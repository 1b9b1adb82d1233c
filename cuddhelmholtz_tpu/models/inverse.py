"""Differentiable Helmholtz solves and wave-speed inversion (FWI-style).

Beyond-reference capability: the CUDA reference (`/root/reference`) is a
forward solver only.  Here the whole pipeline — nodal wave speed ``a`` →
coefficient collocation → coupled operator → GMRES solve → observation
misfit — is one pure JAX function, so ``jax.grad`` delivers the exact
discrete adjoint gradient with one extra linear solve
(``solvers/implicit.py``), ready for gradient-based inversion.

The physical parametrisation follows the reference's convention
(``examples/Helmholtz.cpp:190-218``): the volume term uses ``a^2`` at the
H1 nodes and the absorbing boundary uses ``a`` at the face nodes; both are
derived here from ONE global nodal field, so the gradient accounts for both
paths automatically.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..solvers.implicit import implicit_solve
from ..spaces.h1 import FaceSpace, H1Space
from .helmholtz import (
    HelmholtzTemplate,
    apply_helmholtz,
    helmholtz_op_with_coeff,
    make_helmholtz_template,
)


def solve_helmholtz_diff(
    tmpl: HelmholtzTemplate,
    omega,
    a_nodal: jax.Array,
    b: jax.Array,
    *,
    m: int = 50,
    maxit: int = 400,
    tol: float = 1e-8,
    solve: Callable | None = None,
) -> jax.Array:
    """U(a) = A(a)^{-1} b, differentiable in ``a_nodal``, ``omega`` and ``b``.

    ``a_nodal`` is the global nodal wave speed; the operator uses ``a^2`` in
    the volume and ``a`` on the absorbing faces (both traceable).  The
    coupled system is symmetric, so the adjoint solve reuses the forward
    solver.  Pass ``solve=(matvec, rhs) -> x`` to substitute a stronger
    solver (e.g. the FGMRES+DDH composite) for both passes.
    """
    a_face = jnp.take(a_nodal, tmpl.face_proj)
    op = helmholtz_op_with_coeff(tmpl, omega, a_nodal * a_nodal, a_face)
    return implicit_solve(
        lambda U: apply_helmholtz(op, U),
        b,
        symmetric=True,
        m=m,
        maxit=maxit,
        tol=tol,
        solve=solve,
    )


def ddh_solve_hook(
    ddh,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-8,
    inner_m: int = 20,
    inner_maxit: int = 3,
) -> Callable:
    """A ``solve=(matvec, rhs) -> x`` hook for ``implicit_solve`` /
    ``solve_helmholtz_diff`` that runs FGMRES right-preconditioned by a
    bounded fp32 DDH inner solve (the ``run_helmholtz_ddh`` composite) —
    the production solver for large-scale differentiable Helmholtz.

    The DDH preconditioner is FROZEN at the coefficient it was built with
    (typically the inversion starting model): a preconditioner never changes
    the solution the Krylov iteration converges to, so the solution and its
    implicit gradient stay exact to the solve tolerance while the iteration
    count degrades only gradually as the model drifts from the frozen one —
    rebuild the DDH every few dozen outer updates.  The coupled system is
    symmetric, so the same hook serves the adjoint solve.
    """
    from ..solvers.gmres import fgmres, gmres

    def P(v):
        v32 = v.astype(jnp.float32)
        Y = ddh.rhs(v32)
        out = gmres(ddh.action, Y, m=inner_m, maxit=inner_maxit, tol=0.0)
        return ddh.postprocess(out.x, v32).astype(v.dtype)

    def solve(mv, rhs):
        return fgmres(mv, rhs, P, m=m, maxit=maxit, tol=tol).x

    return solve


def misfit(
    tmpl: HelmholtzTemplate,
    omega,
    a_nodal: jax.Array,
    b: jax.Array,
    observed: jax.Array,
    obs_idx: jax.Array | None = None,
    **solve_kwargs,
) -> jax.Array:
    """0.5 || R U(a) - observed ||^2 — the standard FWI data misfit.

    ``obs_idx`` restricts the observation operator R to a set of receiver
    DOFs (rows of the coupled [u; v] vector); None observes everywhere.
    Differentiable: ``jax.grad(misfit, argnums=2)`` is the adjoint-state
    gradient with respect to the nodal wave speed.
    """
    U = solve_helmholtz_diff(tmpl, omega, a_nodal, b, **solve_kwargs)
    r = (U if obs_idx is None else jnp.take(U, obs_idx)) - observed
    return 0.5 * jnp.vdot(r, r).real


def invert_wavespeed(
    space: H1Space,
    fs: FaceSpace,
    omega: float,
    b: jax.Array,
    observed: jax.Array,
    a0_nodal: jax.Array,
    *,
    obs_idx: jax.Array | None = None,
    steps: int = 20,
    step_size: float = 1e-2,
    dtype=jnp.float64,
    solve_kwargs: dict | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Plain gradient-descent wave-speed inversion (demo driver).

    Returns (a_nodal, loss_history).  One jitted value_and_grad per step —
    each evaluation is one forward and one adjoint Helmholtz solve.  For
    production use plug the returned gradient into optax; this driver keeps
    the example dependency-light.
    """
    tmpl = make_helmholtz_template(space, fs, dtype=dtype)
    kw = solve_kwargs or {}
    loss_grad = jax.jit(
        jax.value_and_grad(
            lambda a: misfit(tmpl, omega, a, b, observed, obs_idx, **kw)
        )
    )
    a = jnp.asarray(a0_nodal, dtype=dtype)
    hist = []
    for _ in range(steps):
        val, g = loss_grad(a)
        hist.append(val)
        a = a - step_size * g
    return a, jnp.stack(hist)
