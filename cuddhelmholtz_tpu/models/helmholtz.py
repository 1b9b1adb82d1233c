"""Coupled real-imaginary Helmholtz operator and coefficient projection.

Parity with the reference example layer (``/root/reference/examples/Helmholtz.hpp``
and ``Helmholtz.cpp:190-218``): the bilinear form

  a([u, v], phi) = [ (grad u, grad phi) - omega^2 (a^2 u, phi) - omega <a v, phi>;
                   -((grad v, grad phi) - omega^2 (a^2 v, phi) + omega <a u, phi>) ]

acting on U = [u; v] (U = u + i v), with first-order absorbing BCs expressed
through the face mass term; the sign flip on the second block symmetrises the
system.  Everything is a pure jittable function of U.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.face_mass import (
    FaceMassOp,
    apply_diag_inv_face_mass,
    apply_face_mass,
    make_diag_inv_face_mass_op,
    make_face_mass_op,
)
from ..ops.functional import face_linear_functional, linear_functional
from ..ops.mass import (
    MassOp,
    apply_diag_inv_mass,
    apply_mass,
    make_diag_inv_mass_op,
    make_mass_op,
)
from ..ops.kron import (
    KronMassOp,
    KronStiffnessOp,
    apply_mass_kron,
    apply_stiffness_kron,
    make_kron_mass_op,
    make_kron_stiffness_op,
)
from ..ops.stiffness import StiffnessOp, apply_stiffness, make_stiffness_op
from ..solvers.gmres import gmres
from ..spaces.h1 import FaceSpace, H1Space
from ..utils.quadrature import QuadratureRule


class HelmholtzOp(NamedTuple):
    """Data for the coupled (u, v) Helmholtz operator."""

    stiffness: StiffnessOp | None  # None when the kron fast path supersedes it
    mass: MassOp | None  # weighted by a^2; None when kron supersedes it
    face_mass: FaceMassOp  # weighted by a
    face_proj: jax.Array  # (fdof,) global indices of face DOFs
    omega: float
    ndof: int
    kron_stiffness: KronStiffnessOp | None = None
    kron_mass: KronMassOp | None = None


def make_helmholtz_op(
    omega: float,
    a2_nodal: np.ndarray,
    a_face_nodal: np.ndarray,
    space: H1Space,
    fs: FaceSpace,
    dtype=jnp.float64,
    kron: bool | None = None,
) -> HelmholtzOp:
    """``kron=None`` auto-enables the 1D-factorised dense-matmul fast path
    (``ops/kron.py``) when ``space`` is a rectilinear ``GridH1Space``."""
    from ..ops.structured import GridH1Space

    if kron is None:
        kron = isinstance(space, GridH1Space)
    ks = km = None
    if kron:
        ks = make_kron_stiffness_op(space, dtype=dtype)
        km = make_kron_mass_op(space, coeff=a2_nodal, dtype=dtype)
        # the kron path supersedes the generic element-batched operators;
        # skip collocating/uploading their (nel, nq, nq) arrays (tens of MB
        # of dead device memory at large grids).  Element-sharded execution
        # (parallel.sharded_helmholtz_matvec) needs them: build with
        # kron=False there.
        stiffness = mass = None
    else:
        stiffness = make_stiffness_op(space, dtype=dtype)
        mass = make_mass_op(space, coeff=a2_nodal, dtype=dtype)
    return HelmholtzOp(
        stiffness=stiffness,
        mass=mass,
        face_mass=make_face_mass_op(fs, coeff=a_face_nodal, dtype=dtype),
        face_proj=jnp.asarray(fs.proj),
        omega=float(omega),
        ndof=space.ndof,
        kron_stiffness=ks,
        kron_mass=km,
    )


def apply_helmholtz(
    op: HelmholtzOp,
    U: jax.Array,
    grid: tuple | None = None,
) -> jax.Array:
    """Y = A U for U = [u; v] of length 2*ndof.

    Pass ``grid=(nx, ny)`` when the space is a GridH1Space to use the
    strided-slice structured assembly (no arbitrary gathers).  The kron
    fast path runs at true fp32 (``ops/kron.py``).
    """
    n = op.ndof
    u, v = U[:n], U[n:]
    w2 = op.omega * op.omega

    if op.kron_stiffness is not None:
        S = lambda w: apply_stiffness_kron(op.kron_stiffness, w)
        M = lambda w: apply_mass_kron(op.kron_mass, w)
    elif grid is not None:
        from ..ops.structured import apply_mass_structured, apply_stiffness_structured

        S = lambda w: apply_stiffness_structured(op.stiffness, grid, w)
        M = lambda w: apply_mass_structured(op.mass, grid, w)
    else:
        S = lambda w: apply_stiffness(op.stiffness, w)
        M = lambda w: apply_mass(op.mass, w)

    Su = S(u) - w2 * M(u)
    Sv = S(v) - w2 * M(v)

    Hu = apply_face_mass(op.face_mass, jnp.take(u, op.face_proj))
    Hv = apply_face_mass(op.face_mass, jnp.take(v, op.face_proj))

    Au = Su.at[op.face_proj].add(-op.omega * Hv)
    Av = -(Sv.at[op.face_proj].add(op.omega * Hu))
    return jnp.concatenate([Au, Av])


class HelmholtzTemplate(NamedTuple):
    """Coefficient-independent Helmholtz data for differentiable rebuilds.

    Holds the stiffness operator (coefficient-free) plus UNIT-coefficient
    mass / face-mass operators collocated at the variable-coefficient
    quadrature sizes, so ``helmholtz_op_with_coeff`` can re-weight them
    traceably inside a ``jax.grad``/``jax.jit`` region."""

    stiffness: StiffnessOp
    mass_unit: MassOp
    face_mass_unit: FaceMassOp
    face_proj: jax.Array
    ndof: int


def make_helmholtz_template(
    space: H1Space, fs: FaceSpace, dtype=jnp.float64
) -> HelmholtzTemplate:
    from ..ops.mass import variable_coeff_n_quad

    nq = variable_coeff_n_quad(space)
    return HelmholtzTemplate(
        stiffness=make_stiffness_op(space, dtype=dtype),
        mass_unit=make_mass_op(space, dtype=dtype, n_quad=nq),
        face_mass_unit=make_face_mass_op(fs, dtype=dtype, n_quad=nq),
        face_proj=jnp.asarray(fs.proj),
        ndof=space.ndof,
    )


def helmholtz_op_with_coeff(
    tmpl: HelmholtzTemplate,
    omega,
    a2_nodal: jax.Array,
    a_face_nodal: jax.Array,
) -> HelmholtzOp:
    """Build the coupled operator as a TRACEABLE function of the nodal
    coefficients (and optionally a traced ``omega``): the differentiable
    counterpart of ``make_helmholtz_op`` for inverse problems
    (``models/inverse.py``).  Uses the generic element-batched operators
    (the kron fast path bakes its coefficient into a host-side layout)."""
    from ..ops.face_mass import face_mass_op_with_coeff
    from ..ops.mass import mass_op_with_coeff

    return HelmholtzOp(
        stiffness=tmpl.stiffness,
        mass=mass_op_with_coeff(tmpl.mass_unit, a2_nodal),
        face_mass=face_mass_op_with_coeff(tmpl.face_mass_unit, a_face_nodal),
        face_proj=tmpl.face_proj,
        omega=omega,
        ndof=tmpl.ndof,
    )


def helmholtz_rhs(space: H1Space, f: Callable, dtype=jnp.float64) -> jax.Array:
    """b = [(f, phi); 0] using the fast collocation functional."""
    bu = linear_functional(space, f, dtype=dtype)
    return jnp.concatenate([bu, jnp.zeros_like(bu)])


def project_coefficients(
    space: H1Space,
    fs: FaceSpace,
    a_fn: Callable,
    dtype=jnp.float64,
) -> tuple[np.ndarray, np.ndarray]:
    """L2-project a^2 onto the H1 space and a onto the face space.

    Mirrors ``Helmholtz.cpp:190-218``: 2*nb-point Gauss-Legendre functionals,
    mass solves with GMRES(5), <=10 restarts, tol 1e-12, diagonal
    preconditioning.  Returns nodal numpy vectors.
    """
    nb = space.n_basis
    quad = QuadratureRule(2 * nb, QuadratureRule.GaussLegendre)

    b = linear_functional(space, lambda xy: a_fn(xy) ** 2, quad, dtype=dtype)
    mass = make_mass_op(space, dtype=dtype)
    pinv = make_diag_inv_mass_op(space, dtype=dtype)
    out = gmres(
        lambda x: apply_mass(mass, x),
        b,
        m=5,
        maxit=10,
        tol=1e-12,
        precond=lambda x: apply_diag_inv_mass(pinv, x),
    )
    a2_nodal = np.asarray(out.x)

    bf = face_linear_functional(fs, a_fn, quad, dtype=dtype)
    fmass = make_face_mass_op(fs, dtype=dtype)
    fpinv = make_diag_inv_face_mass_op(fs, dtype=dtype)
    outf = gmres(
        lambda x: apply_face_mass(fmass, x),
        bf,
        m=5,
        maxit=10,
        tol=1e-12,
        precond=lambda x: apply_diag_inv_face_mass(fpinv, x),
    )
    a_face_nodal = np.asarray(outf.x)
    return a2_nodal, a_face_nodal
