"""Restarted GMRES(m), fully jitted.

Parity with the reference ``gmres`` (``/root/reference/source/gmres.cpp``):
restarted GMRES with Givens-rotation least squares, early inner exit on the
rotated-residual estimate, true-residual recomputation each restart, optional
left preconditioning (solve P A x = P b), fp32 and fp64, residual history.

Design: the reference splits work between device BLAS-1 kernels and host
LAPACK with a blocking sync per dot product (``gmres.cpp:167-189``).  Here
the entire restart cycle is a single jitted ``lax.while_loop``:

  * orthogonalisation is re-orthogonalised classical Gram-Schmidt (CGS2) by
    default -- two (m+1, n) x (n,) matrix-vector products per Arnoldi step
    that reduce with ``psum`` when the vectors are sharded -- instead of the
    reference's k sequential dot+axpy pairs (MGS);
  * the Givens rotations are accumulated in a small (m+1, m+1) matrix so the
    Hessenberg update is one tiny matmul;
  * the triangular solve runs in-jit via ``jax.scipy`` on a fixed-size
    padded system (inactive columns are identity), so early exit needs no
    dynamic shapes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils import linalg

# Precision of the (m+1, n) orthogonalisation/update products: true fp32.
# Under ``vmap`` and in the block solver these become matrix-matrix
# products, which a lower word would let run on TF32 tensor cores and lose
# orthogonality (docs/DTYPES.md).
_MV_PRECISION = "highest"


def _mv(A, x):
    """A @ x with the solver's matvec precision."""
    return jnp.matmul(A, x, precision=_MV_PRECISION)


class ProgressBar:
    """Reference-parity progress bar for host-loop solves (gmres.cpp:44-64).

    Prints a fixed-width bar advanced by ``update(fraction)``; used by
    ``gmres_host`` at verbosity 1 (verbosity >= 2 prints per-restart lines).
    """

    def __init__(self, width: int = 40):
        self.width = width
        self._drawn = -1

    def update(self, fraction: float) -> None:
        import sys

        fraction = min(max(fraction, 0.0), 1.0)
        n = int(self.width * fraction)
        if n != self._drawn:
            self._drawn = n
            bar = "#" * n + "-" * (self.width - n)
            sys.stdout.write(f"\r[{bar}] {100 * fraction:5.1f}%")
            sys.stdout.flush()

    def finish(self) -> None:
        import sys

        self.update(1.0)
        sys.stdout.write("\n")
        sys.stdout.flush()


class GmresResult(NamedTuple):
    x: jax.Array
    success: jax.Array  # bool
    num_iter: jax.Array  # restart count (matches reference out.num_iter)
    num_matvec: jax.Array
    res_norm: jax.Array  # (maxit+1,) residual history; NaN-padded after exit
    n_hist: jax.Array  # number of valid entries in res_norm


def _arnoldi_step(matvec, V, Q, R, eta, k, tol_bnrm, done, nmv, reorth=True, vin=None):
    """One Arnoldi + Givens step; no-ops (other than carry) once ``done``.

    When ``k`` is a Python int (unrolled restart cycle) the orthogonalisation
    reads only the populated rows ``V[:k+1]`` -- on average half the basis
    HBM traffic of the full padded matmul used under ``lax.fori_loop``.
    ``vin`` overrides the direction the operator is applied to (used by the
    augmented-restart solver ``lgmres``; plain Arnoldi applies A to V[k]).
    """
    dtype = V.dtype
    m1 = V.shape[0]
    static_k = isinstance(k, int)

    # The branches CLOSE OVER V and only return the new basis row: putting V
    # through lax.cond's carry would materialise an (m+1, n) select each step
    # (a matvec-sized memory pass) and block in-place row updates.
    def active_step(_):
        w = matvec(V[k] if vin is None else vin)
        # CGS(2): rows of V beyond the current k are zero, so the (sliced or
        # padded) matmul computes exactly the coefficients against v_0..v_k.
        # The second (re-orthogonalisation) pass costs two more reads of the
        # basis; skipping it (reorth=False) halves the orthogonalisation HBM
        # traffic at a loss of orthogonality quality -- fine for
        # well-conditioned systems, like the reference's single-pass scheme.
        Vk = V[: k + 1] if static_k else V
        h = _mv(Vk, w)
        w = w - _mv(Vk.T, h)
        if reorth:
            h2 = _mv(Vk, w)
            w = w - _mv(Vk.T, h2)
            h = h + h2
        if static_k:
            h = jnp.concatenate([h, jnp.zeros(m1 - k - 1, dtype)])
        hk1 = linalg.norm(w)
        breakdown = hk1 == 0.0
        vnew = jnp.where(breakdown, w, w / jnp.where(breakdown, 1.0, hk1))
        # rotate the new Hessenberg column by the accumulated rotations
        col = Q @ h.at[k + 1].set(hk1)
        # new Givens rotation zeroing entry k+1
        a, b = col[k], col[k + 1]
        t = jnp.hypot(a, b)
        safe = t > 0.0
        c = jnp.where(safe, a / jnp.where(safe, t, 1.0), jnp.ones((), dtype))
        s = jnp.where(safe, b / jnp.where(safe, t, 1.0), jnp.zeros((), dtype))
        G = (
            jnp.eye(m1, dtype=dtype)
            .at[k, k].set(c)
            .at[k, k + 1].set(s)
            .at[k + 1, k].set(-s)
            .at[k + 1, k + 1].set(c)
        )
        col = col.at[k].set(c * col[k] + s * col[k + 1]).at[k + 1].set(0.0)
        R2 = R.at[:, k].set(col[: R.shape[0]])
        Q2 = G @ Q
        eta2 = eta.at[k + 1].set(-s * eta[k]).at[k].set(c * eta[k])
        converged = jnp.abs(eta2[k + 1]) < tol_bnrm
        return vnew, Q2, R2, eta2, converged | breakdown, nmv + 1

    def frozen(_):
        # keep the padded system solvable: identity column, zero rhs entry
        col = jnp.zeros(R.shape[0], dtype).at[k].set(1.0)
        return (
            jnp.zeros(V.shape[1], dtype),
            Q,
            R.at[:, k].set(col),
            eta.at[k].set(0.0),
            done,
            nmv,
        )

    vnew, Q, R, eta, done, nmv = lax.cond(done, frozen, active_step, None)
    return V.at[k + 1].set(vnew), Q, R, eta, done, nmv


def gmres(
    matvec: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    precond: Callable | None = None,
    reorth: bool = True,
    unroll: bool = False,
    deferred: bool = False,
) -> GmresResult:
    """Solve A x = b with restarted GMRES(m).

    ``matvec`` must be a pure function of one vector.  With ``precond`` P the
    left-preconditioned system P A x = P b is solved (reference
    ``PreconditionedSystem``, ``gmres.cpp:68-89,242-251``).  Jittable.

    ``unroll=True`` unrolls the m inner Arnoldi steps in the compiled graph
    (m static copies of the step): each step then reads only the populated
    ``V[:k+1]`` rows, halving the average orthogonalisation HBM traffic.
    Best for small m where the solver overhead rivals the matvec; compile
    time grows with m.

    ``deferred=True`` removes the per-step Givens/early-exit machinery (a
    serialized chain of small kernels per step) in favour of one
    ridge-regularised normal-equations least squares per restart; exits
    move to restart boundaries (up to m-1 overshoot steps in the final
    restart).
    """
    dtype = b.dtype
    n = b.shape[0]
    if precond is not None:
        inner_matvec = lambda v: precond(matvec(v))
        b = precond(b)
    else:
        inner_matvec = matvec
    if x0 is None:
        x0 = jnp.zeros(n, dtype=dtype)

    tol = jnp.asarray(tol, dtype=dtype)
    bnrm = linalg.norm(b)
    r0 = b - inner_matvec(x0)
    r0_nrm = linalg.norm(r0)
    hist0 = jnp.full(maxit + 1, jnp.nan, dtype=dtype).at[0].set(r0_nrm)
    tol_bnrm = tol * bnrm

    m1 = m + 1

    def restart_body(carry):
        x, r, r_nrm, it, nmv, hist = carry
        V = jnp.zeros((m1, n), dtype=dtype).at[0].set(
            r / jnp.where(r_nrm > 0.0, r_nrm, 1.0)
        )
        if deferred:
            Hc = jnp.zeros((m1, m), dtype=dtype)

            def inner_d(k, args):
                V, Hc, nmv = args
                static_k = isinstance(k, int)
                Vk = V[: k + 1] if static_k else V
                w = inner_matvec(V[k])
                h = _mv(Vk, w)
                w = w - _mv(Vk.T, h)
                if reorth:
                    h2 = _mv(Vk, w)
                    w = w - _mv(Vk.T, h2)
                    h = h + h2
                if static_k:
                    h = jnp.concatenate([h, jnp.zeros(m1 - k - 1, dtype)])
                hk1 = linalg.norm(w)
                vnew = jnp.where(
                    hk1 > 0.0, w / jnp.where(hk1 > 0.0, hk1, 1.0), w
                )
                return (
                    V.at[k + 1].set(vnew),
                    Hc.at[:, k].set(h.at[k + 1].set(hk1)),
                    nmv + 1,
                )

            if unroll:
                carry_d = (V, Hc, nmv)
                for kk in range(m):
                    carry_d = inner_d(kk, carry_d)
                V, Hc, nmv = carry_d
            else:
                V, Hc, nmv = lax.fori_loop(0, m, inner_d, (V, Hc, nmv))
            N = _mv(Hc.T, Hc)
            ridge = jnp.asarray(1e-7, dtype) * (
                jnp.trace(N) / m + jnp.asarray(1e-30, dtype)
            )
            Ln = jnp.linalg.cholesky(N + ridge * jnp.eye(m, dtype=dtype))
            rhs_n = r_nrm * Hc[0, :]
            y = jax.scipy.linalg.solve_triangular(
                Ln.T,
                jax.scipy.linalg.solve_triangular(Ln, rhs_n, lower=True),
                lower=False,
            )
        else:
            Q = jnp.eye(m1, dtype=dtype)
            R = jnp.zeros((m, m), dtype=dtype)
            eta = jnp.zeros(m1, dtype=dtype).at[0].set(r_nrm)

            def inner(k, args):
                V, Q, R, eta, done, nmv = args
                return _arnoldi_step(
                    inner_matvec, V, Q, R, eta, k, tol_bnrm, done, nmv, reorth
                )

            carry = (V, Q, R, eta, jnp.asarray(False), nmv)
            if unroll:
                for kk in range(m):
                    carry = inner(kk, carry)
                V, Q, R, eta, _, nmv = carry
            else:
                V, Q, R, eta, _, nmv = lax.fori_loop(0, m, inner, carry)
            # padded upper-triangular solve: frozen columns are identity with
            # a zero rhs, so their solution components vanish
            y = jax.scipy.linalg.solve_triangular(R, eta[:m], lower=False)
        x = x + _mv(V[:m].T, y)
        r = b - inner_matvec(x)
        nmv = nmv + 1
        r_nrm = linalg.norm(r)
        it = it + 1
        hist = hist.at[it].set(r_nrm)
        return x, r, r_nrm, it, nmv, hist

    def cond(carry):
        _, _, r_nrm, it, _, _ = carry
        return (r_nrm >= tol_bnrm) & (r_nrm > 0.0) & (it < maxit - 1)

    init = (x0, r0, r0_nrm, jnp.asarray(0), jnp.asarray(1), hist0)
    # the cond's `it < maxit - 1` admits at most maxit-1 restarts, mirroring
    # the reference's `for (it = 1; it < maxit; ++it)` (gmres.cpp:146)
    # (host-observable variant with wall-clock cutoff: see gmres_host below)
    x, r, r_nrm, it, nmv, hist = lax.while_loop(cond, restart_body, init)
    success = r_nrm <= tol_bnrm
    return GmresResult(
        x=x, success=success, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )


def lgmres(
    matvec: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    m: int = 20,
    k: int = 3,
    maxit: int = 100,
    tol: float = 1e-6,
    precond: Callable | None = None,
    reorth: bool = True,
) -> GmresResult:
    """LGMRES(m, k): restarted GMRES augmented with the k previous restart
    update directions z_i = x_i - x_{i-1} (Baker, Jessup & Manteuffel 2005).

    Restarted GMRES discards its Krylov space every m steps and stagnates on
    indefinite problems (the unpreconditioned-Helmholtz profile); appending
    the recent update directions to the approximation space is the standard
    cure at the cost of k extra matvecs per restart.  ``k=0`` reduces to
    ``gmres(m=m)``.  Fully jitted, same ``GmresResult`` contract.  This is a
    beyond-reference capability (the reference ships plain GMRES(m),
    ``gmres.cpp:91-235``); use ``gmres`` for exact reference parity.
    """
    dtype = b.dtype
    n = b.shape[0]
    if precond is not None:
        inner_matvec = lambda v: precond(matvec(v))
        b = precond(b)
    else:
        inner_matvec = matvec
    if x0 is None:
        x0 = jnp.zeros(n, dtype=dtype)

    tol = jnp.asarray(tol, dtype=dtype)
    bnrm = linalg.norm(b)
    r0 = b - inner_matvec(x0)
    r0_nrm = linalg.norm(r0)
    hist0 = jnp.full(maxit + 1, jnp.nan, dtype=dtype).at[0].set(r0_nrm)
    tol_bnrm = tol * bnrm

    mk = m + k
    mk1 = mk + 1

    def restart_body(carry):
        x, r, r_nrm, it, nmv, hist, Z, kv = carry
        V = jnp.zeros((mk1, n), dtype=dtype).at[0].set(
            r / jnp.where(r_nrm > 0.0, r_nrm, 1.0)
        )
        Q = jnp.eye(mk1, dtype=dtype)
        R = jnp.zeros((mk, mk), dtype=dtype)
        eta = jnp.zeros(mk1, dtype=dtype).at[0].set(r_nrm)
        Zs = jnp.zeros((mk, n), dtype=dtype)  # directions A was applied to

        def inner(j, args):
            V, Q, R, eta, done, nmv, Zs = args
            # steps 0..m-1 run plain Arnoldi on the newest basis vector;
            # steps m.. apply A to the stored outer directions while they
            # exist (first restarts have fewer), else continue the Krylov
            # recursion.  Frozen steps leave an identity column and a zero
            # rhs entry, so their y-component vanishes and the recorded
            # direction is inert.
            if k > 0:
                use_z = (j >= m) & (j - m < kv)
                zi = Z[jnp.clip(j - m, 0, k - 1)]
                d = jnp.where(use_z, zi, V[j])
            else:
                d = V[j]
            V, Q, R, eta, done, nmv = _arnoldi_step(
                inner_matvec, V, Q, R, eta, j, tol_bnrm, done, nmv, reorth,
                vin=d,
            )
            return V, Q, R, eta, done, nmv, Zs.at[j].set(d)

        carry_in = (V, Q, R, eta, jnp.asarray(False), nmv, Zs)
        V, Q, R, eta, _, nmv, Zs = lax.fori_loop(0, mk, inner, carry_in)
        y = jax.scipy.linalg.solve_triangular(R, eta[:mk], lower=False)
        dx = _mv(Zs.T, y)
        x = x + dx
        r = b - inner_matvec(x)
        nmv = nmv + 1
        r_nrm = linalg.norm(r)
        it = it + 1
        hist = hist.at[it].set(r_nrm)
        if k > 0:
            dxn = linalg.norm(dx)
            znew = jnp.where(dxn > 0.0, dx / jnp.where(dxn > 0.0, dxn, 1.0), Z[0] * 0.0)
            Z = jnp.roll(Z, 1, axis=0).at[0].set(znew)
            kv = jnp.minimum(kv + jnp.where(dxn > 0.0, 1, 0), k)
        return x, r, r_nrm, it, nmv, hist, Z, kv

    def cond(carry):
        _, _, r_nrm, it, _, _, _, _ = carry
        return (r_nrm >= tol_bnrm) & (r_nrm > 0.0) & (it < maxit - 1)

    Z0 = jnp.zeros((max(k, 1), n), dtype=dtype)
    init = (x0, r0, r0_nrm, jnp.asarray(0), jnp.asarray(1), hist0, Z0, jnp.asarray(0))
    x, r, r_nrm, it, nmv, hist, _, _ = lax.while_loop(cond, restart_body, init)
    success = r_nrm <= tol_bnrm
    return GmresResult(
        x=x, success=success, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )


def fgmres(
    matvec: Callable,
    b: jax.Array,
    precond: Callable,
    x0: jax.Array | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    reorth: bool = True,
    deferred: bool = False,
) -> GmresResult:
    """Flexible GMRES(m) with a right preconditioner applied per step.

    Each Arnoldi step stores z_k = P(v_k) and applies A to it; the solution
    update uses the stored z's, so ``precond`` may be a *varying* (even
    nonlinear) operator — e.g. an inner Krylov solve such as the DDH
    substructured solver.  Plain ``gmres(precond=...)`` requires a FIXED
    linear P (left preconditioning); use this when P is itself iterative.
    Beyond-reference capability (Saad 1993; the reference has only plain
    left preconditioning, ``gmres.cpp:68-89``).

    ``deferred=True`` trades the per-step Givens/early-exit machinery (a
    ``lax.cond`` of serialized small kernels per step) for
    one ridge-regularised normal-equations solve per RESTART: every
    restart runs all m steps unconditionally and convergence is checked on
    the true residual at restart boundaries.  Same trajectories when exit
    happens at a restart boundary; inside the final restart it overshoots
    up to m-1 steps.  Right for expensive-preconditioner solves where m is
    small relative to the total step count.
    """
    dtype = b.dtype
    n = b.shape[0]
    if x0 is None:
        x0 = jnp.zeros(n, dtype=dtype)

    tol = jnp.asarray(tol, dtype=dtype)
    bnrm = linalg.norm(b)
    r0 = b - matvec(x0)
    r0_nrm = linalg.norm(r0)
    hist0 = jnp.full(maxit + 1, jnp.nan, dtype=dtype).at[0].set(r0_nrm)
    tol_bnrm = tol * bnrm

    m1 = m + 1

    def restart_body(carry):
        x, r, r_nrm, it, nmv, hist = carry
        V = jnp.zeros((m1, n), dtype=dtype).at[0].set(
            r / jnp.where(r_nrm > 0.0, r_nrm, 1.0)
        )
        Zs = jnp.zeros((m, n), dtype=dtype)  # preconditioned directions
        if deferred:
            Hc = jnp.zeros((m1, m), dtype=dtype)  # plain Hessenberg columns

            def inner_d(j, args):
                V, Hc, Zs, nmv = args
                z = precond(V[j])
                w = matvec(z)
                # CGS(2) vs the populated rows (rows > j are zero)
                h = _mv(V, w)
                w = w - _mv(V.T, h)
                if reorth:
                    h2 = _mv(V, w)
                    w = w - _mv(V.T, h2)
                    h = h + h2
                hk1 = linalg.norm(w)
                vnew = jnp.where(
                    hk1 > 0.0, w / jnp.where(hk1 > 0.0, hk1, 1.0), w
                )
                return (
                    V.at[j + 1].set(vnew),
                    Hc.at[:, j].set(h.at[j + 1].set(hk1)),
                    Zs.at[j].set(z),
                    nmv + 1,
                )

            V, Hc, Zs, nmv = lax.fori_loop(0, m, inner_d, (V, Hc, Zs, nmv))
            # min_y || r_nrm e1 - Hc y || by ridge-regularised normal
            # equations: one matmul + one tiny Cholesky per restart
            # instead of m serialized Givens chains
            N = _mv(Hc.T, Hc)
            ridge = jnp.asarray(1e-7, dtype) * (
                jnp.trace(N) / m + jnp.asarray(1e-30, dtype)
            )
            Ln = jnp.linalg.cholesky(N + ridge * jnp.eye(m, dtype=dtype))
            rhs_n = r_nrm * Hc[0, :]
            y = jax.scipy.linalg.solve_triangular(
                Ln.T,
                jax.scipy.linalg.solve_triangular(Ln, rhs_n, lower=True),
                lower=False,
            )
        else:
            Q = jnp.eye(m1, dtype=dtype)
            R = jnp.zeros((m, m), dtype=dtype)
            eta = jnp.zeros(m1, dtype=dtype).at[0].set(r_nrm)

            def inner(j, args):
                V, Q, R, eta, done, nmv, Zs = args
                z = precond(V[j])
                V, Q, R, eta, done, nmv = _arnoldi_step(
                    matvec, V, Q, R, eta, j, tol_bnrm, done, nmv, reorth, vin=z
                )
                # frozen steps contribute y_j = 0, so the stale z row is inert
                return V, Q, R, eta, done, nmv, Zs.at[j].set(z)

            carry_in = (V, Q, R, eta, jnp.asarray(False), nmv, Zs)
            V, Q, R, eta, _, nmv, Zs = lax.fori_loop(0, m, inner, carry_in)
            y = jax.scipy.linalg.solve_triangular(R, eta[:m], lower=False)
        x = x + _mv(Zs.T, y)
        r = b - matvec(x)
        nmv = nmv + 1
        r_nrm = linalg.norm(r)
        it = it + 1
        hist = hist.at[it].set(r_nrm)
        return x, r, r_nrm, it, nmv, hist

    def cond(carry):
        _, _, r_nrm, it, _, _ = carry
        return (r_nrm >= tol_bnrm) & (r_nrm > 0.0) & (it < maxit - 1)

    init = (x0, r0, r0_nrm, jnp.asarray(0), jnp.asarray(1), hist0)
    x, r, r_nrm, it, nmv, hist = lax.while_loop(cond, restart_body, init)
    success = r_nrm <= tol_bnrm
    return GmresResult(
        x=x, success=success, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )


class BlockGmresResult(NamedTuple):
    x: jax.Array  # (K, n) solutions
    success: jax.Array  # (K,) per-source bool
    num_iter: jax.Array  # shared restart count
    num_matvec: jax.Array  # total SINGLE-vector matvec count (K per block op)
    res_norm: jax.Array  # (maxit+1, K) per-source residual history
    n_hist: jax.Array


def _block_qr(Z, eps):
    """Factor a K-row block ``Z = F @ V`` with the rows of V orthonormal
    (up to jittered/clipped near-null directions).

    Rank-deficient blocks HAPPEN by design in block GMRES (a source
    converges, directions coalesce), and plain CholQR NaNs on them.  The
    fast path is jittered CholQR; an in-jit ``lax.cond`` falls back to an
    eigh-whitened polar factorisation (spectrum clipped at ``eps·λmax``)
    only when the Cholesky factor comes back non-finite.  Near-dependent
    directions survive as slightly-off-normal rows whose Arnoldi
    inconsistency (~√jitter of the local block norm) affects only
    components the space already contains.  No host sync — while_loop
    safe.
    """
    K = Z.shape[0]
    G = jnp.matmul(Z, Z.T, precision=_MV_PRECISION)
    tr = jnp.trace(G) / K + jnp.asarray(1e-30, Z.dtype)

    # fast path: jittered CholQR — two (K, K) ops.  The jitter (~30 eps
    # relative) dominates the fp32 Gram rounding error, so the factor stays
    # finite for PSD G; it only fails on pathological blocks, detected below.
    Lc = jnp.linalg.cholesky(G + (30 * eps * tr) * jnp.eye(K, dtype=Z.dtype))
    ok = jnp.all(jnp.isfinite(Lc))

    def fast(_):
        # invert the tiny factor explicitly and apply by matmul: one
        # (K, K) @ (K, n) product instead of a triangular solve with n
        # right-hand-side columns
        Li = jax.scipy.linalg.solve_triangular(
            Lc, jnp.eye(K, dtype=Z.dtype), lower=True
        )
        V = jnp.matmul(Li, Z, precision=_MV_PRECISION)
        return Lc, V

    def robust(_):
        # eigh-whitened polar factorisation (rank-revealing, NaN-free) —
        # far costlier than CholQR, so it runs only when the fast path
        # broke down
        s, U = jnp.linalg.eigh(G)
        floor = eps * jnp.maximum(s[-1], jnp.asarray(1e-30, Z.dtype))
        s_c = jnp.sqrt(jnp.maximum(s, floor))
        F = U * s_c[None, :]
        V = jnp.matmul(U.T / s_c[:, None], Z, precision=_MV_PRECISION)
        return F, V

    return lax.cond(ok, fast, robust, None)


def block_gmres(
    matvec: Callable,
    B: jax.Array,
    X0: jax.Array | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    reorth: bool = True,
    unroll: bool = False,
) -> BlockGmresResult:
    """Restarted block GMRES: solve ``A x_k = b_k`` for K right-hand sides
    with ONE shared block-Krylov space (rows of ``B``, shape (K, n)).

    ``matvec`` must map a (K, n) block to a (K, n) block (e.g.
    ``jax.vmap`` of a single-vector operator).  Per restart the space has
    dimension m·K — K× richer than K independent GMRES(m) runs — so for
    clustered spectra (the multi-source DDH λ-systems: one operator, K
    forcings) the restart count drops by nearly K×, while every block step
    still costs exactly one batched matvec, the same device work as one
    lock-step ``vmap`` step.  This is what replaces the reference's
    one-forcing-per-invocation driver loop (DDH.cpp:85-161) at multi-source
    scale; a lock-step ``jax.vmap`` of :func:`gmres` runs
    every lane to the SLOWEST lane's restart count with no cross-source
    subspace sharing.

    Design: block orthogonalisation is CGS2 on K vectors at once —
    (p, n) @ (n, K) matmuls with K times the arithmetic intensity of
    single-vector GMRES; the block QR is CholQR (two small (K, K) host-free ops); the
    per-restart least squares is one (m+1)K × mK QR on-device.  Fully
    jitted: restarts are a ``lax.while_loop`` over fixed-shape state.

    Convergence is per-source (``tol * ||b_k||``); the loop runs until ALL
    sources converge (or maxit).  True residuals are recomputed each
    restart.
    """
    dtype = B.dtype
    K, n = B.shape
    if X0 is None:
        X0 = jnp.zeros((K, n), dtype=dtype)
    eps = jnp.asarray(3e-7 if dtype == jnp.float32 else 1e-14, dtype)

    tol = jnp.asarray(tol, dtype=dtype)
    bnrm = jnp.linalg.norm(B, axis=1)  # (K,)
    tol_b = tol * bnrm
    R0 = B - matvec(X0)
    r0 = jnp.linalg.norm(R0, axis=1)
    hist0 = jnp.full((maxit + 1, K), jnp.nan, dtype=dtype).at[0].set(r0)

    q = (m + 1) * K  # basis rows

    def restart_body(carry):
        X, R, rn, it, nmv, hist = carry
        L0, V0 = _block_qr(R, eps)
        W = jnp.zeros((q, n), dtype=dtype).at[:K].set(V0)
        Hb = jnp.zeros((q, m * K), dtype=dtype)
        # coordinates of R in the basis: r_k = Σ_i L0[k,i] v_i ⇒ E[:K] = L0ᵀ
        E = jnp.zeros((q, K), dtype=dtype).at[:K, :].set(L0.T)

        def inner(j, args):
            """One block-Arnoldi step.  With a static ``j`` (``unroll=True``)
            the CGS matmuls read only the populated ``W[:(j+1)K]`` rows —
            on average half the basis memory traffic, which dominates the
            per-step cost of the batched DDH solve (the matvec amortises
            over K; the orthogonalisation does not)."""
            W, Hb, nmv = args
            static_j = isinstance(j, int)
            if static_j:
                Vj = W[j * K:(j + 1) * K]
                Wl = W[: (j + 1) * K]
            else:
                Vj = lax.dynamic_slice_in_dim(W, j * K, K, axis=0)
                Wl = W
            Z = matvec(Vj)
            # CGS(2) against the populated rows: rows beyond (j+1)K are zero,
            # so the (sliced or padded) matmul computes exactly the
            # coefficients against the live basis (same trick as
            # _arnoldi_step)
            h = jnp.matmul(Wl, Z.T, precision=_MV_PRECISION)  # (p, K)
            Z = Z - jnp.matmul(h.T, Wl, precision=_MV_PRECISION)
            if reorth:
                h2 = jnp.matmul(Wl, Z.T, precision=_MV_PRECISION)
                Z = Z - jnp.matmul(h2.T, Wl, precision=_MV_PRECISION)
                h = h + h2
            if static_j:
                h = jnp.concatenate([h, jnp.zeros((q - (j + 1) * K, K), dtype)])
            Lj, Vn = _block_qr(Z, eps)
            # column block j of the block Hessenberg: coefficients h plus
            # the subdiagonal Lᵀ (A Vj = hᵀ-combination of basis + Lj Vn)
            col = lax.dynamic_update_slice(h, Lj.T, ((j + 1) * K, 0))
            Hb2 = lax.dynamic_update_slice(Hb, col, (0, j * K))
            W2 = lax.dynamic_update_slice_in_dim(W, Vn, (j + 1) * K, axis=0)
            return W2, Hb2, nmv + K

        if unroll:
            carry = (W, Hb, nmv)
            for jj in range(m):
                carry = inner(jj, carry)
            W, Hb, nmv = carry
        else:
            W, Hb, nmv = lax.fori_loop(0, m, inner, (W, Hb, nmv))
        # least squares  min_Y || E - Hb Y ||_F  via ridge-regularised
        # normal equations: N = HbᵀHb is one matmul + ONE (mK, mK)
        # Cholesky, where a Householder QR of the (m+1)K x mK Hessenberg
        # would serialize ~mK small panel steps per restart.  The block
        # Hessenberg of a preconditioned system is mildly conditioned, and
        # the relative ridge bounds the squared condition number's fp32
        # noise; frozen/dependent columns are zero, which the ridge turns
        # into harmless zero components.
        N = jnp.matmul(Hb.T, Hb, precision=_MV_PRECISION)
        ridge = jnp.asarray(1e-7, dtype) * (
            jnp.trace(N) / N.shape[0] + jnp.asarray(1e-30, dtype)
        )
        Ln = jnp.linalg.cholesky(N + ridge * jnp.eye(N.shape[0], dtype=dtype))
        rhs_n = jnp.matmul(Hb.T, E, precision=_MV_PRECISION)
        Y = jax.scipy.linalg.solve_triangular(
            Ln.T,
            jax.scipy.linalg.solve_triangular(Ln, rhs_n, lower=True),
            lower=False,
        )
        X = X + jnp.matmul(Y.T, W[: m * K], precision=_MV_PRECISION)
        R = B - matvec(X)
        nmv = nmv + K
        rn = jnp.linalg.norm(R, axis=1)
        it = it + 1
        hist = hist.at[it].set(rn)
        return X, R, rn, it, nmv, hist

    def cond(carry):
        _, _, rn, it, _, _ = carry
        return jnp.any((rn >= tol_b) & (rn > 0.0)) & (it < maxit - 1)

    init = (X0, R0, r0, jnp.asarray(0), jnp.asarray(K), hist0)
    X, R, rn, it, nmv, hist = lax.while_loop(cond, restart_body, init)
    return BlockGmresResult(
        x=X,
        success=rn <= tol_b,
        num_iter=it,
        num_matvec=nmv,
        res_norm=hist,
        n_hist=it + 1,
    )


def gmres_host(
    matvec: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    precond: Callable | None = None,
    max_seconds: float = 6 * 60 * 60,
    verbose: int = 0,
    reorth: bool = True,
    unroll: bool = False,
) -> tuple[GmresResult, list]:
    """Restarted GMRES with a host-side restart loop.

    Same semantics as ``gmres`` plus the reference's observability features
    (``gmres.hpp:33``, ``gmres.cpp:200-213``): a wall-clock cutoff checked
    between restarts, optional per-restart progress printing, and a returned
    per-restart wall-time list.  Each restart cycle is one jitted device
    program; only the scalar residual syncs to the host per restart.
    """
    import time as _time

    dtype = b.dtype
    n = b.shape[0]
    if precond is not None:
        inner = lambda v: precond(matvec(v))
        b = precond(b)
    else:
        inner = matvec
    if x0 is None:
        x0 = jnp.zeros(n, dtype=dtype)

    tol = jnp.asarray(tol, dtype=dtype)
    bnrm = linalg.norm(b)
    tol_bnrm = float(tol * bnrm)
    m1 = m + 1

    @jax.jit
    def restart(x, r, r_nrm):
        V = jnp.zeros((m1, n), dtype=dtype).at[0].set(
            r / jnp.where(r_nrm > 0.0, r_nrm, 1.0)
        )
        Q = jnp.eye(m1, dtype=dtype)
        R = jnp.zeros((m, m), dtype=dtype)
        eta = jnp.zeros(m1, dtype=dtype).at[0].set(r_nrm)

        def step(k, args):
            V, Q, R, eta, done, nmv = args
            return _arnoldi_step(inner, V, Q, R, eta, k, tol_bnrm, done, nmv, reorth)

        carry = (V, Q, R, eta, jnp.asarray(False), jnp.asarray(0))
        if unroll:
            for kk in range(m):
                carry = step(kk, carry)
            V, Q, R, eta, _, nmv = carry
        else:
            V, Q, R, eta, _, nmv = lax.fori_loop(0, m, step, carry)
        y = jax.scipy.linalg.solve_triangular(R, eta[:m], lower=False)
        x = x + _mv(V[:m].T, y)
        r = b - inner(x)
        return x, r, linalg.norm(r), nmv + 1

    r = b - inner(x0)
    x = x0
    r_nrm = float(linalg.norm(r))
    hist = [r_nrm]
    times = [0.0]
    nmv_total = 1
    t0 = _time.perf_counter()
    it = 0
    # `<=` + the r_nrm == 0 exit mirror `gmres`: a zero (or exactly
    # converged) residual succeeds immediately instead of spinning restarts
    success = r_nrm <= tol_bnrm or r_nrm == 0.0
    # reference verbosity levels (gmres.cpp:44-64,205-213): 1 = progress bar
    # toward the convergence target, >= 2 = one line per restart
    bar = ProgressBar() if verbose == 1 else None
    import math as _math

    log_start = _math.log(max(r_nrm, 1e-300))
    log_goal = _math.log(max(tol_bnrm, 1e-300))
    while not success and it < maxit - 1:
        x, r, r_nrm_dev, nmv = restart(x, r, jnp.asarray(r_nrm, dtype))
        r_nrm = float(r_nrm_dev)
        nmv_total += int(nmv)
        it += 1
        hist.append(r_nrm)
        times.append(_time.perf_counter() - t0)
        if bar is not None:
            prog = (log_start - _math.log(max(r_nrm, 1e-300))) / max(
                log_start - log_goal, 1e-300
            )
            bar.update(max(prog, it / maxit))
        elif verbose:
            print(
                f"iteration {it:6d} / {maxit} || rel. res. = "
                f"{r_nrm / max(float(bnrm), 1e-300):.5e}",
                flush=True,
            )
        success = r_nrm <= tol_bnrm or r_nrm == 0.0
        if times[-1] > max_seconds:
            break
    if bar is not None:
        bar.finish()

    res = jnp.full(maxit + 1, jnp.nan, dtype=dtype).at[: len(hist)].set(
        jnp.asarray(hist, dtype)
    )
    result = GmresResult(
        x=x,
        success=jnp.asarray(success),
        num_iter=jnp.asarray(it),
        num_matvec=jnp.asarray(nmv_total),
        res_norm=res,
        n_hist=jnp.asarray(len(hist)),
    )
    return result, times
