"""Kronecker (tensor-product) fast path for global operators on rectilinear grids.

On a ``uniform_rect`` mesh every element is an axis-aligned rectangle, so the
global stiffness factorises exactly into assembled 1D operators,

    S  =  K1x (x) M1y  +  M1x (x) K1y,

and the weighted mass is ``E^T diag(Wq) E`` with per-direction block-banded
quadrature-evaluation matrices.  Stored dense, the whole operator apply
becomes a handful of N x N matmuls (N = nx*(nb-1)+1, e.g. 385 for the
reference Helmholtz config ``/root/reference/examples/Helmholtz.cpp:101-103``)
— dense matmul work with zero gathers, replacing the per-element einsum +
segment_sum path (``ops/stiffness.py``, ``ops/mass.py``) whose tiny trailing
dims (nb=4) make poorly shaped kernels.

The matmuls run at true fp32 ("highest") by default: a lower word may use
TF32 tensor cores on the GPU, which leaves an operator error that stalls
fp32 Krylov solves (docs/DTYPES.md).

Numerically identical to the generic path (same quadrature, same collocated
data); equality is checked in ``tests/test_kron.py``.  Only valid on a
``GridH1Space`` whose mesh is rectilinear — builders verify and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.quadrature import QuadratureRule
from .mass import collocate_mass
from .structured import GridH1Space


def _grid_1d(space: GridH1Space) -> tuple[np.ndarray, np.ndarray]:
    """1D node coordinates (xs, ys) of the grid numbering; validates that the
    mesh is rectilinear (tensor-product of the two 1D grids)."""
    nx, ny = space.grid
    s = space.n_basis - 1
    Nx, Ny = nx * s + 1, ny * s + 1
    X = space.coords[:, 0].reshape(Ny, Nx)
    Y = space.coords[:, 1].reshape(Ny, Nx)
    xs, ys = X[0], Y[:, 0]
    if not (np.allclose(X, xs[None, :]) and np.allclose(Y, ys[:, None])):
        raise ValueError("kron fast path requires a rectilinear grid mesh")
    return xs, ys


class KronStiffnessOp(NamedTuple):
    """S = K1x (x) M1y + M1x (x) K1y, all four 1D operators dense."""

    Kx: jax.Array  # (Nx, Nx) assembled 1D stiffness along x
    Mx: jax.Array  # (Nx, Nx) assembled 1D mass along x
    Ky: jax.Array  # (Ny, Ny)
    My: jax.Array  # (Ny, Ny)


def _assemble_1d(nodes: np.ndarray, s: int, Khat: np.ndarray, Mhat: np.ndarray):
    """Assemble global 1D stiffness/mass from reference-element matrices.

    ``nodes`` are the 1D grid nodes; element e spans nodes[e*s .. (e+1)*s].
    1D scaling: stiffness ~ 2/h, mass ~ h/2.
    """
    n_el = (len(nodes) - 1) // s
    N = len(nodes)
    K = np.zeros((N, N))
    M = np.zeros((N, N))
    for e in range(n_el):
        h = nodes[(e + 1) * s] - nodes[e * s]
        sl = slice(e * s, e * s + s + 1)
        K[sl, sl] += (2.0 / h) * Khat
        M[sl, sl] += (h / 2.0) * Mhat
    return K, M


def make_kron_stiffness_op(
    space: GridH1Space, dtype=jnp.float64, quad: QuadratureRule | None = None
) -> KronStiffnessOp:
    """1D-factorised equivalent of ``make_stiffness_op`` (same quadrature)."""
    nb = space.n_basis
    s = nb - 1
    if quad is None:
        quad = QuadratureRule(
            nb + space.mesh.max_element_order, QuadratureRule.GaussLegendre
        )
    P = space.basis.eval(quad.x)  # (nq, nb)
    D = space.basis.deriv(quad.x)
    Khat = D.T @ (quad.w[:, None] * D)
    Mhat = P.T @ (quad.w[:, None] * P)
    xs, ys = _grid_1d(space)
    Kx, Mx = _assemble_1d(xs, s, Khat, Mhat)
    Ky, My = _assemble_1d(ys, s, Khat, Mhat)
    to = lambda a: jnp.asarray(a, dtype=dtype)
    return KronStiffnessOp(Kx=to(Kx), Mx=to(Mx), Ky=to(Ky), My=to(My))


def apply_stiffness_kron(
    op: KronStiffnessOp, x: jax.Array, precision="highest"
) -> jax.Array:
    """y = S x as four dense matmuls (K, M symmetric so no transposes)."""
    Ny, Nx = op.Ky.shape[0], op.Kx.shape[0]
    X = x.reshape(Ny, Nx)
    mm = lambda a, b: jnp.matmul(a, b, precision=precision)
    Y = mm(mm(op.My, X), op.Kx) + mm(mm(op.Ky, X), op.Mx)
    return Y.reshape(-1)


class KronMassOp(NamedTuple):
    """M = (Ey (x) Ex)^T diag(Wq) (Ey (x) Ex): per-direction quadrature
    evaluation matrices + the collocated ``a * w * detJ`` grid."""

    Ex: jax.Array  # (nx*nq, Nx) block-banded 1D evaluation
    Ey: jax.Array  # (ny*nq, Ny)
    Wq: jax.Array  # (ny*nq, nx*nq) collocated weights


def _eval_matrix(P: np.ndarray, n_el: int, s: int) -> np.ndarray:
    """(n_el*nq, n_el*s+1) block matrix with P in each element row block."""
    nq, nb = P.shape
    E = np.zeros((n_el * nq, n_el * s + 1))
    for e in range(n_el):
        E[e * nq : (e + 1) * nq, e * s : e * s + nb] = P
    return E


def make_kron_mass_op(
    space: GridH1Space,
    coeff: np.ndarray | None = None,
    dtype=jnp.float64,
    n_quad: int | None = None,
) -> KronMassOp:
    """1D-factorised equivalent of ``make_mass_op`` — reuses its collocated
    ``wdetj`` so the two paths are bit-for-bit the same data."""
    _grid_1d(space)  # rectilinearity check
    nx, ny = space.grid
    s = space.n_basis - 1
    # host-side collocation (same data as make_mass_op, no device round-trip)
    P, wdetj = collocate_mass(space, coeff=coeff, n_quad=n_quad)
    nq = P.shape[0]
    wdetj = wdetj.reshape(ny, nx, nq, nq)  # [ey, ex, qy, qx]
    Wq = wdetj.transpose(0, 2, 1, 3).reshape(ny * nq, nx * nq)
    return KronMassOp(
        Ex=jnp.asarray(_eval_matrix(P, nx, s), dtype=dtype),
        Ey=jnp.asarray(_eval_matrix(P, ny, s), dtype=dtype),
        Wq=jnp.asarray(Wq, dtype=dtype),
    )


def apply_mass_kron(
    op: KronMassOp, x: jax.Array, precision="highest"
) -> jax.Array:
    """y = M x: evaluate on the quadrature grid, scale, integrate back."""
    Ny, Nx = op.Ey.shape[1], op.Ex.shape[1]
    X = x.reshape(Ny, Nx)
    mm = lambda a, b: jnp.matmul(a, b, precision=precision)
    T = mm(mm(op.Ey, X), op.Ex.T)
    U = op.Wq * T
    Y = mm(mm(op.Ey.T, U), op.Ex)
    return Y.reshape(-1)
