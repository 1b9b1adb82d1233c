"""Matrix-free (weighted) mass operator and its lumped diagonal inverse.

Parity with the reference ``MassMatrix`` / ``DiagInvMassMatrix``
(``/root/reference/source/MassMatrix.cpp``): setup collocates
``a * w_i * w_j * detJ`` on a Gauss-Legendre grid per element; the action is
gather -> 1D interpolation (sum factorisation) -> pointwise scale ->
transpose-interpolation -> scatter-add.

Design: the per-element kernels become batched einsums (matmuls over the
element batch dimension) and the atomicAdd assembly becomes a
deterministic ``segment_sum``.  All index maps are static arrays baked at
setup.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..spaces.h1 import H1Space
from ..utils.quadrature import QuadratureRule


class MassOp(NamedTuple):
    """Collocated mass-operator data.

    dofs:  (nel, nb, nb) int32   [el, iy, ix] -> global DOF
    P:     (nq, nb)              1D basis-to-quadrature interpolation
    wdetj: (nel, nq, nq)         a * w_qx * w_qy * detJ at [el, qy, qx]
    ndof:  () int32              number of global DOFs (static via .shape use)
    """

    dofs: jax.Array
    P: jax.Array
    wdetj: jax.Array
    ndof: int


def collocate_mass(
    space: H1Space,
    coeff: np.ndarray | jax.Array | None = None,
    n_quad: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side collocated mass data ``(P, a*w*w*detJ)`` (NumPy).

    ``coeff`` is a nodal global vector (a at the GLL nodes), interpolated to
    the quadrature grid like the reference (``MassMatrix.cpp:103-135``).
    Quadrature size defaults to the reference's choices: nb + mesh order for
    a == 1, 1 + 3 nb / 2 + mesh order for variable a.
    """
    nb = space.n_basis
    order = space.mesh.max_element_order
    if n_quad is None:
        n_quad = nb + order if coeff is None else 1 + (3 * nb) // 2 + order
    quad = QuadratureRule(n_quad, QuadratureRule.GaussLegendre)
    P = space.basis.eval(quad.x)  # (nq, nb)
    metrics = space.mesh.element_metrics(quad)
    detj = metrics.measures.transpose(0, 2, 1)  # (nel, qy, qx)
    w2 = np.outer(quad.w, quad.w)  # (qy, qx)
    wdetj = w2[None] * detj
    if coeff is not None:
        a_e = np.asarray(coeff)[space.dofs]  # (nel, iy, ix)
        a_q = np.einsum("qi,rj,eji->erq", P, P, a_e)  # (nel, qy, qx)
        wdetj = wdetj * a_q
    return P, wdetj


def make_mass_op(
    space: H1Space,
    coeff: np.ndarray | jax.Array | None = None,
    dtype=jnp.float64,
    n_quad: int | None = None,
) -> MassOp:
    """Build device mass-operator data for ``(a(x) u, v)`` on ``space``
    (see ``collocate_mass`` for the quadrature conventions)."""
    P, wdetj = collocate_mass(space, coeff, n_quad)
    return MassOp(
        dofs=jnp.asarray(space.dofs),
        P=jnp.asarray(P, dtype=dtype),
        wdetj=jnp.asarray(wdetj, dtype=dtype),
        ndof=space.ndof,
    )


def variable_coeff_n_quad(space: H1Space) -> int:
    """The reference's quadrature size for a variable coefficient
    (``MassMatrix.cpp:108``): 1 + 3*nb/2 + mesh order."""
    return 1 + (3 * space.n_basis) // 2 + space.mesh.max_element_order


def mass_op_with_coeff(base: MassOp, coeff: jax.Array) -> MassOp:
    """Re-weight a unit-coefficient ``MassOp`` by a nodal field, traceably.

    ``base`` must be built with ``make_mass_op(space, coeff=None,
    n_quad=variable_coeff_n_quad(space))`` so its quadrature matches the
    variable-coefficient collocation rule.  Because the collocation
    ``a_q = P a_e P^T`` runs in jnp, the returned operator is a
    differentiable function of ``coeff`` — the setup path for
    ``jax.grad``-able solves (``solvers/implicit.py``)."""
    a_e = jnp.take(coeff, base.dofs, axis=0).astype(base.P.dtype)  # (nel, iy, ix)
    a_q = jnp.einsum("qi,rj,eji->erq", base.P, base.P, a_e)
    return base._replace(wdetj=base.wdetj * a_q)


def gather_elements(dofs: jax.Array, x: jax.Array) -> jax.Array:
    """x[dofs]: (nel, nb, nb) element tensors from the global vector."""
    return jnp.take(x, dofs, axis=0)


def scatter_elements(dofs: jax.Array, ye: jax.Array, ndof: int) -> jax.Array:
    """Deterministic CG assembly: sum element contributions per global DOF."""
    return jax.ops.segment_sum(
        ye.reshape(-1), dofs.reshape(-1), num_segments=ndof
    )


def mass_element_kernel(op: MassOp, xe: jax.Array) -> jax.Array:
    """(nel, iy, ix) element tensors -> weighted-mass element contributions.

    Shared by the arbitrary-gather, structured strided-slice, and
    element-sharded assembly flavours."""
    t = jnp.einsum("qi,eji->ejq", op.P, xe)  # interp x -> (nel, iy, qx)
    u = jnp.einsum("rj,ejq->erq", op.P, t)  # interp y -> (nel, qy, qx)
    u = u * op.wdetj
    t = jnp.einsum("qi,erq->eri", op.P, u)  # integrate x -> (nel, qy, ix)
    return jnp.einsum("rj,eri->eji", op.P, t)  # integrate y -> (nel, iy, ix)


def apply_mass(op: MassOp, x: jax.Array) -> jax.Array:
    """y = M x (matrix-free, batched over elements)."""
    xe = gather_elements(op.dofs, x)  # (nel, iy, ix)
    ye = mass_element_kernel(op, xe)
    return scatter_elements(op.dofs, ye, op.ndof)


class DiagInvMassOp(NamedTuple):
    """p = 1 / diag(M) via GLL collocation lumping (``MassMatrix.cpp:241-334``)."""

    p: jax.Array


def make_diag_inv_mass_op(
    space: H1Space, coeff: np.ndarray | None = None, dtype=jnp.float64
) -> DiagInvMassOp:
    nb = space.n_basis
    quad = space.basis.quadrature  # GLL collocation: diagonal lumping
    metrics = space.mesh.element_metrics(quad)
    detj = metrics.measures.transpose(0, 2, 1)  # (nel, iy, ix)
    m_e = np.outer(quad.w, quad.w)[None] * detj
    if coeff is not None:
        m_e = m_e * np.asarray(coeff)[space.dofs]
    diag = np.zeros(space.ndof, dtype=np.float64)
    np.add.at(diag, space.dofs.reshape(-1), m_e.reshape(-1))
    return DiagInvMassOp(p=jnp.asarray(1.0 / diag, dtype=dtype))


def apply_diag_inv_mass(op: DiagInvMassOp, x: jax.Array) -> jax.Array:
    return op.p * x


def lumped_mass_diagonal(space: H1Space) -> np.ndarray:
    """Global lumped mass diagonal (host-side, used by DDH setup)."""
    quad = space.basis.quadrature
    metrics = space.mesh.element_metrics(quad)
    detj = metrics.measures.transpose(0, 2, 1)
    m_e = np.outer(quad.w, quad.w)[None] * detj
    diag = np.zeros(space.ndof, dtype=np.float64)
    np.add.at(diag, space.dofs.reshape(-1), m_e.reshape(-1))
    return diag
