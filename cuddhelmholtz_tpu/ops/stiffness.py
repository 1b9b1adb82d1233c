"""Matrix-free stiffness operator y = (grad u, grad v).

Parity with the reference ``StiffnessMatrix``
(``/root/reference/source/StiffnessMatrix.cpp``): setup collocates the
symmetric contravariant metric ``G = w J^{-T} J^{-1} det J`` (entries A, B, C)
on a Gauss-Legendre grid; the action is gather -> 1D interpolate+differentiate
-> contravariant flux -> transpose-integrate -> scatter-add, all as batched
einsums + segment_sum.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..spaces.h1 import H1Space
from ..utils.quadrature import QuadratureRule
from .mass import gather_elements, scatter_elements


class StiffnessOp(NamedTuple):
    """dofs (nel,nb,nb); P, D (nq,nb); A,B,C (nel,nq,nq) at [el,qy,qx]."""

    dofs: jax.Array
    P: jax.Array
    D: jax.Array
    A: jax.Array
    B: jax.Array
    C: jax.Array
    ndof: int


def geometric_factors(space: H1Space, quad: QuadratureRule) -> tuple[np.ndarray, ...]:
    """A, B, C with layout (nel, qy, qx).

    With J[..., a, b] = d x_a / d xi_b:
      A =  w (y_eta^2 + x_eta^2) / detJ      (multiplies u_xi in flux_xi)
      B = -w (x_xi x_eta + y_xi y_eta) / detJ
      C =  w (x_xi^2 + y_xi^2) / detJ
    """
    metrics = space.mesh.element_metrics(quad)
    J = metrics.jacobians  # (nel, qx_i, qy_j, a, b)
    x_xi, x_eta = J[..., 0, 0], J[..., 0, 1]
    y_xi, y_eta = J[..., 1, 0], J[..., 1, 1]
    detj = x_xi * y_eta - x_eta * y_xi
    w2 = np.outer(quad.w, quad.w)  # (qx, qy)
    A = w2 * (y_eta * y_eta + x_eta * x_eta) / detj
    B = -w2 * (y_xi * y_eta + x_xi * x_eta) / detj
    C = w2 * (y_xi * y_xi + x_xi * x_xi) / detj
    # transpose to [el, qy, qx]
    return A.transpose(0, 2, 1), B.transpose(0, 2, 1), C.transpose(0, 2, 1)


def make_stiffness_op(
    space: H1Space, dtype=jnp.float64, quad: QuadratureRule | None = None
) -> StiffnessOp:
    nb = space.n_basis
    if quad is None:
        quad = QuadratureRule(
            nb + space.mesh.max_element_order, QuadratureRule.GaussLegendre
        )
    P = space.basis.eval(quad.x)
    D = space.basis.deriv(quad.x)
    A, B, C = geometric_factors(space, quad)
    return StiffnessOp(
        dofs=jnp.asarray(space.dofs),
        P=jnp.asarray(P, dtype=dtype),
        D=jnp.asarray(D, dtype=dtype),
        A=jnp.asarray(A, dtype=dtype),
        B=jnp.asarray(B, dtype=dtype),
        C=jnp.asarray(C, dtype=dtype),
        ndof=space.ndof,
    )


def stiffness_element_kernel(op: StiffnessOp, xe: jax.Array) -> jax.Array:
    """(nel, iy, ix) element tensors -> weak-Laplacian element contributions.

    The sum-factorised einsum chain shared by every assembly flavour
    (arbitrary-gather, structured strided-slice, element-sharded)."""
    tP = jnp.einsum("qi,eji->ejq", op.P, xe)  # (nel, iy, qx)
    tD = jnp.einsum("qi,eji->ejq", op.D, xe)
    ux = jnp.einsum("rj,ejq->erq", op.P, tD)  # du/dxi  at (qy, qx)
    uy = jnp.einsum("rj,ejq->erq", op.D, tP)  # du/deta at (qy, qx)
    fx = op.A * ux + op.B * uy
    fy = op.B * ux + op.C * uy
    sx = jnp.einsum("qi,erq->eri", op.D, fx)  # integrate flux_xi against dphi/dxi
    sy = jnp.einsum("qi,erq->eri", op.P, fy)
    return jnp.einsum("rj,eri->eji", op.P, sx) + jnp.einsum("rj,eri->eji", op.D, sy)


def apply_stiffness(op: StiffnessOp, x: jax.Array) -> jax.Array:
    """y = S x: weak Laplacian with the collocated metric."""
    xe = gather_elements(op.dofs, x)  # (nel, iy, ix)
    ye = stiffness_element_kernel(op, xe)
    return scatter_elements(op.dofs, ye, op.ndof)
