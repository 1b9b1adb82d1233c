"""Structured-grid fast path: CG assembly with zero arbitrary gathers.

Arbitrary gathers/scatters move several times the bytes of the einsums in a
matrix-free CG operator apply.  For ``uniform_rect`` meshes we instead
number DOFs in row-major grid order (``GridH1Space``); the element
gather/scatter then become nb*nb strided slices / strided adds, which XLA
vectorises fully.

The numbering change is solver-invisible (GMRES and solutions are
permutation-equivariant); any generic operator also works on a
``GridH1Space`` through the usual index tables.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.mesh2d import Mesh2D
from ..spaces.h1 import H1Space
from ..utils.basis import Basis


class GridH1Space(H1Space):
    """H1Space on a uniform_rect mesh with row-major grid DOF numbering.

    dofs[el, iy, ix] = (ey*(nb-1)+iy) * Nx + ex*(nb-1)+ix for el = ex + nx*ey.
    """

    def __init__(self, mesh: Mesh2D, basis: Basis, nx: int, ny: int):
        nb = basis.n
        if mesh.n_elem != nx * ny:
            raise ValueError("mesh does not match nx * ny")
        # the dof table and the strided-slice gather/scatter both assume
        # el = ex + nx*ey on an axis-aligned grid; a swapped (nx, ny) or a
        # permuted element order would silently pair the wrong metric data
        # ordering (not geometry): within each row x must increase, rows must
        # be grouped and increasing in y -- this catches swapped (nx, ny) and
        # permuted element ids while tolerating perturbed vertices (only the
        # kron path additionally requires an exact tensor-product grid)
        v0 = mesh.vertices[mesh.elem_vertices[:, 0]]
        xs = v0[:, 0].reshape(ny, nx)
        ys = v0[:, 1].reshape(ny, nx)
        ordered = np.all(np.diff(xs, axis=1) > 0) and np.all(
            np.diff(ys, axis=0) > 0
        )
        if ordered and ny > 1:
            ordered = bool(np.all(ys.max(axis=1)[:-1] < ys.min(axis=1)[1:]))
        if not ordered:
            raise ValueError(
                "element order is not row-major x-fastest (el = ex + nx*ey); "
                "build the mesh with Mesh2D.uniform_rect(nx, ..., ny, ...)"
            )
        self.mesh = mesh
        self.basis = basis
        self.grid = (nx, ny)
        s = nb - 1
        Nx, Ny = nx * s + 1, ny * s + 1
        ex, ey = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        iy, ix = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
        gx = ex[:, :, None, None] * s + ix[None, None]
        gy = ey[:, :, None, None] * s + iy[None, None]
        dofs = (gy * Nx + gx).transpose(1, 0, 2, 3).reshape(nx * ny, nb, nb)
        self.dofs = dofs.astype(np.int32)
        self.ndof = Nx * Ny
        self._set_coords()


def grid_gather(x: jax.Array, nx: int, ny: int, nb: int) -> jax.Array:
    """(ndof,) grid-ordered vector -> (nel, nb, nb) element tensors.

    Four block reshapes (interior / right edge / top edge / corner) instead
    of per-node gathers: element (ey, ex) covers grid rows s*ey..s*ey+s.
    """
    s = nb - 1
    x2 = x.reshape(ny * s + 1, nx * s + 1)
    core = x2[: ny * s, : nx * s].reshape(ny, s, nx, s).transpose(0, 2, 1, 3)
    right = x2[: ny * s, s::s].reshape(ny, s, nx, 1).transpose(0, 2, 1, 3)
    top = x2[s::s, : nx * s].reshape(ny, 1, nx, s).transpose(0, 2, 1, 3)
    corner = x2[s::s, s::s].reshape(ny, nx, 1, 1)
    upper = jnp.concatenate([core, right], axis=-1)  # (ny, nx, s, nb)
    lower = jnp.concatenate([top, corner], axis=-1)  # (ny, nx, 1, nb)
    xe = jnp.concatenate([upper, lower], axis=-2)  # (ny, nx, nb, nb)
    return xe.reshape(ny * nx, nb, nb)


def grid_scatter(ye: jax.Array, nx: int, ny: int, nb: int) -> jax.Array:
    """(nel, nb, nb) element tensors -> (ndof,) grid-ordered overlap-add.

    Four strided-slice adds (the inverse of grid_gather's block split)."""
    s = nb - 1
    Ny, Nx = ny * s + 1, nx * s + 1
    y2 = jnp.zeros((Ny, Nx), dtype=ye.dtype)
    ye = ye.reshape(ny, nx, nb, nb)
    core = ye[:, :, :s, :s].transpose(0, 2, 1, 3).reshape(ny * s, nx * s)
    right = ye[:, :, :s, s].transpose(0, 2, 1).reshape(ny * s, nx)
    top = ye[:, :, s, :s].reshape(ny, nx * s)
    corner = ye[:, :, s, s]
    y2 = y2.at[: ny * s, : nx * s].add(core)
    y2 = y2.at[: ny * s, s::s].add(right)
    y2 = y2.at[s::s, : nx * s].add(top)
    y2 = y2.at[s::s, s::s].add(corner)
    return y2.reshape(-1)


def apply_stiffness_structured(op, grid: tuple[int, int], x: jax.Array) -> jax.Array:
    """y = S x using strided-slice assembly (op from make_stiffness_op on a
    GridH1Space)."""
    from .stiffness import stiffness_element_kernel

    nx, ny = grid
    nb = op.P.shape[1]
    xe = grid_gather(x, nx, ny, nb)
    return grid_scatter(stiffness_element_kernel(op, xe), nx, ny, nb)


def apply_mass_structured(op, grid: tuple[int, int], x: jax.Array) -> jax.Array:
    """y = M x using strided-slice assembly (op from make_mass_op on a
    GridH1Space)."""
    from .mass import mass_element_kernel

    nx, ny = grid
    nb = op.P.shape[1]
    xe = grid_gather(x, nx, ny, nb)
    return grid_scatter(mass_element_kernel(op, xe), nx, ny, nb)
