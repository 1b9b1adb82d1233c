"""2D quadrilateral mesh: connectivity, orientation, and geometry caches.

Capability parity with the reference's geometry layer
(``/root/reference/source/Mesh2D.cpp``, ``Element.cpp``, ``include/Edge.hpp``,
``include/Node.hpp``) re-designed array-first: instead of per-object
``Node``/``Edge``/``Element`` classes with virtual methods, the mesh stores
flat NumPy arrays (element->vertex table, edge tables, orientation signs) and
all metric evaluation (Jacobians, measures, normals, physical coordinates) is
vectorised over elements x quadrature points.  These static arrays are what
the jitted device operators close over.

Conventions (identical to the reference so index maps are interchangeable):
  * elements are bilinear quads with counter-clockwise vertices 0..3;
  * side s of an element connects local vertices (emap1[s], emap2[s]) with
    emap1 = [0,1,3,0], emap2 = [1,2,2,3]  (bottom, right, top, left);
  * an edge's ``delta`` is +1 if the second element traverses it in the same
    direction as the first, else -1;
  * edge normals point outward from the first element on the edge.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.quadrature import QuadratureRule

# side s of a quad runs from local vertex EDGE_V0[s] to EDGE_V1[s]
EDGE_V0 = np.array([0, 1, 3, 0])
EDGE_V1 = np.array([1, 2, 2, 3])

INTERIOR = 0
BOUNDARY = 1


@dataclass(frozen=True)
class ElementMetrics:
    """Per-(mesh, quadrature) collocated element geometry.

    jacobians: (nel, q, q, 2, 2) with J[..., a, b] = d x_a / d xi_b
    measures:  (nel, q, q) = det J
    coords:    (nel, q, q, 2) physical coordinates
    """

    jacobians: np.ndarray
    measures: np.ndarray
    coords: np.ndarray


@dataclass(frozen=True)
class EdgeMetrics:
    """Per-(edge-set, quadrature) collocated edge geometry.

    measures: (ne, q) arclength factor ds/dxi
    coords:   (ne, q, 2)
    normals:  (ne, q, 2) outward from the edge's first element
    """

    measures: np.ndarray
    coords: np.ndarray
    normals: np.ndarray


class Mesh2D:
    """Quadrilateral mesh defined by vertex coordinates and connectivity.

    Attributes (all NumPy, set in __init__):
      vertices          (nv, 2) float64
      elem_vertices     (nel, 4) int32          CCW vertex ids per element
      edge_vertices     (ne, 2) int32           endpoint vertex ids
      edge_elements     (ne, 2) int32           elements on the edge (-1 if none)
      edge_sides        (ne, 2) int32           side index within each element
      edge_delta        (ne,) int32             +-1 relative orientation
      edge_type         (ne,) int32             INTERIOR / BOUNDARY
      interior_edges, boundary_edges  int32 index lists (in edge-id order)
    """

    def __init__(self, vertices: np.ndarray, elem_vertices: np.ndarray):
        vertices = np.ascontiguousarray(np.asarray(vertices, dtype=np.float64))
        elem_vertices = np.ascontiguousarray(np.asarray(elem_vertices, dtype=np.int32))
        if vertices.ndim != 2 or vertices.shape[1] != 2:
            raise ValueError("vertices must have shape (nv, 2)")
        if elem_vertices.ndim != 2 or elem_vertices.shape[1] != 4:
            raise ValueError("elem_vertices must have shape (nel, 4)")
        self.vertices = vertices
        self.elem_vertices = elem_vertices
        self._build_edges()
        self._metric_cache: dict[str, ElementMetrics] = {}
        self._edge_metric_cache: dict[tuple, EdgeMetrics] = {}

    # ---------------------------------------------------------------- builders

    @classmethod
    def uniform_rect(
        cls, nx: int, ax: float, bx: float, ny: int, ay: float, by: float
    ) -> "Mesh2D":
        """Structured nx-by-ny grid of quads on [ax,bx] x [ay,by]."""
        xs = np.linspace(ax, bx, nx + 1)
        ys = np.linspace(ay, by, ny + 1)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        # vertex id (i, j) -> i + (nx+1) * j, matching the reference layout
        verts = np.stack([X.T.ravel(), Y.T.ravel()], axis=1)
        i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")

        def vid(ii, jj):
            return ii + (nx + 1) * jj

        ev = np.stack(
            [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)], axis=-1
        )
        # element order: x fastest (el = i + nx * j), like the reference
        ev = ev.transpose(1, 0, 2).reshape(-1, 4)
        return cls(verts, ev)

    @classmethod
    def from_vertices(cls, vertices: np.ndarray, elem_vertices: np.ndarray) -> "Mesh2D":
        return cls(vertices, elem_vertices)

    def _build_edges(self):
        nel = self.n_elem
        nv = len(self.vertices)

        # every (element, side) pair, in the reference's traversal order
        ev = self.elem_vertices
        c0 = ev[:, EDGE_V0]  # (nel, 4) start vertex of each side
        c1 = ev[:, EDGE_V1]  # (nel, 4) end vertex
        flat_c0 = c0.ravel()  # order: element-major, side within
        flat_c1 = c1.ravel()
        key = np.minimum(flat_c0, flat_c1).astype(np.int64) + np.int64(nv) * np.maximum(
            flat_c0, flat_c1
        )

        # first occurrence of each key defines the edge (and its id, in the same
        # order the reference assigns ids); the second occurrence is the
        # neighbouring element
        uniq, first_idx, inverse, counts = np.unique(
            key, return_index=True, return_inverse=True, return_counts=True
        )
        # an edge shared by 3+ element sides (non-manifold connectivity, e.g.
        # a duplicated element row) would silently mis-build the CG numbering
        if counts.max(initial=0) > 2:
            bad = uniq[np.argmax(counts)]
            raise ValueError(
                f"non-manifold mesh: edge ({bad % nv}, {bad // nv}) is shared "
                f"by {int(counts.max())} element sides"
            )

        from .. import native

        built = native.build_edges(self.elem_vertices, nv)
        if built is not None:
            (self.edge_vertices, self.edge_elements, self.edge_sides,
             self.edge_delta) = built
            self._finish_edges()
            return

        # renumber edges by order of first occurrence (np.unique sorts by key)
        order = np.argsort(first_idx, kind="stable")
        rank_of_uniq = np.empty_like(order)
        rank_of_uniq[order] = np.arange(len(order))
        edge_id_of_pair = rank_of_uniq[inverse]  # (nel*4,)

        ne = len(uniq)
        edge_elements = np.full((ne, 2), -1, dtype=np.int32)
        edge_sides = np.full((ne, 2), -1, dtype=np.int32)
        edge_vertices = np.zeros((ne, 2), dtype=np.int32)
        edge_delta = np.ones(ne, dtype=np.int32)

        pair_el = np.repeat(np.arange(nel, dtype=np.int32), 4)
        pair_side = np.tile(np.arange(4, dtype=np.int32), nel)

        e1 = rank_of_uniq  # edge id of each unique key
        edge_elements[e1, 0] = pair_el[first_idx]
        edge_sides[e1, 0] = pair_side[first_idx]
        edge_vertices[e1, 0] = flat_c0[first_idx]
        edge_vertices[e1, 1] = flat_c1[first_idx]

        second = np.ones(len(key), dtype=bool)
        second[first_idx] = False
        ps = np.nonzero(second)[0]  # at most one per edge (counts <= 2)
        es = edge_id_of_pair[ps]
        edge_elements[es, 1] = pair_el[ps]
        edge_sides[es, 1] = pair_side[ps]
        # same direction iff the neighbour starts the edge at the same vertex
        # where the first element started it
        edge_delta[es] = np.where(flat_c0[ps] == edge_vertices[es, 0], 1, -1)

        self.edge_vertices = edge_vertices
        self.edge_elements = edge_elements
        self.edge_sides = edge_sides
        self.edge_delta = edge_delta
        self._finish_edges()

    def _finish_edges(self):
        self.edge_type = np.where(
            self.edge_elements[:, 1] >= 0, INTERIOR, BOUNDARY
        ).astype(np.int32)
        self.boundary_edges = np.nonzero(self.edge_type == BOUNDARY)[0].astype(np.int32)
        self.interior_edges = np.nonzero(self.edge_type == INTERIOR)[0].astype(np.int32)

    # ---------------------------------------------------------------- queries

    @property
    def n_elem(self) -> int:
        return len(self.elem_vertices)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_edges(self) -> int:
        return len(self.edge_vertices)

    @property
    def max_element_order(self) -> int:
        """Polynomial order of the geometry map (1 for bilinear quads)."""
        return 1

    def edge_lengths(self) -> np.ndarray:
        d = self.vertices[self.edge_vertices[:, 1]] - self.vertices[self.edge_vertices[:, 0]]
        return np.hypot(d[:, 0], d[:, 1])

    def min_h(self) -> float:
        return float(self.edge_lengths().min())

    def max_h(self) -> float:
        return float(self.edge_lengths().max())

    # ---------------------------------------------------------------- geometry

    def element_corner_coords(self) -> np.ndarray:
        """(nel, 4, 2) physical coordinates of each element's vertices."""
        return self.vertices[self.elem_vertices]

    def physical_coordinates(self, xi: np.ndarray, eta: np.ndarray) -> np.ndarray:
        """Bilinear map at tensor points: returns (nel, len(xi), len(eta), 2)."""
        x = self.element_corner_coords()  # (nel, 4, 2)
        XI, ETA = np.meshgrid(xi, eta, indexing="ij")
        b = np.stack(
            [
                0.25 * (1 - XI) * (1 - ETA),
                0.25 * (1 + XI) * (1 - ETA),
                0.25 * (1 + XI) * (1 + ETA),
                0.25 * (1 - XI) * (1 + ETA),
            ],
            axis=-1,
        )  # (q, q, 4)
        return np.einsum("ijc,ecd->eijd", b, x)

    def jacobians(self, xi: np.ndarray, eta: np.ndarray) -> np.ndarray:
        """(nel, q, q, 2, 2): J[..., a, b] = d x_a / d xi_b at tensor points."""
        x = self.element_corner_coords()  # (nel, 4, 2)
        XI, ETA = np.meshgrid(xi, eta, indexing="ij")
        # d b / d xi and d b / d eta for the four bilinear shape functions
        db_dxi = np.stack(
            [-(1 - ETA), (1 - ETA), (1 + ETA), -(1 + ETA)], axis=-1
        ) * 0.25
        db_deta = np.stack(
            [-(1 - XI), -(1 + XI), (1 + XI), (1 - XI)], axis=-1
        ) * 0.25
        J_xi = np.einsum("ijc,ecd->eijd", db_dxi, x)  # (nel, q, q, 2) = dx/dxi
        J_eta = np.einsum("ijc,ecd->eijd", db_deta, x)
        return np.stack([J_xi, J_eta], axis=-1)  # (..., a, b) with b in {xi, eta}

    def element_metrics(self, quad: QuadratureRule) -> ElementMetrics:
        """Collocated Jacobians/measures/coords at quad x quad points (cached)."""
        key = quad.name
        if key not in self._metric_cache:
            J = self.jacobians(quad.x, quad.x)
            detJ = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
            X = self.physical_coordinates(quad.x, quad.x)
            self._metric_cache[key] = ElementMetrics(J, detJ, X)
        return self._metric_cache[key]

    def edge_metrics(self, quad: QuadratureRule, edges: np.ndarray | None = None) -> EdgeMetrics:
        """Collocated edge measures/coords/normals at quad points (cached).

        ``edges`` selects a subset by edge id (default: all edges).  Straight
        edges have constant measure |x1-x0|/2 and constant normal; the normal
        points outward from the first element (sign flips for sides 2, 3).
        """
        if edges is None:
            edges = np.arange(self.n_edges, dtype=np.int32)
        edges = np.asarray(edges, dtype=np.int32)
        key = (quad.name, edges.tobytes())
        if key not in self._edge_metric_cache:
            x0 = self.vertices[self.edge_vertices[edges, 0]]  # (ne, 2)
            x1 = self.vertices[self.edge_vertices[edges, 1]]
            d = x1 - x0
            length = np.hypot(d[:, 0], d[:, 1])
            meas = np.repeat((length / 2.0)[:, None], quad.n, axis=1)
            t = 0.5 * (quad.x + 1.0)
            coords = x0[:, None, :] + d[:, None, :] * t[None, :, None]
            sgn = np.where(np.isin(self.edge_sides[edges, 0], (2, 3)), -1.0, 1.0)
            normals = np.stack([sgn * d[:, 1] / length, -sgn * d[:, 0] / length], axis=1)
            normals = np.repeat(normals[:, None, :], quad.n, axis=1)
            self._edge_metric_cache[key] = EdgeMetrics(meas, coords, normals)
        return self._edge_metric_cache[key]
