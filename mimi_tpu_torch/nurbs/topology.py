"""Patch topology: MFEM-compatible NURBS dof numbering, boundary sides,
and refined-mesh counts.

The reference exposes mesh-count queries and a dof map
(the reference's py_solid.hpp and py_solid.cpp);
golden regression files are stored in MFEM's NURBS dof order, so we maintain
a permutation between our internal lexicographic order and MFEM order.

MFEM NURBS dof numbering (verified against tests/data/square-nurbs-3.mesh
and cube-nurbs-3.mesh control-point listings):
  1. patch-corner dofs, one per topological vertex, numbered by vertex id;
  2. edge-interior dofs, edges in mesh-file order, each oriented from its
     lower-numbered vertex to its higher-numbered vertex;
  3. (3D) face-interior dofs, faces in hex-local order with vertex lists
     {3,2,1,0},{0,1,5,4},{1,2,6,5},{2,3,7,6},{3,0,4,7},{4,5,6,7}; within a
     face, dofs start adjacent to the first listed vertex, fast axis toward
     the second listed vertex, slow axis toward the fourth;
  4. patch-interior dofs, lexicographic (first parametric index fastest).
"""

from __future__ import annotations

import numpy as np

from .mesh_io import MfemNurbsMesh
from .patch import NurbsPatch

# local corner (i,j[,k]) offsets in MFEM element vertex order
_QUAD_CORNERS = [(0, 0), (1, 0), (1, 1), (0, 1)]
_HEX_CORNERS = [
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
]
_HEX_FACES = [
    (3, 2, 1, 0), (0, 1, 5, 4), (1, 2, 6, 5),
    (2, 3, 7, 6), (3, 0, 4, 7), (4, 5, 6, 7),
]


class PatchTopology:
    """Single-patch topology with MFEM dof numbering.

    (Multi-patch meshes are not used by any reference test/example; the
    reader will raise for them until support is added.)
    """

    def __init__(self, mesh: MfemNurbsMesh):
        if len(mesh.elements) != 1:
            raise NotImplementedError(
                "multi-patch NURBS meshes not yet supported"
            )
        self.mesh = mesh
        self.dim = mesh.dimension
        self.elem_verts = mesh.elements[0][2]
        self.edges = list(mesh.edges)
        self.boundary = list(mesh.boundary)

    # ------------- dof numbering -------------
    def corner_grid_pos(self, vid: int, nc: list[int]):
        """Grid index tuple of topological vertex `vid`."""
        local = self.elem_verts.index(vid)
        if self.dim == 2:
            ij = _QUAD_CORNERS[local]
            return tuple((n - 1) if c else 0 for c, n in zip(ij, nc))
        ijk = _HEX_CORNERS[local]
        return tuple((n - 1) if c else 0 for c, n in zip(ijk, nc))

    def mfem_dof_grid(self, nc: list[int]) -> np.ndarray:
        """Array of shape nc (grid) holding the MFEM dof id of each control
        point; inverse gives lex->mfem permutation."""
        g = -np.ones(nc, dtype=np.int64)
        nv = len(self.elem_verts)

        # 1. corners
        for vid in self.elem_verts:
            g[self.corner_grid_pos(vid, nc)] = vid

        # 2. edges (file order, low->high vertex id)
        offset = nv
        for kv_idx, v0, v1 in self.edges:
            n_int = nc[kv_idx] - 2
            a, b = (v0, v1) if v0 < v1 else (v1, v0)
            pa = np.array(self.corner_grid_pos(a, nc))
            pb = np.array(self.corner_grid_pos(b, nc))
            direction = np.sign(pb - pa)
            axis = int(np.nonzero(direction)[0][0])
            step = int(direction[axis])
            pos = pa.copy()
            for t in range(1, nc[axis] - 1):
                pos[axis] = pa[axis] + step * t
                g[tuple(pos)] = offset + (t - 1)
            offset += n_int

        # 3. faces (3D only)
        if self.dim == 3:
            for face in _HEX_FACES:
                vids = [self.elem_verts[l] for l in face]
                p0 = np.array(self.corner_grid_pos(vids[0], nc))
                p1 = np.array(self.corner_grid_pos(vids[1], nc))
                p3 = np.array(self.corner_grid_pos(vids[3], nc))
                d_fast = np.sign(p1 - p0)
                d_slow = np.sign(p3 - p0)
                ax_f = int(np.nonzero(d_fast)[0][0])
                ax_s = int(np.nonzero(d_slow)[0][0])
                sf, ss = int(d_fast[ax_f]), int(d_slow[ax_s])
                nf, ns = nc[ax_f] - 2, nc[ax_s] - 2
                cnt = 0
                pos = p0.copy()
                for t_s in range(1, ns + 1):
                    for t_f in range(1, nf + 1):
                        pos[:] = p0
                        pos[ax_f] = p0[ax_f] + sf * t_f
                        pos[ax_s] = p0[ax_s] + ss * t_s
                        g[tuple(pos)] = offset + cnt
                        cnt += 1
                offset += nf * ns

        # 4. interior, lexicographic i-fastest
        interior = g == -1
        idx = np.argwhere(interior)
        # order interior dofs with i fastest: lexsort's last key is primary,
        # so keys (i, j[, k]) sort primarily by k, then j, then i.
        order = np.lexsort(tuple(idx[:, d] for d in range(self.dim)))
        for n, row in enumerate(idx[order]):
            g[tuple(row)] = offset + n
        assert g.min() >= 0
        return g

    def lex_to_mfem(self, nc: list[int]) -> np.ndarray:
        """perm[lex_flat] = mfem dof id, lex flat = i + n0*(j + n1*k)."""
        g = self.mfem_dof_grid(nc)
        # flatten with i fastest: transpose to (k, j, i) then ravel C-order
        return g.transpose(*range(self.dim - 1, -1, -1)).ravel()

    # ------------- boundary sides -------------
    def boundary_sides(self, nc: list[int]):
        """For each boundary element in the file: (attribute, axis, end,
        normal_sign) where axis is the fixed parametric direction, end is 0
        or 1, and normal_sign relates the file's vertex-order orientation
        (which MFEM boundary transformations — and hence surface normals —
        follow) to the +tangent-axis parameterization used by our tables."""
        sides = []
        for attr, geom, vids in self.boundary:
            pos = np.array([self.corner_grid_pos(v, nc) for v in vids])
            fixed = [
                d
                for d in range(self.dim)
                if np.all(pos[:, d] == pos[0, d])
            ]
            assert len(fixed) == 1, "boundary element is not a patch side"
            axis = fixed[0]
            end = 0 if pos[0, axis] == 0 else 1
            t_dims = [d for d in range(self.dim) if d != axis]
            if self.dim == 2:
                d01 = pos[1] - pos[0]
                sign = 1 if d01[t_dims[0]] > 0 else -1
            else:
                # quad face (a, b, c, d): xi1 along a->b, xi2 along a->d
                f1 = pos[1] - pos[0]
                f2 = pos[3] - pos[0]
                i = int(np.nonzero(f1)[0][0])
                j = int(np.nonzero(f2)[0][0])
                s1 = 1 if f1[i] > 0 else -1
                s2 = 1 if f2[j] > 0 else -1
                orient = 1 if (i, j) == (t_dims[0], t_dims[1]) else -1
                sign = s1 * s2 * orient
            sides.append((attr, axis, end, sign))
        return sides

    # ------------- counts (MFEM mesh queries) -------------
    @staticmethod
    def counts(spans: list[int], n_cp: list[int]):
        """(n_vertices, n_elements, n_boundary_elements, n_subelements).

        Matches mfem queries used by the reference
        (py_solid.hpp:132-158): "vertices" = control points, elements =
        knot spans, boundary elements = boundary-face spans, subelements =
        interior mesh edges (2D) / faces (3D) of the span grid.
        """
        dim = len(spans)
        n_vertices = int(np.prod(n_cp))
        n_elements = int(np.prod(spans))
        if dim == 2:
            e1, e2 = spans
            n_bdr = 2 * e1 + 2 * e2
            n_sub = e1 * (e2 + 1) + e2 * (e1 + 1)
        elif dim == 3:
            e1, e2, e3 = spans
            n_bdr = 2 * (e1 * e2 + e2 * e3 + e1 * e3)
            n_sub = (
                e1 * e2 * (e3 + 1)
                + e2 * e3 * (e1 + 1)
                + e1 * e3 * (e2 + 1)
            )
        else:
            n_bdr = 2
            n_sub = spans[0] + 1
        return n_vertices, n_elements, n_bdr, n_sub


def build_patch_from_mesh(mesh: MfemNurbsMesh):
    """Constructs (NurbsPatch in lex order, PatchTopology, lex->mfem perm)."""
    topo = PatchTopology(mesh)
    nc = [len(kv) - p - 1 for kv, p in zip(mesh.knot_vectors, mesh.knot_degrees)]
    perm = topo.lex_to_mfem(nc)  # perm[lex] = mfem
    n = int(np.prod(nc))
    cps_lex = np.empty((n, mesh.control_points.shape[1]))
    w_lex = np.empty(n)
    cps_lex[:] = mesh.control_points[perm]
    w_lex[:] = mesh.weights[perm]
    patch = NurbsPatch(mesh.knot_degrees, mesh.knot_vectors, cps_lex, w_lex)
    return patch, topo, perm
