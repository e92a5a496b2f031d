"""Multi-patch NURBS FE space with shared (conforming) interface dofs.

Counterpart of mimi_tpu/fem/multipatch.py.  A global dof numbering over
all patches follows the MFEM NURBS convention (vertex dofs by vertex id,
edge-interior dofs in file edge order walking from the lower- to the
higher-numbered vertex, 3D face-interior dofs in first-appearance order
over the elements' local faces, patch-interior dofs per patch in element
order); per-patch quadrature tables carry the shared numbering in `conn`,
and boundary tables follow the mesh file's boundary section.

Assembly needs nothing new: the scatter-add over global dofs makes
interface continuity automatic.  `iter_domain_tables` yields the tables
patch by patch, so a caller can cast and move each patch's float64 tables
before the next patch is built (parallel/sharding.py build_problem).

Scope: patches share degrees (conforming spaces), interface knot vectors
are shared through the file's per-edge knot-vector indices, and patch
axes follow the orientation of their knot vectors.
"""

from __future__ import annotations

import numpy as np

from ..nurbs.mesh_io import MfemNurbsMesh
from ..nurbs.patch import NurbsPatch
from ..nurbs.topology import _QUAD_CORNERS, _HEX_CORNERS, _HEX_FACES
from .space import (
    BoundaryTables,
    DomainTables,
    patch_domain_tables,
    patch_side_tables,
)


class MultiPatchTopology:
    """Global MFEM-style dof numbering over a conforming multi-patch
    NURBS mesh."""

    def __init__(self, mesh: MfemNurbsMesh):
        self.mesh = mesh
        self.dim = mesh.dimension
        self.n_patches = len(mesh.elements)
        corners = _QUAD_CORNERS if self.dim == 2 else _HEX_CORNERS
        self._corners = corners
        # patch axis -> (kv index): the patch edge from local corner 0
        # along axis a ends at local corner 1 (a=0), 3 (a=1), 4 (a=2)
        axis_end_local = [1, 3, 4][: self.dim]
        edge_kv = {}
        for kvi, v0, v1 in mesh.edges:
            edge_kv[frozenset((v0, v1))] = kvi
        self.patch_kv = []  # per patch: list of kv index per axis
        for attr, geom, verts in mesh.elements:
            kvs = []
            for a in range(self.dim):
                v0 = verts[0]
                v1 = verts[axis_end_local[a]]
                key = frozenset((v0, v1))
                if key not in edge_kv:
                    raise ValueError(
                        f"no knot-vector edge for patch axis {a} "
                        f"(vertices {v0}-{v1})"
                    )
                kvs.append(edge_kv[key])
            self.patch_kv.append(kvs)

    def corner_grid_pos(self, p: int, vid: int, nc_p: list[int]):
        verts = self.mesh.elements[p][2]
        local = verts.index(vid)
        offs = self._corners[local]
        return tuple((n - 1) if c else 0 for c, n in zip(offs, nc_p))

    def patch_nc(self, p: int, nc_of_kv: list[int]) -> list[int]:
        return [nc_of_kv[k] for k in self.patch_kv[p]]

    def global_grids(self, nc_of_kv: list[int]):
        """Per-patch global-dof grids (shape = patch nc) + total count."""
        mesh = self.mesh
        dim = self.dim
        grids = [
            -np.ones(self.patch_nc(p, nc_of_kv), dtype=np.int64)
            for p in range(self.n_patches)
        ]
        # 1. corners by vertex id
        for p, (attr, geom, verts) in enumerate(mesh.elements):
            for vid in verts:
                grids[p][self.corner_grid_pos(p, vid, grids[p].shape)] = vid
        offset = mesh.n_vertices
        # 2. edge interiors, file order, walking low->high vertex id
        edge_off = {}
        for kvi, v0, v1 in mesh.edges:
            key = frozenset((v0, v1))
            if key in edge_off:
                continue
            edge_off[key] = offset
            offset += nc_of_kv[kvi] - 2
        for p in range(self.n_patches):
            nc_p = grids[p].shape
            verts = mesh.elements[p][2]
            vset = set(verts)
            for kvi, v0, v1 in mesh.edges:
                if v0 not in vset or v1 not in vset:
                    continue
                a, b = (v0, v1) if v0 < v1 else (v1, v0)
                pa = np.array(self.corner_grid_pos(p, a, nc_p))
                pb = np.array(self.corner_grid_pos(p, b, nc_p))
                diff = pb - pa
                nz = np.nonzero(diff)[0]
                if len(nz) != 1:
                    continue  # vertex pair is a patch diagonal, not an edge
                axis = int(nz[0])
                step = int(np.sign(diff[axis]))
                base = edge_off[frozenset((v0, v1))]
                pos = pa.copy()
                for t in range(1, nc_p[axis] - 1):
                    pos[axis] = pa[axis] + step * t
                    grids[p][tuple(pos)] = base + (t - 1)
        # 3. face interiors (3D), first-appearance canonical orientation
        if dim == 3:
            face_canon = {}
            face_off = {}
            for p, (attr, geom, verts) in enumerate(mesh.elements):
                nc_p = grids[p].shape
                for face in _HEX_FACES:
                    vids = tuple(verts[l] for l in face)
                    key = frozenset(vids)
                    if key in face_canon:
                        continue
                    face_canon[key] = vids
                    p0 = np.array(self.corner_grid_pos(p, vids[0], nc_p))
                    p1 = np.array(self.corner_grid_pos(p, vids[1], nc_p))
                    p3 = np.array(self.corner_grid_pos(p, vids[3], nc_p))
                    ax_f = int(np.nonzero(p1 - p0)[0][0])
                    ax_s = int(np.nonzero(p3 - p0)[0][0])
                    face_off[key] = offset
                    offset += (nc_p[ax_f] - 2) * (nc_p[ax_s] - 2)
            for p, (attr, geom, verts) in enumerate(mesh.elements):
                nc_p = grids[p].shape
                vset = set(verts)
                for key, vids in face_canon.items():
                    if not key <= vset:
                        continue
                    p0 = np.array(self.corner_grid_pos(p, vids[0], nc_p))
                    p1 = np.array(self.corner_grid_pos(p, vids[1], nc_p))
                    p3 = np.array(self.corner_grid_pos(p, vids[3], nc_p))
                    d_f = p1 - p0
                    d_s = p3 - p0
                    ax_f = int(np.nonzero(d_f)[0][0])
                    ax_s = int(np.nonzero(d_s)[0][0])
                    sf = int(np.sign(d_f[ax_f]))
                    ss = int(np.sign(d_s[ax_s]))
                    nf, ns = nc_p[ax_f] - 2, nc_p[ax_s] - 2
                    base = face_off[key]
                    cnt = 0
                    pos = p0.copy()
                    for t_s in range(1, ns + 1):
                        for t_f in range(1, nf + 1):
                            pos[:] = p0
                            pos[ax_f] = p0[ax_f] + sf * t_f
                            pos[ax_s] = p0[ax_s] + ss * t_s
                            grids[p][tuple(pos)] = base + cnt
                            cnt += 1
        # 4. patch interiors, element order, lexicographic i-fastest
        for p in range(self.n_patches):
            g = grids[p]
            idx = np.argwhere(g == -1)
            order = np.lexsort(tuple(idx[:, d_] for d_ in range(dim)))
            for n, row in enumerate(idx[order]):
                g[tuple(row)] = offset + n
            offset += len(idx)
        return grids, offset

    def boundary_patch_sides(self, nc_of_kv):
        """Per boundary-file entry: (attr, patch, axis, end, normal_sign)."""
        out = []
        for attr, geom, vids in self.mesh.boundary:
            placed = False
            for p, (pattr, pgeom, verts) in enumerate(self.mesh.elements):
                if not set(vids) <= set(verts):
                    continue
                nc_p = self.patch_nc(p, nc_of_kv)
                pos = np.array(
                    [self.corner_grid_pos(p, v, nc_p) for v in vids]
                )
                fixed = [
                    d_
                    for d_ in range(self.dim)
                    if np.all(pos[:, d_] == pos[0, d_])
                ]
                if len(fixed) != 1:
                    continue
                axis = fixed[0]
                end = 0 if pos[0, axis] == 0 else 1
                t_dims = [d_ for d_ in range(self.dim) if d_ != axis]
                if self.dim == 2:
                    d01 = pos[1] - pos[0]
                    sign = 1 if d01[t_dims[0]] > 0 else -1
                else:
                    f1 = pos[1] - pos[0]
                    f2 = pos[3] - pos[0]
                    i = int(np.nonzero(f1)[0][0])
                    j = int(np.nonzero(f2)[0][0])
                    s1 = 1 if f1[i] > 0 else -1
                    s2 = 1 if f2[j] > 0 else -1
                    orient = 1 if (i, j) == (t_dims[0], t_dims[1]) else -1
                    sign = s1 * s2 * orient
                out.append((attr, p, axis, end, sign))
                placed = True
                break
            if not placed:
                raise ValueError(
                    f"boundary element {vids} is not a side of any patch"
                )
        return out


class MultiPatchFESpace:
    """Vector-valued NURBS FE space over a conforming multi-patch mesh.

    Exposes the same surface the assembly layer consumes from the
    single-patch FESpace: n_dof/n_vdof/dim/para_dim/x_ref,
    domain_tables, boundary_tables, side_dofs, boundary_dof_mask."""

    def __init__(
        self,
        mesh: MfemNurbsMesh,
        elevate: int = 0,
        subdivide: int = 0,
        refine_spans=None,
    ):
        self.topo = MultiPatchTopology(mesh)
        self.dim = mesh.dimension
        self.para_dim = mesh.dimension
        topo = self.topo

        # unrefined global numbering -> per-patch control points
        nc0 = [
            len(kv) - p - 1
            for kv, p in zip(mesh.knot_vectors, mesh.knot_degrees)
        ]
        grids0, _ = topo.global_grids(nc0)
        self.patches = []
        for p in range(topo.n_patches):
            gflat = grids0[p].transpose(
                *range(self.dim - 1, -1, -1)
            ).ravel()  # lex order, i fastest
            degrees = [mesh.knot_degrees[k] for k in topo.patch_kv[p]]
            kvs = [mesh.knot_vectors[k].copy() for k in topo.patch_kv[p]]
            patch = NurbsPatch(
                degrees,
                kvs,
                mesh.control_points[gflat].copy(),
                mesh.weights[gflat].copy(),
            )
            if elevate > 0:
                patch.elevate_degrees(elevate)
            for _ in range(subdivide):
                patch.uniform_refine()
            if refine_spans is not None:
                patch.refine_to(refine_spans)
            self.patches.append(patch)
        if len({tuple(pt.degrees) for pt in self.patches}) != 1:
            raise ValueError("patches must share degrees")

        # refined knot-vector control counts (shared kvs refine alike)
        nc_of_kv = list(nc0)
        for p in range(topo.n_patches):
            for a, kvi in enumerate(topo.patch_kv[p]):
                nc_of_kv[kvi] = self.patches[p].n_ctrl()[a]
        self._nc_of_kv = nc_of_kv
        self.grids, self.n_dof = topo.global_grids(nc_of_kv)
        self.n_vdof = self.n_dof * self.dim

        # global reference control net (interface rows written twice with
        # identical values — conforming refinement is deterministic)
        x_ref = np.zeros((self.n_dof, self.dim))
        w_ref = np.zeros(self.n_dof)
        for p, patch in enumerate(self.patches):
            gflat = self._gflat(p)
            prev = w_ref[gflat]
            both = prev > 0
            if both.any():
                if not np.allclose(
                    x_ref[gflat][both],
                    patch.control_points[both],
                    atol=1e-9,
                ):
                    raise ValueError(
                        "non-conforming patch interface (control points "
                        "disagree)"
                    )
            x_ref[gflat] = patch.control_points
            w_ref[gflat] = patch.weights
        self.x_ref = x_ref
        self._bsides = topo.boundary_patch_sides(nc_of_kv)
        self.sides = [
            (attr, axis, end, sign)
            for attr, p, axis, end, sign in self._bsides
        ]

    # ---------- mesh-count queries (PySolid parity) ----------
    def counts(self):
        """(n_vertices, n_elements, n_boundary_elements, n_subelements)
        of the refined multi-patch mesh: control points are shared on
        conforming interfaces, and interface subelement faces/edges are
        counted once (MFEM mesh-query semantics)."""
        from ..nurbs.topology import PatchTopology

        n_vertices = self.n_dof
        n_elements = 0
        n_sub = 0
        per_patch_sides = {}
        for p, patch in enumerate(self.patches):
            spans = patch.n_spans()
            _, n_el_p, _, n_sub_p = PatchTopology.counts(
                spans, patch.n_ctrl()
            )
            n_elements += n_el_p
            n_sub += n_sub_p
            # collect this patch's side keys (corner vertex-id sets)
            verts = self.topo.mesh.elements[p][2]
            corners = self.topo._corners
            dim = self.dim
            for axis in range(dim):
                for end in (0, 1):
                    vids = frozenset(
                        verts[l]
                        for l, offs in enumerate(corners)
                        if offs[axis] == end
                    )
                    # span count of the side's tangent grid
                    t_spans = [
                        spans[d_] for d_ in range(dim) if d_ != axis
                    ]
                    face_spans = int(np.prod(t_spans))
                    per_patch_sides.setdefault(vids, []).append(
                        face_spans
                    )
        # interfaces appear as the same vertex-id set on two patches:
        # their subelement faces were counted twice in the per-patch
        # totals (2D: n_sub counts all grid edges; 3D: all grid faces)
        for vids, occurrences in per_patch_sides.items():
            if len(occurrences) == 2:
                n_sub -= occurrences[0]
        n_bdr = 0
        for attr, p, axis, end, _sign in self._bsides:
            spans = self.patches[p].n_spans()
            t_spans = [
                spans[d_] for d_ in range(self.dim) if d_ != axis
            ]
            n_bdr += int(np.prod(t_spans))
        return n_vertices, n_elements, n_bdr, n_sub

    def _gflat(self, p):
        return (
            self.grids[p]
            .transpose(*range(self.dim - 1, -1, -1))
            .ravel()
        )

    def _weights_grid(self, p):
        patch = self.patches[p]
        nc = patch.n_ctrl()
        return np.asarray(patch.weights).reshape(*nc[::-1]).transpose(
            *range(self.dim - 1, -1, -1)
        )

    # ---------- tables ----------
    def iter_domain_tables(self, quadrature_order: int = -1):
        """The domain tables of each patch in turn, `conn` in the global
        numbering; elements concatenate patch-wise."""
        for p, patch in enumerate(self.patches):
            t = patch_domain_tables(
                patch,
                self._weights_grid(p),
                np.asarray(patch.control_points),
                quadrature_order,
            )
            t.conn = self._gflat(p)[t.conn]
            yield t
            del t  # the caller may drop this patch's tables before the next build

    def domain_tables(self, quadrature_order: int = -1) -> DomainTables:
        parts = list(self.iter_domain_tables(quadrature_order))
        if len({t.N.shape[1:] for t in parts}) != 1:
            raise ValueError("patch quadrature tables disagree in shape")
        return DomainTables(
            conn=np.concatenate([t.conn for t in parts]),
            N=np.concatenate([t.N for t in parts]),
            dN_dX=np.concatenate([t.dN_dX for t in parts]),
            w_detJ=np.concatenate([t.w_detJ for t in parts]),
            n_q=parts[0].n_q,
        )

    def boundary_tables(self, quadrature_order: int = -1) -> BoundaryTables:
        conn_l, N_l, dN_l, wq_l, detJ_l, attr_l, sign_l = (
            [], [], [], [], [], [], [],
        )
        for attr, p, axis, end, n_sign in self._bsides:
            conn_g, Nf, dNf, wqf, detJ = patch_side_tables(
                self.patches[p],
                self._weights_grid(p),
                self.grids[p],
                self.x_ref,
                axis,
                end,
                quadrature_order,
            )
            conn_l.append(conn_g)
            N_l.append(Nf)
            dN_l.append(dNf)
            wq_l.append(wqf)
            detJ_l.append(detJ)
            attr_l.append(np.full(len(conn_g), attr, dtype=np.int64))
            sign_l.append(np.full(len(conn_g), n_sign, dtype=np.float64))
        return BoundaryTables(
            conn=np.concatenate(conn_l),
            N=np.concatenate(N_l),
            dN_dxi=np.concatenate(dN_l),
            wq=np.concatenate(wq_l),
            detJ_ref=np.concatenate(detJ_l),
            attr=np.concatenate(attr_l),
            normal_sign=np.concatenate(sign_l),
        )

    # ---------- boundary dofs ----------
    def side_dofs(self, bid: int) -> np.ndarray:
        dofs = []
        for attr, p, axis, end, _sign in self._bsides:
            if attr != bid + 1:
                continue
            nc_p = self.grids[p].shape
            sel = [slice(None)] * self.dim
            sel[axis] = 0 if end == 0 else nc_p[axis] - 1
            dofs.append(self.grids[p][tuple(sel)].ravel())
        if not dofs:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(dofs))

    def boundary_dof_mask(self, dirichlet: dict) -> np.ndarray:
        mask = np.zeros((self.n_dof, self.dim), dtype=bool)
        for bid, dims in dirichlet.items():
            sd = self.side_dofs(bid)
            for c in dims:
                mask[sd, c] = True
        return mask
