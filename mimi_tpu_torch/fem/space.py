"""Finite element space over a NURBS patch: host-side (numpy) tables.

Counterpart of mimi_tpu/fem/space.py, restricted to what a single-patch
problem needs: per-axis 1D basis tables (`_dim_tables`), the tensor-product
connectivity, the dense domain tables (`patch_domain_tables`, native C++
engine or vectorized numpy), the boundary (side) tables that contact
reads (`patch_side_tables`, `FESpace.boundary_tables`) and the `FESpace`
queries for boundary dofs.

The sum-factorized step (parallel/sharding.py) reads only the 1D tables,
the connectivity and the per-quadrature-point geometry built from them
(ops/sweeps.py build_sf_tables); the dense-table step reads the dense
`N`/`dN_dX`/`w_detJ` tables in the batch-last layout of `batch_last`.

Quadrature default order is 2p+3 (the reference's precomputed.cpp).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..nurbs import knots as kn
from ..nurbs.patch import NurbsPatch
from ..nurbs.topology import PatchTopology


def _dim_tables(kv, p, n_gauss):
    """Per parametric dimension: spans, local dof start indices, quad
    params/weights and 1D basis values/derivatives.

    Returns (starts (n_span,), uq (n_span, n_g), wq (n_span, n_g),
             B (n_span, n_g, p+1), D (n_span, n_g, p+1))
    """
    bps = kn.unique_spans(kv, p)
    n_span = len(bps) - 1
    xg, wg = np.polynomial.legendre.leggauss(n_gauss)
    starts = np.zeros(n_span, dtype=int)
    uq = np.zeros((n_span, n_gauss))
    wq = np.zeros((n_span, n_gauss))
    B = np.zeros((n_span, n_gauss, p + 1))
    D = np.zeros((n_span, n_gauss, p + 1))
    for s in range(n_span):
        a, b = bps[s], bps[s + 1]
        half = 0.5 * (b - a)
        mid = 0.5 * (a + b)
        span_idx = kn.find_span(kv, p, mid)
        starts[s] = span_idx - p
        for g in range(n_gauss):
            u = mid + half * xg[g]
            uq[s, g] = u
            wq[s, g] = wg[g] * half
            ders = kn.ders_basis_funs(kv, p, span_idx, u, 1)
            B[s, g] = ders[0]
            D[s, g] = ders[1]
    return starts, uq, wq, B, D


def domain_dim_tables(patch, quadrature_order: int = -1):
    """`_dim_tables` for every parametric axis at the domain quadrature
    order (default 2p+3 per axis)."""
    tabs = []
    for k in range(patch.para_dim):
        order = (
            quadrature_order
            if quadrature_order >= 0
            else 2 * patch.degrees[k] + 3
        )
        tabs.append(
            _dim_tables(patch.knot_vectors[k], patch.degrees[k], order // 2 + 1)
        )
    return tabs


def _connectivity(tabs, nc):
    """(n_el, n_dof_el) global scalar dofs: global dof = sum_d (starts_d
    + a_d) * mult_d, element and local dof indices axis-0 fastest."""
    d = len(tabs)
    spans = [t[0].shape[0] for t in tabs]
    pp1 = [t[3].shape[2] for t in tabs]
    mults = np.cumprod([1] + list(nc[:-1]))
    conn = np.zeros((*spans[::-1], *pp1[::-1]), dtype=np.int64)
    for k in range(d):
        sh_s = [1] * d
        sh_a = [1] * d
        sh_s[d - 1 - k] = spans[k]
        sh_a[d - 1 - k] = pp1[k]
        per_dim = tabs[k][0][:, None] + np.arange(pp1[k])[None, :]
        conn = conn + per_dim.reshape(*sh_s, *sh_a) * mults[k]
    return conn.reshape(int(np.prod(spans)), int(np.prod(pp1)))


def _quad_weights(tabs):
    """(n_el, n_q) parametric quadrature weights: outer product over
    axes, quadrature index axis-0 fastest."""
    d = len(tabs)
    spans = [t[0].shape[0] for t in tabs]
    n_g = [t[1].shape[1] for t in tabs]
    WQ = np.ones((*spans[::-1], *n_g[::-1]))
    for k in range(d):
        sh_s = [1] * d
        sh_g = [1] * d
        sh_s[d - 1 - k] = spans[k]
        sh_g[d - 1 - k] = n_g[k]
        WQ = WQ * tabs[k][2].reshape(*sh_s, *sh_g)
    return WQ.reshape(int(np.prod(spans)), int(np.prod(n_g)))


def _tensor_basis(tabs, weights_grid):
    """Tensor-product rational basis over all elements: native C++ engine
    when it builds (OpenMP element loop, no large temporaries), vectorized
    numpy otherwise."""
    from . import native

    d = len(weights_grid.shape)
    w_flat = weights_grid.transpose(*range(d - 1, -1, -1)).reshape(-1)
    nat = native.tensor_tables_native(tabs, w_flat, weights_grid.shape)
    if nat is not None:
        return nat
    return _tensor_basis_numpy(tabs, weights_grid)


def _tensor_basis_numpy(tabs, weights_grid):
    """Vectorized tensor-product rational basis over all elements.

    Returns conn (n_el, n_dof), N (n_el, n_q, n_dof), dN_du
    (n_el, n_q, n_dof, d), wq (n_el, n_q); element, quadrature and local
    dof indices all run axis-0 fastest."""
    d = len(tabs)
    nc = weights_grid.shape
    spans = [t[0].shape[0] for t in tabs]
    n_g = [t[1].shape[1] for t in tabs]
    pp1 = [t[3].shape[2] for t in tabs]
    n_el = int(np.prod(spans))
    n_q = int(np.prod(n_g))
    n_dof = int(np.prod(pp1))

    conn = _connectivity(tabs, nc)
    WQ = _quad_weights(tabs)

    def outer_prod(mats):
        """mats[k]: (S_k, G_k, P_k) -> (n_el, n_q, n_dof) with dim-0
        fastest in each flattened index."""
        out = np.ones((*spans[::-1], *n_g[::-1], *pp1[::-1]))
        for k in range(d):
            sh = [1] * (3 * d)
            sh[d - 1 - k] = spans[k]
            sh[2 * d - 1 - k] = n_g[k]
            sh[3 * d - 1 - k] = pp1[k]
            out = out * mats[k].reshape(sh)
        return out.reshape(n_el, n_q, n_dof)

    Bq = outer_prod([tabs[k][3] for k in range(d)])
    Dq = [
        outer_prod([tabs[k][4] if k == der else tabs[k][3] for k in range(d)])
        for der in range(d)
    ]

    # rational (NURBS) correction
    w_flat = weights_grid.transpose(*range(d - 1, -1, -1)).reshape(-1)
    w_loc = w_flat[conn]  # (n_el, n_dof)
    wB = w_loc[:, None, :] * Bq
    W = wB.sum(-1)  # (n_el, n_q)
    N = wB / W[:, :, None]
    dN = np.zeros((n_el, n_q, n_dof, d))
    for k in range(d):
        wD = w_loc[:, None, :] * Dq[k]
        Wd = wD.sum(-1)
        dN[..., k] = (wD - N * Wd[:, :, None]) / W[:, :, None]
    return conn, N, dN, WQ


@dataclass
class DomainTables:
    conn: np.ndarray  # (n_el, n_dof_el) global scalar dofs
    N: np.ndarray  # (n_el, n_q, n_dof_el)
    dN_dX: np.ndarray  # (n_el, n_q, n_dof_el, dim)
    w_detJ: np.ndarray  # (n_el, n_q)  quad weight * |dX/du|
    n_q: int = 0


@dataclass
class BoundaryTables:
    conn: np.ndarray  # (n_bel, n_dof_b)
    N: np.ndarray  # (n_bel, n_q, n_dof_b)
    dN_dxi: np.ndarray  # (n_bel, n_q, n_dof_b, dim-1)
    wq: np.ndarray  # (n_bel, n_q) parametric quad weights
    detJ_ref: np.ndarray  # (n_bel, n_q) reference-config surface jacobian
    attr: np.ndarray  # (n_bel,) boundary attribute (1-based, as in file)
    normal_sign: np.ndarray = None  # (n_bel,) +-1: file-orientation normal
    # relative to the +tangent-axis parameterization used by the tables


def patch_domain_tables(
    patch, weights_grid, x_loc, quadrature_order: int = -1
) -> DomainTables:
    """Dense domain quadrature tables for one patch."""
    tabs = domain_dim_tables(patch, quadrature_order)
    conn, N, dN_du, wq = _tensor_basis(tabs, weights_grid)
    from . import native as _native

    n_el, n_q, n_dof = N.shape
    nat = _native.geometry_tables_native(conn, dN_du, wq, x_loc)
    if nat is not None:
        dN_dX, w_detJ = nat
    else:
        x = x_loc[conn]  # (n_el, n_dof, dim)
        J = np.einsum("end,eqnk->eqdk", x, dN_du, optimize=True)
        detJ = np.linalg.det(J)
        Jinv = np.linalg.inv(J)  # du/dX
        dN_dX = np.einsum("eqnk,eqkd->eqnd", dN_du, Jinv, optimize=True)
        w_detJ = wq * detJ
    return DomainTables(
        conn=conn, N=N, dN_dX=dN_dX, w_detJ=w_detJ, n_q=n_q
    )


def patch_side_tables(
    patch, weights_grid, dof_grid, x_glob, axis, end, quadrature_order=-1
):
    """Boundary tables for one side (axis, end) of one patch.

    dof_grid: array shaped like the control grid holding the caller's
    global scalar dof ids (lexicographic identity for a single patch).
    Returns (conn_g, N, dN_dxi, wq, detJ_ref)."""
    p = patch
    d = p.para_dim
    nc = p.n_ctrl()
    tabs = []
    for k in [k for k in range(d) if k != axis]:
        order = quadrature_order if quadrature_order >= 0 else 2 * p.degrees[k] + 3
        tabs.append(_dim_tables(p.knot_vectors[k], p.degrees[k], order // 2 + 1))
    sel = [slice(None)] * d
    sel[axis] = 0 if end == 0 else nc[axis] - 1
    connf, Nf, dNf, wqf = _tensor_basis(tabs, weights_grid[tuple(sel)])
    conn_g = dof_grid[tuple(sel)].reshape(-1, order="F")[connf]
    Jf = np.einsum("end,eqnk->eqdk", x_glob[conn_g], dNf)  # (.., dim, d-1)
    if d == 2:
        detJ = np.linalg.norm(Jf[..., 0], axis=-1)
    else:
        detJ = np.linalg.norm(np.cross(Jf[..., 0], Jf[..., 1]), axis=-1)
    return conn_g, Nf, dNf, wqf, detJ


def batch_last(tables: DomainTables, dtype, device):
    """The dense tables in the layouts the sweeps read, elements last:
    dN_t (nd, dim, n_q, n_el), N_t (nd, n_q, n_el), wdet_t (n_q, n_el),
    cast to `dtype` on the host and moved to `device` before the
    transpose (the float64 host copies are not kept)."""
    import torch

    def dev(a, perm):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        return t.to(device).permute(*perm).contiguous()

    return (
        dev(tables.dN_dX, (2, 3, 1, 0)),
        dev(tables.N, (2, 1, 0)),
        dev(tables.w_detJ, (1, 0)),
    )


class FESpace:
    """Vector-valued NURBS FE space (byVDIM) over a single patch."""

    def __init__(self, patch: NurbsPatch, topo: PatchTopology):
        self.patch = patch
        self.topo = topo
        self.dim = patch.dim
        self.para_dim = patch.para_dim
        self.n_ctrl = patch.n_ctrl()
        self.n_dof = patch.n_ctrl_total()  # scalar dofs
        self.n_vdof = self.n_dof * self.dim
        self.x_ref = patch.control_points.copy()  # (n_dof, dim) lex order
        self.weights_grid = self._grid(patch.weights)
        self.sides = topo.boundary_sides(self.n_ctrl)

    def _grid(self, flat):
        nc = self.n_ctrl
        d = self.para_dim
        return np.asarray(flat).reshape(*nc[::-1]).transpose(
            *range(d - 1, -1, -1)
        )

    def domain_tables(self, quadrature_order: int = -1) -> DomainTables:
        return patch_domain_tables(
            self.patch, self.weights_grid, self.x_ref, quadrature_order
        )

    def iter_domain_tables(self, quadrature_order: int = -1):
        """The domain tables patch by patch (one patch here; see
        fem/multipatch.py)."""
        yield self.domain_tables(quadrature_order)

    def boundary_tables(self, quadrature_order: int = -1) -> BoundaryTables:
        """All boundary (side) elements, grouped side by side in the order
        the sides appear in the mesh file; within a side, elements are
        lexicographic over the tangent span grid."""
        d = self.para_dim
        nc = self.n_ctrl
        dof_grid = np.arange(self.n_dof).reshape(*nc[::-1]).transpose(
            *range(d - 1, -1, -1)
        )
        parts = []
        for attr, axis, end, n_sign in self.sides:
            conn_g, Nf, dNf, wqf, detJ = patch_side_tables(
                self.patch, self.weights_grid, dof_grid, self.x_ref, axis, end,
                quadrature_order,
            )
            n = len(conn_g)
            parts.append((conn_g, Nf, dNf, wqf, detJ, np.full(n, attr, dtype=np.int64),
                          np.full(n, n_sign, dtype=np.float64)))
        cat = [np.concatenate(x) for x in zip(*parts)]
        return BoundaryTables(
            conn=cat[0], N=cat[1], dN_dxi=cat[2], wq=cat[3], detJ_ref=cat[4],
            attr=cat[5], normal_sign=cat[6],
        )

    def side_dofs(self, bid: int) -> np.ndarray:
        """Scalar (lex) dofs on boundary attribute bid+1 (0-based bid)."""
        nc = self.n_ctrl
        d = self.para_dim
        found = [s for s in self.sides if s[0] == bid + 1]
        if not found:
            return np.zeros(0, dtype=np.int64)
        dofs = []
        dof_grid = np.arange(self.n_dof).reshape(*nc[::-1]).transpose(
            *range(d - 1, -1, -1)
        )
        for attr, axis, end, _sign in found:
            sel = [slice(None)] * d
            sel[axis] = 0 if end == 0 else nc[axis] - 1
            dofs.append(dof_grid[tuple(sel)].ravel())
        return np.unique(np.concatenate(dofs))

    def boundary_dof_mask(self, dirichlet: dict[int, set]) -> np.ndarray:
        """(n_dof, dim) bool mask of essential dofs."""
        mask = np.zeros((self.n_dof, self.dim), dtype=bool)
        for bid, dims in dirichlet.items():
            sd = self.side_dofs(bid)
            for c in dims:
                mask[sd, c] = True
        return mask
