"""The compiled-core problem and the implicit generalized-alpha step.

Counterpart of mimi_tpu/parallel/sharding.py for one device and three
paths:
  - one polynomial 3D patch with simple interior knots (the J2 body-force
    step and the contact press, mortar penalty contact against a rigid
    spline tool, with viscosity; the hyperelastic and the finite-strain
    plastic cubes): the sum-factorized sweeps with the 37-plane Cauchy
    tangent (the viscous flux and a bfloat16 tangent block where asked),
    the 45-plane symmetric or the 81-plane full tangent, structured
    gather and pad-and-sum scatter;
  - every other problem, 2D patches (the golden cantilever, balken at
    p=3), multi-patch meshes and repeated interior knots (the neo-Hookean
    two-patch cantilever): the dense-table sweeps with the symmetric
    tangent of the hyperelastic materials (45 planes in 3D, 10 in 2D) or
    J2's Cauchy-decomposition tangent (37 / 14 planes) and its state,
    structured gather and pad-and-sum scatter on one patch with simple
    interior knots, else gather and fixed-order scatter through the
    connectivity, the FDM (patch-wise additive Schwarz on several
    patches).
All run FDM-preconditioned GMRES and the reference's LineSearchNewton
semantics
(goal max(rel*|r0|, abs), non-finite abort, 3-point line search with a
1e-12 scale floor, a 5-iteration best-improvement window, best iterate
returned on non-convergence).  Contact (on either kind of tables) adds
its residual to every residual evaluation and its tangent to the GMRES
matvec: the frozen-pressure element blocks, the reference's default, or
the consistent tangent with the closest-point query held at the assemble
point (contact/mortar.py).

Options of the reference package that this path does not cover raise
NotImplementedError naming their ROADMAP item.  Multi-device sharding is
ROADMAP Queue 1 item 8; everything here runs on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..contact.mortar import contact_scatter_tables, make_contact_fns, residual_grad_pass
from ..fem import soa
from ..fem.multipatch import MultiPatchFESpace
from ..fem.scatter import gather_sum, inverse_map
from ..fem.space import FESpace, _connectivity, _quad_weights, batch_last, domain_dim_tables
from ..nurbs.mesh_io import read_mfem_nurbs_mesh
from ..nurbs.topology import build_patch_from_mesh
from ..ops import sweeps
from ..solvers.fdm import build_fdm_data, make_fdm_apply
from ..solvers.linear import gmres, pcg


@dataclass
class Problem:
    """Problem data on one device, in the layouts the sweeps read."""

    material: object
    n_dof: int
    dim: int
    n_el: int
    n_q: int
    conn: np.ndarray  # (n_el, nd) global scalar dofs (host)
    wdet_t: torch.Tensor  # (n_q, n_el) quadrature weight * det J
    rhs: torch.Tensor  # (n_dof, dim)
    free: torch.Tensor  # (n_dof, dim) 1.0 / 0.0
    facs: dict  # generalized-alpha factors
    state0: dict | None  # SoA material state: (dim, dim, n_q, n_el) / (n_q, n_el)
    fdm: dict | None  # FDM preconditioner data (host numpy), or None
    # structured dof grid {"spans", "nc", "pp1"} (one patch, simple interior
    # knots), or None: gather and scatter then go through connT
    grid: dict | None = None
    connT: torch.Tensor | None = None  # (nd, n_el) conn.T on the device
    # (n_dof, max valence) the positions in connT of each dof
    # (fem/scatter.py inverse_map), with connT: the scatter's fixed order
    conn_inv: torch.Tensor | None = None
    # exactly one of: the sum-factorized tables {"tables": [B0, D0, B1, D1,
    # B2, D2], "jinv", "n_g", "pp1"}, or the dense tables {"dN_t"
    # (nd, dim, n_q, n_el), "N_t" (nd, n_q, n_el)}
    sf: dict | None = None
    dense: dict | None = None
    # mortar contact: per block a dict of element tables, scene data and
    # penalty (contact/mortar.py), and its static part {"n_local",
    # "query", "bid"}
    contact: list = field(default_factory=list)
    contact_static: list = field(default_factory=list)

    @property
    def dtype(self):
        return self.rhs.dtype

    @property
    def device(self):
        return self.rhs.device


def _unported(what, item):
    return NotImplementedError(
        f"{what} is not ported to mimi_tpu_torch yet (ROADMAP {item})"
    )


def gen_alpha_factors(rho_inf):
    rho = min(max(rho_inf, 0.0), 1.0)
    am = (2.0 - rho) / (1.0 + rho)
    af = 1.0 / (1.0 + rho)
    beta = 0.25 * (1.0 + am - af) ** 2
    gamma = 0.5 + am - af
    return dict(
        fac0=0.5 - beta / am,
        fac1=af,
        fac1_inv=1.0 / af,
        fac2=af * (1.0 - gamma / am),
        fac3=beta * af / am,
        fac4=gamma * af / am,
        fac5_inv=1.0 / am,
    )


def _merge_dirichlet(pairs):
    out = {}
    for b, d in pairs:
        out.setdefault(b, set()).add(d)
    return out


def sf_nodal(wq_t, tabs, square=False):
    """(nd, n_el) integrals sum_q wq N_n (or N_n^2 with square=True) over
    each element, from the separable 1D tables."""
    B0, _, B1, _, B2, _ = tabs
    if square:
        B0, B1, B2 = B0 * B0, B1 * B1, B2 * B2
    g, p1, E = B0.shape
    W = wq_t.reshape(g, g, g, E)  # (q2, q1, q0, e)
    out = torch.einsum("zyxe,xie,yje,zke->kjie", W, B0, B1, B2)
    return out.reshape(p1**3, E)


def build_problem(
    mesh_path,
    elevate: int,
    subdivide: int,
    material,
    dirichlet: list,  # [(bid, dim), ...]
    body_force: dict,  # {dim: value}
    rho_inf: float = 0.25,
    dtype=None,
    device="cuda",
    refine_spans=None,
    quadrature_order: int = -1,
    traction=None,
    constant_velocity=None,
    contact=None,
    periodic=None,
    contact_quadrature_order: int = -1,
) -> Problem:
    """Assemble the step's problem on `device` (the card unless "cpu" is
    passed; raises without a CUDA device) in `dtype` (default
    config.default_dtype: float32 on the card, float64 on the CPU).

    One polynomial 3D patch with simple interior knots and one Gauss count
    on every axis gets the sum-factorized tables: per-axis 1D basis
    tables, the per-qp Jacobian inverse and w det J (ops/sweeps.py
    build_sf_tables).  Every other mesh (several patches, repeated
    interior knots, rational or 2D patches) gets the dense tables dN, N
    and w det J in the batch-last layout (fem/space.py batch_last), built
    patch by patch with the native engine, each patch cast and moved to
    the device before the next one is built.  Both get the body-force
    right-hand side, the Dirichlet mask and the FDM eigenbases (with a
    boundary spring per contact face).

    contact: [(bid, scene), ...] mortar penalty contact of boundary `bid`
    against a NearestDistanceToSplines scene (penalty
    scene.coefficient), with boundary quadrature of order
    `contact_quadrature_order` (default 2p+3), on either kind of tables
    (the boundary tables of one patch or of several)."""
    for opt, what, item in (
        (traction, "traction", "Queue 1 item 6"),
        (constant_velocity, "constant velocity", "Queue 1 item 6"),
        (periodic, "periodic", "Queue 1 item 6"),
    ):
        if opt:
            raise _unported(what, item)
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    mesh = read_mfem_nurbs_mesh(mesh_path) if isinstance(mesh_path, str) else mesh_path
    patch = None
    if len(mesh.elements) > 1:
        fes = MultiPatchFESpace(
            mesh, elevate=elevate, subdivide=subdivide, refine_spans=refine_spans
        )
    else:
        patch, topo, _ = build_patch_from_mesh(mesh)
        if elevate > 0:
            patch.elevate_degrees(elevate)
        for _ in range(subdivide):
            patch.uniform_refine()
        if refine_spans is not None:
            patch.refine_to(refine_spans)
        fes = FESpace(patch, topo)
    dim = fes.dim
    material.setup(dim)
    grid = _structured_grid(patch)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)  # noqa: E731
    if grid is not None and _sf_gate(patch, quadrature_order):
        conn, n_q, wdet_t, nodal, sf = _sf_tables(fes, quadrature_order, dev)
        dense = connT = conn_inv = None
    else:
        conn, n_q, wdet_t, nodal, dense = _dense_tables(fes, quadrature_order, dtype, device)
        sf = None
        connT = torch.as_tensor(np.ascontiguousarray(conn.T), dtype=torch.int64, device=device)
        conn_inv = torch.as_tensor(inverse_map(conn.T, fes.n_dof), device=device)
    n_el = conn.shape[0]

    dir_pairs = list(dirichlet)
    zero_mask = fes.boundary_dof_mask(_merge_dirichlet(dir_pairs))
    free = (~zero_mask).astype(np.float64)
    rhs = np.zeros((fes.n_dof, dim))
    if body_force:
        for c, val in body_force.items():
            rhs[:, c] += nodal * val
        rhs[zero_mask] = 0.0

    state0 = None
    if material.has_state:
        state0 = soa.state_to_soa(
            material.init_state((n_el, n_q), dtype=dtype, device=device)
        )
    contact_data, contact_static = _contact_blocks(
        fes, contact or [], contact_quadrature_order, dtype, device
    )
    return Problem(
        material=material,
        n_dof=fes.n_dof,
        dim=dim,
        n_el=n_el,
        n_q=n_q,
        conn=conn,
        wdet_t=wdet_t,
        rhs=dev(rhs),
        free=dev(free),
        facs=gen_alpha_factors(rho_inf),
        state0=state0,
        fdm=build_fdm_data(
            fes, dir_pairs, material,
            contact_springs=[(bid, scene.coefficient) for bid, scene in contact or []],
        ),
        grid=grid,
        connT=connT,
        conn_inv=conn_inv,
        sf=sf,
        dense=dense,
        contact=contact_data,
        contact_static=contact_static,
    )


def _structured_grid(patch):
    """The structured dof grid of one patch whose interior knots are all
    simple (n_ctrl = n_span + p per axis), or None (several patches, or a
    repeated knot: the gather then goes through the connectivity)."""
    if patch is None:
        return None
    nc, spans = list(patch.n_ctrl()), list(patch.n_spans())
    if any(nc[k] != spans[k] + patch.degrees[k] for k in range(len(nc))):
        return None
    return {"spans": spans, "nc": nc, "pp1": [p + 1 for p in patch.degrees]}


def _sf_gate(patch, quadrature_order):
    """Sum factorization applies: 3D, one degree and one Gauss count on
    every axis, unit weights."""
    n_g_axis = [t[1].shape[1] for t in domain_dim_tables(patch, quadrature_order)]
    return (
        patch.para_dim == 3
        and len(set(patch.degrees)) == 1
        and len(set(n_g_axis)) == 1
        and np.allclose(np.asarray(patch.weights), 1.0)
    )


def _sf_tables(fes, quadrature_order, dev):
    """conn, n_q, wdet_t, the nodal integrals sum_q w det J N (host
    float64, per dof) and the sum-factorized tables of one patch."""
    patch = fes.patch
    tabs = domain_dim_tables(patch, quadrature_order)
    n_g = tabs[0][1].shape[1]
    conn = _connectivity(tabs, list(patch.n_ctrl()))
    sf_tabs, jinv, detJ = sweeps.build_sf_tables(
        patch, fes.x_ref, conn, n_g, np.float64, return_det=True
    )
    w_detJ = _quad_weights(tabs) * detJ  # (n_el, n_q)
    nodal_el = sf_nodal(
        torch.from_numpy(np.ascontiguousarray(w_detJ.T)),
        [torch.from_numpy(t) for t in sf_tabs],
    ).numpy()
    nodal = np.bincount(conn.ravel(), weights=nodal_el.T.ravel(), minlength=fes.n_dof)
    sf = {
        "tables": [dev(t) for t in sf_tabs],
        "jinv": dev(jinv),
        "n_g": n_g,
        "pp1": patch.degrees[0] + 1,
    }
    return conn, n_g**3, dev(w_detJ.T), nodal, sf


def _dense_tables(fes, quadrature_order, dtype, device):
    """conn, n_q, wdet_t, the nodal integrals (as _sf_tables) and the
    dense tables {"dN_t", "N_t"}, patch by patch: each patch's float64
    tables are cast, moved and dropped before the next patch is built, so
    no whole-mesh float64 table exists."""
    conns, dNs, Ns, ws = [], [], [], []
    nodal = np.zeros(fes.n_dof)
    for t in fes.iter_domain_tables(quadrature_order):
        nodal += np.bincount(
            t.conn.ravel(), weights=np.einsum("eq,eqn->en", t.w_detJ, t.N).ravel(),
            minlength=fes.n_dof,
        )
        dN_t, N_t, w_t = batch_last(t, dtype, device)
        conns.append(t.conn)
        dNs.append(dN_t)
        Ns.append(N_t)
        ws.append(w_t)
        n_q = t.n_q
        del t, dN_t, N_t, w_t

    def cat(parts):
        out = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        parts.clear()
        return out

    conn = np.concatenate(conns)
    return conn, n_q, cat(ws), nodal, {"dN_t": cat(dNs), "N_t": cat(Ns)}


def _contact_blocks(fes, contact, quadrature_order, dtype, device):
    """Per contact block the element tables of its marked boundary
    elements (conn, N, dN, wq, nsign, ldof, x_ref_el), the scene data and
    the penalty; and the static part (n_local, query, bid)."""
    data, static = [], []
    if not contact:
        return data, static
    bt = fes.boundary_tables(quadrature_order)
    for bid, scene in contact:
        marked = np.nonzero(bt.attr == bid + 1)[0]
        if marked.size == 0:
            raise ValueError(f"contact boundary {bid} marks no elements")
        c_conn = bt.conn[marked]
        uniq = np.unique(c_conn)
        lookup = -np.ones(uniq.max() + 1, dtype=np.int64)
        lookup[uniq] = np.arange(len(uniq))

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        data.append(
            {
                **contact_scatter_tables(c_conn, lookup[c_conn], device),
                "conn": dev(c_conn, torch.int64),
                "N": dev(bt.N[marked]),
                "dN": dev(bt.dN_dxi[marked]),
                "wq": dev(bt.wq[marked]),
                "nsign": dev(bt.normal_sign[marked]),
                "ldof": dev(lookup[c_conn], torch.int64),
                "x_ref_el": dev(fes.x_ref[c_conn]),
                "scene": scene.scene_data(dtype, device),
                "penalty": float(scene.coefficient),
            }
        )
        static.append(
            {"n_local": len(uniq), "query": scene.make_batched_query(), "bid": bid}
        )
    return data, static


def _contact_fns_for(prob):
    return [
        make_contact_fns(prob.dim, cs["n_local"], cs["query"])
        for cs in prob.contact_static
    ]


def _scatter_conn(res_el, cd, n_dof):
    """(n_mb, nd, dim) boundary-element values of the contact block cd ->
    (n_dof, dim), summed in a fixed order (cd's "inv", "gdof")."""
    dim = res_el.shape[-1]
    out = torch.zeros((n_dof, dim), dtype=res_el.dtype, device=res_el.device)
    out[cd["gdof"]] = gather_sum(res_el.reshape(-1, dim).T, cd["inv"]).T
    return out


def _local_offsets(pp1):
    """Local tensor-product dof offsets in conn's lexicographic order
    (axis-0 fastest): l = a0 + pp1[0]*(a1 + pp1[1]*a2)."""
    total = int(np.prod(pp1))
    for l in range(total):
        rem = l
        a = []
        for k in range(len(pp1)):
            a.append(rem % pp1[k])
            rem //= pp1[k]
        yield tuple(a)


def _structured_gather(u, dim, spans, pp1, nc):
    """(n_dof, dim) -> (dim, nd, n_el) element dof values as prod(pp1)
    overlapping slices of the dof grid."""
    u_grid = u.T.reshape(dim, *nc[::-1])
    slabs = []
    for alphas in _local_offsets(pp1):
        idx = (slice(None),) + tuple(
            slice(a, a + s) for a, s in zip(alphas[::-1], spans[::-1])
        )
        slabs.append(u_grid[idx].reshape(dim, -1))
    return torch.stack(slabs, 1)


def _structured_scatter(res_t, spans, pp1, nc, n_dof):
    """Transpose of _structured_gather as a pad-and-sum: each local-offset
    slab is zero-padded to the full dof grid and the prod(pp1) tensors are
    summed.  (C, nd, n_el) -> (n_dof, C)."""
    C = res_t.shape[0]
    out = None
    for l, alphas in enumerate(_local_offsets(pp1)):
        block = res_t[:, l, :].reshape(C, *spans[::-1])
        pads = []
        for a, s, n in zip(alphas, spans, nc):  # last dim (axis 0) first
            pads += [a, n - a - s]
        p = torch.nn.functional.pad(block, pads)
        out = p if out is None else out + p
    return out.reshape(C, n_dof).T


def _gather_scatter(prob):
    """(gather_t, scatter_el): (n_dof, dim) -> (dim, nd, n_el) element
    values and back, as slices of the structured dof grid, or through the
    connectivity (u.T[:, connT], and each dof's element values gathered
    through conn_inv and summed in a fixed order) when the problem has no
    grid."""
    g = prob.grid
    if g is None:
        connT, inv = prob.connT, prob.conn_inv

        def gather_conn(u):
            return u.T[:, connT]

        def scatter_conn(res_t):
            return gather_sum(res_t.reshape(res_t.shape[0], -1), inv).T

        return gather_conn, scatter_conn

    def gather_t(u):
        return _structured_gather(u, prob.dim, g["spans"], g["pp1"], g["nc"])

    def scatter_el(res_t):
        return _structured_scatter(res_t, g["spans"], g["pp1"], g["nc"], prob.n_dof)

    return gather_t, scatter_el


_SWEEPS = {
    ("sf", "cuda"): (sweeps.residual_sf, sweeps.assemble_sf, sweeps.matvec_sf),
    ("sf", "torch"): (
        sweeps.residual_sf_plain, sweeps.assemble_sf_plain, sweeps.matvec_sf_plain,
    ),
    ("dense", "cuda"): (
        sweeps.residual_dense, sweeps.assemble_dense, sweeps.matvec_dense,
    ),
    ("dense", "torch"): (
        sweeps.residual_dense_plain, sweeps.assemble_dense_plain,
        sweeps.matvec_dense_plain,
    ),
}


def _tables(prob):
    """The problem's sweep tables: ("sf", (tables, jinv)) or ("dense",
    (dN_t, N_t)); every sweep takes them after (u_el, a_el, state) or
    w_el."""
    if prob.sf is not None:
        return "sf", (prob.sf["tables"], prob.sf["jinv"])
    return "dense", (prob.dense["dN_t"], prob.dense["N_t"])


def _select_impl(prob, residual_impl):
    """(residual, assemble, matvec) sweeps on the problem's tables:
    "cuda", the hand-written kernels (ops/csrc), the default on CUDA
    problems; "torch", their plain torch versions, the default on CPU."""
    if residual_impl is None:
        residual_impl = "cuda" if prob.device.type == "cuda" else "torch"
    if residual_impl not in ("cuda", "torch"):
        raise ValueError(
            f"unknown residual_impl {residual_impl!r}: use 'cuda' (the reference "
            "package's 'pallas') or 'torch' (its 'soa')"
        )
    if residual_impl == "cuda" and prob.device.type != "cuda":
        raise ValueError("residual_impl='cuda' needs a problem on a CUDA device")
    return _SWEEPS[(_tables(prob)[0], residual_impl)]


def _grad(prob, w_el):
    """Physical gradient (dim, dim, n_q, n_el) of element fields (dim, nd, n_el)."""
    kind, (t1, t2) = _tables(prob)
    return sweeps.sf_grad(w_el, t1, t2) if kind == "sf" else sweeps.dense_grad(w_el, t1)


def initial_carry(prob: Problem, dt: float = 1.0, residual_impl: str | None = None):
    """Zero fields + the first-step explicit acceleration
    a0 = M^{-1}(f - E(0) - S v0 - contact(0)) (consistent mass,
    diagonal-preconditioned CG; v0 = 0, so the viscous term vanishes).
    `dt` only reaches rate-dependent terms; nothing yields at the zero
    state, so any positive value is equivalent.  `residual_impl` selects
    the residual sweep as in `make_step` ("torch" for a float64 problem on
    the card: the kernels are float32)."""
    z = torch.zeros((prob.n_dof, prob.dim), dtype=prob.dtype, device=prob.device)
    a0 = _explicit_accel(prob, z, prob.state0, dt, residual_impl)
    zero = lambda *shape: torch.zeros(shape, dtype=prob.dtype, device=prob.device)  # noqa: E731
    return {
        "u": z,
        "v": z,
        "a": a0,
        "state": prob.state0,
        "newton": {
            "norm0": 0.0,
            "norm": 0.0,
            "iters": 0,
            "lin_iters": 0,
            "converged": True,
            "finite": True,
        },
        "contact": [
            {
                "force": zero(prob.dim),
                "area": zero(),
                "pressure": zero(),
                "nodal_pressure": zero(cs["n_local"]),
                "res_el": zero(*cd["conn"].shape, prob.dim),
                "proj_unconverged": 0,
                "proj_res_max": zero(),
            }
            for cd, cs in zip(prob.contact, prob.contact_static)
        ],
    }


def _explicit_accel(prob, u, state, dt, residual_impl=None):
    res_sweep, _, _ = _select_impl(prob, residual_impl)
    gather_t, scatter_el = _gather_scatter(prob)
    mat = prob.material
    kind, tables = _tables(prob)
    wq = prob.wdet_t
    free = prob.free
    n_dof, dim = prob.n_dof, prob.dim
    rho = float(mat.density)
    u_el = gather_t(u)
    E_u = scatter_el(
        res_sweep(u_el, torch.zeros_like(u_el), state, *tables, wq, mat, dt, rho)
    )
    for cd, (pp, rp, _) in zip(prob.contact, _contact_fns_for(prob)):
        pressure, _, _ = pp(u, cd, cd["scene"], cd["penalty"])
        E_u = E_u + _scatter_conn(rp(u, cd, pressure)[0], cd, n_dof)
    z = (prob.rhs - E_u) * free

    # consistent mass apply and its diagonal sum_q w N^2, plain torch
    if kind == "sf":
        tabs, jinv = tables
        value = lambda w_el: sweeps.sf_value(w_el, tabs)  # noqa: E731
        integrate = lambda m: sweeps.sf_scatter(None, m, tabs, jinv, wq)  # noqa: E731
        nodal_sq = sf_nodal(wq, tabs, square=True)
    else:
        dN_t, N_t = tables
        value = lambda w_el: sweeps.dense_value(w_el, N_t)  # noqa: E731
        integrate = lambda m: sweeps.dense_scatter(None, m, dN_t, N_t, wq)  # noqa: E731
        nodal_sq = torch.einsum("qe,nqe->ne", wq, N_t * N_t)

    def mass_apply(w_flat):
        w = w_flat.reshape(n_dof, dim) * free
        y = scatter_el(integrate(rho * value(gather_t(w))))
        return (y * free + w_flat.reshape(n_dof, dim) * (1 - free)).reshape(-1)

    m_el = rho * nodal_sq  # (nd, n_el)
    m_diag = scatter_el(m_el[None])[:, 0]
    diag = m_diag.repeat_interleave(dim)
    diag = torch.where(free.reshape(-1) > 0, diag, torch.ones_like(diag))
    a = pcg(mass_apply, z.reshape(-1), diag, rel_tol=1e-8, abs_tol=1e-12, max_iter=1000)
    return a.reshape(n_dof, dim) * free


def make_step(
    prob: Problem,
    dt: float,
    newton_iters: int = 20,
    solver: str = "cg",
    cg_iters: int = 200,
    residual_impl: str | None = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 1e-12,
    lin_rel_tol: float | None = None,
    lin_abs_tol: float | None = None,
    precond: str = "auto",
    contact_tangent: str = "frozen",
    matvec_dtype: str = "f32",
    gmres_restart: int = 30,
    tangent_storage: str = "auto",
    matvec_impl: str = "auto",
):
    """One generalized-alpha step, carry -> carry.

    `residual_impl` selects who runs the three quadrature sweeps:
      - "cuda" (default for a problem on a CUDA device): the hand-written
        CUDA kernels of ops/csrc/, float32 only; the counterpart of the
        reference package's "pallas".
      - "torch" (default on the CPU): their plain torch versions, any
        dtype; the counterpart of the reference package's "soa" engine.
    The problem's tables decide the sweeps (the reference's `matvec_impl`
    "auto"): a problem with sum-factorized tables runs the sf sweeps, a
    dense-table problem the dense sweeps (`matvec_impl` takes "auto" or
    the name of what the tables decide, as an alias of the reference's
    option).  `tangent_storage` "auto" takes the strongest exact
    compression the material declares (cauchy > sym > full): the
    Cauchy-decomposition tangent of J2 (with any of the five hardening
    laws) and J2Linear (37 planes in 3D, 14 in 2D), the symmetric tangent
    of a material with a major-symmetric dP/dF (the hyperelastic ones, 45 /
    10 planes), or the full dP/dF of the finite-strain plasticity models
    J2Simo and J2Log (81 planes in 3D, 16 in 2D); "full" takes the full
    dP/dF on any material (its closed form on J2, J2Linear and the
    hyperelastic materials), as the reference does; "sym" on a material
    without a major-symmetric dP/dF and "cauchy" on one without the
    Cauchy-decomposition contract raise ValueError, as in the reference.
    Every storage runs on the sf and the dense sweeps.  Everything around
    the sweeps (gather/scatter, contact, FDM, GMRES, Newton) is the same
    torch code.  A material with viscosity > 0 adds the viscous flux
    S (v + fac1 a) to the residual sweeps and fac1 S to the matvec.

    `matvec_dtype` ("f32", "bf16") is the storage of the tangent block the
    GMRES matvec streams; "bf16" rounds it once in the assemble and
    widens it on every read, on both engines, in every storage.  Residuals
    stay float32.  Dense tables take a float32 block only (a bfloat16
    dense block raises, ROADMAP Queue 2 item 4).

    The radial return of the J2 family runs up to 40 scalar-solve trips in
    the CUDA kernels, as in the reference's Pallas kernels, and 100 on the
    "torch" engine and in the state update, as in its "soa" engine
    (materials.kernel_solver_mode holds the plain twin of the kernels).

    `solver` defaults to "cg" (FDM-preconditioned GMRES, which "iterative"
    and "gmres" name too), where the reference's default is its dense LU
    ("dense", ROADMAP Queue 1 item 6, not ported): a call that relies on
    the reference's default runs an iterative solve here.

    `contact_tangent` is the contact linearization of a problem with
    contact blocks, as in the reference:
      - "frozen" (the default): the derivative of the traction residual
        pass at frozen nodal pressure, as per-element blocks assembled with
        the residual (contact/mortar.py residual_grad_pass) and applied in
        the matvec; Newton converges linearly on engaged contact;
      - "consistent": the exact derivative of the contact residual with
        the closest-point query held at the assemble point (the
        reference's jax.linearize of the full two-pass residual).

    Newton runs up to `newton_iters` iterations; each linear solve is
    FDM-preconditioned GMRES(restart) with at most `cg_iters` iterations
    and tolerances lin_rel_tol/lin_abs_tol (defaults 1e-8/1e-12 in
    float64, 3e-6/1e-12 in float32).

    The returned `step(carry, contact_scenes=None)` takes optional fresh
    per-block scene data (a list matching prob.contact), so a rigid tool
    can move between steps (NearestDistanceToSplines.
    translate_scene_data).  Its attribute `newton_system(carry)` returns
    the first Newton linear system at the predictor of `carry` as
    {"J_apply", "M_apply", "r"} (flat vectors), for solver diagnostics.
    """
    if solver not in ("cg", "iterative", "gmres"):
        raise _unported(f"solver={solver!r} (dense LU)", "Queue 1 item 6")
    mat = prob.material
    if precond == "auto":
        precond = "fdm"
    if precond in ("bj", "schur"):
        raise _unported(f"precond={precond!r}", "Queue 1 items 6 and 10")
    if precond != "fdm":
        raise ValueError(f"unknown precond {precond!r}")
    if prob.fdm is None:
        raise _unported("problems without an FDM decomposition (block-Jacobi)", "Queue 1 item 6")
    kind = _tables(prob)[0]
    # a compression the material does not declare would corrupt the Krylov
    # operator: a wrong request, as in the reference
    if tangent_storage == "sym" and not mat.tangent_major_symmetric:
        raise ValueError(
            f"{mat.name()} does not declare a major-symmetric dP/dF "
            "(tangent_major_symmetric); symmetric tangent storage would silently "
            "corrupt the Krylov operator"
        )
    if tangent_storage == "cauchy" and not mat.tangent_cauchy_decomp:
        raise ValueError(
            f"{mat.name()} does not declare the Cauchy-decomposition contract "
            "(tangent_cauchy_decomp: sigma symmetric and a function of sym(F) only); "
            "the Cauchy-decomposition storage would silently corrupt the Krylov operator"
        )
    if tangent_storage not in ("auto", *sweeps.STORAGES):
        raise ValueError(f"unknown tangent_storage {tangent_storage!r}")
    # "auto": the strongest exact compression the material declares; "full"
    # (exact for every material) is taken on any
    storage = sweeps.tangent_storage(mat) if tangent_storage == "auto" else tangent_storage
    # the tables decide the sweeps; the reference's explicit names are
    # accepted as aliases of what they decide
    if matvec_impl not in ("auto", "sf", "dense"):
        raise ValueError(f"unknown matvec_impl {matvec_impl!r}")
    if matvec_impl not in ("auto", kind):
        raise _unported(f"matvec_impl={matvec_impl!r} on a problem that decides {kind!r}",
                        "Queue 2 item 2")
    if mat.name() not in (*sweeps.HYPER_KERNELS, *sweeps.CAUCHY_KERNELS, *sweeps.FULL_KERNELS):
        raise _unported(f"{mat.name()} with the {storage} tangent", "Queue 1 item 2")
    if matvec_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown matvec_dtype {matvec_dtype!r}")
    if matvec_dtype == "bf16" and kind == "dense":
        raise _unported("matvec_dtype='bf16' on dense tables (with the bfloat16 table "
                        "streams of Queue 1 item 10)", "Queue 2 item 4")
    if contact_tangent not in ("frozen", "consistent"):
        raise ValueError(f"unknown contact_tangent {contact_tangent!r}")
    frozen = contact_tangent == "frozen"
    contact_fns = _contact_fns_for(prob)
    res_sweep, asm_sweep, mv_sweep = _select_impl(prob, residual_impl)

    f = prob.facs
    dim, n_dof = prob.dim, prob.n_dof
    dt = float(dt)
    fac0 = f["fac3"] * dt * dt
    fac1 = f["fac4"] * dt
    max_iter = int(newton_iters)
    if lin_rel_tol is None:
        lin_rel_tol = 1e-8 if prob.dtype == torch.float64 else 3e-6
    if lin_abs_tol is None:
        lin_abs_tol = 1e-12
    rho = float(mat.density)
    has_visc = float(mat.viscosity) > 0.0
    mu_v = float(mat.viscosity) if has_visc else 0.0
    fac1_mu_v = fac1 * mu_v if has_visc else None
    c_dtype = torch.bfloat16 if matvec_dtype == "bf16" else prob.dtype
    tables, wq = _tables(prob)[1], prob.wdet_t
    rhs, free = prob.rhs, prob.free
    fdm_apply = make_fdm_apply(prob.fdm, fac0, fac1, prob.dtype, prob.device)
    gather_t, scatter_el = _gather_scatter(prob)

    def el_fields(aa, xa, va):
        """Element values of u = xa + fac0 aa, a = aa (masked) and, with
        viscosity, v = va + fac1 aa."""
        v_el = gather_t(va + fac1 * aa) if has_visc else None
        return gather_t(xa + fac0 * aa), gather_t(aa * free), v_el

    def contact_residual(u_cur, scenes):
        out = torch.zeros_like(u_cur)
        for cd, sd, (pp, rp, _) in zip(prob.contact, scenes, contact_fns):
            pressure, _, _ = pp(u_cur, cd, sd, cd["penalty"])
            out = out + _scatter_conn(rp(u_cur, cd, pressure)[0], cd, n_dof)
        return out

    def residual(aa, xa, va, state, scenes):
        u_el, a_el, v_el = el_fields(aa, xa, va)
        y = scatter_el(
            res_sweep(u_el, a_el, state, *tables, wq, mat, dt, rho, v_el=v_el, mu_v=mu_v)
        )
        if contact_fns:
            y = y + contact_residual(xa + fac0 * aa, scenes)
        return (y - rhs) * free

    def frozen_blocks(blocks, cd):
        """w_el -> the frozen-pressure element blocks applied to w_el."""
        n_mb, nd = cd["conn"].shape

        def apply(w):
            w_el = w[cd["conn"]].reshape(n_mb, nd * dim, 1)
            return torch.bmm(blocks, w_el).reshape(n_mb, nd, dim)

        return apply

    def assemble(aa, xa, va, state, scenes):
        """Residual, the tangent block and, per contact block, the
        derivative of its residual at xa + fac0 aa: the frozen-pressure
        element blocks, or the consistent one with the query held."""
        u_el, a_el, v_el = el_fields(aa, xa, va)
        res_t, Ck = asm_sweep(
            u_el, a_el, state, *tables, wq, mat, dt, rho,
            v_el=v_el, mu_v=mu_v, c_dtype=c_dtype, storage=storage,
        )
        r = scatter_el(res_t)
        c_jvps = []
        u_cur = xa + fac0 * aa
        for cd, sd, (pp, _, lin) in zip(prob.contact, scenes, contact_fns):
            if frozen:
                pressure, _, _ = pp(u_cur, cd, sd, cd["penalty"])
                res_el, blocks, _, _ = residual_grad_pass(u_cur, cd, pressure)
                jvp = frozen_blocks(blocks, cd)
            else:
                res_el, _, jvp = lin(u_cur, cd, sd, cd["penalty"])
            r = r + _scatter_conn(res_el, cd, n_dof)
            c_jvps.append((cd, jvp))
        return (r - rhs) * free, (Ck, c_jvps)

    def operators(ctx):
        Ck, c_jvps = ctx

        def J_apply(w_flat):
            w = w_flat.reshape(n_dof, dim) * free
            y = scatter_el(
                mv_sweep(
                    gather_t(w), *tables, wq, Ck, rho, fac0, fac1_mu_v=fac1_mu_v,
                    storage=storage,
                )
            )
            for cd, jvp in c_jvps:
                y = y + fac0 * _scatter_conn(jvp(w), cd, n_dof)
            return (y * free + w_flat.reshape(n_dof, dim) * (1 - free)).reshape(-1)

        return J_apply, fdm_apply

    def solve(ctx, r):
        J_apply, M_apply = operators(ctx)
        c, info = gmres(
            J_apply,
            r.reshape(-1),
            M_apply=M_apply,
            rel_tol=lin_rel_tol,
            abs_tol=lin_abs_tol,
            restart=min(gmres_restart, cg_iters),
            max_iter=cg_iters,
            return_info=True,
        )
        return c.reshape(n_dof, dim), info["iters"]

    def newton(xa, va, state, scenes):
        """LineSearchNewton: goal max(rel*|r0|, abs), 3-point line search
        with a 1e-12 scale-floor abort, 5-iteration best window."""
        aa = torch.zeros_like(xa)
        r, ctx = assemble(aa, xa, va, state, scenes)
        norm = norm0 = float(torch.linalg.norm(r))
        goal = max(rel_tol * norm0, abs_tol)
        best_aa, best_norm = aa, math.inf
        window, it, lin_iters, stop = 31, 0, 0, False
        while (
            not stop
            and math.isfinite(norm)
            and norm > goal
            and it < max_iter
            and window != 0
        ):
            step_c, li = solve(ctx, r)
            q1 = norm
            q3 = float(torch.linalg.norm(residual(aa - step_c, xa, va, state, scenes)))
            q2 = float(torch.linalg.norm(residual(aa - 0.5 * step_c, xa, va, state, scenes)))
            denom = q1 - 2.0 * q2 + q3
            eps = (3.0 * q1 - 4.0 * q2 + q3) / (4.0 * denom) if denom != 0 else math.nan
            if denom > 0 and 0 < eps < 1:
                scale = eps
            else:
                scale = 1.0 if q3 < q1 else 0.05
            stop = abs(scale) < 1e-12
            if not stop:
                aa = aa - scale * step_c
            r, ctx = assemble(aa, xa, va, state, scenes)
            norm_new = float(torch.linalg.norm(r))
            better = norm_new < best_norm
            if better and not stop:
                best_aa, best_norm = aa, norm_new
            if not stop:
                norm = norm_new
                window = ((window << 1) | int(better)) & 31
                it += 1
            lin_iters += li
        converged = norm <= goal
        use_best = not converged and math.isfinite(norm) and not stop and it > 0
        diag = {
            "norm0": norm0,
            "norm": best_norm if use_best else norm,
            "iters": it,
            "lin_iters": lin_iters,
            "converged": converged,
        }
        return (best_aa if use_best else aa), diag

    def predictor(carry):
        u, v, a = carry["u"], carry["v"], carry["a"]
        xa = u + (v + f["fac0"] * dt * a) * f["fac1"] * dt
        va = v + f["fac2"] * dt * a
        return xa, va

    def default_scenes(contact_scenes):
        return contact_scenes or [cd["scene"] for cd in prob.contact]

    def step(carry, contact_scenes=None):
        u, v, a, state = carry["u"], carry["v"], carry["a"], carry["state"]
        scenes = default_scenes(contact_scenes)
        prev_fac = 1.0 - f["fac1_inv"]
        xa, va = predictor(carry)
        aa, diag = newton(xa, va, state, scenes)
        xa = xa + fac0 * aa
        va = va + fac1 * aa
        u_new = u * prev_fac + f["fac1_inv"] * xa
        v_new = v * prev_fac + f["fac1_inv"] * va
        a_new = a * prev_fac + f["fac5_inv"] * aa
        if state is not None:
            dF = _grad(prob, gather_t(u_new))
            state = mat.accumulate_soa(soa.add_diag(dF, 1.0), state, dt)
        # contact observables at the converged alpha level (the reference
        # records from its last residual assembly there)
        contact_aux = [
            lin(xa, cd, sd, cd["penalty"])[1]
            for cd, sd, (_, _, lin) in zip(prob.contact, scenes, contact_fns)
        ]
        finite = bool(torch.isfinite(u_new).all()) and bool(torch.isfinite(v_new).all())
        if state is not None:
            finite = finite and all(bool(torch.isfinite(x).all()) for x in state.values())
        return {
            "u": u_new,
            "v": v_new,
            "a": a_new,
            "state": state,
            "newton": dict(diag, finite=finite),
            "contact": contact_aux,
        }

    def newton_system(carry, contact_scenes=None):
        xa, va = predictor(carry)
        r, ctx = assemble(
            torch.zeros_like(xa), xa, va, carry["state"], default_scenes(contact_scenes)
        )
        J_apply, M_apply = operators(ctx)
        return {"J_apply": J_apply, "M_apply": M_apply, "r": r.reshape(-1)}

    step.newton_system = newton_system
    return step
