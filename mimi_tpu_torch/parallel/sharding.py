"""The compiled-core problem and the implicit generalized-alpha step.

Counterpart of mimi_tpu/parallel/sharding.py for one device and the path
the 3D single-patch J2 benchmark takes: the sum-factorized sweeps with the
37-plane Cauchy tangent (ops/sweeps.py), structured gather and pad-and-sum
scatter, FDM-preconditioned GMRES, and the reference's LineSearchNewton
semantics (goal max(rel*|r0|, abs), non-finite abort, 3-point line search
with a 1e-12 scale floor, a 5-iteration best-improvement window, best
iterate returned on non-convergence).

Options of the reference package that this path does not cover raise
NotImplementedError naming their ROADMAP item.  Multi-device sharding is
ROADMAP Queue 1 item 8; everything here runs on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..fem import soa
from ..fem.space import FESpace, _connectivity, _quad_weights, domain_dim_tables
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
    state0: dict | None  # SoA material state: (3, 3, n_q, n_el) / (n_q, n_el)
    fdm: dict | None  # FDM preconditioner data (host numpy), or None
    grid: dict  # structured dof grid {"spans", "nc", "pp1"}
    sf: dict  # {"tables": [B0, D0, B1, D1, B2, D2], "jinv", "n_g", "pp1"}

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
    dtype=torch.float64,
    device="cpu",
    refine_spans=None,
    quadrature_order: int = -1,
    traction=None,
    constant_velocity=None,
    contact=None,
    periodic=None,
) -> Problem:
    """Assemble the step's problem on `device` in `dtype`.

    The host build (numpy, float64) makes only what the sum-factorized
    sweeps read: per-axis 1D basis tables, the per-qp Jacobian inverse
    and w det J (ops/sweeps.py build_sf_tables), the body-force right-hand
    side, the Dirichlet mask and the FDM eigenbases.  The dense N/dN_dX
    tables of the reference package are not built (fem/space.py still
    provides them)."""
    for opt, what, item in (
        (traction, "traction", "Queue 1 item 6"),
        (constant_velocity, "constant velocity", "Queue 1 item 6"),
        (contact, "contact", "Queue 1 item 5"),
        (periodic, "periodic", "Queue 1 item 6"),
    ):
        if opt:
            raise _unported(what, item)
    mesh = read_mfem_nurbs_mesh(mesh_path) if isinstance(mesh_path, str) else mesh_path
    if len(mesh.elements) > 1:
        raise _unported("multi-patch meshes", "Queue 1 item 6")
    patch, topo, _ = build_patch_from_mesh(mesh)
    if elevate > 0:
        patch.elevate_degrees(elevate)
    for _ in range(subdivide):
        patch.uniform_refine()
    if refine_spans is not None:
        patch.refine_to(refine_spans)
    fes = FESpace(patch, topo)
    dim = fes.dim
    nc, spans = list(patch.n_ctrl()), list(patch.n_spans())
    # the structured gather/scatter needs simple interior knots
    # (n_ctrl = n_span + p per axis)
    if any(nc[k] != spans[k] + patch.degrees[k] for k in range(len(nc))):
        raise _unported("repeated interior knots (conn-based gather)", "Queue 2 item 2")
    tabs = domain_dim_tables(patch, quadrature_order)
    n_g_axis = [t[1].shape[1] for t in tabs]
    # sum factorization gates on the per-axis quadrature counts
    if (
        dim != 3
        or len(set(patch.degrees)) != 1
        or len(set(n_g_axis)) != 1
        or not np.allclose(np.asarray(patch.weights), 1.0)
    ):
        raise _unported(
            "rational, 2D or mixed-degree patches (dense-table sweeps)",
            "Queue 2 item 2",
        )
    material.setup(dim)
    n_g = n_g_axis[0]
    conn = _connectivity(tabs, nc)
    n_el, n_q = conn.shape[0], n_g**3
    sf_tabs, jinv, detJ = sweeps.build_sf_tables(
        patch, fes.x_ref, conn, n_g, np.float64, return_det=True
    )
    w_detJ = _quad_weights(tabs) * detJ  # (n_el, n_q)

    dir_pairs = list(dirichlet)
    zero_mask = fes.boundary_dof_mask(_merge_dirichlet(dir_pairs))
    free = (~zero_mask).astype(np.float64)
    rhs = np.zeros((fes.n_dof, dim))
    if body_force:
        nodal = sf_nodal(
            torch.from_numpy(np.ascontiguousarray(w_detJ.T)),
            [torch.from_numpy(t) for t in sf_tabs],
        ).numpy()
        acc = np.zeros(fes.n_dof)
        np.add.at(acc, conn, nodal.T)
        for c, val in body_force.items():
            rhs[:, c] += acc * val
        rhs[zero_mask] = 0.0

    state0 = None
    if material.has_state:
        state0 = soa.state_to_soa(
            material.init_state((n_el, n_q), dtype=dtype, device=device)
        )
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)  # noqa: E731
    return Problem(
        material=material,
        n_dof=fes.n_dof,
        dim=dim,
        n_el=n_el,
        n_q=n_q,
        conn=conn,
        wdet_t=dev(w_detJ.T),
        rhs=dev(rhs),
        free=dev(free),
        facs=gen_alpha_factors(rho_inf),
        state0=state0,
        fdm=build_fdm_data(fes, dir_pairs, material),
        grid={"spans": spans, "nc": nc, "pp1": [p + 1 for p in patch.degrees]},
        sf={
            "tables": [dev(t) for t in sf_tabs],
            "jinv": dev(jinv),
            "n_g": n_g,
            "pp1": patch.degrees[0] + 1,
        },
    )


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
    g = prob.grid

    def gather_t(u):
        return _structured_gather(u, prob.dim, g["spans"], g["pp1"], g["nc"])

    def scatter_el(res_t):
        return _structured_scatter(res_t, g["spans"], g["pp1"], g["nc"], prob.n_dof)

    return gather_t, scatter_el


def _select_impl(prob, residual_impl):
    """"cuda": the hand-written kernels (ops/csrc), the default on CUDA
    problems; "torch": their plain torch versions, the default on CPU."""
    if residual_impl is None:
        residual_impl = "cuda" if prob.device.type == "cuda" else "torch"
    if residual_impl == "cuda":
        if prob.device.type != "cuda":
            raise ValueError("residual_impl='cuda' needs a problem on a CUDA device")
        return sweeps.residual_sf, sweeps.assemble_sf, sweeps.matvec_sf
    if residual_impl == "torch":
        return (
            sweeps.residual_sf_plain,
            sweeps.assemble_sf_plain,
            sweeps.matvec_sf_plain,
        )
    raise ValueError(
        f"unknown residual_impl {residual_impl!r}: use 'cuda' (the reference "
        "package's 'pallas') or 'torch' (its 'soa')"
    )


def initial_carry(prob: Problem, dt: float = 1.0):
    """Zero fields + the first-step explicit acceleration
    a0 = M^{-1}(f - E(0)) (consistent mass, diagonal-preconditioned CG).
    `dt` only reaches rate-dependent terms; nothing yields at the zero
    state, so any positive value is equivalent."""
    z = torch.zeros((prob.n_dof, prob.dim), dtype=prob.dtype, device=prob.device)
    a0 = _explicit_accel(prob, z, prob.state0, dt)
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
    }


def _explicit_accel(prob, u, state, dt):
    res_sweep, _, _ = _select_impl(prob, None)
    gather_t, scatter_el = _gather_scatter(prob)
    mat = prob.material
    tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
    free = prob.free
    n_dof, dim = prob.n_dof, prob.dim
    rho = float(mat.density)
    u_el = gather_t(u)
    E_u = scatter_el(
        res_sweep(u_el, torch.zeros_like(u_el), state, tabs, jinv, wq, mat, dt, rho)
    )
    z = (prob.rhs - E_u) * free

    def mass_apply(w_flat):
        w = w_flat.reshape(n_dof, dim) * free
        v = sweeps.sf_value(gather_t(w), tabs)
        y = scatter_el(sweeps.sf_scatter(None, rho * v, tabs, jinv, wq))
        return (y * free + w_flat.reshape(n_dof, dim) * (1 - free)).reshape(-1)

    m_el = rho * sf_nodal(wq, tabs, square=True)  # (nd, n_el)
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
    gmres_restart: int = 30,
    tangent_storage: str = "auto",
    matvec_impl: str = "auto",
):
    """One generalized-alpha step, carry -> carry.

    `residual_impl` selects who runs the three quadrature sweeps:
      - "cuda" (default for a problem on a CUDA device): the hand-written
        CUDA kernels of ops/csrc/sweeps_sf.cu, float32 only; the
        counterpart of the reference package's "pallas".
      - "torch" (default on the CPU): their plain torch versions, any
        dtype; the counterpart of the reference package's "soa" engine
        (same math, sum-factorized tables instead of dense ones).
    Both evaluate the residual with the sum-factorized tables and store
    the 37-plane Cauchy-decomposition tangent; everything around the
    sweeps (gather/scatter, FDM, GMRES, Newton) is the same torch code.

    Newton runs up to `newton_iters` iterations; each linear solve is
    FDM-preconditioned GMRES(restart) with at most `cg_iters` iterations
    and tolerances lin_rel_tol/lin_abs_tol (defaults 1e-8/1e-12 in
    float64, 3e-6/1e-12 in float32).

    The returned `step(carry)` has an attribute `newton_system(carry)`
    that returns the first Newton linear system at the predictor of
    `carry` as {"J_apply", "M_apply", "r"} (flat vectors), for solver
    diagnostics.
    """
    if solver not in ("cg", "iterative", "gmres"):
        raise _unported(f"solver={solver!r} (dense LU)", "Queue 1 item 6")
    mat = prob.material
    if float(mat.viscosity) > 0.0:
        raise _unported("viscosity", "Queue 1 item 6")
    if precond == "auto":
        precond = "fdm"
    if precond in ("bj", "schur"):
        raise _unported(f"precond={precond!r}", "Queue 1 items 6 and 10")
    if precond != "fdm":
        raise ValueError(f"unknown precond {precond!r}")
    if prob.fdm is None:
        raise _unported("problems without an FDM decomposition (block-Jacobi)", "Queue 1 item 6")
    if tangent_storage in ("full", "sym"):
        raise _unported(f"tangent_storage={tangent_storage!r}", "Queue 2 item 1")
    if tangent_storage not in ("auto", "cauchy"):
        raise ValueError(f"unknown tangent_storage {tangent_storage!r}")
    if not mat.tangent_cauchy_decomp:
        raise _unported(f"{mat.name()} (full/sym tangent storage)", "Queue 2 item 1")
    if matvec_impl == "dense":
        raise _unported("matvec_impl='dense'", "Queue 2 item 2")
    if matvec_impl not in ("auto", "sf"):
        raise ValueError(f"unknown matvec_impl {matvec_impl!r}")
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
    tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
    rhs, free = prob.rhs, prob.free
    fdm_apply = make_fdm_apply(prob.fdm, fac0, fac1, prob.dtype, prob.device)
    gather_t, scatter_el = _gather_scatter(prob)

    def residual(aa, xa, state):
        u_el = gather_t(xa + fac0 * aa)
        a_el = gather_t(aa * free)
        y = scatter_el(res_sweep(u_el, a_el, state, tabs, jinv, wq, mat, dt, rho))
        return (y - rhs) * free

    def assemble(aa, xa, state):
        u_el = gather_t(xa + fac0 * aa)
        a_el = gather_t(aa * free)
        res_t, Ck = asm_sweep(u_el, a_el, state, tabs, jinv, wq, mat, dt, rho)
        return (scatter_el(res_t) - rhs) * free, Ck

    def operators(Ck):
        def J_apply(w_flat):
            w = w_flat.reshape(n_dof, dim) * free
            y = scatter_el(mv_sweep(gather_t(w), tabs, jinv, wq, Ck, rho, fac0))
            return (y * free + w_flat.reshape(n_dof, dim) * (1 - free)).reshape(-1)

        return J_apply, fdm_apply

    def solve(Ck, r):
        J_apply, M_apply = operators(Ck)
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

    def newton(xa, state):
        """LineSearchNewton: goal max(rel*|r0|, abs), 3-point line search
        with a 1e-12 scale-floor abort, 5-iteration best window."""
        aa = torch.zeros_like(xa)
        r, Ck = assemble(aa, xa, state)
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
            step_c, li = solve(Ck, r)
            q1 = norm
            q3 = float(torch.linalg.norm(residual(aa - step_c, xa, state)))
            q2 = float(torch.linalg.norm(residual(aa - 0.5 * step_c, xa, state)))
            denom = q1 - 2.0 * q2 + q3
            eps = (3.0 * q1 - 4.0 * q2 + q3) / (4.0 * denom) if denom != 0 else math.nan
            if denom > 0 and 0 < eps < 1:
                scale = eps
            else:
                scale = 1.0 if q3 < q1 else 0.05
            stop = abs(scale) < 1e-12
            if not stop:
                aa = aa - scale * step_c
            r, Ck = assemble(aa, xa, state)
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

    def step(carry):
        u, v, a, state = carry["u"], carry["v"], carry["a"], carry["state"]
        prev_fac = 1.0 - f["fac1_inv"]
        xa, va = predictor(carry)
        aa, diag = newton(xa, state)
        xa = xa + fac0 * aa
        va = va + fac1 * aa
        u_new = u * prev_fac + f["fac1_inv"] * xa
        v_new = v * prev_fac + f["fac1_inv"] * va
        a_new = a * prev_fac + f["fac5_inv"] * aa
        if state is not None:
            dF = sweeps.sf_grad(gather_t(u_new), tabs, jinv)
            state = mat.accumulate_soa(soa.add_diag(dF, 1.0), state, dt)
        finite = bool(torch.isfinite(u_new).all()) and bool(torch.isfinite(v_new).all())
        if state is not None:
            finite = finite and all(bool(torch.isfinite(x).all()) for x in state.values())
        return {
            "u": u_new,
            "v": v_new,
            "a": a_new,
            "state": state,
            "newton": dict(diag, finite=finite),
        }

    def newton_system(carry):
        xa, _ = predictor(carry)
        r, Ck = assemble(torch.zeros_like(xa), xa, carry["state"])
        J_apply, M_apply = operators(Ck)
        return {"J_apply": J_apply, "M_apply": M_apply, "r": r.reshape(-1)}

    step.newton_system = newton_system
    return step
