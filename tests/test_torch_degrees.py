"""The port's sweeps at the remaining degrees, quadrature orders and
element shapes on the CPU against the reference package, in float64.

  - the plain sf residual, J w (through the material's own block) and the
    full 81 planes at p = 1 (cube-nurbs.mesh, 2 nodes and 3 Gauss points
    per axis) and p = 4 (cube-nurbs-3.mesh elevated by 1: 5 and 6), and
    the plain dense ones at 2D p = 1 and p = 4, 3D p = 1 and p = 4,
    degrees [3, 2] in 2D, 2D p = 2 at quadrature orders 5 and 9 (3 and 5
    points per axis) and a rational patch (a quarter annulus, p = 2,
    weights 1 / sqrt(2) on the arcs' middle control points), each against
    the reference's jitted math on its own tables at 1e-10 of scale, J2
    on a plastic history, the neo-Hookean and J2Simo; the port's tables of
    each shape against the reference's;
  - two float64 steps of path L's problem (the neo-Hookean cantilever at
    p = 4) at 4^2 and one of the quarter annulus against the reference's
    `soa` make_step at 1e-8 (path K's steps are in
    test_torch_degrees_steps.py, so that the reference's p = 4 step
    compiles on another test worker);
  - the new shapes pass the kernels' shape checks up to the device check
    (meta tensors) and their counters name them; degrees that differ per
    axis no longer raise ValueError.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa as tsoa
from mimi_tpu_torch.nurbs.mesh_io import read_mfem_nurbs_mesh, single_patch_mesh
from mimi_tpu_torch.nurbs.topology import build_patch_from_mesh
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy
from test_torch_p3 import DT, FAC0, RHO, _material, _max_rel_err, _ref_np, _rel
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
BALKEN = os.path.join(DATA, "balken.mesh")
MATERIALS = ("J2", "CompressibleOgdenNeoHookean", "J2Simo")


def mixed_degree_mesh():
    """balken.mesh with degrees [3, 2]: 12 dofs and 20 points per element."""
    template = read_mfem_nurbs_mesh(BALKEN)
    patch = build_patch_from_mesh(template)[0]
    patch.elevate_axis(0, 2)
    patch.elevate_axis(1, 1)
    return single_patch_mesh(template, patch.degrees, patch.knot_vectors, patch.control_points,
                             patch.weights)


def quarter_annulus_mesh():
    """The quarter annulus 1 <= r <= 2, 0 <= theta <= pi / 2 as one
    rational patch of degree 2 (axis 0 radial, axis 1 the exact arcs) on
    balken.mesh's topology (boundary 1: the edge theta = 0)."""
    arc = [(1.0, 0.0, 1.0), (1.0, 1.0, 2**-0.5), (0.0, 1.0, 1.0)]
    cps = [(r * x, r * y) for x, y, _ in arc for r in (1.0, 1.5, 2.0)]
    w = [wa for _, _, wa in arc for _ in range(3)]
    kv = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    return single_patch_mesh(read_mfem_nurbs_mesh(BALKEN), [2, 2], [kv, kv], np.array(cps),
                             np.array(w))


# (mesh, elevate, subdivide, refine_spans, quadrature_order) of each shape,
# by (kind, (dim, nd, n_q)) ("sf" shapes run the sf sweeps, whose dense
# twin's tables the reference builds too)
CUBE = os.path.join(DATA, "cube-nurbs.mesh")
CUBE3 = os.path.join(DATA, "cube-nurbs-3.mesh")
TWO_PATCH = os.path.join(DATA, "two-patch-cube.mesh")
SHAPES = {
    "sf_p1": ("sf", CUBE, 0, 0, 3, -1, (3, 8, 27)),
    "sf_p4": ("sf", CUBE3, 1, 0, 2, -1, (3, 125, 216)),
    "dense_2d_p1": ("dense", BALKEN, 0, 2, None, -1, (2, 4, 9)),
    "dense_2d_p4": ("dense", BALKEN, 3, 1, None, -1, (2, 25, 36)),
    "dense_3d_p1": ("dense", TWO_PATCH, 0, 0, 2, -1, (3, 8, 27)),
    "dense_3d_p4": ("dense", TWO_PATCH, 3, 0, 1, -1, (3, 125, 216)),
    "dense_2d_deg32": ("dense", "mixed", 0, 1, None, -1, (2, 12, 20)),
    "dense_2d_p2_order5": ("dense", BALKEN, 1, 1, None, 5, (2, 9, 9)),
    "dense_2d_p2_order9": ("dense", BALKEN, 1, 1, None, 9, (2, 9, 25)),
    "dense_2d_rational": ("dense", "annulus", 0, 1, None, -1, (2, 9, 16)),
}


def _mesh(mesh):
    return {"mixed": mixed_degree_mesh, "annulus": quarter_annulus_mesh}.get(
        mesh, lambda: mesh)()


def _clamp(dim):
    return [(1, c) for c in range(dim)] if dim == 3 else [(1, 0), (1, 1)]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request):
    """The reference's problem at the shape in float64 (its dense tables,
    and on sf shapes its sf tables), the port's build of the same, and
    element fields made with numpy."""
    kind, mesh, elevate, subdivide, spans, order, key = SHAPES[request.param]
    dim, nd, n_q = key
    kw = dict(elevate=elevate, subdivide=subdivide, dirichlet=_clamp(dim), body_force={1: -3.0},
              rho_inf=0.5, refine_spans=spans, quadrature_order=order)
    ref = jsh.build_problem(_mesh(mesh), material=_material(mimi, "J2"), dtype=jnp.float64, **kw)
    port = mt.build_problem(_mesh(mesh), material=_material(mt, "J2"), dtype=torch.float64,
                            device="cpu", **kw)
    E = ref.n_el
    rng = np.random.default_rng(41)
    amp = 0.02 if dim == 3 else 0.01
    data = {
        "u0": amp * rng.standard_normal((dim, nd, E)),
        "u_el": amp * rng.standard_normal((dim, nd, E)),
        "a_el": rng.standard_normal((dim, nd, E)),
        "w_el": rng.standard_normal((dim, nd, E)),
        "wq": np.ascontiguousarray(np.asarray(ref.w_detJ).T),
        "dN_t": np.transpose(np.asarray(ref.dN_dX), (2, 3, 1, 0)).copy(),
        "N_t": np.transpose(np.asarray(ref.N), (2, 1, 0)).copy(),
    }
    assert data["dN_t"].shape == (nd, dim, n_q, E)
    if kind == "sf":
        assert (ref.sf["pp1"] ** 3, ref.sf["n_g"] ** 3) == (nd, n_q)
        data["tabs"] = [np.asarray(t) for t in ref.sf["tables"]]
        data["jinv"] = np.asarray(ref.sf["jinv"])
    return request.param, kind, key, ref, port, data


def _history(name, kind, data):
    """The port's material and a plastic history for it (its state after
    one accumulate_soa from the initial state at F = I + grad u0), as
    numpy; None for the neo-Hookean."""
    dim = data["u0"].shape[0]
    mat = _material(mt, name)
    mat.setup(dim)
    if not mat.has_state:
        return mat, None
    if kind == "sf":
        grad = tsw.sf_grad(_t(data["u0"]), [_t(x) for x in data["tabs"]], _t(data["jinv"]))
    else:
        grad = tsw.dense_grad(_t(data["u0"]), _t(data["dN_t"]))
    F0 = tsoa.add_diag(grad, 1.0)
    state0 = tsoa.state_to_soa(mat.init_state((F0.shape[-1], F0.shape[-2]), dtype=torch.float64,
                                              device="cpu"))
    state = mat.accumulate_soa(F0, state0, DT)
    assert float(state["eqps"].max()) > 0.0
    return mat, {k: v.numpy() for k, v in state.items()}


def _reference(name, data, state):
    """The reference's element residual, J w of its linearization
    (fac0 dP/dF : grad w, plus the mass term) and the dim^4 planes
    dP_a / dF_b on its dense tables, jitted, in float64."""
    dim = data["u0"].shape[0]
    ref_mat = _material(mimi, name)
    ref_mat.setup(dim)
    dN_t, N_t, wq = (jnp.asarray(data[k]) for k in ("dN_t", "N_t", "wq"))
    st = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}

    def integrate(P, vec):
        return (jnp.einsum("qe,ndqe,cdqe->cne", wq, dN_t, P)
                + jnp.einsum("qe,nqe,cqe->cne", wq, N_t, vec))

    @jax.jit
    def run(u_el, a_el, w_el):
        F = jnp.einsum("ndqe,cne->cdqe", dN_t, u_el) + jnp.eye(dim)[:, :, None, None]
        P, lin = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, st, DT), F)
        y = integrate(P, RHO * jnp.einsum("nqe,cne->cqe", N_t, a_el))
        dW = jnp.einsum("ndqe,cne->cdqe", dN_t, w_el)
        jw = integrate(FAC0 * lin(dW), RHO * jnp.einsum("nqe,cne->cqe", N_t, w_el))
        d2 = dim * dim
        seeds = jnp.eye(d2).reshape(d2, dim, dim)[:, :, :, None, None] * jnp.ones_like(F)
        cols = jax.vmap(lin)(seeds)  # cols[b] = dP / dF_b
        full = jnp.stack([cols[b][a // dim, a % dim] for a in range(d2) for b in range(d2)])
        return y, jw, full

    return [np.asarray(x) for x in run(*(jnp.asarray(data[k])
                                         for k in ("u_el", "a_el", "w_el")))]


@pytest.mark.parametrize("name", MATERIALS)
def test_plain_sweeps_match_reference(shape, name):
    """The port's plain residual, assemble (the material's own block) and
    J w through it, and the full planes, on the shape's tables (sf or
    dense) against the reference's jitted dense-table math at 1e-10."""
    sid, kind, key, _, _, data = shape
    mat, state = _history(name, kind, data)
    y_ref, jw_ref, full_ref = _reference(name, data, state)
    st = None if state is None else {k: _t(v) for k, v in state.items()}
    if kind == "sf":
        tables = ([_t(x) for x in data["tabs"]], _t(data["jinv"]))
        plain = (tsw.residual_sf_plain, tsw.assemble_sf_plain, tsw.matvec_sf_plain)
    else:
        tables = (_t(data["dN_t"]), _t(data["N_t"]))
        plain = (tsw.residual_dense_plain, tsw.assemble_dense_plain, tsw.matvec_dense_plain)
    wq = _t(data["wq"])
    args = (_t(data["u_el"]), _t(data["a_el"]), st, *tables, wq, mat, DT, RHO)
    storage = tsw.tangent_storage(mat)
    assert _rel(plain[0](*args).numpy(), y_ref) < 1e-10, (sid, name)
    y, C = plain[1](*args)
    assert C.shape == (tsw.n_planes(storage, key[0]), key[2], y.shape[-1])
    assert _rel(y.numpy(), y_ref) < 1e-10, (sid, name)
    jw = plain[2](_t(data["w_el"]), *tables, wq, C, RHO, FAC0, storage=storage)
    assert _rel(jw.numpy(), jw_ref) < 1e-10, (sid, name)
    _, C_full = plain[1](*args, storage="full")
    assert _rel(C_full.numpy(), full_ref) < 1e-10, (sid, name)


def test_port_tables_match_reference(shape):
    """The port's build at the shape: the same table kind, element shape
    and tables (dense dN, N, w det J; on sf shapes the 1D tables and jinv)
    as the reference's, at 1e-12."""
    sid, kind, key, ref, port, data = shape
    dim, nd, n_q = key
    assert (port.sf is not None) == (kind == "sf"), sid
    assert (port.dim, port.n_q, port.n_el) == (dim, n_q, ref.n_el)
    assert _rel(port.wdet_t.numpy(), data["wq"]) < 1e-12
    if kind == "sf":
        for t, t_ref in zip(port.sf["tables"], data["tabs"]):
            assert _rel(t.numpy(), t_ref) < 1e-12
        assert _rel(port.sf["jinv"].numpy(), data["jinv"]) < 1e-12
    else:
        assert _rel(port.dense["dN_t"].numpy(), data["dN_t"]) < 1e-12
        assert _rel(port.dense["N_t"].numpy(), data["N_t"]) < 1e-12


def _steps(ref, port, step_kw, n):
    """n float64 steps of the reference's `soa` step and the port's from
    the reference's initial carry, held at 1e-8 after each."""
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    rstep = jsh.make_step(ref, solver="cg", residual_impl="soa", precond="fdm",
                          lin_rel_tol=1e-6, **step_kw)
    pstep = mt.make_step(port, lin_rel_tol=1e-6, **step_kw)
    for i in range(n):
        rc, pc = rstep(rc), pstep(pc)
        assert pc["newton"]["finite"], i
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"]), i
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)
    return carry_to_numpy(pc)


def test_two_p4_cantilever_steps_match_reference():
    """Path L's problem at 4^2: the neo-Hookean cantilever (balken.mesh,
    force -5) elevated by 3 to p = 4 (dense (2, 25, 36) tables), dt 0.05,
    the cantilever's 10 Newton iterations: two float64 steps against the
    reference's `soa` step."""
    name = "CompressibleOgdenNeoHookean"
    kw = dict(elevate=3, subdivide=2, dirichlet=[(2, 0), (2, 1)], body_force={1: -5.0},
              rho_inf=0.5)
    ref = jsh.build_problem(BALKEN, material=_material(mimi, name), dtype=jnp.float64, **kw)
    port = mt.build_problem(BALKEN, material=_material(mt, name), dtype=torch.float64,
                            device="cpu", **kw)
    assert tuple(port.dense["dN_t"].shape[:3]) == (25, 2, 36)
    out = _steps(ref, port, dict(dt=0.05, newton_iters=10, cg_iters=80), 2)
    assert float(out["u"][:, 1].min()) < -1e-3  # the beam sags


def test_rational_patch_step_matches_reference():
    """The quarter annulus (a rational p = 2 patch: dense tables, by
    _sf_gate) at 8 x 8 elements, the edge theta = 0 clamped, the
    neo-Hookean under body force: one float64 step against the reference's
    `soa` step; the patch gets dense tables in both packages."""
    name = "CompressibleOgdenNeoHookean"
    kw = dict(elevate=0, subdivide=3, dirichlet=[(1, 0), (1, 1)], body_force={0: -5.0},
              rho_inf=0.5)
    ref = jsh.build_problem(quarter_annulus_mesh(), material=_material(mimi, name),
                            dtype=jnp.float64, **kw)
    port = mt.build_problem(quarter_annulus_mesh(), material=_material(mt, name),
                            dtype=torch.float64, device="cpu", **kw)
    assert port.sf is None and tuple(port.dense["dN_t"].shape[:3]) == (9, 2, 16)
    assert not np.allclose(build_patch_from_mesh(quarter_annulus_mesh())[0].weights, 1.0)
    out = _steps(ref, port, dict(dt=0.05, newton_iters=10, cg_iters=80), 1)
    assert float(np.abs(out["u"]).max()) > 1e-4


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("p1, n_g", [(2, 3), (5, 6), (3, 3), (3, 5), (6, 4)],
                         ids=["p1", "p4", "p2_order5", "p2_order9", "p5_4pts"])
def test_sf_shapes_pass_the_kernel_checks(p1, n_g):
    """Consistent sf tables of any degree and Gauss count pass _check_common
    up to the device check (meta tensors: no device is asked) and name
    their shape in the counters; inconsistent ones stay ValueError."""
    E = 8
    tabs = [_meta(n_g, p1, E) for _ in range(6)]
    jinv, wq, w = _meta(3, 3, n_g**3, E), _meta(n_g**3, E), _meta(3, p1**3, E)
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw._check_common([("w_el", w)], tabs, jinv, wq)
    with pytest.raises(ValueError, match="required"):
        tsw._check_common([("w_el", _meta(3, p1**3 + 1, E))], tabs, jinv, wq)
    sfx = tsw._shape_suffix(3, (p1, n_g))
    assert sfx == (f"@3d_p{p1 - 1}" if n_g == p1 + 1 else f"@3d_p{p1 - 1}_g{n_g}")
    mat = _material(mt, "J2")
    mat.setup(3)
    assert tsw.kernel_counters(mat, "sf", 3, (p1, n_g)) == (f"residual_sf{sfx}",
                                                            f"assemble_sf{sfx}")
    tsw.register_shape("sf", (p1, n_g))
    for name in (*tsw.kernel_counters(mat, "sf", 3, (p1, n_g), True, True),
                 tsw.matvec_counter("sf", "full", 3, (p1, n_g), True, True)):
        assert tsw.LAUNCHES[name] == 0, name


@pytest.mark.parametrize("key", [(2, 4, 9), (2, 25, 36), (3, 8, 27), (3, 125, 216),
                                 (2, 12, 20), (2, 9, 9), (2, 9, 25)],
                         ids=["2d_p1", "2d_p4", "3d_p1", "3d_p4", "2d_deg32", "2d_p2_order5",
                              "2d_p2_order9"])
def test_dense_shapes_pass_the_kernel_checks(key):
    """Consistent dense tables of any (dim, nd, n_q), degrees that differ
    per axis included (12 dofs of degrees [3, 2]: the repair), pass
    _check_dense and the wrappers up to the device check; their counters
    name the shape."""
    dim, nd, n_q = key
    E = 8
    dN, N, wq, w = _meta(nd, dim, n_q, E), _meta(nd, n_q, E), _meta(n_q, E), _meta(dim, nd, E)
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw._check_dense([("w_el", w)], dN, N, wq)
    mat = _material(mt, "CompressibleOgdenNeoHookean")
    mat.setup(dim)
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw.residual_dense(w, w, None, dN, N, wq, mat, DT, RHO)
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw.matvec_dense(w, dN, N, wq, _meta(tsw.n_planes("sym", dim), n_q, E), RHO, FAC0)
    sfx = tsw._shape_suffix(dim, key)
    expect = {(2, 4, 9): "@2d_p1", (2, 25, 36): "@2d_p4", (3, 8, 27): "@3d_p1",
              (3, 125, 216): "@3d_p4", (2, 12, 20): "@2d_nd12_q20", (2, 9, 9): "@2d_p2_g3",
              (2, 9, 25): "@2d_p2_g5"}[key]
    assert sfx == expect
    assert tsw.material_counters("dense", "j2", "cauchy", dim, key) == (
        f"residual_dense[j2]{sfx}", f"assemble_dense[j2,cauchy]{sfx}")
    assert tsw.fused_counters(key) == (f"neohookean_residual{sfx}",
                                       f"neohookean_tangent_apply{sfx}")
    with pytest.raises(ValueError):  # N of another point count
        tsw._check_dense([("w_el", w)], dN, _meta(nd, n_q + 1, E), wq)
