"""The port's dense-table path (mimi_tpu_torch) against the reference
package on the neo-Hookean two-patch cantilever of
tests/test_multipatch.py: two-patch-cube.mesh (the second patch rotated)
at p=2 and 16 elements, the x=0 face clamped, body force -5.

  - the neo-Hookean stress at 1e-12 and its closed-form dP/dF (what the
    CUDA dense assemble writes) against forward-mode AD at 1e-10;
  - the multi-patch space, its dense tables and the multi-patch FDM
    apply, the connectivity gather and scatter;
  - the three plain dense sweeps with the 45-plane symmetric tangent
    against the Pallas kernels in interpret mode (float32, the bars of
    tests/test_pallas.py) and the same math in JAX float64 (1e-10);
  - three steps against the reference's `soa` engine (float64, 1e-8),
    the run against its knot-split single-patch twin (1e-9), and the step
    on a converted reference problem;
  - the entry points that default to the card raise without one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.fem.multipatch import MultiPatchFESpace as RefMultiPatchFESpace
from mimi_tpu.nurbs.mesh_io import read_mfem_nurbs_mesh as ref_read
from mimi_tpu.ops import sweeps as jsw
from mimi_tpu.parallel import sharding as jsh
from mimi_tpu.solvers.fdm import make_fdm_apply_multipatch

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem.multipatch import MultiPatchFESpace
from mimi_tpu_torch.fem.space import FESpace
from mimi_tpu_torch.nurbs.mesh_io import read_mfem_nurbs_mesh
from mimi_tpu_torch.nurbs.topology import build_patch_from_mesh
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.parallel import sharding as tsh
from mimi_tpu_torch.solvers.fdm import make_fdm_apply
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    material_from_reference,
    problem_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
MP = os.path.join(DATA, "two-patch-cube.mesh")
SP = os.path.join(DATA, "two-patch-cube-ref.mesh")
BUILD = dict(
    elevate=1,
    subdivide=1,
    dirichlet=[(0, 0), (0, 1), (0, 2)],  # clamp x = 0 (attribute 1)
    body_force={1: -5.0},
    rho_inf=0.5,
)
STEP = dict(dt=0.05, newton_iters=4, cg_iters=40)
DT, RHO, FAC0 = 0.05, 1.0, 0.01


def _material(pkg):
    mat = pkg.CompressibleOgdenNeoHookean()
    mat.density = RHO
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


@pytest.fixture(scope="module")
def problems():
    ref = jsh.build_problem(MP, material=_material(mimi), dtype=jnp.float64, **BUILD)
    port = mt.build_problem(MP, material=_material(mt), device="cpu", **BUILD)
    return ref, port


@pytest.fixture(scope="module")
def fields(problems):
    """Element fields made with numpy: u at strains of ~5-10%, a and w of
    unit size."""
    ref, _ = problems
    rng = np.random.default_rng(7)
    E = ref.n_el
    return {
        "u_el": 0.03 * rng.standard_normal((3, 27, E)),
        "a_el": rng.standard_normal((3, 27, E)),
        "w_el": rng.standard_normal((3, 27, E)),
        "dN_t": np.transpose(ref.dN_dX, (2, 3, 1, 0)).copy(),
        "N_t": np.transpose(ref.N, (2, 1, 0)).copy(),
        "wq": np.ascontiguousarray(np.asarray(ref.w_detJ).T),
    }


# ---- (a) the material -------------------------------------------------------


def _random_F(n=64, scale=0.1, seed=3):
    rng = np.random.default_rng(seed)
    return np.eye(3)[:, :, None] + scale * rng.standard_normal((3, 3, n))


def test_neohookean_pk1_matches_reference():
    ref, port = _material(mimi), _material(mt)
    ref.setup(3)
    port.setup(3)
    F = _random_F()
    P_ref = np.asarray(ref.pk1_soa(jnp.asarray(F), None, DT))
    P = port.pk1_soa(torch.tensor(F), None, DT).numpy()
    assert _rel(P, P_ref) < 1e-12


def test_neohookean_closed_form_tangent():
    """tangent_soa (the formula of the CUDA dense assemble) against
    torch.func.jacfwd of pk1_soa, and its major symmetry."""
    mat = _material(mt)
    mat.setup(3)
    F = torch.tensor(_random_F(n=6))
    C = mat.tangent_soa(F)
    for e in range(F.shape[-1]):
        Fe = F[:, :, e : e + 1]
        J = torch.func.jacfwd(lambda x: mat.pk1_soa(x, None, DT))(Fe)
        # (c, d, 1, g, f, 1) -> (c, d, g, f)
        assert _rel(C[..., e], J[:, :, 0, :, :, 0]) < 1e-10
    C9 = C.reshape(9, 9, -1)
    assert float((C9 - C9.transpose(0, 1)).abs().max()) <= 1e-12 * float(C9.abs().max())


# ---- (b) the multi-patch space ----------------------------------------------


@pytest.fixture(scope="module")
def spaces():
    ref = RefMultiPatchFESpace(ref_read(MP), elevate=1, subdivide=1)
    port = MultiPatchFESpace(read_mfem_nurbs_mesh(MP), elevate=1, subdivide=1)
    return ref, port


def test_multipatch_space_matches_reference(spaces):
    ref, port = spaces
    assert port.n_dof == ref.n_dof == 112
    assert port.counts() == ref.counts()
    assert port.sides == ref.sides
    assert np.array_equal(port.x_ref, ref.x_ref)
    mask = {0: {0, 1, 2}, 3: {1}}
    assert np.array_equal(port.boundary_dof_mask(mask), ref.boundary_dof_mask(mask))
    for bid in range(6):
        assert np.array_equal(port.side_dofs(bid), ref.side_dofs(bid))


@pytest.mark.parametrize("field", ["conn", "N", "dN_dX", "w_detJ"])
def test_multipatch_tables_match_reference(spaces, field):
    ref, port = spaces
    got, want = getattr(port.domain_tables(), field), getattr(ref.domain_tables(), field)
    if field == "conn":
        assert np.array_equal(got, want)
    else:
        assert _rel(got, want) < 1e-12


def test_multipatch_boundary_tables_match_reference(spaces):
    ref, port = spaces
    got, want = port.boundary_tables(), ref.boundary_tables()
    for field in ("conn", "attr", "normal_sign"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    for field in ("N", "dN_dxi", "wq", "detJ_ref"):
        assert _rel(getattr(got, field), getattr(want, field)) < 1e-12, field


@pytest.mark.parametrize("field", ["conn", "rhs", "free", "dN_t", "N_t", "wdet_t"])
def test_problem_fields_match_reference(problems, fields, field):
    ref, port = problems
    assert (port.n_dof, port.n_el, port.n_q, port.grid, port.sf) == (
        ref.n_dof, ref.n_el, ref.n_q, None, None,
    )
    got = {
        "conn": port.conn, "rhs": port.rhs, "free": port.free,
        "dN_t": port.dense["dN_t"], "N_t": port.dense["N_t"], "wdet_t": port.wdet_t,
    }[field]
    want = {
        "conn": ref.conn, "rhs": ref.rhs, "free": ref.free, "dN_t": fields["dN_t"],
        "N_t": fields["N_t"], "wdet_t": fields["wq"],
    }[field]
    if field in ("conn", "free"):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    else:
        assert _rel(got, want) < 1e-12


# ---- (c) the multi-patch FDM ------------------------------------------------


def test_multipatch_fdm_apply_matches_reference(problems):
    ref, port = problems
    assert "mp" in port.fdm and len(port.fdm["mp"]) == 2
    for pr, pp in zip(ref.fdm["mp"], port.fdm["mp"]):
        for c in range(3):
            for ax in range(3):
                assert _rel(pp["Ve"][c][ax], pr["Ve"][c][ax]) < 1e-12
    fac0, fac1 = 1e-3, 0.02
    v = np.random.default_rng(5).standard_normal(ref.n_dof * 3)
    y_ref = make_fdm_apply_multipatch(ref.fdm, fac0, fac1, jnp.float64)(jnp.asarray(v))
    y = make_fdm_apply(port.fdm, fac0, fac1, torch.float64, "cpu")(torch.tensor(v))
    assert _rel(y.numpy(), y_ref) < 1e-10


# ---- (d) gather and scatter through conn -------------------------------------


def test_conn_gather_scatter_match_reference(problems):
    """Integer-valued data, so every summation order is exact."""
    ref, port = problems
    rng = np.random.default_rng(9)
    u = rng.integers(-50, 50, (ref.n_dof, 3)).astype(np.float64)
    r = rng.integers(-50, 50, (3, 27, ref.n_el)).astype(np.float64)
    gather_t, scatter_el = tsh._gather_scatter(port)
    connT = jnp.asarray(np.ascontiguousarray(ref.conn.T))
    g_ref = np.asarray(jnp.asarray(u).T[:, connT])
    s_ref = np.asarray(jnp.zeros((3, ref.n_dof)).at[:, connT].add(jnp.asarray(r)).T)
    assert np.array_equal(gather_t(torch.tensor(u)).numpy(), g_ref)
    assert np.array_equal(scatter_el(torch.tensor(r)).numpy(), s_ref)


# ---- (e) the dense sweeps ---------------------------------------------------


def _t(data, dtype):
    return [torch.tensor(data[k], dtype=dtype) for k in ("u_el", "a_el", "dN_t", "N_t", "wq")]


@pytest.fixture(scope="module")
def pallas(problems, fields):
    """The three dense Pallas sweeps in interpret mode, float32, sym."""
    ref, _ = problems
    j = {k: jnp.asarray(v, jnp.float32) for k, v in fields.items()}
    kw = dict(
        mat=ref.material, dt=DT, dim=3, nd=27, n_q=64, n_el=ref.n_el, rho=RHO,
        mu_v=0.0, has_visc=False, state=None, block_e=ref.n_el, interpret=True,
    )
    args = (j["u_el"], j["a_el"], None, None, j["dN_t"], j["N_t"], j["wq"])
    y_res = jsw.make_residual_sweep(**kw)(*args)
    y_asm, C = jsw.make_assemble_sweep(**kw, c_storage="sym")(*args)
    y_mv = jsw.make_matvec_sweep(
        dim=3, nd=27, n_q=64, n_el=ref.n_el, rho=RHO, fac0=FAC0, fac1_mu_v=0.0,
        has_visc=False, block_e=ref.n_el, interpret=True, c_storage="sym",
    )(j["w_el"], j["dN_t"], j["N_t"], j["wq"], C)
    return {k: np.asarray(v) for k, v in dict(res=y_res, asm=y_asm, C=C, mv=y_mv).items()}


def test_dense_residual_matches_pallas(problems, fields, pallas):
    mat = problems[1].material
    u, a, dN, N, wq = _t(fields, torch.float32)
    y = tsw.residual_dense_plain(u, a, None, dN, N, wq, mat, DT, RHO)
    assert _rel(y.numpy(), pallas["res"]) < 1e-4


def test_dense_assemble_matches_pallas(problems, fields, pallas):
    mat = problems[1].material
    u, a, dN, N, wq = _t(fields, torch.float32)
    y, C = tsw.assemble_dense_plain(u, a, None, dN, N, wq, mat, DT, RHO)
    assert C.shape == (45, 64, problems[0].n_el)
    assert _rel(y.numpy(), pallas["asm"]) < 1e-4
    assert _rel(C.numpy(), pallas["C"]) < 1e-4


def test_dense_matvec_matches_pallas(problems, fields, pallas):
    _, _, dN, N, wq = _t(fields, torch.float32)
    w = torch.tensor(fields["w_el"], dtype=torch.float32)
    y = tsw.matvec_dense_plain(w, dN, N, wq, torch.tensor(pallas["C"]), RHO, FAC0)
    assert _rel(y.numpy(), pallas["mv"]) < 1e-3


@pytest.fixture(scope="module")
def jax_f64(problems, fields):
    """The same math in JAX float64: residual, the 45 symmetric planes of
    the forward-mode dP/dF, and the matvec as the jvp of P."""
    ref_mat = problems[0].material
    j = {k: jnp.asarray(v) for k, v in fields.items()}
    dN, N, wq = j["dN_t"], j["N_t"], j["wq"]
    F = jnp.einsum("ndqe,cne->cdqe", dN, j["u_el"]) + jnp.eye(3)[:, :, None, None]

    def integrate(P, vec):
        return jnp.einsum("qe,ndqe,cdqe->cne", wq, dN, P) + jnp.einsum(
            "qe,nqe,cqe->cne", wq, N, vec
        )

    P, jvp_fn = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, None, DT), F)
    cols = [jvp_fn(jnp.zeros_like(F).at[b // 3, b % 3].set(1.0)) for b in range(9)]
    planes = [
        cols[a][a // 3, a % 3] if a == b
        else 0.5 * cols[a][b // 3, b % 3] + 0.5 * cols[b][a // 3, a % 3]
        for a in range(9) for b in range(a, 9)
    ]
    dP = FAC0 * jvp_fn(jnp.einsum("ndqe,cne->cdqe", dN, j["w_el"]))
    return {
        "res": np.asarray(integrate(P, RHO * jnp.einsum("nqe,cne->cqe", N, j["a_el"]))),
        "C": np.asarray(jnp.stack(planes)),
        "mv": np.asarray(integrate(dP, RHO * jnp.einsum("nqe,cne->cqe", N, j["w_el"]))),
    }


def test_dense_sweeps_match_jax_f64(problems, fields, jax_f64):
    mat = problems[1].material
    u, a, dN, N, wq = _t(fields, torch.float64)
    y = tsw.residual_dense_plain(u, a, None, dN, N, wq, mat, DT, RHO)
    assert _rel(y.numpy(), jax_f64["res"]) < 1e-10
    ya, C = tsw.assemble_dense_plain(u, a, None, dN, N, wq, mat, DT, RHO)
    assert torch.equal(ya, y)
    assert _rel(C.numpy(), jax_f64["C"]) < 1e-10
    mv = tsw.matvec_dense_plain(torch.tensor(fields["w_el"]), dN, N, wq, C, RHO, FAC0)
    assert _rel(mv.numpy(), jax_f64["mv"]) < 1e-10


def test_closed_form_planes_match_assemble(problems, fields):
    """The planes the CUDA assemble writes from tangent_soa equal the
    plain assemble's forward-mode planes (float64)."""
    mat = problems[1].material
    u, a, dN, N, wq = _t(fields, torch.float64)
    _, C = tsw.assemble_dense_plain(u, a, None, dN, N, wq, mat, DT, RHO)
    T = mat.tangent_soa(tsw.soa.add_diag(tsw.dense_grad(u, dN), 1.0)).reshape(9, 9, 64, -1)
    tri, _ = tsw.tri_index_map(9)
    closed = torch.stack([T[a, b] for (a, b) in sorted(tri, key=tri.get)])
    assert _rel(closed.numpy(), C.numpy()) < 1e-10


# ---- (f)-(h) the step -------------------------------------------------------


def _ref_np(carry):
    return {k: np.asarray(carry[k]) for k in ("u", "v", "a")}


def _max_rel_err(ref, got):
    return max(
        float(np.abs(got[k] - ref[k]).max()) / max(1.0, float(np.abs(ref[k]).max()))
        for k in ("u", "v", "a")
    )


@pytest.fixture(scope="module")
def ref_steps(problems):
    """The reference's soa engine from its initial carry: the carries
    after 0..3 steps (float64, FDM-preconditioned GMRES)."""
    ref, _ = problems
    rc = jsh.initial_carry(ref)
    step = jsh.make_step(
        ref, solver="cg", residual_impl="soa", precond="fdm", lin_rel_tol=1e-6, **STEP
    )
    out = [rc]
    for _ in range(3):
        out.append(step(out[-1]))
    return out


def test_initial_carry_matches_reference(problems, ref_steps):
    _, port = problems
    a = mt.initial_carry(port)["a"].numpy()
    a_ref = np.asarray(ref_steps[0]["a"])
    # PCG stopped at a relative 1e-8 in both packages (ROADMAP Queue 3)
    assert np.abs(a - a_ref).max() <= 1e-8 * np.abs(a_ref).max()


def test_three_steps_match_reference(problems, ref_steps):
    _, port = problems
    pc = carry_from_numpy(_ref_np(ref_steps[0]), device="cpu")
    step = mt.make_step(port, lin_rel_tol=1e-6, **STEP)
    for i in range(3):
        pc = step(pc)
        rc = ref_steps[i + 1]
        assert pc["newton"]["converged"] and pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)
    assert float(np.abs(carry_to_numpy(pc)["u"]).max()) > 1e-3  # the beam sags


def test_multipatch_matches_single_patch_twin(problems):
    """The two-patch run against the knot-split single patch (a repeated
    interior knot after elevation: the conn-gather branch), dofs matched by
    reference coordinates, as tests/test_multipatch.py does for the
    reference."""
    _, mp = problems
    sp = mt.build_problem(SP, material=_material(mt), device="cpu", **BUILD)
    assert sp.grid is None and sp.dense is not None and sp.n_dof == mp.n_dof
    kw = dict(STEP, newton_iters=20, cg_iters=300, rel_tol=1e-10, lin_rel_tol=1e-11)
    us = []
    for prob in (mp, sp):
        carry = mt.initial_carry(prob)
        step = mt.make_step(prob, **kw)
        for _ in range(3):
            carry = step(carry)
        us.append(carry["u"].numpy())

    def order(x):
        return np.lexsort(tuple(np.round(x[:, d], 9) for d in range(3)))

    x_mp = MultiPatchFESpace(read_mfem_nurbs_mesh(MP), elevate=1, subdivide=1).x_ref
    patch, topo, _ = build_patch_from_mesh(read_mfem_nurbs_mesh(SP))
    patch.elevate_degrees(1)
    patch.uniform_refine()
    x_sp = FESpace(patch, topo).x_ref
    o_mp, o_sp = order(x_mp), order(x_sp)
    assert np.allclose(x_mp[o_mp], x_sp[o_sp], atol=1e-12)
    assert np.abs(us[0]).max() > 1e-3
    assert np.abs(us[0][o_mp] - us[1][o_sp]).max() <= 1e-9


def test_step_on_converted_problem_matches_port_build(problems):
    """problem_from_numpy(the reference multi-patch Problem) drives the
    same step as the port's own build."""
    ref, port = problems
    conv = problem_from_numpy(ref, device="cpu")
    assert conv.dense is not None and "mp" in conv.fdm
    assert type(conv.material) is mt.CompressibleOgdenNeoHookean
    assert material_from_reference(ref.material).mu == port.material.mu
    carry0 = mt.initial_carry(port)
    carries = [
        carry_to_numpy(mt.make_step(prob, lin_rel_tol=1e-6, **STEP)(carry0))
        for prob in (port, conv)
    ]
    assert _max_rel_err(carries[0], carries[1]) <= 1e-10


def test_unported_dense_options_raise(problems):
    _, port = problems
    # the sum-factorized sweeps on a problem without sf tables: a wrong
    # request, as in the reference (mimi_tpu/parallel/sharding.py:965-970)
    with pytest.raises(ValueError, match="sum-factorization tables"):
        mt.make_step(port, 0.05, matvec_impl="sf")
    carry = mt.initial_carry(port)
    # the bfloat16 block with the bfloat16 table streams is ported: the
    # residual is the float32 block's, J w within one bfloat16 step of it
    ns = [mt.make_step(port, 0.05, matvec_dtype=d).newton_system(carry) for d in ("bf16", "f32")]
    w = torch.tensor(np.random.default_rng(3).standard_normal(ns[0]["r"].shape))
    jw = [n["J_apply"](w) for n in ns]
    assert torch.equal(ns[0]["r"], ns[1]["r"])
    assert 0.0 < float((jw[0] - jw[1]).abs().max()) <= 2.0**-7 * float(jw[1].abs().max())
    # the full block of the neo-Hookean dP/dF is ported on dense tables: its
    # Newton system is the symmetric block's to rounding
    ns = [mt.make_step(port, 0.05, tangent_storage=s).newton_system(carry)
          for s in ("full", "sym")]
    w = torch.tensor(np.random.default_rng(4).standard_normal(ns[0]["r"].shape))
    jw = [n["J_apply"](w) for n in ns]
    assert torch.equal(ns[0]["r"], ns[1]["r"])
    assert float((jw[0] - jw[1]).abs().max()) <= 1e-12 * float(jw[1].abs().max())
    # the neo-Hookean sigma is no function of sym(F) alone: a wrong request,
    # as in the reference
    with pytest.raises(ValueError, match="Cauchy-decomposition"):
        mt.make_step(port, 0.05, tangent_storage="cauchy")
    with pytest.raises(ValueError, match="unknown"):
        mt.make_step(port, 0.05, matvec_impl="csr")


# ---- the card is the default ------------------------------------------------


def _scene():
    scene = mt.NearestDistanceToSplines()
    scene.add_spline(mt.Bezier([1, 1], [[0, 0, 1], [0, 1, 1], [1, 0, 1], [1, 1, 1]]))
    scene.plant_kd_tree(4)
    return scene


@pytest.mark.parametrize(
    "call",
    ["build_problem", "problem_from_numpy", "carry_from_numpy", "scene_data",
     "eval_cps", "init_state"],
)
def test_entry_points_default_to_the_card(problems, call):
    """Without device= the entry points ask for the CUDA device; on this
    host without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    ref, _ = problems
    j2 = mt.J2()
    j2.hardening = mt.JohnsonCookHardening()
    j2.set_young_poisson(2100.0, 0.3)
    j2.setup(3)
    calls = {
        "build_problem": lambda: mt.build_problem(MP, material=_material(mt), **BUILD),
        "problem_from_numpy": lambda: problem_from_numpy(ref),
        "carry_from_numpy": lambda: carry_from_numpy(
            {k: np.zeros((ref.n_dof, 3)) for k in ("u", "v", "a")}
        ),
        "scene_data": lambda: _scene().scene_data(),
        "eval_cps": lambda: _scene().splines[0].eval_cps(),
        "init_state": lambda: j2.init_state((2, 64)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()
