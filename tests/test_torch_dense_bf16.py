"""The bfloat16 dense tangent block, its bfloat16 table streams and
matvec_impl="dense" on a sum-factorized problem (mimi_tpu_torch) against
the reference package.

  - the plain dense matvec on a bfloat16 block and bfloat16 copies of dN
    and N (2D p = 2 and 3D p = 2, the sym, cauchy and full storages,
    viscous and not) against `make_matvec_sweep` in interpret mode fed the
    same values, at 1e-6 of scale: both widen bfloat16 exactly and compute
    in float32;
  - the plain dense assemble's bfloat16 planes (neo-Hookean sym, J2
    cauchy, J2Simo full) against `make_assemble_sweep(c_dtype=bfloat16)` in
    interpret mode, every entry within one bfloat16 step of its plane
    group's max;
  - the reference's bfloat16 step check (tests/test_pallas.py:342-393) on
    the port's plain engine in float32, with its two bars;
  - the plain matvec_impl="dense" step on the sum-factorized cube (float64,
    4^3, 2 steps) against the reference's `soa` step at 1e-8 and against
    the port's own sf step;
  - the dense tables of an sf problem order elements, dofs and points as
    its sf tables do, and their w det J agrees.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.ops import sweeps as jsw
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.materials import kernel_solver_mode
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.parallel import sharding as tsh
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy, material_from_reference
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
CUBE = os.path.join(DATA, "cube-nurbs.mesh")
BALKEN = os.path.join(DATA, "balken.mesh")
# (mesh, elevate, subdivide, clamp) of the 3D p = 2 cube (8 elements) and the
# 2D p = 2 cantilever
MESHES = {3: (CUBE, 1, 1, [(1, 0), (1, 1), (1, 2)]), 2: (BALKEN, 1, 1, [(2, 0), (2, 1)])}
DT, RHO, FAC0, FAC1_MU_V = 0.05, 1.0, 0.01, 3.0


def _hyper(pkg):
    mat = pkg.CompressibleOgdenNeoHookean()
    mat.density, mat.viscosity = RHO, -1.0
    mat.set_young_poisson(2100.0, 0.3)
    return mat


def _j2(pkg, name="J2", A=1.0):
    """The main path's J2-family material (Johnson-Cook), yield stress A."""
    mat = getattr(pkg, name)()
    mat.density, mat.viscosity = RHO, -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(2100.0, 0.3)
    h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = A, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _bf16(a):
    """numpy float -> the torch bfloat16 tensor rounded to nearest even."""
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jax_bf16(t):
    """A bfloat16 torch tensor -> the same values as a JAX bfloat16 array
    (the widening and the rounding back are exact)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d_p2", "3d_p2"])
def tables(request):
    """The reference problem's dense tables in the batch-last layout
    (float64), with random element fields made from a seed."""
    dim = request.param
    mesh, elev, subd, clamp = MESHES[dim]
    ref = jsh.build_problem(mesh, elev, subd, _hyper(mimi), clamp, {1: -3.0},
                            dtype=jnp.float64)
    dN = np.transpose(ref.dN_dX, (2, 3, 1, 0)).copy()
    nd, _, n_q, n_el = dN.shape
    rng = np.random.default_rng(20 + dim)
    return {
        "ref": ref, "dim": dim, "nd": nd, "n_q": n_q, "n_el": n_el, "dN_t": dN,
        "N_t": np.transpose(ref.N, (2, 1, 0)).copy(),
        "wq": np.ascontiguousarray(np.asarray(ref.w_detJ).T),
        "w_el": rng.standard_normal((dim, nd, n_el)),
        "rng": rng,
    }


def _ref_matvec(t, storage, visc, C):
    mv = jsw.make_matvec_sweep(
        dim=t["dim"], nd=t["nd"], n_q=t["n_q"], n_el=t["n_el"], rho=RHO, fac0=FAC0,
        fac1_mu_v=FAC1_MU_V if visc else 0.0, has_visc=visc, block_e=t["n_el"],
        interpret=True, c_storage=storage,
    )
    if storage == "full":
        d2 = t["dim"] ** 2
        C = C.reshape(d2, d2, t["n_q"], t["n_el"])
    return np.asarray(mv(jnp.asarray(t["w_el"], jnp.float32), _jax_bf16(_bf16(t["dN_t"])),
                         _jax_bf16(_bf16(t["N_t"])), jnp.asarray(t["wq"], jnp.float32), C))


@pytest.mark.parametrize("visc", [False, True], ids=["inviscid", "visc"])
@pytest.mark.parametrize("storage", ["sym", "cauchy", "full"])
def test_bf16_dense_matvec_matches_pallas(tables, storage, visc):
    """The plain matvec on a bfloat16 block and the bfloat16 copies of dN
    and N against the reference's dense Pallas matvec in interpret mode on
    the same bfloat16 tables and the same block values, at 1e-6 of scale:
    both widen each bfloat16 operand exactly and compute in float32, in
    another summation order.  The reference multiplies two bfloat16 planes
    of the Cauchy block (sigma F^-T, J P) in bfloat16 arithmetic, so for
    that storage it is fed the block's values widened to float32; fed the
    bfloat16 block itself it stays within one bfloat16 step (2^-7) of
    scale."""
    t = tables
    Cb = _bf16(t["rng"].standard_normal((tsw.n_planes(storage, t["dim"]), t["n_q"], t["n_el"])))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    y = tsw.matvec_dense_plain(f32(t["w_el"]), _bf16(t["dN_t"]), _bf16(t["N_t"]), f32(t["wq"]),
                               Cb, RHO, FAC0, FAC1_MU_V if visc else None, storage)
    assert y.dtype == torch.float32
    fed = _jax_bf16(Cb)
    if storage == "cauchy":
        assert _rel(y.numpy(), _ref_matvec(t, storage, visc, fed)) <= 2.0**-7
        fed = fed.astype(jnp.float32)
    assert _rel(y.numpy(), _ref_matvec(t, storage, visc, fed)) <= 1e-6
    # the widened tables are what the float32 matvec reads
    y32 = tsw.matvec_dense_plain(f32(t["w_el"]), _bf16(t["dN_t"]).float(),
                                 _bf16(t["N_t"]).float(), f32(t["wq"]), Cb.float(), RHO, FAC0,
                                 FAC1_MU_V if visc else None, storage)
    assert torch.equal(y, y32)


def _plastic_state(state0, n_q, n_el, rng):
    """A random J2-family history (numpy) in the layout of the reference
    problem's initial state `state0` (SoA)."""
    st = {k: np.array(v) for k, v in state0.items()}
    if "plastic_strain" in st:
        ps = 0.002 * rng.standard_normal(st["plastic_strain"].shape)
        st["plastic_strain"] = 0.5 * (ps + np.swapaxes(ps, 0, 1))
    st["eqps"] = 0.01 * rng.random((n_q, n_el))
    if "temperature" in st:
        st["temperature"] = 20.0 + 100.0 * rng.random((n_q, n_el))
    return st


ASSEMBLE_CASES = [("CompressibleOgdenNeoHookean", "sym", 3), ("J2", "cauchy", 3),
                  ("J2Simo", "full", 2)]


@pytest.mark.parametrize("name, storage, dim", ASSEMBLE_CASES,
                         ids=[f"{n}_{s}_{d}d" for n, s, d in ASSEMBLE_CASES])
def test_bf16_dense_assemble_matches_pallas(name, storage, dim):
    """The plain dense assemble's bfloat16 block against the reference's
    dense Pallas assemble with c_dtype=bfloat16 in interpret mode on the
    same float32 inputs (a random plastic history for the J2 family, the
    kernels' 40-trip return on both sides): the residual at 1e-4 of scale,
    every plane entry within one bfloat16 step (2^-7) of its plane group's
    max (the two packages' float32 planes differ by their own rounding
    before either rounds them; the reference rounds an off-diagonal sym or
    D-hat plane as two rounded halves, the port the float32 plane once)."""
    mesh, elev, subd, clamp = MESHES[dim]
    ref_mat = _hyper(mimi) if name.startswith("Compressible") else _j2(mimi, name)
    ref = jsh.build_problem(mesh, elev, subd, ref_mat, clamp, {1: -3.0}, dtype=jnp.float64)
    dN = np.transpose(ref.dN_dX, (2, 3, 1, 0)).copy()
    nd, _, n_q, n_el = dN.shape
    N, wq = np.transpose(ref.N, (2, 1, 0)).copy(), np.ascontiguousarray(np.asarray(ref.w_detJ).T)
    rng = np.random.default_rng(31)
    u_el = 0.02 * rng.standard_normal((dim, nd, n_el))
    a_el = rng.standard_normal((dim, nd, n_el))
    st = _plastic_state(ref.state0, n_q, n_el, rng) if ref_mat.has_state else None
    j32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    jst = None if st is None else {k: j32(v) for k, v in st.items()}
    kw = dict(mat=ref_mat, dt=DT, dim=dim, nd=nd, n_q=n_q, n_el=n_el, rho=RHO, mu_v=0.0,
              has_visc=False, state=jst, block_e=n_el, interpret=True)
    y_ref, C_ref = jsw.make_assemble_sweep(**kw, c_storage=storage, c_dtype=jnp.bfloat16)(
        j32(u_el), j32(a_el), None, jst, j32(dN), j32(N), j32(wq))
    assert C_ref.dtype == jnp.bfloat16
    C_ref = np.asarray(C_ref.astype(jnp.float32)).reshape(-1, n_q, n_el)
    mat = material_from_reference(ref_mat)
    mat.setup(dim)
    tst = None if st is None else {k: t32(v) for k, v in st.items()}
    with kernel_solver_mode():
        y, C = tsw.assemble_dense_plain(t32(u_el), t32(a_el), tst, t32(dN), t32(N), t32(wq), mat,
                                        DT, RHO, c_dtype=torch.bfloat16, storage=storage)
    assert C.dtype == torch.bfloat16 and C.shape == C_ref.shape
    assert _rel(y.numpy(), np.asarray(y_ref)) <= 1e-4
    if storage == "cauchy":
        lay = tsw.cauchy_plane_layout(dim)
        groups = [(0, lay["n_tri"]), (lay["off_sig"], lay["off_fi"]),
                  (lay["off_fi"], lay["off_j"]), (lay["off_j"], lay["n_plane"])]
    else:
        groups = [(0, C.shape[0])]
    Cf = C.float().numpy()
    for a, b in groups:
        err = np.abs(Cf[a:b] - C_ref[a:b]).max() / np.abs(C_ref[a:b]).max()
        assert err <= 2.0**-7, (a, b, err)
    # the stored block is the float32 block rounded to nearest even
    with kernel_solver_mode():
        _, C32 = tsw.assemble_dense_plain(t32(u_el), t32(a_el), tst, t32(dN), t32(N), t32(wq),
                                          mat, DT, RHO, storage=storage)
    assert torch.equal(C, C32.to(torch.bfloat16))


def test_reference_bf16_step_check_on_the_plain_engine():
    """tests/test_pallas.py:342-393 on the port's plain engine in float32:
    the neo-Hookean cube (p = 2, 8 elements), one Newton iteration of 8
    GMRES iterations at lin_rel_tol 1e-2 from the initial carry; the
    bfloat16 block's step within 2e-2 of max|u| of the float32 one (sf, and
    on the dense tables with their bfloat16 copies too), the dense float32
    step within 1e-5 of max|u| of the sf one."""
    mesh, elev, subd, clamp = MESHES[3]
    prob = mt.build_problem(mesh, elev, subd, _hyper(mt), clamp, {1: -3.0}, rho_inf=0.5,
                            dtype=torch.float32, device="cpu")
    assert prob.sf is not None and prob.grid is not None
    kw = dict(newton_iters=1, solver="cg", cg_iters=8, lin_rel_tol=1e-2)
    carry = mt.initial_carry(prob, dt=0.05)
    u = {}
    for impl in ("sf", "dense"):
        for mv in ("f32", "bf16"):
            out = mt.make_step(prob, 0.05, matvec_impl=impl, matvec_dtype=mv, **kw)(carry)
            assert torch.isfinite(out["u"]).all()
            u[impl, mv] = out["u"]
    scale = float(u["sf", "f32"].abs().max())
    err = lambda a, b: float((u[a] - u[b]).abs().max())  # noqa: E731
    assert 0.0 < err(("sf", "bf16"), ("sf", "f32")) < 2e-2 * scale
    assert 0.0 < err(("dense", "bf16"), ("dense", "f32")) < 2e-2 * scale
    assert err(("dense", "f32"), ("sf", "f32")) < 1e-5 * scale


STEP_BUILD = dict(elevate=1, subdivide=0, dirichlet=[(1, 0), (1, 1), (1, 2)],
                  body_force={1: -3.0}, rho_inf=0.5, refine_spans=4)
STEP = dict(dt=0.05, newton_iters=4, cg_iters=40, lin_rel_tol=1e-6)


@pytest.fixture(scope="module")
def cubes():
    """The main path's cube at 4^3 (tests/test_torch_step.py's: J2 with
    the yield stress lowered to 1 so that the first step plasticizes), in
    both packages, float64."""
    ref = jsh.build_problem(CUBE, material=_j2(mimi), dtype=jnp.float64, **STEP_BUILD)
    port = mt.build_problem(CUBE, material=_j2(mt), dtype=torch.float64, device="cpu",
                            **STEP_BUILD)
    return ref, port


def _carry_np(c):
    return {"u": np.asarray(c["u"]), "v": np.asarray(c["v"]), "a": np.asarray(c["a"]),
            "state": {k: np.asarray(v) for k, v in c["state"].items()}}


def _max_rel_err(ref, got):
    """max over u, v, a and the state of max|got - ref| / max(1, max|ref|)."""
    f = lambda c: {"u": c["u"], "v": c["v"], "a": c["a"], **c["state"]}  # noqa: E731
    ref, got = f(ref), f(got)
    return max(float(np.abs(got[k] - ref[k]).max()) / max(1.0, float(np.abs(ref[k]).max()))
               for k in ref)


def test_dense_matvec_impl_steps_on_the_sf_cube(cubes):
    """matvec_impl="dense" on the sum-factorized cube: all three sweeps run
    on the patch's dense tables (built at the first request and kept on
    the problem), the structured gather and scatter stay.  Two plastic
    steps from the reference's initial carry agree with the reference's
    `soa` engine (dense tables) at 1e-8 and with the port's own sf step at
    1e-10, with the reference's Newton counts."""
    ref, port = cubes
    assert port.sf is not None and port.grid is not None and port.dense is None
    rc = jsh.initial_carry(ref)
    pc = {impl: carry_from_numpy(_carry_np(rc), device="cpu") for impl in ("dense", "sf")}
    rstep = jsh.make_step(ref, solver="cg", residual_impl="soa", precond="fdm", **STEP)
    psteps = {impl: mt.make_step(port, matvec_impl=impl, **STEP) for impl in pc}
    assert port.dense is not None and port.dense["dN_t"].shape == (27, 3, 64, 64)
    for i in range(2):
        rc = rstep(rc)
        for impl in pc:
            pc[impl] = psteps[impl](pc[impl])
            assert pc[impl]["newton"]["converged"] and pc[impl]["newton"]["finite"]
            assert pc[impl]["newton"]["iters"] == int(rc["newton"]["iters"])
        if i == 0:
            assert float(np.asarray(rc["state"]["eqps"]).max()) > 0.0
        dense = carry_to_numpy(pc["dense"])
        assert _max_rel_err(_carry_np(rc), dense) <= 1e-8, i
        assert _max_rel_err(carry_to_numpy(pc["sf"]), dense) <= 1e-10, i


def test_dense_tables_of_an_sf_problem_match_its_sf_tables(cubes):
    """The dense tables built for an sf problem order elements, local dofs
    and points as the sf tables do (one connectivity, q axis-0 fastest,
    n = a0 + 3 a1 + 9 a2): the connectivity arrays are equal, w det J
    agrees at 1e-12 in float64, and dN, N agree with the reference's own
    dense tables of the same patch at 1e-12."""
    ref, port = cubes
    fes, order = port.dense_src
    conn, n_q, wdet_t, _, dense = tsh._dense_tables(fes, order, torch.float64, port.device)
    assert np.array_equal(conn, port.conn) and np.array_equal(conn, np.asarray(ref.conn))
    assert n_q == port.n_q == 64
    assert _rel(wdet_t.numpy(), port.wdet_t.numpy()) <= 1e-12
    assert _rel(dense["dN_t"].numpy(), np.transpose(ref.dN_dX, (2, 3, 1, 0))) <= 1e-12
    assert _rel(dense["N_t"].numpy(), np.transpose(ref.N, (2, 1, 0))) <= 1e-12
    d = tsh.dense_tables(port)
    assert torch.equal(d["wdet_t"], wdet_t) and torch.equal(d["dN_t"], dense["dN_t"])
    # the sf problem's own tables are untouched: its default step stays sf
    assert tsh._tables(port)[0] == "sf" and tsh._tables(port, "dense")[0] == "dense"
