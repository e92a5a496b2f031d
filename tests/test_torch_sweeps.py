"""The port's three sum-factorized sweeps (plain torch versions in
mimi_tpu_torch/ops/sweeps.py) against the reference package's Pallas
kernels in interpret mode (float32, 8 elements, the bars of
tests/test_pallas.py) and against the same math in JAX float64 on dense
tables (1e-10), with and without the viscous flux, and with the tangent
block stored in bfloat16.  Also checks the closed-form J2 tangent that the
CUDA assemble kernel implements against the forward-mode planes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp as torch_jvp

import mimi_tpu as mimi
from mimi_tpu.ops import sweeps as jsw
from mimi_tpu.parallel import sharding as jsh

from mimi_tpu_torch.fem import soa as tsoa
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import material_from_reference
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

MESH = os.path.join(os.path.dirname(__file__), "data", "cube-nurbs.mesh")
DT, RHO, FAC0 = 0.05, 1.0, 0.01
MU_V, FAC1 = 100.0, 0.3  # viscosity (the contact press's) and a fac1
LAY = tsw.cauchy_plane_layout(3)
# plane groups of the Cauchy block: D-hat, sigma, F^-1, J
GROUPS = [(0, 21), (21, 27), (27, 36), (36, 37)]


def _ref_material():
    mat = mimi.J2()
    mat.density = RHO
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(2100.0, 0.3)
    h = mimi.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = 1.0, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    return mat


@pytest.fixture(scope="module")
def case():
    """8 elements (p=2, 4^3 Gauss points); element fields and a material
    state, made with numpy, that put most points on the plastic branch."""
    ref_mat = _ref_material()
    prob = jsh.build_problem(
        MESH, 1, 1, ref_mat, [(1, 0), (1, 1), (1, 2)], {1: -3.0},
        dtype=jnp.float64,
    )
    E = prob.n_el
    rng = np.random.default_rng(11)
    ps = 0.002 * rng.standard_normal((3, 3, 64, E))
    data = {
        "u_el": 0.02 * rng.standard_normal((3, 27, E)),
        "a_el": rng.standard_normal((3, 27, E)),
        "w_el": rng.standard_normal((3, 27, E)),
        "state": {
            "plastic_strain": 0.5 * (ps + ps.transpose(1, 0, 2, 3)),
            "eqps": 0.01 * rng.random((64, E)),
            "temperature": 20.0 + 100.0 * rng.random((64, E)),
        },
        "tabs": [np.asarray(t) for t in prob.sf["tables"]],
        "jinv": np.asarray(prob.sf["jinv"]),
        "wq": np.ascontiguousarray(np.asarray(prob.w_detJ).T),
        "dN_t": np.transpose(prob.dN_dX, (2, 3, 1, 0)).copy(),
        "N_t": np.transpose(prob.N, (2, 1, 0)).copy(),
    }
    data["v_el"] = rng.standard_normal((3, 27, E))  # drawn last: the rest is unchanged
    return prob, ref_mat, material_from_reference(ref_mat), data


def _torch_args(data, dtype):
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return (
        t(data["u_el"]), t(data["a_el"]),
        {k: t(v) for k, v in data["state"].items()},
        [t(x) for x in data["tabs"]], t(data["jinv"]), t(data["wq"]),
    )


def _jax_args(data, dtype):
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return (
        j(data["u_el"]), j(data["a_el"]),
        {k: j(v) for k, v in data["state"].items()},
        [j(x) for x in data["tabs"]], j(data["jinv"]), j(data["wq"]),
    )


def _group_err(C, C_ref):
    """max over plane groups of max|C - C_ref| / max|C_ref in group|."""
    return max(
        float(np.abs(C[a:b] - C_ref[a:b]).max() / np.abs(C_ref[a:b]).max())
        for a, b in GROUPS
    )


def _rel(y, y_ref):
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def test_case_is_mostly_plastic(case):
    prob, ref_mat, mat, data = case
    u_el, _, state, tabs, jinv, _ = _torch_args(data, torch.float64)
    dF = tsw.sf_grad(u_el, tabs, jinv)
    *_, active, _ = mat._return_map(tsoa.add_diag(dF, 1.0), state, DT)
    frac = float(active.double().mean())
    assert 0.25 <= frac < 1.0, frac


@pytest.fixture(scope="module")
def pallas(case):
    """The three Pallas sweeps in interpret mode, float32."""
    prob, ref_mat, mat, data = case
    u_el, a_el, st, tabs, jinv, wq = _jax_args(data, jnp.float32)
    E = prob.n_el
    kw = dict(
        mat=ref_mat, dt=DT, dim=3, nd=27, n_q=64, n_el=E, rho=RHO, mu_v=0.0,
        has_visc=False, state=st, block_e=8, interpret=True, sf_mode=True,
        n_g=4, pp1=3,
    )
    y_res = jsw.make_residual_sweep(**kw)(u_el, a_el, None, st, *tabs, jinv, wq)
    y_asm, C = jsw.make_assemble_sweep(**kw, c_storage="cauchy")(
        u_el, a_el, None, st, *tabs, jinv, wq
    )
    mv = jsw.make_matvec_sweep_sf(
        dim=3, nd=27, n_q=64, n_el=E, rho=RHO, fac0=FAC0, fac1_mu_v=0.0,
        has_visc=False, block_e=8, interpret=True, c_storage="cauchy",
        n_g=4, pp1=3,
    )
    y_mv = mv(jnp.asarray(data["w_el"], jnp.float32), *tabs, jinv, wq, C)
    return {k: np.asarray(v) for k, v in
            dict(res=y_res, asm=y_asm, C=C, mv=y_mv).items()}


def test_residual_matches_pallas(case, pallas):
    *_, mat, data = case
    y = tsw.residual_sf_plain(*_torch_args(data, torch.float32), mat, DT, RHO)
    assert _rel(y.numpy(), pallas["res"]) < 1e-4


def test_assemble_matches_pallas(case, pallas):
    *_, mat, data = case
    y, C = tsw.assemble_sf_plain(*_torch_args(data, torch.float32), mat, DT, RHO)
    assert _rel(y.numpy(), pallas["asm"]) < 1e-4
    assert _group_err(C.numpy(), pallas["C"]) < 1e-3


def test_matvec_matches_pallas(case, pallas):
    *_, mat, data = case
    _, _, _, tabs, jinv, wq = _torch_args(data, torch.float32)
    y = tsw.matvec_sf_plain(
        torch.tensor(data["w_el"], dtype=torch.float32), tabs, jinv, wq,
        torch.tensor(pallas["C"]), RHO, FAC0,
    )
    assert _rel(y.numpy(), pallas["mv"]) < 1e-3


@pytest.fixture(scope="module")
def jax_f64(case):
    """The same math in JAX float64 on the dense tables: residual, the
    Cauchy-block planes from 6 symmetric jvp seeds, and the matvec as the
    jvp of P at frozen state."""
    prob, ref_mat, mat, data = case
    u_el, a_el, st, _, _, wq = _jax_args(data, jnp.float64)
    dN_t, N_t = jnp.asarray(data["dN_t"]), jnp.asarray(data["N_t"])
    eye = jnp.eye(3)[:, :, None, None]
    F = jnp.einsum("ndqe,cne->cdqe", dN_t, u_el) + eye

    def integrate(P, vec):
        return jnp.einsum("qe,ndqe,cdqe->cne", wq, dN_t, P) + jnp.einsum(
            "qe,nqe,cqe->cne", wq, N_t, vec
        )

    P, jvp_fn = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, st, DT), F)
    aq = jnp.einsum("nqe,cne->cqe", N_t, a_el)
    y_res = integrate(P, RHO * aq)
    w = jnp.asarray(data["w_el"])
    dP = FAC0 * jvp_fn(jnp.einsum("ndqe,cne->cdqe", dN_t, w))
    y_mv = integrate(dP, RHO * jnp.einsum("nqe,cne->cqe", N_t, w))
    sig, sig_jvp = jax.linearize(lambda Ft: ref_mat.cauchy_soa(Ft, st, DT), F)
    planes = [None] * LAY["n_plane"]
    for m, (i, j) in enumerate(LAY["sym"]):
        seed = jnp.zeros_like(F).at[i, j].set(1.0).at[j, i].set(1.0)
        col = sig_jvp(seed) * (1.0 if i == j else 0.5)
        for a, (ii, jj) in enumerate(LAY["sym"]):
            k = LAY["tri"][(min(a, m), max(a, m))]
            if a == m:
                planes[k] = col[ii, jj]
            elif a > m:
                planes[k] = 0.5 * col[ii, jj]
            else:
                planes[k] = planes[k] + 0.5 * col[ii, jj]
    return {
        "res": np.asarray(y_res),
        "mv": np.asarray(y_mv),
        "M": np.asarray(jnp.stack(planes[:21])),
        "sig": np.asarray(sig),
    }


def test_residual_matches_jax_f64(case, jax_f64):
    *_, mat, data = case
    y = tsw.residual_sf_plain(*_torch_args(data, torch.float64), mat, DT, RHO)
    assert _rel(y.numpy(), jax_f64["res"]) < 1e-10


def test_assemble_matches_jax_f64(case, jax_f64):
    *_, mat, data = case
    y, C = tsw.assemble_sf_plain(*_torch_args(data, torch.float64), mat, DT, RHO)
    C = C.numpy()
    assert _rel(y.numpy(), jax_f64["res"]) < 1e-10
    assert _rel(C[:21], jax_f64["M"]) < 1e-10
    sig = np.stack([jax_f64["sig"][i, j] for i, j in LAY["sym"]])
    assert _rel(C[21:27], sig) < 1e-10


def test_matvec_matches_jax_f64(case, jax_f64):
    *_, mat, data = case
    args = _torch_args(data, torch.float64)
    _, C = tsw.assemble_sf_plain(*args, mat, DT, RHO)
    y = tsw.matvec_sf_plain(
        torch.tensor(data["w_el"]), args[3], args[4], args[5], C, RHO, FAC0
    )
    assert _rel(y.numpy(), jax_f64["mv"]) < 1e-10


def test_closed_form_tangent_matches_jvp_planes(case):
    """The CUDA assemble kernel writes D-hat from the closed-form
    algorithmic tangent K 1(x)1 + 2G(1 - 3G d/q) I_dev
    + 6G^2 (d/q - 1/(3G + h')) n(x)n; here that formula, in float64, is held
    against the plain version's forward-mode planes."""
    *_, mat, data = case
    u_el, a_el, state, tabs, jinv, wq = _torch_args(data, torch.float64)
    _, C = tsw.assemble_sf_plain(u_el, a_el, state, tabs, jinv, wq, mat, DT, RHO)
    dF = tsw.sf_grad(u_el, tabs, jinv)
    F = tsoa.add_diag(dF, 1.0)
    p, s, q, delta, active, _ = mat._return_map(F, state, DT)
    G, K = mat.G, mat.K
    thermo = mat.hardening.thermo_contribution(state["temperature"])
    _, fprime = mat._residual_grad(delta, q, state["eqps"], thermo, DT, 3 * G)
    h = -fprime - 3 * G
    c1 = torch.where(active, 2 * G * (1 - 3 * G * delta / q), 2 * G)
    c2 = torch.where(active, 6 * G * G * (delta / q - 1 / (3 * G + h)), 0.0)
    n = s / tsoa.fro_norm(s)
    sym = LAY["sym"]
    for a, (i, j) in enumerate(sym):
        for b in range(a, 6):
            k, l = sym[b]
            dij, dkl = float(i == j), float(k == l)
            isym = 0.5 * (float(i == k and j == l) + float(i == l and j == k))
            M = K * dij * dkl + c1 * (isym - dij * dkl / 3) + c2 * n[i, j] * n[k, l]
            got = C[LAY["tri"][(a, b)]]
            assert float((M - got).abs().max()) <= 1e-9 * float(C[:21].abs().max())


def test_tangent_is_forward_derivative_of_pk1(case):
    """tangent_apply_cauchy on the stored block reproduces the forward
    derivative of pk1_soa (the Cauchy decomposition is exact for J2)."""
    *_, mat, data = case
    u_el, a_el, state, tabs, jinv, wq = _torch_args(data, torch.float64)
    _, C = tsw.assemble_sf_plain(u_el, a_el, state, tabs, jinv, wq, mat, DT, RHO)
    dF = tsw.sf_grad(u_el, tabs, jinv)
    F = tsoa.add_diag(dF, 1.0)
    dW = tsw.sf_grad(torch.tensor(data["w_el"]), tabs, jinv)
    _, dP_ref = torch_jvp(lambda Ft: mat.pk1_soa(Ft, state, DT), (F,), (dW,))
    dP = tsw.tangent_apply_cauchy(C, dW, 1.0)
    assert _rel(dP.numpy(), dP_ref.numpy()) < 1e-10


@pytest.fixture(scope="module")
def pallas_visc(case):
    """The viscous Pallas sweeps in interpret mode, float32: residual,
    assemble with a bfloat16 tangent block, and the matvec on that
    block."""
    prob, ref_mat, mat, data = case
    u_el, a_el, st, tabs, jinv, wq = _jax_args(data, jnp.float32)
    v_el = jnp.asarray(data["v_el"], jnp.float32)
    E = prob.n_el
    kw = dict(
        mat=ref_mat, dt=DT, dim=3, nd=27, n_q=64, n_el=E, rho=RHO, mu_v=MU_V,
        has_visc=True, state=st, block_e=8, interpret=True, sf_mode=True,
        n_g=4, pp1=3,
    )
    y_res = jsw.make_residual_sweep(**kw)(u_el, a_el, v_el, st, *tabs, jinv, wq)
    y_asm, C = jsw.make_assemble_sweep(**kw, c_storage="cauchy", c_dtype=jnp.bfloat16)(
        u_el, a_el, v_el, st, *tabs, jinv, wq
    )
    mv = jsw.make_matvec_sweep_sf(
        dim=3, nd=27, n_q=64, n_el=E, rho=RHO, fac0=FAC0, fac1_mu_v=FAC1 * MU_V,
        has_visc=True, block_e=8, interpret=True, c_storage="cauchy",
        n_g=4, pp1=3,
    )
    y_mv = mv(jnp.asarray(data["w_el"], jnp.float32), *tabs, jinv, wq, C)
    assert C.dtype == jnp.bfloat16
    return {
        "res": np.asarray(y_res), "asm": np.asarray(y_asm), "mv": np.asarray(y_mv),
        # bfloat16 -> float32 is exact, and so is the way back
        "C": np.asarray(C).astype(np.float32),
    }


def _visc_args(data):
    return dict(v_el=torch.tensor(data["v_el"], dtype=torch.float32), mu_v=MU_V)


def test_visc_residual_matches_pallas(case, pallas_visc):
    *_, mat, data = case
    args = _torch_args(data, torch.float32)
    y = tsw.residual_sf_plain(*args, mat, DT, RHO, **_visc_args(data))
    assert _rel(y.numpy(), pallas_visc["res"]) < 1e-4
    # the viscous flux is a real part of the residual here
    y0 = tsw.residual_sf_plain(*args, mat, DT, RHO)
    assert _rel(y0.numpy(), pallas_visc["res"]) > 1e-2


def test_visc_bf16_assemble_matches_pallas(case, pallas_visc):
    """Residual at the f32 bar; the bfloat16 planes within one bfloat16
    rounding step (2^-7 of each plane group's max).  The Pallas kernel
    rounds an off-diagonal D-hat plane as two rounded halves, the port
    rounds the float32 plane once, so a few entries differ by one step."""
    *_, mat, data = case
    y, C = tsw.assemble_sf_plain(
        *_torch_args(data, torch.float32), mat, DT, RHO, **_visc_args(data),
        c_dtype=torch.bfloat16,
    )
    assert C.dtype == torch.bfloat16
    assert _rel(y.numpy(), pallas_visc["asm"]) < 1e-4
    assert _group_err(C.float().numpy(), pallas_visc["C"]) <= 2.0**-7
    # the stored block is the float32 block rounded to nearest even
    _, C32 = tsw.assemble_sf_plain(
        *_torch_args(data, torch.float32), mat, DT, RHO, **_visc_args(data)
    )
    assert torch.equal(C, C32.to(torch.bfloat16))


def test_visc_bf16_matvec_matches_pallas(case, pallas_visc):
    """Both matvecs read the same bfloat16 block and widen it on load."""
    *_, mat, data = case
    _, _, _, tabs, jinv, wq = _torch_args(data, torch.float32)
    Cb = torch.tensor(pallas_visc["C"]).to(torch.bfloat16)
    w = torch.tensor(data["w_el"], dtype=torch.float32)
    y = tsw.matvec_sf_plain(w, tabs, jinv, wq, Cb, RHO, FAC0, FAC1 * MU_V)
    assert _rel(y.numpy(), pallas_visc["mv"]) < 1e-3
    y0 = tsw.matvec_sf_plain(w, tabs, jinv, wq, Cb, RHO, FAC0)
    assert _rel(y0.numpy(), pallas_visc["mv"]) > 1e-2


def test_visc_sweeps_match_jax_f64(case, jax_f64):
    """The viscous flux in float64: residual + mu_v grad(v) integrated
    against dN, matvec + fac1 mu_v grad(w), on the dense tables."""
    *_, mat, data = case
    args = _torch_args(data, torch.float64)
    dN_t, wq = data["dN_t"], data["wq"]
    flux = lambda x: np.einsum(  # noqa: E731
        "qe,ndqe,cdqe->cne", wq, dN_t, np.einsum("ndqe,cne->cdqe", dN_t, x)
    )
    v = torch.tensor(data["v_el"])
    y = tsw.residual_sf_plain(*args, mat, DT, RHO, v_el=v, mu_v=MU_V)
    assert _rel(y.numpy(), jax_f64["res"] + MU_V * flux(data["v_el"])) < 1e-10
    ya, C = tsw.assemble_sf_plain(*args, mat, DT, RHO, v_el=v, mu_v=MU_V)
    assert torch.equal(ya, y)
    mv = tsw.matvec_sf_plain(
        torch.tensor(data["w_el"]), args[3], args[4], args[5], C, RHO, FAC0, FAC1 * MU_V
    )
    assert _rel(mv.numpy(), jax_f64["mv"] + FAC1 * MU_V * flux(data["w_el"])) < 1e-10
