#!/usr/bin/env python3
"""Smoke run of mimi_tpu_torch on one CUDA GPU.

Builds the CUDA sweep kernels from the sources in this checkout (one nvcc
per source, started together, into one library), holds each against its plain torch
version, checks one implicit step of the kernel path against the plain
path, then drives three paths, float32.  Two at 48^3 elements
(cube-nurbs.mesh at p=2, 375,000 unknowns):
  - the J2 Johnson-Cook body-force problem, generalized-alpha steps with
    4 line-search Newton iterations and FDM-preconditioned GMRES(40) at
    lin_rel_tol 1e-3 (phases 3-8);
  - the contact press: the top face pressed by a rigid bilinear Bezier
    tool moved down 0.01 per step (mortar penalty contact, kappa 5e7),
    J2 Johnson-Cook with viscosity 100, 12 Newton iterations at rel_tol
    1e-3, GMRES(30, at most 80) at lin_rel_tol 1e-2, the consistent
    contact tangent and a bfloat16 tangent block, which runs the viscous
    and bfloat16 variants of the kernels (phases 9-12).
And the dense-table path (phases 13-16): the neo-Hookean two-patch
cantilever of tests/test_multipatch.py (two-patch-cube.mesh, the second
patch rotated) at p=2 and 2 x 38^3 = 109,744 elements, 379,200 unknowns,
E 2100, nu 0.3, the x=0 face clamped, body force -5, the body-force
path's step settings, through the three dense kernels with the 45-plane
symmetric tangent and the multi-patch additive-Schwarz FDM.

    python3 chip_smoke.py

Exits non-zero without a CUDA device, outside a checkout, or when any
phase fails.  The last line of standard output is the device record
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MESH = os.path.join(ROOT, "tests", "data", "cube-nurbs.mesh")
SPANS = 48  # main path: 48^3 elements
CHECK_SPANS = 16  # kernel-vs-plain and one-step parity
TIMED_STEPS = 5
NEWTON_ITERS = 4
RES_EVALS_PER_STEP = NEWTON_ITERS * 3 + 1  # assemble + 2 line-search residuals, + accumulate
STEP_KW = dict(dt=0.05, newton_iters=NEWTON_ITERS, solver="cg", cg_iters=40,
               precond="fdm", lin_rel_tol=1e-3)
KERNELS = [  # (counter name, TPU kernel it replaces)
    ("matvec_sf", "mimi_tpu/ops/sweeps.py:922"),
    ("assemble_sf", "mimi_tpu/ops/sweeps.py:472"),
    ("residual_sf", "mimi_tpu/ops/sweeps.py:338"),
]
# the contact press (bench.py:361-504 of the reference package)
CONTACT_STEP_KW = dict(dt=0.01, newton_iters=12, solver="cg", cg_iters=80,
                       precond="fdm", lin_rel_tol=1e-2, rel_tol=1e-3,
                       contact_tangent="consistent", matvec_dtype="bf16")
CONTACT_TIMED_STEPS = 5
PUSH = [0.0, 0.0, -0.01]  # tool motion per step
VARIANTS = [  # (counter name, TPU kernel it replaces); the contact path's
    ("residual_sf[visc]", "mimi_tpu/ops/sweeps.py:338"),
    ("assemble_sf[visc,bf16]", "mimi_tpu/ops/sweeps.py:472"),
    ("matvec_sf[visc,bf16]", "mimi_tpu/ops/sweeps.py:922"),
]
SOURCE = [
    "mimi_tpu_torch/ops/csrc/sweeps_sf.cu",
    "mimi_tpu_torch/ops/csrc/sweeps_dense.cu",
]
# the dense-table path: the two-patch neo-Hookean cantilever
TWO_PATCH = os.path.join(ROOT, "tests", "data", "two-patch-cube.mesh")
DENSE_SPANS = 38  # per patch and axis: 2 x 38^3 = 109,744 elements
DENSE_CHECK_SPANS = 8  # 2 x 8^3 = 1,024 elements
DENSE_KERNELS = [  # (counter name, TPU kernel it replaces)
    ("residual_dense", "mimi_tpu/ops/sweeps.py:338"),
    ("assemble_dense[sym]", "mimi_tpu/ops/sweeps.py:472"),
    ("matvec_dense[sym]", "mimi_tpu/ops/sweeps.py:838"),
]
# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and float32
# outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# arithmetic per quadrature point of each kernel's loop body, counted from
# its source (a transcendental as one operation): interpolation, the
# material, the tangent and the scatter.  The radial return's iterations
# are not counted: how many a point needs was not measured (the kernels
# run a fixed cap of 100), so the bound leaves them out and stays a
# lower bound.
OPS_PER_POINT = {
    "residual_sf": 1950, "assemble_sf": 2120, "matvec_sf": 1950,
    "residual_sf[visc]": 2600, "assemble_sf[visc,bf16]": 2770,
    "matvec_sf[visc,bf16]": 1970,
    "residual_dense": 1570, "assemble_dense[sym]": 2080, "matvec_dense[sym]": 1630,
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def jc_material(mt, A=70.0):
    mat = mt.J2()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(2100.0, 0.3)
    h = mt.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = A, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    return mat


def build(mt, spans, device):
    return mt.build_problem(
        MESH, 1, 0, jc_material(mt), [(1, 0), (1, 1), (1, 2)], {1: -3.0},
        rho_inf=0.5, device=device, refine_spans=spans,
    )


def build_contact(mt, spans, device):
    """The contact press: clamped bottom face, top face (bid 1) against a
    rigid bilinear Bezier tool at z = 1.02 (kappa 5e7), J2 Johnson-Cook
    (A 700, B 1400), E 1e6, nu 0.3, density 1e3, viscosity 100."""
    mat = jc_material(mt, A=700.0)
    mat.hardening.B = 1400.0
    mat.density = 1e3
    mat.viscosity = 100.0
    mat.set_young_poisson(1e6, 0.3)
    scene = mt.NearestDistanceToSplines()
    scene.add_spline(mt.Bezier([1, 1], [[-0.5, -0.5, 1.02], [-0.5, 1.5, 1.02],
                                        [1.5, -0.5, 1.02], [1.5, 1.5, 1.02]]))
    scene.plant_kd_tree(max(spans, 8), 1)
    scene.coefficient = 5e7
    return mt.build_problem(
        MESH, 1, 0, mat, [(0, 0), (0, 1), (0, 2)], {}, rho_inf=0.5,
        device=device, refine_spans=spans,
        contact=[(1, scene)],
    )


def nbytes(*objs):
    """Bytes of the tensors in objs, nested in lists, tuples and dicts."""
    total = 0
    for o in objs:
        if isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            total += nbytes(*o)
        elif o is not None:
            total += o.numel() * o.element_size()
    return total


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, n_bytes, n_ops):
    """One entry of the kernels line.  The bound is the larger of the
    bytes the call must move (inputs read once, outputs written once) over
    the memory rate and its operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / F32_FLOPS * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # no single PyTorch call computes a fused quadrature sweep
            "library_ms": None}


def plastic_points(soa, sweeps, prob, u_el, state, dt):
    """Quadrature points on the plastic branch of the J2 return map at the
    element displacements u_el."""
    F = soa.add_diag(sweeps.sf_grad(u_el, prob.sf["tables"], prob.sf["jinv"]), 1.0)
    return int(prob.material._return_map(F, state, dt)[4].sum())


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def compare_sweeps(torch, sweeps, prob, u_el, a_el, w_el, state, label):
    """Each kernel against its plain version on the same inputs; returns
    {kernel: max_abs_err} and fails past the stated tolerances."""
    mat = prob.material
    tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
    args = (u_el, a_el, state, tabs, jinv, wq, mat, STEP_KW["dt"], float(mat.density))
    fac0 = prob.facs["fac3"] * STEP_KW["dt"] ** 2
    errs = {}
    y_k = sweeps.residual_sf(*args)
    torch.cuda.synchronize()
    y_p = sweeps.residual_sf_plain(*args)
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    errs["residual_sf"] = err
    say(f"[{label}] residual: max|err| {err:.3e} scale {scale:.3e}")
    # float32 with another summation order (per-point basis products vs
    # staged einsums): a few ulps of the largest element entry
    if not err <= 1e-5 * scale:
        fail(f"residual kernel disagrees with plain ({err} > 1e-5 * {scale})")
    ya_k, C_k = sweeps.assemble_sf(*args)
    torch.cuda.synchronize()
    ya_p, C_p = sweeps.assemble_sf_plain(*args)
    err, scale = float((ya_k - ya_p).abs().max()), float(ya_p.abs().max())
    # tangent block: each plane against the largest entry of its group
    # (D-hat, sigma, F^-1, J); a plane whose entries are all small, such as
    # a shear stress in a nearly uniaxial state, rounds at the scale of the
    # group's largest component, not at its own
    diff = (C_k - C_p).abs().amax(dim=(1, 2))
    mag = C_p.abs().amax(dim=(1, 2))
    rel = torch.cat([diff[a:b] / mag[a:b].max().clamp_min(1e-30)
                     for a, b in ((0, 21), (21, 27), (27, 36), (36, 37))])
    own = diff / mag.clamp_min(1e-30)
    errs["assemble_sf"] = max(err, float(diff.max()))
    say(f"[{label}] assemble: residual max|err| {err:.3e} scale {scale:.3e}; "
        f"tangent worst plane err vs group max {float(rel.max()):.3e} "
        f"(plane {int(rel.argmax())}), vs own max {float(own.max()):.3e} "
        f"(plane {int(own.argmax())})")
    # float32; the kernel's closed-form tangent and the plain version's
    # forward-mode derivatives round differently, and float32 radial returns
    # stop on their iteration cap at slightly different increments
    if not err <= 1e-4 * scale:
        fail(f"assemble kernel residual disagrees ({err} > 1e-4 * {scale})")
    if not float(rel.max()) <= 1e-4:
        fail(f"assemble kernel tangent disagrees (plane err {float(rel.max())})")
    mv_k = sweeps.matvec_sf(w_el, tabs, jinv, wq, C_p, float(mat.density), fac0)
    torch.cuda.synchronize()
    mv_p = sweeps.matvec_sf_plain(w_el, tabs, jinv, wq, C_p, float(mat.density), fac0)
    err, scale = float((mv_k - mv_p).abs().max()), float(mv_p.abs().max())
    errs["matvec_sf"] = err
    say(f"[{label}] matvec: max|err| {err:.3e} scale {scale:.3e}")
    # float32, summation order
    if not err <= 1e-4 * scale:
        fail(f"matvec kernel disagrees with plain ({err} > 1e-4 * {scale})")
    return errs, C_p


def group_rel(diff, ref):
    """max over the plane groups of the Cauchy block (D-hat, sigma, F^-1,
    J) of max|diff| / max|ref| in the group."""
    return max(float(diff[a:b].max() / ref[a:b].abs().max().clamp_min(1e-30))
               for a, b in ((0, 21), (21, 27), (27, 36), (36, 37)))


def compare_variants(torch, sweeps, prob, f, dt, mu_v, label):
    """The contact path's kernel variants against their plain versions on
    the same inputs (`f`: u_el, a_el, v_el, w_el, state): the viscous
    residual, the viscous assemble with a bfloat16 tangent block, and the
    viscous matvec on the plain bfloat16 block.  Returns ({variant:
    max_abs_err}, the plain block); fails past the stated bars."""
    mat = prob.material
    tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
    rho = float(mat.density)
    fac0 = prob.facs["fac3"] * dt * dt
    fac1_mu_v = prob.facs["fac4"] * dt * mu_v
    args = (f["u_el"], f["a_el"], f["state"], tabs, jinv, wq, mat, dt, rho)
    visc = dict(v_el=f["v_el"], mu_v=mu_v)
    errs = {}
    y_k = sweeps.residual_sf(*args, **visc)
    torch.cuda.synchronize()
    y_p = sweeps.residual_sf_plain(*args, **visc)
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    errs["residual_sf[visc]"] = err
    say(f"[{label}] residual[visc]: max|err| {err:.3e} scale {scale:.3e}")
    # float32, summation order (as the inviscid residual)
    if not err <= 1e-5 * scale:
        fail(f"viscous residual kernel disagrees ({err} > 1e-5 * {scale})")
    ya_k, C_k = sweeps.assemble_sf(*args, **visc, c_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ya_p, C_p = sweeps.assemble_sf_plain(*args, **visc, c_dtype=torch.bfloat16)
    err, scale = float((ya_k - ya_p).abs().max()), float(ya_p.abs().max())
    if C_k.dtype != torch.bfloat16:
        fail(f"bfloat16 assemble wrote {C_k.dtype}")
    diff = (C_k.float() - C_p.float()).abs()
    rel = group_rel(diff, C_p.float())
    share = float((C_k != C_p).float().mean())
    errs["assemble_sf[visc,bf16]"] = max(err, float(diff.max()))
    say(f"[{label}] assemble[visc,bf16]: residual max|err| {err:.3e} scale {scale:.3e}; "
        f"bf16 planes worst err vs group max {rel:.3e} (bar 2^-7 = {2.0**-7:.3e}, one "
        f"bf16 rounding step), share of entries that differ {share:.3e}")
    if not err <= 1e-4 * scale:
        fail(f"viscous assemble kernel residual disagrees ({err} > 1e-4 * {scale})")
    # the float32 planes agree to ~1e-5 of their group's max (phase 3), so
    # a rounded pair can differ by at most one bfloat16 step
    if not rel <= 2.0**-7:
        fail(f"bfloat16 tangent planes disagree (err {rel} of group max)")
    mv_k = sweeps.matvec_sf(f["w_el"], tabs, jinv, wq, C_p, rho, fac0, fac1_mu_v)
    torch.cuda.synchronize()
    mv_p = sweeps.matvec_sf_plain(f["w_el"], tabs, jinv, wq, C_p, rho, fac0, fac1_mu_v)
    err, scale = float((mv_k - mv_p).abs().max()), float(mv_p.abs().max())
    errs["matvec_sf[visc,bf16]"] = err
    say(f"[{label}] matvec[visc,bf16] on one bf16 block: max|err| {err:.3e} scale {scale:.3e}")
    if not err <= 1e-4 * scale:
        fail(f"viscous bfloat16 matvec kernel disagrees ({err} > 1e-4 * {scale})")
    return errs, C_p


def contact_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 9-12: the kernel variants at 16^3, one engaged contact step
    cuda vs torch at 16^3, the contact path at 48^3 and its profile.
    Returns the variants' rows of the kernels line."""
    NDS = mt.NearestDistanceToSplines

    # ---- 9. variant kernels vs plain at 16^3 --------------------------------
    prob = build(mt, CHECK_SPANS, device)
    dt_ = prob.dtype
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, dt_)  # noqa: E731
    E, h = prob.n_el, 1.0 / CHECK_SPANS
    f = {"u_el": 0.06 * h * rnd(3, 27, E), "a_el": rnd(3, 27, E), "v_el": rnd(3, 27, E),
         "w_el": rnd(3, 27, E)}
    state = {k: v.clone() for k, v in prob.state0.items()}
    state["eqps"] = 0.01 * torch.rand(64, E, generator=gen).to(device, dt_)
    state["temperature"] = 20.0 + 100.0 * torch.rand(64, E, generator=gen).to(device, dt_)
    f["state"] = state
    dF = sweeps.sf_grad(f["u_el"], prob.sf["tables"], prob.sf["jinv"])
    *_, active, _ = prob.material._return_map(soa.add_diag(dF, 1.0), state, STEP_KW["dt"])
    frac = float(active.float().mean())
    say(f"[9. 16^3 random] plastic fraction {frac:.3f}; v_el of a_el's scale, mu_v 10 "
        "(viscous and elastic-plastic flux of one size)")
    if frac < 0.25:
        fail(f"plastic fraction {frac} < 0.25: the check would not exercise the return map")
    compare_variants(torch, sweeps, prob, f, STEP_KW["dt"], 10.0, "9. 16^3 random")
    del prob, f, state, dF, active

    # ---- 10. one engaged contact step at 16^3: cuda vs torch -----------------
    prob = build_contact(mt, CHECK_SPANS, device)
    carry0 = mt.initial_carry(prob)
    # tool from z = 1.02 to touching (1.00), then the step's own push
    sd = NDS.translate_scene_data(prob.contact[0]["scene"], [0.0, 0.0, -0.02])
    sd = NDS.translate_scene_data(sd, PUSH)
    steps = {impl: mt.make_step(prob, residual_impl=impl, **CONTACT_STEP_KW)
             for impl in ("cuda", "torch")}
    out = {impl: steps[impl](carry0, contact_scenes=[sd]) for impl in steps}
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
    cc, ct = out["cuda"]["contact"][0], out["torch"]["contact"][0]
    say(f"[10. 16^3 contact step] cuda vs torch, both bf16 tangent, tool at z 0.99: "
        f"max|du| {err:.3e} max|u| {scale:.3e} (ratio {err / scale:.2e}); newton "
        f"{nc['iters']}/{nt['iters']} gmres {nc['lin_iters']}/{nt['lin_iters']} converged "
        f"{nc['converged']}/{nt['converged']} (|r| {nc['norm']:.3e}/{nt['norm']:.3e} of "
        f"|r0| {nt['norm0']:.3e}); penetrating {int(cc['n_penetrating'])}/"
        f"{int(ct['n_penetrating'])}, pass the float32 angle gate {int(cc['n_engaged'])}/"
        f"{int(ct['n_engaged'])}")
    if int(ct["n_penetrating"]) == 0:
        fail("the 16^3 contact step is not engaged")
    # Which penetrating points pass the reference's angle gate
    # (arccos(ratio) > 1e-5, below float32's arccos resolution of 3.45e-4
    # rad) turns on rounding of the foot point, so two engines whose
    # iterates differ by rounding settle on different contact sets and
    # their converged steps differ far above the reference's 1e-4 bar; no
    # Newton tolerance closes that gap (the gated contact residual has a
    # float32 floor near rel_tol).  The engines are held against each other
    # on the first Newton system of the next step instead, assembled from
    # one carry, where both see the same contact set: the residual at the
    # assemble bar, J w within one bfloat16 step of its scale (each engine
    # rounds its own tangent block).
    sd2 = NDS.translate_scene_data(sd, PUSH)
    w = torch.randn(prob.n_dof * prob.dim, generator=gen).to(device, prob.dtype)
    ns = {impl: steps[impl].newton_system(out["torch"], contact_scenes=[sd2])
          for impl in steps}
    r_err = float((ns["cuda"]["r"] - ns["torch"]["r"]).abs().max())
    r_scale = float(ns["torch"]["r"].abs().max())
    jw = {impl: ns[impl]["J_apply"](w) for impl in steps}
    jw_err = float((jw["cuda"] - jw["torch"]).abs().max())
    jw_scale = float(jw["torch"].abs().max())
    say(f"[10. 16^3 contact Newton system] cuda vs torch from the torch step's carry, "
        f"tool at z 0.98: residual max|err| {r_err:.3e} scale {r_scale:.3e}; J w max|err| "
        f"{jw_err:.3e} scale {jw_scale:.3e}")
    if not r_err <= 1e-4 * r_scale:
        fail(f"contact Newton residual parity {r_err} > 1e-4 * {r_scale}")
    if not jw_err <= 2.0**-7 * jw_scale:
        fail(f"contact J w parity {jw_err} > 2^-7 * {jw_scale}")
    del prob, carry0, out, steps, ns, jw, w
    torch.cuda.empty_cache()

    # ---- 11. the contact path at 48^3 ---------------------------------------
    sweeps.reset_launches()
    t0 = time.perf_counter()
    prob = build_contact(mt, SPANS, device)
    torch.cuda.synchronize()
    cd = prob.contact[0]
    n_fq = cd["wq"].numel()
    say(f"[11. 48^3 contact] host build {time.perf_counter() - t0:.2f} s: n_el {prob.n_el}, "
        f"unknowns {prob.n_dof * prob.dim}, contact faces {cd['conn'].shape[0]}, face "
        f"quadrature points {n_fq}, mortar dofs {prob.contact_static[0]['n_local']}")
    query = prob.contact_static[0]["query"]
    n_proj = [0]

    def counted_query(*a):  # counts closest-point projections per step
        n_proj[0] += 1
        return query(*a)

    prob.contact_static[0]["query"] = counted_query
    t0 = time.perf_counter()
    carry = mt.initial_carry(prob)
    torch.cuda.synchronize()
    say(f"[11. 48^3 contact] initial carry {time.perf_counter() - t0:.2f} s")
    step = mt.make_step(prob, **CONTACT_STEP_KW)
    sd = cd["scene"]
    times, diags, penetrating, all_diags = [], [], [], []
    for i in range(1 + CONTACT_TIMED_STEPS):
        sd = NDS.translate_scene_data(sd, PUSH)  # on the device
        p0 = n_proj[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = step(carry, contact_scenes=[sd])
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        d, c = carry["newton"], carry["contact"][0]
        eqps = carry["state"]["eqps"]
        force = (-c["res_el"].sum((0, 1))).tolist()
        tool_z = float(sd[0]["cps"][0, 2])
        say(f"[11. 48^3 contact] step {i} ({'warm' if i == 0 else 'timed'}), tool z "
            f"{tool_z:.4f}: {t_s:.3f} s; newton {d['iters']} gmres {d['lin_iters']} "
            f"converged {d['converged']} (|r0| {d['norm0']:.4e} -> |r| {d['norm']:.4e}); "
            f"projections {n_proj[0] - p0}; proj_unconverged {int(c['proj_unconverged'])} "
            f"proj_res_max {float(c['proj_res_max']):.3e}; penetrating (true_g < 0) "
            f"{int(c['n_penetrating'])} of {n_fq}, of those pass the angle gate "
            f"{int(c['n_engaged'])}; force from the traction residual "
            f"({force[0]:.4e}, {force[1]:.4e}, {force[2]:.4e}), observable 'force' z "
            f"{float(c['force'][2]):.4e}; 'area' (the deformed face area, not a contact "
            f"area) {float(c['area']):.6f}; eqps max {float(eqps.max()):.4e}, plastic "
            f"points {int((eqps > 0).sum())}; max|u| {float(carry['u'].abs().max()):.4e}")
        if not d["finite"]:
            fail(f"non-finite state at contact step {i}")
        all_diags.append(d)
        if i > 0:
            times.append(t_s)
            diags.append(d)
            penetrating.append(int(c["n_penetrating"]))
    launches = dict(sweeps.LAUNCHES)
    s_step = sum(times) / len(times)
    say(f"[11. 48^3 contact] {s_step:.4f} s/step over {len(times)} timed steps "
        f"({', '.join(f'{t:.3f}' for t in times)}); newton iters "
        f"{[d['iters'] for d in diags]}; gmres iters {[d['lin_iters'] for d in diags]}; "
        f"launches { {k: n for k, n in launches.items() if n} }")
    # Newton: converged (rel_tol 1e-3), or down to the float32 floor of the
    # gated contact residual (|r| <= 2e-2 |r0|: rounding flips points
    # across the reference's angle gate, each worth ~kappa g w det J), or
    # a step whose |r0| is itself rounding (the tool exactly touching the
    # face: below 1e-6 of the run's largest |r0|)
    r0_max = max(d["norm0"] for d in all_diags)
    for i, d in enumerate(all_diags):
        if not (d["converged"] or d["norm"] <= 2e-2 * d["norm0"]
                or d["norm0"] <= 1e-6 * r0_max):
            fail(f"contact step {i}: Newton stopped at |r| {d['norm']} of |r0| {d['norm0']}")
    # the body may rebound from the tool after the impact (density 1e3,
    # 1 m/s tool speed), so engagement is asked of the timed steps
    # together, not of the last one
    if max(penetrating) == 0:
        fail("no face quadrature point penetrated the tool by the last timed step")
    for name, _ in VARIANTS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the contact path")

    # the variants against plain, and their times, at the path's state: the
    # predictor of the next step, the first assemble's input (after the
    # accumulate, the yielded points sit on the yield surface, where float32
    # rounding picks the elastic or the plastic tangent)
    g, _ = sh._gather_scatter(prob)
    mu_v, dt = float(prob.material.viscosity), CONTACT_STEP_KW["dt"]
    fc = prob.facs
    xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
    va = carry["v"] + fc["fac2"] * dt * carry["a"]
    f = {"u_el": g(xa), "a_el": g(carry["a"]), "v_el": g(va),
         "w_el": rnd(3, 27, prob.n_el), "state": carry["state"]}
    del xa, va
    errs, Cb = compare_variants(torch, sweeps, prob, f, dt, mu_v, "11. 48^3 contact path")
    tabs, jinv, wq, mat = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.material
    rho = float(mat.density)
    fac0 = prob.facs["fac3"] * dt * dt
    fac1_mu_v = prob.facs["fac4"] * dt * mu_v
    args = (f["u_el"], f["a_el"], f["state"], tabs, jinv, wq, mat, dt, rho)
    visc = dict(v_el=f["v_el"], mu_v=mu_v)
    bf16 = torch.bfloat16
    calls = {
        "residual_sf[visc]": (lambda: sweeps.residual_sf(*args, **visc),
                              lambda: sweeps.residual_sf_plain(*args, **visc)),
        "assemble_sf[visc,bf16]": (
            lambda: sweeps.assemble_sf(*args, **visc, c_dtype=bf16),
            lambda: sweeps.assemble_sf_plain(*args, **visc, c_dtype=bf16)),
        "matvec_sf[visc,bf16]": (
            lambda: sweeps.matvec_sf(f["w_el"], tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v),
            lambda: sweeps.matvec_sf_plain(f["w_el"], tabs, jinv, wq, Cb, rho, fac0,
                                           fac1_mu_v)),
    }
    n_pts = prob.n_el * prob.n_q
    n_plastic = plastic_points(soa, sweeps, prob, f["u_el"], f["state"], dt)
    el_out = 3 * 27 * prob.n_el * 4
    byts = {  # inputs read once, outputs written once
        "residual_sf[visc]": nbytes(f["u_el"], f["a_el"], f["v_el"], tabs, jinv, wq,
                                    f["state"]) + el_out,
        "assemble_sf[visc,bf16]": nbytes(f["u_el"], f["a_el"], f["v_el"], tabs, jinv, wq,
                                         f["state"], Cb) + el_out,
        "matvec_sf[visc,bf16]": nbytes(f["w_el"], tabs, jinv, wq, Cb) + el_out,
    }
    rows = []
    for name, replaces in VARIANTS:
        kern, plain = calls[name]
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, 3)
        row = kernel_row(name, SOURCE[0], replaces, launches[name], errs[name], ms,
                         plain_ms, byts[name], n_pts * OPS_PER_POINT[name])
        say(f"[11. 48^3 timing] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({byts[name] / 1e9:.3f} GB, "
            f"{n_plastic} plastic points); {byts[name] / ms / 1e9:.3f} TB/s")
        rows.append(row)
    del f, Cb, calls

    # ---- 12. where one contact step's time goes (torch.profiler) -----------
    from torch.profiler import ProfilerActivity, profile

    def device_rows(prof):
        return [(e.key, e.count, e.self_device_time_total / 1e3)
                for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]

    sd = NDS.translate_scene_data(sd, PUSH)
    p0 = n_proj[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = step(carry, contact_scenes=[sd])
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    d = carry["newton"]
    ev = device_rows(prof)
    busy = sum(t for _, _, t in ev)
    if busy > 0:
        say(f"[12. 48^3 contact profile] one step (newton {d['iters']}, gmres "
            f"{d['lin_iters']}, projections {n_proj[0] - p0}): device busy {busy:.1f} ms of "
            f"the profiled step's {t_prof:.1f} ms wall; idle share {1.0 - busy / t_prof:.3f} "
            f"(the profiler slows the host, so this overstates idling); timed mean "
            f"{s_step * 1e3:.1f} ms/step")
        for key, n, t in sorted(ev, key=lambda x: -x[2])[:12]:
            say(f"[12. 48^3 contact profile]   {t:9.3f} ms  x{n:<5d} {key[:90]}")
    else:
        say("[12. 48^3 contact profile] device time not visible to torch.profiler: "
            "not measured")
    # the closest-point projection alone, at the path's last state
    cur = carry["u"][cd["conn"]] + cd["x_ref_el"]
    qpts = torch.einsum("eqn,end->eqd", cd["N"], cur).reshape(-1, prob.dim)
    query(qpts, sd)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = query(qpts, sd)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        query(qpts, sd)
        torch.cuda.synchronize()
    q_dev = sum(t for _, _, t in device_rows(prof))
    say(f"[12. 48^3 contact profile] closest-point projection of {qpts.shape[0]} points: "
        f"wall {sorted(walls)[2]:.3f} ms (median of 5), device busy "
        f"{q_dev:.3f} ms; unconverged {int((~res['converged']).sum())}")
    return rows


def dense_build(mt, spans, device):
    """The two-patch neo-Hookean cantilever at `spans` per patch and axis."""
    mat = mt.CompressibleOgdenNeoHookean()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    return mt.build_problem(
        TWO_PATCH, 1, 0, mat, [(0, 0), (0, 1), (0, 2)], {1: -5.0}, rho_inf=0.5,
        device=device, refine_spans=spans,
    )


def compare_dense(torch, sweeps, prob, u_el, a_el, w_el, label):
    """Each dense kernel against its plain version on the same inputs;
    returns ({kernel: max_abs_err}, the plain tangent planes) and fails
    past the stated tolerances."""
    mat, wq = prob.material, prob.wdet_t
    dN, N = prob.dense["dN_t"], prob.dense["N_t"]
    args = (u_el, a_el, None, dN, N, wq, mat, STEP_KW["dt"], float(mat.density))
    fac0 = prob.facs["fac3"] * STEP_KW["dt"] ** 2
    errs = {}
    y_k = sweeps.residual_dense(*args)
    torch.cuda.synchronize()
    y_p = sweeps.residual_dense_plain(*args)
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    errs["residual_dense"] = err
    say(f"[{label}] residual_dense: max|err| {err:.3e} scale {scale:.3e}")
    # float32; F and P agree to the bit (no FMA, the plain version's
    # operation order), the quadrature sums run in another order
    if not err <= 1e-5 * scale:
        fail(f"dense residual kernel disagrees with plain ({err} > 1e-5 * {scale})")
    ya_k, C_k = sweeps.assemble_dense(*args)
    torch.cuda.synchronize()
    ya_p, C_p = sweeps.assemble_dense_plain(*args)
    err, scale = float((ya_k - ya_p).abs().max()), float(ya_p.abs().max())
    c_err, c_scale = float((C_k - C_p).abs().max()), float(C_p.abs().max())
    errs["assemble_dense[sym]"] = max(err, c_err)
    say(f"[{label}] assemble_dense[sym]: residual max|err| {err:.3e} scale {scale:.3e}; "
        f"45 planes max|err| {c_err:.3e} of max {c_scale:.3e} ({c_err / c_scale:.3e})")
    if not err <= 1e-4 * scale:
        fail(f"dense assemble kernel residual disagrees ({err} > 1e-4 * {scale})")
    # the closed-form tangent against the plain version's forward-mode
    # planes, float32
    if not c_err <= 1e-4 * c_scale:
        fail(f"dense assemble kernel tangent disagrees ({c_err} > 1e-4 * {c_scale})")
    mv_k = sweeps.matvec_dense(w_el, dN, N, wq, C_p, float(mat.density), fac0)
    torch.cuda.synchronize()
    mv_p = sweeps.matvec_dense_plain(w_el, dN, N, wq, C_p, float(mat.density), fac0)
    err, scale = float((mv_k - mv_p).abs().max()), float(mv_p.abs().max())
    errs["matvec_dense[sym]"] = err
    say(f"[{label}] matvec_dense[sym]: max|err| {err:.3e} scale {scale:.3e}")
    if not err <= 1e-4 * scale:
        fail(f"dense matvec kernel disagrees with plain ({err} > 1e-4 * {scale})")
    return errs, C_p


def dense_phases(torch, mt, sweeps, sh, device, gen):
    """Phases 13-16: the dense kernels against plain at 2 x 8^3, one step
    of the kernel path against the plain path there, the two-patch
    cantilever at 2 x 38^3, the kernels on its state, their times and one
    profiled step.  Returns the dense rows of the kernels line."""
    # ---- 13. dense kernels vs plain at 2 x 8^3, random fields ---------------
    prob = dense_build(mt, DENSE_CHECK_SPANS, device)
    E = prob.n_el
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, prob.dtype)  # noqa: E731
    # each element scaled so that its largest |F - I| (Frobenius) is 0.1:
    # strains up to 10%, where mu (F - F^-T) cancels most in float32
    u_el = rnd(3, 27, E)
    strain = lambda u: torch.linalg.vector_norm(  # noqa: E731
        sweeps.dense_grad(u, prob.dense["dN_t"]), dim=(0, 1))
    u_el = u_el * (0.1 / strain(u_el).amax(0))
    a_el, w_el = rnd(3, 27, E), rnd(3, 27, E)
    label = f"13. 2x{DENSE_CHECK_SPANS}^3 random"
    eps = strain(u_el)
    J = sweeps.soa.det(sweeps.soa.add_diag(sweeps.dense_grad(u_el, prob.dense["dN_t"]), 1.0))
    say(f"[{label}] n_el {E}, unknowns {prob.n_dof * 3}; |F - I| min {float(eps.min()):.4f} "
        f"median {float(eps.median()):.4f} max {float(eps.max()):.4f}; det F in "
        f"[{float(J.min()):.4f}, {float(J.max()):.4f}]")
    compare_dense(torch, sweeps, prob, u_el, a_el, w_el, label)

    # ---- 14. one step at 2 x 8^3: cuda vs torch ------------------------------
    carry0 = mt.initial_carry(prob)
    out = {impl: mt.make_step(prob, residual_impl=impl, **STEP_KW)(carry0)
           for impl in ("cuda", "torch")}
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
    say(f"[14. 2x{DENSE_CHECK_SPANS}^3 step] cuda vs torch: max|du| {err:.3e} max|u| "
        f"{scale:.3e}; newton {nc['iters']}/{nt['iters']} gmres "
        f"{nc['lin_iters']}/{nt['lin_iters']}")
    # index_add_ scatters in float32 with atomics: rounding, not bitwise
    if not err <= 1e-4 * scale:
        fail(f"dense one-step parity {err} > 1e-4 * {scale}")
    del prob, carry0, out, u_el, a_el, w_el, J, eps
    torch.cuda.empty_cache()

    # ---- 15. the two-patch cantilever at 2 x 38^3 ----------------------------
    sweeps.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = dense_build(mt, DENSE_SPANS, device)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    tab_gb = nbytes(prob.dense, prob.wdet_t) / 1e9
    say(f"[15. 2x38^3 dense] host build {host_s:.2f} s: n_el {prob.n_el}, n_q {prob.n_q}, "
        f"unknowns {prob.n_dof * prob.dim}; dense tables {tab_gb:.3f} GB on the device "
        f"(peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB)")
    t0 = time.perf_counter()
    carry = mt.initial_carry(prob)
    torch.cuda.synchronize()
    say(f"[15. 2x38^3 dense] initial carry {time.perf_counter() - t0:.2f} s")
    step = mt.make_step(prob, **STEP_KW)
    t0 = time.perf_counter()
    carry = step(carry)
    torch.cuda.synchronize()
    say(f"[15. 2x38^3 dense] warm step {time.perf_counter() - t0:.3f} s {carry['newton']}")
    times, diags = [], []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        diags.append(carry["newton"])
    launches = dict(sweeps.LAUNCHES)
    s_step = sum(times) / len(times)
    qp_rate = prob.n_el * prob.n_q * RES_EVALS_PER_STEP / s_step
    say(f"[15. 2x38^3 dense] {s_step:.4f} s/step over {TIMED_STEPS} steps "
        f"({', '.join(f'{t:.3f}' for t in times)}); {qp_rate:.4e} qp-evals/s; newton iters "
        f"{[d['iters'] for d in diags]}; gmres iters {[d['lin_iters'] for d in diags]}; "
        f"max|u| {float(carry['u'].abs().max()):.4e}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    for d in diags:
        say(f"[15. 2x38^3 dense] newton |r0| {d['norm0']:.4e} -> |r| {d['norm']:.4e} "
            f"(ratio {d['norm'] / d['norm0']:.2e})")
    for name, _ in DENSE_KERNELS:  # at least once in each of the 1 + 5 steps
        if launches[name] < 1 + TIMED_STEPS:
            fail(f"kernel {name} was launched {launches[name]} times in 6 dense steps")
    if not all(d["finite"] for d in diags):
        fail("non-finite state on the dense path")
    # rel_tol 1e-8 is below float32 resolution: a four-order drop is the goal
    for d in diags:
        if not (math.isfinite(d["norm"]) and d["norm"] <= 1e-4 * d["norm0"]):
            fail(f"dense Newton did not converge: |r| {d['norm']} vs |r0| {d['norm0']}")

    # ---- 13 (path). the kernels on the path's state ---------------------------
    g, _ = sh._gather_scatter(prob)
    fc, dt = prob.facs, STEP_KW["dt"]
    xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
    u_el, a_el = g(xa), g(carry["a"])
    w_el = torch.randn(3, 27, prob.n_el, generator=gen).to(device, prob.dtype)
    del xa
    errs, Cs = compare_dense(torch, sweeps, prob, u_el, a_el, w_el, "13. 2x38^3 path")

    # ---- 16. times, bandwidth and one profiled step ---------------------------
    mat, wq, rho = prob.material, prob.wdet_t, float(prob.material.density)
    dN, N = prob.dense["dN_t"], prob.dense["N_t"]
    fac0 = fc["fac3"] * dt * dt
    args = (u_el, a_el, None, dN, N, wq, mat, dt, rho)
    calls = {
        "residual_dense": (lambda: sweeps.residual_dense(*args),
                           lambda: sweeps.residual_dense_plain(*args)),
        "assemble_dense[sym]": (lambda: sweeps.assemble_dense(*args),
                                lambda: sweeps.assemble_dense_plain(*args)),
        "matvec_dense[sym]": (
            lambda: sweeps.matvec_dense(w_el, dN, N, wq, Cs, rho, fac0),
            lambda: sweeps.matvec_dense_plain(w_el, dN, N, wq, Cs, rho, fac0)),
    }
    el_out = 3 * 27 * prob.n_el * 4
    byts = {  # inputs read once, outputs written once
        "residual_dense": nbytes(u_el, a_el, dN, N, wq) + el_out,
        "assemble_dense[sym]": nbytes(u_el, a_el, dN, N, wq, Cs) + el_out,
        "matvec_dense[sym]": nbytes(w_el, dN, N, wq, Cs) + el_out,
    }
    n_pts = prob.n_el * prob.n_q
    rows = []
    for name, replaces in DENSE_KERNELS:
        kern, plain = calls[name]
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, 3)
        row = kernel_row(name, SOURCE[1], replaces, launches[name], errs[name], ms,
                         plain_ms, byts[name], n_pts * OPS_PER_POINT[name])
        say(f"[16. 2x38^3 timing] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"{byts[name] / 1e9:.3f} GB, bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
            f"{byts[name] / ms / 1e9:.3f} TB/s ({byts[name] / ms / 1e9 / (HBM_BPS / 1e12):.2f} "
            f"of 3.35)")
        rows.append(row)
    del calls, args, u_el, a_el, w_el, Cs

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    ev = [(e.key, e.count, e.self_device_time_total / 1e3)
          for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(t for _, _, t in ev)
    d = carry["newton"]
    if busy > 0:
        say(f"[16. 2x38^3 profile] one step (newton {d['iters']}, gmres {d['lin_iters']}): "
            f"device busy {busy:.1f} ms; idle share {1.0 - busy / (s_step * 1e3):.3f} of the "
            f"timed {s_step * 1e3:.1f} ms/step (profiled step wall {t_prof:.1f} ms)")
        for key, n, t in sorted(ev, key=lambda x: -x[2])[:12]:
            say(f"[16. 2x38^3 profile]   {t:9.3f} ms  x{n:<5d} {key[:90]}")
    else:
        say("[16. 2x38^3 profile] device time not visible to torch.profiler: not measured")
    del prob, carry, step, prof
    torch.cuda.empty_cache()
    return rows


def main():
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("TF32 off for matmul and cuDNN (full float32 products)")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    device = torch.device("cuda")

    sys.path.insert(0, ROOT)
    import mimi_tpu_torch as mt
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.ops import build as kbuild
    from mimi_tpu_torch.ops import sweeps
    from mimi_tpu_torch.parallel import sharding as sh
    from mimi_tpu_torch.solvers.linear import gmres

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.load()
    build_s = time.perf_counter() - t0
    say(f"kernel build: {build_s:.2f} s (cached={kbuild.BUILD_INFO['cached']}; one nvcc "
        f"per source started together, then one link)")
    for line in kbuild.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain at 16^3 -----------------------------------------
    prob = build(mt, CHECK_SPANS, device)
    E, h = prob.n_el, 1.0 / CHECK_SPANS
    gen = torch.Generator().manual_seed(0)
    dt_ = prob.dtype
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, dt_)  # noqa: E731
    u_el = 0.06 * h * rnd(3, 27, E)  # strains ~5-10%: past yield, F well-conditioned
    a_el, w_el = rnd(3, 27, E), rnd(3, 27, E)
    state = {k: v.clone() for k, v in prob.state0.items()}
    state["eqps"] = 0.01 * torch.rand(64, E, generator=gen).to(device, dt_)
    state["temperature"] = 20.0 + 100.0 * torch.rand(64, E, generator=gen).to(device, dt_)
    dF = sweeps.sf_grad(u_el, prob.sf["tables"], prob.sf["jinv"])
    *_, active, _ = prob.material._return_map(
        soa.add_diag(dF, 1.0), state, STEP_KW["dt"]
    )
    frac = float(active.float().mean())
    say(f"[16^3 random] plastic fraction of quadrature points: {frac:.3f}")
    if frac < 0.25:
        fail(f"plastic fraction {frac} < 0.25: the check would not exercise the return map")
    compare_sweeps(torch, sweeps, prob, u_el, a_el, w_el, state, "16^3 random")

    # ---- 4. one-step parity at 16^3 ------------------------------------------
    carry0 = mt.initial_carry(prob)
    out = {}
    for impl in ("cuda", "torch"):
        out[impl] = mt.make_step(prob, residual_impl=impl, **STEP_KW)(carry0)
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    say(f"[16^3 step] cuda vs torch: max|du| {err:.3e} max|u| {scale:.3e} "
        f"newton {out['cuda']['newton']['iters']}/{out['torch']['newton']['iters']} "
        f"gmres {out['cuda']['newton']['lin_iters']}/{out['torch']['newton']['lin_iters']}")
    # the bar of the reference package's pallas-vs-soa parity check
    if not err <= max(1e-4 * scale, 1e-7):
        fail(f"one-step parity {err} > 1e-4 * {scale}")
    del prob, carry0, out, u_el, a_el, w_el, state, dF, active
    torch.cuda.empty_cache()

    # ---- 5. the main path at 48^3 -------------------------------------------
    sweeps.reset_launches()
    t0 = time.perf_counter()
    prob = build(mt, SPANS, device)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    say(f"[48^3] host build {host_s:.2f} s: n_el {prob.n_el}, n_q {prob.n_q}, "
        f"unknowns {prob.n_dof * prob.dim}; basis path: sum-factorized 1D tables "
        "+ per-point jinv and w det J (no dense N/dN tables)")
    t0 = time.perf_counter()
    carry = mt.initial_carry(prob)
    torch.cuda.synchronize()
    say(f"[48^3] initial carry {time.perf_counter() - t0:.2f} s")
    step = mt.make_step(prob, **STEP_KW)
    t0 = time.perf_counter()
    carry = step(carry)
    torch.cuda.synchronize()
    say(f"[48^3] warm step {time.perf_counter() - t0:.3f} s {carry['newton']}")
    diags = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        carry = step(carry)
        diags.append(carry["newton"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sweeps.LAUNCHES)
    s_step = wall / TIMED_STEPS
    qp_rate = prob.n_el * prob.n_q * RES_EVALS_PER_STEP / s_step
    eqps = carry["state"]["eqps"]
    say(f"[48^3] {s_step:.4f} s/step over {TIMED_STEPS} steps; "
        f"{qp_rate:.4e} qp-evals/s; newton iters {[d['iters'] for d in diags]}; "
        f"gmres iters {[d['lin_iters'] for d in diags]}")
    say(f"[48^3] eqps max {float(eqps.max()):.4e}, plastic points "
        f"{int((eqps > 0).sum())}; max|u| {float(carry['u'].abs().max()):.4e}; "
        f"finite {all(d['finite'] for d in diags)}; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    for d in diags:
        say(f"[48^3] newton |r0| {d['norm0']:.4e} -> |r| {d['norm']:.4e} "
            f"(ratio {d['norm'] / d['norm0']:.2e}, converged flag {d['converged']})")
    for name, _ in KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if not all(d["finite"] for d in diags):
        fail("non-finite state on the main path")
    # The step's goal rel_tol 1e-8 (the benchmark's setting) lies below
    # float32 resolution of the residual, so the flag stays False in float32
    # in both packages; Newton has converged when the residual fell four
    # orders, to the float32 floor.
    for d in diags:
        if not (math.isfinite(d["norm"]) and d["norm"] <= 1e-4 * d["norm0"]):
            fail(f"Newton did not converge: |r| {d['norm']} vs |r0| {d['norm0']}")

    # ---- 6. kernels vs plain on the main path's inputs at 48^3 --------------
    g, _ = sh._gather_scatter(prob)
    u_el, a_el = g(carry["u"]), g(carry["a"])
    w_el = torch.randn(3, 27, prob.n_el, generator=gen).to(device, prob.dtype)
    errs, C = compare_sweeps(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], "48^3 path")
    tabs, jinv, wq, mat = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.material
    rho, dt = float(mat.density), STEP_KW["dt"]
    fac0 = prob.facs["fac3"] * dt * dt
    st = carry["state"]
    calls = {
        "matvec_sf": (lambda: sweeps.matvec_sf(w_el, tabs, jinv, wq, C, rho, fac0),
                      lambda: sweeps.matvec_sf_plain(w_el, tabs, jinv, wq, C, rho, fac0)),
        "assemble_sf": (lambda: sweeps.assemble_sf(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho),
                        lambda: sweeps.assemble_sf_plain(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho)),
        "residual_sf": (lambda: sweeps.residual_sf(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho),
                        lambda: sweeps.residual_sf_plain(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho)),
    }
    n_pts = prob.n_el * prob.n_q
    el_out = 3 * 27 * prob.n_el * 4
    byts = {  # inputs read once, outputs written once
        "matvec_sf": nbytes(w_el, tabs, jinv, wq, C) + el_out,
        "assemble_sf": nbytes(u_el, a_el, tabs, jinv, wq, st, C) + el_out,
        "residual_sf": nbytes(u_el, a_el, tabs, jinv, wq, st) + el_out,
    }
    rows = []
    for name, replaces in KERNELS:
        kern, plain = calls[name]
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, 3)
        row = kernel_row(name, SOURCE[0], replaces, launches[name], errs[name], ms,
                         plain_ms, byts[name], n_pts * OPS_PER_POINT[name])
        say(f"[48^3 timing] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({byts[name] / 1e9:.3f} GB); "
            f"{byts[name] / ms / 1e9:.3f} TB/s")
        rows.append(row)

    # ---- 7. cost of the GMRES loop's per-iteration host sync -----------------
    ns = step.newton_system(carry)
    J_apply, M_apply, r = ns["J_apply"], ns["M_apply"], ns["r"]
    n_it = 1

    def solve():  # one FDM-GMRES solve, reading its Hessenberg column per iteration
        nonlocal n_it
        _, info = gmres(J_apply, r, M_apply=M_apply, rel_tol=STEP_KW["lin_rel_tol"],
                        abs_tol=1e-12, restart=30, max_iter=40, return_info=True)
        n_it = max(int(info["iters"]), 1)

    def device_work():  # the same solve's device work, no host reads
        V = torch.zeros((n_it + 1, r.numel()), dtype=r.dtype, device=device)
        M_apply(r)
        V[0] = M_apply(r - J_apply(torch.zeros_like(r)))
        for j in range(n_it):
            w = M_apply(J_apply(V[j]))
            hh = V[: j + 1] @ w
            w = w - hh @ V[: j + 1]
            V[j + 1] = w / torch.clamp(w.norm(), min=1e-30)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    solve()
    device_work()
    pairs = [(wall_ms(solve), wall_ms(device_work)) for _ in range(7)]
    t_solve = sorted(a for a, _ in pairs)[3]
    t_dev = sorted(b for _, b in pairs)[3]
    say(f"[48^3 gmres] {n_it} iterations, median of 7: {t_solve:.3f} ms with a host "
        f"read per iteration, {t_dev:.3f} ms for the same device work unsynchronized; "
        f"host sync cost {(t_solve - t_dev) / n_it:.4f} ms/iteration "
        f"(per-pair spread {min(a - b for a, b in pairs) / n_it:.4f} to "
        f"{max(a - b for a, b in pairs) / n_it:.4f})")

    # ---- 8. where one step's device time goes (torch.profiler) -------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies); operator rows repeat their
    # kernels' time
    ev = [(e.key, e.count, e.self_device_time_total / 1e3)
          for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(t for _, _, t in ev)
    if busy > 0:
        # the profiler slows the host, not the device: compare the device
        # time with the unprofiled step time
        say(f"[48^3 profile] one step: device busy {busy:.1f} ms; idle share "
            f"{1.0 - busy / (s_step * 1e3):.3f} of the timed {s_step * 1e3:.1f} ms/step "
            f"(profiled step wall {t_prof:.1f} ms)")
        for key, n, t in sorted(ev, key=lambda x: -x[2])[:12]:
            say(f"[48^3 profile]   {t:9.3f} ms  x{n:<5d} {key[:90]}")
    else:
        say("[48^3 profile] device time not visible to torch.profiler: not measured")

    del C, ns, J_apply, M_apply, calls, u_el, a_el, w_el, st
    del prob, carry, step, prof
    torch.cuda.empty_cache()

    # ---- 9-12. the contact press ---------------------------------------------
    rows += contact_phases(torch, mt, sweeps, soa, sh, device, gen)

    # ---- 13-16. the dense-table path ------------------------------------------
    rows += dense_phases(torch, mt, sweeps, sh, device, gen)

    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
