#!/usr/bin/env python3
"""The dense finite-strain kernels (J2Simo, J2Log) of this checkout
against another version's, and at (3, 216, 343), on one CUDA GPU:

1. nvcc of sweeps_dense_finite.cu and its bfloat16 twin at the driven
   shapes (3, 27, 64), (2, 16, 25), (2, 9, 16) and at (3, 216, 343), and
   of the other version's sweeps_dense_finite.cu at the driven shapes,
   with ptxas's registers and spills of the residual / assemble kernels;
2. the residual and the float32 assemble, inviscid and viscous, of both
   versions at the drives' sizes on random plastic input
   (chip_smoke.dense_finite_inputs): whether the outputs are equal to the
   bit, and CUDA-event times taken parent, change, change, parent;
3. every instantiation at (3, 216, 343), 2 x 7^3 elements, against the
   plain versions (chip_smoke.hold_p3).

Only the finite sources are built (not whole libraries).  A failed check
is printed and the run goes on; exits 1 if any failed.

    mkdir -p <dir>; git archive <rev> mimi_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_dense_finite_shapes.py --base <dir>
"""
import argparse, ctypes, os, subprocess, sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch
import chip_smoke as cs
import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa
from mimi_tpu_torch.ops import build as kb, sweeps

W = os.path.join(kb.BUILD_DIR, "ab_dense_finite_shapes")
OUT = W
ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--base", required=True, help="a directory holding the other version's mimi_tpu_torch/ops/csrc")
BASE = os.path.join(os.path.abspath(ap.parse_args().base), "mimi_tpu_torch", "ops", "csrc")
os.makedirs(OUT, exist_ok=True); os.makedirs(W, exist_ok=True)
FAILS = []
def soft_fail(msg):
    print(f"FAIL (continuing): {msg}", flush=True); FAILS.append(msg)
cs.fail = soft_fail
T0 = time.time()
def say(m): print(f"{time.time() - T0:7.1f} {m}", flush=True)
NV = kb.nvcc()
jobs = {}
def nvcc(tag, csrc, name, key):
    obj = os.path.join(W, tag + ".o")
    cmd = [NV, *kb.flags_of(name), *kb.defines("dense", key), "-c", "-o", obj, os.path.join(csrc, name)]
    jobs[tag] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), time.time())
DRIVEN = [(3, 27, 64), (2, 16, 25), (2, 9, 16)]
KEY5 = (3, 216, 343)
F32, BF = "sweeps_dense_finite.cu", "sweeps_dense_finite_bf16.cu"
for key in DRIVEN + [KEY5]:
    k = "_".join(map(str, key))
    nvcc(f"new_{k}", kb.CSRC, F32, key)
    nvcc(f"newbf_{k}", kb.CSRC, BF, key)
    if key != KEY5:
        nvcc(f"base_{k}", BASE, F32, key)
def wait(tag):
    obj, pr, t = jobs[tag]
    out, _ = pr.communicate()
    with open(os.path.join(OUT, f"ptxas2_{tag}.log"), "w") as f:
        f.write(out)
    if pr.returncode:
        print(out[-3000:]); raise SystemExit(f"nvcc {tag} failed")
    say(f"nvcc {tag}: {time.time() - t:.1f} s")
    for n, v in sorted(cs.ptxas_entries(out, NV).items()):
        if any(k in n for k in ("dense_finite_kernel", "dense_slot_kernel", "dense_residual_kernel")):
            say(f"[ptxas {tag}] {n[:200]}: {v.get('registers')} registers, spill stores "
                f"{v.get('spill_stores', 0)} B, loads {v.get('spill_loads', 0)} B, smem {v.get('smem')}")
    return obj
vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
def link(tag, objs):
    so = os.path.join(W, tag + ".so")
    subprocess.run([NV, "-shared", "-o", so, *objs], check=True)
    lib = ctypes.CDLL(so)
    for name, args in (("residual_dense_finite", [vp] * 11 + [sweeps._J2Params, cf, ci, ci, ci, ci, ll, vp]),
                       ("assemble_dense_finite", [vp] * 12 + [sweeps._J2Params, cf, ci, ci, ci, ci, ll, vp]),
                       ("assemble_dense_finite_bf16", [vp] * 12 + [sweeps._J2Params, cf, ci, ci, ci, ci, ll, vp]),
                       ("matvec_dense_full", [vp] * 6 + [cf, cf, ci, cf, ci, ci, ci, ll, vp]),
                       ("matvec_dense_full_bf16", [vp] * 6 + [cf, cf, ci, cf, ci, ci, ci, ll, vp])):
        fn = getattr(lib, "mimi_" + name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, ci
    return lib
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(171)
libs = {}
for key in DRIVEN:
    k = "_".join(map(str, key))
    libs[key] = {"base": link(f"base_{k}", [wait(f"base_{k}")]),
                 "new": link(f"new_{k}", [wait(f"new_{k}"), wait(f"newbf_{k}")])}
dt = 0.05
cases = [("2x38^3 golden law", lambda name: cs.dense_build(mt, cs.DENSE_SPANS, dev, name), 0.2),
         ("512^2 golden law", lambda name: cs.balken_build(mt, name, 2, cs.GOLDEN_SUBDIVIDE, dev), 0.2),
         ("2x512^2 press law (path G)", lambda name: cs.press_build(
             mt, 2, cs.PRESS_2D_SUBDIVIDE, dev, mat=cs.press_finite_material(mt, name)), 0.2)]
for size, make, amp in cases:
    for name in sweeps.FULL_KERNELS:
        prob = make(name)
        key = cs.table_key(prob)
        mat, dN, N, wq = prob.material, prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t
        u_el, a_el, v_el, state, share = cs.dense_finite_inputs(torch, sweeps, soa, prob, gen, dt, amp)
        a = (u_el, a_el, state, dN, N, wq, mat, dt, float(mat.density))
        for visc in (False, True):
            vk = dict(v_el=v_el, mu_v=100.0) if visc else {}
            for what, fn in (("residual", lambda: sweeps.residual_dense(*a, **vk)),
                             ("assemble f32", lambda: sweeps.assemble_dense(*a, **vk, c_dtype=torch.float32))):
                out, ms = {}, {}
                for ver in ("base", "new", "new", "base"):
                    kb._LIBS[kb.key_of("dense", key)] = libs[key][ver]
                    out[ver] = fn()
                    t = cs.cuda_ms(torch, fn, 3)
                    ms[ver] = ms.get(ver, 0.0) + t / 2
                ob, on = out["base"], out["new"]
                ob = ob if isinstance(ob, tuple) else (ob,)
                on = on if isinstance(on, tuple) else (on,)
                same = all(torch.equal(x, y) for x, y in zip(ob, on))
                say(f"[{size} {key} {name}{' visc' if visc else ''}] {what}: parent {ms['base']:.4f} ms, "
                    f"change {ms['new']:.4f} ms ({ms['base'] / ms['new']:.2f}x); equal to the bit {same}; "
                    f"plastic share {share:.3f}")
                if not same:
                    soft_fail(f"{size} {name} {what} visc={visc}: outputs differ")
        del u_el, a_el, v_el, state, a, prob
        torch.cuda.empty_cache()
# ---- (3, 216, 343) against plain ----
k5 = "_".join(map(str, KEY5))
lib5 = link("new5", [wait(f"new_{k5}"), wait(f"newbf_{k5}")])
for name in ("mimi_logm_deep_dense_finite", "mimi_logm_deep_dense_finite_bf16"):
    fn = getattr(lib5, name); fn.argtypes = [vp]; fn.restype = ci
for key in DRIVEN:
    kb._LIBS[kb.key_of("dense", key)] = libs[key]["new"]
    for name in ("mimi_logm_deep_dense_finite", "mimi_logm_deep_dense_finite_bf16"):
        fn = getattr(libs[key]["new"], name); fn.argtypes = [vp]; fn.restype = ci
kb._LIBS[kb.key_of("dense", KEY5)] = lib5
mats = cs.kernel_materials(mt, 3)[4:]
prob5 = mt.build_problem(os.path.join(ROOT, "tests", "data", "two-patch-cube.mesh"), 4, 0, mats[0],
                         [(0, 0), (0, 1), (0, 2)], {}, rho_inf=0.5, device="cuda", dtype=torch.float32,
                         refine_spans=7)
say(f"[p5 (3, 216, 343)] {prob5.n_el} elements, key {cs.table_key(prob5)}")
cs.hold_p3(torch, mt, sweeps, soa, prob5, ((False, False), (True, False), (False, True), (True, True)),
           "p5 2x7^3 random", gen, mats=mats, full=False)
say(f"FAILS {len(FAILS)}: {FAILS}")
sys.exit(1 if FAILS else 0)
