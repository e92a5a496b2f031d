#!/usr/bin/env python3
"""Card probe of the finite-strain kernels' numerics, on one CUDA GPU:

1. J2Log's material body (scripts/probe_finite_points.cu) at random
   points near F = I, built with and without fused multiply-adds: NaN
   planes, plastic and poisoned points;
2. the 48^3 J2Log body-force cube's warm step with the sf finite source
   built without fused multiply-adds (`-fmad=false`) and as shipped: the
   first assemble with a NaN plane, the planes and points it hits, F and
   the state there, and the material body re-run at those points;
3. the sf J2Log kernels on a 16^3 batch with elements past the log
   series' fast range (chip_smoke.hold_log_series, two inputs) and the
   deep series' cost against the fast one.

A failed check is printed and the run goes on.  Writes its log's pieces
and the NaN points beside its build, in ops/_build/probe_finite_strain/.

    python3 scripts/probe_finite_strain.py
"""
import ctypes, os, subprocess, sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch
import chip_smoke as cs
import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa
from mimi_tpu_torch.ops import build as kb, sweeps
from mimi_tpu_torch.parallel import sharding as sh

W = os.path.join(kb.BUILD_DIR, "probe_finite_strain")
OUT = W
os.makedirs(OUT, exist_ok=True); os.makedirs(W, exist_ok=True)
FAILS = []
def soft_fail(msg):
    print(f"FAIL (continuing): {msg}", flush=True); FAILS.append(msg)
cs.fail = soft_fail
T0 = time.time()
def say(m): print(f"{time.time() - T0:7.1f} {m}", flush=True)

NV, CS = kb.nvcc(), kb.CSRC
jobs = {}
def nvcc(tag, src, flags, defs=(), inc=()):
    obj = os.path.join(W, tag + ".o")
    cmd = [NV, *flags, *defs, *[f"-I{i}" for i in inc], "-c", "-o", obj, src]
    jobs[tag] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), time.time())
P = os.path.join(ROOT, "scripts", "probe_finite_points.cu")
nvcc("probe_fma", P, kb.FLAGS, inc=[CS])
nvcc("probe_nofma", P, kb.FLAGS + ["-fmad=false"], inc=[CS])
sf_def = kb.defines("sf", (3, 4))
for name in kb.KIND_SOURCES["sf"]:
    nvcc("sf_" + name, os.path.join(CS, name), kb.flags_of(name), sf_def)
nvcc("sf_nofma_finite", os.path.join(CS, "sweeps_sf_finite.cu"), kb.FLAGS + ["-fmad=false"], sf_def)

def wait(tag):
    obj, pr, t = jobs[tag]
    out, _ = pr.communicate()
    if pr.returncode:
        print(out); raise SystemExit(f"nvcc {tag} failed")
    say(f"nvcc {tag}: {time.time() - t:.1f} s")
    with open(os.path.join(OUT, f"ptxas_{tag}.log"), "w") as f:
        f.write(out)
    return obj

def link(name, objs):
    so = os.path.join(W, name + ".so")
    subprocess.run([NV, "-shared", "-o", so, *objs], check=True)
    return ctypes.CDLL(so)

dev = torch.device("cuda")
gen = torch.Generator().manual_seed(17)

# ---- 1. the material bodies at random points, FMA and no-FMA ----------------
probes = {b: link(b, [wait(b)]) for b in ("probe_fma", "probe_nofma")}
mat_log = cs.jc_material(mt, 70.0, "J2Log"); mat_log.setup(3)
PRM = sweeps._j2_params(mat_log, cs.STEP_KW["dt"], 1.0, family=("J2Simo", "J2Log"))
def run_probe(lib, F, fpi, eqps, temp, deep=0):
    n = F.shape[-1]
    F, fpi, eqps, temp = (x.to(dev, torch.float32).contiguous() for x in (F, fpi, eqps, temp))
    Pk = torch.zeros(9, n, device=dev); C = torch.zeros(81, n, device=dev); rm = torch.zeros(4, n, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    assert lib.probe_j2log(ctypes.byref(PRM), p(fpi), p(eqps), p(temp), p(F), p(Pk), p(C), p(rm), n, deep) == 0
    torch.cuda.synchronize()
    return Pk, C, rm
I9 = torch.eye(3).reshape(9, 1)
for amp in (0.0, 1e-3, 0.01, 0.03, 0.1):
    n = 200000
    F = I9 + amp * torch.randn(9, n, generator=gen)
    fpi = I9.expand(9, n)
    for e0 in (0.0, 0.01):
        for b, lib in probes.items():
            Pk, C, rm = run_probe(lib, F, fpi, torch.full((n,), e0), torch.full((n,), 20.0))
            say(f"[1. probe {b}] |F - I| ~ {amp} eqps0 {e0}: NaN planes {int(torch.isnan(C).sum())} at "
                f"{int(torch.isnan(C).any(0).sum())} points; P NaN {int(torch.isnan(Pk).sum())}; active "
                f"{int(rm[0].sum())}; poisoned {int(rm[1].sum())}")

# ---- 2. run 4: the 48^3 J2Log cube with the sf finite source without FMA ---
objs = {n: wait("sf_" + n) for n in kb.KIND_SOURCES["sf"]}
nofma = wait("sf_nofma_finite")
libs_sf = {
    "nofma": kb.bind(link("sf_nofma", [objs["sweeps_sf.cu"], objs["sweeps_sf_hyper.cu"], nofma]), "sf"),
    "fma": kb.bind(link("sf_fma", list(objs.values())), "sf"),
}
SFKEY = kb.key_of("sf", (3, 4))
CAP = []
def watch(asm):
    def wrapped(u_el, a_el, state, *rest, **kw):
        y, C = asm(u_el, a_el, state, *rest, **kw)
        bad = torch.isnan(C)
        if bad.any() and not CAP:
            tables, jinv = rest[0], rest[1]
            F = soa.add_diag(sweeps.sf_grad(u_el, tables, jinv), 1.0)
            idx = bad.nonzero()
            pts = torch.unique(idx[:, 1] * C.shape[2] + idx[:, 2])
            q, e = pts // C.shape[2], pts % C.shape[2]
            CAP.append(dict(n_nan=int(bad.sum()), planes=bad.sum((1, 2)).cpu(), q=q.cpu(), e=e.cpu(),
                            F=F[:, :, q, e].reshape(9, -1).cpu(), fpi=state["Fp_inv"][:, :, q, e].reshape(9, -1).cpu(),
                            eqps=state["eqps"][q, e].cpu(), temp=state["temperature"][q, e].cpu(),
                            umax=float(u_el.abs().max()), C=C[:, q, e].cpu(), y_nan=int(torch.isnan(y).sum())))
        return y, C
    return wrapped
orig = sh._SWEEPS[("sf", "cuda")]
for build_name in ("nofma", "fma"):
    kb._LIBS[SFKEY] = libs_sf[build_name]
    CAP.clear()
    sh._SWEEPS[("sf", "cuda")] = (orig[0], watch(orig[1]), orig[2])
    prob = cs.build(mt, cs.SPANS, dev, "J2Log")
    carry = mt.initial_carry(prob)
    step = mt.make_step(prob, **cs.STEP_KW)
    carry = step(carry)
    torch.cuda.synchronize()
    say(f"[2. {build_name}] 48^3 J2Log warm step {carry['newton']}")
    sh._SWEEPS[("sf", "cuda")] = orig
    if not CAP:
        say(f"[2. {build_name}] no NaN plane in the step's assembles")
        continue
    c = CAP[0]
    say(f"[2. {build_name}] first NaN assemble: {c['n_nan']} NaN entries at {len(c['q'])} points, "
        f"max|u_el| {c['umax']:.4e}, residual NaN {c['y_nan']}")
    planes = c["planes"].reshape(9, 9)
    say(f"[2. {build_name}] NaN count by plane (a rows, b columns):\n{planes.numpy()}")
    say(f"[2. {build_name}] q of the points {torch.bincount(c['q'], minlength=64).numpy().tolist()}")
    say(f"[2. {build_name}] F - I at the first points:\n{(c['F'][:, :4] - I9).numpy()}")
    say(f"[2. {build_name}] state: eqps max {float(c['eqps'].max())}, temp {float(c['temp'].min())}-"
        f"{float(c['temp'].max())}, |Fp_inv - I| max {float((c['fpi'] - I9).abs().max())}")
    torch.save(c, os.path.join(OUT, f"nan_points_{build_name}.pt"))
    for b, lib in probes.items():
        Pk, C, rm = run_probe(lib, c["F"], c["fpi"], c["eqps"], c["temp"])
        say(f"[2. {build_name} -> {b}] at those points: NaN planes {int(torch.isnan(C).sum())}, P NaN "
            f"{int(torch.isnan(Pk).sum())}, active {int(rm[0].sum())}, poisoned {int(rm[1].sum())}, "
            f"d* {rm[2, :4].tolist()}, r' {rm[3, :4].tolist()}")
    del prob, carry, step
    torch.cuda.empty_cache()

# ---- 3. the sf mixed batch with the shipped sources (phase 23) -------------
kb._LIBS[SFKEY] = libs_sf["fma"]
p = cs.build(mt, cs.CHECK_SPANS, dev, "J2Log")
u_el, a_el, w_el, state, share = cs.finite_inputs(torch, sweeps, soa, p, gen)
st = {k: v.clone() for k, v in state.items()}
diag = lambda x: torch.diag(torch.tensor([x, 1.0, 1.0])).to(dev, p.dtype)
st["Fp_inv"][..., 0] = diag(6.0)[:, :, None]
st["Fp_inv"][..., 1] = diag(1e5)[:, :, None]
for rep in range(2):
    cs.hold_log_series(torch, sweeps, p, u_el, a_el, w_el, st, cs.STEP_KW["dt"], f"3. 16^3 J2Log out of range, seed pass {rep}")
    u_el = u_el + 1e-3 * torch.randn(u_el.shape, generator=gen).to(dev)
args = (u_el, a_el, st, p.sf["tables"], p.sf["jinv"], p.wdet_t, p.material, cs.STEP_KW["dt"], 1.0)
args_in = (u_el, a_el, state) + args[3:]
for lab, a in (("mixed (deep)", args), ("in range (fast)", args_in)):
    ms = cs.cuda_ms(torch, lambda: sweeps.assemble_sf(*a), 5)
    ms_r = cs.cuda_ms(torch, lambda: sweeps.residual_sf(*a), 5)
    say(f"[3. timing] 16^3 J2Log {lab}: assemble {ms:.4f} ms, residual {ms_r:.4f} ms")

say(f"FAILS {len(FAILS)}: {FAILS}")
sys.exit(1 if FAILS else 0)
