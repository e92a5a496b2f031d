#!/usr/bin/env python3
"""Time the sum-factorized residual, assemble and matvec kernels of this
checkout against another version of the same CUDA sources, on one CUDA
GPU, on the same inputs in one process.

    mkdir -p <dir>; git archive <rev> mimi_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_sf_sweeps.py --base <dir> [--only REGEX]

The base's sources (<dir>/mimi_tpu_torch/ops/csrc) are built with the
flags of ops/build.py into <dir>/_build and bound with its signatures, so
their C entry points must match this checkout's.  Inputs at 48^3 elements
(cube-nurbs.mesh, p = 2): J2 Johnson-Cook near F = I (elastic), J2 on
random plastic input (chip_smoke.py phase 9's recipe; the viscous residual
and the viscous assemble with a bfloat16 block, the contact press's
variants, and the float32 assemble), the neo-Hookean material near F = I
(inviscid, and viscous with a bfloat16 block), J2Simo and J2Log on
chip_smoke.py's random plastic history; every sf matvec instantiation
(cauchy, sym and full, inviscid and viscous, float32 and bfloat16 block)
on random w and random planes at p = 2 (48^3) and at p = 3 (the inviscid
float32 ones on path H's tables at 48^3, cube-nurbs-3.mesh; the viscous
and bfloat16 ones at 16^3).  Every output of the two versions is
compared: the max abs difference, relative to the output's max, and
whether they are equal to the bit.  The times are CUDA-event means,
taken base, new, new, base.  Prints the card's name and power limit
first and ptxas's registers and spills of this checkout's sf kernels
(chip_smoke.py phase 2's report; a spill is printed, not raised).
`--only` keeps the rows whose name matches the regular expression.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_base(kb, base):
    """The base's sources compiled into one library, bound."""
    csrc = os.path.join(base, "mimi_tpu_torch", "ops", "csrc")
    out = os.path.join(base, "_build")
    os.makedirs(out, exist_ok=True)
    srcs = [os.path.join(csrc, os.path.basename(s)) for s in kb.SOURCES]
    objs = [os.path.join(out, os.path.basename(s) + ".o") for s in srcs]
    procs = [subprocess.Popen([kb.nvcc(), *kb.FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for s, o in zip(srcs, objs)]
    logs = []
    for s, p in zip(srcs, procs):
        logs.append(p.communicate()[0])
        if p.returncode:
            sys.exit(f"nvcc failed on {s}:\n{logs[-1][-3000:]}")
    so = os.path.join(out, "libbase.so")
    subprocess.run([kb.nvcc(), "-shared", "-o", so, *objs], check=True)
    return kb.bind(ctypes.CDLL(so)), "".join(logs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="directory holding the other version's "
                    "mimi_tpu_torch/ops/csrc")
    ap.add_argument("--spans", type=int, default=48)
    ap.add_argument("--only", default="", help="time only the rows whose name matches")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mimi_tpu_torch as mt
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.ops import build as kb
    from mimi_tpu_torch.ops import sweeps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs = {"new": kb.load()}
    libs["base"], base_log = build_base(kb, os.path.abspath(args.base))
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    cs.fail = lambda msg: print(f"[2. ptxas] {msg}", flush=True)
    cs.check_sf_ptxas(kb)
    for name, v in sorted(cs.ptxas_entries(base_log, kb.nvcc()).items()):
        if "sf_tile_kernel" in name and "SfMatvecPoint" in name:
            print(f"[base ptxas] {name.split('>(')[0]}>: {v.get('registers')} "
                  f"registers, spill stores {v.get('spill_stores')} B", flush=True)
    dev, gen, n = torch.device("cuda"), torch.Generator().manual_seed(0), args.spans

    def ab(label, calls, reps):
        for name, fn in calls.items():
            if not re.search(args.only, name):
                continue
            outs = {}
            for tag in ("base", "new"):
                kb._LIB = libs[tag]
                o = fn()
                outs[tag] = [x.float() for x in (o if isinstance(o, tuple) else (o,))]
            torch.cuda.synchronize()
            pairs = list(zip(outs["new"], outs["base"]))
            diff = max(float((a - b).abs().max()) for a, b in pairs)
            rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                      for a, b in pairs)
            same = all(torch.equal(a, b) for a, b in pairs)
            del outs, pairs
            ts = []
            for tag in ("base", "new", "new", "base"):
                kb._LIB = libs[tag]
                ts.append(cs.cuda_ms(torch, fn, reps))
            print(f"[{label}] {name}: base {ts[0]:.4f} / {ts[3]:.4f} ms, new {ts[1]:.4f} / "
                  f"{ts[2]:.4f} ms, base / new {(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}; outputs "
                  f"differ by {diff:.3e} ({rel:.2e} of their max), equal to the bit: {same}",
                  flush=True)
        kb._LIB = libs["new"]
        torch.cuda.empty_cache()

    def matvecs(label, prob, combos, reps):
        """The sf matvec of each (storage, viscous, bfloat16) in combos on
        prob's tables, random w and random planes."""
        E, nd = prob.n_el, prob.sf["pp1"] ** 3
        tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
        w_el = torch.randn(3, nd, E, generator=gen).to(dev)
        calls = {}
        for storage, visc, bf16 in combos:
            C = torch.randn(sweeps.n_planes(storage), prob.n_q, E, generator=gen).to(dev)
            C = C.to(torch.bfloat16) if bf16 else C
            name = sweeps.matvec_counter("sf", storage, 3, prob.sf["pp1"] - 1, visc, bf16)
            calls[name] = (lambda C=C, storage=storage, fm=(50.0 if visc else None):
                           sweeps.matvec_sf(w_el, tabs, jinv, wq, C, 1e2, 1e-3, fm, storage))
        ab(label, calls, reps)

    combos = [(storage, visc, bf16) for storage in ("cauchy", "sym", "full")
              for visc in (False, True) for bf16 in (False, True)]

    prob = cs.build(mt, n, dev)
    E, h = prob.n_el, 1.0 / n
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev, prob.dtype)  # noqa: E731
    tabs, jinv, wq, mat = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.material
    st = {k: v.clone() for k, v in prob.state0.items()}
    u_el, a_el, v_el = 1e-3 * h * rnd(3, 27, E), rnd(3, 27, E), rnd(3, 27, E)
    a = (u_el, a_el, st, tabs, jinv, wq, mat, 0.05, 1.0)
    print(f"[J2 elastic] plastic points {cs.plastic_points(soa, sweeps, prob, u_el, st, 0.05)}",
          flush=True)
    ab("J2 elastic", {"residual_sf": lambda: sweeps.residual_sf(*a),
                      "assemble_sf": lambda: sweeps.assemble_sf(*a)}, 20)
    u_el = 0.06 * h * rnd(3, 27, E)
    st["eqps"] = 0.01 * torch.rand(64, E, generator=gen).to(dev)
    st["temperature"] = 20.0 + 100.0 * torch.rand(64, E, generator=gen).to(dev)
    a = (u_el, a_el, st, tabs, jinv, wq, mat, 0.05, 1.0)
    print(f"[J2 plastic] plastic points {cs.plastic_points(soa, sweeps, prob, u_el, st, 0.05)} "
          f"of {E * 64}", flush=True)
    ab("J2 plastic", {
        "residual_sf[visc]": lambda: sweeps.residual_sf(*a, v_el=v_el, mu_v=10.0),
        "assemble_sf[visc,bf16]": lambda: sweeps.assemble_sf(*a, v_el=v_el, mu_v=10.0,
                                                             c_dtype=torch.bfloat16),
        "assemble_sf": lambda: sweeps.assemble_sf(*a)}, 10)
    del prob, st, a, u_el, a_el, v_el, tabs, jinv, wq
    prob = cs.hyper_build(mt, n, dev)
    E = prob.n_el
    tabs, jinv, wq, mat = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.material
    u_el, _ = cs.near_identity(torch, lambda u: sweeps.sf_grad(u, tabs, jinv), rnd(3, 27, E),
                               0.01)
    a_el, v_el = rnd(3, 27, E), rnd(3, 27, E)
    a = (u_el, a_el, None, tabs, jinv, wq, mat, 0.05, float(mat.density))
    ab("neo-Hookean", {
        "residual_sf[nh]": lambda: sweeps.residual_sf(*a),
        "assemble_sf[nh,sym]": lambda: sweeps.assemble_sf(*a),
        "residual_sf[nh,visc]": lambda: sweeps.residual_sf(*a, v_el=v_el, mu_v=100.0),
        "assemble_sf[nh,sym,visc,bf16]": lambda: sweeps.assemble_sf(
            *a, v_el=v_el, mu_v=100.0, c_dtype=torch.bfloat16)}, 20)
    del prob, a, u_el, a_el, v_el, tabs, jinv, wq
    for name, tag in (("J2Simo", "simo"), ("J2Log", "log")):
        prob = cs.build(mt, n, dev, name=name)
        u_el, a_el, _, st, share = cs.finite_inputs(torch, sweeps, soa, prob, gen)
        tabs, jinv, wq, mat = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.material
        a = (u_el, a_el, st, tabs, jinv, wq, mat, 0.05, 1.0)
        print(f"[{name}] plastic share {share:.3f}", flush=True)
        ab(name, {f"residual_sf[{tag}]": lambda: sweeps.residual_sf(*a),
                  f"assemble_sf[{tag},full]": lambda: sweeps.assemble_sf(*a)}, 5)
        del prob, a, u_el, a_el, st, tabs, jinv, wq
    prob = cs.build(mt, n, dev)
    matvecs("p=2 matvec", prob, combos, 20)
    del prob
    mat = cs.jc_material(mt)
    prob = cs.cube3_of(mt, mat, n, dev)
    matvecs("p=3 matvec", prob, [c for c in combos if not (c[1] or c[2])], 5)
    del prob
    prob = cs.cube3_of(mt, mat, 16, dev)
    matvecs("p=3 matvec 16^3", prob, [c for c in combos if c[1] or c[2]], 20)


if __name__ == "__main__":
    main()
