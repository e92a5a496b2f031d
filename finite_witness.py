#!/usr/bin/env python3
"""Two witnesses for the finite-strain golden cantilevers of chip_smoke.py
(phases 34-35): J2Simo and J2Log with the Johnson-Cook material of the
reference's j2_simo / j2_log goldens on balken.mesh, boundary 2 clamped,
body force -3, chip_smoke.py's 2D step settings (10 Newton iterations,
FDM-GMRES(30, at most 80) at lin_rel_tol 1e-3).

1. dt 0.2.  Up to 3 steps from the initial carry at p = 3 and
   each size of `--sizes` (subdivisions: 7 is 128^2, 9 is 512^2) on three
   paths: the kernel path (float32), the plain path (float32) and the
   plain path in float64.  Per step: the Newton drop and iterations,
   GMRES per solve, finite state, max|u|, eqps max and the points that
   yield.  A path stops at its first step that is not finite or stops
   short of a 1e-2 drop.  Read: does the plain path diverge where the
   kernel path does?
2. The first Newton system of each timed step of the dt 0.1 drive (1 warm
   + 3 timed steps on the kernel path, as phase 35 runs it) at 512^2 p = 3
   and 128^2 p = 2: its residual r on the kernel path and on the plain
   path in float32, each against the plain path in float64 at the same
   carry, and the plain path at the carry rounded to bfloat16 (what a
   kernel that kept 8 bits of its inputs would read).  Errors are max|dr|
   over max|r| of the float64 system.

    python3 finite_witness.py [--sizes 7,8,9] [--readings 9,7] [--device cuda]

Needs a CUDA GPU unless `--device cpu` (a dry run at small sizes, e.g.
--sizes 3 --readings 3,2: the kernel path is left out).  Prints the card's name and power limit first.
"""

import argparse
import math
import os
import subprocess
import sys
import time

import chip_smoke as cs


def first_steps(torch, mt, name, subdivide, device, dtype, impl, steps):
    """Witness 1 on one path: up to `steps` dt 0.2 steps from the initial
    carry; prints one line per step."""
    prob = cs.balken_build(mt, name, 2, subdivide, device, dtype)
    tag = f"[dt 0.2, {2**subdivide}^2 p=3 {name}, {impl} {str(dtype).split('.')[-1]}]"
    carry = mt.initial_carry(prob, residual_impl=impl)
    step = mt.make_step(prob, 0.2, residual_impl=impl, **cs.STEP2D_KW)
    for i in range(steps):
        before = carry
        t0 = time.perf_counter()
        carry = step(carry)
        if device.type == "cuda":
            torch.cuda.synchronize()
        d = carry["newton"]
        drop = cs.drop_of(carry)
        yielded = int((carry["state"]["eqps"] > before["state"]["eqps"]).sum())
        cs.say(f"{tag} step {i + 1}: {time.perf_counter() - t0:.1f} s; newton {d['iters']}, "
               f"gmres {d['lin_iters'] / max(d['iters'], 1):.1f} per solve; |r0| "
               f"{d['norm0']:.4e} -> |r| {d['norm']:.4e} (drop {drop:.3e}); finite "
               f"{d['finite']}; max|u| {float(carry['u'].abs().max()):.4e}; eqps max "
               f"{float(carry['state']['eqps'].max()):.4e}; points yielding {yielded}")
        if not (d["finite"] and math.isfinite(drop) and drop <= 1e-2):
            break
    del prob, carry, step


def cast_carry(torch, carry, dtype, bf16=False):
    """The carry's fields and state in `dtype`; with `bf16`, rounded to
    bfloat16 on the way."""
    def c(x):
        return (x.to(torch.bfloat16) if bf16 else x).to(dtype)
    out = dict(carry, **{k: c(carry[k]) for k in ("u", "v", "a")})
    out["state"] = {k: c(v) for k, v in carry["state"].items()}
    return out


def newton_readings(torch, mt, name, elevate, subdivide, device, timed):
    """Witness 2 on one problem: the dt 0.1 drive on the kernel path and,
    at each timed step's input carry, the first Newton system's residual
    of four evaluations against the float64 plain one."""
    dt = cs.GOLDEN_FINITE[name][1]
    p32 = cs.balken_build(mt, name, elevate, subdivide, device, torch.float32)
    p64 = cs.balken_build(mt, name, elevate, subdivide, device, torch.float64)
    impls = ("cuda", "torch") if device.type == "cuda" else ("torch",)
    tag = f"[dt {dt}, {2**subdivide}^2 p={elevate + 1} {name}]"
    ns = {impl: mt.make_step(p32, dt, residual_impl=impl, **cs.STEP2D_KW).newton_system
          for impl in impls}
    ns64 = mt.make_step(p64, dt, residual_impl="torch", **cs.STEP2D_KW).newton_system
    carry = mt.initial_carry(p32, residual_impl=impls[0])
    step = mt.make_step(p32, dt, residual_impl=impls[0], **cs.STEP2D_KW)
    carry = step(carry)
    for i in range(timed):
        r64 = ns64(cast_carry(torch, carry, torch.float64))["r"]
        scale = float(r64.abs().max())
        errs = {impl: ns[impl](carry)["r"].double() for impl in impls}
        errs["torch at the bf16 carry"] = ns["torch"](
            cast_carry(torch, carry, torch.float32, bf16=True))["r"].double()
        line = ", ".join(f"{k} {float((v - r64).abs().max()) / scale:.3e}"
                         for k, v in errs.items())
        if "cuda" in errs:
            line += (f"; cuda vs torch float32 "
                     f"{float((errs['cuda'] - errs['torch']).abs().max()) / scale:.3e}")
        before = carry
        carry = step(carry)
        yielded = int((carry["state"]["eqps"] > before["state"]["eqps"]).sum())
        cs.say(f"{tag} timed step {i}: max|r64| {scale:.4e}; against float64: {line}; "
               f"the step's drop {cs.drop_of(carry):.3e}, points yielding {yielded}")
    del p32, p64, carry, step, ns, ns64


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="7,8,9", help="subdivisions of witness 1 (9: 512^2)")
    ap.add_argument("--readings", default="9,7", help="subdivisions of witness 2 (p = 3, 2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            cs.fail("torch.cuda.is_available() is False: this witness needs a CUDA GPU")
        cs.say(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
        torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mimi_tpu_torch as mt

    t0 = time.perf_counter()
    for sub, elevate in zip((int(s) for s in args.readings.split(",")), (2, 1)):
        for name in cs.GOLDEN_FINITE:
            newton_readings(torch, mt, name, elevate, sub, device, 3)
    cs.say(f"[clock] witness 2: {time.perf_counter() - t0:.1f} s")
    paths = [("cuda", torch.float32), ("torch", torch.float32), ("torch", torch.float64)]
    if device.type != "cuda":
        paths = paths[1:]
    for sub in (int(s) for s in args.sizes.split(",")):
        for name in cs.GOLDEN_FINITE:
            for impl, dtype in paths:
                first_steps(torch, mt, name, sub, device, dtype, impl, 3)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        cs.say(f"[clock] witness 1 at {2**sub}^2: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
