#!/usr/bin/env python3
"""Time the sum-factorized residual and assemble kernels of this checkout
against another version of the same CUDA sources, on one CUDA GPU, on the
same inputs in one process.

    mkdir -p <dir>; git archive <rev> mimi_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_sf_sweeps.py --base <dir>

The base's sources (<dir>/mimi_tpu_torch/ops/csrc) are built with the
flags of ops/build.py into <dir>/_build and bound with its signatures, so
their C entry points must match this checkout's.  Inputs at 48^3 elements
(cube-nurbs.mesh, p = 2): J2 Johnson-Cook near F = I (elastic), J2 on
random plastic input (chip_smoke.py phase 9's recipe; the viscous residual
and the viscous assemble with a bfloat16 block, the contact press's
variants, and the float32 assemble), the neo-Hookean material near F = I
(inviscid, and viscous with a bfloat16 block), J2Simo and J2Log on
chip_smoke.py's random plastic history.  Every output of the two versions
is compared; the times are CUDA-event means, taken base, new, new, base.
Prints the card's name and power limit first.
"""

import argparse
import ctypes
import os
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
    for s, p in zip(srcs, procs):
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"nvcc failed on {s}:\n{log[-3000:]}")
    so = os.path.join(out, "libbase.so")
    subprocess.run([kb.nvcc(), "-shared", "-o", so, *objs], check=True)
    return kb.bind(ctypes.CDLL(so))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="directory holding the other version's "
                    "mimi_tpu_torch/ops/csrc")
    ap.add_argument("--spans", type=int, default=48)
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
    libs = {"new": kb.load(), "base": build_base(kb, os.path.abspath(args.base))}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    dev, gen, n = torch.device("cuda"), torch.Generator().manual_seed(0), args.spans

    def ab(label, calls, reps):
        for name, fn in calls.items():
            outs = {}
            for tag in ("base", "new"):
                kb._LIB = libs[tag]
                o = fn()
                outs[tag] = [x.float() for x in (o if isinstance(o, tuple) else (o,))]
            torch.cuda.synchronize()
            diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(outs["new"], outs["base"]))
            del outs
            ts = []
            for tag in ("base", "new", "new", "base"):
                kb._LIB = libs[tag]
                ts.append(cs.cuda_ms(torch, fn, reps))
            print(f"[{label}] {name}: base {ts[0]:.4f} / {ts[3]:.4f} ms, new {ts[1]:.4f} / "
                  f"{ts[2]:.4f} ms, base / new {(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}; outputs "
                  f"differ by {diff:.2e} of their max", flush=True)
        kb._LIB = libs["new"]
        torch.cuda.empty_cache()

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


if __name__ == "__main__":
    main()
