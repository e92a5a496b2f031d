#!/usr/bin/env python3
"""Time the J2-family CUDA sweeps with the radial return capped at the
reference kernels' 40 trips (ops/sweeps.py, J2Params::max_iter =
materials.KERNEL_SOLVE_TRIPS) against the 100 trips they ran before that
cap, on one CUDA GPU, on the same inputs in one process.

    python3 scripts/ab_trip_cap.py [--spans 48] [--subdivide 9]

The trip count is the only field the two runs differ in: this script
rebuilds the kernels' J2Params with max_iter 100 for the uncapped turns
(j2.cuh's loop is otherwise the one the kernels ran at 100 trips).  Rows,
each on random plastic input (chip_smoke.py plastic_inputs, |F - I| up to
0.1 per element, a random plastic history):
  - the contact press's J2 (Johnson-Cook A 700, B 1400, E 1e6, viscosity
    100) sf residual (viscous) and assemble (viscous, bfloat16 block) at
    --spans^3, p = 2;
  - the golden J2 law's dense residual and assemble at 2D p = 3 on the
    golden cantilever refined --subdivide times;
  - J2Log's sf assemble at the golden law at --spans^3.
Each row is timed with CUDA events (10 calls) in turns 100, 40, 40, 100
trips; the outputs of the two caps are compared; the plain residual, run
as the kernels' twin (kernel_solver_mode) and at the "torch" engine's 100
trips, gives the share of the plastic points at the cap.  Prints the
card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=48)
    ap.add_argument("--subdivide", type=int, default=9)
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
    kb.prebuild(cs.EARLIER_KEYS)
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    capped = sweeps._j2_params

    def trips(n):
        def params(*a, **k):
            p = capped(*a, **k)
            p.max_iter = n
            return p
        return params

    def ab(label, calls, plain_residual):
        for name, fn in calls.items():
            outs = {}
            for n in (100, 40):
                sweeps._j2_params = trips(n)
                o = fn()
                outs[n] = [x.float() for x in (o if isinstance(o, tuple) else (o,))]
            sweeps._j2_params = capped
            torch.cuda.synchronize()
            diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(outs[40], outs[100]))
            del outs
            ms = []
            for n in (100, 40, 40, 100):
                sweeps._j2_params = trips(n)
                ms.append(cs.cuda_ms(torch, fn, 10))
            sweeps._j2_params = capped
            print(f"[{label}] {name}: 100 trips {ms[0]:.4f} / {ms[3]:.4f} ms, 40 trips "
                  f"{ms[1]:.4f} / {ms[2]:.4f} ms, 100 / 40 {(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}"
                  f"; outputs differ by {diff:.2e} of their max", flush=True)
        cs.cap_share(torch, label, plain_residual)
        torch.cuda.empty_cache()

    # the contact press's J2, sum-factorized
    prob = cs.build(mt, args.spans, dev)
    mat = cs.press_finite_material(mt, "J2")
    mat.setup(3)
    dt = cs.PRESS_STEP_KW["dt"]
    f, share = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, cs.LAW_AMPLITUDE)
    a = (f["u_el"], f["a_el"], f["state"], prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, mat,
         dt, float(mat.density))
    visc = dict(v_el=f["v_el"], mu_v=float(mat.viscosity))
    label = f"{args.spans}^3 press J2"
    print(f"[{label}] plastic share {share:.4f}", flush=True)
    ab(label, {"residual_sf[visc]": lambda: sweeps.residual_sf(*a, **visc),
               "assemble_sf[visc,bf16]": lambda: sweeps.assemble_sf(*a, **visc,
                                                                    c_dtype=torch.bfloat16)},
       lambda: sweeps.residual_sf_plain(*a, **visc))
    # J2Log at the golden law, sum-factorized
    mat = cs.jc_material(mt, name="J2Log")
    mat.setup(3)
    dt = cs.STEP_KW["dt"]
    f, share = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, cs.LAW_AMPLITUDE)
    a = (f["u_el"], f["a_el"], f["state"], prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, mat,
         dt, 1.0)
    label = f"{args.spans}^3 J2Log golden law"
    print(f"[{label}] plastic share {share:.4f}", flush=True)
    ab(label, {"assemble_sf[log,full]": lambda: sweeps.assemble_sf(*a)},
       lambda: sweeps.residual_sf_plain(*a))
    del prob, f, a
    # the golden J2 law on dense 2D p = 3 tables
    prob = cs.cantilever_of(mt, cs.jc_material(mt), 2, args.subdivide, dev)
    mat, dt = prob.material, cs.GOLDEN_2D["J2"][1]
    f, share = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, cs.LAW_AMPLITUDE)
    a = (f["u_el"], f["a_el"], f["state"], prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t,
         mat, dt, 1.0)
    label = f"{2**args.subdivide}^2 p=3 J2 golden law"
    print(f"[{label}] plastic share {share:.4f}", flush=True)
    ab(label, {"residual_dense@2d_p3": lambda: sweeps.residual_dense(*a),
               "assemble_dense@2d_p3": lambda: sweeps.assemble_dense(*a)},
       lambda: sweeps.residual_dense_plain(*a))


if __name__ == "__main__":
    main()
