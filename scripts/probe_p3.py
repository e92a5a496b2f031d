#!/usr/bin/env python3
"""Time the cubic (p = 3) 3D kernels and steps at full size on one CUDA
GPU: the sf residual, assemble and matvec of J2 on the body-force cube of
cube-nurbs-3.mesh at --spans^3 (random input, chip_smoke.py
plastic_inputs at |F - I| up to 0.02) and the dense (3, 3) ones of the
neo-Hookean two-patch cube elevated by 2 at 2 x --dense-spans^3 (random
input, chip_smoke.py random_visc_inputs), each over 5 calls (CUDA
events); then two steps of each problem with the body-force path's step
settings (chip_smoke.py STEP_KW), host clock around each.  The checks of
these kernels against their plain versions are chip_smoke.py's phases
54-57; this script only times.

    python3 scripts/probe_p3.py [--spans 48] [--dense-spans 38]

Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spans", type=int, default=48)
    ap.add_argument("--dense-spans", type=int, default=38)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    import chip_smoke as cs
    import mimi_tpu_torch as mt
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.ops import build as kbuild
    from mimi_tpu_torch.ops import sweeps

    t0 = time.perf_counter()
    kbuild.prebuild(cs.EARLIER_KEYS)
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    device, gen, dt = torch.device("cuda"), torch.Generator().manual_seed(0), cs.STEP_KW["dt"]
    kw = {k: v for k, v in cs.STEP_KW.items() if k != "dt"}
    for label, prob in (
        (f"sf {args.spans}^3 p=3 J2", lambda: cs.cube3_of(mt, cs.jc_material(mt), args.spans,
                                                           device)),
        (f"dense 2x{args.dense_spans}^3 p=3 neo-Hookean",
         lambda: cs.two_patch3_of(mt, cs.hyper_material(mt), args.dense_spans, device)),
    ):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob = prob()
        torch.cuda.synchronize()
        print(f"[{label}] build {time.perf_counter() - t0:.1f} s: n_el {prob.n_el}, n_q "
              f"{prob.n_q}, unknowns {prob.n_dof * prob.dim}", flush=True)
        mat = prob.material
        if mat.has_state:
            f, _ = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, 0.02)
        else:
            f = cs.random_visc_inputs(torch, sweeps, prob, mat, gen, dt)
        tables, kern, _ = cs.kernel_fns(sweeps, prob)
        a = (f["u_el"], f["a_el"], f["state"], *tables, prob.wdet_t, mat, dt, 1.0)
        _, C = kern[1](*a)
        storage = sweeps.tangent_storage(mat)
        for name, fn in (("residual", lambda: kern[0](*a)), ("assemble", lambda: kern[1](*a)),
                         ("matvec", lambda: kern[2](f["w_el"], *tables, prob.wdet_t, C, 1.0, 1e-4,
                                                    storage=storage))):
            print(f"[{label}] {name}: {cs.cuda_ms(torch, fn, 5):.3f} ms", flush=True)
        del f, a, C
        carry = mt.initial_carry(prob)
        step = mt.make_step(prob, dt, **kw)
        for _ in range(2):
            t0 = time.perf_counter()
            carry = step(carry)
            torch.cuda.synchronize()
            print(f"[{label}] step {time.perf_counter() - t0:.2f} s {carry['newton']}; peak "
                  f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        del prob, carry, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
