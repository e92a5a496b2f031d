#!/usr/bin/env python3
"""GMRES iterations per step of the main path's body-force J2 cube for
each matvec: the sum-factorized or the dense tables (matvec_impl), the
tangent block and the dense tables in float32 or bfloat16 (matvec_dtype),
on the plain engine, float32.

    python3 scripts/gmres_by_matvec.py [--spans 8 12] [--steps 3] [--device cpu]

Each configuration takes --steps steps from the same initial carry with
chip_smoke.py's STEP_KW (4 Newton iterations, FDM-GMRES(30, 40) at
lin_rel_tol 1e-3) and prints the GMRES iterations of every step.  The
counts are what the solver counts, on any device; no time is taken.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, nargs="+", default=[8, 12])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mimi_tpu_torch as mt

    device = torch.device(args.device)
    for n in args.spans:
        prob = mt.build_problem(cs.MESH, 1, 0, cs.jc_material(mt), [(1, 0), (1, 1), (1, 2)],
                                {1: -3.0}, rho_inf=0.5, device=device, dtype=torch.float32,
                                refine_spans=n)
        carry0 = mt.initial_carry(prob, residual_impl="torch")
        for impl in ("sf", "dense"):
            for mv in ("f32", "bf16"):
                step = mt.make_step(prob, residual_impl="torch", matvec_impl=impl,
                                    matvec_dtype=mv, **cs.STEP_KW)
                carry, its = carry0, []
                for _ in range(args.steps):
                    carry = step(carry)
                    its.append(carry["newton"]["lin_iters"])
                print(f"{n}^3 matvec_impl={impl} matvec_dtype={mv}: GMRES per step {its}",
                      flush=True)


if __name__ == "__main__":
    main()
