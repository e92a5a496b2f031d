#!/usr/bin/env python3
"""Time the main path's steps (chip_smoke.py phase 5: the 48^3 J2
body-force cube, make_step with the smoke's STEP_KW) of several checkouts of
the repo on one CUDA GPU, each in a process of its own, in the order given:

    mkdir -p <dir>; git archive <rev> | tar -x -C <dir>
    python3 scripts/ab_main_path.py [--steps 5] <dir> . . <dir>

(parent, change, change, parent).  Each process imports the package and
chip_smoke.py of its own checkout, builds the problem, takes a warm step
(which builds the checkout's kernels into its own ops/_build, outside the
timing), then `--steps` timed steps.  It prints one JSON line per run:
s/step (mean and each step), Newton and GMRES iterations (the same work on
both sides), kernel launches per step.  The host's share of a step shows
here: the path makes ~60 launches a step and its device is idle for about
half of it, so a cost per launch on the host moves s/step.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r"""
import json, sys, time
import torch
root, steps = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import chip_smoke as cs
import mimi_tpu_torch as mt
from mimi_tpu_torch.ops import sweeps

prob = cs.build(mt, cs.SPANS, torch.device("cuda"))
carry = mt.initial_carry(prob)
step = mt.make_step(prob, **cs.STEP_KW)
t0 = time.perf_counter()
carry = step(carry)
torch.cuda.synchronize()
warm = time.perf_counter() - t0
sweeps.reset_launches()
times, newton = [], []
for _ in range(steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = step(carry)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    newton.append((carry["newton"]["iters"], carry["newton"]["lin_iters"]))
print(json.dumps({"root": root, "s_step": sum(times) / len(times), "steps": times,
                  "warm_s": warm, "newton_gmres": newton,
                  "launches_per_step": sum(sweeps.LAUNCHES.values()) / steps}), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repo, timed in this order")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", CHILD, root, str(args.steps)], cwd=root,
                             capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"{root}: rc {out.returncode}\n{out.stdout}\n{out.stderr[-4000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
