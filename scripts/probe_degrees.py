#!/usr/bin/env python3
"""First card run of the degree, quadrature-order and element-shape
kernels: builds every library of ops/build.py's default shapes and of
chip_smoke.NEW_KEYS from the sources (printing each library's and each
source's nvcc seconds and ptxas's registers and spills), then runs
chip_smoke.py's phases 62-67 (every new instantiation against its plain
version, the fused kernels, paths K and L, the held steps).  A failed
check is printed and the run goes on, so that one call shows every fault;
exits 1 if any check failed.

    python3 scripts/probe_degrees.py
"""

import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

FAILED = []


def note(msg):
    FAILED.append(msg)
    print(f"FAILED CHECK: {msg}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import mimi_tpu_torch as mt
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.ops import build as kbuild
    from mimi_tpu_torch.ops import fused_neohookean as fused
    from mimi_tpu_torch.ops import sweeps
    from mimi_tpu_torch.parallel import sharding as sh

    chip_smoke.fail = note
    keys = chip_smoke.BUILD_ORDER
    t0 = time.perf_counter()
    kbuild.prebuild(keys)
    print(f"[probe] every library built in {time.perf_counter() - t0:.2f} s on {kbuild.JOBS} "
          "nvcc processes", flush=True)
    chip_smoke.check_ptxas(kbuild, keys, "probe ptxas")
    gen = torch.Generator().manual_seed(0)
    try:
        chip_smoke.degree_phases(torch, mt, sweeps, soa, sh, fused, kbuild,
                                 torch.device("cuda"), gen)
    except Exception:  # the probe reports every fault of one call
        note(traceback.format_exc())
    print(f"[probe] {len(FAILED)} failed checks", flush=True)
    sys.exit(1 if FAILED else 0)


if __name__ == "__main__":
    main()
