#!/usr/bin/env python3
"""Time the compile of each CUDA source of ops/build.py on its own, all
started together as ops/build.py starts them, on a machine with nvcc.

    python3 scripts/time_kernel_build.py

Prints each source's seconds (wall, from its start to its end, the
sources competing for the machine's cores as in a build), the whole
set's and the core count.  The objects go to a temporary directory and
are dropped; the kernel library of ops/_build/ is not touched.
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mimi_tpu_torch.ops import build as kbuild  # noqa: E402


def main():
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        running = {}
        for src in kbuild.SOURCES:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            running[src] = (time.perf_counter(), subprocess.Popen(
                [kbuild.nvcc(), *kbuild.flags_of(src), "-c", "-o", obj, src],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        while running:
            for src, (ts, proc) in list(running.items()):
                if proc.poll() is not None:
                    print(f"{os.path.basename(src)}: {time.perf_counter() - ts:.1f} s, rc "
                          f"{proc.returncode}", flush=True)
                    del running[src]
            time.sleep(0.2)
        print(f"all sources: {time.perf_counter() - t0:.1f} s on {os.cpu_count()} cores")


if __name__ == "__main__":
    main()
