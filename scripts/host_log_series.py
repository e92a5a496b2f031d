#!/usr/bin/env python3
"""J2Log's sum-factorized kernels on a mixed batch, built as host C++ (no
card, no fused multiply-adds anywhere), against their plain versions.

The sf library at (3, 4) (3D p = 2) is compiled with g++ against
ops/csrc/host_stub/ (tests/test_torch_csrc_host.py host_build), then for
each seed: the body-force cube at --spans^3 with J2Log (chip_smoke.py's
Johnson-Cook law), random plastic input (chip_smoke.finite_inputs), element
0 stretched past the log series' fast range and element 1 past the deep
one, held against the plain versions by chip_smoke.compare_kernels (its
bars; a failed check is printed and the run goes on).  The planes' reading
is the card's phase 23 check without the card's rounding.

    python3 scripts/host_log_series.py [--spans 16] [--seeds 3]
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mimi_tpu_torch as mt  # noqa: E402
import test_torch_csrc_host as host  # noqa: E402
from mimi_tpu_torch.fem import soa  # noqa: E402
from mimi_tpu_torch.ops import build as kb, sweeps  # noqa: E402

KEY = ("sf", (3, 4))


def host_library(dest):
    """The sf library at KEY built with g++ into `dest`, bound as
    ops/build.py binds the card's."""
    units = [(*KEY, name) for name in kb.KIND_SOURCES["sf"]]
    failed = [u for u, (rc, _) in host.host_build(dest, units).items() if rc]
    if failed:
        raise SystemExit(f"host build failed: {failed}")
    so = os.path.join(dest, "lib_sf_3_4.so")
    subprocess.run(["g++", "-shared", "-o", so, *[host._unit_obj(dest, *u) for u in units]],
                   check=True)
    return kb.bind(ctypes.CDLL(so), "sf")


def use_host(lib):
    """Make the sf wrappers launch `lib` on CPU tensors (one host launch,
    no stream, no device check)."""
    kb._LIBS[kb.key_of(*KEY)] = lib
    kb.load = lambda kind, shape: kb._LIBS[kb.key_of(kind, shape)]
    sweeps._check_device = lambda device: None

    def launch(fn, name, *args):
        sweeps.LAUNCHES[name] += 1
        if fn(*args, ctypes.c_void_p(None)) != 0:
            raise RuntimeError(f"{name} failed")

    sweeps._launch = launch
    sweeps.residual_sf = lambda *a, **k: sweeps._sf_sweep(False, *a, **k)
    sweeps.assemble_sf = lambda *a, c_dtype=None, storage=None, **k: sweeps._sf_sweep(
        True, *a, **k, c_dtype=c_dtype or torch.float32, storage=storage)
    sweeps.matvec_sf = lambda *a, **k: sweeps._sf_matvec(*a, **k)
    torch.cuda.synchronize = lambda: None
    torch.cuda.empty_cache = lambda: None
    cs.fail = lambda msg: print(f"FAIL (continuing): {msg}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=16)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as dest:
        use_host(host_library(dest))
        dev = torch.device("cpu")
        for seed in range(args.seeds):
            gen = torch.Generator().manual_seed(seed)
            t0 = time.perf_counter()
            p = cs.cube_of(mt, cs.jc_material(mt, 70.0, "J2Log"), args.spans, dev,
                           dtype=torch.float32)
            u_el, a_el, w_el, state, _ = cs.finite_inputs(torch, sweeps, soa, p, gen)
            st = {k: v.clone() for k, v in state.items()}
            for e, stretch in ((0, 6.0), (1, 1e5)):
                st["Fp_inv"][..., e] = torch.diag(torch.tensor([stretch, 1.0, 1.0]))[:, :, None]
            cs.compare_kernels(torch, sweeps, p, u_el, a_el, w_el, st, cs.STEP_KW["dt"],
                               f"seed {seed} {args.spans}^3 J2Log mixed batch, host build")
            print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
