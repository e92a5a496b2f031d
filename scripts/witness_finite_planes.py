#!/usr/bin/env python3
"""Hold the J2Simo and J2Log full-block assembles (viscous, float32 block)
against their plain versions in float32 and in float64, on one CUDA GPU,
on random plastic input of the contact press's law (Johnson-Cook A 700,
B 1400, E 1e6, viscosity 100; chip_smoke.py plastic_inputs, |F - I| up to
0.1 per element).

    python3 scripts/witness_finite_planes.py [--seeds 0 1]

The kernels run twice: every source built with ops/build.py's FLAGS (nvcc
contracts products and sums into fused multiply-adds) into ops/_build/fma/,
and with `-fmad=false` (each product and sum rounded on its own, as the
plain version's separate torch operations round them) into
ops/_build/nofma/.  For each case and seed it prints the planes'
worst error against their group's max (chip_smoke.py group_err, every
point in) of each kernel build against the plain float32 twin
(materials.kernel_solver_mode) and against the plain version in float64,
and of the plain float32 twin against float64; the points where a kernel
is more than 1e-4 of the block's max from the plain twin, with their
distance from the yield surface (chip_smoke.py yield_margin) and their
errors against float64; and each build's CUDA-event time.  Cases: dense
(2, 3) at 512^2 (the golden cantilever's mesh, p = 3) J2Log and J2Simo,
dense (2, 2) at 2 x 512^2 (the two-patch press's mesh) J2Log, sf at 48^3
J2Log.  Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_lib(kb, tag, extra, keys):
    """The kernel sources built at `keys` with ops/build.py's FLAGS +
    `extra` into ops/_build/<tag>/ (build_tree): {key: library}."""
    return kb.build_tree(kb.CSRC, os.path.join(kb.BUILD_DIR, tag), keys,
                         lambda src: kb.FLAGS + extra)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mimi_tpu_torch as mt
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.materials import kernel_solver_mode
    from mimi_tpu_torch.ops import build as kb
    from mimi_tpu_torch.ops import sweeps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    keys = [("dense", (2, 16, 25)), ("dense", (2, 9, 16)), ("sf", (3, 4))]
    libs = {"fma": build_lib(kb, "fma", [], keys),
            "nofma": build_lib(kb, "nofma", ["-fmad=false"], keys)}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    mesh = {
        "(2, 3) 512^2": lambda mat: cs.cantilever_of(mt, mat, 2, cs.GOLDEN_SUBDIVIDE, dev),
        "(2, 2) 2x512^2": lambda mat: cs.press_build(mt, 2, cs.PRESS_2D_SUBDIVIDE, dev, mat=mat),
        "sf 48^3": lambda mat: cs.build(mt, cs.SPANS, dev, name=mat.name()),
    }
    cases = [("(2, 3) 512^2", "J2Log", args.seeds), ("(2, 3) 512^2", "J2Simo", args.seeds[:1]),
             ("(2, 2) 2x512^2", "J2Log", args.seeds[:1]), ("sf 48^3", "J2Log", args.seeds[:1])]
    for where, name, seeds in cases:
        prob = mesh[where](cs.press_finite_material(mt, name))
        mat = cs.press_finite_material(mt, name)
        mat.setup(prob.dim)
        dt = cs.PRESS_STEP_KW["dt"]
        tables = ((prob.sf["tables"], prob.sf["jinv"]) if prob.sf is not None
                  else (prob.dense["dN_t"], prob.dense["N_t"]))
        kern = sweeps.assemble_sf if prob.sf is not None else sweeps.assemble_dense
        plain = sweeps.assemble_sf_plain if prob.sf is not None else sweeps.assemble_dense_plain
        groups = cs.plane_groups(sweeps, "full", prob.dim)
        for seed in seeds:
            gen = torch.Generator().manual_seed(seed)
            f, share = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, cs.LAW_AMPLITUDE)
            a = (f["u_el"], f["a_el"], f["state"], *tables, prob.wdet_t, mat, dt,
                 float(mat.density))
            vk = dict(v_el=f["v_el"], mu_v=float(mat.viscosity))
            label = f"{where} {name} seed {seed}"
            with kernel_solver_mode():
                _, C_p = plain(*a, **vk)
                _, C64 = plain(*cs.as_f64(torch, a), **cs.as_f64(torch, vk),
                               c_dtype=torch.float64)
            bmax = float(C_p.abs().max())
            margin = cs.yield_margin(torch, sweeps, prob, f["u_el"], f["state"], tables, mat)
            p64 = torch.nan_to_num((C_p.double() - C64).abs()).amax(0) / bmax
            print(f"[{label}] plastic share {share:.4f}, points {p64.numel()}; plain float32 vs "
                  f"float64 {cs.group_err(torch, C_p, C64, groups):.3e} of the group max",
                  flush=True)
            for tag, lib in libs.items():
                kb._LIBS.clear()
                kb._LIBS.update(lib)
                _, C_k = kern(*a, **vk)
                torch.cuda.synchronize()
                ms = cs.cuda_ms(torch, lambda: kern(*a, **vk), 10)
                kp = torch.nan_to_num((C_k.double() - C_p.double()).abs()).amax(0) / bmax
                k64 = torch.nan_to_num((C_k.double() - C64).abs()).amax(0) / bmax
                off = kp > 1e-4
                line = (f"[{label}] {tag}: {ms:.4f} ms; kernel vs plain float32 "
                        f"{cs.group_err(torch, C_k, C_p.double(), groups):.3e}, vs float64 "
                        f"{cs.group_err(torch, C_k, C64, groups):.3e} of the group max; points "
                        f"past 1e-4 of the block max from the plain twin {int(off.sum())}")
                if bool(off.any()):
                    line += (f", yield margin {float(margin[off].min()):.3e} to "
                             f"{float(margin[off].max()):.3e}; there kernel vs float64 to "
                             f"{float(k64[off].max()):.3e}, plain vs float64 to "
                             f"{float(p64[off].max()):.3e} of the block max")
                print(line, flush=True)
                del C_k, kp, k64, off
            del f, a, vk, C_p, C64, margin, p64
            torch.cuda.empty_cache()
        del prob
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
