#!/usr/bin/env python3
"""Time the dense-table residual, assemble and matvec kernels of this
checkout against another version of the same CUDA sources, on one CUDA
GPU, on the same inputs in one process.

    mkdir -p <dir>; git archive <rev> mimi_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_dense_sweeps.py --base <dir> [--only REGEX]

The base's dense sources (<dir>/mimi_tpu_torch/ops/csrc) are built at
the dense shapes of chip_smoke.EARLIER_KEYS with this checkout's flags and shape
defines (ops/build.py build_tree: -fmad=false where NO_FMAD says) into
<dir>/_build and bound with this checkout's signatures, so its C entry
points and shape macros must match.  Every float32 dense instantiation
runs at each of those shapes: the 2D golden cantilever's mesh (balken.mesh) at p = 2
and p = 3, 2^--subdivide elements per axis; the two-patch cube at p = 2,
2 x --spans^3, and at p = 3, 2 x 8^3.  Each material's residual, its own
block's assemble and matvec, and the full block's assemble and matvec of
the materials with a stronger own storage, inviscid and viscous: J2
(Johnson-Cook) and J2Linear on a random plastic history, J2Simo and J2Log
on the same recipe, the neo-Hookean and St. Venant-Kirchhoff materials
near F = I (chip_smoke.py's plastic_inputs and random_visc_inputs).  Every
output of the two versions is compared: the max abs difference, relative
to the output's max, and whether they are equal to the bit; the times are
CUDA-event means, taken base, new, new, base.  Prints the card's name and
power limit first.  `--only` keeps the rows whose name matches the
regular expression.
"""

import argparse
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use(kb, libs):
    """Make the wrappers launch the kernels of `libs` ({key: library})."""
    kb._LIBS.clear()
    kb._LIBS.update(libs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="directory holding the other version's "
                    "mimi_tpu_torch/ops/csrc")
    ap.add_argument("--subdivide", type=int, default=8, help="2D: 2^subdivide spans per axis")
    ap.add_argument("--spans", type=int, default=16, help="3D p = 2: 2 x spans^3 elements")
    ap.add_argument("--only", default="", help="time only the rows whose name matches")
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
    keys = [k for k in cs.EARLIER_KEYS if k[0] == "dense"]
    libs = {"new": kb.prebuild(keys)}
    base = os.path.abspath(args.base)
    libs["base"], _ = kb.build_tree(os.path.join(base, "mimi_tpu_torch", "ops", "csrc"),
                                    os.path.join(base, "_build"), keys)
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    dev, gen, dt = torch.device("cuda"), torch.Generator().manual_seed(0), 0.05
    counts = {"rows": 0, "equal": 0}

    def ab(label, calls, reps):
        for name, fn in calls.items():
            if not re.search(args.only, name):
                continue
            outs = {}
            for tag in ("base", "new"):
                use(kb, libs[tag])
                o = fn()
                outs[tag] = [x.float() for x in (o if isinstance(o, tuple) else (o,))]
            torch.cuda.synchronize()
            pairs = list(zip(outs["new"], outs["base"]))
            diff = max(float((a - b).abs().max()) for a, b in pairs)
            rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                      for a, b in pairs)
            same = all(torch.equal(a, b) for a, b in pairs)
            counts["rows"] += 1
            counts["equal"] += int(same)
            del outs, pairs
            ts = []
            for tag in ("base", "new", "new", "base"):
                use(kb, libs[tag])
                ts.append(cs.cuda_ms(torch, fn, reps))
            print(f"[{label}] {name}: base {ts[0]:.4f} / {ts[3]:.4f} ms, new {ts[1]:.4f} / "
                  f"{ts[2]:.4f} ms, base / new {(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}; outputs "
                  f"differ by {diff:.3e} ({rel:.2e} of their max), equal to the bit: {same}",
                  flush=True)
        use(kb, libs["new"])
        torch.cuda.empty_cache()

    shapes = {
        (2, 2): lambda mat: cs.cantilever_of(mt, mat, 1, args.subdivide, dev),
        (2, 3): lambda mat: cs.cantilever_of(mt, mat, 2, args.subdivide, dev),
        (3, 2): lambda mat: cs.dense_build(mt, args.spans, dev),
        (3, 3): lambda mat: cs.two_patch3_of(mt, mat, cs.DENSE_CHECK_SPANS, dev),
    }
    for (dim, p), make in shapes.items():
        base_prob = None
        for mat in cs.kernel_materials(mt, dim):
            if base_prob is None:
                base_prob = make(mat)
            prob = cs.with_material(soa, base_prob, mat)
            tag = sweeps.kernel_tag(mat)
            if mat.has_state:
                amp = cs.J2LIN_AMPLITUDE if tag == "j2lin" else cs.LAW_AMPLITUDE
                f, share = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, amp)
            else:
                f, share = cs.random_visc_inputs(torch, sweeps, prob, mat, gen, dt), 0.0
            dN, N, wq = prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t
            rho, own = float(mat.density), sweeps.tangent_storage(mat)
            a = (f["u_el"], f["a_el"], f["state"], dN, N, wq, mat, dt, rho)
            label = f"({dim}, {p}) {prob.n_el} elements {tag}, plastic share {share:.3f}"
            calls = {}
            for visc in (False, True):
                vk = dict(v_el=f["v_el"], mu_v=100.0) if visc else {}
                fm = 5.0 if visc else None
                names = sweeps.kernel_counters(mat, "dense", dim, p, visc)
                calls[names[0]] = lambda vk=vk: sweeps.residual_dense(*a, **vk)
                for storage in dict.fromkeys((own, "full")):
                    names = sweeps.kernel_counters(mat, "dense", dim, p, visc, storage=storage)
                    calls[names[1]] = (lambda vk=vk, s=storage:
                                       sweeps.assemble_dense(*a, **vk, storage=s))
                    C = sweeps.assemble_dense(*a, storage=storage)[1]
                    mv = sweeps.matvec_counter("dense", storage, dim, p, visc)
                    calls.setdefault(mv, lambda C=C, s=storage, fm=fm: sweeps.matvec_dense(
                        f["w_el"], dN, N, wq, C, rho, 1e-3, fm, storage=s))
            ab(label, calls, 10 if dim == 3 and p == 2 else 20)
            del f, a, calls, prob
            torch.cuda.empty_cache()
        del base_prob
        torch.cuda.empty_cache()
    print(f"{counts['equal']} of {counts['rows']} rows equal to the bit", flush=True)


if __name__ == "__main__":
    main()
