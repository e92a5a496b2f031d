#!/usr/bin/env python3
"""Time the sum-factorized residual, assemble and matvec kernels of this
checkout against another version of the same CUDA sources, on one CUDA
GPU, on the same inputs in one process.

    mkdir -p <dir>; git archive <rev> mimi_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_sf_sweeps.py --base <dir> [--part all|earlier|p4] [--only REGEX]
    python3 scripts/ab_sf_sweeps.py --part wide

The base's sources (<dir>/mimi_tpu_torch/ops/csrc) are built at the sf
shapes (3, 4) and (4, 5) with the flags and shape defines of ops/build.py
into <dir>/_build (build_tree) and bound with its signatures, so their C
entry points and shape macros must match this checkout's.  Inputs at 48^3 elements
(cube-nurbs.mesh, p = 2): J2 Johnson-Cook near F = I (elastic), J2 on
random plastic input (chip_smoke.py phase 9's recipe; the viscous residual
and the viscous assemble with a bfloat16 block, the contact press's
variants, and the float32 assemble), the neo-Hookean material near F = I
(inviscid, and viscous with a bfloat16 block), J2Simo and J2Log on
chip_smoke.py's random plastic history; every sf matvec instantiation
(cauchy, sym and full, inviscid and viscous, float32 and bfloat16 block)
on random w and random planes at p = 2 (48^3) and at p = 3 (the inviscid
float32 ones on path H's tables at 48^3, cube-nurbs-3.mesh; the viscous
and bfloat16 ones at 16^3) and path H's J2 residual and assemble near
F = I (48^3, p = 3); with `--part p4` (or all) every p = 4
instantiation (SfShape<5, 6>) at path K's tables (cube-nurbs-3.mesh
elevated by 1, 40^3): the residual and assemble of every material x
storage (its own, and the full block of J2, J2Linear and the hyperelastic
materials) x viscous x block dtype on random input (the J2 family on a
random plastic history, chip_smoke.py phase 62's recipe; the
hyperelastic materials at strains of a few percent), and every matvec on
random w and random planes, each with its bound.  `--part wide` builds
this checkout alone, at the two sf shapes whose axis kernels take tiles
of 8 elements (4 for the viscous residual and assemble) (SfShape<5, 8>:
p = 4 at quadrature order 14; SfShape<6, 7>: p = 5), and holds every
matvec instantiation there against matvec_sf_plain on random w and planes
(cube-nurbs-3.mesh elevated by 1 and 2, at 9^3 and 7^3: ragged last
tiles), with its CUDA-event time and bound, and every residual and
assemble instantiation against its plain version at chip_smoke.py's bars
(its hold_p3, phase 62's: each material, its own block and the full one,
the four (viscous, bfloat16) pairs, on random plastic input).  Every
output of
the two versions is compared: the max abs difference, relative to the
output's max, and whether they are equal to the bit.  The times are CUDA-event means,
taken base, new, new, base.  Prints the card's name and power limit
first and ptxas's registers and spills of the sf kernels of both
versions (chip_smoke.py phase 2's report; a spill is printed, not raised).
`--only` keeps the rows whose name matches the regular expression.
"""

import argparse
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


KEYS = [("sf", (3, 4)), ("sf", (4, 5))]
P4_KEYS = [("sf", (5, 6))]
WIDE_KEYS = [("sf", (5, 8)), ("sf", (6, 7))]
K_SPANS = 40  # path K: 40^3 elements at p = 4


def use(kb, libs):
    """Make the wrappers launch the kernels of `libs` ({key: library})."""
    kb._LIBS.clear()
    kb._LIBS.update(libs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="directory holding the other version's "
                    "mimi_tpu_torch/ops/csrc (all but --part wide)")
    ap.add_argument("--spans", type=int, default=48)
    ap.add_argument("--only", default="", help="time only the rows whose name matches")
    ap.add_argument("--part", choices=("all", "earlier", "p4", "wide"), default="all",
                    help="earlier: p = 2 and p = 3; p4: the p = 4 kernels at path K's size; "
                    "wide: the kernels at (5, 8) and (6, 7) against plain")
    args = ap.parse_args()
    if args.part != "wide" and not args.base:
        ap.error("--base is needed but with --part wide")
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
    kb.JOBS = os.cpu_count() or kb.JOBS  # nothing else runs beside the builds
    if args.part == "wide":
        return wide(torch, cs, mt, kb, sweeps, soa, t0)
    keys = (KEYS if args.part != "p4" else []) + (P4_KEYS if args.part != "earlier" else [])
    kb.start(keys)
    base = os.path.abspath(args.base)
    libs = {}
    libs["base"], base_log = kb.build_tree(os.path.join(base, "mimi_tpu_torch", "ops", "csrc"),
                                           os.path.join(base, "_build"), keys)
    libs["new"] = kb.prebuild(keys)
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    cs.fail = lambda msg: print(f"[2. ptxas] {msg}", flush=True)
    cs.check_ptxas(kb, keys)
    for name, v in sorted(cs.ptxas_entries(base_log, kb.nvcc()).items()):
        if "sf_tile_kernel" in name or "sf_axis_" in name:
            print(f"[base ptxas] {re.sub(r'[(](int|bool)[)]', '', name.split('>(')[0])}>: "
                  f"{v.get('registers')} registers, spill stores {v.get('spill_stores')} B",
                  flush=True)
    dev, gen, n = torch.device("cuda"), torch.Generator().manual_seed(0), args.spans

    def ab(label, calls, reps, margin=None):
        """Each call of `calls` on both versions: outputs compared, times
        base, new, new, base.  `margin()`: the points' distance from the
        yield surface (chip_smoke.py yield_margin), for the points whose
        planes differ by more than 1e-4 of the block's max."""
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
            if margin is not None and len(pairs) == 2:
                C, Cb = pairs[1]
                off = (C - Cb).abs().amax(0) > 1e-4 * Cb.abs().max()
                if bool(off.any()):
                    m = margin()[off]
                    print(f"[{label}] {name}: {int(off.sum())} points' planes differ by more "
                          f"than 1e-4 of the block's max; their plain trial state within "
                          f"{float(m.max()):.2e} of the flow stress ({int((m <= cs.YIELD_BAND).sum())}"
                          f" within YIELD_BAND {cs.YIELD_BAND:.0e})", flush=True)
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

    def matvecs(label, prob, combos, reps):
        """The sf matvec of each (storage, viscous, bfloat16) in combos on
        prob's tables, random w and random planes."""
        E, nd = prob.n_el, prob.sf["pp1"] ** 3
        tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
        w_el = torch.randn(3, nd, E, generator=gen).to(dev)
        calls = {}
        for storage, visc, bf16 in combos:
            C = torch.randn(sweeps.n_planes(storage), prob.n_q, E, generator=gen).to(dev)
            C = C.to(torch.bfloat16) if bf16 else C
            name = sweeps.matvec_counter("sf", storage, 3, prob.sf["pp1"] - 1, visc, bf16)
            # inputs read once, the output written once (bytes bound the matvec)
            ms, _ = cs.bound_of(cs.nbytes(w_el, tabs, jinv, wq, C, w_el), 0)
            print(f"[{label}] {name}: bound {ms:.4f} ms by bytes", flush=True)
            calls[name] = (lambda C=C, storage=storage, fm=(50.0 if visc else None):
                           sweeps.matvec_sf(w_el, tabs, jinv, wq, C, 1e2, 1e-3, fm, storage))
        ab(label, calls, reps)

    combos = [(storage, visc, bf16) for storage in ("cauchy", "sym", "full")
              for visc in (False, True) for bf16 in (False, True)]

    def residuals(label, prob, reps):
        """The residual and assemble of J2 near F = I (path K's state is
        elastic) and of every material (chip_smoke.py kernel_materials) on
        random input (the J2 family plastic) on prob's tables: its own
        block and (J2, J2Linear, the hyperelastic materials) the full one,
        each (viscous, bfloat16 block); the residual inviscid and
        viscous."""
        if not re.search(args.only, "residual_sf assemble_sf"):
            return
        dt, tabs, jinv, wq = 0.05, prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
        cases = [("j2 elastic", cs.kernel_materials(mt)[0])]
        cases += [(sweeps.kernel_tag(m), m) for m in cs.kernel_materials(mt)]
        for tag, mat in cases:
            if tag == "j2 elastic":
                f, share = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, 1e-4)
            elif mat.has_state:
                amp = 0.2 * (cs.J2LIN_AMPLITUDE / cs.LAW_AMPLITUDE if tag == "j2lin" else 1.0)
                f, share = cs.plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, amp)
            else:
                f, share = cs.random_visc_inputs(torch, sweeps, prob, mat, gen, dt), 0.0
            own = sweeps.tangent_storage(mat)
            a = (f["u_el"], f["a_el"], f["state"], tabs, jinv, wq, mat, dt, float(mat.density))
            vk = dict(v_el=f["v_el"], mu_v=cs.VISC_MU)
            calls = {}
            for visc in (False, True):
                k = vk if visc else {}
                calls[f"residual_sf[{tag}{',visc' if visc else ''}]"] = (
                    lambda k=k: sweeps.residual_sf(*a, **k))
            for storage in (own,) if own == "full" or tag == "j2 elastic" else (own, "full"):
                for visc in (False, True):
                    for bf16 in (False, True):
                        k = dict(vk if visc else {}, storage=storage,
                                 c_dtype=torch.bfloat16 if bf16 else torch.float32)
                        name = (f"assemble_sf[{tag},{storage}{',visc' if visc else ''}"
                                f"{',bf16' if bf16 else ''}]")
                        calls[name] = lambda k=k: sweeps.assemble_sf(*a, **k)
            # inputs read once, the outputs written once (bound_of); the
            # operations are the point's (chip_smoke.py sf_ops), not counted here
            ms, _ = cs.bound_of(cs.nbytes(f["u_el"], f["a_el"], f["state"], tabs, jinv, wq,
                                          f["u_el"]), 0)
            print(f"[{label} {tag}] {prob.n_el} elements, plastic share {share:.3f}; the "
                  f"residual's bound by bytes {ms:.4f} ms", flush=True)
            margin = ((lambda: cs.yield_margin(torch, sweeps, prob, f["u_el"], f["state"],
                                               mat=mat)) if mat.has_state else None)
            ab(f"{label} {tag}", calls, reps, margin)
            del f, a, vk, calls, margin
            torch.cuda.empty_cache()

    if args.part != "earlier":
        prob = cs.cube3_of(mt, cs.jc_material(mt), K_SPANS, dev, elevate=1)
        residuals(f"p=4 {K_SPANS}^3", prob, 3)
        matvecs(f"p=4 matvec {K_SPANS}^3", prob, combos, 10)
        del prob
        torch.cuda.empty_cache()
    if args.part == "p4":
        return
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
    prob = cs.build(mt, n, dev)
    matvecs("p=2 matvec", prob, combos, 20)
    del prob
    mat = cs.jc_material(mt)
    prob = cs.cube3_of(mt, mat, n, dev)
    tabs, jinv, wq, E = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.n_el
    u_el = 1e-3 * h * rnd(3, 64, E)
    a = (u_el, rnd(3, 64, E), {k: v.clone() for k, v in prob.state0.items()}, tabs, jinv, wq,
         mat, 0.05, 1.0)
    ab("J2 p=3 elastic", {"residual_sf@3d_p3": lambda: sweeps.residual_sf(*a),
                          "assemble_sf@3d_p3": lambda: sweeps.assemble_sf(*a)}, 5)
    del a, u_el, tabs, jinv, wq
    matvecs("p=3 matvec", prob, [c for c in combos if not (c[1] or c[2])], 5)
    del prob
    prob = cs.cube3_of(mt, mat, 16, dev)
    matvecs("p=3 matvec 16^3", prob, [c for c in combos if c[1] or c[2]], 20)


def wide(torch, cs, mt, kb, sweeps, soa, t0):
    """--part wide: every sf matvec instantiation at WIDE_KEYS against
    matvec_sf_plain at 1e-5 of the output's max, and its time; every
    residual and assemble instantiation against plain (chip_smoke.py
    hold_p3)."""
    kb.start(WIDE_KEYS)
    kb.prebuild(WIDE_KEYS)
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    cs.fail = lambda msg: print(f"[2. ptxas] {msg}", flush=True)
    cs.check_ptxas(kb, WIDE_KEYS)
    dev, gen, bad = torch.device("cuda"), torch.Generator().manual_seed(0), []
    for elevate, order, spans in ((1, 14, 9), (2, -1, 7)):
        prob = mt.build_problem(cs.MESH3, elevate, 0, cs.jc_material(mt),
                                [(1, 0), (1, 1), (1, 2)], {1: -3.0}, rho_inf=0.5, device=dev,
                                refine_spans=spans, quadrature_order=order)
        key = cs.table_key(prob)
        E, nd = prob.n_el, prob.sf["pp1"] ** 3
        tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
        w_el = torch.randn(3, nd, E, generator=gen).to(dev)
        for storage in ("cauchy", "sym", "full"):
            for visc in (False, True):
                for bf16 in (False, True):
                    C = torch.randn(sweeps.n_planes(storage), prob.n_q, E, generator=gen).to(dev)
                    C = C.to(torch.bfloat16) if bf16 else C
                    a = (w_el, tabs, jinv, wq, C, 1e2, 1e-3, 50.0 if visc else None, storage)
                    y_k = sweeps.matvec_sf(*a)
                    y_p = sweeps.matvec_sf_plain(*a[:-1], storage=storage)
                    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
                    ms = cs.cuda_ms(torch, lambda a=a: sweeps.matvec_sf(*a), 20)
                    bound, _ = cs.bound_of(cs.nbytes(w_el, tabs, jinv, wq, C, w_el), 0)
                    name = sweeps.matvec_counter("sf", storage, 3, key, visc, bf16)
                    ok = err <= 1e-5 * scale
                    bad += [] if ok else [name]
                    print(f"[wide {key} {E} elements] {name}: {ms:.4f} ms, bound {bound:.4f} ms "
                          f"by bytes; vs plain max|err| {err:.3e} of scale {scale:.3e} "
                          f"({err / scale:.2e}, bar 1e-5): {'ok' if ok else 'FAIL'}", flush=True)
        del w_el, tabs, jinv, wq
        # the residual and assemble of every material and storage, each
        # (viscous, bfloat16) pair, against plain at the smoke's bars
        failed = []
        cs.fail = failed.append
        cs.hold_p3(torch, mt, sweeps, soa, prob, [(False, False), (False, True), (True, False),
                                                  (True, True)],
                   f"wide {key} {E} elements", gen, amplitude=0.2)
        for msg in failed:
            print(f"[wide {key}] FAIL {msg}", flush=True)
        bad += failed
        cs.fail = lambda msg: print(f"[2. ptxas] {msg}", flush=True)
        del prob
        torch.cuda.empty_cache()
    print(f"wide: {'every kernel within its bar' if not bad else f'FAIL {bad}'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
