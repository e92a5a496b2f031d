#!/usr/bin/env python3
"""Time the sum-factorized residual, assemble and matvec kernels of this
checkout against another version of the same CUDA sources, on one CUDA
GPU, on the same inputs in one process.

    mkdir -p <dir>; git archive <rev> mimi_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_sf_sweeps.py --base <dir> [--part all|earlier|p4|finite|split[,...]]
        [--new <dir>[,<dir>...]] [--only REGEX]
    python3 scripts/ab_sf_sweeps.py --part wide

The base's sources (<dir>/mimi_tpu_torch/ops/csrc) are built at the sf
shapes (3, 4) and (4, 5) with the flags and shape defines of ops/build.py
into <dir>/_build (build_tree) and bound with its signatures, so their C
entry points and shape macros must match this checkout's.  Inputs at 48^3 elements
(cube-nurbs.mesh, p = 2): J2 Johnson-Cook near F = I (elastic), J2 on
random plastic input (chip_smoke.py phase 9's recipe; the viscous residual
and the viscous assemble with a bfloat16 block, the contact press's
variants, and the float32 assemble), the neo-Hookean material near F = I
(inviscid, and viscous with a bfloat16 block); every sf matvec instantiation
(cauchy, sym and full, inviscid and viscous, float32 and bfloat16 block)
on random w and random planes at p = 2 (48^3) and at p = 3 (the inviscid
float32 ones on path H's tables at 48^3, cube-nurbs-3.mesh; the viscous
and bfloat16 ones at 16^3) and path H's J2 residual and assemble near
F = I (48^3, p = 3): `--part earlier`.  With `--part p4` (or all) every p = 4
instantiation (SfShape<5, 6>) at path K's tables (cube-nurbs-3.mesh
elevated by 1, 40^3): the residual and assemble of every material x
storage (its own, and the full block of J2, J2Linear and the hyperelastic
materials) x viscous x block dtype on random input (the J2 family on a
random plastic history, chip_smoke.py phase 62's recipe; the
hyperelastic materials at strains of a few percent), and every matvec on
random w and random planes, each with its bound.

`--part finite` (or all): J2Simo's and J2Log's sf residual and assemble at
p = 2, 48^3: at path F's state (chip_smoke.py phase 50: the cube press
driven 1 warm + PRESS_F_TIMED steps on the base's kernels, the fields of
its next Newton system, press_state) the viscous residual and the viscous
assemble with a bfloat16 block; on the press law's random plastic history
(chip_smoke.py plastic_inputs, LAW_AMPLITUDE) the residual inviscid and
viscous and the assemble in every (viscous, block dtype) pair; on the
finite cubes' random plastic history (finite_inputs) the inviscid float32
residual and assemble; at p = 3 (SfShape<4, 5>, cube-nurbs-3.mesh at
24^3) on the press law's random plastic history the residual inviscid and
viscous and the assemble inviscid float32 and viscous bfloat16.  Each of these rows is also held against its plain
version (the 40-trip twin; the planes by chip_smoke.py planes_rel, the
yield-band points left out) and printed with its bound (chip_smoke.py
bound_of: bytes read and written once, the operations of sf_ops), and a
J2Log row says whether its sweep's deep log-series launch ran.

`--part split` (at (3, 4) only): path F's four rows and the press law's
random ones, on the base and on three copies of the base patched here
under <base>/_split: "nostore" (the 81 planes computed, not stored),
"nopass" (no tangent pass: the float pass, the interpolation and the sums
alone) and "nodeep" (J2Log's deep launch not made).  The assemble's time
splits into the float pass (nopass), the 9 tangent passes (nostore -
nopass), the plane stores (base - nostore) and the deep launch (base -
nodeep).

`--part wide` builds this checkout alone, at the two sf shapes whose axis
kernels take tiles of 8 elements (4 for the viscous residual and assemble)
(SfShape<5, 8>: p = 4 at quadrature order 14; SfShape<6, 7>: p = 5), and
holds every matvec instantiation there against matvec_sf_plain on random w
and planes (cube-nurbs-3.mesh elevated by 1 and 2, at 9^3 and 7^3: ragged
last tiles), with its CUDA-event time and bound, and every residual and
assemble instantiation against its plain version at chip_smoke.py's bars
(its hold_p3, phase 62's: each material, its own block and the full one,
the four (viscous, bfloat16) pairs, on random plastic input).

Every output of the versions is compared with the base's: the max abs
difference, relative to the output's max, and whether they are equal to
the bit.  The times are the medians of every call's CUDA events, taken
base, new, new, base (base, new 1, .., new n, new n, .., new 1, base with
several new versions).  `--new` names other trees (each a directory
holding mimi_tpu_torch/ops/csrc) to time against the base instead of this
checkout's sources, each built as the base is (with --part finite or
split alone, every version builds sweeps_sf_finite.cu alone, the one
source those rows launch).  Prints the card's name
and power limit first and ptxas's registers and spills of the sf kernels
of every version (chip_smoke.py phase 2's report; a spill is printed, not
raised).  `--only` keeps the rows whose name matches the regular
expression.
"""

import argparse
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


KEYS = [("sf", (3, 4)), ("sf", (4, 5))]
P4_KEYS = [("sf", (5, 6))]
WIDE_KEYS = [("sf", (5, 8)), ("sf", (6, 7))]
K_SPANS = 40  # path K: 40^3 elements at p = 4
P3_SPANS = 24  # --part finite's p = 3 rows
PARTS = ("all", "earlier", "p4", "finite", "split", "wide")
# --part split: the base's sources patched (file, text, replacement)
SPLIT = {
    "nostore": ("materials.cuh",
                "for (int a = 0; a < D2; ++a) store_c(cout + (a * D2 + b) * QE + qe, col[a]);",
                "for (int a = 0; a < D2; ++a)\n"
                "        if (col[a] == 1.0e-37f) store_c(cout + (a * D2 + b) * QE + qe, col[a]);"),
    "nopass": ("materials.cuh", "for (int b = 0; b < D2; ++b) {\n      float col[D2];",
               "for (int b = 0; b < 0; ++b) {\n      float col[D2];"),
    "nodeep": ("finite.cuh", "    m.deep = 1;\n    return fn(m);", "    return 0;"),
}


def use(kb, libs):
    """Make the wrappers launch the kernels of `libs` ({key: library})."""
    kb._LIBS.clear()
    kb._LIBS.update(libs)


def split_trees(base):
    """--part split: the base's csrc copied and patched (SPLIT) into
    <base>/_split/<name>; {name: tree}."""
    src = os.path.join(base, "mimi_tpu_torch", "ops", "csrc")
    trees = {}
    for name, (fname, old, new) in SPLIT.items():
        tree = os.path.join(base, "_split", name)
        dst = os.path.join(tree, "mimi_tpu_torch", "ops", "csrc")
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(src, dst)
        path = os.path.join(dst, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            sys.exit(f"--part split: the base's {fname} does not hold the text {old!r} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        trees[name] = tree
    return trees


class FiniteLib:
    """A library of sweeps_sf_finite.cu alone, bound as ops/build.py binds
    the "sf" kind: the other sources' entry points are absent, and binding
    them sets nothing that is called."""

    def __init__(self, so):
        import ctypes

        self._lib = ctypes.CDLL(so)

    def __getattr__(self, name):
        import types

        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def finite_tree(kb, csrc, out, keys):
    """build_tree of sweeps_sf_finite.cu alone (J2Simo's and J2Log's
    kernels and the full matvec: what --part finite and split launch):
    ({key: library}, compiler output)."""
    sources = kb.KIND_SOURCES
    kb.KIND_SOURCES = dict(sources, sf=("sweeps_sf_finite.cu",))
    try:
        queued = {k: kb._queue(k, csrc, os.path.join(out, f"lib_{k[0]}_{'_'.join(map(str, k[1]))}"
                                                          ".so"), kb.flags_of) for k in keys}
    finally:
        kb.KIND_SOURCES = sources
    libs, log = {}, ""
    for k, q in queued.items():
        so, info = kb._link(k, q)
        log += info["log"]
        libs[k] = kb.bind(FiniteLib(so), k[0])
    return libs, log


def event_ms(torch, fn, reps):
    """Each of `reps` calls of fn timed by its own CUDA events (ms), after
    a warm call."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for e0, e1 in evs:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return [e0.elapsed_time(e1) for e0, e1 in evs]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="directory holding the other version's "
                    "mimi_tpu_torch/ops/csrc (all but --part wide)")
    ap.add_argument("--new", default="", help="comma-separated directories holding the "
                    "versions timed against the base (default: this checkout)")
    ap.add_argument("--spans", type=int, default=48)
    ap.add_argument("--only", default="", help="time only the rows whose name matches")
    ap.add_argument("--part", default="all",
                    help="comma-separated of " + ", ".join(PARTS) + ": earlier, p = 2 and "
                    "p = 3 but J2Simo and J2Log; p4, the p = 4 kernels at path K's size; "
                    "finite, J2Simo's and J2Log's at p = 2; split, the base's finite "
                    "assembles split by patched copies; wide, the kernels at (5, 8) and "
                    "(6, 7) against plain")
    args = ap.parse_args()
    parts = set(args.part.split(","))
    if not parts <= set(PARTS):
        ap.error(f"--part takes {', '.join(PARTS)}")
    if "all" in parts:
        parts |= {"earlier", "p4", "finite"}
    if parts != {"wide"} and not args.base:
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
    from mimi_tpu_torch.parallel import sharding as sh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    kb.JOBS = os.cpu_count() or kb.JOBS  # nothing else runs beside the builds
    if parts == {"wide"}:
        return wide(torch, cs, mt, kb, sweeps, soa, t0)
    keys = [] if parts <= {"p4"} else [KEYS[0]] if parts == {"split"} else list(KEYS)
    keys += P4_KEYS if "p4" in parts else []
    base = os.path.abspath(args.base)
    trees = ({"base": base} | (split_trees(base) if "split" in parts else {})
             | {f"new:{os.path.basename(os.path.normpath(d))}": os.path.abspath(d)
                for d in args.new.split(",") if d})
    tags = list(trees)
    own = len(tags) == 1  # this checkout is the new version
    if own:
        kb.start(keys)
    # the finite rows launch the finite source's kernels alone
    tree_build = (lambda *a: finite_tree(kb, *a)) if parts <= {"finite", "split"} else kb.build_tree
    libs, logs = {}, {}
    for tag in tags:
        libs[tag], logs[tag] = tree_build(
            os.path.join(trees[tag], "mimi_tpu_torch", "ops", "csrc"),
            os.path.join(trees[tag], "_build" if tag == "base" else "_build_ab"), keys)
    if own:
        tags.append("new")
        libs["new"] = kb.prebuild(keys)
    print(f"builds {time.perf_counter() - t0:.1f} s; versions {tags}", flush=True)
    cs.fail = lambda msg: print(f"[2. ptxas] {msg}", flush=True)
    if own:
        cs.check_ptxas(kb, keys)
    for tag, log in logs.items():
        for name, v in sorted(cs.ptxas_entries(log, kb.nvcc()).items()):
            if "sf_tile_kernel" in name or "sf_axis_" in name or "sf_dealt_kernel" in name:
                print(f"[{tag} ptxas] {re.sub(r'[(](int|bool)[)]', '', name.split('>(')[0])}>: "
                      f"{v.get('registers')} registers, spill stores {v.get('spill_stores')} B",
                      flush=True)
    cs.fail = lambda msg: print(f"FAIL (printed, not raised): {msg}", flush=True)
    dev, gen, n = torch.device("cuda"), torch.Generator().manual_seed(0), args.spans
    news = tags[1:]
    order = ["base", *news, *news[::-1], "base"]

    def ab(label, calls, reps, margin=None, plain=None):
        """Each call of `calls` on every version: outputs compared with the
        base's, times taken in `order` (medians of every call's events).
        `margin()`: the points' distance from the yield surface
        (chip_smoke.py yield_margin), for the points whose planes differ by
        more than 1e-4 of the block's max.  `plain[name]`: (the plain
        version's outputs, a function of (outputs, plain outputs) that
        says how far they are apart), printed for every version."""
        for name, fn in calls.items():
            if not re.search(args.only, name):
                continue
            ref = None
            for tag in tags:
                use(kb, libs[tag])
                o = fn()
                out = [x.float() for x in (o if isinstance(o, tuple) else (o,))]
                torch.cuda.synchronize()
                if plain and name in plain:
                    print(f"[{label}] {name} {tag}: against plain {plain[name][1](o)}",
                          flush=True)
                if ref is None:
                    ref = out
                    continue
                pairs = list(zip(out, ref))
                diff = max(float((a - b).abs().max()) for a, b in pairs)
                rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                          for a, b in pairs)
                same = all(torch.equal(a, b) for a, b in pairs)
                print(f"[{label}] {name} {tag}: outputs differ from the base's by {diff:.3e} "
                      f"({rel:.2e} of their max), equal to the bit: {same}", flush=True)
                if margin is not None and len(pairs) == 2:
                    C, Cb = pairs[1]
                    off = (C - Cb).abs().amax(0) > 1e-4 * Cb.abs().max()
                    if bool(off.any()):
                        m = margin()[off]
                        print(f"[{label}] {name} {tag}: {int(off.sum())} points' planes differ "
                              f"by more than 1e-4 of the block's max; their plain trial state "
                              f"within {float(m.max()):.2e} of the flow stress "
                              f"({int((m <= cs.YIELD_BAND).sum())} within YIELD_BAND "
                              f"{cs.YIELD_BAND:.0e})", flush=True)
                del out, pairs
            del ref
            ts = {tag: [] for tag in tags}
            for tag in order:
                use(kb, libs[tag])
                ts[tag] += event_ms(torch, fn, reps)
            med = {tag: statistics.median(v) for tag, v in ts.items()}
            print(f"[{label}] {name}: median ms " + ", ".join(
                f"{tag} {med[tag]:.4f}" for tag in tags) + "; base / version " + ", ".join(
                f"{tag} {med['base'] / med[tag]:.2f}" for tag in news), flush=True)
        use(kb, libs[tags[-1]])
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

    def finite_rows(label, prob, f, dt, residual_viscs, combos, reps):
        """J2Simo's or J2Log's (the problem's material) residual for each
        viscous flag of residual_viscs and full assemble for each (viscous,
        bfloat16 block) of combos on the fields f, against the base and
        the plain version, with bounds; J2Log: whether the deep launch ran."""
        import dataclasses

        mat, key = prob.material, cs.table_key(prob)
        tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
        args_ = (f["u_el"], f["a_el"], f["state"], tabs, jinv, wq, mat, dt, float(mat.density))
        ops, st = cs.sf_ops(sweeps, dataclasses.replace(prob, material=mat)), cs.sf_struct(prob)
        n_pts = prob.n_el * prob.n_q
        calls, plains = {}, {}
        for visc in residual_viscs:
            vk = dict(v_el=f["v_el"], mu_v=cs.VISC_MU) if visc else {}
            name = sweeps.kernel_counters(mat, "sf", 3, key, visc)[0]
            calls[name] = lambda vk=vk: sweeps.residual_sf(*args_, **vk)
            y_p = cs.twin(sweeps.residual_sf_plain)(*args_, **vk)

            def far(y, y_p=y_p):
                err, scale = cs.masked_err(torch, y, y_p, "residual")
                return f"max|err| {err:.3e} of scale {scale:.3e} ({err / scale:.2e}; bar 1e-5)"
            plains[name] = (None, far)
            byts = cs.nbytes(f["u_el"], f["a_el"], f["v_el"] if visc else None, tabs, jinv, wq,
                             f["state"], f["u_el"])
            ms, by = cs.bound_of(byts, n_pts * (ops[0] + (st["viscous"] if visc else 0)))
            print(f"[{label}] {name}: {byts / 1e9:.4f} GB; bound {ms:.4f} ms by {by}",
                  flush=True)
        for visc, bf16 in combos:
            vk = dict(v_el=f["v_el"], mu_v=cs.VISC_MU) if visc else {}
            cd = torch.bfloat16 if bf16 else torch.float32
            name = sweeps.kernel_counters(mat, "sf", 3, key, visc, bf16, "full")[1]
            calls[name] = lambda vk=vk, cd=cd: sweeps.assemble_sf(*args_, **vk, c_dtype=cd,
                                                                  storage="full")
            y_p, C_p = cs.twin(sweeps.assemble_sf_plain)(*args_, **vk, c_dtype=torch.float32,
                                                         storage="full")
            C_p = C_p.to(cd)

            def far(o, y_p=y_p, C_p=C_p, bf16=bf16, name=name):
                err, scale = cs.masked_err(torch, o[0], y_p, "assemble residual")
                bar = 2.0**-7 if bf16 else 1e-4
                rel, dmax, note, _ = cs.planes_rel(torch, sweeps, prob, o[1], C_p, bar, args_,
                                                   name, mat, "full", witness=True)
                return (f"residual max|err| {err:.3e} of scale {scale:.3e} ({err / scale:.2e}; "
                        f"bar 1e-4); planes worst vs group max {rel:.3e} (bar {bar:.1e}), max "
                        f"|dC| {dmax:.3e}{note}")
            plains[name] = (None, far)
            byts = cs.nbytes(f["u_el"], f["a_el"], f["v_el"] if visc else None, tabs, jinv, wq,
                             f["state"], f["u_el"], C_p)
            ms, by = cs.bound_of(byts, n_pts * (ops[1] + (st["viscous"] if visc else 0)))
            print(f"[{label}] {name}: {byts / 1e9:.4f} GB; bound {ms:.4f} ms by {by}",
                  flush=True)
        if sweeps.kernel_tag(mat).startswith("log"):
            for name, fn in calls.items():
                use(kb, libs["base"])
                d0 = sweeps.logm_deep_sweeps()
                fn()
                print(f"[{label}] {name}: the deep log-series launch ran "
                      f"{sweeps.logm_deep_sweeps() - d0} time(s) in one sweep", flush=True)
        ab(label, calls, reps, plain=plains)
        del calls, plains
        torch.cuda.empty_cache()

    def finite_part(split):
        """--part finite (or, `split`, the rows of --part split)."""
        step_kw = dict(cs.PRESS_STEP_KW, matvec_dtype="bf16")
        dt = step_kw["dt"]
        press = cs.build_contact(mt, n, dev, "J2Simo")
        for name in sweeps.FULL_KERNELS:
            prob = cs.with_material(soa, press, cs.press_finite_material(mt, name))
            use(kb, libs["base"])
            carry, *_ = cs.drive_press(torch, mt, sweeps, prob, f"path F {n}^3 {name}",
                                       step_kw, cs.PRESS_F_TIMED, engaged_each=False)
            f = cs.press_state(torch, sh, prob, carry, dt, gen)
            del carry
            torch.cuda.empty_cache()
            finite_rows(f"path F {n}^3 {name} state", prob, f, dt, (True,), ((True, True),), 10)
            del f
            f, share = cs.plastic_inputs(torch, sweeps, soa, prob, prob.material, gen, dt,
                                         cs.LAW_AMPLITUDE)
            print(f"[press law random {n}^3 {name}] plastic share {share:.3f}", flush=True)
            finite_rows(f"press law random {n}^3 {name}", prob, f, dt,
                        (True,) if split else (False, True),
                        ((True, True),) if split else
                        ((False, False), (True, False), (True, True), (False, True)), 10)
            del f, prob
            torch.cuda.empty_cache()
        del press
        if split:
            return
        for name in sweeps.FULL_KERNELS:
            prob = cs.build(mt, n, dev, name=name)
            u_el, a_el, _, st, share = cs.finite_inputs(torch, sweeps, soa, prob, gen)
            print(f"[cube {n}^3 {name}] plastic share {share:.3f}", flush=True)
            finite_rows(f"cube {n}^3 {name}", prob, {"u_el": u_el, "a_el": a_el, "state": st},
                        cs.STEP_KW["dt"], (False,), ((False, False),), 10)
            del prob, u_el, a_el, st
            torch.cuda.empty_cache()
        for name in sweeps.FULL_KERNELS:
            prob = cs.cube3_of(mt, cs.press_finite_material(mt, name), P3_SPANS, dev)
            f, share = cs.plastic_inputs(torch, sweeps, soa, prob, prob.material, gen, dt,
                                         cs.LAW_AMPLITUDE)
            print(f"[p=3 press law random {P3_SPANS}^3 {name}] plastic share {share:.3f}",
                  flush=True)
            finite_rows(f"p=3 press law random {P3_SPANS}^3 {name}", prob, f, dt, (False, True),
                        ((False, False), (True, True)), 5)
            del f, prob
            torch.cuda.empty_cache()

    if "finite" in parts or "split" in parts:
        finite_part("finite" not in parts)
    if "p4" in parts:
        prob = cs.cube3_of(mt, cs.jc_material(mt), K_SPANS, dev, elevate=1)
        residuals(f"p=4 {K_SPANS}^3", prob, 3)
        matvecs(f"p=4 matvec {K_SPANS}^3", prob, combos, 10)
        del prob
        torch.cuda.empty_cache()
    if "earlier" not in parts:
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
