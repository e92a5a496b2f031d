#!/usr/bin/env python3
"""Time the dense-table residual, assemble and matvec kernels of this
checkout against another version of the same CUDA sources, on one CUDA
GPU, on the same inputs in one process.

    mkdir -p <dir>; git archive <rev> mimi_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_dense_sweeps.py --base <dir> [--new <dir>] \
        [--part all|earlier|tiled|finite|residual|hyper|untiled[,...]] [--only REGEX]

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
near F = I (chip_smoke.py's plastic_inputs and random_visc_inputs).
`--part tiled` times the tiled matvec (every storage, inviscid and
viscous, float32 or bfloat16 block and tables) on random w and random
planes at the driven sizes instead (`all`: both): path I's tables (3, 64, 125), the
two-patch cube elevated by 2 at 2 x 38^3; path L's (2, 25, 36), the
cantilever elevated by 3 at 512^2; and (3, 125, 216), elevated by 3 at
2 x 16^3, each storage with its bound by bytes; ptxas's registers and
spills of both versions' tiled matvecs are printed first.  `--part finite`
times J2Simo's and J2Log's dense residual and assemble (inviscid and
viscous, float32 and bfloat16 block) at the finite-strain drives' shapes
and sizes on random plastic input (chip_smoke.dense_finite_inputs): (3, 27,
64) at 2 x 38^3 (the 3D dense cells; also on elastic input, |F - I| up to
1e-3, as the cells' path states are) and (2, 16, 25) at 512^2 (the golden
cantilevers) with the golden law, (2, 9, 16) at 128^2 (the p = 2 drives)
with the golden law and at 2 x 512^2 with path G's press law (its size and
law, random input, not its state), each with its bound, after both
versions' ptxas lines of the finite kernels (`all` does not include it).
`--part residual` times the dense residual and assemble at the driven
rows, each at its path's state (the predictor fields after 1 warm + 1
step of the path's own settings, driven on this checkout's kernels): path
I (neo-Hookean `sym`, (3, 64, 125), 2 x 38^3) and path L ((2, 25, 36),
512^2); the golden J2 cantilever at 512^2 (2, 16, 25) and at 128^2 p = 2;
path J's float32 residual and bfloat16 assemble ((3, 27, 64), 48^3); 3D
dense J2 at 2 x 38^3; and J2 and J2Linear (inviscid and viscous, their
own and the full block) on random plastic input at the J2 rows' sizes
(chip_smoke.py's plastic_inputs) (`all` does not include it).
`--part hyper` times the neo-Hookean residual and assemble at the
untiled driven rows (the golden twin at 512^2, 128^2 p = 2, the 3D cell
at 2 x 38^3 and path A's viscous 2 x 512^2 at p = 2) on random input near
F = I, for a variant given with --new.  In both, each output is held
against the plain version too, on the first RESIDUAL_HEAD elements (the
plain versions of path I's size do not fit the card whole), and both
versions' ptxas lines of the dense residual kernels are printed.
`--part untiled` times the fused neo-Hookean tangent apply at every
shape of FUSED_ROWS (the 3D dense cell's (3, 27, 64) at 2 x 38^3, the
tiled (3, 64, 125), (3, 125, 216) and (2, 25, 36), the untiled 2D
(2, 16, 25) and (2, 9, 16)) on random input near F = I, and 3D J2's
residual and assemble at (3, 27, 64): the residual part's rows of path J
and the 3D dense J2 cell (their path states, and J2 and J2Linear on random
plastic input at the cell's size); both versions' ptxas lines of those
kernels are printed (`all` does not include it).
Parts join with commas (`residual,finite`: one build of both versions);
`--paths REGEX` drives only the residual part's paths whose label matches
(RESIDUAL_PATHS), and builds only their shapes.
`--new <dir>` builds that tree's sources in place of this checkout's for
the "new" side (a variant made in a scratch copy), with the same flags.
Every output of the two versions is compared: the max
abs difference, relative to the output's max, and whether they are equal
to the bit; the times are CUDA-event means, taken base, new, new, base,
and with --part residual or hyper the median of every call's own events.
Prints the card's name and power limit first.  `--only` keeps the rows
whose name matches the regular expression.
"""

import argparse
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the tiled shapes and their driven sizes: path I's (3, 64, 125) at
# 2 x 38^3, path L's (2, 25, 36) at 512^2, (3, 125, 216) at 2 x 16^3
TILED_KEYS = [("dense", (3, 64, 125)), ("dense", (2, 25, 36)), ("dense", (3, 125, 216))]


def tiled_matvecs(torch, mt, cs, sweeps, ab, dev, gen):
    """The tiled dense matvec of every storage, inviscid and viscous, with
    a float32 block and tables or a bfloat16 block and bfloat16 copies of
    dN and N, on random w and random planes at each shape's driven size."""
    hyper = cs.hyper_material(mt)
    makers = {
        (3, 64, 125): lambda: cs.two_patch3_of(mt, hyper, cs.DENSE_SPANS, dev),
        (2, 25, 36): lambda: cs.balken_build(mt, "CompressibleOgdenNeoHookean", 3,
                                             cs.GOLDEN_SUBDIVIDE, dev),
        (3, 125, 216): lambda: cs.two_patch3_of(mt, hyper, 16, dev, elevate=3),
    }
    for key, make in makers.items():
        prob = make()
        E, dim, nd = prob.n_el, prob.dim, key[1]
        w_el = torch.randn(dim, nd, E, generator=gen).to(dev)
        for bf16 in (False, True):
            ct = torch.bfloat16 if bf16 else torch.float32
            dN, N = prob.dense["dN_t"].to(ct), prob.dense["N_t"].to(ct)
            for storage in ("sym", "cauchy", "full"):
                C = torch.randn(sweeps.n_planes(storage, dim), prob.n_q, E,
                                generator=gen).to(dev, ct)
                calls = {}
                # inputs read once, the output written once (bytes bound the matvec)
                ms, _ = cs.bound_of(cs.nbytes(w_el, dN, N, prob.wdet_t, C, w_el), 0)
                print(f"[tiled {key} {E} elements] {storage}{',bf16' if bf16 else ''}: "
                      f"bound {ms:.4f} ms by bytes", flush=True)
                for visc in (False, True):
                    name = sweeps.matvec_counter("dense", storage, dim, key, visc, bf16)
                    calls[name] = (lambda C=C, s=storage, fm=(5.0 if visc else None):
                                   sweeps.matvec_dense(w_el, dN, N, prob.wdet_t, C, 1e2, 1e-3,
                                                       fm, storage=s))
                ab(f"tiled {key} {E} elements", calls, 10 if key == (3, 64, 125) else 20)
                del C, calls
            del dN, N
        del prob, w_el
        torch.cuda.empty_cache()


# the dense finite-strain shapes (--part finite)
FINITE_KEYS = [("dense", (3, 27, 64)), ("dense", (2, 16, 25)), ("dense", (2, 9, 16))]


def finite_sweeps(torch, mt, cs, sweeps, soa, ab, dev, gen):
    """J2Simo's and J2Log's dense residual and assemble, inviscid and
    viscous, with a float32 or bfloat16 block, at the finite-strain drives'
    shapes and sizes, on random plastic input, with each call's bound (the
    kernels line's count: inputs read once, outputs written once, the
    operations of chip_smoke.dense_ops)."""
    dt = 0.05
    cube = lambda name: cs.dense_build(mt, cs.DENSE_SPANS, dev, name)  # noqa: E731
    cases = [  # (label, problem, |F - I| of the input: 0.2 plastic, 1e-3 elastic)
        ("2x38^3 golden law", cube, 0.2),
        ("2x38^3 golden law, elastic", cube, 1e-3),
        ("512^2 golden law", lambda name: cs.balken_build(mt, name, 2, cs.GOLDEN_SUBDIVIDE, dev),
         0.2),
        ("128^2 golden law", lambda name: cs.balken_build(mt, name, 1, cs.P2_SUBDIVIDE, dev), 0.2),
        ("2x512^2 press law (path G)", lambda name: cs.press_build(
            mt, 2, cs.PRESS_2D_SUBDIVIDE, dev, mat=cs.press_finite_material(mt, name)), 0.2),
    ]
    for size, make, amplitude in cases:
        for name in sweeps.FULL_KERNELS:
            prob = make(name)
            mat, dN, N, wq = prob.material, prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t
            key = cs.table_key(prob)
            u_el, a_el, v_el, state, share = cs.dense_finite_inputs(torch, sweeps, soa, prob,
                                                                    gen, dt, amplitude)
            deep = cs.deep_points(torch, sweeps, soa, prob, u_el, state) if name == "J2Log" else 0
            rho = float(mat.density)
            a = (u_el, a_el, state, dN, N, wq, mat, dt, rho)
            ops = cs.dense_ops(sweeps, prob)
            n_pts, el = prob.n_el * prob.n_q, cs.nbytes(u_el)
            label = (f"finite {cs.table_key(prob)} {size} {prob.n_el} elements {name}, plastic "
                     f"share {share:.3f}, points past the fast log range {deep}")
            calls = {}
            for visc in (False, True):
                vk = dict(v_el=v_el, mu_v=100.0) if visc else {}
                vb = cs.nbytes(v_el) if visc else 0
                names = sweeps.kernel_counters(mat, "dense", prob.dim, key, visc)
                calls[names[0]] = lambda vk=vk: sweeps.residual_dense(*a, **vk)
                ms, by = cs.bound_of(cs.nbytes(*a[:6]) + vb + el, n_pts * ops[0])
                print(f"[{label}] {names[0]}: bound {ms:.4f} ms by {by}", flush=True)
                for bf16 in (False, True):
                    ct = torch.bfloat16 if bf16 else torch.float32
                    names = sweeps.kernel_counters(mat, "dense", prob.dim, key, visc, bf16)
                    calls[names[1]] = (lambda vk=vk, ct=ct:
                                       sweeps.assemble_dense(*a, **vk, c_dtype=ct))
                    planes = sweeps.n_planes("full", prob.dim) * n_pts * (2 if bf16 else 4)
                    ms, by = cs.bound_of(cs.nbytes(*a[:6]) + vb + el + planes, n_pts * ops[1])
                    print(f"[{label}] {names[1]}: bound {ms:.4f} ms by {by}", flush=True)
            ab(label, calls, 5 if prob.dim == 3 or prob.n_el > 300000 else 10)
            del u_el, a_el, v_el, state, a, calls, prob
            torch.cuda.empty_cache()


# the driven paths of the dense residual and assemble (--part residual) and
# their tables' shapes
RESIDUAL_PATHS = {"path I 2x38^3": (3, 64, 125), "path L 512^2": (2, 25, 36),
                  "golden J2 512^2": (2, 16, 25), "J2 128^2 p=2": (2, 9, 16),
                  "path J 48^3": (3, 27, 64), "3D dense J2 2x38^3": (3, 27, 64)}
# elements on which each output is held against its plain version
RESIDUAL_HEAD = 8192


def head(x, n):
    """x restricted to its first n elements (the last axis of every
    tensor), through dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: head(v, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(head(v, n) for v in x)
    return x[..., :n].contiguous() if hasattr(x, "shape") and x.dim() else x


def residual_sweeps(torch, mt, cs, sweeps, soa, sh, ab, dev, gen, paths=""):
    """The dense residual and assemble at the driven rows, each at its
    path's state, J2 and J2Linear also on random plastic input, with each
    call's bound (inputs read once, outputs written once; chip_smoke.dense_ops);
    each call's plain version on the first RESIDUAL_HEAD elements; only the
    paths whose label matches the regular expression `paths`."""
    import dataclasses

    dt = cs.STEP_KW["dt"]
    kw3 = {k: v for k, v in cs.STEP_KW.items() if k != "dt"}
    nh = "CompressibleOgdenNeoHookean"

    def path_j():
        prob = cs.build(mt, cs.SPANS, dev)
        d = sh.dense_tables(prob)
        return prob, dataclasses.replace(prob, sf=None, dense={"dN_t": d["dN_t"],
                                                                "N_t": d["N_t"]},
                                         wdet_t=d["wdet_t"])

    def plain(prob):
        return prob, prob

    drives = [  # (label, problem maker -> (driven problem, dense view), dt, step settings, bf16)
        ("path I 2x38^3", lambda: plain(cs.two_patch3_of(mt, cs.hyper_material(mt),
                                                         cs.DENSE_SPANS, dev)), dt, kw3, False),
        ("path L 512^2", lambda: plain(cs.balken_build(mt, nh, 3, cs.GOLDEN_SUBDIVIDE, dev)),
         cs.GOLDEN_2D[nh][1], cs.STEP2D_KW, False),
        ("golden J2 512^2", lambda: plain(cs.balken_build(mt, "J2", 2, cs.GOLDEN_SUBDIVIDE,
                                                          dev)),
         cs.GOLDEN_2D["J2"][1], cs.STEP2D_KW, False),
        ("J2 128^2 p=2", lambda: plain(cs.balken_build(mt, "J2", 1, cs.P2_SUBDIVIDE, dev)),
         cs.GOLDEN_2D["J2"][1], cs.STEP2D_KW, False),
        ("path J 48^3", path_j, dt, cs.J_STEP_KW, True),
        ("3D dense J2 2x38^3", lambda: plain(cs.dense_build(mt, cs.DENSE_SPANS, dev, "J2")), dt,
         kw3, False),
    ]
    for label, make, pdt, kw, bf16 in drives:
        if not re.search(paths, label):
            continue
        prob, view = make()
        step = mt.make_step(prob, pdt, **kw)
        carry = mt.initial_carry(prob)
        for _ in range(2):  # the warm step and one timed step of the drives
            carry = step(carry)
        u_el, a_el, _ = cs.predictor_fields(torch, sh, prob, carry, gen, pdt)
        state = carry["state"]
        del step
        mat, rho = prob.material, float(prob.material.density)
        share = (float((state["eqps"] > 0).float().mean()) if state is not None else 0.0)
        cases = [(f"{label} path state, points with eqps > 0 {share:.4f}", mat, u_el, a_el,
                  None, state, bf16)]
        # J2 and J2Linear on random plastic input at each J2 row's size (path
        # J's tables are the 3D cell's shape)
        if mat.has_state and not bf16:
            for m in (mat, cs.j2lin_material(mt)):
                p = cs.with_material(soa, view, m)
                amp = cs.J2LIN_AMPLITUDE if sweeps.kernel_tag(m) == "j2lin" else cs.LAW_AMPLITUDE
                f, sh_ = cs.plastic_inputs(torch, sweeps, soa, p, m, gen, pdt, amp)
                cases.append((f"{label} random {sweeps.kernel_tag(m)}, plastic share {sh_:.3f}",
                              m, f["u_el"], f["a_el"], f["v_el"], f["state"], None))
        for case, m, ue, ae, ve, st, cb in cases:
            p = cs.with_material(soa, view, m)
            dN, N, wq = p.dense["dN_t"], p.dense["N_t"], p.wdet_t
            key = cs.table_key(p)
            a = (ue, ae, st, dN, N, wq, m, pdt, rho)
            n = min(RESIDUAL_HEAD, p.n_el)
            ah = head(a, n)
            ops = cs.dense_ops(sweeps, p)
            n_pts, el = p.n_el * p.n_q, cs.nbytes(ue)
            own = sweeps.tangent_storage(m)
            calls = {}
            viscs = (False,) if cb is not None else (False, True)
            for visc in viscs:
                vk = dict(v_el=ve, mu_v=100.0) if visc else {}
                vkh = dict(v_el=head(ve, n), mu_v=100.0) if visc else {}
                vb = cs.nbytes(ve) if visc else 0
                names = sweeps.kernel_counters(m, "dense", p.dim, key, visc)
                calls[names[0]] = (lambda vk=vk: sweeps.residual_dense(*a, **vk),
                                   lambda vkh=vkh: cs.twin(sweeps.residual_dense_plain)(*ah,
                                                                                       **vkh))
                ms, by = cs.bound_of(cs.nbytes(*a[:6]) + vb + el, n_pts * ops[0])
                print(f"[{case}] {names[0]}: bound {ms:.4f} ms by {by}", flush=True)
                stores = (own,) if cb is not None else tuple(dict.fromkeys((own, "full")))
                for storage in stores:
                    ct = torch.bfloat16 if cb else torch.float32
                    names = sweeps.kernel_counters(m, "dense", p.dim, key, visc, bool(cb),
                                                   storage=storage)
                    calls[names[1]] = (
                        lambda vk=vk, s=storage, ct=ct: sweeps.assemble_dense(
                            *a, **vk, storage=s, c_dtype=ct),
                        lambda vkh=vkh, s=storage: cs.twin(sweeps.assemble_dense_plain)(
                            *ah, **vkh, storage=s))
                    planes = (sweeps.n_planes(storage, p.dim) * n_pts
                              * (2 if ct == torch.bfloat16 else 4))
                    ms, by = cs.bound_of(cs.nbytes(*a[:6]) + vb + el + planes, n_pts * ops[1])
                    print(f"[{case}] {names[1]}: bound {ms:.4f} ms by {by}", flush=True)
            ab(f"{case} ({key}, {p.n_el} elements)", calls,
               5 if p.n_el * p.n_q > 5e6 else 10, head_n=n)
            del calls, a, ah
            torch.cuda.empty_cache()
        del prob, view, carry, cases, u_el, a_el, state
        torch.cuda.empty_cache()


# the fused neo-Hookean tangent apply's rows (--part untiled): label ->
# (tables' shape, problem maker); the 3D dense cell's tables at 2 x 38^3
# (phase 17's), path I's and (3, 125, 216)'s, path L's and the 2D untiled
# shapes at the golden cantilevers' and the p = 2 drives' sizes
FUSED_ROWS = {
    "fused 3D cell 2x38^3": ((3, 27, 64), lambda mt, cs, dev: cs.dense_build(
        mt, cs.DENSE_SPANS, dev)),
    "fused path I 2x38^3": ((3, 64, 125), lambda mt, cs, dev: cs.two_patch3_of(
        mt, cs.hyper_material(mt), cs.DENSE_SPANS, dev)),
    "fused 2x16^3 p=4": ((3, 125, 216), lambda mt, cs, dev: cs.two_patch3_of(
        mt, cs.hyper_material(mt), 16, dev, elevate=3)),
    "fused path L 512^2": ((2, 25, 36), lambda mt, cs, dev: cs.balken_build(
        mt, "CompressibleOgdenNeoHookean", 3, cs.GOLDEN_SUBDIVIDE, dev)),
    "fused golden 512^2": ((2, 16, 25), lambda mt, cs, dev: cs.balken_build(
        mt, "CompressibleOgdenNeoHookean", 2, cs.GOLDEN_SUBDIVIDE, dev)),
    "fused 128^2 p=2": ((2, 9, 16), lambda mt, cs, dev: cs.balken_build(
        mt, "CompressibleOgdenNeoHookean", 1, cs.P2_SUBDIVIDE, dev)),
}
# the 3D J2 rows of --part untiled: residual_sweeps' paths at (3, 27, 64)
UNTILED_J2_PATHS = "path J|3D dense J2"


def fused_applies(torch, mt, cs, sweeps, ab, dev, gen, paths=""):
    """The fused neo-Hookean tangent apply at FUSED_ROWS' shapes and sizes
    on random input near F = I (chip_smoke.random_visc_inputs), with its
    bound (chip_smoke.hold_fused's count: inputs read once, the output
    written once, fused_ops' operations) and its plain version on the
    first RESIDUAL_HEAD elements; only the rows whose label matches
    `paths`."""
    from mimi_tpu_torch.ops import fused_neohookean as fused

    for label, (key, make) in FUSED_ROWS.items():
        if not re.search(paths, label):
            continue
        prob = make(mt, cs, dev)
        assert cs.table_key(prob) == key, (label, cs.table_key(prob))
        mat, dN, wq = prob.material, prob.dense["dN_t"], prob.wdet_t
        f = cs.random_visc_inputs(torch, sweeps, prob, mat, gen, cs.STEP_KW["dt"])
        u_el, w_el = f["u_el"], f["w_el"]
        n = min(RESIDUAL_HEAD, prob.n_el)
        lam, mu = mat.lambda_, mat.mu
        name = sweeps.fused_counters(key)[1]
        ms, by = cs.bound_of(cs.nbytes(u_el, w_el, dN, wq, u_el),
                             prob.n_el * prob.n_q * cs.fused_ops(prob.dim, key[1])[1])
        print(f"[{label}] {name}: bound {ms:.4f} ms by {by}", flush=True)
        args, ah = (u_el, w_el, dN, wq), head((u_el, w_el, dN, wq), n)
        calls = {name: (lambda: fused.neohookean_tangent_apply(*args, lam, mu),
                        lambda: fused.neohookean_tangent_apply_plain(*ah, lam, mu))}
        ab(f"{label} random ({key}, {prob.n_el} elements)", calls,
           10 if prob.n_el * prob.n_q > 5e6 else 20, head_n=n)
        del prob, f, u_el, w_el, args, ah, calls
        torch.cuda.empty_cache()


# the hyperelastic materials' untiled driven shapes (--part hyper)
HYPER_KEYS = [("dense", (2, 16, 25)), ("dense", (2, 9, 16)), ("dense", (3, 27, 64))]


def hyper_sweeps(torch, mt, cs, sweeps, ab, dev, gen):
    """The neo-Hookean residual and assemble at the untiled driven rows
    (the golden twin at 512^2, 128^2 p = 2, the 3D cell at 2 x 38^3, path
    A's viscous 2 x 512^2), random input near F = I; each call's plain
    version on the first RESIDUAL_HEAD elements."""
    dt, nh = cs.STEP_KW["dt"], "CompressibleOgdenNeoHookean"
    hyper = [
        ("golden neo-Hookean 512^2", lambda: cs.balken_build(mt, nh, 2, cs.GOLDEN_SUBDIVIDE, dev),
         False),
        ("neo-Hookean 128^2 p=2", lambda: cs.balken_build(mt, nh, 1, cs.P2_SUBDIVIDE, dev), False),
        ("3D dense neo-Hookean 2x38^3", lambda: cs.dense_build(mt, cs.DENSE_SPANS, dev), False),
        ("path A 2x512^2 viscous", lambda: cs.press_build(mt, 2, cs.PRESS_2D_SUBDIVIDE, dev), True),
    ]
    for label, make, visc in hyper:
        p = make()
        m, rho = p.material, float(p.material.density)
        f = cs.random_visc_inputs(torch, sweeps, p, m, gen, dt)
        dN, N, wq = p.dense["dN_t"], p.dense["N_t"], p.wdet_t
        key = cs.table_key(p)
        a = (f["u_el"], f["a_el"], None, dN, N, wq, m, dt, rho)
        n = min(RESIDUAL_HEAD, p.n_el)
        ah = head(a, n)
        vk = dict(v_el=f["v_el"], mu_v=100.0) if visc else {}
        vkh = dict(v_el=head(f["v_el"], n), mu_v=100.0) if visc else {}
        names = sweeps.kernel_counters(m, "dense", p.dim, key, visc)
        calls = {names[0]: (lambda: sweeps.residual_dense(*a, **vk),
                            lambda: cs.twin(sweeps.residual_dense_plain)(*ah, **vkh)),
                 names[1]: (lambda: sweeps.assemble_dense(*a, **vk),
                            lambda: cs.twin(sweeps.assemble_dense_plain)(*ah, **vkh))}
        ab(f"{label} random ({key}, {p.n_el} elements)", calls, 10, head_n=n)
        del p, f, a, ah, calls
        torch.cuda.empty_cache()


def use(kb, libs):
    """Make the wrappers launch the kernels of `libs` ({key: library})."""
    kb._LIBS.clear()
    kb._LIBS.update(libs)


def median_ms(torch, fn, reps):
    """Each of `reps` calls' own CUDA-event ms, after a warm call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return ts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="directory holding the other version's "
                    "mimi_tpu_torch/ops/csrc")
    ap.add_argument("--new", default="", help="directory holding the sources of the new side "
                    "(default: this checkout's)")
    ap.add_argument("--subdivide", type=int, default=8, help="2D: 2^subdivide spans per axis")
    ap.add_argument("--spans", type=int, default=16, help="3D p = 2: 2 x spans^3 elements")
    ap.add_argument("--only", default="", help="time only the rows whose name matches")
    ap.add_argument("--paths", default="", help="--part residual, untiled: drive only the paths "
                    "and rows whose label matches (RESIDUAL_PATHS, FUSED_ROWS)")
    ap.add_argument("--part", default="all",
                    help="all, earlier, tiled, finite, residual, hyper or untiled, or several "
                    "joined by commas; "
                    "earlier: the untiled shapes' instantiations and (3, 3) at 2 x 8^3; "
                    "tiled: the tiled matvecs at the driven sizes; finite: J2Simo's and "
                    "J2Log's dense residual and assemble at the driven sizes; residual: the "
                    "dense residual and assemble at the driven rows and states; hyper: the "
                    "neo-Hookean residual and assemble at the untiled driven rows; untiled: the "
                    "fused tangent apply at every driven shape and 3D J2's residual and "
                    "assemble at (3, 27, 64)")
    args = ap.parse_args()
    parts = set(args.part.split(","))
    if "all" in parts:
        parts |= {"earlier", "tiled"}
    if not parts <= {"all", "earlier", "tiled", "finite", "residual", "hyper", "untiled"}:
        ap.error(f"unknown part in {args.part!r}")
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
    keys = []
    residual_keys = [("dense", k) for label, k in RESIDUAL_PATHS.items()
                     if re.search(args.paths, label)]
    untiled_keys = [("dense", k) for label, (k, _) in FUSED_ROWS.items()
                    if re.search(args.paths, label)] + [
        ("dense", k) for label, k in RESIDUAL_PATHS.items()
        if re.search(UNTILED_J2_PATHS, label) and re.search(args.paths, label)]
    for part, part_keys in (("finite", FINITE_KEYS), ("residual", residual_keys),
                            ("untiled", untiled_keys),
                            ("hyper", HYPER_KEYS),
                            ("earlier", [k for k in cs.EARLIER_KEYS if k[0] == "dense"]),
                            ("tiled", TILED_KEYS)):
        if part in parts:
            keys += [k for k in part_keys if k not in keys]
    kb.JOBS = os.cpu_count() or kb.JOBS  # nothing else runs beside the builds
    base = os.path.abspath(args.base)
    libs = {}
    if args.new:
        new = os.path.abspath(args.new)
        queued = kb.build_tree(os.path.join(new, "mimi_tpu_torch", "ops", "csrc"),
                               os.path.join(new, "_build"), keys)
    else:
        kb.start(keys)
    libs["base"], base_log = kb.build_tree(os.path.join(base, "mimi_tpu_torch", "ops", "csrc"),
                                           os.path.join(base, "_build"), keys)
    if args.new:
        libs["new"], new_log = queued
    else:
        libs["new"] = kb.prebuild(keys)
        new_log = "".join(kb.BUILD_INFO[kb.key_of(*k)]["log"] for k in keys)
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    if parts != {"earlier"}:
        shown = []
        if "finite" in parts:  # the finite-strain residual and assemble kernels
            shown.append(lambda n: "J2SimoMat" in n or "J2LogMat" in n)
        if "tiled" in parts:
            shown.append(lambda n: "dense_matvec_tile_kernel" in n or (
                "dense_tile_kernel" in n and "MatvecPoint" in n))
        if parts & {"residual", "hyper", "untiled"}:  # the dense residual and assemble kernels
            shown.append(lambda n: any(k in n for k in (
                "dense_residual_tile_kernel", "dense_slot_kernel", "dense_finite_kernel",
                "dense_ring_kernel")) or (
                "dense_tile_kernel" in n and "ResidualPoint" in n) or (
                "dense_residual_kernel" in n and "DenseJ2" in n))
        if "untiled" in parts:  # the fused tangent apply
            shown.append(lambda n: "nh_tangent_apply_" in n or (
                "dense_tile_kernel" in n and "NhTangentPoint" in n))
        for tag, log in (("base", base_log), ("new", new_log)):
            for name, v in sorted(cs.ptxas_entries(log, kb.nvcc()).items()):
                if any(f(name) for f in shown):
                    print(f"[{tag} ptxas] {name.split('>(')[0]}>: {v.get('registers')} "
                          f"registers, {v.get('smem')} B smem, spill stores "
                          f"{v.get('spill_stores')} B, loads {v.get('spill_loads')} B", flush=True)
    dev, gen, dt = torch.device("cuda"), torch.Generator().manual_seed(0), 0.05
    counts = {"rows": 0, "equal": 0}

    def ab(label, calls, reps, head_n=None):
        """Each call of `calls` ({name: fn, or (fn, plain on the first
        head_n elements)}) on both versions: their outputs compared, and
        their times (base, new, new, base; with head_n the medians of every
        call's own events, else the blocks' means)."""
        for name, fn in calls.items():
            if not re.search(args.only, name):
                continue
            fn, plain = fn if isinstance(fn, tuple) else (fn, None)
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
            vs_plain = ""
            if plain is not None:
                o = plain()
                ref = [x.float() for x in (o if isinstance(o, tuple) else (o,))]
                rels = [float((a[..., :head_n] - b).abs().max() / b.abs().max().clamp_min(1e-30))
                        for a, b in zip(outs["new"], ref)]
                vs_plain = (f"; new against plain on {head_n} elements "
                            + " / ".join(f"{r:.2e}" for r in rels) + " of its max")
                del o, ref
            counts["rows"] += 1
            counts["equal"] += int(same)
            del outs, pairs
            if head_n is None:
                ts = []
                for tag in ("base", "new", "new", "base"):
                    use(kb, libs[tag])
                    ts.append(cs.cuda_ms(torch, fn, reps))
                times = (f"base {ts[0]:.4f} / {ts[3]:.4f} ms, new {ts[1]:.4f} / {ts[2]:.4f} ms, "
                         f"base / new {(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}")
            else:
                ts = {"base": [], "new": []}
                for tag in ("base", "new", "new", "base"):
                    use(kb, libs[tag])
                    ts[tag] += median_ms(torch, fn, reps)
                mb, mn = (sorted(ts[t])[len(ts[t]) // 2] for t in ("base", "new"))
                times = (f"median of {len(ts['new'])} calls: base {mb:.4f} ms, new {mn:.4f} ms, "
                         f"base / new {mb / mn:.2f}")
            print(f"[{label}] {name}: {times}; outputs differ by {diff:.3e} ({rel:.2e} of their "
                  f"max), equal to the bit: {same}{vs_plain}", flush=True)
        use(kb, libs["new"])
        torch.cuda.empty_cache()

    if "finite" in parts:
        finite_sweeps(torch, mt, cs, sweeps, soa, ab, dev, gen)
    if "residual" in parts:
        residual_sweeps(torch, mt, cs, sweeps, soa, sh, ab, dev, gen, args.paths)
    if "hyper" in parts:
        hyper_sweeps(torch, mt, cs, sweeps, ab, dev, gen)
    if "untiled" in parts:
        fused_applies(torch, mt, cs, sweeps, ab, dev, gen, args.paths)
        residual_sweeps(torch, mt, cs, sweeps, soa, sh, ab, dev, gen,
                        f"(?=.*(?:{UNTILED_J2_PATHS}))(?=.*(?:{args.paths}))")
    if "tiled" in parts:
        tiled_matvecs(torch, mt, cs, sweeps, ab, dev, gen)
    if "earlier" in parts:
        earlier_sweeps(torch, mt, cs, sweeps, soa, ab, dev, gen, dt, args)
    print(f"{counts['equal']} of {counts['rows']} rows equal to the bit", flush=True)


def earlier_sweeps(torch, mt, cs, sweeps, soa, ab, dev, gen, dt, args):
    """Every float32 dense instantiation at the untiled shapes and (3, 3):
    each material's residual, its own block's assemble and matvec and the
    full block's, inviscid and viscous, on random input."""
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


if __name__ == "__main__":
    main()
