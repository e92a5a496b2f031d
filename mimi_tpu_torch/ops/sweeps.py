"""The step's three quadrature sweeps: residual, residual + per-point
tangent (assemble), and the GMRES matvec, on two kinds of tables.

Counterpart of mimi_tpu/ops/sweeps.py (`make_residual_sweep`,
`make_assemble_sweep`, `make_matvec_sweep_sf` and `make_matvec_sweep`):
  - sum-factorized tables (`residual_sf`, `assemble_sf`, `matvec_sf`)
    with c_storage="cauchy" (the 37-plane Cauchy-decomposition tangent of
    J2 and J2Linear, kernels in ops/csrc/sweeps_sf.cu) or c_storage="sym" (45
    upper-triangle planes of a major-symmetric dP/dF: the hyperelastic
    materials, ops/csrc/sweeps_sf_hyper.cu) or c_storage="full" (the 81
    planes of dP/dF: J2Simo and J2Log, kernels in
    ops/csrc/sweeps_sf_finite.cu), each with and without the viscous flux,
    the tangent block in float32 or bfloat16, at any (p + 1, n_g): the
    element's degree and Gauss points per axis;
  - dense tables dN (nd, dim, n_q, n_el) and N (nd, n_q, n_el) in 2D or
    3D, c_storage="sym" (the hyperelastic materials: 45 planes in 3D, 10
    in 2D), "cauchy" (J2 and J2Linear with their state: 37 / 14 planes)
    or "full" (J2Simo and J2Log with their state: 81 / 16 planes), with
    and without the viscous flux, the block in float32 or bfloat16 (the
    bfloat16 matvec reads bfloat16 copies of dN and N as well):
    `residual_dense`, `assemble_dense`, `matvec_dense`, kernels in
    ops/csrc/sweeps_dense.cu, sweeps_dense_j2.cu and
    sweeps_dense_finite.cu and their bfloat16 twins (*_bf16.cu, entry
    points with the suffix "_bf16"), at any (dim, nd, n_q): any degree,
    quadrature order, and degrees that differ per axis.
The kernels of a shape are compiled from the sources the first time that
shape is launched, into a library of its own (ops/build.py `load`), as the
reference traces one kernel per shape.
The material decides the storage (`tangent_storage`): the residual reads
it off the material; the assemble writes the material's own block or,
asked with `storage="full"`, the full one of any material (J2's, J2Linear's
and the hyperelastic materials' from their closed-form tangents); the
matvec is told the block's storage (`storage`).  The J2 family's radial
return runs at most materials.KERNEL_SOLVE_TRIPS (40) trips in the kernels, as in the
reference's Pallas kernels; the plain versions run the "torch" engine's
100 unless called inside materials.kernel_solver_mode(), the kernels'
plain twin.  The
J2 family (J2, J2Simo, J2Log) runs with any of the reference's hardening
laws: the Johnson-Cook family, PowerLaw and Voce (`_j2_params`).
Each sweep has
  - a plain torch version (`*_plain`), dtype-generic, on whole
    (n_q, n_el) planes;
  - a wrapper that runs the plain version for CPU tensors and launches the
    hand-written CUDA kernel for CUDA tensors, and counts those launches
    per variant in `LAUNCHES`.

The viscous flux mu_v grad(v) joins P in the residual and the assemble
(v_el = the element values of va + fac1 aa); the matvec adds
fac1 mu_v grad(w).  A bfloat16 tangent block is rounded to nearest even
when it is written and widened to float on every read; so are the
bfloat16 table copies the dense matvec reads.

Layouts (batch-last, elements fastest; shared with the JAX package):
element dof values (dim, nd, n_el) with n = a0 + P a1 (+ P^2 a2); per-axis
1D tables B0, D0, B1, D1, B2, D2 of shape (n_g, p+1, n_el); the per-qp
Jacobian inverse jinv[a, f] = d xi_a / d X_f of shape (3, 3, n_q, n_el)
with q = q0 + G q1 + G^2 q2; quadrature weights times det J, wq
(n_q, n_el); material state leaves (dim, dim, n_q, n_el) / (n_q, n_el).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.func import jvp, vmap

from ..fem import soa
from ..materials import KERNEL_SOLVE_TRIPS
from . import build


def _flags(visc=False, bf16=False):
    return [t for t, on in (("visc", visc), ("bf16", bf16)) if on]


def variant(name, visc=False, bf16=False):
    """Counter name of one J2 kernel variant: "matvec_sf",
    "matvec_sf[visc]", "matvec_sf[bf16]", "matvec_sf[visc,bf16]"."""
    tags = _flags(visc, bf16)
    return f"{name}[{','.join(tags)}]" if tags else name


# kernel launches since the last reset, per kernel variant (CUDA tensors
# only): the sf variants of J2 with a Johnson-Cook family law (untagged);
# the other sf variants by material tag (kernel_tag: "j2lin" J2Linear, "nh"
# the neo-Hookean, "stvk" the St. Venant-Kirchhoff material, "simo" J2Simo,
# "log" J2Log, and "j2-pow", "simo-voce" and the like for a J2-family
# material with the PowerLaw or Voce law); the dense ones by material tag
# ("j2" for J2, "j2lin", "simo", "log", the law suffixes as on sf; the
# untagged names are the neo-Hookean instantiations); both kinds by the
# element shape's suffix (_shape_suffix: "@2d_p3", "@3d_p4", "@3d_p2_g3",
# "@2d_nd12_q20"; none for 3D p = 2); "visc" and "bf16" tag the viscous and
# the bfloat16-block instantiations.  A shape's names are here from the
# first load of its library (_lib, register_shape): read a count with
# LAUNCHES.get(name, 0).
LAUNCHES = {}
# the (kind, shape key) pairs whose counters LAUNCHES names
_NAMED = set()
# The hyperelastic materials the CUDA kernels instantiate, by class name:
# (material id of the C entry points, counter tag).  csrc/materials.cuh
# holds each one's struct, the entry points switch on the id.
HYPER_KERNELS = {"CompressibleOgdenNeoHookean": (0, "nh"), "StVenantKirchhoff": (1, "stvk")}
# The finite-strain plasticity models on the kernels with the full tangent
# (csrc/sweeps_sf_finite.cu, sweeps_dense_finite.cu), by class name:
# (material id of their C entry points, counter tag, state leaves in the
# order the entry points take them)
FULL_KERNELS = {
    "J2Simo": (0, "simo", ("be_old", "F_old", "eqps", "temperature")),
    "J2Log": (1, "log", ("Fp_inv", "eqps", "temperature")),
}
# The small-strain J2 models on the kernels with the Cauchy storage
# (csrc/sweeps_sf.cu, sweeps_dense_j2.cu), by class name: (material id of
# their C entry points, counter tag, the state leaves in the entry points'
# four slots ps, eqps, temp, beta; None where the material has none)
CAUCHY_KERNELS = {
    "J2": (0, "j2", ("plastic_strain", "eqps", "temperature", None)),
    "J2Linear": (1, "j2lin", ("plastic_strain", "eqps", None, "beta")),
}
# The hardening laws of the J2 family the kernels run besides the
# Johnson-Cook family (csrc/j2.cuh flow), by class name: (law id of
# J2Params, counter tag)
LAW_KERNELS = {"PowerLawHardening": (1, "pow"), "VoceHardening": (2, "voce")}
STORAGES = ("cauchy", "sym", "full")


def n_planes(storage, dim=3):
    """Planes of a tangent block in `storage` for `dim`: cauchy 37 (3D) /
    14 (2D), sym 45 / 10, full 81 / 16."""
    if storage not in STORAGES:
        raise ValueError(f"unknown tangent storage {storage!r}")
    d2 = dim * dim
    if storage == "cauchy":
        return cauchy_plane_layout(dim)["n_plane"]
    return d2 * (d2 + 1) // 2 if storage == "sym" else d2 * d2


def _root(n, dim):
    """The integer r >= 1 with r^dim = n, or None."""
    r = round(n ** (1.0 / dim))
    return next((c for c in (r - 1, r, r + 1) if c >= 1 and c**dim == n), None)


def dense_key(dim, p):
    """The dense tables' shape key (dim, nd, n_q) of degree p with its
    default (p + 2)^dim points."""
    return dim, (p + 1) ** dim, (p + 2) ** dim


def _shape_suffix(dim, p):
    """Counter-name suffix of an instantiation's element shape.  `p` is the
    degree (at its default (p + 2)^dim points) or the tables' shape key:
    (p + 1, n_g) of sf tables, (dim, nd, n_q) of dense ones.  None for 3D
    p = 2 at 64 points; "@2d_p3", "@3d_p4" at the default points;
    "@3d_p2_g3" at another Gauss count per axis; "@2d_nd12_q20" for degrees
    or Gauss counts that differ per axis."""
    if isinstance(p, tuple):
        dim, nd, nq = (3, p[0] ** 3, p[1] ** 3) if len(p) == 2 else p
    else:
        dim, nd, nq = dense_key(dim, p)
    p1, g = _root(nd, dim), _root(nq, dim)
    if p1 is None or g is None:
        return f"@{dim}d_nd{nd}_q{nq}"
    if g != p1 + 1:
        return f"@{dim}d_p{p1 - 1}_g{g}"
    return "" if (dim, p1) == (3, 3) else f"@{dim}d_p{p1 - 1}"


def material_counters(kind, tag, storage="sym", dim=3, p=2, visc=False, bf16=False):
    """(residual, assemble) counter names of a material's instantiations on
    the "sf" or "dense" tables with the "sym", "full" or "cauchy" storage,
    viscous and with a bfloat16 block where asked (the residual writes no
    block), with the suffix of (dim, p) (p: the degree or the tables' shape
    key, _shape_suffix): "assemble_sf[nh,sym,visc,bf16]",
    "residual_dense[j2,visc]@2d_p2" and the like.  The neo-Hookean's dense
    names and those of J2 with a Johnson-Cook family law on sf tables are
    untagged ("residual_dense[visc]", "assemble_dense[sym]"; `variant`) in
    the material's own storage."""
    sfx = _shape_suffix(dim, p)
    if kind == "sf" and tag == "j2":
        res = variant("residual_sf", visc) + sfx
        if storage == "cauchy":
            return res, variant("assemble_sf", visc, bf16) + sfx
    elif kind == "dense" and tag == "nh":
        res = variant("residual_dense", visc) + sfx
    else:
        res = f"residual_{kind}[{','.join([tag, *_flags(visc)])}]{sfx}"
    asm = ["sym"] if (kind, tag, storage) == ("dense", "nh", "sym") else [tag, storage]
    return res, f"assemble_{kind}[{','.join(asm + _flags(visc, bf16))}]{sfx}"


def matvec_counter(kind, storage, dim=3, p=2, visc=False, bf16=False):
    """Counter name of a matvec instantiation: "matvec_dense[cauchy]@2d_p3",
    "matvec_sf[sym,visc,bf16]" and the like (the Cauchy sf matvec's are
    untagged: "matvec_sf[visc,bf16]", "matvec_sf@3d_p3")."""
    if (kind, storage) == ("sf", "cauchy"):
        return variant("matvec_sf", visc, bf16) + _shape_suffix(dim, p)
    return f"matvec_{kind}[{','.join([storage, *_flags(visc, bf16)])}]{_shape_suffix(dim, p)}"


_LAWS = ("",) + tuple(f"-{t}" for _, t in LAW_KERNELS.values())
# the tags of the J2 family's instantiations, each law's included
_CAUCHY_TAGS = [f"j2{law}" for law in _LAWS] + ["j2lin"]
_FULL_TAGS = [f"{t}{law}" for _, t, _ in FULL_KERNELS.values() for law in _LAWS]
_HYPER_TAGS = [t for _, t in HYPER_KERNELS.values()]
_BOTH = (False, True)


def fused_counters(key):
    """Counter names of the fused neo-Hookean kernels at the dense shape
    key (ops/fused_neohookean.py): "neohookean_residual" at (3, 27, 64),
    "neohookean_residual@2d_p4" and the like at another shape."""
    sfx = _shape_suffix(key[0], key)
    return f"neohookean_residual{sfx}", f"neohookean_tangent_apply{sfx}"


def shape_counters(kind, key):
    """Every counter name of the `kind` kernels at the shape `key`: each
    material's instantiations in its own storage and in the full one,
    viscous or not, with a float32 or a bfloat16 block, the matvecs of every
    storage, and on dense tables the fused neo-Hookean kernels."""
    dim = 3 if kind == "sf" else key[0]
    names = [
        name
        for tags, own in ((_HYPER_TAGS, "sym"), (_CAUCHY_TAGS, "cauchy"), (_FULL_TAGS, "full"))
        for tag in tags
        for storage in {own, "full"}
        for visc in _BOTH
        for bf16 in _BOTH
        for name in material_counters(kind, tag, storage, dim, key, visc, bf16)
    ]
    names += [matvec_counter(kind, storage, dim, key, visc, bf16)
              for storage in STORAGES for visc in _BOTH for bf16 in _BOTH]
    return names + (list(fused_counters(key)) if kind == "dense" else [])


def register_shape(kind, key):
    """Name the shape's instantiations in LAUNCHES (at 0), where they are
    not named yet."""
    for name in shape_counters(kind, key):
        LAUNCHES.setdefault(name, 0)



def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_tag(mat):
    """Counter tag of the material's kernels: the material's ("j2", "j2lin",
    "simo", "log", "nh", "stvk") and, for a J2-family law the kernels run
    besides the Johnson-Cook family, the law's ("j2-pow", "simo-voce")."""
    tags = {name: v[1] for table in (HYPER_KERNELS, CAUCHY_KERNELS, FULL_KERNELS)
            for name, v in table.items()}
    if mat.name() not in tags:
        raise NotImplementedError(f"the CUDA sweeps implement no {mat.name()}")
    law = LAW_KERNELS.get(type(getattr(mat, "hardening", None)).__name__)
    return tags[mat.name()] + (f"-{law[1]}" if law else "")


def kernel_counters(mat, kind, dim=3, p=2, visc=False, bf16=False, storage=None):
    """(residual, assemble) counter names of the material's kernels on the
    "sf" or "dense" tables at (dim, p) (p: the degree or the tables' shape
    key), viscous and with a bfloat16 block
    where asked, the block in `storage` (default: the material's;
    material_counters)."""
    return material_counters(kind, kernel_tag(mat), storage or tangent_storage(mat), dim, p,
                             visc, bf16)


def tangent_storage(mat):
    """The strongest exact compression of the per-point tangent the
    material declares: "cauchy", "sym" or "full" (n_planes)."""
    if mat.tangent_cauchy_decomp:
        return "cauchy"
    return "sym" if mat.tangent_major_symmetric else "full"


def tri_index_map(d2: int):
    """Upper-triangle plane index for symmetric tangent storage:
    (a, b) with a <= b -> flat index into d2*(d2+1)//2 planes."""
    idx = {}
    k = 0
    for a in range(d2):
        for b in range(a, d2):
            idx[(a, b)] = k
            k += 1
    return idx, k


def sym_basis(dim: int):
    """Symmetric-tensor basis index pairs, row-major upper triangle:
    dim 3 -> [(0,0),(0,1),(0,2),(1,1),(1,2),(2,2)]."""
    return [(i, j) for i in range(dim) for j in range(i, dim)]


def cauchy_plane_layout(dim: int):
    """Plane layout of the Cauchy-decomposition tangent block:
    [0:n_tri)            D-hat = d sigma / d eps, upper triangle over the
                         sym_basis x sym_basis Voigt matrix
    [n_tri:n_tri+n_sym)  sigma entries in sym_basis order
    [+dim*dim)           F^{-1} row-major
    [last]               J = det F
    Total: dim 3 -> 21 + 6 + 9 + 1 = 37 planes."""
    n_sym = dim * (dim + 1) // 2
    tri, n_tri = tri_index_map(n_sym)
    return {
        "sym": sym_basis(dim),
        "tri": tri,
        "n_tri": n_tri,
        "off_sig": n_tri,
        "off_fi": n_tri + n_sym,
        "off_j": n_tri + n_sym + dim * dim,
        "n_plane": n_tri + n_sym + dim * dim + 1,
    }


def build_sf_tables(patch, x_ref, conn, n_q_axis, dtype=np.float64,
                    return_det=False):
    """Host-side factors of the sum-factorized sweeps on one polynomial
    3D patch: per-axis per-element 1D basis tables and the per-qp inverse
    geometric Jacobian.

    Returns (tables, jinv): tables = [B0, D0, B1, D1, B2, D2] each
    (n_g, p+1, n_el); jinv (3, 3, n_q, n_el); with return_det=True also
    detJ (n_el, n_q), all computed in float64 and cast to `dtype`.
    Raises ValueError for rational patches (the quotient is not
    separable)."""
    w = np.asarray(patch.weights).ravel()
    if not np.allclose(w, 1.0):
        raise ValueError("sum factorization needs unit weights")
    from ..fem.space import _dim_tables

    if len(patch.degrees) != 3:
        raise ValueError("sum factorization is 3D-only")
    tabs = [
        _dim_tables(patch.knot_vectors[ax], patch.degrees[ax], n_q_axis)
        for ax in range(3)
    ]
    spans = [t[0].shape[0] for t in tabs]
    n_el = int(np.prod(spans))
    if n_el != conn.shape[0]:
        raise ValueError("connectivity does not match the span grid")
    # element e = e0 + S0 e1 + S0 S1 e2 (axis 0 fastest)
    e = np.arange(n_el)
    eids = (e % spans[0], (e // spans[0]) % spans[1], e // (spans[0] * spans[1]))
    tables = []
    for ax in range(3):
        tables.append(np.ascontiguousarray(tabs[ax][3][eids[ax]].transpose(1, 2, 0)))
        tables.append(np.ascontiguousarray(tabs[ax][4][eids[ax]].transpose(1, 2, 0)))
    # geometric Jacobian J[e, q, k, c] = dX_c / dxi_k by the same staged
    # sum factorization as the sweeps (no (n_el, n_q, nd, 3) table)
    xs = np.asarray(x_ref)[np.asarray(conn)].transpose(2, 1, 0)  # (3, nd, E)
    pg = sf_param_grad(
        torch.from_numpy(np.ascontiguousarray(xs, np.float64)),
        [torch.from_numpy(t) for t in tables],
    )
    J = pg.permute(3, 2, 1, 0)
    # jinv[a, f, q, e] = d xi_a / d X_f = inv(J)[e, q, f, a]
    jinv = torch.linalg.inv(J).permute(3, 2, 1, 0).contiguous().numpy()
    out = ([np.asarray(t, dtype) for t in tables], np.asarray(jinv, dtype))
    if return_det:
        out = out + (np.asarray(torch.linalg.det(J).numpy(), dtype),)
    return out


# ---------------------------------------------------------------------------
# plain torch versions (sum factorization as staged einsums)
# ---------------------------------------------------------------------------


def _grid_el(w_el, p1):
    """(C, nd, E) -> (C, a2, a1, a0, E)."""
    return w_el.reshape(w_el.shape[0], p1, p1, p1, w_el.shape[-1])


def sf_param_grad(w_el, tabs):
    """Parametric gradient d w_c / d xi_k (C, 3, n_q, E) of the element
    fields w_el (C, nd, E) by staged sums over the 1D factors."""
    B0, D0, B1, D1, B2, D2 = tabs
    W = _grid_el(w_el, B0.shape[1])
    sB = torch.einsum("zke,ckjie->czjie", B2, W)
    sD = torch.einsum("zke,ckjie->czjie", D2, W)
    tBB = torch.einsum("yje,czjie->czyie", B1, sB)
    C, E = w_el.shape[0], w_el.shape[-1]

    def last(T, t):
        return torch.einsum("xie,czyie->czyxe", T, t).reshape(C, -1, E)

    return torch.stack(
        [
            last(D0, tBB),
            last(B0, torch.einsum("yje,czjie->czyie", D1, sB)),
            last(B0, torch.einsum("yje,czjie->czyie", B1, sD)),
        ],
        1,
    )


def sf_grad(w_el, tabs, jinv):
    """Physical gradient dF[g, f] (3, 3, n_q, E) of the element fields
    w_el (3, nd, E)."""
    return torch.einsum("gaqe,afqe->gfqe", sf_param_grad(w_el, tabs), jinv)


def sf_value(w_el, tabs):
    """Values (C, n_q, E) of the element fields w_el (C, nd, E)."""
    B0, _, B1, _, B2, _ = tabs
    p1 = B0.shape[1]
    t = torch.einsum("zke,ckjie->czjie", B2, _grid_el(w_el, p1))
    t = torch.einsum("yje,czjie->czyie", B1, t)
    t = torch.einsum("xie,czyie->czyxe", B0, t)
    return t.reshape(w_el.shape[0], -1, w_el.shape[-1])


def sf_scatter(X, vecm, tabs, jinv, wq):
    """Transpose of the interpolation, integrated with weights wq:
    out[c, n] = sum_q wq (dN[n, f] X[c, f] + N[n] vecm[c]), with dN the
    physical basis gradient; X (C, 3, n_q, E) or None, vecm (C, n_q, E)
    or None.  Returns (C, nd, E)."""
    B0, D0, B1, D1, B2, D2 = tabs
    g, p1 = B0.shape[0], B0.shape[1]
    E = wq.shape[-1]
    src = X if X is not None else vecm
    C = src.shape[0]

    def grid_q(t):
        return t.reshape(C, g, g, g, E)  # (c, q2, q1, q0, e)

    def first(T, t):  # contract q0 -> a0
        return torch.einsum("xie,czyxe->czyie", T, grid_q(t))

    def second(T, t):  # contract q1 -> a1
        return torch.einsum("yje,czyie->czjie", T, t)

    def third(T, t):  # contract q2 -> a2
        return torch.einsum("zke,czjie->ckjie", T, t)

    out = None
    if X is not None:
        Z = torch.einsum("afqe,cfqe->caqe", jinv, wq * X)
        out = third(B2, second(B1, first(D0, Z[:, 0])))
        out = out + third(B2, second(D1, first(B0, Z[:, 1])))
        out = out + third(D2, second(B1, first(B0, Z[:, 2])))
    if vecm is not None:
        m = third(B2, second(B1, first(B0, wq * vecm)))
        out = m if out is None else out + m
    return out.reshape(C, p1**3, E)


def tangent_apply_cauchy(Cb, dF, fac0):
    """dP = fac0 (tr(F^-1 dF) P + J (D-hat : sym dF) F^-T - P dF^T F^-T)
    from the Cauchy-decomposition block Cb (cauchy_plane_layout of dF's
    dimension: 37 planes in 3D, 14 in 2D), P = J sigma F^-T rebuilt from
    the stored sigma, F^-1 and J."""
    dim = dF.shape[0]
    lay = cauchy_plane_layout(dim)
    SYM, tri6 = lay["sym"], lay["tri"]

    def M_at(a, m):
        return Cb[tri6[(min(a, m), max(a, m))]]

    sig = {}
    for k, (i, j) in enumerate(SYM):
        sig[(i, j)] = sig[(j, i)] = Cb[lay["off_sig"] + k]
    fi = [[Cb[lay["off_fi"] + r * dim + c] for c in range(dim)] for r in range(dim)]
    Jd = Cb[lay["off_j"]]
    # contraction coefficients against the stored D-hat: dF_ii or
    # (dF_ij + dF_ji), un-halved
    cm = [dF[i, i] if i == j else dF[i, j] + dF[j, i] for (i, j) in SYM]
    dsig = {}
    for a, (i, j) in enumerate(SYM):
        acc = M_at(a, 0) * cm[0]
        for m in range(1, len(SYM)):
            acc = acc + M_at(a, m) * cm[m]
        dsig[(i, j)] = dsig[(j, i)] = acc
    P = [
        [Jd * sum(sig[(c, e)] * fi[dd][e] for e in range(dim)) for dd in range(dim)]
        for c in range(dim)
    ]
    trF = sum(fi[c][e] * dF[e, c] for c in range(dim) for e in range(dim))
    A = [
        [sum(dF[e, a] * fi[b][e] for e in range(dim)) for b in range(dim)]
        for a in range(dim)
    ]
    return soa.stack2(
        [
            [
                fac0
                * (
                    trF * P[c][dd]
                    + Jd * sum(dsig[(c, e)] * fi[dd][e] for e in range(dim))
                    - sum(P[c][e] * A[e][dd] for e in range(dim))
                )
                for dd in range(dim)
            ]
            for c in range(dim)
        ]
    )


def _visc_flux(P, v_el, mu_v, tabs, jinv):
    return P if v_el is None else P + mu_v * sf_grad(v_el, tabs, jinv)


def residual_sf_plain(u_el, a_el, state, tabs, jinv, wq, mat, dt, rho,
                      v_el=None, mu_v=0.0):
    """y[c, n] = sum_q wq (dN[n, d] (P(F) + mu_v dV)[c, d] + N[n] rho
    a_q[c]), F = I + grad u, dV = grad v (no viscous flux when v_el is
    None)."""
    P = mat.pk1_soa(soa.add_diag(sf_grad(u_el, tabs, jinv), 1.0), state, dt)
    P = _visc_flux(P, v_el, mu_v, tabs, jinv)
    return sf_scatter(P, rho * sf_value(a_el, tabs), tabs, jinv, wq)


def assemble_sf_plain(u_el, a_el, state, tabs, jinv, wq, mat, dt, rho,
                      v_el=None, mu_v=0.0, c_dtype=None, storage=None):
    """Residual (with the viscous flux as residual_sf_plain) plus the
    tangent block in `storage` (default: the material's, `tangent_storage`),
    stored in `c_dtype` (default: the fields' dtype; bfloat16 rounds the
    planes to nearest even).  Viscosity enters the matvec, not the block.

    "sym": the 45 planes of `sym_tangent_planes`.  "full": the 81 planes
    of `full_tangent_planes` (any material).  "cauchy": the 37 planes of
    `cauchy_tangent_planes`."""
    F = soa.add_diag(sf_grad(u_el, tabs, jinv), 1.0)
    P, Cb = tangent_planes(storage or tangent_storage(mat))(mat, F, state, dt)
    y = sf_scatter(
        _visc_flux(P, v_el, mu_v, tabs, jinv), rho * sf_value(a_el, tabs), tabs, jinv, wq
    )
    return y, Cb if c_dtype is None else Cb.to(c_dtype)


def cauchy_tangent_planes(mat, F, state, dt):
    """(P, the Cauchy-decomposition planes of cauchy_plane_layout) at F of
    any dimension.  D-hat comes from forward-mode derivatives of
    `mat.cauchy_soa` along the one-hot symmetric seeds S_m = e_ij + e_ji
    (e_ii on the diagonal), scaled by 1/2 on off-diagonal basis columns
    and stored symmetric (pairs accumulated half plus half); then sigma,
    F^-1 and J, and P = J sigma F^-T."""
    dim = F.shape[0]
    lay = cauchy_plane_layout(dim)
    SYM, tri = lay["sym"], lay["tri"]
    planes = [None] * lay["n_plane"]
    sig = None
    for m, (i, j) in enumerate(SYM):
        seed = torch.zeros_like(F)
        seed[i, j] = 1.0
        seed[j, i] = 1.0
        sig, col = jvp(lambda Ft: mat.cauchy_soa(Ft, state, dt), (F,), (seed,))
        wm = 1.0 if i == j else 0.5
        for a, (ii, jj) in enumerate(SYM):
            x = col[ii, jj] * wm
            if a == m:
                planes[tri[(a, m)]] = x
            elif a > m:
                planes[tri[(m, a)]] = 0.5 * x
            else:
                planes[tri[(a, m)]] = planes[tri[(a, m)]] + 0.5 * x
    fi = soa.inv(F)
    jd = soa.det(F)
    for a, (ii, jj) in enumerate(SYM):
        planes[lay["off_sig"] + a] = sig[ii, jj]
    for r in range(dim):
        for c in range(dim):
            planes[lay["off_fi"] + r * dim + c] = fi[r, c]
    planes[lay["off_j"]] = jd
    return jd * soa.matmul_nt(sig, fi), torch.stack(planes, 0)


def tangent_planes(storage):
    """(mat, F, state, dt) -> (P, tangent planes) of `storage`."""
    return {"cauchy": cauchy_tangent_planes, "sym": sym_tangent_planes,
            "full": full_tangent_planes}[storage]


def _tangent_apply(storage, Cb, dim=3):
    """The plain apply of a tangent block held in `storage` for `dim`."""
    if Cb.shape[0] != n_planes(storage, dim):
        raise ValueError(
            f"C: {n_planes(storage, dim)} planes required for storage {storage!r} in "
            f"{dim}D, got {Cb.shape[0]}"
        )
    return {"cauchy": tangent_apply_cauchy, "sym": tangent_apply_sym,
            "full": tangent_apply_full}[storage]


def matvec_sf_plain(w_el, tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v=None, storage="cauchy"):
    """y[c, n] = sum_q wq (dN[n, d] dP[c, d] + N[n] rho w_q[c]),
    dP = fac0 (dP/dF : grad w) (+ fac1 mu_v grad w) from the block of
    `storage` (the 37-plane Cauchy decomposition, the 45 symmetric planes
    or the 81 full ones), widened to the fields' dtype."""
    dW = sf_grad(w_el, tabs, jinv)
    dP = _tangent_apply(storage, Cb)(Cb.to(w_el.dtype), dW, fac0)
    if fac1_mu_v is not None:
        dP = dP + fac1_mu_v * dW
    return sf_scatter(dP, rho * sf_value(w_el, tabs), tabs, jinv, wq)


# ---------------------------------------------------------------------------
# plain torch versions on dense tables (2D and 3D; c_storage "sym", "cauchy"
# or "full")
# ---------------------------------------------------------------------------


def dense_grad(w_el, dN_t):
    """Physical gradient dF[g, f] (C, dim, n_q, E) of the element fields
    w_el (C, nd, E), summed over n in order as the reference's
    _grad_interp (the CUDA kernels repeat this order without fused
    multiply-add, so the deformation gradients agree to the bit)."""
    nd, dim = dN_t.shape[0], dN_t.shape[1]
    rows = []
    for g in range(w_el.shape[0]):
        row = []
        for f in range(dim):
            acc = dN_t[0, f] * w_el[g, 0]
            for n in range(1, nd):
                acc = acc + dN_t[n, f] * w_el[g, n]
            row.append(acc)
        rows.append(row)
    return soa.stack2(rows)


def dense_value(w_el, N_t):
    """Values (C, n_q, E) of the element fields w_el (C, nd, E)."""
    return torch.einsum("cne,nqe->cqe", w_el, N_t)


def dense_scatter(X, vecm, dN_t, N_t, wq):
    """out[c, n] = sum_q wq (dN[n, d] X[c, d] + N[n] vecm[c]); X
    (C, dim, n_q, E) or None, vecm (C, n_q, E) or None.  Returns
    (C, nd, E)."""
    out = None
    if X is not None:
        out = torch.einsum("ndqe,cdqe->cne", dN_t, wq * X)
    if vecm is not None:
        m = torch.einsum("nqe,cqe->cne", N_t, wq * vecm)
        out = m if out is None else out + m
    return out


def tangent_apply_sym(Cs, dF, fac0):
    """dP[c, d] = fac0 sum_k C(D c + d, k) dF_k from the D2 (D2 + 1) / 2
    upper-triangle planes Cs of a major-symmetric dP/dF, D = dim of dF,
    D2 = D^2 (45 planes in 3D, 10 in 2D; k in order, as _tangent_apply)."""
    dim = dF.shape[0]
    d2 = dim * dim
    tri, _ = tri_index_map(d2)

    def C_at(a, k):
        return Cs[tri[(min(a, k), max(a, k))]]

    rows = []
    for c in range(dim):
        row = []
        for d in range(dim):
            a = dim * c + d
            acc = C_at(a, 0) * dF[0, 0]
            for k in range(1, d2):
                acc = acc + C_at(a, k) * dF[k // dim, k % dim]
            row.append(fac0 * acc)
        rows.append(row)
    return soa.stack2(rows)


def sym_tangent_planes(mat, F, state, dt):
    """(P, the symmetric planes) at F: the columns C[:, b] = dP/dF_b are
    forward-mode derivatives of `mat.pk1_soa` along the D2 one-hot seeds,
    and plane (a, b), a < b, stores 0.5 C_ba + 0.5 C_ab (the reference
    adds the transposed half first)."""
    dim = F.shape[0]
    P, cols = _jvp_columns(mat, F, state, dt)

    def C(a, b):  # dP_a / dF_b
        return cols[b][a // dim, a % dim]

    d2 = dim * dim
    planes = [
        C(a, a) if a == b else 0.5 * C(b, a) + 0.5 * C(a, b)
        for a in range(d2)
        for b in range(a, d2)
    ]
    return P, torch.stack(planes, 0)


def tangent_apply_full(Cf, dF, fac0):
    """dP[c, d] = fac0 sum_b C[a D2 + b] dF_b, a = D c + d, b = D g + f,
    from the D2^2 planes Cf of dP/dF (b in order, as _tangent_apply)."""
    dim = dF.shape[0]
    d2 = dim * dim
    rows = []
    for c in range(dim):
        row = []
        for d in range(dim):
            a = dim * c + d
            acc = Cf[a * d2] * dF[0, 0]
            for b in range(1, d2):
                acc = acc + Cf[a * d2 + b] * dF[b // dim, b % dim]
            row.append(fac0 * acc)
        rows.append(row)
    return soa.stack2(rows)


def _jvp_columns(mat, F, state, dt):
    """(P, [dP/dF_b for b in 0..D2-1]): forward-mode derivatives of
    `mat.pk1_soa` along the one-hot seeds e_b, b = D g + f, batched over
    the seeds (vmap), so the primal, and with it the radial return's
    scalar solve, runs once."""
    dim = F.shape[0]
    d2 = dim * dim
    seeds = torch.zeros((d2, *F.shape), dtype=F.dtype, device=F.device)
    for b in range(d2):
        seeds[b, b // dim, b % dim] = 1.0
    P, cols = vmap(lambda s: jvp(lambda Ft: mat.pk1_soa(Ft, state, dt), (F,), (s,)))(seeds)
    return P[0], list(cols)


def full_tangent_planes(mat, F, state, dt):
    """(P, the D2^2 planes C[a D2 + b] = dP_a / dF_b), a = D c + d
    indexing P and b = D g + f indexing F, from D2 forward-mode
    derivatives of `mat.pk1_soa` (the reference's `full` storage,
    flattened)."""
    dim = F.shape[0]
    d2 = dim * dim
    P, cols = _jvp_columns(mat, F, state, dt)
    return P, torch.stack(
        [cols[b][a // dim, a % dim] for a in range(d2) for b in range(d2)], 0
    )


def residual_dense_plain(u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho,
                         v_el=None, mu_v=0.0):
    """y[c, n] = sum_q wq (dN[n, d] (P(F) + mu_v dV)[c, d] + N[n] rho
    a_q[c]), F = I + grad u, dV = grad v (none when v_el is None)."""
    P = mat.pk1_soa(soa.add_diag(dense_grad(u_el, dN_t), 1.0), state, dt)
    if v_el is not None:
        P = P + mu_v * dense_grad(v_el, dN_t)
    return dense_scatter(P, rho * dense_value(a_el, N_t), dN_t, N_t, wq)


def assemble_dense_plain(u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho,
                         v_el=None, mu_v=0.0, c_dtype=None, storage=None):
    """Residual (as residual_dense_plain) plus the tangent block in
    `storage` (default: the material's), stored in `c_dtype` (default: the
    fields' dtype): "sym", the symmetric planes of `sym_tangent_planes` (the
    hyperelastic materials), "cauchy", the planes of `cauchy_tangent_planes`
    (J2, J2Linear), or "full", the dim^4 planes of `full_tangent_planes`
    (any material; J2Simo's and J2Log's own)."""
    F = soa.add_diag(dense_grad(u_el, dN_t), 1.0)
    P, Cb = tangent_planes(storage or tangent_storage(mat))(mat, F, state, dt)
    if v_el is not None:
        P = P + mu_v * dense_grad(v_el, dN_t)
    y = dense_scatter(P, rho * dense_value(a_el, N_t), dN_t, N_t, wq)
    return y, Cb if c_dtype is None else Cb.to(c_dtype)


def matvec_dense_plain(w_el, dN_t, N_t, wq, Cb, rho, fac0, fac1_mu_v=None, storage="sym"):
    """y[c, n] = sum_q wq (dN[n, d] dP[c, d] + N[n] rho w_q[c]),
    dP = fac0 (dP/dF : grad w) (+ fac1 mu_v grad w) from the block of
    `storage` ("sym", "cauchy" or "full").  The block and the tables (a
    bfloat16 block comes with bfloat16 copies of dN and N, the reference's
    dN_mv / N_mv) are widened to the fields' dtype before any arithmetic,
    as the kernels widen them on load."""
    dN_t, N_t = dN_t.to(w_el.dtype), N_t.to(w_el.dtype)
    dW = dense_grad(w_el, dN_t)
    dP = _tangent_apply(storage, Cb, dN_t.shape[1])(Cb.to(w_el.dtype), dW, fac0)
    if fac1_mu_v is not None:
        dP = dP + fac1_mu_v * dW
    return dense_scatter(dP, rho * dense_value(w_el, N_t), dN_t, N_t, wq)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


class _J2Params(ctypes.Structure):
    """Mirror of struct J2Params in csrc/j2.cuh, field by field."""

    _fields_ = [
        (name, ctypes.c_float)
        for name in (
            "K", "G", "A", "B", "n", "C", "eps0_dot", "t_ref", "t_melt",
            "m", "thermo_const", "tol", "xtol", "dt", "rho",
        )
    ] + [
        (name, ctypes.c_int)
        for name in ("rate_dep", "thermo_mode", "max_iter", "law", "pow_mode", "dpow_mode",
                     "m_mode")
    ] + [
        (name, ctypes.c_float)
        for name in (
            "pw", "dpw", "sigma_y", "inv_eps0", "dh_coef", "sigma_sat", "sat_diff", "inv_c",
            "dv_coef", "g3", "inv_g3", "inv_dt", "inv_eps0_dot", "inv_dtemp", "h_iso",
            "h_kin", "sqrt6_g", "inv_denom",
        )
    ]


# J2Params' pow modes of an exponent e: how torch's pow(tensor, e) evaluates
# it on the card (sqrt, x x, x x x, rsqrt, 1 / x, 1 / (x x), x, 1); powf
# (0) otherwise
_POW_MODES = {0.5: 1, 2.0: 2, 3.0: 3, -0.5: 4, -1.0: 5, -2.0: 6, 1.0: 7, 0.0: 8}


def _pow_params(pw, dpw):
    """J2Params fields of the flow stress's exponent pw and its
    derivative's dpw (each taken in double, as torch gets it)."""
    return dict(pw=pw, dpw=dpw, pow_mode=_POW_MODES.get(float(pw), 0),
                dpow_mode=_POW_MODES.get(float(dpw), 0))


def _j2_params(mat, dt, rho, family=("J2",)):
    """Kernel parameters of a set-up material of the J2 family (a class
    named in `family`): J2Linear's moduli, or the elastic constants, the
    return's tolerances and the hardening law (the Johnson-Cook family,
    PowerLaw or Voce) of J2, J2Simo and J2Log.  A tensor divided by a
    Python number d is multiplied by float(1 / d) on the card, so the
    reciprocals are taken here in double."""
    from ..materials import _K_TOL
    from ..materials import hardening as H

    if mat.name() not in family:
        raise NotImplementedError(
            f"the CUDA sweeps implement {' and '.join(family)} with this storage, "
            f"not {mat.name()}"
        )
    if mat.name() == "J2Linear":
        G, h_iso, h_kin = mat.G, mat.isotropic_hardening, mat.kinematic_hardening
        return _J2Params(
            K=mat.K, G=G, dt=dt, rho=rho, sigma_y=mat.sigma_y, h_iso=h_iso, h_kin=h_kin,
            sqrt6_g=math.sqrt(6.0) * G, inv_denom=1.0 / (3.0 * G + h_kin + h_iso),
        )
    h = mat.hardening
    base = dict(K=mat.K, G=mat.G, tol=mat._tolerance, xtol=_K_TOL, dt=dt, rho=rho,
                max_iter=KERNEL_SOLVE_TRIPS, g3=3.0 * mat.G, inv_g3=1.0 / (3.0 * mat.G), inv_dt=1.0 / dt)
    if isinstance(h, H.PowerLawHardening):
        return _J2Params(
            **base, **_pow_params(1.0 / h.n, 1.0 / h.n - 1.0), law=LAW_KERNELS[h.name()][0],
            sigma_y=h.sigma_y, inv_eps0=1.0 / h.eps0, dh_coef=h.sigma_y / (h.n * h.eps0),
        )
    if isinstance(h, H.VoceHardening):
        return _J2Params(
            **base, law=LAW_KERNELS[h.name()][0], sigma_y=h.sigma_y, sigma_sat=h.sigma_sat,
            sat_diff=h.sigma_sat - h.sigma_y, inv_c=1.0 / h.strain_constant,
            dv_coef=(h.sigma_sat - h.sigma_y) / h.strain_constant,
        )
    if not isinstance(h, H.JohnsonCookHardening):
        raise NotImplementedError(
            f"the CUDA sweeps implement the Johnson-Cook family, PowerLaw and Voce "
            f"hardening, not {h.name()}"
        )
    rate = isinstance(h, H.JohnsonCookRateDependentHardening)
    if isinstance(h, H.JohnsonCookViscoConstantTemperatureHardening):
        thermo_mode, thermo_const = 2, float(h._temperature_contribution)
    elif isinstance(h, H.JohnsonCookTemperatureAndRateDependentHardening):
        thermo_mode, thermo_const = 1, 1.0
    else:
        thermo_mode, thermo_const = 0, 1.0
    t_ref = getattr(h, "reference_temperature", 0.0)
    t_melt = getattr(h, "melting_temperature", 1.0)
    eps0_dot, m = getattr(h, "eps0_dot", 1.0), getattr(h, "m", 1.0)
    return _J2Params(
        **base, **_pow_params(h.n, h.n - 1.0), A=h.A, B=h.B, n=h.n, C=getattr(h, "C", 0.0),
        eps0_dot=eps0_dot, inv_eps0_dot=1.0 / eps0_dot, t_ref=t_ref, t_melt=t_melt,
        inv_dtemp=1.0 / (t_melt - t_ref) if t_melt != t_ref else 0.0, m=m,
        m_mode=_POW_MODES.get(float(m), 0), thermo_const=thermo_const, rate_dep=int(rate),
        thermo_mode=thermo_mode,
    )


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} required, got {tuple(t.shape)}")


def _check(name, t, shape, device, dtype=torch.float32):
    _check_shape(name, t, shape)
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: {dtype} on {device} required, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")


def _check_device(device):
    if device.type != "cuda":
        raise ValueError(f"CUDA sweep called on a {device} tensor")


def _check_common(el_fields, tabs, jinv, wq):
    """Validate the shared sum-factorized operands; returns (device, n_el,
    p + 1, n_g), the shape of the kernels to launch (any degree and Gauss
    count).  Shapes that do not fit together raise ValueError, before the
    device is asked."""
    el_fields = [(n, t) for n, t in el_fields if t is not None]
    if len(tabs) != 6:
        raise ValueError(f"tabs: 6 one-dimensional tables required, got {len(tabs)}")
    n_g, p1, n_el = tabs[0].shape
    nd, n_q = p1**3, n_g**3
    for name, t in el_fields:
        _check_shape(name, t, (3, nd, n_el))
    for k, t in enumerate(tabs):
        _check_shape(f"tabs[{k}]", t, (n_g, p1, n_el))
    _check_shape("jinv", jinv, (3, 3, n_q, n_el))
    _check_shape("wq", wq, (n_q, n_el))
    device = el_fields[0][1].device
    _check_device(device)
    for name, t in el_fields:
        _check(name, t, (3, nd, n_el), device)
    for k, t in enumerate(tabs):
        _check(f"tabs[{k}]", t, (n_g, p1, n_el), device)
    _check("jinv", jinv, (3, 3, n_q, n_el), device)
    _check("wq", wq, (n_q, n_el), device)
    return device, n_el, p1, n_g


def _state_ptrs(state, leaves, dim, n_q, n_el, device):
    """Pointers to the state leaves named in `leaves` (None: a null
    pointer), each checked as (dim, dim, n_q, n_el) or (n_q, n_el)."""
    for k in filter(None, leaves):
        _check(k, state[k], (dim, dim, n_q, n_el) if state[k].dim() == 4 else (n_q, n_el), device)
    return [_ptr(None if k is None else state[k]) for k in leaves]


def _cauchy_state(mat, state, dim, n_q, n_el, device):
    """(material id, the entry points' four state pointers ps, eqps, temp,
    beta) of a CAUCHY_KERNELS material, its leaves checked."""
    mat_id, _, leaves = CAUCHY_KERNELS[mat.name()]
    return mat_id, _state_ptrs(state, leaves, dim, n_q, n_el, device)


def _c_flag(c_dtype):
    """Kernel flag of a tangent-block storage dtype: 0 float32, 1 bf16."""
    if c_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tangent block dtype {c_dtype}: float32 or bfloat16 required")
    return int(c_dtype == torch.bfloat16)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _lib(kind, key):
    """The kernel library of `kind` ("sf" or "dense") at the shape `key`,
    built at its first request (ops/build.py load); its counters are named
    once, at that first request."""
    lib = build.load(kind, key)
    if (kind, key) not in _NAMED:
        register_shape(kind, key)
        _NAMED.add((kind, key))
    return lib


def logm_deep_sweeps():
    """J2Log sweeps on the card (residual and assemble, sf and dense) whose
    deep log-series launch ran, summed over the libraries loaded so far:
    each such sweep had a point out of the fast series' range and took the
    deep series at every point (csrc/finite.cuh).  Reads the device's
    counters, so it waits for the device."""
    n, total = ctypes.c_longlong(0), 0
    for (kind, _), lib in build._LIBS.items():
        names = ["mimi_logm_deep_sf_finite"] if kind == "sf" else [
            "mimi_logm_deep_dense_finite", "mimi_logm_deep_dense_finite_bf16"]
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
            err = fn(ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"{name} failed: CUDA error {err}")
            total += n.value
    return total


def _launch(fn, name, *args):
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    LAUNCHES[name] += 1
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


class _HyperParams(ctypes.Structure):
    """Mirror of struct HyperelasticParams in csrc/materials.cuh."""

    _fields_ = [(name, ctypes.c_float) for name in ("mu", "lam", "rho")]


def _hyper_params(mat, rho):
    """(parameter block, material id, counter tag) of a hyperelastic
    material the CUDA kernels instantiate."""
    if type(mat).__name__ not in HYPER_KERNELS:
        raise NotImplementedError(
            f"of the hyperelastic materials the CUDA sweeps implement "
            f"{' and '.join(HYPER_KERNELS)}, not {mat.name()} (ROADMAP Queue 1 item 2)"
        )
    return (_HyperParams(mu=mat.mu, lam=mat.lambda_, rho=rho), *HYPER_KERNELS[type(mat).__name__])


def _finite_state(mat, state, dim, n_q, n_el, device):
    """(material id, the entry points' four state pointers) of a
    FULL_KERNELS material, its leaves checked."""
    mat_id, _, leaves = FULL_KERNELS[mat.name()]
    return mat_id, _state_ptrs(state, (*leaves, *[None] * (4 - len(leaves))), dim, n_q, n_el,
                               device)


def _block_storage(mat, storage):
    """The storage of the material's tangent block: its own
    (`tangent_storage`) unless "full" is asked, the one storage every
    material's kernels also write."""
    own = tangent_storage(mat)
    storage = storage or own
    if storage not in (own, "full"):
        raise ValueError(
            f"{mat.name()}'s kernels write its own {own!r} tangent block or the 'full' one, "
            f"not {storage!r}"
        )
    return own, storage


def _material_args(mat, state, dt, rho, dim, n_q, n_el, device, kind):
    """(C entry-point stem, parameter block, material id, state pointers) of
    the material's kernels on `kind` tables: the hyperelastic ones
    (HYPER_KERNELS, stateless), J2 and J2Linear (CAUCHY_KERNELS) or J2Simo
    and J2Log (FULL_KERNELS)."""
    own = tangent_storage(mat)
    if own == "sym":
        if state is not None:
            raise NotImplementedError(
                "a stateful material with the symmetric storage: no such material is "
                "ported (ROADMAP Queue 1 item 2)"
            )
        prm, mat_id, _ = _hyper_params(mat, rho)
        return ("_sf_hyper" if kind == "sf" else "_dense"), prm, mat_id, ()
    table = FULL_KERNELS if own == "full" else CAUCHY_KERNELS
    prm = _j2_params(mat, dt, rho, family=tuple(table))
    mat_id, st = (_finite_state if own == "full" else _cauchy_state)(
        mat, state, dim, n_q, n_el, device)
    stem = {("sf", "cauchy"): "_sf", ("sf", "full"): "_sf_finite",
            ("dense", "cauchy"): "_dense_j2", ("dense", "full"): "_dense_finite"}[(kind, own)]
    return stem, prm, mat_id, tuple(st)


def _sf_sweep(assemble, u_el, a_el, state, tabs, jinv, wq, mat, dt, rho, v_el=None, mu_v=0.0,
              c_dtype=torch.float32, storage=None):
    """The material's residual (or, with `assemble`, residual and tangent
    block in `storage` and c_dtype) kernel on sum-factorized tables, with the
    viscous flux where v_el is given: `mimi_residual_sf` / `mimi_assemble_sf`
    (J2 with any of the five hardening laws, J2Linear), `..._sf_hyper` (the
    hyperelastic materials) or `..._sf_finite` (J2Simo, J2Log), of the
    library at the tables' (p + 1, n_g)."""
    own, storage = _block_storage(mat, storage)
    bf16 = _c_flag(c_dtype)
    device, n_el, p1, n_g = _check_common(
        [("u_el", u_el), ("a_el", a_el), ("v_el", v_el)], tabs, jinv, wq
    )
    n_q = n_g**3
    stem, prm, mat_id, st = _material_args(mat, state, dt, rho, 3, n_q, n_el, device, "sf")
    lib = _lib("sf", (p1, n_g))
    names = kernel_counters(mat, "sf", 3, (p1, n_g), visc=v_el is not None, bf16=bool(bf16),
                            storage=storage)
    out = torch.empty((3, p1**3, n_el), dtype=torch.float32, device=device)
    head = (_ptr(u_el), _ptr(a_el), _ptr(v_el), *[_ptr(t) for t in tabs], _ptr(jinv),
            _ptr(wq), *st, _ptr(out))
    tail = (prm, ctypes.c_float(mu_v), ctypes.c_int(mat_id), ctypes.c_longlong(n_el))
    if not assemble:
        _launch(getattr(lib, f"mimi_residual{stem}"), names[0], *head, *tail)
        return out
    cb = torch.empty((n_planes(storage), n_q, n_el), dtype=c_dtype, device=device)
    # the full-storage switch of the materials with a stronger own storage
    full = () if own == "full" else (ctypes.c_int(int(storage == "full")),)
    _launch(getattr(lib, f"mimi_assemble{stem}"), names[1], *head, _ptr(cb), ctypes.c_int(bf16),
            *full, *tail)
    return out, cb


def residual_sf(u_el, a_el, state, tabs, jinv, wq, mat, dt, rho, v_el=None, mu_v=0.0):
    """Residual sweep: plain torch on CPU tensors; on CUDA tensors the
    kernel `mimi_residual_sf` (J2 with any of the five hardening laws,
    J2Linear), `mimi_residual_sf_hyper` (the hyperelastic materials) or
    `mimi_residual_sf_finite` (J2Simo, J2Log), each with the viscous flux
    when v_el is given."""
    if u_el.device.type == "cpu":
        return residual_sf_plain(u_el, a_el, state, tabs, jinv, wq, mat, dt, rho, v_el, mu_v)
    return _sf_sweep(False, u_el, a_el, state, tabs, jinv, wq, mat, dt, rho, v_el, mu_v)


def assemble_sf(u_el, a_el, state, tabs, jinv, wq, mat, dt, rho, v_el=None,
                mu_v=0.0, c_dtype=None, storage=None):
    """Assemble sweep: (residual, tangent block in `storage`, by default the
    material's, and in `c_dtype`, by default the fields' dtype); plain torch
    on CPU tensors; on CUDA tensors the kernel `mimi_assemble_sf` (J2 with
    any of the five hardening laws, J2Linear: the 37 Cauchy planes of the
    closed-form algorithmic tangent), `mimi_assemble_sf_hyper` (the
    hyperelastic materials, the 45 symmetric planes of the closed-form
    dP/dF), each also with the 81 full planes from the same closed forms,
    or `mimi_assemble_sf_finite` (J2Simo, J2Log: 81 planes from 9
    forward-mode dual-number passes), each with the viscous flux when v_el
    is given and the block in float32 or bfloat16."""
    c_dtype = c_dtype or u_el.dtype
    if u_el.device.type == "cpu":
        return assemble_sf_plain(
            u_el, a_el, state, tabs, jinv, wq, mat, dt, rho, v_el, mu_v, c_dtype, storage
        )
    return _sf_sweep(True, u_el, a_el, state, tabs, jinv, wq, mat, dt, rho, v_el, mu_v,
                     c_dtype, storage)


# the sf and dense matvec entry points by storage
_MATVEC_FNS = {
    "sf": {"cauchy": "mimi_matvec_sf", "sym": "mimi_matvec_sf_sym", "full": "mimi_matvec_sf_full"},
    "dense": {"cauchy": "mimi_matvec_dense_cauchy", "sym": "mimi_matvec_dense",
              "full": "mimi_matvec_dense_full"},
}


def matvec_sf(w_el, tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v=None, storage="cauchy"):
    """GMRES matvec sweep on the block of `storage`: plain torch on CPU
    tensors; on CUDA tensors the kernel `mimi_matvec_sf` ("cauchy", 37
    planes), `mimi_matvec_sf_sym` ("sym", 45 planes) or `mimi_matvec_sf_full`
    ("full", 81 planes), each on a float32 or bfloat16 block with the
    viscous term when fac1_mu_v is given."""
    if w_el.device.type == "cpu":
        return matvec_sf_plain(w_el, tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v, storage)
    return _sf_matvec(w_el, tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v, storage)


def _sf_matvec(w_el, tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v=None, storage="cauchy"):
    """The sf matvec kernel of `storage` (_MATVEC_FNS) on a float32 or
    bfloat16 block, with the viscous term when fac1_mu_v is given."""
    _tangent_apply(storage, Cb)
    visc = fac1_mu_v is not None
    device, n_el, p1, n_g = _check_common([("w_el", w_el)], tabs, jinv, wq)
    out = torch.empty((3, p1**3, n_el), dtype=torch.float32, device=device)
    bf16 = _c_flag(Cb.dtype)
    _check("C", Cb, (n_planes(storage), n_g**3, n_el), device, Cb.dtype)
    _launch(
        getattr(_lib("sf", (p1, n_g)), _MATVEC_FNS["sf"][storage]),
        matvec_counter("sf", storage, 3, (p1, n_g), visc, bool(bf16)),
        _ptr(w_el), *[_ptr(t) for t in tabs], _ptr(jinv), _ptr(wq), _ptr(Cb),
        ctypes.c_int(bf16), _ptr(out), ctypes.c_float(rho), ctypes.c_float(fac0),
        ctypes.c_int(int(visc)), ctypes.c_float(fac1_mu_v if visc else 0.0),
        ctypes.c_longlong(n_el),
    )
    return out


def _check_dense(el_fields, dN_t, N_t, wq, table_dtype=torch.float32):
    """Validate the dense operands, the tables dN_t and N_t in
    `table_dtype` (float32, or bfloat16 for the bfloat16 matvec); returns
    (device, n_el, (dim, nd, n_q)), the shape key of the kernels to launch:
    any dofs and points per element in 2D or 3D (any degree, quadrature
    order, degrees that differ per axis).  Shapes that do not fit together
    raise ValueError, before the device is asked."""
    if dN_t.dim() != 4:
        raise ValueError(f"dN_t: (nd, dim, n_q, n_el) required, got {tuple(dN_t.shape)}")
    nd, dim, n_q, n_el = dN_t.shape
    if dim not in (2, 3) or nd < 1 or n_q < 1:
        raise ValueError(f"dN_t: (nd, dim, n_q, n_el) with dim 2 or 3 and nd, n_q >= 1 "
                         f"required, got {tuple(dN_t.shape)}")
    for name, t in el_fields:
        _check_shape(name, t, (dim, nd, n_el))
    _check_shape("N_t", N_t, (nd, n_q, n_el))
    _check_shape("wq", wq, (n_q, n_el))
    device = dN_t.device
    _check_device(device)
    for name, t in el_fields:
        _check(name, t, (dim, nd, n_el), device)
    _check("dN_t", dN_t, (nd, dim, n_q, n_el), device, table_dtype)
    _check("N_t", N_t, (nd, n_q, n_el), device, table_dtype)
    _check("wq", wq, (n_q, n_el), device)
    return device, n_el, (dim, nd, n_q)


def _dense_sweep(assemble, u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho, v_el=None,
                 mu_v=0.0, storage=None, c_dtype=torch.float32):
    """The dense residual (or, with `assemble`, residual and tangent block
    in `storage`, by default the material's, and in c_dtype, float32 or
    bfloat16) kernel of the material, with the viscous flux when v_el is
    given: the hyperelastic ones (`mimi_residual_dense` /
    `mimi_assemble_dense`: the symmetric or the full block), J2 (any of the
    five hardening laws) and J2Linear with their state
    (`mimi_residual_dense_j2` / `mimi_assemble_dense_j2`: the Cauchy or the
    full block), J2Simo and J2Log with their state
    (`mimi_residual_dense_finite` / `mimi_assemble_dense_finite`: full); a
    bfloat16 block from the assembles' `_bf16` twins; the library of the
    tables' (dim, nd, n_q)."""
    own, storage = _block_storage(mat, storage)
    bf16 = _c_flag(c_dtype)
    fields = [("u_el", u_el), ("a_el", a_el)] + ([("v_el", v_el)] if v_el is not None else [])
    device, n_el, key = _check_dense(fields, dN_t, N_t, wq)
    dim, _, n_q = key
    stem, prm, mat_id, st = _material_args(mat, state, dt, rho, dim, n_q, n_el, device, "dense")
    head = (_ptr(u_el), _ptr(a_el), _ptr(v_el), _ptr(dN_t), _ptr(N_t), _ptr(wq), *st)
    tail = (prm, ctypes.c_float(mu_v), ctypes.c_int(mat_id), *map(ctypes.c_int, key),
            ctypes.c_longlong(n_el))
    names = kernel_counters(mat, "dense", dim, key, v_el is not None, bool(bf16), storage)
    out = torch.empty((dim, u_el.shape[1], n_el), dtype=torch.float32, device=device)
    lib = _lib("dense", key)
    if not assemble:
        _launch(getattr(lib, f"mimi_residual{stem}"), names[0], *head, _ptr(out), *tail)
        return out
    cb = torch.empty((n_planes(storage, dim), n_q, n_el), dtype=c_dtype, device=device)
    full = () if own == "full" else (ctypes.c_int(int(storage == "full")),)
    _launch(getattr(lib, f"mimi_assemble{stem}{'_bf16' if bf16 else ''}"), names[1], *head,
            _ptr(out), _ptr(cb), *full, *tail)
    return out, cb


def residual_dense(u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho, v_el=None, mu_v=0.0):
    """Dense residual sweep: plain torch on CPU tensors; on CUDA tensors the
    kernel `mimi_residual_dense` (the hyperelastic materials),
    `mimi_residual_dense_j2` (J2 with any of the five hardening laws,
    J2Linear) or `mimi_residual_dense_finite` (J2Simo, J2Log), each with the
    viscous flux when v_el is given, at the tables' (dim, nd, n_q)."""
    if u_el.device.type == "cpu":
        return residual_dense_plain(u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho, v_el, mu_v)
    return _dense_sweep(False, u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho, v_el, mu_v)


def assemble_dense(u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho, v_el=None,
                   mu_v=0.0, c_dtype=None, storage=None):
    """Dense assemble sweep: (residual, tangent block in `storage`, by
    default the material's, and in `c_dtype`, by default the fields'
    dtype); plain torch on CPU tensors; on CUDA tensors the kernel
    `mimi_assemble_dense` (the hyperelastic materials' closed-form dP/dF,
    the symmetric or full planes), `mimi_assemble_dense_j2` (the closed-form
    algorithmic tangent of J2 or J2Linear, the Cauchy or full planes) or
    `mimi_assemble_dense_finite` (J2Simo, J2Log: the dim^4 planes of dP/dF
    from dim^2 forward-mode dual-number passes), each with the viscous flux
    when v_el is given and the block in float32 or bfloat16 (their `_bf16`
    twins), from the float32 tables."""
    c_dtype = c_dtype or u_el.dtype
    if u_el.device.type == "cpu":
        return assemble_dense_plain(
            u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho, v_el, mu_v, c_dtype, storage
        )
    return _dense_sweep(True, u_el, a_el, state, dN_t, N_t, wq, mat, dt, rho, v_el, mu_v,
                        storage, c_dtype)


def _dense_matvec(w_el, dN_t, N_t, wq, Cb, rho, fac0, storage, fac1_mu_v=None):
    """The dense matvec kernel of `storage`: `mimi_matvec_dense` ("sym"),
    `mimi_matvec_dense_cauchy` ("cauchy") or `mimi_matvec_dense_full`
    ("full"), each with the viscous term when fac1_mu_v is given; a
    bfloat16 block through their `_bf16` twins, which read dN_t and N_t as
    bfloat16 copies too (the reference's dN_mv / N_mv)."""
    bf16 = _c_flag(Cb.dtype)
    if dN_t.dtype != Cb.dtype or N_t.dtype != Cb.dtype:
        raise ValueError(
            f"the dense matvec reads its tables in the block's dtype ({Cb.dtype}: the "
            f"bfloat16 block comes with bfloat16 copies of dN and N), got dN_t "
            f"{dN_t.dtype}, N_t {N_t.dtype}"
        )
    device, n_el, key = _check_dense([("w_el", w_el)], dN_t, N_t, wq, Cb.dtype)
    dim = key[0]
    _check("C", Cb, (n_planes(storage, dim), wq.shape[0], n_el), device, Cb.dtype)
    out = torch.empty((dim, w_el.shape[1], n_el), dtype=torch.float32, device=device)
    visc = fac1_mu_v is not None
    _launch(
        getattr(_lib("dense", key), _MATVEC_FNS["dense"][storage] + ("_bf16" if bf16 else "")),
        matvec_counter("dense", storage, dim, key, visc, bool(bf16)),
        _ptr(w_el), _ptr(dN_t), _ptr(N_t), _ptr(wq), _ptr(Cb), _ptr(out),
        ctypes.c_float(rho), ctypes.c_float(fac0), ctypes.c_int(int(visc)),
        ctypes.c_float(fac1_mu_v if visc else 0.0), *map(ctypes.c_int, key),
        ctypes.c_longlong(n_el),
    )
    return out


def matvec_dense(w_el, dN_t, N_t, wq, Cb, rho, fac0, fac1_mu_v=None, storage="sym"):
    """Dense GMRES matvec sweep on the block of `storage`: plain torch on
    CPU tensors; on CUDA tensors the kernel `mimi_matvec_dense` ("sym"),
    `mimi_matvec_dense_cauchy` ("cauchy") or `mimi_matvec_dense_full`
    ("full"), each with the viscous term when fac1_mu_v is given, on a
    float32 block and float32 tables or a bfloat16 block and bfloat16
    copies of dN_t and N_t (the `_bf16` twins)."""
    if w_el.device.type == "cpu":
        return matvec_dense_plain(w_el, dN_t, N_t, wq, Cb, rho, fac0, fac1_mu_v, storage)
    return _dense_matvec(w_el, dN_t, N_t, wq, Cb, rho, fac0, storage, fac1_mu_v)
