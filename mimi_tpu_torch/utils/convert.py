"""Carry problems, materials and step state across from the reference
package (mimi_tpu) and back, through numpy.

These functions read plain attributes and numpy-convertible fields only
and load no JAX module, so a caller holding objects of the reference
package can run both packages on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import splines as _splines
from ..config import default_dtype, resolve_device
from ..contact.scene import NearestDistanceToSplines
from ..materials import (
    J2,
    CompressibleOgdenNeoHookean,
    J2Linear,
    J2Log,
    J2Simo,
    StVenantKirchhoff,
)
from ..materials import hardening as _hardening
from ..parallel.sharding import Problem


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


_ELASTIC = ("density", "viscosity", "lambda_", "mu", "young", "poisson", "K", "G")
_J2_FAMILY = {cls.__name__: cls for cls in (J2, J2Simo, J2Log)}
# the materials without a hardening law: (class, their own parameters
# beside the elastic ones)
_NO_LAW = {
    cls.__name__: (cls, own)
    for cls, own in (
        (CompressibleOgdenNeoHookean, ()),
        (StVenantKirchhoff, ()),
        (J2Linear, ("isotropic_hardening", "kinematic_hardening", "sigma_y")),
    )
}


def material_from_reference(mat):
    """The port's counterpart of a reference-package material (J2, J2Simo or
    J2Log with any hardening law, J2Linear, CompressibleOgdenNeoHookean or
    StVenantKirchhoff), with its parameters copied and set up for the same
    dimension when the reference material was."""
    name = type(mat).__name__
    if name in _NO_LAW:
        cls, own = _NO_LAW[name]
        out = cls()
        for k in _ELASTIC + own:
            setattr(out, k, float(getattr(mat, k)))
        if hasattr(mat, "dim"):
            out.setup(mat.dim)
        return out
    if name not in _J2_FAMILY:
        raise NotImplementedError(f"{name} is not ported")
    out = _J2_FAMILY[name]()
    for k in _ELASTIC + (
        "heat_fraction", "specific_heat", "initial_temperature", "melting_temperature",
    ):
        setattr(out, k, float(getattr(mat, k)))
    if mat.hardening is not None:
        h = getattr(_hardening, type(mat.hardening).__name__)()
        for k, v in vars(mat.hardening).items():
            setattr(h, k, float(v) if isinstance(v, (int, float)) else v)
        out.hardening = h
    if hasattr(mat, "dim"):
        out.setup(mat.dim)
    return out


def scene_from_reference(scene):
    """The port's NearestDistanceToSplines rebuilt from a reference-package
    scene: its splines' degrees, knot vectors, control points and
    weights, its planted seed samples and penalty."""
    out = NearestDistanceToSplines()
    out.coefficient = float(scene.coefficient)
    for s in scene.splines:
        cls = getattr(_splines, type(s).__name__)
        sp = _splines._SplineBase.__new__(cls)
        _splines._SplineBase.__init__(
            sp, s.degrees, s.knot_vectors, np.array(s.cps),
            None if s.weights is None else np.array(s.weights),
        )
        out.add_spline(sp)
    if scene._samples is not None:
        out._samples = [np.array(a) for a in scene._samples]
    return out


def _contact_from_reference(ref, scenes, dtype, device):
    """The port's contact blocks of a reference Problem (no padding); the
    scene data is the reference's, the queries come from `scenes`."""
    if len(scenes) != len(ref.contact):
        raise ValueError(f"{len(ref.contact)} contact blocks need as many scenes")
    data, static = [], []
    for cd, cs, scene in zip(ref.contact, ref.contact_static, scenes):
        port_scene = scene_from_reference(scene)
        ints = {"conn", "ldof"}
        blk = {
            k: torch.tensor(np.asarray(cd[k]), dtype=torch.int64 if k in ints else dtype,
                            device=device)
            for k in ("conn", "N", "dN", "wq", "nsign", "ldof", "x_ref_el")
        }
        if float(np.asarray(cd["wq"]).min()) == 0.0:
            raise NotImplementedError("padded contact blocks (ROADMAP Queue 1 item 8)")
        blk["scene"] = [
            {k: _tensor(v, dtype, device) for k, v in sd.items()} for sd in cd["scene"]
        ]
        blk["penalty"] = float(np.asarray(cd["penalty"]))
        data.append(blk)
        static.append(
            {"n_local": int(cs["n_local"]), "query": port_scene.make_batched_query(),
             "bid": cs["bid"]}
        )
    return data, static


def problem_from_numpy(ref, material=None, dtype=None, device="cuda", scenes=None):
    """A port `Problem` on `device` (the card unless "cpu" is passed) from
    a reference-package `Problem` with no element padding: one with `sf`
    tables and a structured `grid` keeps the sum-factorized tables; any
    other (multi-patch, repeated interior knots) carries the dense tables
    N, dN_dX and w_detJ in the batch-last layout, its connectivity and its
    FDM data (the multi-patch additive-Schwarz form included).  `dtype`
    defaults to the reference problem's float type.  A problem with
    contact blocks needs the reference scenes it was built with
    (`scenes`, one per block)."""
    device = resolve_device(device)
    if ref.n_el != np.asarray(ref.conn).shape[0] or (
        ref.grid is not None and ref.n_el != int(np.prod(ref.grid["spans"]))
    ):
        raise NotImplementedError("padded element batches (ROADMAP Queue 1 item 8)")
    rhs = np.asarray(ref.rhs)
    if dtype is None:
        dtype = torch.float64 if rhs.dtype == np.float64 else torch.float32
    mat = material if material is not None else material_from_reference(ref.material)
    state0 = None
    if ref.state0 is not None:
        if not ref.state_soa:
            raise NotImplementedError("per-quad state layout; SoA expected")
        state0 = {k: _tensor(v, dtype, device) for k, v in ref.state0.items()}
    contact, contact_static = _contact_from_reference(ref, scenes or [], dtype, device)
    conn = np.asarray(ref.conn)
    tables = dict(grid=None, sf=None, dense=None, connT=None)
    if ref.sf is not None and ref.grid is not None:
        tables.update(
            grid=dict(ref.grid),
            sf={
                "tables": [_tensor(t, dtype, device) for t in ref.sf["tables"]],
                "jinv": _tensor(ref.sf["jinv"], dtype, device),
                "n_g": int(ref.sf["n_g"]),
                "pp1": int(ref.sf["pp1"]),
            },
        )
    else:
        tables.update(
            connT=torch.tensor(conn.T, dtype=torch.int64, device=device),
            dense={
                "dN_t": _tensor(np.transpose(ref.dN_dX, (2, 3, 1, 0)), dtype, device),
                "N_t": _tensor(np.transpose(ref.N, (2, 1, 0)), dtype, device),
            },
        )
    return Problem(
        material=mat,
        n_dof=int(ref.n_dof),
        dim=int(ref.dim),
        n_el=int(ref.n_el),
        n_q=int(ref.n_q),
        conn=conn,
        wdet_t=_tensor(np.asarray(ref.w_detJ).T, dtype, device),
        rhs=_tensor(rhs, dtype, device),
        free=_tensor(ref.free, dtype, device),
        facs=dict(ref.facs),
        state0=state0,
        fdm=ref.fdm,
        **tables,
        contact=contact,
        contact_static=contact_static,
    )


def carry_from_numpy(carry, dtype=None, device="cuda"):
    """A port step carry on `device` (the card unless "cpu" is passed; dtype
    by default config.default_dtype) from a dict with "u", "v", "a"
    (n_dof, dim), "state" (SoA leaves) and, with contact, "contact" (per
    block a dict of observables) arrays; "newton" is reset."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)

    def obs(v):
        a = np.asarray(v)
        return torch.tensor(a, dtype=dtype if a.dtype.kind == "f" else torch.int64,
                            device=device)

    return {
        "u": _tensor(carry["u"], dtype, device),
        "v": _tensor(carry["v"], dtype, device),
        "a": _tensor(carry["a"], dtype, device),
        "state": None
        if carry.get("state") is None
        else {k: _tensor(v, dtype, device) for k, v in carry["state"].items()},
        "newton": {
            "norm0": 0.0,
            "norm": 0.0,
            "iters": 0,
            "lin_iters": 0,
            "converged": True,
            "finite": True,
        },
        "contact": [
            {k: obs(v) for k, v in blk.items()} for blk in carry.get("contact", [])
        ],
    }


def carry_to_numpy(carry):
    """The fields of a port step carry as numpy arrays."""
    out = {k: carry[k].detach().cpu().numpy() for k in ("u", "v", "a")}
    out["state"] = (
        None
        if carry["state"] is None
        else {k: v.detach().cpu().numpy() for k, v in carry["state"].items()}
    )
    out["newton"] = dict(carry["newton"])
    out["contact"] = [
        {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v) for k, v in blk.items()}
        for blk in carry.get("contact", [])
    ]
    return out
