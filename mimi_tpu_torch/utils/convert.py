"""Carry problems, materials and step state across from the reference
package (mimi_tpu) and back, through numpy.

These functions read plain attributes and numpy-convertible fields only;
they never import jax, so a caller holding objects of the reference
package can run both packages on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..materials import J2
from ..materials import hardening as _hardening
from ..parallel.sharding import Problem


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def material_from_reference(mat):
    """The port's counterpart of a reference-package material (J2 with any
    hardening law), with its parameters copied and set up for the same
    dimension when the reference material was."""
    if type(mat).__name__ != "J2":
        raise NotImplementedError(
            f"{type(mat).__name__} is not ported yet (ROADMAP Queue 1 item 2)"
        )
    out = J2()
    for k in (
        "density", "viscosity", "lambda_", "mu", "young", "poisson", "K", "G",
        "heat_fraction", "specific_heat", "initial_temperature",
        "melting_temperature",
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


def problem_from_numpy(ref, material=None, dtype=None, device="cpu"):
    """A port `Problem` from a reference-package `Problem` built for the
    same single polynomial 3D patch (it must carry `sf` tables and a
    structured `grid`, with no element padding).  `dtype` defaults to the
    reference problem's float type."""
    if ref.sf is None or ref.grid is None:
        raise NotImplementedError(
            "only single-patch polynomial 3D problems are ported "
            "(ROADMAP Queue 2 item 2)"
        )
    if ref.n_el != int(np.prod(ref.grid["spans"])):
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
    return Problem(
        material=mat,
        n_dof=int(ref.n_dof),
        dim=int(ref.dim),
        n_el=int(ref.n_el),
        n_q=int(ref.n_q),
        conn=np.asarray(ref.conn),
        wdet_t=_tensor(np.asarray(ref.w_detJ).T, dtype, device),
        rhs=_tensor(rhs, dtype, device),
        free=_tensor(ref.free, dtype, device),
        facs=dict(ref.facs),
        state0=state0,
        fdm=ref.fdm,
        grid=dict(ref.grid),
        sf={
            "tables": [_tensor(t, dtype, device) for t in ref.sf["tables"]],
            "jinv": _tensor(ref.sf["jinv"], dtype, device),
            "n_g": int(ref.sf["n_g"]),
            "pp1": int(ref.sf["pp1"]),
        },
    )


def carry_from_numpy(carry, dtype=torch.float64, device="cpu"):
    """A port step carry from a dict with "u", "v", "a" (n_dof, dim) and
    "state" (SoA leaves) arrays; "newton" is reset."""
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
    return out
