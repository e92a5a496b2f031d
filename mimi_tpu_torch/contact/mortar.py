"""Mortar-averaged penalty contact against rigid spline scenes.

Counterpart of mimi_tpu/contact/mortar.py `make_contact_fns`:

pressure pass (all marked boundary elements): per quadrature point a
closest-point query at the current coordinates (u + x_ref), the unit
spline normal, the normal gap clamped min(g, 0) with the 1e-5 angle gate;
mortar-averaged nodal gap and area by scatter-add; nodal pressure
p = gap / area * penalty.

residual pass: traction residual t = -(w det J p) n with n the element
surface normal.

The closest-point query runs on a detached copy of the quadrature points
and its results (foot point, spline normal, distance) are constants of the
linearization, as the reference's `stop_gradient` makes them.  The gap is
rebuilt from the held foot point and normal and the live quadrature point,
so at a converged foot point d(gap) = n . d(qpt).

`linearized_pass` is the port's form of the reference's consistent
contact tangent (`jax.linearize(contact_residual)` in
parallel/sharding.py): one pressure and residual pass at u that keeps its
intermediates, and a closed-form directional derivative w -> d res_el
that reuses them and never reruns the projection.

`residual_grad_pass` is the reference's frozen tangent (its
`residual_grad_pass`, `jax.jacfwd` of the element residual): the residual
pass and, per contact element, the Jacobian of its traction residual in
its own dof values with the nodal pressure held fixed.
"""

from __future__ import annotations

import torch


def _surface_normal_raw(J):
    """Unnormalized surface normal c (..., dim) of the tangent columns J
    (..., dim, dim-1): the cross product in 3D, (d1, -d0) in 2D.  |c| is
    the surface Jacobian determinant (the reference's `_det_surf`) and
    c / |c| its `_unit_normal_from_J`."""
    if J.shape[-2] == 2:
        return torch.stack([J[..., 1, 0], -J[..., 0, 0]], -1)
    return torch.linalg.cross(J[..., 0], J[..., 1], dim=-1)


def _surface_normal_raw_dot(J, dJ):
    """Directional derivative of `_surface_normal_raw` along dJ."""
    if J.shape[-2] == 2:
        return torch.stack([dJ[..., 1, 0], -dJ[..., 0, 0]], -1)
    return torch.linalg.cross(dJ[..., 0], J[..., 1], dim=-1) + torch.linalg.cross(
        J[..., 0], dJ[..., 1], dim=-1
    )


def _traction(cd, pressure, det, c):
    """Traction residual of the pressure on the surface with the
    unnormalized normals c and their norms det: (res_el (n_mb, nd, dim),
    force, integrated pressure, (p_q, nrm, fac))."""
    N = cd["N"]
    p_q = torch.einsum("eqn,en->eq", N, pressure[cd["ldof"]])
    nrm = cd["nsign"][:, None, None] * (c / det[..., None])
    fac = cd["wq"] * det * p_q
    res_el = -torch.einsum("eq,eqn,eqd->end", fac, N, nrm)
    force = torch.einsum("eq,eqd->d", fac, nrm)
    return res_el, force, fac.sum(), (p_q, nrm, fac)


def residual_grad_pass(u, cd, pressure):
    """The residual pass at u (n_dof, dim) and the frozen-pressure element
    blocks: (res_el, blocks (n_mb, nd dim, nd dim), force, integrated
    pressure), blocks[e, n dim + d, m dim + c] = d res_el[e, n, d] /
    d u[conn[e, m], c] at fixed nodal pressure.  The traction w det J p n
    is -(w p_q nsign) c with c the unnormalized surface normal, so its
    derivative is that of c, linear in the surface tangents (2D) or
    bilinear (3D); the blocks are its derivative along each of the nd dim
    unit element seeds, in closed form."""
    dim = u.shape[-1]
    cur = u[cd["conn"]] + cd["x_ref_el"]
    N, dN = cd["N"], cd["dN"]
    J = torch.einsum("end,eqnk->eqdk", cur, dN)
    c = _surface_normal_raw(J)
    res_el, force, pint, (p_q, _, _) = _traction(
        cd, pressure, torch.linalg.vector_norm(c, dim=-1), c
    )
    n_mb, nd = cd["conn"].shape
    # seeds s = m dim + c: dJ[s, e, q, d, k] = delta(d, c) dN[e, q, m, k]
    eye = torch.eye(dim, dtype=u.dtype, device=u.device)
    dJ = torch.einsum("eqmk,cd->mceqdk", dN, eye).reshape(nd * dim, n_mb, *J.shape[1:])
    dc = _surface_normal_raw_dot(J.expand_as(dJ), dJ)
    wp = cd["wq"] * p_q * cd["nsign"][:, None]
    d_res = -torch.einsum("eq,eqn,seqd->ends", wp, N, dc)
    return res_el, d_res.reshape(n_mb, nd * dim, nd * dim), force, pint


def make_contact_fns(dim: int, n_local: int, batched_query):
    """Mortar passes over explicitly passed element tables.

    `cd` is a dict of element tables for one marked boundary block:
      conn (n_mb, nd) global scalar dofs (int64), N (n_mb, q, nd),
      dN (n_mb, q, nd, dim-1), wq (n_mb, q), nsign (n_mb,),
      ldof (n_mb, nd) local mortar dof ids, x_ref_el (n_mb, nd, dim).

    Returns (pressure_pass, residual_pass, linearized_pass)."""

    def scatter_local(vals_el, ldof):
        out = torch.zeros(n_local, dtype=vals_el.dtype, device=vals_el.device)
        return out.index_add_(0, ldof.reshape(-1), vals_el.reshape(-1))

    def gap_pass(u, cd, scene_data):
        """Query at the current quadrature points; the held results and
        the gated, clamped gap."""
        cur = u[cd["conn"]] + cd["x_ref_el"]
        N = cd["N"]
        qpts = torch.einsum("eqn,end->eqd", N, cur)
        n_mb, n_q, _ = qpts.shape
        qflat = qpts.reshape(-1, dim)
        res = batched_query(qflat.detach(), scene_data)
        unconv = ~res["converged"]
        qdiag = {
            "proj_unconverged": unconv.sum(),
            "proj_res_max": torch.where(
                unconv, res["grad_norm"], torch.zeros_like(res["grad_norm"])
            ).max(),
        }
        nrm_q = res["normal"].detach()
        true_g = (-(nrm_q * (res["physical"].detach() - qflat)).sum(1)).reshape(n_mb, n_q)
        dist = res["distance"].detach().reshape(n_mb, n_q)
        tiny = torch.finfo(u.dtype).tiny
        # angle gate (mortar_contact.cpp:158-189), exactly as the
        # reference writes it
        ratio = torch.clamp(true_g.abs() / torch.clamp(dist, min=tiny), max=1.0)
        keep = ~(torch.arccos(ratio) > 1.0e-5)
        g = torch.where(keep, torch.clamp(true_g, max=0.0), torch.zeros_like(true_g))
        qdiag["n_penetrating"] = (true_g < 0).sum()
        qdiag["n_engaged"] = (keep & (true_g < 0)).sum()
        return cur, g, keep & (true_g < 0), nrm_q.reshape(n_mb, n_q, dim), qdiag

    def pressure_from(cur, g, cd, penalty):
        N = cd["N"]
        J = torch.einsum("end,eqnk->eqdk", cur, cd["dN"])
        c = _surface_normal_raw(J)
        det = torch.linalg.vector_norm(c, dim=-1)
        fac = cd["wq"] * det
        area = scatter_local(torch.einsum("eq,eqn->en", fac, N), cd["ldof"])
        gap = scatter_local(torch.einsum("eq,eqn->en", fac * g, N), cd["ldof"])
        pos = area > 0.0
        gpa = torch.where(pos, gap / torch.where(pos, area, torch.ones_like(area)),
                          torch.zeros_like(area))
        return gpa * penalty, fac.sum(), (J, c, det, fac, area, gap, pos, gpa)

    def pressure_pass(u, cd, scene_data, penalty):
        cur, g, _, _, qdiag = gap_pass(u, cd, scene_data)
        pressure, total_area, _ = pressure_from(cur, g, cd, penalty)
        return pressure, total_area, qdiag

    def residual_pass(u, cd, pressure):
        cur = u[cd["conn"]] + cd["x_ref_el"]
        J = torch.einsum("end,eqnk->eqdk", cur, cd["dN"])
        c = _surface_normal_raw(J)
        res_el, force, pint, _ = _traction(
            cd, pressure, torch.linalg.vector_norm(c, dim=-1), c
        )
        return res_el, force, pint

    def linearized_pass(u, cd, scene_data, penalty):
        """(res_el, aux, jvp): the two passes at u, and w -> d res_el, the
        derivative of the residual pass along w (n_dof, dim) with the
        query held at u."""
        cur, g, gmask, nrm_q, qdiag = gap_pass(u, cd, scene_data)
        pressure, total_area, (J, c, det, fac, area, gap, pos, gpa) = pressure_from(
            cur, g, cd, penalty
        )
        res_el, force, pint, (p_q, nrm, fac_p) = _traction(cd, pressure, det, c)
        N, dN, wq, ldof = cd["N"], cd["dN"], cd["wq"], cd["ldof"]
        nsign = cd["nsign"][:, None, None]
        gm = gmask.to(u.dtype)
        safe_area = torch.where(pos, area, torch.ones_like(area))

        def jvp(w):
            w_el = w[cd["conn"]]
            dg = gm * (nrm_q * torch.einsum("eqn,end->eqd", N, w_el)).sum(-1)
            dJ = torch.einsum("end,eqnk->eqdk", w_el, dN)
            dc = _surface_normal_raw_dot(J, dJ)
            ddet = (c * dc).sum(-1) / det
            dfac = wq * ddet
            darea = scatter_local(torch.einsum("eq,eqn->en", dfac, N), ldof)
            dgap = scatter_local(torch.einsum("eq,eqn->en", dfac * g + fac * dg, N), ldof)
            dp = torch.where(pos, (dgap - gpa * darea) / safe_area,
                             torch.zeros_like(area)) * penalty
            dp_q = torch.einsum("eqn,en->eq", N, dp[ldof])
            dfac_p = wq * (ddet * p_q + det * dp_q)
            n_raw = c / det[..., None]
            dnrm = nsign * (dc - n_raw * (n_raw * dc).sum(-1, keepdim=True)) / det[..., None]
            return -(
                torch.einsum("eq,eqn,eqd->end", dfac_p, N, nrm)
                + torch.einsum("eq,eqn,eqd->end", fac_p, N, dnrm)
            )

        aux = {
            "force": force,
            "area": total_area,
            "pressure": pint,
            "nodal_pressure": pressure,
            "res_el": res_el,
            **qdiag,
        }
        return res_el, aux, jvp

    return pressure_pass, residual_pass, linearized_pass
