"""Rigid-body contact scenes: batch-last closest-point projection onto
splines.

Counterpart of mimi_tpu/contact/scene.py `NearestDistanceToSplines` on
its fast path (`make_batched_query`, the SoA projection
`_make_query_soa_one`).  The seed is an argmin over a sampled parameter
grid, taken chunk by chunk; the projection is a damped Newton in the
parametric domain over all query points at once, every intermediate a
(n,) plane.  Derivatives of the spline come in closed form
(splines.make_eval_planes_ders).

Normal convention: 2D n = (d1y, -d1x)/|d1|; 3D n = d1 x d2 normalized.
NormalGap = -n . (physical - query).

The Newton loop reads `active.any()` on the host once per trip and stops
when every point is frozen, as the reference's `lax.while_loop` does.
Frozen points never change, so the numbers equal a loop run to the cap;
the read costs one device-to-host sync per trip and saves the remaining
trips (the argmin-seeded iteration converges in a few).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype, resolve_device


class NearestDistanceToSplines:
    """A rigid scene of splines: penalty `coefficient`, the splines, and
    the planted seed parameters of the projection."""

    def __init__(self):
        self.coefficient = 1.0e4
        self.splines = []
        self._samples = None  # per spline (S, para_dim) parameter seeds

    def add_spline(self, spline):
        self.splines.append(spline)

    def plant_kd_tree(self, resolution, nthreads: int = 1):
        """Seed parameters: a uniform `resolution` grid over each spline's
        parametric box (first parametric index fastest)."""
        assert len(self.splines) >= 1, "scene needs at least one spline"
        self._samples = []
        for s in self.splines:
            if np.isscalar(resolution):
                res = [int(resolution)] * s.para_dim
            else:
                res = list(resolution)
            lo, hi = s.parametric_bounds()
            axes = [np.linspace(lo[d], hi[d], res[d]) for d in range(s.para_dim)]
            grid = np.meshgrid(*axes, indexing="ij")
            self._samples.append(
                np.stack([g.reshape(-1, order="F") for g in grid], axis=-1)
            )

    def scene_data(self, dtype=None, device="cuda"):
        """Per spline: the current control data `cps` (n_cp, dim_h), the
        seed parameters `samples` (S, para_dim) and their images
        `sample_pts` (S, dim), as tensors on `device` (the card unless
        "cpu" is passed; dtype by default config.default_dtype)."""
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        out = []
        for i, s in enumerate(self.splines):
            cps = s.eval_cps(dtype, device)
            samples = torch.tensor(self._samples[i], dtype=dtype, device=device)
            pts = s.make_eval_planes()(samples.T, cps.T).T.contiguous()
            out.append({"cps": cps, "samples": samples, "sample_pts": pts})
        return out

    @staticmethod
    def translate_scene_data(scene_data, delta):
        """Rigid translation of scene data on its device: every spline's
        control points and sampled seed points shifted by `delta`
        (length dim).  Parametric seeds are translation-invariant;
        rational control data (x w, w) moves by delta * w."""
        out = []
        for sd in scene_data:
            cps = sd["cps"]
            d = torch.as_tensor(delta, dtype=cps.dtype, device=cps.device)
            dim = d.shape[0]
            if cps.shape[1] == dim:
                cps = cps + d[None, :]
            else:
                w = cps[:, -1:]
                cps = torch.cat([cps[:, :-1] + d[None, :] * w, w], dim=1)
            out.append(
                {
                    "cps": cps,
                    "samples": sd["samples"],
                    "sample_pts": sd["sample_pts"] + d[None, :],
                }
            )
        return out

    def _make_query_soa_one(self, s, max_iter=30):
        """Batch-last closest-point projection onto one spline.

        Returns query(q_t (dim, n), cps, samples, sample_pts) -> dict of
        batch-last results, with the per-point `converged` flag and the
        last gradient norm `grad_norm`."""
        ev = s.make_eval_planes()
        ev_ders = s.make_eval_planes_ders()
        lo_np, hi_np = s.parametric_bounds()
        pd, dim = s.para_dim, s.dim
        scale = float(np.max(hi_np - lo_np))
        alphas = [1.0, 0.5, 0.25, 0.125, 1.0 / 32.0, 1.0 / 128.0]
        bounds = {}  # (dtype, device) -> (lo, hi) (para_dim, 1), made once

        def query(q_t, cps, samples, sample_pts):
            n = q_t.shape[1]
            dtype, device = q_t.dtype, q_t.device
            cps_t = cps.T.to(dtype)
            samples_t = samples.T.to(dtype)
            sample_pts_t = sample_pts.T.to(dtype)
            if (dtype, device) not in bounds:
                bounds[dtype, device] = tuple(
                    torch.tensor(b, dtype=dtype, device=device)[:, None] for b in (lo_np, hi_np)
                )
            lo, hi = bounds[dtype, device]
            finfo = torch.finfo(dtype)
            tol_u = 100.0 * finfo.eps * scale
            tiny = finfo.tiny

            # seed: running argmin over sample chunks (first minimum wins,
            # within a chunk and across chunks)
            S = sample_pts_t.shape[1]
            CH = min(128, S)
            best_d2 = torch.full((n,), finfo.max, dtype=dtype, device=device)
            u0 = torch.zeros((pd, n), dtype=dtype, device=device)
            for c0 in range(0, S, CH):
                pts = sample_pts_t[:, c0 : c0 + CH]
                prm = samples_t[:, c0 : c0 + CH]
                d2 = sum((pts[c][:, None] - q_t[c][None, :]) ** 2 for c in range(dim))
                dmin, idx = torch.min(d2, dim=0)
                take = dmin < best_d2
                u0 = torch.where(take[None, :], prm[:, idx], u0)
                best_d2 = torch.where(take, dmin, best_d2)

            def obj(uu):
                d_ = ev(uu, cps_t) - q_t
                return 0.5 * sum(d_[c] * d_[c] for c in range(dim))

            def grad_hess(uu):
                S_pt, d1, d2 = ev_ders(uu, cps_t)
                diff = S_pt - q_t
                g = [sum(d1[k][c] * diff[c] for c in range(dim)) for k in range(pd)]
                H = [
                    [
                        sum(
                            d1[k][c] * d1[l][c] + diff[c] * d2[k][l][c]
                            for c in range(dim)
                        )
                        for l in range(pd)
                    ]
                    for k in range(pd)
                ]
                return g, H

            def newton_dir(g, H):
                reg = 1e-14
                if pd == 1:
                    h = H[0][0] + reg
                    h = torch.where(h.abs() > tiny, h, torch.full_like(h, tiny))
                    return [g[0] / h]
                h00 = H[0][0] + reg
                h11 = H[1][1] + reg
                h01 = H[0][1]
                det = h00 * h11 - h01 * h01
                det = torch.where(
                    det.abs() > tiny,
                    det,
                    torch.where(det < 0, torch.full_like(det, -tiny),
                                torch.full_like(det, tiny)),
                )
                return [(h11 * g[0] - h01 * g[1]) / det, (h00 * g[1] - h01 * g[0]) / det]

            u = u0
            active = torch.ones((n,), dtype=torch.bool, device=device)
            gn_last = torch.full((n,), finfo.max, dtype=dtype, device=device)
            it = 0
            while it < max_iter and bool(active.any()):
                fval = obj(u)
                g, H = grad_hess(u)
                du = torch.stack(newton_dir(g, H))
                found = torch.zeros((n,), dtype=torch.bool, device=device)
                u_best = u
                for alpha in alphas:
                    u_try = torch.clamp(u - alpha * du, lo, hi)
                    take = (~found) & (obj(u_try) <= fval)
                    u_best = torch.where(take[None, :], u_try, u_best)
                    found = found | take
                moved = (u_best - u).abs().amax(dim=0)
                gn = torch.sqrt(sum(gi * gi for gi in g))
                u = torch.where(active[None, :], u_best, u)
                gn_last = torch.where(active, gn, gn_last)
                active = active & (moved > tol_u)
                it += 1

            phys, d1, _ = ev_ders(u, cps_t)
            pmq = phys - q_t
            dist = torch.sqrt(sum(pmq[c] * pmq[c] for c in range(dim)))
            if dim == 2:
                nrm = torch.stack([d1[0][1], -d1[0][0]])
            else:
                a, b = d1[0], d1[1]
                nrm = torch.stack(
                    [
                        a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0],
                    ]
                )
            nlen = torch.sqrt(sum(nrm[c] * nrm[c] for c in range(dim)))
            nrm = nrm / torch.clamp(nlen, min=tiny)
            normal_gap = -sum(nrm[c] * pmq[c] for c in range(dim))
            return {
                "parametric": u.T,
                "physical": phys.T,
                "distance": dist,
                "normal": nrm.T,
                "normal_gap": normal_gap,
                "converged": ~active,
                "grad_norm": gn_last,
            }

        return query

    def make_batched_query(self):
        """Closest-point query over all scene splines: each query point
        (n, dim) takes the result of the spline at the least distance."""
        queries = [self._make_query_soa_one(s) for s in self.splines]

        def batched(qpts, data):
            q_t = qpts.T
            results = [
                qo(q_t, d["cps"], d["samples"], d["sample_pts"])
                for qo, d in zip(queries, data)
            ]
            if len(results) == 1:
                return results[0]
            best = torch.argmin(torch.stack([r["distance"] for r in results]), dim=0)
            out = {}
            for k in results[0]:
                st = torch.stack([r[k] for r in results])
                ix = best.reshape((1, -1) + (1,) * (st.ndim - 2)).expand(
                    (1,) + st.shape[1:]
                )
                out[k] = torch.gather(st, 0, ix)[0]
            return out

        return batched
