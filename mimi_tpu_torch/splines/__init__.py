"""Rigid-body splines for contact scenes, evaluated batch-last.

Counterpart of the parts of mimi_tpu/splines/__init__.py that the contact
scene reads: `_basis_planes`, `_SplineBase.parametric_bounds`,
`make_eval_planes`, `eval_cps`, and the `Bezier`, `BSpline`, `NURBS`
classes.  Control points are stored in lexicographic order (first
parametric index fastest), as in splinepy.

Every intermediate is a (n,) plane over the n parameter tuples evaluated at
once.  The reference package takes first and second derivatives by nested
forward-mode AD through the Cox-de Boor recurrence; here they come in
closed form from the derivative recurrence of Piegl & Tiller (A2.3), with
the quotient rule for rational splines (`make_eval_planes_ders`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype, resolve_device


def _basis_planes(kv, p: int, u, n_der: int = 0):
    """Batch-last B-spline basis and derivatives at the (n,) parameter
    plane u.

    kv is the knot vector, a tensor on u's device (or an array).  Returns
    (span (n,) int64, ders) with ders[k][r] the k-th derivative of the r-th
    nonzero basis function, a (n,) plane, for k = 0..n_der.  The span is
    clamped to [p, n_fn - 1] as in the reference (`side="right"` search),
    so u at an interior knot takes the right-hand piece."""
    u = u.contiguous()
    kvt = torch.as_tensor(kv, dtype=u.dtype, device=u.device)
    n_fn = len(kvt) - p - 1
    span = torch.clamp(torch.searchsorted(kvt, u, right=True) - 1, p, n_fn - 1)
    left = [None] + [u - kvt[span + 1 - j] for j in range(1, p + 1)]
    right = [None] + [kvt[span + j] - u for j in range(1, p + 1)]
    ndu = [[None] * (p + 1) for _ in range(p + 1)]
    ndu[0][0] = torch.ones_like(u)
    for j in range(1, p + 1):
        saved = torch.zeros_like(u)
        for r in range(j):
            ndu[j][r] = right[r + 1] + left[j - r]
            temp = ndu[r][j - 1] / ndu[j][r]
            ndu[r][j] = saved + right[r + 1] * temp
            saved = left[j - r] * temp
        ndu[j][j] = saved
    ders = [[ndu[r][p] for r in range(p + 1)]]
    ders += [[None] * (p + 1) for _ in range(n_der)]
    for r in range(p + 1):
        a = [[0.0] * (p + 1), [0.0] * (p + 1)]
        s1, s2 = 0, 1
        a[0][0] = 1.0
        for k in range(1, n_der + 1):
            d = torch.zeros_like(u)
            rk, pk = r - k, p - k
            if r >= k:
                a[s2][0] = a[s1][0] / ndu[pk + 1][rk]
                d = a[s2][0] * ndu[rk][pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = k - 1 if (r - 1) <= pk else p - r
            for j in range(j1, j2 + 1):
                a[s2][j] = (a[s1][j] - a[s1][j - 1]) / ndu[pk + 1][rk + j]
                d = d + a[s2][j] * ndu[rk + j][pk]
            if r <= pk:
                a[s2][k] = -a[s1][k - 1] / ndu[pk + 1][r]
                d = d + a[s2][k] * ndu[r][pk]
            ders[k][r] = d
            s1, s2 = s2, s1
    fac = float(p)
    for k in range(1, n_der + 1):
        ders[k] = [x * fac for x in ders[k]]
        fac *= p - k
    return span, ders


class _SplineBase:
    """Tensor-product spline; cps (n, dim) lexicographic numpy storage."""

    def __init__(self, degrees, knot_vectors, control_points, weights=None):
        self.degrees = [int(d) for d in degrees]
        self.knot_vectors = [np.asarray(k, dtype=float) for k in knot_vectors]
        self.cps = np.asarray(control_points, dtype=float)
        self.dim = self.cps.shape[1]
        self.para_dim = len(self.degrees)
        self.weights = (
            None if weights is None else np.asarray(weights, dtype=float).ravel()
        )
        self._n_ctrl = [
            len(kv) - p - 1 for kv, p in zip(self.knot_vectors, self.degrees)
        ]
        assert int(np.prod(self._n_ctrl)) == len(self.cps)
        if self.para_dim > 2:
            raise NotImplementedError("para_dim > 2 scenes")
        self._knots_on = {}  # (dtype, device) -> knot vectors as tensors

    def _knots(self, like):
        """The knot vectors as tensors of `like`'s dtype on its device,
        made once: a host-to-device copy per evaluation would wait for
        the device every time."""
        key = (like.dtype, like.device)
        if key not in self._knots_on:
            self._knots_on[key] = [
                torch.as_tensor(kv, dtype=like.dtype, device=like.device)
                for kv in self.knot_vectors
            ]
        return self._knots_on[key]

    def parametric_bounds(self):
        lo = [kv[p] for kv, p in zip(self.knot_vectors, self.degrees)]
        hi = [kv[-p - 1] for kv, p in zip(self.knot_vectors, self.degrees)]
        return np.array(lo), np.array(hi)

    def eval_cps(self, dtype=None, device="cuda"):
        """Current (possibly user-mutated) control data as a tensor on
        `device` (the card unless "cpu" is passed; dtype by default
        config.default_dtype), homogeneous (x * w, w) if rational."""
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        cps = self.cps
        if self.weights is not None:
            cps = np.concatenate(
                [self.cps * self.weights[:, None], self.weights[:, None]], axis=1
            )
        return torch.tensor(cps, dtype=dtype, device=device)

    def _homogeneous(self, u, cps_t, n_der):
        """Homogeneous sums A[(k0, k1)] = sum_i d^k0 N_i d^k1 N_j cps_ij
        (dim_h, n) for every derivative order k0 + k1 <= n_der."""
        pd = self.para_dim
        spans, ders = [], []
        knots = self._knots(u)
        for d in range(pd):
            s_, D_ = _basis_planes(knots[d], self.degrees[d], u[d], n_der)
            spans.append(s_)
            ders.append(D_)
        out = {}
        if pd == 1:
            p0 = self.degrees[0]
            for k in range(n_der + 1):
                acc = None
                for i in range(p0 + 1):
                    term = ders[0][k][i][None, :] * cps_t[:, spans[0] - p0 + i]
                    acc = term if acc is None else acc + term
                out[(k,)] = acc
            return out
        p0, p1 = self.degrees
        nc0 = self._n_ctrl[0]
        for k0 in range(n_der + 1):
            for k1 in range(n_der + 1 - k0):
                acc = None
                for j in range(p1 + 1):
                    row = nc0 * (spans[1] - p1 + j)
                    for i in range(p0 + 1):
                        flat = spans[0] - p0 + i + row
                        w_ij = ders[0][k0][i] * ders[1][k1][j]
                        term = w_ij[None, :] * cps_t[:, flat]
                        acc = term if acc is None else acc + term
                out[(k0, k1)] = acc
        return out

    def make_eval_planes(self):
        """f(u (para_dim, n), cps_t (dim_h, n_cp)) -> (dim, n): the spline
        at n parameter tuples, with cps_t the transposed (homogeneous if
        rational) control data, `eval_cps().T`."""
        pd = self.para_dim
        rational = self.weights is not None

        def evaluate(u, cps_t):
            A = self._homogeneous(u, cps_t, 0)[(0,) * pd]
            return A[:-1] / A[-1:] if rational else A

        return evaluate

    def make_eval_planes_ders(self):
        """f(u, cps_t) -> (S, d1, d2): the spline (dim, n), its first
        derivatives d1[k] = dS/du_k and second derivatives
        d2[k][l] = d2S/du_k du_l, each (dim, n), in closed form."""
        pd = self.para_dim
        rational = self.weights is not None

        def idx(*ks):
            m = [0] * pd
            for k in ks:
                m[k] += 1
            return tuple(m)

        def evaluate(u, cps_t):
            A = self._homogeneous(u, cps_t, 2)
            if not rational:
                d1 = [A[idx(k)] for k in range(pd)]
                d2 = [[A[idx(k, l)] for l in range(pd)] for k in range(pd)]
                return A[idx()], d1, d2
            W = A[idx()][-1:]
            S = A[idx()][:-1] / W
            d1 = [(A[idx(k)][:-1] - A[idx(k)][-1:] * S) / W for k in range(pd)]
            d2 = [
                [
                    (
                        A[idx(k, l)][:-1]
                        - A[idx(k, l)][-1:] * S
                        - A[idx(k)][-1:] * d1[l]
                        - A[idx(l)][-1:] * d1[k]
                    )
                    / W
                    for l in range(pd)
                ]
                for k in range(pd)
            ]
            return S, d1, d2

        return evaluate


class Bezier(_SplineBase):
    def __init__(self, degrees, control_points):
        kvs = [np.array([0.0] * (d + 1) + [1.0] * (d + 1)) for d in degrees]
        super().__init__(degrees, kvs, control_points)


class BSpline(_SplineBase):
    def __init__(self, degrees, control_points, knot_vectors):
        super().__init__(degrees, knot_vectors, control_points)


class NURBS(_SplineBase):
    def __init__(self, degrees, control_points, knot_vectors, weights):
        super().__init__(degrees, knot_vectors, control_points, weights)
