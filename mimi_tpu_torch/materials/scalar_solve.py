"""Safeguarded Newton-bisection scalar root solver over batches.

Counterpart of mimi_tpu/materials/scalar_solve.py (the reference's
`ScalarSolve`, newton.hpp): same bracket orientation, Newton/bisection
switching rule, stopping tests and `max_iter`.  It runs as a Python loop
over whole batches with per-lane freezing: the loop ends when every lane
has converged or after `max_iter` trips, and a converged lane never moves
again, so every lane gets exactly the iterate it would get alone.  With
max_iter=40 it is the reference's fixed-trip `loop="fori"` variant, which
its Pallas kernels run: an early exit changes no lane's iterate there.

The solve is not differentiated: callers pass detached inputs and
re-inject sensitivities by one implicit-function-theorem correction
(materials/__init__.py `_J2ThermoBase._solve_delta_eqps`).
"""

from __future__ import annotations

import torch


def make_scalar_solver(val_grad, xtol, max_iter=100):
    """val_grad(x, *theta) -> (residual, d residual / dx), lane-wise.
    Returns solve(x0, lo, hi, rtol, theta) -> root, all arguments
    broadcastable tensors (or numbers for x0/lo); with return_trips=True
    (root, the trips each lane ran before it converged, max_iter for a lane
    that never did)."""

    def solve(x0, lo, hi, rtol, theta, return_trips=False):
        hi = torch.as_tensor(hi)
        lo = torch.as_tensor(lo, dtype=hi.dtype, device=hi.device)
        x0 = torch.as_tensor(x0, dtype=hi.dtype, device=hi.device)
        f_lo, _ = val_grad(lo, *theta)
        f_hi, _ = val_grad(hi, *theta)

        # orient the search so that f(xl) < 0
        swap = f_lo > 0.0
        xl = torch.where(swap, hi, lo)
        xh = torch.where(swap, lo, hi)

        x = torch.where((x0 < lo) | (x0 > hi), 0.5 * (lo + hi), x0)
        delta0 = (hi - lo).abs()
        f, df = val_grad(x, *theta)
        shape = torch.broadcast_shapes(x.shape, f.shape, xl.shape)
        x, f, df, xl, xh = (t.expand(shape).clone() for t in (x, f, df, xl, xh))
        dx = delta0.expand(shape).clone()
        dxo = dx.clone()
        conv = torch.zeros(shape, dtype=torch.bool, device=x.device)
        trips = torch.zeros(shape, dtype=torch.int32, device=x.device) if return_trips else None

        it = 0
        while it < max_iter and not bool(conv.all()):
            if return_trips:
                trips += (~conv).int()
            use_bisect = (
                (((x - xh) * df - f) > 0.0)
                | (((x - xl) * df - f) < 0.0)
                | ((2.0 * f).abs() > (dxo * df).abs())
            )
            dxo = dx
            dx_bis = 0.5 * (xh - xl)
            dx_new = torch.where(use_bisect, dx_bis, f / df)
            x_new = torch.where(use_bisect, xl + dx_bis, x - f / df)
            # converged lanes stay frozen
            x_new = torch.where(conv, x, x_new)
            dx_new = torch.where(conv, dx, dx_new)
            f_new, df_new = val_grad(x_new, *theta)
            conv_new = conv | (dx_new.abs() < xtol) | (f_new.abs() < rtol)
            xl = torch.where((f_new < 0.0) & ~conv, x_new, xl)
            xh = torch.where((f_new < 0.0) | conv, xh, x_new)
            x, dx, f, df, conv = x_new, dx_new, f_new, df_new, conv_new
            it += 1

        # corner cases: a bracket endpoint is already the root
        x = torch.where(f_hi.abs() < xtol, hi, x)
        x = torch.where(f_lo.abs() < xtol, lo, x)
        return (x, trips) if return_trips else x

    return solve
