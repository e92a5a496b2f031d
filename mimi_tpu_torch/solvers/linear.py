"""Krylov solvers for the Newton step: preconditioned CG and restarted,
left-preconditioned GMRES on flat tensors.

Counterpart of mimi_tpu/solvers/linear.py with the same stopping
semantics.  The vectors stay on the tensors' device; the small Arnoldi
least-squares problem (Givens rotations, back substitution) runs on the
host in float64, so each GMRES iteration costs one device-to-host copy of
its Hessenberg column, which is also where the convergence test is read.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.linalg
import torch


def pcg(A_apply, b, diag_precond, rel_tol=1e-8, abs_tol=1e-12, max_iter=200):
    """Preconditioned conjugate gradients, x0 = 0.

    Stops when (z, r) <= max(rel^2 (z0, r0), abs^2) (mfem CGSolver
    semantics) or after `max_iter` iterations."""
    inv_d = 1.0 / diag_precond
    r = b
    z = inv_d * r
    d = z
    nom = torch.dot(z, r)
    nom0 = float(nom)
    stop = max(nom0 * rel_tol * rel_tol, abs_tol * abs_tol)
    x = torch.zeros_like(b)
    done = nom0 <= stop
    it = 0
    while not done and it < max_iter:
        w = A_apply(d)
        alpha = nom / torch.dot(d, w)
        x = x + alpha * d
        r = r - alpha * w
        z = inv_d * r
        betanom = torch.dot(z, r)
        done = float(betanom) <= stop
        d = z + (betanom / nom) * d
        nom = betanom
        it += 1
    return x


def gmres(
    A_apply,
    b,
    M_apply=None,
    rel_tol=1e-8,
    abs_tol=1e-12,
    restart=30,
    max_iter=200,
    return_info=False,
):
    """Left-preconditioned restarted GMRES, x0 = 0.

    Classical Gram-Schmidt against the stored basis (one matrix-vector
    product per iteration, as the reference package does), Givens-rotation
    least squares.  Stops when the preconditioned residual norm falls
    under max(rel_tol*|M^{-1}b|, abs_tol); runs at most
    ceil(max_iter/restart) cycles of at most `restart` iterations.

    With return_info=True also returns {"iters", "res"}: the Arnoldi
    iterations actually run and the final preconditioned residual norm.
    """
    if M_apply is None:
        M_apply = lambda v: v  # noqa: E731
    n = b.shape[0]
    m = int(restart)
    dtype = b.dtype
    tiny = float(torch.finfo(dtype).tiny)

    norm_b = float(torch.linalg.norm(M_apply(b)))
    stop = max(rel_tol * norm_b, abs_tol)
    max_cycles = max(1, -(-int(max_iter) // m))

    x = torch.zeros_like(b)
    res, k, iters = norm_b, 0, 0
    while res > stop and k < max_cycles:
        r = M_apply(b - A_apply(x))
        beta = float(torch.linalg.norm(r))
        V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
        V[0] = r / max(beta, tiny)
        R = np.zeros((m, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        res = beta
        j = 0
        while j < m and res > stop:
            w = M_apply(A_apply(V[j]))
            h = V[: j + 1] @ w
            w = w - h @ V[: j + 1]
            h2 = torch.linalg.norm(w)
            V[j + 1] = w / torch.clamp(h2, min=tiny)
            hcol = np.zeros(m + 1)
            hcol[: j + 2] = torch.cat([h, h2[None]]).tolist()  # host sync
            for i in range(j):
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = hi
            denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            cs[j] = hcol[j] / max(denom, tiny)
            sn[j] = hcol[j + 1] / max(denom, tiny)
            hcol[j] = cs[j] * hcol[j] + sn[j] * hcol[j + 1]
            hcol[j + 1] = 0.0
            R[:, j] = hcol[:m]
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            res = abs(g[j + 1])
            j += 1
        if j:
            y = scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False)
            x = x + torch.as_tensor(y, dtype=dtype, device=b.device) @ V[:j]
        k += 1
        iters += j
    if return_info:
        return x, {"iters": iters, "res": res}
    return x
