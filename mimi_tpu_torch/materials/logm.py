"""Symmetric matrix log and exp in the SoA (batch-last) layout.

Counterpart of the SoA half of mimi_tpu/materials/logm.py: log by trace
prescaling, Denman-Beavers square roots and the Gregory (atanh) series;
exp by scaling and squaring with a Taylor core.  Both are smooth
compositions of 3 x 3 products and inverses, so torch.func.jvp
differentiates them directly.  Points outside the series' convergent range
are poisoned with NaN, so that the step's finite check reports them.

The eigh-based `logm_sym`/`expm_sym` of the reference (with their custom
JVPs) serve its batch-first engine and are not ported.
"""

from __future__ import annotations

import math

import torch

from ..fem import soa

# ||X||_F bound of the Gregory argument for the 8-term series (truncation
# below float32 roundoff); the reference's _LOGM_X_MAX
LOGM_X_MAX = 0.40
# ||A||_F bound of the 8-term, 3-squaring Taylor core; _EXPM_A_MAX
EXPM_A_MAX = 4.4
# (square-root levels, Gregory terms, Denman-Beavers iterations)
LOGM_FAST = (2, 8, 7)
LOGM_DEEP = (5, 12, 14)


def _sqrt_db_soa(A, iters):
    """Denman-Beavers square root of SPD A."""
    Y, Z = A, soa.add_diag(A * 0.0, 1.0)
    for _ in range(iters):
        Y_inv = soa.inv(Y)
        Z_inv = soa.inv(Z)
        Y, Z = 0.5 * (Y + Z_inv), 0.5 * (Z + Y_inv)
    return Y


def _poison_where_bad(out, norm_est, limit):
    """out * 1 in range, out * NaN out of range or where norm_est is not
    finite (`~(x <= limit)` holds for NaN too)."""
    bad = ~(norm_est <= limit)
    return out * torch.where(bad, math.nan, 1.0)


def _logm_core(C, sqrt_levels, gregory_terms, db_iters):
    """(log C, ||X||_F) with X the series argument."""
    s = soa.trace(C) / C.shape[0]
    A = C / s
    for _ in range(sqrt_levels):
        A = _sqrt_db_soa(A, db_iters)
    X = soa.matmul(soa.add_diag(A, -1.0), soa.inv(soa.add_diag(A, 1.0)))
    X2 = soa.matmul(X, X)
    term, acc = X, X
    for k in range(1, gregory_terms):
        term = soa.matmul(term, X2)
        acc = acc + term / (2.0 * k + 1.0)
    logA = (2.0 ** (sqrt_levels + 1)) * acc
    return soa.add_diag(logA, torch.log(s)), soa.fro_norm(X)


def logm_sym_soa(C):
    """log of SPD C: trace prescaling, Denman-Beavers square roots, then
    log(A) = 2 sum_k X^(2k+1)/(2k+1), X = (A - I)(A + I)^-1, in the fast
    configuration (LOGM_FAST).

    As in the reference, when any point of the batch leaves the fast
    configuration's range (||X||_F > 0.40) the whole batch is recomputed
    with the deep one (LOGM_DEEP), and points beyond the range in use are
    NaN-poisoned.  The CUDA kernels decide in the same way for all the
    points of a sweep (ops/csrc/finite.cuh)."""
    out, xn = _logm_core(C, *LOGM_FAST)
    if bool((~(xn <= LOGM_X_MAX)).any()):
        out, xn = _logm_core(C, *LOGM_DEEP)
    return _poison_where_bad(out, xn, LOGM_X_MAX)


def expm_sym_soa(A):
    """exp of symmetric A by scaling and squaring (3 squarings) with an
    8-term Taylor core, accurate to roundoff for ||A||_F <= 4.4; a batch
    with a larger point is recomputed with 7 squarings and 10 terms (range
    70), and points beyond the range in use are NaN-poisoned."""

    def core(sq, terms):
        B = A / (2.0**sq)
        eye = soa.add_diag(B * 0.0, 1.0)
        term, acc = eye, eye
        for k in range(1, terms + 1):
            term = soa.matmul(term, B) / k
            acc = acc + term
        for _ in range(sq):
            acc = soa.matmul(acc, acc)
        return acc

    nrm = soa.fro_norm(A)
    if bool((~(nrm <= EXPM_A_MAX)).any()):
        return _poison_where_bad(core(7, 10), nrm, 70.0)
    return _poison_where_bad(core(3, 8), nrm, EXPM_A_MAX)
