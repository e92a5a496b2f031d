"""Fused neo-Hookean element residual and matrix-free tangent apply on
dense tables.

Counterpart of mimi_tpu/ops/pallas_residual.py
(`neohookean_residual_pallas`, `neohookean_tangent_apply_pallas`):
  - `neohookean_residual`: r_el = sum_q w det J dN P(F(u)) with
    P = mu (F - F^-T) + lambda J (J - 1) F^-T, the stress of
    `CompressibleOgdenNeoHookean`;
  - `neohookean_tangent_apply`: y_el = sum_q w det J dN (dP/dF(u) : dF(w))
    with no stored tangent: dP is formed from F and dF at every point,
      dP = mu dF + lambda (2J - 1) J tr(F^-1 dF) F^-T
           - (lambda J (J - 1) - mu) F^-T dF^T F^-T.
They compute what `sweeps.residual_dense` computes with a_el = 0 and what
`sweeps.matvec_dense` computes with rho = 0 and fac0 = 1 on the tangent
assembled at the same u.

Layout: the batch-last dense layout of ops/sweeps.py, `dN_t`
(nd, dim, n_q, n_el) as `Problem.dense["dN_t"]`, element values
(dim, nd, n_el), `wq` = w det J (n_q, n_el).  The reference kernels'
(dim, nd, n_el, n_q) layout, the element values broadcast over the
quadrature axis and the reduction over the points outside the kernel
answer constraints of the TPU compiler and are not carried over.

Each function has a plain torch version (`*_plain`), dtype-generic, and a
wrapper that runs it for CPU tensors and launches the hand-written CUDA
kernel (ops/csrc/fused_neohookean.cu, float32, at the tables' (dim, nd,
n_q): 2D or 3D, any degree and point count, of the dense library of that
shape) for CUDA tensors, counting those launches in `sweeps.LAUNCHES`
(`sweeps.fused_counters`: "neohookean_residual",
"neohookean_tangent_apply" at (3, 27, 64), the shape's suffix at another).
"""

from __future__ import annotations

import ctypes

import torch

from ..fem import soa
from ..materials import neohookean_pk1_soa
from .sweeps import _check, _launch, _lib, _ptr, dense_grad, dense_scatter, fused_counters


def neohookean_residual_plain(u_el, dN_t, wq, lam, mu):
    """r[c, n] = sum_q wq dN[n, d] P[c, d], P the stress of
    `CompressibleOgdenNeoHookean.pk1_soa`."""
    F = soa.add_diag(dense_grad(u_el, dN_t), 1.0)
    return dense_scatter(neohookean_pk1_soa(F, lam, mu), None, dN_t, None, wq)


def neohookean_tangent_apply_plain(u_el, w_el, dN_t, wq, lam, mu):
    """y[c, n] = sum_q wq dN[n, d] dP[c, d], dP the directional derivative
    of P at F(u) along dF = grad w, in closed form."""
    F = soa.add_diag(dense_grad(u_el, dN_t), 1.0)
    dF = dense_grad(w_el, dN_t)
    J = soa.det(F)
    fi = soa.inv(F)
    G = fi.transpose(0, 1)  # F^-T
    t = (G * dF).sum((0, 1))  # tr(F^-1 dF)
    M = soa.matmul(G, soa.matmul_tn(dF, G))  # F^-T dF^T F^-T
    coef_t = lam * (2.0 * J - 1.0) * J * t
    coef_m = lam * J * (J - 1.0) - mu
    dP = mu * dF + coef_t * G - coef_m * M
    return dense_scatter(dP, None, dN_t, None, wq)


def _check_operands(fields, dN_t, wq):
    """(device, n_el, (dim, nd, n_q)) of consistent float32 CUDA operands;
    ValueError otherwise."""
    device = dN_t.device
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {device} tensor")
    if dN_t.dim() != 4 or dN_t.shape[1] not in (2, 3):
        raise ValueError(f"dN_t: (nd, dim, n_q, n_el) in 2D or 3D required, got "
                         f"{tuple(dN_t.shape)}")
    nd, dim, n_q, n_el = dN_t.shape
    for name, t in fields:
        _check(name, t, (dim, nd, n_el), device)
    _check("dN_t", dN_t, (nd, dim, n_q, n_el), device)
    _check("wq", wq, (n_q, n_el), device)
    return device, n_el, (dim, nd, n_q)


def neohookean_residual(u_el, dN_t, wq, lam, mu):
    """The fused neo-Hookean element residual (dim, nd, n_el): plain torch
    on CPU tensors, the CUDA kernel `mimi_neohookean_residual` on CUDA
    tensors."""
    if u_el.device.type == "cpu":
        return neohookean_residual_plain(u_el, dN_t, wq, lam, mu)
    device, n_el, key = _check_operands([("u_el", u_el)], dN_t, wq)
    out = torch.empty(u_el.shape, dtype=torch.float32, device=device)
    _launch(
        _lib("dense", key).mimi_neohookean_residual, fused_counters(key)[0],
        _ptr(u_el), _ptr(dN_t), _ptr(wq), _ptr(out), ctypes.c_float(lam), ctypes.c_float(mu),
        *map(ctypes.c_int, key), ctypes.c_longlong(n_el),
    )
    return out


def neohookean_tangent_apply(u_el, w_el, dN_t, wq, lam, mu):
    """The matrix-free neo-Hookean tangent apply (dim, nd, n_el): plain
    torch on CPU tensors, the CUDA kernel `mimi_neohookean_tangent_apply` on
    CUDA tensors."""
    if u_el.device.type == "cpu":
        return neohookean_tangent_apply_plain(u_el, w_el, dN_t, wq, lam, mu)
    device, n_el, key = _check_operands([("u_el", u_el), ("w_el", w_el)], dN_t, wq)
    out = torch.empty(u_el.shape, dtype=torch.float32, device=device)
    _launch(
        _lib("dense", key).mimi_neohookean_tangent_apply, fused_counters(key)[1],
        _ptr(u_el), _ptr(w_el), _ptr(dN_t), _ptr(wq), _ptr(out), ctypes.c_float(lam),
        ctypes.c_float(mu), *map(ctypes.c_int, key), ctypes.c_longlong(n_el),
    )
    return out
