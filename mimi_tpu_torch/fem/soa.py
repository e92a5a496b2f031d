"""Structure-of-arrays (batch-last) small-tensor algebra.

Counterpart of mimi_tpu/fem/soa.py.  A "tensor" is a torch tensor of shape
(d, d, *batch), a "vector" (d, *batch), a "scalar" (*batch); on the step's
hot path the batch is (n_q, n_el), elements fastest, which is also the
coalesced order for the CUDA sweep kernels (ops/sweeps.py).  The small
dims unroll in Python, so every function is plain elementwise torch code
and works under torch.func.jvp.
"""

from __future__ import annotations

import torch


def stack2(rows):
    """[[scalar]] -> (d, d, *batch)."""
    return torch.stack([torch.stack(list(r), 0) for r in rows], 0)


def add_diag(A, c):
    """A + c*I (c a number or a batch-shaped scalar)."""
    d = A.shape[0]
    return stack2(
        [[A[i, j] + c if i == j else A[i, j] for j in range(d)] for i in range(d)]
    )


def trace(A):
    out = A[0, 0]
    for i in range(1, A.shape[0]):
        out = out + A[i, i]
    return out


def sym(A):
    d = A.shape[0]
    return stack2(
        [[0.5 * (A[i, j] + A[j, i]) for j in range(d)] for i in range(d)]
    )


def matmul(A, B):
    """A @ B."""
    return stack2(
        [
            [
                sum(A[i, k] * B[k, j] for k in range(A.shape[1]))
                for j in range(B.shape[1])
            ]
            for i in range(A.shape[0])
        ]
    )


def matmul_tn(A, B):
    """A^T @ B."""
    return stack2(
        [
            [
                sum(A[k, i] * B[k, j] for k in range(A.shape[0]))
                for j in range(B.shape[1])
            ]
            for i in range(A.shape[1])
        ]
    )


def matmul_nt(A, B):
    """A @ B^T."""
    return stack2(
        [
            [
                sum(A[i, k] * B[j, k] for k in range(A.shape[1]))
                for j in range(B.shape[0])
            ]
            for i in range(A.shape[0])
        ]
    )


def dev(A, factor=1.0):
    """factor * deviator(A)."""
    d = A.shape[0]
    tr_over_d = trace(A) / d
    return stack2(
        [
            [
                factor * (A[i, j] - tr_over_d) if i == j else factor * A[i, j]
                for j in range(d)
            ]
            for i in range(d)
        ]
    )


def fro_norm(A):
    d = A.shape[0]
    s = sum(A[i, j] * A[i, j] for i in range(d) for j in range(d))
    return torch.sqrt(s)


def ddot(A, B):
    """Full contraction sum_ij A[i,j] B[i,j]."""
    d = A.shape[0]
    return sum(A[i, j] * B[i, j] for i in range(d) for j in range(d))


def cbrt(x):
    """Real cube root, negative x included, as jnp.cbrt (torch has no
    cbrt): sign(x) |x|^(1/3), which is x ** (1/3) to the bit for x > 0."""
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def det(A):
    d = A.shape[0]
    if d == 2:
        return A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    if d != 3:
        raise NotImplementedError(f"soa.det of a {d}x{d} tensor")
    return (
        A[0, 0] * (A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1])
        - A[0, 1] * (A[1, 0] * A[2, 2] - A[1, 2] * A[2, 0])
        + A[0, 2] * (A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0])
    )


def inv(A):
    """Closed-form (adjugate) 2x2 or 3x3 inverse, in the reference's
    operation order: 2x2 divides by det, 3x3 multiplies by 1 / det."""
    d = A.shape[0]
    if d == 2:
        detA = det(A)
        return stack2(
            [[A[1, 1] / detA, -A[0, 1] / detA], [-A[1, 0] / detA, A[0, 0] / detA]]
        )
    if d != 3:
        raise NotImplementedError(f"soa.inv of a {d}x{d} tensor")

    def c(i1, j1, i2, j2):
        return A[i1, j1] * A[i2, j2] - A[i1, j2] * A[i2, j1]

    inv_det = 1.0 / det(A)
    return stack2(
        [
            [c(1, 1, 2, 2) * inv_det, c(0, 2, 2, 1) * inv_det, c(0, 1, 1, 2) * inv_det],
            [c(1, 2, 2, 0) * inv_det, c(0, 0, 2, 2) * inv_det, c(0, 2, 1, 0) * inv_det],
            [c(1, 0, 2, 1) * inv_det, c(0, 1, 2, 0) * inv_det, c(0, 0, 1, 1) * inv_det],
        ]
    )


def state_to_soa(state):
    """Per-quad layout -> SoA layout for a material-state dict over an
    (n_el, n_q) batch: tensor leaves (e, q, d, d) -> (d, d, q, e), scalar
    leaves (e, q) -> (q, e)."""

    def conv(a):
        if a.ndim == 4:
            return a.permute(2, 3, 1, 0).contiguous()
        return a.transpose(0, 1).contiguous()

    return {k: conv(v) for k, v in state.items()}
