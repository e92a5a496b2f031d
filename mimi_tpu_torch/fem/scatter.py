"""Scatter-adds in a fixed order: the transpose of a gather through an
index map, summed without atomics.

`index_add_` on a CUDA tensor adds through atomics, in an order that
changes from run to run, so two runs of the same step round differently
and, over a drive, part.  Here the map's inverse is built once on the
host (`inverse_map`), and each scatter gathers every output's values and
sums them (`gather_sum`): the order of each sum is fixed, on every
device.
"""

from __future__ import annotations

import numpy as np
import torch


def inverse_map(idx, n_out):
    """(n_out, V) int64: row i holds the positions k of the flattened index
    array `idx` with idx[k] == i, ascending, padded with idx.size (the zero
    slot that `gather_sum` appends); V is the largest count (at least 1)."""
    idx = np.asarray(idx, dtype=np.int64).ravel()
    counts = np.bincount(idx, minlength=n_out)
    order = np.argsort(idx, kind="stable")
    rank = np.arange(idx.size) - np.repeat(np.cumsum(counts) - counts, counts)
    inv = np.full((n_out, max(int(counts.max(initial=0)), 1)), idx.size, dtype=np.int64)
    inv[idx[order], rank] = order
    return inv


def gather_sum(vals, inv):
    """out[..., i] = sum_j vals[..., inv[i, j]], the positions on the last
    axis of `vals`, the padded slots adding 0: (..., K) -> (..., n_out).
    The same sums as `zeros(..., n_out).index_add_(-1, idx, vals)` with
    `inv = inverse_map(idx, n_out)`, added in the order of the positions."""
    return torch.nn.functional.pad(vals, (0, 1))[..., inv].sum(-1)
