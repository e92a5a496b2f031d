"""Default dtype and device of the port.

Functions that build problems take an explicit `device` and `dtype`;
these helpers give the usual choice: the first CUDA device in float32 when
one is present (the CUDA sweep kernels are float32), else the CPU in
float64 (the precision the parity tests hold the reference package to).
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def default_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
