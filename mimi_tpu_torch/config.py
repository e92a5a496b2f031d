"""Device and dtype defaults of the port.

The port's entry points run on the first CUDA device unless the caller
passes `device="cpu"`; without a CUDA device they raise instead of falling
back to the CPU.  The dtype follows the device: float32 on the card (the
CUDA sweep kernels are float32), float64 on the CPU (the precision the
parity tests hold the reference package to).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises RuntimeError when it names CUDA
    and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on the CPU"
        )
    return dev


def default_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
