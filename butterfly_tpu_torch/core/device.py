"""Device selection for the port's entry points.

Every entry point runs on the CUDA card unless the caller asks for the
CPU (as the tests do). Asking for CUDA where there is none raises: the
serving stack never carries on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (None = "cuda") as a torch.device, checked for presence."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
