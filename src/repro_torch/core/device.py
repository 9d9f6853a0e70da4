"""Where the port runs, and the reference knobs it does not take yet.

Every entry point of the port runs on the card unless its caller names
another device: `resolve_device(None)` is CUDA, and with no card it
raises instead of quietly falling back to the CPU.  `device="cpu"` runs
the plain PyTorch versions of the kernels (the tests do).
"""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device a sweep runs on: `device` as given, else the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch versions "
            "of the kernels on the CPU")
    return dev


def exact_fp32() -> None:
    """Keep fp32 matrix products and convolutions in full fp32 on the card
    (no TF32), as the reference computes them; called where the port runs
    fp32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reject_unported(*, devices: Optional[int] = None,
                    backend: Optional[str] = None) -> None:
    """Raise for reference knobs this package does not implement yet:
    lane sharding over several cards (`devices` > 1) and the NumPy
    backend (`backend=`)."""
    if devices is not None:
        n = int(devices)
        if n < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if n > 1:
            raise NotImplementedError(
                "devices > 1 (lane sharding over several cards) is not "
                "ported yet")
    if backend is not None:
        raise NotImplementedError(
            f"backend={backend!r} is not ported: the engine runs PyTorch on "
            "the given device")
