"""K8: row RMSNorm over (T, d), fp32 statistics, scale applied as
`(1 + scale)`, result in x's dtype.

It is the counterpart of the reference's Pallas kernel
`src/repro/kernels/rmsnorm.py::rmsnorm`, and computes the same function
as the reference's `models/layers.py::rms_norm`, so the port runs every
norm of the model through it.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/rmsnorm.cu: one pass over each row, held in registers, in the
layout `launch_plan` picks) and counts the launch in `launches`; on a CPU
tensor it runs `rmsnorm_plain`.  Any other device raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

_FNS = {(torch.bfloat16, torch.bfloat16): "rmsnorm_bf16_bf16",
        (torch.float32, torch.float32): "rmsnorm_f32_f32"}
#: widths compiled as fixed cases (TinyLlama's d, MLA's kv_norm rank)
FIXED_WIDTHS = (512, 2048)
#: threads a block at most (csrc/rmsnorm.cu kMaxThreads)
MAX_THREADS = 256
#: rows a block where a warp takes a row
WARP_ROWS_PER_BLOCK = 2


def launch_plan(rows: int, d: int, sms: int, itemsize: int = 2,
                aligned: bool = True) -> Tuple[int, int]:
    """(threads a row, rows a block) of the kernel on a card of `sms` SMs.

    At a fixed width with 16-byte aligned rows, up to one row an SM takes
    a whole block a row: min(pieces, 256) threads, a 16-byte piece or more
    each, so every row is one round trip of loads on an SM of its own.
    Otherwise a warp takes a row, WARP_ROWS_PER_BLOCK rows a block, so
    blocks are small and many are resident on each SM."""
    if aligned and d in FIXED_WIDTHS and rows <= sms:
        return min(d * itemsize // 16, MAX_THREADS), 1
    return 32, WARP_ROWS_PER_BLOCK


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The same function in tensor ops (any device): the plain version the
    kernel is held against."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor):
    if x.dim() != 2 or scale.dim() != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm takes x (T, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if (x.dtype, scale.dtype) not in _FNS:
        raise TypeError(f"rmsnorm takes bf16 or fp32 x with a scale of x's "
                        f"dtype, got {x.dtype} and {scale.dtype}")
    if scale.device != x.device:
        raise ValueError("rmsnorm inputs must be on one device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm inputs must be contiguous")
    if x.requires_grad or scale.requires_grad:
        raise RuntimeError("rmsnorm is forward only")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (T, d) bf16 or fp32; scale: (d,) of x's dtype.  Returns
    (T, d) in x's dtype."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm runs on CUDA or CPU tensors, not "
                           f"{x.device}")
    y = torch.empty_like(x)
    rows, d = x.shape
    if rows == 0:
        return y
    vector = (d * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
              and scale.data_ptr() % 16 == 0)
    tpr, rpb = launch_plan(rows, d, _build.sm_count(x.device),
                           x.element_size(), vector)
    fn = getattr(_library(), _FNS[(x.dtype, scale.dtype)])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
                 float(eps), tpr, rpb, int(vector), stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("rmsnorm")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
