"""K7: the diagonal linear recurrence h_t = a_t * h_{t-1} + b_t from
h_{-1} = 0 over a, b (B, T, C) -> (hs (B, T, C) fp32, h_final (B, C)
fp32), the math in fp32 whatever the input dtype.

It is the counterpart of the reference's Pallas kernel
`src/repro/kernels/ssm_scan.py::ssm_scan` (and of its oracle
`kernels/ref.py::ssm_scan_ref`).  The reference pads T and C with
a = 1, b = 0, so padded steps never change h; the port's kernel runs each
chain over exactly T steps and needs no padding.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/ssm_scan.cu, one thread per (b, c) chain) and counts the launch in
`launches`; on a CPU tensor it runs `ssm_scan_plain`.  Any other device
raises.  `chunk` and `block_c` are the reference's time-chunk and
channel-block sizes, kept for signature parity and checked: the CUDA
kernel uses neither (it loops over all of T in one thread per chain and
fixes its own block of channels).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

_FNS = {torch.bfloat16: "ssm_scan_bf16_f32", torch.float32: "ssm_scan_f32_f32"}


def ssm_scan_plain(a: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as a loop over T on tensors (any device): the
    plain version the kernel is held against."""
    bsz, t, c = a.shape
    hs = torch.empty((bsz, t, c), dtype=torch.float32, device=a.device)
    h = torch.zeros((bsz, c), dtype=torch.float32, device=a.device)
    for i in range(t):
        h = a[:, i].float() * h + b[:, i].float()
        hs[:, i] = h
    return hs, h


def _check(a: torch.Tensor, b: torch.Tensor, chunk: int, block_c: int):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"ssm_scan takes a and b of one shape (B, T, C), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _FNS or b.dtype != a.dtype:
        raise TypeError(f"ssm_scan takes bf16 or fp32 a and b of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError("ssm_scan inputs must be on one device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ssm_scan inputs must be contiguous")
    if chunk < 1 or block_c < 1:
        raise ValueError(f"ssm_scan takes positive chunk and block_c, got "
                         f"{chunk} and {block_c}")


def ssm_scan(a: torch.Tensor, b: torch.Tensor, *, chunk: int = 128,
             block_c: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, T, C) bf16 or fp32 -> (hs (B, T, C), h_final (B, C)),
    both fp32."""
    _check(a, b, chunk, block_c)
    if a.device.type == "cpu":
        return ssm_scan_plain(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"ssm_scan runs on CUDA or CPU tensors, not "
                           f"{a.device}")
    bsz, t, c = a.shape
    if bsz > 65535:
        raise ValueError(f"ssm_scan takes B up to 65535, got {bsz}")
    hs = torch.empty((bsz, t, c), dtype=torch.float32, device=a.device)
    hf = torch.zeros((bsz, c), dtype=torch.float32, device=a.device)
    if bsz == 0 or t == 0 or c == 0:
        return hs, hf
    fn = getattr(_library(), _FNS[a.dtype])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), hs.data_ptr(), hf.data_ptr(),
                 bsz, t, c, stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return hs, hf


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("ssm_scan")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
