"""K12c forward: Mamba-1's selective scan over (B, S) steps of d_inner
channels with N states each, from h = 0:

    a = exp(dt A),  b = (dt x) B_t,  h = a h + b,  y_t = sum_n h C_t,

returning y (B, S, d_inner) fp32 and the last h (B, d_inner, N) fp32, the
math in fp32 whatever the input dtype.

It is the counterpart of the reference's `_mamba_chunk_scan`
(`src/repro/models/ssm.py:129`), which XLA runs as a checkpointed scan
over time chunks, forming the decay a and the input b as (B, chunk,
d_inner, N) tensors a chunk at a time.  The CUDA kernel
(csrc/selective_scan.cu: a group of G lanes a channel, G the power of two
at or above N, lane n holding h[d, n] in a register, y_t a fixed-order
butterfly over the group) forms a and b in registers and allocates no
(B, S, d_inner, N) or (B, chunk, d_inner, N) tensor.

On a CUDA tensor the wrapper launches the kernel and counts the call in
`launches`; on a CPU tensor it runs `selective_scan_plain`, the
reference's chunk body in tensor ops.  Any other device raises.  It is
forward only: an input that requires grad is refused (the backward is
ROADMAP.md Queue 1 item 6 (c)).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

_FNS = {torch.bfloat16: "selective_scan_bf16",
        torch.float32: "selective_scan_f32"}
#: states a channel the kernel takes at most (one warp a channel)
MAX_STATES = 32
#: the reference's time chunk (`src/repro/models/ssm.py::DEFAULT_CHUNK`)
DEFAULT_CHUNK = 64


def selective_scan_plain(dt: torch.Tensor, bm: torch.Tensor,
                         cm: torch.Tensor, x: torch.Tensor, A: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunk body in tensor ops (any device): per time
    chunk of `DEFAULT_CHUNK` steps, a = exp(dt A) and b = (dt x) B as (B, chunk,
    d_inner, N) tensors, then h = a h + b and y_t = sum_n h C_t step by
    step.  The plain version the kernel is held against."""
    bsz, steps, di = dt.shape
    n = bm.shape[-1]
    f32 = torch.float32
    y = torch.empty((bsz, steps, di), dtype=f32, device=dt.device)
    h = torch.zeros((bsz, di, n), dtype=f32, device=dt.device)
    for t0 in range(0, steps, DEFAULT_CHUNK):
        t1 = min(t0 + DEFAULT_CHUNK, steps)
        dt_c = dt[:, t0:t1].to(f32)
        a = torch.exp(dt_c[..., None] * A[None, None])
        b = (dt_c * x[:, t0:t1].to(f32))[..., None] * \
            bm[:, t0:t1].to(f32)[:, :, None, :]
        c = cm[:, t0:t1].to(f32)
        for i in range(t1 - t0):
            h = a[:, i] * h + b[:, i]
            y[:, t0 + i] = torch.einsum("bdn,bn->bd", h, c[:, i])
    return y, h


def _check(dt, bm, cm, x, A):
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan takes dt and x of one shape "
                         f"(B, S, d_inner), got {tuple(dt.shape)} and "
                         f"{tuple(x.shape)}")
    bsz, steps, di = dt.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"selective_scan takes A (d_inner, N) = ({di}, N), "
                         f"got {tuple(A.shape)}")
    n = A.shape[1]
    if bm.shape != (bsz, steps, n) or cm.shape != bm.shape:
        raise ValueError(f"selective_scan takes Bm and Cm (B, S, N) = "
                         f"{(bsz, steps, n)}, got {tuple(bm.shape)} and "
                         f"{tuple(cm.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"selective_scan takes fp32 dt and A, got "
                        f"{dt.dtype} and {A.dtype}")
    if x.dtype not in _FNS or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise TypeError(f"selective_scan takes Bm, Cm and x of one dtype, "
                        f"bf16 or fp32, got {bm.dtype}, {cm.dtype} and "
                        f"{x.dtype}")
    tensors = (dt, bm, cm, x, A)
    if any(t.device != dt.device for t in tensors):
        raise ValueError("selective_scan inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan inputs must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("selective_scan is forward only (its backward: "
                           "ROADMAP.md Queue 1 item 6 (c))")


def selective_scan(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                   x: torch.Tensor, A: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt (B, S, d_inner) fp32, Bm and Cm (B, S, N), x (B, S, d_inner)
    (Bm, Cm and x bf16 or fp32), A (d_inner, N) fp32 -> (y (B, S,
    d_inner), h_final (B, d_inner, N)), both fp32."""
    _check(dt, bm, cm, x, A)
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, bm, cm, x, A)
    if dt.device.type != "cuda":
        raise RuntimeError(f"selective_scan runs on CUDA or CPU tensors, "
                           f"not {dt.device}")
    bsz, steps, di = dt.shape
    n = A.shape[1]
    if bsz > 65535 or n > MAX_STATES:
        raise ValueError(f"selective_scan takes B up to 65535 and N up to "
                         f"{MAX_STATES}, got {bsz} and {n}")
    y = torch.empty((bsz, steps, di), dtype=torch.float32, device=dt.device)
    hf = torch.zeros((bsz, di, n), dtype=torch.float32, device=dt.device)
    if bsz == 0 or steps == 0 or di == 0 or n == 0:
        return y, hf
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_library(), _FNS[x.dtype])(
            dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
            A.data_ptr(), y.data_ptr(), hf.data_ptr(), bsz, steps, di, n,
            stream)
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return y, hf


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("selective_scan")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
