"""K5: blockwise online-softmax attention forward in the (B, H, S, D)
layout: q (B, H, Sq, D), k and v (B, Hkv, Sk, D) -> o (B, H, Sq, D) in
q's dtype and lse (B, H, Sq) in fp32.

It is the counterpart of the reference's Pallas kernel
`src/repro/kernels/flash_attention.py::flash_attention_fwd` and computes
the same function: fp32 math whatever the input dtype, GQA by
kv head = h // (H / Hkv), the causal mask `kpos <= qpos` with no Sk - Sq
offset, masked scores at the reference's -1e30.  The reference returns
lse lane-replicated (a TPU layout); the port returns it (B, H, Sq).

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/flash_attention.cu: bf16 on the tensor cores, each softmax weight
split into two bf16 terms so that P V keeps fp32-like weights; fp32 on
FMAs) and counts the launch in `launches`; on a CPU tensor it runs
`flash_attention_fwd_plain`.  Any other device raises.  It refuses inputs
that require grad: the backward kernel (K11) comes with training.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.device import exact_fp32
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_FNS = {torch.bfloat16: "flash_attention_fwd_bf16",
        torch.float32: "flash_attention_fwd_f32"}


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function with the score matrix written out (any device):
    the plain version the kernel is held against."""
    exact_fp32()
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(h // hkv, dim=1)
    vf = v.float().repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, vf).to(q.dtype), lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd takes q (B,H,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)} (batch, head dim, and "
                         "kv heads dividing the heads)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _FNS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes bf16 or fp32 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd inputs must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd inputs must be contiguous")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention_fwd is forward only: its "
                           "backward (K11) is not ported yet")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,Sq,D), k and v (B,Hkv,Sk,D) -> (o (B,H,Sq,D), lse (B,H,Sq))."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_fwd runs on CUDA or CPU "
                           f"tensors, not {q.device}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = getattr(_library(), _FNS[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, hkv, sq, sk, d, int(causal),
                 float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return o, lse


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
