"""K6: flash-decoding attention for one query per sequence: q (B, H, D),
k and v (B, Sk, Hkv, D), `length` the valid prefix of the cache ->
o (B, H, D) in q's dtype, the math in fp32 throughout.

It is the counterpart of the reference's Pallas kernel
`src/repro/kernels/decode_attention.py::decode_attention` (and of its
oracle `kernels/ref.py::decode_attention_ref`): GQA by kv head =
h // (H / Hkv), the cache split into slices of keys, un-normalised
partials per split, then the reference's rescale-combine.  Where the
reference's two functions disagree, the port chooses and its tests pin
it:

* keys at positions >= min(length, Sk) are masked, so `length` > Sk gives
  the oracle's answer (the Pallas kernel also attends to its own zero
  padding there);
* `length` <= 0 returns zeros, as the Pallas kernel does (the oracle
  returns the uniform mean of v).

`length` is a Python int or a one-element int32 tensor on the inputs'
device, which the kernel reads on the device (no host sync).

`nsplit` and `block_k` are the reference's arguments: they are checked
and otherwise ignored, and no longer set the kernel's split.  The card
sets it: `split_plan` cuts the cache into whole 64-key tiles so that
B x Hkv x splits fills one wave of 3 CTAs per SM (the Pallas kernel's
split would leave most of an H100's 132 SMs idle at a small batch).

On a CUDA tensor the wrapper launches the hand-written kernels
(csrc/decode_attention.cu: the split pass and the combine) and counts
the call in `launches`; on a CPU tensor it runs `decode_attention_plain`.
Any other device raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
import numbers
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.device import exact_fp32
from repro_torch.kernels import _build

#: wrapper calls that launched the kernels on CUDA tensors since import
#: (or the last reset)
launches = 0

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 4096          # g * D: the accumulators of one CTA
KEY_TILE = 64                   # keys per bf16 tile (two fp32 tiles)
MIN_SPLIT_TILES = 2             # tiles per split at the least
CTAS_PER_SM = 3                 # split-pass CTAs an SM holds at D <= 128
_FNS = {torch.bfloat16: "decode_attention_bf16",
        torch.float32: "decode_attention_f32"}

Length = Union[int, torch.Tensor]       # or a numpy integer


def split_plan(b: int, hkv: int, sk: int, sms: int) -> Tuple[int, int]:
    """(splits, keys per split) of the split pass on a card of `sms` SMs:
    whole KEY_TILE-key tiles per split, at least MIN_SPLIT_TILES of them,
    and as many splits as bring the b * hkv * splits CTAs up to one wave
    of CTAS_PER_SM per SM (never past it); the last split may be short."""
    tiles = -(-sk // KEY_TILE)
    want = max(1, CTAS_PER_SM * sms // (b * hkv))
    per_split = max(MIN_SPLIT_TILES, -(-tiles // want)) * KEY_TILE
    return -(-sk // per_split), per_split


def decode_attention_plain(q, k, v, length: Length, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The same function with the scores written out (any device): the
    plain version the kernel is held against."""
    exact_fp32()
    b, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, h // hkv, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    n = torch.as_tensor(length, device=q.device).reshape(())
    s = s.masked_fill(torch.arange(sk, device=q.device) >= n, NEG_INF)
    o = torch.einsum("bhgk,bkhd->bhgd", torch.softmax(s, dim=-1), v.float())
    o = torch.where(n > 0, o, 0.0)
    return o.reshape(b, h, d).to(q.dtype)


def _check(q, k, v, length, nsplit, block_k):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention takes q (B,H,D) and k, v "
                         f"(B,Sk,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    if (k.shape[0] != b or k.shape[3] != d or h % k.shape[2]
            or k.shape[1] < 1):
        raise ValueError(f"decode_attention: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)} (batch, head dim, kv "
                         "heads dividing the heads, at least one key)")
    if d > MAX_HEAD_DIM or (h // k.shape[2]) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention takes D <= {MAX_HEAD_DIM} and "
                         f"(H / Hkv) * D <= {MAX_GROUP_WIDTH}, got D {d}, "
                         f"H / Hkv {h // k.shape[2]}")
    if q.dtype not in _FNS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes bf16 or fp32 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("decode_attention inputs must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention inputs must be contiguous")
    if nsplit < 1 or block_k < 1:
        raise ValueError(f"decode_attention takes positive nsplit and "
                         f"block_k, got {nsplit} and {block_k}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("decode_attention is forward only")
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.dtype != torch.int32:
            raise TypeError(f"decode_attention takes a Python int or a "
                            f"one-element int32 tensor as length, got "
                            f"{length.dtype} {tuple(length.shape)}")
        if length.device != q.device:
            raise ValueError(f"decode_attention: length lies on "
                             f"{length.device}, the inputs on {q.device}")
    elif not isinstance(length, numbers.Integral):
        raise TypeError(f"decode_attention takes a Python int or a "
                        f"one-element int32 tensor as length, got "
                        f"{type(length).__name__}")


def decode_attention(q, k, v, length: Length, *, nsplit: int = 8,
                     block_k: int = 256,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,D), k and v (B,Sk,Hkv,D), length -> (B,H,D) in q's dtype."""
    _check(q, k, v, length, nsplit, block_k)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention runs on CUDA or CPU tensors, "
                           f"not {q.device}")
    b, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if b > 65535 or hkv > 65535:
        raise ValueError(f"decode_attention takes B and Hkv up to 65535, "
                         f"got {b} and {hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    g = h // hkv
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    ns, per_split = split_plan(b, hkv, sk, _build.sm_count(q.device))
    acc = torch.empty((b, hkv, ns, g, d), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((2, b, hkv, ns, g), dtype=torch.float32,
                     device=q.device)
    if isinstance(length, torch.Tensor):
        len_ptr, len_val = length.data_ptr(), 0
    else:
        len_ptr, len_val = None, max(-1, min(int(length), sk))
    width = 16 // q.element_size()
    vector = int(d % width == 0 and k.data_ptr() % 16 == 0
                 and v.data_ptr() % 16 == 0)
    fn = getattr(_library(), _FNS[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, len_val,
                 acc.data_ptr(), ml.data_ptr(), o.data_ptr(), b, h, hkv, sk,
                 d, ns, per_split, float(scale), vector, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return o


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
