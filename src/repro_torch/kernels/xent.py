"""K10: fused softmax cross-entropy over vocab tiles.  x (T, d), emb
(V, d) or, with `transpose_emb`, the (d, V) head read in place, labels
(T,) -> nll (T,) fp32 and the argmax (T,) int32, with the (T, V) logits
never formed.

It is the counterpart of the reference's Pallas kernel
`src/repro/kernels/xent.py::blocked_xent` and computes the same nll, the
products in fp32 from the inputs' values; it also returns the first index
of each row's maximum logit, which the reference's XLA twin
`models/loss.py::blocked_cross_entropy` keeps for its accuracy.

`block_v` is the vocab block: the plain version scans blocks of that many
columns, as the reference's scan does; the kernel gives each CUDA block a
chunk of that many columns (rounded up to its 128-column tile) and merges
the chunks' partials as the scan merges blocks.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/xent.cu: bf16 on the tensor cores, fp32 on FMAs) and counts the
launch in `launches`; on a CPU tensor it runs `blocked_xent_plain`.  Any
other device raises.  It refuses inputs that require grad: the backward
comes with training.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.device import exact_fp32
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

#: the kernels' token tile by dtype and their vocab tile (csrc/xent.cu)
TILE_T = {torch.bfloat16: 128, torch.float32: 64}
TILE_V = 128
_FNS = {torch.bfloat16: "blocked_xent_bf16", torch.float32: "blocked_xent_f32"}


def blocked_xent_plain(x: torch.Tensor, emb: torch.Tensor,
                       labels: torch.Tensor, *, transpose_emb: bool = False,
                       block_v: int = 8192
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in tensor ops (any device): a scan over vocab
    blocks of `block_v` columns carrying the running max, sum-exp, label
    logit and argmax, as the reference's `blocked_cross_entropy`.  The
    plain version the kernel is held against."""
    exact_fp32()
    e = emb.t() if transpose_emb else emb                  # (V, d) view
    v = e.shape[0]
    t = x.shape[0]
    dev = x.device
    xf = x.float()
    labels = labels.long()
    m = torch.full((t,), -torch.inf, device=dev)
    s = torch.zeros((t,), device=dev)
    ll = torch.full((t,), -torch.inf, device=dev)
    best = torch.full((t,), -torch.inf, device=dev)
    amax = torch.zeros((t,), dtype=torch.long, device=dev)
    for base in range(0, v, block_v):
        logits = xf @ e[base:base + block_v].float().t()  # (T, bv)
        bv = logits.shape[1]
        blk_max, blk_arg = logits.max(dim=1)   # first index of the maximum
        new_m = torch.maximum(m, blk_max)
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=1)
        m = new_m
        in_blk = (labels >= base) & (labels < base + bv)
        idx = (labels - base).clamp(0, bv - 1)
        ll = torch.where(in_blk, logits.gather(1, idx[:, None])[:, 0], ll)
        better = blk_max > best
        best = torch.where(better, blk_max, best)
        amax = torch.where(better, blk_arg + base, amax)
    return m + torch.log(s) - ll, amax.to(torch.int32)


def _check(x, emb, labels, transpose_emb, block_v):
    if x.dim() != 2 or emb.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"blocked_xent takes x (T, d), emb (V, d) or (d, V) "
                         f"and labels (T,), got {tuple(x.shape)}, "
                         f"{tuple(emb.shape)}, {tuple(labels.shape)}")
    d = emb.shape[0] if transpose_emb else emb.shape[1]
    v = emb.shape[1] if transpose_emb else emb.shape[0]
    if d != x.shape[1] or labels.shape[0] != x.shape[0] or v < 1:
        layout = "(d, V)" if transpose_emb else "(V, d)"
        raise ValueError(f"blocked_xent: emb {tuple(emb.shape)} as {layout} "
                         f"and labels {tuple(labels.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if block_v < 1:
        raise ValueError(f"blocked_xent: block_v must be >= 1, got {block_v}")
    if x.dtype not in _FNS or emb.dtype != x.dtype:
        raise TypeError(f"blocked_xent takes bf16 or fp32 x and emb of one "
                        f"dtype, got {x.dtype} and {emb.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"blocked_xent takes int32 or int64 labels, got "
                        f"{labels.dtype}")
    if emb.device != x.device or labels.device != x.device:
        raise ValueError("blocked_xent inputs must be on one device")
    if not (x.is_contiguous() and emb.is_contiguous()):
        raise ValueError("blocked_xent takes contiguous x and emb")
    if x.requires_grad or emb.requires_grad:
        raise RuntimeError("blocked_xent is forward only")


def blocked_xent(x: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                 *, transpose_emb: bool = False, block_v: int = 8192
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) bf16 or fp32; emb (V, d), or (d, V) with `transpose_emb`,
    of x's dtype; labels (T,) int32 or int64.  Returns nll (T,) fp32 and
    the argmax (T,) int32."""
    _check(x, emb, labels, transpose_emb, block_v)
    if x.device.type == "cpu":
        return blocked_xent_plain(x, emb, labels, transpose_emb=transpose_emb,
                                  block_v=block_v)
    if x.device.type != "cuda":
        raise RuntimeError(f"blocked_xent runs on CUDA or CPU tensors, not "
                           f"{x.device}")
    t, d = x.shape
    v = emb.shape[1] if transpose_emb else emb.shape[0]
    nll = torch.empty((t,), dtype=torch.float32, device=x.device)
    amax = torch.empty((t,), dtype=torch.int32, device=x.device)
    if t == 0:
        return nll, amax
    chunk = -(-block_v // TILE_V) * TILE_V
    chunks = -(-v // chunk)
    if chunks > 1:
        part = torch.empty((5, chunks, t), dtype=torch.float32,
                           device=x.device)
        counter = torch.zeros((-(-t // TILE_T[x.dtype]),), dtype=torch.int32,
                              device=x.device)
    else:
        part, counter = nll, amax                    # not read
    labels = labels.to(torch.int32).contiguous()
    width = 16 // x.element_size()
    vector = int(d % width == 0 and (not transpose_emb or v % width == 0)
                 and x.data_ptr() % 16 == 0 and emb.data_ptr() % 16 == 0)
    fn = getattr(_library(), _FNS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), emb.data_ptr(), labels.data_ptr(),
                 nll.data_ptr(), amax.data_ptr(), part.data_ptr(),
                 counter.data_ptr(), t, v, d, chunk, int(transpose_emb),
                 vector, stream)
    if err:
        raise RuntimeError(f"blocked_xent kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return nll, amax


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("xent")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
