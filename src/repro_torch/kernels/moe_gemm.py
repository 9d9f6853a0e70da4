"""K9: grouped (per-expert) GEMM over block-sorted rows: x (T, d),
w (E, d, f), block_ids (T / block_m,) int32 -> (T, f) in x's dtype, row
block i multiplied by w[block_ids[i]] with fp32 accumulation.

It is the counterpart of the reference's Pallas kernel
`src/repro/kernels/moe_gemm.py::grouped_gemm` and computes the same
function, with one addition to its contract: a block whose id is -1 is
written as zeros (the packed layout of `models/moe.py` sizes its buffer
from shapes alone and leaves its unused blocks at -1).

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/moe_gemm.cu) and counts the launch in `launches`; on a CPU tensor
it runs `grouped_gemm_plain`.  Any other device raises.  In bf16 the
kernel multiplies on the tensor cores (bf16 products summed in fp32,
one rounding at the store), with one tile for 64-row blocks (a prefill)
and one for 8-row blocks (a decode tick, a stream over weight slabs);
in fp32 it is an FMA kernel with the same two row tiles.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.device import exact_fp32
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

#: the kernel's row tiles (csrc/moe_gemm.cu: the bf16 `gg_prefill` and
#: `gg_tick`, the fp32 kernel's two shapes); block_m must be a multiple
#: of one of them
TILE_M = (64, 8)
_FNS = {torch.bfloat16: "grouped_gemm_bf16", torch.float32: "grouped_gemm_f32"}


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       block_ids: torch.Tensor, block_m: int) -> torch.Tensor:
    """The same function in tensor ops (any device): one fp32 product per
    expert over the rows of its blocks, never a gathered weight copy per
    block.  Reads the ids on the host.  The plain version the kernel is
    held against."""
    exact_fp32()
    t, _ = x.shape
    n_experts, _, f = w.shape
    ids = block_ids.cpu()
    if bool(((ids < -1) | (ids >= n_experts)).any()):
        raise ValueError(f"block ids must lie in [-1, {n_experts}), got "
                         f"{ids.min().item()}..{ids.max().item()}")
    out = torch.zeros((t, f), dtype=x.dtype, device=x.device)
    rows = torch.arange(t).reshape(-1, block_m)
    for e in torch.unique(ids[ids >= 0]).tolist():
        r = rows[ids == e].reshape(-1).to(x.device)
        out[r] = (x[r].float() @ w[e].float()).to(x.dtype)
    return out


def _check(x, w, block_ids, block_m):
    if x.dim() != 2 or w.dim() != 3 or block_ids.dim() != 1:
        raise ValueError(f"grouped_gemm takes x (T, d), w (E, d, f) and "
                         f"block_ids (T / block_m,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(block_ids.shape)}")
    t, d = x.shape
    if w.shape[1] != d:
        raise ValueError(f"grouped_gemm: w {tuple(w.shape)} does not fit "
                         f"x {tuple(x.shape)}")
    if block_m < 1 or t % block_m or block_ids.shape[0] != t // block_m:
        raise ValueError(f"grouped_gemm: T = {t} must be a multiple of "
                         f"block_m = {block_m} with one id per block, got "
                         f"{block_ids.shape[0]} ids")
    if x.dtype not in _FNS or w.dtype != x.dtype:
        raise TypeError(f"grouped_gemm takes bf16 or fp32 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if block_ids.dtype != torch.int32:
        raise TypeError(f"grouped_gemm takes int32 block ids, got "
                        f"{block_ids.dtype}")
    if w.device != x.device or block_ids.device != x.device:
        raise ValueError("grouped_gemm inputs must be on one device")
    if not (x.is_contiguous() and w.is_contiguous()
            and block_ids.is_contiguous()):
        raise ValueError("grouped_gemm inputs must be contiguous")
    if x.requires_grad or w.requires_grad:
        raise RuntimeError("grouped_gemm is forward only")


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_ids: torch.Tensor,
                 block_m: int) -> torch.Tensor:
    """x (T, d) block-sorted rows, w (E, d, f), block_ids (T // block_m,)
    int32 in [-1, E) -> (T, f) in x's dtype."""
    _check(x, w, block_ids, block_m)
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, block_ids, block_m)
    if x.device.type != "cuda":
        raise RuntimeError(f"grouped_gemm runs on CUDA or CPU tensors, not "
                           f"{x.device}")
    tile = next((m for m in TILE_M if block_m % m == 0), None)
    if tile is None:
        raise ValueError(f"grouped_gemm on the card takes block_m a multiple "
                         f"of one of {TILE_M}, got {block_m}")
    t, d = x.shape
    n_experts, _, f = w.shape
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    width = 16 // x.element_size()
    vector = int(d % width == 0 and f % width == 0
                 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    fn = getattr(_library(), _FNS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), block_ids.data_ptr(),
                 out.data_ptr(), t, block_m, n_experts, d, f, tile, vector,
                 stream)
    if err:
        raise RuntimeError(f"grouped_gemm kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("moe_gemm")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
