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

The backward has two entry points of its own, the counterpart of XLA's
gradient of the reference's expert einsums (`src/repro/models/moe.py`:
105-108): `grouped_gemm_dx` (dX = dY W[e]^T block by block, the
forward's two row tiles) and `grouped_gemm_dw` (dW[e] = the sum over the
blocks of id e of X_blk^T dY_blk, one block per expert and output tile
walking the ids in order: no atomics, so two launches give the same
bits).  Both accumulate in fp32 and round once, count their launches in
`bwd_launches`, run `*_plain` on CPU tensors and raise elsewhere.
`kernels/ops.py::GroupedGemm` puts the three under autograd.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.device import exact_fp32
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0
#: backward launches (dX and dW) on CUDA tensors, counted the same way
bwd_launches = 0

#: the kernels' row tiles (csrc/moe_gemm.cu: the bf16 `gg_prefill` and
#: `gg_tick`, dX's `gg_dx_rows` and `gg_dx_tick`, the fp32 kernels' two
#: shapes); block_m must be a multiple of one of them
TILE_M = (64, 8)
_FNS = {torch.bfloat16: "grouped_gemm_bf16", torch.float32: "grouped_gemm_f32"}
_DX_FNS = {torch.bfloat16: "grouped_gemm_dx_bf16",
           torch.float32: "grouped_gemm_dx_f32"}
_DW_FNS = {torch.bfloat16: "grouped_gemm_dw_bf16",
           torch.float32: "grouped_gemm_dw_f32"}


def _expert_rows(block_ids: torch.Tensor, block_m: int, n_experts: int):
    """(expert, its rows on the host) for every expert some block names,
    the ids checked to lie in [-1, n_experts)."""
    ids = block_ids.cpu()
    if bool(((ids < -1) | (ids >= n_experts)).any()):
        raise ValueError(f"block ids must lie in [-1, {n_experts}), got "
                         f"{ids.min().item()}..{ids.max().item()}")
    rows = torch.arange(ids.shape[0] * block_m).reshape(-1, block_m)
    return [(e, rows[ids == e].reshape(-1))
            for e in torch.unique(ids[ids >= 0]).tolist()]


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       block_ids: torch.Tensor, block_m: int) -> torch.Tensor:
    """The same function in tensor ops (any device): one fp32 product per
    expert over the rows of its blocks, never a gathered weight copy per
    block.  Reads the ids on the host.  The plain version the kernel is
    held against."""
    exact_fp32()
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    for e, r in _expert_rows(block_ids, block_m, w.shape[0]):
        r = r.to(x.device)
        out[r] = (x[r].float() @ w[e].float()).to(x.dtype)
    return out


def grouped_gemm_dx_plain(dy: torch.Tensor, w: torch.Tensor,
                          block_ids: torch.Tensor,
                          block_m: int) -> torch.Tensor:
    """dX of `grouped_gemm` in tensor ops (any device): dy (T, f), w
    (E, d, f) -> (T, d), each expert's rows dy_r w[e]^T in one fp32
    product; -1 blocks zeros.  The plain version `grouped_gemm_dx` is held
    against."""
    exact_fp32()
    out = torch.zeros((dy.shape[0], w.shape[1]), dtype=dy.dtype,
                      device=dy.device)
    for e, r in _expert_rows(block_ids, block_m, w.shape[0]):
        r = r.to(dy.device)
        out[r] = (dy[r].float() @ w[e].float().T).to(dy.dtype)
    return out


def grouped_gemm_dw_plain(x: torch.Tensor, dy: torch.Tensor,
                          block_ids: torch.Tensor, block_m: int,
                          n_experts: int) -> torch.Tensor:
    """dW of `grouped_gemm` in tensor ops (any device): x (T, d), dy
    (T, f) -> (E, d, f) in x's dtype, dw[e] = x_r^T dy_r over the rows of
    expert e's blocks in one fp32 product; zeros for an expert that owns
    no block.  The plain version `grouped_gemm_dw` is held against."""
    exact_fp32()
    out = torch.zeros((n_experts, x.shape[1], dy.shape[1]), dtype=x.dtype,
                      device=x.device)
    for e, r in _expert_rows(block_ids, block_m, n_experts):
        r = r.to(x.device)
        out[e] = (x[r].float().T @ dy[r].float()).to(x.dtype)
    return out


def _check(name, a, b, block_ids, block_m, fits):
    """Shared input checks: 2-d `a` (T, ...) with one id per block_m rows,
    `b` of a shape that `fits` it, one floating dtype of the kernels', one
    device, contiguous, no input that requires grad (the kernels write
    fresh tensors and would drop the gradient)."""
    if a.dim() != 2 or block_ids.dim() != 1:
        raise ValueError(f"{name} takes a 2-d first input and 1-d block_ids, "
                         f"got {tuple(a.shape)}, {tuple(block_ids.shape)}")
    if not fits(a, b):
        raise ValueError(f"{name}: {tuple(b.shape)} does not fit "
                         f"{tuple(a.shape)}")
    t = a.shape[0]
    if block_m < 1 or t % block_m or block_ids.shape[0] != t // block_m:
        raise ValueError(f"{name}: T = {t} must be a multiple of "
                         f"block_m = {block_m} with one id per block, got "
                         f"{block_ids.shape[0]} ids")
    if a.dtype not in _FNS or b.dtype != a.dtype:
        raise TypeError(f"{name} takes bf16 or fp32 inputs of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if block_ids.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 block ids, got "
                        f"{block_ids.dtype}")
    if b.device != a.device or block_ids.device != a.device:
        raise ValueError(f"{name} inputs must be on one device")
    if not (a.is_contiguous() and b.is_contiguous()
            and block_ids.is_contiguous()):
        raise ValueError(f"{name} inputs must be contiguous")
    if a.requires_grad or b.requires_grad:
        raise RuntimeError(f"{name} is forward only: it has no gradient of "
                           "its own (ops.GroupedGemm is K9's differentiable "
                           "entry)")


def _tile(name, a, block_m):
    """The row tile of a launch on `a`'s device: None on the CPU (the plain
    version runs), else the first of TILE_M that divides block_m."""
    if a.device.type == "cpu":
        return None
    if a.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA or CPU tensors, not "
                           f"{a.device}")
    tile = next((m for m in TILE_M if block_m % m == 0), None)
    if tile is None:
        raise ValueError(f"{name} on the card takes block_m a multiple of "
                         f"one of {TILE_M}, got {block_m}")
    return tile


def _launch(name, fn_name, a, b, block_ids, out, block_m, n_experts, d, f,
            *tile):
    """Launch one kernel of the library on the current stream; `vector`
    (16-byte loads) where both inputs start on 16 bytes and d and f are
    whole 16-byte pieces."""
    width = 16 // a.element_size()
    vector = int(d % width == 0 and f % width == 0
                 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    fn = getattr(_library(), fn_name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), block_ids.data_ptr(),
                 out.data_ptr(), a.shape[0], block_m, n_experts, d, f,
                 *tile, vector, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_ids: torch.Tensor,
                 block_m: int) -> torch.Tensor:
    """x (T, d) block-sorted rows, w (E, d, f), block_ids (T // block_m,)
    int32 in [-1, E) -> (T, f) in x's dtype."""
    _check("grouped_gemm", x, w, block_ids, block_m,
           lambda x, w: w.dim() == 3 and w.shape[1] == x.shape[1])
    tile = _tile("grouped_gemm", x, block_m)
    if tile is None:
        return grouped_gemm_plain(x, w, block_ids, block_m)
    n_experts, d, f = w.shape
    out = torch.empty((x.shape[0], f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("grouped_gemm", _FNS[x.dtype], x, w, block_ids, out, block_m,
            n_experts, d, f, tile)
    global launches
    launches += 1
    return out


def grouped_gemm_dx(dy: torch.Tensor, w: torch.Tensor,
                    block_ids: torch.Tensor, block_m: int) -> torch.Tensor:
    """dX of `grouped_gemm`: dy (T, f), w (E, d, f), block_ids (T //
    block_m,) int32 in [-1, E) -> (T, d) in dy's dtype, row block i
    dy_i w[block_ids[i]]^T, a -1 block zeros."""
    _check("grouped_gemm_dx", dy, w, block_ids, block_m,
           lambda dy, w: w.dim() == 3 and w.shape[2] == dy.shape[1])
    tile = _tile("grouped_gemm_dx", dy, block_m)
    if tile is None:
        return grouped_gemm_dx_plain(dy, w, block_ids, block_m)
    n_experts, d, f = w.shape
    out = torch.empty((dy.shape[0], d), dtype=dy.dtype, device=dy.device)
    if out.numel() == 0:
        return out
    _launch("grouped_gemm_dx", _DX_FNS[dy.dtype], dy, w, block_ids, out,
            block_m, n_experts, d, f, tile)
    global bwd_launches
    bwd_launches += 1
    return out


def grouped_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                    block_ids: torch.Tensor, block_m: int,
                    n_experts: int) -> torch.Tensor:
    """dW of `grouped_gemm`: x (T, d), dy (T, f), block_ids (T //
    block_m,) int32 in [-1, E) -> (E, d, f) in x's dtype, dw[e] the sum
    of x_blk^T dy_blk over the blocks of id e (zeros if none)."""
    _check("grouped_gemm_dw", x, dy, block_ids, block_m,
           lambda x, dy: dy.dim() == 2 and dy.shape[0] == x.shape[0])
    if n_experts < 1:
        raise ValueError(f"grouped_gemm_dw takes 1 or more experts, got "
                         f"{n_experts}")
    if _tile("grouped_gemm_dw", x, block_m) is None:
        return grouped_gemm_dw_plain(x, dy, block_ids, block_m, n_experts)
    d, f = x.shape[1], dy.shape[1]
    out = torch.empty((n_experts, d, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("grouped_gemm_dw", _DW_FNS[x.dtype], x, dy, block_ids, out,
            block_m, n_experts, d, f)
    global bwd_launches
    bwd_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("moe_gemm")
    for names, ints in ((_FNS, 7), (_DX_FNS, 7), (_DW_FNS, 6)):
        for name in names.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib
