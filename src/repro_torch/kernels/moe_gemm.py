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
`bwd_launches` (and by route in `bwd_launches_by_route`), run `*_plain`
on CPU tensors and raise elsewhere.  `bwd_route` picks the kernels of a
launch from the shapes and alignment alone: "sm90" (bf16, block_m a
multiple of 64, d and f multiples of 8, 16-byte aligned bases: TMA's
rules) takes the Hopper kernels `gg_dx_sm90` / `gg_dw_sm90` (`wgmma` fed
by TMA through an `mbarrier` ring, persistent blocks, 128 x 256 tiles
stored by TMA); "mma" every other bf16 launch (the `mma.sync` kernels
`gg_dx_rows`, `gg_dx_tick`, `gg_dw`: 8-row decode blocks, ragged or
unaligned shapes); "fma" fp32.  `kernels/ops.py::GroupedGemm` puts the
three under autograd.
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
#: the same launches by route (`bwd_route`)
bwd_launches_by_route = {"sm90": 0, "mma": 0, "fma": 0}

#: the kernels' row tiles (csrc/moe_gemm.cu: the bf16 `gg_prefill` and
#: `gg_tick`, dX's `gg_dx_rows` and `gg_dx_tick`, the fp32 kernels' two
#: shapes); block_m must be a multiple of one of them
TILE_M = (64, 8)
_FNS = {torch.bfloat16: "grouped_gemm_bf16", torch.float32: "grouped_gemm_f32"}
_DX_FNS = {torch.bfloat16: "grouped_gemm_dx_bf16",
           torch.float32: "grouped_gemm_dx_f32"}
_DW_FNS = {torch.bfloat16: "grouped_gemm_dw_bf16",
           torch.float32: "grouped_gemm_dw_f32"}
#: dW's sm90 kernel keeps an int an expert in shared memory beside its
#: 144 KiB ring and 64 KiB of staged output
SM90_MAX_EXPERTS = 2048


def bwd_route(dtype, block_m: int, d: int, f: int, aligned: bool,
              n_experts: int = 1) -> str:
    """The backward kernels a launch takes, from shapes and alignment
    only: "sm90" for bf16 with block_m a multiple of 64, d and f multiples
    of 8 (rows on 16 bytes) and 16-byte aligned bases (`aligned`), with at
    most SM90_MAX_EXPERTS experts (dW); "fma" for fp32; "mma" otherwise.
    Every route is a hand-written kernel."""
    if dtype == torch.float32:
        return "fma"
    if (dtype == torch.bfloat16 and block_m % 64 == 0 and d % 8 == 0
            and f % 8 == 0 and aligned and n_experts <= SM90_MAX_EXPERTS):
        return "sm90"
    return "mma"


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


def _bwd_route(name, a, b, block_m, d, f, n_experts, route):
    """The route of a backward launch on the card: `bwd_route`'s, or
    "mma" where that is "sm90" and `route` asks for it (the card tests
    and chip_smoke.py hold both routes to the plain versions on the same
    inputs)."""
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    auto = bwd_route(a.dtype, block_m, d, f, aligned, n_experts)
    if route is None or route == auto:
        return auto
    if route == "mma" and auto == "sm90":
        return route
    raise ValueError(f"{name}: route {route!r} does not take these inputs "
                     f"(bwd_route gives {auto!r})")


def _launch_bwd(name, route, fns, a, b, block_ids, out, block_m, n_experts,
                d, f, tile):
    """One backward launch by `route`, counted in `bwd_launches` and
    `bwd_launches_by_route`."""
    if route == "sm90":
        fn = getattr(_library(), fns)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), block_ids.data_ptr(),
                     out.data_ptr(), a.shape[0], block_m, n_experts, d, f,
                     _build.sm_count(a.device), stream)
        if err:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
    else:
        _launch(name, fns, a, b, block_ids, out, block_m, n_experts, d, f,
                *tile)
    global bwd_launches
    bwd_launches += 1
    bwd_launches_by_route[route] += 1


def grouped_gemm_dx(dy: torch.Tensor, w: torch.Tensor,
                    block_ids: torch.Tensor, block_m: int) -> torch.Tensor:
    """dX of `grouped_gemm`: dy (T, f), w (E, d, f), block_ids (T //
    block_m,) int32 in [-1, E) -> (T, d) in dy's dtype, row block i
    dy_i w[block_ids[i]]^T, a -1 block zeros."""
    return _grouped_gemm_dx(dy, w, block_ids, block_m)


def _grouped_gemm_dx(dy, w, block_ids, block_m, route=None):
    """`grouped_gemm_dx` on the route `_bwd_route` takes."""
    _check("grouped_gemm_dx", dy, w, block_ids, block_m,
           lambda dy, w: w.dim() == 3 and w.shape[2] == dy.shape[1])
    tile = _tile("grouped_gemm_dx", dy, block_m)
    if tile is None:
        return grouped_gemm_dx_plain(dy, w, block_ids, block_m)
    n_experts, d, f = w.shape
    route = _bwd_route("grouped_gemm_dx", dy, w, block_m, d, f, 1, route)
    out = torch.empty((dy.shape[0], d), dtype=dy.dtype, device=dy.device)
    if out.numel() == 0:
        return out
    _launch_bwd("grouped_gemm_dx", route,
                "grouped_gemm_dx_sm90" if route == "sm90"
                else _DX_FNS[dy.dtype], dy, w, block_ids, out, block_m,
                n_experts, d, f, (tile,))
    return out


def grouped_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                    block_ids: torch.Tensor, block_m: int,
                    n_experts: int) -> torch.Tensor:
    """dW of `grouped_gemm`: x (T, d), dy (T, f), block_ids (T //
    block_m,) int32 in [-1, E) -> (E, d, f) in x's dtype, dw[e] the sum
    of x_blk^T dy_blk over the blocks of id e (zeros if none)."""
    return _grouped_gemm_dw(x, dy, block_ids, block_m, n_experts)


def _grouped_gemm_dw(x, dy, block_ids, block_m, n_experts, route=None):
    """`grouped_gemm_dw` on the route `_bwd_route` takes."""
    _check("grouped_gemm_dw", x, dy, block_ids, block_m,
           lambda x, dy: dy.dim() == 2 and dy.shape[0] == x.shape[0])
    if n_experts < 1:
        raise ValueError(f"grouped_gemm_dw takes 1 or more experts, got "
                         f"{n_experts}")
    if _tile("grouped_gemm_dw", x, block_m) is None:
        return grouped_gemm_dw_plain(x, dy, block_ids, block_m, n_experts)
    d, f = x.shape[1], dy.shape[1]
    route = _bwd_route("grouped_gemm_dw", x, dy, block_m, d, f, n_experts,
                       route)
    out = torch.empty((n_experts, d, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch_bwd("grouped_gemm_dw", route,
                "grouped_gemm_dw_sm90" if route == "sm90"
                else _DW_FNS[x.dtype], x, dy, block_ids, out, block_m,
                n_experts, d, f, ())
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("moe_gemm")
    sm90 = ("grouped_gemm_dx_sm90", "grouped_gemm_dw_sm90")
    for names, ints in ((_FNS.values(), 7), (_DX_FNS.values(), 7),
                        (_DW_FNS.values(), 6), (sm90, 6)):
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.grouped_gemm_sm90_plan.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.grouped_gemm_sm90_plan.restype = ctypes.c_int
    return lib
