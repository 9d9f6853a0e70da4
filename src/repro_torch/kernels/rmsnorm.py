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

`rmsnorm_bwd` is its backward (K8's backward), the gradient of the
reference's `rms_norm`: dx and d scale from x, scale and the output's
gradient g, with r recomputed from x (csrc/rmsnorm.cu `rms_bwd_rows`, a
warp a row in `bwd_plan`'s fixed order, then `rms_bwd_sum`: d scale from
per-block partials in a fixed order, no atomics); it counts in
`bwd_launches` and runs `rmsnorm_bwd_plain` on CPU tensors.
`models/layers.py::rms_norm` pairs the two in a `torch.autograd.Function`;
`rmsnorm` itself refuses inputs that require grad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0
#: backward calls on CUDA tensors (two launches each, counted once)
bwd_launches = 0

_FNS = {(torch.bfloat16, torch.bfloat16): "rmsnorm_bf16_bf16",
        (torch.float32, torch.float32): "rmsnorm_f32_f32"}
#: widths compiled as fixed cases (TinyLlama's d, MLA's kv_norm rank)
FIXED_WIDTHS = (512, 2048)
#: threads a block at most (csrc/rmsnorm.cu kMaxThreads)
MAX_THREADS = 256
#: rows a block where a warp takes a row
WARP_ROWS_PER_BLOCK = 2
_BWD_FNS = {torch.bfloat16: "rmsnorm_bwd_bf16", torch.float32: "rmsnorm_bwd_f32"}
#: warps a block of the backward, at most (each holds a d-wide fp32
#: partial of d scale in shared memory)
BWD_WARPS = 8
#: shared memory a block can use on an H100 (bytes)
SMEM_BYTES = 232448


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


def bwd_plan(rows: int, d: int, sms: int) -> Tuple[int, int]:
    """(blocks, warps a block) of the backward on a card of `sms` SMs: a
    warp a row, up to BWD_WARPS warps a block (fewer where their d-wide
    fp32 partials would not fit in shared memory), two blocks an SM at
    most; each warp takes rows in a fixed grid-stride order, so the plan,
    and with it every sum, depends on the shapes alone."""
    warps = min(BWD_WARPS, SMEM_BYTES // (4 * d))
    if warps < 1:
        raise ValueError(f"rmsnorm_bwd takes d <= {SMEM_BYTES // 4}, got {d}")
    return max(1, min(-(-rows // warps), 2 * sms)), warps


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward in tensor ops (any device): with g^ = g (1 + scale)
    and x^ = x r, dx = r (g^ - x^ mean(g^ x^)) in x's dtype and
    d scale = sum over rows of g x^, in fp32 rounded once."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    gh = gf * (1.0 + scale.float())
    dx = r * (gh - xh * torch.mean(gh * xh, dim=-1, keepdim=True))
    return dx.to(x.dtype), torch.sum(gf * xh, dim=0).to(scale.dtype)


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
        raise RuntimeError("rmsnorm is forward only: differentiate through "
                           "models.layers.rms_norm, whose backward runs "
                           "rmsnorm_bwd")


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


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `rmsnorm`: x (T, d) and g (T, d) of x's dtype,
    scale (d,).  Returns (dx (T, d) in x's dtype, d scale (d,) in
    scale's)."""
    _check(x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd takes g of x's shape, dtype and "
                         f"device, got {tuple(g.shape)} {g.dtype} {g.device}")
    if not g.is_contiguous():
        raise ValueError("rmsnorm_bwd inputs must be contiguous")
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, scale, g, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm_bwd runs on CUDA or CPU tensors, not "
                           f"{x.device}")
    rows, d = x.shape
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    blocks, warps = bwd_plan(rows, d, _build.sm_count(x.device))
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    vector = (d * x.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, scale, g)))
    fn = getattr(_library(), _BWD_FNS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 dscale.data_ptr(), part.data_ptr(), rows, d, float(eps),
                 blocks, warps, int(vector), stream)
    if err:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: CUDA error "
                           f"{err}")
    global bwd_launches
    bwd_launches += 1
    return dx, dscale


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("rmsnorm")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _BWD_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
