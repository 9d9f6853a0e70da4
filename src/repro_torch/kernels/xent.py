"""K10: fused softmax cross-entropy over vocab tiles.  x (T, d), emb
(V, d) or, with `transpose_emb`, the (d, V) head read in place, labels
(T,) -> nll (T,) fp32, the argmax (T,) int32 and each row's log-sum-exp
lse (T,) fp32, with the (T, V) logits never formed.  K12a, its backward:
x, emb, labels, lse and the gradient g (T,) of nll -> dx and d emb.

K10 is the counterpart of the reference's Pallas kernel
`src/repro/kernels/xent.py::blocked_xent` and computes the same nll, the
products in fp32 from the inputs' values; it also returns the first index
of each row's maximum logit, which the reference's XLA twin
`models/loss.py::blocked_cross_entropy` keeps for its accuracy, and lse,
which the backward reads.

K12a replaces the XLA code that differentiates that twin (the VJP of its
`jax.checkpoint`-ed scan): per vocab chunk of `block_v` columns the
kernel (csrc/xent_bwd.cu) recomputes the logits tile and writes dl =
g (softmax - one-hot) into a (T, chunk) buffer: fp32 on the fp32 path,
and on the bf16 path as hi and lo bf16 terms (dl rounded to bf16 alone
misses one rounding step on dx where a row's softmax and one-hot terms
cancel).  The chunk's two products dx += dl E_chunk and d E_chunk =
dl^T x go to cuBLAS, as the reference leaves its einsums to XLA; in bf16
each is taken over hi and lo, accumulated in place into fp32 (dx over
the whole call, d E_chunk in a buffer cast once into d emb).  The
chunks run from the last to the first, as the reference's reverse scan
does, dx summed in fp32 and rounded once.  `bwd_route` picks K12a's
kernel from the shapes and alignment alone: "sm90" (bf16 where TMA can
describe the tensors) takes the Hopper kernel `xent_bwd_sm90` (`wgmma`
fed by TMA through an `mbarrier` ring, persistent blocks, dl stored by
TMA), "mma" every other bf16 input (the `mma.sync` kernel), "fma" fp32.

`block_v` is the vocab block: the plain versions scan blocks of that many
columns, as the reference's scan does; the kernels take chunks of that
many columns rounded up to their 128-column tile (K10 merges the chunks'
partials as the scan merges blocks).

On a CUDA tensor each wrapper launches its hand-written kernel (bf16 on
the tensor cores, fp32 on FMAs) and counts each launch (`launches`,
`bwd_launches`, by route in `bwd_launches_by_route`; a K12a call
launches its kernel once a chunk); on a CPU tensor it runs its plain
version.  Any other device raises.  The forward refuses inputs that
require grad: `kernels/ops.py::BlockedXent` is the differentiable
entry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.device import exact_fp32
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset): K10's
#: (one a call) and K12a's (one a vocab chunk)
launches = 0
bwd_launches = 0
#: K12a's launches by route (`bwd_route`)
bwd_launches_by_route = {"sm90": 0, "mma": 0, "fma": 0}

#: the kernels' token tile by dtype and their vocab tile (csrc/xent.cu)
TILE_T = {torch.bfloat16: 128, torch.float32: 64}
TILE_V = 128
_FNS = {torch.bfloat16: "blocked_xent_bf16", torch.float32: "blocked_xent_f32"}
_BWD_FNS = {"sm90": "blocked_xent_bwd_sm90", "mma": "blocked_xent_bwd_bf16",
            "fma": "blocked_xent_bwd_f32"}


def _rows_on_16_bytes(size: int, d: int, v: int, transpose_emb: bool,
                      aligned: bool) -> bool:
    """Whether rows of `size`-byte elements lie on 16 bytes: d, and V for
    the (d, V) head, multiples of 16 // size, x and emb on 16 bytes
    (`aligned`).  The kernels' 16-byte loads need it, and so does TMA."""
    width = 16 // size
    return (aligned and d % width == 0
            and (not transpose_emb or v % width == 0))


def bwd_route(dtype, d: int, v: int, transpose_emb: bool,
              aligned: bool) -> str:
    """K12a's kernel for a launch, from shapes and alignment only: "sm90"
    for bf16 where TMA can describe the tensors (`_rows_on_16_bytes`: d,
    and V for the (d, V) head, multiples of 8; x and emb on 16 bytes);
    "fma" for fp32; "mma" otherwise.  Every route is a hand-written
    kernel."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16 and _rows_on_16_bytes(2, d, v, transpose_emb,
                                                     aligned):
        return "sm90"
    return "mma"


def blocked_xent_plain(x: torch.Tensor, emb: torch.Tensor,
                       labels: torch.Tensor, *, transpose_emb: bool = False,
                       block_v: int = 8192
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
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
    lse = m + torch.log(s)
    return lse - ll, amax.to(torch.int32), lse


def _check(x, emb, labels, transpose_emb, block_v, grad=False):
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
    if not grad and (x.requires_grad or emb.requires_grad):
        raise RuntimeError("blocked_xent is forward only (ops.BlockedXent "
                           "differentiates it)")


def blocked_xent(x: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                 *, transpose_emb: bool = False, block_v: int = 8192
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) bf16 or fp32; emb (V, d), or (d, V) with `transpose_emb`,
    of x's dtype; labels (T,) int32 or int64.  Returns nll (T,) fp32, the
    argmax (T,) int32 and lse (T,) fp32."""
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
    lse = torch.empty((t,), dtype=torch.float32, device=x.device)
    if t == 0:
        return nll, amax, lse
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
    vector = _vector(x, emb, transpose_emb)
    fn = getattr(_library(), _FNS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), emb.data_ptr(), labels.data_ptr(),
                 nll.data_ptr(), amax.data_ptr(), lse.data_ptr(),
                 part.data_ptr(), counter.data_ptr(), t, v, d, chunk,
                 int(transpose_emb), vector, stream)
    if err:
        raise RuntimeError(f"blocked_xent kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return nll, amax, lse


def _aligned(x, emb) -> bool:
    return x.data_ptr() % 16 == 0 and emb.data_ptr() % 16 == 0


def _vector(x, emb, transpose_emb) -> int:
    """Whether the kernels may load x and emb in 16-byte pieces."""
    v = emb.shape[1] if transpose_emb else emb.shape[0]
    return int(_rows_on_16_bytes(x.element_size(), x.shape[1], v,
                                 transpose_emb, _aligned(x, emb)))


def blocked_xent_bwd_plain(x: torch.Tensor, emb: torch.Tensor,
                           labels: torch.Tensor, lse: torch.Tensor,
                           g: torch.Tensor, *, transpose_emb: bool = False,
                           block_v: int = 8192
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12a's function in tensor ops (any device): the reference's block
    scan in reverse, each block's logits recomputed in fp32, dl = g
    (exp(logits - lse) - one-hot) in fp32, dx summed over the blocks and
    each block's rows of d emb written, both products in fp32; dx and
    d emb in the inputs' dtype.  The plain version the kernel is held
    against."""
    exact_fp32()
    e = emb.t() if transpose_emb else emb                  # (V, d) view
    v = e.shape[0]
    xf = x.float()
    labels = labels.long()
    g = g.float()
    lse = lse.float()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    de = torch.empty(e.shape, dtype=torch.float32, device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    for base in reversed(range(0, v, block_v)):
        eb = e[base:base + block_v].float()                  # (bv, d)
        dl = torch.exp(xf @ eb.t() - lse[:, None])           # (T, bv)
        bv = dl.shape[1]
        in_blk = (labels >= base) & (labels < base + bv)
        dl[rows[in_blk], labels[in_blk] - base] -= 1.0
        dl.mul_(g[:, None])
        dx += dl @ eb
        de[base:base + bv] = dl.t() @ xf
    de = de.t() if transpose_emb else de
    return dx.to(x.dtype), de.to(emb.dtype).contiguous()


def _check_bwd(x, emb, labels, lse, g, transpose_emb, block_v):
    _check(x, emb, labels, transpose_emb, block_v, grad=True)
    t = x.shape[0]
    for name, a in (("lse", lse), ("g", g)):
        if a.shape != (t,) or a.dtype != torch.float32:
            raise ValueError(f"blocked_xent_bwd takes {name} ({t},) fp32, "
                             f"got {tuple(a.shape)} {a.dtype}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"blocked_xent_bwd takes {name} contiguous on "
                             "x's device")


def _bwd_route(x, emb, transpose_emb, route):
    """The route of K12a's launches on these inputs: `bwd_route`'s, or
    "mma" where that is "sm90" and `route` asks for it (the card tests
    and chip_smoke.py hold both routes to the plain version on the same
    inputs); any other `route` that differs raises."""
    d = x.shape[1]
    v = emb.shape[1] if transpose_emb else emb.shape[0]
    auto = bwd_route(x.dtype, d, v, transpose_emb, _aligned(x, emb))
    if route is None or route == auto:
        return auto
    if route == "mma" and auto == "sm90":
        return route
    raise ValueError(f"blocked_xent_bwd: route {route!r} does not take these "
                     f"inputs (bwd_route gives {auto!r})")


def _bwd_chunks(x, emb, labels, lse, g, transpose_emb, block_v, route=None):
    """K12a's launches of one call by `route` (`_bwd_route`), the vocab
    chunks from the last to the first: after each launch yields (first
    column, columns, dl) with dl the chunk's (T, columns) fp32 buffer, or
    its (hi, lo) bf16 terms.  Counts each launch in `bwd_launches` and
    `bwd_launches_by_route`."""
    global bwd_launches
    route = _bwd_route(x, emb, transpose_emb, route)
    t, d = x.shape
    v = emb.shape[1] if transpose_emb else emb.shape[0]
    chunk = -(-block_v // TILE_V) * TILE_V
    ld = min(chunk, -(-v // TILE_V) * TILE_V)
    dl = torch.empty((t, ld), dtype=x.dtype, device=x.device)
    lo = torch.empty_like(dl) if x.dtype == torch.bfloat16 else dl
    labels = labels.to(torch.int32).contiguous()
    # the sm90 kernel's persistent blocks, or the others' 16-byte loads
    last = (_build.sm_count(x.device) if route == "sm90"
            else _vector(x, emb, transpose_emb))
    fn = getattr(_bwd_library(), _BWD_FNS[route])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for base in reversed(range(0, v, chunk)):
            w = min(chunk, v - base)
            err = fn(x.data_ptr(), emb.data_ptr(), labels.data_ptr(),
                     lse.data_ptr(), g.data_ptr(), dl.data_ptr(),
                     lo.data_ptr(), t, v, d, base, w, ld,
                     int(transpose_emb), last, stream)
            if err:
                raise RuntimeError(f"blocked_xent_bwd kernel launch failed "
                                   f"(route {route}): CUDA error {err}")
            bwd_launches += 1
            bwd_launches_by_route[route] += 1
            yield base, w, (dl[:, :w] if lo is dl
                            else (dl[:, :w], lo[:, :w]))


def blocked_xent_bwd(x: torch.Tensor, emb: torch.Tensor,
                     labels: torch.Tensor, lse: torch.Tensor,
                     g: torch.Tensor, *, transpose_emb: bool = False,
                     block_v: int = 8192
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12a: the gradients (dx (T, d), d emb of emb's shape, both in x's
    dtype) of sum_t g[t] nll[t] for `blocked_xent`'s inputs, given its lse
    (T,) fp32 and g (T,) fp32."""
    return _blocked_xent_bwd(x, emb, labels, lse, g, transpose_emb, block_v)


def _blocked_xent_bwd(x, emb, labels, lse, g, transpose_emb=False,
                      block_v=8192, route=None):
    """`blocked_xent_bwd` with its kernel's `route` checked (`_bwd_route`,
    on any device) and taken on the card."""
    _check_bwd(x, emb, labels, lse, g, transpose_emb, block_v)
    _bwd_route(x, emb, transpose_emb, route)
    if x.device.type == "cpu":
        return blocked_xent_bwd_plain(x, emb, labels, lse, g,
                                      transpose_emb=transpose_emb,
                                      block_v=block_v)
    if x.device.type != "cuda":
        raise RuntimeError(f"blocked_xent_bwd runs on CUDA or CPU tensors, "
                           f"not {x.device}")
    exact_fp32()
    f32 = torch.float32
    t, d = x.shape
    v = emb.shape[1] if transpose_emb else emb.shape[0]
    dx = torch.zeros(x.shape, dtype=f32, device=x.device)
    demb = torch.zeros_like(emb)
    # a chunk's d E, (d, w) for the (d, V) head or (w, d), summed in fp32
    # in place and cast once into demb
    de_buf = torch.empty((min(-(-block_v // TILE_V) * TILE_V, v) * d,),
                         dtype=f32, device=x.device)

    def de_operands(part):           # d E = dl^T x, or x^T dl (d, V)
        return (x.t(), part) if transpose_emb else (part.t(), x)
    for base, w, dl in (_bwd_chunks(x, emb, labels, lse, g, transpose_emb,
                                    block_v, route) if t else ()):
        cols = slice(base, base + w)
        rhs = emb[:, cols].t() if transpose_emb else emb[cols]   # (w, d)
        de = de_buf[:w * d].view((d, w) if transpose_emb else (w, d))
        if x.dtype == f32:
            dx.addmm_(dl, rhs)
            torch.mm(*de_operands(dl), out=de)
        else:                # hi, then lo: each product summed in fp32
            hi, lo = dl
            torch.addmm(dx, hi, rhs, out_dtype=f32, out=dx)
            torch.addmm(dx, lo, rhs, out_dtype=f32, out=dx)
            torch.mm(*de_operands(hi), out_dtype=f32, out=de)
            torch.addmm(de, *de_operands(lo), out_dtype=f32, out=de)
        if transpose_emb:
            demb[:, cols] = de
        else:
            demb[cols] = de
    return dx.to(x.dtype), demb


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("xent")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("xent_bwd")
    for name in _BWD_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.blocked_xent_bwd_sm90_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.blocked_xent_bwd_sm90_plan.restype = ctypes.c_int
    return lib
