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
that require grad: `kernels/ops.py::flash_attention` is the
differentiable entry.

K11, `flash_attention_bwd`, is the backward: the reference's `_fa_bwd`
(`src/repro/kernels/ops.py:65`), recomputing p from (q, k, v, o, lse) in
the same layout, fp32 math rounded once.  On a CUDA tensor it launches
csrc/flash_attention_bwd.cu in the passes of `bwd_plan` (dsum, then dq a
query tile at a time, then dk and dv a key tile at a time over the
group's query heads, no atomics; counted as one call in `bwd_launches`):
bf16 on the tensor cores, p and dS kept in registers and each split into
two bf16 terms for the products; fp32 on FMAs.  On a CPU tensor it runs
`flash_attention_bwd_plain`, the reference's chunked recompute.
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
#: K11 calls on CUDA tensors (`bwd_plan`'s launches each, counted once)
bwd_launches = 0

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_FNS = {torch.bfloat16: "flash_attention_fwd_bf16",
        torch.float32: "flash_attention_fwd_f32"}
_BWD_FNS = {torch.bfloat16: "flash_attention_bwd_bf16",
            torch.float32: "flash_attention_bwd_f32"}
#: queries a step of the plain backward's recompute (the reference's)
BWD_CHUNK = 1024
#: K11's tiles: the queries of a dq block (a head) and the keys of a dk/dv
#: block
BWD_TILE = 64
_PLAN_KEYS = ("launches", "dsum_blocks", "dq_grid", "dq_threads",
              "dq_heads", "dq_smem", "dq_blocks_per_sm", "dkdv_grid",
              "dkdv_threads", "dkdv_smem", "dkdv_blocks_per_sm",
              "dq_first_tile", "dkdv_first_tile", "dsum_threads")


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


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The reference's `_fa_bwd` in tensor ops (any device), in K5's
    layout: each chunk of BWD_CHUNK queries recomputes its scores against
    every key, p = exp(s - lse), ds = p (dp - dsum) scale, and adds its
    share of dk and dv; fp32 math, rounded once to the inputs' dtype."""
    exact_fp32()
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().view(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()                       # (B,Hkv,Sk,D)
    dof = do.float().view(b, hkv, g, sq, d)
    lsef = lse.float().view(b, hkv, g, sq)
    dsum = torch.sum(dof * o.float().view(b, hkv, g, sq, d), dim=-1)
    kpos = torch.arange(sk, device=q.device)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c0 in range(0, sq, BWD_CHUNK):
        c1 = min(c0 + BWD_CHUNK, sq)
        q_c, do_c = qf[:, :, :, c0:c1], dof[:, :, :, c0:c1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", q_c, kf) * scale
        if causal:
            qpos = torch.arange(c0, c1, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
        p = torch.exp(s - lsef[:, :, :, c0:c1, None])
        del s
        dv += torch.einsum("bhgqk,bhgqd->bhkd", p, do_c)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do_c, vf)
        ds = p * (dp - dsum[:, :, :, c0:c1, None]) * scale
        del p, dp
        dq[:, :, :, c0:c1] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
        dk += torch.einsum("bhgqk,bhgqd->bhkd", ds, q_c)
        del ds
    return (dq.view(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bwd_plan(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
             causal: bool, dtype: torch.dtype = torch.bfloat16) -> dict:
    """K11's launches for one call, the rule of
    csrc/flash_attention_bwd.cu::plan (`bwd_device_plan` reads the C
    launcher's own).  dsum: a warp a query row, 256 threads a block.  dq: a
    block per 64-query tile and `dq_heads` query heads (bf16: two heads of
    one GQA group where the group is even, 128 threads a head; fp32: one
    head, 256 threads), block 0 on the last query tile (the heaviest under
    the causal mask; the fp32 kernel keeps the natural order when not
    causal).  dk/dv: a block per 64-key tile and KV head (bf16: 4 warps of
    16 keys; fp32: 256 threads), looping over the group's H / Hkv query
    heads and their query tiles, block 0 on key tile 0 (the heaviest).
    A pass with nothing to compute is not launched; `launches` counts the
    rest.  `dq_tiles` and `dkdv_tiles` give the tile each block x index
    takes; `dkdv_items` the (head, query tile) items of each key tile."""
    bf16 = dtype == torch.bfloat16
    q_tiles, k_tiles = -(-Sq // BWD_TILE), -(-Sk // BWD_TILE)
    g = H // Hkv
    hpc = 2 if bf16 and g % 2 == 0 else 1
    rows = B * H * Sq
    plan = {key: (0, 0, 0) if key.endswith("_grid") else 0
            for key in _PLAN_KEYS
            if not key.endswith(("_smem", "_blocks_per_sm"))}
    plan.update(dsum_threads=256, dq_tiles=(), dkdv_tiles=(),
                dkdv_items=())
    if rows > 0:
        plan.update(launches=2, dsum_blocks=-(-rows // 8),
                    dq_grid=(q_tiles, H // hpc, B),
                    dq_threads=128 * hpc if bf16 else 256, dq_heads=hpc,
                    dq_first_tile=q_tiles - 1 if bf16 or causal else 0)
        plan["dq_tiles"] = (tuple(range(q_tiles - 1, -1, -1))
                            if bf16 or causal else tuple(range(q_tiles)))
    if B * Hkv * Sk > 0:
        plan.update(launches=plan["launches"] + 1,
                    dkdv_grid=(k_tiles, Hkv, B),
                    dkdv_threads=128 if bf16 else 256,
                    dkdv_tiles=tuple(range(k_tiles)))
        plan["dkdv_items"] = tuple(
            g * max(q_tiles - (kt if causal else 0), 0)
            for kt in range(k_tiles))
    return plan


def bwd_device_plan(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
                    causal: bool, dtype: torch.dtype = torch.bfloat16
                    ) -> dict:
    """The plan K11's C launcher takes on the current card (needs the
    card): `bwd_plan`'s keys without the tile tuples, plus each product
    kernel's dynamic shared bytes and the blocks an SM holds (CUDA's
    occupancy API, the 16-byte-aligned instance)."""
    out = (ctypes.c_int * 18)()
    err = _bwd_library().flash_attention_bwd_plan(
        B, H, Hkv, Sq, Sk, D, int(causal), int(dtype == torch.bfloat16), out)
    if err:
        raise RuntimeError(f"flash_attention_bwd_plan failed: CUDA error "
                           f"{err}")
    vals = list(out)
    plan = {}
    for key in _PLAN_KEYS:
        if key.endswith("_grid"):
            plan[key], vals = tuple(vals[:3]), vals[3:]
        else:
            plan[key], vals = vals[0], vals[1:]
    return plan


def _check(q, k, v, name: str):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} takes q (B,H,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)} (batch, head dim, and "
                         "kv heads dividing the heads)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _FNS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes bf16 or fp32 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name} inputs must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} inputs must be contiguous")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(f"{name} is forward only: differentiate through "
                           "ops.flash_attention, whose backward is K11 "
                           "(flash_attention_bwd)")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,Sq,D), k and v (B,Hkv,Sk,D) -> (o (B,H,Sq,D), lse (B,H,Sq))."""
    _check(q, k, v, "flash_attention_fwd")
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


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11.  q, o, do (B,H,Sq,D); k, v (B,Hkv,Sk,D); lse (B,H,Sq) fp32, as
    `flash_attention_fwd` gave them -> (dq, dk, dv) in the inputs' dtype
    and layout."""
    _check(q, k, v, "flash_attention_bwd")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd takes {name} of q's "
                             f"shape, dtype and device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    b, h, sq, d = q.shape
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd takes lse (B,H,Sq) fp32 on "
                         f"q's device, got {tuple(lse.shape)} {lse.dtype}")
    if not (o.is_contiguous() and do.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd inputs must be contiguous")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd runs on CUDA or CPU "
                           f"tensors, not {q.device}")
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = getattr(_bwd_library(), _BWD_FNS[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dsum.data_ptr(), b, h, hkv, sq, sk, d,
                 int(causal), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    for name in _BWD_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_attention_bwd_plan.argtypes = [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    lib.flash_attention_bwd_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
