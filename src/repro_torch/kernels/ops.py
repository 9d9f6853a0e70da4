"""The kernels at the model's layout, as the reference's `kernels/ops.py`
exposes them to `models/`: attention in (B, S, H, D), the grouped
expert GEMM over block-sorted rows, and the fused cross-entropy."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import moe_gemm as MG
from repro_torch.kernels import xent as XE


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,H,D), through K5 in its
    (B,H,S,D) layout (forward only)."""
    o, _ = FA.flash_attention_fwd(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(),
                                  causal=causal, scale=scale)
    return o.transpose(1, 2)


def grouped_gemm(x, w, block_ids, block_m: int):
    """x (T, d) block-sorted rows, w (E, d, f), block_ids (T // block_m,)
    -> (T, f), through K9; a block of id -1 comes out as zeros."""
    return MG.grouped_gemm(x, w, block_ids, block_m)


def blocked_xent(x, emb, labels, *, transpose_emb: bool = False,
                 block_v: int = 8192):
    """x (T, d), emb (V, d) or (d, V) with `transpose_emb`, labels (T,)
    -> (nll (T,) fp32, argmax (T,) int32), through K10 (forward only)."""
    return XE.blocked_xent(x, emb, labels, transpose_emb=transpose_emb,
                           block_v=block_v)
