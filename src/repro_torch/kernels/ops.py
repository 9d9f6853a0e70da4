"""The kernels at the model's layout, as the reference's `kernels/ops.py`
exposes them: attention in (B, S, H, D), flash-decoding over a cache of
valid prefix `length`, the diagonal linear-recurrence scan, the grouped
expert GEMM over block-sorted rows, and the fused cross-entropy.  Each
launches its hand-written kernel on CUDA tensors and runs its plain
version on CPU tensors; there is no mode switch.

`flash_attention` is differentiable, as the reference's `custom_vjp` is:
K5 forward, saving (q, k, v, o, lse) in K5's contiguous layout, and K11
(`flash_attention_bwd`) backward.  `blocked_xent` is differentiable
too: K10 forward, saving (x, emb, labels, lse) and never the logits, and
K12a (`xent.blocked_xent_bwd`) backward, as the reference differentiates
its blocked loss's checkpointed scan.  `grouped_gemm` is differentiable
in x and w: K9 forward, saving (x, w, block_ids), and K9's backward
(`moe_gemm.grouped_gemm_dx` and `grouped_gemm_dw`), as XLA differentiates
the reference's expert einsums."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import moe_gemm as MG
from repro_torch.kernels import ssm_scan as SS
from repro_torch.kernels import xent as XE


class FlashAttention(torch.autograd.Function):
    """K5 forward and K11 backward at the model's (B, S, H, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                      for t in (q, k, v))
        o, lse = FA.flash_attention_fwd(qt, kt, vt, causal=causal,
                                        scale=scale)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(qt, kt, vt, o, lse)
            ctx.causal, ctx.scale = causal, scale
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        qt, kt, vt, o, lse = ctx.saved_tensors
        dq, dk, dv = FA.flash_attention_bwd(
            qt, kt, vt, o, lse, do.transpose(1, 2).contiguous(),
            causal=ctx.causal, scale=ctx.scale)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,H,D), through K5 in its
    (B,H,S,D) layout, differentiable through K11."""
    return FlashAttention.apply(q, k, v, causal, scale)


def decode_attention(q, k, v, length):
    """q (B,H,D); k,v (B,Sk,Hkv,D); length a Python int or a one-element
    int32 tensor on the inputs' device -> (B,H,D), through K6 (keys at or
    past min(length, Sk) masked; length 0 gives zeros)."""
    return DA.decode_attention(q, k, v, length)


def ssm_scan(a, b):
    """a, b (B,T,C) -> (hs (B,T,C) fp32, h_final (B,C) fp32) for
    h_t = a_t h_{t-1} + b_t from zero, through K7."""
    return SS.ssm_scan(a, b)


class GroupedGemm(torch.autograd.Function):
    """K9 forward; its backward dX (`grouped_gemm_dx`) and dW
    (`grouped_gemm_dw`), each launched only where its input needs it."""

    @staticmethod
    def forward(ctx, x, w, block_ids, block_m):
        out = MG.grouped_gemm(x.detach(), w.detach(), block_ids, block_m)
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(x, w, block_ids)
            ctx.block_m = block_m
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, block_ids = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = MG.grouped_gemm_dx(dy, w.detach(), block_ids, ctx.block_m)
        if ctx.needs_input_grad[1]:
            dw = MG.grouped_gemm_dw(x.detach(), dy, block_ids, ctx.block_m,
                                    w.shape[0])
        return dx, dw, None, None


def grouped_gemm(x, w, block_ids, block_m: int):
    """x (T, d) block-sorted rows, w (E, d, f), block_ids (T // block_m,)
    -> (T, f), through K9; a block of id -1 comes out as zeros.
    Differentiable in x and w through K9's backward."""
    return GroupedGemm.apply(x, w, block_ids, block_m)


class BlockedXent(torch.autograd.Function):
    """K10 forward and K12a backward.  The gradient reaches x and emb
    only (the argmax has none); the logits are recomputed, never
    saved."""

    @staticmethod
    def forward(ctx, x, emb, labels, transpose_emb, block_v):
        nll, amax, lse = XE.blocked_xent(
            x.detach(), emb.detach(), labels, transpose_emb=transpose_emb,
            block_v=block_v)
        ctx.mark_non_differentiable(amax)
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(x, emb, labels, lse)
            ctx.transpose_emb, ctx.block_v = transpose_emb, block_v
        return nll, amax

    @staticmethod
    def backward(ctx, g, _):
        x, emb, labels, lse = ctx.saved_tensors
        dx, demb = XE.blocked_xent_bwd(
            x.detach(), emb.detach(), labels, lse, g.float().contiguous(),
            transpose_emb=ctx.transpose_emb, block_v=ctx.block_v)
        return dx, demb, None, None, None


def blocked_xent(x, emb, labels, *, transpose_emb: bool = False,
                 block_v: int = 8192):
    """x (T, d), emb (V, d) or (d, V) with `transpose_emb`, labels (T,)
    -> (nll (T,) fp32, argmax (T,) int32), through K10, differentiable in
    x and emb through K12a."""
    return BlockedXent.apply(x, emb, labels, transpose_emb, block_v)
