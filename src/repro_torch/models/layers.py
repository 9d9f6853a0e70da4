"""Model layers of the port, as plain functions on tensors in the
reference's layout (`src/repro/models/layers.py`): RMSNorm, rotary
embeddings, GQA attention, full or windowed (prefill, and per-slot
decode over a full cache or a ring buffer), DeepSeek MLA (the expanded
prefill and the absorbed per-slot decode) and the SwiGLU MLP.

Dispatch follows the reference: `attention` sends a call to the flash
kernel (K5, `kernels/ops.py::flash_attention`) exactly where the
reference's gate admits it (no window, no softcap, no validity mask, no
query offset, equal q/v head dims, more than one query); every other call
runs `_attend_dense` in plain tensor ops, as the reference computes it
outside any Pallas kernel, over query chunks of `chunk_q` when Sq is
larger, each chunk masked at its own query positions (causal, and
`qpos - kpos < window` for a window).  `rms_norm` runs K8, which
computes the same function as the reference's `rms_norm`, with K8's
backward behind a `torch.autograd.Function`; attention's flash path is
differentiable through K11 (`kernels/ops.py::flash_attention`).  The
tensors' device picks the kernel (CUDA) or its plain version (CPU).
MLA's prefill has q/k head dim 192 and v head dim 128, so the flash gate
sends it to the dense path, as in the reference.

Not ported (raise `NotImplementedError`): soft-capped attention, head
padding, grouped-KV decode, q-LoRA MLA and M-RoPE.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import exact_fp32
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models.param import ParamSpec

F32 = torch.float32
NEG_INF = -1e30


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (the port serves "
                              "the dense and MoE families with full "
                              "attention or MLA, and RG-LRU with local "
                              "attention; ROADMAP.md Queue 1)")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class RMSNorm(torch.autograd.Function):
    """K8 forward over rows, K8's backward (`rmsnorm_bwd`) backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x2 = x.detach().reshape(-1, x.shape[-1])
        y = RN.rmsnorm(x2, scale.detach(), eps)
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(x2, scale.detach())
            ctx.eps = eps
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, dscale = RN.rmsnorm_bwd(x2, scale,
                                    dy.reshape(x2.shape).contiguous(),
                                    ctx.eps)
        return dx.reshape(dy.shape), dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis through K8 (rows flattened)."""
    return RMSNorm.apply(x, scale, eps)


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), init="zeros")


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_cos_sin(positions: torch.Tensor, dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin (..., dim/2) in fp32."""
    exps = torch.arange(0, dim, 2, dtype=F32, device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.to(F32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    x = x.to(F32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Sk) additive mask bias in fp32."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF).to(F32)


def _attend_dense(q, k, v, qpos, kpos, causal, window, scale, softcap,
                  kv_valid=None):
    """q: (B,Sq,H,D) k,v: (B,Sk,H,D) (kv pre-repeated to H) -> (B,Sq,H,D).
    Scores and softmax in fp32, P cast to v's dtype for the PV product."""
    if softcap > 0:
        _unported("soft-capped attention")
    exact_fp32()
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32)) * scale
    s = s + _mask_bias(qpos, kpos, causal, window)[None, None]
    if kv_valid is not None:  # (B, Sk) bool — decode cache validity
        s = s + torch.where(kv_valid, 0.0, NEG_INF).to(F32)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attention(q, k, v, *, causal: bool, window: int = 0,
              scale: Optional[float] = None, softcap: float = 0.0,
              q_offset: int = 0, chunk_q: int = 1024,
              kv_valid: Optional[torch.Tensor] = None,
              pad_heads: bool = False, group_kv: bool = False):
    """GQA attention.  q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D) -> (B,Sq,Hq,D)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    assert hq % hkv == 0, (hq, hkv)
    g = hq // hkv
    if softcap > 0:
        _unported("soft-capped attention")
    if pad_heads:
        _unported("head-padded TP attention (pad_heads)")
    if group_kv:
        _unported("grouped-KV attention (group_kv)")

    # the reference's flash gate (layers.py:296), to the letter
    if (window == 0 and softcap == 0.0 and kv_valid is None
            and q_offset == 0 and d == dv and sq > 1):
        return ops.flash_attention(q, k, v, causal, scale)

    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if g > 1:  # broadcast KV heads, as the reference does
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kpos = torch.arange(sk, dtype=torch.int32, device=q.device)
    # queries in chunks of chunk_q over all keys, as the reference scans
    # them (layers.py:323-338).  It pads the last chunk and cuts the padded
    # rows off; query rows are independent, so the port cuts the chunk
    # short instead.  Forward only, so nothing is checkpointed.
    outs = [_attend_dense(q[:, c0:c0 + chunk_q], k, v,
                          q_offset + c0 + torch.arange(
                              min(chunk_q, sq - c0), dtype=torch.int32,
                              device=q.device),
                          kpos, causal, window, scale, softcap, kv_valid)
            for c0 in range(0, sq, chunk_q)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA attention block (params + apply)
# ---------------------------------------------------------------------------
def attn_spec(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = {
        "wq": ParamSpec((d, nq, hd), init="scaled"),
        "wk": ParamSpec((d, nkv, hd), init="scaled"),
        "wv": ParamSpec((d, nkv, hd), init="scaled"),
        "wo": ParamSpec((nq, hd, d), init="scaled"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((nq, hd), init="zeros")
        s["bk"] = ParamSpec((nkv, hd), init="zeros")
        s["bv"] = ParamSpec((nkv, hd), init="zeros")
    return s


def _qkv(x, p, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"][None, None]
        k = k + p["bk"][None, None]
        v = v + p["bv"][None, None]
    return q, k, v


def _rope_for(cfg: ModelConfig, positions, hd: int, seq: int, device):
    """cos/sin for this arch's rope kind; positions: (S,) or None."""
    if cfg.rope_kind in ("none", "sinusoid"):
        return None
    if cfg.rope_kind == "mrope":
        _unported("M-RoPE")
    if positions is None:
        positions = torch.arange(seq, dtype=torch.int32, device=device)
    return rope_cos_sin(positions, hd, cfg.rope_theta)


def attn_block(x, p, cfg: ModelConfig, *, causal: bool = False,
               window: int = 0, positions=None, cross_kv=None):
    """Full-sequence attention block (prefill). Returns (out, (k, v))."""
    if cross_kv is not None:
        _unported("cross attention (encoder-decoder)")
    _, s, _ = x.shape
    q, k, v = _qkv(x, p, cfg)
    cs = _rope_for(cfg, positions, cfg.resolved_head_dim, s, x.device)
    if cs is not None:
        q = apply_rope(q, *cs)
        k = apply_rope(k, *cs)
    o = attention(q, k, v, causal=causal, window=window,
                  softcap=cfg.attn_logit_softcap,
                  pad_heads=cfg.pad_heads_to_tp)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), (k, v)


def _norm_index(index, b: int, device) -> torch.Tensor:
    """Normalize the decode position index to (B,) int64 (a scalar
    broadcasts)."""
    idx = torch.as_tensor(index, device=device).to(torch.int64)
    return idx.expand(b) if idx.dim() == 0 else idx


def attn_decode(x, p, cfg: ModelConfig, k_cache, v_cache, index, *,
                window: int = 0, positions=None, cross: bool = False):
    """Single-token decode. x: (B,1,d). k/v_cache: (B,S,hkv,hd) (rope
    applied at write time). index: scalar or (B,) per-slot position.
    With a `window` the cache is a ring buffer: position i sits in slot
    i % S, and slot j holds position idx - ((idx - j) mod S), valid where
    that is in [0, idx] and within the window.

    Writes the new key and value into `k_cache`/`v_cache` in place (the
    reference returns updated copies; in place keeps one cache on the
    card) and returns (out, k_cache, v_cache)."""
    if cross:
        _unported("cross attention (encoder-decoder)")
    if cfg.decode_cache_seq_shard or cfg.decode_2d_tp:
        _unported("sharded decode caches")
    b = x.shape[0]
    s_max = k_cache.shape[1]
    idx = _norm_index(index, b, x.device)                        # (B,)
    q, k, v = _qkv(x, p, cfg)
    if cfg.rope_kind == "mrope":
        _unported("M-RoPE")
    if cfg.rope_kind == "rope":
        cs = rope_cos_sin(idx[:, None], cfg.resolved_head_dim,
                          cfg.rope_theta)                        # (B,1,hd/2)
        q = apply_rope(q, *cs)
        k = apply_rope(k, *cs)
    slot = idx % s_max if window > 0 else idx
    rows = torch.arange(b, device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    kpos = torch.arange(s_max, device=x.device)[None, :]        # (1,S)
    idx_c = idx[:, None]
    if window > 0:
        abs_pos = idx_c - ((idx_c - kpos) % s_max)
        valid = ((abs_pos >= 0) & (abs_pos <= idx_c)
                 & (idx_c - abs_pos < window))
    else:
        valid = kpos <= idx_c
    o = attention(q, k_cache, v_cache, causal=False, kv_valid=valid,
                  softcap=cfg.attn_logit_softcap)
    # o has the cache's dtype (bf16); promote as JAX does for fp32 weights
    o = o.to(torch.promote_types(o.dtype, p["wo"].dtype))
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_spec(cfg: ModelConfig) -> dict:
    m = cfg.mla
    if m.q_lora_rank:
        _unported("MLA with a q-LoRA projection")
    d, h = cfg.d_model, cfg.num_heads
    return {
        "wq": ParamSpec((d, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
                        init="scaled"),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           init="scaled"),
        "kv_norm": norm_spec(m.kv_lora_rank),
        "w_uk": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                          init="scaled"),
        "w_uv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), init="scaled"),
        "wo": ParamSpec((h, m.v_head_dim, d), init="scaled"),
    }


def mla_block(x, p, cfg: ModelConfig, *, causal: bool = True,
              positions=None):
    """Prefill MLA: the latent expanded to per-head K/V.  Returns (out,
    (c_kv, k_rope)), the latent and the roped key for the decode cache."""
    m = cfg.mla
    _, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    c_kv, k_rope = torch.split(dkv, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = rms_norm(c_kv.contiguous(), p["kv_norm"], cfg.norm_eps)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    cs = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, *cs)
    k_rope = apply_rope(k_rope[:, :, None, :], *cs)           # (B,S,1,rope)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3],
                                         m.qk_rope_head_dim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    o = attention(qf, k, v, causal=causal, scale=scale)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(x, p, cfg: ModelConfig, c_cache, kr_cache, index):
    """Absorbed-projection MLA decode: attention runs in the latent space
    (per-head K/V are never formed over the cache).  x: (B,1,d);
    c_cache: (B,S,lora), kr_cache: (B,S,rope); index: scalar or (B,)
    per-slot position.  Scores in fp32, probabilities cast to x's dtype
    before the context product, as the reference's dtypes go.

    Writes the new latent and roped key into the caches in place and
    returns (out, c_cache, kr_cache)."""
    m = cfg.mla
    b = x.shape[0]
    s_max = c_cache.shape[1]
    idx = _norm_index(index, b, x.device)                        # (B,)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])                # (B,1,H,.)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    c_new, kr_new = torch.split(dkv, [m.kv_lora_rank, m.qk_rope_head_dim],
                                dim=-1)
    c_new = rms_norm(c_new.contiguous(), p["kv_norm"], cfg.norm_eps)
    cs = rope_cos_sin(idx[:, None], m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, *cs)
    kr_new = apply_rope(kr_new[:, :, None, :], *cs)[:, :, 0, :]
    rows = torch.arange(b, device=x.device)
    c_cache[rows, idx] = c_new[:, 0].to(c_cache.dtype)
    kr_cache[rows, idx] = kr_new[:, 0].to(kr_cache.dtype)
    # absorb W_uk into q: q_lat (B,1,H,lora)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    exact_fp32()
    s_lat = torch.einsum("bshr,btr->bhst", q_lat.to(F32), c_cache.to(F32))
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.to(F32),
                          kr_cache.to(F32))
    scores = (s_lat + s_rope) * scale
    valid = torch.arange(s_max, device=x.device)[None, :] <= idx[:, None]
    scores = scores + torch.where(valid, 0.0, NEG_INF).to(F32)[:, None, None]
    prob = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = _promoted("bhst,btr->bshr", prob, c_cache)        # (B,1,H,lora)
    o = _promoted("bshr,rhk->bshk", ctx_lat, p["w_uv"])          # (B,1,H,v)
    return _promoted("bshk,hkd->bsd", o, p["wo"]), c_cache, kr_cache


def _promoted(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`einsum` of two operands of mixed dtypes in their promoted dtype,
    as JAX promotes (a bf16 cache against fp32 activations)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    if cfg.mlp_kind != "swiglu":
        _unported(f"mlp_kind {cfg.mlp_kind!r}")
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), init="scaled"),
        "wi_up": ParamSpec((d, f), init="scaled"),
        "wo": ParamSpec((f, d), init="scaled"),
    }


def mlp_block(x, p, cfg: ModelConfig):
    if cfg.mlp_kind != "swiglu":
        _unported(f"mlp_kind {cfg.mlp_kind!r}")
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    h = torch.nn.functional.silu(g.to(F32)).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, p["wo"])
