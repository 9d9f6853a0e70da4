"""Decoder-only LM assembly, in the reference's segment layout
(`src/repro/models/transformer.py`): layers are grouped into segments of
a repeating block pattern, each segment's parameters stacked with a
leading `repeats` axis.  The reference applies a segment with
`jax.lax.scan`; the port runs a Python loop over the stacked layers.
Under `cfg.remat` each layer is rematerialized in the backward
(`_remat`), as the reference wraps its segment body.

Ported block kinds: full attention (`ATTN`) and MLA, each with a dense
SwiGLU MLP or an MoE FFN; the hybrid family's Griffin RG-LRU (`RGLRU`,
`models/ssm.py`) and local attention (`LOCAL_ATTN`, a window of
`cfg.rglru.local_window`), each with a dense SwiGLU MLP; and Mamba-1
(`MAMBA`, `models/ssm.py`), a norm and the mixer with no MLP, as the
reference builds it.  A local layer's decode cache is a ring buffer of
min(window, s_max) positions; an RG-LRU layer's is its conv tail (bf16)
and its state `h` (fp32); a Mamba layer's its conv tail (bf16) and its
state `ssm` ((B, d_inner, N) fp32).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, Tuple

import torch
from torch.utils import checkpoint as CK

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, MLA, RGLRU,
                                      ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.param import ParamSpec, SpecTree, tree_map


@dataclasses.dataclass(frozen=True)
class Segment:
    repeats: int
    pattern: Tuple[Tuple[str, bool], ...]   # ((kind, is_moe), ...)


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    per_layer = [(k, cfg.layer_is_moe(i))
                 for i, k in enumerate(cfg.layer_kinds())]
    plen = len(cfg.block_pattern)
    segs: List[Segment] = []
    i = 0
    n = len(per_layer)
    while i < n:
        pat = tuple(per_layer[i:i + plen])
        reps = 1
        j = i + len(pat)
        while j + len(pat) <= n and tuple(per_layer[j:j + len(pat)]) == pat:
            reps += 1
            j += len(pat)
        if len(pat) < plen:  # tail shorter than pattern
            segs.append(Segment(1, pat))
            i += len(pat)
            continue
        segs.append(Segment(reps, pat))
        i = j
    return segs


def _check_kind(kind: str) -> None:
    if kind not in (ATTN, MLA, RGLRU, LOCAL_ATTN, MAMBA):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported (the port serves "
            "full-attention, MLA, RG-LRU, local-attention and Mamba "
            "blocks)")


def _window(cfg: ModelConfig, kind: str) -> int:
    """A local-attention layer's window (the reference's rule: 0 where the
    config has no RG-LRU section)."""
    return cfg.rglru.local_window if (kind == LOCAL_ATTN and cfg.rglru) \
        else 0


def _mixer_spec(cfg: ModelConfig, kind: str) -> SpecTree:
    if kind == MLA:
        return L.mla_spec(cfg)
    if kind == RGLRU:
        return SSM.rglru_spec(cfg)
    if kind == MAMBA:
        return SSM.mamba_spec(cfg)
    return L.attn_spec(cfg)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def _stack_spec(spec: SpecTree, n: int) -> SpecTree:
    return tree_map(lambda s: dataclasses.replace(s, shape=(n,) + s.shape),
                    spec)


def block_spec(cfg: ModelConfig, kind: str, is_moe: bool) -> SpecTree:
    _check_kind(kind)
    d = cfg.d_model
    s: SpecTree = {"norm1": L.norm_spec(d), "mixer": _mixer_spec(cfg, kind)}
    if kind != MAMBA:                    # a Mamba block has no MLP
        s["norm2"] = L.norm_spec(d)
        s["ffn"] = MOE.moe_spec(cfg) if is_moe else L.mlp_spec(cfg)
    return s


def segment_spec(cfg: ModelConfig, seg: Segment) -> SpecTree:
    return {"blocks": [_stack_spec(block_spec(cfg, k, m), seg.repeats)
                       for (k, m) in seg.pattern]}


def lm_spec(cfg: ModelConfig) -> SpecTree:
    d, v = cfg.d_model, cfg.vocab_size
    s: SpecTree = {
        "embed": ParamSpec((v, d), init="normal"),
        "segments": [segment_spec(cfg, seg) for seg in layer_plan(cfg)],
        "final_norm": L.norm_spec(d),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, v), init="scaled")
    return s


def _layer(tree, r: int):
    """Layer `r` of a stacked (repeats, ...) tree, as views."""
    return tree_map(lambda t: t[r], tree)


def _layers(tree, n: int) -> List[Any]:
    """The `n` layers of a stacked (n, ...) tree, as views, each stack
    split once (`unbind`): under autograd a stack's gradient is then one
    `stack` of its layers' gradients, where indexing it a layer at a time
    (`_layer`) adds a zero-filled stack-sized gradient per layer."""
    parts: List[Tuple[torch.Tensor, ...]] = []

    def split(t):
        parts.append(t.unbind(0))
        return len(parts) - 1
    index = tree_map(split, tree)
    return [tree_map(lambda i: parts[i][r], index) for r in range(n)]


# ---------------------------------------------------------------------------
# Block application (full sequence: prefill)
# ---------------------------------------------------------------------------
def _ffn(x, p, cfg: ModelConfig, is_moe: bool):
    """The block's FFN: (out, aux loss)."""
    if is_moe:
        return MOE.moe_block(x, p, cfg)
    return L.mlp_block(x, p, cfg), torch.zeros((), dtype=torch.float32,
                                               device=x.device)


def apply_block(x, p, cfg: ModelConfig, kind: str, is_moe: bool, *,
                causal: bool = True, positions=None,
                collect_cache: bool = False):
    """Returns (x, aux loss, cache entry or None)."""
    _check_kind(kind)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == MLA:
        o, ckv = L.mla_block(h, p["mixer"], cfg, causal=causal,
                             positions=positions)
        cache = {"c_kv": ckv[0], "k_rope": ckv[1]}
    elif kind == RGLRU:
        o, (conv, hh) = SSM.rglru_block(h, p["mixer"], cfg,
                                        return_state=True)
        cache = {"conv": conv, "h": hh}
    elif kind == MAMBA:
        o, (conv, ss) = SSM.mamba_block(h, p["mixer"], cfg,
                                        return_state=True)
        cache = {"conv": conv, "ssm": ss}
    else:
        o, kv = L.attn_block(h, p["mixer"], cfg, causal=causal,
                             window=_window(cfg, kind), positions=positions)
        cache = {"k": kv[0], "v": kv[1]}
    x = x + o
    if kind == MAMBA:                       # no MLP
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        f, aux = _ffn(h2, p["ffn"], cfg, is_moe)
        x = x + f
    return x, aux, (cache if collect_cache else None)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products, recompute
    the rest."""
    return (CK.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CK.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, mode: str) -> Callable:
    """`fn` rematerialized in the backward, as the reference's `_remat`
    (`src/repro/models/transformer.py:156`) wraps its segment body:
    "none" keeps every activation; "full" saves only the layer's inputs
    (`torch.utils.checkpoint`, non-reentrant) and runs the layer again in
    the backward, kernels (K5, K8) and autograd Functions included, with
    the same bits; "dots" saves the outputs of the layer's matrix products
    (`aten.mm`, `aten.bmm`, `aten.addmm`: the projections and the MLP,
    which einsum dispatches as a `bmm` over one flattened batch, and on
    the CPU the plain attention's two products) and recomputes the rest:
    on the card attention (K5, no aten product), the norms (K8), RoPE and
    the activations.  That is the PyTorch counterpart of XLA's
    `dots_with_no_batch_dims_saveable`, not the same policy op for op:
    XLA chooses among its fused dots, PyTorch among dispatched aten ops."""
    if mode == "none":
        return fn
    if mode not in ("dots", "full"):
        raise ValueError(f"remat must be none, dots or full, got {mode!r}")
    kw = {"use_reentrant": False}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            CK.create_selective_checkpoint_contexts, _save_dots)
    return lambda *a, **k: CK.checkpoint(fn, *a, **kw, **k)


def apply_segments(x, params_segments, cfg: ModelConfig, *, causal=True,
                   positions=None, collect_cache=False):
    """Run all segments. Returns (x, total aux loss, caches or None); each
    cache entry is stacked (repeats, ...) as the reference's scan stacks
    it.  Under autograd each layer is rematerialized by `cfg.remat`."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: List[Any] = []
    block = apply_block
    if torch.is_grad_enabled() and not collect_cache:
        block = _remat(apply_block, cfg.remat)
    for seg, seg_p in zip(layer_plan(cfg), params_segments):
        entries = [[] for _ in seg.pattern]
        blocks = [_layers(b, seg.repeats) for b in seg_p["blocks"]]
        for r in range(seg.repeats):
            for pos_i, (kind, m) in enumerate(seg.pattern):
                x, aux, ce = block(
                    x, blocks[pos_i][r], cfg, kind, m,
                    causal=causal, positions=positions,
                    collect_cache=collect_cache)
                total_aux = total_aux + aux
                entries[pos_i].append(ce)
        if collect_cache:
            caches.append([{key: torch.stack([e[key] for e in es])
                            for key in es[0]} for es in entries])
    return x, total_aux, (caches if collect_cache else None)


# ---------------------------------------------------------------------------
# Decode-step application (single token, cache threading)
# ---------------------------------------------------------------------------
def apply_block_decode(x, p, cfg: ModelConfig, kind: str, is_moe: bool,
                       cache: dict, index):
    _check_kind(kind)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == MLA:
        o, cc, krc = L.mla_decode(h, p["mixer"], cfg, cache["c_kv"],
                                  cache["k_rope"], index)
        cache = {"c_kv": cc, "k_rope": krc}
    elif kind == RGLRU:
        o, conv, hh = SSM.rglru_decode(h, p["mixer"], cfg, cache["conv"],
                                       cache["h"])
        cache["conv"].copy_(conv)            # into the cache, in place
        cache["h"].copy_(hh)
    elif kind == MAMBA:
        o, conv, ss = SSM.mamba_decode(h, p["mixer"], cfg, cache["conv"],
                                       cache["ssm"])
        cache["conv"].copy_(conv)            # into the cache, in place
        cache["ssm"].copy_(ss)
    else:
        o, kc, vc = L.attn_decode(h, p["mixer"], cfg, cache["k"], cache["v"],
                                  index, window=_window(cfg, kind))
        cache = {"k": kc, "v": vc}
    x = x + o
    if kind != MAMBA:                       # a Mamba block has no MLP
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + _ffn(h2, p["ffn"], cfg, is_moe)[0]
    return x, cache


def apply_segments_decode(x, params_segments, caches, cfg: ModelConfig,
                          index):
    """One token through every layer.  Each layer writes its new cache
    entries (key and value, MLA's latent and roped key, or the RG-LRU's
    or Mamba's conv tail and state) into its slice of the stacked caches
    in place, so `caches` is returned updated (the reference returns new
    stacked arrays)."""
    for seg, seg_p, seg_c in zip(layer_plan(cfg), params_segments, caches):
        for r in range(seg.repeats):
            for pos_i, (kind, m) in enumerate(seg.pattern):
                x, _ = apply_block_decode(
                    x, _layer(seg_p["blocks"][pos_i], r), cfg, kind, m,
                    _layer(seg_c[pos_i], r), index)
    return x, caches


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------
def block_cache_spec(cfg: ModelConfig, kind: str, batch: int,
                     s_max: int) -> SpecTree:
    _check_kind(kind)
    if kind == MLA:
        m = cfg.mla
        return {"c_kv": ParamSpec((batch, s_max, m.kv_lora_rank),
                                  init="zeros"),
                "k_rope": ParamSpec((batch, s_max, m.qk_rope_head_dim),
                                    init="zeros")}
    if kind == RGLRU:
        w = cfg.rglru.lru_width or cfg.d_model
        return {"conv": ParamSpec((batch, cfg.rglru.d_conv - 1, w),
                                  init="zeros"),
                "h": ParamSpec((batch, w), init="zeros",
                               dtype=torch.float32)}
    if kind == MAMBA:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        return {"conv": ParamSpec((batch, s.d_conv - 1, di), init="zeros"),
                "ssm": ParamSpec((batch, di, s.d_state), init="zeros",
                                 dtype=torch.float32)}
    if kind == LOCAL_ATTN:                   # the ring buffer
        s_max = min(cfg.rglru.local_window, s_max)
    shp = (batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": ParamSpec(shp, init="zeros"),
            "v": ParamSpec(shp, init="zeros")}


def cache_spec(cfg: ModelConfig, batch: int, s_max: int) -> List[Any]:
    return [[_stack_spec(block_cache_spec(cfg, k, batch, s_max), seg.repeats)
             for (k, _) in seg.pattern] for seg in layer_plan(cfg)]
