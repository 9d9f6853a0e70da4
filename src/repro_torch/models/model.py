"""The model API of the port, over the dense family, the MoE family
with full attention or MLA, the hybrid family of RG-LRU and local
attention blocks, and the attention-free Mamba-1 family
(`src/repro/models/model.py`):

    model = build_model(cfg)
    params = model.init(generator, device)      # drawn on `device`
    loss, metrics = model.loss(params, batch)   # differentiable
    logits, cache = model.prefill(params, {"tokens": tokens})
    logits, cache = model.decode_step(params, cache, tokens, index)

`Model` is an `nn.Module`: `init` (or `bind`) registers the parameter
tree under the reference's keys and stacking (`segments.0.blocks.0.mixer.wq`
is the (L, d, H, hd) stack of every layer's query projection).  The
forward functions take the tree explicitly, as the reference's do.

`params_from_numpy` turns the reference's parameter tree, as numpy
arrays, into the port's, key for key, so both packages can compute the
same thing on the same weights.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models import transformer as T
from repro_torch.models.loss import blocked_cross_entropy, cross_entropy


def _shift_labels(tokens: torch.Tensor):
    """next-token labels (last position predicts a pad; masked out)."""
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     dim=1)
    return labels, mask


def _as_module(tree) -> nn.Module:
    """An `nn.Module` mirror of a nested dict / list tree whose leaves are
    registered as (frozen) parameters sharing the tree's storage."""
    if isinstance(tree, dict):
        mod = nn.Module()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                mod.register_parameter(key, val if isinstance(
                    val, nn.Parameter) else nn.Parameter(val, False))
            else:
                mod.add_module(key, _as_module(val))
        return mod
    return nn.ModuleList([_as_module(v) for v in tree])


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def params_from_numpy(tree, device) -> Any:
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays, bf16 as `ml_dtypes.bfloat16`) as the port's, key for key, on
    `device`."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return _frozen(t.to(device))
    return P.tree_map(leaf, tree)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    # -- params ------------------------------------------------------------
    def spec(self) -> P.SpecTree:
        return T.lm_spec(self.cfg)

    def init(self, generator: torch.Generator, device=None):
        """Draw the parameters from `generator` on `device` (the card
        unless told otherwise; the generator must live there) and register
        them; returns the tree."""
        device = resolve_device(device)
        if generator.device.type != device.type or (
                device.index is not None
                and generator.device.index != device.index):
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the parameters are drawn on {device}")
        params = P.tree_map(_frozen, P.init_params(self.spec(), generator,
                                                   device))
        self.bind(params)
        return params

    def bind(self, params) -> None:
        """Register a parameter tree as this module's parameters."""
        self.params = _as_module(params)

    def param_count(self) -> int:
        return P.param_count(self.spec())

    # -- embedding / head ----------------------------------------------------
    def _embed(self, params, batch):
        return params["embed"][batch["tokens"]], None

    def _head(self, params, x) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, params["embed"])
        return torch.einsum("bsd,dv->bsv", x, params["lm_head"])

    # -- training loss (forward) ---------------------------------------------
    def loss(self, params, batch):
        """The training objective on `batch` ({"tokens": (B, S)}, a tensor
        or a numpy array, as `SyntheticLM.batch_at` gives it).  Returns
        (loss, {"nll", "acc", "aux"}), fp32 scalars.  The hybrid and SSM
        families run it forward only (K7's and K12c's kernels refuse an
        input that requires grad; their backwards are ROADMAP.md Queue 1
        item 6 (c)).
        Differentiable on the dense and MoE families: attention runs K5
        forward and K11 backward (MLA's q/k head dim 192 against v's 128
        keeps DeepSeek on the dense path, autograd's backward, as in the
        reference), every norm K8 and its backward, every routed-expert
        product K9 and its backward (`ops.GroupedGemm`), and with
        `blocked_xent` the loss K10 forward and K12a backward
        (`training/step.py` takes the gradients); with full logits the
        head and `cross_entropy` are autograd's."""
        cfg = self.cfg
        if cfg.encdec:
            raise NotImplementedError("the encoder-decoder loss is not "
                                      "ported yet (ROADMAP.md Queue 1)")
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        x, positions = self._embed(params, {"tokens": tokens})
        x, aux, _ = T.apply_segments(x, params["segments"], cfg,
                                     causal=True, positions=positions)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        labels, mask = _shift_labels(tokens)
        if cfg.blocked_xent:
            b, s, d = x.shape
            emb = params["embed"] if cfg.tie_embeddings else params["lm_head"]
            nll, acc = blocked_cross_entropy(
                x.reshape(b * s, d), emb, labels.reshape(-1),
                block=cfg.vocab_block, mask=mask.reshape(-1),
                transpose_emb=not cfg.tie_embeddings)
        else:
            logits = self._head(params, x)
            nll, acc = cross_entropy(logits, labels, mask)
        loss = nll + aux
        return loss, {"nll": nll, "acc": acc, "aux": aux}

    # -- inference -------------------------------------------------------------
    def prefill(self, params, batch) -> Tuple[torch.Tensor, Any]:
        """Full-prompt pass. Returns (last-position logits (B,V), cache)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        x, _, caches = T.apply_segments(x, params["segments"], cfg,
                                        causal=True, positions=positions,
                                        collect_cache=True)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, caches

    def decode_step(self, params, cache, tokens, index):
        """tokens: (B,1) int; index: scalar or (B,) per-slot position.
        Returns (logits (B,1,V), cache), the cache updated in place."""
        cfg = self.cfg
        x = params["embed"][tokens]
        x, cache = T.apply_segments_decode(x, params["segments"], cache, cfg,
                                           index)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._head(params, x), cache

    # -- caches -----------------------------------------------------------------
    def cache_spec(self, batch: int, s_max: int):
        return T.cache_spec(self.cfg, batch, s_max)

    def cache_zeros(self, batch: int, s_max: int, device=None):
        """Zero caches on `device` (the card unless told otherwise)."""
        return P.init_params(self.cache_spec(batch, s_max), None,
                             resolve_device(device))


def build_model(cfg: ModelConfig) -> Model:
    """The model of a config; raises `NotImplementedError` for what the
    port does not serve yet."""
    unported = []
    if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
        unported.append(f"family {cfg.family!r}")
    if cfg.encdec:
        unported.append("encoder-decoder")
    if cfg.attention_kind == "none":     # attention-free: Mamba blocks only
        if set(cfg.layer_kinds()) != {MAMBA}:
            unported.append("attention kind 'none' with attention blocks")
    elif cfg.attention_kind not in ("attn", "mla") or (
            (cfg.attention_kind == "mla") != (cfg.mla is not None)):
        unported.append(f"attention kind {cfg.attention_kind!r}")
    if cfg.kernels != "auto":
        unported.append(f"kernels={cfg.kernels!r} (the tensors' device picks "
                        "kernel or plain version)")
    for knob in ("pad_heads_to_tp", "decode_cache_seq_shard", "decode_2d_tp"):
        if getattr(cfg, knob):
            unported.append(knob)
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet (the port "
            "serves the dense, MoE, hybrid and SSM families; ROADMAP.md "
            "Queue 1)")
    return Model(cfg)
