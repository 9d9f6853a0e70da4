"""Model configurations of the port: the reference's `ModelConfig` with
its sub-configs and `smoke_variant`, field for field, so that a config
written for one package reads the same in the other.

The package serves the dense family, the MoE family with full
attention or MLA, the hybrid family of RG-LRU and local-attention
blocks, and the attention-free Mamba-1 family (see
`configs/__init__.py::get_config` and `models/model.py::build_model`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds used by models/transformer.py per-layer patterns.
ATTN = "attn"          # softmax attention (GQA/MQA; window>0 => local)
MLA = "mla"            # DeepSeek multi-head latent attention
MAMBA = "mamba"        # Mamba-1 selective SSM
RGLRU = "rglru"        # Griffin RG-LRU recurrent block
LOCAL_ATTN = "local"   # local (windowed) attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    layer_mode: str = "all_but_first"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0
    d_conv: int = 4
    block_width_multiplier: float = 1.0
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 => d_model // num_heads
    # --- attention details
    attention_kind: str = ATTN         # attn|mla|none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_kind: str = "rope"            # rope|mrope|none|sinusoid
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_logit_softcap: float = 0.0
    # --- per-layer block pattern, cycled over layers
    block_pattern: Tuple[str, ...] = (ATTN,)
    # --- mlp
    mlp_kind: str = "swiglu"           # swiglu|gelu
    # --- sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # --- encoder-decoder (whisper)
    encdec: bool = False
    enc_layers: int = 0
    dec_layers: int = 0
    cross_kv_len: int = 1500
    dec_train_len: int = 512
    # --- vlm
    n_vision_tokens: int = 0
    # --- embeddings / misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # --- runtime knobs of the reference (not architecture)
    remat: str = "none"
    use_scan: bool = True
    kernels: str = "auto"
    blocked_xent: bool = False
    vocab_block: int = 8192
    pad_heads_to_tp: bool = False
    moe_expert_fsdp: bool = True
    decode_cache_seq_shard: bool = False
    decode_2d_tp: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def dt_rank(self) -> int:
        """Mamba's dt projection rank: `ssm.dt_rank`, or ceil(d / 16)."""
        if self.ssm is None:
            raise ValueError(f"{self.name} has no SSM section")
        return self.ssm.dt_rank or -(-self.d_model // 16)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Temporal-mixing kind for each layer (pattern cycled)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.layer_mode == "all":
            return True
        return i > 0  # all_but_first

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count of the families the port serves (the
        reference's `ModelConfig.param_count`; equals `Model.param_count`
        of the built model)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        if self.encdec:
            raise NotImplementedError(
                f"{self.name}: param_count covers the decoder-only blocks "
                "the port serves (encoder-decoder: ROADMAP.md Queue 1 item "
                "7)")

        def attn_params() -> int:
            n = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            if self.qkv_bias:
                n += (nq + 2 * nkv) * hd
            return n

        def mla_params() -> int:
            m = self.mla
            qdim = nq * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            n = (d * qdim if m.q_lora_rank == 0 else
                 d * m.q_lora_rank + m.q_lora_rank * qdim + m.q_lora_rank)
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # down-proj, rope k
            n += m.kv_lora_rank                             # kv norm
            n += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
            n += nq * m.v_head_dim * d                      # o proj
            return n

        def mamba_params() -> int:
            s = self.ssm
            di, dtr = s.expand * d, self.dt_rank
            n = d * 2 * di                                  # in_proj
            n += di * s.d_conv + di                         # conv1d + bias
            n += di * (dtr + 2 * s.d_state)                 # x_proj
            n += dtr * di + di                              # dt_proj, bias
            n += di * s.d_state + di                        # A_log, D
            return n + di * d                               # out_proj

        def rglru_params() -> int:
            g = self.rglru
            w = g.lru_width or d
            n = 2 * d * w                                   # x, gate in-proj
            n += w * g.d_conv + w                           # conv1d + bias
            n += 4 * w                                      # the gates' w, b
            n += w                                          # a param
            return n + w * d                                # out proj

        def dense_mlp(dff: int) -> int:
            if self.mlp_kind == "swiglu":
                return 3 * d * dff
            return 2 * d * dff + dff + d

        def moe_mlp() -> int:
            m = self.moe
            n = d * m.num_experts                           # router
            n += m.num_experts * 3 * d * m.d_ff_expert
            n += m.num_shared_experts * 3 * d * m.d_ff_expert
            return n

        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += d                                          # final norm
        for i, k in enumerate(self.layer_kinds()):
            if k == MAMBA:                  # a norm and the mixer, no MLP
                total += d + mamba_params()
                continue
            total += 2 * d                                  # the two norms
            total += (mla_params() if k == MLA else rglru_params()
                      if k == RGLRU else attn_params())
            total += moe_mlp() if self.layer_is_moe(i) else dense_mlp(self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: the top-k routed and the
        shared experts count, the other routed experts do not)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        idle = (m.num_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        n_moe = sum(self.layer_is_moe(i) for i in range(self.num_layers))
        return self.param_count() - n_moe * idle


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to CPU-test scale, preserving family structure
    (the reference's rule, for the families this package serves: dense,
    MoE, MLA, the RG-LRU hybrid and Mamba-1)."""
    kw = dict(
        num_layers=min(cfg.num_layers, len(cfg.block_pattern) + 1),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        use_scan=True,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        d_ff_expert=32)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, d_conv=4,
                                        expand=2)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=64,
                                          local_window=32)
    kw["name"] = cfg.name + "-smoke"
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
