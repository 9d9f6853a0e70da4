"""moonshot-v1-16b-a3b [moe] — Moonlight (DeepSeek-V3-family): 64 routed + 2 shared, top-6.
[hf:moonshotai/Moonlight-16B-A3B]

The reference's config, field for field: full attention, layer 0 dense
(d_ff 11264), then 47 MoE layers.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, smoke_variant

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,                 # dense FFN of layer 0
    vocab_size=163840,
    mlp_kind="swiglu",
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
        layer_mode="all_but_first",
    ),
    tie_embeddings=False,
)

SMOKE = smoke_variant(FULL, num_kv_heads=4)
CONFIG = FULL
