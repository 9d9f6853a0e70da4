"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512; 64 routed + 2 shared, top-6.
[arXiv:2405.04434; hf]

The reference's config, field for field: 27 layers, layer 0 dense
(d_ff 10944), then 26 MoE layers of 64 routed + 2 shared experts.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      smoke_variant)

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,            # unused under MLA (latent KV)
    d_ff=10944,                 # dense FFN of layer 0
    vocab_size=102400,
    attention_kind="mla",
    block_pattern=("mla",),
    mlp_kind="swiglu",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,          # V2-Lite: no q-lora
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
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
