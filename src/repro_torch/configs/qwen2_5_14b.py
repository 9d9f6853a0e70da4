"""qwen2.5-14b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-*; hf]

The reference's config, field for field: 48 layers, 40 query heads over
8 KV heads (a group of 5), biases on the q/k/v projections, rope theta
1e6.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
)

SMOKE = smoke_variant(FULL, num_kv_heads=2)
CONFIG = FULL
