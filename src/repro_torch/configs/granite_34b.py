"""granite-34b [dense] — llama-arch code model, MQA (kv=1). [arXiv:2405.04324; hf]

The reference's config, field for field: 88 layers, one KV head shared
by all 48 query heads, the head tied to the embedding.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,           # MQA
    d_ff=24576,
    vocab_size=49152,
    mlp_kind="swiglu",
    tie_embeddings=True,
    qkv_bias=False,
)

SMOKE = smoke_variant(FULL, num_kv_heads=1)
CONFIG = FULL
