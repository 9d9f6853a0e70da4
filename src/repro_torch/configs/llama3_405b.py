"""llama3-405b [dense] — GQA kv=8, 128k vocab. [arXiv:2407.21783]

The reference's config, field for field: 126 layers at d 16,384, 128
query heads over 8 KV heads, rope theta 5e5.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    mlp_kind="swiglu",
    rope_theta=500000.0,
    tie_embeddings=False,
)

SMOKE = smoke_variant(FULL, num_kv_heads=2)
CONFIG = FULL
