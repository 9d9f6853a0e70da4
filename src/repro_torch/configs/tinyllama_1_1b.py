"""tinyllama-1.1b [dense] — llama2-arch small, GQA kv=4. [arXiv:2401.02385; hf]"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    mlp_kind="swiglu",
    tie_embeddings=False,
)

SMOKE = smoke_variant(FULL, num_kv_heads=2)
CONFIG = FULL
