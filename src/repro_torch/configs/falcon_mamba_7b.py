"""falcon-mamba-7b [ssm] — pure Mamba-1, attention-free. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, smoke_variant

FULL = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,                # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                     # mamba blocks have no separate MLP
    vocab_size=65024,
    attention_kind="none",
    rope_kind="none",
    block_pattern=("mamba",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
)

SMOKE = smoke_variant(FULL)
CONFIG = FULL
