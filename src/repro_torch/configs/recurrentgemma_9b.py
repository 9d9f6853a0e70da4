"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU + local attn 1:2, MQA kv=1, window 2048.
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, smoke_variant

FULL = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,             # MQA on the local-attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),   # 2 recurrent : 1 local-attn
    rglru=RGLRUConfig(lru_width=4096, d_conv=4, local_window=2048),
    mlp_kind="swiglu",
    attn_logit_softcap=0.0,
    tie_embeddings=True,
)

SMOKE = smoke_variant(FULL, num_kv_heads=1)
CONFIG = FULL
