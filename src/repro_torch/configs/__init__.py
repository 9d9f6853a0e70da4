"""Architecture registry of the port: the architectures it serves so far.

The reference registers ten architectures; the port serves the dense
`tinyllama-1.1b`, `granite-34b` (MQA), `qwen2.5-14b` (QKV bias) and
`llama3-405b`, the MoE `deepseek-v2-lite-16b` (MLA) and
`moonshot-v1-16b-a3b` (full attention), the hybrid `recurrentgemma-9b`
(RG-LRU and local attention) and the attention-free `falcon-mamba-7b`
(Mamba-1), full and smoke, and raises `NotImplementedError` for the
other two until their families are ported (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite_16b, falcon_mamba_7b,
                                 granite_34b, llama3_405b,
                                 moonshot_v1_16b_a3b, qwen2_5_14b,
                                 recurrentgemma_9b, tinyllama_1_1b)
from repro_torch.configs.base import (ModelConfig,  # noqa: F401
                                      smoke_variant)

_PORTED = {"granite-34b": granite_34b,
           "qwen2.5-14b": qwen2_5_14b,
           "llama3-405b": llama3_405b,
           "tinyllama-1.1b": tinyllama_1_1b,
           "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
           "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
           "recurrentgemma-9b": recurrentgemma_9b,
           "falcon-mamba-7b": falcon_mamba_7b}
# the ROADMAP.md Queue 1 item that ports each of the others
_NOT_PORTED = {"qwen2-vl-7b": "item 7", "whisper-small": "item 7"}

ARCH_NAMES = tuple(_PORTED)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; the port serves "
            f"{ARCH_NAMES} (ROADMAP.md Queue 1 {_NOT_PORTED[name]})")
    if name not in _PORTED:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _PORTED[name]
    return mod.SMOKE if smoke else mod.FULL
