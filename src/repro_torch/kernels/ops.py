"""The kernels at the model's layout: attention in (B, S, H, D), as the
reference's `kernels/ops.py` exposes it to `models/layers.py`."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as FA


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,H,D), through K5 in its
    (B,H,S,D) layout (forward only)."""
    o, _ = FA.flash_attention_fwd(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(),
                                  causal=causal, scale=scale)
    return o.transpose(1, 2)
