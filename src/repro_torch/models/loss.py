"""Cross-entropy losses (the reference's `src/repro/models/loss.py`).

`cross_entropy` takes full logits.  `blocked_cross_entropy` computes the
cross-entropy of `x @ emb^T` without forming the (T, V) logits: it runs
`kernels/ops.py::BlockedXent`, K10 forward (whose plain version is the
reference's scan over vocab blocks carrying the running (max, sum-exp,
label logit, argmax)) and K12a backward (each vocab chunk's logits
recomputed, as the reference's `jax.checkpoint` on its block body
recomputes them).  The mask and the mean stay here, so autograd hands
K12a the gradient mask_t / sum(mask) of each token's nll.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops

F32 = torch.float32


def _mean(nll: torch.Tensor, acc: torch.Tensor,
          mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if mask is None:
        return nll.mean(), acc.mean()
    mask = mask.to(F32)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom, (acc * mask).sum() / denom


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., V) any float dtype; labels (...) int.
    Returns (mean_nll fp32, accuracy fp32)."""
    logits = logits.to(F32)
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    acc = (torch.argmax(logits, dim=-1) == labels).to(F32)
    return _mean(lse - ll, acc, mask)


def blocked_cross_entropy(x: torch.Tensor, emb: torch.Tensor,
                          labels: torch.Tensor, block: int = 8192,
                          mask: Optional[torch.Tensor] = None,
                          transpose_emb: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE of logits = x @ emb^T without materializing them.

    x: (T, d) final hidden states; emb: (V, d) (or (d, V) with
    transpose_emb, read in place); labels: (T,).  Returns (mean_nll,
    max-logit-match accuracy)."""
    nll, amax = ops.blocked_xent(x, emb, labels, transpose_emb=transpose_emb,
                                 block_v=block)
    return _mean(nll, (amax == labels).to(F32), mask)
