"""Train / serve step factories (the reference's
`src/repro/training/step.py`).

`make_train_step(model, opt_cfg)` -> train_step(state, batch) with:
  * the loss and its gradients through `torch.autograd` over
    `model.loss` (on the card: K5 and K11 for attention, K8 and its
    backward for every norm, K9 and its backward (`grouped_gemm_dx`,
    `grouped_gemm_dw`) for every routed-expert product of the MoE
    family, K10 and K12a for the blocked loss; cuBLAS, autograd's own
    kernels elsewhere), each layer rematerialized as `cfg.remat` says,
  * optional microbatch gradient accumulation (a loop over splits; the
    gradients summed in fp32, then divided, the loss and metrics
    averaged, as the reference's scan does),
  * the AdamW update (`optim/adamw.py`, written into the state's
    tensors).

`init_train_state` draws the parameters on the device and marks them
trainable; the serving path's trees (`Model.init`) stay frozen.
`abstract_train_state` is the state's shapes and dtypes as meta-device
tensors (what `checkpoint.restore_checkpoint` fills).
`make_prefill_step` / `make_decode_step` are the serving lowerings.

It trains both families the port serves: the dense one and the MoE one
(deepseek-v2-lite-16b, moonshot-v1-16b-a3b).  DeepSeek's MLA prefill has
q/k head dim 192 and v head dim 128, so its attention stays on the dense
path (autograd's own backward) as in the reference.

Not ported yet (ROADMAP.md Queue 1): training the hybrid and SSM
families (`make_train_step` raises: the backwards of the RG-LRU's and
Mamba's scans are item 6 (c))
and the explicit data-parallel `make_dp_compressed_step` /
`init_dp_compressed_state` (`distributed/`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves as leaves
from repro_torch.models.param import tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

F32 = torch.float32


def trainable(params):
    """The tree with each leaf a trainable `nn.Parameter` sharing the
    leaf's storage."""
    return tree_map(lambda t: nn.Parameter(t.detach(), requires_grad=True),
                    params)


def init_train_state(model: Model, generator: torch.Generator,
                     opt_cfg: AdamWConfig, device=None) -> Dict[str, Any]:
    """Parameters drawn from `generator` on `device` (the card unless told
    otherwise), trainable and bound to `model`, with zero moments."""
    params = trainable(model.init(generator, device))
    model.bind(params)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def abstract_train_state(model: Model, opt_cfg: AdamWConfig
                         ) -> Dict[str, Any]:
    """The train state's tree of shapes and dtypes, each leaf an empty
    tensor on the meta device: bf16 parameters as the spec gives them,
    moments in `opt_cfg.state_dtype`, the int32 step count."""
    def meta(spec, dtype=None):
        return torch.empty(spec.shape, dtype=dtype or spec.dtype,
                           device="meta")
    moment = getattr(torch, opt_cfg.state_dtype)
    spec = model.spec()
    return {"params": tree_map(meta, spec),
            "opt": {"m": tree_map(lambda s: meta(s, moment), spec),
                    "v": tree_map(lambda s: meta(s, moment), spec),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def _split_microbatches(batch: Dict[str, Any], n: int):
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    grad_accum: int = 1):
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if model.cfg.family in ("hybrid", "ssm"):
        raise NotImplementedError(
            f"{model.cfg.name}: training the {model.cfg.family} family is "
            "not ported yet (the backwards of the RG-LRU's and Mamba's "
            "scans: ROADMAP.md Queue 1 item 6 (c))")

    def loss_and_grads(params, mb):
        with torch.enable_grad():
            loss, metrics = model.loss(params, mb)
            grads = torch.autograd.grad(loss, leaves(params))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def train_step(state, batch):
        params = state["params"]
        flat = leaves(params)
        if not all(p.requires_grad for p in flat):
            raise ValueError("the train state's parameters must require "
                             "grad (init_train_state, or training.step."
                             "trainable(params))")
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=F32, device=p.device)
                     for p in flat]
            loss = torch.zeros((), dtype=F32, device=flat[0].device)
            ms = []
            for mb in _split_microbatches(batch, grad_accum):
                l_mb, m, g = loss_and_grads(params, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss = loss + l_mb
                ms.append(m)
            for acc in grads:
                acc.div_(grad_accum)
            loss = loss / grad_accum
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        index = iter(range(len(flat)))
        grad_tree = tree_map(lambda _: grads[next(index)], params)
        del grads
        new_params, new_opt, opt_metrics = adamw_update(
            params, grad_tree, state["opt"], opt_cfg)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens, index):
        return model.decode_step(params, cache, tokens, index)
    return decode_step
