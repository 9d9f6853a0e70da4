"""Parameter declaration: a model is described once as a nested dict (and
list) of `ParamSpec`s, in the reference's tree layout, and materialized
from it by `init_params`.

Weights are drawn from an explicit `torch.Generator` on the device they
live on, so on the card the parameters never pass through the host.  The
draws differ from `jax.random`'s for the same seed; the tests carry the
reference's weights across instead (`models/model.py::params_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"     # normal|zeros|ones|scaled|lru_a|a_log|dt_bias
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16


SpecTree = Dict[str, Any]  # nested dict / list of ParamSpec


def _init_one(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    shape, dtype = spec.shape, spec.dtype
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init in ("normal", "scaled"):
        if spec.init == "normal":
            s = spec.scale
        else:                                  # fan-in scaled
            s = 1.0 / math.sqrt(shape[0] if len(shape) >= 2
                                else max(shape[0], 1))
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * s).to(dtype)
    if spec.init == "lru_a":    # RG-LRU Lambda so that a is in [0.9, 0.999]
        u = 0.9 + (0.999 - 0.9) * torch.rand(
            shape, generator=generator, dtype=torch.float32, device=device)
        # a = exp(-c softplus(L) r): store L with softplus(L) = -log(u) / c
        # (c = 8, r ~ 1)
        target = -torch.log(u) / 8.0
        return torch.log(torch.expm1(torch.clamp_min(target, 1e-8))
                         ).to(dtype)
    if spec.init == "a_log":    # Mamba's A_log: log(1..d_state) on each row
        # taken in fp64 and rounded once, so every device draws the same
        # bits (the correctly rounded logs)
        n = torch.arange(1, shape[-1] + 1, dtype=torch.float64)
        row = torch.log(n).to(torch.float32).to(device)
        return row.expand(shape).to(dtype).contiguous()
    if spec.init == "dt_bias":  # softplus-inverse of U[1e-3, 1e-1]
        u = 1e-3 + (1e-1 - 1e-3) * torch.rand(
            shape, generator=generator, dtype=torch.float32, device=device)
        return torch.log(torch.expm1(u)).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def tree_map(fn: Callable, tree):
    """`fn` over the leaves of a nested dict / list tree, keeping its keys,
    order and nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list tree, in `tree_map`'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_params(spec: SpecTree, generator: torch.Generator, device):
    """Materialize `spec` leaf by leaf, in tree order, from `generator`
    (which must live on `device`)."""
    device = torch.device(device)
    return tree_map(lambda s: _init_one(s, generator, device), spec)


def param_count(spec: SpecTree) -> int:
    n = [0]

    def count(s: ParamSpec):
        n[0] += math.prod(s.shape)
    tree_map(count, spec)
    return n[0]
