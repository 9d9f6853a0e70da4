"""Mixture-of-Experts FFN of the port (DeepSeek/Moonlight family: shared
+ routed top-k), the reference's `src/repro/models/moe.py` on tensors.

Routing follows the reference to the letter, per batch row: fp32 router
logits and softmax, the top k sorted in descending order, the gates
renormalised, a Switch auxiliary loss, and the position of each of a
row's S*k token copies in its expert from a cumsum in s-major, k-minor
order; a copy at a position >= the capacity C = max(int(cf * k * S / E),
k) is dropped (GShard semantics).

The routed experts run on a packed layout instead of the reference's
(B, E, C, d) capacity buffers: the kept copies of the whole batch, sorted
by expert into `block_m`-row blocks, each block multiplied by its
expert's weights through K9 (`kernels/ops.py::grouped_gemm`, which is
differentiable through K9's backward).  A kept
copy gives the same output in either layout and a dropped one adds
exactly 0 in both.  The buffer is sized from shapes alone
(ceil(copies / block_m) + E blocks) and its counts, offsets and block
ids are computed on the tensors' device, so no MoE layer copies anything
to the host.  The shared experts are a dense SwiGLU in tensor ops, as the
reference computes them outside any kernel.

`moe_block` is differentiable as the reference's is: the scatter into the
buffer and the gather out of it are autograd's index ops, the expert
products K9 forward and backward, and the router and gates take their
gradient through `torch.topk`'s values and the auxiliary loss.  Every
dropped copy points at the buffer's last row, in a block of id -1: K9
writes zeros there and its backward gives that block zero dX and no dW
term, and the copy's gate weight is 0, so a dropped copy carries no
gradient to x or to any weight.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.param import ParamSpec

F32 = torch.float32


def moe_spec(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    s = {
        "router": ParamSpec((d, m.num_experts), init="scaled", dtype=F32),
        "w_gate": ParamSpec((m.num_experts, d, fe), init="scaled"),
        "w_up": ParamSpec((m.num_experts, d, fe), init="scaled"),
        "w_down": ParamSpec((m.num_experts, fe, d), init="scaled"),
    }
    if m.num_shared_experts:
        fs = m.num_shared_experts * fe
        s["shared"] = {
            "wi_gate": ParamSpec((d, fs), init="scaled"),
            "wi_up": ParamSpec((d, fs), init="scaled"),
            "wo": ParamSpec((fs, d), init="scaled"),
        }
    return s


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * m.top_k * seq / m.num_experts)
    return max(c, m.top_k)


class Routing(NamedTuple):
    probs: torch.Tensor       # (B, S, E) fp32 router probabilities
    gate_vals: torch.Tensor   # (B, S, k) fp32, renormalised
    expert_idx: torch.Tensor  # (B, S, k) int64, descending probability
    keep: torch.Tensor        # (B, S*k) bool: within the row's capacity


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          capacity: int) -> Routing:
    """The routing decisions of x (B, S, d), as the reference takes them."""
    m = cfg.moe
    k = m.top_k
    logits = torch.einsum("bsd,de->bse", x.to(F32), router.to(F32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    keep = capacity_keep(expert_idx, m.num_experts, capacity)
    return Routing(probs, gate_vals, expert_idx, keep)


def capacity_keep(expert_idx: torch.Tensor, n_experts: int,
                  capacity: int) -> torch.Tensor:
    """Each batch row's S*k copies (s-major, k-minor) placed in their
    experts by a cumsum: keep (B, S*k), False for a copy at a position
    >= capacity (the reference's overflow slot)."""
    b, s, k = expert_idx.shape
    flat_e = expert_idx.reshape(b, s * k)
    pos = torch.cumsum(F.one_hot(flat_e, n_experts), dim=1) - 1
    return torch.gather(pos, 2, flat_e[..., None])[..., 0] < capacity


def block_m_for(copies: int, n_experts: int) -> int:
    """K9's row block for a call: 8 rows when the copies average at most 8
    per expert (a decode tick, where a block of 64 would be mostly
    padding and the kernel streams weight slabs), 64 otherwise (a
    prefill, where bigger tiles reuse each weight tile across more
    rows)."""
    return 8 if copies <= 8 * n_experts else 64


def pack(expert_idx: torch.Tensor, keep: torch.Tensor, n_experts: int,
         block_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed layout of a batch's token copies, on their device.

    expert_idx (..., k) and keep (same count of copies, flattened in
    s-major, k-minor order).  Returns `dest` (copies,), each kept copy's
    row in the packed buffer (its expert's rows in order, each expert's
    group padded to whole blocks), and `block_ids` (blocks,) int32, the
    expert of each block or -1.  The buffer has ceil(copies / block_m) + E
    blocks, so its last block is never used: dropped copies point at its
    last row."""
    eflat = expert_idx.reshape(-1)
    kept = keep.reshape(-1)
    n = eflat.shape[0]
    blocks = -(-n // block_m) + n_experts
    onehot = F.one_hot(eflat, n_experts) * kept[:, None]
    counts = onehot.sum(0)
    rank = torch.gather(torch.cumsum(onehot, 0), 1, eflat[:, None])[:, 0] - 1
    ends = torch.cumsum(-(-counts // block_m) * block_m, 0)
    starts = ends - (-(-counts // block_m) * block_m)
    dest = torch.where(kept, starts[eflat] + rank,
                       torch.full_like(rank, blocks * block_m - 1))
    first_rows = torch.arange(blocks, device=eflat.device) * block_m
    ids = torch.searchsorted(ends, first_rows, right=True)
    block_ids = torch.where(ids < n_experts, ids, -1).to(torch.int32)
    return dest, block_ids


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
              capacity: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar fp32)."""
    m = cfg.moe
    b, s, d = x.shape
    k = m.top_k
    c = capacity or moe_capacity(cfg, s)
    r = route(x, p["router"], cfg, c)

    # Switch aux loss: E * sum_e f_e * P_e  (global means)
    me = r.probs.mean((0, 1))
    ce = F.one_hot(r.expert_idx[..., 0], m.num_experts).to(F32).mean((0, 1))
    aux = m.num_experts * torch.sum(me * ce) * m.aux_loss_weight

    # routed experts on the packed layout, every product through K9
    bm = block_m_for(b * s * k, m.num_experts)
    dest, block_ids = pack(r.expert_idx, r.keep, m.num_experts, bm)
    xs = torch.zeros((block_ids.shape[0] * bm, d), dtype=x.dtype,
                     device=x.device)
    xs[dest] = x.reshape(b * s, d).repeat_interleave(k, dim=0)
    g = ops.grouped_gemm(xs, p["w_gate"], block_ids, bm)
    u = ops.grouped_gemm(xs, p["w_up"], block_ids, bm)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    out = ops.grouped_gemm(h, p["w_down"], block_ids, bm)
    w = (r.gate_vals.reshape(b, s * k) * r.keep.to(F32)).to(x.dtype)
    y = (out[dest].reshape(b, s * k, d) * w[..., None]
         ).reshape(b, s, k, d).sum(dim=2)

    if m.num_shared_experts:
        sp = p["shared"]
        g = torch.einsum("bsd,df->bsf", x, sp["wi_gate"])
        u = torch.einsum("bsd,df->bsf", x, sp["wi_up"])
        y = y + torch.einsum("bsf,fd->bsd",
                             F.silu(g.to(F32)).to(x.dtype) * u, sp["wo"])
    return y, aux
