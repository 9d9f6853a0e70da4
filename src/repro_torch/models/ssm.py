"""Linear-recurrence blocks of the port: the Griffin RG-LRU half of the
reference's `src/repro/models/ssm.py`, in its layout and dtypes.

`chunked_diag_scan` is the recurrence h_t = a_t h_{t-1} + b_t from
h_{-1} = 0 in fp32 over (B, S, C), returning every h_t and the last one.
The reference scans it in checkpointed time chunks (`DEFAULT_CHUNK`); the
port runs K7's kernel (`kernels/ssm_scan.py::ssm_scan`, counted in its
`launches`) on a CUDA tensor and the kernel's plain version on a CPU
tensor.  The kernel picks its own time chunks (`ssm_scan.scan_plan`), so
`chunk` only has to be positive.  It is forward only (K7 refuses an input
that requires grad).

`rglru_block` (prefill) and `rglru_decode` (one token) are the Griffin
recurrent block: a GELU gate branch and a conv1d + RG-LRU branch, merged
and projected, with per-channel diagonal gates as in the reference.
Their cache is the pre-conv tail of the x branch (`conv`, d_conv - 1
rows) and the recurrence's state (`h`, fp32).

Not ported (raise `NotImplementedError`): the Mamba-1 block
(`mamba_spec`, `mamba_block`, `mamba_decode`; ROADMAP.md Queue 1 item
6 (b)) and a scan from a given initial state `h0`, which no caller
passes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import exact_fp32
from repro_torch.kernels import ssm_scan as SS
from repro_torch.models.param import ParamSpec

F32 = torch.float32
DEFAULT_CHUNK = 64
_LRU_C = 8.0


def _mamba_unported(*_args, **_kwargs):
    raise NotImplementedError("the Mamba-1 block is not ported yet "
                              "(ROADMAP.md Queue 1 item 6 (b))")


mamba_spec = mamba_block = mamba_decode = _mamba_unported


# ---------------------------------------------------------------------------
# the diagonal linear recurrence (K12b forward, on K7's kernel)
# ---------------------------------------------------------------------------
def chunked_diag_scan(a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor] = None,
                      chunk: int = DEFAULT_CHUNK
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, C) -> (hs (B, S, C) fp32, h_final (B, C) fp32) for
    h_t = a_t h_{t-1} + b_t from zero: K7's kernel on CUDA tensors, its
    plain version on CPU tensors; any other device raises."""
    if h0 is not None:
        raise NotImplementedError("a scan from an initial state h0 is not "
                                  "ported: no caller passes one")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return SS.ssm_scan(a.contiguous(), b.contiguous())


# ---------------------------------------------------------------------------
# causal depthwise conv1d, and its single-step update for decode
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (C, K) depthwise, causal; summed in fp32 and
    cast back to x's dtype."""
    k, s = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    wf = w.to(F32)
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for j in range(k):
        out = out + xp[:, j:j + s].to(F32) * wf[:, j][None, None]
    return (out + bias.to(F32)).to(x.dtype)


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, bias: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, C); conv_state: (B, K-1, C) past inputs.  Returns (y_t in
    x_t's dtype, the new state: the window's last K-1 rows, in the dtype
    x_t and conv_state promote to)."""
    k = w.shape[1]
    window = torch.cat([conv_state, x_t[:, None]], dim=1)       # (B, K, C)
    exact_fp32()
    y = torch.einsum("bkc,ck->bc", window.to(F32), w.to(F32)) + bias.to(F32)
    return y.to(x_t.dtype), (window[:, -(k - 1):] if k > 1 else conv_state)


# ---------------------------------------------------------------------------
# Griffin RG-LRU block (recurrentgemma)
# ---------------------------------------------------------------------------
def rglru_spec(cfg: ModelConfig) -> dict:
    g = cfg.rglru
    d = cfg.d_model
    w = g.lru_width or d
    return {
        "in_x": ParamSpec((d, w), init="scaled"),
        "in_gate": ParamSpec((d, w), init="scaled"),
        "conv_w": ParamSpec((w, g.d_conv), init="scaled"),
        "conv_b": ParamSpec((w,), init="zeros"),
        "gate_i_w": ParamSpec((w,), init="zeros", dtype=F32),
        "gate_i_b": ParamSpec((w,), init="zeros", dtype=F32),
        "gate_r_w": ParamSpec((w,), init="zeros", dtype=F32),
        "gate_r_b": ParamSpec((w,), init="zeros", dtype=F32),
        "a_param": ParamSpec((w,), init="lru_a", dtype=F32),
        "out": ParamSpec((w, d), init="scaled"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: log(exp(x) + 1) as `logaddexp(x, 0)`, with no
    linear branch past a threshold (`F.softplus` turns linear past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(xc: torch.Tensor, p) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc fp32 (..., w) -> (a, gated input) fp32: per-channel diagonal
    gates, a = exp(-c r softplus(Lambda)) and sqrt(1 - a^2) i xc."""
    i_gate = torch.sigmoid(xc * p["gate_i_w"] + p["gate_i_b"])
    r_gate = torch.sigmoid(xc * p["gate_r_w"] + p["gate_r_b"])
    log_a = -_LRU_C * r_gate * _softplus(p["a_param"])
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * i_gate * xc


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rglru_block(x: torch.Tensor, p, cfg: ModelConfig,
                chunk: int = DEFAULT_CHUNK, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d) [, (conv_state, h_final)].  conv_state is
    the raw pre-conv tail of the x branch, its last d_conv - 1 rows (fewer
    for a shorter prompt, as the reference slices it)."""
    exact_fp32()
    xb_pre = torch.einsum("bsd,dw->bsw", x, p["in_x"])
    gb = torch.einsum("bsd,dw->bsw", x, p["in_gate"])
    xb = causal_conv1d(xb_pre, p["conv_w"], p["conv_b"])
    a, b = _rglru_gates(xb.to(F32), p)
    hs, h_final = chunked_diag_scan(a, b, chunk=chunk)         # (B,S,w) fp32
    y = hs * _gelu(gb.to(F32))
    out = torch.einsum("bsw,wd->bsd", y.to(x.dtype), p["out"])
    if return_state:
        return out, (xb_pre[:, -(cfg.rglru.d_conv - 1):], h_final)
    return out


def rglru_decode(x_t: torch.Tensor, p, cfg: ModelConfig,
                 conv_state: torch.Tensor, h: torch.Tensor):
    """x_t: (B, 1, d); conv_state (B, K-1, w); h (B, w) fp32.  Returns
    (y (B, 1, d), the new conv_state, the new h) as fresh tensors."""
    exact_fp32()
    xb = torch.einsum("bsd,dw->bsw", x_t, p["in_x"])[:, 0]
    gb = torch.einsum("bsd,dw->bsw", x_t, p["in_gate"])[:, 0]
    xb, conv_state = conv1d_step(xb, conv_state, p["conv_w"], p["conv_b"])
    a, b = _rglru_gates(xb.to(F32), p)
    h = a * h + b
    y = h * _gelu(gb.to(F32))
    out = torch.einsum("bw,wd->bd", y.to(x_t.dtype), p["out"])[:, None]
    return out, conv_state, h
