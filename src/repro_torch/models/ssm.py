"""Linear-recurrence blocks of the port: the Mamba-1 selective SSM and
the Griffin RG-LRU of the reference's `src/repro/models/ssm.py`, in its
layout and dtypes.

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

`mamba_block` (prefill) and `mamba_decode` (one token) are the Mamba-1
block: in_proj to the x and z branches, a causal depthwise conv1d and
SiLU on x, the input-dependent dt, B and C (`_mamba_abc`), the selective
scan, the skip D x and the SiLU(z) gate, out_proj.  The prefill's scan
(`_mamba_chunk_scan`) is K12c (`kernels/selective_scan.py`, counted in
its `launches`) on a CUDA tensor and its plain version on a CPU tensor;
the decode updates the state elementwise, as the reference leaves it to
XLA, and launches no K12c.  Their cache is the raw pre-conv tail of the
x branch (`conv`, d_conv - 1 rows) and the scan's state (`ssm`, (B,
d_inner, N) fp32).  K12c is forward only.

Not ported (raises `NotImplementedError`): a diagonal scan from a given
initial state `h0`, which no caller passes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import exact_fp32
from repro_torch.kernels import selective_scan as K12C
from repro_torch.kernels import ssm_scan as SS
from repro_torch.models.param import ParamSpec

F32 = torch.float32
DEFAULT_CHUNK = 64
_LRU_C = 8.0


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


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: log(exp(x) + 1) as `logaddexp(x, 0)`, with no
    linear branch past a threshold (`F.softplus` turns linear past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------
def mamba_spec(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = cfg.dt_rank
    return {
        "in_proj": ParamSpec((d, 2 * di), init="scaled"),
        "conv_w": ParamSpec((di, s.d_conv), init="scaled"),
        "conv_b": ParamSpec((di,), init="zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * s.d_state), init="scaled"),
        "dt_proj": ParamSpec((dtr, di), init="scaled"),
        "dt_bias": ParamSpec((di,), init="dt_bias", dtype=F32),
        "A_log": ParamSpec((di, s.d_state), init="a_log", dtype=F32),
        "D": ParamSpec((di,), init="ones", dtype=F32),
        "out_proj": ParamSpec((di, d), init="scaled"),
    }


def _mamba_abc(xc: torch.Tensor, p, cfg: ModelConfig):
    """The shared projections: xc (B, T, d_inner) -> dt (B, T, d_inner)
    fp32 (softplus'd), Bm, Cm (B, T, N) in xc's dtype."""
    s = cfg.ssm
    dtr = cfg.dt_rank
    exact_fp32()
    xdbc = torch.einsum("btd,dk->btk", xc, p["x_proj"])
    dt_r, bm, cm = torch.split(xdbc, [dtr, s.d_state, s.d_state], dim=-1)
    dt = torch.einsum("btr,rd->btd", dt_r, p["dt_proj"]).to(F32) \
        + p["dt_bias"]
    return _softplus(dt), bm, cm


def _mamba_chunk_scan(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                      xc: torch.Tensor, A: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan: dt (B, S, d_inner) fp32; Bm, Cm (B, S, N); xc
    (B, S, d_inner); A (d_inner, N) fp32 -> (y (B, S, d_inner) fp32,
    h_final (B, d_inner, N) fp32).  K12c on CUDA tensors (a and b in
    registers, no (B, chunk, d_inner, N) tensor, every step in one pass),
    its plain version in the reference's chunks of 64 on CPU tensors; any
    other device raises."""
    return K12C.selective_scan(dt.contiguous(), bm.contiguous(),
                               cm.contiguous(), xc.contiguous(),
                               A.contiguous())


def mamba_block(x: torch.Tensor, p, cfg: ModelConfig,
                return_state: bool = False):
    """x: (B, S, d) -> (B, S, d) [, (conv_state, ssm_state)].  conv_state
    is the raw pre-conv tail of the x branch, its last d_conv - 1 rows
    (fewer for a shorter prompt, as the reference slices it), copied: a
    view would keep the layer's whole (B, S, 2 d_inner) in_proj output
    alive until the prefill stacks every layer's cache."""
    exact_fp32()
    xz = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    xc_pre, z = xz.chunk(2, dim=-1)                     # (B, S, di) each
    xc = causal_conv1d(xc_pre, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.to(F32)).to(x.dtype)
    dt, bm, cm = _mamba_abc(xc, p, cfg)
    A = -torch.exp(p["A_log"])                           # (di, N) fp32
    y, h_final = _mamba_chunk_scan(dt, bm, cm, xc, A)
    y = y + p["D"][None, None] * xc.to(F32)
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    if return_state:
        return out, (xc_pre[:, -(cfg.ssm.d_conv - 1):].clone(), h_final)
    return out


def mamba_decode(x_t: torch.Tensor, p, cfg: ModelConfig,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One token.  x_t: (B, 1, d); conv_state (B, K-1, d_inner); ssm_state
    (B, d_inner, N) fp32.  Returns (y (B, 1, d), the new conv_state, the
    new ssm_state) as fresh tensors; the state update is elementwise (no
    K12c launch)."""
    exact_fp32()
    xz = torch.einsum("bsd,dk->bsk", x_t, p["in_proj"])[:, 0]
    xc, z = xz.chunk(2, dim=-1)
    xc, conv_state = conv1d_step(xc, conv_state, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.to(F32)).to(x_t.dtype)
    dt, bm, cm = _mamba_abc(xc[:, None], p, cfg)
    dt, bm, cm = dt[:, 0], bm[:, 0], cm[:, 0]           # (B,di), (B,N)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A[None])              # (B, di, N)
    b = (dt * xc.to(F32))[..., None] * bm.to(F32)[:, None, :]
    ssm_state = a * ssm_state + b
    y = torch.einsum("bdn,bn->bd", ssm_state, cm.to(F32))
    y = y + p["D"][None] * xc.to(F32)
    y = (y * F.silu(z.to(F32))).to(x_t.dtype)
    out = torch.einsum("bk,kd->bd", y, p["out_proj"])[:, None]
    return out, conv_state, ssm_state


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
