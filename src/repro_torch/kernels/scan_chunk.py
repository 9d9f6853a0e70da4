"""K2: the uncoupled chunk step of the trace-scan engine.

`scan_chunk` advances the scan state of A independent lanes by one chunk
of C slots: per slot, the decision row `rowidx[:, t]` of each lane's
(R, B) tables is read at the lane's live progress (two-point bucket
interpolation), the shared rate model (core/model.py) gives throughput
and power, and `dt = min(slot length, remaining / throughput)` advances
remaining work, runtime and the kWh / CO2-per-member / cost sums.  It is
the counterpart of the reference's `_scan_chunk_jax_impl`
(src/repro/core/engine_jax.py), which XLA compiles from a `lax.scan`.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/scan_chunk.cu: one thread per lane, the slot loop inside, the
series staged through shared memory in tiles of 64 bytes a lane, 8 fp64
or 16 fp32 slots; `launch_plan` lanes a block) and counts the launch in
`launches`; on a CPU tensor it runs
`scan_chunk_plain`, the same function as a Python slot loop of tensor
ops.  Any other device raises.

Dtypes: tables, series and per-lane physics scalars share the compute
dtype (float64, or float32 for `precision="mixed"`); the carried state
is always float64; `rowidx` is int32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import model
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0


def launch_plan(A: int, sms: int) -> tuple:
    """(threads a block, blocks) of the kernel's launch for A lanes on a
    card of `sms` SMs, the rule of csrc/scan_chunk.cu::plan_threads: a
    block's lanes are one contiguous region of every lane-major array,
    128 of them, or 64 or 32 where 128 would leave SMs without a block."""
    threads = next((t for t in (128, 64) if -(-A // t) >= sms), 32)
    return threads, -(-A // threads)


def _bucket_lookup(u_tab, b_tab, sidx, row, prog, B: int):
    """The reference's two-point progress interpolation between the two
    nearest bucket centers (tables are sampled at (b + 0.5) / B)."""
    if B == 1:
        return u_tab[sidx, row, 0], b_tab[sidx, row, 0]
    x = prog * B - 0.5
    b0 = torch.clamp(torch.floor(x), 0, B - 2).to(torch.int64)
    w = torch.clamp(x - b0, 0.0, 1.0)
    u = (1.0 - w) * u_tab[sidx, row, b0] + w * u_tab[sidx, row, b0 + 1]
    bt = (1.0 - w) * b_tab[sidx, row, b0] + w * b_tab[sidx, row, b0 + 1]
    return u, bt


def scan_chunk_plain(u_tab, b_tab, rowidx, bg, cf, pr, lens,
                     remaining, rt, kwh, co2, cost,
                     n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac,
                     *, B: int):
    """One chunk as a Python slot loop of tensor ops (any device); the
    plain version the kernel is held against."""
    A, C = rowidx.shape
    sidx = torch.arange(A, device=u_tab.device)
    rows = rowidx.to(torch.int64)
    cdt = u_tab.dtype
    for t in range(C):
        # mixed precision: lookup and rates at the tables' dtype, the
        # carried state stays fp64 (no-op cast on fp64 plans)
        prog = (1.0 - remaining / n_scen).to(cdt)
        u, bt = _bucket_lookup(u_tab, b_tab, sidx, rows[:, t], prog, B)
        r = model.rates(u, bt, bg[:, t], rate_at_full=rate,
                        batch_overhead_s=oh, idle_w=idle, dyn_w=dyn,
                        alpha=alpha, gamma=gamma, overhead_w_frac=ohfrac,
                        xp=model.TORCH)
        dt = torch.where(
            remaining > 0.0,
            torch.minimum(lens[:, t],
                          remaining / torch.clamp_min(r.scen_per_s, 1e-30)),
            0.0)
        e = r.kwh_per_s * dt
        remaining = remaining - r.scen_per_s * dt
        rt = rt + dt
        kwh = kwh + e
        co2 = co2 + e[:, None] * cf[:, :, t]
        cost = cost + e * pr[:, t]
    return remaining, rt, kwh, co2, cost


def _check(u_tab, b_tab, rowidx, bg, cf, pr, lens, state, scalars, B):
    A, R, Bt = u_tab.shape
    C = rowidx.shape[1]
    E = cf.shape[1]
    cdt = u_tab.dtype
    if cdt not in (torch.float64, torch.float32):
        raise TypeError(f"scan_chunk computes in float64 or float32, got {cdt}")
    if Bt != B:
        raise ValueError(f"B={B} but the tables have {Bt} buckets")
    want = [(b_tab, (A, R, Bt), cdt), (rowidx, (A, C), torch.int32),
            (bg, (A, C), cdt), (cf, (A, E, C), cdt), (pr, (A, C), cdt),
            (lens, (A, C), cdt)]
    want += [(s, (A, E) if i == 3 else (A,), torch.float64)
             for i, s in enumerate(state)]
    want += [(s, (A,), cdt) for s in scalars]
    for x, shape, dtype in [(u_tab, (A, R, Bt), cdt)] + want:
        if x.device != u_tab.device:
            raise ValueError("scan_chunk inputs must all be on one device")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"scan_chunk input of shape {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError("scan_chunk inputs must be contiguous")
    return A, R, C, E


def scan_chunk(u_tab, b_tab, rowidx, bg, cf, pr, lens,
               remaining, rt, kwh, co2, cost,
               n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac,
               *, B: int):
    """One uncoupled chunk: `u_tab`/`b_tab` (A, R, B), `rowidx` (A, C)
    int32, `bg`/`pr`/`lens` (A, C), `cf` (A, E, C), state (A,) float64
    (`co2` (A, E)), eight per-lane scalars (A,).  Returns the five state
    tensors after C slots (new tensors; the inputs are not modified)."""
    args = (u_tab, b_tab, rowidx, bg, cf, pr, lens,
            remaining, rt, kwh, co2, cost,
            n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac)
    if u_tab.device.type == "cpu":
        return scan_chunk_plain(*args, B=B)
    if u_tab.device.type != "cuda":
        raise RuntimeError(f"scan_chunk runs on CUDA or CPU tensors, not "
                           f"{u_tab.device}")
    state = (remaining, rt, kwh, co2, cost)
    scalars = (n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac)
    A, R, C, E = _check(u_tab, b_tab, rowidx, bg, cf, pr, lens, state,
                        scalars, B)
    out = tuple(torch.empty_like(s) for s in state)
    if A == 0:
        return out
    lib = _library()
    fn = (lib.scan_chunk_f64 if u_tab.dtype == torch.float64
          else lib.scan_chunk_f32)
    with torch.cuda.device(u_tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in args + out), A, R, B, C, E, stream)
    if err:
        raise RuntimeError(f"scan_chunk kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out


def device_plan(A: int, E: int, dtype: torch.dtype) -> dict:
    """The launch the kernel takes on the current card for A lanes and E
    carbon members: threads a block, blocks, dynamic shared memory bytes,
    and the blocks an SM holds (CUDA's occupancy API)."""
    out = (ctypes.c_int * 4)()
    err = _library().scan_chunk_plan(A, E, int(dtype == torch.float64), out)
    if err:
        raise RuntimeError(f"scan_chunk_plan failed: CUDA error {err}")
    return dict(zip(("threads", "blocks", "smem", "blocks_per_sm"), out))


def _library() -> ctypes.CDLL:
    lib = _build.library("scan_chunk")
    for fn in (lib.scan_chunk_f64, lib.scan_chunk_f32):
        fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.scan_chunk_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.scan_chunk_plan.restype = ctypes.c_int
    return lib
