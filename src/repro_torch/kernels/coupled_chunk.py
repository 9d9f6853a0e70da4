"""K1: the site-coupled chunk step of the trace-scan engine.

`coupled_chunk` advances the lanes of capped fleet groups by one chunk of
C slots in a dense ``(G, Lp, ...)`` layout (group, lane in group): per
slot, the progress-bucket interpolation of the pre-gathered decision
rows (hat weights over the B bucket centers), the shared rate model, the
group sums of the active lanes' base and average draw, `iters` damped
`model.site_throttle` steps each re-evaluating the rates at the new
factor, `dt = min(slot length, remaining / throughput)`, the kWh /
CO2-per-member / cost sums and the running site peak.  It is the
counterpart of the reference's Pallas kernel
(src/repro/kernels/coupled_throttle.py, `coupled_chunk`), with the same
signature.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/coupled_chunk.cu: lanes in threads, group sums by warp shuffles,
the throttle's fixed point left at its exact stop, `launch_plan` threads
a block) and counts the launch in `launches`; `step_histogram` launches
the same kernel counting the throttle steps it took.  On a CPU tensor it
runs
`coupled_chunk_plain`, the same function as a Python slot loop of tensor
ops.  Any other device raises.

Padded lanes must carry remaining 0, n_scen 1, alpha 1 and padded groups
an infinite cap.  Dtypes as for `scan_chunk`: compute dtype for rows,
series, caps, office draw and scalars; float64 state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import model
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

#: most lanes one group may have (one CUDA block of threads)
MAX_GROUP_LANES = 1024


def launch_plan(G: int, Lp: int, sms: int) -> tuple:
    """(threads a block, blocks, groups a warp) of the kernel's launch for
    G groups of Lp lanes on a card of `sms` SMs, the rule of
    csrc/coupled_chunk.cu::plan: above 32 lanes a group, one block of Lp
    threads a group; else the fewest groups a warp (a power of two, at
    most 32 / Lp) that keep the warps at 8 an SM or fewer, in blocks of
    one warp below 4 warps an SM and of four from there."""
    if Lp > 32:
        return Lp, G, 1
    gpw = 1
    while gpw < 32 // Lp and G > 8 * sms * gpw:
        gpw *= 2
    warps = -(-G // gpw)
    threads = 128 if warps >= 4 * sms else 32
    return threads, -(-warps * 32 // threads), gpw


def coupled_chunk_plain(u_rows, b_rows, bg, cf, pr, lens, cap_g, office,
                        remaining, rt, kwh, co2, cost, speak,
                        n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac,
                        *, iters: int, finish_frac: float):
    """One coupled chunk as a Python slot loop of tensor ops (any device);
    the plain version the kernel is held against.  Mirrors the Pallas
    body: the group axis is batched, sums run over the lane axis."""
    G, Lp, C, B = u_rows.shape
    cdt = u_rows.dtype
    centers = torch.arange(B, dtype=cdt, device=u_rows.device)
    T = model.TORCH
    cap = cap_g[:, None]
    for t in range(C):
        prog = (1.0 - remaining / n_scen).to(cdt)
        if B == 1:
            u = u_rows[:, :, t, 0]
            bt = b_rows[:, :, t, 0]
        else:
            x = torch.clamp(prog * B - 0.5, 0.0, B - 1.0)
            w = torch.clamp_min(1.0 - torch.abs(x[..., None] - centers), 0.0)
            u = torch.sum(u_rows[:, :, t, :] * w, dim=-1)
            bt = torch.sum(b_rows[:, :, t, :] * w, dim=-1)
        bg_t = bg[:, :, t]
        r = model.rates(u, bt, bg_t, rate_at_full=rate,
                        batch_overhead_s=oh, idle_w=idle, dyn_w=dyn,
                        alpha=alpha, gamma=gamma, overhead_w_frac=ohfrac,
                        xp=T)
        active = remaining > finish_frac * n_scen
        zero = torch.zeros((), dtype=cdt, device=u.device)
        base = torch.sum(torch.where(
            active, model.power_w(bg_t, idle, dyn, alpha, xp=T), zero)
            / 1000.0, dim=1, keepdim=True)
        off_t = office[:, t:t + 1]
        head = cap - off_t
        f = torch.ones((G, 1), dtype=cdt, device=u.device)
        r2 = r
        for _ in range(iters):
            draw = torch.sum(torch.where(active, r2.p_avg_w, zero) / 1000.0,
                             dim=1, keepdim=True)
            f = model.site_throttle(draw, base, head, f, xp=T)
            r2 = model.rates(u * f, bt, bg_t, rate_at_full=rate,
                             batch_overhead_s=oh, idle_w=idle, dyn_w=dyn,
                             alpha=alpha, gamma=gamma,
                             overhead_w_frac=ohfrac, xp=T)
        dt = torch.where(
            remaining > 0.0,
            torch.minimum(lens[:, :, t],
                          remaining / torch.clamp_min(r2.scen_per_s, 1e-30)),
            0.0)
        e = r2.kwh_per_s * dt
        site_kw = torch.sum(torch.where(active, r2.p_avg_w, zero) / 1000.0,
                            dim=1, keepdim=True) + off_t
        speak = torch.where(active, torch.maximum(speak, site_kw), speak)
        remaining = remaining - r2.scen_per_s * dt
        rt = rt + dt
        kwh = kwh + e
        co2 = co2 + e[..., None] * cf[:, :, :, t]
        cost = cost + e * pr[:, :, t]
    return remaining, rt, kwh, co2, cost, speak


def _check(args, cdt, G, Lp, C, B, E):
    (u_rows, b_rows, bg, cf, pr, lens, cap_g, office) = args[:8]
    shapes = [((G, Lp, C, B), cdt)] * 2 + [((G, Lp, C), cdt)] \
        + [((G, Lp, E, C), cdt)] + [((G, Lp, C), cdt)] * 2 \
        + [((G,), cdt), ((G, C), cdt)] \
        + [((G, Lp), torch.float64)] * 3 + [((G, Lp, E), torch.float64)] \
        + [((G, Lp), torch.float64)] * 2 + [((G, Lp), cdt)] * 8
    for x, (shape, dtype) in zip(args, shapes):
        if x.device != u_rows.device:
            raise ValueError("coupled_chunk inputs must all be on one device")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"coupled_chunk input of shape "
                             f"{tuple(x.shape)} {x.dtype}, expected {shape} "
                             f"{dtype}")
        if not x.is_contiguous():
            raise ValueError("coupled_chunk inputs must be contiguous")
    if Lp & (Lp - 1) or not 1 <= Lp <= MAX_GROUP_LANES:
        raise ValueError(f"coupled_chunk needs a power-of-two lane count per "
                         f"group up to {MAX_GROUP_LANES}, got {Lp}")


def coupled_chunk(u_rows, b_rows, bg, cf, pr, lens, cap_g, office,
                  remaining, rt, kwh, co2, cost, speak,
                  n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac,
                  *, iters: int, finish_frac: float):
    """One coupled chunk over the dense layout: `u_rows`/`b_rows`
    (G, Lp, C, B), `bg`/`pr`/`lens` (G, Lp, C), `cf` (G, Lp, E, C),
    `cap_g` (G,), `office` (G, C), state (G, Lp) float64 (`co2`
    (G, Lp, E)), eight per-lane scalars (G, Lp).  Returns the six state
    tensors after C slots (new tensors; the inputs are not modified)."""
    args = (u_rows, b_rows, bg, cf, pr, lens, cap_g, office,
            remaining, rt, kwh, co2, cost, speak,
            n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac)
    if u_rows.device.type == "cpu":
        return coupled_chunk_plain(*args, iters=iters,
                                   finish_frac=finish_frac)
    return _launch(args, iters, finish_frac)


def step_histogram(u_rows, b_rows, bg, cf, pr, lens, cap_g, office,
                   remaining, rt, kwh, co2, cost, speak,
                   n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac,
                   *, iters: int, finish_frac: float) -> list:
    """Launch the kernel on CUDA tensors (counted in `launches`) and
    return how many (group, slot) pairs with a lane running took 0, 1,
    ..., `iters` throttle steps past the slot's first operating point
    before the fixed point stopped; the outputs are dropped."""
    if u_rows.device.type != "cuda":
        raise RuntimeError("step_histogram counts the CUDA kernel's steps")
    hist = torch.zeros(int(iters) + 1, dtype=torch.int32,
                       device=u_rows.device)
    _launch((u_rows, b_rows, bg, cf, pr, lens, cap_g, office,
             remaining, rt, kwh, co2, cost, speak,
             n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac),
            iters, finish_frac, hist)
    return hist.tolist()


def _launch(args, iters, finish_frac, hist=None):
    """Check the inputs, launch the kernel (with `hist`, the instance that
    counts throttle steps into it) and count the launch."""
    u_rows, cf = args[0], args[3]
    if u_rows.device.type != "cuda":
        raise RuntimeError(f"coupled_chunk runs on CUDA or CPU tensors, not "
                           f"{u_rows.device}")
    G, Lp, C, B = u_rows.shape
    E = cf.shape[2]
    cdt = u_rows.dtype
    if cdt not in (torch.float64, torch.float32):
        raise TypeError(f"coupled_chunk computes in float64 or float32, got "
                        f"{cdt}")
    _check(args, cdt, G, Lp, C, B, E)
    out = tuple(torch.empty_like(s) for s in args[8:14])
    if G == 0:
        return out
    lib = _library()
    f64 = cdt == torch.float64
    if hist is None:
        fn, extra = (lib.coupled_chunk_f64 if f64
                     else lib.coupled_chunk_f32), ()
    else:
        fn, extra = (lib.coupled_chunk_steps_f64 if f64
                     else lib.coupled_chunk_steps_f32), (hist.data_ptr(),)
    with torch.cuda.device(u_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in args + out), G, Lp, C, B, E,
                 int(iters), float(finish_frac), *extra, stream)
    if err:
        raise RuntimeError(f"coupled_chunk kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out


def device_plan(G: int, Lp: int, dtype: torch.dtype) -> dict:
    """The launch the kernel takes on the current card: threads a block,
    blocks, groups a warp, and the blocks an SM holds (CUDA's occupancy
    API, E = 1, B = 1)."""
    out = (ctypes.c_int * 4)()
    err = _library().coupled_chunk_plan(G, Lp, int(dtype == torch.float64),
                                        out)
    if err:
        raise RuntimeError(f"coupled_chunk_plan failed: CUDA error {err}")
    return dict(zip(("threads", "blocks", "groups_per_warp",
                     "blocks_per_sm"), out))


def _library() -> ctypes.CDLL:
    lib = _build.library("coupled_chunk")
    head = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 6 + [ctypes.c_double]
    for fn in (lib.coupled_chunk_f64, lib.coupled_chunk_f32):
        fn.argtypes = head + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.coupled_chunk_steps_f64, lib.coupled_chunk_steps_f32):
        fn.argtypes = head + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    lib.coupled_chunk_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.coupled_chunk_plan.restype = ctypes.c_int
    return lib
