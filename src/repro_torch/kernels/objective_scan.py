"""K3: the schedule optimizer's single-campaign objective scan.

`TraceObjective.evaluate` (core/engine_torch.py) maps per-slot intensities
(..., n_slots) to the campaign's energy, CO2, runtime, cost and unfinished
fraction by scanning the remaining work over the horizon's T slots; the
reference jits it as one `jax.lax.scan` (`TraceObjective._evaluate_jax`,
src/repro/core/engine_jax.py) and differentiates it with `jax.grad`.

`trace_objective(obj, u_day)` is the objective's one entry:

* on a CUDA tensor it runs `TraceScan`, a `torch.autograd.Function` whose
  forward is one launch of the hand-written forward kernel
  (csrc/objective_scan.cu, `trace_scan_fwd`: a block a member, the
  horizon in tiles of slots (`launch_plan`), every slot's physics in
  parallel, then the tile's chain in slot order) and whose backward is
  one launch of the backward kernel (`trace_scan_bwd`: the tiles in
  reverse from the forward's checkpoint of each slot's starting remaining
  work, the adjoint of remaining carried back through each tile between
  two parallel passes over its slots);
* on a CPU tensor it runs `trace_objective_plain`, the objective as plain
  tensor ops (`trace_scan_fwd_plain`: the per-slot physics of all T slots
  at once, then `work_scan`'s slot loop over the remaining work),
  differentiated by `torch.autograd`;
* any other device raises.

Each launch wrapper has its plain version beside it (`trace_scan_fwd_plain`,
and `trace_scan_bwd_plain`, its vector-Jacobian product by
`torch.autograd`); a wrapper takes it for a CPU tensor, and counts its
kernel launches in `fwd_launches` / `bwd_launches` on a CUDA tensor.

Dtypes: `u_day` is fp64 at the kernels (the Function casts); the series
are the objective's compute dtype (float64, or float32 for
`precision="mixed"`: fp32 physics, fp64 carried state and sums); the
outputs and the gradient are fp64; `rowidx` is int32 at the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import model
from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
fwd_launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


#: most slots a tile (threads a block) of both kernels
TILE_MAX = 256


def launch_plan(N: int, T: int) -> dict:
    """The kernels' launch for N members over T slots, the rule of
    csrc/objective_scan.cu::plan: a block a member, a thread a slot of a
    tile, tiles of at most `TILE_MAX` slots made as even as whole warps
    leave them (so T = 280 runs as two tiles of 160 slots, not 256 and
    24).  Dynamic shared bytes: the forward's six doubles a slot, the
    backward's three doubles, a day bin (int32) and a finish flag a
    slot."""
    T1 = max(T, 1)
    tiles = -(-T1 // TILE_MAX)
    W = -(-(-(-T1 // tiles)) // 32) * 32
    return dict(blocks=N, threads=W, slots=W, tiles=-(-T // W),
                smem_fwd=48 * W, smem_bwd=29 * W)


# ---------------------------------------------------------------------------
# The objective
# ---------------------------------------------------------------------------
def trace_objective(obj, u_day: torch.Tensor):
    """`EvalMetrics` of the `TraceObjective` `obj` at intensities `u_day`
    (..., n_slots): the kernels' `TraceScan` on a CUDA tensor, the plain
    version on a CPU tensor; any other device raises."""
    if u_day.device.type == "cuda":
        return trace_objective_scan(obj, u_day)
    if u_day.device.type == "cpu":
        return trace_objective_plain(obj, u_day)
    raise RuntimeError(f"trace_objective runs on CUDA or CPU tensors, not "
                       f"{u_day.device}")


def work_scan(remaining: torch.Tensor, scen_per_s: torch.Tensor,
              lens: torch.Tensor):
    """The slot-by-slot scan of the remaining work, the plain objectives'
    one sequential part: from `remaining` (...), under the per-slot rates
    `scen_per_s` (T, ...) and slot lengths `lens` (T,), the seconds each
    slot ran (T, ...), the remaining work at each slot's start (T, ...),
    and the final remaining.
    """
    scen = model.TORCH.maximum(scen_per_s, 1e-30)
    work = scen * lens.reshape((-1,) + (1,) * (scen.dim() - 1))
    zero = remaining.new_zeros(())
    dts, starts = [], []
    # per-slot views by `unbind`: one autograd node for all T slots
    # (indexing slot by slot adds T, each a full-size zero tensor in the
    # backward); the slot lengths as 0-d tensors, since a Python number in
    # `where` costs a launch a slot to make its tensor on the card
    for ln, w_t, s_t, sps_t in zip(lens.unbind(0), work.unbind(0),
                                   scen.unbind(0), scen_per_s.unbind(0)):
        starts.append(remaining)
        # strict branch selection, NOT a minimum(ln, remaining/scen): when
        # the campaign finishes exactly on a slot boundary, the minimum's
        # tie splits its gradient across both branches and the analytic
        # cancellation d(remaining - scen*dt)/du == 0 of the finish branch
        # is lost.  The tie takes the finish branch.
        dt = torch.where(remaining > w_t, ln, remaining / s_t)
        dt = torch.where(remaining > 0.0, dt, zero)
        remaining = remaining - sps_t * dt
        dts.append(dt)
    return torch.stack(dts), torch.stack(starts), remaining


def trace_objective_plain(obj, u_day: torch.Tensor):
    """The objective as plain tensor ops on any device, differentiable by
    `torch.autograd` (`trace_scan_fwd_plain`), in the leading shape of
    `u_day`."""
    *tables, scal = scan_inputs(obj, u_day.device)
    return _metrics(trace_scan_fwd_plain(u_day.reshape(-1, u_day.shape[-1]),
                                         *tables, scal), u_day.shape[:-1])


def _metrics(outs, shape):
    from repro_torch.core.engine_torch import EvalMetrics
    kwh, co2, rt, cost, unf = outs[:5]
    return EvalMetrics(kwh.reshape(shape), co2.reshape(shape + co2.shape[1:]),
                       rt.reshape(shape), cost.reshape(shape),
                       unf.reshape(shape))


def scan_inputs(obj, device: torch.device) -> tuple:
    """The kernels' inputs of `obj` on `device`, built once: rowidx
    (int32), bg, cf ((T,) or (T, E), contiguous), pr, lens, and the nine
    scalars (n_scen, the seven physics scalars, the batch size)."""
    key = (device, "scan")
    if key not in obj._tables:
        rowidx, bg, cf, pr, lens = obj._device_tables(device)
        obj._tables[key] = (rowidx.to(torch.int32), bg, cf.contiguous(), pr,
                            lens, tuple(obj._scalars) + (obj.batch_size,))
    return obj._tables[key]


def trace_objective_scan(obj, u_day: torch.Tensor):
    """The objective through `TraceScan` (the two kernels on a CUDA
    tensor, their plain versions on a CPU tensor), in the leading shape of
    `u_day`."""
    u = u_day.to(torch.float64).reshape(-1, u_day.shape[-1]).contiguous()
    *tables, scal = scan_inputs(obj, u.device)
    return _metrics(TraceScan.apply(u, *tables, scal), u_day.shape[:-1])


class TraceScan(torch.autograd.Function):
    """The objective's scan over a flat population `u` (N, S) fp64: the
    forward launch, and the backward launch from the forward's checkpoint
    of each slot's starting remaining work (kept only when `u` needs a
    gradient).  Outputs (kWh, CO2, runtime h, cost, unfinished), each
    (N,) but CO2 (N, E) for an ensemble.  Gradients left out downstream
    reach the backward as zeros (null pointers)."""

    @staticmethod
    def forward(ctx, u, rowidx, bg, cf, pr, lens, scal):
        keep = ctx.needs_input_grad[0]
        *outs, hist = trace_scan_fwd(u, rowidx, bg, cf, pr, lens, scal,
                                     keep=keep)
        if keep:
            ctx.save_for_backward(u, rowidx, bg, cf, pr, lens, hist)
            ctx.scal = scal
        ctx.set_materialize_grads(False)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * 7
        u, rowidx, bg, cf, pr, lens, hist = ctx.saved_tensors
        g_u = trace_scan_bwd(u, rowidx, bg, cf, pr, lens, ctx.scal, hist,
                             grads)
        return (g_u,) + (None,) * 6


# ---------------------------------------------------------------------------
# The two launches and their plain versions
# ---------------------------------------------------------------------------
def trace_scan_fwd_plain(u, rowidx, bg, cf, pr, lens, scal, *,
                         keep: bool = False):
    """The forward kernel's function in PyTorch: (kWh, CO2, runtime h,
    cost, unfinished, each slot's starting remaining (T, N) or None).
    The physics of all T slots at once (it does not depend on the carried
    state), then `work_scan`; mixed policy: `u` cast to the series' fp32
    physics, the carried state and the sums in fp64 (the engine's
    `_plan_dtypes` split)."""
    n_scen, *_, batch = scal
    ut = u.to(bg.dtype)[:, rowidx.long()].T                   # (T, N)
    r = model.rates(ut, batch, bg[:, None], xp=model.TORCH,
                    **_scalar_physics(scal))
    dt, starts, remaining = work_scan(
        torch.full(u.shape[:1], n_scen, dtype=torch.float64,
                   device=u.device), r.scen_per_s, lens)
    e = r.kwh_per_s * dt
    if cf.dim() == 2:
        co2 = (e[..., None] * cf[:, None]).sum(0)
    else:
        co2 = (e * cf[:, None]).sum(0)
    return (e.sum(0), co2, dt.sum(0) / 3600.0, (e * pr[:, None]).sum(0),
            remaining / n_scen, starts.detach() if keep else None)


def trace_scan_bwd_plain(u, rowidx, bg, cf, pr, lens, scal, hist, grads):
    """The backward kernel's function in PyTorch: d/du (N, S) fp64 of the
    outputs weighted by `grads` (kWh, CO2, runtime h, cost, unfinished;
    None is zero), by `torch.autograd` through `trace_scan_fwd_plain`
    (which recomputes what the kernel reads from the checkpoint
    `hist`)."""
    return vjp(lambda x: trace_scan_fwd_plain(x, rowidx, bg, cf, pr, lens,
                                              scal)[:5], u, grads)


def vjp(fn, u, grads):
    """d/du of the sum of each output of `fn(u)` times its gradient in
    `grads` (None: no gradient), by `torch.autograd`."""
    with torch.enable_grad():
        x = u.detach().requires_grad_()
        pairs = [(o, g) for o, g in zip(fn(x), grads) if g is not None]
        g_u = torch.autograd.grad([o for o, _ in pairs],
                                  x, [g for _, g in pairs],
                                  allow_unused=True)[0] if pairs else None
    return torch.zeros_like(u) if g_u is None else g_u


def _scalar_physics(scal) -> dict:
    _, rate, oh, idle, dyn, alpha, gamma, ohf, _ = scal
    return dict(rate_at_full=rate, batch_overhead_s=oh, idle_w=idle,
                dyn_w=dyn, alpha=alpha, gamma=gamma, overhead_w_frac=ohf)


def _check(u, rowidx, bg, cf, pr, lens, hist=None, grads=()):
    N, S = u.shape
    T = rowidx.shape[0]
    cdt = bg.dtype
    if cdt not in (torch.float64, torch.float32):
        raise TypeError(f"trace_scan computes in float64 or float32, got "
                        f"{cdt}")
    EC = 1 if cf.dim() == 1 else cf.shape[1]
    want = [(u, (N, S), torch.float64), (rowidx, (T,), torch.int32),
            (bg, (T,), cdt), (cf, (T,) if cf.dim() == 1 else (T, EC), cdt),
            (pr, (T,), cdt), (lens, (T,), cdt)]
    if hist is not None:
        want.append((hist, (T, N), torch.float64))
    shapes = [(N,), (N,) if cf.dim() == 1 else (N, EC), (N,), (N,), (N,)]
    want += [(g, shape, torch.float64) for g, shape in zip(grads, shapes)
             if g is not None]
    for x, shape, dtype in want:
        if x.device != u.device:
            raise ValueError("trace_scan inputs must all be on one device")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"trace_scan input of shape {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError("trace_scan inputs must be contiguous")
    return N, S, T, EC


def _device(u, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (the plain
    version); any other device raises."""
    if u.device.type == "cuda":
        return True
    if u.device.type == "cpu":
        return False
    raise RuntimeError(f"{name} runs on CUDA or CPU tensors, not {u.device}")


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def trace_scan_fwd(u, rowidx, bg, cf, pr, lens, scal, *, keep: bool = False):
    """The forward launch: `u` (N, S) fp64, `rowidx` (T,) int32, `bg`,
    `pr`, `lens` (T,) and `cf` (T,) or (T, E) in the compute dtype, `scal`
    the nine scalars.  Returns (kWh, CO2, runtime h, cost, unfinished,
    each slot's starting remaining (T, N) when `keep`, else None)."""
    if not _device(u, "trace_scan_fwd"):
        return trace_scan_fwd_plain(u, rowidx, bg, cf, pr, lens, scal,
                                    keep=keep)
    N, S, T, EC = _check(u, rowidx, bg, cf, pr, lens)
    f64 = dict(dtype=torch.float64, device=u.device)
    kwh, rt, cost, unf = (torch.empty(N, **f64) for _ in range(4))
    co2 = torch.empty((N,) if cf.dim() == 1 else (N, EC), **f64)
    hist = torch.empty(T, N, **f64) if keep else None
    if N == 0:
        return kwh, co2, rt, cost, unf, hist
    lib = _library()
    fn = (lib.trace_scan_fwd_f64 if bg.dtype == torch.float64
          else lib.trace_scan_fwd_f32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(_ptr(x) for x in (u, rowidx, bg, cf, pr, lens)),
                 (ctypes.c_double * 9)(*scal),
                 *(_ptr(x) for x in (kwh, co2, rt, cost, unf, hist)),
                 N, S, T, EC, stream)
    if err:
        raise RuntimeError(f"trace_scan_fwd kernel launch failed: CUDA "
                           f"error {err}")
    global fwd_launches
    fwd_launches += 1
    return kwh, co2, rt, cost, unf, hist


def trace_scan_bwd(u, rowidx, bg, cf, pr, lens, scal, hist, grads):
    """The backward launch: d/du (N, S) fp64 of the forward's outputs
    weighted by `grads` (five tensors of the outputs' shapes, or None)."""
    if not _device(u, "trace_scan_bwd"):
        return trace_scan_bwd_plain(u, rowidx, bg, cf, pr, lens, scal, hist,
                                    grads)
    grads = tuple(None if g is None else g.contiguous() for g in grads)
    N, S, T, EC = _check(u, rowidx, bg, cf, pr, lens, hist, grads)
    g_u = torch.zeros(N, S, dtype=torch.float64, device=u.device)
    if N == 0:
        return g_u
    lib = _library()
    fn = (lib.trace_scan_bwd_f64 if bg.dtype == torch.float64
          else lib.trace_scan_bwd_f32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(_ptr(x) for x in (u, rowidx, bg, cf, pr, lens)),
                 (ctypes.c_double * 9)(*scal),
                 *(_ptr(x) for x in (hist,) + grads + (g_u,)),
                 N, S, T, EC, stream)
    if err:
        raise RuntimeError(f"trace_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    global bwd_launches
    bwd_launches += 1
    return g_u


def device_plan(T: int, bwd: bool, dtype: torch.dtype) -> dict:
    """The launch the forward (or backward) kernel takes on the current
    card over T slots with `dtype` physics: threads a block, dynamic shared
    bytes, and the blocks an SM holds (CUDA's occupancy API)."""
    out = (ctypes.c_int * 3)()
    err = _library().trace_scan_plan(T, int(bwd), int(dtype == torch.float64),
                                     out)
    if err:
        raise RuntimeError(f"trace_scan_plan failed: CUDA error {err}")
    return dict(zip(("threads", "smem", "blocks_per_sm"), out))


def _library() -> ctypes.CDLL:
    lib = _build.library("objective_scan")
    dbl = ctypes.POINTER(ctypes.c_double)
    for fn in (lib.trace_scan_fwd_f64, lib.trace_scan_fwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [dbl] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.trace_scan_bwd_f64, lib.trace_scan_bwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [dbl] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.trace_scan_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.trace_scan_plan.restype = ctypes.c_int
    return lib
