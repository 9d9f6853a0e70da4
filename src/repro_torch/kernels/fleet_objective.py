"""K4: the schedule optimizer's site-coupled fleet objective scan.

`FleetTraceObjective.evaluate` (core/engine_torch.py) maps a joint
intensity block (..., M, n_slots) to each campaign's energy, CO2, runtime,
cost and unfinished fraction and the site's peak draw, scanning M
campaigns that share one site power envelope slot by slot; the reference
jits it as one `jax.lax.scan` over `FleetTraceObjective._step`
(src/repro/core/engine_jax.py) and differentiates it with `jax.grad`.

`fleet_objective(obj, u)` is the objective's one entry:

* on a CUDA tensor it runs `FleetScan`, a `torch.autograd.Function` whose
  forward is one launch of the hand-written forward kernel
  (csrc/fleet_objective.cu, `fleet_scan_fwd`: up to 128 campaigns a block
  a member, the horizon in tiles of slots (`launch_plan`), every slot's
  throttle solve in parallel under the activity mask at the tile's
  start, then the tile's chain in slot order, which reruns the solve from
  a slot where a capped campaign's activity turns off, so the mask is
  exact; past 128 campaigns a warp a member over the slots in order)
  and whose backward is one launch of the backward kernel
  (`fleet_scan_bwd`: the tiles in reverse from the forward's checkpoints
  of each slot's starting remaining work and site peak, the adjoints of
  remaining and of the peak carried back through each tile between two
  parallel passes over its slots);
* on a CPU tensor it runs `fleet_objective_plain`: the throttle solve of
  every slot at once under an assumed activity mask (`throttle_plain`),
  a slot loop over the remaining work (`pass_plain`), repeated until the
  mask holds, differentiated by `torch.autograd`;
* any other device raises.

Each launch wrapper has its plain version beside it (`fleet_scan_fwd_plain`,
the forward kernel's slot loop in PyTorch, and `fleet_scan_bwd_plain`,
its vector-Jacobian product by `torch.autograd`); a wrapper takes it for
a CPU tensor and counts its kernel launches in `fwd_launches` /
`bwd_launches` on a CUDA tensor.  Everything is fp64:
neither package has a mixed-precision fleet objective.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import model
from repro_torch.kernels import _build
from repro_torch.kernels.objective_scan import _device, _ptr, vjp, work_scan

#: kernel launches on CUDA tensors since import (or the last reset)
fwd_launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


#: campaigns a member of the tile kernels (past that the streaming ones)
M_TILES = 128


def launch_plan(N: int, M: int, T: int) -> dict:
    """The tile kernels' launch for N members of M campaigns (1..128)
    over T slots, the rule of csrc/fleet_objective.cu::plan: a block a
    member; a group of `group` threads a slot of a tile, the campaigns
    inside the thread (M <= 2: a thread a slot, tiles of at most 256
    slots, whole warps) or on a warp's lanes (8 warps, tiles of at most 64
    slots, in multiples of 8); the tiles as even as that rounding leaves
    them.  Group g of a tile takes its slots g, g + threads / group, ...
    Dynamic shared bytes: the nine campaign scalars (the backward also
    the four output gradients) a campaign; the forward's four series and
    site draw a slot, three rates and an activity flag a slot and
    campaign, its mask and stop slot; the backward's twelve doubles of
    the throttle solve, the site draw and the peak a slot, a day bin
    (int32) and an event flag a slot, and two doubles and a finish flag a
    slot and campaign."""
    if not 1 <= M <= M_TILES:
        raise ValueError(f"the tile kernels take 1 to {M_TILES} campaigns, "
                         f"not {M}")
    T1 = max(T, 1)
    group = 1 if M <= 2 else 32
    cap, rnd = (256, 32) if group == 1 else (64, 8)
    tiles = -(-T1 // cap)
    W = -(-(-(-T1 // tiles)) // rnd) * rnd
    return dict(blocks=N, threads=W if group == 1 else 256, slots=W,
                group=group, tiles=-(-T // W),
                smem_fwd=(8 * (9 * M + 5 * W + 3 * W * M) + -(-W * M // 8) * 8
                          + -(-M // 8) * 8 + 8),
                smem_bwd=(8 * (13 * M + 12 * W + 2 * W * M) + 4 * W
                          + -(-W * M // 8) * 8 + -(-W // 8) * 8))


def device_plan(M: int, T: int, bwd: bool) -> dict:
    """The launch the forward (or backward) tile kernel takes on the
    current card: threads a block, slots a tile, threads a slot's group,
    dynamic shared bytes, and the blocks an SM holds (CUDA's occupancy
    API)."""
    out = (ctypes.c_int * 5)()
    err = _library().fleet_scan_plan(M, T, int(bwd), out)
    if err:
        raise RuntimeError(f"fleet_scan_plan failed: CUDA error {err}")
    return dict(zip(("threads", "slots", "group", "smem", "blocks_per_sm"),
                    out))


# ---------------------------------------------------------------------------
# The objective
# ---------------------------------------------------------------------------
def fleet_objective(obj, u: torch.Tensor):
    """`FleetEvalMetrics` of the `FleetTraceObjective` `obj` at the joint
    intensities `u` (..., M, n_slots): the kernels' `FleetScan` on a CUDA
    tensor, the plain version on a CPU tensor; any other device raises."""
    if u.device.type == "cuda":
        return fleet_objective_scan(obj, u)
    if u.device.type == "cpu":
        return fleet_objective_plain(obj, u)
    raise RuntimeError(f"fleet_objective runs on CUDA or CPU tensors, not "
                       f"{u.device}")


def fleet_objective_plain(obj, u: torch.Tensor):
    """The coupled scan as plain tensor ops, with the throttle solve of
    every slot run at once.

    A slot's throttle depends on the carried state only through which
    campaigns are still active, and a campaign's activity is a prefix of
    the horizon (its remaining work never grows).  So each pass solves
    the throttle of all T slots under an assumed (T, ..., M) activity
    mask (`throttle_plain`), then scans the remaining work slot by slot
    and records the mask it actually saw (`obj._pass`).  A pass whose
    seen mask equals the assumed one computed exactly what the
    slot-by-slot definition computes (the one mask that can: by induction
    over the slots); each other pass corrects at least the earliest
    finish it had wrong, so from all campaigns active throughout the
    passes stop after at most M + 1, one read back each.  They run
    without autograd; when the input needs a gradient, the converged
    mask's pass runs once more with it.  An evaluation that needs a
    gradient first tries, with autograd, the mask the last such
    evaluation of its shape converged to (`obj._grad_masks`, a gradient
    step's neighbour): when that holds it is the only pass.  Evaluations
    without a gradient always start from all active, so their values and
    cost do not depend on earlier calls; nor does any value.  An uncapped
    fleet needs no mask for its physics and takes one pass."""
    tb = obj._device_tables(u.device)
    shape = u.shape[:-1]                                # (..., M)
    # (T, ..., M) intensities and per-slot signals broadcast to them
    u_t = u.to(torch.float64)[..., tb["rowidx"]].movedim(-1, 0)
    lead = (-1,) + (1,) * len(shape)
    bg = tb["bg"].reshape(lead)
    r0 = obj._rates(u_t, bg, tb)
    if obj.site_cap_kw is None:
        return obj._pass(r0, tb, shape)[0]

    def coupled(active):
        return obj._pass(throttle_plain(u_t, bg, r0, active, tb, obj._rates,
                                        obj.M), tb, shape)

    grad = torch.is_grad_enabled() and u.requires_grad
    key = (u.device, tuple(u_t.shape))
    hint = obj._grad_masks
    if grad and key in hint:
        out, seen = coupled(hint[key])
        if torch.equal(seen, hint[key]):
            return out
    with torch.no_grad():
        active = torch.ones(u_t.shape, dtype=torch.bool, device=u.device)
        out, seen = coupled(active)
        while not torch.equal(seen, active):
            active = seen
            out, seen = coupled(active)
    if grad:
        out = coupled(active)[0]
        hint.clear()
        hint[key] = active
    return out


def throttle_plain(u_t, bg, r, active, tb, rates, M: int) -> model.Rates:
    """Every slot's `SITE_THROTTLE_ITERS` damped curtailment steps over
    the summed draw of the campaigns `active` marks, and the physics
    (`rates(u, bg, tb)`) at the final factor ((T, ..., M) fields)."""
    mid = (1,) * (active.dim() - 2)
    base = torch.where(active, tb["base"].reshape(-1, *mid, M), 0.0).sum(-1)
    head = tb["headroom"].reshape(-1, *mid)
    f = torch.ones(base.shape, dtype=torch.float64, device=base.device)
    for _ in range(model.SITE_THROTTLE_ITERS):
        fleet_kw = (torch.where(active, r.p_avg_w, 0.0) / 1000.0).sum(-1)
        f = model.site_throttle(fleet_kw, base, head, f, xp=model.TORCH)
        r = rates(u_t * f[..., None], bg, tb)
    return r


def pass_plain(r, tb, shape):
    """The slot-by-slot scan of the remaining work under the physics `r`
    ((T, ..., M) fields): the metrics, and the (T, ..., M) mask of the
    campaigns active at the start of each slot."""
    from repro_torch.core.engine_torch import FleetEvalMetrics
    lead = (-1,) + (1,) * len(shape)
    dt, starts, remaining = work_scan(tb["n_scen"].expand(shape).clone(),
                                      r.scen_per_s, tb["lens"])
    active = starts > tb["finish"]
    e = r.kwh_per_s * dt
    site_kw = ((torch.where(active, r.p_avg_w, 0.0) / 1000.0).sum(-1)
               + tb["office"].reshape(lead[:-1]))
    # the running peak, slot by slot as the reference takes it (a tie
    # splits its gradient between the slots)
    peak = torch.zeros(shape[:-1], dtype=torch.float64, device=dt.device)
    for kw in site_kw.unbind(0):
        peak = model.TORCH.maximum(peak, kw)
    return FleetEvalMetrics(
        e.sum(0), (e * tb["cf"].reshape(lead)).sum(0), dt.sum(0) / 3600.0,
        (e * tb["pr"].reshape(lead)).sum(0), remaining / tb["n_scen"],
        peak), active


def scan_inputs(obj, device: torch.device) -> tuple:
    """The kernels' inputs of `obj` on `device`, built once: rowidx
    (int32), the (6, T) series bg, cf, pr, lens, office and headroom, the
    (T, M) base draw and the (9, M) campaign scalars (n_scen, the finish
    threshold, the seven physics scalars)."""
    key = (device, "scan")
    if key not in obj._tables:
        tb = obj._device_tables(device)
        ph = tb["physics"]
        obj._tables[key] = (
            tb["rowidx"].to(torch.int32),
            torch.stack([tb[k] for k in ("bg", "cf", "pr", "lens", "office",
                                         "headroom")]),
            tb["base"].contiguous(),
            torch.stack([tb["n_scen"], tb["finish"]]
                        + [ph[k] for k in ("rate_at_full",
                                           "batch_overhead_s", "idle_w",
                                           "dyn_w", "alpha", "gamma",
                                           "overhead_w_frac")]))
    return obj._tables[key]


def fleet_objective_scan(obj, u: torch.Tensor):
    """The objective through `FleetScan` (the two kernels on a CUDA
    tensor, their plain versions on a CPU tensor), in the leading shape of
    `u`."""
    from repro_torch.core.engine_torch import FleetEvalMetrics
    shape = u.shape[:-1]
    if not shape or shape[-1] != obj.M:
        raise ValueError(f"fleet intensities of shape {tuple(u.shape)}: "
                         f"expected (..., {obj.M}, {obj.n_slots})")
    uf = u.to(torch.float64).reshape(-1, obj.M, u.shape[-1]).contiguous()
    outs = FleetScan.apply(uf, *scan_inputs(obj, u.device), obj.batch_size,
                           obj.site_cap_kw is not None)
    return FleetEvalMetrics(*(x.reshape(shape) for x in outs[:5]),
                            outs[5].reshape(shape[:-1]))


class FleetScan(torch.autograd.Function):
    """The fleet scan over a flat population `u` (N, M, S) fp64: the
    forward launch, and the backward launch from the forward's
    checkpoints (kept only when `u` needs a gradient).  Outputs (kWh,
    CO2, runtime h, cost, unfinished) (N, M) and the site peak (N,).
    Gradients left out downstream reach the backward as zeros (null
    pointers)."""

    @staticmethod
    def forward(ctx, u, rowidx, tabs, base, camp, batch, capped):
        keep = ctx.needs_input_grad[0]
        *outs, hist, phist = fleet_scan_fwd(u, rowidx, tabs, base, camp,
                                            batch, capped, keep=keep)
        if keep:
            ctx.save_for_backward(u, rowidx, tabs, base, camp, hist, phist)
            ctx.batch, ctx.capped = batch, capped
        ctx.set_materialize_grads(False)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * 7
        u, rowidx, tabs, base, camp, hist, phist = ctx.saved_tensors
        g_u = fleet_scan_bwd(u, rowidx, tabs, base, camp, ctx.batch,
                             ctx.capped, hist, phist, grads)
        return (g_u,) + (None,) * 6


# ---------------------------------------------------------------------------
# The two launches and their plain versions
# ---------------------------------------------------------------------------
def _camp_physics(camp) -> dict:
    return dict(zip(("rate_at_full", "batch_overhead_s", "idle_w", "dyn_w",
                     "alpha", "gamma", "overhead_w_frac"), camp[2:]))


def fleet_scan_fwd_plain(u, rowidx, tabs, base, camp, batch, capped, *,
                         keep: bool = False):
    """The forward kernel's function in PyTorch: (kWh, CO2, runtime h,
    cost, unfinished (N, M), site peak (N,), each slot's starting
    remaining (T, N, M) and site peak (T, N), or None twice)."""
    N, M, _ = u.shape
    T = rowidx.shape[0]
    f64 = dict(dtype=torch.float64, device=u.device)
    n_scen, finish = camp[0], camp[1]
    phys = _camp_physics(camp)
    rows = rowidx.long()
    R = n_scen.expand(N, M).clone()
    rt, kwh, co2, cost = (torch.zeros(N, M, **f64) for _ in range(4))
    peak = torch.zeros(N, **f64)
    hist = torch.empty(T, N, M, **f64) if keep else None
    phist = torch.empty(T, N, **f64) if keep else None
    for t in range(T):
        ut = u[:, :, rows[t]]
        act = R > finish
        if keep:
            hist[t] = R.detach()
            phist[t] = peak.detach()
        bg_t = tabs[0, t]
        r = model.rates(ut, batch, bg_t, xp=model.TORCH, **phys)
        if capped:
            b = torch.where(act, base[t], 0.0).sum(-1)
            f = torch.ones(N, **f64)
            for _ in range(model.SITE_THROTTLE_ITERS):
                f = model.site_throttle(
                    (torch.where(act, r.p_avg_w, 0.0) / 1000.0).sum(-1), b,
                    tabs[5, t], f, xp=model.TORCH)
                r = model.rates(ut * f[:, None], batch, bg_t, xp=model.TORCH,
                                **phys)
        site = ((torch.where(act, r.p_avg_w, 0.0) / 1000.0).sum(-1)
                + tabs[4, t])
        peak = model.TORCH.maximum(peak, site)
        ln = tabs[3, t]
        scen = model.TORCH.maximum(r.scen_per_s, 1e-30)
        dt = torch.where(R > scen * ln, ln, R / scen)
        dt = torch.where(R > 0.0, dt, 0.0)
        e = r.kwh_per_s * dt
        R = R - r.scen_per_s * dt
        rt = rt + dt
        kwh = kwh + e
        co2 = co2 + e * tabs[1, t]
        cost = cost + e * tabs[2, t]
    return kwh, co2, rt / 3600.0, cost, R / n_scen, peak, hist, phist


def fleet_scan_bwd_plain(u, rowidx, tabs, base, camp, batch, capped, hist,
                         phist, grads):
    """The backward kernel's function in PyTorch: d/du (N, M, S) fp64 of
    the outputs weighted by `grads` (kWh, CO2, runtime h, cost,
    unfinished, site peak; None is zero), by `torch.autograd` through
    `fleet_scan_fwd_plain` (which recomputes what the kernel reads from
    the checkpoints `hist` and `phist`)."""
    return vjp(lambda x: fleet_scan_fwd_plain(x, rowidx, tabs, base, camp,
                                              batch, capped)[:6], u, grads)


def _check(u, rowidx, tabs, base, camp, hist=None, phist=None, grads=()):
    if u.dim() != 3:
        raise ValueError(f"fleet_scan takes u of shape (N, M, S), got "
                         f"{tuple(u.shape)}")
    N, M, S = u.shape
    T = rowidx.shape[0]
    f64 = torch.float64
    want = [(u, (N, M, S), f64), (rowidx, (T,), torch.int32),
            (tabs, (6, T), f64), (base, (T, M), f64), (camp, (9, M), f64)]
    if hist is not None:
        want += [(hist, (T, N, M), f64), (phist, (T, N), f64)]
    shapes = [(N, M)] * 5 + [(N,)]
    want += [(g, shape, f64) for g, shape in zip(grads, shapes)
             if g is not None]
    for x, shape, dtype in want:
        if x.device != u.device:
            raise ValueError("fleet_scan inputs must all be on one device")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"fleet_scan input of shape {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError("fleet_scan inputs must be contiguous")
    return N, M, S, T


def fleet_scan_fwd(u, rowidx, tabs, base, camp, batch, capped, *,
                   keep: bool = False):
    """The forward launch: `u` (N, M, S), `rowidx` (T,) int32, `tabs`
    (6, T), `base` (T, M), `camp` (9, M), the batch size and whether the
    site is capped.  Returns (kWh, CO2, runtime h, cost, unfinished (N,
    M), site peak (N,), and with `keep` the checkpoints (T, N, M) and
    (T, N), else None twice)."""
    if not _device(u, "fleet_scan_fwd"):
        return fleet_scan_fwd_plain(u, rowidx, tabs, base, camp, batch,
                                    capped, keep=keep)
    N, M, S, T = _check(u, rowidx, tabs, base, camp)
    f64 = dict(dtype=torch.float64, device=u.device)
    outs = [torch.empty(N, M, **f64) for _ in range(5)]
    outs.append(torch.empty(N, **f64))
    hist = torch.empty(T, N, M, **f64) if keep else None
    phist = torch.empty(T, N, **f64) if keep else None
    if N == 0:
        return (*outs, hist, phist)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fleet_scan_fwd(
            *(_ptr(x) for x in (u, rowidx, tabs, base, camp)), float(batch),
            int(bool(capped)), *(_ptr(x) for x in outs + [hist, phist]),
            N, M, S, T, stream)
    if err:
        raise RuntimeError(f"fleet_scan_fwd kernel launch failed: CUDA "
                           f"error {err}")
    global fwd_launches
    fwd_launches += 1
    return (*outs, hist, phist)


def fleet_scan_bwd(u, rowidx, tabs, base, camp, batch, capped, hist, phist,
                   grads):
    """The backward launch: d/du (N, M, S) fp64 of the forward's outputs
    weighted by `grads` (six tensors of the outputs' shapes, or None)."""
    if not _device(u, "fleet_scan_bwd"):
        return fleet_scan_bwd_plain(u, rowidx, tabs, base, camp, batch,
                                    capped, hist, phist, grads)
    grads = tuple(None if g is None else g.contiguous() for g in grads)
    N, M, S, T = _check(u, rowidx, tabs, base, camp, hist, phist, grads)
    g_u = torch.zeros(N, M, S, dtype=torch.float64, device=u.device)
    if N == 0:
        return g_u
    lam = torch.empty(N, M, dtype=torch.float64, device=u.device)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fleet_scan_bwd(
            *(_ptr(x) for x in (u, rowidx, tabs, base, camp)), float(batch),
            int(bool(capped)),
            *(_ptr(x) for x in (hist, phist) + grads + (lam, g_u)),
            N, M, S, T, stream)
    if err:
        raise RuntimeError(f"fleet_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    global bwd_launches
    bwd_launches += 1
    return g_u


def _library() -> ctypes.CDLL:
    lib = _build.library("fleet_objective")
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.fleet_scan_fwd.argtypes = ([vp] * 5 + [d, i] + [vp] * 8 + [i] * 4
                                   + [vp])
    lib.fleet_scan_bwd.argtypes = ([vp] * 5 + [d, i] + [vp] * 10 + [i] * 4
                                   + [vp])
    lib.fleet_scan_plan.argtypes = [i] * 3 + [vp]
    for fn in (lib.fleet_scan_fwd, lib.fleet_scan_bwd, lib.fleet_scan_iters,
               lib.fleet_scan_plan):
        fn.restype = ctypes.c_int
    lib.fleet_scan_iters.argtypes = []
    if lib.fleet_scan_iters() != model.SITE_THROTTLE_ITERS:
        raise RuntimeError("csrc/fleet_objective.cu takes "
                           f"{lib.fleet_scan_iters()} throttle steps a slot, "
                           f"the model {model.SITE_THROTTLE_ITERS}")
    return lib

