"""Vectorized sweep engine: evaluate many (schedule x workload x grid-curve)
combinations in one batched pass, dispatching each case to the cheapest
representation that is exact for it.

Two vectorized paths sit behind one `sweep()` entry point:

  * the **periodic 24-slot path** (this module): decisions and signals
    that are periodic over 24 h and piecewise-constant per hour collapse a
    campaign into a periodic piecewise-linear accumulation — sample each
    case onto a 24-slot grid, derive per-slot rates with the shared rate
    model (core/model.py), jump whole days with integer arithmetic, and
    resolve the final partial day with one cumulative-sum search, all on
    float64 torch tensors on the sweep's device;

  * the **trace-grid path** (core/engine_torch.py): anything the periodic
    grid cannot represent — progress/elapsed-aware schedules, non-periodic
    multi-day `TraceSignal`s, carbon ensembles (`SignalEnsemble`),
    sub-hour band edges — is compiled into a `SweepPlan` and stepped
    through a chunked resumable scan (the hand-written chunk kernels on
    the card) that carries `(remaining, elapsed, accumulator)` state
    across fixed-shape horizon chunks.

`sweep()` classifies every case and routes it; the per-case probe that
used to *reject* progress-aware schedules with a ValueError now simply
sends them down the trace-grid path.  Agreement with the per-batch oracle
`simulate_campaign_exact` is pinned to <0.5 % for both paths by
tests/test_session_engine.py and tests/test_trace_engine.py; against the
coarse sequential path the periodic engine agrees to float precision
(both integrate the same piecewise-hourly model).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import model
from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.device import reject_unported, resolve_device
from repro_torch.core.energy import MachineProfile
from repro_torch.core.policy import TimeBands
from repro_torch.core.schedule import (Schedule, SchedulingContext, as_schedule,
                                 change_hours)
from repro_torch.core.signal import Signal, is_periodic_24h, sample_hourly
from repro_torch.core.simulator import SimResult, fill_deltas
from repro_torch.core.workload import OEMWorkload

# Memo caches below are bounded (long-running sweep services construct
# unbounded numbers of TimeBands/carbon variants; the old module-level
# dicts grew forever).
_CACHE_SIZE = 256


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One point of a sweep: a schedule run against one scenario setup.

    `carbon` may be a GridCarbonModel or any carbon Signal (a non-periodic
    `TraceSignal` routes the case to the trace-grid engine).  A non-zero
    `deadline_h` is surfaced to the schedule via `ctx.deadline_h`.
    """
    schedule: Schedule
    workload: OEMWorkload
    machine: MachineProfile = MachineProfile()
    bands: TimeBands = TimeBands()
    carbon: Optional[object] = None
    start_hour: float = 9.0
    label: str = ""
    deadline_h: float = 0.0

    def name(self) -> str:
        return self.label or as_schedule(self.schedule).name


@functools.lru_cache(maxsize=_CACHE_SIZE)
def _band_table(bands: TimeBands):
    """(band_name[24], background[24]) for one TimeBands, memoized — band
    lookups are the hot part of profile sampling in large sweeps."""
    if any(float(e) % 1.0 for e in bands.edges()):
        raise ValueError(
            "the periodic engine samples bands on the hourly grid and "
            "cannot represent sub-hour band edges; sweep() routes such "
            "cases to the trace-grid engine")
    names = [bands.band_at(float(h)) for h in range(24)]
    return (names, np.array([bands.background(b) for b in names]))


@functools.lru_cache(maxsize=_CACHE_SIZE)
def _carbon_table_cached(carbon) -> np.ndarray:
    return np.array(sample_hourly(carbon))


def _carbon_table(carbon) -> np.ndarray:
    try:
        return _carbon_table_cached(carbon)
    except TypeError:                       # unhashable hourly_curve (list)
        return np.array(sample_hourly(carbon))


def _grid_resolution(edges) -> int:
    """Smallest slots-per-hour (a divisor of 60) aligning every edge;
    raises for edges finer than one minute."""
    for k in (1, 2, 3, 4, 5, 6, 10, 12, 15, 20, 30, 60):
        if all(abs(float(e) * k - round(float(e) * k)) < 1e-9
               for e in edges):
            return k
    raise ValueError(
        "edges finer than one minute cannot be aligned to a "
        "simulation grid; use the sequential simulators")


def slots_per_hour(bands: TimeBands) -> int:
    """Smallest sub-hour grid resolution that aligns every band edge.

    1 for integral edges; e.g. 2 for half-hour edges.  Raises for edges
    finer than one minute (not representable on any reasonable grid).
    """
    return _grid_resolution(bands.edges())


def case_slots_per_hour(case: "SweepCase") -> int:
    """Finest grid resolution a case needs: the lcm of the band-edge
    resolution and the schedule's own `change_hours` resolution.

    This is the dispatcher hook that lets a *schedule* force a sub-hour
    grid: a 48-slot `ParametricSchedule` advertises half-hour change
    hours, so its cases route to the trace engine at slots_per_hour=2
    even under hour-aligned bands.  All resolutions are divisors of 60,
    so the lcm is too.
    """
    sched = as_schedule(case.schedule)
    return math.lcm(slots_per_hour(case.bands),
                    _grid_resolution(change_hours(sched, case.bands)))


def periodic_decision_profile(schedule, bands: TimeBands,
                              slots_per_hour: int = 1
                              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Closed-form (intensity, batch) day profiles of shape (24*sph,) for
    the bundled Policy / HourlyPolicy classes, which are periodic and
    progress-free by construction; None for anything that needs decide()
    sampling.  Bands are sampled directly on the sph grid — NOT through
    the hourly `_band_table`, which rejects sub-hour band edges (the
    trace engine calls this with sph>1 exactly for those)."""
    from repro_torch.core.policy import HourlyPolicy, Policy

    sph = int(slots_per_hour)
    sched = as_schedule(schedule)
    decide = type(sched).decide if isinstance(sched, Policy) else None
    if decide is HourlyPolicy.decide and sched.hourly_intensity:
        u = np.repeat(np.array(sched.hourly_intensity, dtype=float), sph)
        if sched.low_priority:
            u = u * 0.82
        return u, np.full(24 * sph, float(sched.batch_size))
    if decide in (Policy.decide, HourlyPolicy.decide):
        need = _grid_resolution(bands.edges())
        if sph % need:
            raise ValueError(
                f"slots_per_hour={sph} cannot represent band edges that "
                f"need {need} slots/hour — sampling would silently alias "
                "them; sweep() routes such cases to the trace-grid engine "
                "at the right resolution")
        names = [bands.band_at(r / sph) for r in range(24 * sph)]
        per_band = {b: sched.intensity_at(b) for b in set(names)}
        u = np.array([per_band[b] for b in names])
        return u, np.full(24 * sph, float(sched.batch_size))
    return None


def _try_hourly_profile(schedule, bands: TimeBands, carbon,
                        price: Optional[Signal] = None,
                        deadline_h: float = 0.0
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Sample a schedule's decisions on the 24-hour grid, or None when the
    schedule consults progress/elapsed_h (the periodic grid is sampled
    once per hour-of-day and reused for every simulated day, so such
    schedules are not representable — the dispatcher sends them to the
    trace-grid engine instead)."""
    closed = periodic_decision_profile(schedule, bands)
    if closed is not None:
        return closed

    sched = as_schedule(schedule)
    band_names, bg24 = _band_table(bands)
    cf24 = _carbon_table(carbon)
    pr24 = ([price.at(float(h)) for h in range(24)] if price is not None
            else None)
    u = np.empty(24)
    batch = np.empty(24)
    for h in range(24):
        ctx = SchedulingContext(
            hour_of_day=float(h), band=band_names[h],
            background=float(bg24[h]), carbon_factor=float(cf24[h]),
            price_usd_per_kwh=pr24[h] if pr24 is not None else 0.0,
            deadline_h=deadline_h)
        d = sched.decide(ctx)
        # probe at other campaign positions: a schedule that consults
        # progress/elapsed_h decides differently somewhere and needs the
        # trace-grid engine's (hour, progress-bucket) decision tables.
        # Several (elapsed, progress) pairs, spanning behind-schedule and
        # ahead-of-schedule states, so pace-style controllers whose
        # decision happens to coincide at one probe point are still caught.
        for elapsed, progress in ((24.0 + h, 0.5), (720.0 + h, 0.02),
                                  (float(h), 0.98), (240.0 + h, 0.999)):
            d_probe = sched.decide(dataclasses.replace(
                ctx, elapsed_h=elapsed, progress=progress))
            if (d_probe.intensity, d_probe.batch_size) != (d.intensity,
                                                           d.batch_size):
                return None
        u[h] = d.intensity
        batch[h] = d.batch_size
    return u, batch


def hourly_profile(schedule, bands: TimeBands, carbon: GridCarbonModel,
                   price: Optional[Signal] = None):
    """Sample a schedule's decisions on the 24-hour grid.

    Returns (intensity[24], batch[24]).  Exact for any schedule whose
    decision is constant within each local hour (all bundled ones are).
    Raises for progress/elapsed-aware schedules — `sweep()` handles those
    transparently via the trace-grid engine; call that instead.
    """
    prof = _try_hourly_profile(schedule, bands, carbon, price)
    if prof is None:
        raise ValueError(
            f"schedule {as_schedule(schedule).name!r} varies with campaign "
            "progress/elapsed time; the periodic hourly grid cannot "
            "represent it — sweep() routes such schedules to the "
            "trace-grid engine automatically")
    return prof


def _case_is_periodic(case: SweepCase, price: Optional[Signal]) -> bool:
    """Cheap structural checks for the periodic 24-slot representation
    (the schedule's own probe happens later, in profile sampling)."""
    carbon = case.carbon or GridCarbonModel()
    if not is_periodic_24h(carbon):
        return False
    if price is not None and not is_periodic_24h(price):
        return False
    # the schedule's change_hours count too: a sub-hour-slot schedule
    # (e.g. a 48-slot ParametricSchedule) aliases on the hourly grid
    return case_slots_per_hour(case) == 1


def sweep(cases: Sequence[SweepCase],
          price: Optional[Signal] = None,
          progress_buckets: int = 32,
          backend: Optional[str] = None,
          max_days: int = 120,
          precision: str = "fp64",
          devices: Optional[int] = None,
          cache_dir: Optional[str] = None,
          device=None) -> List[SimResult]:
    """Evaluate all cases in vectorized passes; order is preserved.

    Each case is dispatched to the periodic 24-slot path when its
    schedule, bands, and signals are all 24 h-periodic and hour-aligned,
    and to the trace-grid scan engine (core/engine_torch.py) otherwise —
    progress/elapsed-aware schedules, `TraceSignal` carbon/price,
    `SignalEnsemble` carbon (E scenario members per scan, summarized as
    mean + `EnsembleStats`), and sub-hour band edges all take the trace
    path instead of raising.

    `progress_buckets` and `max_days` (the trace grid's horizon cap)
    tune the trace path, as does `precision` ("fp64" exact / "mixed"
    fp32 dynamics with fp64 accumulators).  `device` is where both
    paths run: the card by default, `"cpu"` for the plain PyTorch
    versions of the kernels.  `cache_dir` points trace-path compilation
    at a persistent on-disk plan cache (see
    `engine_torch.compile_plan`).  `backend` and `devices` > 1 are the
    reference's knobs that are not ported yet and raise.
    """
    reject_unported(devices=devices, backend=backend)
    dev = resolve_device(device)
    if not len(cases):
        return []
    periodic_idx: List[int] = []
    trace_idx: List[int] = []
    profiles = {}
    for i, c in enumerate(cases):
        prof = (_try_hourly_profile(c.schedule, c.bands,
                                    c.carbon or GridCarbonModel(), price,
                                    c.deadline_h)
                if _case_is_periodic(c, price) else None)
        if prof is None:
            trace_idx.append(i)
        else:
            periodic_idx.append(i)
            profiles[i] = prof

    out: List[Optional[SimResult]] = [None] * len(cases)
    if periodic_idx:
        res = _sweep_periodic([cases[i] for i in periodic_idx], price,
                              [profiles[i] for i in periodic_idx], dev)
        for i, r in zip(periodic_idx, res):
            out[i] = r
    if trace_idx:
        from repro_torch.core.engine_torch import trace_sweep
        sub = [cases[i] for i in trace_idx]
        # lcm, not max: mixing half-hour and 20-minute cases in one batch
        # needs a grid aligning both (all resolutions divide 60)
        sph = functools.reduce(math.lcm,
                               (case_slots_per_hour(c) for c in sub))
        res = trace_sweep(sub, price=price, slots_per_hour=sph,
                          progress_buckets=progress_buckets,
                          max_days=max_days, precision=precision,
                          device=dev, cache_dir=cache_dir)
        for i, r in zip(trace_idx, res):
            out[i] = r
    return out  # type: ignore[return-value]


def _sweep_periodic(cases: Sequence[SweepCase], price: Optional[Signal],
                    profiles: Sequence[Tuple[np.ndarray, np.ndarray]],
                    device: torch.device) -> List[SimResult]:
    """The periodic 24-slot path: one batched float64 pass over all cases
    on `device` (inputs are gathered on the host, as in the reference)."""
    S = len(cases)
    u = np.empty((S, 24))
    batch = np.empty((S, 24))
    bg = np.empty((S, 24))
    cf = np.empty((S, 24))
    pr = np.zeros((S, 24))
    n_scen = np.empty(S)
    rate = np.empty(S)
    oh_s = np.empty(S)
    idle = np.empty(S)
    dyn = np.empty(S)
    alpha = np.empty(S)
    gamma = np.empty(S)
    ohfrac = np.empty(S)
    start = np.empty(S)

    pr24 = (np.array([price.at(float(h)) for h in range(24)])
            if price is not None else None)
    for i, c in enumerate(cases):
        carbon = c.carbon or GridCarbonModel()
        u[i], batch[i] = profiles[i]
        bg[i] = _band_table(c.bands)[1]
        cf[i] = _carbon_table(carbon)
        if pr24 is not None:
            pr[i] = pr24
        n_scen[i] = c.workload.n_scenarios
        rate[i] = c.workload.rate_at_full
        oh_s[i] = c.workload.batch_overhead_s
        m = c.machine
        idle[i], dyn[i], alpha[i] = m.idle_w, m.dyn_w, m.alpha
        gamma[i], ohfrac[i] = m.gamma, m.overhead_w_frac
        start[i] = c.start_hour

    (u, batch, bg, cf, pr, n_scen, rate, oh_s, idle, dyn, alpha, gamma,
     ohfrac, start) = (torch.as_tensor(a, dtype=torch.float64, device=device)
                       for a in (u, batch, bg, cf, pr, n_scen, rate, oh_s,
                                 idle, dyn, alpha, gamma, ohfrac, start))

    # ---- per-slot rates (the shared rate model, batched over (S, 24)) -----
    r = model.rates(u, batch, bg,
                    rate_at_full=rate[:, None], batch_overhead_s=oh_s[:, None],
                    idle_w=idle[:, None], dyn_w=dyn[:, None],
                    alpha=alpha[:, None], gamma=gamma[:, None],
                    overhead_w_frac=ohfrac[:, None], xp=model.TORCH)
    scen_rate = r.scen_per_s                          # scenarios per second
    kwh_rate = r.kwh_per_s                            # kWh per second
    co2_rate = kwh_rate * cf
    cost_rate = kwh_rate * pr

    # ---- slot sequence of one 24 h period starting at start_hour ----------
    # K = 25 slots: a (possibly zero-length) partial leading slot, 23 full
    # hours, and the trailing remainder of the leading hour.
    h0 = torch.floor(start)
    frac = start - h0                                  # fraction into hour h0
    K = 25
    k = torch.arange(K, device=device)
    slot_hour = (h0.to(torch.int64)[:, None] + k[None, :]) % 24   # (S, K)
    lens = torch.full((S, K), 3600.0, dtype=torch.float64, device=device)
    lens[:, 0] = (1.0 - frac) * 3600.0
    lens[:, 24] = frac * 3600.0

    def seq(rate_per_hour):
        return torch.gather(rate_per_hour, 1, slot_hour)

    scen_seq = seq(scen_rate) * lens
    kwh_seq = seq(kwh_rate) * lens
    co2_seq = seq(co2_rate) * lens
    cost_seq = seq(cost_rate) * lens

    day_scen = scen_seq.sum(dim=1)
    days = torch.floor(n_scen / day_scen)
    residual = n_scen - days * day_scen                # scenarios past midnight N

    # find the slot where the residual completes (first cum >= residual)
    cum_scen = torch.cumsum(scen_seq, dim=1)
    k_stop = torch.clamp_max(
        (cum_scen < residual[:, None] - 1e-9).sum(dim=1), K - 1)
    rows = torch.arange(S, device=device)
    before = cum_scen[rows, k_stop] - scen_seq[rows, k_stop]
    stop_rate = seq(scen_rate)[rows, k_stop]
    tail_s = (torch.clamp_min(residual - before, 0.0)
              / torch.clamp_min(stop_rate, 1e-30))

    def total(per_seg, per_s_rate):
        excl = torch.cumsum(per_seg, dim=1) - per_seg  # sum of slots < k_stop
        day_total = per_seg.sum(dim=1)
        return (days * day_total + excl[rows, k_stop]
                + seq(per_s_rate)[rows, k_stop] * tail_s)

    lens_excl = torch.cumsum(lens, dim=1) - lens
    runtime_s = days * 86400.0 + lens_excl[rows, k_stop] + tail_s
    energy = total(kwh_seq, kwh_rate)
    co2 = total(co2_seq, co2_rate)
    cost = total(cost_seq, cost_rate)

    runtime_s, energy, co2, cost = (
        t.tolist() for t in torch.stack([runtime_s, energy, co2, cost]).cpu())
    out = []
    for i, c in enumerate(cases):
        out.append(SimResult(
            policy=c.name(), runtime_h=runtime_s[i] / 3600.0,
            energy_kwh=energy[i], co2_kg=co2[i],
            cost_usd=cost[i] if price is not None else None))
    return out


def frontier_from_sweep(results: List[SimResult],
                        baseline_name: str = "baseline",
                        base: Optional[SimResult] = None) -> List[SimResult]:
    """Fill the delta-vs-baseline columns of a sweep in place.

    The reference is `base` when given, else the swept result named
    `baseline_name`; with neither, results are returned unchanged.
    """
    if base is None:
        base = next((r for r in results if r.policy == baseline_name), None)
    if base is None:
        return results
    return fill_deltas(results, base)
