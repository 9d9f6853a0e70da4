"""Campaign simulator: executes a recurrent workload under an execution
schedule over simulated wall-clock, producing the Figure-1 runtime/energy
frontier and the OEM case-study tables.

Mechanics (all estimation-based, per the paper's method):
  * time advances segment by segment; a segment ends wherever the schedule's
    decision or any input signal can change (`schedule.change_hours`);
  * effective throughput R_eff = R * u * (1 - gamma * b)   (contention);
  * machine power P(u, b) = idle + dyn * (u + b)^alpha      (convex);
  * per-batch orchestration overhead runs at overhead power (no work);
  * energy is whole-machine over the campaign (that is what the paper's
    kWh figures measure: 48.67 kWh / 180.30 h = 270 W average).

All scheduling goes through `Schedule.decide(SchedulingContext)` — there is
no duck-typed `intensity_at_hour` probing here anymore; old policy objects
are coerced via `repro_torch.core.schedule.as_schedule`.

Calibration: R is solved so the baseline policy reproduces the measured
runtime exactly, then dyn_w so it reproduces the measured kWh exactly.
The six policy *deltas* are then genuine model predictions, validated
against the paper's reported numbers (benchmarks/run.py).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.core import model
from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.energy import MachineProfile
from repro_torch.core.policy import BASELINE, POLICIES, TimeBands
from repro_torch.core.schedule import (Schedule, SchedulingContext, as_schedule,
                                 change_hours)
from repro_torch.core.signal import ConstantSignal, Signal, carbon_signal
from repro_torch.core.tracker import RunSummary, RunTracker
from repro_torch.core.workload import OEMWorkload


@dataclasses.dataclass(frozen=True)
class EnsembleStats:
    """Distribution of one metric over a carbon-trace ensemble.

    Built by `ensemble_stats` from the per-member samples the trace-grid
    scan produces; `mean`/`std`/`min`/`max` plus the 5/50/95 % quantiles
    summarize it, and `samples` keeps the raw per-member values (order =
    ensemble member order) for custom risk measures.
    """
    mean: float
    std: float
    lo: float                         # min over members
    hi: float                         # max over members
    q05: float
    q50: float
    q95: float
    samples: Tuple[float, ...]

    @property
    def n_members(self) -> int:
        return len(self.samples)

    def quantile(self, q: float) -> float:
        import numpy as _np
        return float(_np.quantile(_np.asarray(self.samples), q))


def ensemble_stats(samples) -> EnsembleStats:
    """`EnsembleStats` from an array of per-member metric values."""
    import numpy as _np
    arr = _np.asarray(samples, dtype=float).ravel()
    q05, q50, q95 = (float(q) for q in _np.quantile(arr, (0.05, 0.5, 0.95)))
    return EnsembleStats(mean=float(arr.mean()), std=float(arr.std()),
                         lo=float(arr.min()), hi=float(arr.max()),
                         q05=q05, q50=q50, q95=q95,
                         samples=tuple(float(v) for v in arr))


@dataclasses.dataclass
class SimResult:
    policy: str
    runtime_h: float
    energy_kwh: float
    co2_kg: float
    runtime_delta_pct: float = 0.0   # vs baseline (+ = slower)
    energy_delta_pct: float = 0.0    # vs baseline (- = saves)
    cost_usd: Optional[float] = None  # set when a price Signal is supplied
    summary: Optional[RunSummary] = None
    # Filled by ensemble sweeps (carbon = SignalEnsemble): the scalar
    # columns above then hold ensemble means, and these carry the spread.
    # energy/runtime stats appear only when the schedule consults the
    # carbon signal (then the dynamics themselves vary per member).
    co2_ensemble: Optional[EnsembleStats] = None
    energy_ensemble: Optional[EnsembleStats] = None
    runtime_ensemble: Optional[EnsembleStats] = None


def _segment_grid(schedule: Schedule, bands: TimeBands,
                  hourly_signals: bool = False) -> List[float]:
    """Hours in [0, 24) where the decision or any integrated quantity may
    change.

    Union of the band edges (background changes there) and the schedule's
    own change hours; always contains 0.0 so the cyclic successor of the
    last breakpoint is 24.0 + grid[0] == 24.0.  When an hourly-varying
    signal (grid carbon curve, price tariff) is active, segments must not
    span hours — a multi-hour band segment would be carbonized/priced
    entirely at its start hour — so the grid refines to every hour.
    """
    hs = {float(h) for h in range(24)} if hourly_signals else {0.0}
    for h in bands.edges():
        hs.add(float(h) % 24.0)
    for h in change_hours(schedule, bands):
        hs.add(float(h) % 24.0)
    return sorted(hs)


def _next_boundary(grid: List[float], hour: float) -> float:
    """Smallest grid hour strictly greater than `hour` (cyclic, in (h, 24])."""
    i = bisect.bisect_right(grid, hour + 1e-9)
    return grid[i] if i < len(grid) else 24.0 + grid[0]


def simulate_campaign(workload: OEMWorkload, policy, machine: MachineProfile,
                      bands: TimeBands = TimeBands(),
                      carbon=None,
                      start_hour: float = 9.0,
                      tracker: Optional[RunTracker] = None,
                      coarse: bool = True,
                      price: Optional[Signal] = None,
                      deadline_h: float = 0.0) -> SimResult:
    """Simulate the full campaign under any Schedule (or legacy Policy).

    `coarse=True` advances segment-by-segment (exact for piecewise-constant
    decisions, ~1000x faster than per-batch); `coarse=False` delegates to
    the per-batch reference oracle `simulate_campaign_exact`.

    `carbon` may be a GridCarbonModel or any carbon Signal (including a
    non-periodic TraceSignal); signals are sampled at absolute campaign
    hours.  `deadline_h` is surfaced to schedules via `ctx.deadline_h`.

    This free function is the back-compat surface; prefer
    `repro_torch.carina.Campaign` for new code (it owns calibration, tracking,
    and dashboards) and `repro_torch.core.engine.sweep` for many-schedule sweeps.
    """
    if not coarse:
        return simulate_campaign_exact(workload, policy, machine, bands,
                                       carbon, start_hour, price=price,
                                       deadline_h=deadline_h)
    carbon_sig = carbon_signal(carbon or GridCarbonModel())
    schedule = as_schedule(policy)
    grid = _segment_grid(
        schedule, bands,
        hourly_signals=(price is not None
                        or not isinstance(carbon_sig, ConstantSignal)))
    n_total = float(workload.n_scenarios)
    remaining = n_total
    t_h = start_hour
    energy_kwh = 0.0
    co2_kg = 0.0
    cost_usd = 0.0

    while remaining > 0:
        h = t_h % 24.0
        # sample piecewise-constant inputs just *inside* the segment
        # (same 1e-9 tolerance as _next_boundary): accumulated fp drift
        # can land t_h a few ulps below a band edge that is not exactly
        # representable (e.g. 43/3 h), and sampling at t_h then applies
        # the previous band to the whole following segment
        h_in, t_in = (h + 1e-9) % 24.0, t_h + 1e-9
        band = bands.band_at(h_in)
        b = bands.background(band)
        cf = carbon_sig.at(t_in)
        ctx = SchedulingContext(
            hour_of_day=h_in, band=band, background=b,
            carbon_factor=cf,
            price_usd_per_kwh=price.at(t_in) if price is not None else 0.0,
            elapsed_h=t_h - start_hour,
            progress=1.0 - remaining / n_total,
            deadline_h=deadline_h)
        d = schedule.decide(ctx)
        u, batch = d.intensity, d.batch_size
        seg_h = _next_boundary(grid, h) - h

        r = model.campaign_rates(u, batch, b, workload, machine)
        scen_per_s = r.scen_per_s

        seg_s = seg_h * 3600.0
        max_scen = scen_per_s * seg_s
        if max_scen >= remaining:
            seg_s = remaining / scen_per_s
            done = remaining
        else:
            done = max_scen

        e_kwh = r.p_avg_w * seg_s / 3.6e6
        c_kg = e_kwh * cf
        energy_kwh += e_kwh
        co2_kg += c_kg
        if price is not None:
            cost_usd += e_kwh * ctx.price_usd_per_kwh
        if tracker is not None:
            # sim_time_h is absolute simulated time (hour-of-day = % 24),
            # matching the controller's clock.hours, so the tracker's
            # hour-aware CO2 uses the same grid hour this segment ran in
            tracker.record_unit(phase=band, intensity=u, runtime_s=seg_s,
                                energy_kwh=e_kwh, sim_time_h=t_h,
                                meta={"scenarios": done, "batch": batch})
        remaining -= done
        t_h += seg_s / 3600.0

    runtime_h = t_h - start_hour
    return SimResult(schedule.name, runtime_h, energy_kwh, co2_kg,
                     cost_usd=cost_usd if price is not None else None,
                     summary=tracker.summary() if tracker else None)


def simulate_campaign_exact(workload: OEMWorkload, policy,
                            machine: MachineProfile,
                            bands: TimeBands = TimeBands(),
                            carbon=None,
                            start_hour: float = 9.0,
                            price: Optional[Signal] = None,
                            deadline_h: float = 0.0) -> SimResult:
    """Batch-by-batch reference simulation (each batch is atomic and sees the
    band at its start — the segment-based simulate_campaign and the
    vectorized engines split batches at boundaries; tests pin agreement to
    <0.5 %).  This is the per-batch oracle the sweep engines are checked
    against.  `carbon` may be a GridCarbonModel or any carbon Signal."""
    carbon_sig = carbon_signal(carbon or GridCarbonModel())
    schedule = as_schedule(policy)
    n_total = float(workload.n_scenarios)
    remaining = n_total
    t_h = start_hour
    energy_kwh = 0.0
    co2_kg = 0.0
    cost_usd = 0.0
    while remaining > 0:
        h = t_h % 24.0
        band = bands.band_at(h)
        b = bands.background(band)
        cf = carbon_sig.at(t_h)
        ctx = SchedulingContext(
            hour_of_day=h, band=band, background=b,
            carbon_factor=cf,
            price_usd_per_kwh=price.at(t_h) if price is not None else 0.0,
            elapsed_h=t_h - start_hour,
            progress=1.0 - remaining / n_total,
            deadline_h=deadline_h)
        d = schedule.decide(ctx)
        u, batch = d.intensity, d.batch_size
        r = model.campaign_rates(u, batch, b, workload, machine)
        n = min(batch, remaining)
        t_work = n / max(r.r_eff, 1e-9)
        t_oh = workload.batch_overhead_s
        e = (r.p_work_w * t_work + r.p_oh_w * t_oh) / 3.6e6
        energy_kwh += e
        co2_kg += e * cf
        if price is not None:
            cost_usd += e * ctx.price_usd_per_kwh
        t_h += (t_work + t_oh) / 3600.0
        remaining -= n
    return SimResult(schedule.name, t_h - start_hour, energy_kwh, co2_kg,
                     cost_usd=cost_usd if price is not None else None)


# ---------------------------------------------------------------------------
def calibrate_workload(workload: OEMWorkload, machine: MachineProfile,
                       bands: TimeBands = TimeBands(),
                       tol: float = 1e-4) -> Tuple[OEMWorkload, MachineProfile]:
    """Solve (rate_at_full, dyn_w) so the BASELINE policy reproduces the
    measured (hours, kWh) exactly.  Bisection; runtime is monotone in R and
    energy in dyn_w."""
    assert workload.measured_hours and workload.measured_kwh

    def runtime_for(r: float) -> float:
        wl = dataclasses.replace(workload, rate_at_full=r)
        return simulate_campaign(wl, BASELINE, machine, bands).runtime_h

    lo, hi = 1e-3, 1e3
    for _ in range(80):
        mid = math.sqrt(lo * hi)
        if runtime_for(mid) > workload.measured_hours:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1 + tol:
            break
    wl = dataclasses.replace(workload, rate_at_full=math.sqrt(lo * hi))

    def energy_for(d: float) -> float:
        m = dataclasses.replace(machine, dyn_w=d)
        return simulate_campaign(wl, BASELINE, m, bands).energy_kwh

    lo, hi = 1.0, 2000.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if energy_for(mid) < workload.measured_kwh:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * workload.measured_kwh:
            break
    m = dataclasses.replace(machine, dyn_w=0.5 * (lo + hi))
    return wl, m


def fill_deltas(results: List[SimResult], base: SimResult) -> List[SimResult]:
    """Fill the delta-vs-baseline columns in place (single definition used
    by the frontier, the session API, and the sweep engine)."""
    for r in results:
        r.runtime_delta_pct = 100.0 * (r.runtime_h / base.runtime_h - 1.0)
        r.energy_delta_pct = 100.0 * (r.energy_kwh / base.energy_kwh - 1.0)
    return results


def policy_frontier(workload: OEMWorkload,
                    machine: MachineProfile = MachineProfile(),
                    bands: TimeBands = TimeBands(),
                    carbon: Optional[GridCarbonModel] = None,
                    calibrate: bool = True) -> List[SimResult]:
    """The Figure-1 table: all six policies vs the measured baseline.

    Back-compat shim — `repro_torch.carina.Campaign(...).frontier()` is the
    session-level equivalent and `Campaign.sweep(...)` the vectorized one.
    """
    if calibrate:
        workload, machine = calibrate_workload(workload, machine, bands)
    base = simulate_campaign(workload, BASELINE, machine, bands, carbon)
    out = [base if p.name == BASELINE.name
           else simulate_campaign(workload, p, machine, bands, carbon)
           for p in POLICIES.values()]
    return fill_deltas(out, base)
