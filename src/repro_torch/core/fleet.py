"""The fleet session API: many concurrent campaigns under one site.

The paper runs its two OEM database-generation campaigns on *shared*
company infrastructure — the real coupling (office background load, a
site power budget, one grid carbon/price signal) is between workflows,
not inside any one of them.  A `Fleet` makes that joint execution
first-class:

    import repro_torch.carina as carina
    site = carina.Site(power_cap_kw=0.45, office_kw=0.15)
    fleet = carina.Fleet([carina.Campaign(carina.OEM_CASE_1),
                          carina.Campaign(carina.OEM_CASE_2)], site)
    rows = fleet.sweep([carina.PEAK_AWARE_BOOSTED,
                        carina.proportional_split(0.8)])
    rows[0].site.co2_kg                     # site rollup
    rows[0].campaigns[1].runtime_h          # per-campaign SimResult

A `Site` owns the shared inputs (one `SignalSet`: band background, grid
carbon, price), the site power cap in kW, and the office/background
draw.  Under an active cap, campaigns couple through the one definition
of site contention (`model.site_throttle`): per slot, the summed active
draw is compared to the headroom and every campaign's worker intensity
is curtailed by the same demand-proportional factor.  Execution runs on
the trace engine's grouped lanes (`core/engine_torch.py`): the M campaigns
of each fleet case occupy adjacent scan lanes and the coupled chunk
kernel (kernels/coupled_chunk.py) applies the cap coupling across the
group each slot — an uncoupled
fleet (`power_cap_kw=None`) is dispatched through the plain engine and
is bitwise-identical to M independent `Campaign.sweep` calls.

`Campaign` is the M=1 special case: `Campaign.as_fleet()` wraps a
campaign, and `Fleet([c]).sweep(...)` reproduces `c.sweep(...)` row for
row.  `simulate_fleet` is the sequential per-slot oracle the grouped
engine is validated against (<0.5 %, tests/test_fleet.py).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import model
from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.device import reject_unported
from repro_torch.core.engine import SweepCase, case_slots_per_hour, sweep
from repro_torch.core.policy import TimeBands
from repro_torch.core.schedule import (AllocationSchedule, Schedule,
                                 SchedulingContext, as_schedule,
                                 dedupe_names as _dedupe_names)
from repro_torch.core.signal import (Signal, SignalSet, as_ensemble, as_trace,
                               carbon_signal, default_signals)
from repro_torch.core.simulator import SimResult, ensemble_stats, fill_deltas


@dataclasses.dataclass(frozen=True)
class Site:
    """The shared execution environment of a fleet of campaigns.

    `power_cap_kw` is the site's power envelope (None = unconstrained);
    `office_kw` the peak office/background draw in kW, scaled over the
    day by the band background curve (the same contention signal the
    campaigns see); `bands`/`carbon`/`price` are the one `SignalSet`
    every campaign of the fleet shares.
    """
    power_cap_kw: Optional[float] = None
    office_kw: float = 0.0
    bands: TimeBands = TimeBands()
    carbon: Optional[object] = None          # GridCarbonModel or Signal
    price: Optional[Signal] = None
    name: str = "site"

    def __post_init__(self):
        if self.power_cap_kw is not None and self.power_cap_kw <= 0.0:
            raise ValueError(f"power_cap_kw must be positive kW or None, "
                             f"got {self.power_cap_kw}")
        if self.office_kw < 0.0:
            raise ValueError(f"office_kw must be >= 0, got {self.office_kw}")

    @property
    def signals(self) -> SignalSet:
        return default_signals(self.bands, self.carbon or GridCarbonModel(),
                               self.price)

    def office_draw_kw(self, hour: float) -> float:
        """Office draw at an absolute hour (follows the band background)."""
        return self.office_kw * self.bands.background(
            self.bands.band_at(hour % 24.0))

    def headroom_kw(self, hour: float) -> float:
        """Power left for campaigns at an absolute hour (inf when uncapped)."""
        if self.power_cap_kw is None:
            return math.inf
        return self.power_cap_kw - self.office_draw_kw(hour)


@dataclasses.dataclass
class SiteRollup:
    """Site-level totals of one fleet execution: makespan, summed
    energy/CO2/cost, and (coupled runs) the peak total site draw."""
    runtime_h: float                  # makespan: max over campaigns
    energy_kwh: float                 # summed over campaigns
    co2_kg: float
    cost_usd: Optional[float] = None
    peak_kw: Optional[float] = None   # office + fleet; None when untracked
    n_campaigns: int = 0
    co2_ensemble: Optional[object] = None   # EnsembleStats of summed CO2


@dataclasses.dataclass
class FleetResult:
    """One fleet case's outcome: per-campaign `SimResult`s + site rollup."""
    policy: str
    campaigns: List[SimResult]
    site: SiteRollup


def _rollup(name: str, members: Sequence[SimResult],
            peak_kw: Optional[float] = None) -> SiteRollup:
    cost = (sum(r.cost_usd for r in members)
            if all(r.cost_usd is not None for r in members) else None)
    co2_ens = None
    if all(r.co2_ensemble is not None for r in members):
        samples = np.sum([r.co2_ensemble.samples for r in members], axis=0)
        co2_ens = ensemble_stats(samples)
    return SiteRollup(
        runtime_h=max(r.runtime_h for r in members),
        energy_kwh=sum(r.energy_kwh for r in members),
        co2_kg=sum(r.co2_kg for r in members),
        cost_usd=cost, peak_kw=peak_kw, n_campaigns=len(members),
        co2_ensemble=co2_ens)


# ---------------------------------------------------------------------------
# The grouped-lane fleet sweep (engine-level entry point)
# ---------------------------------------------------------------------------
def fleet_sweep(fleet_cases: Sequence[Sequence[SweepCase]],
                site: Site, price: Optional[Signal] = None, *,
                names: Optional[Sequence[str]] = None,
                progress_buckets: int = 32, max_days: int = 240,
                backend: Optional[str] = None,
                chunk_days: Optional[int] = None,
                precision: str = "fp64",
                devices: Optional[int] = None,
                cache_dir: Optional[str] = None,
                device=None) -> List[FleetResult]:
    """Evaluate fleet cases (each a group of M member `SweepCase`s) on
    the grouped-lane trace engine; order is preserved.

    Every group shares `site`'s cap/office draw; with no cap the flat
    batch runs through the regular `sweep()` dispatcher (periodic cases
    keep the cheap 24-slot path, and results are bitwise-identical to
    sweeping the members independently).

    `precision` is the engine's dtype policy (see
    `engine_torch.compile_plan`) and `device` where the scan runs (the
    card by default; "cpu" runs the kernels' plain PyTorch versions).
    `cache_dir` points plan compilation at a persistent on-disk cache
    (see `engine_torch.compile_plan`).  `backend` and `devices` > 1 are
    not ported yet and raise.
    """
    reject_unported(devices=devices, backend=backend)
    if not len(fleet_cases):
        return []
    flat: List[SweepCase] = [c for grp in fleet_cases for c in grp]
    sizes = [len(grp) for grp in fleet_cases]
    if names is None:
        names = [grp[0].name() for grp in fleet_cases]
    if site.power_cap_kw is None:
        res = sweep(flat, price=price, progress_buckets=progress_buckets,
                    max_days=max_days, precision=precision, device=device,
                    cache_dir=cache_dir)
        out = []
        i = 0
        for name, M in zip(names, sizes):
            members = res[i:i + M]
            out.append(FleetResult(policy=name, campaigns=members,
                                   site=_rollup(name, members)))
            i += M
        return out

    from repro_torch.core.engine_torch import (compile_plan, execute_plan,
                                               summarize_plan)
    sph = 1
    for c in flat:
        sph = math.lcm(sph, case_slots_per_hour(c))
    G = len(fleet_cases)
    plan = compile_plan(flat, price, slots_per_hour=sph,
                        progress_buckets=progress_buckets, max_days=max_days,
                        group_sizes=sizes,
                        group_caps_kw=[site.power_cap_kw] * G,
                        group_office_kw=[site.office_kw] * G,
                        precision=precision, cache_dir=cache_dir)
    state = execute_plan(plan, chunk_days=chunk_days, device=device)
    res = summarize_plan(plan, state)
    out = []
    i = 0
    for g, (name, M) in enumerate(zip(names, sizes)):
        members = res[i:i + M]
        lanes = np.flatnonzero(plan.lane_group == g)
        peak = float(state.site_kw_peak[lanes].max())
        out.append(FleetResult(policy=name, campaigns=members,
                               site=_rollup(name, members, peak_kw=peak)))
        i += M
    return out


# ---------------------------------------------------------------------------
# Sequential per-slot oracle (the grouped engine's accuracy reference)
# ---------------------------------------------------------------------------
def simulate_fleet(cases: Sequence[SweepCase], site: Site,
                   price: Optional[Signal] = None, *,
                   slots_per_hour: int = 1,
                   max_days: int = 240) -> FleetResult:
    """Step M campaigns jointly, slot by slot, in plain Python.

    The reference implementation of site-coupled execution: per slot,
    every running campaign's schedule decides its demand from a full
    `SchedulingContext` (exact progress, and live site fields —
    `site_power_kw`, `site_headroom`, `n_active`), the summed demanded
    draw is curtailed by `model.site_throttle` against the slot's
    headroom, and the physics advances.  The grouped-lane engine is
    pinned against this oracle to <0.5 % (its decision tables quantize
    progress into buckets; the coupling arithmetic is identical).
    """
    M = len(cases)
    if not M:
        raise ValueError("simulate_fleet needs at least one case")
    if len({c.start_hour for c in cases}) > 1:
        raise ValueError("fleet campaigns share the site clock: all cases "
                         "must have the same start_hour")
    sph = int(slots_per_hour)
    start = float(cases[0].start_hour)
    g0 = math.floor(start * sph) / sph
    scheds = [as_schedule(c.schedule) for c in cases]
    carbon_sig = carbon_signal(site.carbon or GridCarbonModel())
    bands = site.bands
    cap = site.power_cap_kw if site.power_cap_kw is not None else math.inf

    remaining = np.array([float(c.workload.n_scenarios) for c in cases])
    n_scen = remaining.copy()
    rt = np.zeros(M)
    kwh = np.zeros(M)
    co2 = np.zeros(M)
    cost = np.zeros(M)
    peak_kw = 0.0
    prev_site_kw = site.office_draw_kw(g0)

    for t in range(int(max_days) * 24 * sph):
        active = remaining > 1e-6 * n_scen
        if not active.any():
            break
        t_abs = g0 + t / sph
        slot_s = (3600.0 / sph if t else (g0 + 1.0 / sph - start) * 3600.0)
        hod = t_abs % 24.0
        band = bands.band_at(hod)
        bg = bands.background(band)
        cf = float(carbon_sig.at(t_abs))
        pr = float(price.at(t_abs)) if price is not None else 0.0
        office = site.office_kw * bg
        headroom = cap - office
        n_active = int(active.sum())
        head_frac = (1.0 if not math.isfinite(cap)
                     else max(cap - prev_site_kw, 0.0) / cap)

        # demands: every running campaign decides from the full context
        u = np.zeros(M)
        bt = np.ones(M)
        for m in range(M):
            if not active[m]:
                continue
            ctx = SchedulingContext(
                hour_of_day=hod, band=band, background=bg, carbon_factor=cf,
                price_usd_per_kwh=pr,
                elapsed_h=max(t_abs - start, 0.0),
                progress=1.0 - remaining[m] / n_scen[m],
                deadline_h=cases[m].deadline_h,
                site_power_kw=prev_site_kw, site_headroom=head_frac,
                n_active=n_active)
            d = scheds[m].decide(ctx)
            u[m], bt[m] = d.intensity, d.batch_size

        rates = [model.campaign_rates(u[m], bt[m], bg, cases[m].workload,
                                      cases[m].machine) for m in range(M)]
        base = sum(model.power_w(bg, cases[m].machine.idle_w,
                                 cases[m].machine.dyn_w,
                                 cases[m].machine.alpha) / 1000.0
                   for m in range(M) if active[m])
        f = 1.0
        cur = rates
        for _ in range(model.SITE_THROTTLE_ITERS):
            fleet_kw = sum(r.p_avg_w / 1000.0
                           for m, r in enumerate(cur) if active[m])
            f = model.site_throttle(fleet_kw, base, headroom, f)
            cur = [model.campaign_rates(u[m] * f, bt[m], bg,
                                        cases[m].workload, cases[m].machine)
                   for m in range(M)]
        site_kw = office
        for m in range(M):
            if not active[m]:
                continue
            r2 = cur[m]
            dt = min(slot_s, remaining[m] / max(r2.scen_per_s, 1e-30))
            e = r2.kwh_per_s * dt
            remaining[m] -= r2.scen_per_s * dt
            rt[m] += dt
            kwh[m] += e
            co2[m] += e * cf
            cost[m] += e * pr
            site_kw += r2.p_avg_w / 1000.0
        peak_kw = max(peak_kw, site_kw)
        prev_site_kw = site_kw
    # checked after the loop (not for/else): a fleet finishing in the
    # very last allowed slot exhausts the range without re-entering it
    if (remaining > 1e-6 * n_scen).any():
        worst = int(np.argmax(remaining / n_scen))
        raise RuntimeError(
            f"fleet case {cases[worst].name()!r} did not finish within "
            f"max_days={max_days} under the site cap")

    members = [SimResult(policy=c.name(), runtime_h=rt[m] / 3600.0,
                         energy_kwh=float(kwh[m]), co2_kg=float(co2[m]),
                         cost_usd=(float(cost[m]) if price is not None
                                   else None))
               for m, c in enumerate(cases)]
    name = cases[0].name()
    return FleetResult(policy=name, campaigns=members,
                       site=_rollup(name, members, peak_kw=float(peak_kw)))


# ---------------------------------------------------------------------------
# The session object
# ---------------------------------------------------------------------------
class Fleet:
    """N campaigns bound to one `Site` — the M-campaigns axis of the
    session API.

    Campaign-level knobs (workload, machine, calibration, start hour)
    come from the member `Campaign`s; the fleet replaces their
    individual signals with the site's shared ones.  `Campaign` is the
    M=1 special case: `Fleet([c]).sweep(scheds)` reproduces
    `c.sweep(scheds)` exactly (with no site cap the same engine
    dispatch runs the same lanes).
    """

    def __init__(self, campaigns: Sequence, site: Optional[Site] = None,
                 *, name: Optional[str] = None,
                 out_dir: Optional[str] = None,
                 cache_dir: Optional[str] = None):
        if not len(campaigns):
            raise ValueError("Fleet needs at least one campaign")
        self.campaigns = list(campaigns)
        if site is None:
            c0 = self.campaigns[0]
            site = Site(bands=c0.bands, carbon=c0.carbon, price=c0.price)
        self.site = site
        if site.power_cap_kw is not None:
            starts = {c.start_hour for c in self.campaigns}
            if len(starts) > 1:
                raise ValueError(
                    f"campaigns under a site cap share the site clock; got "
                    f"start_hours {sorted(starts)}")
        self.name = name or "+".join(
            getattr(c.workload, "name", c.name) for c in self.campaigns)
        self.out_dir = out_dir
        self.cache_dir = cache_dir

    @property
    def n_campaigns(self) -> int:
        return len(self.campaigns)

    # ------------------------------------------------------------------
    def _member_schedules(self, assignment) -> Tuple[str, List[Schedule]]:
        """(label, M per-campaign schedules) for one fleet assignment:
        an `AllocationSchedule`, a single Schedule (broadcast), or a
        sequence of exactly M schedules."""
        M = self.n_campaigns
        if isinstance(assignment, AllocationSchedule):
            return assignment.name, [as_schedule(s)
                                     for s in assignment.for_fleet(M)]
        if isinstance(assignment, (list, tuple)):
            if len(assignment) != M:
                raise ValueError(
                    f"per-campaign assignment needs {M} schedules "
                    f"(one per campaign), got {len(assignment)}")
            scheds = [as_schedule(s) for s in assignment]
            names = [s.name for s in scheds]
            label = (names[0] if len(set(names)) == 1
                     else "|".join(names))
            return label, scheds
        s = as_schedule(assignment)
        return s.name, [s] * M

    def _cases(self, scheds: Sequence[Schedule], *, carbon, deadlines,
               label: str) -> List[SweepCase]:
        dls = self._deadlines(deadlines)
        out = []
        for m, (c, s) in enumerate(zip(self.campaigns, scheds)):
            wl, mach = c.calibrated()
            out.append(SweepCase(
                s, wl, mach, self.site.bands, carbon, c.start_hour,
                label=f"{label}/{getattr(wl, 'name', c.name)}",
                deadline_h=dls[m]))
        return out

    def _deadlines(self, deadlines) -> List[float]:
        M = self.n_campaigns
        if deadlines is None:
            return [0.0] * M
        if np.ndim(deadlines) == 0:
            return [float(deadlines)] * M
        if len(deadlines) != M:
            raise ValueError(f"deadlines needs {M} entries (one per "
                             f"campaign), got {len(deadlines)}")
        return [float(d) for d in deadlines]

    def _carbon(self, carbon_trace, carbon_ensemble):
        if carbon_trace is not None and carbon_ensemble is not None:
            raise ValueError("pass either carbon_trace= or "
                             "carbon_ensemble=, not both")
        if carbon_ensemble is not None:
            return as_ensemble(carbon_ensemble, name="carbon-ensemble")
        if carbon_trace is not None:
            return as_trace(carbon_trace, name="carbon-trace")
        return self.site.carbon or GridCarbonModel()

    # ------------------------------------------------------------------
    def sweep(self, assignments: Sequence, *,
              deadlines=None,
              carbon_trace=None, carbon_ensemble=None,
              zones=None,
              window_h: Optional[int] = None,
              stride_h: Optional[int] = None,
              deltas: bool = False,
              backend: Optional[str] = None,
              max_days: int = 240,
              precision: str = "fp64",
              devices: Optional[int] = None,
              device=None) -> List[FleetResult]:
        """Evaluate fleet assignments jointly under the site.

        Each assignment is an `AllocationSchedule`, a single schedule
        (applied to every campaign), or a sequence of M per-campaign
        schedules; each yields one `FleetResult` (M per-campaign
        `SimResult`s + a site rollup).  Duplicate assignment labels are
        disambiguated with an indexed suffix.  `deadlines` is a scalar
        or one deadline per campaign, surfaced via `ctx.deadline_h`;
        `carbon_trace`/`carbon_ensemble` swap the site's carbon signal
        exactly like `Campaign.sweep`.  With a site cap the grouped-lane
        trace engine couples the campaigns each slot (kernel K1 on the
        card); with `power_cap_kw=None` results are identical to
        sweeping each campaign independently.  `deltas=True` fills each
        member's delta columns vs its own standalone calibrated
        baseline.  `device` is where the sweep runs (the card by
        default).  `backend` and `devices` > 1 are not ported yet and
        raise.

        `zones=` (a `CarbonArchive` or {zone: series} mapping; mutually
        exclusive with the other carbon arguments) expands every
        assignment across N real grid zones in the same batched plan:
        one `FleetResult` per (assignment, zone), labeled
        `"<assignment>@<zone>"`, each zone's group carrying that zone's
        hourly trace (or, with `window_h`/`stride_h`, its sliding-window
        ensemble).  Zone groups ride the same grouped-lane plan (K1 on
        the card under a cap) and the plan cache unchanged.
        """
        assignments = list(assignments)
        if not assignments:
            raise ValueError("Fleet.sweep needs at least one assignment "
                             "(got an empty sequence)")
        resolved = [self._member_schedules(a) for a in assignments]
        labels = _dedupe_names([label for label, _ in resolved])
        if zones is not None:
            if carbon_trace is not None or carbon_ensemble is not None:
                raise ValueError("pass only one of carbon_trace=, "
                                 "carbon_ensemble=, zones=")
            from repro_torch.core.session import _zone_signals
            pairs = _zone_signals(zones, window_h, stride_h)
            groups = [self._cases(scheds, carbon=sig, deadlines=deadlines,
                                  label=f"{lbl}@{z}")
                      for (_, scheds), lbl in zip(resolved, labels)
                      for z, sig in pairs]
            labels = [f"{lbl}@{z}" for lbl in labels for z, _ in pairs]
        else:
            if window_h is not None or stride_h is not None:
                raise ValueError("window_h=/stride_h= shape the per-zone "
                                 "ensembles and need zones=")
            carbon = self._carbon(carbon_trace, carbon_ensemble)
            groups = [self._cases(scheds, carbon=carbon,
                                  deadlines=deadlines, label=lbl)
                      for (_, scheds), lbl in zip(resolved, labels)]
        out = fleet_sweep(groups, self.site, price=self.site.price,
                          names=labels, backend=backend, max_days=max_days,
                          precision=precision, devices=devices,
                          cache_dir=self.cache_dir, device=device)
        if deltas:
            for fr in out:
                for c, r in zip(self.campaigns, fr.campaigns):
                    fill_deltas([r], c.baseline())
        return out

    def frontier(self, assignments: Optional[Sequence] = None, *,
                 deadlines=None, render: bool = False,
                 device=None) -> List[FleetResult]:
        """The fleet Figure-1 table: bundled policies (or the given
        assignments) applied fleet-wide, with per-campaign deltas vs
        each campaign's standalone baseline and a site rollup per row."""
        from repro_torch.core.policy import POLICIES
        if assignments is None:
            assignments = list(POLICIES.values())
        out = self.sweep(assignments, deadlines=deadlines, deltas=True,
                         device=device)
        if render and self.out_dir:
            from repro_torch.core.dashboard import render_frontier_dashboard
            rows = [r for fr in out for r in fr.campaigns]
            render_frontier_dashboard(
                rows, self.out_dir, title=f"fleet {self.name}",
                site_rollups=[(fr.policy, fr.site) for fr in out])
        return out

    # ------------------------------------------------------------------
    def run(self, assignment=None, *, deadlines=None,
            render: Optional[bool] = None, device=None) -> FleetResult:
        """Execute the fleet once under one assignment (default: each
        campaign's own schedule), via the grouped engine."""
        if assignment is None:
            assignment = [c.schedule for c in self.campaigns]
        res = self.sweep([assignment], deadlines=deadlines,
                         device=device)[0]
        if (render if render is not None else bool(self.out_dir)):
            from repro_torch.core.dashboard import render_frontier_dashboard
            out = self.out_dir or os.path.join("experiments", self.name)
            render_frontier_dashboard(
                res.campaigns, out, title=f"fleet {self.name}",
                site_rollups=[(res.policy, res.site)])
        return res

    # ------------------------------------------------------------------
    def optimize(self, objective="co2", *, constraints=None,
                 deadlines=None, carbon_trace=None, device=None, **kwargs):
        """Synthesize a *joint* schedule for the whole fleet.

        Searches the joint `ParametricSchedule` space — one M x n_slots
        logit block, campaign m's day schedule in row m — against the
        coupled fleet objective (`FleetTraceObjective`): site metrics
        are summed over campaigns and `deadlines` become per-campaign
        runtime caps.  An active site cap is enforced by the physical
        curtailment *inside* the objective (no soft constraint is
        added — idle/office draw cannot be shed, so the reported peak
        may sit slightly above an unreachable cap); to plan under a
        peak *budget* without curtailment, drop the cap from the Site
        and pass `constraints={"site_peak_kw": budget}`.  By default
        the search warm-starts from the independently-optimized
        per-campaign schedules (`init="independent"`), so the joint
        result is never worse than running the members' own optima
        under the shared cap.

        Returns a `FleetOptimizeResult`: `.schedules` (M drop-in
        `ParametricSchedule`s), `.results`/`.site` (per-campaign
        `SimResult`s + rollup, evaluated by the grouped-lane engine),
        plus the usual optimizer fields.  `device` is where it runs (the
        card by default); remaining kwargs go to `optimize_fleet`
        (method, candidates, iterations, steps, lr, u_min/u_max, seed,
        ...).
        """
        from repro_torch.core.optimize import optimize_fleet
        carbon = self._carbon(carbon_trace, None)
        dls = self._deadlines(deadlines)
        cases = self._cases([c.schedule for c in self.campaigns],
                            carbon=carbon, deadlines=dls, label="fleet")
        return optimize_fleet(
            cases, site=self.site, objective=objective,
            constraints=constraints, price=self.site.price, device=device,
            **kwargs)

    def run_mpc(self, carbon_trace=None, objective="co2", *,
                constraints=None, deadlines=None, forecast="oracle",
                replan_every_h=24.0, backend=None, chunk_days=None,
                device=None, **kwargs):
        """Run the fleet closed-loop under receding-horizon MPC.

        The M-campaign analogue of `Campaign.run_mpc`: every
        `replan_every_h` hours (None/inf = open loop) the *unfinished*
        campaigns' remaining workloads are jointly re-optimized via
        `optimize_fleet` against a fresh `forecast` of the ground-truth
        trace (`carbon_trace`, defaulting to the site's carbon),
        warm-started from the incumbent schedules, and the grouped-lane
        plan resumes from carried state — already-executed slots are
        never recomputed.  `deadlines` (scalar or per-campaign, all
        finite) define the receding horizons.  `device` is where every
        solve and every control interval runs (the card by default);
        `backend=` raises.  Remaining keyword arguments configure every
        `optimize_fleet` solve.

        Returns an `MPCResult` whose `.result` is a `FleetResult`
        (per-campaign `SimResult`s + site rollup) realized against the
        truth.
        """
        from repro_torch.core.mpc import FleetMPCSession
        truth = self._carbon(carbon_trace, None)
        dls = self._deadlines(deadlines)
        cases = self._cases([c.schedule for c in self.campaigns],
                            carbon=truth, deadlines=dls, label="mpc")
        return FleetMPCSession(
            cases, self.site, truth, objective=objective,
            constraints=constraints, forecast=forecast,
            replan_every_h=replan_every_h, price=self.site.price,
            backend=backend, chunk_days=chunk_days,
            cache_dir=self.cache_dir, solver=kwargs, device=device).run()


__all__ = ["Fleet", "FleetResult", "Site", "SiteRollup", "fleet_sweep",
           "simulate_fleet"]
