"""The CARINA session API: one object that owns the whole pipeline.

    import repro_torch.carina as carina
    report = carina.Campaign(OEM_CASE_1, PEAK_AWARE_BOOSTED).run()

A `Campaign` binds a workload to a schedule and a machine, and owns
everything the examples used to hand-wire: calibration against the
measured baseline, run tracking, carbon/price translation, dashboard
rendering, the Figure-1 frontier, vectorized sweeps, and (for training
workloads) a fully wired `CarinaController`.

Simulation campaigns (OEMWorkload):
    Campaign(workload, schedule).run()          -> CampaignReport
    Campaign(workload).frontier()               -> six-policy Figure-1 table
    Campaign(workload).sweep(schedules)         -> vectorized many-schedule pass
                                                   (on the card by default)
    Campaign(workload).optimize("co2", deadline_h=200)
                                                -> synthesized schedule
                                                   (core/optimize.py)
    Campaign(workload).run_mpc(truth, "co2", deadline_h=200)
                                                -> receding-horizon MPC
                                                   (core/mpc.py)
    Campaign(workload).sweep(schedules, zones=archive)
                                                -> (schedule x zone) sweep
                                                   (core/data.py)
    Campaign(workload).calibrate(log_path)      -> fitted rate/power model
                                                   (core/calibrate.py)

Training campaigns (TrainingCampaign):
    c = Campaign(training_workload, schedule)
    controller = c.controller(max_replicas=n_dev, clock=SimClock(...))
    run_training(..., controller=controller)
    c.finish()                                  -> summary + dashboard
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.controller import CarinaController, SimClock
from repro_torch.core.dashboard import render_frontier_dashboard, render_run_dashboard
from repro_torch.core.energy import ChipProfile, MachineProfile, StepCost
from repro_torch.core.engine import SweepCase, frontier_from_sweep, sweep
from repro_torch.core.policy import BASELINE, POLICIES, TimeBands
from repro_torch.core.schedule import Schedule, as_schedule, dedupe_names
from repro_torch.core.signal import (Signal, SignalSet, as_ensemble, as_trace,
                               default_signals)
from repro_torch.core.simulator import (SimResult, calibrate_workload, fill_deltas,
                                  simulate_campaign, simulate_campaign_exact)
from repro_torch.core.tracker import RunSummary, RunTracker
from repro_torch.core.workload import OEMWorkload, TrainingCampaign


@dataclasses.dataclass
class CampaignReport:
    """What a finished campaign hands back."""
    result: SimResult
    summary: Optional[RunSummary] = None
    dashboard_dir: Optional[str] = None


def _zone_signals(zones, window_h: Optional[int],
                  stride_h: Optional[int]) -> List[tuple]:
    """Normalize a `zones=` argument into ordered (name, signal) pairs.

    Accepts a `CarbonArchive` (every zone, archive order) or a mapping
    of zone name -> `ZoneSeries` / Signal / hourly sequence.  Without
    `window_h` each zone lowers to its hourly trace; with it, to a
    sliding-window ensemble (the (S, E, zone) sweep shape).  Shared by
    `Campaign.sweep` and `Fleet.sweep`.
    """
    from repro_torch.core.data import CarbonArchive, ZoneSeries
    from repro_torch.core.signal import trace_windows
    if isinstance(zones, CarbonArchive):
        items = [(s.zone, s) for s in zones]
    elif isinstance(zones, dict):
        items = list(zones.items())
    else:
        raise TypeError(
            f"zones= takes a CarbonArchive or a {{zone: series}} "
            f"mapping, got {type(zones).__name__}")
    if not items:
        raise ValueError("zones= needs at least one zone")
    out = []
    for zname, v in items:
        if isinstance(v, ZoneSeries):
            sig = (v.to_ensemble(window_h, stride_h) if window_h
                   else v.to_trace())
        elif window_h:
            sig = trace_windows(v, window_h, stride_h,
                                name=f"carbon:{zname}")
        else:
            sig = as_trace(v, name=f"carbon:{zname}")
        out.append((str(zname), sig))
    return out


class Campaign:
    """A workload bound to a schedule, a machine, and its input signals."""

    def __init__(self, workload, schedule=BASELINE,
                 machine: Optional[MachineProfile] = None, *,
                 bands: TimeBands = TimeBands(),
                 carbon: Optional[GridCarbonModel] = None,
                 price: Optional[Signal] = None,
                 start_hour: float = 9.0,
                 calibrate: bool = True,
                 name: Optional[str] = None,
                 out_dir: Optional[str] = None,
                 cache_dir: Optional[str] = None):
        self.workload = workload
        self.schedule: Schedule = as_schedule(schedule)
        self.machine = machine or MachineProfile()
        self.bands = bands
        self.carbon = carbon or GridCarbonModel()
        self.price = price
        self.start_hour = start_hour
        # the ctor flag keeps its public name; the attribute is
        # auto_calibrate so the measured-run `calibrate()` *method* can
        # exist (the bool gates the measured-baseline solve below, the
        # method fits the full rate/power model from tracker logs)
        self.auto_calibrate = calibrate
        self.name = name or f"{getattr(workload, 'name', 'campaign')}" \
                            f"-{self.schedule.name}"
        self.out_dir = out_dir
        self.cache_dir = cache_dir
        self.tracker: Optional[RunTracker] = None
        self._calibrated: Optional[Tuple[OEMWorkload, MachineProfile]] = None
        self._baselines: dict = {}

    # ------------------------------------------------------------------
    @property
    def signals(self) -> SignalSet:
        return default_signals(self.bands, self.carbon, self.price)

    def calibrated(self) -> Tuple[OEMWorkload, MachineProfile]:
        """(workload, machine) with the measured baseline solved in; cached."""
        if self._calibrated is None:
            wl, m = self.workload, self.machine
            if (self.auto_calibrate and isinstance(wl, OEMWorkload)
                    and wl.measured_hours and wl.measured_kwh):
                wl, m = calibrate_workload(wl, m, self.bands)
            self._calibrated = (wl, m)
        return self._calibrated

    def baseline(self, exact: bool = False) -> SimResult:
        """The calibrated BASELINE run (reference for delta columns).
        `exact=True` gives the per-batch-oracle baseline so exact-mode
        deltas compare like against like."""
        key = "exact" if exact else "coarse"
        if key not in self._baselines:
            wl, m = self.calibrated()
            simulate = simulate_campaign_exact if exact else simulate_campaign
            self._baselines[key] = simulate(
                wl, BASELINE, m, self.bands, self.carbon, self.start_hour,
                price=self.price)
        return self._baselines[key]

    def calibrate(self, log_path: Optional[str] = None, *, units=None,
                  fit=None, steps: int = 500, lr: float = 0.1,
                  bootstrap: int = 0, seed: int = 0,
                  backend: Optional[str] = None, apply: bool = False,
                  device=None):
        """Fit the rate/power model to a measured run (RunTracker log).

        Reads `log_path` (default: this campaign's `out_dir/units.jsonl`,
        the log `run(track=True)` writes), lifts the units into observed
        (throughput, power) targets, and fits `core/model.py`'s
        parameters starting from this campaign's configured values —
        Adam through `torch.autograd` on `device` (the card by default;
        `core/calibrate.py`), or with `backend="numpy"` the
        finite-difference mirror on the host (`backend="jax"` raises).
        `bootstrap` > 0 adds seeded unit-resampling confidence
        intervals (refits on the host mirror).  Returns a
        `CalibratedModel`; with `apply=True` the fitted (workload,
        machine) replace this campaign's calibrated pair, so subsequent
        sweep/optimize/run calls use the measured physics.  Pass
        `units=` (a `UnitRecord` sequence, e.g. a live tracker's
        `.records`) to skip the disk round-trip.
        """
        from repro_torch.core.calibrate import (FIT_PARAMS, fit_calibration,
                                                observations_from_units)
        from repro_torch.core.tracker import load_units
        source = log_path
        if units is None:
            source = log_path or (os.path.join(self.out_dir, "units.jsonl")
                                  if self.out_dir else None)
            if source is None or not os.path.exists(source):
                raise ValueError(
                    "Campaign.calibrate needs a measured run: pass "
                    "log_path= (a RunTracker JSONL), or run(track=True) "
                    "with out_dir set first, or pass units= directly")
            units = load_units(source)
        obs = observations_from_units(units, self.bands)
        cm = fit_calibration(
            obs, self.workload, self.machine,
            fit=tuple(fit) if fit is not None else FIT_PARAMS,
            steps=steps, lr=lr, bootstrap=bootstrap, seed=seed,
            backend=backend, source=source,
            zone=getattr(self.carbon, "zone", None), device=device)
        if apply:
            self._calibrated = cm.apply(self.workload, self.machine)
            self._baselines = {}       # stale vs the fitted physics
        return cm

    # ------------------------------------------------------------------
    # Simulation campaigns
    # ------------------------------------------------------------------
    def run(self, *, track: bool = False, exact: bool = False,
            render: Optional[bool] = None) -> CampaignReport:
        """Execute the campaign under this schedule.

        Fills the delta-vs-baseline columns, records per-segment units when
        `track` (or an `out_dir` JSONL log) is requested, and renders the
        run dashboard into `out_dir` when one is set.  `exact=True` runs
        the per-batch oracle instead of the segment simulator; the oracle
        does not record units, so it cannot be combined with tracking.
        """
        if not isinstance(self.workload, OEMWorkload):
            raise TypeError(
                "Campaign.run() simulates OEMWorkload campaigns; for a "
                "TrainingCampaign use Campaign.controller() with "
                "repro.training.loop.run_training")
        if exact and track:
            raise ValueError("track=True needs the segment simulator; the "
                             "per-batch oracle (exact=True) does not record "
                             "units")
        wl, m = self.calibrated()
        tracker = None
        if not exact and (track or self.out_dir):
            log = (os.path.join(self.out_dir, "units.jsonl")
                   if self.out_dir else None)
            tracker = RunTracker(self.name, carbon=self.carbon, log_path=log)
            self.tracker = tracker
        if exact:
            res = simulate_campaign_exact(wl, self.schedule, m, self.bands,
                                          self.carbon, self.start_hour,
                                          price=self.price)
        else:
            res = simulate_campaign(wl, self.schedule, m, self.bands,
                                    self.carbon, self.start_hour,
                                    tracker=tracker, price=self.price)
        fill_deltas([res], self.baseline(exact=exact))
        summary = tracker.close() if tracker else None
        dash = None
        if render if render is not None else bool(self.out_dir):
            dash = self.out_dir or os.path.join("experiments", self.name)
            if summary is not None:
                render_run_dashboard(summary, dash)
            render_frontier_dashboard([res], dash, title=self.name)
        return CampaignReport(result=res, summary=summary, dashboard_dir=dash)

    def frontier(self, schedules: Optional[Sequence] = None,
                 render: bool = False) -> List[SimResult]:
        """The Figure-1 table: each schedule vs the calibrated baseline.

        With the default schedule set this reproduces `policy_frontier`
        float-for-float (same sequential code path, same calibration).
        """
        schedules = (list(schedules) if schedules is not None
                     else list(POLICIES.values()))
        if not schedules:
            raise ValueError("Campaign.frontier needs at least one schedule "
                             "(got an empty sequence); omit the argument "
                             "for the bundled policy set")
        wl, m = self.calibrated()
        base = self.baseline()
        out = []
        for s in schedules:
            s = as_schedule(s)
            # reuse the cached baseline only for the bundled BASELINE object;
            # a user schedule merely *named* "baseline" is still simulated
            out.append(base if s is BASELINE
                       else simulate_campaign(wl, s, m, self.bands,
                                              self.carbon, self.start_hour,
                                              price=self.price))
        fill_deltas(out, base)
        # duplicate schedule names would collide in dashboards and any
        # name-keyed view of the table; renamed rows are copies so the
        # cached baseline object keeps its canonical name
        names = dedupe_names([r.policy for r in out])
        out = [r if r.policy == n else dataclasses.replace(r, policy=n)
               for r, n in zip(out, names)]
        if render and self.out_dir:
            render_frontier_dashboard(out, self.out_dir, title=self.name)
        return out

    def sweep(self, schedules: Sequence, *,
              carbons: Optional[Sequence] = None,
              workloads: Optional[Sequence[OEMWorkload]] = None,
              deltas: bool = False,
              carbon_trace=None,
              carbon_ensemble=None,
              zones=None,
              window_h: Optional[int] = None,
              stride_h: Optional[int] = None,
              deadline_h: float = 0.0,
              device=None) -> List[SimResult]:
        """Vectorized (schedule x workload x grid-curve) sweep.

        Uses the calibrated machine/rate; hundreds of candidate schedules
        evaluate in one batched pass (core/engine.py) on `device` (the
        card by default; "cpu" runs the kernels' plain PyTorch
        versions).  Order: the cartesian product iterates schedules
        fastest, then carbons, then workloads.  Cases representable on
        the periodic 24-slot grid take the closed-form path; everything
        else — progress/elapsed-aware schedules, trace signals — is
        routed to the trace-grid scan engine (core/engine_torch.py)
        automatically.

        `carbon_trace` accepts an hourly kg-CO2e/kWh sequence of any
        length (e.g. a week-long forecast; hour 0 = midnight of day 0) or
        a ready Signal, and replaces `carbons`.  `carbon_ensemble`
        accepts a `SignalEnsemble` (or an (E, T) array / list of traces;
        see `repro_torch.core.signal.as_ensemble` and `trace_windows`)
        and evaluates every schedule against all E carbon scenarios in
        one scan: results carry the ensemble-mean `co2_kg` plus
        per-member `EnsembleStats` in `co2_ensemble`.  A non-zero
        `deadline_h` is surfaced to every schedule via `ctx.deadline_h`.

        `zones=` opens the grid axis: a `CarbonArchive` (or a
        {zone: series} mapping) expands the sweep to (schedule x zone)
        in ONE batched plan — each zone contributes its hourly trace
        (or, with `window_h`/`stride_h`, its sliding-window scenario
        ensemble, making the sweep (S, E, zone)).  Rows are labeled
        `"<schedule>@<zone>"`, and results are bitwise-identical to
        sweeping each zone independently.  Mutually exclusive with the
        other carbon arguments.
        """
        exclusive = [n for n, v in (("carbons", carbons),
                                    ("carbon_trace", carbon_trace),
                                    ("carbon_ensemble", carbon_ensemble),
                                    ("zones", zones))
                     if v is not None]
        if len(exclusive) > 1:
            raise ValueError(f"pass only one of carbons=, carbon_trace=, "
                             f"carbon_ensemble=, zones=; got {exclusive}")
        zone_names = None
        if carbon_trace is not None:
            carbons = [as_trace(carbon_trace, name="carbon-trace")]
        elif carbon_ensemble is not None:
            carbons = [as_ensemble(carbon_ensemble, name="carbon-ensemble")]
        elif zones is not None:
            pairs = _zone_signals(zones, window_h, stride_h)
            zone_names = [z for z, _ in pairs]
            carbons = [sig for _, sig in pairs]
        elif window_h is not None or stride_h is not None:
            raise ValueError("window_h=/stride_h= shape the per-zone "
                             "ensembles and need zones=")
        schedules = [as_schedule(s) for s in schedules]
        if not schedules:
            raise ValueError("Campaign.sweep needs at least one schedule "
                             "(got an empty sequence)")
        # duplicate names collide in dashboards and name-keyed result
        # views; disambiguated labels keep every row addressable
        labels = dedupe_names([s.name for s in schedules])
        wl0, m = self.calibrated()
        cases = []
        for wl in (workloads if workloads is not None else [wl0]):
            if wl is not wl0 and not wl.rate_at_full:
                wl = dataclasses.replace(wl, rate_at_full=wl0.rate_at_full)
            for ci, carbon in enumerate(carbons if carbons is not None
                                        else [self.carbon]):
                for s, lbl in zip(schedules, labels):
                    cases.append(SweepCase(
                        s, wl, m, self.bands, carbon, self.start_hour,
                        label=(f"{lbl}@{zone_names[ci]}" if zone_names
                               else lbl),
                        deadline_h=deadline_h))
        results = sweep(cases, price=self.price, cache_dir=self.cache_dir,
                        device=device)
        return (frontier_from_sweep(results, base=self.baseline())
                if deltas else results)

    def optimize(self, objective="co2", *, constraints=None,
                 deadline_h: float = 0.0, carbon_trace=None,
                 carbon_ensemble=None, robust: Optional[str] = None,
                 deltas: bool = False, device=None, **kwargs):
        """Synthesize a near-optimal schedule for this campaign.

        Searches the `ParametricSchedule` space (per-slot intensities)
        against the calibrated workload/machine on the trace-grid
        objective (core/optimize.py): gradient descent through the scan
        under `torch.autograd` for the smooth family, or a population/CEM
        search evaluating hundreds of candidates per objective call, on
        `device` (the card by default).

        `objective` is a metric name ("co2", "energy", "runtime",
        "cost"), a weights mapping for weighted-sum trade-offs, or an
        `Objective`; `constraints` maps metrics to caps
        (ε-constraints).  `deadline_h` is shorthand for a runtime cap —
        ``optimize("co2", deadline_h=200.0)`` reads *min CO2 subject to
        finishing in 200 h*.  `carbon_trace` swaps in a non-periodic
        hourly forecast exactly like `Campaign.sweep`; `carbon_ensemble`
        swaps in a whole scenario ensemble (`SignalEnsemble`, (E, T)
        array, or list of traces), and `robust` picks how the
        per-member CO2 collapses into the loss — ``"mean"`` (expected),
        ``"cvar"`` (tail mean at `cvar_alpha`, pass via kwargs), or
        ``"worst"``.  Remaining keyword arguments go to
        `optimize_schedule` (method, candidates, iterations, steps, lr,
        n_slots, u_min/u_max, levels, pareto, seed, cvar_alpha, ...).

        Returns an `OptimizeResult`: `.schedule` (a drop-in Schedule),
        `.result` (a SimResult comparable to sweep/frontier rows —
        delta columns filled vs the calibrated baseline when
        `deltas=True`), and `.frontier` (the population's Pareto set,
        when `pareto=True` with the cem method).
        """
        from repro_torch.core.engine import (case_slots_per_hour,
                                             periodic_decision_profile)
        from repro_torch.core.optimize import (canonical_metric,
                                               optimize_schedule)
        from repro_torch.core.schedule import ParametricSchedule
        wl, m = self.calibrated()
        if carbon_trace is not None and carbon_ensemble is not None:
            raise ValueError("pass either carbon_trace= or "
                             "carbon_ensemble=, not both")
        if carbon_ensemble is not None:
            carbon = as_ensemble(carbon_ensemble, name="carbon-ensemble")
        elif carbon_trace is not None:
            carbon = as_trace(carbon_trace, name="carbon-trace")
        else:
            carbon = self.carbon
        if robust is not None:
            kwargs["robust"] = robust
        # canonicalize aliases ("runtime", "deadline") BEFORE merging the
        # deadline_h shorthand, so an explicit user cap always wins and
        # the runtime cap is found for case.deadline_h below
        constraints = {canonical_metric(k): float(v)
                       for k, v in dict(constraints or {}).items()}
        if deadline_h:
            constraints.setdefault("runtime_h", float(deadline_h))
        case = SweepCase(self.schedule, wl, m, self.bands, carbon,
                         self.start_hour,
                         deadline_h=float(constraints.get("runtime_h", 0.0)))
        if "init" not in kwargs:
            # warm-start from this campaign's own schedule when it has a
            # closed-form day profile (gradient polish converges much
            # faster near a sensible incumbent than from a flat table);
            # sampled at the case's grid resolution so sub-hour band
            # edges are not aliased away
            prof = periodic_decision_profile(self.schedule, self.bands,
                                             case_slots_per_hour(case))
            if prof is not None:
                kwargs["init"] = prof[0]
            elif isinstance(self.schedule, ParametricSchedule):
                # a previous optimization's result IS a day profile:
                # refine the incumbent instead of restarting flat
                kwargs["init"] = self.schedule.intensity_table()
        out = optimize_schedule(case, objective, constraints,
                                price=self.price, device=device, **kwargs)
        if deltas:
            fill_deltas([out.result] + out.frontier, self.baseline())
        return out

    def run_mpc(self, carbon_trace=None, objective="co2", *,
                constraints=None, deadline_h: float = 0.0,
                forecast="oracle", replan_every_h=24.0,
                backend=None, chunk_days=None, device=None, **kwargs):
        """Run this campaign closed-loop under receding-horizon MPC.

        `carbon_trace` is the *ground truth* the campaign executes
        against (an hourly trace or Signal; defaults to the campaign's
        own carbon when that is a trace).  `forecast` names what the
        optimizer *sees* — ``"oracle"`` / ``"day_ahead"`` /
        ``"persistence"``, or any `repro_torch.core.signal.ForecastModel`
        — and every `replan_every_h` hours (None/inf = open loop) the
        remaining horizon is re-optimized from the carried executor
        state, warm-started from the incumbent schedule's intensity
        table.  A finite runtime cap is required (`deadline_h` or
        `constraints={"runtime_h": ...}`): the receding horizon is
        defined relative to it.  `device` is where every solve and
        every control interval runs (the card by default); `backend=`
        raises.  Remaining keyword arguments configure every
        `optimize_schedule` solve (method, candidates, iterations,
        seed, ...).

        Returns an `MPCResult` — realized vs planned CO2/energy,
        per-re-plan solve stats, and the realized forecast error.
        """
        from repro_torch.core.engine import (case_slots_per_hour,
                                             periodic_decision_profile)
        from repro_torch.core.mpc import MPCSession
        from repro_torch.core.optimize import canonical_metric
        from repro_torch.core.schedule import ParametricSchedule
        wl, m = self.calibrated()
        truth = (as_trace(carbon_trace, name="carbon-trace")
                 if carbon_trace is not None else self.carbon)
        constraints = {canonical_metric(k): float(v)
                       for k, v in dict(constraints or {}).items()}
        if deadline_h:
            constraints.setdefault("runtime_h", float(deadline_h))
        case = SweepCase(self.schedule, wl, m, self.bands, truth,
                         self.start_hour,
                         deadline_h=float(constraints.get("runtime_h", 0.0)))
        solver = dict(kwargs)
        if "init" not in solver:
            prof = periodic_decision_profile(self.schedule, self.bands,
                                             case_slots_per_hour(case))
            if prof is not None:
                solver["init"] = prof[0]
            elif isinstance(self.schedule, ParametricSchedule):
                solver["init"] = self.schedule.intensity_table()
        return MPCSession(case, truth, objective=objective,
                          constraints=constraints, forecast=forecast,
                          replan_every_h=replan_every_h, price=self.price,
                          backend=backend, chunk_days=chunk_days,
                          cache_dir=self.cache_dir, solver=solver,
                          device=device).run()

    # ------------------------------------------------------------------
    def as_fleet(self, site=None, **kwargs):
        """This campaign as an M=1 `Fleet` (the degenerate special case:
        `c.as_fleet().sweep(scheds)` reproduces `c.sweep(scheds)` row
        for row).  `site` is a `repro_torch.core.fleet.Site`; by default the
        fleet inherits this campaign's bands/carbon/price with no cap."""
        from repro_torch.core.fleet import Fleet
        return Fleet([self], site, **kwargs)

    # ------------------------------------------------------------------
    # Training campaigns
    # ------------------------------------------------------------------
    def controller(self, *, max_replicas: int = 1, min_replicas: int = 1,
                   clock: Optional[SimClock] = None,
                   chip: Optional[ChipProfile] = None,
                   step_cost: Optional[StepCost] = None,
                   granularity: str = "step",
                   log_units: bool = True) -> CarinaController:
        """A fully wired CarinaController sharing this campaign's schedule,
        bands, carbon/price signals and tracker (training/serving side)."""
        if self.tracker is not None:
            self.tracker.close()        # don't orphan a previous wiring's log
        log = (os.path.join(self.out_dir, "units.jsonl")
               if (self.out_dir and log_units) else None)
        self.tracker = RunTracker(self.name, carbon=self.carbon,
                                  granularity=granularity, log_path=log)
        if step_cost is None and isinstance(self.workload, TrainingCampaign):
            step_cost = self.workload.step_cost
        return CarinaController(
            policy=self.schedule, bands=self.bands, tracker=self.tracker,
            max_replicas=max_replicas, min_replicas=min_replicas,
            clock=clock or SimClock(start_hour=self.start_hour),
            chip=chip or ChipProfile(), step_cost=step_cost,
            carbon=self.carbon, price=self.price)

    def finish(self, render: bool = True) -> Optional[RunSummary]:
        """Close the tracker and render the run dashboard (if out_dir)."""
        if self.tracker is None:
            return None
        summary = self.tracker.close()
        if render and self.out_dir:
            render_run_dashboard(summary, self.out_dir)
        return summary
