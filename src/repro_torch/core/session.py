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
from repro_torch.core.device import reject_unported
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
        reject_unported(cache_dir=cache_dir)
        self.workload = workload
        self.schedule: Schedule = as_schedule(schedule)
        self.machine = machine or MachineProfile()
        self.bands = bands
        self.carbon = carbon or GridCarbonModel()
        self.price = price
        self.start_hour = start_hour
        # the ctor flag keeps its public name; the attribute is
        # auto_calibrate, as in the reference (which also has a measured-
        # run `calibrate()` method, not ported yet)
        self.auto_calibrate = calibrate
        self.name = name or f"{getattr(workload, 'name', 'campaign')}" \
                            f"-{self.schedule.name}"
        self.out_dir = out_dir
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
        """
        exclusive = [n for n, v in (("carbons", carbons),
                                    ("carbon_trace", carbon_trace),
                                    ("carbon_ensemble", carbon_ensemble))
                     if v is not None]
        if len(exclusive) > 1:
            raise ValueError(f"pass only one of carbons=, carbon_trace=, "
                             f"carbon_ensemble=; got {exclusive}")
        if carbon_trace is not None:
            carbons = [as_trace(carbon_trace, name="carbon-trace")]
        elif carbon_ensemble is not None:
            carbons = [as_ensemble(carbon_ensemble, name="carbon-ensemble")]
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
            for carbon in (carbons if carbons is not None
                           else [self.carbon]):
                for s, lbl in zip(schedules, labels):
                    cases.append(SweepCase(
                        s, wl, m, self.bands, carbon, self.start_hour,
                        label=lbl, deadline_h=deadline_h))
        results = sweep(cases, price=self.price, device=device)
        return (frontier_from_sweep(results, base=self.baseline())
                if deltas else results)

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
