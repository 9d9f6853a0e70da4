"""Receding-horizon MPC: rolling re-plan on the resumable executor.

The optimizer (core/optimize.py) plans once against a fully known carbon
trace; real grid signals are *forecasts* that go stale mid-campaign.
`MPCSession` closes the loop: every `replan_every_h` hours it
re-optimizes the remaining horizon against a fresh forecast of the
ground-truth trace (a `ForecastModel` from core/signal.py), swaps the
re-optimized schedule into the in-flight plan with
`engine_torch.replace_tables`, and resumes execution against the
*realized* trace from the carried `PlanCursor` — no already-executed
slot is ever recomputed (pinned by the `replans`/`slots_reused` scan
counters).

On the card every solve runs the optimizer's objective kernels (K3
`objective_scan` for a campaign, K4 `fleet_objective` for a fleet,
forward and backward) and every control interval the chunk kernels (K2
`scan_chunk`, or K1 `coupled_chunk` for a capped fleet); `device="cpu"`
runs their plain PyTorch versions.  Compilation (`compile_plan`,
`replace_tables`) and summaries stay on the host.

The control loop, per re-plan instant `t_k`:

1. observe the carried state (scenarios remaining, elapsed hours);
2. forecast the remaining horizon: `model.forecast(truth, t_k, H_k)`;
3. re-optimize the remaining workload under the forecast, warm-started
   from the previous solution's intensity table (day-periodic logits,
   so the previous tail *is* the warm start);
4. swap tables (`replace_tables`) and execute one control interval
   against the realized truth (`execute_interval`).

With `replan_every_h=None` (or infinity) the loop degenerates to
open-loop planning: one solve, one execution — bitwise identical to
`optimize_schedule` + sweep when the forecast is the oracle.

`FleetMPCSession` is the M-campaign analogue on `optimize_fleet` and
grouped-lane plans; both are surfaced as `Campaign.run_mpc(...)` and
`Fleet.run_mpc(...)`.

The value-of-forecast experiment from the West et al. carbon-shifting
studies (arXiv:2503.13705, arXiv:2508.14625) — realized CO2 under
oracle vs day-ahead vs persistence forecasts — is a few lines on top
(pinned by tests/test_torch_mpc.py).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.device import reject_unported
from repro_torch.core.engine import SweepCase, case_slots_per_hour
from repro_torch.core.signal import (SignalEnsemble, as_forecast, as_trace,
                                     sample_signal)


@dataclasses.dataclass
class ReplanRecord:
    """Solve stats of one MPC planning instant (entry 0 is the initial
    plan; later entries are mid-flight re-plans)."""
    at_hour: float            # absolute hour the plan was made
    planned_co2_kg: float     # predicted CO2 of the remaining horizon
    planned_runtime_h: float  # ... and its predicted remaining runtime
    solve_s: float            # optimizer wall time for this solve
    evaluations: int          # candidate evaluations in this solve
    slots_carried: int        # lane x slot units carried into this re-plan
    forecast_mae: float       # realized mean |forecast - truth| over the
    #                           control interval that followed (kg/kWh)


@dataclasses.dataclass
class MPCResult:
    """Outcome of one receding-horizon MPC run.

    `result` is the *realized* outcome (a `SimResult`, or a
    `FleetResult` for fleet sessions) — executed against the ground
    truth, comparable to any sweep row.  `planned_co2_kg` is what the
    initial open-loop plan predicted under its forecast; the gap to
    `realized_co2_kg` is the cost of forecast error (zero under the
    oracle).  `replans[0]` is the initial solve; `n_replans` counts only
    the mid-flight re-plans.
    """
    result: object                      # SimResult | fleet.FleetResult
    schedule: object                    # final schedule(s) in force
    replans: List[ReplanRecord]
    forecast: str                       # forecast model name
    replan_every_h: Optional[float]     # None = open loop
    planned_co2_kg: float
    realized_co2_kg: float
    planned_runtime_h: float
    realized_runtime_h: float
    realized_energy_kwh: float
    solve_s: float                      # summed optimizer wall time
    forecast_mae: float                 # mean |forecast - truth| over
    #                                     every executed hour (kg/kWh)
    slots_reused: int                   # executed lane x slot units carried
    #                                     across re-plans (never recomputed)

    @property
    def n_replans(self) -> int:
        return max(len(self.replans) - 1, 0)


def _as_member_signal(fc: SignalEnsemble):
    """A single-member forecast collapses to its bare member signal, so
    an oracle forecast hands the optimizer the *same object* as an
    open-loop optimize against the truth (bitwise-identical plans,
    shared signal-grid cache entries)."""
    return fc.member(0) if fc.n_members == 1 else fc


def _check_truth_coverage(truth, start_hour: float, deadline_h: float
                          ) -> None:
    """An MPC session executes against the realized trace; silently
    holding the archive's last value past its end (TraceSignal's default
    pad) would fabricate realized emissions.  Require coverage of the
    campaign window up front (see TraceSignal.pad for the policy)."""
    end = getattr(truth, "end_hour", None)
    if end is None:
        return
    need = start_hour + deadline_h
    if end < need:
        raise ValueError(
            f"ground-truth trace '{getattr(truth, 'name', 'trace')}' ends "
            f"at hour {end:g} but the campaign needs coverage through "
            f"hour {need:g} (start {start_hour:g} + deadline "
            f"{deadline_h:g}); extend the archive or shorten the deadline")


def _interval_mae(fc_sig, truth, hours: np.ndarray) -> float:
    """Realized mean absolute forecast error over executed hours."""
    if hours.size == 0:
        return 0.0
    return float(np.abs(sample_signal(fc_sig, hours)
                        - sample_signal(truth, hours)).mean())


class MPCSession:
    """Receding-horizon MPC over one campaign (see module docstring).

    `case` binds the workload/machine/bands and the *initial* schedule
    (used only as the first solve's warm start); `truth` is the realized
    hourly carbon trace; `constraints` must include a finite runtime cap
    (the horizon the receding re-plans recede toward).  `solver` kwargs
    are forwarded to every `optimize_schedule` call (method, candidates,
    iterations, steps, seed, init, ...).  `device` is where every solve
    and every control interval runs (the card by default); `backend=`
    is the reference's and raises.
    """

    def __init__(self, case: SweepCase, truth, *,
                 objective="co2",
                 constraints: Optional[dict] = None,
                 forecast="oracle",
                 replan_every_h: Optional[float] = 24.0,
                 price=None, backend: Optional[str] = None,
                 chunk_days: Optional[int] = None,
                 max_days: int = 120,
                 cache_dir: Optional[str] = None,
                 solver: Optional[dict] = None,
                 device=None):
        from repro_torch.core.optimize import canonical_metric
        reject_unported(backend=backend)
        self.constraints = {canonical_metric(k): float(v)
                            for k, v in dict(constraints or {}).items()}
        deadline = self.constraints.get("runtime_h", 0.0)
        if not deadline or not math.isfinite(deadline):
            raise ValueError(
                "MPC needs a finite runtime cap: pass "
                "constraints={'runtime_h': ...} (or deadline_h= via "
                "Campaign.run_mpc) — the receding horizon is defined "
                "relative to it")
        self.truth = as_trace(truth, name="truth")
        _check_truth_coverage(self.truth, case.start_hour, deadline)
        self.case = dataclasses.replace(case, carbon=self.truth,
                                        deadline_h=deadline)
        self.objective = objective
        self.model = as_forecast(forecast)
        if replan_every_h is not None:
            k = float(replan_every_h)
            if k <= 0:
                raise ValueError(
                    f"replan_every_h must be positive (or None for open "
                    f"loop), got {replan_every_h}")
            replan_every_h = None if math.isinf(k) else k
        self.replan_every_h = replan_every_h
        self.price = price
        self.chunk_days = chunk_days
        self.max_days = int(max_days)
        self.cache_dir = cache_dir
        self.solver = dict(solver or {})
        self.device = device

    # ------------------------------------------------------------------
    def _forecast_signal(self, now_h: float, horizon_h: float):
        fc = self.model.forecast(self.truth, now_h, horizon_h)
        return _as_member_signal(fc)

    def _solve(self, opt_case: SweepCase, remaining_cap_h: float,
               init) -> "object":
        from repro_torch.core.optimize import optimize_schedule
        kwargs = dict(self.solver)
        if init is not None:
            # a mid-flight warm start (the incumbent's own table) always
            # wins over a solver-level init, which seeds only solve 0
            kwargs["init"] = init
        constraints = dict(self.constraints)
        constraints["runtime_h"] = remaining_cap_h
        return optimize_schedule(opt_case, self.objective, constraints,
                                 price=self.price, device=self.device,
                                 **kwargs)

    def run(self) -> MPCResult:
        from repro_torch.core.engine_torch import (compile_plan,
                                                   execute_interval,
                                                   replace_tables,
                                                   summarize_plan)
        case = self.case
        truth = self.truth
        deadline = case.deadline_h
        K = self.replan_every_h

        # initial solve at t = start against the first forecast
        fc_sig = self._forecast_signal(case.start_hour,
                                       deadline * 1.25 + 48.0)
        t_solve = time.perf_counter()
        res = self._solve(dataclasses.replace(case, carbon=fc_sig),
                          deadline, init=None)
        solve_s = time.perf_counter() - t_solve
        planned_co2 = float(np.mean(res.metrics.co2_kg))
        planned_runtime = float(np.mean(res.metrics.runtime_h))
        records = [ReplanRecord(
            at_hour=case.start_hour, planned_co2_kg=planned_co2,
            planned_runtime_h=planned_runtime, solve_s=solve_s,
            evaluations=res.evaluations, slots_carried=0,
            forecast_mae=0.0)]
        sched = res.schedule
        sph = case_slots_per_hour(dataclasses.replace(case, schedule=sched))
        interval_slots = (None if K is None
                          else max(1, int(round(K * sph))))

        # one plan against the realized truth, executed in intervals
        plan = compile_plan(
            [dataclasses.replace(case, schedule=sched)], self.price,
            slots_per_hour=sph, max_days=self.max_days,
            cache_dir=self.cache_dir)
        g0 = float(plan.g0[0])
        cursor = None
        fc_sigs = [fc_sig]
        mae_hours = 0.0
        mae_sum = 0.0
        slots_reused = 0
        while True:
            t_prev = 0 if cursor is None else cursor.t0
            until = (None if interval_slots is None
                     else t_prev + interval_slots)
            cursor = execute_interval(plan, cursor, until_slot=until,
                                      chunk_days=self.chunk_days,
                                      device=self.device)
            hours = g0 + np.arange(t_prev, cursor.t0) / sph
            mae = _interval_mae(fc_sigs[-1], truth, hours)
            records[-1] = dataclasses.replace(records[-1], forecast_mae=mae)
            mae_sum += mae * hours.size
            mae_hours += hours.size
            if cursor.done:
                break
            now = g0 + cursor.t0 / sph
            remaining_cap = deadline - (now - case.start_hour)
            if remaining_cap <= 1.0 / sph:
                # deadline (nearly) spent: no room to re-plan — run the
                # last schedule to completion (best effort past the cap)
                cursor = execute_interval(plan, cursor,
                                          chunk_days=self.chunk_days,
                                          device=self.device)
                break
            remaining_scen = float(cursor.state.remaining[0])
            fc_sig = self._forecast_signal(now, remaining_cap * 1.25 + 48.0)
            fc_sigs.append(fc_sig)
            opt_case = dataclasses.replace(
                case, schedule=sched, carbon=fc_sig, start_hour=now,
                deadline_h=remaining_cap,
                workload=dataclasses.replace(case.workload,
                                             n_scenarios=remaining_scen))
            t_solve = time.perf_counter()
            res = self._solve(opt_case, remaining_cap,
                              init=sched.intensity_table()
                              if hasattr(sched, "intensity_table") else None)
            solve_s = time.perf_counter() - t_solve
            sched = res.schedule
            slots_reused += cursor.t0 * plan.n_lanes
            records.append(ReplanRecord(
                at_hour=now, planned_co2_kg=float(np.mean(res.metrics.co2_kg)),
                planned_runtime_h=float(np.mean(res.metrics.runtime_h)),
                solve_s=solve_s, evaluations=res.evaluations,
                slots_carried=cursor.t0 * plan.n_lanes, forecast_mae=0.0))
            plan = replace_tables(plan, cursor, schedules={0: sched},
                                  cache_dir=self.cache_dir)

        realized = summarize_plan(plan, cursor.state)[0]
        return MPCResult(
            result=realized, schedule=sched, replans=records,
            forecast=self.model.name, replan_every_h=K,
            planned_co2_kg=planned_co2, realized_co2_kg=realized.co2_kg,
            planned_runtime_h=planned_runtime,
            realized_runtime_h=realized.runtime_h,
            realized_energy_kwh=realized.energy_kwh,
            solve_s=sum(r.solve_s for r in records),
            forecast_mae=(mae_sum / mae_hours if mae_hours else 0.0),
            slots_reused=slots_reused)


class FleetMPCSession:
    """Receding-horizon MPC over M campaigns under one site.

    The fleet analogue of `MPCSession`: each re-plan jointly
    re-optimizes every *unfinished* campaign's remaining workload via
    `optimize_fleet` (warm-started from the previous schedules'
    intensity tables), swaps all changed tables in one `replace_tables`
    call, and resumes the grouped-lane plan.  Campaigns that finish
    drop out of the joint search; campaigns whose deadline is spent
    fall back to best-effort (uncapped) completion.  `device` is where
    every solve and every control interval runs (the card by default);
    `backend=` is the reference's and raises.
    """

    def __init__(self, cases: Sequence[SweepCase], site, truth, *,
                 objective="co2",
                 constraints: Optional[dict] = None,
                 forecast="oracle",
                 replan_every_h: Optional[float] = 24.0,
                 price=None, backend: Optional[str] = None,
                 chunk_days: Optional[int] = None,
                 max_days: int = 240,
                 cache_dir: Optional[str] = None,
                 solver: Optional[dict] = None,
                 device=None):
        reject_unported(backend=backend)
        if not len(cases):
            raise ValueError("FleetMPCSession needs at least one case")
        deadlines = [float(getattr(c, "deadline_h", 0.0) or 0.0)
                     for c in cases]
        if not all(d > 0 and math.isfinite(d) for d in deadlines):
            raise ValueError(
                "MPC needs a finite deadline per campaign (the receding "
                f"horizon is defined relative to it); got {deadlines}")
        starts = {c.start_hour for c in cases}
        if len(starts) > 1:
            raise ValueError(
                f"fleet MPC campaigns share the site clock; got "
                f"start_hours {sorted(starts)}")
        self.truth = as_trace(truth, name="truth")
        start = cases[0].start_hour
        _check_truth_coverage(self.truth, start, max(deadlines))
        self.cases = [dataclasses.replace(c, carbon=self.truth)
                      for c in cases]
        self.site = site
        self.objective = objective
        self.constraints = dict(constraints or {})
        self.model = as_forecast(forecast)
        if replan_every_h is not None:
            k = float(replan_every_h)
            if k <= 0:
                raise ValueError(
                    f"replan_every_h must be positive (or None for open "
                    f"loop), got {replan_every_h}")
            replan_every_h = None if math.isinf(k) else k
        self.replan_every_h = replan_every_h
        self.price = price
        self.chunk_days = chunk_days
        self.max_days = int(max_days)
        self.cache_dir = cache_dir
        self.solver = dict(solver or {})
        self.device = device

    # ------------------------------------------------------------------
    def _solve(self, opt_cases: Sequence[SweepCase], init):
        from repro_torch.core.optimize import optimize_fleet
        kwargs = dict(self.solver)
        if init is not None:
            kwargs["init"] = init
        return optimize_fleet(list(opt_cases), site=self.site,
                              objective=self.objective,
                              constraints=self.constraints or None,
                              price=self.price, device=self.device,
                              **kwargs)

    def run(self) -> MPCResult:
        from repro_torch.core.engine_torch import (compile_plan,
                                                   execute_interval,
                                                   replace_tables,
                                                   summarize_plan)
        from repro_torch.core.fleet import FleetResult, _rollup
        cases = self.cases
        truth = self.truth
        M = len(cases)
        start = cases[0].start_hour
        deadlines = np.array([c.deadline_h for c in cases])
        K = self.replan_every_h
        cap = getattr(self.site, "power_cap_kw", None)
        office = float(getattr(self.site, "office_kw", 0.0) or 0.0)

        horizon0 = float(deadlines.max()) * 1.25 + 48.0
        fc_sig = _as_member_signal(self.model.forecast(truth, start,
                                                       horizon0))
        t_solve = time.perf_counter()
        res = self._solve([dataclasses.replace(c, carbon=fc_sig)
                           for c in cases], init=None)
        solve_s = time.perf_counter() - t_solve
        scheds = list(res.schedules)
        planned_co2 = float(res.site.co2_kg)
        planned_runtime = float(res.site.runtime_h)
        records = [ReplanRecord(
            at_hour=start, planned_co2_kg=planned_co2,
            planned_runtime_h=planned_runtime, solve_s=solve_s,
            evaluations=res.evaluations, slots_carried=0,
            forecast_mae=0.0)]
        sph = 1
        for c, s in zip(cases, scheds):
            sph = math.lcm(sph, case_slots_per_hour(
                dataclasses.replace(c, schedule=s)))
        interval_slots = (None if K is None
                          else max(1, int(round(K * sph))))

        plan = compile_plan(
            [dataclasses.replace(c, schedule=s)
             for c, s in zip(cases, scheds)],
            self.price, slots_per_hour=sph, max_days=self.max_days,
            group_sizes=[M], group_caps_kw=[cap], group_office_kw=[office],
            cache_dir=self.cache_dir)
        g0 = float(plan.g0[0])
        cursor = None
        last_fc = fc_sig
        mae_hours = 0.0
        mae_sum = 0.0
        slots_reused = 0
        while True:
            t_prev = 0 if cursor is None else cursor.t0
            until = (None if interval_slots is None
                     else t_prev + interval_slots)
            cursor = execute_interval(plan, cursor, until_slot=until,
                                      chunk_days=self.chunk_days,
                                      device=self.device)
            hours = g0 + np.arange(t_prev, cursor.t0) / sph
            mae = _interval_mae(last_fc, truth, hours)
            records[-1] = dataclasses.replace(records[-1], forecast_mae=mae)
            mae_sum += mae * hours.size
            mae_hours += hours.size
            if cursor.done:
                break
            now = g0 + cursor.t0 / sph
            elapsed = now - start
            remaining_caps = deadlines - elapsed
            # campaigns still running with re-plannable room; a spent
            # deadline degrades to best-effort (uncapped) completion
            active = [int(plan.lane_case[la]) for la in cursor.active]
            replannable = [m for m in active
                           if remaining_caps[m] > 1.0 / sph]
            if not replannable:
                cursor = execute_interval(plan, cursor,
                                          chunk_days=self.chunk_days,
                                          device=self.device)
                break
            rem = cursor.state.remaining
            horizon = float(remaining_caps[replannable].max()) * 1.25 + 48.0
            last_fc = _as_member_signal(self.model.forecast(truth, now,
                                                            horizon))
            opt_cases = []
            for m in replannable:
                lane = int(np.flatnonzero(plan.lane_case == m)[0])
                opt_cases.append(dataclasses.replace(
                    cases[m], schedule=scheds[m], carbon=last_fc,
                    start_hour=now, deadline_h=float(remaining_caps[m]),
                    workload=dataclasses.replace(
                        cases[m].workload,
                        n_scenarios=float(rem[lane]))))
            init = np.stack([scheds[m].intensity_table()
                             if hasattr(scheds[m], "intensity_table")
                             else np.full(24 * sph, 0.6)
                             for m in replannable])
            t_solve = time.perf_counter()
            res = self._solve(opt_cases, init=init)
            solve_s = time.perf_counter() - t_solve
            for m, s in zip(replannable, res.schedules):
                scheds[m] = s
            slots_reused += cursor.t0 * plan.n_lanes
            records.append(ReplanRecord(
                at_hour=now, planned_co2_kg=float(res.site.co2_kg),
                planned_runtime_h=float(res.site.runtime_h),
                solve_s=solve_s, evaluations=res.evaluations,
                slots_carried=cursor.t0 * plan.n_lanes, forecast_mae=0.0))
            plan = replace_tables(
                plan, cursor,
                schedules={m: scheds[m] for m in replannable},
                cache_dir=self.cache_dir)

        results = summarize_plan(plan, cursor.state)
        peak = (float(cursor.state.site_kw_peak.max())
                if cursor.state.site_kw_peak is not None else None)
        realized = FleetResult(policy="mpc", campaigns=results,
                               site=_rollup("mpc", results, peak_kw=peak))
        return MPCResult(
            result=realized, schedule=list(scheds), replans=records,
            forecast=self.model.name, replan_every_h=K,
            planned_co2_kg=planned_co2,
            realized_co2_kg=realized.site.co2_kg,
            planned_runtime_h=planned_runtime,
            realized_runtime_h=realized.site.runtime_h,
            realized_energy_kwh=realized.site.energy_kwh,
            solve_s=sum(r.solve_s for r in records),
            forecast_mae=(mae_sum / mae_hours if mae_hours else 0.0),
            slots_reused=slots_reused)


def run_mpc(case: SweepCase, truth, **kwargs) -> MPCResult:
    """Functional one-shot form of `MPCSession` (see class docstring)."""
    return MPCSession(case, truth, **kwargs).run()


__all__ = ["MPCSession", "FleetMPCSession", "MPCResult", "ReplanRecord",
           "run_mpc"]
