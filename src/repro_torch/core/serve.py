"""Online serving: CARINA as a carbon-aware request-level scheduler.

The trace engine plans *campaigns*; this module schedules *streaming
request traffic* (core/arrivals.py) against per-slot grid carbon, then
executes the resulting demand through the same compiled machinery —
so the chunk kernels, lane groups, and site power caps all apply
unchanged to request workloads:

  1. **Window** — an arrival window is discretized into service slots
     (`ServingWindow`): per-slot carbon, background load, and service
     capacity at full intensity (from THE rate model, core/model.py).
  2. **Assign** — a pluggable policy maps every request to a service
     slot and an executed quality tier, or rejects it:
       * `FifoServingPolicy` — the carbon-blind baseline: a single
         FIFO queue served in arrival order (vectorized over the whole
         window via the cumulative served-work curve);
       * `GreedyServingPolicy` — the carbon-gated heuristic: slots are
         filled greenest-first, requests earliest-deadline-first, with
         an optional quality-degrade pass when clean capacity is
         scarce (the CarbonShiftML slot + model-quality assignment);
       * `OptimizedServingPolicy` — reuses the CEM machinery
         (core/optimize.py) to synthesize the window's per-slot
         offered-capacity profile, then packs requests into it.
  3. **Execute** — the admitted per-tier demand becomes an
     `AllocationSchedule`-shaped block of scan lanes (one lane per
     quality tier, intensities inverted from demand through the rate
     model) and runs through `compile_plan -> execute_plan ->
     summarize_plan` in ONE sweep on the card (kernel K2) — a
     million-request day is a handful of scan lanes.  A `Site` turns on
     the grouped-lane site-coupled kernel (K1) exactly as for fleets.

`ServingSession` is the session surface (submit / tick / drain with a
`SiteRollup`-style rollup) plus a lightweight live-mode adapter
(`gate_open` / `record_tick`) that the decode-serving engine
(repro_torch/serving/engine.py) plugs into.

Devices: assignment is host NumPy (bit-identical across runs and
devices); execution runs on `device` (the card by default, "cpu" for
the plain PyTorch versions of the kernels).  Every policy's `assign`
takes the call's `device`; `OptimizedServingPolicy` runs its CEM
search there: the population evaluates through `TraceObjective` (kernel K3's
forward on the card).  The card and the CPU agree to float64
precision, so the synthesized budgets agree to ~1e-15 relative.  The
reference's `backend=` and `devices` > 1 raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import engine_torch, model
from repro_torch.core.arrivals import (ArrivalBatch, DEFAULT_TIERS,
                                       QualityTier, arrival_stream)
from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.controller import SimClock
from repro_torch.core.device import reject_unported, resolve_device
from repro_torch.core.energy import (ChipProfile, EnergyModel,
                                     MachineProfile, StepCost)
from repro_torch.core.engine import SweepCase
from repro_torch.core.engine_torch import (compile_plan, execute_plan,
                                           summarize_plan)
from repro_torch.core.policy import TimeBands
from repro_torch.core.schedule import AllocationSchedule, ParametricSchedule
from repro_torch.core.signal import Signal, carbon_signal, sample_signal
from repro_torch.core.simulator import SimResult
from repro_torch.core.workload import OEMWorkload

#: Safety margin: a policy may book at most this fraction of a slot's
#: full-intensity capacity, leaving headroom for rate-model curvature.
DEFAULT_FILL_FRAC = 0.9


# ---------------------------------------------------------------------------
# The window: per-slot carbon / background / capacity
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServingWindow:
    """One arrival window, discretized into service slots.

    All times are hours; `slot_hours[s]` is slot s's *absolute* start
    hour (`t0_h + s * slot_h` — hour 0 is midnight of the session's
    first day).  `cap_work[s]` is the work a server completes in slot s
    at intensity 1.0 under that slot's background load (scenario units,
    from `model.campaign_rates`); policies book at most
    `fill_frac * cap_work` per slot.
    """
    t0_h: float
    window_h: float
    sph: int
    slot_hours: np.ndarray           # (S,) absolute slot start hours
    carbon: np.ndarray               # (S,) kg CO2e/kWh at the slot
    background: np.ndarray           # (S,) office load in [0, 1]
    cap_work: np.ndarray             # (S,) scenarios servable at u = 1
    fill_frac: float
    workload: OEMWorkload            # service-rate template (n_scenarios unused)
    machine: MachineProfile
    bands: TimeBands
    carbon_sig: Signal
    price: Optional[Signal]
    batch_size: int

    @property
    def n_slots(self) -> int:
        return len(self.slot_hours)

    @property
    def slot_h(self) -> float:
        return 1.0 / self.sph

    @property
    def budgets(self) -> np.ndarray:
        """(S,) bookable work per slot (`fill_frac * cap_work`)."""
        return self.fill_frac * self.cap_work

    @staticmethod
    def build(t0_h: float, window_h: float, *, slots_per_hour: int = 1,
              workload: OEMWorkload, machine: MachineProfile,
              bands: TimeBands, carbon_sig: Signal,
              price: Optional[Signal] = None,
              fill_frac: float = DEFAULT_FILL_FRAC,
              batch_size: int = 50) -> "ServingWindow":
        if not (0.0 < window_h <= 24.0):
            raise ValueError(
                f"window_h must be in (0, 24] (the demand lanes lower to "
                f"day-periodic decision tables), got {window_h}")
        sph = int(slots_per_hour)
        S = int(round(window_h * sph))
        if S < 1 or abs(S / sph - window_h) > 1e-9:
            raise ValueError(f"window_h={window_h} is not a whole number "
                             f"of slots at {sph} slots/hour")
        slot_h = 1.0 / sph
        hours = t0_h + slot_h * np.arange(S)
        carbon = sample_signal(carbon_sig, hours + 0.5 * slot_h)
        bg = np.array([bands.background(bands.band_at(h % 24.0))
                       for h in hours])
        r = model.campaign_rates(1.0, batch_size, bg, workload, machine,
                                 xp=np)
        cap = np.asarray(r.r_eff, dtype=float) * 3600.0 * slot_h
        return ServingWindow(
            t0_h=float(t0_h), window_h=float(window_h), sph=sph,
            slot_hours=hours, carbon=np.asarray(carbon, dtype=float),
            background=bg, cap_work=cap, fill_frac=float(fill_frac),
            workload=workload, machine=machine, bands=bands,
            carbon_sig=carbon_sig, price=price, batch_size=int(batch_size))


# ---------------------------------------------------------------------------
# Assignments
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Assignment:
    """One policy's answer for one window: per-request service slot and
    executed tier, plus the per-(tier, slot) demand block the executor
    lowers into scan lanes.

    `slot[i] == -1` means request i was rejected (no feasible slot at
    any allowed tier).  `t_finish_h[i]` is the window-relative finish
    estimate (slot end for slot-packed policies; fractional within the
    slot for FIFO); rejected requests carry `inf`.
    """
    policy: str
    slot: np.ndarray                 # (N,) int, -1 = rejected
    tier: np.ndarray                 # (N,) int, executed tier
    t_finish_h: np.ndarray           # (N,) float, window-relative
    demand: np.ndarray               # (T, S) scheduled work per tier x slot

    @property
    def admitted(self) -> np.ndarray:
        return self.slot >= 0

    @property
    def n_admitted(self) -> int:
        return int(np.count_nonzero(self.slot >= 0))


def _slot_bounds(batch: ArrivalBatch, window: ServingWindow
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-request (earliest, latest) feasible service slot: a request
    may be served from its arrival slot through the last slot that ends
    by its deadline (clipped to the window; latest < earliest means no
    slot meets the deadline inside this window)."""
    slot_h = window.slot_h
    a = np.minimum((batch.t_arrive_h / slot_h).astype(np.int64),
                   window.n_slots - 1)
    d = np.floor(batch.deadline_h / slot_h - 1.0 + 1e-9).astype(np.int64)
    return a, np.minimum(d, window.n_slots - 1)


def _scaled_work(batch: ArrivalBatch, tiers: Sequence[QualityTier],
                 tier_idx: np.ndarray) -> np.ndarray:
    scales = np.array([t.work_scale for t in tiers])
    return batch.work * scales[np.minimum(tier_idx, len(tiers) - 1)]


def _fifo_curve(batch: ArrivalBatch, window: ServingWindow,
                work: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The FIFO queue's cumulative served-work curve.

    `served[s]` is the total work completed by the end of slot s when
    requests are served strictly in arrival order at the slot budgets:
    `served[s] = min(arrived_work[s], served[s-1] + budget[s])` — the
    min is the idle case (queue drained before new arrivals).  Returns
    (cum_work per request, served per slot).
    """
    budgets = window.budgets
    cw = np.cumsum(work)
    slot_ends = window.slot_h * (1.0 + np.arange(window.n_slots))
    arrived = np.searchsorted(batch.t_arrive_h, slot_ends, side="right")
    arrived_cw = np.concatenate([[0.0], cw])[arrived]
    served = np.empty(window.n_slots)
    prev = 0.0
    for s in range(window.n_slots):           # scalar recursion, S is small
        prev = min(float(arrived_cw[s]), prev + float(budgets[s]))
        served[s] = prev
    return cw, served


def _fifo_demand(batch: ArrivalBatch, window: ServingWindow,
                 work: np.ndarray, tier_idx: np.ndarray,
                 cw: np.ndarray, served: np.ndarray,
                 n_tiers: int) -> np.ndarray:
    """(T, S) demand block of the FIFO curve: request i's work interval
    on the served-work axis is (cw[i]-work[i], cw[i]]; slot s owns the
    range (served[s-1], served[s]].  The overlap split attributes work
    spanning a slot boundary to both slots, so the executed lanes carry
    exactly the work the queue model served per slot.

    The intervals are disjoint and ordered (start[i] >= cw[i-1]), so a
    slot boundary cuts at most one request: the cumulative tier mass at
    a boundary is a prefix sum plus one partial term, and the demand
    block falls out of a diff — O(n + S log n) per tier, no per-slot
    pass over the requests."""
    demand = np.empty((n_tiers, window.n_slots))
    start = cw - work
    for t in range(n_tiers):
        sel = np.flatnonzero(tier_idx == t)
        if not len(sel):
            demand[t] = 0.0
            continue
        cw_t, st_t, w_t = cw[sel], start[sel], work[sel]
        wcum = np.concatenate([[0.0], np.cumsum(w_t)])
        k = np.searchsorted(cw_t, served, side="right")
        kc = np.minimum(k, len(sel) - 1)      # boundary-cut candidate
        part = np.where(k < len(sel),
                        np.clip(served - st_t[kc], 0.0, w_t[kc]), 0.0)
        mass = wcum[k] + part
        demand[t] = np.diff(np.concatenate([[0.0], mass]))
    return demand


class FifoServingPolicy:
    """Carbon-blind baseline: one FIFO queue served in arrival order at
    the slot budgets, deadlines ignored until the post-hoc SLO check.
    Every request runs at its requested tier."""

    name = "fifo"

    def assign(self, batch: ArrivalBatch, window: ServingWindow,
               tiers: Sequence[QualityTier], *, seed: int = 0,
               device=None) -> Assignment:
        tier_idx = np.minimum(batch.tier, len(tiers) - 1)
        work = _scaled_work(batch, tiers, tier_idx)
        cw, served = _fifo_curve(batch, window, work)

        slot = np.searchsorted(served, cw - 1e-9, side="left")
        fits = cw <= served[-1] + 1e-9
        slot = np.where(fits, np.minimum(slot, window.n_slots - 1), -1)

        prev = np.concatenate([[0.0], served[:-1]])
        budgets = window.budgets
        s_safe = np.maximum(slot, 0)
        frac = (cw - prev[s_safe]) / np.maximum(budgets[s_safe], 1e-12)
        t_fin = window.slot_h * (s_safe + np.clip(frac, 0.0, 1.0))
        t_fin = np.where(fits, t_fin, np.inf)

        demand = _fifo_demand(batch, window, work * fits, tier_idx, cw,
                              served, len(tiers))
        return Assignment("fifo", slot.astype(np.int64), tier_idx, t_fin,
                          demand)


def _latest_slots(a_slot: np.ndarray, d_slot: np.ndarray, work: np.ndarray,
                  budgets: np.ndarray, used: np.ndarray,
                  eligible: np.ndarray) -> np.ndarray:
    """Each request's *latest feasible slot* under contention: the
    defer-everything schedule, computed by EDF run in reverse time
    (slots latest-first, requests latest-arrival-first — the mirror of
    earliest-deadline-first, so it is feasibility-optimal).  Requests
    it cannot place (-1) fit in no schedule at this work size.
    Accumulates into `used` so a second pass (degraded work sizes) can
    claim only leftover budget."""
    n = len(a_slot)
    L = np.full(n, -1, dtype=np.int64)
    order = np.argsort(-a_slot, kind="stable")
    order = order[eligible[order]]
    for s in range(len(budgets) - 1, -1, -1):
        room = float(budgets[s] - used[s])
        if room <= 0.0:
            continue
        cand = order[(L[order] < 0) & (a_slot[order] <= s)
                     & (d_slot[order] >= s)]
        if not cand.size:
            continue
        cum = np.cumsum(work[cand])
        k = int(np.searchsorted(cum, room + 1e-12, side="right"))
        if k:
            L[cand[:k]] = s
            used[s] += float(cum[k - 1])
    return L


def _edf_pack(name: str, batch: ArrivalBatch, window: ServingWindow,
              tiers: Sequence[QualityTier], green_budget: np.ndarray,
              *, degrade: bool, pro_ok=None) -> Assignment:
    """The shared packing core of the carbon-aware policies.

    Two passes.  A *reverse-time* EDF pass computes each request's
    latest feasible slot `L` under budget contention (degrading to the
    cheapest tier, then rejecting, whatever fits in no schedule).  The
    *forward* pass then serves slots in time order: requests whose `L`
    is the current slot are **forced** — served against the full slot
    budget regardless of carbon — and everything else is served
    *proactively*, earliest-deadline-first, only up to
    `green_budget[s]` (0 on dirty slots — those requests wait) and,
    when `pro_ok` is given, only for the requests `pro_ok(s)` marks
    willing (the greedy policy's wait-for-clean rule).

    Forcing at `L` rather than at the raw deadline slot is what makes
    carbon-driven waiting free: when deferred work piles up against a
    deadline cluster, the reverse pass has already spread the pile
    over the latest slots that still fit it, so the forward pass never
    meets an overflow the reverse pass didn't resolve — admissions
    match the feasibility-optimal carbon-blind schedule.
    """
    n = batch.n
    S = window.n_slots
    budgets = window.budgets
    a_slot, d_slot = _slot_bounds(batch, window)
    tier_idx = np.minimum(batch.tier, len(tiers) - 1)
    work = _scaled_work(batch, tiers, tier_idx)
    order_d = np.argsort(batch.deadline_h, kind="stable")

    # reverse pass: latest feasible slots, eco retry for the leftovers
    exec_tier = tier_idx.copy()
    w_eff = work.copy()
    r_used = np.zeros(S)
    L = _latest_slots(a_slot, d_slot, work, budgets, r_used,
                      np.ones(n, dtype=bool))
    if degrade and len(tiers) > 1:
        eco = len(tiers) - 1
        eco_work = batch.work * tiers[eco].work_scale
        retry = (L < 0) & (tier_idx != eco)
        if retry.any():
            L2 = _latest_slots(a_slot, d_slot, eco_work, budgets, r_used,
                               retry)
            got = retry & (L2 >= 0)
            L = np.where(got, L2, L)
            exec_tier = np.where(got, eco, exec_tier)
            w_eff = np.where(got, eco_work, w_eff)

    assigned = np.full(n, -1, dtype=np.int64)
    used = np.zeros(S)

    def _take(cand: np.ndarray, room: float, s: int) -> float:
        cum = np.cumsum(w_eff[cand])
        k = int(np.searchsorted(cum, room + 1e-12, side="right"))
        if not k:
            return 0.0
        assigned[cand[:k]] = s
        return float(cum[k - 1])

    for s in range(S):
        # forced class: at the latest feasible slot — full budget
        forced = order_d[(assigned[order_d] < 0) & (L[order_d] >= 0)
                         & (L[order_d] <= s) & (a_slot[order_d] <= s)]
        room = float(budgets[s] - used[s])
        if forced.size and room > 0.0:
            used[s] += _take(forced, room, s)
        # proactive class: EDF up to the slot's green budget
        room = float(min(green_budget[s], budgets[s]) - used[s])
        if room > 0.0:
            mask = ((assigned[order_d] < 0) & (L[order_d] > s)
                    & (a_slot[order_d] <= s))
            if pro_ok is not None:
                mask &= pro_ok(s)[order_d]
            cand = order_d[mask]
            if cand.size:
                used[s] += _take(cand, room, s)

    t_fin = np.where(assigned >= 0,
                     window.slot_h * (np.maximum(assigned, 0) + 1.0), np.inf)
    demand = np.zeros((len(tiers), S))
    adm = assigned >= 0
    np.add.at(demand, (exec_tier[adm], assigned[adm]), w_eff[adm])
    return Assignment(name, assigned, exec_tier, t_fin, demand)


class GreedyServingPolicy:
    """Carbon-gated greedy heuristic: a request is served proactively
    only when the current slot is within `tol` of the *cleanest slot
    still ahead in its own deadline window* — work waits for its best
    reachable carbon, and contention self-regulates (when the valley
    slot fills, the runners-up become each leftover request's new best
    and pick it up).  Requests whose window runs out are served as
    deadline-forced work regardless of carbon, so waiting never costs
    admissions; forced overflow degrades to the cheapest quality tier
    (when `degrade`) before rejecting.

    An explicit `gate` (kg CO2e/kWh) replaces the per-request rule
    with a static one: slots at or below the gate serve proactively,
    dirtier slots serve only forced work.
    """

    name = "greedy"

    def __init__(self, gate: Optional[float] = None, degrade: bool = True,
                 tol: float = 0.1):
        self.gate = gate
        self.degrade = degrade
        self.tol = float(tol)

    def assign(self, batch: ArrivalBatch, window: ServingWindow,
               tiers: Sequence[QualityTier], *, seed: int = 0,
               device=None) -> Assignment:
        if self.gate is not None:
            green = np.where(window.carbon <= self.gate, window.budgets, 0.0)
            return _edf_pack(self.name, batch, window, tiers, green,
                             degrade=self.degrade)
        carbon = window.carbon
        d_clip = np.minimum(
            np.floor(batch.deadline_h / window.slot_h - 1.0 + 1e-9
                     ).astype(np.int64), window.n_slots - 1)

        def pro_ok(s: int) -> np.ndarray:
            # cleanest carbon still reachable: cummin of carbon[s:]
            # indexed by each request's last feasible slot
            fmin = np.minimum.accumulate(carbon[s:])
            best = fmin[np.maximum(d_clip - s, 0)]
            return carbon[s] <= (1.0 + self.tol) * best + 1e-12

        return _edf_pack(self.name, batch, window, tiers, window.budgets,
                         degrade=self.degrade, pro_ok=pro_ok)


class OptimizedServingPolicy:
    """Optimized slot assignment: synthesize the window's per-slot
    offered-capacity profile with the CEM machinery (`optimize_schedule`
    on an aggregate demand block — the window's total work as one
    campaign under the window's carbon trace, with the window length as
    the runtime cap), then pack requests into the synthesized profile
    with the same EDF time-order core as the greedy policy (the profile
    plays the role of the green budgets; deadline-forced requests still
    draw on the full slot budget, so the optimizer shapes carbon, never
    SLOs).

    The search runs on the `device` handed to `assign` — the card by
    default (each population evaluate one launch of kernel K3's
    forward), or "cpu" for its plain PyTorch version; `serve_window`
    hands it its own.  The reference's `backend=` raises.  Seeded: the
    CEM population is driven by the `seed` handed to `assign` (offset by
    `self.seed`)."""

    name = "optimized"

    def __init__(self, objective: str = "co2", *, candidates: int = 48,
                 iterations: int = 10, method: str = "cem",
                 backend: Optional[str] = None, degrade: bool = True,
                 seed: int = 0):
        reject_unported(backend=backend)
        self.objective = objective
        self.candidates = int(candidates)
        self.iterations = int(iterations)
        self.method = method
        self.degrade = degrade
        self.seed = int(seed)

    def _budgets(self, total_work: float, window: ServingWindow,
                 seed: int, device=None) -> np.ndarray:
        from repro_torch.core.optimize import optimize_schedule
        wl = dataclasses.replace(window.workload, name="serving-window",
                                 n_scenarios=float(total_work))
        day = 24 * window.sph
        sched = ParametricSchedule.from_intensities(
            np.full(day, 0.6), u_min=0.0, u_max=1.0,
            batch_size=window.batch_size, name="serving-seed")
        trace = _window_trace(window)
        case = SweepCase(schedule=sched, workload=wl,
                         machine=window.machine, bands=window.bands,
                         carbon=trace, start_hour=window.t0_h % 24.0,
                         label="serving-window",
                         deadline_h=window.window_h)
        res = optimize_schedule(
            case, self.objective, {"runtime_h": window.window_h},
            method=self.method, n_slots=day, u_min=0.0, u_max=1.0,
            batch_size=window.batch_size, price=window.price,
            candidates=self.candidates, iterations=self.iterations,
            seed=self.seed + seed, device=device)
        u_day = res.schedule.intensity_table()
        day_idx = _day_slot_index(window)
        u = u_day[day_idx]
        r = model.campaign_rates(u, window.batch_size, window.background,
                                 window.workload, window.machine, xp=np)
        cap_u = np.asarray(r.r_eff, dtype=float) * 3600.0 * window.slot_h
        return np.minimum(window.fill_frac * cap_u, window.budgets)

    def assign(self, batch: ArrivalBatch, window: ServingWindow,
               tiers: Sequence[QualityTier], *, seed: int = 0,
               device=None) -> Assignment:
        tier_idx = np.minimum(batch.tier, len(tiers) - 1)
        total = float(_scaled_work(batch, tiers, tier_idx).sum())
        green = self._budgets(total, window, seed, device)
        return _edf_pack(self.name, batch, window, tiers, green,
                         degrade=self.degrade)


SERVING_POLICIES: Dict[str, type] = {
    "fifo": FifoServingPolicy,
    "greedy": GreedyServingPolicy,
    "optimized": OptimizedServingPolicy,
}


def as_serving_policy(policy) -> object:
    """Coerce a registry name or a policy object (anything with
    `assign(batch, window, tiers, seed=, device=)`) into a serving
    policy."""
    if isinstance(policy, str):
        try:
            return SERVING_POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown serving policy {policy!r}; choose from "
                f"{sorted(SERVING_POLICIES)}") from None
    if hasattr(policy, "assign"):
        return policy
    raise TypeError(f"cannot interpret {policy!r} as a serving policy")


# ---------------------------------------------------------------------------
# Execution: the demand block through the trace engine
# ---------------------------------------------------------------------------
def _day_slot_index(window: ServingWindow) -> np.ndarray:
    """(S,) index of each window slot in the 24h-periodic day table."""
    day = 24 * window.sph
    s0 = int(round((window.t0_h % 24.0) * window.sph))
    return (s0 + np.arange(window.n_slots)) % day


def _window_trace(window: ServingWindow):
    """The window's carbon as a TraceSignal anchored at the lane start
    (padded past the window so a residual trickle clamps, not wraps)."""
    from repro_torch.core.signal import TraceSignal
    hours = window.t0_h + np.arange(int(math.ceil(window.window_h)) + 48)
    vals = sample_signal(window.carbon_sig, hours + 0.5)
    return TraceSignal(tuple(float(v) for v in vals),
                       start_hour=window.t0_h % 24.0, name="serving-carbon")


def _u_for_demand(demand: np.ndarray, window: ServingWindow,
                  k: int = 129) -> np.ndarray:
    """Invert the rate model per slot: the intensity at which one lane
    completes `demand[s]` scenarios within slot s under that slot's
    background load.  Monotone interpolation on a shared u-grid."""
    us = np.linspace(0.0, 1.0, k)
    r = model.campaign_rates(us[:, None], window.batch_size,
                             window.background[None, :], window.workload,
                             window.machine, xp=np)
    cap = np.asarray(r.r_eff, dtype=float) * 3600.0 * window.slot_h
    u = np.zeros(window.n_slots)
    for s in range(window.n_slots):
        u[s] = np.interp(demand[s], cap[:, s], us)
    return u


def execute_assignment(assignment: Assignment, window: ServingWindow,
                       tiers: Sequence[QualityTier], *, site=None,
                       backend: Optional[str] = None,
                       precision: str = "fp64",
                       devices: Optional[int] = None,
                       cache_dir: Optional[str] = None,
                       device=None
                       ) -> Tuple[List[SimResult], AllocationSchedule,
                                  Optional[float]]:
    """Lower the admitted demand block into per-tier scan lanes and run
    them through `compile_plan -> execute_plan -> summarize_plan` — one
    sweep for the whole window on `device` (the card by default: kernel
    K2, or K1 when a `site` couples the lanes under its cap; "cpu" runs
    their plain PyTorch versions).  Returns the per-lane `SimResult`s
    (empty tiers skipped), the executed `AllocationSchedule` demand
    block, and the peak site draw (kW, site-coupled runs only).
    `precision` is the engine's dtype policy; the reference's `backend`
    and `devices` > 1 raise."""
    reject_unported(devices=devices, backend=backend)
    day = 24 * window.sph
    day_idx = _day_slot_index(window)
    trace = _window_trace(window)
    members: List[ParametricSchedule] = []
    cases: List[SweepCase] = []
    lane_tiers: List[int] = []
    for t, tier in enumerate(tiers):
        w_t = float(assignment.demand[t].sum())
        if w_t <= 0.0:
            continue
        u = _u_for_demand(assignment.demand[t], window)
        day_u = np.zeros(day)
        day_u[day_idx] = u
        sched = ParametricSchedule.from_intensities(
            day_u, u_min=0.0, u_max=1.0, batch_size=window.batch_size,
            name=f"serving[{assignment.policy}]/{tier.name}")
        wl = dataclasses.replace(window.workload,
                                 name=f"serving-{tier.name}",
                                 n_scenarios=w_t)
        cases.append(SweepCase(schedule=sched, workload=wl,
                               machine=window.machine, bands=window.bands,
                               carbon=trace,
                               start_hour=window.t0_h % 24.0,
                               label=sched.name))
        members.append(sched)
        lane_tiers.append(t)
    alloc = AllocationSchedule(
        tuple(members) or (ParametricSchedule.from_intensities(
            np.zeros(day), u_min=0.0, u_max=1.0,
            batch_size=window.batch_size, name="serving-empty"),),
        name=f"serving[{assignment.policy}]")
    if not cases:
        return [], alloc, None

    groups = {}
    if site is not None:
        groups = dict(group_sizes=[len(cases)],
                      group_caps_kw=[getattr(site, "power_cap_kw", None)],
                      group_office_kw=[float(getattr(site, "office_kw", 0.0)
                                             or 0.0)])
    plan = compile_plan(cases, price=window.price,
                        slots_per_hour=window.sph, precision=precision,
                        cache_dir=cache_dir, **groups)
    state = execute_plan(plan, device=device)
    results = summarize_plan(plan, state)
    peak = (float(np.max(state.site_kw_peak))
            if state.site_kw_peak is not None else None)
    for r, t in zip(results, lane_tiers):
        r.policy = f"{assignment.policy}/{tiers[t].name}"
    return results, alloc, peak


# ---------------------------------------------------------------------------
# Window reports and the session rollup
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WindowReport:
    """One scheduled-and-executed arrival window."""
    policy: str
    t0_h: float
    window_h: float
    n_requests: int
    n_admitted: int
    n_rejected: int
    n_degraded: int
    n_slo_miss: int
    energy_kwh: float
    co2_kg: float
    cost_usd: Optional[float]
    peak_kw: Optional[float]
    assignment: Assignment
    schedule: AllocationSchedule          # the executed demand block
    lanes: List[SimResult]
    request_energy_kwh: np.ndarray        # (N,) attribution (sums to total)
    request_co2_kg: np.ndarray            # (N,) carbon-weighted attribution
    slo_ok: np.ndarray                    # (N,) bool

    @property
    def slo_miss_rate(self) -> float:
        return self.n_slo_miss / max(self.n_requests, 1)


@dataclasses.dataclass(frozen=True)
class ServingRollup:
    """Session-level totals across every executed window — the serving
    analogue of the fleet's `SiteRollup`."""
    n_requests: int
    n_admitted: int
    n_rejected: int
    n_degraded: int
    n_slo_miss: int
    energy_kwh: float
    co2_kg: float
    cost_usd: Optional[float] = None
    peak_kw: Optional[float] = None
    n_windows: int = 0

    @property
    def slo_miss_rate(self) -> float:
        return self.n_slo_miss / max(self.n_requests, 1)


def serve_window(batch: ArrivalBatch, window: ServingWindow, *,
                 policy="greedy", tiers: Sequence[QualityTier] = DEFAULT_TIERS,
                 site=None, seed: int = 0,
                 backend: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 device=None) -> WindowReport:
    """Schedule one arrival window and execute it in one sweep: policy
    assignment (admission + slot + tier), engine execution of the
    admitted demand block on `device` (the card by default), per-request
    SLO check and energy/CO2 attribution.  The policy assigns on
    `device` too (the optimized policy's search).  The
    functional core under `ServingSession.tick` (use it directly for
    policy comparisons on a shared window).  `backend=` raises."""
    reject_unported(backend=backend)
    dev = resolve_device(device)
    pol = as_serving_policy(policy)
    asn = pol.assign(batch, window, tiers, seed=seed, device=dev)
    lanes, alloc, peak = execute_assignment(asn, window, tiers, site=site,
                                            cache_dir=cache_dir, device=dev)

    adm = asn.admitted
    slo_ok = adm & (asn.t_finish_h <= batch.deadline_h + 1e-9)
    tier_req = np.minimum(batch.tier, len(tiers) - 1)
    degraded = adm & (asn.tier != tier_req)
    n = batch.n

    # per-request attribution: energy by work share within the tier
    # lane, CO2 additionally weighted by the assigned slot's carbon —
    # shares sum exactly to the lane totals the engine reported
    w_exec = _scaled_work(batch, tiers, asn.tier) * adm
    req_kwh = np.zeros(n)
    req_co2 = np.zeros(n)
    slot_carbon = window.carbon[np.maximum(asn.slot, 0)]
    for t in range(len(tiers)):
        r = next((lr for lr in lanes
                  if lr.policy.endswith("/" + tiers[t].name)), None)
        if r is None:
            continue
        m = adm & (asn.tier == t)
        wt = w_exec * m
        tot = wt.sum()
        if tot > 0.0:
            req_kwh += r.energy_kwh * wt / tot
            cwt = wt * slot_carbon
            req_co2 += r.co2_kg * cwt / max(cwt.sum(), 1e-300)

    stats = engine_torch._STATS
    stats.requests_seen += n
    stats.requests_admitted += int(adm.sum())
    stats.requests_rejected += int(n - adm.sum())
    stats.requests_degraded += int(degraded.sum())

    cost = (sum(r.cost_usd for r in lanes)
            if lanes and all(r.cost_usd is not None for r in lanes) else None)
    return WindowReport(
        policy=asn.policy, t0_h=window.t0_h, window_h=window.window_h,
        n_requests=n, n_admitted=int(adm.sum()),
        n_rejected=int(n - adm.sum()), n_degraded=int(degraded.sum()),
        n_slo_miss=int(n - slo_ok.sum()),
        energy_kwh=float(sum(r.energy_kwh for r in lanes)),
        co2_kg=float(sum(r.co2_kg for r in lanes)), cost_usd=cost,
        peak_kw=peak, assignment=asn, schedule=alloc, lanes=lanes,
        request_energy_kwh=req_kwh, request_co2_kg=req_co2, slo_ok=slo_ok)


# ---------------------------------------------------------------------------
# The session surface
# ---------------------------------------------------------------------------
class ServingSession:
    """Carbon-aware request-level scheduling as a session object.

    **Windowed mode** (the batch path): `submit()` queues arrivals —
    an `ArrivalBatch`, or generator kwargs forwarded to
    `arrival_stream` — `tick()` schedules and executes one window
    through one sweep on `device` (the card by default; "cpu" runs the
    kernels' plain PyTorch versions), `drain()` runs the queue dry and
    returns the `ServingRollup`.

        sess = carina.ServingSession(policy="greedy", service_rate=50.0)
        sess.submit(n=1_000_000, shape="camel", seed=7)
        rollup = sess.drain()
        rollup.co2_kg, rollup.slo_miss_rate

    **Live mode** (the decode-serving adapter): `gate_open()` gates
    admissions on the current grid carbon (with queue-pressure
    override) and `record_tick()` accounts one engine iteration's
    runtime/energy/CO2 — the surface repro_torch/serving/engine.py
    plugs into.  It needs no device.

    The reference's `backend=` raises.
    """

    def __init__(self, workload: Optional[OEMWorkload] = None,
                 machine: Optional[MachineProfile] = None,
                 bands: Optional[TimeBands] = None,
                 carbon=None, price: Optional[Signal] = None, *,
                 window_h: float = 24.0, slots_per_hour: int = 1,
                 start_hour: float = 0.0, service_rate: float = 25.0,
                 batch_size: int = 50, batch_overhead_s: float = 2.0,
                 tiers: Sequence[QualityTier] = DEFAULT_TIERS,
                 policy="greedy", site=None,
                 fill_frac: float = DEFAULT_FILL_FRAC, seed: int = 0,
                 backend: Optional[str] = None,
                 clock: Optional[SimClock] = None,
                 chip: Optional[ChipProfile] = None,
                 step_cost: Optional[StepCost] = None, tracker=None,
                 gate: Optional[float] = None, max_queue: int = 32,
                 cache_dir: Optional[str] = None, device=None):
        reject_unported(backend=backend)
        self.workload = workload or OEMWorkload(
            "serving", 0, rate_at_full=float(service_rate),
            batch_overhead_s=float(batch_overhead_s))
        if self.workload.rate_at_full <= 0.0:
            raise ValueError("the serving workload template needs a "
                             "positive rate_at_full (the service rate)")
        self.machine = machine or MachineProfile()
        self.bands = bands or TimeBands()
        self.carbon_sig = carbon_signal(carbon if carbon is not None
                                        else GridCarbonModel())
        self.price = price
        self.window_h = float(window_h)
        self.sph = int(slots_per_hour)
        self.tiers = tuple(tiers)
        self.policy = policy
        self.site = site
        self.fill_frac = float(fill_frac)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.cache_dir = cache_dir
        self.device = device
        self._t0 = float(start_hour)
        self._queue: List[ArrivalBatch] = []
        self.reports: List[WindowReport] = []
        # live-mode accessories (the decode-engine adapter)
        self.clock = clock or SimClock(start_hour=float(start_hour))
        self.energy = EnergyModel(chip=chip or ChipProfile())
        self.step_cost = step_cost
        self.tracker = tracker
        self.gate = gate
        self.max_queue = int(max_queue)
        self.live_units = 0
        self.live_energy_kwh = 0.0
        self.live_co2_kg = 0.0

    # ---- windowed mode ----------------------------------------------------
    def submit(self, arrivals: Union[ArrivalBatch, int, None] = None,
               **gen_kwargs) -> ArrivalBatch:
        """Queue one window of arrivals: pass an `ArrivalBatch`, or
        `n=`/generator kwargs forwarded to `arrival_stream` (the
        window length is the session's; the seed defaults to the
        session seed offset by the windows queued so far)."""
        if isinstance(arrivals, ArrivalBatch):
            if gen_kwargs:
                raise ValueError("pass either an ArrivalBatch or "
                                 "generator kwargs, not both")
            batch = arrivals
        else:
            if isinstance(arrivals, int):
                gen_kwargs.setdefault("n", arrivals)
            gen_kwargs.setdefault("seed",
                                  self.seed + len(self._queue)
                                  + len(self.reports))
            batch = arrival_stream(horizon_h=self.window_h, **gen_kwargs)
        if batch.horizon_h > self.window_h + 1e-9:
            raise ValueError(
                f"batch horizon {batch.horizon_h} h exceeds the session "
                f"window ({self.window_h} h)")
        self._queue.append(batch)
        return batch

    @property
    def pending(self) -> int:
        """Windows queued and not yet ticked."""
        return len(self._queue)

    def window(self) -> ServingWindow:
        """The next window's per-slot context (capacity, carbon,
        background), without scheduling anything."""
        return ServingWindow.build(
            self._t0, self.window_h, slots_per_hour=self.sph,
            workload=self.workload, machine=self.machine, bands=self.bands,
            carbon_sig=self.carbon_sig, price=self.price,
            fill_frac=self.fill_frac, batch_size=self.batch_size)

    def tick(self) -> WindowReport:
        """Schedule and execute the oldest queued window in one sweep
        on the session's device; advances the session clock by one
        window."""
        if not self._queue:
            raise ValueError("no arrivals queued; submit() first")
        report = serve_window(
            self._queue[0], self.window(), policy=self.policy,
            tiers=self.tiers, site=self.site,
            seed=self.seed + len(self.reports), cache_dir=self.cache_dir,
            device=self.device)
        self._queue.pop(0)
        self._t0 += self.window_h
        self.reports.append(report)
        return report

    def drain(self, max_windows: int = 10_000) -> ServingRollup:
        """Tick until the queue is empty; returns the session rollup."""
        for _ in range(max_windows):
            if not self._queue:
                break
            self.tick()
        return self.rollup()

    def rollup(self) -> ServingRollup:
        rs = self.reports
        cost = (sum(r.cost_usd for r in rs)
                if rs and all(r.cost_usd is not None for r in rs) else None)
        peaks = [r.peak_kw for r in rs if r.peak_kw is not None]
        return ServingRollup(
            n_requests=sum(r.n_requests for r in rs),
            n_admitted=sum(r.n_admitted for r in rs),
            n_rejected=sum(r.n_rejected for r in rs),
            n_degraded=sum(r.n_degraded for r in rs),
            n_slo_miss=sum(r.n_slo_miss for r in rs),
            energy_kwh=sum(r.energy_kwh for r in rs),
            co2_kg=sum(r.co2_kg for r in rs), cost_usd=cost,
            peak_kw=max(peaks) if peaks else None, n_windows=len(rs))

    # ---- live mode (decode-serving adapter) -------------------------------
    def gate_open(self, queue_depth: int = 0) -> bool:
        """Admission gate for the live decode engine: open when the
        current grid carbon is at or below `gate` (always open with no
        gate), with a queue-pressure override — a backlog at or above
        `max_queue` forces admissions so dirty hours delay, never
        starve, traffic."""
        if self.gate is None:
            return True
        if queue_depth >= self.max_queue:
            return True
        return float(self.carbon_sig.at(self.clock.hours)) <= self.gate

    def record_tick(self, runtime_s: float, *, active: int = 1,
                    steps: int = 1, intensity: float = 1.0,
                    meta: Optional[dict] = None) -> float:
        """Account one live engine iteration: advance the session
        clock, estimate energy (roofline when a `StepCost` is known,
        machine-profile runtime mode otherwise), convert to CO2 at the
        current grid intensity, and append a tracked unit when the
        session owns a `RunTracker`.  Returns the kWh recorded."""
        self.clock.advance_s(runtime_s)
        if self.step_cost is not None:
            kwh = steps * max(active, 1) * self.energy.step_energy_j(
                self.step_cost, intensity) / 3.6e6
        else:
            kwh = self.energy.runtime_energy_kwh(runtime_s, intensity)
        hour = self.clock.hour_of_day()
        co2 = kwh * float(self.carbon_sig.at(self.clock.hours))
        self.live_units += 1
        self.live_energy_kwh += kwh
        self.live_co2_kg += co2
        if self.tracker is not None:
            self.tracker.record_unit(
                phase=self.bands.band_at(hour), intensity=float(intensity),
                runtime_s=float(runtime_s), energy_kwh=float(kwh),
                sim_time_h=self.clock.hours,
                meta=dict(meta or {}, active=active, steps=steps))
        return kwh


# ---------------------------------------------------------------------------
# Reference implementation (benchmark baseline)
# ---------------------------------------------------------------------------
def _fifo_assign_loop(batch: ArrivalBatch, window: ServingWindow,
                      tiers: Sequence[QualityTier] = DEFAULT_TIERS
                      ) -> Assignment:
    """Per-request Python-loop FIFO — the naive implementation the
    vectorized `FifoServingPolicy` replaces.  Kept as an equivalence
    oracle and a timing baseline; produces the same outputs (service
    slot, finish time, the per-tier demand block) one request at a
    time."""
    budgets = window.budgets
    tier_idx = np.minimum(batch.tier, len(tiers) - 1)
    work = _scaled_work(batch, tiers, tier_idx)
    slot_h = window.slot_h
    S = window.n_slots
    out = np.full(batch.n, -1, dtype=np.int64)
    t_fin = np.full(batch.n, np.inf)
    demand = np.zeros((len(tiers), S))
    s = 0
    room = float(budgets[0]) if S else 0.0
    for i in range(batch.n):
        a = min(int(batch.t_arrive_h[i] / slot_h), S - 1)
        if s < a:
            s = a
            room = float(budgets[s])
        need = float(work[i])
        t = int(tier_idx[i])
        spill = []                      # (slot, amount) before the last
        while need > room + 1e-12:
            need -= room
            spill.append((s, room))
            s += 1
            if s >= S:
                break
            room = float(budgets[s])
        if s >= S:
            break                       # rejected: spill never lands
        room -= need
        for sp, amt in spill:
            demand[t, sp] += amt
        demand[t, s] += need
        out[i] = s
        b = float(budgets[s])
        t_fin[i] = slot_h * (s + min(max((b - room) / max(b, 1e-12),
                                         0.0), 1.0))
    return Assignment("fifo-loop", out, tier_idx, t_fin, demand)


__all__ = ["Assignment", "DEFAULT_FILL_FRAC", "FifoServingPolicy",
           "GreedyServingPolicy", "OptimizedServingPolicy",
           "SERVING_POLICIES", "ServingRollup", "ServingSession",
           "ServingWindow", "WindowReport", "as_serving_policy",
           "execute_assignment", "serve_window"]
