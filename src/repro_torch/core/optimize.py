"""Schedule synthesis: search the schedule space instead of spot-checking it.

The paper's policy analysis *evaluates* six hand-written policies
(off-hours boosting buys ~-9% energy for ~+7% runtime); the carbon-aware
workflow literature (arXiv:2503.13705, arXiv:2508.14625) shows the
interesting question is what the *optimal* schedule looks like.  This
module answers it by treating the trace-grid engine as an objective:

  * the search space is `ParametricSchedule` — one intensity logit per
    day slot, squashed into [u_min, u_max], so every parameter vector is
    a feasible schedule (`core/schedule.py`);
  * the objective is `TraceObjective` (`core/engine_torch.py`) — the
    campaign scan as a function of the intensity table, batched over
    candidates and differentiable (on the card one forward and one
    backward launch of the K3 kernels, `kernels/objective_scan.py`; the
    fleet's `FleetTraceObjective` likewise through K4);
  * two search modes share one scalarization: **grad** (Adam through the
    scan — exact gradients of energy/CO2/runtime w.r.t. every slot) for
    the smooth family, and **cem** (a cross-entropy population search,
    hundreds of candidates per objective call) which needs no gradients
    and handles quantized/discrete intensity levels.

Objectives are weighted sums over campaign metrics plus ε-constraints
(caps) turned into hinge penalties: `minimize co2 s.t. runtime <= D` is
`Objective(weights={"co2_kg": 1}, constraints={"runtime_h": D})`.  All
metrics are normalized by a reference evaluation so penalty weights mean
the same thing across workloads.  `pareto_front` extracts the
non-dominated set from a population's evaluations, giving the
runtime/energy (or runtime/CO2) trade curve in one search — the same
`SimResult` rows the frontier dashboards already render.

The session-level entry points are `Campaign.optimize(...)`
(`core/session.py`) and `Fleet.optimize(...)` (`core/fleet.py`); this
module is the engine room.  The objectives run on `device` (the card by
default): the population's sampling and refits stay on the host in
NumPy, and only the objective's scans (one kernel launch a population
evaluate, one forward and one backward a gradient step) and the
gradient steps' Adam updates run on the device.  The reference's `backend=` raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import model
from repro_torch.core.device import reject_unported
from repro_torch.core.engine import case_slots_per_hour
from repro_torch.core.engine_torch import (EvalMetrics, FleetTraceObjective,
                                           TraceObjective, trace_sweep)
from repro_torch.core.schedule import ParametricSchedule
from repro_torch.core.simulator import SimResult

#: Metrics an objective may weight or cap, with their accepted aliases.
#: `site_peak_kw` is fleet-level only (`optimize_fleet`): the peak total
#: site draw over the horizon.
METRIC_ALIASES: Dict[str, str] = {
    "energy": "energy_kwh", "energy_kwh": "energy_kwh", "kwh": "energy_kwh",
    "co2": "co2_kg", "co2_kg": "co2_kg", "carbon": "co2_kg",
    "runtime": "runtime_h", "runtime_h": "runtime_h", "deadline": "runtime_h",
    "cost": "cost_usd", "cost_usd": "cost_usd", "price": "cost_usd",
    "site_peak_kw": "site_peak_kw", "peak_kw": "site_peak_kw",
    "site_peak": "site_peak_kw",
}
METRIC_KEYS: Tuple[str, ...] = ("energy_kwh", "co2_kg", "runtime_h",
                                "cost_usd")


def canonical_metric(name: str) -> str:
    try:
        return METRIC_ALIASES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; choose from "
                         f"{sorted(set(METRIC_ALIASES))}") from None


#: Robust reductions over a carbon-trace ensemble's CO2 axis.
ROBUST_MODES: Tuple[str, ...] = ("mean", "cvar", "worst")


def _maximum(xp):
    """Elementwise max of the array namespace `xp` (NumPy or torch); the
    torch one splits its gradient evenly at a tie, as the reference's
    `jnp.maximum` does (an objective sitting exactly on a cap)."""
    return np.maximum if xp is np else model.TORCH.maximum


def _amax(values, xp):
    """Max over the last axis; torch's `amax` splits the gradient evenly
    among tied maxima, as the reference's `jnp.max` does."""
    return values.max(axis=-1) if xp is np else torch.amax(values, dim=-1)


def reduce_ensemble(values, robust: str = "mean", alpha: float = 0.9,
                    xp=np):
    """Collapse the trailing ensemble axis of a per-member metric block.

    `"mean"` is the expected value; `"worst"` the max over members;
    `"cvar"` the Conditional Value-at-Risk at level `alpha` — the mean
    of the worst `(1 - alpha)` fraction of members (`alpha=0.9` averages
    the worst 10 %), the standard coherent risk measure between the two
    extremes.  All three are differentiable on tensors (`xp=torch`: sort
    and `amax` propagate gradients), so robust objectives flow through the
    same grad/CEM machinery as deterministic ones.
    """
    if robust == "mean":
        return values.mean(axis=-1)
    if robust == "worst":
        return _amax(values, xp)
    if robust == "cvar":
        E = values.shape[-1]
        k = max(1, int(math.ceil((1.0 - alpha) * E)))
        srt = (np.sort(values, axis=-1) if xp is np
               else torch.sort(values, dim=-1, stable=True).values)
        return srt[..., E - k:].mean(axis=-1)
    raise ValueError(f"unknown robust mode {robust!r}; choose from "
                     f"{ROBUST_MODES}")


def _reduce_metrics(metrics: EvalMetrics, objective: "Objective",
                    xp=np) -> EvalMetrics:
    """Collapse the ensemble axis of `co2_kg` (when present) under the
    objective's robust mode.  The ensemble only carbonizes — the
    schedule family is carbon-blind, so energy/runtime/cost carry no
    member axis — which is why co2 is the one reduced field."""
    co2 = metrics.co2_kg
    if np.ndim(co2) > np.ndim(metrics.energy_kwh):
        co2 = reduce_ensemble(co2, objective.robust, objective.cvar_alpha,
                              xp=xp)
        metrics = metrics._replace(co2_kg=co2)
    return metrics


@dataclasses.dataclass(frozen=True)
class Objective:
    """What "best schedule" means: weighted metrics + ε-constraints.

    `weights` are summed over normalized metrics (lower is better);
    `constraints` are caps handled as one-sided hinge penalties of weight
    `penalty` per *relative* violation — at `penalty=200`, exceeding a
    cap by 1% costs as much as 2 units of normalized objective, so
    feasible optima sit within a fraction of a percent of active caps.
    Unfinished campaigns (workload left past the evaluation horizon) are
    penalized separately and much harder: they are not schedules at all.

    When the case's carbon is a `SignalEnsemble`, `robust` picks how the
    per-member CO2 axis collapses before weighting and constraining:
    `"mean"` (expected CO2), `"cvar"` (mean of the worst `1 - cvar_alpha`
    fraction of members), or `"worst"` (max over members).  A CO2 cap
    under `robust="cvar"` therefore reads "the CVaR of CO2 must stay
    under the cap".
    """
    weights: Mapping[str, float]
    constraints: Mapping[str, float] = dataclasses.field(default_factory=dict)
    penalty: float = 200.0
    unfinished_penalty: float = 1e4
    robust: str = "mean"
    cvar_alpha: float = 0.9

    def __post_init__(self):
        object.__setattr__(self, "weights", {
            canonical_metric(k): float(v) for k, v in self.weights.items()})
        object.__setattr__(self, "constraints", {
            canonical_metric(k): float(v)
            for k, v in self.constraints.items()})
        if not self.weights:
            raise ValueError("objective needs at least one weighted metric")
        for k, cap in self.constraints.items():
            if cap <= 0.0:
                raise ValueError(f"constraint cap for {k} must be positive, "
                                 f"got {cap}")
        if self.robust not in ROBUST_MODES:
            raise ValueError(f"unknown robust mode {self.robust!r}; choose "
                             f"from {ROBUST_MODES}")
        if not (0.0 < self.cvar_alpha < 1.0):
            raise ValueError(f"cvar_alpha must be in (0, 1), got "
                             f"{self.cvar_alpha}")

    @classmethod
    def coerce(cls, objective, constraints=None) -> "Objective":
        """Accept an Objective, a metric name, or a weights mapping."""
        if isinstance(objective, Objective):
            if constraints:
                merged = dict(objective.constraints)
                merged.update({canonical_metric(k): float(v)
                               for k, v in constraints.items()})
                return dataclasses.replace(objective, constraints=merged)
            return objective
        if isinstance(objective, str):
            weights = {canonical_metric(objective): 1.0}
        else:
            weights = dict(objective)
        return cls(weights=weights, constraints=dict(constraints or {}))

    def label(self) -> str:
        """Short provenance tag for schedule/result names."""
        parts = [k.split("_")[0] for k, w in self.weights.items() if w]
        for k in self.constraints:
            parts.append(f"{k.split('_')[0]}<={self.constraints[k]:g}")
        if self.robust != "mean":
            tag = (f"cvar{self.cvar_alpha:g}" if self.robust == "cvar"
                   else self.robust)
            parts.append(tag)
        return ",".join(parts)


def scalarize(metrics: EvalMetrics, objective: Objective,
              scales: Mapping[str, float], xp=np):
    """The scalar loss both search modes minimize (float or array in,
    same shape out; `xp` is NumPy, or torch for tensors).

    An ensemble CO2 axis (co2_kg one dim wider than the other metrics)
    is collapsed first under the objective's robust mode, so weights and
    caps always act on one scalar CO2 per candidate.
    """
    metrics = _reduce_metrics(metrics, objective, xp=xp)
    maximum = _maximum(xp)
    val = 0.0
    for k, w in objective.weights.items():
        val = val + w * getattr(metrics, k) / scales[k]
    for k, cap in objective.constraints.items():
        val = val + objective.penalty * maximum(
            getattr(metrics, k) / cap - 1.0, 0.0)
    # deadband on the unfinished penalty: a linear term would leak the
    # (analytically zero, numerically fp-noise) gradient of the finished
    # state's residual into every step
    return val + objective.unfinished_penalty * maximum(
        metrics.unfinished - 1e-9, 0.0)


@dataclasses.dataclass
class OptimizeResult:
    """What a schedule search hands back.

    `schedule` is the optimized `ParametricSchedule` (drop it into
    `Campaign.run/sweep`, simulators, or controllers like any other
    schedule); `result` is its `SimResult` as evaluated by the real sweep
    engine, directly comparable to any sweep/frontier row; `frontier` is
    the non-dominated set of the final population (population methods
    only) for the frontier dashboards.
    """
    schedule: ParametricSchedule
    result: SimResult
    value: float                      # scalarized objective at the optimum
    metrics: EvalMetrics              # raw metrics at the optimum (floats)
    objective: Objective
    method: str
    history: List[float]              # best objective value per iteration
    evaluations: int                  # total candidate evaluations
    frontier: List[SimResult] = dataclasses.field(default_factory=list)
    co2_ensemble: Optional[np.ndarray] = None   # per-member CO2 at optimum


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Boolean mask of the non-dominated rows of `points` (N, K), all
    objectives minimized.  K=2 runs the sort-and-scan algorithm (fine for
    whole-population inputs); K>2 falls back to pairwise checks."""
    pts = np.asarray(points, dtype=float)
    n, k = pts.shape
    mask = np.zeros(n, dtype=bool)
    if k == 2:
        order = np.lexsort((pts[:, 1], pts[:, 0]))
        best_y = math.inf
        for i in order:
            if pts[i, 1] < best_y - 1e-12:
                mask[i] = True
                best_y = pts[i, 1]
        return mask
    for i in range(n):
        d = ((pts <= pts[i]).all(axis=1) & (pts < pts[i]).any(axis=1))
        mask[i] = not d.any()
    return mask


def _metrics_at(metrics: EvalMetrics, i) -> EvalMetrics:
    return EvalMetrics(*(float(np.asarray(f)[i]) for f in metrics))


def _result_from_metrics(name: str, m: EvalMetrics,
                         has_price: bool) -> SimResult:
    return SimResult(policy=name, runtime_h=m.runtime_h,
                     energy_kwh=m.energy_kwh, co2_kg=m.co2_kg,
                     cost_usd=m.cost_usd if has_price else None)


# ---------------------------------------------------------------------------
# Search modes
# ---------------------------------------------------------------------------
def _grad_search(loss, p0, steps: int, lr: float, device
                 ) -> Tuple[np.ndarray, List[float], int]:
    """Adam on the logits, in fp64 on `device`; the gradient of `loss` by
    `torch.autograd`, whose step through the objective's scan is the
    scan's hand-written backward kernel on the card (K3 / K4) and
    autograd of the plain scan on the CPU.  `loss` maps a parameter tensor on `device` to the
    scalar objective — the single-campaign and joint-fleet searches differ
    only in that closure.  Each step reads the loss back once (one sync a
    step); the clip and the Adam update stay on the device.  Returns the
    best parameters seen (not the last iterate — the loss is
    nonconvex)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    history: List[float] = []
    p = torch.as_tensor(np.asarray(p0, dtype=float), dtype=torch.float64,
                        device=device)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    best_val, best_p = math.inf, p
    for t in range(1, steps + 1):
        p.requires_grad_(True)
        loss_t = loss(p)
        (g,) = torch.autograd.grad(loss_t, p)
        p = p.detach()
        val = loss_t.item()
        if val < best_val:
            best_val, best_p = val, p
        history.append(min(val, history[-1]) if history else val)
        # clip the global norm: one pathological step (a constraint
        # kink, a slot-boundary tie) must not poison Adam's moments
        gnorm = torch.linalg.vector_norm(g)
        g = torch.where(gnorm > 10.0, g * (10.0 / gnorm), g)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mhat = m / (1.0 - b1 ** t)
        vhat = v / (1.0 - b2 ** t)
        # hold, then cosine-decay over the last 40%: the constraint
        # hinges make the endgame landscape stiff and a fixed step
        # oscillates across them, but decaying from the start freezes
        # the slot structure before it has moved
        frac = max(t / steps - 0.6, 0.0) / 0.4
        lr_t = lr * (0.05 + 0.475 * (1.0 + math.cos(math.pi * frac)))
        p = p - lr_t * mhat / (torch.sqrt(vhat) + eps)
    return best_p.detach().cpu().numpy(), history, steps


def _cem_search(evaluate, p0, candidates: int, iterations: int,
                elite_frac: float, init_std: float, smoothing: float,
                seed: int) -> Tuple[np.ndarray, List[float], int]:
    """Cross-entropy method over the logits: sample a Gaussian population,
    evaluate all candidates in one call, refit mean/std on the elites.
    `evaluate` maps an (N, D) logit population to (N,) objective values
    (one `evaluate_batch` on the device underneath; the closure owns
    level snapping and Pareto collection).  Sampling and refits are host
    NumPy from `RandomState(seed)`, so a seed gives the reference's
    population.  Needs no gradients and survives quantized intensity
    levels: candidates are snapped *before* evaluation, so the search
    optimizes the same quantized objective the result reports —
    snapping only the final answer could silently break the constraints
    the smooth search satisfied."""
    rng = np.random.RandomState(seed)
    n = len(p0)
    mean = np.asarray(p0, dtype=float).copy()
    std = np.full(n, float(init_std))
    n_elite = max(2, int(round(candidates * elite_frac)))
    best_val, best_p = math.inf, mean.copy()
    history: List[float] = []
    for _ in range(iterations):
        pop = mean[None, :] + std[None, :] * rng.randn(candidates, n)
        pop[0] = mean                     # incumbent mean
        pop[1] = best_p                   # elitism: best-so-far survives
        vals = np.asarray(evaluate(pop))
        order = np.argsort(vals)
        if vals[order[0]] < best_val:
            best_val = float(vals[order[0]])
            best_p = pop[order[0]].copy()
        history.append(best_val)
        elite = pop[order[:n_elite]]
        mean = smoothing * elite.mean(axis=0) + (1.0 - smoothing) * mean
        std = smoothing * elite.std(axis=0) + (1.0 - smoothing) * std
        std = np.maximum(std, 0.02)       # keep exploring
    return best_p, history, candidates * iterations


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------
def optimize_schedule(case, objective: Union[str, Mapping, Objective] = "co2",
                      constraints: Optional[Mapping] = None, *,
                      method: str = "auto",
                      n_slots: Optional[int] = None,
                      u_min: float = 0.05, u_max: float = 1.0,
                      batch_size: int = 50,
                      price=None,
                      horizon_h: Optional[float] = None,
                      candidates: int = 256, iterations: int = 40,
                      elite_frac: float = 0.125, init_std: float = 1.5,
                      smoothing: float = 0.7,
                      steps: int = 800, lr: float = 0.1,
                      init: Union[float, Sequence[float]] = 0.6,
                      levels: Optional[Sequence[float]] = None,
                      seed: int = 0, backend: Optional[str] = None,
                      pareto: bool = False,
                      robust: Optional[str] = None,
                      cvar_alpha: Optional[float] = None,
                      precision: str = "fp64",
                      device=None) -> OptimizeResult:
    """Search the `ParametricSchedule` space for the case's best schedule.

    `objective` is a metric name, a weights mapping, or an `Objective`;
    `constraints` maps metrics to caps (ε-constraints), e.g.
    ``optimize_schedule(case, "co2", {"runtime_h": 200.0})`` for
    *min CO2 s.t. the 200 h deadline*.  `method`: ``"grad"`` (Adam
    through the scan — excellent from a warm start, can stall from a cold
    one), ``"cem"`` (population search; robust), ``"cem+grad"``
    (population search, then gradient polish from its best candidate), or
    ``"auto"`` (cem+grad, or cem when `levels` is given).  `init` seeds
    the search — a flat intensity or
    a per-slot table (e.g. an existing policy's, via
    `ParametricSchedule.from_intensities`).  `levels`, if given,
    restricts intensities to a discrete level set: population candidates
    are snapped *before* evaluation (the search optimizes the quantized
    objective, so constraints hold for the quantized schedule) and the
    returned schedule's table is exactly level-valued.  `pareto=True`
    (cem only) attaches the non-dominated runtime-vs-primary-metric set
    of every candidate evaluated.

    `robust` / `cvar_alpha` override the objective's ensemble reduction
    when the case's carbon is a `SignalEnsemble` — "mean" optimizes
    expected CO2 across the members, "cvar" the mean of the worst
    `1 - cvar_alpha` tail, "worst" the maximum (see `reduce_ensemble`);
    all three run under both search modes.

    `precision="mixed"` evaluates search candidates with fp32 scan
    dynamics (fp64 accumulators — see `TraceObjective`); the final
    reported row always re-runs through the engine at exact fp64, so
    only the search trajectory is approximate.

    `device` is where the objective, the gradient steps and the final
    `trace_sweep` run (the card by default; "cpu" runs the plain
    PyTorch versions of the kernels).  `backend=` raises.

    See docs/OPTIMIZER.md for objective/constraint semantics and for
    when grad beats population search.
    """
    reject_unported(backend=backend)
    obj = Objective.coerce(objective, constraints)
    if robust is not None or cvar_alpha is not None:
        obj = dataclasses.replace(
            obj, robust=robust if robust is not None else obj.robust,
            cvar_alpha=(cvar_alpha if cvar_alpha is not None
                        else obj.cvar_alpha))
    if candidates < 2:
        raise ValueError(f"candidates must be >= 2, got {candidates} "
                         "(the population keeps the incumbent mean and "
                         "the best-so-far candidate)")
    sph = case_slots_per_hour(case)
    if n_slots is not None:
        if n_slots % 24:
            raise ValueError(f"n_slots must be a multiple of 24, "
                             f"got {n_slots}")
        sph = math.lcm(sph, n_slots // 24)
    n = 24 * sph

    needs_price = any(k == "cost_usd" for k in
                      list(obj.weights) + list(obj.constraints))
    if needs_price and price is None:
        raise ValueError("objective involves cost_usd but no price signal "
                         "was given")

    if horizon_h is None and "runtime_h" in obj.constraints:
        horizon_h = obj.constraints["runtime_h"] * 1.25 + 24.0
    to = TraceObjective(case, price=price, slots_per_hour=sph,
                        horizon_h=horizon_h, batch_size=float(batch_size),
                        precision=precision, device=device)

    if np.ndim(init) == 0:
        init_u = np.full(n, float(init))
    else:
        init_arr = np.asarray(init, dtype=float)
        if n % len(init_arr):
            raise ValueError(f"init table of {len(init_arr)} slots does not "
                             f"tile the {n}-slot grid")
        init_u = np.repeat(init_arr, n // len(init_arr))
    seed_sched = ParametricSchedule.from_intensities(
        init_u, u_min=u_min, u_max=u_max, batch_size=batch_size)
    p0 = np.asarray(seed_sched.logits, dtype=float)

    # normalization: one reference evaluation makes weights/penalties
    # workload-independent ("1 unit" = the seed schedule's metric);
    # ensemble CO2 is reduced first so the scale matches the reduced
    # quantity the loss actually weights
    ref = _reduce_metrics(to.evaluate_batch(init_u[None, :]), obj, xp=np)
    scales = {k: max(abs(float(np.asarray(getattr(ref, k))[0])), 1e-9)
              for k in METRIC_KEYS}

    if method == "auto":
        method = "cem+grad" if levels is None else "cem"
    if method not in ("grad", "cem", "cem+grad"):
        raise ValueError(f"unknown method {method!r}; use 'grad', 'cem', "
                         "'cem+grad' or 'auto'")
    if levels is not None and "grad" in method:
        raise ValueError(
            "levels= needs a population method (use method='cem' or "
            "'auto'): a gradient search optimizes the smooth objective, "
            "and snapping its result afterwards could silently violate "
            "the constraints the search satisfied")

    lv = (np.sort(np.asarray(levels, dtype=float))
          if levels is not None else None)
    collect: Optional[list] = [] if (pareto and "cem" in method) else None
    n_evals = 0
    history: List[float] = []
    if "cem" in method:
        def eval_pop(pop):
            u = ParametricSchedule.u_from_logits(pop, u_min, u_max, xp=np)
            if lv is not None:            # same snap as the final schedule
                u = lv[np.argmin(np.abs(u[..., None]
                                        - lv[None, None, :]), axis=-1)]
            mets = to.evaluate_batch(u)
            vals = np.asarray(scalarize(mets, obj, scales, xp=np))
            if collect is not None:
                collect.append((pop.copy(), mets))
            return vals

        best_p, history, n_evals = _cem_search(
            eval_pop, p0, candidates, iterations, elite_frac, init_std,
            smoothing, seed)
        p0 = best_p                       # grad polish starts from the
    if "grad" in method:                  # population's best candidate
        def grad_loss(p):
            u = ParametricSchedule.u_from_logits(p, u_min, u_max, xp=torch)
            return scalarize(to.evaluate(u), obj, scales, xp=torch)

        best_p, ghist, gevals = _grad_search(grad_loss, p0, steps, lr,
                                             to.device)
        start = history[-1] if history else math.inf
        history += [min(v, start) for v in ghist]
        n_evals += gevals

    name = f"optimized[{obj.label()}]"
    sched = seed_sched.with_logits(best_p, name=name)
    if lv is not None:
        # snap at table materialization (ParametricSchedule.levels) — the
        # identical argmin the search applied per candidate; a
        # from_intensities round trip could not reproduce the level
        # values bit-exactly
        sched = dataclasses.replace(sched, name=name + "#q",
                                    levels=tuple(float(v) for v in lv))

    # report through the real engine so the row is directly comparable to
    # any sweep/frontier output (same physics; fp-level agreement)
    final_case = dataclasses.replace(case, schedule=sched, label=sched.name)
    result = trace_sweep([final_case], price=price, slots_per_hour=sph,
                         device=to.device)[0]
    raw_best = to.evaluate_batch(sched.intensity_table()[None, :])
    co2_members = (np.asarray(raw_best.co2_kg)[0].copy()
                   if to.ensemble_size else None)
    best_metrics = _metrics_at(_reduce_metrics(raw_best, obj, xp=np), 0)
    value = float(scalarize(best_metrics, obj, scales, xp=np))

    frontier: List[SimResult] = []
    if collect:
        all_mets = EvalMetrics(*(np.concatenate(
            [np.asarray(getattr(m, k)) for _, m in collect])
            for k in EvalMetrics._fields))
        all_mets = _reduce_metrics(all_mets, obj, xp=np)
        # frontier axes: runtime vs the heaviest non-runtime weighted
        # metric (runtime is always the frontier's x-axis)
        others = [k for k in obj.weights
                  if k != "runtime_h" and obj.weights[k]]
        primary = (max(others, key=lambda k: abs(obj.weights[k]))
                   if others else "energy_kwh")
        feasible = all_mets.unfinished <= 1e-6
        for k, cap in obj.constraints.items():
            if k != "runtime_h":
                feasible &= getattr(all_mets, k) <= cap * (1.0 + 1e-6)
        idx = np.flatnonzero(feasible)
        if idx.size:
            pts = np.stack([all_mets.runtime_h[idx],
                            getattr(all_mets, primary)[idx]], axis=1)
            front = idx[pareto_front(pts)]
            front = front[np.argsort(all_mets.runtime_h[front])]
            frontier = [
                _result_from_metrics(f"{name}/pareto{j}",
                                     _metrics_at(all_mets, i), to.has_price)
                for j, i in enumerate(front)]

    return OptimizeResult(schedule=sched, result=result, value=value,
                          metrics=best_metrics, objective=obj, method=method,
                          history=history, evaluations=n_evals,
                          frontier=frontier, co2_ensemble=co2_members)


# ---------------------------------------------------------------------------
# Joint fleet optimization (the M-campaigns axis)
# ---------------------------------------------------------------------------
def scalarize_fleet(fm, objective: Objective, scales: Mapping[str, float],
                    deadlines=None, xp=np):
    """The scalar loss of a joint fleet schedule (FleetEvalMetrics in,
    float or (...,) array out; `xp` is NumPy, or torch for tensors).

    Weighted metrics act on *site totals* (summed over campaigns);
    `site_peak_kw` weights/caps act on the site-level peak draw; a
    `runtime_h` cap and the per-campaign `deadlines` act per campaign
    (campaigns run concurrently — a sum of runtimes means nothing).
    Unfinished campaigns are penalized per member, like the single-
    campaign `scalarize`.
    """
    maximum = _maximum(xp)
    site = {k: getattr(fm, k).sum(axis=-1)
            for k in ("energy_kwh", "co2_kg", "cost_usd")}
    val = 0.0
    for k, w in objective.weights.items():
        if k == "site_peak_kw":
            val = val + w * fm.site_peak_kw / scales[k]
        elif k == "runtime_h":
            # makespan: the fleet is done when its last campaign is
            val = val + w * _amax(fm.runtime_h, xp) / scales[k]
        else:
            val = val + w * site[k] / scales[k]
    for k, cap in objective.constraints.items():
        if k == "site_peak_kw":
            val = val + objective.penalty * maximum(
                fm.site_peak_kw / cap - 1.0, 0.0)
        elif k == "runtime_h":
            val = val + objective.penalty * maximum(
                fm.runtime_h / cap - 1.0, 0.0).sum(axis=-1)
        else:
            val = val + objective.penalty * maximum(
                site[k] / cap - 1.0, 0.0)
    if deadlines is not None:
        dl = np.asarray(deadlines, dtype=float)
        dl = np.where(dl > 0.0, dl, np.inf)
        if xp is not np:
            dl = torch.as_tensor(dl, dtype=fm.runtime_h.dtype,
                                 device=fm.runtime_h.device)
        val = val + objective.penalty * maximum(
            fm.runtime_h / dl - 1.0, 0.0).sum(axis=-1)
    return val + objective.unfinished_penalty * maximum(
        fm.unfinished - 1e-9, 0.0).sum(axis=-1)


@dataclasses.dataclass
class FleetOptimizeResult:
    """What a joint fleet-schedule search hands back.

    `schedules[m]` is campaign m's optimized `ParametricSchedule` (a
    drop-in Schedule); `results`/`site` are the per-campaign
    `SimResult`s and site rollup as evaluated by the real grouped-lane
    engine under the site cap; `independent` (when the search
    warm-started from per-campaign optima) holds those standalone
    `OptimizeResult`s for comparison.
    """
    schedules: List[ParametricSchedule]
    results: List[SimResult]
    site: object                          # fleet.SiteRollup
    value: float
    metrics: object                       # FleetEvalMetrics at the optimum
    objective: Objective
    method: str
    history: List[float]
    evaluations: int
    independent: List[OptimizeResult] = dataclasses.field(
        default_factory=list)


def optimize_fleet(cases: Sequence, site=None, *,
                   objective: Union[str, Mapping, Objective] = "co2",
                   constraints: Optional[Mapping] = None,
                   method: str = "auto",
                   n_slots: Optional[int] = None,
                   u_min: float = 0.05, u_max: float = 1.0,
                   batch_size: int = 50,
                   price=None,
                   horizon_h: Optional[float] = None,
                   candidates: int = 192, iterations: int = 30,
                   elite_frac: float = 0.125, init_std: float = 1.0,
                   smoothing: float = 0.7,
                   steps: int = 500, lr: float = 0.1,
                   init: Union[str, float, Sequence] = "independent",
                   seed: int = 0,
                   backend: Optional[str] = None,
                   device=None) -> FleetOptimizeResult:
    """Search the joint `ParametricSchedule` space for a whole fleet.

    `cases` are the M member `SweepCase`s (shared start_hour/bands, one
    carbon signal; per-campaign `deadline_h` become runtime caps) and
    `site` a `repro_torch.core.fleet.Site` whose cap/office draw couple them
    (None = uncoupled).  The parameter vector is M x n_slots logits —
    campaign m's day schedule in row m — optimized through
    `FleetTraceObjective` with the same Adam-through-the-scan and
    population machinery as `optimize_schedule` (the searches share
    one generic loss interface).

    A *physical* site cap is enforced by the curtailment inside the
    objective (no separate constraint needed — idle and office draw are
    not sheddable, so a soft `site_peak_kw` cap below the physical one
    would only distort the objective).  To instead *plan* under a peak
    budget — schedule around the peak rather than rely on reactive
    throttling — pass an uncapped site and an explicit
    `constraints={"site_peak_kw": budget}`.

    `init="independent"` (default) warm-starts from each campaign's own
    `optimize_schedule` optimum (same budgets, no coupling): since both
    searches keep the best candidate seen — including the start — the
    joint result is never worse than the independent optima evaluated
    under the shared cap.  `init` also accepts a flat intensity or an
    (M, n_slots) intensity table.

    `device` is where the objectives, the gradient steps and the final
    `fleet_sweep` run (the card by default); `backend=` raises.
    """
    reject_unported(backend=backend)
    if not len(cases):
        raise ValueError("optimize_fleet needs at least one case")
    M = len(cases)
    obj = Objective.coerce(objective, constraints)
    site_cap = getattr(site, "power_cap_kw", None)
    office_kw = float(getattr(site, "office_kw", 0.0) or 0.0)
    deadlines = np.array([float(getattr(c, "deadline_h", 0.0) or 0.0)
                          for c in cases])

    sph = 1
    for c in cases:
        sph = math.lcm(sph, case_slots_per_hour(c))
    if n_slots is not None:
        if n_slots % 24:
            raise ValueError(f"n_slots must be a multiple of 24, "
                             f"got {n_slots}")
        sph = math.lcm(sph, n_slots // 24)
    n = 24 * sph

    needs_price = any(k == "cost_usd" for k in
                      list(obj.weights) + list(obj.constraints))
    if needs_price and price is None:
        raise ValueError("objective involves cost_usd but no price signal "
                         "was given")

    if horizon_h is None and deadlines.max(initial=0.0) > 0.0:
        horizon_h = float(deadlines.max()) * 1.25 + 24.0
    fo = FleetTraceObjective(cases, site_cap_kw=site_cap,
                             office_kw=office_kw, price=price,
                             slots_per_hour=sph, horizon_h=horizon_h,
                             batch_size=float(batch_size), device=device)

    # ---- seed the joint search -------------------------------------------
    independent: List[OptimizeResult] = []
    if isinstance(init, str):
        if init != "independent":
            raise ValueError(f"unknown init {init!r}; use 'independent', a "
                             "flat intensity, or an (M, n_slots) table")
        # the single-campaign objective knows no site_peak_kw: strip it
        # from constraints AND weights (a peak-only objective falls back
        # to CO2 for the warm start — the joint search still optimizes
        # the real objective afterwards)
        sub_weights = {k: v for k, v in obj.weights.items()
                       if k != "site_peak_kw"}
        sub_obj = dataclasses.replace(
            obj, weights=sub_weights or {"co2_kg": 1.0},
            constraints={k: v for k, v in obj.constraints.items()
                         if k != "site_peak_kw"})
        for m, c in enumerate(cases):
            independent.append(optimize_schedule(
                c, sub_obj,
                {"runtime_h": deadlines[m]} if deadlines[m] else None,
                method=method, n_slots=n, u_min=u_min, u_max=u_max,
                batch_size=batch_size, price=price,
                candidates=candidates, iterations=iterations,
                elite_frac=elite_frac, init_std=init_std,
                smoothing=smoothing, steps=steps, lr=lr, seed=seed + m,
                device=fo.device))
        init_u = np.stack([r.schedule.intensity_table()
                           for r in independent])
    elif np.ndim(init) == 0:
        init_u = np.full((M, n), float(init))
    else:
        init_u = np.asarray(init, dtype=float)
        if init_u.shape[0] != M or n % init_u.shape[1]:
            raise ValueError(f"init table of shape {init_u.shape} does not "
                             f"tile the ({M}, {n}) joint grid")
        init_u = np.repeat(init_u, n // init_u.shape[1], axis=1)

    seed_scheds = [ParametricSchedule.from_intensities(
        init_u[m], u_min=u_min, u_max=u_max, batch_size=batch_size)
        for m in range(M)]
    p0 = np.concatenate([np.asarray(s.logits, dtype=float)
                         for s in seed_scheds])

    # normalization: one reference evaluation of the seed makes weights
    # and penalties workload-independent, like the single-campaign path
    ref = fo.evaluate_batch(init_u[None])
    scales = {k: max(abs(float(np.asarray(getattr(ref, k)).sum())), 1e-9)
              for k in METRIC_KEYS}
    scales["site_peak_kw"] = max(float(np.asarray(ref.site_peak_kw)
                                       .ravel()[0]), 1e-9)

    if method == "auto":
        method = "cem+grad"
    if method not in ("grad", "cem", "cem+grad"):
        raise ValueError(f"unknown method {method!r}; use 'grad', 'cem', "
                         "'cem+grad' or 'auto'")

    n_evals = 0
    history: List[float] = []
    if "cem" in method:
        def eval_pop(pop):
            u = ParametricSchedule.u_from_logits(
                pop.reshape(-1, M, n), u_min, u_max, xp=np)
            fm = fo.evaluate_batch(u)
            return np.asarray(scalarize_fleet(fm, obj, scales, deadlines,
                                              xp=np))

        best_p, history, n_evals = _cem_search(
            eval_pop, p0, candidates, iterations, elite_frac, init_std,
            smoothing, seed)
        p0 = best_p
    if "grad" in method:
        def grad_loss(p):
            u = ParametricSchedule.u_from_logits(p.reshape(M, n), u_min,
                                                 u_max, xp=torch)
            return scalarize_fleet(fo.evaluate(u), obj, scales, deadlines,
                                   xp=torch)

        best_p, ghist, gevals = _grad_search(grad_loss, p0, steps, lr,
                                             fo.device)
        start = history[-1] if history else math.inf
        history += [min(v, start) for v in ghist]
        n_evals += gevals

    label = f"optimized_fleet[{obj.label()}]"
    best_logits = np.asarray(best_p, dtype=float).reshape(M, n)
    schedules = [
        seed_scheds[m].with_logits(
            best_logits[m],
            name=f"{label}/{getattr(cases[m].workload, 'name', m)}")
        for m in range(M)]

    # report through the real grouped-lane engine so the rows are
    # directly comparable to any fleet sweep
    from repro_torch.core.fleet import Site, fleet_sweep
    eng_site = site if site is not None else Site(
        power_cap_kw=site_cap, office_kw=office_kw, bands=cases[0].bands,
        carbon=cases[0].carbon, price=price)
    final_cases = [dataclasses.replace(c, schedule=s, label=s.name)
                   for c, s in zip(cases, schedules)]
    fr = fleet_sweep([final_cases], eng_site, price=price, names=[label],
                     device=fo.device)[0]

    u_best = np.stack([s.intensity_table() for s in schedules])
    raw = fo.evaluate_batch(u_best[None])
    best_metrics = type(raw)(*(np.asarray(f)[0] for f in raw))
    value = float(np.asarray(scalarize_fleet(raw, obj, scales, deadlines,
                                             xp=np))[0])
    return FleetOptimizeResult(
        schedules=schedules, results=fr.campaigns, site=fr.site,
        value=value, metrics=best_metrics, objective=obj, method=method,
        history=history, evaluations=n_evals, independent=independent)


__all__ = ["METRIC_ALIASES", "METRIC_KEYS", "ROBUST_MODES",
           "FleetOptimizeResult", "Objective", "OptimizeResult",
           "canonical_metric", "optimize_fleet", "optimize_schedule",
           "pareto_front", "reduce_ensemble", "scalarize", "scalarize_fleet"]
