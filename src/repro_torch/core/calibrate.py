"""Fit the shared rate/power model to *measured* runs (RunTracker logs).

CARINA's sweeps and optimizers are only as good as `core/model.py`'s
parameters.  This module closes the loop: lift a `RunTracker` JSONL
unit stream into per-unit observed (throughput, average power)
targets, then fit the rate/power parameters by the same Adam machinery
the schedule optimizer uses (`optimize._grad_search`), with the model's
NumPy/torch polymorphism providing the gradient path: `loss_fn(model.TORCH)`
is differentiated by `torch.autograd` on the chosen device.

`CalibrationObjective` is the per-unit measured-targets analogue of the
engine's `TraceObjective`: where `TraceObjective` maps a *schedule*
parameter vector to a scalar loss through the scan, this maps a *model*
parameter vector to a scalar misfit against logged units — same closure
contract, so `_grad_search` drives both.  Parameters are fitted in log
space (theta_i = init_i * exp(p_i)): positivity is structural and the
search is conditioned on *relative* moves, so watts-scale and unitless
parameters share one learning rate.

A NumPy mirror (`_fd_adam`, deterministic central differences + the
same Adam update, without the gradient search's learning-rate decay)
is `backend="numpy"`; bootstrap confidence intervals resample units via
multinomial weights and refit on that mirror, on the host.  The
reference's `backend="jax"` raises.

Surfaced as `Campaign.calibrate(log_path=...)`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import model
from repro_torch.core.device import reject_unported, resolve_device
from repro_torch.core.policy import TimeBands
from repro_torch.core.tracker import UnitRecord, load_units

# The identifiable parameter set, given band-varying background and
# hour-varying intensity: throughput observations pin (rate_at_full,
# gamma), power observations pin (idle_w, dyn_w, overhead_w_frac).
# `alpha` and `batch_overhead_s` stay fixed at their configured values —
# alpha trades off against dyn_w on smooth load ranges, and the batch
# overhead is directly measurable, not worth burning excitation on.
FIT_PARAMS = ("rate_at_full", "gamma", "idle_w", "dyn_w",
              "overhead_w_frac")
_WORKLOAD_PARAMS = frozenset({"rate_at_full", "batch_overhead_s"})
_MACHINE_PARAMS = frozenset({"idle_w", "dyn_w", "alpha", "gamma",
                             "overhead_w_frac"})


@dataclasses.dataclass(frozen=True)
class Observations:
    """Per-unit measured operating points lifted from a tracker log."""
    u: np.ndarray            # worker intensity commanded
    batch: np.ndarray        # batch size
    background: np.ndarray   # contention load (from the unit's band)
    scen_per_s: np.ndarray   # observed throughput (scenarios / wall s)
    p_avg_w: np.ndarray      # observed average power (W)
    weight: np.ndarray       # per-unit weight (wall seconds, normalized)

    @property
    def n(self) -> int:
        return int(self.u.shape[0])


def observations_from_units(units: Sequence[UnitRecord],
                            bands: Optional[TimeBands] = None
                            ) -> Observations:
    """Lift tracked units into calibration targets.

    Keeps units that carry what the model predicts: positive runtime, a
    commanded intensity, a scenario count (`meta["scenarios"]`) and a
    batch size (`meta["batch"]`).  The unit's band name maps to the
    contention background via `bands`; units from unknown bands are
    dropped rather than guessed at.
    """
    bands = bands or TimeBands()
    u, batch, bg, thr, pw, w = [], [], [], [], [], []
    for r in units:
        scen = float(r.meta.get("scenarios", 0.0) or 0.0)
        b = float(r.meta.get("batch", 0.0) or 0.0)
        if r.runtime_s <= 0.0 or r.intensity <= 0.0 or scen <= 0.0 \
                or b <= 0.0 or r.energy_kwh <= 0.0:
            continue
        try:
            background = float(bands.background(r.phase))
        except KeyError:
            continue
        u.append(float(r.intensity))
        batch.append(b)
        bg.append(background)
        thr.append(scen / r.runtime_s)
        pw.append(r.energy_kwh * 3.6e6 / r.runtime_s)
        w.append(r.runtime_s)
    if not u:
        raise ValueError(
            "no calibratable units: records need runtime_s > 0, "
            "intensity > 0, energy_kwh > 0 and meta scenarios/batch "
            "(RunTracker logs from simulate_campaign / Campaign.run("
            "track=True) qualify)")
    weight = np.asarray(w, dtype=float)
    return Observations(u=np.asarray(u, dtype=float),
                        batch=np.asarray(batch, dtype=float),
                        background=np.asarray(bg, dtype=float),
                        scen_per_s=np.asarray(thr, dtype=float),
                        p_avg_w=np.asarray(pw, dtype=float),
                        weight=weight / weight.sum())


def load_observations(log_path: str,
                      bands: Optional[TimeBands] = None) -> Observations:
    """`observations_from_units` over a JSONL tracker log on disk."""
    return observations_from_units(load_units(log_path), bands)


class CalibrationObjective:
    """Model-parameter vector -> weighted relative-misfit scalar.

    The loss is the runtime-weighted mean of squared *relative* errors
    in throughput and average power — relative, so scenarios/s and
    watts contribute on equal footing and the optimum is scale-free.
    `loss_fn(xp, device)` returns a closure `loss(p, w=None)` over the
    chosen array namespace (`np`, or `model.TORCH` with the observations
    as fp64 tensors on `device`), where `w` is an optional per-unit
    resampling weight vector (bootstrap).
    """

    def __init__(self, obs: Observations, workload, machine,
                 fit: Sequence[str] = FIT_PARAMS):
        bad = [f for f in fit
               if f not in _WORKLOAD_PARAMS | _MACHINE_PARAMS]
        if bad:
            raise ValueError(f"unknown fit parameter(s) {bad}; choose "
                             f"from {sorted(_WORKLOAD_PARAMS | _MACHINE_PARAMS)}")
        self.obs = obs
        self.fit: Tuple[str, ...] = tuple(fit)
        self.params: Dict[str, float] = {
            "rate_at_full": float(workload.rate_at_full),
            "batch_overhead_s": float(workload.batch_overhead_s),
            "idle_w": float(machine.idle_w),
            "dyn_w": float(machine.dyn_w),
            "alpha": float(machine.alpha),
            "gamma": float(machine.gamma),
            "overhead_w_frac": float(machine.overhead_w_frac)}
        zero = [f for f in self.fit if self.params[f] == 0.0]
        if zero:
            raise ValueError(
                f"cannot fit {zero} from a zero initial value (log-space "
                "parameterization needs a nonzero starting point); set a "
                "rough prior on the workload/machine first")

    def theta(self, p) -> Dict[str, object]:
        """Decode a log-space search vector into named parameters."""
        out = dict(self.params)
        for i, f in enumerate(self.fit):
            out[f] = self.params[f] * np.exp(np.asarray(p, dtype=float)[i])
        return {k: float(v) for k, v in out.items()}

    def loss_fn(self, xp=np, device=None):
        o = self.obs
        fixed = self.params
        fit = self.fit
        arrays = (o.u, o.batch, o.background, o.scen_per_s, o.p_avg_w,
                  o.weight)
        if xp is not np:
            arrays = tuple(torch.as_tensor(a, dtype=torch.float64,
                                           device=device) for a in arrays)
        u, batch, bg, obs_r, obs_p, base_w = arrays

        def loss(p, w=None):
            th = dict(fixed)
            for i, f in enumerate(fit):
                th[f] = fixed[f] * xp.exp(p[i])
            r = model.rates(u, batch, bg,
                            rate_at_full=th["rate_at_full"],
                            batch_overhead_s=th["batch_overhead_s"],
                            idle_w=th["idle_w"], dyn_w=th["dyn_w"],
                            alpha=th["alpha"], gamma=th["gamma"],
                            overhead_w_frac=th["overhead_w_frac"], xp=xp)
            err = ((r.scen_per_s - obs_r) / obs_r) ** 2 \
                + ((r.p_avg_w - obs_p) / obs_p) ** 2
            ww = base_w if w is None else base_w * w
            return (ww * err).sum() / ww.sum()

        return loss


def _fd_adam(loss, p0, steps: int, lr: float, eps: float = 1e-5
             ) -> Tuple[np.ndarray, List[float]]:
    """Deterministic central-difference Adam: the NumPy mirror of
    `optimize._grad_search` (same moments, same 10.0 norm clip, best
    parameters seen returned — the loss is nonconvex)."""
    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    p = np.asarray(p0, dtype=float).copy()
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    best_val, best_p = math.inf, p.copy()
    history: List[float] = []
    for t in range(1, steps + 1):
        val = float(loss(p))
        if val < best_val:
            best_val, best_p = val, p.copy()
        history.append(min(val, history[-1]) if history else val)
        g = np.empty_like(p)
        for i in range(len(p)):
            d = np.zeros_like(p)
            d[i] = eps
            g[i] = (float(loss(p + d)) - float(loss(p - d))) / (2.0 * eps)
        gnorm = float(np.linalg.norm(g))
        if gnorm > 10.0:
            g *= 10.0 / gnorm
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mh = m / (1.0 - b1 ** t)
        vh = v / (1.0 - b2 ** t)
        p = p - lr * mh / (np.sqrt(vh) + adam_eps)
    return best_p, history


def _fit(objective: CalibrationObjective, p0: np.ndarray, steps: int,
         lr: float, backend: str, device
         ) -> Tuple[np.ndarray, List[float]]:
    if backend == "torch":
        from repro_torch.core.optimize import _grad_search
        loss = objective.loss_fn(model.TORCH, device)
        best_p, history, _ = _grad_search(loss, p0, steps, lr, device)
        return np.asarray(best_p, dtype=float), history
    best_p, history = _fd_adam(objective.loss_fn(np), p0, steps, lr)
    return best_p, history


def _resolve_backend(backend: Optional[str]) -> str:
    """None -> "torch" (autograd on the device), "numpy" -> the host
    mirror; the reference's "jax" raises."""
    if backend not in (None, "jax", "numpy"):
        raise ValueError(f"backend must be None or 'numpy', got "
                         f"{backend!r}")
    if backend == "jax":
        reject_unported(backend=backend)
    return "torch" if backend is None else backend


@dataclasses.dataclass(frozen=True)
class CalibratedModel:
    """A fitted parameter set + provenance, ready to apply to a session."""
    params: Dict[str, float]            # fitted values (fit subset only)
    init: Dict[str, float]              # the starting values
    ci: Dict[str, Tuple[float, float]]  # bootstrap CI per fitted param
    fit: Tuple[str, ...]
    loss: float
    history: Tuple[float, ...]
    n_units: int
    backend: str                        # "torch" or "numpy"
    source: Optional[str] = None        # log path the fit came from
    zone: Optional[str] = None          # emission-factor zone, if logged

    def apply(self, workload, machine):
        """(workload, machine) with the fitted parameters substituted."""
        wl_kw = {k: v for k, v in self.params.items()
                 if k in _WORKLOAD_PARAMS}
        m_kw = {k: v for k, v in self.params.items()
                if k in _MACHINE_PARAMS}
        return (dataclasses.replace(workload, **wl_kw) if wl_kw
                else workload,
                dataclasses.replace(machine, **m_kw) if m_kw else machine)

    def rel_error(self, truth: Mapping[str, float]) -> Dict[str, float]:
        """|fitted/true - 1| per fitted parameter present in `truth`."""
        return {k: abs(self.params[k] / float(truth[k]) - 1.0)
                for k in self.params if k in truth}


def fit_calibration(obs: Observations, workload, machine, *,
                    fit: Sequence[str] = FIT_PARAMS,
                    steps: int = 500, lr: float = 0.1,
                    bootstrap: int = 0, seed: int = 0,
                    confidence: float = 0.95,
                    backend: Optional[str] = None,
                    source: Optional[str] = None,
                    zone: Optional[str] = None,
                    device=None) -> CalibratedModel:
    """Fit model parameters to observations; the calibration entry point.

    The point estimate is Adam through `torch.autograd` via
    `optimize._grad_search` on `device` (the card by default, "cpu"
    otherwise), or with `backend="numpy"` the deterministic
    finite-difference mirror on the host; `backend="jax"` raises.
    `bootstrap` > 0 adds seeded unit-resampling confidence intervals:
    each replicate reweights units by a multinomial draw and refits on
    the NumPy mirror, warm-started from the point estimate; `ci` maps
    each fitted parameter to its central `confidence` interval.
    """
    be = _resolve_backend(backend)
    dev = resolve_device(device) if be == "torch" else None
    objective = CalibrationObjective(obs, workload, machine, fit=fit)
    p0 = np.zeros(len(objective.fit))
    best_p, history = _fit(objective, p0, steps, lr, be, dev)
    fitted = objective.theta(best_p)
    final_loss = float(objective.loss_fn(np)(best_p))

    ci: Dict[str, Tuple[float, float]] = {}
    if bootstrap > 0:
        rng = np.random.RandomState(seed)
        loss_np = objective.loss_fn(np)
        boot_steps = max(100, steps // 3)
        thetas = []
        for _ in range(int(bootstrap)):
            w = rng.multinomial(obs.n, np.full(obs.n, 1.0 / obs.n)
                                ).astype(float)
            bp, _ = _fd_adam(lambda p: loss_np(p, w), best_p,
                             boot_steps, lr)
            thetas.append([objective.theta(bp)[f] for f in objective.fit])
        arr = np.asarray(thetas)
        tail = 100.0 * (1.0 - confidence) / 2.0
        lo = np.percentile(arr, tail, axis=0)
        hi = np.percentile(arr, 100.0 - tail, axis=0)
        ci = {f: (float(lo[i]), float(hi[i]))
              for i, f in enumerate(objective.fit)}

    return CalibratedModel(
        params={f: fitted[f] for f in objective.fit},
        init={f: objective.params[f] for f in objective.fit},
        ci=ci, fit=objective.fit, loss=final_loss,
        history=tuple(history), n_units=obs.n, backend=be,
        source=source, zone=zone)


__all__ = ["FIT_PARAMS", "CalibratedModel", "CalibrationObjective",
           "Observations", "fit_calibration", "load_observations",
           "observations_from_units"]
