"""The one rate/power model every simulator and engine shares.

The physics of a CARINA campaign segment — contention-throttled effective
throughput, per-batch orchestration overhead, and the convex whole-machine
power draw — used to be copy-pasted three times (both sequential
simulators and the vectorized engine), which meant the model could
silently diverge.  This module is now the single definition:

  * effective throughput   R_eff = R * u * max(1 - gamma * b, 0.05)
  * batch wall time        t_batch = oh_s + batch / max(R_eff, eps)
  * work power             P_work = idle + dyn * max(u + b, 0)^alpha
  * overhead power         P_oh   = idle + dyn * max(f_oh * u + b, 0)^alpha
  * average power          P_avg  = w * P_work + (1 - w) * P_oh
                           with w = t_work / t_batch

Every entry point is polymorphic over the array namespace: pass Python
floats with the default ``xp=SCALAR`` and you get Python floats back
(bit-identical to the historical scalar code paths); pass NumPy arrays
with ``xp=numpy`` or torch tensors with ``xp=TORCH`` and the same
expressions broadcast.  Callers:

  * ``core/simulator.py``     (both sequential simulators; scalars)
  * ``core/engine.py``        (periodic vectorized engine; torch)
  * ``core/engine_torch.py``  (trace-grid scan engine; NumPy lowering)
  * ``kernels/scan_chunk.py``, ``kernels/coupled_chunk.py`` (the plain
    PyTorch versions of the chunk kernels; torch)
  * ``core/energy.py``        (``MachineProfile.power`` delegates here)
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any

import torch

# Effective throughput never drops below 5% of nominal (a fully contended
# machine still makes progress) and divisions are guarded by a tiny floor.
CONTENTION_FLOOR = 0.05
RATE_EPS = 1e-9

# Scalar namespace: Python-float arithmetic, bit-identical to the
# historical `max(...)`-based scalar code in the sequential simulators.
SCALAR = SimpleNamespace(maximum=lambda a, b: a if a > b else b,
                         minimum=lambda a, b: a if a < b else b)


def _torch_extremum(pair, clamp, scalar):
    """Elementwise max/min over any mix of tensors and Python numbers:
    `torch.maximum`/`torch.minimum` take tensors only, so a Python bound
    goes through `clamp_min`/`clamp_max` (exact, NaN-propagating, and the
    tensor keeps its dtype — as NumPy keeps it for a weak scalar)."""
    def op(a, b):
        if isinstance(a, torch.Tensor):
            return pair(a, b) if isinstance(b, torch.Tensor) else clamp(a, b)
        if isinstance(b, torch.Tensor):
            return clamp(b, a)
        return scalar(a, b)
    return op


# Torch namespace: the same expressions on tensors of any device/dtype.
TORCH = SimpleNamespace(
    maximum=_torch_extremum(torch.maximum, torch.clamp_min, SCALAR.maximum),
    minimum=_torch_extremum(torch.minimum, torch.clamp_max, SCALAR.minimum))

# A site-throttled campaign's worker intensity never drops below 5% of
# its demand (the curtailment sheds worker load, not the whole machine;
# same floor philosophy as CONTENTION_FLOOR).
SITE_THROTTLE_FLOOR = 0.05

# Fixed-point steps of the curtailment solve per slot.  The sheddable-
# power update below converges geometrically (site draw within ~0.1% of
# a reachable cap in 3-4 steps); a fixed count keeps the chunk kernels'
# slot loop fixed and every consumer bit-consistent.
SITE_THROTTLE_ITERS = 4


def power_w(load: Any, idle_w: Any, dyn_w: Any, alpha: Any,
            xp=SCALAR) -> Any:
    """Whole-machine power at combined load: idle + dyn * max(load, 0)^alpha.

    This is THE convex-power expression; nothing else in the repo spells
    it out (``MachineProfile.power`` and both power terms in ``rates``
    all come through here).
    """
    return idle_w + dyn_w * xp.maximum(load, 0.0) ** alpha


@dataclasses.dataclass(frozen=True)
class Rates:
    """Per-unit-time view of one (intensity, batch, background) operating
    point.  Fields are floats or arrays, matching the inputs."""
    r_eff: Any          # effective scenarios/s while working
    batch_time_s: Any   # wall seconds per batch (work + orchestration)
    scen_per_s: Any     # scenarios per wall second
    work_frac: Any      # fraction of wall time spent working
    p_work_w: Any       # power while working
    p_oh_w: Any         # power during orchestration overhead
    p_avg_w: Any        # time-averaged power over the batch cycle
    kwh_per_s: Any      # p_avg_w expressed as kWh per wall second


def rates(u: Any, batch_size: Any, background: Any, *,
          rate_at_full: Any, batch_overhead_s: Any,
          idle_w: Any, dyn_w: Any, alpha: Any, gamma: Any,
          overhead_w_frac: Any, xp=SCALAR) -> Rates:
    """The shared rate model at one operating point (scalar or batched)."""
    mx = xp.maximum
    r_eff = rate_at_full * u * mx(1.0 - gamma * background, CONTENTION_FLOOR)
    work_t = batch_size / mx(r_eff, RATE_EPS)
    batch_time = batch_overhead_s + work_t
    scen_per_s = batch_size / batch_time
    work_frac = work_t / batch_time
    p_work = power_w(u + background, idle_w, dyn_w, alpha, xp=xp)
    p_oh = power_w(overhead_w_frac * u + background, idle_w, dyn_w, alpha,
                   xp=xp)
    p_avg = work_frac * p_work + (1.0 - work_frac) * p_oh
    return Rates(r_eff=r_eff, batch_time_s=batch_time, scen_per_s=scen_per_s,
                 work_frac=work_frac, p_work_w=p_work, p_oh_w=p_oh,
                 p_avg_w=p_avg, kwh_per_s=p_avg / 3.6e6)


def campaign_rates(u: Any, batch_size: Any, background: Any,
                   workload, machine, xp=SCALAR) -> Rates:
    """``rates`` with the parameters unpacked from an ``OEMWorkload``-like
    and a ``MachineProfile``-like object (duck-typed; no imports)."""
    return rates(u, batch_size, background,
                 rate_at_full=workload.rate_at_full,
                 batch_overhead_s=workload.batch_overhead_s,
                 idle_w=machine.idle_w, dyn_w=machine.dyn_w,
                 alpha=machine.alpha, gamma=machine.gamma,
                 overhead_w_frac=machine.overhead_w_frac, xp=xp)


def site_throttle(fleet_kw: Any, base_kw: Any, headroom_kw: Any,
                  f: Any = 1.0, xp=SCALAR) -> Any:
    """THE definition of site-coupled contention between concurrent
    campaigns sharing one power envelope: one damped fixed-point step of
    the shared curtailment factor.

    When the summed draw of a fleet's *active* campaigns (`fleet_kw`,
    evaluated at the current factor `f`) exceeds the site headroom
    (site cap minus office draw), every campaign's worker intensity is
    curtailed by the same factor.  Because most of a machine's draw is
    not sheddable (idle power plus the background-induced term,
    `base_kw` = Σ power_w(background) over active campaigns), the update
    iterates on the *sheddable* component:

        f' = clip(f * (headroom - base) / (fleet_kw - base),
                  SITE_THROTTLE_FLOOR, 1.0)

    Consumers apply exactly `SITE_THROTTLE_ITERS` steps per slot,
    re-evaluating the fleet draw at each step's factor — the sequential
    fleet oracle (core/fleet.py) and the coupled chunk kernel
    (kernels/coupled_chunk.py and its CUDA source) run this same loop.
    A reachable cap is met to ~0.1 %; an unreachable one (headroom below the non-sheddable draw) pins the
    floor, so campaigns trickle instead of deadlocking and the reported
    site peak honestly exceeds the cap.  Each campaign's effective
    throughput R_eff then scales with the final factor — the
    per-campaign r_eff depends on the *summed* fleet power vs the cap.
    Polymorphic over the array namespace like the rest of the model.
    """
    shed_target = xp.maximum(headroom_kw - base_kw, 0.0)
    shed = xp.maximum(fleet_kw - base_kw, RATE_EPS)
    return xp.maximum(xp.minimum(f * shed_target / shed, 1.0),
                      SITE_THROTTLE_FLOOR)


__all__ = ["CONTENTION_FLOOR", "RATE_EPS", "SCALAR", "TORCH",
           "SITE_THROTTLE_FLOOR",
           "SITE_THROTTLE_ITERS", "Rates", "power_w", "rates",
           "campaign_rates", "site_throttle"]
