"""Online serving: the `ServingSession` of the port, in live mode.

The reference's `ServingSession` (src/repro/core/serve.py) has two
modes.  The **live mode** is the adapter the decode-serving engine
(`repro_torch/serving/engine.py`) plugs into: `gate_open()` gates
admissions on the current grid carbon (with a queue-pressure override)
and `record_tick()` accounts one engine iteration's runtime, energy and
CO2, with the same clock, `StepCost` roofline and tracker accounting as
the reference.  The port has it in full.

The **windowed mode** (`submit` / `tick` / `drain`: request windows
scheduled and executed through the sweep engine) is not ported yet
(ROADMAP.md Queue 1, item `core/arrivals.py + core/serve.py`) and
raises `NotImplementedError`.  The constructor keeps the reference's
signature, so a session built for one package builds in the other.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.arrivals import DEFAULT_TIERS, QualityTier
from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.controller import SimClock
from repro_torch.core.energy import (ChipProfile, EnergyModel,
                                     MachineProfile, StepCost)
from repro_torch.core.policy import TimeBands
from repro_torch.core.signal import Signal, carbon_signal
from repro_torch.core.workload import OEMWorkload

#: Safety margin: a policy may book at most this fraction of a slot's
#: full-intensity capacity, leaving headroom for rate-model curvature.
DEFAULT_FILL_FRAC = 0.9


class ServingSession:
    """Carbon-aware serving as a session object; live mode only (see the
    module docstring).

        sess = ServingSession(tracker=RunTracker("serve"),
                              clock=SimClock(start_hour=10.0),
                              step_cost=StepCost(flops=..., hbm_bytes=...,
                                                 ici_bytes=0.0))
        engine = ServingEngine(model, params, session=sess)
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
                 cache_dir: Optional[str] = None):
        # the windowed mode's other arguments (machine, price, window,
        # tiers, policy, site, ...) are accepted and not used: that mode
        # raises below.  The workload template is built and checked as
        # the reference builds it.
        self.workload = workload or OEMWorkload(
            "serving", 0, rate_at_full=float(service_rate),
            batch_overhead_s=float(batch_overhead_s))
        if self.workload.rate_at_full <= 0.0:
            raise ValueError("the serving workload template needs a "
                             "positive rate_at_full (the service rate)")
        self.bands = bands or TimeBands()
        self.carbon_sig = carbon_signal(carbon if carbon is not None
                                        else GridCarbonModel())
        self.clock = clock or SimClock(start_hour=float(start_hour))
        self.energy = EnergyModel(chip=chip or ChipProfile())
        self.step_cost = step_cost
        self.tracker = tracker
        self.gate = gate
        self.max_queue = int(max_queue)
        self.live_units = 0
        self.live_energy_kwh = 0.0
        self.live_co2_kg = 0.0

    # ---- windowed mode (not ported) --------------------------------------
    def _windowed(self, *args, **kwargs):
        raise NotImplementedError(
            "ServingSession's windowed mode (submit/tick/drain/window/"
            "rollup) is not ported yet (ROADMAP.md Queue 1: core/arrivals.py "
            "+ core/serve.py); the live mode (gate_open/record_tick) is")

    submit = tick = drain = window = rollup = _windowed

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
