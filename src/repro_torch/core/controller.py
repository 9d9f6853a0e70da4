"""CarinaController: execution-time control for the TPU training loop
(Algorithm 1, lines 6-8, with the knob mapping of DESIGN.md §2).

Per tracked unit (a training round of N steps) the controller:
  1. determines the local time phase (band) — simulated or wall clock;
  2. asks the Schedule for a decision (worker intensity) given the full
     SchedulingContext (band, background load, carbon intensity);
  3. maps intensity -> TPU knobs:
       * active dp replicas: floor(u * max_replicas), plus one extra
         duty-cycled replica whenever there is a fractional remainder
         (elastic width; a change triggers checkpoint + re-mesh in the
         training loop),
       * duty cycle: u / (replicas / max_replicas) — the fractional
         remainder of the last replica is realized as sleep between steps
         (priority-reduction analogue), so replicas * duty == u exactly;
  4. after execution records runtime / energy estimate / carbon into the
     RunTracker (roofline-mode energy when a compiled StepCost is known).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.energy import ChipProfile, EnergyModel, StepCost
from repro_torch.core.policy import BASELINE, TimeBands
from repro_torch.core.schedule import SchedulingContext, as_schedule
from repro_torch.core.tracker import RunTracker


@dataclasses.dataclass
class IntensityDecision:
    band: str
    intensity: float
    replicas: int            # active dp replicas
    duty: float              # in [0,1]: fraction of time stepping (sleep rest)


class SimClock:
    """Simulated campaign clock: hours advance as the loop reports runtime.
    Lets CPU-scale tests traverse day/night bands in seconds."""

    def __init__(self, start_hour: float = 9.0, speedup: float = 1.0):
        self.hours = start_hour
        self.speedup = speedup

    def advance_s(self, seconds: float):
        self.hours += self.speedup * seconds / 3600.0

    def hour_of_day(self) -> float:
        return self.hours % 24.0


class CarinaController:
    def __init__(self, policy=BASELINE, bands: TimeBands = TimeBands(),
                 tracker: Optional[RunTracker] = None,
                 max_replicas: int = 1, min_replicas: int = 1,
                 clock: Optional[SimClock] = None,
                 chip: ChipProfile = ChipProfile(),
                 step_cost: Optional[StepCost] = None,
                 carbon: Optional[GridCarbonModel] = None,
                 price=None):
        self.policy = policy                      # kept for introspection
        self.schedule = as_schedule(policy)
        self.bands = bands
        self.tracker = tracker
        self.max_replicas = max_replicas
        self.min_replicas = min_replicas
        self.clock = clock or SimClock()
        self.energy = EnergyModel(chip=chip)
        self.step_cost = step_cost
        self.carbon = carbon or (tracker.carbon if tracker is not None
                                 else GridCarbonModel())
        self.price = price                        # optional price Signal
        self.decisions = []

    # ---- Algorithm 1 lines 6-8 -------------------------------------------
    def decide(self) -> IntensityDecision:
        hour = self.clock.hour_of_day()
        band = self.bands.band_at(hour)
        ctx = SchedulingContext(
            hour_of_day=hour, band=band,
            background=self.bands.background(band),
            carbon_factor=self.carbon.factor_at(hour),
            price_usd_per_kwh=(self.price.at(hour)
                               if self.price is not None else 0.0))
        u = float(self.schedule.decide(ctx).intensity)
        # floor(u * max) full replicas; a fractional remainder adds one more
        # replica whose surplus capacity the duty cycle sleeps away, so
        # realized * duty == u (no part of u is silently dropped, which is
        # what round() did when it rounded down).
        want = u * self.max_replicas
        replicas = math.floor(want + 1e-9)
        if want - replicas > 1e-9:
            replicas += 1
        replicas = max(self.min_replicas, min(self.max_replicas, replicas))
        replicas = max(replicas, 1)
        realized = replicas / self.max_replicas
        duty = min(1.0, u / realized) if realized > 0 else 1.0
        d = IntensityDecision(band, u, replicas, duty)
        self.decisions.append(d)
        return d

    # ---- Algorithm 1 lines 10-11 -------------------------------------------
    def record_unit(self, decision: IntensityDecision, *, steps: int,
                    runtime_s: float, meta: Optional[dict] = None):
        self.clock.advance_s(runtime_s)
        if self.step_cost is not None:
            joules = steps * self.energy.step_energy_j(
                dataclasses.replace(self.step_cost,
                                    chips=self.step_cost.chips), decision.duty)
            # scale chips by active replica fraction
            joules *= decision.replicas / self.max_replicas
            kwh = joules / 3.6e6
        else:
            # runtime-mode fallback: machine profile at this intensity
            kwh = self.energy.runtime_energy_kwh(runtime_s, decision.intensity)
        if self.tracker is not None:
            self.tracker.record_unit(
                phase=decision.band, intensity=decision.intensity,
                runtime_s=runtime_s, energy_kwh=kwh,
                sim_time_h=self.clock.hours,
                meta=dict(meta or {}, steps=steps, replicas=decision.replicas,
                          duty=decision.duty))
        return kwh
