"""Fixed clock-time execution policies (paper §2).

Time bands (local time) and the six Figure-1 policies.  A policy maps each
band to a worker intensity plus a batch size; the controller additionally
maps intensity onto TPU-native knobs (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.core.schedule import Decision, SchedulingContext

PEAK = "peak"
LOAD_SENSITIVE = "load_sensitive"
SHOULDER = "shoulder"
NIGHT = "night"

BANDS = (PEAK, LOAD_SENSITIVE, SHOULDER, NIGHT)


@dataclasses.dataclass(frozen=True)
class TimeBands:
    """Hour-of-day -> band.  Defaults: peak 14-19, load-sensitive 11-14 &
    19-21, shoulder 7-11 & 21-24, night 0-7 (paper's office-day structure)."""
    peak: Tuple[Tuple[int, int], ...] = ((14, 19),)
    load_sensitive: Tuple[Tuple[int, int], ...] = ((11, 14), (19, 21))
    shoulder: Tuple[Tuple[int, int], ...] = ((7, 11), (21, 24))

    def band_at(self, hour_of_day: float) -> str:
        h = hour_of_day % 24.0
        for lo, hi in self.peak:
            if lo <= h < hi:
                return PEAK
        for lo, hi in self.load_sensitive:
            if lo <= h < hi:
                return LOAD_SENSITIVE
        for lo, hi in self.shoulder:
            if lo <= h < hi:
                return SHOULDER
        return NIGHT

    def hours_per_day(self) -> Dict[str, float]:
        out = {b: 0.0 for b in BANDS}
        for h in range(24):
            out[self.band_at(h)] += 1.0
        return out

    def edges(self) -> Tuple[float, ...]:
        """Sorted hours in [0, 24] where the band (and hence the background
        load) can change — the segmentation grid for band-level schedules."""
        hs = {0.0, 24.0}
        for ranges in (self.peak, self.load_sensitive, self.shoulder):
            for lo, hi in ranges:
                hs.add(float(lo) % 24.0)
                hs.add(24.0 if hi == 24 else float(hi) % 24.0)
        return tuple(sorted(hs))

    # background (interactive/office) load per band — the contention model
    # (calibrated jointly with MachineProfile; EXPERIMENTS.md §Paper-validation)
    def background(self, band: str) -> float:
        return {PEAK: 0.65, LOAD_SENSITIVE: 0.50, SHOULDER: 0.15, NIGHT: 0.02}[band]


@dataclasses.dataclass(frozen=True)
class Policy:
    """Worker intensity per band + batch size (+ priority flag, which on the
    workstation meant OS niceness; here it is an extra constant throttle)."""
    name: str
    intensity: Dict[str, float]
    batch_size: int = 50
    low_priority: bool = False

    def intensity_at(self, band: str) -> float:
        u = self.intensity[band]
        return u * 0.82 if self.low_priority else u

    # ---- Schedule protocol -------------------------------------------------
    def decide(self, ctx: SchedulingContext) -> Decision:
        return Decision(self.intensity_at(ctx.band), self.batch_size)

    def change_hours(self, bands: "TimeBands") -> Tuple[float, ...]:
        return bands.edges()


def _const(u: float) -> Dict[str, float]:
    return {b: u for b in BANDS}


def constant_schedule(u: float, batch_size: int = 50,
                      name: str = "") -> Policy:
    """A constant-intensity Schedule (sweep-engine building block)."""
    return Policy(name or f"const_{u:.2f}", _const(u), batch_size=batch_size)


# The six Figure-1 policies.  Baseline runs at a constant working intensity;
# peak-aware policies throttle sensitive bands and boost off-hours to recover
# throughput; batch policies change orchestration granularity only.
BASELINE = Policy("baseline", _const(0.85), batch_size=50)

PEAK_AWARE_BOOSTED = Policy(
    "peak_aware_boosted_offhours",
    {PEAK: 0.35, LOAD_SENSITIVE: 0.55, SHOULDER: 0.90, NIGHT: 0.95},
    batch_size=50)

PEAK_AWARE_AGGRESSIVE = Policy(
    "peak_aware_aggressive",
    {PEAK: 0.10, LOAD_SENSITIVE: 0.35, SHOULDER: 0.90, NIGHT: 1.00},
    batch_size=50)

LOW_PRIORITY_ONLY = Policy("low_priority_only", _const(0.85), batch_size=50,
                           low_priority=True)

SMALL_BATCHES = Policy("small_batches_25", _const(0.85), batch_size=25)

LARGE_BATCHES = Policy("large_batches_100", _const(0.85), batch_size=100)

POLICIES = {p.name: p for p in (
    BASELINE, PEAK_AWARE_BOOSTED, PEAK_AWARE_AGGRESSIVE, LOW_PRIORITY_ONLY,
    SMALL_BATCHES, LARGE_BATCHES)}


# ---------------------------------------------------------------------------
# Beyond-paper extension: carbon-intensity-driven scheduling (the paper's
# stated future work — "continuously updated regional carbon-intensity
# feeds").  Intensity follows the *grid carbon curve* hour by hour instead
# of fixed clock bands: CO2-optimal rather than energy-optimal.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HourlyPolicy(Policy):
    hourly_intensity: Tuple[float, ...] = ()      # len 24

    def intensity_at_hour(self, hour: float) -> float:
        u = self.hourly_intensity[math.floor(hour) % 24]
        return u * 0.82 if self.low_priority else u

    # ---- Schedule protocol -------------------------------------------------
    def decide(self, ctx: SchedulingContext) -> Decision:
        if not self.hourly_intensity:        # un-filled: fall back to bands
            return Decision(self.intensity_at(ctx.band), self.batch_size)
        return Decision(self.intensity_at_hour(ctx.hour_of_day),
                        self.batch_size)

    def change_hours(self, bands: TimeBands) -> Tuple[float, ...]:
        if not self.hourly_intensity:
            return bands.edges()
        return tuple(float(h) for h in range(25))


def hourly_schedule(name: str, intensities, batch_size: int = 50) -> HourlyPolicy:
    """A 24-slot hourly Schedule (sweep-engine building block)."""
    vals = tuple(float(v) for v in intensities)
    if len(vals) != 24:
        raise ValueError(f"hourly_schedule needs 24 intensities, got {len(vals)}")
    return HourlyPolicy(name, _const(0.85), batch_size, False, vals)


def _carbon_values(carbon):
    """Hourly carbon factors from a GridCarbonModel *or* any Signal."""
    from repro_torch.core.signal import sample_hourly
    return list(sample_hourly(carbon))


def make_carbon_aware_policy(carbon, u_low: float = 0.30, u_high: float = 1.0,
                             batch_size: int = 50) -> HourlyPolicy:
    """Map normalized grid carbon intensity -> worker intensity (inverse
    linear): full speed in the cleanest hours, u_low in the dirtiest.
    Pure-carbon following; see make_carbon_weighted_boosted for the variant
    that dominates (EXPERIMENTS.md bonus B4).  `carbon` may be a
    GridCarbonModel or any carbon Signal."""
    vals = _carbon_values(carbon)
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    inten = tuple(u_high - (v - lo) / rng * (u_high - u_low) for v in vals)
    return HourlyPolicy("carbon_aware_dynamic", _const(0.85), batch_size,
                        False, inten)


def make_carbon_weighted_boosted(carbon, bands: TimeBands = TimeBands(),
                                 swing: float = 0.30,
                                 batch_size: int = 50) -> HourlyPolicy:
    """Beyond-paper hybrid: the paper's boosted-off-hours band intensities,
    modulated ±swing/2 by the normalized hourly grid carbon intensity.
    Strictly dominates plain boosted on runtime, energy AND CO2e under a
    time-varying grid (tests/test_carina.py::test_carbon_weighted_dominates)."""
    vals = _carbon_values(carbon)
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    inten = []
    for h in range(24):
        u = PEAK_AWARE_BOOSTED.intensity[bands.band_at(h)]
        mod = (1.0 + swing / 2) - swing * (vals[h] - lo) / rng
        inten.append(min(1.0, max(0.1, u * mod)))
    return HourlyPolicy("carbon_weighted_boosted", _const(0.85), batch_size,
                        False, tuple(inten))
