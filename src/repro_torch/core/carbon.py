"""Grid carbon model: local emission factor + optional 24h intensity curve.

The paper translates energy to CO2e with a single local grid factor
(Detroit-area DTE).  The factor is not stated numerically but both case
studies imply it:  21.8 kg / 48.67 kWh = 33.2 kg / 74.16 kWh = 0.448 kg/kWh.

CARINA's conclusions call for "time-varying regional carbon-intensity
feeds" as future work; we implement that extension behind the same API
(hourly curve, disabled by default so the paper-faithful path is the
default).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

# kg CO2e per kWh, implied by the paper's OEM case studies (DTE, Detroit)
DTE_FACTOR = 0.448


@dataclasses.dataclass(frozen=True)
class GridCarbonModel:
    factor_kg_per_kwh: float = DTE_FACTOR
    # optional hourly multiplier (len 24, mean ~1.0); None = flat (paper mode)
    hourly_curve: Optional[Sequence[float]] = None
    # provenance of the emission factor (grid zone + data source), stamped
    # into RunTracker logs so calibration runs are self-describing; None
    # keeps the paper-faithful anonymous-factor default
    zone: Optional[str] = None
    source: Optional[str] = None

    def factor_at(self, hour_of_day: float) -> float:
        if self.hourly_curve is None:
            return self.factor_kg_per_kwh
        h = math.floor(hour_of_day) % 24   # floor: int() truncates negatives
        return self.factor_kg_per_kwh * self.hourly_curve[h]

    def co2_kg(self, kwh: float, hour_of_day: Optional[float] = None) -> float:
        if hour_of_day is None or self.hourly_curve is None:
            return kwh * self.factor_kg_per_kwh
        return kwh * self.factor_at(hour_of_day)


# A representative Midwest diurnal carbon-intensity shape (gas peakers on the
# evening ramp; baseload overnight).  Used only when explicitly enabled.
MIDWEST_HOURLY = (
    0.92, 0.90, 0.89, 0.88, 0.88, 0.90, 0.95, 1.00,
    1.03, 1.04, 1.05, 1.06, 1.07, 1.08, 1.10, 1.12,
    1.14, 1.15, 1.13, 1.10, 1.05, 1.00, 0.96, 0.94,
)
