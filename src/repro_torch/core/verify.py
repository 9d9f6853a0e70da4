"""Verification logic for tracked-unit logs (paper §2: the OEM workloads
use "resume, merge, and verification logic" — this is the verification
side: a JSONL unit log can be re-aggregated and checked for internal
consistency after crashes/restarts/merges).  Plain host Python, carried
over unchanged from the reference (`src/repro/core/verify.py`) against
the port's `GridCarbonModel`.

Checks:
  1. schema: every record has the UnitRecord fields with sane types;
  2. monotonic unit indices (per producer) and non-negative quantities;
  3. carbon consistency: co2 == factor(hour) * energy within tolerance;
  4. summary consistency: an embedded summary line (if present) matches the
     re-aggregation of the unit records preceding it.

Returns a VerifyReport; `ok` is False with per-check messages otherwise.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from repro_torch.core.carbon import GridCarbonModel


@dataclasses.dataclass
class VerifyReport:
    ok: bool
    n_units: int
    energy_kwh: float
    co2_kg: float
    errors: List[str]


REQUIRED = ("index", "phase", "intensity", "runtime_s", "energy_kwh",
            "co2_kg", "sim_time_h")


def verify_unit_log(path: str, carbon: Optional[GridCarbonModel] = None,
                    rtol: float = 1e-6) -> VerifyReport:
    carbon = carbon or GridCarbonModel()
    errors: List[str] = []
    units = []
    summary = None
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {ln}: bad json ({e})")
                continue
            if "summary" in rec:
                summary = rec["summary"]
                continue
            missing = [k for k in REQUIRED if k not in rec]
            if missing:
                errors.append(f"line {ln}: missing fields {missing}")
                continue
            if rec["runtime_s"] < 0 or rec["energy_kwh"] < 0:
                errors.append(f"line {ln}: negative quantities")
            want_co2 = carbon.co2_kg(rec["energy_kwh"],
                                     hour_of_day=rec["sim_time_h"] % 24.0)
            if abs(rec["co2_kg"] - want_co2) > rtol + rtol * abs(want_co2):
                errors.append(
                    f"line {ln}: carbon mismatch {rec['co2_kg']} vs {want_co2}")
            units.append(rec)

    for prev, cur in zip(units, units[1:]):
        if cur["index"] < prev["index"]:
            errors.append(f"unit {cur['index']}: non-monotonic index")

    e_tot = sum(u["energy_kwh"] for u in units)
    c_tot = sum(u["co2_kg"] for u in units)
    if summary is not None:
        if abs(summary.get("energy_kwh", 0.0) - e_tot) > 1e-6 + 1e-6 * e_tot:
            errors.append("summary energy does not match re-aggregation")
        if summary.get("units") != len(units):
            errors.append(f"summary units {summary.get('units')} != {len(units)}")
    return VerifyReport(not errors, len(units), e_tot, c_tot, errors)
