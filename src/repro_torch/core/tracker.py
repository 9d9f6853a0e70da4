"""Run-level and step-level instrumentation (paper Algorithm 1).

For each tracked unit CARINA records runtime, selected worker intensity,
estimated energy load, translated carbon burden, and execution metadata;
units aggregate into a run summary.  Records stream to JSONL so a crash
loses at most the open unit (resume/merge logic re-aggregates).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.core.carbon import GridCarbonModel

# Version stamped into every JSONL record so logs are self-describing:
# readers can evolve the schema without guessing what an old log meant.
# v1 = the original field set + the carbon provenance meta keys.
SCHEMA_VERSION = 1


@dataclasses.dataclass
class UnitRecord:
    index: int
    phase: str                    # time band at execution
    intensity: float
    runtime_s: float
    energy_kwh: float
    co2_kg: float
    sim_time_h: float             # absolute simulated clock (hour-of-day = % 24)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


@dataclasses.dataclass
class RunSummary:
    name: str
    units: int
    runtime_h: float
    energy_kwh: float
    co2_kg: float
    by_phase: Dict[str, Dict[str, float]]
    meta: Dict[str, Any]


class RunTracker:
    """granularity: "run" collapses everything into one unit at close();
    "step" records each tracked unit (paper: whole-run or step-level)."""

    def __init__(self, name: str, carbon: Optional[GridCarbonModel] = None,
                 granularity: str = "step", log_path: Optional[str] = None,
                 meta: Optional[dict] = None):
        assert granularity in ("run", "step")
        self.name = name
        self.carbon = carbon or GridCarbonModel()
        self.granularity = granularity
        self.records: List[UnitRecord] = []
        self.meta = dict(meta or {})
        # emission-factor provenance: calibration replays a log long
        # after the session that wrote it, so the log itself must say
        # which grid factor translated kWh to kg
        self.meta.setdefault("carbon_factor_kg_per_kwh",
                             self.carbon.factor_kg_per_kwh)
        if self.carbon.zone:
            self.meta.setdefault("carbon_zone", self.carbon.zone)
        if self.carbon.source:
            self.meta.setdefault("carbon_source", self.carbon.source)
        self._log_path = log_path
        self._log_file = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            # a crashed predecessor may have left a torn (newline-less)
            # final line; isolate it so resumed records stay parseable
            if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
                with open(log_path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    torn = f.read(1) != b"\n"
            else:
                torn = False
            self._log_file = open(log_path, "a", buffering=1)
            if torn:
                self._log_file.write("\n")
        self._open_accum = {"runtime_s": 0.0, "energy_kwh": 0.0, "co2_kg": 0.0}

    # ------------------------------------------------------------------
    def record_unit(self, *, phase: str, intensity: float, runtime_s: float,
                    energy_kwh: float, sim_time_h: float,
                    meta: Optional[dict] = None) -> UnitRecord:
        co2 = self.carbon.co2_kg(energy_kwh, hour_of_day=sim_time_h % 24.0)
        if self.carbon.zone or self.carbon.source:
            meta = dict(meta or {})
            if self.carbon.zone:
                meta.setdefault("zone", self.carbon.zone)
            if self.carbon.source:
                meta.setdefault("source", self.carbon.source)
        if self.granularity == "run":
            # accumulate the hour-aware CO2 too, so run-mode totals respect
            # an hourly_curve instead of re-deriving at the flat factor
            self._open_accum["runtime_s"] += runtime_s
            self._open_accum["energy_kwh"] += energy_kwh
            self._open_accum["co2_kg"] += co2
            rec = UnitRecord(len(self.records), phase, intensity, runtime_s,
                             energy_kwh, co2, sim_time_h, meta or {})
            return rec  # not appended; aggregated at close
        rec = UnitRecord(len(self.records), phase, intensity, runtime_s,
                         energy_kwh, co2, sim_time_h, meta or {})
        self.records.append(rec)
        if self._log_file:
            self._log_file.write(rec.to_json() + "\n")
        return rec

    # ------------------------------------------------------------------
    def summary(self) -> RunSummary:
        if self.granularity == "run" and not self.records:
            e = self._open_accum["energy_kwh"]
            self.records.append(UnitRecord(
                0, "run", 1.0, self._open_accum["runtime_s"], e,
                self._open_accum["co2_kg"], 0.0, {}))
        by_phase: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            d = by_phase.setdefault(r.phase, {"runtime_s": 0.0, "energy_kwh": 0.0,
                                              "co2_kg": 0.0, "units": 0.0})
            d["runtime_s"] += r.runtime_s
            d["energy_kwh"] += r.energy_kwh
            d["co2_kg"] += r.co2_kg
            d["units"] += 1
        return RunSummary(
            name=self.name,
            units=len(self.records),
            runtime_h=sum(r.runtime_s for r in self.records) / 3600.0,
            energy_kwh=sum(r.energy_kwh for r in self.records),
            co2_kg=sum(r.co2_kg for r in self.records),
            by_phase=by_phase,
            meta=self.meta,
        )

    def close(self) -> RunSummary:
        s = self.summary()
        if self._log_file:
            self._log_file.write(json.dumps(
                {"summary": dataclasses.asdict(s)}, sort_keys=True) + "\n")
            self._log_file.close()
            self._log_file = None
        return s


def load_units(path: str) -> List[UnitRecord]:
    """Recover the tracked units from a JSONL log (crash/resume path).

    Malformed lines (a unit torn mid-write by a crash) are skipped, not
    fatal — a resumed tracker appends to the same log, so valid records can
    follow a torn one.  A crash loses at most the unit that was mid-write.
    Summary lines from clean close() calls are skipped too.  Unknown keys
    (a record written by a *newer* schema) are dropped rather than fatal,
    and records missing the v1 fields are treated like torn lines — the
    `schema` field says what the writer meant, so readers degrade
    gracefully in both directions.
    """
    known = {f.name for f in dataclasses.fields(UnitRecord)}
    required = known - {"meta", "schema"}
    units: List[UnitRecord] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue                   # torn mid-write: skip that unit
            if not isinstance(d, dict) or "summary" in d:
                continue
            if not required <= set(d):
                continue                   # truncated / foreign record
            units.append(UnitRecord(**{k: v for k, v in d.items()
                                       if k in known}))
    return units


def summary_from_units(units: List[UnitRecord], name: str = "resumed",
                       meta: Optional[dict] = None) -> RunSummary:
    """Re-aggregate recovered units into a RunSummary (same roll-up as
    RunTracker.summary, without needing a live tracker)."""
    t = RunTracker(name, meta=meta)
    t.records = list(units)
    return t.summary()


def merge_summaries(summaries: List[RunSummary], name: str = "merged") -> RunSummary:
    """Resume/merge logic: combine partial runs (paper §2)."""
    by_phase: Dict[str, Dict[str, float]] = {}
    for s in summaries:
        for ph, d in s.by_phase.items():
            t = by_phase.setdefault(ph, {"runtime_s": 0.0, "energy_kwh": 0.0,
                                         "co2_kg": 0.0, "units": 0.0})
            for k in t:
                t[k] += d[k]
    return RunSummary(
        name=name,
        units=sum(s.units for s in summaries),
        runtime_h=sum(s.runtime_h for s in summaries),
        energy_kwh=sum(s.energy_kwh for s in summaries),
        co2_kg=sum(s.co2_kg for s in summaries),
        by_phase=by_phase,
        meta={"merged_from": [s.name for s in summaries]},
    )
