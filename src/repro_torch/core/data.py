"""Real carbon-intensity archives -> CARINA signals (ingestion layer).

ElectricityMaps/WattTime-style CSV/JSON archives are parsed, pushed
through a strict validation/quality pass, and lowered onto the existing
signal machinery: one hourly `TraceSignal` per zone (`ZoneSeries
.to_trace`), or a sliding-window `SignalEnsemble` per zone
(`ZoneSeries.to_ensemble`, via `trace_windows`).  Parsing and validation
are deliberately separate stages:

  * **parse** (`_parse_csv` / `_parse_json`) only maps the file onto raw
    `(timestamp, value, unit)` samples per zone — flexible about column
    names and record forms, strict about malformed values.
  * **validate/repair** (`_regularize`) owns every temporal/unit
    judgement call: sorting non-monotone rows, normalizing
    gCO2/kWh / kgCO2/kWh / lbs/MWh onto kg CO2e per kWh, collapsing
    duplicate hours (DST fall-back folds), filling gaps per an explicit
    `gap_policy` ("interpolate" | "hold" | "raise"; spring-forward
    skips show up as 1-hour gaps), and downsampling sub-hourly archives
    onto the hourly slot grid by in-hour means.  Every repair is counted
    in a per-zone `QualityReport` so nothing is silently invented.

Units: rows may carry a `unit` column; otherwise `unit=` applies to the
whole file, and failing that the unit is inferred per zone from the
value magnitude (median >= 10 reads as gCO2/kWh).  A multi-zone file
whose zones *infer* different units is rejected — that is the classic
g-vs-kg mixed-archive bug, and guessing would corrupt one zone by 1000x.

A seeded `write_synthetic_archive` generates realistic offline fixtures;
2-3 small bundled archives live under `src/repro_torch/data/samples/` (see
`sample_archive_path` / `load_sample_archive`) so tests and examples
never need network access.
"""
from __future__ import annotations

import csv
import dataclasses
import datetime as _dt
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.carbon import MIDWEST_HOURLY, GridCarbonModel
from repro_torch.core.signal import SignalEnsemble, TraceSignal, trace_windows

GAP_POLICIES = ("interpolate", "hold", "raise")

# Accepted spellings, in match priority order (case-insensitive).
_TS_COLS = ("datetime", "timestamp", "point_time", "utc_datetime",
            "datetime_utc", "date", "time")
_ZONE_COLS = ("zone", "zone_name", "zone_id", "ba", "region")
_VALUE_COLS = ("carbon_intensity_avg", "carbon_intensity",
               "carbonintensity", "co2_intensity", "moer", "intensity",
               "value")
_UNIT_COLS = ("unit", "units", "carbon_intensity_unit")

# kg CO2e per kWh per 1.0 of the source unit.  "lb" is the WattTime MOER
# convention, lbs CO2 per *MWh*: 0.453592 kg/lb / 1000 kWh/MWh.
_UNIT_SCALE = {"kg": 1.0, "g": 1e-3, "lb": 0.453592e-3}
_UNIT_LABEL = {"kg": "kgCO2/kWh", "g": "gCO2/kWh", "lb": "lbs/MWh"}


def _unit_key(text) -> Optional[str]:
    """Normalize a unit spelling to 'kg' | 'g' | 'lb' (None for blank)."""
    t = str(text).strip().lower().replace(" ", "")
    if not t:
        return None
    if t.startswith("kg") or "kgco2" in t:
        return "kg"
    if t.startswith("lb"):
        return "lb"
    if t.startswith("g"):
        return "g"
    raise ValueError(
        f"unrecognized carbon-intensity unit {text!r}; expected a "
        "gCO2/kWh, kgCO2/kWh, or lbs/MWh spelling")


def _parse_when(value) -> _dt.datetime:
    """One timestamp -> naive UTC datetime (ISO 8601 or unix seconds)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return _dt.datetime.fromtimestamp(
            float(value), _dt.timezone.utc).replace(tzinfo=None)
    s = str(value).strip()
    try:
        return _dt.datetime.fromtimestamp(
            float(s), _dt.timezone.utc).replace(tzinfo=None)
    except ValueError:
        pass
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        d = _dt.datetime.fromisoformat(s)
    except ValueError:
        raise ValueError(f"cannot parse timestamp {value!r} (ISO 8601 "
                         "or unix seconds)") from None
    if d.tzinfo is not None:
        d = d.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return d


# One raw sample: (timestamp, value in source units, unit key or None).
_Raw = Tuple[_dt.datetime, float, Optional[str]]


def _pick(cols: Dict[str, str], names) -> Optional[str]:
    for n in names:
        if n in cols:
            return cols[n]
    return None


def _parse_csv(path: str, default_zone: str) -> Dict[str, List[_Raw]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if not reader.fieldnames:
            raise ValueError(f"{path}: empty CSV (no header row)")
        cols = {c.strip().lower(): c for c in reader.fieldnames}
        ts_col = _pick(cols, _TS_COLS)
        val_col = _pick(cols, _VALUE_COLS)
        if ts_col is None or val_col is None:
            raise ValueError(
                f"{path}: need a timestamp column (one of {_TS_COLS}) "
                f"and an intensity column (one of {_VALUE_COLS}); got "
                f"{tuple(cols)}")
        zone_col = _pick(cols, _ZONE_COLS)
        unit_col = _pick(cols, _UNIT_COLS)
        out: Dict[str, List[_Raw]] = {}
        for i, row in enumerate(reader):
            raw_val = (row.get(val_col) or "").strip()
            if not raw_val and not (row.get(ts_col) or "").strip():
                continue                          # blank line
            try:
                val = float(raw_val)
            except ValueError:
                raise ValueError(
                    f"{path} row {i + 2}: bad intensity value "
                    f"{raw_val!r}") from None
            when = _parse_when(row[ts_col])
            unit = _unit_key(row[unit_col]) if unit_col else None
            zone = ((row.get(zone_col) or "").strip() or default_zone
                    if zone_col else default_zone)
            out.setdefault(zone, []).append((when, val, unit))
    return out


def _record_fields(rec: dict) -> Tuple[_dt.datetime, float, Optional[str],
                                       Optional[str]]:
    low = {str(k).strip().lower(): v for k, v in rec.items()}
    ts = _pick({k: k for k in low}, _TS_COLS)
    val = _pick({k: k for k in low}, _VALUE_COLS)
    if ts is None or val is None:
        raise ValueError(f"JSON record {rec!r} has no recognizable "
                         "timestamp/intensity keys")
    zone = _pick({k: k for k in low}, _ZONE_COLS)
    unit = _pick({k: k for k in low}, _UNIT_COLS)
    return (_parse_when(low[ts]), float(low[val]),
            _unit_key(low[unit]) if unit and low[unit] is not None else None,
            str(low[zone]) if zone else None)


def _parse_json(path: str, default_zone: str) -> Dict[str, List[_Raw]]:
    with open(path) as f:
        obj = json.load(f)
    out: Dict[str, List[_Raw]] = {}

    def add(records, zone_hint):
        for rec in records:
            when, val, unit, zone = _record_fields(rec)
            out.setdefault(zone or zone_hint or default_zone,
                           []).append((when, val, unit))

    if isinstance(obj, dict) and isinstance(obj.get("zones"), dict):
        for z, records in obj["zones"].items():
            add(records, str(z))
    elif isinstance(obj, dict):
        records = obj.get("data", obj.get("history"))
        if not isinstance(records, list):
            raise ValueError(
                f"{path}: JSON archives are a record list, a "
                "{'zone':..., 'data'|'history': [...]} object, or a "
                "{'zones': {name: [...]}} object")
        add(records, str(obj["zone"]) if obj.get("zone") else None)
    elif isinstance(obj, list):
        add(obj, None)
    else:
        raise ValueError(f"{path}: cannot interpret "
                         f"{type(obj).__name__} as a carbon archive")
    return out


# ----------------------------------------------------------------------
# Validation / quality pass
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QualityReport:
    """What the validation pass repaired for one zone (nothing silent)."""
    zone: str
    unit: str                    # source unit key: "kg" | "g" | "lb"
    rows: int                    # raw samples parsed
    hours: int                   # hours in the regularized series
    out_of_order: int            # samples re-sorted into place
    duplicates_collapsed: int    # extra same-hour samples averaged away
    dst_folds: int               # hours seen exactly twice (fall-back)
    gaps_filled: int             # missing hours synthesized per policy
    gap_runs: Tuple[int, ...]    # length of each repaired gap run
    longest_gap_h: int
    dst_skips: int               # 1-hour gaps (spring-forward signature)
    subhourly_minutes: Optional[int]   # source cadence when < 60 min
    gap_policy: str

    @property
    def clean(self) -> bool:
        return not (self.out_of_order or self.duplicates_collapsed
                    or self.gaps_filled)


@dataclasses.dataclass(frozen=True)
class ZoneSeries:
    """One zone's regularized hourly series (kg CO2e/kWh) + its report."""
    zone: str
    values: Tuple[float, ...]
    start: str                   # ISO timestamp of values[0]'s hour
    quality: QualityReport

    @property
    def hours(self) -> int:
        return len(self.values)

    @property
    def mean_kg_per_kwh(self) -> float:
        return float(np.mean(self.values))

    def to_trace(self, start_hour: float = 0.0, name: Optional[str] = None,
                 pad: str = "hold") -> TraceSignal:
        """This zone as a campaign-anchored hourly `TraceSignal`.

        `start_hour` re-anchors the archive onto the campaign clock
        (hour 0 = midnight of campaign day 0) — archives carry absolute
        timestamps, campaigns count hours from their own day 0.
        """
        return TraceSignal(self.values, start_hour=start_hour,
                           name=name or f"carbon:{self.zone}", pad=pad)

    def to_ensemble(self, window_h: int, stride_h: Optional[int] = None,
                    *, start_hour: float = 0.0,
                    name: Optional[str] = None,
                    pad: str = "hold") -> SignalEnsemble:
        """Sliding `window_h`-hour windows as a scenario ensemble.

        Refuses a series whose longest repaired gap exceeds `window_h`:
        such an ensemble would contain members made entirely of
        interpolated/held fiction.  Re-load with a shorter horizon or a
        better archive instead.
        """
        gap = self.quality.longest_gap_h
        if gap > int(window_h):
            raise ValueError(
                f"zone {self.zone!r}: archive has a {gap}-hour repaired "
                f"gap (> window_h={int(window_h)}); an ensemble window "
                "falling inside it would be pure "
                f"{self.quality.gap_policy!r} fiction — use a longer "
                "window, a cleaner archive, or slice around the gap")
        return trace_windows(self.values, window_h, stride_h,
                             start_hour=start_hour,
                             name=name or f"carbon:{self.zone}", pad=pad)

    def to_carbon_model(self, source: Optional[str] = None) -> GridCarbonModel:
        """Flat-factor summary model (mean intensity), zone-stamped."""
        return GridCarbonModel(factor_kg_per_kwh=self.mean_kg_per_kwh,
                               zone=self.zone, source=source)


def _regularize(zone: str, samples: List[_Raw], scale_by_row: np.ndarray,
                unit: str, gap_policy: str) -> ZoneSeries:
    """The quality pass: raw samples -> strict hourly kg/kWh series."""
    whens = [s[0] for s in samples]
    vals = np.asarray([s[1] for s in samples], dtype=float) * scale_by_row
    if not np.all(np.isfinite(vals)):
        bad = int(np.sum(~np.isfinite(vals)))
        raise ValueError(f"zone {zone!r}: {bad} non-finite intensity "
                         "value(s); archives must be numeric")
    base = min(whens).replace(minute=0, second=0, microsecond=0)
    t = np.asarray([(w - base).total_seconds() / 3600.0 for w in whens])
    out_of_order = int(np.sum(np.diff(t) < -1e-9))
    order = np.argsort(t, kind="stable")
    t, vals = t[order], vals[order]

    dt_pos = np.diff(t)
    dt_pos = dt_pos[dt_pos > 1e-9]
    step_h = float(np.median(dt_pos)) if dt_pos.size else 1.0
    subhourly = step_h < 0.999
    subhourly_minutes = int(round(step_h * 60.0)) if subhourly else None

    hour = np.floor(t + 1e-9).astype(int)
    uniq, inv, counts = np.unique(hour, return_inverse=True,
                                  return_counts=True)
    hourly = np.bincount(inv, weights=vals) / counts
    if subhourly:
        # multiple in-hour samples are the cadence, not duplication
        duplicates = dst_folds = 0
    else:
        duplicates = int(np.sum(counts - 1))
        dst_folds = int(np.sum(counts == 2))

    full = np.arange(uniq[0], uniq[-1] + 1)
    present = np.zeros(len(full), dtype=bool)
    present[uniq - uniq[0]] = True
    gap_runs: List[int] = []
    run = 0
    for p in present:
        if p:
            if run:
                gap_runs.append(run)
            run = 0
        else:
            run += 1
    gaps_filled = int(sum(gap_runs))
    if gaps_filled and gap_policy == "raise":
        raise ValueError(
            f"zone {zone!r}: {gaps_filled} missing hour(s) across "
            f"{len(gap_runs)} gap(s) (longest {max(gap_runs)} h) and "
            "gap_policy='raise'; re-load with gap_policy='interpolate' "
            "or 'hold' to repair explicitly")
    values = np.empty(len(full), dtype=float)
    values[present] = hourly
    if gaps_filled:
        if gap_policy == "interpolate":
            values[~present] = np.interp(full[~present], uniq, hourly)
        else:                                     # "hold"
            idx = np.arange(len(full))
            last = np.maximum.accumulate(np.where(present, idx, 0))
            values = values[last]
    start = (base + _dt.timedelta(hours=int(uniq[0]))).isoformat()
    report = QualityReport(
        zone=zone, unit=unit, rows=len(samples), hours=len(full),
        out_of_order=out_of_order, duplicates_collapsed=duplicates,
        dst_folds=dst_folds, gaps_filled=gaps_filled,
        gap_runs=tuple(gap_runs),
        longest_gap_h=max(gap_runs) if gap_runs else 0,
        dst_skips=int(sum(1 for g in gap_runs if g == 1)),
        subhourly_minutes=subhourly_minutes, gap_policy=gap_policy)
    return ZoneSeries(zone=zone, values=tuple(float(v) for v in values),
                      start=start, quality=report)


# ----------------------------------------------------------------------
# The archive object + loader
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CarbonArchive:
    """A validated multi-zone carbon-intensity archive (hourly, kg/kWh)."""
    series: Tuple[ZoneSeries, ...]
    path: Optional[str] = None
    name: str = "archive"

    def __post_init__(self):
        if not self.series:
            raise ValueError("CarbonArchive needs at least one zone")

    @property
    def zones(self) -> Tuple[str, ...]:
        return tuple(s.zone for s in self.series)

    @property
    def quality(self) -> Dict[str, QualityReport]:
        return {s.zone: s.quality for s in self.series}

    def __len__(self) -> int:
        return len(self.series)

    def __iter__(self):
        return iter(self.series)

    def __getitem__(self, zone: str) -> ZoneSeries:
        for s in self.series:
            if s.zone == zone:
                return s
        raise KeyError(f"zone {zone!r} not in archive "
                       f"{self.name!r}; zones: {self.zones}")

    def _one(self, zone: Optional[str]) -> ZoneSeries:
        if zone is not None:
            return self[zone]
        if len(self.series) == 1:
            return self.series[0]
        raise ValueError(f"archive {self.name!r} has zones {self.zones}; "
                         "pass zone= to pick one")

    def to_trace(self, zone: Optional[str] = None, **kw) -> TraceSignal:
        return self._one(zone).to_trace(**kw)

    def to_ensemble(self, window_h: int, stride_h: Optional[int] = None,
                    zone: Optional[str] = None, **kw) -> SignalEnsemble:
        return self._one(zone).to_ensemble(window_h, stride_h, **kw)


def load_carbon_archive(path: str, zone: Optional[str] = None, *,
                        unit: Optional[str] = None,
                        gap_policy: str = "interpolate",
                        name: Optional[str] = None) -> CarbonArchive:
    """Parse + validate a CSV/JSON carbon-intensity archive.

    `zone=` keeps only that zone; `unit=` asserts the file-wide source
    unit ("g" / "kg" / "lb" or a full spelling) when rows don't carry
    one; `gap_policy` picks how missing hours are repaired (see module
    docstring).  Returns a `CarbonArchive` of hourly kg-CO2e/kWh
    `ZoneSeries`, each with a `QualityReport` of every repair made.
    """
    if gap_policy not in GAP_POLICIES:
        raise ValueError(f"gap_policy must be one of {GAP_POLICIES}, "
                         f"got {gap_policy!r}")
    stem = os.path.splitext(os.path.basename(path))[0]
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        raw = _parse_csv(path, default_zone=zone or stem)
    elif ext == ".json":
        raw = _parse_json(path, default_zone=zone or stem)
    else:
        raise ValueError(f"unsupported archive format {ext!r} "
                         "(expected .csv or .json)")
    if zone is not None:
        if zone not in raw:
            raise ValueError(f"zone {zone!r} not in {path}; zones: "
                             f"{tuple(sorted(raw))}")
        raw = {zone: raw[zone]}

    file_unit = _unit_key(unit) if unit is not None else None
    inferred: Dict[str, str] = {}
    resolved: Dict[str, Tuple[np.ndarray, str]] = {}
    for z, samples in sorted(raw.items()):
        if not samples:
            raise ValueError(f"zone {z!r} in {path} has no samples")
        row_units = [u for _, _, u in samples]
        explicit = next((u for u in row_units if u), None)
        if file_unit is not None:
            default = file_unit
        elif explicit is not None:
            default = explicit
        else:
            med = float(np.median([v for _, v, _ in samples]))
            default = "g" if med >= 10.0 else "kg"
            inferred[z] = default
        scale = np.asarray([_UNIT_SCALE[u or default] for u in row_units])
        resolved[z] = (scale, default)
    if len(set(inferred.values())) > 1:
        raise ValueError(
            f"{path}: zones disagree on *inferred* units "
            f"({dict(sorted(inferred.items()))}) — a g-vs-kg mix in one "
            "multi-zone file; add a unit column or pass unit= to "
            "disambiguate")

    series = tuple(_regularize(z, raw[z], resolved[z][0], resolved[z][1],
                               gap_policy)
                   for z in sorted(raw))
    return CarbonArchive(series=series, path=path, name=name or stem)


# ----------------------------------------------------------------------
# Synthetic archives + bundled samples
# ----------------------------------------------------------------------
def write_synthetic_archive(path: str, zones=("ZONE-A",), days: int = 7, *,
                            seed: int = 0, unit: str = "kg",
                            cadence_min: int = 60,
                            dst: Optional[str] = None,
                            gap: Optional[Tuple[int, int]] = None,
                            start: str = "2024-03-08T00:00",
                            include_unit_column: bool = True) -> str:
    """Write a seeded, realistic CSV/JSON carbon archive (offline fixture).

    Per zone: a diurnal shape (evening-ramp peakers), a weekend dip, and
    2% noise around a seeded base level.  `dst="spring"` drops local
    02:00 of day 1 (skip), `"fall"` doubles 01:00 of day 2 (fold),
    `"both"` does both; `gap=(start_hour, length_h)` deletes a run of
    hours — all on every zone, so loaders can be pinned against known
    defects.  Format follows the extension (.csv / .json).
    """
    if dst not in (None, "spring", "fall", "both"):
        raise ValueError("dst must be None, 'spring', 'fall', or 'both'")
    ukey = _unit_key(unit)
    out_scale = 1.0 / _UNIT_SCALE[ukey]
    rng = np.random.RandomState(seed)
    start_dt = _dt.datetime.fromisoformat(start)
    n = days * 24 * 60 // int(cadence_min)
    spring_h, fall_h = 26, 49          # day-1 02:00 skip, day-2 01:00 fold
    rows: List[Tuple[str, str, float]] = []   # (zone, iso, value in unit)
    for z in zones:
        base = 0.2 + 0.4 * rng.rand()
        for i in range(n):
            h = i * cadence_min / 60.0
            hidx = int(h)
            if gap is not None and gap[0] <= hidx < gap[0] + gap[1]:
                continue
            if dst in ("spring", "both") and hidx == spring_h:
                continue
            kg = (base * MIDWEST_HOURLY[hidx % 24]
                  * (0.88 if (hidx // 24) % 7 >= 5 else 1.0)
                  * (1.0 + 0.02 * rng.randn()))
            kg = max(kg, 0.01)
            when = (start_dt + _dt.timedelta(minutes=i * cadence_min)
                    ).isoformat()
            rows.append((z, when, kg * out_scale))
            if dst in ("fall", "both") and hidx == fall_h:
                rows.append((z, when, max(kg * (1.0 + 0.02 * rng.randn()),
                                          0.01) * out_scale))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            header = ["datetime", "zone", "carbon_intensity"]
            if include_unit_column:
                header.append("unit")
            w.writerow(header)
            for z, when, val in rows:
                line = [when, z, f"{val:.6g}"]
                if include_unit_column:
                    line.append(_UNIT_LABEL[ukey])
                w.writerow(line)
    elif ext == ".json":
        by_zone: Dict[str, list] = {}
        for z, when, val in rows:
            rec = {"datetime": when, "carbon_intensity": round(val, 6)}
            if include_unit_column:
                rec["unit"] = _UNIT_LABEL[ukey]
            by_zone.setdefault(z, []).append(rec)
        with open(path, "w") as f:
            json.dump({"zones": by_zone}, f, indent=None,
                      separators=(",", ":"))
    else:
        raise ValueError(f"unsupported archive format {ext!r} "
                         "(expected .csv or .json)")
    return path


SAMPLE_ARCHIVES = ("grid_week_3z.csv", "midwest_5min.json", "dst_week.csv")


def samples_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "samples")


def sample_archive_path(name: str) -> str:
    """Absolute path of a bundled sample archive (offline fixtures)."""
    p = os.path.join(samples_dir(), name)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"no bundled sample archive {name!r}; available: "
            f"{SAMPLE_ARCHIVES}")
    return p


def load_sample_archive(name: str, **kw) -> CarbonArchive:
    """`load_carbon_archive` over a bundled sample (see SAMPLE_ARCHIVES)."""
    return load_carbon_archive(sample_archive_path(name), **kw)


__all__ = ["GAP_POLICIES", "SAMPLE_ARCHIVES", "CarbonArchive",
           "QualityReport", "ZoneSeries", "load_carbon_archive",
           "load_sample_archive", "sample_archive_path", "samples_dir",
           "write_synthetic_archive"]
