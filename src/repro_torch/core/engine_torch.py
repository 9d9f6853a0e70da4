"""Trace-grid sweep engine on PyTorch: compile -> execute -> summarize.

The counterpart of the reference's `core/engine_jax.py`.  The periodic
24-slot engine (core/engine.py) collapses a campaign into one repeated
day; this engine *steps* the campaign slot by slot (hourly, or finer for
sub-hour band edges), carrying `(remaining, elapsed, energy/CO2/cost
accumulators)` per scan lane, so it represents everything the periodic
grid cannot: progress/elapsed-aware schedules, non-periodic multi-day
`TraceSignal`s, carbon ensembles (E members per lane) and site-capped
fleets whose campaigns couple through one power envelope.

  * **compile** (`compile_plan`) is host-side NumPy, identical to the
    reference: every case is classified once (closed-form day profile,
    probed decide() lattice, or the vectorized `decide_grid` protocol)
    and lowered into a `SweepPlan` of padded decision tables, per-lane
    physics scalars, day-periodic background tables and incrementally
    sampled signal grids.  Per-case compilation is memoized by case
    fingerprint within the process.

  * **execute** (`execute_plan`) runs the chunked resumable scan: the
    horizon is covered by fixed-length chunks (default 4 days), state is
    carried across chunks, finished lanes are compacted out and
    stragglers get more chunks.  Each chunk's inputs are assembled on the
    host, copied to the device, advanced by one kernel launch and copied
    back: `kernels/scan_chunk.py` (K2) for plain sweeps,
    `kernels/coupled_chunk.py` (K1) for site-capped fleets, each a
    hand-written CUDA kernel on the card and its plain PyTorch version on
    the CPU.  `mode="monolithic"` keeps the single-scan/retry-doubling
    executor for equivalence tests.

  * **summarize** (`summarize_plan`) folds the final state into
    `SimResult`s; ensemble cases get mean CO2 plus per-member
    `EnsembleStats`.

  * **recurrence**: `compile_plan(cache_dir=...)` adds a persistent
    layer under the in-process memo (core/plancache.py), so a fresh
    process re-compiling the same batch reads it off disk;
    `replace_tables` swaps decision tables (or carbon signals) into an
    in-flight plan, the re-plan step of receding-horizon MPC
    (core/mpc.py); `delta_sweep` re-scans only the cases a delta
    changed and splices last cycle's results for the rest.

  * **objectives** (`TraceObjective`, `FleetTraceObjective`) are the same
    physics as a differentiable function of a day schedule's per-slot
    intensities, the substrate of `core/optimize.py`: on the card one
    launch of a hand-written scan kernel forward and one backward
    (`kernels/objective_scan.py` K3, `kernels/fleet_objective.py` K4,
    each a `torch.autograd.Function`), on the CPU their plain PyTorch
    versions differentiated by `torch.autograd`.

Entry points run on the card (`device="cuda"`) unless the caller names
another device; with no card and no device given they raise instead of
falling back to the CPU.  `precision="mixed"` runs the per-slot physics
in float32 with float64 carried state and sums.  Not in this package
yet: lane sharding over several cards (`devices` > 1) and the NumPy
backend (`backend=`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import model, plancache
from repro_torch.core.carbon import GridCarbonModel
from repro_torch.core.device import reject_unported, resolve_device
from repro_torch.core.schedule import (ParametricSchedule, SchedulingContext,
                                       as_schedule)
from repro_torch.core.signal import (Signal, SignalEnsemble, TraceSignal,
                                     carbon_signal, sample_signal)
from repro_torch.core.simulator import SimResult, ensemble_stats
from repro_torch.kernels import coupled_chunk as _k1
from repro_torch.kernels import fleet_objective as _k4
from repro_torch.kernels import objective_scan as _k3
from repro_torch.kernels import scan_chunk as _k2

_PROBE_PROGRESS = (0.0, 1.0 / 3.0, 2.0 / 3.0, 0.999)
_PROBE_OFFSETS = (0.0, 3.0, 5.0, 9.0, 13.0, 17.0, 21.0)

#: Chunk length of the resumable scan, in days.  One compiled kernel
#: shape serves every campaign length; stragglers just get more chunks.
DEFAULT_CHUNK_DAYS = 4

#: Fraction of a case's workload that must complete per scanned day for
#: the case to count as progressing (zero-intensity schedules leak a
#: ~1e-10/day numerical trickle through the rate floor, real schedules
#: complete orders of magnitude more).
_STALL_FRAC_PER_DAY = 1e-9

#: Remaining-work fraction below which a lane counts as finished — the
#: executor's compaction threshold, and the site-coupled kernels' power
#: mask: a lane whose fp residue is epsilon-positive must not demand a
#: full slot of site power (backends round the final subtraction
#: differently, and one phantom throttled slot costs the rest of the
#: group real throughput).
_FINISH_FRAC = 1e-6


# ---------------------------------------------------------------------------
# Scan statistics: how much slot-work a sweep executed, how many bytes
# crossed between host and device, and how often each kernel launched.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ScanStats:
    """Counters over every scan executed since the last reset.

    `slot_work` counts lane x slot units handed to the chunk kernels
    (coupled chunks count their dense (group, lane) padding); `chunks`
    counts chunk executions; `grouped_lanes` counts lane x chunk units
    that ran through the site-coupled kernel (0 for plain sweeps);
    `plan_hits`/`plan_misses` count the per-case compile memo;
    `precision_mode` is the dtype policy ("fp64"/"mixed") and `device`
    the device of the most recent `execute_plan`; `copy_bytes` counts
    the bytes copied between host and device around the chunks (inputs
    up, state down; on the CPU the copies are no-ops but still counted).
    `kernel_dispatches` holds the launches of each hand-written CUDA
    kernel, read from the wrappers: `scan_chunk` (K2) and
    `coupled_chunk` (K1); both stay 0 when the chunks ran the plain
    PyTorch versions on the CPU.
    MPC observability: `replans` counts `replace_tables` calls (one per
    mid-flight re-plan) and `slots_reused` the lane x slot units of
    already-executed state carried across those re-plans — work a
    plan-from-scratch loop would have recomputed and the resumable
    executor did not.
    Recurrence observability: `disk_hits`/`disk_misses` count per-case
    compile artifacts served from (or absent from) the persistent plan
    cache (core/plancache.py; a fresh-process warm start of an S-case
    sweep shows `disk_hits == S` with `plan_misses == 0`), and
    `lanes_recomputed`/`lanes_spliced` partition a `delta_sweep`'s
    lanes into re-scanned and result-spliced.
    The `requests_*` counters are fed by the serving layer
    (core/serve.py) as it schedules arrival windows: seen is every
    request offered, admitted/rejected partition them, and degraded
    counts admissions that only fit at a cheaper quality tier.
    `reset_scan_stats()` zeroes all of it.
    """
    slot_work: int = 0            # lane x slot units executed
    chunks: int = 0               # chunk executions
    grouped_lanes: int = 0        # lane x chunk units in coupled groups
    plan_hits: int = 0            # per-case compile memo hits
    plan_misses: int = 0
    replans: int = 0              # replace_tables calls (mid-flight re-plans)
    slots_reused: int = 0         # lane x slot units carried across re-plans
    disk_hits: int = 0            # compile artifacts loaded from disk
    disk_misses: int = 0          # disk lookups that fell through to compile
    lanes_recomputed: int = 0     # delta_sweep lanes re-scanned
    lanes_spliced: int = 0        # delta_sweep lanes served from prev results
    requests_seen: int = 0        # requests offered to the serving layer
    requests_admitted: int = 0    # ... assigned a service slot
    requests_rejected: int = 0    # ... infeasible at every allowed tier
    requests_degraded: int = 0    # ... admitted at a cheaper tier
    precision_mode: str = ""      # dtype policy of the last executed plan
    device: str = ""              # device of the last executed plan
    copy_bytes: int = 0           # host<->device bytes around the chunks
    kernel_dispatches: Dict[str, int] = dataclasses.field(
        default_factory=dict)


_STATS = ScanStats()


def scan_stats(reset: bool = False) -> ScanStats:
    """A snapshot copy of the engine's scan counters (with the kernel
    launch counts read from the wrappers); `reset=True` zeroes the live
    counters after taking the snapshot."""
    snap = dataclasses.replace(
        _STATS, kernel_dispatches={"scan_chunk": _k2.launches,
                                   "coupled_chunk": _k1.launches})
    if reset:
        reset_scan_stats()
    return snap


def reset_scan_stats() -> None:
    """Zero the counters, the kernels' launch counts included."""
    for f in dataclasses.fields(ScanStats):
        if f.default is not dataclasses.MISSING:
            setattr(_STATS, f.name, f.default)
    _k2.launches = 0
    _k1.launches = 0


@functools.lru_cache(maxsize=256)       # bounded, same policy as engine.py
def _bg_table(bands, sph: int) -> np.ndarray:
    """Background load per grid row over one day ((24*sph,), memoized)."""
    return np.array([bands.background(bands.band_at(r / sph))
                     for r in range(24 * sph)])


def _ctx_factory(case, carbon_sig, price_sig):
    """ctx(t_abs, progress) for probing and decision-table sampling,
    built exactly like the sequential simulators build theirs."""
    bands = case.bands
    start = case.start_hour

    def make(t_abs: float, progress: float) -> SchedulingContext:
        hod = t_abs % 24.0
        band = bands.band_at(hod)
        return SchedulingContext(
            hour_of_day=hod, band=band, background=bands.background(band),
            carbon_factor=float(carbon_sig.at(t_abs)),
            price_usd_per_kwh=(float(price_sig.at(t_abs))
                               if price_sig is not None else 0.0),
            elapsed_h=max(t_abs - start, 0.0), progress=progress,
            deadline_h=case.deadline_h)

    return make


class ProbeInfo(NamedTuple):
    """Dependence classification of one schedule's decide()."""
    progress_dep: bool
    elapsed_dep: bool
    carbon_dep: bool
    samples: list                 # (t_abs, intensity, batch) lattice points


def _probe(sched, make_ctx, g0: float, horizon_h: float) -> ProbeInfo:
    """Classify a schedule's decide() from a coarse lattice.

    `elapsed_dep` is true when the same hour-of-day decides differently on
    different days (a deadline pace, or a schedule following a non-periodic
    carbon trace through ctx.carbon_factor); `progress_dep` when decisions
    move with ctx.progress; `carbon_dep` when perturbing ctx.carbon_factor
    alone changes the decision (such schedules need per-member decision
    tables under a carbon ensemble).  Exact for the bundled schedule
    families; arbitrary callables are sampled on the lattice (documented
    heuristic — a schedule varying only between lattice points can be
    misclassified).
    """
    days = sorted({0.0, 24.0, 48.0,
                   max(math.floor(horizon_h / 48.0) * 24.0, 0.0),
                   max((math.floor(horizon_h / 24.0) - 1) * 24.0, 0.0)})
    progress_dep = elapsed_dep = carbon_dep = False
    samples = []
    for off in _PROBE_OFFSETS:
        base = None
        for day_h in days:
            t_abs = g0 + day_h + off
            if t_abs - g0 > horizon_h + 24.0:
                continue
            ctx0 = make_ctx(t_abs, 0.5)
            d0 = sched.decide(ctx0)
            key0 = (d0.intensity, d0.batch_size)
            samples.append((t_abs, d0.intensity, d0.batch_size))
            if base is None:
                base = key0
            elif key0 != base:
                elapsed_dep = True
            if not carbon_dep:
                dc = sched.decide(dataclasses.replace(
                    ctx0, carbon_factor=ctx0.carbon_factor * 1.5 + 0.05))
                if (dc.intensity, dc.batch_size) != key0:
                    carbon_dep = True
            for p in _PROBE_PROGRESS:
                dp = sched.decide(make_ctx(t_abs, p))
                if (dp.intensity, dp.batch_size) != key0:
                    progress_dep = True
                    samples.append((t_abs, dp.intensity, dp.batch_size))
    return ProbeInfo(progress_dep, elapsed_dep, carbon_dep, samples)


def _case_g0(case, sph: int) -> float:
    return math.floor(case.start_hour * sph) / sph


def _grid_ctx(case, carbon_sig, price_sig, sph: int, t_abs: np.ndarray,
              B_i: int) -> SchedulingContext:
    """Array SchedulingContext over absolute hours `t_abs` for the
    vectorized `decide_grid` protocol (shape (T, 1) x (1, B))."""
    H = 24 * sph
    rows = np.floor(t_abs * sph + 1e-9).astype(int) % H
    centers = (np.arange(B_i) + 0.5) / B_i
    return SchedulingContext(
        hour_of_day=t_abs[:, None] % 24.0, band="",
        background=_bg_table(case.bands, sph)[rows][:, None],
        carbon_factor=sample_signal(carbon_sig, t_abs)[:, None],
        price_usd_per_kwh=(sample_signal(price_sig, t_abs)[:, None]
                           if price_sig is not None else 0.0),
        elapsed_h=np.maximum(t_abs - case.start_hour, 0.0)[:, None],
        progress=centers[None, :], deadline_h=case.deadline_h)


def _day_table(case, sched, probe: Optional[ProbeInfo], carbon_sig,
               price_sig, sph: int, B: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Periodic decision table of shape (24*sph, B_i) for a schedule whose
    decide() was probed hour-of-day-periodic (rows are indexed modulo the
    day; each row is sampled at its first occurrence on the grid)."""
    H = 24 * sph
    g0 = _case_g0(case, sph)
    hod = np.arange(H) / sph
    t_abs = g0 + ((hod - g0) % 24.0)     # first occurrence of each row
    progress_dep = probe.progress_dep if probe is not None else False
    B_i = B if progress_dep else 1
    if hasattr(sched, "decide_grid"):
        u, b = sched.decide_grid(_grid_ctx(case, carbon_sig, price_sig, sph,
                                           t_abs, B_i))
        return (np.broadcast_to(np.asarray(u, dtype=float), (H, B_i)).copy(),
                np.broadcast_to(np.asarray(b, dtype=float), (H, B_i)).copy())
    make_ctx = _ctx_factory(case, carbon_sig, price_sig)
    u_rows = np.empty((H, B_i))
    b_rows = np.empty((H, B_i))
    for ri in range(H):
        for bi in range(B_i):
            p = (bi + 0.5) / B_i if progress_dep else 0.0
            d = sched.decide(make_ctx(float(t_abs[ri]), p))
            u_rows[ri, bi] = d.intensity
            b_rows[ri, bi] = d.batch_size
    return u_rows, b_rows


def _chunk_table_builder(case, sched, probe: ProbeInfo, carbon_sig,
                         price_sig, sph: int, B: int) -> Callable:
    """builder(t0_slot, C) -> (u, b) of shape (C, B_i) for an
    elapsed-aware schedule: decision rows for global grid slots
    [t0, t0 + C) only — slots already scanned are never re-decided."""
    g0 = _case_g0(case, sph)
    # decide_grid schedules always get the full progress axis: the grid
    # call is vectorized (extra buckets are nearly free) and the probe
    # lattice must not flatten a progress window it happened to miss —
    # only probed decide() schedules, where buckets cost B Python calls
    # per row, use the probe's progress classification
    B_i = B if (probe.progress_dep or hasattr(sched, "decide_grid")) else 1
    if hasattr(sched, "decide_grid"):
        def build_grid(t0_slot: int, C: int):
            t_abs = g0 + (t0_slot + np.arange(C)) / sph
            u, b = sched.decide_grid(_grid_ctx(case, carbon_sig, price_sig,
                                               sph, t_abs, B_i))
            return (np.broadcast_to(np.asarray(u, dtype=float),
                                    (C, B_i)).copy(),
                    np.broadcast_to(np.asarray(b, dtype=float),
                                    (C, B_i)).copy())
        return build_grid

    make_ctx = _ctx_factory(case, carbon_sig, price_sig)

    def build_loop(t0_slot: int, C: int):
        u_rows = np.empty((C, B_i))
        b_rows = np.empty((C, B_i))
        for ri in range(C):
            t = g0 + (t0_slot + ri) / sph
            for bi in range(B_i):
                p = (bi + 0.5) / B_i if probe.progress_dep else 0.0
                d = sched.decide(make_ctx(t, p))
                u_rows[ri, bi] = d.intensity
                b_rows[ri, bi] = d.batch_size
        return u_rows, b_rows

    return build_loop


def _estimate_hours(case, prof, probe: Optional[ProbeInfo],
                    max_hours: float, sph: int = 1) -> float:
    """Campaign-duration estimate (sizes the monolithic scan grid; the
    chunked executor doesn't need it — it just appends chunks).

    Near-exact for periodic progress-free tables (one day's throughput is
    computable up front); conservative — slowest sampled decision — for
    decide()-probed schedules."""
    sched = as_schedule(case.schedule)
    bg_day = _bg_table(case.bands, sph)
    if prof is not None:                 # (24*sph,) day profile
        u_rows, b_rows = prof
        r = model.campaign_rates(np.asarray(u_rows), np.asarray(b_rows),
                                 bg_day, case.workload, case.machine, xp=np)
        day_scen = float(r.scen_per_s.sum()) * 3600.0 / sph
        if day_scen <= 0.0:
            return max_hours
        dur = case.workload.n_scenarios / day_scen * 24.0
        return min(dur * 1.02 + 28.0, max_hours)
    samples = probe.samples
    u = np.array([s[1] for s in samples])
    b = np.array([s[2] for s in samples])
    bg = bg_day[np.floor([(s[0] % 24.0) * sph for s in samples]).astype(int)]
    rs = model.campaign_rates(u, b, bg, case.workload, case.machine,
                              xp=np).scen_per_s
    floor = rs[rs > 0.02 * rs.max()] if rs.size else rs
    if not floor.size:
        return max_hours
    if hasattr(sched, "decide_grid"):
        # vectorized tables are cheap to rebuild, so start from the mean
        # sampled rate (a feedback controller like the deadline keeper
        # mixes its extremes) and let the retry loop double on undershoot
        dur = case.workload.n_scenarios / (float(floor.mean()) * 3600.0)
        return min(dur * 1.25 + 26.0, max_hours)
    dur = case.workload.n_scenarios / (float(floor.min()) * 3600.0)
    return min(dur * 1.15 + 26.0, max_hours)


# ---------------------------------------------------------------------------
# Case compilation: classify once, cache by fingerprint.
# ---------------------------------------------------------------------------
class _CaseCompiled(NamedTuple):
    """Everything expensive about one case, computed exactly once."""
    prof: Optional[Tuple[np.ndarray, np.ndarray]]   # closed-form day profile
    probe: Optional[ProbeInfo]
    table: Optional[Tuple[np.ndarray, np.ndarray]]  # periodic (H, B_i) rows
    periodic: bool        # True: rowidx wraps mod day; False: chunk-built
    carbon_dep: bool      # decisions consult live carbon (ensemble expansion)
    est_h: float          # duration estimate for the monolithic mode
    stalled: bool = False  # provably never finishes (zero day throughput)


def _table_stalled(case, table: Tuple[np.ndarray, np.ndarray],
                   sph: int) -> bool:
    """True when a day-periodic decision table provably never finishes:
    one full day at campaign start (progress-bucket 0) completes a
    negligible fraction of the workload, and the table repeats forever.
    Catches zero-intensity schedules at compile time instead of after a
    scan to max_days."""
    u_rows, b_rows = table
    r = model.campaign_rates(u_rows[:, 0], b_rows[:, 0],
                             _bg_table(case.bands, sph), case.workload,
                             case.machine, xp=np)
    day_scen = float(r.scen_per_s.sum()) * 3600.0 / sph
    return day_scen <= _STALL_FRAC_PER_DAY * case.workload.n_scenarios



_PLAN_CACHE: "OrderedDict[tuple, _CaseCompiled]" = OrderedDict()
_PLAN_CACHE_SIZE = 4096               # entries are ~1 KB (tables + probe)


def _memo_get(key: tuple) -> Optional[_CaseCompiled]:
    """In-memory memo lookup with LRU recency: a hit moves the entry to
    the young end, so hot entries compiled early survive eviction."""
    comp = _PLAN_CACHE.get(key)
    if comp is not None:
        _PLAN_CACHE.move_to_end(key)
    return comp


def _memo_put(key: tuple, comp: _CaseCompiled) -> None:
    """Insert at the young end; when full, evict the oldest quarter (in
    true recency order — `_memo_get` refreshes on hit)."""
    if key in _PLAN_CACHE:
        _PLAN_CACHE.move_to_end(key)
        _PLAN_CACHE[key] = comp
        return
    if len(_PLAN_CACHE) >= _PLAN_CACHE_SIZE:
        for _ in range(max(_PLAN_CACHE_SIZE // 4, 1)):
            if not _PLAN_CACHE:
                break
            _PLAN_CACHE.popitem(last=False)
    _PLAN_CACHE[key] = comp


class _Opaque(Exception):
    """A fingerprint component has no value identity (e.g. a closure)."""


_OPAQUE_FROZEN = object()     # memoized "this component is opaque" marker


def _freeze(obj):
    """Recursively lower a fingerprint component to a hashable value:
    dataclasses by field values, dicts/sequences by sorted/ordered
    tuples, arrays by bytes.  Raises `_Opaque` for anything without a
    value identity — plain class instances hash by identity, which says
    nothing about the *decisions* the object makes (it could mutate, or
    close over mutable state), so such cases are simply compiled fresh.
    Every bundled schedule/signal family is a (frozen) dataclass and
    freezes by value."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(_freeze(getattr(obj, f.name))
                                    for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    try:
        hash(obj)
    except TypeError:
        raise _Opaque from None
    if type(obj).__hash__ is object.__hash__:   # identity hash only
        raise _Opaque
    return obj


def _fingerprint(case, price, sph: int, B: int, max_days: int,
                 memo: Optional[dict] = None) -> Optional[tuple]:
    """Hashable value identity of one case's compilation inputs, or None
    when a component is opaque (then the case is compiled fresh).

    `memo` (id -> (obj, frozen)) de-duplicates the freeze of components
    shared across a batch — a 1000-case sweep over one workload/machine/
    trace freezes each shared object once, not 1000 times.  The memo
    keeps the object referenced, so ids cannot be recycled while it
    lives (one compile_plan call).
    """
    def freeze(obj):
        if memo is None:
            return _freeze(obj)
        entry = memo.get(id(obj))
        if entry is None:
            try:
                entry = (obj, _freeze(obj))
            except _Opaque:
                entry = (obj, _OPAQUE_FROZEN)
            memo[id(obj)] = entry
        if entry[1] is _OPAQUE_FROZEN:
            raise _Opaque
        return entry[1]

    try:
        return (freeze(case.schedule), freeze(case.workload),
                freeze(case.machine), freeze(case.bands),
                freeze(case.carbon), case.start_hour, case.deadline_h,
                freeze(price) if price is not None else None,
                sph, B, max_days)
    except _Opaque:
        return None


def clear_plan_cache() -> None:
    """Empty the in-process compile memo and zero every cache counter
    (`plan_hits`/`plan_misses`, the disk `disk_hits`/`disk_misses`, and
    the delta-sweep `lanes_recomputed`/`lanes_spliced`) so hit-rate
    measurements restart clean.  Disk entries are left in place — use
    `plancache.get_cache(dir).clear()` to empty a store."""
    _PLAN_CACHE.clear()
    _STATS.plan_hits = 0
    _STATS.plan_misses = 0
    _STATS.disk_hits = 0
    _STATS.disk_misses = 0
    _STATS.lanes_recomputed = 0
    _STATS.lanes_spliced = 0


def _comp_nbytes(comp: _CaseCompiled) -> int:
    n = 256                               # flags, floats, tuple overhead
    for pair in (comp.prof, comp.table):
        if pair is not None:
            n += int(pair[0].nbytes) + int(pair[1].nbytes)
    if comp.probe is not None:
        n += 24 * len(comp.probe.samples)
    return n


@dataclasses.dataclass(frozen=True)
class PlanCacheInfo:
    """One dashboard row over both plan-cache layers: the in-process
    memo (`mem_*`) and the persistent disk store (`disk_*`, zero when
    caching is off).  `hits`/`misses` aggregate since the last
    `clear_plan_cache()`/`reset_scan_stats()`: a hit is a compile
    avoided by either layer, a miss is an actual `_compile_case` run."""
    mem_entries: int
    mem_bytes: int
    disk_entries: int
    disk_bytes: int
    hits: int
    misses: int

    @property
    def hit_rate(self) -> float:
        """Fraction of case lookups served without compiling (0.0 when
        nothing has been looked up yet)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def plan_cache_info(cache_dir: Optional[str] = None) -> PlanCacheInfo:
    """Entries, bytes, and hit rate of the plan cache (memo + disk).

    `cache_dir` resolves like everywhere else (explicit dir, else the
    ``CARINA_PLAN_CACHE`` env default, else no disk layer)."""
    cache = plancache.get_cache(cache_dir)
    disk_entries, disk_bytes = cache.info() if cache is not None else (0, 0)
    return PlanCacheInfo(
        mem_entries=len(_PLAN_CACHE),
        mem_bytes=sum(_comp_nbytes(c) for c in _PLAN_CACHE.values()),
        disk_entries=disk_entries, disk_bytes=disk_bytes,
        hits=_STATS.plan_hits + _STATS.disk_hits,
        misses=_STATS.plan_misses)


def _obtain_case(case, dec_sig, price, sph: int, B: int, max_hours: float,
                 key: Optional[tuple],
                 cache: Optional[plancache.PlanCache]) -> _CaseCompiled:
    """One case's compile artifact through the layered cache: in-memory
    memo, then the disk store, then `_compile_case` (write-through to
    both layers).  Opaque-fingerprint cases (key None) bypass both
    layers entirely — no entry is ever stored for them, so a
    closure-bearing schedule can never poison the cache."""
    comp = _memo_get(key) if key is not None else None
    if comp is not None:
        _STATS.plan_hits += 1
        return comp
    if cache is not None and key is not None:
        comp = cache.get_case(key)
        if comp is not None:
            _STATS.disk_hits += 1
            _memo_put(key, comp)
            return comp
        _STATS.disk_misses += 1
    comp = _compile_case(case, dec_sig, price, sph, B, max_hours)
    _STATS.plan_misses += 1
    if key is not None:
        _memo_put(key, comp)
        if cache is not None:
            cache.put_case(key, comp)
    return comp


def _compile_case(case, dec_sig, price, sph: int, B: int,
                  max_hours: float) -> _CaseCompiled:
    """Classify one case and build whatever table can be built up front.
    `dec_sig` is the carbon signal decisions see (for an ensemble: the
    first member — the probe's carbon_dep flag tells us whether the
    member choice can matter)."""
    from repro_torch.core.engine import periodic_decision_profile
    sched = as_schedule(case.schedule)
    prof = periodic_decision_profile(sched, case.bands, sph)
    if prof is not None:                 # closed-form: never consults ctx
        u_rows, b_rows = prof
        table = (u_rows[:, None].astype(float), b_rows[:, None].astype(float))
        return _CaseCompiled(prof=prof, probe=None, table=table,
                             periodic=True, carbon_dep=False,
                             est_h=_estimate_hours(case, prof, None,
                                                   max_hours, sph),
                             stalled=_table_stalled(case, table, sph))
    probe = _probe(sched, _ctx_factory(case, dec_sig, price),
                   _case_g0(case, sph), max_hours)
    est = _estimate_hours(case, None, probe, max_hours, sph)
    # decide_grid tables are exact per-slot and cheap to rebuild per
    # chunk, so schedules implementing it only get the compact
    # day-periodic lowering when they *declare* hour-of-day-only
    # decisions (`periodic_decisions`, e.g. ParametricSchedule) — the
    # probe lattice alone must not demote a vectorized schedule whose
    # elapsed-dependence it happens to miss.  Plain decide() schedules
    # keep the probe classification (the pre-existing, documented
    # heuristic).
    grid_ok = (not hasattr(sched, "decide_grid")
               or getattr(sched, "periodic_decisions", False))
    if not probe.elapsed_dep and grid_ok:
        table = _day_table(case, sched, probe, dec_sig, price, sph, B)
        return _CaseCompiled(prof=None, probe=probe, table=table,
                             periodic=True, carbon_dep=probe.carbon_dep,
                             est_h=est,
                             stalled=_table_stalled(case, table, sph))
    return _CaseCompiled(prof=None, probe=probe, table=None, periodic=False,
                         carbon_dep=probe.carbon_dep, est_h=est)



@dataclasses.dataclass
class SweepPlan:
    """The compiled form of one trace sweep: everything the chunked scan
    needs, laid out as batched arrays over scan *lanes*.

    A lane is one scan row: normally one case; a carbon-dependent
    schedule under an E-member ensemble expands into E lanes (one per
    member, since each member induces different decisions).  Decision
    tables are either periodic (`lane_table`, rows indexed modulo the
    day) or built chunk-by-chunk (`lane_builder`, for elapsed-aware
    schedules).  `grids` memoizes signal samples per (signal, grid
    offset): each grid slot is sampled exactly once per plan and
    extended incrementally as chunks are appended — never re-sampled
    per retry.
    """
    cases: Tuple
    price: Optional[Signal]
    sph: int
    B: int
    max_days: int
    E: int                                   # ensemble width (1 = none)
    case_ensemble: List[Optional[SignalEnsemble]]   # per case
    case_expanded: List[bool]                # per case: E lanes?
    lane_case: np.ndarray                    # (L,) case index per lane
    lane_member: np.ndarray                  # (L,) member driving decisions
    lane_table: List[Optional[Tuple[np.ndarray, np.ndarray]]]
    lane_builder: List[Optional[Callable]]
    lane_periodic: np.ndarray                # (L,) bool (== has a table)
    tab_u: np.ndarray                        # (L, 24*sph, B_t) stacked tables
    tab_b: np.ndarray                        # (zero/one rows for chunk-built)
    tab_buckets: int                         # B_t: 1, or B with progress lanes
    lane_co2_sigs: List[Tuple[Signal, ...]]  # (E,) carbon signals per lane
    # per-lane physics scalars, all shape (L,)
    n_scen: np.ndarray
    rate: np.ndarray
    oh: np.ndarray
    idle: np.ndarray
    dyn: np.ndarray
    alpha: np.ndarray
    gamma: np.ndarray
    ohfrac: np.ndarray
    start: np.ndarray
    g0: np.ndarray
    s0: np.ndarray
    bg_day: np.ndarray                       # (L, 24*sph)
    est_h: float                             # max over cases
    # fleet (lane-group) layout: adjacent cases of one fleet share a
    # group; a finite per-group cap turns on the site-coupled kernel
    group_sizes: Tuple[int, ...] = ()        # cases per group (sum = n cases)
    case_group: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=int))   # (n cases,)
    lane_group: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=int))   # (L,)
    group_cap_kw: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))  # (G,), inf = uncoupled
    group_office_kw: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))  # (G,) peak office draw
    #: dtype policy of the scan ("fp64" exact, or "mixed": fp32 state
    #: and inputs with fp64 kWh/CO2/cost accumulators)
    precision: str = "fp64"
    grids: Dict[tuple, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n_lanes(self) -> int:
        return len(self.lane_case)

    @property
    def max_slots(self) -> int:
        return int(self.max_days * 24 * self.sph)

    @property
    def coupled(self) -> bool:
        """True when any group has a finite site cap (the scan must run
        the grouped site-coupled kernel)."""
        return bool(np.isfinite(self.group_cap_kw).any())


class _ScanState(NamedTuple):
    """Scan accumulators, carried across chunks."""
    remaining: np.ndarray     # (L,)
    runtime_s: np.ndarray     # (L,)
    kwh: np.ndarray           # (L,)
    co2: np.ndarray           # (L, E)
    cost: np.ndarray          # (L,)
    # site draw peak (kW, office + fleet) seen by each lane's group while
    # the lane was active; None on uncoupled plans (the uncoupled kernel
    # does not track it).  Group peak = max over the group's lanes.
    site_kw_peak: Optional[np.ndarray] = None


@dataclasses.dataclass
class PlanCursor:
    """Resumable position of one plan execution, paused at a chunk
    boundary.

    `state` holds full-length (L,) accumulators — finished lanes keep
    their final values; `t0` is the next global grid slot to scan and
    `active` the lane indices still unfinished.  A cursor is what
    `execute_interval` returns and accepts: the MPC loop executes one
    control interval, re-plans (`replace_tables`), and resumes from the
    same cursor — no already-executed slot is ever recomputed.
    Cursors are immutable in practice: `execute_interval` copies the
    state arrays, so earlier cursors stay valid snapshots.
    """
    state: _ScanState
    t0: int = 0
    active: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=int))

    @property
    def done(self) -> bool:
        """True when every lane has finished its workload."""
        return self.active.size == 0


def new_cursor(plan: SweepPlan) -> PlanCursor:
    """A fresh cursor at slot 0 with every lane active."""
    L = plan.n_lanes
    state = _ScanState(
        plan.n_scen.copy(), np.zeros(L), np.zeros(L),
        np.zeros((L, plan.E)), np.zeros(L),
        np.zeros(L) if plan.coupled else None)
    return PlanCursor(state=state, t0=0, active=np.arange(L))


def compile_plan(cases: Sequence, price: Optional[Signal] = None, *,
                 slots_per_hour: int = 1, progress_buckets: int = 32,
                 max_days: int = 120,
                 group_sizes: Optional[Sequence[int]] = None,
                 group_caps_kw: Optional[Sequence[Optional[float]]] = None,
                 group_office_kw: Optional[Sequence[float]] = None,
                 precision: str = "fp64",
                 cache_dir: Optional[str] = None) -> SweepPlan:
    """Lower a case batch into a `SweepPlan` (the scan's input form).

    Per-case classification (closed-form profile / probe / decide_grid)
    is memoized by case fingerprint across calls, so re-sweeping the
    same cases skips the Python probing entirely.  `cache_dir` (default:
    the ``CARINA_PLAN_CACHE`` environment variable; caching off when
    both are unset) adds the persistent layer: compile artifacts are
    also served from / written through to a disk-backed
    content-addressed store (core/plancache.py), so a *fresh process*
    re-compiling the same batch does zero classification/probing/
    lowering work — one whole-batch entry read (accounted as
    `scan_stats().disk_hits`) replaces the S-case compile,
    bitwise-identically.

    `group_sizes` partitions the case sequence into fleet *groups* of
    adjacent cases (the M campaigns of one fleet case); `group_caps_kw`
    gives each group's site power cap in kW (None/inf = uncoupled) and
    `group_office_kw` its peak office/background draw (scaled by the
    band background over the day).  Groups with a finite cap run the
    site-coupled kernel: per slot, the summed active draw of the group
    is compared to the headroom and every member's intensity is
    curtailed by the shared `model.site_throttle` factor.  With the
    defaults every case is its own uncoupled group and the scan is
    byte-identical to the ungrouped engine.

    `precision` selects the scan's dtype policy: `"fp64"` (default)
    keeps the exact double-precision behaviour; `"mixed"` runs the
    per-slot physics (tables, series, rates) in fp32 while the carried
    state and the kWh/CO2/cost sums stay fp64 — kWh/CO2 totals stay
    within ~1e-6 relative of fp64 (pinned by tests).
    """
    if precision not in ("fp64", "mixed"):
        raise ValueError(f"unknown precision {precision!r}; "
                         "use 'fp64' or 'mixed'")
    sph = int(slots_per_hour)
    B = int(progress_buckets)
    max_hours = float(max_days) * 24.0
    H = 24 * sph

    # ---- group layout ----------------------------------------------------
    if group_sizes is None:
        group_sizes = (1,) * len(cases)
    group_sizes = tuple(int(g) for g in group_sizes)
    if sum(group_sizes) != len(cases) or any(g < 1 for g in group_sizes):
        raise ValueError(
            f"group_sizes {group_sizes} must be positive and sum to the "
            f"case count ({len(cases)})")
    G = len(group_sizes)
    caps = np.full(G, np.inf)
    if group_caps_kw is not None:
        if len(group_caps_kw) != G:
            raise ValueError(f"group_caps_kw needs one entry per group "
                             f"({G}), got {len(group_caps_kw)}")
        caps = np.array([np.inf if c is None else float(c)
                         for c in group_caps_kw])
        if (caps <= 0.0).any():
            raise ValueError("site caps must be positive kW (or None for "
                             "uncoupled)")
    office = np.zeros(G)
    if group_office_kw is not None:
        if len(group_office_kw) != G:
            raise ValueError(f"group_office_kw needs one entry per group "
                             f"({G}), got {len(group_office_kw)}")
        office = np.array([float(o) for o in group_office_kw])
    case_group = np.repeat(np.arange(G), group_sizes)
    for g in np.flatnonzero(np.isfinite(caps)):
        members = [cases[i] for i in np.flatnonzero(case_group == g)]
        if len({c.start_hour for c in members}) > 1:
            raise ValueError(
                f"coupled group {g} mixes start_hours "
                f"{sorted({c.start_hour for c in members})}: campaigns "
                "under one site cap share the site's clock (their scan "
                "grids must align slot for slot)")
        if len({id(c.bands) for c in members}) > 1 and \
                len({c.bands for c in members}) > 1:
            raise ValueError(
                f"coupled group {g} mixes TimeBands: campaigns under one "
                "site share the site's band structure (the office draw "
                "follows one background curve)")

    ensembles: List[Optional[SignalEnsemble]] = []
    for c in cases:
        ens = c.carbon if isinstance(c.carbon, SignalEnsemble) else None
        ensembles.append(ens)
    sizes = {len(e) for e in ensembles if e is not None}
    if len(sizes) > 1:
        raise ValueError(
            f"all carbon ensembles in one sweep must have the same member "
            f"count; got {sorted(sizes)}")
    E = sizes.pop() if sizes else 1

    # decision-carbon signal per case: ensemble member 0 stands in for
    # the ensemble (carbon_dep probing tells us if the choice matters).
    # Cases on the default grid model share ONE signal object, so the
    # id-keyed signal-grid dedup fires across the whole batch.
    default_sig = carbon_signal(GridCarbonModel())
    dec_sigs = [carbon_signal(ens.member(0)) if ens is not None
                else (carbon_signal(c.carbon) if c.carbon is not None
                      else default_sig)
                for c, ens in zip(cases, ensembles)]

    cache = plancache.get_cache(cache_dir)
    memo: dict = {}
    keys = [_fingerprint(c, price, sph, B, max_days, memo) for c in cases]
    compiled: List[Optional[_CaseCompiled]] = [
        _memo_get(k) if k is not None else None for k in keys]
    _STATS.plan_hits += sum(c is not None for c in compiled)
    missing = [i for i, c in enumerate(compiled) if c is None]
    batch_digest = (cache.batch_digest(keys)
                    if cache is not None and len(cases)
                    and all(k is not None for k in keys) else None)
    batch_missed = False
    if missing and batch_digest is not None:
        # whole-batch warm start: one entry read replaces up to S
        # per-case reads (the common recurrence shape — the same batch,
        # verbatim, next cycle in a fresh process)
        batch = cache.get_batch(batch_digest, len(cases))
        if batch is not None:
            for i in missing:
                compiled[i] = batch[i]
                _memo_put(keys[i], batch[i])
            _STATS.disk_hits += len(missing)
            missing = []
        else:
            batch_missed = True
    for i in missing:
        compiled[i] = _obtain_case(cases[i], dec_sigs[i], price, sph, B,
                                   max_hours, keys[i], cache)
    if batch_missed:
        cache.put_batch(batch_digest, compiled)
    for c, comp in zip(cases, compiled):
        if comp.stalled:
            raise RuntimeError(
                f"case {c.name()!r} can never finish on the trace grid: one "
                f"full day of its schedule completes a negligible fraction "
                f"of {c.workload.n_scenarios:.0f} scenarios and the "
                "decision table is day-periodic — the schedule is stalled "
                "at zero intensity")

    # ---- lane layout -----------------------------------------------------
    lane_case: List[int] = []
    lane_member: List[int] = []
    lane_table: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
    lane_builder: List[Optional[Callable]] = []
    lane_periodic: List[bool] = []
    lane_co2: List[Tuple[Signal, ...]] = []
    case_expanded: List[bool] = []
    lane_group: List[int] = []
    for i, (c, comp, ens) in enumerate(zip(cases, compiled, ensembles)):
        sched = as_schedule(c.schedule)
        expand = ens is not None and comp.carbon_dep
        if expand and np.isfinite(caps[case_group[i]]):
            raise ValueError(
                f"case {c.name()!r}: a carbon-consulting schedule under a "
                "carbon ensemble expands into per-member lanes, which "
                "cannot share a site cap (each member lane is an "
                "alternative scenario, not a concurrent campaign) — use a "
                "carbon-blind schedule, a single trace, or drop the cap")
        case_expanded.append(expand)
        members = range(E) if expand else (0,)
        for e in members:
            lane_case.append(i)
            lane_group.append(int(case_group[i]))
            lane_member.append(e)
            if expand:
                # per-member decisions: rebuild the table (or builder)
                # against member e's carbon signal
                sig_e = carbon_signal(ens.member(e))
                if comp.periodic:
                    lane_table.append(
                        comp.table if comp.prof is not None else
                        _day_table(c, sched, comp.probe, sig_e, price,
                                   sph, B))
                    lane_builder.append(None)
                else:
                    lane_table.append(None)
                    lane_builder.append(_chunk_table_builder(
                        c, sched, comp.probe, sig_e, price, sph, B))
                # the member's own trace carbonizes every ensemble column
                # (summarize reads the diagonal lane e / member e)
                lane_co2.append(tuple(carbon_signal(ens.member(e))
                                      for _ in range(E)))
            else:
                if comp.periodic:
                    lane_table.append(comp.table)
                    lane_builder.append(None)
                else:
                    lane_table.append(None)
                    lane_builder.append(_chunk_table_builder(
                        c, sched, comp.probe, dec_sigs[i], price, sph, B))
                if ens is not None:
                    lane_co2.append(tuple(carbon_signal(ens.member(e2))
                                          for e2 in range(E)))
                else:
                    lane_co2.append(tuple(dec_sigs[i] for _ in range(E)))
            lane_periodic.append(comp.periodic)

    lc = np.asarray(lane_case, dtype=int)
    wl = [cases[i].workload for i in lane_case]
    mach = [cases[i].machine for i in lane_case]
    start = np.array([cases[i].start_hour for i in lane_case], dtype=float)
    g0 = np.floor(start * sph) / sph
    # periodic decision tables, stacked once so the per-chunk assembly is
    # one fancy-index slice instead of a per-lane Python loop
    L = len(lane_case)
    B_t = max((t[0].shape[1] for t in lane_table if t is not None),
              default=1)
    tab_u = np.zeros((L, H, B_t))
    tab_b = np.ones((L, H, B_t))
    for lane, t in enumerate(lane_table):
        if t is not None:
            u_r, b_r = t
            tab_u[lane] = u_r if u_r.shape[1] == B_t \
                else np.broadcast_to(u_r, (H, B_t))
            tab_b[lane] = b_r if b_r.shape[1] == B_t \
                else np.broadcast_to(b_r, (H, B_t))
    return SweepPlan(
        cases=tuple(cases), price=price, sph=sph, B=B, max_days=int(max_days),
        E=E, case_ensemble=ensembles, case_expanded=case_expanded,
        lane_case=lc, lane_member=np.asarray(lane_member, dtype=int),
        lane_table=lane_table, lane_builder=lane_builder,
        lane_periodic=np.asarray(lane_periodic, dtype=bool),
        tab_u=tab_u, tab_b=tab_b, tab_buckets=B_t,
        lane_co2_sigs=lane_co2,
        n_scen=np.array([float(w.n_scenarios) for w in wl]),
        rate=np.array([w.rate_at_full for w in wl]),
        oh=np.array([w.batch_overhead_s for w in wl]),
        idle=np.array([m.idle_w for m in mach]),
        dyn=np.array([m.dyn_w for m in mach]),
        alpha=np.array([m.alpha for m in mach]),
        gamma=np.array([m.gamma for m in mach]),
        ohfrac=np.array([m.overhead_w_frac for m in mach]),
        start=start, g0=g0,
        s0=np.round(g0 * sph).astype(int) % H,
        bg_day=np.stack([_bg_table(cases[i].bands, sph)
                         for i in lane_case]),
        est_h=max(comp.est_h for comp in compiled),
        precision=precision,
        group_sizes=group_sizes, case_group=case_group,
        lane_group=np.asarray(lane_group, dtype=int),
        group_cap_kw=caps, group_office_kw=office)


def _normalize_replace_maps(plan: SweepPlan, schedules, carbon
                            ) -> Tuple[Dict[int, object], Dict[int, object]]:
    """Normalize `replace_tables`/`delta_sweep` deltas to index maps:
    `schedules` may be a mapping {case index -> schedule}, a per-case
    sequence (None = keep), or — for 1-case plans — a bare schedule;
    `carbon` a mapping {case index -> signal}, one signal applied to
    every case, or a per-case sequence."""
    n = len(plan.cases)
    sched_map: Dict[int, object] = {}
    if schedules is not None:
        if hasattr(schedules, "items"):
            sched_map = {int(i): s for i, s in schedules.items()}
        elif callable(getattr(schedules, "decide", None)) or \
                callable(getattr(schedules, "decide_grid", None)):
            if n != 1:
                raise ValueError(
                    f"a bare schedule is ambiguous for a {n}-case plan; "
                    "pass a mapping {case index: schedule} or a per-case "
                    "sequence")
            sched_map = {0: schedules}
        else:
            seq = list(schedules)
            if len(seq) != n:
                raise ValueError(
                    f"schedules sequence needs one entry per case ({n}), "
                    f"got {len(seq)}")
            sched_map = {i: s for i, s in enumerate(seq) if s is not None}
    carbon_map: Dict[int, object] = {}
    if carbon is not None:
        if hasattr(carbon, "items") and not callable(
                getattr(carbon, "at", None)):
            carbon_map = {int(i): c for i, c in carbon.items()}
        elif isinstance(carbon, (list, tuple)) and not callable(
                getattr(carbon, "at", None)):
            if len(carbon) != n:
                raise ValueError(
                    f"carbon sequence needs one entry per case ({n}), "
                    f"got {len(carbon)}")
            carbon_map = {i: c for i, c in enumerate(carbon)
                          if c is not None}
        else:
            carbon_map = {i: carbon for i in range(n)}
    for i in list(sched_map) + list(carbon_map):
        if not 0 <= i < n:
            raise ValueError(f"case index {i} out of range for a "
                             f"{n}-case plan")
    return sched_map, carbon_map


def replace_tables(plan: SweepPlan, cursor: Optional[PlanCursor] = None, *,
                   schedules=None, carbon=None,
                   cache_dir: Optional[str] = None) -> SweepPlan:
    """Swap decision tables and/or carbon signals on an in-flight plan.

    The MPC re-plan primitive: given a plan paused at `cursor`, return a
    new `SweepPlan` whose changed cases carry fresh decision tables (and
    optionally new carbon signals) while every *unchanged* lane keeps its
    compiled tables, builders, and incrementally-sampled signal grids —
    nothing already classified, lowered, or executed is redone.  Resume
    with `execute_interval(new_plan, cursor)`: the carried state is valid
    because the lane layout is preserved (enforced below).

    `schedules` is a mapping {case index -> schedule} or a sequence with
    one entry per case (None = keep); `carbon` is one signal applied to
    every changed-carbon case or a per-case sequence (None = keep).  A
    case's ensemble width and lane expansion must not change — an
    in-flight lane is a scan row with carried state and cannot be split
    or merged mid-campaign.

    Changed cases are re-classified through the layered plan cache
    (`plan_hits`/`plan_misses`/`disk_hits` account it; `cache_dir`
    resolves like `compile_plan`'s); `scan_stats().replans` counts
    each call and `slots_reused` accumulates `cursor.t0 * n_lanes` — the
    lane x slot units of executed state carried forward instead of
    recomputed.
    """
    sched_map, carbon_map = _normalize_replace_maps(plan, schedules, carbon)
    changed = sorted(set(sched_map) | set(carbon_map))
    _STATS.replans += 1
    if cursor is not None:
        if len(cursor.state.remaining) != plan.n_lanes:
            raise ValueError(
                f"cursor carries {len(cursor.state.remaining)} lanes but "
                f"the plan has {plan.n_lanes}")
        _STATS.slots_reused += int(cursor.t0) * plan.n_lanes
    if not changed:
        return plan

    H = 24 * plan.sph
    max_hours = float(plan.max_days) * 24.0
    new_cases = list(plan.cases)
    ensembles = list(plan.case_ensemble)
    lane_table = list(plan.lane_table)
    lane_builder = list(plan.lane_builder)
    lane_periodic = plan.lane_periodic.copy()
    lane_co2 = list(plan.lane_co2_sigs)
    est_h = plan.est_h
    cache = plancache.get_cache(cache_dir)
    memo: dict = {}
    for i in changed:
        case = plan.cases[i]
        lanes = np.flatnonzero(plan.lane_case == i)
        new_carb = carbon_map.get(i, case.carbon)
        if i in carbon_map:
            ens_new = (new_carb if isinstance(new_carb, SignalEnsemble)
                       else None)
            old_e = len(ensembles[i]) if ensembles[i] is not None else 1
            new_e = len(ens_new) if ens_new is not None else 1
            if (ens_new is None) != (ensembles[i] is None) or old_e != new_e:
                raise ValueError(
                    f"case {case.name()!r}: replacing a "
                    f"{old_e}-member carbon with a {new_e}-member one "
                    "would change the plan's lane/ensemble layout; "
                    "re-plans must keep the ensemble width")
            ensembles[i] = ens_new
        ens = ensembles[i]
        new_case = dataclasses.replace(
            case, schedule=sched_map.get(i, case.schedule), carbon=new_carb)
        new_cases[i] = new_case
        sched = as_schedule(new_case.schedule)
        if ens is not None:
            dec_sig = carbon_signal(ens.member(0))
        elif new_case.carbon is not None:
            dec_sig = carbon_signal(new_case.carbon)
        else:
            # default-grid case: keep the plan's existing shared signal
            dec_sig = lane_co2[int(lanes[0])][0]
        key = _fingerprint(new_case, plan.price, plan.sph, plan.B,
                           plan.max_days, memo)
        comp = _obtain_case(new_case, dec_sig, plan.price, plan.sph,
                            plan.B, max_hours, key, cache)
        if comp.stalled:
            raise RuntimeError(
                f"case {new_case.name()!r}: the replacement schedule is "
                "stalled at zero intensity (one full day completes a "
                "negligible fraction of the workload)")
        expand = ens is not None and comp.carbon_dep
        if expand != plan.case_expanded[i]:
            raise ValueError(
                f"case {new_case.name()!r}: the replacement schedule "
                f"{'consults' if expand else 'ignores'} the carbon signal "
                "under an ensemble, which would "
                f"{'expand' if expand else 'collapse'} its lanes; "
                "re-plans must keep the lane layout")
        est_h = max(est_h, comp.est_h)
        for lane in lanes:
            lane = int(lane)
            e = int(plan.lane_member[lane])
            if expand:
                sig_e = carbon_signal(ens.member(e))
                if comp.periodic:
                    lane_table[lane] = (
                        comp.table if comp.prof is not None else
                        _day_table(new_case, sched, comp.probe, sig_e,
                                   plan.price, plan.sph, plan.B))
                    lane_builder[lane] = None
                else:
                    lane_table[lane] = None
                    lane_builder[lane] = _chunk_table_builder(
                        new_case, sched, comp.probe, sig_e, plan.price,
                        plan.sph, plan.B)
                lane_co2[lane] = tuple(carbon_signal(ens.member(e))
                                       for _ in range(plan.E))
            else:
                if comp.periodic:
                    lane_table[lane] = comp.table
                    lane_builder[lane] = None
                else:
                    lane_table[lane] = None
                    lane_builder[lane] = _chunk_table_builder(
                        new_case, sched, comp.probe, dec_sig, plan.price,
                        plan.sph, plan.B)
                if ens is not None:
                    lane_co2[lane] = tuple(carbon_signal(ens.member(e2))
                                           for e2 in range(plan.E))
                else:
                    lane_co2[lane] = tuple(dec_sig
                                           for _ in range(plan.E))
            lane_periodic[lane] = comp.periodic

    # restack the periodic tables (cheap NumPy; no classification)
    L = plan.n_lanes
    B_t = max((t[0].shape[1] for t in lane_table if t is not None),
              default=1)
    tab_u = np.zeros((L, H, B_t))
    tab_b = np.ones((L, H, B_t))
    for lane, t in enumerate(lane_table):
        if t is not None:
            u_r, b_r = t
            tab_u[lane] = u_r if u_r.shape[1] == B_t \
                else np.broadcast_to(u_r, (H, B_t))
            tab_b[lane] = b_r if b_r.shape[1] == B_t \
                else np.broadcast_to(b_r, (H, B_t))
    # grids dict is shared by reference: unchanged signals keep their
    # incrementally-sampled prefixes, so resuming re-samples nothing
    return dataclasses.replace(
        plan, cases=tuple(new_cases), case_ensemble=ensembles,
        lane_table=lane_table, lane_builder=lane_builder,
        lane_periodic=lane_periodic, tab_u=tab_u, tab_b=tab_b,
        tab_buckets=B_t, lane_co2_sigs=lane_co2, est_h=est_h)


def _value_changed(old, new) -> bool:
    """True unless `new` provably carries the same value identity as
    `old` (same object, or equal `_freeze` fingerprints).  Opaque
    components (closures) are always treated as changed — correctness
    over splicing."""
    if old is new:
        return False
    try:
        return _freeze(old) != _freeze(new)
    except _Opaque:
        return True


def _subset_plan(plan: SweepPlan, case_idx: Sequence[int]) -> SweepPlan:
    """A `SweepPlan` over a case subset, sliced — not recompiled — from
    `plan`: tables, builders, physics scalars, and the incrementally
    sampled signal `grids` (shared by reference) all carry over, so
    building the subset does zero classification or lowering work.
    Coupled groups must be included whole (their lanes interact through
    the site cap every slot); per-lane scan results are unchanged by
    the subsetting, exactly as with finished-lane compaction."""
    idx = np.asarray(sorted(int(i) for i in case_idx), dtype=int)
    keep = np.zeros(len(plan.cases), dtype=bool)
    keep[idx] = True
    for g in sorted({int(plan.case_group[i]) for i in idx}):
        if np.isfinite(plan.group_cap_kw[g]):
            members = np.flatnonzero(plan.case_group == g)
            if not keep[members].all():
                raise ValueError(
                    f"coupled group {g} must be subset whole: its lanes "
                    "share the site cap every slot")
    case_pos = {int(i): j for j, i in enumerate(idx)}
    lanes = np.flatnonzero(np.isin(plan.lane_case, idx))
    old_groups = sorted({int(plan.case_group[i]) for i in idx})
    gmap = {g: k for k, g in enumerate(old_groups)}
    ga = np.asarray(old_groups, dtype=int)
    return dataclasses.replace(
        plan,
        cases=tuple(plan.cases[i] for i in idx),
        case_ensemble=[plan.case_ensemble[i] for i in idx],
        case_expanded=[plan.case_expanded[i] for i in idx],
        lane_case=np.array([case_pos[int(c)]
                            for c in plan.lane_case[lanes]], dtype=int),
        lane_member=plan.lane_member[lanes],
        lane_table=[plan.lane_table[int(ln)] for ln in lanes],
        lane_builder=[plan.lane_builder[int(ln)] for ln in lanes],
        lane_periodic=plan.lane_periodic[lanes],
        tab_u=plan.tab_u[lanes], tab_b=plan.tab_b[lanes],
        lane_co2_sigs=[plan.lane_co2_sigs[int(ln)] for ln in lanes],
        n_scen=plan.n_scen[lanes], rate=plan.rate[lanes],
        oh=plan.oh[lanes], idle=plan.idle[lanes], dyn=plan.dyn[lanes],
        alpha=plan.alpha[lanes], gamma=plan.gamma[lanes],
        ohfrac=plan.ohfrac[lanes], start=plan.start[lanes],
        g0=plan.g0[lanes], s0=plan.s0[lanes], bg_day=plan.bg_day[lanes],
        group_sizes=tuple(
            int(np.isin(np.flatnonzero(plan.case_group == g), idx).sum())
            for g in old_groups),
        case_group=np.array([gmap[int(plan.case_group[i])] for i in idx],
                            dtype=int),
        lane_group=np.array([gmap[int(g)] for g in plan.lane_group[lanes]],
                            dtype=int),
        group_cap_kw=plan.group_cap_kw[ga],
        group_office_kw=plan.group_office_kw[ga],
        grids=plan.grids)


@dataclasses.dataclass
class DeltaSweepResult:
    """One incremental re-sweep: per-case `SimResult`s for the whole
    batch (`results`, order preserved), the updated plan to delta
    against next cycle (`plan`), and the case-index partition into
    re-scanned (`recomputed`) vs prev-result-spliced (`spliced`)."""
    results: List[SimResult]
    plan: SweepPlan
    recomputed: Tuple[int, ...]
    spliced: Tuple[int, ...]


def delta_sweep(prev_plan: SweepPlan, prev_results: Sequence[SimResult], *,
                schedules=None, carbon=None,
                backend: Optional[str] = None,
                chunk_days: Optional[int] = None,
                devices: Optional[int] = None,
                cache_dir: Optional[str] = None,
                device=None) -> DeltaSweepResult:
    """Re-sweep a recurring batch incrementally: re-scan only the cases
    a delta actually affects and splice last cycle's `SimResult`s for
    the rest.

    The recurrence primitive: given last cycle's compiled plan and its
    results, plus this cycle's delta — `schedules` (mapping {case index
    -> schedule} or per-case sequence, None = keep) and/or `carbon`
    (one signal for every case or a per-case sequence) — return the
    full result list as if the whole batch had been re-swept.  Deltas
    are screened by value: a "changed" schedule or carbon signal that
    fingerprints identically to the incumbent is a no-op (its lanes are
    spliced, not re-scanned).  Changed cases re-lower through
    `replace_tables` — the ensemble width and lane expansion of every
    case must be preserved, exactly as for an in-flight re-plan — and
    re-execute from slot 0 as a fresh cycle on a sliced subplan;
    results for them are bitwise-identical to a full re-sweep (lanes
    do not interact across groups, so subsetting is equivalent to the
    executor's finished-lane compaction).  A changed case inside a
    site-capped fleet group drags its whole group into the re-scan
    (coupled lanes share the cap every slot — splicing a member of a
    changed group would be wrong, not just stale).

    `scan_stats().lanes_recomputed`/`lanes_spliced` account the lane
    partition; with K changed schedules out of S the re-scanned slot
    work is ~K/S of a full re-sweep.  `cache_dir` resolves like
    `compile_plan`'s; `device` is where the re-scan runs (the card by
    default: K2, or K1 for a capped group); `devices` and `backend`
    raise unless left at their defaults (not ported yet).  Note a
    changed *carbon* signal affects every case it applies to even under
    carbon-blind schedules — the CO2 integral runs over the realized
    trace — so a new carbon window re-scans all of its cases; the
    savings there come from the plan cache (tables and classification
    are reused), not from splicing.
    """
    reject_unported(devices=devices, backend=backend)
    prev_results = list(prev_results)
    n = len(prev_plan.cases)
    if len(prev_results) != n:
        raise ValueError(
            f"prev_results carries {len(prev_results)} results but the "
            f"plan has {n} cases — pass last cycle's full result list")
    sched_map, carbon_map = _normalize_replace_maps(prev_plan, schedules,
                                                    carbon)
    sched_map = {i: s for i, s in sched_map.items()
                 if _value_changed(prev_plan.cases[i].schedule, s)}
    carbon_map = {i: c for i, c in carbon_map.items()
                  if _value_changed(prev_plan.cases[i].carbon, c)}
    new_plan = replace_tables(prev_plan, None,
                              schedules=sched_map or None,
                              carbon=carbon_map or None,
                              cache_dir=cache_dir)
    affected = set(sched_map) | set(carbon_map)
    # lane-group revalidation: a changed member of a site-capped group
    # invalidates the whole group's scan, not just its own lane
    for g in sorted({int(new_plan.case_group[i]) for i in affected}):
        if np.isfinite(new_plan.group_cap_kw[g]):
            affected.update(
                int(i) for i in np.flatnonzero(new_plan.case_group == g))
    if not affected:
        _STATS.lanes_spliced += new_plan.n_lanes
        return DeltaSweepResult(results=prev_results, plan=new_plan,
                                recomputed=(), spliced=tuple(range(n)))
    sub = sorted(affected)
    subplan = _subset_plan(new_plan, sub)
    _STATS.lanes_recomputed += subplan.n_lanes
    _STATS.lanes_spliced += new_plan.n_lanes - subplan.n_lanes
    state = execute_plan(subplan, chunk_days=chunk_days, device=device)
    sub_results = summarize_plan(subplan, state)
    results = prev_results
    for j, i in enumerate(sub):
        results[i] = sub_results[j]
    return DeltaSweepResult(
        results=results, plan=new_plan, recomputed=tuple(sub),
        spliced=tuple(i for i in range(n) if i not in affected))


# ---------------------------------------------------------------------------
# Incremental signal grids: every grid slot of every (signal, offset)
# pair is sampled exactly once per plan; appended chunks only sample the
# new tail (the old engine re-sampled every signal per case per retry).
# ---------------------------------------------------------------------------
def _sig_slice(plan: SweepPlan, sig, g0: float, t0: int,
               C: int) -> np.ndarray:
    key = (id(sig), float(g0))
    vals = plan.grids.get(key)
    have = 0 if vals is None else len(vals)
    if have < t0 + C:
        t_abs = g0 + np.arange(have, t0 + C) / plan.sph
        tail = sample_signal(sig, t_abs)
        vals = tail if vals is None else np.concatenate([vals, tail])
        plan.grids[key] = vals
    return vals[t0:t0 + C]


def _pad_pow2(n: int, minimum: int = 8) -> int:
    return max(minimum, 1 << max(n - 1, 0).bit_length())


def _plan_dtypes(plan: SweepPlan) -> Tuple[torch.dtype, torch.dtype]:
    """(compute, state) dtypes of the plan's precision policy: the
    per-slot physics inputs (tables, series, machine scalars) run in the
    compute dtype; the carried state, `remaining` included, stays
    float64 — an fp32 `remaining` compounds per-slot rounding into the
    slot-time trajectory and breaks the mixed policy's 1e-6 bar."""
    if plan.precision == "mixed":
        return torch.float32, torch.float64
    return torch.float64, torch.float64


def _dev(a: np.ndarray, dtype: torch.dtype, device: torch.device
         ) -> torch.Tensor:
    """Host array -> contiguous tensor of `dtype` on `device` (counted)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                     dtype=dtype)
    _STATS.copy_bytes += t.numel() * t.element_size()
    return t


def _host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host float64 array (counted)."""
    a = t.detach().to("cpu").numpy()
    _STATS.copy_bytes += a.nbytes
    return a


def _lane_scalars(plan: SweepPlan, active: np.ndarray) -> tuple:
    return tuple(arr[active] for arr in
                 (plan.n_scen, plan.rate, plan.oh, plan.idle, plan.dyn,
                  plan.alpha, plan.gamma, plan.ohfrac))


def _run_chunk(plan: SweepPlan, active: np.ndarray, inputs, state_slices,
               device: torch.device) -> tuple:
    """Execute one chunk for the active lanes through K2 (site-coupled
    plans route to `_run_chunk_coupled`).  Lanes are independent, so no
    padding is needed: the kernel takes any lane count."""
    if plan.coupled:
        return _run_chunk_coupled(plan, active, inputs, state_slices, device)
    u_tab, b_tab, rowidx, bg, cf, pr, lens = inputs
    A, C = rowidx.shape
    cdt, adt = _plan_dtypes(plan)
    _STATS.chunks += 1
    _STATS.slot_work += A * C
    out = _k2.scan_chunk(
        _dev(u_tab, cdt, device), _dev(b_tab, cdt, device),
        _dev(rowidx, torch.int32, device), _dev(bg, cdt, device),
        _dev(cf, cdt, device), _dev(pr, cdt, device),
        _dev(lens, cdt, device),
        *(_dev(a, adt, device) for a in state_slices),
        *(_dev(a, cdt, device) for a in _lane_scalars(plan, active)),
        B=u_tab.shape[2])
    return tuple(_host(o) for o in out)


def _run_chunk_coupled(plan: SweepPlan, active: np.ndarray, inputs,
                       state_slices, device: torch.device) -> tuple:
    """One chunk through the site-coupled kernel K1.

    Active lanes' groups are remapped to dense ids (finished groups drop
    out with their lanes), the lanes are repacked into a dense
    (group, lane-in-group) layout with the per-slot decision rows
    pre-gathered — the layout the reference builds for its Pallas
    kernel — and the results scatter back to flat lane order.  Padded
    lanes carry the safe fills (remaining 0, n_scen 1, alpha 1), padded
    groups an infinite cap."""
    u_tab, b_tab, rowidx, bg, cf, pr, lens = inputs
    A, C = rowidx.shape
    uniq, first, gid = np.unique(plan.lane_group[active],
                                 return_index=True, return_inverse=True)
    Gd = len(uniq)
    cap_g = plan.group_cap_kw[uniq]
    # each group's office draw follows its own band background over the
    # chunk (group members share bands — validated at compile time)
    office = plan.group_office_kw[uniq][:, None] * bg[first]      # (Gd, C)
    cnt = np.bincount(gid, minlength=Gd)
    csum = np.concatenate([[0], np.cumsum(cnt)])
    pos = np.arange(A) - csum[gid]        # position within own group
    Lp = _pad_pow2(int(cnt.max()))
    Gp = _pad_pow2(Gd, minimum=1)

    def dense(a, fill=0.0):
        out = np.full((Gp, Lp) + a.shape[1:], fill, dtype=a.dtype)
        out[gid, pos] = a
        return out

    # hoist the per-lane dynamic row gather out of the kernel
    u_rows = np.take_along_axis(u_tab, rowidx[:, :, None], axis=1)
    b_rows = np.take_along_axis(b_tab, rowidx[:, :, None], axis=1)
    cap_p = np.pad(cap_g, (0, Gp - Gd), constant_values=np.inf)
    off_p = np.pad(office, ((0, Gp - Gd), (0, 0)))
    n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac = \
        _lane_scalars(plan, active)
    cdt, adt = _plan_dtypes(plan)
    _STATS.grouped_lanes += A
    _STATS.chunks += 1
    _STATS.slot_work += Gp * Lp * C
    out = _k1.coupled_chunk(
        _dev(dense(u_rows), cdt, device),
        _dev(dense(b_rows, 1.0), cdt, device),
        _dev(dense(bg), cdt, device), _dev(dense(cf), cdt, device),
        _dev(dense(pr), cdt, device),
        _dev(dense(lens, 3600.0 / plan.sph), cdt, device),
        _dev(cap_p, cdt, device), _dev(off_p, cdt, device),
        *(_dev(dense(a), adt, device) for a in state_slices),
        _dev(dense(n_scen, 1.0), cdt, device), _dev(dense(rate), cdt, device),
        _dev(dense(oh), cdt, device), _dev(dense(idle), cdt, device),
        _dev(dense(dyn), cdt, device), _dev(dense(alpha, 1.0), cdt, device),
        _dev(dense(gamma), cdt, device), _dev(dense(ohfrac), cdt, device),
        iters=model.SITE_THROTTLE_ITERS, finish_frac=_FINISH_FRAC)
    return tuple(_host(o)[gid, pos] for o in out)


def _chunk_inputs(plan: SweepPlan, active: np.ndarray, t0: int,
                  C: int) -> tuple:
    """Assemble the per-slot inputs for global slots [t0, t0 + C) of the
    active lanes: decision tables (padded to a common (R, B) bucket),
    row indices, background, carbon (per ensemble member), price and
    slot lengths — all batched NumPy, no per-slot Python."""
    H = 24 * plan.sph
    A = active.size
    slot = t0 + np.arange(C)
    s_rows = (plan.s0[active][:, None] + slot[None, :]) % H       # (A, C)
    bg = np.take_along_axis(plan.bg_day[active], s_rows, axis=1)
    lens = np.full((A, C), 3600.0 / plan.sph)
    if t0 == 0:
        lens[:, 0] = (plan.g0[active] + 1.0 / plan.sph
                      - plan.start[active]) * 3600.0

    # decision tables: periodic lanes come from the plan's precompiled
    # stack in one fancy-index slice; only chunk-built (elapsed-aware)
    # lanes pay per-lane Python here — typically the few stragglers
    has_tab = plan.lane_periodic[active]
    built_pos = np.flatnonzero(~has_tab)
    built = [plan.lane_builder[active[p]](t0, C) for p in built_pos]
    Bg = plan.tab_buckets
    R = H
    if built:
        R = max(R, C)
        Bg = max(Bg, max(u.shape[1] for u, _ in built))
    u_tab = np.zeros((A, R, Bg))
    b_tab = np.ones((A, R, Bg))
    tab_pos = np.flatnonzero(has_tab)
    if tab_pos.size:
        # (n, H, B_t) -> (n, H, Bg): last axis broadcasts when B_t == 1
        u_tab[tab_pos, :H, :] = plan.tab_u[active[tab_pos]]
        b_tab[tab_pos, :H, :] = plan.tab_b[active[tab_pos]]
    for p, (u_r, b_r) in zip(built_pos, built):
        rows = u_r.shape[0]
        u_tab[p, :rows] = np.broadcast_to(u_r, (rows, Bg)) \
            if u_r.shape[1] == 1 else u_r
        b_tab[p, :rows] = np.broadcast_to(b_r, (rows, Bg)) \
            if b_r.shape[1] == 1 else b_r
    rowidx = np.where(has_tab[:, None], s_rows,
                      np.arange(C)[None, :]).astype(np.int32)

    # signals: one grid lookup + one batched assignment per distinct
    # (signal, offset) pair, not one per lane
    cf = np.empty((A, plan.E, C))
    groups: Dict[tuple, list] = {}
    for k, lane in enumerate(active):
        g0 = float(plan.g0[lane])
        for e, sig in enumerate(plan.lane_co2_sigs[lane]):
            groups.setdefault((id(sig), g0), []).append((k, e, sig))
    for (_, g0), members in groups.items():
        vals = _sig_slice(plan, members[0][2], g0, t0, C)
        ks = np.fromiter((m[0] for m in members), int, len(members))
        es = np.fromiter((m[1] for m in members), int, len(members))
        cf[ks, es] = vals[None, :]
    if plan.price is not None:
        pr = np.empty((A, C))
        pgroups: Dict[float, list] = {}
        for k, lane in enumerate(active):
            pgroups.setdefault(float(plan.g0[lane]), []).append(k)
        for g0, ks in pgroups.items():
            pr[np.asarray(ks)] = _sig_slice(plan, plan.price, g0,
                                            t0, C)[None, :]
    else:
        pr = np.zeros((A, C))
    return u_tab, b_tab, rowidx, bg, cf, pr, lens


def _stall_diagnostic(plan: SweepPlan, lane: int, remaining: float) -> str:
    case = plan.cases[plan.lane_case[lane]]
    return (f"case {case.name()!r} made no progress over a full scanned "
            f"day on the trace grid (remaining {remaining:.0f} of "
            f"{plan.n_scen[lane]:.0f} scenarios); its schedule is "
            "stalled at zero intensity")


def execute_plan(plan: SweepPlan, *, chunk_days: Optional[int] = None,
                 mode: str = "chunked", device=None,
                 devices: Optional[int] = None,
                 backend: Optional[str] = None) -> _ScanState:
    """Run the scan over a compiled plan and return the final state.

    `mode="chunked"` (default) is the resumable scan: fixed-shape chunks
    are appended until every lane finishes, finished lanes are compacted
    out, and no slot is ever scanned twice.  `mode="monolithic"` keeps
    the previous engine behaviour — one scan sized by the duration
    estimate, re-run from t=0 with a doubled horizon on undershoot —
    for equivalence tests.

    `device` is where the chunks run: the card by default (the CUDA
    kernels), or `"cpu"` (their plain PyTorch versions).  `devices`
    (lane sharding over several cards) and `backend` are not ported yet
    and raise unless left at None (`devices=1` is accepted).  The scan's
    dtype policy is fixed at `compile_plan(precision=...)` time.

    Stall detection: provably-dead periodic tables are diagnosed at
    compile time; beyond that, the chunked executor raises the stall
    diagnostic as soon as a day-periodic lane completes a full scanned
    day with zero progress (the monolithic executor can only see
    zero-progress-from-t=0, so a schedule that stalls mid-campaign
    still scans to `max_days` there before the generic failure).
    """
    reject_unported(devices=devices, backend=backend)
    if mode not in ("chunked", "monolithic"):
        raise ValueError(f"unknown mode {mode!r}; use 'chunked' or "
                         "'monolithic'")
    if chunk_days is not None and int(chunk_days) < 1:
        raise ValueError(f"chunk_days must be >= 1, got {chunk_days}")
    if mode == "monolithic":
        dev = resolve_device(device)
        _STATS.precision_mode = plan.precision
        _STATS.device = str(dev)
        return _execute_monolithic(plan, dev)
    return execute_interval(plan, chunk_days=chunk_days,
                            device=device).state


def execute_interval(plan: SweepPlan, cursor: Optional[PlanCursor] = None, *,
                     until_slot: Optional[int] = None,
                     chunk_days: Optional[int] = None,
                     device=None) -> PlanCursor:
    """Advance the chunked scan from `cursor` (a fresh one when None) to
    `until_slot` (to completion when None) and return the new cursor.

    This is the resumable core of `execute_plan` exposed as a primitive.
    The input cursor is not mutated — its state arrays are copied — so
    callers can keep earlier cursors as snapshots.  Lanes that finish
    before `until_slot` compact out exactly as in `execute_plan`;
    stall detection and the `max_days` guard behave identically.  The
    state is copied to the device and back around every chunk (as the
    reference does), so a cursor is plain host arrays.
    """
    if chunk_days is not None and int(chunk_days) < 1:
        raise ValueError(f"chunk_days must be >= 1, got {chunk_days}")
    dev = resolve_device(device)
    _STATS.precision_mode = plan.precision
    _STATS.device = str(dev)
    H = 24 * plan.sph
    max_slots = plan.max_slots
    if cursor is None:
        cursor = new_cursor(plan)
    stop = max_slots if until_slot is None else min(int(until_slot),
                                                   max_slots)
    C = int(chunk_days or DEFAULT_CHUNK_DAYS) * H
    coupled = plan.coupled
    st = cursor.state
    remaining = st.remaining.copy()
    rt = st.runtime_s.copy()
    kwh = st.kwh.copy()
    co2 = st.co2.copy()
    cost = st.cost.copy()
    speak = st.site_kw_peak.copy() if st.site_kw_peak is not None else (
        np.zeros(plan.n_lanes) if coupled else None)
    active = cursor.active.copy()
    t0 = int(cursor.t0)
    while active.size and t0 < stop:
        C_eff = min(C, stop - t0)
        inputs = _chunk_inputs(plan, active, t0, C_eff)
        state = (remaining[active], rt[active], kwh[active], co2[active],
                 cost[active])
        if coupled:
            state = state + (speak[active],)
        before = remaining[active].copy()
        out = _run_chunk(plan, active, inputs, state, dev)
        if coupled:
            speak[active] = out[5]
        remaining[active], rt[active], kwh[active], co2[active], \
            cost[active] = out[:5]
        unfinished = (remaining[active]
                      > _FINISH_FRAC * plan.n_scen[active])
        if C_eff >= H:
            made = before - remaining[active]
            days = C_eff / H
            stalled = (unfinished & plan.lane_periodic[active]
                       & (made <= _STALL_FRAC_PER_DAY * days
                          * plan.n_scen[active]))
            if stalled.any():
                lane = int(active[np.flatnonzero(stalled)[0]])
                raise RuntimeError(_stall_diagnostic(
                    plan, lane, float(remaining[lane])))
        active = active[unfinished]
        t0 += C_eff
        if active.size and t0 >= max_slots:
            worst = int(active[np.argmax(remaining[active]
                                         / plan.n_scen[active])])
            case = plan.cases[plan.lane_case[worst]]
            raise RuntimeError(
                f"case {case.name()!r} did not finish within "
                f"max_days={plan.max_days} on the trace grid (remaining "
                f"{remaining[worst]:.0f} of {plan.n_scen[worst]:.0f} "
                "scenarios); its schedule may be stalled at zero intensity")
    return PlanCursor(state=_ScanState(remaining, rt, kwh, co2, cost, speak),
                      t0=t0, active=active)


def _execute_monolithic(plan: SweepPlan,
                        device: torch.device) -> _ScanState:
    """The pre-chunking behaviour: scan everything from t=0 over one
    estimated horizon, double and re-scan on undershoot."""
    H = 24 * plan.sph
    L = plan.n_lanes
    max_slots = plan.max_slots
    all_lanes = np.arange(L)
    T = int(math.ceil(min(plan.est_h, plan.max_days * 24.0) * plan.sph))
    while True:
        inputs = _chunk_inputs(plan, all_lanes, 0, T)
        state = (plan.n_scen.copy(), np.zeros(L), np.zeros(L),
                 np.zeros((L, plan.E)), np.zeros(L))
        if plan.coupled:
            state = state + (np.zeros(L),)
        out = _run_chunk(plan, all_lanes, inputs, state, device)
        remaining = out[0]
        if (remaining <= _FINISH_FRAC * plan.n_scen).all():
            return _ScanState(*out)
        if T >= H:
            made = plan.n_scen - remaining
            stalled = ((remaining > _FINISH_FRAC * plan.n_scen)
                       & plan.lane_periodic
                       & (made <= _STALL_FRAC_PER_DAY * (T / H)
                          * plan.n_scen))
            if stalled.any():
                lane = int(np.flatnonzero(stalled)[0])
                raise RuntimeError(_stall_diagnostic(
                    plan, lane, float(remaining[lane])))
        if T >= max_slots:
            worst = int(np.argmax(remaining / plan.n_scen))
            case = plan.cases[plan.lane_case[worst]]
            raise RuntimeError(
                f"case {case.name()!r} did not finish within "
                f"max_days={plan.max_days} on the trace grid (remaining "
                f"{remaining[worst]:.0f} of {plan.n_scen[worst]:.0f} "
                "scenarios); its schedule may be stalled at zero intensity")
        T = min(T * 2, max_slots)


def summarize_plan(plan: SweepPlan, state: _ScanState) -> List[SimResult]:
    """Fold the final scan state into one `SimResult` per case.

    Deterministic cases report scalars; ensemble cases report ensemble
    means in the scalar columns plus per-member `EnsembleStats` for CO2
    (and for energy/runtime/cost too when the schedule's decisions
    consulted the carbon signal, i.e. the dynamics themselves varied).
    """
    has_price = plan.price is not None
    out: List[SimResult] = []
    for i, case in enumerate(plan.cases):
        lanes = np.flatnonzero(plan.lane_case == i)
        ens = plan.case_ensemble[i]
        if ens is None:
            lane = int(lanes[0])
            out.append(SimResult(
                policy=case.name(),
                runtime_h=float(state.runtime_s[lane]) / 3600.0,
                energy_kwh=float(state.kwh[lane]),
                co2_kg=float(state.co2[lane, 0]),
                cost_usd=float(state.cost[lane]) if has_price else None))
            continue
        if not plan.case_expanded[i]:
            lane = int(lanes[0])
            co2_samples = state.co2[lane]
            out.append(SimResult(
                policy=case.name(),
                runtime_h=float(state.runtime_s[lane]) / 3600.0,
                energy_kwh=float(state.kwh[lane]),
                co2_kg=float(co2_samples.mean()),
                cost_usd=float(state.cost[lane]) if has_price else None,
                co2_ensemble=ensemble_stats(co2_samples)))
            continue
        # carbon-dependent schedule: lane e ran member e's decisions, and
        # only its own member's CO2 column is meaningful (the diagonal)
        members = plan.lane_member[lanes]
        co2_samples = state.co2[lanes, members]
        rt_samples = state.runtime_s[lanes] / 3600.0
        kwh_samples = state.kwh[lanes]
        cost_samples = state.cost[lanes]
        out.append(SimResult(
            policy=case.name(),
            runtime_h=float(rt_samples.mean()),
            energy_kwh=float(kwh_samples.mean()),
            co2_kg=float(co2_samples.mean()),
            cost_usd=float(cost_samples.mean()) if has_price else None,
            co2_ensemble=ensemble_stats(co2_samples),
            energy_ensemble=ensemble_stats(kwh_samples),
            runtime_ensemble=ensemble_stats(rt_samples)))
    return out


# ---------------------------------------------------------------------------
# Differentiable objective path (the substrate of core/optimize.py).
#
# `trace_sweep` is built for *evaluation*: it probes schedules with Python
# `decide()` calls, classifies them, and extends the horizon.
# `TraceObjective` is the same physics specialized for *search*: everything
# that depends on the case (signals, background, slot lengths, machine
# scalars) is precomputed once, and what remains is a function
#     per-slot intensities (..., n_slots)  ->  EvalMetrics
# of torch tensors, differentiable, and one call evaluates a whole
# population.  On a CUDA tensor the scan is one launch of a hand-written
# kernel and its gradient one launch of another, behind a
# `torch.autograd.Function` (`kernels/objective_scan.py` K3 for
# `TraceObjective`, `kernels/fleet_objective.py` K4 for
# `FleetTraceObjective`); on a CPU tensor it is their plain PyTorch
# versions, differentiated by `torch.autograd`.
# ---------------------------------------------------------------------------
class EvalMetrics(NamedTuple):
    """Campaign outcome as a tuple of floats, arrays or tensors.

    `cost_usd` is 0 when no price signal was given; `unfinished` is the
    fraction of the workload left at the end of the horizon (0 when the
    campaign completed — optimizers penalize it so solutions that stall
    past the horizon are driven back into range).  When the case's
    carbon is a `SignalEnsemble`, `co2_kg` carries one trailing ensemble
    axis (..., E) — one value per member — while the other fields keep
    shape (...): the schedule family is carbon-blind, so the dynamics
    are identical across members and only the carbonization varies.
    `repro_torch.core.optimize.reduce_ensemble` collapses that axis under
    a robust objective (mean / CVaR / worst-case).
    """
    energy_kwh: Any
    co2_kg: Any
    runtime_h: Any
    cost_usd: Any
    unfinished: Any


def _to_numpy(metrics):
    """A metrics tuple of tensors as the same tuple of NumPy arrays."""
    return type(metrics)(*(x.detach().cpu().numpy() for x in metrics))


class TraceObjective:
    """One sweep case as a pure objective over day schedules.

    Construction samples the case's signals over a *fixed* horizon
    (`horizon_h`, default sized from a mid-intensity duration estimate or
    the case deadline) — there is no retry-doubling or probe
    classification afterwards.  `evaluate(u_day)` maps per-slot
    intensities of shape (..., n_slots) to `EvalMetrics` of shape (...,):
    on a tensor it is the differentiable scan on the tensor's device (a
    CUDA tensor: K3's forward kernel, and its backward kernel under
    `torch.autograd`; a CPU tensor: the plain version,
    `kernels/objective_scan.py`); on a NumPy array it runs the same scan
    on the objective's `device` (the card by default) and returns NumPy.

    A schedule that finishes inside the horizon gets exactly the numbers
    `trace_sweep` would produce for the equivalent `ParametricSchedule`
    (same grid, same shared rate model); one that does not reports
    `unfinished > 0` instead of growing the grid.

    A `SignalEnsemble` carbon turns `co2_kg` into a (..., E) block — the
    substrate of `Campaign.optimize(robust=...)`.

    `precision="mixed"` runs the per-slot inputs and physics in fp32 with
    fp64 carried state and kWh/CO2/cost sums (the policy of
    `compile_plan(precision=...)`); the default keeps exact fp64.
    `backend=` is the reference's and raises.
    """

    def __init__(self, case, *, price: Optional[Signal] = None,
                 slots_per_hour: int = 1, horizon_h: Optional[float] = None,
                 batch_size: float = 50.0, max_days: int = 120,
                 precision: str = "fp64", device=None,
                 backend: Optional[str] = None):
        reject_unported(backend=backend)
        if precision not in ("fp64", "mixed"):
            raise ValueError(f"unknown precision {precision!r}; "
                             "use 'fp64' or 'mixed'")
        self.device = resolve_device(device)
        sph = int(slots_per_hour)
        self.precision = precision
        self.case = case
        self.sph = sph
        self.n_slots = 24 * sph
        self.batch_size = float(batch_size)
        self.has_price = price is not None
        self._tables = {}

        wl, mach = case.workload, case.machine
        self._scalars = (float(wl.n_scenarios), float(wl.rate_at_full),
                         float(wl.batch_overhead_s), float(mach.idle_w),
                         float(mach.dyn_w), float(mach.alpha),
                         float(mach.gamma), float(mach.overhead_w_frac))

        carbon = case.carbon or GridCarbonModel()
        self.ensemble_size = (len(carbon)
                              if isinstance(carbon, SignalEnsemble) else 0)
        start = float(case.start_hour)
        g0 = math.floor(start * sph) / sph
        bg_day = _bg_table(case.bands, sph)
        if horizon_h is None:
            horizon_h = self._default_horizon(bg_day, max_days)
        self.horizon_h = float(min(horizon_h, max_days * 24.0))
        T = max(int(math.ceil(self.horizon_h * sph)), 1)
        slot = np.arange(T)
        t_abs = g0 + slot / sph
        s0 = int(round(g0 * sph)) % self.n_slots
        self.rowidx = ((s0 + slot) % self.n_slots).astype(np.int32)
        self.bg = bg_day[self.rowidx]
        if self.ensemble_size:
            self.cf = carbon.sample(t_abs)           # (E, T)
        else:
            self.cf = sample_signal(carbon_signal(carbon), t_abs)
        self.pr = (sample_signal(price, t_abs) if price is not None
                   else np.zeros(T))
        lens = np.full(T, 3600.0 / sph)
        lens[0] = (g0 + 1.0 / sph - start) * 3600.0
        self.lens = lens
        self.hours = t_abs                 # absolute hour of each slot

    def _default_horizon(self, bg_day: np.ndarray, max_days: int) -> float:
        """Mid-intensity duration estimate, stretched; or the deadline
        with margin, whichever is larger (deadline-capped optima sit at
        the cap, so the grid must comfortably cover it)."""
        n_scen, *_ = self._scalars
        r = model.campaign_rates(0.35, self.batch_size, float(bg_day.mean()),
                                 self.case.workload, self.case.machine)
        dur = n_scen / max(r.scen_per_s, 1e-9) / 3600.0
        est = dur * 1.6 + 48.0
        dl = float(getattr(self.case, "deadline_h", 0.0) or 0.0)
        if dl > 0.0:
            est = max(est, dl * 1.25 + 24.0)
        return min(est, max_days * 24.0)

    # ------------------------------------------------------------------
    def evaluate(self, u_day) -> EvalMetrics:
        """EvalMetrics for per-slot intensities `u_day` (..., n_slots).

        A tensor stays on its device and in the autograd graph (give it
        fp64, or the mixed policy's fp32 physics); a NumPy array runs on
        the objective's device and comes back as NumPy."""
        if isinstance(u_day, torch.Tensor):
            return _k3.trace_objective(self, u_day)
        return self.evaluate_batch(u_day)

    def evaluate_batch(self, U) -> EvalMetrics:
        """NumPy EvalMetrics for a NumPy (N, n_slots) population, in one
        pass on the objective's device."""
        U = torch.as_tensor(np.asarray(U, dtype=np.float64),
                            device=self.device)
        with torch.no_grad():
            return _to_numpy(_k3.trace_objective(self, U))

    # ------------------------------------------------------------------
    def _device_tables(self, device: torch.device) -> tuple:
        """(rowidx, bg, cf (T, E) or (T,), pr, lens) on `device` in the
        physics dtype; built once per device."""
        if device not in self._tables:
            cdt = (torch.float32 if self.precision == "mixed"
                   else torch.float64)
            cf = self.cf.T if self.ensemble_size else self.cf
            self._tables[device] = (
                torch.as_tensor(self.rowidx, dtype=torch.long, device=device),
                *(torch.as_tensor(a, dtype=cdt, device=device)
                  for a in (self.bg, cf, self.pr, self.lens)))
        return self._tables[device]


def evaluate_params(params, case, *, u_min: float = 0.05, u_max: float = 1.0,
                    batch_size: float = 50.0,
                    price: Optional[Signal] = None, slots_per_hour: int = 1,
                    horizon_h: Optional[float] = None, device=None,
                    backend: Optional[str] = None) -> EvalMetrics:
    """`EvalMetrics` (energy_kwh, co2_kg, runtime_h, cost_usd, unfinished)
    for `ParametricSchedule` logits `params` on `case`.

    Differentiable: the squash and the scan are both torch, so
    `torch.autograd.grad(evaluate_params(p, case).co2_kg, p)` just works
    for a tensor `p` (on its own device); NumPy logits run on `device` and
    come back as NumPy.  For repeated evaluation (optimization loops) build
    one `TraceObjective` instead — this convenience resamples the case's
    signals on every call.
    """
    on_tensor = isinstance(params, torch.Tensor)
    obj = TraceObjective(case, price=price, slots_per_hour=slots_per_hour,
                         horizon_h=horizon_h, batch_size=batch_size,
                         device=params.device if on_tensor else device,
                         backend=backend)
    if not on_tensor:
        params = np.asarray(params, dtype=float)
    return obj.evaluate(ParametricSchedule.u_from_logits(
        params, u_min, u_max, xp=torch if on_tensor else np))


class FleetEvalMetrics(NamedTuple):
    """Joint outcome of M concurrent campaigns: per-campaign fields carry
    a trailing (..., M) axis, `site_peak_kw` is the site-level (...,) peak
    total site draw (office + all campaigns) over the horizon, the
    quantity a `site_peak_kw <= cap` constraint caps."""
    energy_kwh: Any          # (..., M)
    co2_kg: Any              # (..., M)
    runtime_h: Any           # (..., M)
    cost_usd: Any            # (..., M)
    unfinished: Any          # (..., M)
    site_peak_kw: Any        # (...,)


class FleetTraceObjective:
    """M concurrent campaigns under one site as a pure objective.

    The fleet analogue of `TraceObjective`: construction samples the
    shared signals over a fixed horizon; `evaluate(u)` maps a joint
    intensity block of shape (..., M, n_slots) — campaign m's day
    schedule in row m — to `FleetEvalMetrics` of shape (..., M)/(...,).
    Each slot applies the one site-coupling definition
    (`model.site_throttle`): the summed active draw is compared to the
    site headroom (cap minus office draw, which follows the band
    background), every campaign's intensity is curtailed by the shared
    factor, and the physics re-evaluated — what the coupled chunk kernel
    (K1) and the sequential fleet oracle do, so optimized schedules
    report identically through the real engine.

    Differentiable end to end (the throttle's clamps and the running
    site-peak max split their gradient at a tie, as the reference's do),
    with the same strict finish-branch selection as `TraceObjective`: on
    a CUDA tensor through K4's forward and backward kernels, which run
    the slots in order (the activity mask is exact, no passes); on a CPU
    tensor through the plain version's mask passes
    (`kernels/fleet_objective.py`).  `site_cap_kw=None` evaluates the uncoupled fleet
    while still reporting `site_peak_kw`, so a planner can satisfy a peak
    cap by *scheduling* around it rather than relying on reactive
    curtailment.  Carbon ensembles are not taken (fleet robustness
    composes poorly with joint curtailment; sweep the optimized schedules
    against an ensemble instead).  A NumPy input runs on `device` (the
    card by default) and comes back as NumPy; `backend=` raises.
    """

    def __init__(self, cases: Sequence, *,
                 site_cap_kw: Optional[float] = None,
                 office_kw: float = 0.0,
                 price: Optional[Signal] = None,
                 slots_per_hour: int = 1,
                 horizon_h: Optional[float] = None,
                 batch_size: float = 50.0, max_days: int = 120,
                 device=None, backend: Optional[str] = None):
        reject_unported(backend=backend)
        if not len(cases):
            raise ValueError("FleetTraceObjective needs at least one case")
        if len({c.start_hour for c in cases}) > 1:
            raise ValueError("fleet campaigns share the site clock: all "
                             "cases must have the same start_hour")
        if len({c.bands for c in cases}) > 1:
            raise ValueError("fleet campaigns share the site's TimeBands "
                             "(one background/office curve); got differing "
                             "bands across cases")
        if any(isinstance(c.carbon, SignalEnsemble) for c in cases):
            raise ValueError("FleetTraceObjective does not take carbon "
                             "ensembles; optimize against one trace and "
                             "sweep the result against the ensemble")
        self.device = resolve_device(device)
        sph = int(slots_per_hour)
        self.cases = tuple(cases)
        self.M = len(cases)
        self.sph = sph
        self.n_slots = 24 * sph
        self.batch_size = float(batch_size)
        self.site_cap_kw = (float(site_cap_kw) if site_cap_kw is not None
                            else None)
        self.office_kw = float(office_kw)
        self.has_price = price is not None
        self._tables = {}
        self._grad_masks = {}   # the last gradient evaluation's mask

        case0 = cases[0]
        self._scalars = tuple(
            np.array([getattr(c.workload, wkey) for c in cases])
            for wkey in ("n_scenarios", "rate_at_full", "batch_overhead_s")
        ) + tuple(
            np.array([getattr(c.machine, mkey) for c in cases])
            for mkey in ("idle_w", "dyn_w", "alpha", "gamma",
                         "overhead_w_frac"))
        self.deadlines_h = np.array([float(c.deadline_h) for c in cases])

        carbon = case0.carbon or GridCarbonModel()
        start = float(case0.start_hour)
        g0 = math.floor(start * sph) / sph
        bg_day = _bg_table(case0.bands, sph)
        if horizon_h is None:
            horizon_h = self._default_horizon(bg_day, max_days)
        self.horizon_h = float(min(horizon_h, max_days * 24.0))
        T = max(int(math.ceil(self.horizon_h * sph)), 1)
        slot = np.arange(T)
        t_abs = g0 + slot / sph
        s0 = int(round(g0 * sph)) % self.n_slots
        self.rowidx = ((s0 + slot) % self.n_slots).astype(np.int32)
        self.bg = bg_day[self.rowidx]
        self.cf = sample_signal(carbon_signal(carbon), t_abs)
        self.pr = (sample_signal(price, t_abs) if price is not None
                   else np.zeros(T))
        lens = np.full(T, 3600.0 / sph)
        lens[0] = (g0 + 1.0 / sph - start) * 3600.0
        self.lens = lens
        self.office = self.office_kw * self.bg          # (T,) kW
        cap = np.inf if self.site_cap_kw is None else self.site_cap_kw
        self.headroom = cap - self.office               # (T,) kW

    def _default_horizon(self, bg_day: np.ndarray, max_days: int) -> float:
        """Slowest standalone campaign at mid intensity, stretched by the
        demanded-draw vs headroom ratio (a capped fleet runs longer than
        any member would alone), or the largest deadline with margin."""
        durs = []
        draw_kw = 0.0
        for c in self.cases:
            r = model.campaign_rates(0.35, self.batch_size,
                                     float(bg_day.mean()), c.workload,
                                     c.machine)
            durs.append(c.workload.n_scenarios
                        / max(r.scen_per_s, 1e-9) / 3600.0)
            draw_kw += r.p_avg_w / 1000.0
        stretch = 1.0
        if self.site_cap_kw is not None:
            head = max(self.site_cap_kw - self.office_kw * 0.3, 1e-9)
            stretch = max(draw_kw / head, 1.0)
        est = max(durs) * 1.6 * stretch + 48.0
        dl = float(self.deadlines_h.max(initial=0.0))
        if dl > 0.0:
            est = max(est, dl * 1.25 + 24.0)
        return min(est, max_days * 24.0)

    # ------------------------------------------------------------------
    def evaluate(self, u) -> FleetEvalMetrics:
        """`FleetEvalMetrics` for a joint intensity block (..., M,
        n_slots): differentiable on a tensor, NumPy in and out on an
        array."""
        if isinstance(u, torch.Tensor):
            return _k4.fleet_objective(self, u)
        return self.evaluate_batch(u)

    def evaluate_batch(self, U) -> FleetEvalMetrics:
        """NumPy metrics for a NumPy (N, M, n_slots) population, in one
        pass on the objective's device."""
        U = torch.as_tensor(np.asarray(U, dtype=np.float64),
                            device=self.device)
        with torch.no_grad():
            return _to_numpy(_k4.fleet_objective(self, U))

    # ------------------------------------------------------------------
    def _device_tables(self, device: torch.device) -> dict:
        """The signals (T,) and per-campaign scalars (M,) as fp64 tensors
        on `device`, built once per device."""
        if device not in self._tables:
            f64 = functools.partial(torch.as_tensor, dtype=torch.float64,
                                    device=device)
            (n_scen, rate, oh, idle, dyn, alpha, gamma,
             ohfrac) = (f64(a) for a in self._scalars)
            bg = f64(self.bg)
            self._tables[device] = dict(
                rowidx=torch.as_tensor(self.rowidx, dtype=torch.long,
                                       device=device),
                bg=bg, cf=f64(self.cf), pr=f64(self.pr), lens=f64(self.lens),
                office=f64(self.office), headroom=f64(self.headroom),
                # each campaign's non-sheddable draw per slot, kW (T, M)
                base=model.power_w(bg[:, None], idle, dyn, alpha,
                                   xp=model.TORCH) / 1000.0,
                n_scen=n_scen, finish=_FINISH_FRAC * n_scen,
                physics=dict(rate_at_full=rate, batch_overhead_s=oh,
                             idle_w=idle, dyn_w=dyn, alpha=alpha,
                             gamma=gamma, overhead_w_frac=ohfrac))
        return self._tables[device]

    def _rates(self, u, bg, tb) -> model.Rates:
        return model.rates(u, self.batch_size, bg, xp=model.TORCH,
                           **tb["physics"])

    def _pass(self, r, tb, shape) -> Tuple[FleetEvalMetrics, torch.Tensor]:
        """The plain version's scan pass (`_k4.pass_plain`)."""
        return _k4.pass_plain(r, tb, shape)


def trace_sweep(cases: Sequence, price: Optional[Signal] = None, *,
                slots_per_hour: int = 1, progress_buckets: int = 32,
                max_days: int = 120, chunk_days: Optional[int] = None,
                mode: str = "chunked",
                group_sizes: Optional[Sequence[int]] = None,
                group_caps_kw: Optional[Sequence[Optional[float]]] = None,
                group_office_kw: Optional[Sequence[float]] = None,
                precision: str = "fp64", device=None,
                devices: Optional[int] = None,
                backend: Optional[str] = None,
                cache_dir: Optional[str] = None) -> List[SimResult]:
    """Evaluate cases on the trace grid; order is preserved.

    Compile -> execute -> summarize (see the module docstring and
    `compile_plan`/`execute_plan`).  Use `repro_torch.core.engine.sweep`
    for mixed workloads: it keeps the periodic 24-slot path for cases
    that qualify and calls this for the rest.  `device` is where the
    chunks run (default the card); `cache_dir` resolves like
    `compile_plan`'s; `devices` and `backend` are accepted for the
    reference's signature and raise unless left at their defaults (not
    ported yet).
    """
    reject_unported(devices=devices, backend=backend)
    if not len(cases):
        return []
    plan = compile_plan(cases, price, slots_per_hour=slots_per_hour,
                        progress_buckets=progress_buckets, max_days=max_days,
                        group_sizes=group_sizes, group_caps_kw=group_caps_kw,
                        group_office_kw=group_office_kw,
                        precision=precision, cache_dir=cache_dir)
    state = execute_plan(plan, chunk_days=chunk_days, mode=mode,
                         device=device)
    return summarize_plan(plan, state)


# ---------------------------------------------------------------------------
# Carrying a lowered plan across from NumPy arrays
# ---------------------------------------------------------------------------
class _CarriedCase(NamedTuple):
    """Stand-in for a case of a plan built from arrays: only its name."""
    label: str

    def name(self) -> str:
        return self.label


_PLAN_ARRAYS = ("tab_u", "tab_b", "bg_day", "s0", "g0", "start", "n_scen",
                "rate", "oh", "idle", "dyn", "alpha", "gamma", "ohfrac")


def plan_from_numpy(fields: dict) -> SweepPlan:
    """A `SweepPlan` built from a lowered plan's arrays, so one lowering
    can be run through two executors.

    `fields` holds the reference plan's array fields as NumPy arrays —
    `tab_u`, `tab_b` (L, 24*sph, B), `bg_day` (L, 24*sph), `s0`, `g0`,
    `start`, `n_scen` and the physics scalars `rate`, `oh`, `idle`, `dyn`,
    `alpha`, `gamma`, `ohfrac` (L,) — plus `sph`, `max_days` and
    `precision`, and the signals as hourly samples from absolute hour 0:
    `carbon` (L, E, N) per lane and member, optional `price` (N,).
    Optional: `lane_case`/`lane_member` (default one case per lane),
    `lane_group`, `group_cap_kw`, `group_office_kw` (default uncoupled),
    `names` (one per case).  Every lane must have a day-periodic table
    (chunk-built lanes of elapsed-aware schedules are not carried), and
    sampling past hour N raises.  Summaries of such a plan report the
    first carbon member of every case (no ensemble statistics).
    """
    missing = [k for k in _PLAN_ARRAYS + ("carbon", "sph", "max_days")
               if k not in fields]
    if missing:
        raise ValueError(f"plan_from_numpy needs the fields {missing}")
    arr = {k: np.asarray(fields[k]) for k in _PLAN_ARRAYS}
    for k in ("tab_u", "tab_b", "bg_day", "start", "g0", "n_scen", "rate",
              "oh", "idle", "dyn", "alpha", "gamma", "ohfrac"):
        arr[k] = arr[k].astype(np.float64)
    arr["s0"] = arr["s0"].astype(int)
    L, H, B_t = arr["tab_u"].shape
    sph = int(fields["sph"])
    if H != 24 * sph:
        raise ValueError(f"tables have {H} rows; sph={sph} needs {24 * sph}")
    carbon = np.asarray(fields["carbon"], dtype=np.float64)
    if carbon.ndim != 3 or carbon.shape[0] != L:
        raise ValueError(f"carbon must be (L={L}, E, hours), got "
                         f"{carbon.shape}")
    E = carbon.shape[1]
    sigs = {}

    def trace(values, name):
        key = values.tobytes()
        if key not in sigs:          # shared objects dedup the grid sampling
            sigs[key] = TraceSignal(tuple(values.tolist()), name=name,
                                    pad="raise")
        return sigs[key]

    lane_co2 = [tuple(trace(carbon[i, e], f"carbon[{i},{e}]")
                      for e in range(E)) for i in range(L)]
    price = (trace(np.asarray(fields["price"], dtype=np.float64), "price")
             if fields.get("price") is not None else None)
    lane_case = np.asarray(fields.get("lane_case", np.arange(L)), dtype=int)
    n_cases = int(lane_case.max()) + 1 if L else 0
    names = list(fields.get("names") or [f"lane{i}" for i in range(n_cases)])
    lane_group = np.asarray(fields.get("lane_group", lane_case), dtype=int)
    G = int(lane_group.max()) + 1 if L else 0
    case_group = np.zeros(n_cases, dtype=int)
    case_group[lane_case] = lane_group
    caps = np.asarray(fields.get("group_cap_kw", np.full(G, np.inf)),
                      dtype=np.float64)
    office = np.asarray(fields.get("group_office_kw", np.zeros(G)),
                        dtype=np.float64)
    return SweepPlan(
        cases=tuple(_CarriedCase(n) for n in names), price=price, sph=sph,
        B=B_t, max_days=int(fields["max_days"]), E=E,
        case_ensemble=[None] * n_cases, case_expanded=[False] * n_cases,
        lane_case=lane_case,
        lane_member=np.asarray(fields.get("lane_member", np.zeros(L)),
                               dtype=int),
        lane_table=[(arr["tab_u"][i], arr["tab_b"][i]) for i in range(L)],
        lane_builder=[None] * L, lane_periodic=np.ones(L, dtype=bool),
        tab_u=arr["tab_u"], tab_b=arr["tab_b"], tab_buckets=B_t,
        lane_co2_sigs=lane_co2,
        n_scen=arr["n_scen"], rate=arr["rate"], oh=arr["oh"],
        idle=arr["idle"], dyn=arr["dyn"], alpha=arr["alpha"],
        gamma=arr["gamma"], ohfrac=arr["ohfrac"], start=arr["start"],
        g0=arr["g0"], s0=arr["s0"], bg_day=arr["bg_day"],
        est_h=float(fields.get("est_h", int(fields["max_days"]) * 24.0)),
        precision=str(fields.get("precision", "fp64")),
        group_sizes=tuple(int(c) for c in np.bincount(case_group,
                                                      minlength=G)),
        case_group=case_group, lane_group=lane_group,
        group_cap_kw=caps, group_office_kw=office)
