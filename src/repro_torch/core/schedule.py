"""The unified scheduling surface (Algorithm 1 line 6, generalized).

Everything that decides "how hard to work right now" — the six fixed
Figure-1 policies, the hourly carbon-aware factories, and any future
forecast-driven scheduler — implements one protocol:

    class Schedule(Protocol):
        name: str
        def decide(self, ctx: SchedulingContext) -> Decision

The context carries the local hour, the time band, and the current values
of every input Signal (background load, carbon intensity, price); the
decision carries worker intensity and orchestration batch size.  This
kills the `hasattr(policy, "intensity_at_hour")` duck typing that used to
be copy-pasted in both simulators and the controller.

Segmentation metadata: simulators and the vectorized engine need to know
when a schedule's decision can change.  `change_hours(schedule, bands)`
returns the sorted hour-of-day breakpoints (subset of [0, 24]); band
schedules change only at band edges, hourly schedules every hour, and
anything unknown conservatively every hour.  All bundled signals are
hourly-constant, so the hourly grid is always a safe refinement.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulingContext:
    """Everything a schedule may consult for one decision.

    The site-level fields describe the shared power envelope a fleet of
    concurrent campaigns runs under (core/fleet.py): `site_power_kw` is
    the total site draw (office + all campaigns) over the slot *entering*
    this decision, `site_headroom` the fraction of the site cap still
    free at that draw (1.0 when the site has no cap), and `n_active` the
    number of fleet campaigns with work remaining.  Standalone campaigns
    keep the defaults — a schedule written against them behaves
    identically with and without a fleet.  The site fields are exact in
    the sequential fleet oracle; the vectorized engines lower decisions
    to tables and do not feed live site state back into `decide()` (the
    cap coupling itself is physics, applied by the engine after
    decisions — see `model.site_throttle`).
    """
    hour_of_day: float           # local time, [0, 24)
    band: str                    # time band at this hour
    background: float            # background (office) load, [0, 1]
    carbon_factor: float         # grid intensity, kg CO2e / kWh
    price_usd_per_kwh: float = 0.0
    elapsed_h: float = 0.0       # hours since campaign start
    progress: float = 0.0        # fraction of the workload completed, [0, 1]
    deadline_h: float = 0.0      # campaign deadline in hours (0 = none)
    site_power_kw: float = 0.0   # site draw entering this slot (0 = unknown)
    site_headroom: float = 1.0   # free fraction of the site cap, [0, 1]
    n_active: int = 1            # fleet campaigns still running


@dataclasses.dataclass(frozen=True)
class Decision:
    """One scheduling decision: how hard to work and at what granularity."""
    intensity: float             # worker intensity u in [0, 1]
    batch_size: int = 50         # orchestration batch size
    note: str = ""               # free-form provenance (dashboards/logs)


@runtime_checkable
class Schedule(Protocol):
    """Anything with a name that can turn a context into a decision."""

    name: str

    def decide(self, ctx: SchedulingContext) -> Decision:
        ...


# ---------------------------------------------------------------------------
# Segmentation metadata
# ---------------------------------------------------------------------------
HOURLY_GRID: Tuple[float, ...] = tuple(float(h) for h in range(25))


def change_hours(schedule, bands) -> Tuple[float, ...]:
    """Sorted hours in [0, 24] at which `schedule`'s decision may change.

    Schedules may implement `change_hours(bands)` themselves (band policies
    return the band edges); anything else is assumed hourly-constant, which
    is exact for every bundled signal and schedule.
    """
    fn = getattr(schedule, "change_hours", None)
    if callable(fn):
        return tuple(fn(bands))
    return HOURLY_GRID


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------
class FunctionSchedule:
    """Wrap a plain `ctx -> intensity` callable as a Schedule."""

    def __init__(self, name: str, fn: Callable[[SchedulingContext], float],
                 batch_size: int = 50):
        self.name = name
        self._fn = fn
        self.batch_size = batch_size

    def decide(self, ctx: SchedulingContext) -> Decision:
        return Decision(float(self._fn(ctx)), self.batch_size)


@dataclasses.dataclass(frozen=True)
class DeadlineSchedule:
    """Pace-keeping deadline schedule (the related-work "deadline-aware
    shifting" pattern): run gently at `u_low` while ahead of the linear
    pace toward the deadline, ramp up to `u_high` as the campaign falls
    behind.

    The controller is proportional over a progress window of width
    `band` just ahead of the pace line: full boost at/behind pace, easing
    down to `u_low` once the campaign is `band` ahead — so feasible
    deadlines are met with a small margin rather than tracked from
    behind.  `band=0` degenerates to a bang-bang boost-when-behind
    switch, which is harsher on any discretized simulator — the
    proportional default is what the trace-grid engine's accuracy bar is
    pinned on.

    The deadline comes from the schedule's own `deadline_h` when given,
    else from `ctx.deadline_h` (so one schedule object can be swept
    against many deadlines via `Campaign.sweep(deadline_h=...)`).  With
    no deadline at all it runs flat-out at `u_high`.  Consults
    `ctx.progress`/`ctx.elapsed_h`, so it needs the sequential simulators
    or the trace-grid engine — the periodic 24-slot engine cannot
    represent it.

    Implements `decide_grid` (the vectorized decision protocol): engines
    may pass a SchedulingContext whose fields are broadcastable NumPy
    arrays and get the whole decision table back in one call, instead of
    sampling decide() once per (hour, progress-bucket) grid point.
    """
    deadline_h: float = 0.0
    u_low: float = 0.35
    u_high: float = 0.95
    band: float = 0.1
    batch_size: int = 50
    name: str = "deadline_pace"

    def _intensity(self, elapsed_h, progress, ctx_deadline_h):
        dl = self.deadline_h if self.deadline_h > 0.0 else ctx_deadline_h
        if dl <= 0.0:
            return np.broadcast_to(
                self.u_high, np.broadcast_shapes(np.shape(elapsed_h),
                                                 np.shape(progress)))
        pace = np.minimum(np.asarray(elapsed_h, dtype=float) / dl, 1.0)
        behind = pace - progress
        if self.band <= 0.0:
            return np.where(behind > 0.0, self.u_high, self.u_low)
        frac = np.clip(behind / self.band + 1.0, 0.0, 1.0)
        return self.u_low + (self.u_high - self.u_low) * frac

    def decide(self, ctx: SchedulingContext) -> Decision:
        return Decision(float(self._intensity(ctx.elapsed_h, ctx.progress,
                                              ctx.deadline_h)),
                        self.batch_size)

    def decide_grid(self, ctx: SchedulingContext):
        """(intensity, batch_size) arrays over a grid context."""
        u = self._intensity(ctx.elapsed_h, ctx.progress, ctx.deadline_h)
        return u, np.broadcast_to(float(self.batch_size), np.shape(u))


def deadline_schedule(deadline_h: float = 0.0, *, u_low: float = 0.35,
                      u_high: float = 0.95, band: float = 0.1,
                      batch_size: int = 50,
                      name: str = "") -> DeadlineSchedule:
    """A `DeadlineSchedule` with a readable default label."""
    label = name or (f"deadline_{deadline_h:g}h" if deadline_h
                     else "deadline_pace")
    return DeadlineSchedule(deadline_h, u_low, u_high, band, batch_size,
                            label)


def progress_ramp_schedule(u_start: float = 0.4, u_end: float = 0.9,
                           batch_size: int = 50,
                           name: str = "") -> FunctionSchedule:
    """Intensity ramping linearly with campaign progress — start gentle,
    finish hard.  Progress-aware, so trace-grid/sequential only."""

    def ramp(ctx: SchedulingContext) -> float:
        return u_start + (u_end - u_start) * min(max(ctx.progress, 0.0), 1.0)

    return FunctionSchedule(name or f"ramp_{u_start:g}_{u_end:g}", ramp,
                            batch_size)


def _sigmoid(z, xp=np):
    """Numerically stable logistic, polymorphic over the array namespace
    (tanh is bounded both directions, unlike the naive 1/(1+exp(-z)))."""
    return 0.5 * (xp.tanh(0.5 * z) + 1.0)


@dataclasses.dataclass(frozen=True)
class ParametricSchedule:
    """The optimizer's schedule family: one free intensity parameter per
    slot of the day, squashed through a sigmoid into [u_min, u_max].

    `logits[i]` controls the worker intensity over local hours
    `[24 i / n, 24 (i + 1) / n)` where `n = len(logits)`; the intensity is
    `u_min + (u_max - u_min) * sigmoid(logits[i])`, so every point of the
    parameter space is a feasible schedule and gradients never push
    intensities out of range.  `n` may exceed 24 for sub-hour resolution
    (48 -> half-hour slots); slot edges must align to a minute grid like
    band edges (n must divide a multiple of 24 up to 24*60).

    The family is deliberately *periodic and progress-free*: the decision
    depends on hour-of-day only, so it lowers to a decision table with no
    Python in the engines' hot loops.  `decide_grid` (the vectorized
    decision protocol) builds the whole table in one NumPy call;
    the reference engine's `TraceObjective` consumes the same
    `u_from_logits` mapping inside its gradient search (the optimizer
    is not part of this package yet).

    `from_intensities` inverts the squash (warm-starting the optimizer
    from a hand-written policy); `with_logits` rebinds parameters on an
    otherwise identical schedule (how the optimizer materializes its
    result).  A non-None `levels` snaps the materialized table to the
    nearest allowed intensity (exactly — membership tests against the
    level set hold; the squash cannot represent arbitrary values
    bit-exactly through a logit round trip), which is how the optimizer
    returns discrete decision tables.
    """
    logits: Tuple[float, ...]
    u_min: float = 0.05
    u_max: float = 1.0
    batch_size: int = 50
    name: str = "parametric"
    levels: Optional[Tuple[float, ...]] = None

    #: Contract flag for the trace engine's compiler: decisions depend on
    #: hour-of-day only (never elapsed/progress/carbon), so the decide_grid
    #: table may be lowered to one day-periodic block instead of being
    #: rebuilt per horizon chunk.  Custom decide_grid schedules may opt in
    #: by declaring the same attribute; without it they keep exact
    #: per-slot tables.
    periodic_decisions = True

    def __post_init__(self):
        n = len(self.logits)
        if n < 1:
            raise ValueError("ParametricSchedule needs at least one slot")
        if (24.0 * 60.0) % n:
            raise ValueError(
                f"n_slots={n} does not divide the day on a minute grid; "
                "use a divisor of 1440 (24, 48, 96, ...)")
        if not (0.0 <= self.u_min < self.u_max <= 1.0):
            raise ValueError(
                f"need 0 <= u_min < u_max <= 1, got ({self.u_min}, "
                f"{self.u_max})")
        # materialize the decision table once (frozen dataclass, so
        # decide() would otherwise recompute the sigmoid + level snap on
        # every sequential-simulator segment)
        u = self.u_from_logits(np.asarray(self.logits, dtype=float),
                               self.u_min, self.u_max, xp=np)
        if self.levels is not None:
            lv = np.asarray(self.levels, dtype=float)
            u = lv[np.argmin(np.abs(u[:, None] - lv[None, :]), axis=1)]
        object.__setattr__(self, "_table", u)

    # ---- parameter mapping (shared with the optimizer's objective) --------
    @staticmethod
    def u_from_logits(logits, u_min: float = 0.05, u_max: float = 1.0,
                      xp=np):
        """logits -> intensities in [u_min, u_max]; works for NumPy *and*
        any array namespace with `exp` via `xp` (the one definition the
        optimizer differentiates)."""
        return u_min + (u_max - u_min) * _sigmoid(logits, xp=xp)

    @classmethod
    def from_intensities(cls, intensities, *, u_min: float = 0.05,
                         u_max: float = 1.0, batch_size: int = 50,
                         name: str = "parametric") -> "ParametricSchedule":
        """Invert the squash: the ParametricSchedule whose table matches
        `intensities` (clipped into the open (u_min, u_max) interval)."""
        u = np.clip(np.asarray(intensities, dtype=float),
                    u_min + 1e-4 * (u_max - u_min),
                    u_max - 1e-4 * (u_max - u_min))
        frac = (u - u_min) / (u_max - u_min)
        return cls(tuple(float(v) for v in np.log(frac / (1.0 - frac))),
                   u_min=u_min, u_max=u_max, batch_size=batch_size,
                   name=name)

    def with_logits(self, logits, name: str = "") -> "ParametricSchedule":
        return dataclasses.replace(
            self, logits=tuple(float(v) for v in np.asarray(logits).ravel()),
            name=name or self.name)

    # ---- derived views ----------------------------------------------------
    @property
    def n_slots(self) -> int:
        return len(self.logits)

    def intensity_table(self) -> np.ndarray:
        """(n_slots,) intensities — the schedule as a decision table
        (snapped exactly onto `levels` when set)."""
        return self._table.copy()

    # ---- Schedule protocol ------------------------------------------------
    # Slot lookups add a half-ulp guard (+1e-9 slots) before flooring:
    # when 24/n_slots is not binary-representable (n_slots = 120, 240,
    # ...), a grid hour sitting exactly on a slot edge can compute as
    # 40.999999999999996 and truncate one slot low, breaking the 1e-9
    # engine-consistency contract with the sequential simulator.
    def decide(self, ctx: SchedulingContext) -> Decision:
        i = int((ctx.hour_of_day % 24.0) * self.n_slots / 24.0 + 1e-9)
        return Decision(float(self._table[min(i, self.n_slots - 1)]),
                        self.batch_size)

    def decide_grid(self, ctx: SchedulingContext):
        """Vectorized decision protocol: hour-of-day arrays in, the whole
        intensity table out (no Python in the engines' hot loops)."""
        hod = np.asarray(ctx.hour_of_day, dtype=float)
        idx = np.minimum(np.floor((hod % 24.0) * self.n_slots / 24.0 + 1e-9),
                         self.n_slots - 1).astype(int)
        u = self.intensity_table()[idx]
        return u, np.broadcast_to(float(self.batch_size), np.shape(u))

    def change_hours(self, bands) -> Tuple[float, ...]:
        """Slot edges: the engines refine their grid to align them (a
        48-slot schedule forces a half-hour trace grid)."""
        return tuple(24.0 * i / self.n_slots for i in range(self.n_slots + 1))


def parametric_schedule(n_slots: int = 24, *, init: float = 0.6,
                        u_min: float = 0.05, u_max: float = 1.0,
                        batch_size: int = 50,
                        name: str = "parametric") -> ParametricSchedule:
    """A flat ParametricSchedule at intensity `init` — the optimizer's
    default starting point."""
    return ParametricSchedule.from_intensities(
        np.full(n_slots, float(init)), u_min=u_min, u_max=u_max,
        batch_size=batch_size, name=name)


# ---------------------------------------------------------------------------
# Joint (fleet-level) scheduling
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CarbonGateSchedule:
    """Demand `u_high` while grid carbon is at or below `threshold`
    (kg CO2e/kWh), `u_low` above it — the per-member demand rule behind
    `carbon_gated_cap`: gating every member's demand on one shared
    carbon signal caps the whole fleet's draw in dirty hours.  Consults
    `ctx.carbon_factor`, so the trace compiler's probe classifies it
    carbon-dependent (per-member decision tables under an ensemble)."""
    threshold: float
    u_low: float = 0.15
    u_high: float = 0.95
    batch_size: int = 50
    name: str = "carbon_gate"

    def decide(self, ctx: SchedulingContext) -> Decision:
        u = self.u_high if ctx.carbon_factor <= self.threshold else self.u_low
        return Decision(float(u), self.batch_size)

    def decide_grid(self, ctx: SchedulingContext):
        u = np.where(np.asarray(ctx.carbon_factor) <= self.threshold,
                     self.u_high, self.u_low)
        u = np.broadcast_to(u, np.broadcast_shapes(np.shape(u),
                                                   np.shape(ctx.progress)))
        return u, np.broadcast_to(float(self.batch_size), np.shape(u))


@dataclasses.dataclass(frozen=True)
class AllocationSchedule:
    """A joint schedule: per-campaign intensities for a whole fleet.

    One `AllocationSchedule` covers M concurrent campaigns under a
    shared site (core/fleet.py).  It is two coupled halves:

      * **demand** — `members[m]` is campaign m's demand schedule (any
        ordinary `Schedule`; a single member broadcasts to every
        campaign).  `decide_joint(ctxs)` returns the demanded
        per-campaign decisions;
      * **allocation** — the realized intensities follow from the site's
        shared curtailment, `model.site_throttle`: when the demanded
        fleet draw exceeds the site headroom, every campaign is scaled
        by the same demand-proportional factor.  This is physics, not
        schedule code — the sequential fleet oracle and the grouped-lane
        engine both apply it after decisions, so a demand schedule runs
        identically under both.

    The bundled reference allocations compose existing demand families:
    `proportional_split` (flat equal demand — the cap splits headroom
    proportionally), `deadline_weighted_split` (per-member
    `DeadlineSchedule` pace-keepers — campaigns behind their deadline
    demand more and therefore win a larger share of a contended cap),
    and `carbon_gated_cap` (per-member `CarbonGateSchedule`s — the whole
    fleet's draw is gated on grid carbon).  `decide(ctx)` delegates to
    member 0 so an AllocationSchedule still satisfies the `Schedule`
    protocol (an M=1 fleet degenerates to a plain campaign).
    """
    members: Tuple[Schedule, ...]
    name: str = "allocation"

    def __post_init__(self):
        if len(self.members) < 1:
            raise ValueError("AllocationSchedule needs at least one member "
                             "demand schedule")

    def n_members(self) -> int:
        return len(self.members)

    def member_schedule(self, m: int) -> Schedule:
        """Campaign m's demand schedule (a single member broadcasts)."""
        if len(self.members) == 1:
            return self.members[0]
        return self.members[m]

    def for_fleet(self, n: int) -> Tuple[Schedule, ...]:
        """The M per-campaign demand schedules for an M-campaign fleet."""
        if len(self.members) not in (1, n):
            raise ValueError(
                f"AllocationSchedule {self.name!r} has {len(self.members)} "
                f"member schedules but the fleet has {n} campaigns; give "
                "one (broadcast) or exactly one per campaign")
        return tuple(self.member_schedule(m) for m in range(n))

    def decide(self, ctx: SchedulingContext) -> Decision:
        return self.members[0].decide(ctx)

    def decide_joint(self, ctxs) -> Tuple[Decision, ...]:
        """Demanded decisions for every campaign, one context each
        (contexts carry the site fields plus per-campaign progress/
        deadline).  Realized intensities are these demands scaled by the
        site curtailment factor — see `model.site_throttle`."""
        return tuple(self.member_schedule(m).decide(ctx)
                     for m, ctx in enumerate(ctxs))

    def change_hours(self, bands) -> Tuple[float, ...]:
        hs = set()
        for s in self.members:
            hs.update(change_hours(s, bands))
        return tuple(sorted(hs))


def proportional_split(u: float = 0.9, *, batch_size: int = 50,
                       name: str = "") -> AllocationSchedule:
    """Every campaign demands the same flat intensity; under a site cap
    the shared curtailment splits the headroom proportionally (equal
    demand -> equal share)."""
    from repro_torch.core.policy import constant_schedule
    return AllocationSchedule((constant_schedule(u, batch_size=batch_size),),
                              name=name or f"proportional_{u:g}")


def deadline_weighted_split(deadlines_h, *, u_low: float = 0.35,
                            u_high: float = 0.95, band: float = 0.1,
                            batch_size: int = 50,
                            name: str = "") -> AllocationSchedule:
    """Per-campaign `DeadlineSchedule` pace-keepers: a campaign behind
    its own deadline pace demands more, so a contended cap is split in
    favour of the urgent campaigns (demand-proportional curtailment
    turns demand weights into allocation weights)."""
    members = tuple(deadline_schedule(float(d), u_low=u_low, u_high=u_high,
                                      band=band, batch_size=batch_size)
                    for d in deadlines_h)
    return AllocationSchedule(members, name=name or "deadline_weighted")


def carbon_gated_cap(threshold: float, *, u_low: float = 0.15,
                     u_high: float = 0.95, batch_size: int = 50,
                     name: str = "") -> AllocationSchedule:
    """Gate the whole fleet's demand on grid carbon: every campaign
    demands `u_high` in clean hours (carbon <= threshold) and `u_low`
    in dirty ones, capping the site's draw exactly when it is most
    carbon-expensive."""
    member = CarbonGateSchedule(float(threshold), u_low=u_low, u_high=u_high,
                                batch_size=batch_size)
    return AllocationSchedule((member,),
                              name=name or f"carbon_gate_{threshold:g}")


class _LegacyPolicyAdapter:
    """Back-compat shim for pre-Schedule duck-typed policy objects.

    Anything exposing the old `intensity_at(band)` (and optionally
    `intensity_at_hour(hour)` + `hourly_intensity`) surface keeps working;
    new code should subclass/implement Schedule directly.
    """

    def __init__(self, policy):
        self._policy = policy
        self.name = getattr(policy, "name", type(policy).__name__)
        self.batch_size = getattr(policy, "batch_size", 50)

    def decide(self, ctx: SchedulingContext) -> Decision:
        p = self._policy
        if hasattr(p, "intensity_at_hour") and getattr(p, "hourly_intensity", ()):
            u = p.intensity_at_hour(ctx.hour_of_day)
        else:
            u = p.intensity_at(ctx.band)
        return Decision(float(u), self.batch_size)

    def change_hours(self, bands) -> Tuple[float, ...]:
        p = self._policy
        if hasattr(p, "intensity_at_hour") and getattr(p, "hourly_intensity", ()):
            return HOURLY_GRID
        return bands.edges()


def dedupe_names(names) -> list:
    """Disambiguate duplicate labels with an indexed suffix (`name#1`,
    `name#2`, ...), so sweep result rows and dashboard tables keyed by
    name never silently collide."""
    seen: dict = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}#{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out


def as_schedule(obj) -> Schedule:
    """Coerce policies (old or new) into the Schedule protocol."""
    if hasattr(obj, "decide"):
        return obj
    if hasattr(obj, "intensity_at") or hasattr(obj, "intensity_at_hour"):
        return _LegacyPolicyAdapter(obj)
    raise TypeError(f"cannot interpret {obj!r} as a Schedule")
