"""Time-varying input signals (paper §2 instrumentation + stated future work).

A Signal is any time-varying scalar input the scheduler or the simulator
consumes: background office load, grid carbon intensity, electricity
price.  The paper hard-wires the first two (band levels in
`TimeBands.background`, an hourly multiplier in `GridCarbonModel`); this
module lifts them behind one interface so a live forecast feed — the
paper's "continuously updated regional carbon-intensity feeds" — can later
implement the same protocol without touching the simulator or the engine.

Signals are sampled with *absolute* campaign hours (hour 0 = midnight of
the campaign's first day).  Periodic signals wrap mod 24 internally, so
hour-of-day and absolute-hour sampling agree for them; a `TraceSignal`
(an arbitrary-length hourly series such as a week-long grid-carbon
forecast) is genuinely non-periodic and is what routes a sweep onto the
trace-grid engine (core/engine_torch.py) instead of the periodic 24-slot
one (core/engine.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class Signal(Protocol):
    """A scalar input varying with time."""

    name: str

    def at(self, hour_of_day: float) -> float:
        """Value at the given hour (absolute campaign hours; periodic
        signals wrap mod 24, so hour-of-day works too)."""
        ...


def period_hours(signal) -> Optional[float]:
    """A signal's period in hours; None when unknown or non-periodic.

    Signals may declare their own `period_h`; the bundled periodic
    classes (ConstantSignal / HourlySignal / BandSignal, plus the
    GridCarbonModel duck type) are known to repeat every 24 h.  Anything
    else is conservatively treated as non-periodic — a custom live-feed
    signal implementing only `at(hour)` must not be silently collapsed
    onto one repeated day by the periodic sweep engine.
    """
    if hasattr(signal, "period_h"):
        return signal.period_h
    if isinstance(signal, (ConstantSignal, HourlySignal, BandSignal)):
        return 24.0
    if hasattr(signal, "factor_at"):      # GridCarbonModel duck type
        return 24.0
    return None


def is_periodic_24h(signal) -> bool:
    """True when the signal is known to repeat every 24 h (the periodic
    sweep engine's representability condition)."""
    return period_hours(signal) == 24.0


@dataclasses.dataclass(frozen=True)
class ConstantSignal:
    """Flat signal (e.g. the paper's single DTE grid factor)."""
    value: float
    name: str = "constant"

    def at(self, hour_of_day: float) -> float:
        return self.value


@dataclasses.dataclass(frozen=True)
class HourlySignal:
    """24-slot piecewise-constant signal (one value per local hour)."""
    values: Tuple[float, ...]
    name: str = "hourly"

    def __post_init__(self):
        if len(self.values) != 24:
            raise ValueError(
                f"HourlySignal needs exactly 24 values, got {len(self.values)}")

    def at(self, hour_of_day: float) -> float:
        # math.floor, not int(): int() truncates toward zero, mapping hour
        # -0.5 to slot 0 instead of slot 23
        return self.values[math.floor(hour_of_day) % 24]


@dataclasses.dataclass(frozen=True)
class BandSignal:
    """Signal defined per time band (e.g. background office load).

    `bands` is a TimeBands instance (duck-typed to avoid the import cycle);
    `levels` maps band name -> value.
    """
    bands: object
    levels: dict
    name: str = "band"

    def at(self, hour_of_day: float) -> float:
        return self.levels[self.bands.band_at(hour_of_day)]


@dataclasses.dataclass(frozen=True)
class TraceSignal:
    """A non-periodic hourly series of arbitrary length (e.g. a week-long
    grid-carbon or forecast trace).

    `values[i]` covers absolute hours `[start_hour + i, start_hour + i + 1)`
    where hour 0 is midnight of the campaign's first day.  `period_h` is
    None: sweeps over a TraceSignal are routed to the trace-grid engine.

    `pad` makes the out-of-range policy explicit instead of incidental:

    - ``"hold"`` (default): outside the covered range the trace clamps
      (holds its first/last value), so a campaign that outruns its
      forecast keeps the most recent sample rather than wrapping to
      stale data.
    - ``"raise"``: sampling outside ``[start_hour, end_hour)`` raises
      ``ValueError``.  Use this when silently repeating the archive's
      last value would corrupt a result — e.g. an MPC horizon that
      extends past the end of a ground-truth trace.
    """
    values: Tuple[float, ...]
    start_hour: float = 0.0
    name: str = "trace"
    pad: str = "hold"

    def __post_init__(self):
        if len(self.values) < 1:
            raise ValueError("TraceSignal needs at least one value")
        if self.pad not in ("hold", "raise"):
            raise ValueError(
                f"pad must be 'hold' or 'raise', got {self.pad!r}")
        # frozen dataclass: stash the array form once (sample() is hot in
        # large sweeps and must not re-convert the tuple per case)
        object.__setattr__(self, "_arr",
                           np.asarray(self.values, dtype=float))

    @property
    def period_h(self) -> Optional[float]:
        return None

    @property
    def hours(self) -> float:
        """Length of the covered range in hours."""
        return float(len(self.values))

    @property
    def end_hour(self) -> float:
        """First absolute hour past the covered range."""
        return self.start_hour + len(self.values)

    def covers(self, hour: float) -> bool:
        """True when `hour` falls inside the covered range."""
        return self.start_hour <= hour < self.end_hour

    def _check_range(self, lo: float, hi: float) -> None:
        if lo < self.start_hour or hi >= self.end_hour:
            raise ValueError(
                f"trace '{self.name}' covers hours [{self.start_hour}, "
                f"{self.end_hour}) but was sampled at hour "
                f"{lo if lo < self.start_hour else hi}; extend the "
                "archive, shorten the horizon, or use pad='hold' to "
                "clamp explicitly")

    def at(self, hour: float) -> float:
        if self.pad == "raise":
            self._check_range(hour, hour)
        i = math.floor(hour - self.start_hour)
        return self.values[min(max(i, 0), len(self.values) - 1)]

    def sample(self, hours) -> np.ndarray:
        """Vectorized `at` over an array of absolute hours."""
        hours = np.asarray(hours, dtype=float)
        if self.pad == "raise" and hours.size:
            self._check_range(float(hours.min()), float(hours.max()))
        idx = np.clip(np.floor(hours - self.start_hour).astype(int),
                      0, len(self.values) - 1)
        return self._arr[idx]


@dataclasses.dataclass(frozen=True)
class SignalEnsemble:
    """A stack of carbon (or price) traces treated as one uncertain signal.

    The carbon-aware workflow literature evaluates savings across *many*
    trace windows, not one deterministic forecast; a `SignalEnsemble`
    carries those E scenario members side by side.  Members are usually
    `TraceSignal`s (historical windows, forecast samples) but any Signal
    works.  `sample(hours)` returns the whole `(E, *hours.shape)` block in
    one vectorized call — the shape the trace-grid scan vmaps its CO2
    accumulators over to produce per-member metrics.

    `period_h` is None, so a sweep case whose carbon is an ensemble always
    routes to the trace-grid engine.  `at(hour)` returns the member mean
    (the sequential simulators see the ensemble's central scenario; use
    `member(e)` to simulate one realization).
    """
    members: Tuple[Signal, ...]
    name: str = "ensemble"

    def __post_init__(self):
        if len(self.members) < 1:
            raise ValueError("SignalEnsemble needs at least one member")

    def __len__(self) -> int:
        return len(self.members)

    @property
    def n_members(self) -> int:
        return len(self.members)

    @property
    def period_h(self) -> Optional[float]:
        return None

    def member(self, e: int) -> Signal:
        return self.members[e]

    def at(self, hour: float) -> float:
        at = 0.0
        for m in self.members:
            at += float(m.at(hour))
        return at / len(self.members)

    def sample(self, hours) -> np.ndarray:
        """Vectorized sampling of every member: (E, *hours.shape)."""
        hours = np.asarray(hours, dtype=float)
        return np.stack([sample_signal(m, hours) for m in self.members])


def as_ensemble(value, name: str = "ensemble") -> SignalEnsemble:
    """Coerce to a `SignalEnsemble`.

    Accepts an ensemble (passed through), a 2-D array of shape (E, T)
    (each row becomes an hourly `TraceSignal`), or an iterable of members
    where each member is a Signal or an hourly sequence (`as_trace`
    coercion per member).
    """
    if isinstance(value, SignalEnsemble):
        return value
    arr = None
    if not callable(getattr(value, "at", None)):
        try:
            arr = np.asarray(value, dtype=float)
        except (TypeError, ValueError):
            arr = None
    if arr is not None and arr.ndim == 2:
        return SignalEnsemble(tuple(
            TraceSignal(tuple(float(v) for v in row), name=f"{name}[{e}]")
            for e, row in enumerate(arr)), name=name)
    if arr is not None and arr.ndim == 1 and arr.dtype != object:
        raise TypeError(
            "a flat hourly series is one trace, not an ensemble — pass it "
            "as carbon_trace= (or wrap it: as_ensemble([series]), or give "
            "an (E, T) array / list of traces)")
    try:
        members = list(value)
    except TypeError:
        raise TypeError(
            f"cannot interpret {type(value).__name__} as a SignalEnsemble; "
            "pass an ensemble, an (E, T) array, or a list of traces/Signals"
        ) from None
    if not members:
        raise ValueError("SignalEnsemble needs at least one member")
    return SignalEnsemble(tuple(as_trace(m, name=f"{name}[{e}]")
                                for e, m in enumerate(members)), name=name)


def trace_windows(values, window_h: int, stride_h: Optional[int] = None,
                  start_hour: float = 0.0,
                  name: str = "windows", pad: str = "hold") -> SignalEnsemble:
    """Slice one long hourly series into an ensemble of sliding windows.

    The standard way to build a scenario ensemble from a historical
    grid-carbon archive: every `stride_h` (default `window_h`, i.e.
    non-overlapping) a `window_h`-hour window becomes one member, each
    re-anchored to `start_hour` so all members cover the same campaign
    hours.  Raises if the series is shorter than one window.  `pad` is
    forwarded to every member `TraceSignal` — pass ``"raise"`` to make
    sampling past a window's end an error instead of a silent clamp
    (see `TraceSignal.pad`).  A `TraceSignal` is accepted directly
    (e.g. a `ZoneSeries.to_trace()` from an archive): its values are
    windowed and, like any other series, every member is re-anchored to
    `start_hour`.
    """
    if isinstance(values, TraceSignal):
        values = values.values
    arr = np.asarray(list(values), dtype=float).ravel()
    window_h = int(window_h)
    stride = int(stride_h) if stride_h is not None else window_h
    if window_h < 1 or stride < 1:
        raise ValueError("window_h and stride_h must be positive")
    if len(arr) < window_h:
        raise ValueError(f"series of {len(arr)} hours is shorter than one "
                         f"{window_h}-hour window")
    members = []
    for e, o in enumerate(range(0, len(arr) - window_h + 1, stride)):
        members.append(TraceSignal(tuple(float(v)
                                         for v in arr[o:o + window_h]),
                                   start_hour=start_hour,
                                   name=f"{name}[{e}]", pad=pad))
    return SignalEnsemble(tuple(members), name=name)


def as_trace(values, start_hour: float = 0.0,
             name: str = "trace") -> TraceSignal:
    """Coerce an hourly sequence (or pass through a Signal) to a trace.

    The Signal test requires a *callable* `at` — jnp arrays and pandas
    Series expose a non-callable `.at` indexer and must be treated as
    plain hourly sequences, not passed through unconverted.
    """
    if isinstance(values, TraceSignal):
        return values
    if callable(getattr(values, "at", None)):   # already some Signal
        return values
    return TraceSignal(tuple(float(v) for v in values),
                       start_hour=start_hour, name=name)


def sample_signal(signal, hours) -> np.ndarray:
    """Vectorized sampling of any Signal (or GridCarbonModel) at an array
    of absolute hours.  Bundled signal classes take closed-form index
    paths; anything else falls back to a per-hour `at` loop."""
    hours = np.asarray(hours, dtype=float)
    if isinstance(signal, ConstantSignal):
        return np.full(hours.shape, signal.value)
    if isinstance(signal, HourlySignal):
        idx = np.floor(hours).astype(int) % 24
        return np.asarray(signal.values, dtype=float)[idx]
    if isinstance(signal, TraceSignal):
        return signal.sample(hours)
    if isinstance(signal, SignalEnsemble):   # scalar view: the member mean
        return signal.sample(hours).mean(axis=0)
    if hasattr(signal, "factor_at"):    # GridCarbonModel duck type
        return sample_signal(carbon_signal(signal), hours)
    return np.array([float(signal.at(float(h))) for h in hours.ravel()]
                    ).reshape(hours.shape)


def background_signal(bands) -> BandSignal:
    """The paper's contention model as a Signal: band -> background load."""
    from repro_torch.core.policy import BANDS
    return BandSignal(bands, {b: bands.background(b) for b in BANDS},
                      name="background")


def sample_hourly(source) -> Tuple[float, ...]:
    """24 hourly samples from a GridCarbonModel or any Signal — the one
    place the hour grid is applied to a signal (engine, factories, and
    carbon_signal all build on this)."""
    at = getattr(source, "factor_at", None) or source.at
    return tuple(at(float(h)) for h in range(24))


def carbon_signal(carbon) -> Signal:
    """Grid carbon intensity (kg CO2e / kWh) as a Signal.

    Accepts a GridCarbonModel *or* any Signal (TraceSignal included, which
    passes through unchanged) — the one coercion point that lets the
    simulators and engines treat carbon uniformly instead of special-casing
    GridCarbonModel vs Signal.
    """
    if hasattr(carbon, "factor_at"):            # GridCarbonModel duck type
        if getattr(carbon, "hourly_curve", None) is None:
            return ConstantSignal(carbon.factor_kg_per_kwh, name="carbon")
        return HourlySignal(sample_hourly(carbon), name="carbon")
    if callable(getattr(carbon, "at", None)):   # already a Signal
        return carbon
    raise TypeError(
        f"carbon must be a GridCarbonModel or a Signal with a callable "
        f"at(hour); got {type(carbon).__name__} (plain hourly sequences "
        "are coerced with repro_torch.core.signal.as_trace)")


# ---------------------------------------------------------------------------
# Electricity price (new input class; DTE-like time-of-use tariff).
# Off-peak 0.11 $/kWh, mid-day shoulder 0.15, on-peak 15-19 h at 0.21.
# ---------------------------------------------------------------------------
DTE_TOU_HOURLY: Tuple[float, ...] = (
    0.11, 0.11, 0.11, 0.11, 0.11, 0.11, 0.11, 0.15,
    0.15, 0.15, 0.15, 0.15, 0.15, 0.15, 0.15, 0.21,
    0.21, 0.21, 0.21, 0.21, 0.15, 0.15, 0.11, 0.11,
)

TOU_PRICE = HourlySignal(DTE_TOU_HOURLY, name="dte-tou-price")


@dataclasses.dataclass(frozen=True)
class SignalSet:
    """The bundle of signals a scheduling decision may consult."""
    background: Signal
    carbon: Signal
    price: Optional[Signal] = None

    def price_at(self, hour_of_day: float) -> float:
        return self.price.at(hour_of_day) if self.price is not None else 0.0

    def sample(self, grid: Sequence[float]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sample every signal on a grid of absolute hours.

        Returns `(background, carbon, price)` arrays of the grid's shape
        (price is all-zero when no price signal is set).  A convenience
        over `sample_signal`, which is the primitive the engines call
        per-signal (they carry cases' signals individually rather than
        as a SignalSet).
        """
        hours = np.asarray(grid, dtype=float)
        bg = sample_signal(self.background, hours)
        cf = sample_signal(self.carbon, hours)
        pr = (sample_signal(self.price, hours) if self.price is not None
              else np.zeros(hours.shape))
        return bg, cf, pr

    def is_periodic(self) -> bool:
        """True when every bundled signal repeats every 24 h."""
        return all(is_periodic_24h(s) for s in
                   (self.background, self.carbon, self.price)
                   if s is not None)


def default_signals(bands, carbon, price: Optional[Signal] = None) -> SignalSet:
    return SignalSet(background=background_signal(bands),
                     carbon=carbon_signal(carbon), price=price)


# ---------------------------------------------------------------------------
# Forecast-error models (receding-horizon MPC substrate).
#
# An MPC re-plan at hour `now_h` does not see the ground-truth trace; it
# sees a *forecast* of the remaining horizon.  A ForecastModel turns the
# ground truth into that per-re-plan view — seeded and stateless, so the
# same (truth, now_h, horizon_h) always yields the same forecast and a
# re-run of an MPC session is bit-reproducible.  The three bundled models
# bracket the forecast-quality axis from the West et al. carbon-shifting
# studies (arXiv:2503.13705, arXiv:2508.14625): `oracle` (perfect
# foresight — the open-loop upper bound), `day_ahead` (truth plus seeded
# multiplicative noise and optional bias), and `persistence` (yesterday's
# realized values repeated forward — the no-forecast baseline).
# ---------------------------------------------------------------------------

@runtime_checkable
class ForecastModel(Protocol):
    """Turns a ground-truth trace into a forecast of the remaining horizon."""

    name: str

    def forecast(self, truth, now_h: float, horizon_h: float) -> SignalEnsemble:
        """Forecast the window `[now_h, now_h + horizon_h]` of `truth`.

        Returns a `SignalEnsemble` (E >= 1 members) covering at least the
        requested window on the hourly grid.  Values at hours `<= now_h`
        are *observed* and must equal the realized truth; stochastic
        models must be deterministic in `(truth, now_h, horizon_h)` and
        their own seed.
        """
        ...


def _forecast_grid(truth, now_h: float, horizon_h: float):
    """The hourly grid a forecast is built on: integral hours from
    `floor(now_h)` through `now_h + horizon_h` (so the re-plan's sample
    grid, which is anchored at `floor(now_h)`, is fully covered)."""
    if horizon_h < 0:
        raise ValueError(f"horizon_h must be >= 0, got {horizon_h}")
    h0 = math.floor(now_h)
    n = max(1, math.ceil(now_h + horizon_h) - h0)
    return h0, np.arange(h0, h0 + n, dtype=float)


@dataclasses.dataclass(frozen=True)
class OracleForecast:
    """Perfect foresight: the forecast *is* the ground truth.

    The truth signal itself is returned as the single ensemble member
    (not a resampled copy), so an oracle-driven re-plan sees bitwise the
    same signal object as an open-loop optimize against the truth.
    """
    name: str = "oracle"

    def forecast(self, truth, now_h: float, horizon_h: float) -> SignalEnsemble:
        _forecast_grid(truth, now_h, horizon_h)   # validates horizon
        return SignalEnsemble((as_trace(truth),), name="oracle")


@dataclasses.dataclass(frozen=True)
class PersistenceForecast:
    """No-forecast baseline: the last observed period repeated forward.

    Future hours take the value realized exactly `lookback_h` (default 24,
    i.e. "same hour yesterday") before — iterated, so hour `now + 30`
    uses `now + 30 - 48` when a single lookback would still be in the
    future.  At the current hour the forecast equals the realized value
    (horizon-0 invariant), since only already-observed data is consulted.
    """
    lookback_h: float = 24.0
    name: str = "persistence"

    def __post_init__(self):
        if self.lookback_h <= 0:
            raise ValueError("lookback_h must be positive")

    def forecast(self, truth, now_h: float, horizon_h: float) -> SignalEnsemble:
        truth = as_trace(truth)
        h0, grid = _forecast_grid(truth, now_h, horizon_h)
        # Source hour per grid hour: observed hours pass through; future
        # hours step back whole lookback periods until at or before now.
        ahead = np.maximum(grid - now_h, 0.0)
        steps = np.ceil(ahead / self.lookback_h)
        src = grid - steps * self.lookback_h
        vals = sample_signal(truth, src)
        member = TraceSignal(tuple(float(v) for v in vals), start_hour=h0,
                             name=f"persistence@{now_h:g}h")
        return SignalEnsemble((member,), name="persistence")


@dataclasses.dataclass(frozen=True)
class DayAheadForecast:
    """Day-ahead-style forecast: truth plus seeded multiplicative error.

    Each member `m` sees `truth * (1 + bias + noise_sigma * eps)` with
    `eps ~ N(0, 1)` drawn from a generator seeded by
    `(seed, m, floor(now_h))` — stateless, so the same re-plan instant
    always produces the same forecast.  Hours at or before `now_h` are
    observed and pass through unperturbed.  With `noise_sigma == 0` and
    `bias == 0` the forecast values equal the oracle's.
    """
    noise_sigma: float = 0.1
    bias: float = 0.0
    n_members: int = 1
    seed: int = 0
    name: str = "day_ahead"

    def __post_init__(self):
        if self.noise_sigma < 0:
            raise ValueError("noise_sigma must be >= 0")
        if self.n_members < 1:
            raise ValueError("n_members must be >= 1")

    def forecast(self, truth, now_h: float, horizon_h: float) -> SignalEnsemble:
        truth = as_trace(truth)
        h0, grid = _forecast_grid(truth, now_h, horizon_h)
        base = sample_signal(truth, grid)
        future = grid > now_h
        members = []
        for m in range(self.n_members):
            vals = base.copy()
            if self.noise_sigma > 0.0 or self.bias != 0.0:
                rng = np.random.default_rng(
                    (int(self.seed), int(m), int(math.floor(now_h))))
                eps = rng.standard_normal(len(grid))
                factor = 1.0 + self.bias + self.noise_sigma * eps
                vals = np.where(future, base * factor, base)
                vals = np.maximum(vals, 1e-9)   # carbon intensity stays > 0
            members.append(TraceSignal(tuple(float(v) for v in vals),
                                       start_hour=h0,
                                       name=f"day_ahead[{m}]@{now_h:g}h"))
        return SignalEnsemble(tuple(members), name="day_ahead")


def oracle() -> OracleForecast:
    """Perfect-foresight forecast model (open-loop upper bound)."""
    return OracleForecast()


def persistence(lookback_h: float = 24.0) -> PersistenceForecast:
    """Persistence forecast model (same hour `lookback_h` ago)."""
    return PersistenceForecast(lookback_h=lookback_h)


def day_ahead(noise_sigma: float = 0.1, bias: float = 0.0,
              n_members: int = 1, seed: int = 0) -> DayAheadForecast:
    """Day-ahead forecast model (truth + seeded multiplicative error)."""
    return DayAheadForecast(noise_sigma=noise_sigma, bias=bias,
                            n_members=n_members, seed=seed)


def as_forecast(value) -> ForecastModel:
    """Coerce to a ForecastModel: pass through anything with a callable
    `forecast`, or map the names ``"oracle"`` / ``"persistence"`` /
    ``"day_ahead"`` to default-configured models."""
    if callable(getattr(value, "forecast", None)):
        return value
    if isinstance(value, str):
        factories = {"oracle": oracle, "persistence": persistence,
                     "day_ahead": day_ahead}
        if value in factories:
            return factories[value]()
        raise ValueError(
            f"unknown forecast model {value!r}; expected one of "
            f"{sorted(factories)} or a ForecastModel instance")
    raise TypeError(
        f"cannot interpret {type(value).__name__} as a ForecastModel; "
        "pass oracle()/persistence()/day_ahead(...) or a name string")
