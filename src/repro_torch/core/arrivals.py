"""Request-arrival streams for the online-serving layer (core/serve.py).

The paper plans *recurrent* campaigns offline; the serving layer
schedules *streaming* arrivals — requests that show up continuously,
each with a deadline, a work size (in the same scenario units the rate
model speaks), and a requested quality tier.  This module is the data
side of that layer:

  * `ArrivalBatch` — one arrival window as a struct-of-arrays (sorted
    arrival times, absolute deadlines, work sizes, requested tiers), so
    a million-request day is four NumPy arrays, not a million objects;
  * `QualityTier` — the CarbonShiftML-style quality axis: tier k runs
    `work * work_scale` (a cheaper model / coarser analysis), which
    admission policies may fall back to when clean capacity is scarce;
  * `arrival_stream` — seeded synthetic generators for the four load
    shapes of the temporal-shifting literature (arXiv:2508.14625):
    `random`, `linear`, `peak`, `camel`.

Everything is deterministic under an explicit `seed=` — generators own
a `np.random.default_rng(seed)` and never touch global RNG state, so a
(seed, shape, n) triple pins the exact same stream across runs and
backends.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

#: The synthetic load shapes (density of arrivals over the window).
LOAD_SHAPES: Tuple[str, ...] = ("random", "linear", "peak", "camel")


@dataclasses.dataclass(frozen=True)
class QualityTier:
    """One rung of the quality/effort ladder a request may run at.

    `work_scale` multiplies the request's full-quality work size: a
    0.25 tier does a quarter of the compute (and typically delivers a
    degraded answer).  Policies may *degrade* a request to a cheaper
    tier than requested, never upgrade it.
    """
    name: str
    work_scale: float

    def __post_init__(self):
        if not (0.0 < self.work_scale <= 1.0):
            raise ValueError(f"work_scale must be in (0, 1], got "
                             f"{self.work_scale}")


#: Full quality, a half-compute tier, and an eco tier — the default
#: ladder admission policies degrade down when clean capacity is scarce.
DEFAULT_TIERS: Tuple[QualityTier, ...] = (
    QualityTier("full", 1.0),
    QualityTier("reduced", 0.5),
    QualityTier("eco", 0.25),
)


@dataclasses.dataclass(frozen=True)
class ArrivalBatch:
    """One window of request arrivals, as parallel arrays sorted by
    arrival time.

    Times are hours relative to the window start: request i arrives at
    `t_arrive_h[i]` and must finish by `deadline_h[i]` (absolute, not
    slack — always >= the arrival).  `work[i]` is the full-quality work
    size in scenario units (the rate model's currency); `tier[i]` the
    *requested* quality tier index into the session's tier ladder.
    """
    t_arrive_h: np.ndarray       # (N,) float, sorted ascending
    deadline_h: np.ndarray       # (N,) float, >= t_arrive_h
    work: np.ndarray             # (N,) float, > 0
    tier: np.ndarray             # (N,) int, requested quality tier
    horizon_h: float = 24.0

    def __post_init__(self):
        arr = np.asarray(self.t_arrive_h, dtype=float)
        ddl = np.asarray(self.deadline_h, dtype=float)
        wrk = np.asarray(self.work, dtype=float)
        tr = np.asarray(self.tier, dtype=np.int64)
        if not (len(arr) == len(ddl) == len(wrk) == len(tr)):
            raise ValueError(
                f"arrival arrays disagree on length: "
                f"{len(arr)}/{len(ddl)}/{len(wrk)}/{len(tr)}")
        if len(arr) and np.any(arr[1:] < arr[:-1]):
            raise ValueError("arrivals must be sorted by t_arrive_h")
        if np.any(ddl < arr):
            raise ValueError("every deadline must be >= its arrival")
        if np.any(wrk <= 0.0):
            raise ValueError("work sizes must be positive")
        if np.any(tr < 0):
            raise ValueError("tier indices must be >= 0")
        if len(arr) and float(arr[-1]) >= float(self.horizon_h):
            raise ValueError(
                f"arrival at {float(arr[-1]):g} h is outside the "
                f"{float(self.horizon_h):g} h window")
        object.__setattr__(self, "t_arrive_h", arr)
        object.__setattr__(self, "deadline_h", ddl)
        object.__setattr__(self, "work", wrk)
        object.__setattr__(self, "tier", tr)
        object.__setattr__(self, "horizon_h", float(self.horizon_h))

    @property
    def n(self) -> int:
        return len(self.t_arrive_h)

    def __len__(self) -> int:
        return self.n

    @staticmethod
    def merge(batches: Sequence["ArrivalBatch"]) -> "ArrivalBatch":
        """Merge same-window batches into one, re-sorted by arrival
        (stable, so equal arrival times keep submission order)."""
        if not batches:
            raise ValueError("merge needs at least one batch")
        horizon = max(b.horizon_h for b in batches)
        arr = np.concatenate([b.t_arrive_h for b in batches])
        order = np.argsort(arr, kind="stable")
        return ArrivalBatch(
            arr[order],
            np.concatenate([b.deadline_h for b in batches])[order],
            np.concatenate([b.work for b in batches])[order],
            np.concatenate([b.tier for b in batches])[order],
            horizon_h=horizon)


def _shape_density(shape: str, t: np.ndarray, horizon_h: float,
                   peak_frac: float, camel_fracs: Tuple[float, float]
                   ) -> np.ndarray:
    """Un-normalized arrival density over window-relative hours `t`."""
    x = t / horizon_h                       # [0, 1)
    if shape == "random":
        return np.ones_like(x)
    if shape == "linear":
        # ramp from 0.2x to 1.8x the mean rate across the window
        return 0.2 + 1.6 * x
    if shape == "peak":
        # one bump (diurnal rush) on a floor of background traffic
        return 0.1 + np.exp(-0.5 * ((x - peak_frac) / 0.10) ** 2)
    if shape == "camel":
        # two humps (morning + evening) on the same floor
        a, b = camel_fracs
        return (0.1 + np.exp(-0.5 * ((x - a) / 0.08) ** 2)
                + np.exp(-0.5 * ((x - b) / 0.08) ** 2))
    raise ValueError(f"unknown load shape {shape!r}; choose from "
                     f"{LOAD_SHAPES}")


def arrival_stream(n: int, horizon_h: float = 24.0,
                   shape: str = "random", *, seed: int = 0,
                   mean_work: float = 1.0, work_sigma: float = 0.5,
                   slack_h: Tuple[float, float] = (1.0, 8.0),
                   tier_mix: Sequence[float] = (1.0,),
                   peak_frac: float = 0.75,
                   camel_fracs: Tuple[float, float] = (0.35, 0.8)
                   ) -> ArrivalBatch:
    """A seeded synthetic arrival stream of `n` requests over one window.

    `shape` picks the arrival-density curve (`LOAD_SHAPES`); arrival
    times are drawn by inverse-CDF sampling of that density, so the
    empirical histogram follows the curve at any `n`.  Work sizes are
    lognormal around `mean_work` (σ = `work_sigma` in log space,
    mean-corrected so the expected work is exactly `mean_work`);
    deadlines are the arrival plus a uniform slack in `slack_h`;
    requested tiers are drawn from the `tier_mix` weights (index k =
    tier k of the session's ladder — the default requests full quality
    for everyone).  `peak_frac` / `camel_fracs` place the bump centers
    as fractions of the window.

    Deterministic: one `np.random.default_rng(seed)` drives every draw;
    no global RNG state is read or written.
    """
    if n < 1:
        raise ValueError(f"need at least one request, got n={n}")
    if horizon_h <= 0.0:
        raise ValueError(f"horizon_h must be positive, got {horizon_h}")
    lo, hi = float(slack_h[0]), float(slack_h[1])
    if not (0.0 < lo <= hi):
        raise ValueError(f"slack_h must satisfy 0 < lo <= hi, got {slack_h}")
    rng = np.random.default_rng(seed)

    # inverse-CDF sampling on a fine grid: density -> CDF -> quantiles
    grid = np.linspace(0.0, horizon_h, 2049)
    mid = 0.5 * (grid[1:] + grid[:-1])
    dens = _shape_density(shape, mid, horizon_h, peak_frac, camel_fracs)
    cdf = np.concatenate([[0.0], np.cumsum(dens)])
    cdf /= cdf[-1]
    t = np.interp(rng.random(n), cdf, grid)
    t = np.sort(np.minimum(t, np.nextafter(horizon_h, 0.0)))

    # mean-corrected lognormal work sizes (E[work] == mean_work)
    work = mean_work * np.exp(
        work_sigma * rng.standard_normal(n) - 0.5 * work_sigma ** 2)
    work = np.maximum(work, 1e-3 * mean_work)

    deadline = t + rng.uniform(lo, hi, size=n)

    mix = np.asarray(tier_mix, dtype=float)
    if mix.ndim != 1 or len(mix) < 1 or np.any(mix < 0.0) or mix.sum() <= 0:
        raise ValueError(f"tier_mix must be non-negative weights, got "
                         f"{tier_mix}")
    tier = rng.choice(len(mix), size=n, p=mix / mix.sum())

    return ArrivalBatch(t, deadline, work, tier, horizon_h=horizon_h)


__all__ = ["ArrivalBatch", "DEFAULT_TIERS", "LOAD_SHAPES", "QualityTier",
           "arrival_stream"]
