"""The PyTorch port's receding-horizon MPC (`core/mpc.py`,
`Campaign.run_mpc`, `Fleet.run_mpc`) held against the JAX package on
the CPU.

The reference's acceptance tests (tests/test_mpc.py) are carried over on
the same fixture (OEM case 1 at 1/8 of its scenarios, the seeded
non-periodic `_truth()`, the small seeded CEM `SOLVER`): K = infinity is
open-loop `optimize_schedule` bitwise; every executed slot is carried
across a re-plan, never re-scanned (the `replans`/`slots_reused`
counters); pausing and resuming an interval, and an identity
`replace_tables`, change no bit; the fleet session holds its site cap;
an uncovered truth and a missing deadline are refused; realized CO2 is
ordered by forecast quality.

Added for the port: `MPCSession`, `Campaign.run_mpc` and
`FleetMPCSession` against the reference's — every `ReplanRecord`'s
`at_hour`, `planned_co2_kg`, `planned_runtime_h`, `evaluations` and
`slots_carried`, and the realized CO2, energy and runtime, within 1e-9
relative.  Both sides run their solver's seeded CEM on the CPU (the
reference its jitted JAX objective, the port the plain PyTorch versions
of its kernels), so the candidates' rankings agree and every re-plan
sees the same schedule.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.carina as R  # noqa: E402
import repro.core.mpc as RM  # noqa: E402
import repro_torch.carina as P  # noqa: E402
from repro_torch.core.mpc import FleetMPCSession, MPCSession  # noqa: E402

SOLVER = dict(method="cem", candidates=24, iterations=4, seed=0)
RTOL = 1e-9
CPU = dict(device="cpu")


def _truth(mod=P, days: int = 14, seed: int = 11):
    """A non-periodic ground-truth carbon trace with day-to-day regime
    drift (tests/test_mpc.py::_truth): a diurnal swing whose amplitude
    and phase wander across days, plus seeded noise."""
    rng = np.random.default_rng(seed)
    h = np.arange(24 * days, dtype=float)
    day = h // 24
    amp = 0.18 + 0.10 * np.sin(day * 2.1) + 0.03 * rng.standard_normal(
        24 * days)
    phase = 0.8 * np.sin(day * 0.9)
    vals = 0.40 + amp * np.sin((h % 24) * 2 * np.pi / 24 + phase)
    vals += 0.02 * rng.standard_normal(24 * days)
    return mod.as_trace(vals.clip(0.05), start_hour=0.0, name="truth")


def _oem_small(mod=P):
    """OEM case 1, calibrated, scaled to 1/8 of its scenarios (~22 h at
    full intensity)."""
    wl, m = mod.calibrate_workload(mod.OEM_CASE_1, mod.MachineProfile())
    return dataclasses.replace(wl, n_scenarios=wl.n_scenarios // 8), m


@pytest.fixture(scope="module")
def oem_small():
    return _oem_small()


def _mpc_case(oem_small, truth, deadline_h=96.0, mod=P):
    wl, m = oem_small
    return mod.SweepCase(mod.constant_schedule(1.0), wl, m, carbon=truth,
                         start_hour=9.0, deadline_h=deadline_h)


def _rel(a, b):
    return abs(a - b) <= RTOL * abs(b)


def _hold(got, ref):
    """An `MPCResult` of the port against the reference's: the records
    and the realized fields within 1e-9 relative."""
    assert len(got.replans) == len(ref.replans)
    for g, r in zip(got.replans, ref.replans):
        assert g.at_hour == r.at_hour
        assert g.evaluations == r.evaluations
        assert g.slots_carried == r.slots_carried
        assert _rel(g.planned_co2_kg, r.planned_co2_kg), (g, r)
        assert _rel(g.planned_runtime_h, r.planned_runtime_h), (g, r)
        assert abs(g.forecast_mae - r.forecast_mae) <= RTOL * max(
            abs(r.forecast_mae), 1.0)
    for f in ("realized_co2_kg", "realized_energy_kwh",
              "realized_runtime_h", "planned_co2_kg", "planned_runtime_h"):
        assert _rel(getattr(got, f), getattr(ref, f)), f
    assert got.slots_reused == ref.slots_reused
    assert got.n_replans == ref.n_replans
    assert got.forecast == ref.forecast


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("forecast,every", [("persistence", 8.0),
                                            ("day_ahead", 24.0)])
def test_mpc_session_matches_reference(oem_small, forecast, every):
    outs = []
    for mod, cls, kw in ((R, RM.MPCSession, {}), (P, MPCSession, CPU)):
        truth = _truth(mod)
        case = _mpc_case(_oem_small(mod), truth, mod=mod)
        outs.append(cls(case, truth, constraints={"runtime_h": 96.0},
                        forecast=forecast, replan_every_h=every,
                        solver=SOLVER, **kw).run())
    ref, got = outs
    assert got.n_replans >= 1
    _hold(got, ref)
    assert np.array_equal(got.schedule.intensity_table(),
                          ref.schedule.intensity_table())


def test_campaign_run_mpc_matches_reference():
    """`Campaign.run_mpc` warm-starts its first solve from the campaign's
    periodic profile, as the reference's does."""
    outs = []
    for mod, kw in ((R, {}), (P, CPU)):
        wl, m = _oem_small(mod)
        c = mod.Campaign(wl, mod.PEAK_AWARE_BOOSTED, machine=m,
                         calibrate=False)
        outs.append(c.run_mpc(_truth(mod), "co2", deadline_h=96.0,
                              forecast="persistence", replan_every_h=24.0,
                              **SOLVER, **kw))
    ref, got = outs
    assert got.n_replans >= 1
    _hold(got, ref)


def test_fleet_mpc_session_matches_reference():
    outs = []
    for mod, kw in ((R, {}), (P, CPU)):
        wl, m = _oem_small(mod)
        truth = _truth(mod)
        small = dataclasses.replace(wl, n_scenarios=wl.n_scenarios // 2)
        f = mod.Fleet([mod.Campaign(wl, machine=m, carbon=truth),
                       mod.Campaign(small, machine=m, carbon=truth)],
                      mod.Site(power_cap_kw=1.5, office_kw=0.2,
                               carbon=truth))
        outs.append(f.run_mpc(truth, deadlines=96.0, forecast="persistence",
                              replan_every_h=48.0, method="cem",
                              candidates=12, iterations=2, seed=0, **kw))
    ref, got = outs
    assert got.n_replans >= 1
    _hold(got, ref)
    assert _rel(got.result.site.peak_kw, ref.result.site.peak_kw)
    for g, r in zip(got.result.campaigns, ref.result.campaigns):
        for f in ("runtime_h", "energy_kwh", "co2_kg"):
            assert _rel(getattr(g, f), getattr(r, f)), f
    for g, r in zip(got.schedule, ref.schedule):
        np.testing.assert_array_equal(g.intensity_table(),
                                      r.intensity_table())


# ---------------------------------------------------------------------------
# The reference's acceptance tests, on the port
# ---------------------------------------------------------------------------
def test_value_of_forecast_ordering():
    """Realized CO2 is monotone in forecast quality on OEM case 1 at 1/4
    of its scenarios (~45 h of work against a 96 h deadline): the two
    inequalities that involve the stochastic day-ahead forecast within
    2 % of the oracle's realized CO2, oracle before persistence strictly
    (the reference's bars and seeds)."""
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    wl = dataclasses.replace(wl, n_scenarios=wl.n_scenarios // 4)
    truth = _truth()
    solver = dict(method="cem", candidates=32, iterations=6, seed=0)
    realized = {}
    for name, model in [("oracle", P.oracle()),
                        ("day_ahead", P.day_ahead(noise_sigma=0.35, seed=0)),
                        ("persistence", P.persistence())]:
        case = P.SweepCase(P.constant_schedule(1.0), wl, m, carbon=truth,
                           start_hour=9.0, deadline_h=96.0)
        out = MPCSession(case, truth, constraints={"runtime_h": 96.0},
                         forecast=model, replan_every_h=24.0,
                         solver=solver, **CPU).run()
        realized[name] = out.realized_co2_kg
        assert out.realized_runtime_h <= 96.0 + 1e-6
    tol = 0.02 * realized["oracle"]
    assert realized["oracle"] <= realized["day_ahead"] + tol, realized
    assert realized["day_ahead"] <= realized["persistence"] + tol, realized
    assert realized["oracle"] < realized["persistence"], realized


def test_oracle_forecast_mae_is_zero(oem_small):
    truth = _truth()
    out = MPCSession(_mpc_case(oem_small, truth), truth,
                     constraints={"runtime_h": 96.0}, forecast="oracle",
                     replan_every_h=24.0, solver=SOLVER, **CPU).run()
    assert out.forecast_mae == 0.0
    assert all(r.forecast_mae == 0.0 for r in out.replans)
    assert out.realized_co2_kg <= out.planned_co2_kg * 1.05


@pytest.mark.parametrize("k_inf", [None, math.inf])
def test_k_inf_matches_open_loop_bitwise(oem_small, k_inf):
    truth = _truth()
    case = _mpc_case(oem_small, truth)
    P.reset_scan_stats()
    out = MPCSession(case, truth, constraints={"runtime_h": 96.0},
                     forecast="oracle", replan_every_h=k_inf,
                     solver=SOLVER, **CPU).run()
    st_mpc = P.scan_stats(reset=True)
    ref = P.optimize_schedule(case, "co2", {"runtime_h": 96.0}, **SOLVER,
                              **CPU)
    assert np.array_equal(out.schedule.intensity_table(),
                          ref.schedule.intensity_table())
    assert out.realized_co2_kg == ref.result.co2_kg
    assert out.realized_energy_kwh == ref.result.energy_kwh
    assert out.realized_runtime_h == ref.result.runtime_h
    assert out.n_replans == 0
    assert out.slots_reused == 0
    assert st_mpc.replans == 0
    assert st_mpc.slots_reused == 0


def test_replan_reuses_every_executed_slot(oem_small):
    truth = _truth()
    case = _mpc_case(oem_small, truth)
    P.reset_scan_stats()
    out = MPCSession(case, truth, constraints={"runtime_h": 96.0},
                     forecast="persistence", replan_every_h=8.0,
                     solver=SOLVER, **CPU).run()
    stats = P.scan_stats(reset=True)
    assert out.n_replans >= 2            # ~25 h campaign, 8 h intervals
    assert stats.replans == out.n_replans
    carried = [r.slots_carried for r in out.replans]
    assert carried[0] == 0               # entry 0 is the initial solve
    assert all(c > 0 for c in carried[1:])
    assert carried[1:] == sorted(carried[1:])    # cursor only advances
    assert stats.slots_reused == sum(carried[1:])
    assert out.slots_reused == stats.slots_reused


def test_execute_interval_split_is_bitwise(oem_small):
    """Pausing/resuming at an arbitrary slot boundary is invisible in the
    final state."""
    wl, m = oem_small
    truth = _truth()
    case = P.SweepCase(P.constant_schedule(0.7), wl, m, carbon=truth,
                       start_hour=9.0, deadline_h=96.0)
    plan = P.compile_plan([case])
    ref = P.execute_plan(plan, **CPU)
    cur = P.execute_interval(plan, until_slot=17, **CPU)
    assert not cur.done and cur.t0 == 17
    cur = P.execute_interval(plan, cur, until_slot=40, **CPU)
    cur = P.execute_interval(plan, cur, **CPU)
    assert cur.done
    for a, b in zip(ref, cur.state):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_replace_tables_identity_swap_is_noop(oem_small):
    """Swapping in the very same schedule/carbon mid-flight changes no
    bit of the outcome — only the counters move."""
    wl, m = oem_small
    truth = _truth()
    case = P.SweepCase(P.constant_schedule(0.7), wl, m, carbon=truth,
                       start_hour=9.0, deadline_h=96.0)
    plan = P.compile_plan([case])
    ref = P.execute_plan(plan, **CPU)
    P.reset_scan_stats()
    cur = P.execute_interval(plan, until_slot=24, **CPU)
    plan2 = P.replace_tables(plan, cur, schedules={0: case.schedule},
                             carbon=truth)
    cur = P.execute_interval(plan2, cur, **CPU)
    stats = P.scan_stats(reset=True)
    assert stats.replans == 1
    assert stats.slots_reused == 24 * plan.n_lanes
    for a, b in zip(ref, cur.state):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_fleet_run_mpc_smoke(oem_small):
    wl, m = oem_small
    truth = _truth()
    small = dataclasses.replace(wl, n_scenarios=wl.n_scenarios // 2)
    f = P.Fleet([P.Campaign(wl, machine=m, carbon=truth),
                 P.Campaign(small, machine=m, carbon=truth)],
                P.Site(power_cap_kw=1.5, office_kw=0.2, carbon=truth))
    P.reset_scan_stats()
    out = f.run_mpc(truth, deadlines=96.0, forecast="persistence",
                    replan_every_h=48.0, method="cem", candidates=12,
                    iterations=2, seed=0, **CPU)
    stats = P.scan_stats(reset=True)
    assert out.n_replans >= 1
    assert stats.replans == out.n_replans
    assert stats.grouped_lanes > 0, "the capped plan runs the coupled scan"
    assert len(out.result.campaigns) == 2
    assert out.result.site.peak_kw is not None
    assert out.result.site.peak_kw <= 1.5 + 1e-9
    assert out.realized_co2_kg == pytest.approx(out.result.site.co2_kg)
    assert all(r.runtime_h > 0 for r in out.result.campaigns)


README_FLEET_PEAK_KW = 0.45170038323109474   # constant_schedule(1.0)


def test_readme_fleet_peaks_over_its_cap_as_the_reference():
    """The model meets a reachable site cap only to a fraction of a
    percent (`site_throttle`: four damped fixed-point steps a slot).  The
    README's two-OEM fleet under `Site(0.45, 0.12)` peaks over its cap
    under every assignment here, by up to 0.378 % at full intensity, in
    the reference as in the port.  This pins the figure behind
    chip_smoke.py's bar on that fleet's MPC peak (cap + 0.5 %)."""
    peaks = {}
    for mod, kw in ((R, dict(backend="numpy")), (P, CPU)):
        site = mod.Site(power_cap_kw=0.45, office_kw=0.12)
        fleet = mod.Fleet([mod.Campaign(mod.OEM_CASE_1),
                           mod.Campaign(mod.OEM_CASE_2)], site)
        rows = fleet.sweep([mod.BASELINE, mod.PEAK_AWARE_BOOSTED,
                            [mod.BASELINE, mod.PEAK_AWARE_BOOSTED],
                            [mod.PEAK_AWARE_BOOSTED, mod.BASELINE],
                            mod.constant_schedule(0.8),
                            mod.constant_schedule(1.0)], **kw)
        peaks[mod] = [r.site.peak_kw for r in rows]
        for r in rows:
            assert all(math.isfinite(c.runtime_h) for c in r.campaigns)
    ref, got = peaks[R], peaks[P]
    assert all(0.45 < p <= 0.45 * 1.005 for p in ref), ref
    assert max(ref) == ref[-1]
    assert _rel(ref[-1], README_FLEET_PEAK_KW), ref[-1]
    assert all(_rel(g, r) for g, r in zip(got, ref)), (got, ref)


def test_mpc_rejects_uncovered_truth(oem_small):
    """A truth archive shorter than the campaign window would fabricate
    emissions under the hold clamp, so the session refuses it."""
    truth = _truth(days=2)                # 48 h of truth, 96 h deadline
    case = _mpc_case(oem_small, truth)
    with pytest.raises(ValueError, match="needs coverage"):
        MPCSession(case, truth, constraints={"runtime_h": 96.0},
                   solver=SOLVER, **CPU)


def test_mpc_requires_finite_deadline(oem_small):
    truth = _truth()
    case = _mpc_case(oem_small, truth)
    with pytest.raises(ValueError, match="runtime cap"):
        MPCSession(case, truth, solver=SOLVER, **CPU)
    with pytest.raises(ValueError, match="positive"):
        MPCSession(case, truth, constraints={"runtime_h": 96.0},
                   replan_every_h=0.0, solver=SOLVER, **CPU)
    with pytest.raises(ValueError, match="finite deadline"):
        FleetMPCSession([dataclasses.replace(case, deadline_h=0.0)],
                        P.Site(), truth, solver=SOLVER, **CPU)


def test_backend_refused_and_card_by_default(oem_small):
    truth = _truth()
    case = _mpc_case(oem_small, truth)
    with pytest.raises(NotImplementedError, match="backend"):
        MPCSession(case, truth, constraints={"runtime_h": 96.0},
                   backend="numpy")
    with pytest.raises(NotImplementedError, match="backend"):
        FleetMPCSession([case], P.Site(), truth, backend="numpy")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MPCSession(case, truth, constraints={"runtime_h": 96.0},
                       solver=SOLVER).run()
