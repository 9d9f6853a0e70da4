"""The PyTorch port's schedule optimizer held against the JAX package on
the CPU: `TraceObjective`/`FleetTraceObjective` forward and gradient,
`evaluate_params`, `pareto_front`, the seeded CEM search, and the
reference's own acceptance tests carried over to the port
(`tests/test_optimize.py`, `tests/test_fleet.py`).

Tolerances: objective values within 1e-9 relative per field in fp64
(`unfinished`, a fraction of the workload, within 1e-9 absolute);
`precision="mixed"` within 1e-6 of fp64; gradients within 1e-8 relative
in norm, and per component for every component above 1e-12 of the norm.
The reference runs its jitted JAX backend under x64, and gradients come
from `jax.grad` there and `torch.autograd` here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.carina as R  # noqa: E402
import repro.core.optimize as RO  # noqa: E402
import repro_torch.carina as P  # noqa: E402
import repro_torch.core.optimize as PO  # noqa: E402
from repro.compat import enable_x64  # noqa: E402

FIELDS = ("energy_kwh", "co2_kg", "runtime_h", "cost_usd", "unfinished")
SCALES = dict(energy_kwh=40.0, co2_kg=20.0, runtime_h=200.0, cost_usd=5.0,
              site_peak_kw=0.5)


def _close(got, ref, rtol, field):
    """Per element within `rtol` of |ref| (of 1 for `unfinished`)."""
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, (field, got.shape, ref.shape)
    scale = 1.0 if field == "unfinished" else np.abs(ref)
    err = np.abs(got - ref)
    assert (err <= rtol * scale).all(), (field, float(err.max()))


def _grads_close(got, ref, rtol=1e-8):
    got, ref = np.asarray(got).ravel(), np.asarray(ref).ravel()
    norm = np.linalg.norm(ref)
    assert norm > 0.0
    assert np.linalg.norm(got - ref) <= rtol * norm, \
        np.linalg.norm(got - ref) / norm
    big = np.abs(ref) > 1e-12 * norm
    assert (np.abs(got - ref)[big] <= rtol * np.abs(ref)[big]).all()


# ---------------------------------------------------------------------------
# Cases (tests/test_optimize.py:40-78), built in both packages
# ---------------------------------------------------------------------------
def _quiet_bands(mod):
    class QuietBands(mod.TimeBands):
        """Background load off: the analytic toy needs u to be the only
        load."""

        def background(self, band: str) -> float:
            return 0.0
    return QuietBands()


def toy_case(mod):
    """The two-band toy with a closed-form optimum (see
    tests/test_optimize.py): CO2* = dyn W^2 / (R^2 sum_i tau_i / c_i)."""
    m = mod.MachineProfile(idle_w=0.0, dyn_w=200.0, alpha=2.0, gamma=0.0)
    wl = mod.OEMWorkload("toy", 388_800, rate_at_full=10.0,
                         batch_overhead_s=0.0)
    carbon = mod.HourlySignal(tuple([1.0] * 12 + [0.2] * 12),
                              name="two-band")
    case = mod.SweepCase(mod.parametric_schedule(24), wl, m,
                         _quiet_bands(mod), carbon, start_hour=0.0,
                         deadline_h=24.0)
    tau = 12 * 3600.0
    co2_star = (m.dyn_w * wl.n_scenarios ** 2
                / (wl.rate_at_full ** 2 * tau * (1 / 1.0 + 1 / 0.2))) / 3.6e6
    return case, co2_star


def week_values():
    rng = np.random.RandomState(7)
    h = np.arange(168)
    return 0.448 * (1.0 + 0.30 * np.sin(2 * np.pi * h / 24.0)
                    + 0.08 * np.sin(2 * np.pi * h / 168.0)
                    + 0.05 * rng.randn(168))


def week_trace(mod):
    return mod.TraceSignal(tuple(float(v) for v in week_values()),
                           name="week")


def oem_case(mod, carbon=None, deadline_h=220.0):
    wl, m = mod.calibrate_workload(mod.OEM_CASE_1, mod.MachineProfile())
    return mod.SweepCase(mod.parametric_schedule(24), wl, m,
                         carbon=carbon if carbon is not None
                         else week_trace(mod), deadline_h=deadline_h)


def ensemble(mod):
    rng = np.random.RandomState(11)
    base = week_values()
    return mod.as_ensemble(base[None, :] * (1.0 + 0.15 * rng.randn(4, 168)),
                           name="ens4")


# name -> (case builder, TraceObjective kwargs builder)
OBJECTIVE_CASES = {
    "toy": (lambda mod: toy_case(mod)[0], lambda mod: dict(horizon_h=30.0)),
    "oem_week": (oem_case, lambda mod: {}),
    "price": (oem_case, lambda mod: dict(price=mod.TOU_PRICE)),
    "ensemble4": (lambda mod: oem_case(mod, carbon=ensemble(mod)),
                  lambda mod: {}),
    "sph2": (oem_case, lambda mod: dict(slots_per_hour=2)),
    "unfinished": (oem_case, lambda mod: dict(horizon_h=90.0)),
}


def _objectives(name, precision="fp64"):
    build, kw = OBJECTIVE_CASES[name]
    ref = R.TraceObjective(build(R), backend="jax", precision=precision,
                           **kw(R))
    got = P.TraceObjective(build(P), device="cpu", precision=precision,
                           **kw(P))
    return ref, got


def _population(n_slots, n=16, seed=0):
    return np.random.RandomState(seed).uniform(0.05, 1.0, (n, n_slots))


# ---------------------------------------------------------------------------
# 1. TraceObjective forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp64", "mixed"])
@pytest.mark.parametrize("name", list(OBJECTIVE_CASES))
def test_trace_objective_matches_reference(name, precision):
    ref64, got = _objectives(name, precision)
    assert got.horizon_h == ref64.horizon_h
    assert np.array_equal(got.rowidx, ref64.rowidx)
    U = _population(got.n_slots)
    ref_mixed = None
    if precision == "mixed":
        ref_mixed = ref64.evaluate_batch(U)
        ref64 = _objectives(name)[0]
    ref = ref64.evaluate_batch(U)
    out = got.evaluate_batch(U)
    rtol = 1e-9 if precision == "fp64" else 1e-6
    for f in FIELDS:
        _close(getattr(out, f), getattr(ref, f), rtol, f)
    if ref_mixed is not None:
        # held to the reference's fp64, and no further from it than the
        # reference's own mixed run (whose XLA fp32 physics can sit past
        # 1e-6 of fp64 here; ROADMAP Queue 3)
        for f in ("energy_kwh", "co2_kg", "runtime_h"):
            r = np.asarray(getattr(ref, f))
            assert (np.abs(getattr(out, f) - r).max()
                    <= np.abs(getattr(ref_mixed, f) - r).max()), f
    if name == "ensemble4":
        assert out.co2_kg.shape == (16, 4)
    if name == "unfinished":
        assert (out.unfinished > 0.1).all()
    if name == "price":
        assert (out.cost_usd > 0).all()


def test_evaluate_on_a_tensor_is_the_batch_evaluation():
    _, got = _objectives("oem_week")
    U = _population(24, n=3)
    batch = got.evaluate_batch(U)
    one = got.evaluate(torch.as_tensor(U[1]))
    assert isinstance(one.energy_kwh, torch.Tensor)
    for f in FIELDS:
        assert float(getattr(one, f)) == pytest.approx(
            float(getattr(batch, f)[1]), rel=1e-12, abs=1e-15)
    assert isinstance(got.evaluate(U).runtime_h, np.ndarray)


# ---------------------------------------------------------------------------
# 2. Gradients of the scalarized loss against jax.grad
# ---------------------------------------------------------------------------
def _loss_grads(name, objective, constraints=None, robust="mean", caps=None):
    """(jax.grad, torch.autograd) of scalarize(evaluate(u_from_logits(p)))
    at seeded logits; `caps` maps each framework to its own constraints
    (for the tie case)."""
    ref_to, got_to = _objectives(name)
    p0 = np.random.RandomState(5).randn(got_to.n_slots) * 0.5
    cons = caps or {"R": constraints, "P": constraints}
    robj = RO.Objective.coerce(objective, cons["R"])
    pobj = PO.Objective.coerce(objective, cons["P"])
    robj = dataclasses.replace(robj, robust=robust)
    pobj = dataclasses.replace(pobj, robust=robust)
    with enable_x64():
        def rloss(p):
            u = R.ParametricSchedule.u_from_logits(p, 0.05, 1.0, xp=jnp)
            return RO.scalarize(ref_to.evaluate(u), robj, SCALES, xp=jnp)
        rv, rg = jax.value_and_grad(rloss)(jnp.asarray(p0))
    p = torch.tensor(p0, requires_grad=True)
    u = P.ParametricSchedule.u_from_logits(p, 0.05, 1.0, xp=torch)
    val = PO.scalarize(got_to.evaluate(u), pobj, SCALES, xp=torch)
    (g,) = torch.autograd.grad(val, p)
    assert val.item() == pytest.approx(float(rv), rel=1e-9)
    return np.asarray(rg), g.numpy()


@pytest.mark.parametrize("name,objective,constraints,robust", [
    ("oem_week", "co2", {"runtime_h": 200.0}, "mean"),
    ("price", "cost", {"runtime_h": 230.0, "energy": 45.0}, "mean"),
    ("ensemble4", "co2", {"runtime_h": 230.0}, "cvar"),
    ("ensemble4", {"co2": 1.0, "energy": 0.5}, None, "worst"),
    ("toy", "co2", {"runtime_h": 24.0}, "mean"),
])
def test_loss_gradient_matches_jax_grad(name, objective, constraints,
                                        robust):
    rg, g = _loss_grads(name, objective, constraints, robust)
    _grads_close(g, rg)


def test_loss_gradient_at_an_exact_cap_splits_the_hinge():
    """u exactly on a runtime cap: `maximum(runtime / cap - 1, 0)` ties,
    and JAX gives the hinge half its gradient.  Each framework is put on
    its own cap (its own runtime value), and the port matches `jax.grad`;
    `clamp_min` would pass the whole hinge gradient, which sits 1e-1 away
    (the two one-sided gradients bracket the tie's)."""
    ref_to, got_to = _objectives("oem_week")
    p0 = np.random.RandomState(5).randn(24) * 0.5
    u0 = R.ParametricSchedule.u_from_logits(p0, 0.05, 1.0, xp=np)[None]
    cap_r = float(ref_to.evaluate_batch(u0).runtime_h[0])
    cap_p = float(got_to.evaluate_batch(u0).runtime_h[0])
    rg, g = _loss_grads("oem_week", "co2", caps={
        "R": {"runtime_h": cap_r}, "P": {"runtime_h": cap_p}})
    _grads_close(g, rg)
    _, over = _loss_grads("oem_week", "co2", {"runtime_h": cap_p * 0.999})
    _, under = _loss_grads("oem_week", "co2", {"runtime_h": cap_p * 1.001})
    assert np.linalg.norm(over - under) > 0.1 * np.linalg.norm(g)
    np.testing.assert_allclose(g, 0.5 * (over + under),
                               atol=2e-2 * np.linalg.norm(g))


# ---------------------------------------------------------------------------
# 3. FleetTraceObjective forward and gradient
# ---------------------------------------------------------------------------
def fleet_cases(mod, deadlines=(300.0, 480.0)):
    out = []
    for wl0, dl in zip((mod.OEM_CASE_1, mod.OEM_CASE_2), deadlines):
        wl, m = mod.calibrate_workload(wl0, mod.MachineProfile())
        out.append(mod.SweepCase(mod.parametric_schedule(24), wl, m,
                                 deadline_h=dl))
    return out


FLEET_OBJECTIVES = {
    0.40: ("co2", None),
    None: ({"co2": 1.0, "runtime": 0.2}, {"site_peak_kw": 0.52}),
}


@pytest.mark.parametrize("cap", [0.40, None])
def test_fleet_objective_matches_reference(cap):
    ref_fo = R.FleetTraceObjective(fleet_cases(R), site_cap_kw=cap,
                                   office_kw=0.12, backend="jax")
    got_fo = P.FleetTraceObjective(fleet_cases(P), site_cap_kw=cap,
                                   office_kw=0.12, device="cpu")
    U = np.random.RandomState(1).uniform(0.2, 1.0, (16, 2, 24))
    ref, got = ref_fo.evaluate_batch(U), got_fo.evaluate_batch(U)
    for f in FIELDS + ("site_peak_kw",):
        _close(getattr(got, f), getattr(ref, f), 1e-9, f)
    # gradient of the joint loss (deadlines as per-campaign caps; the
    # uncapped fleet plans under a peak budget with a makespan weight)
    objective, constraints = FLEET_OBJECTIVES[cap]
    robj = RO.Objective.coerce(objective, constraints)
    pobj = PO.Objective.coerce(objective, constraints)
    dls = [300.0, 480.0]
    p0 = np.random.RandomState(2).randn(2, 24) * 0.5
    with enable_x64():
        def rloss(p):
            u = R.ParametricSchedule.u_from_logits(p, 0.05, 1.0, xp=jnp)
            return RO.scalarize_fleet(ref_fo.evaluate(u), robj, SCALES, dls,
                                      xp=jnp)
        rv, rg = jax.value_and_grad(rloss)(jnp.asarray(p0))
    p = torch.tensor(p0, requires_grad=True)
    val = PO.scalarize_fleet(got_fo.evaluate(
        P.ParametricSchedule.u_from_logits(p, 0.05, 1.0, xp=torch)),
        pobj, SCALES, dls, xp=torch)
    (g,) = torch.autograd.grad(val, p)
    assert val.item() == pytest.approx(float(rv), rel=1e-9)
    _grads_close(g.numpy(), np.asarray(rg))


def test_fleet_passes_and_the_gradient_mask_hint():
    """The capped fleet's batched throttle passes start from every
    campaign active and stop within M + 1 passes without autograd, plus
    one with it for a gradient.  A gradient evaluation first tries the
    mask the last one of its shape converged to (one pass when it holds);
    neither a stale mask nor earlier calls change any value or gradient,
    and evaluations without a gradient always start from all active."""
    def fresh():
        return P.FleetTraceObjective(fleet_cases(P), site_cap_kw=0.40,
                                     office_kw=0.12, device="cpu")
    passes = []

    def counting(obj):
        inner = obj._pass

        def counted(*args):
            passes.append(torch.is_grad_enabled())
            return inner(*args)
        obj._pass = counted
        return obj

    def grad_of(obj, U):
        p = torch.tensor(np.log(U / (1.0 - U)), requires_grad=True)
        u = P.ParametricSchedule.u_from_logits(p, 0.0, 1.0, xp=torch)
        fm = obj.evaluate(u)
        return torch.autograd.grad(fm.co2_kg.sum() + fm.site_peak_kw, p)[0]

    rng = np.random.RandomState(4)
    U1 = rng.uniform(0.2, 1.0, (8, 2, 24))
    U2 = rng.uniform(0.05, 0.5, (8, 2, 24))
    fo = counting(fresh())
    first = fo.evaluate_batch(U2)
    del passes[:]
    g_fresh = grad_of(fo, U2[3])                 # no hint yet
    assert passes[-1] and not any(passes[:-1])
    assert 2 <= len(passes) <= fo.M + 2
    del passes[:]
    assert torch.equal(grad_of(fo, U2[3]), g_fresh)   # the hint holds
    assert passes == [True]
    del passes[:]
    again = fo.evaluate_batch(U2)
    assert 1 <= len(passes) <= fo.M + 1 and not any(passes)
    for f in first._fields:
        assert np.array_equal(getattr(first, f), getattr(again, f)), f
    grad_of(fo, U1[0])                           # leave a stale hint
    assert torch.equal(grad_of(fo, U2[3]), g_fresh)
    assert torch.equal(grad_of(fresh(), U2[3]), g_fresh)


def test_fleet_objective_checks_its_cases():
    cases = fleet_cases(P)
    with pytest.raises(ValueError, match="start_hour"):
        P.FleetTraceObjective([cases[0], dataclasses.replace(
            cases[1], start_hour=17.0)], device="cpu")
    with pytest.raises(ValueError, match="ensembles"):
        P.FleetTraceObjective([dataclasses.replace(
            cases[0], carbon=ensemble(P))], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        P.FleetTraceObjective([], device="cpu")


# ---------------------------------------------------------------------------
# 4. evaluate_params and pareto_front
# ---------------------------------------------------------------------------
def test_evaluate_params_matches_reference():
    p0 = np.random.RandomState(3).randn(24)
    ref = R.evaluate_params(p0, oem_case(R))
    got = P.evaluate_params(p0, oem_case(P), device="cpu")
    for f in FIELDS:
        _close(getattr(got, f), getattr(ref, f), 1e-9, f)
    p = torch.tensor(p0, requires_grad=True)
    on_tensor = P.evaluate_params(p, oem_case(P))
    (g,) = torch.autograd.grad(on_tensor.co2_kg, p)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert on_tensor.co2_kg.item() == pytest.approx(float(ref.co2_kg),
                                                    rel=1e-9)


@pytest.mark.parametrize("k", [2, 3])
def test_pareto_front_matches_reference(k):
    rng = np.random.RandomState(k)
    pts = np.round(rng.rand(64, k), 1)          # ties on every axis
    assert np.array_equal(P.pareto_front(pts), R.pareto_front(pts))
    pts = rng.rand(200, k)
    mask = P.pareto_front(pts)
    assert np.array_equal(mask, R.pareto_front(pts)) and mask.any()


# ---------------------------------------------------------------------------
# 5. The seeded population search
# ---------------------------------------------------------------------------
def test_cem_search_matches_reference():
    kw = dict(method="cem", candidates=16, iterations=3, seed=0)
    ref = R.optimize_schedule(oem_case(R), "energy", {"runtime_h": 220.0},
                              **kw)
    got = P.optimize_schedule(oem_case(P), "energy", {"runtime_h": 220.0},
                              device="cpu", **kw)
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-9)
    assert got.schedule.logits == ref.schedule.logits
    assert got.evaluations == ref.evaluations == 48
    assert got.value == pytest.approx(ref.value, rel=1e-9)
    for f in ("energy_kwh", "co2_kg", "runtime_h"):
        _close(getattr(got.result, f), getattr(ref.result, f), 1e-9, f)
        _close(getattr(got.metrics, f), getattr(ref.metrics, f), 1e-9, f)


def test_grad_search_follows_the_reference_trajectory():
    """Adam from the same start: the port's history and optimum stay
    within 1e-9 of the reference's (no step lands on a noise gradient
    here; the acceptance bars below hold the searches either way)."""
    kw = dict(method="grad", steps=60)
    ref = R.optimize_schedule(oem_case(R), "energy", {"runtime_h": 220.0},
                              **kw)
    got = P.optimize_schedule(oem_case(P), "energy", {"runtime_h": 220.0},
                              device="cpu", **kw)
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-9)
    np.testing.assert_allclose(got.schedule.logits, ref.schedule.logits,
                               rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# 6. The reference's acceptance tests, on the port
# ---------------------------------------------------------------------------
def test_grad_recovers_analytic_two_band_optimum():
    case, co2_star = toy_case(P)
    res = P.optimize_schedule(case, "co2", {"runtime_h": 24.0},
                              method="grad", u_min=0.02, u_max=1.0,
                              steps=800, lr=0.1, horizon_h=30.0,
                              device="cpu")
    assert res.metrics.unfinished < 1e-9
    assert res.metrics.runtime_h <= 24.0 * 1.005
    assert abs(res.metrics.co2_kg / co2_star - 1) < 0.01
    u = res.schedule.intensity_table()
    assert u[:12].mean() < 0.5 * u[12:].mean()
    assert res.history == sorted(res.history, reverse=True)


def test_runtime_cap_is_respected_as_epsilon_constraint():
    case, _ = toy_case(P)
    res = P.optimize_schedule(case, "energy", {"runtime_h": 14.0},
                              method="cem", u_min=0.02, u_max=1.0,
                              candidates=128, iterations=40, horizon_h=30.0,
                              seed=3, device="cpu")
    assert res.metrics.runtime_h <= 14.0 * 1.01
    assert res.metrics.unfinished < 1e-9


def test_optimizer_quantizes_to_levels():
    case, _ = toy_case(P)
    levels = (0.1, 0.3, 0.5, 0.7, 1.0)
    res = P.optimize_schedule(case, "co2", {"runtime_h": 24.0},
                              u_min=0.02, u_max=1.0, candidates=64,
                              iterations=10, horizon_h=30.0, seed=5,
                              levels=levels, device="cpu")
    assert res.method == "cem"                 # auto with levels
    u = res.schedule.intensity_table()
    assert all(any(v == lv for lv in levels) for v in u)
    assert res.metrics.runtime_h <= 24.0 * 1.01
    assert res.metrics.unfinished < 1e-9
    eng = P.trace_sweep([dataclasses.replace(case, schedule=res.schedule)],
                        device="cpu")[0]
    assert abs(eng.energy_kwh / res.result.energy_kwh - 1) < 1e-12
    with pytest.raises(ValueError, match="population"):
        P.optimize_schedule(case, "co2", method="grad", levels=(0.2, 0.9),
                            horizon_h=30.0, device="cpu")


def test_campaign_optimize_canonicalizes_constraint_aliases():
    c = P.Campaign(P.OEM_CASE_1)
    res = c.optimize("co2", constraints={"runtime": 150.0}, deadline_h=200.0,
                     method="cem", candidates=32, iterations=4, device="cpu")
    assert res.objective.constraints == {"runtime_h": 150.0}
    res2 = c.optimize("co2", constraints={"deadline": 150.0}, method="cem",
                      candidates=32, iterations=4, device="cpu")
    assert res2.objective.constraints == {"runtime_h": 150.0}


def test_campaign_optimize_warm_starts_from_parametric_incumbent():
    first = P.Campaign(P.OEM_CASE_1).optimize(
        "energy", deadline_h=210.0, method="cem", candidates=64,
        iterations=10, device="cpu")
    again = P.Campaign(P.OEM_CASE_1, first.schedule).optimize(
        "energy", deadline_h=210.0, method="cem", candidates=16,
        iterations=2, init_std=0.05, device="cpu")
    assert again.result.energy_kwh <= first.result.energy_kwh * 1.0001


def test_campaign_optimize_fills_deltas_and_matches_the_reference():
    kw = dict(deadline_h=200.0, method="cem", candidates=48, iterations=6,
              deltas=True)
    ref = R.Campaign(R.OEM_CASE_1).optimize("energy", **kw)
    c = P.Campaign(P.OEM_CASE_1)
    res = c.optimize("energy", device="cpu", **kw)
    assert res.result.policy.startswith("optimized[")
    assert res.objective.constraints == {"runtime_h": 200.0}
    assert res.result.energy_delta_pct != 0.0
    assert res.schedule.logits == ref.schedule.logits
    assert res.result.energy_delta_pct == pytest.approx(
        ref.result.energy_delta_pct, rel=1e-9)
    again = c.sweep([res.schedule], device="cpu")[0]
    assert abs(again.energy_kwh / res.result.energy_kwh - 1) < 1e-9


def test_fleet_optimize_beats_independent_under_shared_cap():
    c1, c2 = P.Campaign(P.OEM_CASE_1), P.Campaign(P.OEM_CASE_2)
    site = P.Site(power_cap_kw=0.40, office_kw=0.12)
    dls = [300.0, 480.0]
    res = P.Fleet([c1, c2], site).optimize(
        "co2", deadlines=dls, candidates=32, iterations=4, steps=40,
        device="cpu")
    assert res.method == "cem+grad"
    assert len(res.schedules) == 2 and len(res.independent) == 2
    cases = [P.SweepCase(r.schedule, *c.calibrated(), site.bands,
                         P.GridCarbonModel(), 9.0, label=r.schedule.name,
                         deadline_h=d)
             for r, c, d in zip(res.independent, (c1, c2), dls)]
    ind = P.fleet_sweep([cases], site, names=["independent"],
                        device="cpu")[0]
    assert res.site.co2_kg <= ind.site.co2_kg + 1e-9
    for r, d in zip(res.results, dls):
        assert r.runtime_h <= d * 1.02
    assert res.site.peak_kw is not None
    assert float(np.max(res.metrics.unfinished)) < 1e-6


def test_unported_backend_and_default_device():
    case, _ = toy_case(P)
    for call in (lambda: P.TraceObjective(case, backend="jax"),
                 lambda: P.FleetTraceObjective([case], backend="numpy"),
                 lambda: P.optimize_schedule(case, backend="numpy"),
                 lambda: P.optimize_fleet([case], backend="jax"),
                 lambda: P.Campaign(P.OEM_CASE_1).optimize(backend="numpy"),
                 lambda: P.evaluate_params(np.zeros(24), case,
                                           backend="jax")):
        with pytest.raises(NotImplementedError, match="backend"):
            call()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.optimize_schedule(case, method="cem", candidates=4, iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.Fleet([P.Campaign(P.OEM_CASE_1)]).optimize(method="cem")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.Campaign(P.OEM_CASE_1).optimize(method="cem")
