"""The PyTorch port's trace-scan engine held against the JAX package on
the CPU: the plain version of the uncoupled chunk kernel (K2) against
the reference's jitted and NumPy chunk steps, the executors on one
lowered plan carried across with `plan_from_numpy` (uncoupled and
coupled, chunked and monolithic, fp64 and mixed), the lowering itself,
and `Campaign.sweep(carbon_trace=...)` end to end (input builders from
tests/test_torch_kernels.py).

Tolerances: fp64 per lane within 1e-9 relative (the two frameworks
round `pow` and fused multiply-adds differently; measured ~1e-15);
`precision="mixed"` within 1e-6 relative of fp64 (the reference's own
bar for its fp32-physics policy).  The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.carina as R  # noqa: E402
import repro_torch.carina as P  # noqa: E402
from repro.compat import enable_x64  # noqa: E402
from repro.core import engine_jax as ref_engine  # noqa: E402
from repro_torch.core import engine_torch  # noqa: E402
from repro_torch.kernels import scan_chunk as k2  # noqa: E402
from test_torch_kernels import (RTOL, chunk_inputs, close,  # noqa: E402
                                k2_tensors)



def _week(scale=0.448):
    rng = np.random.RandomState(7)
    h = np.arange(168)
    return tuple(float(v) for v in scale * (
        1.0 + 0.30 * np.sin(2 * np.pi * h / 24.0)
        + 0.08 * np.sin(2 * np.pi * h / 168.0) + 0.05 * rng.randn(168)))


@pytest.fixture(scope="module")
def calibrated():
    return (R.calibrate_workload(R.OEM_CASE_1, R.MachineProfile()),
            P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile()))


# ---------------------------------------------------------------------------
# K2: the plain chunk step vs the reference's chunk steps
# ---------------------------------------------------------------------------
def _k2_plain(ins, state, scalars, dtype=torch.float64):
    return [o.numpy() for o in k2.scan_chunk(
        *k2_tensors(ins, state, scalars, dtype), B=ins[0].shape[2])]


@pytest.mark.parametrize("B", [1, 4])
def test_plain_scan_chunk_matches_reference_chunk_steps(B):
    ins, state, scalars = chunk_inputs(B)
    got = _k2_plain(ins, state, scalars)
    ref_np = ref_engine._scan_chunk_np(*ins, state, scalars, B)
    with enable_x64():
        import jax.numpy as jnp
        ref_jax = ref_engine._scan_chunk_jax(
            *(jnp.asarray(a) for a in ins + state + scalars), B=B)
    n = scalars[0]
    for ref in (ref_np, [np.asarray(o) for o in ref_jax]):
        close(got[0], ref[0], RTOL, scale=n)          # remaining
        for g, r in zip(got[1:], ref[1:]):
            close(g, r, RTOL)
    assert got[0][2] <= 1e-6 * n[2] and got[0][0] > 0  # finished / not


@pytest.mark.parametrize("B", [1, 4])
def test_plain_scan_chunk_mixed_within_1e6_of_fp64(B):
    ins, state, scalars = chunk_inputs(B, seed=1)
    ref = ref_engine._scan_chunk_np(*ins, state, scalars, B)
    got = _k2_plain(ins, state, scalars, dtype=torch.float32)
    assert all(g.dtype == np.float64 for g in got)     # fp64 carried state
    close(got[0], ref[0], 1e-6, scale=scalars[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, 1e-6)


# ---------------------------------------------------------------------------
# Executors: one lowered plan, two executors
# ---------------------------------------------------------------------------
def _carry(plan):
    """The port's plan from a reference plan's arrays (signals as hourly
    samples from hour 0 over the whole horizon)."""
    N = plan.max_days * 24 + 48
    hours = np.arange(N, dtype=float)
    fields = {k: getattr(plan, k) for k in engine_torch._PLAN_ARRAYS}
    fields.update(
        sph=plan.sph, max_days=plan.max_days, precision=plan.precision,
        carbon=np.stack([[R.sample_signal(s, hours) for s in sigs]
                         for sigs in plan.lane_co2_sigs]),
        price=(R.sample_signal(plan.price, hours)
               if plan.price is not None else None),
        lane_case=plan.lane_case, lane_member=plan.lane_member,
        lane_group=plan.lane_group, group_cap_kw=plan.group_cap_kw,
        group_office_kw=plan.group_office_kw,
        names=[c.name() for c in plan.cases], est_h=plan.est_h)
    return engine_torch.plan_from_numpy(fields)


def _plain_cases(mod, wl, m):
    trace = mod.TraceSignal(_week(), name="week")
    return [mod.SweepCase(mod.BASELINE, wl, m, carbon=trace),
            mod.SweepCase(mod.PEAK_AWARE_BOOSTED, wl, m, carbon=trace,
                          start_hour=3.5),
            mod.SweepCase(mod.progress_ramp_schedule(0.4, 0.9), wl, m,
                          carbon=trace),
            mod.SweepCase(mod.constant_schedule(0.7),
                          dataclasses.replace(wl, n_scenarios=400_000), m,
                          carbon=mod.GridCarbonModel(
                              hourly_curve=mod.MIDWEST_HOURLY))]


def _coupled_cases(mod, wl, m):
    wl2 = dataclasses.replace(wl, n_scenarios=2_400_000)
    site = mod.Site(power_cap_kw=0.40, office_kw=0.12)
    trace = mod.TraceSignal(_week(), name="week")
    return [mod.SweepCase(s, w, m, site.bands, trace, 9.0)
            for s, w in zip((mod.BASELINE, mod.PEAK_AWARE_BOOSTED,
                             mod.constant_schedule(0.8), mod.BASELINE,
                             mod.progress_ramp_schedule(0.5, 1.0)),
                            (wl, wl2, wl, wl2, wl))]


def _assert_states(got, ref, plan, rtol):
    n = plan.n_scen
    close(got.remaining, ref.remaining, rtol, scale=n)
    for f in ("runtime_s", "kwh", "co2", "cost"):
        close(getattr(got, f), getattr(ref, f), rtol)
    if ref.site_kw_peak is not None:
        close(got.site_kw_peak, ref.site_kw_peak, rtol)


@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("mode", ["chunked", "monolithic"])
def test_executor_matches_reference_on_a_carried_plan(calibrated, coupled,
                                                      mode):
    (wl, m), _ = calibrated
    if coupled:
        plan = ref_engine.compile_plan(
            _coupled_cases(R, wl, m), R.TOU_PRICE, progress_buckets=8,
            group_sizes=[2, 3], group_caps_kw=[0.40, 0.40],
            group_office_kw=[0.12, 0.12])
    else:
        plan = ref_engine.compile_plan(_plain_cases(R, wl, m), R.TOU_PRICE,
                                       progress_buckets=8)
    ref = ref_engine.execute_plan(plan, mode=mode, devices=1,
                                  pallas="interpret" if coupled else None)
    port = _carry(plan)
    assert port.coupled == coupled
    got = engine_torch.execute_plan(port, mode=mode, device="cpu",
                                    chunk_days=2)
    _assert_states(got, ref, plan, RTOL)
    if coupled:                       # the jnp kernel agrees too
        _assert_states(got, ref_engine.execute_plan(plan, devices=1,
                                                    pallas="off"),
                       plan, RTOL)


@pytest.mark.parametrize("coupled", [False, True])
def test_mixed_precision_within_1e6_of_fp64(calibrated, coupled):
    _, (wl, m) = calibrated
    kw = (dict(group_sizes=[2, 3], group_caps_kw=[0.40, 0.40],
               group_office_kw=[0.12, 0.12]) if coupled else {})
    cases = (_coupled_cases if coupled else _plain_cases)(P, wl, m)
    ref = engine_torch.compile_plan(cases, progress_buckets=8, **kw)
    mixed = engine_torch.compile_plan(cases, progress_buckets=8,
                                      precision="mixed", **kw)
    a = engine_torch.execute_plan(ref, device="cpu")
    engine_torch.reset_scan_stats()
    b = engine_torch.execute_plan(mixed, device="cpu")
    assert engine_torch.scan_stats().precision_mode == "mixed"
    for f in ("kwh", "co2", "runtime_s"):
        close(getattr(b, f), getattr(a, f), 1e-6)


def test_carried_plan_needs_its_arrays():
    with pytest.raises(ValueError, match="needs the fields"):
        engine_torch.plan_from_numpy({"tab_u": np.zeros((1, 24, 1))})


# ---------------------------------------------------------------------------
# Lowering: the port's compile_plan builds the reference's tables
# ---------------------------------------------------------------------------
def _lowering_cases(mod, wl, m):
    trace = mod.TraceSignal(_week(), name="week")
    ens = mod.SignalEnsemble((mod.TraceSignal(_week(), name="a"),
                              mod.TraceSignal(_week(0.5), name="b")))
    m2 = mod.MachineProfile(idle_w=120.0, dyn_w=300.0, alpha=1.5, gamma=0.5)
    return [
        [mod.SweepCase(p, wl, m) for p in mod.POLICIES.values()]
        + [mod.SweepCase(mod.deadline_schedule(200.0), wl, m, carbon=trace),
           mod.SweepCase(mod.progress_ramp_schedule(0.4, 0.9), wl, m,
                         carbon=trace, start_hour=3.0),
           mod.SweepCase(mod.BASELINE, wl, m2, carbon=trace,
                         start_hour=17.0)],
        [mod.SweepCase(mod.BASELINE, wl, m, carbon=ens),
         mod.SweepCase(mod.CarbonGateSchedule(0.45), wl, m, carbon=ens)],
        [mod.SweepCase(mod.PEAK_AWARE_BOOSTED, wl, m,
                       bands=mod.TimeBands(peak=((14.5, 19),),
                                           load_sensitive=((11, 14.5),
                                                           (19, 21))))],
    ]


def test_lowering_matches_reference(calibrated):
    (wl, m), (pwl, pm) = calibrated
    sphs = (1, 1, 2)
    for ref_cases, port_cases, sph in zip(_lowering_cases(R, wl, m),
                                          _lowering_cases(P, pwl, pm), sphs):
        ref = ref_engine.compile_plan(ref_cases, slots_per_hour=sph,
                                      progress_buckets=8)
        got = engine_torch.compile_plan(port_cases, slots_per_hour=sph,
                                        progress_buckets=8)
        for f in engine_torch._PLAN_ARRAYS + (
                "lane_case", "lane_member", "lane_periodic", "lane_group",
                "group_cap_kw", "group_office_kw"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          err_msg=f)
        assert (got.E, got.tab_buckets, got.est_h, got.case_expanded) == \
            (ref.E, ref.tab_buckets, ref.est_h, ref.case_expanded)
        active = np.arange(ref.n_lanes)
        for t0 in (0, 48 * sph):
            for a, b in zip(engine_torch._chunk_inputs(got, active, t0,
                                                       48 * sph),
                            ref_engine._chunk_inputs(ref, active, t0,
                                                     48 * sph)):
                np.testing.assert_array_equal(a, b)


def test_lowering_matches_reference_on_scaleout_cases():
    wl1, m = R.calibrate_workload(R.OEM_CASE_1, R.MachineProfile())
    pwl1, pm = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    plans = []
    for mod, w1, mm, comp in ((R, wl1, m, ref_engine.compile_plan),
                              (P, pwl1, pm, engine_torch.compile_plan)):
        w2 = dataclasses.replace(mod.OEM_CASE_2, rate_at_full=w1.rate_at_full)
        scheds = [mod.BASELINE, mod.PEAK_AWARE_BOOSTED,
                  mod.constant_schedule(0.6), mod.constant_schedule(0.8),
                  mod.constant_schedule(0.95), mod.constant_schedule(0.7)]
        unc = comp([mod.SweepCase(s, w, mm, carbon=mod.GridCarbonModel())
                    for s, w in zip(scheds, [w1, w2] * 3)])
        site = mod.Site(power_cap_kw=0.40, office_kw=0.12)
        cpl = comp([mod.SweepCase(s, w, mm, site.bands, mod.GridCarbonModel(),
                                  9.0)
                    for s, w in zip((mod.BASELINE, mod.PEAK_AWARE_BOOSTED,
                                     mod.constant_schedule(0.8),
                                     mod.BASELINE), (w1, w2, w1, w2))],
                   group_sizes=[2, 2], group_caps_kw=[0.40] * 2,
                   group_office_kw=[0.12] * 2)
        plans.append((unc, cpl))
    for ref, got in zip(plans[0], plans[1]):
        for f in engine_torch._PLAN_ARRAYS + ("lane_group", "group_cap_kw",
                                              "group_office_kw"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        assert got.coupled == ref.coupled


# ---------------------------------------------------------------------------
# The slice end to end: Campaign.sweep over a week-long carbon trace
# ---------------------------------------------------------------------------
def test_campaign_sweep_carbon_trace_matches_reference():
    week = _week()
    ref = R.Campaign(R.OEM_CASE_1).sweep(list(R.POLICIES.values()),
                                         carbon_trace=week)
    engine_torch.reset_scan_stats()
    got = P.Campaign(P.OEM_CASE_1).sweep(list(P.POLICIES.values()),
                                         carbon_trace=week, device="cpu")
    st = P.scan_stats()
    assert st.chunks > 0 and st.device == "cpu"
    assert st.kernel_dispatches == {"scan_chunk": 0, "coupled_chunk": 0}
    for a, b in zip(ref, got):
        assert a.policy == b.policy
        for f in ("runtime_h", "energy_kwh", "co2_kg"):
            assert abs(getattr(b, f) / getattr(a, f) - 1) < RTOL, (a.policy,
                                                                   f)
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    exact = P.simulate_campaign_exact(wl, P.BASELINE, m,
                                      carbon=P.TraceSignal(week))
    assert abs(got[0].co2_kg / exact.co2_kg - 1) < 0.005


def test_campaign_sweep_carbon_ensemble_matches_reference():
    ens = [_week(), _week(0.5), _week(0.3)]
    ref = R.Campaign(R.OEM_CASE_1).sweep(
        [R.BASELINE, R.CarbonGateSchedule(0.45)], carbon_ensemble=ens)
    got = P.Campaign(P.OEM_CASE_1).sweep(
        [P.BASELINE, P.CarbonGateSchedule(0.45)], carbon_ensemble=ens,
        device="cpu")
    for a, b in zip(ref, got):
        assert abs(b.co2_kg / a.co2_kg - 1) < RTOL
        close(b.co2_ensemble.samples, a.co2_ensemble.samples, RTOL)
    assert got[1].runtime_ensemble is not None
