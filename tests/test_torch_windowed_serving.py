"""The PyTorch port's windowed serving (`core/serve.py`: `ServingWindow`,
the three serving policies, `execute_assignment`, `serve_window`,
`ServingSession.submit/tick/drain/rollup`) held against the JAX package
on the CPU.

Assignment is host NumPy carried over unchanged, so every policy's
`Assignment` (slot, tier, finish time, the (tier, slot) demand block)
must equal the reference's bit for bit.  Execution runs the port's
`compile_plan -> execute_plan -> summarize_plan` with `device="cpu"`
(the plain PyTorch versions of K2, and of K1 under a `Site`); the
reference executes on its NumPy engine (`backend="numpy"`, the
reference's own schedule-search backend for the optimized policy).
Window totals, every lane's fields and the per-request energy/CO2
attribution are held within 1e-9 relative.

Also carried over from tests/test_serving.py on the port: the vectorized
FIFO against the per-request loop oracle, the pinned fixed-seed CO2
figures (greedy and optimized beat FIFO at equal, zero, SLO misses), a
million-request day as one chunk, the session lifecycle, the serving
counters, `degrade=False`, attribution sums; plus the refused knobs, the
default device, and the whole public surface of `repro.carina`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.carina as R  # noqa: E402
import repro.core.serve as RS  # noqa: E402
import repro_torch.carina as P  # noqa: E402
import repro_torch.core.serve as PS  # noqa: E402
from repro.core import engine_jax  # noqa: E402
from repro_torch.core import engine_torch  # noqa: E402

RTOL = 1e-9
CPU = dict(device="cpu")
N_SMALL = 2_000
STREAM = dict(slack_h=(4.0, 12.0), camel_fracs=(0.2, 0.55),
              tier_mix=(0.8, 0.15, 0.05))


def _midwest(mod):
    return mod.HourlySignal(tuple(float(v) * mod.DTE_FACTOR
                                  for v in mod.MIDWEST_HOURLY))


def _sessions(**kw):
    """(reference, port) sessions on the same settings (the reference's
    tests/test_serving.py defaults: Midwest x DTE carbon, 6 am start);
    the reference's windows execute on its NumPy engine."""
    kw.setdefault("service_rate", 0.6)
    kw.setdefault("start_hour", 6.0)
    ref_kw, port_kw = dict(kw), dict(kw)
    for k in ("policy", "site"):
        if k in kw and callable(kw[k]):
            ref_kw[k], port_kw[k] = kw[k](R), kw[k](P)
    ref = R.ServingSession(carbon=_midwest(R), backend="numpy", **ref_kw)
    return ref, P.ServingSession(carbon=_midwest(P), device="cpu", **port_kw)


def _rel_ok(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    return bool(np.all(np.abs(got - ref) <= rtol * np.abs(ref)))


def _hold_assignment(got, ref):
    assert got.policy == ref.policy
    for f in ("slot", "tier", "t_finish_h", "demand"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _hold_report(got, ref):
    """The port's `WindowReport` against the reference's: assignment
    bitwise, counts equal, totals, lanes and the per-request
    attribution within 1e-9 relative."""
    _hold_assignment(got.assignment, ref.assignment)
    for f in ("policy", "t0_h", "window_h", "n_requests", "n_admitted",
              "n_rejected", "n_degraded", "n_slo_miss"):
        assert getattr(got, f) == getattr(ref, f), f
    assert np.array_equal(got.slo_ok, ref.slo_ok)
    for f in ("energy_kwh", "co2_kg", "cost_usd", "peak_kw"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert _rel_ok(a, b), (f, a, b)
    assert [r.policy for r in got.lanes] == [r.policy for r in ref.lanes]
    for a, b in zip(got.lanes, ref.lanes):
        for f in ("runtime_h", "energy_kwh", "co2_kg"):
            assert _rel_ok(getattr(a, f), getattr(b, f)), (a.policy, f)
    assert got.schedule.name == ref.schedule.name
    for f in ("request_energy_kwh", "request_co2_kg"):
        assert _rel_ok(getattr(got, f), getattr(ref, f)), f


def _pair_window(policy, batch_kw, **sess_kw):
    """One window scheduled and executed by both packages on the same
    seeded arrivals; returns (port report, reference report)."""
    rs, ps = _sessions(**sess_kw)
    rb = R.arrival_stream(**batch_kw)
    pb = P.arrival_stream(**batch_kw)
    for f in ("t_arrive_h", "deadline_h", "work", "tier"):
        assert np.array_equal(getattr(pb, f), getattr(rb, f)), f
    rpol = policy(R) if callable(policy) else policy
    ppol = policy(P) if callable(policy) else policy
    ref = R.serve_window(rb, rs.window(), policy=rpol, site=rs.site,
                         backend="numpy")
    got = P.serve_window(pb, ps.window(), policy=ppol, site=ps.site, **CPU)
    return got, ref


# ---------------------------------------------------------------------------
# every policy, every load shape: assignments bitwise, the rest 1e-9
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", R.LOAD_SHAPES)
@pytest.mark.parametrize("policy", ["fifo", "greedy", "optimized"])
def test_window_matches_the_reference(policy, shape):
    got, ref = _pair_window(
        policy, dict(n=N_SMALL, shape=shape, seed=42, **STREAM),
        service_rate=N_SMALL * 3e-5)
    _hold_report(got, ref)
    assert got.n_admitted > 0 and got.co2_kg > 0.0


def test_window_under_a_binding_site_cap_matches_the_reference():
    """A `Site` runs the window's tier lanes as one coupled group (the
    plain version of K1 here); the cap binds: the peak under 0.3 kW is
    below the peak under a cap the window cannot reach."""
    def site(cap):
        return lambda mod: mod.Site(power_cap_kw=cap, office_kw=0.12)

    kw = dict(n=N_SMALL, shape="peak", seed=7, **STREAM)
    got, ref = _pair_window("greedy", kw, service_rate=N_SMALL * 3e-5,
                            site=site(0.3))
    _hold_report(got, ref)
    free, _ = _pair_window("greedy", kw, service_rate=N_SMALL * 3e-5,
                           site=site(1e3))
    assert got.peak_kw < free.peak_kw
    assert got.co2_kg != free.co2_kg


def test_window_with_a_price_and_sub_hour_slots_matches_the_reference():
    got, ref = _pair_window(
        "greedy", dict(n=N_SMALL, horizon_h=12.0, shape="camel", seed=3,
                       **STREAM),
        service_rate=N_SMALL * 3e-5, window_h=12.0, slots_per_hour=2)
    _hold_report(got, ref)
    rs, ps = _sessions(service_rate=1.0)
    priced = dict(n=500, shape="random", seed=1)
    ref = R.serve_window(R.arrival_stream(**priced), R.ServingWindow.build(
        6.0, 24.0, workload=rs.workload, machine=rs.machine, bands=rs.bands,
        carbon_sig=rs.carbon_sig, price=R.TOU_PRICE), backend="numpy")
    got = P.serve_window(P.arrival_stream(**priced), P.ServingWindow.build(
        6.0, 24.0, workload=ps.workload, machine=ps.machine, bands=ps.bands,
        carbon_sig=ps.carbon_sig, price=P.TOU_PRICE), **CPU)
    assert got.cost_usd is not None
    _hold_report(got, ref)


def test_window_context_matches_the_reference():
    rs, ps = _sessions(service_rate=3.0, slots_per_hour=4, window_h=6.0)
    rw, pw = rs.window(), ps.window()
    for f in ("t0_h", "window_h", "sph", "fill_frac", "batch_size"):
        assert getattr(pw, f) == getattr(rw, f), f
    for f in ("slot_hours", "carbon", "background", "cap_work", "budgets"):
        assert np.array_equal(getattr(pw, f), getattr(rw, f)), f
    assert np.array_equal(PS._day_slot_index(pw), RS._day_slot_index(rw))
    with pytest.raises(ValueError, match="window_h must be in"):
        ps.window_h = 30.0
        ps.window()
    with pytest.raises(ValueError, match="whole number of slots"):
        P.ServingWindow.build(0.0, 1.5, workload=ps.workload,
                              machine=ps.machine, bands=ps.bands,
                              carbon_sig=ps.carbon_sig)


# ---------------------------------------------------------------------------
# FIFO: vectorized == per-request loop oracle (both packages)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,seed", [("random", 0), ("peak", 1),
                                        ("camel", 2)])
def test_fifo_matches_the_loop_oracle_and_the_reference(shape, seed):
    rs, ps = _sessions(service_rate=0.05)        # tight: forces rejections
    batch = P.arrival_stream(5000, shape=shape, seed=seed,
                             tier_mix=(0.8, 0.2))
    asn = P.FifoServingPolicy().assign(batch, ps.window(), P.DEFAULT_TIERS)
    loop = PS._fifo_assign_loop(batch, ps.window(), P.DEFAULT_TIERS)
    assert np.array_equal(asn.slot, loop.slot)
    assert asn.demand.sum() == pytest.approx(loop.demand.sum())
    assert asn.n_admitted < batch.n              # the overload bites
    ref = RS._fifo_assign_loop(batch, rs.window(), R.DEFAULT_TIERS)
    _hold_assignment(loop, ref)


# ---------------------------------------------------------------------------
# the headline, pinned as the reference pins it
# ---------------------------------------------------------------------------
def test_greedy_and_optimized_beat_fifo_on_co2_pinned():
    rs, ps = _sessions()
    kw = dict(n=20000, shape="camel", seed=3, camel_fracs=(0.2, 0.55),
              slack_h=(4.0, 12.0))
    batch, rbatch = P.arrival_stream(**kw), R.arrival_stream(**kw)
    got = {p: P.serve_window(batch, ps.window(), policy=p, **CPU)
           for p in ("fifo", "greedy", "optimized")}
    for p, r in got.items():
        assert r.n_admitted == batch.n, p
        assert r.n_slo_miss == 0, p
        _hold_report(r, R.serve_window(rbatch, rs.window(), policy=p,
                                       backend="numpy"))
    fifo, greedy, opt = (got[p].co2_kg
                         for p in ("fifo", "greedy", "optimized"))
    assert greedy < 0.9 * fifo and opt < 0.9 * fifo
    assert fifo == pytest.approx(3.3977, rel=0.02)
    assert greedy == pytest.approx(2.7872, rel=0.02)
    assert opt == pytest.approx(2.7251, rel=0.02)


def test_policies_are_reproducible_and_seeded():
    _, ps = _sessions()
    w = ps.window()
    batch = P.arrival_stream(8000, shape="peak", seed=11,
                             tier_mix=(0.7, 0.3), slack_h=(2.0, 10.0))
    for policy in ("fifo", "greedy",
                   P.OptimizedServingPolicy(candidates=24, iterations=4)):
        pol = P.as_serving_policy(policy)
        a1 = pol.assign(batch, w, P.DEFAULT_TIERS, seed=0, **CPU)
        a2 = pol.assign(batch, w, P.DEFAULT_TIERS, seed=0, **CPU)
        _hold_assignment(a1, a2)
    ref = RS.OptimizedServingPolicy(candidates=24, iterations=4).assign(
        batch, _sessions()[0].window(), R.DEFAULT_TIERS, seed=5)
    got = P.OptimizedServingPolicy(candidates=24, iterations=4).assign(
        batch, w, P.DEFAULT_TIERS, seed=5, **CPU)
    _hold_assignment(got, ref)


def test_optimized_policy_takes_the_device_of_the_call(monkeypatch):
    """`serve_window` hands its device to the policy: with no card, an
    optimized window on the CPU searches on the CPU, where the default
    device would raise."""
    _, ps = _sessions()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pol = P.OptimizedServingPolicy(candidates=8, iterations=2)
    batch = P.arrival_stream(300, shape="random", seed=4)
    rep = P.serve_window(batch, ps.window(), policy=pol, **CPU)
    assert rep.policy == "optimized" and rep.n_admitted > 0
    with pytest.raises(ValueError, match="unknown serving policy"):
        P.as_serving_policy("edf")
    with pytest.raises(TypeError, match="serving policy"):
        P.as_serving_policy(3)


# ---------------------------------------------------------------------------
# scale: 1M requests/day in one chunk
# ---------------------------------------------------------------------------
def test_million_request_day_is_one_chunk():
    n = 1_000_000
    _, ps = _sessions(service_rate=30.0, policy="greedy")
    ps.submit(n=n, shape="camel", seed=5, slack_h=(4.0, 12.0))
    P.reset_scan_stats()
    rep = ps.tick()
    st = P.scan_stats()
    assert st.requests_seen == n
    assert st.requests_admitted == rep.n_admitted == n
    assert st.chunks == 1
    assert rep.n_slo_miss == 0
    assert rep.co2_kg > 0 and rep.energy_kwh > 0
    assert rep.request_co2_kg.sum() == pytest.approx(rep.co2_kg, rel=1e-9)


# ---------------------------------------------------------------------------
# session lifecycle, counters, degrade, attribution
# ---------------------------------------------------------------------------
def test_session_submit_tick_drain_rollup_matches_the_reference():
    rs, ps = _sessions(policy="greedy", seed=9)
    for s in (rs, ps):
        s.submit(n=300, shape="random")
        s.submit(n=400, shape="peak")
    assert ps.pending == 2
    assert ps._queue[0].t_arrive_h[0] != ps._queue[1].t_arrive_h[0]
    r1 = ps.tick()
    assert ps.pending == 1 and r1.t0_h == 6.0
    rs.tick()
    roll, rroll = ps.drain(), rs.drain()
    assert ps.pending == 0 and roll.n_windows == 2
    assert roll.n_requests == 700
    for got, ref in zip(ps.reports, rs.reports):
        _hold_report(got, ref)
    assert ps.reports[1].t0_h == 30.0
    for f in ("n_requests", "n_admitted", "n_rejected", "n_degraded",
              "n_slo_miss", "n_windows", "cost_usd", "peak_kw"):
        assert getattr(roll, f) == getattr(rroll, f), f
    for f in ("energy_kwh", "co2_kg"):
        assert _rel_ok(getattr(roll, f), getattr(rroll, f)), f
    assert roll.slo_miss_rate == rroll.slo_miss_rate
    with pytest.raises(ValueError, match="submit"):
        ps.tick()
    _, short = _sessions(window_h=6.0)
    with pytest.raises(ValueError, match="exceeds the session window"):
        short.submit(P.arrival_stream(10, horizon_h=24.0))
    with pytest.raises(ValueError, match="not both"):
        short.submit(P.arrival_stream(10, horizon_h=6.0), n=3)


def test_serving_counters_match_the_reference_and_reset():
    rs, ps = _sessions(service_rate=0.02)        # heavy overload
    kw = dict(n=500, shape="peak", seed=0, tier_mix=(0.5, 0.3, 0.2),
              slack_h=(1.0, 4.0), mean_work=10.0)
    rs.submit(**kw)
    ps.submit(**kw)
    engine_jax.reset_scan_stats()
    P.reset_scan_stats()
    rep = ps.tick()
    rs.tick()
    st, rst = P.scan_stats(), engine_jax.scan_stats()
    got = (st.requests_seen, st.requests_admitted, st.requests_rejected,
           st.requests_degraded)
    assert got == (rst.requests_seen, rst.requests_admitted,
                   rst.requests_rejected, rst.requests_degraded)
    assert got == (500, rep.n_admitted, rep.n_rejected, rep.n_degraded)
    assert rep.n_rejected > 0 and rep.n_degraded > 0
    P.reset_scan_stats()
    z = P.scan_stats()
    assert (z.requests_seen, z.requests_admitted, z.requests_rejected,
            z.requests_degraded) == (0, 0, 0, 0)
    assert engine_torch._STATS.requests_seen == 0


def test_degrade_off_keeps_requested_tiers():
    kw = dict(n=400, shape="peak", seed=2, tier_mix=(0.5, 0.5),
              slack_h=(1.0, 4.0), mean_work=10.0)
    strict, ref = _pair_window(
        lambda mod: mod.GreedyServingPolicy(degrade=False),
        kw, service_rate=0.02)
    _hold_report(strict, ref)
    assert strict.n_degraded == 0
    loose, _ = _pair_window("greedy", kw, service_rate=0.02)
    assert loose.n_degraded > 0
    assert loose.n_admitted >= strict.n_admitted


def test_request_attribution_sums_to_window_totals():
    _, ps = _sessions(policy="greedy")
    ps.submit(n=1000, shape="camel", seed=4, tier_mix=(0.8, 0.2))
    rep = ps.tick()
    assert rep.request_energy_kwh.sum() == pytest.approx(rep.energy_kwh,
                                                         rel=1e-9)
    assert rep.request_co2_kg.sum() == pytest.approx(rep.co2_kg, rel=1e-9)
    assert np.all(rep.request_energy_kwh[rep.assignment.slot < 0] == 0.0)
    lanes = {r.policy for r in rep.lanes}
    assert lanes == {"greedy/full", "greedy/reduced"}


def test_an_empty_window_executes_nothing():
    _, ps = _sessions()
    w = ps.window()
    asn = P.Assignment("none", np.full(3, -1), np.zeros(3, dtype=np.int64),
                       np.full(3, np.inf), np.zeros((3, w.n_slots)))
    lanes, alloc, peak = P.execute_assignment(asn, w, P.DEFAULT_TIERS, **CPU)
    assert lanes == [] and peak is None
    assert alloc.name == "serving[none]"


# ---------------------------------------------------------------------------
# refused knobs, the default device, the public surface
# ---------------------------------------------------------------------------
def test_unported_knobs_raise():
    _, ps = _sessions()
    w = ps.window()
    batch = P.arrival_stream(50, shape="random", seed=0)
    asn = P.FifoServingPolicy().assign(batch, w, P.DEFAULT_TIERS)
    with pytest.raises(NotImplementedError, match="backend"):
        P.serve_window(batch, w, backend="numpy", **CPU)
    with pytest.raises(NotImplementedError, match="backend"):
        P.execute_assignment(asn, w, P.DEFAULT_TIERS, backend="jax", **CPU)
    with pytest.raises(NotImplementedError, match="devices > 1"):
        P.execute_assignment(asn, w, P.DEFAULT_TIERS, devices=2, **CPU)
    with pytest.raises(NotImplementedError, match="backend"):
        P.OptimizedServingPolicy(backend="numpy")
    with pytest.raises(NotImplementedError, match="backend"):
        P.ServingSession(backend="numpy")
    with pytest.raises(TypeError):
        P.execute_assignment(asn, w, P.DEFAULT_TIERS, pallas=True, **CPU)


def test_the_default_device_is_the_card(monkeypatch):
    """With no card, every windowed entry point raises instead of
    running on the CPU; the live mode needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sess = P.ServingSession(service_rate=0.6)
    w = sess.window()
    batch = sess.submit(n=50, shape="random", seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sess.tick()
    assert sess.pending == 1                  # the window stays queued
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.serve_window(batch, w)
    asn = P.FifoServingPolicy().assign(batch, w, P.DEFAULT_TIERS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.execute_assignment(asn, w, P.DEFAULT_TIERS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.OptimizedServingPolicy(candidates=4, iterations=1).assign(
            batch, w, P.DEFAULT_TIERS)
    assert sess.gate_open()
    assert sess.record_tick(1.0) > 0


def test_every_public_name_of_the_reference_is_ported():
    """No public name of `repro.carina`, eager or lazy (`_LAZY`), is
    missing from `repro_torch.carina`."""
    ref = {n for n in dir(R) if not n.startswith("_")} | set(R._LAZY)
    port = {n for n in dir(P) if not n.startswith("_")}
    assert len(ref) == 168
    assert sorted(ref - port) == []
