"""The PyTorch port's persistent plan cache and incremental re-sweeps held
against the JAX package on the CPU: `core/plancache.py`, the layered
compile cache of `compile_plan(cache_dir=...)`, `replace_tables`,
`delta_sweep` and `plan_cache_info`/`clear_plan_cache`.

The reference's own acceptance tests (tests/test_plancache.py) are
carried over to the port: a warm start reads every compile artifact off
disk and reproduces the cold results bitwise, also in a fresh process;
corrupt entries and a schema bump recompile; opaque schedules bypass
both layers; the memo and the disk store are LRU-bounded; `delta_sweep`
re-scans only what a delta changed (a capped group whole) and splices
the rest bitwise.  The XLA compilation-cache tests have no counterpart:
the port compiles no XLA program.

Added for the port: `delta_sweep` and `compile_plan -> execute_plan`
after a disk hit within 1e-9 relative per field of the reference, with
the same re-scanned/spliced partition; and one store shared by the two
packages, where each reads only its own entries.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.carina as R  # noqa: E402
from repro.core import engine_jax as rej  # noqa: E402
from repro.core import plancache as rpc  # noqa: E402
import repro_torch.carina as P  # noqa: E402
from repro_torch.core import engine_torch as ej  # noqa: E402
from repro_torch.core import plancache  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def calibrated():
    return P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())


@pytest.fixture(autouse=True)
def _no_env_cache(monkeypatch):
    """Keep an ambient CARINA_PLAN_CACHE* out of every test: caching is
    exercised only through explicit cache_dir= arguments here."""
    monkeypatch.delenv("CARINA_PLAN_CACHE", raising=False)
    monkeypatch.delenv("CARINA_PLAN_CACHE_MB", raising=False)


def _res_key(r):
    return (r.runtime_h, r.energy_kwh, r.co2_kg, r.cost_usd)


def _week_trace(mod, seed: int = 3):
    rng = np.random.RandomState(seed)
    h = np.arange(96)
    vals = 0.45 * (1.0 + 0.3 * np.sin(2 * np.pi * h / 24.0)
                   + 0.05 * rng.rand(96))
    return mod.TraceSignal(tuple(float(v) for v in vals), name=f"trace{seed}")


def _cases(calibrated, n, scenarios=600.0, mod=P):
    """n distinct small cases (distinct constant schedules, one shared
    non-periodic trace)."""
    wl, m = calibrated
    wl = dataclasses.replace(wl, n_scenarios=float(scenarios))
    trace = _week_trace(mod)
    us = np.linspace(0.35, 1.0, n)
    return [mod.SweepCase(mod.constant_schedule(float(u)), wl, m,
                          carbon=trace, label=f"u{j}")
            for j, u in enumerate(us)]


def _both_cases(n, scenarios=600.0):
    """The same n cases built in the reference (first) and in the port."""
    return tuple(_cases(mod.calibrate_workload(mod.OEM_CASE_1,
                                               mod.MachineProfile()),
                        n, scenarios, mod) for mod in (R, P))


def _close_results(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for f in ("runtime_h", "energy_kwh", "co2_kg"):
            a, b = getattr(g, f), getattr(r, f)
            assert abs(a - b) <= RTOL * abs(b), (g.policy, f, a, b)


# ---------------------------------------------------------------------------
# Acceptance: disk warm start does zero classification/lowering work
# ---------------------------------------------------------------------------
def test_disk_cache_warm_start_zero_work_bitwise(calibrated, tmp_path):
    cases = _cases(calibrated, 5)
    d = str(tmp_path / "store")
    ej.clear_plan_cache()
    cold = P.trace_sweep(cases, cache_dir=d, **CPU)
    s = ej.scan_stats()
    assert s.plan_misses == len(cases)
    assert s.disk_misses == len(cases)
    # a fresh process in all but name: the memo is gone, the disk stays
    ej.clear_plan_cache()
    warm = P.trace_sweep(cases, cache_dir=d, **CPU)
    s = ej.scan_stats()
    assert s.plan_misses == 0, "warm start must not compile anything"
    assert s.disk_hits == len(cases)
    for a, b in zip(cold, warm):
        assert _res_key(a) == _res_key(b)


def test_fleet_warm_start_across_processes(tmp_path):
    """A second identical coupled fleet sweep in a *fresh python
    process* does zero classification/lowering work and reproduces the
    cold results bitwise."""
    d = str(tmp_path / "store")
    script = textwrap.dedent("""
        import dataclasses, json, sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import repro_torch.carina as P
        from repro_torch.core import engine_torch as ej

        wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
        wl = dataclasses.replace(wl, n_scenarios=600.0)
        rng = np.random.RandomState(3)
        h = np.arange(96)
        vals = 0.45 * (1.0 + 0.3 * np.sin(2 * np.pi * h / 24.0)
                       + 0.05 * rng.rand(96))
        trace = P.TraceSignal(tuple(float(v) for v in vals), name="trace3")
        groups = [[P.SweepCase(P.constant_schedule(u), wl, m, carbon=trace,
                               label=f"u{j}")
                   for j, u in enumerate((0.5, 0.8, 1.0))]]
        site = P.Site(power_cap_kw=2.0)
        res = P.fleet_sweep(groups, site, cache_dir=sys.argv[1],
                            device="cpu")
        s = ej.scan_stats()
        print(json.dumps({
            "co2": [r.co2_kg for r in res[0].campaigns],
            "runtime": [r.runtime_h for r in res[0].campaigns],
            "peak": res[0].site.peak_kw,
            "plan_misses": s.plan_misses, "disk_hits": s.disk_hits}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("CARINA_PLAN_CACHE", None)
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", script, d], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["plan_misses"] == 3 and cold["disk_hits"] == 0
    assert warm["plan_misses"] == 0, "fresh process must warm-start"
    assert warm["disk_hits"] == 3
    assert warm["co2"] == cold["co2"]
    assert warm["runtime"] == cold["runtime"]
    assert warm["peak"] == cold["peak"]


def test_corrupted_entries_recompile_never_crash(calibrated, tmp_path):
    cases = _cases(calibrated, 3)
    d = str(tmp_path / "store")
    ej.clear_plan_cache()
    cold = P.trace_sweep(cases, cache_dir=d, **CPU)
    cache = plancache.get_cache(d)
    entries = cache._entries()
    assert entries, "the store should hold entries after a cold sweep"
    for e in entries:
        with open(e.path, "wb") as f:
            f.write(b"not an npz archive")
    ej.clear_plan_cache()
    again = P.trace_sweep(cases, cache_dir=d, **CPU)
    s = ej.scan_stats()
    assert s.plan_misses == len(cases), "corrupt entries must recompile"
    for a, b in zip(cold, again):
        assert _res_key(a) == _res_key(b)
    # the corrupt files were dropped and replaced by fresh writes
    for e in cache._entries():
        with open(e.path, "rb") as f:
            assert f.read(2) == b"PK"


def test_schema_version_salt_invalidates(calibrated, tmp_path, monkeypatch):
    cases = _cases(calibrated, 2)
    d = str(tmp_path / "store")
    ej.clear_plan_cache()
    P.trace_sweep(cases, cache_dir=d, **CPU)
    monkeypatch.setattr(plancache, "SCHEMA_VERSION",
                        plancache.SCHEMA_VERSION + 1)
    ej.clear_plan_cache()
    P.trace_sweep(cases, cache_dir=d, **CPU)
    s = ej.scan_stats()
    assert s.disk_hits == 0, "a version bump must orphan old entries"
    assert s.plan_misses == len(cases)


def test_opaque_schedule_bypasses_both_layers(calibrated, tmp_path):
    """A closure-bearing schedule has no value identity: it must compile
    fresh every time (no memo hit, no disk entry — the store cannot be
    poisoned by an object that can change behind its key)."""
    wl, m = calibrated
    wl = dataclasses.replace(wl, n_scenarios=400.0)
    knob = {"u": 0.7}
    sched = P.FunctionSchedule("closure", lambda ctx: knob["u"])
    case = P.SweepCase(sched, wl, m, carbon=_week_trace(P))
    d = str(tmp_path / "store")
    ej.clear_plan_cache()
    r1 = P.trace_sweep([case], cache_dir=d, **CPU)
    r2 = P.trace_sweep([case], cache_dir=d, **CPU)
    s = ej.scan_stats()
    assert s.plan_hits == 0 and s.disk_hits == 0
    assert s.plan_misses == 2, "opaque cases compile fresh every sweep"
    assert plancache.get_cache(d).info() == (0, 0), "no entry stored"
    assert _res_key(r1[0]) == _res_key(r2[0])
    # the closure really is live: mutating it changes the next sweep
    knob["u"] = 0.4
    r3 = P.trace_sweep([case], cache_dir=d, **CPU)
    assert r3[0].runtime_h > r1[0].runtime_h


def test_memo_true_lru_hit_refreshes_recency(calibrated, monkeypatch):
    """An entry hit recently must survive the eviction sweep even if it
    was compiled first."""
    monkeypatch.setattr(ej, "_PLAN_CACHE_SIZE", 4)
    cases = _cases(calibrated, 5)
    ej.clear_plan_cache()
    P.trace_sweep([cases[0]], **CPU)             # oldest by insertion
    for c in cases[1:4]:
        P.trace_sweep([c], **CPU)                # memo now full (4)
    P.trace_sweep([cases[0]], **CPU)             # hit -> young end
    assert ej.scan_stats().plan_hits == 1
    P.trace_sweep([cases[4]], **CPU)             # evicts oldest quarter
    ej._STATS.plan_hits = 0
    ej._STATS.plan_misses = 0
    P.trace_sweep([cases[0]], **CPU)
    s = ej.scan_stats()
    assert s.plan_hits == 1 and s.plan_misses == 0, \
        "the recently-hit entry must have survived eviction"
    # and the insertion-order victim is really gone
    P.trace_sweep([cases[1]], **CPU)
    assert ej.scan_stats().plan_misses == 1


def test_disk_lru_eviction_bounds_store(calibrated, tmp_path):
    cases = _cases(calibrated, 12)
    d = str(tmp_path / "store")
    ej.clear_plan_cache()
    cold = P.trace_sweep(cases, cache_dir=d, **CPU)
    cache = plancache.get_cache(d)
    n0, bytes0 = cache.info()
    assert n0 > 0
    # shrink the bound below the current footprint and trigger a sweep
    small = plancache.PlanCache(d, max_bytes=max(bytes0 // 2, 1))
    small._evict()
    n1, bytes1 = small.info()
    assert bytes1 <= small.max_bytes
    assert n1 < n0, "the oldest entries must have been swept"
    # a sweep against the thinned store still works (partial hits +
    # recompiles) and stays bitwise
    ej.clear_plan_cache()
    warm = P.trace_sweep(cases, cache_dir=d, **CPU)
    for a, b in zip(cold, warm):
        assert _res_key(a) == _res_key(b)


def test_plan_cache_info_and_clear(calibrated, tmp_path):
    cases = _cases(calibrated, 4)
    d = str(tmp_path / "store")
    ej.clear_plan_cache()
    P.trace_sweep(cases, cache_dir=d, **CPU)
    ej.clear_plan_cache()                        # memo gone, disk stays
    P.trace_sweep(cases, cache_dir=d, **CPU)
    info = P.plan_cache_info(cache_dir=d)
    assert info.mem_entries == len(cases) and info.mem_bytes > 0
    assert info.disk_entries > 0 and info.disk_bytes > 0
    assert info.hits >= len(cases) and info.misses == 0
    assert info.hit_rate == 1.0
    P.clear_plan_cache()
    s = ej.scan_stats()
    assert (s.plan_hits, s.plan_misses, s.disk_hits, s.disk_misses,
            s.lanes_recomputed, s.lanes_spliced) == (0, 0, 0, 0, 0, 0)
    info = P.plan_cache_info(cache_dir=d)
    assert info.mem_entries == 0 and info.hit_rate == 0.0
    assert info.disk_entries > 0, "clear_plan_cache leaves disk alone"


def test_reset_scan_stats_zeroes_the_recurrence_counters(calibrated):
    cases = _cases(calibrated, 3)
    plan = P.compile_plan(cases)
    cur = P.execute_interval(plan, until_slot=5, **CPU)
    P.replace_tables(plan, cur, schedules={1: P.constant_schedule(0.5)})
    s = P.scan_stats(reset=True)
    assert s.replans == 1 and s.slots_reused == 5 * plan.n_lanes
    s = P.scan_stats()
    assert (s.replans, s.slots_reused, s.disk_hits, s.disk_misses,
            s.lanes_recomputed, s.lanes_spliced) == (0,) * 6


def test_env_var_resolves_the_store(calibrated, tmp_path, monkeypatch):
    """``CARINA_PLAN_CACHE`` stands in for an explicit cache_dir, and
    ``Campaign(cache_dir=...)`` reaches the store through its sweep."""
    cases = _cases(calibrated, 2)
    d = str(tmp_path / "env-store")
    monkeypatch.setenv("CARINA_PLAN_CACHE", d)
    ej.clear_plan_cache()
    P.trace_sweep(cases, **CPU)
    assert plancache.get_cache(None).root == os.path.abspath(d)
    assert P.plan_cache_info().disk_entries > 0
    monkeypatch.delenv("CARINA_PLAN_CACHE")
    d2 = str(tmp_path / "campaign-store")
    ej.clear_plan_cache()
    c = P.Campaign(P.OEM_CASE_1, cache_dir=d2)
    c.sweep([P.deadline_schedule(200.0)], **CPU)
    assert ej.scan_stats().disk_misses == 1
    assert P.plan_cache_info(d2).disk_entries > 0


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------
def test_compile_execute_after_a_disk_hit_matches_reference(tmp_path):
    """`compile_plan -> execute_plan` served from the disk store gives
    the reference's results within 1e-9 (and the cold run's bitwise)."""
    ref_cases, cases = _both_cases(6)
    d = str(tmp_path / "store")
    ej.clear_plan_cache()
    plan = P.compile_plan(cases, cache_dir=d)
    cold = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    ej.clear_plan_cache()
    plan = P.compile_plan(cases, cache_dir=d)
    s = ej.scan_stats()
    assert s.disk_hits == len(cases) and s.plan_misses == 0
    warm = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    assert [_res_key(r) for r in warm] == [_res_key(r) for r in cold]
    rplan = rej.compile_plan(ref_cases)
    ref = rej.summarize_plan(rplan, rej.execute_plan(rplan, backend="numpy"))
    _close_results(warm, ref)


def _delta_variants(mod, cases):
    """(label, compile_plan kwargs, delta kwargs) of the delta cases."""
    return [
        ("one schedule", {}, dict(schedules={3: mod.constant_schedule(0.42)})),
        ("three schedules", {},
         dict(schedules=[None, mod.constant_schedule(0.5), None, None,
                         mod.constant_schedule(0.9),
                         mod.constant_schedule(0.61)])),
        ("carbon", {}, dict(carbon={2: _week_trace(mod, seed=11)})),
        ("capped group", dict(group_sizes=[3, 3],
                              group_caps_kw=[2.0, None]),
         dict(schedules={0: mod.constant_schedule(0.55)})),
        ("value-identical", {},
         dict(schedules=[c.schedule for c in cases])),
    ]


@pytest.mark.parametrize("variant", range(5))
def test_delta_sweep_matches_reference(variant):
    """The port's `delta_sweep` against the reference's on the same
    delta: results per field within 1e-9 relative, the same partition
    into re-scanned and spliced cases, and the same lane counters."""
    ref_cases, cases = _both_cases(6)
    label, ckw, ref_delta = _delta_variants(R, ref_cases)[variant]
    _, _, delta = _delta_variants(P, cases)[variant]
    rplan = rej.compile_plan(ref_cases, **ckw)
    rprev = rej.summarize_plan(rplan, rej.execute_plan(rplan,
                                                       backend="numpy"))
    rej.reset_scan_stats()
    rout = rej.delta_sweep(rplan, rprev, backend="numpy", **ref_delta)
    rst = rej.scan_stats()
    plan = P.compile_plan(cases, **ckw)
    prev = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    _close_results(prev, rprev)
    ej.reset_scan_stats()
    out = P.delta_sweep(plan, prev, **delta, **CPU)
    st = ej.scan_stats()
    assert out.recomputed == rout.recomputed, label
    assert out.spliced == rout.spliced, label
    assert (st.lanes_recomputed, st.lanes_spliced) == \
        (rst.lanes_recomputed, rst.lanes_spliced)
    _close_results(out.results, rout.results)
    if out.recomputed and st.grouped_lanes:
        assert label == "capped group"


def test_replace_tables_matches_reference_mid_flight(calibrated):
    """A re-plan mid-flight: the restacked tables equal the reference's,
    the unchanged lanes keep theirs, and the resumed state matches."""
    ref_cases, cases = _both_cases(4, scenarios=3000.0)
    rplan, plan = rej.compile_plan(ref_cases), P.compile_plan(cases)
    rcur = rej.execute_interval(rplan, until_slot=30, backend="numpy")
    cur = P.execute_interval(plan, until_slot=30, **CPU)
    rnew = rej.replace_tables(rplan, rcur,
                              schedules={1: R.progress_ramp_schedule(0.3,
                                                                     0.8)})
    new = P.replace_tables(plan, cur,
                           schedules={1: P.progress_ramp_schedule(0.3, 0.8)})
    np.testing.assert_array_equal(new.tab_u, rnew.tab_u)
    np.testing.assert_array_equal(new.tab_b, rnew.tab_b)
    assert new.lane_table[0] is plan.lane_table[0]
    assert new.grids is plan.grids
    assert new.cases[1].schedule.name == rnew.cases[1].schedule.name
    rend = rej.execute_interval(rnew, rcur, backend="numpy")
    end = P.execute_interval(new, cur, **CPU)
    _close_results(P.summarize_plan(new, end.state),
                   rej.summarize_plan(rnew, rend.state))


def test_two_packages_share_one_store(tmp_path):
    """A reference store and a port store in one directory: each package
    reads only its own entries (the port's are salted and tagged with
    its package), and both still give their right results."""
    ref_cases, cases = _both_cases(4)
    d = str(tmp_path / "shared")
    rej.clear_plan_cache()
    ej.clear_plan_cache()
    rcold = R.trace_sweep(ref_cases, cache_dir=d, backend="numpy")
    n_ref, _ = plancache.get_cache(d).info()
    assert n_ref > 0
    cold = P.trace_sweep(cases, cache_dir=d, **CPU)
    s = ej.scan_stats()
    assert s.disk_hits == 0 and s.plan_misses == len(cases), \
        "the port must not read the reference's entries"
    n_both, _ = plancache.get_cache(d).info()
    assert n_both == 2 * n_ref, "each package writes its own entries"
    # a second cycle of each, from disk only
    rej.clear_plan_cache()
    ej.clear_plan_cache()
    rwarm = R.trace_sweep(ref_cases, cache_dir=d, backend="numpy")
    rs = rej.scan_stats()
    assert rs.plan_misses == 0 and rs.disk_hits == len(ref_cases)
    warm = P.trace_sweep(cases, cache_dir=d, **CPU)
    s = ej.scan_stats()
    assert s.plan_misses == 0 and s.disk_hits == len(cases)
    assert [_res_key(r) for r in rwarm] == [_res_key(r) for r in rcold]
    assert [_res_key(r) for r in warm] == [_res_key(r) for r in cold]
    _close_results(warm, rwarm)
    assert plancache.get_cache(d).info()[0] == n_both, \
        "neither package deleted the other's entries"
    # digests differ for the same frozen value, and a foreign entry at
    # the port's own name reads as a miss and stays in place
    key = ("same", 1.0)
    assert plancache.fingerprint_digest(key) != rpc.fingerprint_digest(key)
    port = plancache.get_cache(d)
    foreign = rpc.PlanCache(d)
    name = port._path(plancache.fingerprint_digest(key), "case")
    foreign._store(name, {"c": {}}, {})
    assert port.get_case(key) is None and os.path.exists(name)


# ---------------------------------------------------------------------------
# Acceptance: delta_sweep recomputes ~K/S of the slot work, bitwise
# ---------------------------------------------------------------------------
def test_delta_sweep_1_of_100_slot_work_and_bitwise(calibrated):
    S = 100
    cases = _cases(calibrated, S)
    plan = P.compile_plan(cases)
    ej.reset_scan_stats()
    state = P.execute_plan(plan, **CPU)
    base_work = ej.scan_stats().slot_work
    prev = P.summarize_plan(plan, state)

    new_sched = P.constant_schedule(0.42)
    ej.reset_scan_stats()
    delta = P.delta_sweep(plan, prev, schedules={7: new_sched}, **CPU)
    s = ej.scan_stats()
    assert s.lanes_recomputed == 1 and s.lanes_spliced == S - 1
    assert s.slot_work <= 0.02 * base_work, (
        f"1-of-{S} delta re-scanned {s.slot_work}/{base_work} slot units")
    assert delta.recomputed == (7,)
    assert len(delta.spliced) == S - 1

    full_cases = list(cases)
    full_cases[7] = dataclasses.replace(cases[7], schedule=new_sched)
    ref = P.trace_sweep(full_cases, **CPU)
    for a, b in zip(delta.results, ref):
        assert _res_key(a) == _res_key(b)
    # the returned plan is the delta base for the *next* cycle
    assert delta.plan.cases[7].schedule is new_sched


def test_delta_sweep_noop_delta_splices_everything(calibrated):
    cases = _cases(calibrated, 6)
    plan = P.compile_plan(cases)
    prev = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    ej.reset_scan_stats()
    # an "update" that fingerprints identically to the incumbent — e.g.
    # the orchestrator re-sends every schedule each cycle
    delta = P.delta_sweep(plan, prev, schedules=[c.schedule for c in cases],
                          **CPU)
    s = ej.scan_stats()
    assert delta.recomputed == ()
    assert s.lanes_recomputed == 0 and s.lanes_spliced == plan.n_lanes
    assert s.slot_work == 0, "a value-identical delta must scan nothing"
    assert [_res_key(r) for r in delta.results] == \
        [_res_key(r) for r in prev]


def test_delta_sweep_carbon_delta_rescans_its_cases(calibrated):
    cases = _cases(calibrated, 4)
    plan = P.compile_plan(cases)
    prev = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    new_trace = _week_trace(P, seed=11)
    ej.reset_scan_stats()
    delta = P.delta_sweep(plan, prev, carbon={2: new_trace}, **CPU)
    assert delta.recomputed == (2,)
    full_cases = list(cases)
    full_cases[2] = dataclasses.replace(cases[2], carbon=new_trace)
    ref = P.trace_sweep(full_cases, **CPU)
    for a, b in zip(delta.results, ref):
        assert _res_key(a) == _res_key(b)


def test_delta_sweep_coupled_group_rescans_whole(calibrated):
    """A changed member of a site-capped group drags the whole group into
    the re-scan (lanes interact through the cap every slot); uncapped
    cases in the same plan still splice."""
    cases = _cases(calibrated, 5)
    plan = P.compile_plan(cases, group_sizes=[3, 2],
                          group_caps_kw=[2.0, None])
    prev = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    new_sched = P.constant_schedule(0.55)
    ej.reset_scan_stats()
    delta = P.delta_sweep(plan, prev, schedules={0: new_sched}, **CPU)
    s = ej.scan_stats()
    assert delta.recomputed == (0, 1, 2), "the capped group goes whole"
    assert delta.spliced == (3, 4)
    assert s.lanes_recomputed == 3 and s.lanes_spliced == 2
    assert s.grouped_lanes > 0, "the re-scan runs the coupled kernel"
    full_cases = list(cases)
    full_cases[0] = dataclasses.replace(cases[0], schedule=new_sched)
    full_plan = P.compile_plan(full_cases, group_sizes=[3, 2],
                               group_caps_kw=[2.0, None])
    ref = P.summarize_plan(full_plan, P.execute_plan(full_plan, **CPU))
    for a, b in zip(delta.results, ref):
        assert _res_key(a) == _res_key(b)


def test_delta_sweep_revalidates_ensemble_width(calibrated):
    wl, m = calibrated
    wl = dataclasses.replace(wl, n_scenarios=400.0)
    ens = P.as_ensemble([_week_trace(P, 1), _week_trace(P, 2)], name="e2")
    cases = [P.SweepCase(P.constant_schedule(0.8), wl, m, carbon=ens)]
    plan = P.compile_plan(cases)
    prev = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    with pytest.raises(ValueError, match="ensemble width"):
        P.delta_sweep(plan, prev, carbon={0: _week_trace(P, 9)}, **CPU)


def test_delta_sweep_rejects_mismatched_results(calibrated):
    cases = _cases(calibrated, 3)
    plan = P.compile_plan(cases)
    prev = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    with pytest.raises(ValueError, match="full result list"):
        P.delta_sweep(plan, prev[:-1],
                      schedules={0: P.constant_schedule(0.5)}, **CPU)


def test_delta_sweep_refuses_unported_knobs(calibrated):
    cases = _cases(calibrated, 2)
    plan = P.compile_plan(cases)
    prev = P.summarize_plan(plan, P.execute_plan(plan, **CPU))
    for kw in (dict(backend="numpy"), dict(devices=2)):
        with pytest.raises(NotImplementedError):
            P.delta_sweep(plan, prev, **kw, **CPU)


def test_subset_plan_refuses_split_coupled_group(calibrated):
    cases = _cases(calibrated, 3)
    plan = P.compile_plan(cases, group_sizes=[3], group_caps_kw=[2.0])
    with pytest.raises(ValueError, match="whole"):
        ej._subset_plan(plan, [1])
