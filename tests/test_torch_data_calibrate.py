"""The PyTorch port's grid data (`core/data.py`), zone sweeps (`zones=`,
`window_h=`, `stride_h=` on `Campaign.sweep` and `Fleet.sweep`) and
measured-run calibration (`core/calibrate.py`, `Campaign.calibrate`)
held against the JAX package on the CPU.

* Data: every bundled sample archive and a set of synthetic ones (gaps
  under each policy, DST folds and skips, sub-hourly cadence, g / kg /
  lb units, JSON) load to `ZoneSeries` and `QualityReport`s equal to
  the reference's; the port's copies of the samples are byte-identical
  to the reference's.
* Zones: the port's zone sweeps (traces, sliding-window ensembles,
  raw-series mappings, fleets with and without a site cap) within 1e-9
  relative of the reference's, labels and order equal, and bitwise equal
  to the port's own per-zone loop.
* Calibration: `backend="numpy"` (the finite-difference mirror) bitwise
  equal to the reference's, bootstrap intervals included; the default
  autograd fit within 1e-6 relative of the reference's `backend="jax"`
  fit per parameter (the reading, 2.2e-16 on the CPU, is printed by
  `test_autograd_fit_follows_the_reference_jax_fit`); both recover the
  truth within the reference's 2 % bar; `apply=True`, `units=`, the
  refused `backend="jax"` and the default device.
"""
import dataclasses
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.carina as R  # noqa: E402
import repro.core.calibrate as RC  # noqa: E402
import repro_torch.carina as P  # noqa: E402
import repro_torch.core.calibrate as PC  # noqa: E402
import repro_torch.core.data as PD  # noqa: E402

RTOL = 1e-9
CPU = dict(device="cpu")


# ----------------------------------------------------------------------
# grid data
# ----------------------------------------------------------------------
def _hold_archive(got, ref):
    assert got.name == ref.name and got.zones == ref.zones
    for z in ref.zones:
        a, b = got[z], ref[z]
        assert (a.zone, a.values, a.start) == (b.zone, b.values, b.start), z
        assert dataclasses.asdict(a.quality) == dataclasses.asdict(b.quality)
        assert a.quality.clean == b.quality.clean


@pytest.mark.parametrize("name", R.SAMPLE_ARCHIVES)
def test_sample_archives_load_as_the_reference(name):
    assert P.SAMPLE_ARCHIVES == R.SAMPLE_ARCHIVES
    assert filecmp.cmp(P.sample_archive_path(name),
                       R.sample_archive_path(name), shallow=False)
    assert os.path.dirname(P.sample_archive_path(name)) == PD.samples_dir()
    assert "repro_torch" in PD.samples_dir()
    _hold_archive(P.load_sample_archive(name), R.load_sample_archive(name))
    for policy in P.GAP_POLICIES[:2]:
        _hold_archive(P.load_sample_archive(name, gap_policy=policy),
                      R.load_sample_archive(name, gap_policy=policy))


SYNTHETIC = {
    "plain": dict(zones=("A", "B", "C"), days=3, seed=1),
    "gap-interpolate": dict(zones=("A",), days=4, seed=2, gap=(30, 5)),
    "dst-both-g": dict(zones=("A", "B"), days=3, seed=3, dst="both",
                       unit="g"),
    "subhourly-lb": dict(zones=("A",), days=2, seed=4, cadence_min=15,
                         unit="lb"),
    "no-unit-column": dict(zones=("A",), days=2, seed=5, unit="g",
                           include_unit_column=False),
}


@pytest.mark.parametrize("ext", [".csv", ".json"])
@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_archives_write_and_load_as_the_reference(tmp_path, case,
                                                            ext):
    kw = SYNTHETIC[case]
    got = P.write_synthetic_archive(str(tmp_path / f"p{ext}"), **kw)
    ref = R.write_synthetic_archive(str(tmp_path / f"r{ext}"), **kw)
    assert filecmp.cmp(got, ref, shallow=False)
    for policy in ("interpolate", "hold"):
        _hold_archive(P.load_carbon_archive(got, gap_policy=policy),
                      R.load_carbon_archive(got, gap_policy=policy))
    if "gap" in kw:
        with pytest.raises(ValueError):
            P.load_carbon_archive(got, gap_policy="raise")
        arch = P.load_carbon_archive(got)
        with pytest.raises(ValueError, match="repaired gap"):
            arch["A"].to_ensemble(4)


def test_archive_errors_as_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError, match="no bundled sample"):
        P.sample_archive_path("nope.csv")
    with pytest.raises(ValueError, match="gap_policy"):
        P.load_sample_archive("grid_week_3z.csv", gap_policy="guess")
    p = P.write_synthetic_archive(str(tmp_path / "one.csv"), zones=("Z",))
    arch = P.load_carbon_archive(p, zone="Z")
    assert arch.zones == ("Z",)
    tr, rtr = arch.to_trace(), R.load_carbon_archive(p).to_trace()
    assert tr.values == rtr.values and tr.start_hour == rtr.start_hour
    ens, rens = arch.to_ensemble(24, 12), R.load_carbon_archive(
        p).to_ensemble(24, 12)
    assert [(m.values, m.start_hour) for m in ens.members] == \
        [(m.values, m.start_hour) for m in rens.members]
    cm = arch["Z"].to_carbon_model(source="synthetic")
    assert (cm.zone, cm.source) == ("Z", "synthetic")
    assert cm.factor_kg_per_kwh == R.load_carbon_archive(p)["Z"] \
        .to_carbon_model().factor_kg_per_kwh


# ----------------------------------------------------------------------
# the zone axis
# ----------------------------------------------------------------------
SCHEDS = ("c0.4", "c0.85", "boosted")


def _scheds(mod):
    return [mod.constant_schedule(0.4), mod.constant_schedule(0.85),
            mod.PEAK_AWARE_BOOSTED]


def _campaign(mod, cache_dir=None):
    wl = mod.OEMWorkload("zsweep", 40_000, rate_at_full=2.3,
                         batch_overhead_s=2.0)
    return mod.Campaign(wl, cache_dir=cache_dir)


@pytest.fixture(scope="module")
def arches():
    return (P.load_sample_archive("grid_week_3z.csv"),
            R.load_sample_archive("grid_week_3z.csv"))


def _key(r):
    return (r.runtime_h, r.energy_kwh, r.co2_kg)


def _hold_rows(got, ref):
    assert [r.policy for r in got] == [r.policy for r in ref]
    for a, b in zip(got, ref):
        for f in ("runtime_h", "energy_kwh", "co2_kg"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= RTOL * abs(y), (a.policy, f, x, y)
        assert (a.co2_ensemble is None) == (b.co2_ensemble is None)
        if b.co2_ensemble is not None:
            assert np.allclose(a.co2_ensemble.samples,
                               b.co2_ensemble.samples, rtol=RTOL, atol=0)


def test_zone_sweep_matches_the_reference_and_the_per_zone_loop(arches):
    arch, rarch = arches
    rows = _campaign(P).sweep(_scheds(P), zones=arch, **CPU)
    _hold_rows(rows, _campaign(R).sweep(_scheds(R), zones=rarch))
    assert [r.policy for r in rows] == [
        f"{s.name}@{z}" for z in arch.zones for s in _scheds(P)]
    for z in arch.zones:
        solo = _campaign(P).sweep(_scheds(P),
                                  carbon_trace=arch[z].to_trace(), **CPU)
        batched = [r for r in rows if r.policy.endswith(f"@{z}")]
        assert [_key(a) for a in batched] == [_key(b) for b in solo]


def test_zone_sweep_through_the_plan_store_is_bitwise(arches, tmp_path):
    arch, _ = arches
    P.clear_plan_cache()
    cold = _campaign(P, str(tmp_path)).sweep(_scheds(P), zones=arch, **CPU)
    P.clear_plan_cache()
    warm = _campaign(P, str(tmp_path)).sweep(_scheds(P), zones=arch, **CPU)
    st = P.scan_stats()
    assert st.disk_hits == 9 and st.disk_misses == 0
    assert [_key(a) for a in warm] == [_key(b) for b in cold]


@pytest.mark.parametrize("window_h,stride_h,members",
                         [(48, 24, 6), (24, 24, 7)])
def test_zone_ensemble_sweep_matches_the_reference(arches, window_h,
                                                   stride_h, members):
    arch, rarch = arches
    rows = _campaign(P).sweep(_scheds(P), zones=arch, window_h=window_h,
                              stride_h=stride_h, **CPU)
    _hold_rows(rows, _campaign(R).sweep(_scheds(R), zones=rarch,
                                        window_h=window_h,
                                        stride_h=stride_h))
    assert len(rows) == 3 * len(SCHEDS)
    for r in rows:
        assert len(r.co2_ensemble.samples) == members
        assert r.co2_ensemble.lo <= r.co2_kg <= r.co2_ensemble.hi
    solo = _campaign(P).sweep(_scheds(P), carbon_ensemble=arch[
        "DE"].to_ensemble(window_h, stride_h), **CPU)
    assert [_key(a) for a in rows[:3]] == [_key(b) for b in solo]


def test_zone_mapping_accepts_raw_series_as_the_reference():
    def zones(mod):
        return {"FLAT": [0.5] * 72,
                "RAMP": list(np.linspace(0.2, 0.8, 72))}
    rows = _campaign(P).sweep([P.BASELINE], zones=zones(P), **CPU)
    _hold_rows(rows, _campaign(R).sweep([R.BASELINE], zones=zones(R)))
    assert [r.policy for r in rows] == ["baseline@FLAT", "baseline@RAMP"]
    assert rows[0].co2_kg != rows[1].co2_kg
    ens = _campaign(P).sweep([P.BASELINE], zones=zones(P), window_h=24,
                             stride_h=24, **CPU)
    _hold_rows(ens, _campaign(R).sweep([R.BASELINE], zones=zones(R),
                                       window_h=24, stride_h=24))


def test_zone_argument_validation(arches):
    arch, _ = arches
    c = _campaign(P)
    s = _scheds(P)
    with pytest.raises(ValueError, match="only one of"):
        c.sweep(s, zones=arch, carbon_trace=[0.4] * 48, **CPU)
    with pytest.raises(ValueError, match="need zones="):
        c.sweep(s, window_h=48, **CPU)
    with pytest.raises(ValueError, match="need zones="):
        c.sweep(s, stride_h=24, **CPU)
    with pytest.raises(TypeError, match="zones="):
        c.sweep(s, zones=[0.4] * 48, **CPU)
    with pytest.raises(ValueError, match="at least one zone"):
        c.sweep(s, zones={}, **CPU)
    fleet = P.Fleet([_campaign(P)])
    with pytest.raises(ValueError, match="only one of"):
        fleet.sweep([P.BASELINE], zones=arch, carbon_trace=[0.4] * 48, **CPU)
    with pytest.raises(ValueError, match="need zones="):
        fleet.sweep([P.BASELINE], window_h=48, **CPU)


def _fleet(mod, cap=None):
    wl_a = mod.OEMWorkload("a", 30_000, rate_at_full=2.3,
                           batch_overhead_s=2.0)
    wl_b = mod.OEMWorkload("b", 45_000, rate_at_full=2.3,
                           batch_overhead_s=2.0)
    site = (mod.Site(power_cap_kw=cap, office_kw=0.12) if cap is not None
            else None)
    return mod.Fleet([mod.Campaign(wl_a), mod.Campaign(wl_b)], site)


@pytest.mark.parametrize("cap", [None, 0.45])
def test_fleet_zone_sweep_matches_the_reference(arches, cap):
    arch, rarch = arches
    out = _fleet(P, cap).sweep([P.BASELINE, P.PEAK_AWARE_BOOSTED],
                               zones=arch, **CPU)
    ref = _fleet(R, cap).sweep([R.BASELINE, R.PEAK_AWARE_BOOSTED],
                               zones=rarch)
    assert [fr.policy for fr in out] == [fr.policy for fr in ref] == [
        f"{a}@{z}" for a in ("baseline", P.PEAK_AWARE_BOOSTED.name)
        for z in arch.zones]
    for fr, rr in zip(out, ref):
        _hold_rows(fr.campaigns, rr.campaigns)
        if cap is not None:
            assert abs(fr.site.peak_kw - rr.site.peak_kw) \
                <= RTOL * rr.site.peak_kw
    for i, z in enumerate(arch.zones):
        solo = _fleet(P, cap).sweep([P.BASELINE],
                                    carbon_trace=arch[z].to_trace(), **CPU)
        assert [_key(r) for r in out[i].campaigns] == \
            [_key(r) for r in solo[0].campaigns]
        if cap is not None:
            assert out[i].site.peak_kw == solo[0].site.peak_kw


# ----------------------------------------------------------------------
# calibration
# ----------------------------------------------------------------------
TRUTH = {"rate_at_full": 3.4, "gamma": 0.65, "idle_w": 95.0,
         "dyn_w": 260.0, "overhead_w_frac": 0.45}


class Excite:
    """The reference's identification schedule (tests/test_calibrate.py):
    intensity over [0.3, 1.0] and alternating batch sizes."""
    name = "excite"

    def __init__(self, mod):
        self.mod = mod

    def decide(self, ctx):
        h = int(ctx.hour_of_day)
        u = 0.3 + 0.7 * ((h * 7) % 24) / 23.0
        return self.mod.Decision(u, batch_size=8 if h % 2 else 32)


def _carbon(mod):
    return mod.GridCarbonModel(hourly_curve=mod.MIDWEST_HOURLY,
                               zone="US-MISO", source="sample")


@pytest.fixture(scope="module")
def measured_log(tmp_path_factory):
    """The truth campaign run once through the port, tracked; the same
    log is fitted by both packages."""
    out = str(tmp_path_factory.mktemp("measured"))
    wl = P.OEMWorkload("truth", 150_000, rate_at_full=TRUTH["rate_at_full"],
                       batch_overhead_s=2.0)
    m = P.MachineProfile(idle_w=TRUTH["idle_w"], dyn_w=TRUTH["dyn_w"],
                         gamma=TRUTH["gamma"],
                         overhead_w_frac=TRUTH["overhead_w_frac"])
    report = P.Campaign(wl, Excite(P), m, carbon=_carbon(P),
                        out_dir=out).run(track=True, render=False)
    assert report.summary is not None and report.summary.units >= 20
    return os.path.join(out, "units.jsonl")


def _nominal(mod, out_dir=None):
    wl = mod.OEMWorkload("nominal", 150_000, rate_at_full=3.0,
                         batch_overhead_s=2.0)
    return mod.Campaign(wl, Excite(mod), mod.MachineProfile(),
                        carbon=_carbon(mod), out_dir=out_dir)


def _hold_fit_bitwise(got, ref):
    for f in ("params", "init", "ci", "fit", "loss", "history", "n_units",
              "source", "zone"):
        assert getattr(got, f) == getattr(ref, f), f


def test_numpy_fit_is_the_reference_bit_for_bit(measured_log):
    got = _nominal(P).calibrate(measured_log, backend="numpy", bootstrap=3,
                                seed=3, steps=300)
    ref = _nominal(R).calibrate(measured_log, backend="numpy", bootstrap=3,
                                seed=3, steps=300)
    _hold_fit_bitwise(got, ref)
    assert got.backend == ref.backend == "numpy"
    assert set(got.ci) == set(P.FIT_PARAMS)
    for f, (lo, hi) in got.ci.items():
        assert lo <= got.params[f] * 1.05 and hi >= got.params[f] * 0.95


def test_autograd_fit_follows_the_reference_jax_fit(measured_log):
    got = _nominal(P).calibrate(measured_log, **CPU)
    ref = _nominal(R).calibrate(measured_log, backend="jax")
    assert got.backend == "torch" and ref.backend == "jax"
    err = max(abs(got.params[f] / ref.params[f] - 1.0) for f in got.fit)
    print(f"autograd fit vs the reference's jax fit: max relative "
          f"parameter error {err:.3e} (bar 1e-6)")
    assert err <= 1e-6
    assert abs(got.loss - ref.loss) <= 1e-6 * ref.loss + 1e-15
    assert len(got.history) == len(ref.history) == 500
    for cm in (got, ref):
        assert max(cm.rel_error(TRUTH).values()) < 0.02
    assert got.source == measured_log and got.zone == "US-MISO"
    assert got.init["rate_at_full"] == pytest.approx(3.0)
    assert got.history[-1] <= got.history[0] and got.loss < 1e-4


def test_apply_updates_the_campaign_physics(measured_log):
    c = _nominal(P)
    wl0, m0 = c.calibrated()
    c.baseline()
    cm = c.calibrate(measured_log, backend="numpy", apply=True)
    wl1, m1 = c.calibrated()
    assert c._baselines == {}
    assert wl1.rate_at_full == pytest.approx(TRUTH["rate_at_full"],
                                             rel=0.02)
    assert m1.gamma == pytest.approx(TRUTH["gamma"], rel=0.02)
    assert m1.alpha == m0.alpha
    assert wl0.rate_at_full == pytest.approx(3.0)
    assert cm.params.keys() == set(P.FIT_PARAMS)
    ref = _nominal(R)
    ref.calibrate(measured_log, backend="numpy", apply=True)
    rwl, rm = ref.calibrated()
    assert (wl1.rate_at_full, m1.gamma, m1.idle_w, m1.dyn_w,
            m1.overhead_w_frac) == (rwl.rate_at_full, rm.gamma, rm.idle_w,
                                    rm.dyn_w, rm.overhead_w_frac)


def test_calibrate_from_units_and_out_dir(measured_log, tmp_path):
    units = P.load_units(measured_log)
    cm = _nominal(P).calibrate(units=units, backend="numpy", steps=300)
    ref = _nominal(R).calibrate(units=R.load_units(measured_log),
                                backend="numpy", steps=300)
    _hold_fit_bitwise(cm, ref)
    assert cm.source is None
    assert max(cm.rel_error(TRUTH).values()) < 0.05
    out = tmp_path / "run"
    out.mkdir()
    (out / "units.jsonl").write_bytes(open(measured_log, "rb").read())
    cm2 = _nominal(P, str(out)).calibrate(backend="numpy", steps=300)
    assert cm2.source == str(out / "units.jsonl")
    assert cm2.params == cm.params
    obs = P.load_observations(measured_log)
    robs = RC.load_observations(measured_log)
    for f in ("u", "batch", "background", "scen_per_s", "p_avg_w",
              "weight"):
        assert np.array_equal(getattr(obs, f), getattr(robs, f)), f


def test_objective_matches_the_reference(measured_log):
    obs = P.load_observations(measured_log)
    wl = P.OEMWorkload("w", 1000, rate_at_full=2.0, batch_overhead_s=2.0)
    o = P.CalibrationObjective(obs, wl, P.MachineProfile())
    ro = RC.CalibrationObjective(RC.load_observations(measured_log),
                                 R.OEMWorkload("w", 1000, rate_at_full=2.0,
                                               batch_overhead_s=2.0),
                                 R.MachineProfile())
    p = np.random.default_rng(0).normal(0.0, 0.2, len(o.fit))
    w = np.random.default_rng(1).integers(0, 3, obs.n).astype(float)
    assert o.loss_fn(np)(p) == ro.loss_fn(np)(p)
    assert o.loss_fn(np)(p, w) == ro.loss_fn(np)(p, w)
    assert o.theta(p) == ro.theta(p)
    pt = torch.tensor(p, dtype=torch.float64, requires_grad=True)
    val = o.loss_fn(PC.model.TORCH, "cpu")(pt)
    (g,) = torch.autograd.grad(val, pt)
    assert abs(val.item() / ro.loss_fn(np)(p) - 1.0) <= 1e-12
    jax = pytest.importorskip("jax")
    from repro.compat import enable_x64
    with enable_x64():
        rg = np.asarray(jax.grad(ro.loss_fn(jax.numpy))(jax.numpy.asarray(p)))
    assert np.allclose(g.numpy(), rg, rtol=1e-9, atol=1e-12)


def test_observation_lifting_and_objective_checks():
    def unit(i, phase="night", runtime_s=3600.0, energy_kwh=0.2,
             scen=5000.0):
        return P.UnitRecord(i, phase, 0.8, runtime_s, energy_kwh, 0.05,
                            float(i), {"scenarios": scen, "batch": 32})
    units = [unit(0), unit(1, runtime_s=0.0), unit(2, phase="maintenance"),
             unit(3, scen=0.0), unit(4, energy_kwh=0.0), unit(5, "peak")]
    obs = P.observations_from_units(units)
    assert obs.n == 2 and obs.background.tolist() == [0.02, 0.65]
    with pytest.raises(ValueError, match="no calibratable units"):
        P.observations_from_units([unit(0, runtime_s=0.0)])
    wl = P.OEMWorkload("w", 1000, rate_at_full=2.0, batch_overhead_s=2.0)
    with pytest.raises(ValueError, match="unknown fit parameter"):
        P.CalibrationObjective(obs, wl, P.MachineProfile(), fit=("alpha_w",))
    with pytest.raises(ValueError, match="zero initial"):
        P.CalibrationObjective(obs, dataclasses.replace(wl, rate_at_full=0.0),
                               P.MachineProfile())
    th = P.CalibrationObjective(obs, wl, P.MachineProfile()).theta(
        np.zeros(len(P.FIT_PARAMS)))
    assert th["rate_at_full"] == 2.0


def test_calibration_refuses_what_the_port_does_not_run(measured_log,
                                                        monkeypatch):
    with pytest.raises(NotImplementedError, match="backend"):
        _nominal(P).calibrate(measured_log, backend="jax", **CPU)
    with pytest.raises(ValueError, match="backend must be"):
        _nominal(P).calibrate(measured_log, backend="torch", **CPU)
    with pytest.raises(ValueError, match="measured run"):
        _nominal(P).calibrate()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _nominal(P).calibrate(measured_log)
    assert _nominal(P).calibrate(measured_log, backend="numpy",
                                 steps=5).backend == "numpy"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _campaign(P).sweep([P.BASELINE], zones={"FLAT": [0.5] * 48})
