"""The PyTorch port's physics, host modules and session surface, held
against the JAX package (`repro`) on the CPU.

* `repro_torch.core.model` (`rates`, `power_w`, `site_throttle` through the
  `TORCH` namespace) equals `repro.core.model` with `xp=numpy` to 1e-12
  on random float64 grids;
* the OEM baselines land on the paper's numbers and the periodic 24-slot
  engine equals the reference on the six Figure-1 policies;
* the package imports neither `jax` nor `repro`, runs on the card unless
  told otherwise, and refuses the knobs it does not implement yet.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import model as ref_model  # noqa: E402
import repro.carina as R  # noqa: E402
import repro_torch.carina as P  # noqa: E402
from repro_torch.core import model  # noqa: E402
from repro_torch.core.device import reject_unported, resolve_device  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PHYS = dict(rate_at_full=2.7, batch_overhead_s=2.0, idle_w=80.0, dyn_w=190.0,
            alpha=1.6, gamma=0.35, overhead_w_frac=0.25)


def _grid(rng, n=257):
    return (rng.uniform(-0.1, 1.2, n), rng.uniform(1.0, 200.0, n),
            rng.uniform(0.0, 0.9, n))


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_rates_and_power_match_reference_on_random_grids():
    rng = np.random.default_rng(0)
    u, b, bg = _grid(rng)
    alpha = rng.uniform(1.0, 2.5, u.size)          # per-lane exponent
    phys = dict(PHYS, alpha=alpha)
    ref = ref_model.rates(u, b, bg, xp=np, **phys)
    got = model.rates(_t(u), _t(b), _t(bg), xp=model.TORCH,
                      **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                         for k, v in phys.items()})
    for f in ("r_eff", "batch_time_s", "scen_per_s", "work_frac",
              "p_work_w", "p_oh_w", "p_avg_w", "kwh_per_s"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(ref, f), rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        model.power_w(_t(u + bg), 80.0, 190.0, _t(alpha),
                      xp=model.TORCH).numpy(),
        ref_model.power_w(u + bg, 80.0, 190.0, alpha, xp=np),
        rtol=1e-12, atol=0)


def test_site_throttle_matches_reference_including_infinite_headroom():
    rng = np.random.default_rng(1)
    n = 300
    draw = rng.uniform(0.0, 3.0, n)
    base = rng.uniform(0.0, 1.5, n)
    head = rng.uniform(0.1, 3.0, n)
    head[::7] = np.inf                                # uncapped groups
    f = rng.uniform(0.05, 1.0, n)
    ref = ref_model.site_throttle(draw, base, head, f, xp=np)
    got = model.site_throttle(_t(draw), _t(base), _t(head), _t(f),
                              xp=model.TORCH).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert (got[::7] == 1.0).all()                    # inf headroom: f = 1
    # scalars keep the scalar path, bit for bit
    assert model.site_throttle(1.2, 0.4, 0.9, 1.0) == \
        ref_model.site_throttle(1.2, 0.4, 0.9, 1.0)


def test_torch_namespace_mixes_tensors_and_python_numbers():
    x = torch.tensor([-1.0, 0.5, 2.0], dtype=torch.float32)
    assert model.TORCH.maximum(x, 0.0).tolist() == [0.0, 0.5, 2.0]
    assert model.TORCH.minimum(1.0, x).tolist() == [-1.0, 0.5, 1.0]
    assert model.TORCH.maximum(x, 0.0).dtype == torch.float32
    assert model.TORCH.maximum(2.0, 3.0) == 3.0
    y = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float64)
    assert model.TORCH.maximum(x, y).dtype == torch.float64


@pytest.mark.parametrize("case,hours,kwh", [("OEM_CASE_1", 180.30, 48.67),
                                            ("OEM_CASE_2", 274.75, 74.16)])
def test_oem_baselines_land_on_paper_numbers(case, hours, kwh):
    r = P.Campaign(getattr(P, case)).run().result
    ref = R.Campaign(getattr(R, case)).run().result
    assert abs(r.runtime_h / hours - 1) < 1e-4      # the measured baseline
    assert abs(r.energy_kwh / kwh - 1) < 1e-4
    assert r.runtime_h == ref.runtime_h and r.energy_kwh == ref.energy_kwh


def test_periodic_engine_matches_reference_on_figure1_policies():
    wl, m = R.calibrate_workload(R.OEM_CASE_1, R.MachineProfile())
    pwl, pm = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    ref = R.sweep([R.SweepCase(p, wl, m) for p in R.POLICIES.values()],
                  price=R.TOU_PRICE)
    got = P.sweep([P.SweepCase(p, pwl, pm) for p in P.POLICIES.values()],
                  price=P.TOU_PRICE, device="cpu")
    for a, b in zip(ref, got):
        assert a.policy == b.policy
        for f in ("runtime_h", "energy_kwh", "co2_kg", "cost_usd"):
            assert abs(getattr(b, f) / getattr(a, f) - 1) < 1e-12, \
                (a.policy, f)


def test_frontier_matches_reference():
    ref = R.Campaign(R.OEM_CASE_2).frontier()
    got = P.Campaign(P.OEM_CASE_2).frontier()
    assert [r.policy for r in got] == [r.policy for r in ref]
    for a, b in zip(ref, got):
        assert (a.runtime_h, a.energy_kwh, a.energy_delta_pct) == \
            (b.runtime_h, b.energy_kwh, b.energy_delta_pct)


def test_package_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch.carina, repro_torch.core.engine_torch, "
            "repro_torch.kernels.scan_chunk, repro_torch.kernels.coupled_chunk;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stdout + p.stderr[-2000:]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.Campaign(P.OEM_CASE_1).sweep([P.BASELINE])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("kwargs", [dict(devices=2), dict(backend="numpy"),
                                    dict(cache_dir="plans")])
def test_unported_knobs_raise(kwargs):
    with pytest.raises(NotImplementedError):
        reject_unported(**kwargs)
    with pytest.raises(NotImplementedError):
        P.sweep([P.SweepCase(P.BASELINE, P.OEM_CASE_1)], device="cpu",
                **kwargs)
    reject_unported(devices=1)                    # one card is the default
    with pytest.raises(ValueError):
        reject_unported(devices=0)
