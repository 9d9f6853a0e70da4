"""The PyTorch port's site-coupled path held against the JAX package on
the CPU: the plain version of the coupled chunk kernel (K1) against the
reference's Pallas kernel in interpret mode on the same dense inputs,
and capped / uncapped `Fleet.sweep` end to end against
`repro.carina.Fleet.sweep` (Pallas interpret and jnp kernels) and the
sequential fleet oracle.

Tolerances: fp64 within 1e-9 relative per lane (the reference pins its
Pallas kernel to the jnp kernel at the same bar); the grouped engine
within 0.5 % of `simulate_fleet` (its decision tables quantize
progress; the reference's own bar).  The CUDA kernel is held against
the plain version on the card by tests/test_torch_kernels.py and
chip_smoke.py (input builders shared with the former).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.carina as R  # noqa: E402
import repro_torch.carina as P  # noqa: E402
from repro.compat import enable_x64  # noqa: E402
from repro.kernels.coupled_throttle import coupled_chunk as pallas_chunk  # noqa: E402
from repro_torch.core import model  # noqa: E402
from repro_torch.kernels import coupled_chunk as k1  # noqa: E402
from test_torch_kernels import (FINISH, RTOL, close,  # noqa: E402
                                dense_inputs, k1_tensors)



def _k1(fn, ins, state, scalars, dtype=torch.float64):
    return [o.numpy() for o in fn(*k1_tensors(ins, state, scalars, dtype),
                                  iters=model.SITE_THROTTLE_ITERS,
                                  finish_frac=FINISH)]


@pytest.mark.parametrize("B", [1, 4])
def test_plain_coupled_chunk_matches_pallas_interpret(B):
    ins, state, scalars = dense_inputs(B)
    got = _k1(k1.coupled_chunk, ins, state, scalars)
    with enable_x64():
        import jax.numpy as jnp
        ref = pallas_chunk(*(jnp.asarray(a) for a in ins + state + scalars),
                           iters=model.SITE_THROTTLE_ITERS,
                           finish_frac=FINISH, interpret=True)
    ref = [np.asarray(o) for o in ref]
    close(got[0], ref[0], RTOL, scale=scalars[0])        # remaining
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, RTOL)
    # the cap binds: the capped groups' peaks sit near their caps, and the
    # all-padding group (infinite cap) stays untouched
    assert np.array_equal(got[1][2], state[1][2])
    assert (got[5][0, :3] > 0.3).all()


def test_plain_coupled_chunk_mixed_within_1e6_of_fp64():
    ins, state, scalars = dense_inputs(4, seed=3)
    ref = _k1(k1.coupled_chunk_plain, ins, state, scalars)
    got = _k1(k1.coupled_chunk_plain, ins, state, scalars,
              dtype=torch.float32)
    assert all(g.dtype == np.float64 for g in got)
    close(got[0], ref[0], 1e-6, scale=scalars[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, 1e-6)


# ---------------------------------------------------------------------------
# The slice end to end: capped and uncapped fleets
# ---------------------------------------------------------------------------
def _fleet(mod, cap):
    site = mod.Site(power_cap_kw=cap, office_kw=0.12)
    return mod.Fleet([mod.Campaign(mod.OEM_CASE_1),
                      mod.Campaign(mod.OEM_CASE_2)], site)


def _assignments(mod):
    return [mod.PEAK_AWARE_BOOSTED, mod.deadline_weighted_split([300, 480])]


def test_capped_fleet_sweep_matches_reference_and_oracle():
    ref_pallas = _fleet(R, 0.45).sweep(_assignments(R), pallas="interpret",
                                       devices=1)
    ref_jnp = _fleet(R, 0.45).sweep(_assignments(R), pallas="off",
                                    devices=1)
    P.reset_scan_stats()
    fleet = _fleet(P, 0.45)
    got = fleet.sweep(_assignments(P), device="cpu")
    st = P.scan_stats()
    assert st.grouped_lanes > 0
    assert st.kernel_dispatches == {"scan_chunk": 0, "coupled_chunk": 0}
    for ref in (ref_pallas, ref_jnp):
        for fr, fg in zip(ref, got):
            assert fr.policy == fg.policy
            close(fg.site.peak_kw, fr.site.peak_kw, RTOL)
            for a, b in zip(fr.campaigns, fg.campaigns):
                for f in ("runtime_h", "energy_kwh", "co2_kg"):
                    close(getattr(b, f), getattr(a, f), RTOL)
    # within 0.5 % of the sequential per-slot oracle, and held at the cap
    cases = fleet._cases([P.PEAK_AWARE_BOOSTED] * 2, carbon=fleet._carbon(
        None, None), deadlines=None, label="oracle")
    orc = P.simulate_fleet(cases, fleet.site)
    for a, b in zip(got[0].campaigns, orc.campaigns):
        for f in ("runtime_h", "energy_kwh", "co2_kg"):
            assert abs(getattr(a, f) / getattr(b, f) - 1) < 5e-3, f
    assert got[0].site.peak_kw < 0.46


def test_capped_fleet_carbon_trace_mixed_precision():
    rng = np.random.RandomState(7)
    week = [0.448 * (1 + 0.3 * np.sin(2 * np.pi * h / 24) +
                     0.05 * rng.randn()) for h in range(168)]
    a = _fleet(P, 0.45).sweep([P.PEAK_AWARE_BOOSTED], carbon_trace=week,
                              device="cpu")[0]
    b = _fleet(P, 0.45).sweep([P.PEAK_AWARE_BOOSTED], carbon_trace=week,
                              precision="mixed", device="cpu")[0]
    for x, y in zip(a.campaigns, b.campaigns):
        assert abs(y.energy_kwh / x.energy_kwh - 1) < 1e-6
        assert abs(y.co2_kg / x.co2_kg - 1) < 1e-6


def test_uncapped_fleet_equals_independent_campaigns():
    fleet = _fleet(P, None)
    rows = fleet.sweep([P.PEAK_AWARE_BOOSTED, P.BASELINE], device="cpu")
    for c, col in zip(fleet.campaigns, zip(*(r.campaigns for r in rows))):
        solo = c.sweep([P.PEAK_AWARE_BOOSTED, P.BASELINE], device="cpu")
        for a, b in zip(col, solo):
            assert (a.runtime_h, a.energy_kwh, a.co2_kg) == \
                (b.runtime_h, b.energy_kwh, b.co2_kg)
    assert rows[0].site.peak_kw is None
