"""The port's kernels K1 (`coupled_chunk`), K2 (`scan_chunk`), K3
(`objective_scan`), K4 (`fleet_objective`), K5 (`flash_attention`), K6
(`decode_attention`), K7 (`ssm_scan`), K8 (`rmsnorm`) and its backward, K9
(`moe_gemm`) and its backward (`grouped_gemm_dx`, `grouped_gemm_dw`), K10 (`xent`), K11 (`flash_attention_bwd`), K12a
(`xent_bwd`, the blocked loss's backward) and K12c (`selective_scan`,
Mamba-1's selective scan):
their wrappers' dispatch and input checks, and — on a machine with an NVIDIA GPU — each CUDA kernel
against its plain PyTorch version.

This file imports neither `jax` nor `repro`, so the card tests run on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

Here on the CPU the card tests skip.  The input builders are shared with
tests/test_torch_engine.py and tests/test_torch_fleet.py, which hold the
plain versions against the JAX package (tests/test_torch_optimize.py does
so for the objectives whose scans K3 and K4 are, and
tests/test_torch_objective_kernels.py holds their autograd Functions to
autograd of the plain versions on the CPU; tests/test_torch_serving.py
does so for K5 and K8, tests/test_torch_moe.py for K9, tests/test_torch_loss.py
for K10, tests/test_torch_train_loop.py for K12a, tests/test_torch_ops.py
for K6 and K7, tests/test_torch_mamba.py for K12c).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.carina as P  # noqa: E402
from repro_torch.core import model  # noqa: E402
from repro_torch.kernels import coupled_chunk as k1  # noqa: E402
from repro_torch.kernels import decode_attention as k6  # noqa: E402
from repro_torch.kernels import fleet_objective as k4  # noqa: E402
from repro_torch.kernels import flash_attention as k5  # noqa: E402
from repro_torch.kernels import moe_gemm as k9  # noqa: E402
from repro_torch.kernels import objective_scan as k3  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as k8  # noqa: E402
from repro_torch.kernels import scan_chunk as k2  # noqa: E402
from repro_torch.kernels import selective_scan as k12c  # noqa: E402
from repro_torch.kernels import ssm_scan as k7  # noqa: E402
from repro_torch.kernels import xent as k10  # noqa: E402

RTOL = 1e-9
FINISH = 1e-6


def close(got, ref, rtol, scale=None):
    """Every element within `rtol` of `ref` (relative to |ref|, or to
    `scale` where the reference value may sit near zero)."""
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    tol = rtol * (np.abs(ref) if scale is None else scale)
    assert (np.abs(got - ref) <= tol).all(), np.max(np.abs(got - ref))


def chunk_inputs(B, seed=0, A=6, R_=24, C=30, E=2):
    """K2 inputs: lanes from fresh to nearly done (some finish inside the
    chunk), one already finished; a partial first slot."""
    rng = np.random.default_rng(seed)
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    n_scen = np.full(A, float(wl.n_scenarios))
    ins = (rng.uniform(0.2, 1.0, (A, R_, B)),
           rng.choice([25.0, 50.0, 100.0], (A, R_, B)),
           rng.integers(0, R_, (A, C)).astype(np.int32),
           rng.uniform(0.0, 0.5, (A, C)), rng.uniform(0.3, 0.6, (A, E, C)),
           rng.uniform(0.0, 0.2, (A, C)), np.full((A, C), 3600.0))
    ins[6][:, 0] = 1800.0
    frac = np.array([1.0, 0.6, 0.05, 0.02, 0.004, 0.0])[:A]
    state = (n_scen * frac, rng.uniform(0, 1e5, A), rng.uniform(0, 10, A),
             rng.uniform(0, 5, (A, E)), rng.uniform(0, 1, A))
    scalars = (n_scen, np.full(A, wl.rate_at_full),
               np.full(A, wl.batch_overhead_s), np.full(A, m.idle_w),
               rng.uniform(0.8, 1.2, A) * m.dyn_w,
               rng.uniform(1.2, 2.0, A), np.full(A, m.gamma),
               np.full(A, m.overhead_w_frac))
    return ins, state, scalars


def dense_inputs(B, seed=0, Lp=8, C=24, E=2, counts=(3, 5, 0)):
    """K1 inputs in the dense (G, Lp) layout: groups of 3 and 5 real lanes
    under a binding cap, and one all-padding group with an infinite cap
    (padded lanes: remaining 0, n_scen 1, alpha 1)."""
    rng = np.random.default_rng(seed)
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    G = len(counts)
    real = np.zeros((G, Lp), dtype=bool)
    for g, n in enumerate(counts):
        real[g, :n] = True

    def lanes(values, fill):
        return np.where(real, values, fill)

    n = lanes(np.full((G, Lp), float(wl.n_scenarios)), 1.0)
    frac = rng.choice([1.0, 0.3, 0.01, 0.002], (G, Lp))
    ins = (rng.uniform(0.3, 1.0, (G, Lp, C, B)),
           rng.choice([25.0, 50.0, 100.0], (G, Lp, C, B)),
           rng.uniform(0.0, 0.5, (G, Lp, C)),
           rng.uniform(0.3, 0.6, (G, Lp, E, C)),
           rng.uniform(0.0, 0.2, (G, Lp, C)), np.full((G, Lp, C), 3600.0),
           np.array([0.45, 0.70, np.inf])[:G],
           rng.uniform(0.05, 0.12, (G, C)))
    state = (lanes(n * frac, 0.0), rng.uniform(0, 1e5, (G, Lp)),
             rng.uniform(0, 10, (G, Lp)), rng.uniform(0, 5, (G, Lp, E)),
             rng.uniform(0, 1, (G, Lp)), rng.uniform(0, 0.4, (G, Lp)))
    scalars = (n, lanes(np.full((G, Lp), wl.rate_at_full), 0.0),
               lanes(np.full((G, Lp), wl.batch_overhead_s), 0.0),
               lanes(np.full((G, Lp), m.idle_w), 0.0),
               lanes(rng.uniform(0.8, 1.2, (G, Lp)) * m.dyn_w, 0.0),
               lanes(rng.uniform(1.2, 2.0, (G, Lp)), 1.0),
               lanes(np.full((G, Lp), m.gamma), 0.0),
               lanes(np.full((G, Lp), m.overhead_w_frac), 0.0))
    return ins, state, scalars


def k2_tensors(ins, state, scalars, dtype=torch.float64, device="cpu"):
    t = [torch.as_tensor(a, dtype=dtype, device=device) for a in ins]
    t[2] = torch.as_tensor(ins[2], device=device)
    return (t + [torch.as_tensor(a, dtype=torch.float64, device=device)
                 for a in state]
            + [torch.as_tensor(a, dtype=dtype, device=device)
               for a in scalars])


def k1_tensors(ins, state, scalars, dtype=torch.float64, device="cpu"):
    return ([torch.as_tensor(a, dtype=dtype, device=device) for a in ins]
            + [torch.as_tensor(a, dtype=torch.float64, device=device)
               for a in state]
            + [torch.as_tensor(a, dtype=dtype, device=device)
               for a in scalars])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# K3 / K4 inputs: objectives of the optimizer and seeded populations
# ---------------------------------------------------------------------------
def _week(mod=P):
    rng = np.random.RandomState(7)
    h = np.arange(168)
    return mod.TraceSignal(tuple(
        0.448 * (1.0 + 0.30 * np.sin(2 * np.pi * h / 24.0)
                 + 0.05 * rng.randn(168))), name="week")


def _quiet_bands():
    class QuietBands(P.TimeBands):
        """No background load: the slot physics is the same every slot."""

        def background(self, band: str) -> float:
            return 0.0
    return QuietBands()


def _boundary_case():
    """A campaign that finishes exactly on a slot boundary: u = 0.5 gives
    scen_per_s = 5 exactly (no background, no overhead), so 10 full hours
    of 18,000 scenarios leave remaining == scen * len at the start of the
    tenth, which takes the finish branch with dt == len."""
    m = P.MachineProfile(idle_w=0.0, dyn_w=200.0, alpha=2.0, gamma=0.0)
    wl = P.OEMWorkload("boundary", 180_000, rate_at_full=10.0,
                       batch_overhead_s=0.0)
    return P.SweepCase(P.parametric_schedule(24), wl, m, _quiet_bands(),
                       P.HourlySignal(tuple([1.0] * 12 + [0.2] * 12),
                                      name="two-band"), start_hour=0.0)


#: name -> (TraceObjective kwargs, what the case exercises); `members`
#: fixes the population's size
OBJECTIVE_CASES = {
    "week": dict(),                                  # E = 0, fp64
    "mixed": dict(precision="mixed"),
    "ensemble4": dict(ensemble=True),                 # E = 4
    "sph2_price": dict(slots_per_hour=2, price=True),  # bins repeat, cost
    "unfinished": dict(horizon_h=90.0),
    "boundary": dict(boundary=True, horizon_h=30.0),
    # T off the kernels' tiles (two of 160 slots): a gradient step's one
    # member, and a population of 1,024
    "n1_t280": dict(members=1, horizon_h=280.0),
    "n1024_t292": dict(members=1024, horizon_h=292.0),
}


def objective_case(name, device="cpu", n=6, seed=0):
    """A `TraceObjective` on `device` and a seeded (n, n_slots) NumPy
    population (the boundary case: member 0 at u = 0.5 throughout)."""
    kw = dict(OBJECTIVE_CASES[name])
    n = kw.pop("members", n)
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    carbon = _week()
    if kw.pop("ensemble", False):
        base = np.asarray(carbon.values)
        rng = np.random.RandomState(11)
        carbon = P.as_ensemble(base[None, :168]
                               * (1.0 + 0.15 * rng.randn(4, 168)),
                               name="ens4")
    if kw.pop("price", False):
        kw["price"] = P.TOU_PRICE
    if kw.pop("boundary", False):
        case = _boundary_case()
    else:
        case = P.SweepCase(P.parametric_schedule(24), wl, m, carbon=carbon,
                           deadline_h=220.0)
    obj = P.TraceObjective(case, device=device, **kw)
    U = np.random.RandomState(seed).uniform(0.05, 1.0, (n, obj.n_slots))
    if name == "boundary":
        U[0] = 0.5
    return obj, U


def _fleet_cases(M, quiet=False):
    import dataclasses
    out = []
    bands = _quiet_bands()           # one site: one TimeBands for all
    calibrated = [P.calibrate_workload(wl0, P.MachineProfile())
                  for wl0 in (P.OEM_CASE_1, P.OEM_CASE_2)[:M]]
    for i in range(M):
        wl, m = calibrated[i % 2]
        wl = dataclasses.replace(wl, name=f"c{i}", n_scenarios=int(
            wl.n_scenarios * (1.0 if M <= 2 else 0.2 + 0.05 * (i % 7))))
        extra = (bands, None, 0.0) if quiet else ()
        out.append(P.SweepCase(P.parametric_schedule(24), wl, m, *extra,
                               deadline_h=300.0 + 10.0 * i))
    return out


def _pair_cases(scales):
    """Campaigns of OEM case 1 in identical pairs, pair k at `scales[k]`
    of its workload."""
    import dataclasses
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    return [P.SweepCase(P.parametric_schedule(24), dataclasses.replace(
        wl, name=f"c{i}", n_scenarios=int(wl.n_scenarios * scales[i // 2])),
        m, deadline_h=300.0) for i in range(2 * len(scales))]


#: name -> (campaigns, site cap kW (None: uncapped; "exact": the
#: unthrottled draw), office kW, horizon h, quiet bands, spread: None, or
#: (members, the workload scales of identical campaign pairs, or None for
#: the usual campaigns))
FLEET_CASES = {
    "capped": (2, 0.40, 0.12, 320.0, False, None),
    "uncapped": (2, None, 0.12, 320.0, False, None),
    "m1": (1, 0.20, 0.05, 150.0, False, None),
    "m3_unfinished": (3, 0.60, 0.12, 60.0, False, None),
    "m40": (40, 4.0, 0.12, 48.0, False, None),
    "m300": (300, 70.0, 0.12, 24.0, False, None),  # past the tile kernels
    "exact_cap": (2, "exact", 0.0, 60.0, True, None),
    # campaigns that turn inactive at many distinct slots under a binding
    # cap (`test_fleet_finish_cases_cover_the_tiles`): inside the tiles and
    # on their first and last slots, a pair in one slot, all of a member's
    # in the first tile; M = 2 (a thread a slot, T = 300 in two tiles of
    # 160) and M = 6 (a warp a slot, T = 100 in two tiles of 56)
    "finishes": (2, 0.40, 0.12, 300.0, False, (48, (0.5,))),
    "finishes_m6": (6, 1.2, 0.12, 100.0, False, (48, (0.15, 0.2, 0.25))),
    # a gradient step's one member over the README fleet's 624 slots
    # (three tiles of 224)
    "n1_t624": (2, 0.45, 0.12, 624.0, False, (1, None)),
}


def fleet_case(name, device="cpu", n=4, seed=1, entry=None):
    """A `FleetTraceObjective` on `device` and a seeded (n, M, n_slots)
    NumPy population (a spread case's own size).  "exact_cap" runs
    constant intensities on quiet bands (every slot's site draw equal:
    the running peak ties each slot) under a cap equal to member 0's
    draw, so each of its throttle steps has a ratio of exactly 1
    (`minimum(ratio, 1)` ties).  That draw is the one `entry` computes
    with the cap off (the plain version by default; the kernels' on the
    card round it their own way, so each implementation is put on its
    own cap).  The pair cases draw intensities over 0.3-1, every fourth
    member near full (it finishes early) and every third running each
    pair on one row (the pair finishes in one slot)."""
    M, cap, office, horizon, quiet, spread = FLEET_CASES[name]
    n, scales = spread or (n, None)
    cases = _fleet_cases(M, quiet) if scales is None else _pair_cases(scales)
    rng = np.random.RandomState(seed)
    if scales is not None:
        U = rng.uniform(0.3, 1.0, (n, M, 24))
        U[1::4] = 0.85 + 0.15 * U[1::4]
        U[::3, 1::2] = U[::3, 0::2]
        return P.FleetTraceObjective(cases, site_cap_kw=cap, office_kw=office,
                                     horizon_h=horizon, device=device), U
    if cap == "exact":
        U = np.broadcast_to(rng.uniform(0.3, 0.9, (n, M, 1)),
                            (n, M, 24)).copy()
        free = P.FleetTraceObjective(cases, office_kw=office,
                                     horizon_h=horizon, device=device)
        with torch.no_grad():
            cap = float((entry or k4.fleet_objective_plain)(
                free, torch.tensor(U[:1], device=device)).site_peak_kw[0])
    else:
        U = rng.uniform(0.2, 1.0, (n, M, 24))
    obj = P.FleetTraceObjective(cases, site_cap_kw=cap, office_kw=office,
                                horizon_h=horizon, device=device)
    return obj, U


def fleet_pair(name, dev, n=4):
    """(objective for the kernels, objective for the plain version, U) on
    the card: one objective, but for "exact_cap" each on its own cap."""
    obj, U = fleet_case(name, dev, n=n)
    if name != "exact_cap":
        return obj, obj, U
    return fleet_case(name, dev, n=n, entry=k4.fleet_objective)[0], obj, U


def weighted_loss(outs, keep, seed=3):
    """A scalar of the objective's outputs: each kept field (by index)
    summed per member, scaled to order one, weighted by seeded numbers;
    the fields not kept get no gradient."""
    rng = np.random.RandomState(seed)
    total = 0.0
    for i in keep:
        x = outs[i].reshape(outs[i].shape[0], -1).sum(-1) \
            if outs[i].dim() else outs[i].reshape(1)
        w = torch.as_tensor(rng.uniform(0.5, 1.5, x.shape), dtype=x.dtype,
                            device=x.device)
        scale = x.detach().abs().mean().clamp_min(1.0)
        total = total + (w * x / scale).sum()
    return total


def grads_close(got, ref, rtol, components=True):
    """Within `rtol` of the reference in norm, and (`components`) each
    component within max(10 rtol, 1e-8) of itself plus `rtol` of the
    norm (rounding leaves ~1e-17 of the norm on components that cancel);
    a zero reference (no kept output moves with u) is matched exactly.
    Mixed precision is held in norm only: its plain version sums each
    component in fp32."""
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    norm = float(torch.linalg.vector_norm(ref))
    if norm == 0.0:
        assert not got.any()
        return
    err = float(torch.linalg.vector_norm(got - ref))
    assert err <= rtol * norm, err / norm
    if not components:
        return
    ctol = max(10 * rtol, 1e-8)
    assert ((got - ref).abs() <= ctol * ref.abs() + rtol * norm).all()


def fields_close(got, ref, rtol, unfinished=4):
    """Per field within `rtol` of |ref| (`unfinished`, a fraction of the
    workload, within `rtol` absolute)."""
    for i, (g, r) in enumerate(zip(got, ref)):
        close(g.detach().cpu(), r.detach().cpu(), rtol,
              scale=1.0 if i == unfinished else None)


def test_scan_chunk_wrapper_dispatch():
    args = k2_tensors(*chunk_inputs(4))
    before = k2.launches
    a = k2.scan_chunk(*args, B=4)
    b = k2.scan_chunk_plain(*args, B=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert k2.launches == before                       # CPU: no launch
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k2.scan_chunk(*(x.to("meta") for x in args), B=4)


def test_coupled_chunk_wrapper_dispatch_and_checks():
    args = k1_tensors(*dense_inputs(4))
    before = k1.launches
    a = k1.coupled_chunk(*args, iters=4, finish_frac=FINISH)
    b = k1.coupled_chunk_plain(*args, iters=4, finish_frac=FINISH)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert k1.launches == before                       # CPU: no launch
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k1.coupled_chunk(*(x.to("meta") for x in args), iters=4,
                         finish_frac=FINISH)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        k1.step_histogram(*args, iters=4, finish_frac=FINISH)
    k1._check(args, torch.float64, 3, 8, 24, 4, 2)      # accepted
    with pytest.raises(ValueError, match="power-of-two"):
        k1._check(k1_tensors(*dense_inputs(4, Lp=6)), torch.float64, 3, 6,
                  24, 4, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, RTOL),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("B", [1, 4])
def test_scan_chunk_kernel_matches_plain_on_card(B, dtype, rtol):
    dev = _card()
    ins, state, scalars = chunk_inputs(B)
    args = k2_tensors(ins, state, scalars, dtype, dev)
    before = k2.launches
    got = k2.scan_chunk(*args, B=B)
    ref = k2.scan_chunk_plain(*args, B=B)
    assert k2.launches == before + 1
    close(got[0].cpu(), ref[0].cpu(), rtol, scale=scalars[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g.cpu(), r.cpu(), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, RTOL),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("B,Lp", [(1, 8), (4, 8), (4, 64)])
def test_coupled_chunk_kernel_matches_plain_on_card(B, Lp, dtype, rtol):
    dev = _card()
    counts = (3, 5, 0) if Lp <= 32 else (40, 64, 0)
    ins, state, scalars = dense_inputs(B, Lp=Lp, counts=counts)
    args = k1_tensors(ins, state, scalars, dtype, dev)
    before = k1.launches
    got = k1.coupled_chunk(*args, iters=model.SITE_THROTTLE_ITERS,
                           finish_frac=FINISH)
    ref = k1.coupled_chunk_plain(*args, iters=model.SITE_THROTTLE_ITERS,
                                 finish_frac=FINISH)
    assert k1.launches == before + 1
    close(got[0].cpu(), ref[0].cpu(), rtol, scale=scalars[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g.cpu(), r.cpu(), rtol)


def edge_chunk_inputs(A, C, B, E, seed=0, R_=24):
    """K2 inputs at any (A, C, B, E): each lane finishes in slot 0, a few
    slots in (inside a tile of the kernel or across its edge), never, or
    is done already; a partial first slot."""
    rng = np.random.default_rng(seed)
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    n_scen = np.full(A, float(wl.n_scenarios))
    ins = (rng.uniform(0.2, 1.0, (A, R_, B)),
           rng.choice([25.0, 50.0, 100.0], (A, R_, B)),
           rng.integers(0, R_, (A, C)).astype(np.int32),
           rng.uniform(0.0, 0.5, (A, C)), rng.uniform(0.3, 0.6, (A, E, C)),
           rng.uniform(0.0, 0.2, (A, C)), np.full((A, C), 3600.0))
    ins[6][:, 0] = 1800.0
    kind = rng.integers(0, 4, A)
    rem = np.choose(kind, [np.full(A, 1.0),                # slot 0
                           rng.uniform(1e4, 4e4, A),       # a few slots in
                           n_scen,                         # never
                           np.zeros(A)])                   # done already
    state = (rem, rng.uniform(0, 1e5, A), rng.uniform(0, 10, A),
             rng.uniform(0, 5, (A, E)), rng.uniform(0, 1, A))
    scalars = (n_scen, np.full(A, wl.rate_at_full),
               np.full(A, wl.batch_overhead_s), np.full(A, m.idle_w),
               rng.uniform(0.8, 1.2, A) * m.dyn_w,
               rng.uniform(1.2, 2.0, A), np.full(A, m.gamma),
               np.full(A, m.overhead_w_frac))
    return ins, state, scalars


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, RTOL),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("B,E", [(1, 1), (4, 3), (1, 5)])
@pytest.mark.parametrize("C", [1, 7, 96])
@pytest.mark.parametrize("A", [1, 127, 129, 1000])
def test_scan_chunk_kernel_edges_on_card(A, C, B, E, dtype, rtol):
    """The staged kernel at lane counts around its 128-lane blocks, chunk
    lengths off its 4-slot tiles (C = 1, 7: element copies; 96: 16-byte
    copies), E in registers (1, 3) and the general path (5), B = 4's
    progress lookup, and lanes that finish in slot 0, mid-tile or never."""
    dev = _card()
    ins, state, scalars = edge_chunk_inputs(A, C, B, E, seed=A + C)
    args = k2_tensors(ins, state, scalars, dtype, dev)
    before = k2.launches
    got = k2.scan_chunk(*args, B=B)
    ref = k2.scan_chunk_plain(*args, B=B)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    close(got[0].cpu(), ref[0].cpu(), rtol, scale=scalars[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g.cpu(), r.cpu(), rtol)
    if C == 96:                 # slot-0 and a-few-slots lanes are done
        few = state[0] < 5e4
        assert (got[0].cpu().numpy()[few] <= 1e-6 * scalars[0][few]).all()


def edge_dense_inputs(B, Lp, C=24, E=1, seed=0):
    """K1 inputs with four groups: one under a cap below its base draw
    (f falls to the floor in one step and stays: the exact stop after one
    step), one under an infinite cap (the stop before any step), one
    under a cap that binds part of the time (several steps), and one all
    padding.  Lanes finish in about three slots from fresh, so with B > 1
    the progress bucket moves by one or two a slot."""
    rng = np.random.default_rng(seed)
    wl, m = P.calibrate_workload(P.OEM_CASE_1, P.MachineProfile())
    counts = (Lp, max(1, Lp // 2), Lp, 0)
    G = len(counts)
    real = np.zeros((G, Lp), dtype=bool)
    for g, n in enumerate(counts):
        real[g, :n] = True

    def lanes(values, fill):
        return np.where(real, values, fill)

    n = lanes(np.full((G, Lp), 3.0e4), 1.0)
    frac = rng.choice([1.0, 0.6, 0.3, 0.0], (G, Lp))
    ins = (rng.uniform(0.3, 1.0, (G, Lp, C, B)),
           rng.choice([25.0, 50.0, 100.0], (G, Lp, C, B)),
           rng.uniform(0.0, 0.5, (G, Lp, C)),
           rng.uniform(0.3, 0.6, (G, Lp, E, C)),
           rng.uniform(0.0, 0.2, (G, Lp, C)), np.full((G, Lp, C), 3600.0),
           np.array([0.01, np.inf, 0.15 * counts[2], np.inf]),
           rng.uniform(0.05, 0.12, (G, C)))
    state = (lanes(n * frac, 0.0), rng.uniform(0, 1e5, (G, Lp)),
             rng.uniform(0, 10, (G, Lp)), rng.uniform(0, 5, (G, Lp, E)),
             rng.uniform(0, 1, (G, Lp)), rng.uniform(0, 0.4, (G, Lp)))
    scalars = (n, lanes(np.full((G, Lp), wl.rate_at_full), 0.0),
               lanes(np.full((G, Lp), wl.batch_overhead_s), 0.0),
               lanes(np.full((G, Lp), m.idle_w), 0.0),
               lanes(rng.uniform(0.8, 1.2, (G, Lp)) * m.dyn_w, 0.0),
               lanes(rng.uniform(1.2, 2.0, (G, Lp)), 1.0),
               lanes(np.full((G, Lp), m.gamma), 0.0),
               lanes(np.full((G, Lp), m.overhead_w_frac), 0.0))
    return ins, state, scalars


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, RTOL),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("Lp", [1, 8, 16, 32, 64])
def test_coupled_chunk_kernel_edges_on_card(Lp, B, dtype, rtol):
    """The redesigned K1 against its plain version where the exact stop of
    the throttle's fixed point is taken after no step, after one, and not
    at all, at one lane a group up to a block a group (the power terms
    shared out over a lane's replicas at Lp 1 and 8, not at 16 and 32),
    and (B = 4) where the progress bucket moves past the prefetched
    rows."""
    dev = _card()
    ins, state, scalars = edge_dense_inputs(B, Lp, seed=Lp + B)
    args = k1_tensors(ins, state, scalars, dtype, dev)
    before = k1.launches
    got = k1.coupled_chunk(*args, iters=model.SITE_THROTTLE_ITERS,
                           finish_frac=FINISH)
    ref = k1.coupled_chunk_plain(*args, iters=model.SITE_THROTTLE_ITERS,
                                 finish_frac=FINISH)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    close(got[0].cpu(), ref[0].cpu(), rtol, scale=scalars[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g.cpu(), r.cpu(), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("Lp", [1, 8, 64])
def test_coupled_chunk_exact_stop_on_card(Lp, dtype):
    """Under an infinite cap every (group, slot) pair stops before any
    throttle step; under a cap below the base draw f falls to the floor
    in one step and the next step returns it bit for bit."""
    dev = _card()
    ins, state, scalars = edge_dense_inputs(1, Lp, seed=Lp)
    pick = [0, 1, 3]                    # the floor, the uncapped, padding
    ins = tuple(a[pick] for a in ins)
    scalars = tuple(a[pick] for a in scalars)
    state = (np.where(scalars[0] > 1.0, 1e12, 0.0),) + tuple(
        a[pick] for a in state[1:])        # real lanes run every slot
    args = k1_tensors(ins, state, scalars, dtype, dev)
    C = ins[0].shape[2]
    before = k1.launches
    hist = k1.step_histogram(*args, iters=model.SITE_THROTTLE_ITERS,
                             finish_frac=FINISH)
    assert k1.launches == before + 1
    assert hist == [C, C] + [0] * (model.SITE_THROTTLE_ITERS - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("Lp,B", [(8, 1), (1, 1), (8, 4)])
def test_coupled_chunk_packed_warps_on_card(Lp, B, dtype):
    """Past 8 warps an SM the kernel packs two or more groups into a warp:
    1,200 groups (300 copies of the edge groups) against the plain
    version."""
    dev = _card()
    ins, state, scalars = edge_dense_inputs(B, Lp, seed=Lp)
    reps = 300
    ins, state, scalars = ([np.concatenate([a] * reps) for a in x]
                           for x in (ins, state, scalars))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert k1.launch_plan(len(ins[6]), Lp, sms)[2] > 1
    args = k1_tensors(ins, state, scalars, dtype, dev)
    got = k1.coupled_chunk(*args, iters=model.SITE_THROTTLE_ITERS,
                           finish_frac=FINISH)
    ref = k1.coupled_chunk_plain(*args, iters=model.SITE_THROTTLE_ITERS,
                                 finish_frac=FINISH)
    torch.cuda.synchronize()
    rtol = RTOL if dtype == torch.float64 else 1e-6
    close(got[0].cpu(), ref[0].cpu(), rtol, scale=scalars[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g.cpu(), r.cpu(), rtol)


@pytest.mark.cuda
def test_chunk_launch_plans_match_the_kernels_on_card():
    """The Python launch plans are the rules the C launchers apply."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float64, torch.float32):
        for A in (1, 129, 1000, 100_000):
            got = k2.device_plan(A, 1, dtype)
            assert (got["threads"], got["blocks"]) == k2.launch_plan(A, sms)
            assert got["blocks_per_sm"] >= 1
        for G, Lp in ((512, 8), (3, 8), (2000, 8), (7, 64), (1200, 1)):
            got = k1.device_plan(G, Lp, dtype)
            assert (got["threads"], got["blocks"],
                    got["groups_per_warp"]) == k1.launch_plan(G, Lp, sms)
            assert got["blocks_per_sm"] >= 1


@pytest.mark.parametrize("A,sms", [(100_000, 132), (1, 132), (127, 132),
                                   (129, 132), (1000, 132), (8447, 132),
                                   (8448, 132), (16896, 132), (5, 1)])
def test_scan_chunk_launch_plan_covers_the_lanes(A, sms):
    """K2's blocks cover the A lanes once, in 128-lane blocks unless that
    would leave SMs idle, then in 64 or 32; at chip_smoke's S = 1e5 on
    132 SMs, 782 blocks of 128."""
    threads, blocks = k2.launch_plan(A, sms)
    assert threads in (32, 64, 128)
    assert (blocks - 1) * threads < A <= blocks * threads
    if threads < 128:
        assert -(-A // (2 * threads)) < sms
    if threads > 32:
        assert blocks >= sms
    if A == 100_000:
        assert (threads, blocks) == (128, 782)


@pytest.mark.parametrize("G,Lp,sms", [(512, 8, 132), (3, 8, 132),
                                      (4096, 8, 132), (2, 64, 132),
                                      (7, 1024, 132), (1000, 32, 132),
                                      (1, 1, 1), (2000, 8, 132),
                                      (100000, 1, 132), (1057, 4, 132)])
def test_coupled_chunk_launch_plan_keeps_groups_whole(G, Lp, sms):
    """K1's warps hold whole groups (a block a group above 32 lanes) and
    cover every group once; a warp serves one group while the card has
    8 warps an SM or fewer to fill, more (a power of two) only past that;
    the benchmark's 512 groups of 8 run as 512 one-warp blocks."""
    threads, blocks, gpw = k1.launch_plan(G, Lp, sms)
    if Lp > 32:
        assert (threads, blocks, gpw) == (Lp, G, 1)
        return
    assert threads in (32, 128) and gpw * Lp <= 32
    assert gpw & (gpw - 1) == 0
    warps = -(-G // gpw)
    assert (blocks - 1) * threads < warps * 32 <= blocks * threads
    assert G <= 8 * sms * gpw or gpw * Lp == 32
    assert gpw == 1 or G > 8 * sms * gpw // 2
    assert (threads == 128) == (warps >= 4 * sms)
    if (G, Lp, sms) == (512, 8, 132):
        assert (threads, blocks, gpw) == (32, 512, 1)


# ---------------------------------------------------------------------------
# K5 flash attention, K8 RMSNorm
# ---------------------------------------------------------------------------
MODEL_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LSE_TOL = dict(rtol=1e-3, atol=1e-3)


def attn_inputs(b, h, hkv, sq, sk, d, dtype, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=(b, n, s, d)),
                                 dtype=torch.float32).to(dtype).to(device)
                 for n, s in ((h, sq), (hkv, sk), (hkv, sk)))


def naive_attention(q, k, v, causal):
    """Per head, in float64, the mask `kpos <= qpos` without an offset."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    o = torch.empty(q.shape, dtype=torch.float64)
    lse = torch.empty((b, h, sq), dtype=torch.float64)
    for bi in range(b):
        for hi in range(h):
            s = q[bi, hi].double() @ k[bi, hi // g].double().T / d ** 0.5
            if causal:
                qpos = torch.arange(sq)[:, None]
                s = s.masked_fill(torch.arange(s.shape[1])[None] > qpos,
                                  -1e30)
            lse[bi, hi] = torch.logsumexp(s, -1)
            o[bi, hi] = torch.softmax(s, -1) @ v[bi, hi // g].double()
    return o, lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,sq,sk", [(4, 4, 9, 9), (4, 2, 7, 13),
                                         (8, 1, 12, 5)])
def test_flash_attention_plain_matches_naive(h, hkv, sq, sk, causal):
    q, k, v = attn_inputs(2, h, hkv, sq, sk, 16, torch.float32)
    o, lse = k5.flash_attention_fwd_plain(q, k, v, causal=causal)
    o_ref, lse_ref = naive_attention(q, k, v, causal)
    close(o, o_ref, 1e-5, scale=1.0)
    close(lse, lse_ref, 1e-5)


def test_flash_attention_wrapper_dispatch_and_checks():
    q, k, v = attn_inputs(1, 4, 2, 10, 10, 16, torch.float32)
    before = k5.launches
    a = k5.flash_attention_fwd(q, k, v, causal=True)
    b = k5.flash_attention_fwd_plain(q, k, v, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == q.shape and a[1].shape == (1, 4, 10)
    assert a[1].dtype == torch.float32
    assert k5.launches == before                       # CPU: no launch
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k5.flash_attention_fwd(*(x.to("meta") for x in (q, k, v)))
    with pytest.raises(TypeError):
        k5.flash_attention_fwd(q, k.double(), v)
    with pytest.raises(TypeError):
        k5.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dims"):
        k5.flash_attention_fwd(*attn_inputs(1, 4, 2, 6, 6, 24,
                                            torch.float32))
    with pytest.raises(ValueError, match="does not fit"):
        k5.flash_attention_fwd(*attn_inputs(1, 4, 3, 6, 6, 16,
                                            torch.float32))
    with pytest.raises(ValueError):
        k5.flash_attention_fwd(q[0], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        k5.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v)
    with pytest.raises(RuntimeError, match="forward only"):
        k5.flash_attention_fwd(q.clone().requires_grad_(), k, v)
    # ops keeps the model's (B, S, H, D) layout around the kernel's
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True)
    assert torch.equal(o, a[0].transpose(1, 2))


def test_rmsnorm_wrapper_dispatch_and_checks():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(5, 64)), dtype=torch.float32)
    s = torch.as_tensor(rng.normal(size=64), dtype=torch.float32)
    before = k8.launches
    y = k8.rmsnorm(x, s, 1e-6)
    assert torch.equal(y, k8.rmsnorm_plain(x, s, 1e-6))
    ref = x.double() / torch.sqrt((x.double() ** 2).mean(-1, keepdim=True)
                                  + 1e-6) * (1 + s.double())
    close(y, ref, 1e-5, scale=1.0)
    assert k8.launches == before                       # CPU: no launch
    assert k8.rmsnorm(x.bfloat16(), s.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k8.rmsnorm(x.to("meta"), s.to("meta"))
    with pytest.raises(TypeError):
        k8.rmsnorm(x, s.bfloat16())                    # fp32 x, bf16 scale
    with pytest.raises(TypeError):
        k8.rmsnorm(x.bfloat16(), s)                    # bf16 x, fp32 scale
    with pytest.raises(TypeError):
        k8.rmsnorm(x.double(), s.double())
    with pytest.raises(ValueError):
        k8.rmsnorm(x[None], s)
    with pytest.raises(ValueError):
        k8.rmsnorm(x, s[:32])
    with pytest.raises(ValueError, match="contiguous"):
        k8.rmsnorm(x.T.contiguous().T[:, :5], s[:5])


def shifted(t, shift):
    """`t` copied into a buffer `shift` elements past its start: contiguous,
    off the 16-byte alignment of the vector loads when shift is odd."""
    if not shift:
        return t
    flat = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    out = flat[shift:].view(t.shape)
    out.copy_(t)
    return out


def assert_flash_close(o, o_ref, dtype):
    """K5's o against its plain version.  The bf16 kernel splits each
    softmax weight into two bf16 terms, so both sides compute in fp32 and
    round o once: one rounding step (<= 2^-7 |o|) plus a floor of 1e-3 of
    the output's own scale (a typical |o| here is ~0.05, below a fixed
    2e-2 bar).  fp32: MODEL_TOL."""
    o, o_ref = o.float().cpu(), o_ref.float().cpu()
    if dtype == torch.bfloat16:
        bar = 2.0 ** -7 * o_ref.abs() + 1e-3 * o_ref.abs().max()
    else:
        bar = MODEL_TOL[dtype]["atol"] + MODEL_TOL[dtype]["rtol"] * o_ref.abs()
    assert bool(((o - o_ref).abs() <= bar).all()), \
        float((o - o_ref).abs().max())


# (causal, sq, sk, h, hkv, d): every combination of the first axes, then
# TinyLlama's loss shape (S 2,048, 32 / 4 heads)
FLASH_CARD_CASES = [
    (causal, sq, sk, h, hkv, d)
    for causal in (True, False)
    for sq, sk in ((128, 128), (777, 777), (70, 200), (200, 70),
                   (1000, 1000),               # off the 64-row tiles
                   (193, 129), (129, 193))     # Sq > Sk and Sq < Sk, 64k + 1
    for h, hkv in ((8, 8), (8, 1))
    for d in (64, 16, 128, 32)] + [(True, 2048, 2048, 32, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk,h,hkv,d", FLASH_CARD_CASES)
def test_flash_attention_kernel_matches_plain_on_card(causal, sq, sk, h, hkv,
                                                      d, dtype):
    dev = _card()
    q, k, v = attn_inputs(2, h, hkv, sq, sk, d, dtype, dev)
    before = k5.launches
    o, lse = k5.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = k5.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert_flash_close(o, o_ref, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale,shift,h,hkv", [
    (0.3, 0, 8, 2),                    # a given scale, two heads a block
    (-0.2, 0, 8, 2),                   # a negative one
    (None, 1, 8, 2),                   # q, k, v off 16-byte alignment
    (None, 1, 6, 6)])                  # the same, one head a block
def test_flash_attention_kernel_scale_and_alignment_on_card(scale, shift, h,
                                                            hkv, dtype):
    dev = _card()
    q, k, v = (shifted(t, shift) for t in attn_inputs(1, h, hkv, 300, 300,
                                                       64, dtype, dev,
                                                       seed=7))
    assert all(t.is_contiguous() for t in (q, k, v))
    assert (q.data_ptr() % 16 != 0) == bool(shift)
    o, lse = k5.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    o_ref, lse_ref = k5.flash_attention_fwd_plain(q, k, v, causal=True,
                                                  scale=scale)
    assert_flash_close(o, o_ref, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,sdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("t,d", [(1024, 2048), (4, 2048), (7, 100),
                                 (33, 64),
                                 (916, 2048), (8192, 2048),   # prefill, loss
                                 (4, 512), (916, 512),        # MLA kv_norm
                                 (133, 512), (1, 2048)])
@pytest.mark.parametrize("shift", [0, 1])
def test_rmsnorm_kernel_matches_plain_on_card(t, d, xdt, sdt, shift):
    """Each layout `launch_plan` can pick: a block a row (few rows at the
    fixed widths), a warp a row (many rows), the general kernel (other
    widths; rows off 16-byte alignment)."""
    dev = _card()
    rng = np.random.default_rng(t)
    x = torch.as_tensor(rng.normal(0, 3, (t, d)), dtype=torch.float32)
    s = torch.as_tensor(rng.normal(0, 0.3, d), dtype=torch.float32)
    x, s = shifted(x.to(xdt).to(dev), shift), shifted(s.to(sdt).to(dev), shift)
    aligned = (d * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
               and s.data_ptr() % 16 == 0)
    assert aligned == (d * x.element_size() % 16 == 0 and not shift)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tpr, rpb = k8.launch_plan(t, d, sms, x.element_size(), aligned)
    assert (tpr > 32) == (aligned and d in k8.FIXED_WIDTHS and t <= sms)
    before = k8.launches
    y = k8.rmsnorm(x, s, 1e-6)
    ref = k8.rmsnorm_plain(x, s, 1e-6)
    torch.cuda.synchronize()
    assert k8.launches == before + 1 and y.dtype == xdt
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **MODEL_TOL[xdt])


@pytest.mark.parametrize("rows,d,itemsize,aligned,plan", [
    (4, 2048, 2, True, (256, 1)),      # a decode tick: a block a row
    (4, 2048, 4, True, (256, 1)),      # fp32: two pieces a thread
    (4, 512, 2, True, (64, 1)),        # MLA kv_norm at a tick
    (132, 512, 4, True, (128, 1)),     # one row an SM
    (133, 2048, 2, True, (32, 2)),     # more rows than SMs: a warp a row
    (916, 2048, 2, True, (32, 2)),     # a prefill
    (8192, 2048, 2, True, (32, 2)),    # the loss's rows
    (4, 2048, 2, False, (32, 2)),      # rows off 16-byte alignment
    (4, 100, 2, True, (32, 2)),        # another width
])
def test_rmsnorm_launch_plan_picks_the_layout_by_rows(rows, d, itemsize,
                                                      aligned, plan):
    assert k8.launch_plan(rows, d, 132, itemsize, aligned) == plan
    tpr, rpb = plan
    assert tpr * rpb <= k8.MAX_THREADS and tpr % 32 == 0
    if tpr > 32:                        # whole 16-byte pieces a thread
        assert (d * itemsize // 16) % tpr == 0


# ---------------------------------------------------------------------------
# K11 attention backward, K8's backward
# ---------------------------------------------------------------------------
def attn_bwd_inputs(b, h, hkv, sq, sk, d, dtype, causal, device="cpu",
                    seed=0):
    """q, k, v, o, lse (K5's plain forward) and do, at the backward's
    layout, on `device`."""
    q, k, v = attn_inputs(b, h, hkv, sq, sk, d, dtype, device, seed)
    o, lse = k5.flash_attention_fwd_plain(q, k, v, causal=causal)
    rng = np.random.default_rng(seed + 1)
    do = torch.as_tensor(rng.normal(size=q.shape), dtype=torch.float32
                         ).to(dtype).to(device)
    return q, k, v, o, lse, do


def assert_bwd_close(got, ref, dtype):
    """K11 against its plain version: both compute in fp32 and round once,
    in another order: bf16 one rounding step, 2^-7 |x| + 1e-3 max |x|;
    fp32 1e-4 of max |x|."""
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = ref.abs().max()
    bar = (2.0 ** -7 * ref.abs() + 1e-3 * scale if dtype == torch.bfloat16
           else 1e-4 * scale)
    assert bool(((got - ref).abs() <= bar).all()), \
        float((got - ref).abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,sq,sk", [(4, 4, 9, 9), (4, 2, 7, 13),
                                         (8, 1, 12, 5), (2, 1, 1100, 1030)])
def test_flash_attention_bwd_plain_matches_autograd(h, hkv, sq, sk, causal):
    """The plain backward (the reference's chunked recompute, 1,024 queries
    a chunk) against autograd of the plain forward in float64."""
    q, k, v, o, lse, do = attn_bwd_inputs(1, h, hkv, sq, sk, 16,
                                          torch.float32, causal)
    got = k5.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    g = k64.shape[1]
    s = (q64 @ k64.repeat_interleave(h // g, 1).transpose(-1, -2)) / 4.0
    if causal:
        s = s.masked_fill(torch.arange(sk)[None] > torch.arange(sq)[:, None],
                          -1e30)
    o64 = torch.softmax(s, -1) @ v64.repeat_interleave(h // g, 1)
    want = torch.autograd.grad((o64 * do.double()).sum(), (q64, k64, v64))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        close(a, b, 1e-5, scale=float(b.abs().max()))


def test_flash_attention_bwd_wrapper_dispatch_and_checks():
    args = attn_bwd_inputs(1, 4, 2, 10, 12, 16, torch.float32, True)
    before = k5.bwd_launches
    a = k5.flash_attention_bwd(*args, causal=True)
    b = k5.flash_attention_bwd_plain(*args, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [t.shape for t in a] == [t.shape for t in args[:3]]
    assert k5.bwd_launches == before                   # CPU: no launch
    q, k, v, o, lse, do = args
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k5.flash_attention_bwd(*(t.to("meta") for t in args))
    with pytest.raises(ValueError, match="shape"):
        k5.flash_attention_bwd(q, k, v, o[:, :, :5], lse, do)
    with pytest.raises(ValueError, match="shape"):
        k5.flash_attention_bwd(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError, match="lse"):
        k5.flash_attention_bwd(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="contiguous"):
        k5.flash_attention_bwd(q, k, v, o, lse,
                               do.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="head dims"):
        k5.flash_attention_bwd(*attn_bwd_inputs(1, 4, 2, 6, 6, 24,
                                                torch.float32, False))
    with pytest.raises(TypeError):
        k5.flash_attention_bwd(*(t.double() for t in args))


def test_rmsnorm_bwd_plain_matches_autograd():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(0, 2, (9, 100)), dtype=torch.float32)
    s = torch.as_tensor(rng.normal(0, 0.3, 100), dtype=torch.float32)
    g = torch.as_tensor(rng.normal(size=(9, 100)), dtype=torch.float32)
    dx, ds = k8.rmsnorm_bwd_plain(x, s, g, 1e-6)
    x64, s64 = x.double().requires_grad_(), s.double().requires_grad_()
    y = x64 * torch.rsqrt((x64 ** 2).mean(-1, keepdim=True) + 1e-6) * (1 + s64)
    want = torch.autograd.grad((y * g.double()).sum(), (x64, s64))
    close(dx, want[0], 1e-5, scale=float(want[0].abs().max()))
    close(ds, want[1], 1e-5, scale=float(want[1].abs().max()))


def test_rmsnorm_bwd_wrapper_dispatch_and_checks():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(5, 64)), dtype=torch.float32)
    s = torch.as_tensor(rng.normal(size=64), dtype=torch.float32)
    g = torch.as_tensor(rng.normal(size=(5, 64)), dtype=torch.float32)
    before = k8.bwd_launches
    got = k8.rmsnorm_bwd(x, s, g)
    want = k8.rmsnorm_bwd_plain(x, s, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert k8.bwd_launches == before                   # CPU: no launch
    dx, ds = k8.rmsnorm_bwd(x.bfloat16(), s.bfloat16(), g.bfloat16())
    assert dx.dtype == ds.dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k8.rmsnorm_bwd(x.to("meta"), s.to("meta"), g.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        k8.rmsnorm_bwd(x, s, g[:4])
    with pytest.raises(ValueError, match="shape"):
        k8.rmsnorm_bwd(x, s, g.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        k8.rmsnorm_bwd(x, s, g.T.contiguous().T)
    with pytest.raises(TypeError):
        k8.rmsnorm_bwd(x, s.bfloat16(), g)


@pytest.mark.parametrize("rows,d,sms,plan", [
    (8192, 2048, 132, (264, 8)),       # the training step's rows
    (4, 2048, 132, (1, 8)),            # a few rows
    (916, 512, 132, (115, 8)),         # MLA kv_norm rows
    (33, 100, 132, (5, 8)),
    (10, 8192, 132, (2, 7)),           # d-wide partials cap the warps
    (3, 58112, 132, (3, 1))])
def test_rmsnorm_bwd_plan_fits_shared_memory(rows, d, sms, plan):
    assert k8.bwd_plan(rows, d, sms) == plan
    blocks, warps = plan
    assert warps * d * 4 <= k8.SMEM_BYTES and blocks <= 2 * sms
    assert blocks * warps >= min(rows, 2 * sms * warps)


def test_rmsnorm_bwd_plan_refuses_too_wide_rows():
    with pytest.raises(ValueError, match="d <="):
        k8.bwd_plan(4, 58113, 132)


# (causal, sq, sk, h, hkv, d): every combination of the first axes, then
# TinyLlama's training shape (S 2,048, 32 / 4 heads)
FLASH_BWD_CARD_CASES = [
    (causal, sq, sk, h, hkv, d)
    for causal in (True, False)
    for sq, sk in ((128, 128), (1000, 1000),   # off the 64-row tiles
                   (193, 129), (129, 193))     # Sq > Sk and Sq < Sk
    for h, hkv in ((8, 8), (8, 1))
    for d in (64, 16, 128, 32)] + [(True, 2048, 2048, 32, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk,h,hkv,d", FLASH_BWD_CARD_CASES)
def test_flash_attention_bwd_kernel_matches_plain_on_card(causal, sq, sk, h,
                                                          hkv, d, dtype):
    dev = _card()
    b = 4 if sq == 2048 else 2
    args = attn_bwd_inputs(b, h, hkv, sq, sk, d, dtype, causal, dev)
    before = k5.bwd_launches
    got = k5.flash_attention_bwd(*args, causal=causal)
    want = k5.flash_attention_bwd_plain(*args, causal=causal)
    torch.cuda.synchronize()
    assert k5.bwd_launches == before + 1
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert bool(torch.isfinite(a).all())
        assert_bwd_close(a, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale,shift", [(0.3, 0), (None, 1)])
def test_flash_attention_bwd_kernel_scale_alignment_and_bits_on_card(
        scale, shift, dtype):
    """A given scale; inputs off 16-byte alignment; two launches on the same
    inputs give the same bits (no atomics)."""
    dev = _card()
    args = tuple(shifted(t, shift) if t.dtype == dtype else t
                 for t in attn_bwd_inputs(2, 8, 2, 300, 300, 64, dtype, True,
                                          dev, seed=7))
    got = k5.flash_attention_bwd(*args, causal=True, scale=scale)
    again = k5.flash_attention_bwd(*args, causal=True, scale=scale)
    want = k5.flash_attention_bwd_plain(*args, causal=True, scale=scale)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert_bwd_close(a, w, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,sq,sk,h,hkv,d", FLASH_BWD_CARD_CASES)
def test_flash_attention_bwd_plan_covers_the_tiles(causal, sq, sk, h, hkv,
                                                   d, dtype):
    """K11's launch plan at the train shape and the card cases' shapes:
    every query tile of every head in one dq block (two heads of one GQA
    group a bf16 block where the group is even), every key tile of every
    KV head in one dk/dv block, each over the group's query heads and
    the query tiles at or past it (causal), three launches, and the
    heaviest tiles first."""
    b = 4 if sq == 2048 else 2
    plan = k5.bwd_plan(b, h, hkv, sq, sk, d, causal, dtype)
    bf16 = dtype == torch.bfloat16
    g = h // hkv
    nq, nk = -(-sq // 64), -(-sk // 64)
    heads = 2 if bf16 and g % 2 == 0 else 1
    assert plan["launches"] == 3
    assert plan["dsum_blocks"] * 8 >= b * h * sq > (plan["dsum_blocks"]
                                                   - 1) * 8
    assert plan["dq_grid"] == (nq, h // heads, b)
    assert plan["dq_heads"] == heads
    assert plan["dq_threads"] == (128 * heads if bf16 else 256)
    assert plan["dkdv_grid"] == (nk, hkv, b)
    assert plan["dkdv_threads"] == (128 if bf16 else 256)
    assert sorted(plan["dq_tiles"]) == list(range(nq))
    assert sorted(plan["dkdv_tiles"]) == list(range(nk))
    # work of each block: key tiles a query tile sees, query tiles (of all
    # the group's heads) a key tile sees
    q_work = [min(qt + 1, nk) if causal else nk for qt in plan["dq_tiles"]]
    kv_work = [plan["dkdv_items"][kt] for kt in plan["dkdv_tiles"]]
    assert kv_work == [g * max(nq - kt, 0) if causal else g * nq
                       for kt in plan["dkdv_tiles"]]
    if causal:                                  # heaviest first
        assert q_work == sorted(q_work, reverse=True)
        assert kv_work == sorted(kv_work, reverse=True)
    assert plan["dq_first_tile"] == plan["dq_tiles"][0]
    assert plan["dkdv_first_tile"] == plan["dkdv_tiles"][0]
    if (causal, sq, h, hkv, d) == (True, 2048, 32, 4, 64) and bf16:
        assert plan["dq_grid"] == (32, 16, 4)
        assert plan["dkdv_grid"] == (32, 4, 4)
        assert kv_work[:2] == [256, 248] and kv_work[-1] == 8


def test_flash_attention_bwd_plan_skips_empty_passes():
    """Nothing to compute, nothing launched: no query rows leave only the
    dk/dv pass (zeros), no keys only dsum and dq."""
    assert k5.bwd_plan(2, 8, 2, 0, 100, 64, True)["launches"] == 1
    assert k5.bwd_plan(2, 8, 2, 100, 0, 64, True)["launches"] == 2
    assert k5.bwd_plan(2, 8, 2, 100, 0, 64, True)["dkdv_grid"] == (0, 0, 0)
    # Sq < Sk under the causal mask: key tiles past the last query see
    # no item
    plan = k5.bwd_plan(1, 8, 1, 129, 193, 64, True)
    assert plan["dkdv_items"] == (24, 16, 8, 0)


def split_bf16(w):
    """fp32 weights as K11's bf16 kernels multiply them: hi, the top 16
    bits (exact in bf16), and lo = bf16(w - hi)."""
    hi = (w.view(torch.int32) & -65536).view(torch.float32)
    return hi, (w - hi).to(torch.bfloat16).float()


def flash_bwd_emulated(q, k, v, o, lse, do, causal, split=True):
    """K11's bf16 operand rounding in fp32 on the CPU: q, k, v, do in bf16,
    s and dp summed in fp32, p and ds each multiplied as two bf16 terms
    (`split_bf16`; with `split` False as one, bf16(w)), fp32 sums, each
    output rounded once."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / d ** 0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    dsum = (dof * o.float()).sum(-1, keepdim=True)
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        p = p.masked_fill(torch.arange(sk)[None] > torch.arange(sq)[:, None],
                          0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - dsum) * scale
    def terms(w):
        if split:
            return split_bf16(w)
        return w.bfloat16().float(), torch.zeros_like(w)
    (ph, pl), (dh, dl) = terms(p), terms(ds)
    dq = dh @ kf + dl @ kf
    dk = (dh.transpose(-1, -2) @ qf + dl.transpose(-1, -2) @ qf)
    dv = (ph.transpose(-1, -2) @ dof + pl.transpose(-1, -2) @ dof)
    dk = dk.view(b, hkv, g, sk, d).sum(2)
    dv = dv.view(b, hkv, g, sk, d).sum(2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bwd_split_operands_hold_the_bar(d):
    """The bf16 kernels' operand rounding (p and ds as hi + lo bf16
    terms) keeps dq, dk and dv within K11's bar of the plain version:
    g = 8, S = 256, causal.  With one bf16 term each, dq (a sum with heavy
    cancellation: the ds of a row sum to 0) misses the bar: that is what
    the lo products pay for."""
    args = attn_bwd_inputs(1, 8, 1, 256, 256, d, torch.bfloat16, True,
                           seed=d)
    got = flash_bwd_emulated(*args, causal=True)
    want = k5.flash_attention_bwd_plain(*args, causal=True)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert_bwd_close(a, w, torch.bfloat16)
    dq1 = flash_bwd_emulated(*args, causal=True, split=False)[0].float()
    ref = want[0].float()
    bar = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    assert not bool(((dq1 - ref).abs() <= bar).all())


@pytest.mark.cuda
def test_flash_attention_bwd_launch_plan_matches_the_kernel_on_card():
    """The C launcher takes `bwd_plan`'s launches, and each product
    kernel fits an SM."""
    _card()
    cases = [(4, 32, 4, 2048, 2048, 64, True)] + [
        (2, h, hkv, sq, sk, d, causal)
        for causal, sq, sk, h, hkv, d in FLASH_BWD_CARD_CASES[:-1]]
    for args in cases:
        for dtype in (torch.bfloat16, torch.float32):
            got = k5.bwd_device_plan(*args, dtype)
            want = k5.bwd_plan(*args, dtype)
            for key, val in got.items():
                if key.endswith(("_smem", "_blocks_per_sm")):
                    continue
                assert val == want[key], (args, dtype, key)
            assert got["dq_blocks_per_sm"] >= 1, (args, dtype)
            assert got["dkdv_blocks_per_sm"] >= 1, (args, dtype)
            assert max(got["dq_smem"], got["dkdv_smem"]) <= 232448


def assert_rms_bwd_close(dx, ds, x, s, g, eps=1e-6):
    """K8's backward against its plain version: dx one rounding step in
    bf16 (2^-7 |dx| + 1e-3 max |dx|), 1e-5 of max |dx| in fp32; d scale,
    an fp32 sum over the rows in another order, within 1e-5 of the sum of
    its terms' magnitudes plus one rounding step of its type."""
    pdx, pds = k8.rmsnorm_bwd_plain(x, s, g, eps)
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    mag = (g.float() * xf * r).abs().sum(0)
    rnd = 2.0 ** -8 if x.dtype == torch.bfloat16 else 1e-6
    dxf, pdxf = dx.float(), pdx.float()
    bar = (2.0 ** -7 * pdxf.abs() + 1e-3 * pdxf.abs().max()
           if x.dtype == torch.bfloat16 else 1e-5 * pdxf.abs().max())
    assert bool(((dxf - pdxf).abs() <= bar).all()), \
        float((dxf - pdxf).abs().max())
    dbar = 1e-5 * mag + rnd * pds.float().abs()
    assert bool(((ds.float() - pds.float()).abs() <= dbar).all()), \
        float((ds.float() - pds.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,shift", [(8192, 2048, 0), (4, 2048, 0),
                                       (916, 512, 0), (33, 100, 0),
                                       (7, 2048, 1), (1, 2048, 0)])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(t, d, shift, dtype):
    """The training step's rows, a tick's, MLA's kv_norm rows, another
    width and rows off 16-byte alignment (element loads); two launches
    give the same bits."""
    dev = _card()
    rng = np.random.default_rng(t + d)
    x, g = (shifted(torch.as_tensor(rng.normal(0, 3, (t, d)),
                                    dtype=torch.float32).to(dtype).to(dev),
                    shift) for _ in range(2))
    s = torch.as_tensor(rng.normal(0, 0.3, d), dtype=torch.float32
                        ).to(dtype).to(dev)
    before = k8.bwd_launches
    dx, ds = k8.rmsnorm_bwd(x, s, g, 1e-6)
    dx2, ds2 = k8.rmsnorm_bwd(x, s, g, 1e-6)
    torch.cuda.synchronize()
    assert k8.bwd_launches == before + 2
    assert dx.dtype == ds.dtype == dtype
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    assert_rms_bwd_close(dx, ds, x, s, g)


# ---------------------------------------------------------------------------
# K9 grouped expert GEMM
# ---------------------------------------------------------------------------
def gg_inputs(ids, bm, d, f, e, dtype, device="cpu", seed=0, shift=0):
    """Block-sorted rows, expert weights of std 1/sqrt(d) (zeros for the
    experts no block names) and int32 ids; with `shift` x starts that many
    elements into its buffer (contiguous, off the 16-byte alignment of the
    vector loads)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(len(ids) * bm, d)),
                        dtype=torch.float32).to(dtype).to(device)
    if shift:
        pad = torch.zeros(shift, dtype=dtype, device=device)
        x = torch.cat([pad, x.reshape(-1)])[shift:].view(x.shape)
    w = torch.zeros((e, d, f), dtype=dtype, device=device)
    for i in sorted({i for i in ids if i >= 0}):
        w[i] = torch.as_tensor(rng.normal(0, d ** -0.5, (d, f)),
                               dtype=torch.float32).to(dtype)
    return x, w, torch.as_tensor(np.asarray(ids, np.int32)).to(device)


def tick_ids(named=22, blocks=67, experts=64, seed=0):
    """The packed layout's block ids at a 4-slot decode tick of the main
    path: `named` blocks of distinct experts in expert order, then -1."""
    rng = np.random.default_rng(seed)
    named = sorted(rng.choice(experts, named, replace=False).tolist())
    return named + [-1] * (blocks - len(named))


def test_grouped_gemm_wrapper_dispatch_and_checks():
    x, w, ids = gg_inputs([1, -1, 0], 8, 24, 40, 3, torch.float32)
    before = k9.launches
    y = k9.grouped_gemm(x, w, ids, 8)
    assert torch.equal(y, k9.grouped_gemm_plain(x, w, ids, 8))
    assert y.shape == (24, 40) and not y[8:16].any()
    close(y[:8], x[:8].double() @ w[1].double(), 1e-5, scale=1.0)
    assert k9.launches == before                       # CPU: no launch
    assert k9.grouped_gemm(x.bfloat16(), w.bfloat16(), ids, 8).dtype == \
        torch.bfloat16
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k9.grouped_gemm(x.to("meta"), w.to("meta"), ids.to("meta"), 8)
    with pytest.raises(TypeError):
        k9.grouped_gemm(x, w.bfloat16(), ids, 8)       # mixed dtypes
    with pytest.raises(TypeError):
        k9.grouped_gemm(x.double(), w.double(), ids, 8)
    with pytest.raises(TypeError, match="int32"):
        k9.grouped_gemm(x, w, ids.long(), 8)
    with pytest.raises(ValueError, match="multiple"):
        k9.grouped_gemm(x, w, ids, 7)                  # 24 rows, blocks of 7
    with pytest.raises(ValueError, match="multiple"):
        k9.grouped_gemm(x, w, ids[:2], 8)              # one id per block
    with pytest.raises(ValueError, match="does not fit"):
        k9.grouped_gemm(x, w[:, :20], ids, 8)
    with pytest.raises(ValueError, match="contiguous"):
        k9.grouped_gemm(x.T.contiguous().T, w, ids, 8)
    with pytest.raises(ValueError, match="block ids"):
        k9.grouped_gemm(x, w, torch.tensor([1, 3, 0], dtype=torch.int32), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids,bm,d,f,e,shift", [
    ([5, 2, 2, -1, 0, -1, -1], 8, 2048, 1408, 8, 0),    # a decode tick
    ([5, 2, 2, -1, 0, -1, -1], 8, 2048, 1408, 8, 1),    # x misaligned
    ([0, 1, 2, 3, -1], 64, 2048, 1408, 4, 0),            # prefill widths
    ([3, 0, -1, 1], 64, 1408, 2048, 4, 0),               # the down product
    ([1, -1, 0, 1], 16, 100, 77, 2, 0),                  # ragged d and f
    ([0, -1, 1], 128, 33, 130, 2, 0),                    # ragged, bm 128
    ([-1, -1], 8, 64, 64, 1, 0),                         # every block empty
    (tick_ids(), 8, 2048, 1408, 64, 0),                  # the main path's tick
    (tick_ids(), 8, 1408, 2048, 64, 0),                  # its down product
    ([2, 0, 0, -1, 1], 64, 2048, 1000, 3, 0),            # ragged column tile
    ([0, 1, -1], 64, 256, 200, 2, 1)])                   # prefill, shifted x
def test_grouped_gemm_kernel_matches_plain_on_card(ids, bm, d, f, e, shift,
                                                   dtype):
    dev = _card()
    x, w, bid = gg_inputs(ids, bm, d, f, e, dtype, dev, seed=d + f,
                          shift=shift)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(shift)
    before = k9.launches
    got = k9.grouped_gemm(x, w, bid, bm)
    ref = k9.grouped_gemm_plain(x, w, bid, bm)
    torch.cuda.synchronize()
    assert k9.launches == before + 1 and got.dtype == dtype
    got, ref = got.float().cpu(), ref.float().cpu()
    rows = np.repeat(np.asarray(ids) < 0, bm)
    assert not got[rows].any()                         # -1 blocks: zeros
    if dtype == torch.float32:
        close(got, ref, 1e-5, scale=float(ref.abs().max()))
    else:
        # Both sum bf16 products in fp32 and round once: one rounding step
        # (<= 2^-7 |out|), plus a floor of 1e-3 of the output's own scale
        # for entries near 0 (the fp32 sums differ in order).
        bar = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
        assert bool(((got - ref).abs() <= bar).all()), \
            float((got - ref).abs().max())


def gg_bwd_inputs(ids, bm, d, f, e, dtype, device="cpu", seed=0, shift=0):
    """`gg_inputs` plus dy (T, f) of std 1, shifted like x."""
    x, w, bid = gg_inputs(ids, bm, d, f, e, dtype, device, seed, shift)
    rng = np.random.default_rng(seed + 1)
    dy = torch.as_tensor(rng.normal(size=(len(ids) * bm, f)),
                         dtype=torch.float32).to(dtype).to(device)
    if shift:
        pad = torch.zeros(shift, dtype=dtype, device=device)
        dy = torch.cat([pad, dy.reshape(-1)])[shift:].view(dy.shape)
    return x, w, bid, dy


def assert_k9_close(got, ref):
    """K9's bars, forward and backward: fp32 within 2e-5 of max |ref| (fp32
    sums in another order); bf16 one rounding step, 2^-7 |ref| plus a floor
    of 1e-3 max |ref| for entries near 0 (both sum bf16 products in fp32
    and round once)."""
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = float(ref.abs().max())
    bar = 2.0 ** -7 * ref.abs() + 1e-3 * scale if bf16 else 2e-5 * scale
    assert bool(((got - ref).abs() <= bar).all()), \
        float((got - ref).abs().max())


def test_grouped_gemm_backward_wrappers_dispatch_and_checks():
    x, w, ids, dy = gg_bwd_inputs([1, -1, 1], 8, 24, 40, 3, torch.float32)
    before = (k9.launches, k9.bwd_launches)
    dx = k9.grouped_gemm_dx(dy, w, ids, 8)
    dw = k9.grouped_gemm_dw(x, dy, ids, 8, 3)
    assert (k9.launches, k9.bwd_launches) == before     # CPU: no launch
    assert torch.equal(dx, k9.grouped_gemm_dx_plain(dy, w, ids, 8))
    assert torch.equal(dw, k9.grouped_gemm_dw_plain(x, dy, ids, 8, 3))
    assert dx.shape == (24, 24) and not dx[8:16].any()
    close(dx[16:], dy[16:].double() @ w[1].double().T, 1e-5, scale=1.0)
    rows = [*range(8), *range(16, 24)]
    close(dw[1], x[rows].double().T @ dy[rows].double(), 1e-5, scale=1.0)
    assert dw.shape == (3, 24, 40) and not dw[0].any() and not dw[2].any()
    assert k9.grouped_gemm_dw(x.bfloat16(), dy.bfloat16(), ids, 8,
                              3).dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k9.grouped_gemm_dx(dy.to("meta"), w.to("meta"), ids.to("meta"), 8)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k9.grouped_gemm_dw(x.to("meta"), dy.to("meta"), ids.to("meta"), 8, 3)
    with pytest.raises(ValueError, match="does not fit"):
        k9.grouped_gemm_dx(dy[:, :20].contiguous(), w, ids, 8)
    with pytest.raises(ValueError, match="does not fit"):
        k9.grouped_gemm_dw(x, dy[:16].contiguous(), ids, 8, 3)
    with pytest.raises(ValueError, match="experts"):
        k9.grouped_gemm_dw(x, dy, ids, 8, 0)
    with pytest.raises(TypeError):
        k9.grouped_gemm_dw(x, dy.bfloat16(), ids, 8, 3)   # mixed dtypes
    with pytest.raises(TypeError, match="int32"):
        k9.grouped_gemm_dx(dy, w, ids.long(), 8)
    with pytest.raises(ValueError, match="multiple"):
        k9.grouped_gemm_dw(x, dy, ids, 7, 3)
    with pytest.raises(ValueError, match="contiguous"):
        k9.grouped_gemm_dx(dy.T.contiguous().T, w, ids, 8)
    with pytest.raises(ValueError, match="block ids"):
        k9.grouped_gemm_dw(x, dy, torch.tensor([1, 3, 0], dtype=torch.int32),
                           8, 3)
    with pytest.raises(RuntimeError, match="forward only"):
        k9.grouped_gemm_dx(dy.clone().requires_grad_(), w, ids, 8)


def test_grouped_gemm_autograd_is_the_plain_versions_on_cpu():
    """`ops.grouped_gemm`'s backward on CPU tensors is `grouped_gemm_dx_plain`
    and `grouped_gemm_dw_plain`, and agrees with autograd of the plain
    forward; an input that needs no gradient gets none."""
    x, w, ids, dy = gg_bwd_inputs([2, -1, 0, 2], 8, 24, 40, 4, torch.float32)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = ops.grouped_gemm(xl, wl, ids, 8)
    assert torch.equal(out.detach(), k9.grouped_gemm_plain(x, w, ids, 8))
    gx, gw = torch.autograd.grad(out, (xl, wl), dy)
    assert torch.equal(gx, k9.grouped_gemm_dx_plain(dy, w, ids, 8))
    assert torch.equal(gw, k9.grouped_gemm_dw_plain(x, dy, ids, 8, 4))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    ax, aw = torch.autograd.grad(k9.grouped_gemm_plain(xa, wa, ids, 8),
                                 (xa, wa), dy)
    close(gx, ax, 1e-6, scale=float(ax.abs().max()))
    close(gw, aw, 1e-6, scale=float(aw.abs().max()))
    out = ops.grouped_gemm(x, wl, ids, 8)                 # dW only
    (gw2,) = torch.autograd.grad(out, (wl,), dy)
    assert torch.equal(gw2, gw)


def moe_train_ids(blocks=26, experts=8, seed=0):
    """A training step's packed ids in miniature: experts in order with
    0 to 6 blocks each (some none), then the -1 tail."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 7, experts)
    counts[rng.integers(experts)] = 0
    ids = [e for e in range(experts) for _ in range(counts[e])]
    return ids + [-1] * (blocks - len(ids)) if len(ids) < blocks else ids


def moonlight_ids(copies=49_152, block_m=64, experts=64, seed=0):
    """A Moonlight-16B-A3B train step's packed ids (4 x 2,048 tokens, top
    6): `copies` token copies routed at random with seeded counts, each
    expert's copies in whole blocks in expert order, then -1 up to
    ceil(copies / block_m) + experts blocks (832)."""
    counts = np.random.default_rng(seed).multinomial(
        copies, [1.0 / experts] * experts)
    ids = [e for e, c in enumerate(counts) for _ in range(-(-c // block_m))]
    return ids + [-1] * (-(-copies // block_m) + experts - len(ids))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids,bm,d,f,e,shift", [
    ([0, 1, 2, 3, -1], 64, 2048, 1408, 5, 0),        # gate/up, expert 4 empty
    ([3, 0, -1, 1], 64, 1408, 2048, 5, 0),           # the down product
    (moe_train_ids(), 64, 2048, 1408, 8, 0),         # uneven experts
    (moe_train_ids(seed=1), 64, 256, 200, 8, 1),     # shifted, ragged tile
    ([5, 2, 2, -1, 0, -1, -1], 8, 2048, 1408, 8, 0),  # block_m 8
    ([5, 2, 2, -1, 0, -1, -1], 8, 2048, 1408, 8, 1),  # misaligned
    (tick_ids(), 8, 1408, 2048, 64, 0),              # 8-row blocks, 64 experts
    ([1, -1, 0, 1], 16, 100, 77, 3, 0),              # ragged d and f
    ([0, -1, 1], 128, 33, 130, 3, 0),                # ragged, bm 128
    ([-1, -1], 8, 64, 64, 2, 0),                     # every block empty
    ([2, 0, 0, -1, 1, 0], 64, 2048, 1000, 4, 0),     # ragged column tile
    ([0, 1, -1, 1, 2], 128, 512, 384, 3, 0),         # block_m 128
    ([2, 0, -1, 0], 192, 256, 320, 3, 0),            # block_m 192
    ([0, 0, 0, 1, 1, -1, 2], 64, 512, 256, 3, 0),    # an odd expert, then one
    ([0, 0, 0, 2, -1], 64, 1408, 2048, 3, 0),        # down: d 1,408, odd
    ([3] * 24 + [-1, -1], 64, 256, 512, 4, 0),       # one expert, 24 blocks
    ([17] * 5 + [-1], 64, 256, 256, 64, 0),          # 63 of 64 experts empty
    (moonlight_ids(), 64, 2048, 1408, 64, 0),        # Moonlight's gate/up
    (moe_train_ids(), 64, 200, 264, 8, 0),           # d 200: boxes cut short
    ([0, 0, 1, -1], 64, 1000, 1408, 2, 0),           # d 1,000, an odd expert
    ([1, 1, 1, -1, 0], 64, 168, 264, 2, 0)])         # dW rows 192.. past d
def test_grouped_gemm_backward_kernels_match_plain_on_card(ids, bm, d, f, e,
                                                           shift, dtype):
    """Each applicable route (`bwd_route`'s, and "mma" where that is
    "sm90") against the plain versions: the route counted, -1 rows and
    empty experts zeros over NaN-filled memory, K9's bars, two launches
    bitwise equal."""
    dev = _card()
    x, w, bid, dy = gg_bwd_inputs(ids, bm, d, f, e, dtype, dev, seed=d + f,
                                  shift=shift)
    assert (x.data_ptr() % 16 != 0) == (dy.data_ptr() % 16 != 0) == \
        bool(shift)
    auto = k9.bwd_route(dtype, bm, d, f, not shift, e)
    assert auto == ("fma" if dtype == torch.float32 else
                    "sm90" if bm % 64 == 0 and d % 8 == 0 and f % 8 == 0
                    and not shift else "mma")
    ref_x = k9.grouped_gemm_dx_plain(dy, w, bid, bm)
    ref_w = k9.grouped_gemm_dw_plain(x, dy, bid, bm, e)
    for route in [auto] + (["mma"] if auto == "sm90" else []):
        # leave non-zero garbage where the outputs will be allocated, so a
        # row or an expert left unwritten shows
        torch.full((x.numel() + e * d * f,), float("nan"), device=dev)
        before = (k9.launches, k9.bwd_launches,
                  k9.bwd_launches_by_route[route])
        dx = k9._grouped_gemm_dx(dy, w, bid, bm, route)
        dw = k9._grouped_gemm_dw(x, dy, bid, bm, e, route)
        dx2 = k9._grouped_gemm_dx(dy, w, bid, bm, route)
        dw2 = k9._grouped_gemm_dw(x, dy, bid, bm, e, route)
        torch.cuda.synchronize()
        assert (k9.launches, k9.bwd_launches,
                k9.bwd_launches_by_route[route]) == \
            (before[0], before[1] + 4, before[2] + 4), route
        assert dx.dtype == dw.dtype == dtype
        assert dx.shape == (len(ids) * bm, d) and dw.shape == (e, d, f)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2), route
        empty = np.repeat(np.asarray(ids) < 0, bm)
        assert not dx.cpu()[empty].any(), route          # -1 blocks: zeros
        for i in set(range(e)) - set(ids):               # experts owning none
            assert not dw[i].any(), (route, i)
        assert_k9_close(dx, ref_x)
        assert_k9_close(dw, ref_w)
        del dx, dw, dx2, dw2


@pytest.mark.cuda
def test_grouped_gemm_sm90_plan_on_card():
    """The sm90 kernels' tile, as the C library builds it, is 128 x 256
    with K steps of 64; a block's shared memory fits the card's 232,448
    bytes up to `SM90_MAX_EXPERTS`."""
    _card()
    import ctypes
    lib = k9._library()
    out = (ctypes.c_int * 6)()
    dx_smem = lib.grouped_gemm_sm90_plan(0, 0, out)
    assert (out[0], out[1], out[2]) == (128, 256, 64)
    assert out[5] * out[3] < dx_smem <= 232_448
    assert lib.grouped_gemm_sm90_plan(1, k9.SM90_MAX_EXPERTS, out) <= 232_448


@pytest.mark.parametrize("dtype,bm,d,f,aligned,e,route", [
    (torch.bfloat16, 64, 2048, 1408, True, 64, "sm90"),    # Moonlight gate/up
    (torch.bfloat16, 64, 1408, 2048, True, 64, "sm90"),    # its down
    (torch.bfloat16, 128, 512, 384, True, 3, "sm90"),
    (torch.bfloat16, 192, 8, 8, True, 1, "sm90"),
    (torch.bfloat16, 64, 200, 264, True, 8, "sm90"),       # d off 64
    (torch.bfloat16, 64, 1000, 1408, True, 2, "sm90"),
    (torch.bfloat16, 8, 2048, 1408, True, 64, "mma"),      # decode blocks
    (torch.bfloat16, 16, 2048, 1408, True, 8, "mma"),
    (torch.bfloat16, 96, 2048, 1408, True, 8, "mma"),      # block_m off 64
    (torch.bfloat16, 64, 33, 130, True, 3, "mma"),         # d off 8
    (torch.bfloat16, 64, 256, 200 + 4, True, 3, "mma"),    # f off 8
    (torch.bfloat16, 64, 256, 200, False, 8, "mma"),       # misaligned
    (torch.bfloat16, 64, 2048, 1408, True, 2048, "sm90"),
    (torch.bfloat16, 64, 2048, 1408, True, 2049, "mma"),   # too many experts
    (torch.float32, 64, 2048, 1408, True, 64, "fma"),
    (torch.float32, 8, 100, 77, False, 3, "fma")])
def test_bwd_route_table(dtype, bm, d, f, aligned, e, route):
    assert k9.bwd_route(dtype, bm, d, f, aligned, e) == route


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_autograd_launches_the_kernels_on_card(dtype):
    """Through `ops.grouped_gemm` on the card: one K9 forward, one dX and
    one dW launch, never a plain version; the gradients within K9's bars
    of the plain versions'."""
    dev = _card()
    x, w, bid, dy = gg_bwd_inputs(moe_train_ids(), 64, 512, 384, 8, dtype,
                                  dev)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (k9.launches, k9.bwd_launches)
    plain = (k9.grouped_gemm_plain, k9.grouped_gemm_dx_plain,
             k9.grouped_gemm_dw_plain)

    def refuse(*_):
        raise AssertionError("a plain version ran on CUDA tensors")
    k9.grouped_gemm_plain = k9.grouped_gemm_dx_plain = \
        k9.grouped_gemm_dw_plain = refuse
    try:
        out = ops.grouped_gemm(xl, wl, bid, 64)
        gx, gw = torch.autograd.grad(out, (xl, wl), dy)
    finally:
        (k9.grouped_gemm_plain, k9.grouped_gemm_dx_plain,
         k9.grouped_gemm_dw_plain) = plain
    torch.cuda.synchronize()
    assert (k9.launches, k9.bwd_launches) == (before[0] + 1, before[1] + 2)
    assert_k9_close(gx, k9.grouped_gemm_dx_plain(dy, w, bid, 64))
    assert_k9_close(gw, k9.grouped_gemm_dw_plain(x, dy, bid, 64, 8))


# ---------------------------------------------------------------------------
# K10 fused cross-entropy
# ---------------------------------------------------------------------------
def xent_inputs(t, d, v, dtype, dv, device="cpu", seed=0, shift=0):
    """x and emb of std 0.5 (emb as the (d, V) head when `dv`), labels
    drawn at random with the first in column 0 and the last three in the
    last column; with `shift` x starts that many elements into its buffer
    (contiguous, off the 16-byte alignment of the vector loads)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0, 0.5, (t, d)), dtype=torch.float32)
    emb = torch.as_tensor(rng.normal(0, 0.5, (v, d)), dtype=torch.float32)
    lab = rng.integers(0, v, t)
    lab[0], lab[-3:] = 0, v - 1
    x = x.to(dtype).to(device)
    if shift:
        pad = torch.zeros(shift, dtype=dtype, device=device)
        x = torch.cat([pad, x.reshape(-1)])[shift:].view(x.shape)
    emb = (emb.T.contiguous() if dv else emb).to(dtype).to(device)
    return x, emb, torch.as_tensor(lab).to(device)


def test_blocked_xent_wrapper_dispatch_and_checks():
    x, emb, lab = xent_inputs(70, 24, 300, torch.float32, dv=True)
    before = k10.launches
    nll, amax, lse = k10.blocked_xent(x, emb, lab, transpose_emb=True,
                                      block_v=128)
    ref = k10.blocked_xent_plain(x, emb, lab, transpose_emb=True, block_v=128)
    assert all(torch.equal(a, b) for a, b in zip((nll, amax, lse), ref))
    assert k10.launches == before                      # CPU: no launch
    logits = x.double() @ emb.double()
    close(lse, torch.logsumexp(logits, 1), 1e-5, scale=1.0)
    close(nll, torch.logsumexp(logits, 1) - logits[torch.arange(70), lab],
          1e-5, scale=1.0)
    assert torch.equal(amax.long(), logits.argmax(1))
    assert torch.equal(ops.blocked_xent(x, emb, lab, transpose_emb=True)[1],
                       amax)
    x, emb, lab = torch.zeros(4, 8), torch.zeros(10, 8), torch.zeros(4).long()
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k10.blocked_xent(x.to("meta"), emb.to("meta"), lab.to("meta"))
    with pytest.raises(ValueError, match="do not fit"):
        k10.blocked_xent(x, emb, lab, transpose_emb=True)   # (10, 8) as (d, V)
    with pytest.raises(ValueError, match="do not fit"):
        k10.blocked_xent(x, emb, lab[:3])
    with pytest.raises(TypeError):
        k10.blocked_xent(x, emb.bfloat16(), lab)             # mixed dtypes
    with pytest.raises(TypeError):
        k10.blocked_xent(x.double(), emb.double(), lab)
    with pytest.raises(TypeError, match="labels"):
        k10.blocked_xent(x, emb, lab.float())
    with pytest.raises(ValueError, match="contiguous"):
        k10.blocked_xent(x, emb.T.contiguous().T, lab)
    with pytest.raises(ValueError, match="block_v"):
        k10.blocked_xent(x, emb, lab, block_v=0)
    with pytest.raises(RuntimeError, match="forward only"):
        k10.blocked_xent(x.requires_grad_(), emb, lab)


def xent_bwd_inputs(t, d, v, dtype, dv, device="cpu", seed=0, shift=0):
    """`xent_inputs` with K10's plain lse (fp32, from the inputs' values)
    and the loss's gradient of each nll, g = mask / sum(mask), a quarter
    of the mask zeros."""
    x, emb, lab = xent_inputs(t, d, v, dtype, dv, device, seed, shift)
    lse = k10.blocked_xent_plain(x, emb, lab, transpose_emb=dv)[2]
    mask = torch.as_tensor(np.random.default_rng(seed + 1).random(t) > 0.25,
                           dtype=torch.float32)
    g = (mask / mask.sum().clamp(min=1.0)).to(device)
    return x, emb, lab, lse, g


def test_blocked_xent_bwd_wrapper_dispatch_and_checks():
    x, emb, lab, lse, g = xent_bwd_inputs(70, 24, 300, torch.float32, True)
    before = k10.bwd_launches
    dx, de = k10.blocked_xent_bwd(x, emb, lab, lse, g, transpose_emb=True,
                                  block_v=128)
    ref = k10.blocked_xent_bwd_plain(x, emb, lab, lse, g,
                                     transpose_emb=True, block_v=128)
    assert torch.equal(dx, ref[0]) and torch.equal(de, ref[1])
    assert k10.bwd_launches == before                  # CPU: no launch
    assert dx.shape == x.shape and de.shape == emb.shape
    # against the gradient of the fp64 loss sum_t g_t nll_t
    xd, ed = (t.double().requires_grad_() for t in (x, emb))
    logits = xd @ ed
    nll = torch.logsumexp(logits, 1) - logits[torch.arange(70), lab]
    rdx, rde = torch.autograd.grad((g.double() * nll).sum(), (xd, ed))
    close(dx, rdx, 1e-5, scale=float(rdx.abs().max()))
    close(de, rde, 1e-5, scale=float(rde.abs().max()))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k10.blocked_xent_bwd(*(t.to("meta") for t in (x, emb, lab, lse, g)),
                             transpose_emb=True)
    with pytest.raises(ValueError, match="lse"):
        k10.blocked_xent_bwd(x, emb, lab, lse[:5], g, transpose_emb=True)
    with pytest.raises(ValueError, match="g "):
        k10.blocked_xent_bwd(x, emb, lab, lse, g.double(),
                             transpose_emb=True)
    with pytest.raises(ValueError, match="do not fit"):
        k10.blocked_xent_bwd(x, emb, lab, lse, g)           # (24, 300) as (V, d)
    with pytest.raises(TypeError):
        k10.blocked_xent_bwd(x, emb.bfloat16(), lab, lse, g,
                             transpose_emb=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,v,block_v,dv,shift", [
    (8192, 2048, 32000, 8192, True, 0),    # the train step's call, 4 chunks
    (1000, 2048, 32000, 8192, False, 0),   # the same as a tied (V, d) table
    (300, 128, 5000, 2048, False, 0),      # T and V tails, 3 chunks
    (77, 96, 1000, 8192, True, 0),         # one chunk, T and V tails
    (64, 100, 777, 256, True, 0),          # d and V off the vector width
    (130, 64, 1000, 100, False, 0),        # block_v rounded up to 128
    (96, 256, 2000, 512, True, 1),         # x misaligned
    (3, 64, 40, 8192, False, 0),           # fewer rows and columns than a tile
    (129, 256, 3000, 1024, True, 0),       # one row past a 128-row tile
    (200, 512, 5001, 2048, False, 0),      # tied table, V % 8 != 0
    (255, 256, 8200, 8192, True, 0),       # a last chunk of 8 columns
    (200, 200, 3000, 1024, True, 0),       # d 200: the last d box cut short
    (130, 200, 2000, 512, False, 0),       # the same, a tied table
    (70, 96, 1000, 256, False, 0),         # d 96 tied: a box of 32 past d
    (300, 256, 5000, 2048, True, 0),       # V % 256 != 0: a ragged last tile
    (1, 128, 264, 8192, True, 0),          # one token, fewer than a tile
    (129, 2048, 8200, 4096, True, 0),      # TinyLlama's d, a narrow last chunk
    (64, 2048, 163840, 8192, True, 0)])    # Moonlight's head, 20 chunks
def test_blocked_xent_bwd_kernel_matches_plain_on_card(t, d, v, block_v, dv,
                                                       shift, dtype):
    """K12a against its plain version on the same inputs, on every route
    the inputs take (`bwd_route`'s, and "mma" where that is "sm90"):
    bf16 within one rounding step, 2^-7 |x| + 1e-3 max |x| (the products
    sum bf16 dl in fp32, dx over the chunks too, and round once); fp32
    within 1e-4 max |x|; two launches bitwise equal; every launch counted
    on its route."""
    dev = _card()
    x, emb, lab, lse, g = xent_bwd_inputs(t, d, v, dtype, dv, dev,
                                          seed=t + v, shift=shift)
    assert (x.data_ptr() % 16 != 0) == bool(shift)
    auto = k10.bwd_route(dtype, d, v, dv, not shift)
    assert auto == ("fma" if dtype == torch.float32 else
                    "sm90" if d % 8 == 0 and (not dv or v % 8 == 0)
                    and not shift else "mma")
    want = k10.blocked_xent_bwd_plain(x, emb, lab, lse, g,
                                      transpose_emb=dv, block_v=block_v)
    chunk = -(-block_v // k10.TILE_V) * k10.TILE_V
    for route in [auto] + (["mma"] if auto == "sm90" else []):
        before = (k10.bwd_launches, k10.bwd_launches_by_route[route])
        got = k10._blocked_xent_bwd(x, emb, lab, lse, g, dv, block_v, route)
        again = k10._blocked_xent_bwd(x, emb, lab, lse, g, dv, block_v,
                                      route)
        torch.cuda.synchronize()
        n = 2 * -(-v // chunk)                              # one a chunk
        assert (k10.bwd_launches, k10.bwd_launches_by_route[route]) == \
            (before[0] + n, before[1] + n), route
        for a, w, b in zip(got, want, again):
            assert a.dtype == dtype and a.shape == w.shape
            assert torch.equal(a, b), route                 # no atomics
            a, w = a.float().cpu(), w.float().cpu()
            assert bool(torch.isfinite(a).all()), route
            scale = w.abs().max()
            bar = (2.0 ** -7 * w.abs() + 1e-3 * scale
                   if dtype == torch.bfloat16 else 1e-4 * scale)
            assert bool(((a - w).abs() <= bar).all()), \
                (route, float(((a - w).abs() - bar).max()))
        del got, again
    assert torch.equal(k10.blocked_xent_bwd(x, emb, lab, lse, g,
                                            transpose_emb=dv,
                                            block_v=block_v)[0],
                       k10._blocked_xent_bwd(x, emb, lab, lse, g, dv,
                                             block_v, auto)[0])


@pytest.mark.cuda
def test_blocked_xent_bwd_sm90_plan_on_card():
    """The sm90 kernel's tile, as the C library builds it, is 128 x 256
    with d steps of 64; a block's shared memory (ring, staging tiles,
    barriers) fits the card's 232,448 bytes; a launch takes one block an
    SM, no more than there are tiles."""
    dev = _card()
    import ctypes
    from repro_torch.kernels import _build
    sms = _build.sm_count(dev)
    out = (ctypes.c_int * 7)()
    smem = k10._bwd_library().blocked_xent_bwd_sm90_plan(8192, 8192, sms,
                                                         out)
    assert (out[0], out[1], out[2]) == (128, 256, 64)
    assert out[5] * out[3] < smem <= 232_448
    assert out[6] == sms                     # 64 x 32 tiles: every SM
    k10._bwd_library().blocked_xent_bwd_sm90_plan(3, 128, sms, out)
    assert out[6] == 1                       # one tile: one block


@pytest.mark.parametrize("dtype,d,v,dv,aligned,route", [
    (torch.bfloat16, 2048, 32000, True, True, "sm90"),     # TinyLlama's head
    (torch.bfloat16, 2048, 163840, True, True, "sm90"),    # Moonlight's
    (torch.bfloat16, 2048, 32000, False, True, "sm90"),    # a tied table
    (torch.bfloat16, 200, 3000, True, True, "sm90"),       # d off 64
    (torch.bfloat16, 96, 1000, False, True, "sm90"),
    (torch.bfloat16, 256, 5000, True, True, "sm90"),       # V off 256
    (torch.bfloat16, 256, 8200, True, True, "sm90"),
    (torch.bfloat16, 512, 5001, False, True, "sm90"),      # tied: V is rows
    (torch.bfloat16, 512, 5001, True, True, "mma"),        # (d, V): V off 8
    (torch.bfloat16, 100, 777, True, True, "mma"),         # d off 8
    (torch.bfloat16, 100, 776, False, True, "mma"),
    (torch.bfloat16, 256, 2000, True, False, "mma"),       # misaligned
    (torch.float32, 2048, 32000, True, True, "fma"),
    (torch.float32, 100, 777, False, False, "fma")])
def test_xent_bwd_route_table(dtype, d, v, dv, aligned, route):
    assert k10.bwd_route(dtype, d, v, dv, aligned) == route


@pytest.mark.parametrize("t,d,v,dtype,dv,shift,route,takes", [
    (70, 24, 304, torch.bfloat16, True, 0, "sm90", True),
    (70, 24, 304, torch.bfloat16, True, 0, "mma", True),   # forced, allowed
    (70, 24, 304, torch.bfloat16, True, 1, "sm90", False),  # misaligned x
    (70, 24, 304, torch.bfloat16, True, 1, "mma", True),
    (70, 20, 300, torch.bfloat16, False, 0, "sm90", False),  # d off 8
    (70, 24, 301, torch.bfloat16, True, 0, "sm90", False),  # (d, V), V off 8
    (70, 24, 301, torch.bfloat16, False, 0, "sm90", True),  # tied: rows
    (70, 24, 304, torch.float32, True, 0, "sm90", False),
    (70, 24, 304, torch.float32, True, 0, "mma", False),
    (70, 24, 304, torch.float32, True, 0, "fma", True),
    (70, 24, 304, torch.bfloat16, True, 0, "fma", False),
    (70, 24, 304, torch.bfloat16, True, 0, "tma", False)])
def test_blocked_xent_bwd_private_route_on_cpu(t, d, v, dtype, dv, shift,
                                               route, takes):
    """The private `route=` takes a route the inputs allow (and "mma"
    where `bwd_route` gives "sm90") and runs the plain version on the
    CPU, no launch counted; it refuses any other route before anything
    runs."""
    x, emb, lab, lse, g = xent_bwd_inputs(t, d, v, dtype, dv, shift=shift)
    assert (x.data_ptr() % 16 != 0) == bool(shift)
    before = (k10.bwd_launches, dict(k10.bwd_launches_by_route))
    if not takes:
        with pytest.raises(ValueError, match="route"):
            k10._blocked_xent_bwd(x, emb, lab, lse, g, dv, 128, route)
        return
    got = k10._blocked_xent_bwd(x, emb, lab, lse, g, dv, 128, route)
    want = k10.blocked_xent_bwd_plain(x, emb, lab, lse, g, transpose_emb=dv,
                                      block_v=128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (k10.bwd_launches, k10.bwd_launches_by_route) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,v,block_v,dv,shift", [
    (256, 2048, 32000, 8192, True, 0),     # TinyLlama's head, 4 chunks
    (128, 2048, 32000, 8192, False, 0),    # the same as a tied (V, d) table
    (300, 128, 5000, 2048, False, 0),      # T and V tails, 3 chunks
    (77, 96, 1000, 8192, True, 0),         # one chunk, T and V tails
    (64, 100, 777, 256, True, 0),          # d and V off the vector width
    (130, 64, 1000, 100, False, 0),        # block_v rounded up to 128
    (96, 256, 2000, 512, True, 1),         # x misaligned
    (3, 64, 40, 8192, False, 0),           # fewer rows and columns than a tile
    (129, 256, 3000, 1024, True, 0),       # one row past a 128-row tile
    (255, 256, 3000, 1024, False, 0),      # one row short of two tiles
    (384, 2048, 32000, 8192, True, 0),     # TinyLlama's head, 3 row tiles
    (200, 512, 5001, 2048, False, 0)])     # tied table, V % 8 != 0
def test_blocked_xent_kernel_matches_plain_on_card(t, d, v, block_v, dv,
                                                   shift, dtype):
    dev = _card()
    x, emb, lab = xent_inputs(t, d, v, dtype, dv, dev, seed=t + v,
                              shift=shift)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(shift)
    before = k10.launches
    nll, amax, lse = k10.blocked_xent(x, emb, lab, transpose_emb=dv,
                                      block_v=block_v)
    pnll, pamax, plse = k10.blocked_xent_plain(x, emb, lab, transpose_emb=dv,
                                               block_v=block_v)
    torch.cuda.synchronize()
    assert k10.launches == before + 1
    assert nll.dtype == lse.dtype == torch.float32
    assert amax.dtype == torch.int32
    for got, ref in ((nll, pnll), (lse, plse)):
        got, ref = got.cpu(), ref.cpu()
        assert bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), \
            float((got - ref).abs().max())
    logits = (x.float() @ (emb.float() if dv else emb.float().T)).cpu()
    top2 = logits.topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > 1e-4 * logits.abs().max()
    assert torch.equal(amax.cpu()[clear], pamax.cpu()[clear])
    assert torch.equal(amax.cpu()[clear].long(), logits.argmax(1)[clear])


def test_ablation_variants_apply_to_the_sources():
    """Every part-removed variant of `kernels.ablate` still matches the
    current K1, K2, K5, K6, K7, K8, K9 (forward, and the sm90 backward
    kernels of the same source), K10, K11, K12a (its sm90 kernel) and
    K12c sources, with their headers
    inlined (the tool is run on the card; here only its substitutions are
    checked)."""
    from repro_torch.kernels import ablate
    srcs = ablate.variant_sources()
    assert set(ablate.VARIANTS) == {"scan_chunk", "coupled_chunk",
                                    "flash_attention", "decode_attention",
                                    "moe_gemm", "moe_gemm_bwd", "xent",
                                    "xent_bwd", "ssm_scan", "rmsnorm",
                                    "flash_attention_bwd", "selective_scan"}
    for name, variants in ablate.VARIANTS.items():
        base = srcs[(name, "unchanged")]
        assert len(variants) >= 3
        for label in variants:
            assert srcs[(name, label)] != base, (name, label)


# ---------------------------------------------------------------------------
# K6 flash-decoding, K7 linear-recurrence scan
# ---------------------------------------------------------------------------
def decode_inputs(b, h, hkv, sk, d, dtype, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(b, h, d)), dtype=torch.float32)
            .to(dtype).to(device),
            *(torch.as_tensor(rng.normal(size=(b, sk, hkv, d)),
                              dtype=torch.float32).to(dtype).to(device)
              for _ in range(2)))


def scan_inputs(b, t, c, dtype, device="cpu", seed=0):
    """a in (0.5, 1) and b ~ N(0, 0.1), as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (b, t, c)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(0.0, 0.1, (b, t, c)), dtype=torch.float32)
    return a.to(dtype).to(device), x.to(dtype).to(device)


def selective_inputs(b, s, di, n, dtype, device="cpu", seed=0):
    """K12c inputs as the Mamba block gives them: dt = softplus(N(-3, 1))
    fp32, Bm, Cm, x ~ N(0, 1) in `dtype`, A = -exp(A_log) fp32 with A_log
    near the init's log(1..N)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(-3.0, 1.0, (b, s, di))))
    A = -np.exp(np.log(np.arange(1, n + 1)) + rng.normal(0.0, 0.1, (di, n)))
    bm, cm = (rng.normal(size=(b, s, n)) for _ in range(2))
    x = rng.normal(size=(b, s, di))

    def t(a, dt_=torch.float32):
        return torch.as_tensor(a, dtype=torch.float32).to(dt_).to(device)
    return t(dt), t(bm, dtype), t(cm, dtype), t(x, dtype), t(A)


def naive_selective(dt, bm, cm, x, A):
    """The selective scan in fp64, one step at a time."""
    dt, bm, cm, x, A = (v.double() for v in (dt, bm, cm, x, A))
    bsz, s, di = dt.shape
    h = torch.zeros((bsz, di, A.shape[1]), dtype=torch.float64)
    y = torch.empty((bsz, s, di), dtype=torch.float64)
    for t in range(s):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        y[:, t] = (h * cm[:, t, None, :]).sum(-1)
    return y, h


def naive_decode(q, k, v, length):
    """One (b, head) at a time in fp64 over the keys before
    min(length, Sk); zeros where there are none."""
    b, h, d = q.shape
    g = h // k.shape[2]
    n = max(0, min(int(length), k.shape[1]))
    o = torch.zeros((b, h, d), dtype=torch.float64)
    for bi in range(b):
        for hi in range(h):
            if n:
                kk = k[bi, :n, hi // g].double()
                p = torch.softmax(kk @ q[bi, hi].double() / d ** 0.5, 0)
                o[bi, hi] = p @ v[bi, :n, hi // g].double()
    return o


@pytest.mark.parametrize("length", [0, 1, 77, 300, 301, 1000])
def test_decode_attention_plain_matches_naive(length):
    q, k, v = decode_inputs(2, 8, 2, 300, 16, torch.float32, seed=length)
    got = k6.decode_attention_plain(q, k, v, length)
    close(got, naive_decode(q, k, v, length), 1e-5, scale=1.0)
    n = torch.tensor([length], dtype=torch.int32)
    assert torch.equal(k6.decode_attention_plain(q, k, v, n), got)


def test_decode_attention_wrapper_dispatch_and_checks():
    q, k, v = decode_inputs(2, 8, 2, 40, 16, torch.float32)
    before = k6.launches
    o = k6.decode_attention(q, k, v, 25, nsplit=3, block_k=8)
    assert torch.equal(o, k6.decode_attention_plain(q, k, v, 25))
    assert k6.launches == before                       # CPU: no launch
    assert torch.equal(ops.decode_attention(q, k, v, 25), o)
    n = torch.tensor([25], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, k, v, n), o)
    assert torch.equal(ops.decode_attention(q, k, v, np.int32(25)), o)
    assert ops.decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                25).dtype == torch.bfloat16
    assert torch.equal(k6.decode_attention(q, k, v, 25, nsplit=1,
                                           block_k=256), o)   # not the split
    assert k6.split_plan(4, 4, 2048, 132) == (16, 128)   # two tiles a split
    assert k6.split_plan(1, 8, 32768, 132) == (47, 704)   # 376 CTAs
    assert k6.split_plan(1, 1, 100, 132) == (1, 128)     # a short split
    assert k6.split_plan(1, 1, 4096, 132) == (32, 128)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k6.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 3)
    with pytest.raises(TypeError):
        k6.decode_attention(q, k.bfloat16(), v, 3)             # mixed dtypes
    with pytest.raises(TypeError):
        k6.decode_attention(q.double(), k.double(), v.double(), 3)
    with pytest.raises(TypeError, match="length"):
        k6.decode_attention(q, k, v, 3.0)
    with pytest.raises(TypeError, match="length"):
        k6.decode_attention(q, k, v, torch.tensor([3]))        # int64
    with pytest.raises(TypeError, match="length"):
        k6.decode_attention(q, k, v, torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="length lies on"):
        k6.decode_attention(q, k, v, n.to("meta"))
    with pytest.raises(ValueError):
        k6.decode_attention(q[None], k, v, 3)
    with pytest.raises(ValueError):
        k6.decode_attention(q[:, :7], k, v, 3)       # 7 heads over 2 kv heads
    with pytest.raises(ValueError):
        k6.decode_attention(q, k[:, :0], v[:, :0], 3)          # no key
    with pytest.raises(ValueError, match="D <= 256"):
        k6.decode_attention(*decode_inputs(1, 2, 1, 4, 264, torch.float32), 3)
    with pytest.raises(ValueError, match="contiguous"):
        k6.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v, 3)
    with pytest.raises(ValueError, match="nsplit"):
        k6.decode_attention(q, k, v, 3, nsplit=0)


@pytest.mark.parametrize("b,hkv,sk,sms", [
    (4, 4, 2048, 132), (1, 8, 32768, 132), (1, 1, 4096, 132),
    (1, 8, 1, 132), (3, 2, 300, 132), (64, 8, 100, 132),
    (2, 3, 32769, 114), (1, 1, 31, 1), (65535, 1, 40, 132)])
def test_decode_attention_split_plan_tiles_the_cache(b, hkv, sk, sms):
    """The split pass's plan: whole key tiles per split, the splits cover
    [0, Sk) exactly and none overlaps or is empty, and no more splits than
    the CTA target asks for."""
    ns, per = k6.split_plan(b, hkv, sk, sms)
    assert per % k6.KEY_TILE == 0
    assert per >= k6.MIN_SPLIT_TILES * k6.KEY_TILE
    bounds = [(s * per, min((s + 1) * per, sk)) for s in range(ns)]
    assert bounds[0][0] == 0 and bounds[-1][1] == sk
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert ns <= max(1, k6.CTAS_PER_SM * sms // (b * hkv))


@pytest.mark.parametrize("b,h,hkv,sk", [(4, 32, 4, 2048),     # TinyLlama
                                        (1, 40, 8, 32768)])   # 32k Qwen heads
def test_decode_attention_split_plan_fills_the_card(b, h, hkv, sk):
    """At the two shapes `chip_smoke.py` drives, the split pass fills the
    132 SMs of an H100 in one wave of at most CTAS_PER_SM CTAs an SM: at
    the 32k cache at least 2 an SM (264 CTAs), at TinyLlama's short cache
    at least one, each split the least MIN_SPLIT_TILES tiles."""
    ns, per = k6.split_plan(b, hkv, sk, 132)
    ctas = b * hkv * ns
    assert 132 <= ctas <= k6.CTAS_PER_SM * 132
    if sk == 32768:
        assert ctas >= 2 * 132
    else:
        assert per == k6.MIN_SPLIT_TILES * k6.KEY_TILE


@pytest.mark.parametrize("length", [0, 1, 1000, 2048, 3000])
def test_decode_attention_plain_is_the_reference_function(length):
    """The plain version is the reference's function as the port pins it,
    whatever split the kernel takes: a softmax over the keys before
    min(length, Sk), zeros at length 0, the same result past Sk, and the
    reference's arguments `nsplit` / `block_k` change nothing on the CPU."""
    q, k, v = decode_inputs(1, 8, 2, 2048, 32, torch.float32, seed=length)
    got = k6.decode_attention_plain(q, k, v, length)
    close(got, naive_decode(q, k, v, length), 1e-5, scale=1.0)
    for nsplit, block_k in ((1, 256), (8, 256), (64, 32)):
        assert torch.equal(k6.decode_attention(q, k, v, length, nsplit=nsplit,
                                               block_k=block_k), got)
    if length >= 2048:
        assert torch.equal(got, k6.decode_attention_plain(q, k, v, 2048))


def test_ssm_scan_wrapper_dispatch_and_checks():
    a, b = scan_inputs(2, 9, 5, torch.float32)
    before = k7.launches
    hs, hf = k7.ssm_scan(a, b, chunk=4, block_c=2)
    phs, phf = k7.ssm_scan_plain(a, b)
    assert torch.equal(hs, phs) and torch.equal(hf, phf)
    assert k7.launches == before                       # CPU: no launch
    h = torch.zeros(2, 5, dtype=torch.float64)
    for t in range(9):
        h = a[:, t].double() * h + b[:, t].double()
        close(hs[:, t], h, 1e-6, scale=1.0)
    assert torch.equal(hf, hs[:, -1])
    hs16, hf16 = ops.ssm_scan(a.bfloat16(), b.bfloat16())
    assert hs16.dtype == hf16.dtype == torch.float32
    assert torch.equal(ops.ssm_scan(a, b)[0], hs)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k7.ssm_scan(a.to("meta"), b.to("meta"))
    with pytest.raises(TypeError):
        k7.ssm_scan(a, b.bfloat16())
    with pytest.raises(TypeError):
        k7.ssm_scan(a.double(), b.double())
    with pytest.raises(ValueError):
        k7.ssm_scan(a, b[:, :8])
    with pytest.raises(ValueError):
        k7.ssm_scan(a[0], b[0])
    with pytest.raises(ValueError, match="contiguous"):
        k7.ssm_scan(a.transpose(1, 2).contiguous().transpose(1, 2),
                    b.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="chunk"):
        k7.ssm_scan(a, b, chunk=0)


def test_selective_scan_wrapper_dispatch_and_checks():
    """On a CPU tensor K12c's wrapper is its plain version (no launch), in
    the reference's chunks of 64 (S = 100 leaves a short last one),
    within 1e-6 of max |value| of an fp64 scan; N off a power of two."""
    args = selective_inputs(2, 100, 24, 5, torch.float32)
    before = k12c.launches
    y, hf = k12c.selective_scan(*args)
    py, phf = k12c.selective_scan_plain(*args)
    assert torch.equal(y, py) and torch.equal(hf, phf)
    assert k12c.launches == before                     # CPU: no launch
    assert y.dtype == hf.dtype == torch.float32
    assert y.shape == (2, 100, 24) and hf.shape == (2, 24, 5)
    ny, nh = naive_selective(*args)
    close(y, ny, 1e-6, scale=float(ny.abs().max()))
    close(hf, nh, 1e-6, scale=float(nh.abs().max()))
    by, bh = k12c.selective_scan(*selective_inputs(2, 100, 24, 5,
                                                   torch.bfloat16))
    assert by.dtype == bh.dtype == torch.float32
    dt, bm, cm, x, A = args
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k12c.selective_scan(*(v.to("meta") for v in args))
    with pytest.raises(TypeError):                     # Bm, Cm, x differ
        k12c.selective_scan(dt, bm.bfloat16(), cm, x, A)
    with pytest.raises(TypeError):                     # dt not fp32
        k12c.selective_scan(dt.bfloat16(), bm, cm, x, A)
    with pytest.raises(TypeError):
        k12c.selective_scan(dt, bm.double(), cm.double(), x.double(), A)
    with pytest.raises(ValueError):
        k12c.selective_scan(dt, bm, cm, x[:, :99], A)
    with pytest.raises(ValueError):
        k12c.selective_scan(dt, bm[..., :4], cm[..., :4], x, A)
    with pytest.raises(ValueError):
        k12c.selective_scan(dt, bm, cm, x, A[:20])
    with pytest.raises(ValueError, match="contiguous"):
        k12c.selective_scan(dt, bm, cm, x.transpose(1, 2).contiguous()
                            .transpose(1, 2), A)


def _forward_only_call(kernel, grad_arg, device):
    """One call of K6, K7, K8, K10 or K12c with input `grad_arg` requiring
    grad."""
    if kernel == "decode_attention":
        args = list(decode_inputs(1, 4, 2, 16, 8, torch.float32, device))
        fn = lambda a: k6.decode_attention(*a, 9)  # noqa: E731
    elif kernel == "ssm_scan":
        args = list(scan_inputs(1, 6, 4, torch.float32, device))
        fn = lambda a: k7.ssm_scan(*a)  # noqa: E731
    elif kernel == "blocked_xent":
        args = list(xent_inputs(5, 16, 40, torch.float32, True, device))
        fn = lambda a: k10.blocked_xent(*a, transpose_emb=True)  # noqa: E731
    elif kernel == "selective_scan":
        args = list(selective_inputs(1, 6, 4, 16, torch.float32, device))
        fn = lambda a: k12c.selective_scan(*a)  # noqa: E731
    else:
        rng = np.random.default_rng(0)
        args = [torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                                device=device) for shape in ((3, 64), (64,))]
        fn = lambda a: k8.rmsnorm(*a)  # noqa: E731
    args[grad_arg] = args[grad_arg].requires_grad_()
    return fn(args)


_FORWARD_ONLY = [("decode_attention", 0), ("decode_attention", 1),
                 ("decode_attention", 2), ("ssm_scan", 0), ("ssm_scan", 1),
                 ("rmsnorm", 0), ("rmsnorm", 1), ("blocked_xent", 0),
                 ("blocked_xent", 1)] + [("selective_scan", i)
                                         for i in range(5)]


@pytest.mark.parametrize("kernel,grad_arg", _FORWARD_ONLY)
def test_forward_only_kernels_refuse_grad(kernel, grad_arg):
    """K6, K7, K8, K10 and K12c's raw wrappers refuse an input that
    requires grad before they pick the device, as K5 and K9 do: the CUDA kernels
    write into fresh tensors and would drop the gradient without a word
    (`ops.BlockedXent` is K10's differentiable entry)."""
    with pytest.raises(RuntimeError, match="forward only"):
        _forward_only_call(kernel, grad_arg, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,grad_arg", _FORWARD_ONLY)
def test_forward_only_kernels_refuse_grad_on_card(kernel, grad_arg):
    dev = _card()
    counts = (k6, k7, k8, k10, k12c)
    before = [k.launches for k in counts]
    with pytest.raises(RuntimeError, match="forward only"):
        _forward_only_call(kernel, grad_arg, dev)
    assert [k.launches for k in counts] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sk,d,length,nsplit,block_k", [
    (4, 32, 4, 2048, 64, 1000, 8, 256),    # TinyLlama's decode
    (1, 40, 8, 4096, 128, 4096, 8, 256),   # Qwen2.5-14B's heads
    (2, 8, 2, 1024, 64, 700, 4, 256),
    (2, 16, 1, 2048, 64, 100, 8, 256),     # MQA, mostly masked
    (1, 8, 2, 300, 64, 77, 3, 128),        # Sk off the tiles
    (1, 8, 2, 300, 64, 301, 3, 128),       # length > Sk
    (3, 8, 2, 300, 64, 0, 3, 128),         # length 0
    (2, 4, 4, 130, 18, 129, 8, 16),        # D off the vector width
    (1, 64, 2, 200, 128, 150, 2, 64),      # g * D = 4096
    (1, 40, 8, 32768, 128, 32768, 8, 256),  # the 32k Qwen2.5-14B-head cache
    (1, 8, 1, 4096, 128, 3001, 8, 256),    # B * Hkv = 1
])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_decode_attention_kernel_matches_plain_on_card(b, h, hkv, sk, d,
                                                       length, nsplit,
                                                       block_k, as_tensor,
                                                       dtype):
    dev = _card()
    q, k, v = decode_inputs(b, h, hkv, sk, d, dtype, dev, seed=sk + length)
    n = (torch.tensor([length], dtype=torch.int32, device=dev) if as_tensor
         else length)
    before = k6.launches
    o = k6.decode_attention(q, k, v, n, nsplit=nsplit, block_k=block_k)
    ref = k6.decode_attention_plain(q, k, v, n)
    torch.cuda.synchronize()
    assert k6.launches == before + 1 and o.dtype == dtype
    assert bool(torch.isfinite(o.float()).all())
    # Both compute in fp32 and round once: bf16 may differ by one rounding
    # step (<= 2^-7 |o|), plus a floor of 1e-3 of the output's own scale
    # (a typical |o| is about sqrt(e / n) here, below a fixed 2e-2 bar).
    o, ref = o.float().cpu(), ref.float().cpu()
    if dtype == torch.bfloat16:
        bar = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    else:
        bar = MODEL_TOL[dtype]["atol"] + MODEL_TOL[dtype]["rtol"] * ref.abs()
    assert bool(((o - ref).abs() <= bar).all()), float((o - ref).abs().max())
    if length == 0:
        assert not bool(o.any())


def scan_edge(a, x, edge, steps):
    """Inputs of a chunked scan's edge cases: a = 0 resets every 37 steps;
    a up to 1.05; b = 0 over the first chunk of every other channel."""
    a, x = a.clone(), x.clone()
    if edge == "resets":
        a[:, ::37] = 0
    elif edge == "a to 1.05":
        a = 0.9 + (a - 0.5) * 0.3
    elif edge == "b 0 first chunk":
        x[:, :steps, ::2] = 0
    return a, x


@pytest.mark.parametrize("b,t,c,sms", [(1, 916, 131072, 132),
                                       (1, 2048, 4096, 132),
                                       (1, 2048, 4096, 78),
                                       (2, 256, 512, 132), (1, 100, 300, 132),
                                       (2, 64, 64, 132), (3, 7, 129, 132),
                                       (1, 1000, 64, 132), (4, 500, 1000, 132),
                                       (1, 10 ** 6, 1, 132), (1, 31, 1, 132)])
def test_scan_plan_cuts_t_into_chunks(b, t, c, sms):
    chunks, steps = k7.scan_plan(b, t, c, sms)
    if (b, t, c) == (1, 916, 131072):
        assert chunks == 1               # Falcon-Mamba-7B: the chains fill it
    if (b, t, c) == (1, 2048, 4096):
        assert chunks > 1                # the RG-LRU: 32 blocks of chains
    assert (chunks - 1) * steps < t <= chunks * steps      # T exactly
    assert 1 <= chunks <= k7.MAX_CHUNKS
    if chunks > 1:
        assert steps >= k7.MIN_STEPS and steps % k7.STEP_GROUP == 0
        assert b * c * chunks <= 2 * k7.CHAINS_PER_SM * sms or \
            steps == k7.MIN_STEPS


@pytest.mark.parametrize("edge", ["uniform", "resets", "a to 1.05",
                                  "b 0 first chunk"])
@pytest.mark.parametrize("steps", [1, 7, 16, 33, 64, 100, 128])
def test_ssm_scan_chunk_decomposition_matches_the_sequential_scan(steps,
                                                                  edge):
    """`ssm_scan_chunked_plain` (the kernel's chunks, carried state and
    rerun, in tensor ops) against the sequential plain scan: within 1e-6
    of max |h|, chunk lengths that do and do not divide T = 100."""
    a, x = scan_edge(*scan_inputs(2, 100, 33, torch.float32, seed=steps),
                     edge, steps)
    hs, hf = k7.ssm_scan_plain(a, x)
    chs, chf = k7.ssm_scan_chunked_plain(a, x, steps)
    bar = 1e-6 * float(hs.abs().max())
    assert float((chs - hs).abs().max()) <= bar
    assert float((chf - hf).abs().max()) <= bar
    assert torch.equal(chf, chs[:, -1])
    if edge == "b 0 first chunk":        # a zero state carries exactly
        assert not bool(chs[:, :steps, ::2].any())
    if edge == "resets" and steps <= 37:  # a reset starts the chain anew
        assert torch.equal(chs[:, 37], x[:, 37])


# (b, t, c, edge): every edge at the small shapes, Falcon-Mamba-7B's width
SCAN_CARD_CASES = [
    (b, t, c, edge)
    for b, t, c in ((2, 256, 512), (1, 100, 300), (2, 64, 64), (3, 7, 129),
                    (1, 2048, 4096), (1, 1000, 64), (4, 500, 1000),
                    (2, 333, 100))
    for edge in ("uniform", "resets", "a to 1.05", "b 0 first chunk")
] + [(1, 916, 131072, "uniform")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,edge", SCAN_CARD_CASES)
def test_ssm_scan_kernel_matches_plain_on_card(b, t, c, edge, dtype):
    """Both paths of `scan_plan`: one chunk (the chains fill the card, or
    T is short) and the chunk-parallel scan (small B x C, T not a multiple
    of the chunk), with resets, growing a and zero first chunks."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks, steps = k7.scan_plan(b, t, c, sms)
    assert (chunks > 1) == (b * c * 2 < k7.CHAINS_PER_SM * sms
                            and t >= 2 * k7.MIN_STEPS)
    a, x = scan_edge(*scan_inputs(b, t, c, torch.float32, seed=t + c),
                     edge, steps)
    a, x = a.to(dtype).to(dev), x.to(dtype).to(dev)
    before = k7.launches
    hs, hf = k7.ssm_scan(a, x)
    phs, phf = k7.ssm_scan_plain(a, x)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    assert hs.dtype == hf.dtype == torch.float32
    assert bool(torch.isfinite(hs).all())
    bar = 1e-5 * float(phs.abs().max())
    assert float((hs - phs).abs().max()) <= bar
    assert float((hf - phf).abs().max()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("t", [916, 1001])
def test_rglru_scan_launches_k7_on_card(t):
    """The RG-LRU's recurrence (`models/ssm.py::chunked_diag_scan`) on the
    card: one K7 launch, within 1e-5 of max |h| of the plain version, at
    RecurrentGemma-9B's width (C 4,096) over the serving path's 916-token
    prompt and over 1,001 steps, both off K7's step group of 8."""
    from repro_torch.models import ssm
    dev = _card()
    a, x = scan_inputs(1, t, 4096, torch.float32, dev, seed=t)
    a = 0.9 + (a - 0.5) * 0.198                   # the lru_a range
    assert t % k7.STEP_GROUP
    before = k7.launches
    hs, hf = ssm.chunked_diag_scan(a, x)
    phs, phf = k7.ssm_scan_plain(a, x)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    assert hs.is_cuda and hs.dtype == hf.dtype == torch.float32
    bar = 1e-5 * float(phs.abs().max())
    assert float((hs - phs).abs().max()) <= bar
    assert float((hf - phf).abs().max()) <= bar


# (b, s, d_inner, N): B = 2, S off every tile (77, 1,000), d_inner off the
# block's channels (200), N 16 (Falcon-Mamba), 8 (the smoke config), off a
# power of two (5) and a full warp (32); Falcon-Mamba-7B's width
SELECTIVE_CARD_CASES = [(2, 77, 200, 16), (1, 1000, 200, 16),
                        (2, 1000, 256, 16), (2, 77, 64, 8), (1, 130, 33, 5),
                        (1, 100, 40, 32), (3, 9, 7, 1), (1, 916, 8192, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,di,n", SELECTIVE_CARD_CASES)
def test_selective_scan_kernel_matches_plain_on_card(b, s, di, n, dtype):
    """K12c against its plain version on the same inputs: y within 1e-5
    of max |y|, h_final within 1e-5 of max |h| (both fp32; `expf` and the
    butterfly's order against `torch.exp` and the einsum's), one launch a
    call, and two launches bitwise equal."""
    dev = _card()
    args = selective_inputs(b, s, di, n, dtype, dev, seed=s + di + n)
    before = k12c.launches
    y, hf = k12c.selective_scan(*args)
    y2, hf2 = k12c.selective_scan(*args)
    py, phf = k12c.selective_scan_plain(*args)
    torch.cuda.synchronize()
    assert k12c.launches == before + 2
    assert y.dtype == hf.dtype == torch.float32
    assert y.shape == (b, s, di) and hf.shape == (b, di, n)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    assert float((y - py).abs().max()) <= 1e-5 * float(py.abs().max())
    assert float((hf - phf).abs().max()) <= 1e-5 * float(phf.abs().max())
    assert torch.equal(y, y2) and torch.equal(hf, hf2)


@pytest.mark.cuda
def test_mamba_scan_launches_k12c_on_card():
    """Mamba's selective scan on the model path (`models/ssm.py::
    _mamba_chunk_scan`) on the card at Falcon-Mamba-7B's widths (d_inner
    8,192, N 16) over 300 steps, bf16 inputs: one K12c launch, within
    1e-5 of the plain version."""
    from repro_torch.models import ssm
    dev = _card()
    dt, bm, cm, x, A = selective_inputs(1, 300, 8192, 16, torch.bfloat16,
                                        dev, seed=3)
    before = k12c.launches
    y, hf = ssm._mamba_chunk_scan(dt, bm, cm, x, A)
    py, phf = k12c.selective_scan_plain(dt, bm, cm, x, A)
    torch.cuda.synchronize()
    assert k12c.launches == before + 1 and y.is_cuda
    assert float((y - py).abs().max()) <= 1e-5 * float(py.abs().max())
    assert float((hf - phf).abs().max()) <= 1e-5 * float(phf.abs().max())


# ---------------------------------------------------------------------------
# K3 and K4 on the card: kernels against their plain versions
# ---------------------------------------------------------------------------
_K3_BARS = {"mixed": (1e-6, 1e-5)}          # (values, gradient in norm)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [(0, 1, 2, 3, 4), (1, 4)])
@pytest.mark.parametrize("name", list(OBJECTIVE_CASES))
def test_objective_scan_kernels_match_plain_on_card(name, keep):
    """K3 forward and backward through `TraceScan` against autograd of the
    plain objective on the card: values per field and the gradient of a
    loss of all outputs, or of two (the others reach the backward as no
    gradient); one launch of each kernel."""
    dev = _card()
    obj, U = objective_case(name, dev)
    rtol, gtol = _K3_BARS.get(name, (RTOL, RTOL))
    u_k = torch.tensor(U, device=dev, requires_grad=True)
    u_p = torch.tensor(U, device=dev, requires_grad=True)
    before = (k3.fwd_launches, k3.bwd_launches)
    got = k3.trace_objective(obj, u_k)
    (g_k,) = torch.autograd.grad(weighted_loss(got, keep), u_k)
    torch.cuda.synchronize()
    assert (k3.fwd_launches, k3.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = k3.trace_objective_plain(obj, u_p)
    (g_p,) = torch.autograd.grad(weighted_loss(ref, keep), u_p)
    fields_close(got, ref, rtol)
    grads_close(g_k, g_p, gtol, components=name != "mixed")
    if name == "unfinished":
        assert (got.unfinished > 0.1).all()
    if name == "ensemble4":
        assert got.co2_kg.shape == (U.shape[0], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["week", "mixed", "ensemble4", "boundary",
                                  "n1_t280", "n1024_t292"])
def test_objective_scan_launches_match_plain_versions_on_card(name):
    """Each K3 launch against its own plain version at the same inputs:
    outputs and the checkpoint of each slot's starting remaining; the
    backward's d/du for every output weighted."""
    dev = _card()
    obj, U = objective_case(name, dev, n=37)
    rtol = _K3_BARS.get(name, (RTOL, RTOL))
    *tables, scal = k3.scan_inputs(obj, dev)
    u = torch.tensor(U, device=dev)
    got = k3.trace_scan_fwd(u, *tables, scal, keep=True)
    ref = k3.trace_scan_fwd_plain(u, *tables, scal, keep=True)
    fields_close(got[:5], ref[:5], rtol[0])
    close(got[5].cpu(), ref[5].cpu(), rtol[0], scale=scal[0])
    rng = np.random.default_rng(5)
    grads = [torch.as_tensor(rng.normal(size=tuple(x.shape)), device=dev)
             for x in ref[:5]]
    g = k3.trace_scan_bwd(u, *tables, scal, ref[5], grads)
    g_ref = k3.trace_scan_bwd_plain(u, *tables, scal, ref[5], grads)
    grads_close(g, g_ref, rtol[1], components=name != "mixed")


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [(0, 1, 2, 3, 4, 5), (1, 5)])
@pytest.mark.parametrize("name", list(FLEET_CASES))
def test_fleet_objective_kernels_match_plain_on_card(name, keep):
    """K4 forward and backward through `FleetScan` against autograd of the
    plain objective (its mask passes) on the card; one launch of each
    kernel."""
    dev = _card()
    obj, obj_p, U = fleet_pair(name, dev)
    u_k = torch.tensor(U, device=dev, requires_grad=True)
    u_p = torch.tensor(U, device=dev, requires_grad=True)
    before = (k4.fwd_launches, k4.bwd_launches)
    got = k4.fleet_objective(obj, u_k)
    (g_k,) = torch.autograd.grad(weighted_loss(got, keep), u_k)
    torch.cuda.synchronize()
    assert (k4.fwd_launches, k4.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = k4.fleet_objective_plain(obj_p, u_p)
    (g_p,) = torch.autograd.grad(weighted_loss(ref, keep), u_p)
    fields_close(got, ref, RTOL)
    grads_close(g_k, g_p, RTOL)
    if name == "m3_unfinished":
        assert (got.unfinished > 0.0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["capped", "uncapped", "m40", "m300",
                                  "exact_cap", "finishes", "finishes_m6",
                                  "n1_t624"])
def test_fleet_objective_launches_match_plain_versions_on_card(name):
    """Each K4 launch against its own plain version at the same inputs,
    the checkpoints included."""
    dev = _card()
    obj, obj_p, U = fleet_pair(name, dev, n=5)
    args, args_p = (k4.scan_inputs(o, dev) + (o.batch_size,
                                              o.site_cap_kw is not None)
                    for o in (obj, obj_p))
    u = torch.tensor(U, device=dev)
    got = k4.fleet_scan_fwd(u, *args, keep=True)
    ref = k4.fleet_scan_fwd_plain(u, *args_p, keep=True)
    fields_close(got[:6], ref[:6], RTOL)
    close(got[6].cpu(), ref[6].cpu(), RTOL,
          scale=float(args[3][0].max()))
    close(got[7].cpu(), ref[7].cpu(), RTOL)
    rng = np.random.default_rng(6)
    grads = [torch.as_tensor(rng.normal(size=tuple(x.shape)), device=dev)
             for x in ref[:6]]
    g = k4.fleet_scan_bwd(u, *args, got[6], got[7], grads)
    g_ref = k4.fleet_scan_bwd_plain(u, *args_p, ref[6], ref[7], grads)
    grads_close(g, g_ref, RTOL)


def _launch_args(kind, name, dev):
    """(module, prefix, the forward launch's arguments) of a K3 or K4
    case on the card."""
    if kind == "k3":
        obj, U = objective_case(name, dev)
        *tables, scal = k3.scan_inputs(obj, dev)
        return k3, "trace_scan", (torch.tensor(U, device=dev), *tables, scal)
    obj, U = fleet_case(name, dev)
    return k4, "fleet_scan", (torch.tensor(U, device=dev),
                              *k4.scan_inputs(obj, dev), obj.batch_size,
                              obj.site_cap_kw is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name", [
    ("k3", "week"), ("k3", "mixed"), ("k3", "ensemble4"),
    ("k3", "n1024_t292"), ("k4", "capped"), ("k4", "uncapped"),
    ("k4", "finishes"), ("k4", "finishes_m6"), ("k4", "n1_t624")])
def test_objective_kernels_are_deterministic_on_card(kind, name):
    """Two launches of each kernel on the same inputs give the same bits:
    the forward's outputs and checkpoints, and the backward's d/du (its
    day bins summed in slot order, no atomics)."""
    dev = _card()
    mod, prefix, args = _launch_args(kind, name, dev)
    fwd = getattr(mod, f"{prefix}_fwd")
    bwd = getattr(mod, f"{prefix}_bwd")
    a, b = fwd(*args, keep=True), fwd(*args, keep=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    n_out = 6 if mod is k4 else 5
    rng = np.random.default_rng(8)
    grads = [torch.as_tensor(rng.normal(size=tuple(x.shape)), device=dev)
             for x in a[:n_out]]
    g1 = bwd(*args, *a[n_out:], grads)
    g2 = bwd(*args, *a[n_out:], grads)
    torch.cuda.synchronize()
    assert g1.abs().sum() > 0 and torch.equal(g1, g2)


@pytest.mark.cuda
def test_objective_launch_plans_match_the_kernels_on_card():
    """The Python launch plans of K3 and K4 are the rules the C launchers
    apply, and every plan launches (at least a block an SM)."""
    _card()
    for T in (1, 24, 280, 292, 624):
        want = k3.launch_plan(1, T)
        for bwd in (False, True):
            for dtype in (torch.float64, torch.float32):
                got = k3.device_plan(T, bwd, dtype)
                assert (got["threads"], got["smem"]) == (
                    want["threads"], want["smem_bwd" if bwd else "smem_fwd"])
                assert got["blocks_per_sm"] >= 1
        for M in (1, 2, 3, 40, 64, 65, 128):
            want = k4.launch_plan(1, M, T)
            for bwd in (False, True):
                got = k4.device_plan(M, T, bwd)
                assert (got["threads"], got["slots"], got["group"],
                        got["smem"]) == (
                    want["threads"], want["slots"], want["group"],
                    want["smem_bwd" if bwd else "smem_fwd"])
                assert got["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_objective_scan_gradient_at_an_exact_cap_on_card():
    """A runtime cap exactly at the campaign's runtime: the loss's hinge
    `maximum(runtime / cap - 1, 0)` ties and splits its gradient.  The
    kernels and the plain version, each on its own cap (where its own
    runtime ties the hinge), give the same gradient, between the
    one-sided ones.  On the card `runtime / cap` is a multiply by the
    reciprocal, which reaches exactly 1 only for some runtimes: the
    first seeded schedule whose runtime has such a cap, within 8 floats
    of it, in both implementations is the one tested."""
    from repro_torch.core import optimize as PO
    dev = _card()
    obj, _ = objective_case("week", dev)
    scales = dict(energy_kwh=40.0, co2_kg=20.0, runtime_h=200.0,
                  cost_usd=5.0)

    def grad(entry, p0, cap):
        p = p0.clone().requires_grad_()
        u = P.ParametricSchedule.u_from_logits(p, 0.05, 1.0, xp=torch)
        o = PO.Objective.coerce("co2", {"runtime_h": cap})
        val = PO.scalarize(entry(obj, u), o, scales, xp=torch)
        return torch.autograd.grad(val, p)[0]

    def exact_cap(entry, p0):
        """A cap at which this implementation's hinge ties, or None."""
        u0 = P.ParametricSchedule.u_from_logits(p0, 0.05, 1.0, xp=torch)
        with torch.no_grad():
            rt = entry(obj, u0).runtime_h
        up = down = float(rt)
        for _ in range(9):
            for c in (up, down):
                if float(rt / c - 1.0) == 0.0:
                    return c
            up, down = np.nextafter(up, np.inf), np.nextafter(down, 0.0)
        return None

    for seed in range(5, 45):
        p0 = torch.as_tensor(np.random.RandomState(seed).randn(24) * 0.5,
                             device=dev)
        cap_k = exact_cap(k3.trace_objective, p0)
        cap_p = exact_cap(k3.trace_objective_plain, p0)
        if cap_k is not None and cap_p is not None:
            break
    else:
        raise AssertionError("no seeded schedule ties the hinge on the card")
    g = grad(k3.trace_objective, p0, cap_k)
    grads_close(g, grad(k3.trace_objective_plain, p0, cap_p), RTOL)
    over = grad(k3.trace_objective, p0, cap_k * 0.999)
    under = grad(k3.trace_objective, p0, cap_k * 1.001)
    assert float((over - under).norm()) > 0.1 * float(g.norm())
    assert float((g - 0.5 * (over + under)).norm()) <= 2e-2 * float(
        g.norm())


@pytest.mark.cuda
def test_serving_window_under_a_binding_site_on_card():
    """One greedy serving window (core/serve.py) under a `Site` whose
    0.64 kW cap binds, on the card (K1 runs the window's coupled tier
    lanes) and on the CPU: the host-side assignment equal, the report's
    totals, each lane and the per-request attribution within 1e-9
    relative, the serving counters equal."""
    dev = _card()
    carbon = P.HourlySignal(tuple(float(v) * P.DTE_FACTOR
                                  for v in P.MIDWEST_HOURLY))
    batch = P.arrival_stream(20_000, shape="peak", seed=7,
                             slack_h=(4.0, 12.0), tier_mix=(0.8, 0.15, 0.05))
    reps, counts = {}, {}
    for where in (dev, "cpu"):
        sess = P.ServingSession(carbon=carbon, service_rate=0.6,
                                start_hour=6.0, policy="greedy",
                                site=P.Site(power_cap_kw=0.64,
                                            office_kw=0.12),
                                device=where)
        sess.submit(batch)
        P.reset_scan_stats()
        reps[where] = sess.tick()
        st = P.scan_stats()
        counts[where] = (st.requests_seen, st.requests_admitted,
                         st.requests_rejected, st.requests_degraded,
                         st.kernel_dispatches["coupled_chunk"])
    got, ref = reps[dev], reps["cpu"]
    assert counts[dev][:4] == counts["cpu"][:4]
    assert counts[dev][4] > 0 and counts["cpu"][4] == 0
    for f in ("slot", "tier", "t_finish_h", "demand"):
        assert np.array_equal(getattr(got.assignment, f),
                              getattr(ref.assignment, f)), f
    for f in ("n_admitted", "n_rejected", "n_degraded", "n_slo_miss"):
        assert getattr(got, f) == getattr(ref, f), f
    close([got.energy_kwh, got.co2_kg, got.peak_kw],
          [ref.energy_kwh, ref.co2_kg, ref.peak_kw], RTOL)
    assert [r.policy for r in got.lanes] == [r.policy for r in ref.lanes]
    close([(r.runtime_h, r.energy_kwh, r.co2_kg) for r in got.lanes],
          [(r.runtime_h, r.energy_kwh, r.co2_kg) for r in ref.lanes], RTOL)
    close(got.request_energy_kwh, ref.request_energy_kwh, RTOL)
    close(got.request_co2_kg, ref.request_co2_kg, RTOL)
    free = P.ServingSession(carbon=carbon, service_rate=0.6, start_hour=6.0,
                            site=P.Site(power_cap_kw=1e3, office_kw=0.12),
                            device=dev)
    free.submit(batch)
    # the cap binds: the window peaks at 0.6601 kW under a cap it cannot
    # reach, and at the 0.64 kW cap (met to the model's fraction of a
    # percent) under this one
    assert got.peak_kw <= 0.64 * 1.005 < free.tick().peak_kw
