"""The port's chunk kernels K1 (`coupled_chunk`) and K2 (`scan_chunk`):
their wrappers' dispatch and input checks, and — on a machine with an
NVIDIA GPU — each CUDA kernel against its plain PyTorch version.

This file imports neither `jax` nor `repro`, so the card tests run on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

Here on the CPU the card tests skip.  The input builders are shared with
tests/test_torch_engine.py and tests/test_torch_fleet.py, which hold the
plain versions against the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.carina as P  # noqa: E402
from repro_torch.core import model  # noqa: E402
from repro_torch.kernels import coupled_chunk as k1  # noqa: E402
from repro_torch.kernels import scan_chunk as k2  # noqa: E402

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
