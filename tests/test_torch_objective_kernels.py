"""The optimizer's objective scans K3 (`kernels/objective_scan.py`) and K4
(`kernels/fleet_objective.py`) on the CPU.

On a CPU tensor each objective runs its plain version (the code the
objectives ran before the kernels, differentiated by `torch.autograd`);
on a CUDA tensor it runs a `torch.autograd.Function` whose forward and
backward are one kernel launch each.  Here the Functions run with the
plain versions of the two launches (a launch wrapper takes its plain
version for a CPU tensor), which checks their bookkeeping: the saved
checkpoints, outputs left without a gradient, leading shapes, carbon
ensembles, repeated day bins, any number of campaigns.  Each is held to
autograd of the plain objective at 1e-12 (values per field, gradients
in norm, and each component within 1e-8 of itself plus 1e-12 of the
norm; `precision="mixed"` too, since each launch's plain backward is
autograd of its plain forward).  The kernels themselves are held
to the plain versions on the card by tests/test_torch_kernels.py, and the
plain objectives to the JAX package by tests/test_torch_optimize.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import fleet_objective as k4  # noqa: E402
from repro_torch.kernels import objective_scan as k3  # noqa: E402
from test_torch_kernels import (FLEET_CASES, OBJECTIVE_CASES,  # noqa: E402
                                fields_close, fleet_case, grads_close,
                                objective_case, weighted_loss)

TIGHT = 1e-12


def _grad(fn, obj, U, keep, shape=None):
    u = torch.tensor(U, requires_grad=True)
    x = u if shape is None else u.reshape(shape)
    out = fn(obj, x)
    return out, torch.autograd.grad(weighted_loss(out, keep), u)[0]


@pytest.mark.parametrize("name", list(OBJECTIVE_CASES))
def test_trace_objective_on_the_cpu_is_the_plain_version(name):
    """`evaluate` on a CPU tensor runs the plain objective: values and
    gradients bitwise equal, and no kernel launch."""
    obj, U = objective_case(name)
    before = (k3.fwd_launches, k3.bwd_launches)
    a, ga = _grad(lambda o, u: o.evaluate(u), obj, U, (0, 1, 2, 3, 4))
    b, gb = _grad(k3.trace_objective_plain, obj, U, (0, 1, 2, 3, 4))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ga, gb)
    batch = obj.evaluate_batch(U)
    assert all(np.array_equal(x, y.detach().numpy())
               for x, y in zip(batch, b))
    assert (k3.fwd_launches, k3.bwd_launches) == before


@pytest.mark.parametrize("keep", [(0, 1, 2, 3, 4), (1, 4), (0,)])
@pytest.mark.parametrize("name", list(OBJECTIVE_CASES))
def test_trace_scan_function_matches_autograd_of_the_plain_version(name,
                                                                   keep):
    obj, U = objective_case(name)
    got, g = _grad(k3.trace_objective_scan, obj, U, keep)
    ref, g_ref = _grad(k3.trace_objective_plain, obj, U, keep)
    fields_close(got, ref, TIGHT)
    grads_close(g, g_ref, TIGHT)
    E = obj.ensemble_size
    assert got.co2_kg.shape == ((U.shape[0], E) if E else (U.shape[0],))
    if name == "sph2_price":
        assert len(obj.lens) > obj.n_slots and (got.cost_usd > 0).all()


def test_trace_scan_function_keeps_leading_shapes():
    """A (2, 3, n_slots) block and a single schedule (n_slots,): the
    outputs keep the leading shape, the gradient the input's."""
    obj, U = objective_case("ensemble4")
    for shape in ((2, 3, obj.n_slots), (obj.n_slots,)):
        V = U.reshape(-1)[:int(np.prod(shape))].reshape(shape)
        u = torch.tensor(V, requires_grad=True)
        got = k3.trace_objective_scan(obj, u)
        ref = k3.trace_objective_plain(obj, u)
        assert got.energy_kwh.shape == shape[:-1]
        assert got.co2_kg.shape == shape[:-1] + (4,)
        fields_close([x.reshape(-1) for x in got],
                     [x.reshape(-1) for x in ref], TIGHT)
        (g,) = torch.autograd.grad(got.co2_kg.sum() + got.runtime_h.sum(), u)
        (g_ref,) = torch.autograd.grad(ref.co2_kg.sum() + ref.runtime_h.sum(),
                                       u)
        assert g.shape == shape
        grads_close(g, g_ref, TIGHT)


def test_trace_scan_keeps_state_only_for_a_gradient():
    """The forward keeps each slot's starting remaining (T, N) only when
    the input needs a gradient; without one nothing is saved."""
    obj, U = objective_case("week")
    *tables, scal = k3.scan_inputs(obj, torch.device("cpu"))
    u = torch.tensor(U)
    out = k3.trace_scan_fwd(u, *tables, scal, keep=True)
    assert out[5].shape == (len(obj.lens), U.shape[0])
    assert torch.equal(out[5][0], torch.full((U.shape[0],), scal[0],
                                             dtype=torch.float64))
    assert k3.trace_scan_fwd(u, *tables, scal)[5] is None
    with torch.no_grad():
        got = k3.trace_objective_scan(obj, torch.tensor(U,
                                                        requires_grad=True))
    assert got.energy_kwh.grad_fn is None


@pytest.mark.parametrize("keep", [(0, 1, 2, 3, 4, 5), (1, 5), (2,)])
@pytest.mark.parametrize("name", list(FLEET_CASES))
def test_fleet_scan_function_matches_autograd_of_the_plain_version(name,
                                                                   keep):
    obj, U = fleet_case(name)
    got, g = _grad(k4.fleet_objective_scan, obj, U, keep)
    ref, g_ref = _grad(k4.fleet_objective_plain, obj, U, keep)
    fields_close(got, ref, TIGHT)
    grads_close(g, g_ref, TIGHT)
    assert got.site_peak_kw.shape == (U.shape[0],)
    if name == "exact_cap":
        assert float(got.site_peak_kw.max()) <= obj.site_cap_kw * (1 + 1e-12)


def test_fleet_scan_function_keeps_leading_shapes():
    obj, U = fleet_case("capped", n=6)
    shape = (2, 3, obj.M, obj.n_slots)
    got, g = _grad(k4.fleet_objective_scan, obj, U, (1, 5), shape)
    ref, g_ref = _grad(k4.fleet_objective_plain, obj, U, (1, 5), shape)
    assert got.co2_kg.shape == (2, 3, obj.M)
    assert got.site_peak_kw.shape == (2, 3)
    fields_close([x.reshape(-1) for x in got], [x.reshape(-1) for x in ref],
                 TIGHT)
    grads_close(g, g_ref, TIGHT)
    with pytest.raises(ValueError, match="expected"):
        k4.fleet_objective_scan(obj, torch.tensor(U[:, :1]))


def test_fleet_objective_on_the_cpu_is_the_plain_version():
    """`evaluate` on a CPU tensor runs the plain objective (its mask
    passes): values and gradients bitwise equal, and no kernel launch."""
    obj, U = fleet_case("capped")
    before = (k4.fwd_launches, k4.bwd_launches)
    a, ga = _grad(lambda o, u: o.evaluate(u), obj, U, (1, 5))
    b, gb = _grad(k4.fleet_objective_plain, obj, U, (1, 5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ga, gb)
    assert (k4.fwd_launches, k4.bwd_launches) == before


def test_fleet_scan_takes_any_number_of_campaigns():
    """The launch wrappers set no limit on the campaigns a member: their
    input check takes M = 300 (past the kernels' register tiles, where
    they stream the campaigns)."""
    obj, U = fleet_case("m300", n=2)
    tables = k4.scan_inputs(obj, torch.device("cpu"))
    u = torch.tensor(U)
    assert k4._check(u, *tables) == (2, 300, obj.n_slots, len(obj.lens))
    out = k4.fleet_scan_fwd(u, *tables, obj.batch_size, True)
    assert out[0].shape == (2, 300) and out[5].shape == (2,)


@pytest.mark.parametrize("name", ["finishes", "finishes_m6"])
def test_fleet_finish_cases_cover_the_tiles(name):
    """The spread cases hold the forward kernel's repair rounds to the
    edges: their campaigns turn inactive (remaining at the finish
    fraction) inside a tile, on a tile's first slot (the next tile starts
    from the new mask) and on its last (a repair of one slot), two of one
    member in one slot, all of some member's in the first tile; T is not
    a multiple of the tile, and the cap binds."""
    obj, U = fleet_case(name)
    tables = k4.scan_inputs(obj, torch.device("cpu"))
    u = torch.tensor(U)
    out = k4.fleet_scan_fwd_plain(u, *tables, obj.batch_size, True,
                                  keep=True)
    act = (out[6] > tables[3][1]).numpy()       # (T, N, M) at slot starts
    T, N, M = act.shape
    W = k4.launch_plan(N, M, T)["slots"]
    assert T % W != 0
    t, n, m = np.nonzero(act[:-1] & ~act[1:])
    off = np.full((N, M), -1)
    off[n, m] = t + 1                           # the first slot inactive
    assert (off > 0).all() and act[0].all()
    at = off % W
    assert (at == 0).any() and (at == W - 1).any()
    assert ((at != 0) & (at != W - 1)).any()
    assert any(len(set(row)) < M for row in off)
    assert (off < W).all(1).any()
    free = k4.fleet_scan_fwd_plain(u, *tables, obj.batch_size, False)
    assert not torch.equal(free[0], out[0])


@pytest.mark.parametrize("T", [1, 24, 280, 292, 624])
@pytest.mark.parametrize("N", [1, 192, 256, 1024])
def test_objective_scan_launch_plan_covers_the_slots(N, T):
    """K3's plan: a block a member, a thread a slot of each tile (whole
    warps, at most 256), every slot once, tiles as even as the warps
    leave them, shared memory within a block's 232,448 bytes."""
    p = k3.launch_plan(N, T)
    W = p["slots"]
    assert p["blocks"] == N and p["threads"] == W
    assert W % 32 == 0 and W <= 256
    seen = [t0 + i for t0 in range(0, p["tiles"] * W, W)
            for i in range(p["threads"]) if t0 + i < T]
    assert sorted(seen) == list(range(T))
    assert p["tiles"] * W - T < 32 * p["tiles"]
    assert max(p["smem_fwd"], p["smem_bwd"]) <= 232_448
    if T == 280:
        assert (W, p["tiles"]) == (160, 2)


@pytest.mark.parametrize("T", [1, 24, 280, 292, 624])
@pytest.mark.parametrize("M", [1, 2, 40, 128])
@pytest.mark.parametrize("N", [1, 192, 256, 1024])
def test_fleet_objective_launch_plan_covers_the_slots(N, M, T):
    """K4's plan: a block a member, a slot to a thread (M <= 2) or to a
    warp of 8, group g of a tile taking slots g, g + groups, ...: every
    slot once, whole warps, shared memory within a block's 232,448 bytes;
    the README fleet (M = 2, T = 624) in three tiles of 224."""
    p = k4.launch_plan(N, M, T)
    G, W, threads = p["group"], p["slots"], p["threads"]
    assert p["blocks"] == N and G == (1 if M <= 2 else 32)
    assert threads % 32 == 0 and threads <= 256
    assert threads == (W if G == 1 else 256)
    groups = threads // G
    seen = [t0 + s for t0 in range(0, p["tiles"] * W, W)
            for g in range(groups) for s in range(g, W, groups) if t0 + s < T]
    assert sorted(seen) == list(range(T))
    assert max(p["smem_fwd"], p["smem_bwd"]) <= 232_448
    if (M, T) == (2, 624):
        assert (W, p["tiles"]) == (224, 3)


def test_fleet_objective_launch_plan_takes_the_tile_kernels_campaigns():
    """Past 128 campaigns the streaming kernels run: no tile plan."""
    for M in (0, 129):
        with pytest.raises(ValueError, match="campaigns"):
            k4.launch_plan(1, M, 24)


@pytest.mark.parametrize("which", ["trace", "fleet"])
def test_objectives_refuse_other_devices(which):
    """Neither the objectives nor the launch wrappers take a device that
    is neither CPU nor CUDA."""
    if which == "trace":
        obj, U = objective_case("week")
        entry, launch = k3.trace_objective, k3.trace_scan_fwd
        *tables, scal = k3.scan_inputs(obj, torch.device("cpu"))
        extra = (scal,)
    else:
        obj, U = fleet_case("capped")
        entry, launch = k4.fleet_objective, k4.fleet_scan_fwd
        tables = k4.scan_inputs(obj, torch.device("cpu"))
        extra = (obj.batch_size, True)
    u = torch.tensor(U).to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        entry(obj, u)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        launch(u, *(t.to("meta") for t in tables), *extra)
