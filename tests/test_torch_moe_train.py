"""The port's MoE training and the slice's other pieces held against the
JAX package on the CPU:

* (a) K9's backward plain versions (`grouped_gemm_dx_plain`,
  `grouped_gemm_dw_plain`, what `ops.GroupedGemm`'s backward runs on CPU
  tensors) against autograd of `grouped_gemm_plain` and an fp64 NumPy
  formula: -1 blocks, an expert that owns no block, block_m 8 and 64,
  fp32 and bf16;
* (b) `moe_block`'s gradients (x, the router, `w_gate`, `w_up`, `w_down`,
  the shared experts) against `jax.grad` of the reference's `moe_block`,
  both MoE smoke configs, at a capacity that drops copies and one that
  does not: fp32 within 1e-5 relative in norm; bf16 by the excess rule,
  each leaf's gradient no further from the fp32 truth (the reference in
  fp32 on the same bf16 values) than the reference's own bf16 gradient
  is, plus 1e-2, relative in norm (the rule chip_smoke.py holds the
  card's gradients to); a dropped copy's buffer row carries no gradient;
* (c) `Model.loss` gradients of deepseek-v2-lite-16b and
  moonshot-v1-16b-a3b at smoke size against the reference's (built with
  `use_scan=False`, the same well-conditioned fp32 weights through
  `params_from_numpy`): every leaf within 1e-4 relative in norm, the loss
  within 1e-5; three AdamW steps of `make_train_step` against the
  reference's `jax.jit(make_train_step)`: loss and gradient norm within
  1e-5; the two MoE cases of tests/test_archs_smoke.py::
  test_train_step_no_nans on the port;
* (d) the three dense configs granite-34b, qwen2.5-14b and llama3-405b:
  param counts full and smoke (tests/test_torch_moe.py::
  test_param_counts_match_reference), the smoke loss and prefill +
  teacher-forced decode logits against the reference on the same fp32
  weights (loss 1e-5, logits 1e-4 of max |logit|);
* (e) the CLIs: `python -m repro_torch.launch.serve --device cpu`
  completes its requests for every ported architecture at smoke size, and
  `python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --smoke
  --steps 2 --device cpu` runs.

The kernels themselves run on the card only: tests/test_torch_kernels.py
and chip_smoke.py hold K9's backward against these plain versions there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.optim import adamw as RADAM  # noqa: E402
from repro.serving.engine import _write_slot as ref_write_slot  # noqa: E402
from repro.training import step as RSTEP  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.kernels import moe_gemm as k9  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as ADAM  # noqa: E402
from repro_torch.serving.engine import _write_slot  # noqa: E402
from repro_torch.training import step as STEP  # noqa: E402

DEEPSEEK, MOONLIGHT = "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"
DENSE = ("granite-34b", "qwen2.5-14b", "llama3-405b")
EXCESS = 1e-2
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _paths(tree, prefix=""):
    """(path, leaf) of a port tree, the path in `jax.tree_util.keystr`'s
    spelling."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _paths(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _by_path(jtree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}


@pytest.fixture
def pallas_mode():
    """The reference's attention prefill through its flash kernel (Pallas
    interpret mode and `_fa_bwd`), which is what the port's gate runs."""
    saved = RL.kernel_mode()
    RL.set_kernel_mode("pallas")
    try:
        yield
    finally:
        RL.set_kernel_mode(saved)


# ---------------------------------------------------------------------------
# (a) K9's backward plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids,bm,e", [
    ([2, -1, 0, 2, -1, 3], 8, 5),          # expert 1 and 4 own no block
    ([0, 0, 3, -1], 64, 4),                # experts 1 and 2 own none
    ([-1, -1], 8, 2)])                     # every block empty
def test_backward_plain_versions_match_autograd_and_numpy(ids, bm, e, dtype):
    rng = np.random.default_rng(len(ids) * bm)
    d, f = 24, 40
    t = len(ids) * bm
    x64 = rng.normal(size=(t, d))
    w64 = rng.normal(0, d ** -0.5, (e, d, f))
    dy64 = rng.normal(size=(t, f))
    x, w, dy = (torch.as_tensor(a, dtype=torch.float32).to(dtype)
                for a in (x64, w64, dy64))
    bid = torch.as_tensor(np.asarray(ids, np.int32))
    dx = k9.grouped_gemm_dx_plain(dy, w, bid, bm)
    dw = k9.grouped_gemm_dw_plain(x, dy, bid, bm, e)
    assert dx.dtype == dw.dtype == dtype
    assert dx.shape == (t, d) and dw.shape == (e, d, f)
    # the fp64 formula on the same (rounded) values
    xv, wv, yv = (a.double().numpy() for a in (x, w, dy))
    want_x = np.zeros((t, d))
    want_w = np.zeros((e, d, f))
    for i, ex in enumerate(ids):
        r = slice(i * bm, (i + 1) * bm)
        if ex >= 0:
            want_x[r] = yv[r] @ wv[ex].T
            want_w[ex] += xv[r].T @ yv[r]
    bar = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    for got, want in ((dx, want_x), (dw, want_w)):
        g = got.double().numpy()
        np.testing.assert_allclose(g, want, rtol=bar,
                                   atol=bar * max(np.abs(want).max(), 1e-30))
    for i in set(range(e)) - set(ids):
        assert not dw[i].any()
    assert not dx[torch.as_tensor(np.repeat(np.asarray(ids) < 0, bm))].any()
    if max(ids) < 0:
        return                       # no product: the forward is constant
    # autograd of the plain forward, in fp32 on the same values
    xl, wl = x.float().requires_grad_(), w.float().requires_grad_()
    out = k9.grouped_gemm_plain(xl, wl, bid, bm)
    ax, aw = torch.autograd.grad(out, (xl, wl), dy.float())
    np.testing.assert_allclose(_np(dx), ax.numpy(), rtol=bar,
                               atol=bar * max(float(ax.abs().max()), 1e-30))
    np.testing.assert_allclose(_np(dw), aw.numpy(), rtol=bar,
                               atol=bar * max(float(aw.abs().max()), 1e-30))


# ---------------------------------------------------------------------------
# (b) moe_block's gradients
# ---------------------------------------------------------------------------
def _moe_weights(cfg, seed=0):
    """Random MoE weights (the router in fp32, as the spec declares)."""
    rng = np.random.default_rng(seed)
    m, d, fe = cfg.moe, cfg.d_model, cfg.moe.d_ff_expert
    fs = m.num_shared_experts * fe
    return {"router": rng.normal(0, d ** -0.5, (d, m.num_experts)),
            "w_gate": rng.normal(0, d ** -0.5, (m.num_experts, d, fe)),
            "w_up": rng.normal(0, d ** -0.5, (m.num_experts, d, fe)),
            "w_down": rng.normal(0, fe ** -0.5, (m.num_experts, fe, d)),
            "shared": {"wi_gate": rng.normal(0, d ** -0.5, (d, fs)),
                       "wi_up": rng.normal(0, d ** -0.5, (d, fs)),
                       "wo": rng.normal(0, fs ** -0.5, (fs, d))}}


def _rounded(tree, dtype):
    """The tree's values as `dtype` holds them, back in fp32 numpy (the
    router stays fp32)."""
    def leaf(key, a):
        t = torch.as_tensor(np.asarray(a, np.float32))
        return t.numpy() if key == "router" else t.to(dtype).float().numpy()
    return {k: (_rounded(v, dtype) if isinstance(v, dict) else leaf(k, v))
            for k, v in tree.items()}


def _as_jax(tree, dtype):
    return {k: (_as_jax(v, dtype) if isinstance(v, dict) else
                jnp.asarray(v, jnp.float32 if k == "router" else JNP[dtype]))
            for k, v in tree.items()}


def _as_torch(tree, dtype):
    return {k: (_as_torch(v, dtype) if isinstance(v, dict) else
                torch.as_tensor(v).to(torch.float32 if k == "router"
                                      else dtype).requires_grad_())
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


def _ref_grads(x, w, ct, cfg, capacity, dtype):
    def loss(x, p):
        y, aux = RMOE.moe_block(x, p, cfg, capacity)
        return jnp.sum(y.astype(jnp.float32) * ct) + 3.0 * aux
    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x, JNP[dtype]), _as_jax(w, dtype))
    return {"x": np.asarray(gx, np.float64),
            **{k: np.asarray(v, np.float64) for k, v in _flat(gp).items()}}


def _port_grads(x, w, ct, cfg, capacity, dtype):
    xt = torch.as_tensor(x).to(dtype).requires_grad_()
    p = _as_torch(w, dtype)
    y, aux = MOE.moe_block(xt, p, cfg, capacity)
    loss = (y.float() * torch.as_tensor(ct)).sum() + 3.0 * aux
    leaves = _flat(p)
    grads = torch.autograd.grad(loss, [xt, *leaves.values()])
    return dict(zip(["x", *leaves], (g.double().numpy() for g in grads)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,s,capacity", [(DEEPSEEK, 12, 24),
                                             (DEEPSEEK, 20, 4),
                                             (MOONLIGHT, 16, 32),
                                             (MOONLIGHT, 12, 3)])
def test_moe_block_grads_match_reference(arch, s, capacity, dtype):
    cfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    rng = np.random.default_rng(s + capacity)
    w = _rounded(_moe_weights(cfg, seed=s), dtype)
    x = torch.as_tensor(rng.normal(size=(2, s, cfg.d_model)),
                        dtype=torch.float32).to(dtype).float().numpy()
    ct = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    keep = MOE.route(torch.as_tensor(x), torch.as_tensor(w["router"]), cfg,
                     capacity).keep
    # a capacity of S * k keeps every copy; the small ones drop some
    assert bool(keep.all()) == (capacity >= s * cfg.moe.top_k)
    got = _port_grads(x, w, ct, cfg, capacity, dtype)
    ref = _ref_grads(x, w, ct, rcfg, capacity, dtype)
    assert sorted(got) == sorted(ref) == sorted(
        ["x", "router", "w_gate", "w_up", "w_down", "shared.wi_gate",
         "shared.wi_up", "shared.wo"])
    if dtype == torch.float32:
        for key in ref:
            assert _rel(got[key], ref[key]) <= 1e-5, key
        return
    truth = _ref_grads(x, w, ct, rcfg, capacity, torch.float32)
    for key in ref:
        excess = _rel(got[key], truth[key]) - _rel(ref[key], truth[key])
        assert excess <= EXCESS, (key, excess)


def test_dropped_copies_carry_no_gradient():
    """Every dropped copy points at the packed buffer's last row, in a
    block of id -1: that row's gradient is exactly zero, and a token whose
    copies are all dropped gets gradient only through the router."""
    cfg = get_config(MOONLIGHT, smoke=True)
    rng = np.random.default_rng(0)
    s, capacity = 12, 2
    w = _moe_weights(cfg, seed=1)
    p = _as_torch(w, torch.float32)
    x = torch.as_tensor(rng.normal(size=(1, s, cfg.d_model)),
                        dtype=torch.float32).requires_grad_()
    seen = {}
    grouped = MOE.ops.grouped_gemm

    def keep_buffer(xs, wt, block_ids, bm):
        if "xs" not in seen:
            xs.retain_grad()
            seen.update(xs=xs, ids=block_ids, bm=bm)
        return grouped(xs, wt, block_ids, bm)
    MOE.ops.grouped_gemm = keep_buffer
    try:
        y, aux = MOE.moe_block(x, p, cfg, capacity)
    finally:
        MOE.ops.grouped_gemm = grouped
    r = MOE.route(x.detach(), p["router"].detach(), cfg, capacity)
    assert not bool(r.keep.all())
    (y.sum() + 3.0 * aux).backward()
    xs, ids = seen["xs"], seen["ids"]
    assert int(ids[-1]) == -1
    assert not xs.grad[-1].any()                      # the dropped row
    empty = torch.repeat_interleave(ids < 0, seen["bm"])
    assert not xs.grad[empty].any()
    # the router's and the experts' weights: the reference's gradients
    # (which drop the copies into its overflow slot) within 1e-5
    ref = _ref_grads(x.detach().numpy(), w, np.ones((1, s, cfg.d_model),
                                                    np.float32),
                     ref_get_config(MOONLIGHT, smoke=True), capacity,
                     torch.float32)
    got = {"x": x.grad.double().numpy(),
           **{k: v.grad.double().numpy() for k, v in _flat(p).items()}}
    for key in ref:
        assert _rel(got[key], ref[key]) <= 1e-5, key


# ---------------------------------------------------------------------------
# (c) Model.loss gradients and train steps of both MoE smoke models
# ---------------------------------------------------------------------------
def conditioned(params, seed=2):
    """The reference's tree redrawn well-conditioned in fp32: matrices
    N(0, 1/fan-in) (a layer-stacked leaf's fan-in is its layer's: an
    expert leaf's is its d or f, "wo"'s the product of its input axes),
    norm scales N(0, 0.2), the embedding N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if "norm" in key:
            std = 0.2
        elif "embed" in key:
            std = 1.0
        else:
            shape = a.shape[1:] if "segments" in key else a.shape
            if key.endswith(("['w_gate']", "['w_up']", "['w_down']")):
                fan = shape[1]
            elif key.endswith("['wo']"):
                fan = np.prod(shape[:-1])
            else:
                fan = shape[0]
            std = float(fan) ** -0.5
        return jnp.asarray(rng.normal(0.0, std, a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def moe_models():
    """Per MoE arch: the reference's smoke model (`use_scan=False`) with
    well-conditioned fp32 weights, and the port's model."""
    out = {}
    for arch in (DEEPSEEK, MOONLIGHT):
        cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  use_scan=False)
        rmodel = ref_build_model(cfg)
        params = conditioned(jax.eval_shape(rmodel.init,
                                            jax.random.PRNGKey(0)))
        out[arch] = (rmodel, params, build_model(get_config(arch,
                                                            smoke=True)))
    return out


def _trainable(params):
    return STEP.trainable(params_from_numpy(jax.tree.map(np.asarray, params),
                                            "cpu"))


@pytest.mark.parametrize("arch", [DEEPSEEK, MOONLIGHT])
def test_model_loss_grads_match_reference(moe_models, pallas_mode, arch):
    rmodel, params, pmodel = moe_models[arch]
    batch = D.SyntheticLM(pmodel.cfg, 2, 24, seed=4).batch_at(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, jbatch), has_aux=True))(params)
    pparams = _trainable(params)
    loss, met = pmodel.loss(pparams, batch)
    paths = _paths(pparams)
    grads = torch.autograd.grad(loss, [t for _, t in paths])
    assert float(met["aux"].detach()) > 0
    for key, a, b in (("loss", loss, rloss), ("nll", met["nll"], rmet["nll"]),
                      ("aux", met["aux"], rmet["aux"])):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5,
                                   atol=0, err_msg=key)
    ref = _by_path(rgrads)
    assert sorted(ref) == sorted(p for p, _ in paths)
    for (path, _), g in zip(paths, grads):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), ref[path]) <= 1e-4, path


@pytest.mark.parametrize("arch", [DEEPSEEK, MOONLIGHT])
def test_train_steps_match_reference(moe_models, pallas_mode, arch):
    rmodel, params, pmodel = moe_models[arch]
    kw = dict(warmup_steps=2, total_steps=10)
    opt, ropt = ADAM.AdamWConfig(**kw), RADAM.AdamWConfig(**kw)
    pparams = _trainable(params)
    state = {"params": pparams, "opt": ADAM.init_opt_state(pparams, opt)}
    rstate = {"params": params, "opt": RADAM.init_opt_state(params, ropt)}
    step = STEP.make_train_step(pmodel, opt)
    rstep = jax.jit(RSTEP.make_train_step(rmodel, ropt))
    data = D.SyntheticLM(pmodel.cfg, 2, 16, seed=4)
    for s in range(3):
        batch = data.batch_at(s)
        state, met = step(state, batch)
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        for key in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(rmet[key]),
                                       rtol=1e-5, atol=0,
                                       err_msg=f"{s} {key}")
        assert int(state["opt"]["step"]) == s + 1


@pytest.mark.parametrize("arch", [DEEPSEEK, MOONLIGHT])
def test_train_step_no_nans(arch):
    """tests/test_archs_smoke.py::test_train_step_no_nans, the MoE cases,
    on the port: one bf16 step from `init_train_state`."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    opt = ADAM.AdamWConfig(total_steps=10, warmup_steps=2)
    state = STEP.init_train_state(model, torch.Generator().manual_seed(0),
                                  opt, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    state, metrics = STEP.make_train_step(model, opt)(
        state, {"tokens": tokens.astype(np.int32)})
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    for _, leaf in _paths(state["params"]):
        assert bool(torch.isfinite(leaf.float()).all())


# ---------------------------------------------------------------------------
# (d) the three dense configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_matches_reference_field_for_field(arch):
    for smoke in (False, True):
        cfg, rcfg = get_config(arch, smoke), ref_get_config(arch, smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_loss_and_logits_match_reference(arch):
    cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                              use_scan=False)
    rmodel = ref_build_model(cfg)
    params = conditioned(jax.eval_shape(rmodel.init, jax.random.PRNGKey(0)))
    if cfg.qkv_bias:                     # biases drawn, not left at zero
        rng = np.random.default_rng(5)
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(rng.normal(0, 0.2, a.shape), a.dtype)
            if jax.tree_util.keystr(p).endswith(("['bq']", "['bk']",
                                                  "['bv']")) else a, params)
    pmodel = build_model(get_config(arch, smoke=True))
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    batch = D.SyntheticLM(pmodel.cfg, 2, 24, seed=4).batch_at(0)
    rloss, _ = jax.jit(rmodel.loss)(params, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    prefill, decode = jax.jit(rmodel.prefill), jax.jit(rmodel.decode_step)
    with torch.no_grad():
        loss, _ = pmodel.loss(pparams, batch)
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (9, 14)]
        rcache = rmodel.cache_zeros(2, 24)
        pcache = pmodel.cache_zeros(2, 24, "cpu")
        tokens = np.zeros((2, 1), np.int32)
        for slot, prompt in enumerate(prompts):
            rl, rc = prefill(params, {"tokens": jnp.asarray(prompt[None])})
            pl, pc = pmodel.prefill(
                pparams, {"tokens": torch.as_tensor(prompt[None]).long()})
            assert np.abs(_np(pl) - _np(rl)).max() <= \
                1e-4 * np.abs(_np(rl)).max()
            rcache = ref_write_slot(rcache, rc, slot, cfg, len(prompt))
            pcache = _write_slot(pcache, pc, slot, pmodel.cfg, len(prompt))
            tokens[slot, 0] = int(jnp.argmax(rl[0]))
        idx = np.array([len(p) for p in prompts], np.int32)
        for _ in range(3):
            rl, rcache = decode(params, rcache, jnp.asarray(tokens),
                                jnp.asarray(idx))
            pl, pcache = pmodel.decode_step(pparams, pcache,
                                            torch.as_tensor(tokens).long(),
                                            torch.as_tensor(idx).long())
            assert np.abs(_np(pl) - _np(rl)).max() <= \
                1e-4 * np.abs(_np(rl)).max()
            tokens = np.array(jnp.argmax(rl[:, 0], axis=-1),
                              np.int32)[:, None]         # teacher forcing
            idx = idx + 1


# ---------------------------------------------------------------------------
# (e) the CLIs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_cli_completes_its_requests(arch, capsys):
    done = serve_cli.main(["--arch", arch, "--device", "cpu", "--requests",
                           "3", "--max-new", "3", "--slots", "2"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    out = capsys.readouterr().out
    assert "-smoke" in out and "completed 3 requests" in out
    assert "tokens/s" in out and "Wh" in out and "CO2e" in out


def test_serve_cli_smoke_flag_turns_off(monkeypatch):
    """`--no-smoke` asks for the full config (checked here without
    drawing its weights)."""
    asked = []

    def fake_config(name, smoke=False):
        asked.append(smoke)
        raise SystemExit(0)
    monkeypatch.setattr(serve_cli, "get_config", fake_config)
    for argv, want in ((["--no-smoke"], False), ([], True),
                       (["--smoke"], True)):
        with pytest.raises(SystemExit):
            serve_cli.main(argv + ["--device", "cpu"])
        assert asked.pop() is want


def test_train_cli_trains_moonlight_smoke(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = train_cli.main(["--arch", MOONLIGHT, "--smoke", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert res.final_step == 2 and res.restarts == 0
    out = capsys.readouterr().out
    assert f"arch={MOONLIGHT}-smoke" in out and "done at step 2" in out
