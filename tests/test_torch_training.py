"""The port's training step held against the JAX package on the CPU:

* (a) K11's plain version (`kernels/flash_attention.py::
  flash_attention_bwd_plain`, what the backward of `ops.flash_attention`
  runs on CPU tensors) against `jax.grad` of the reference's
  `kernels.ops.flash_attention` (the Pallas forward in interpret mode and
  its `_fa_bwd`), at tests/test_kernels.py::test_flash_attention_vjp's
  shape, MQA, non-causal, Sq != Sk and Sq = 1,100 (past one 1,024-query
  chunk): fp32 within 1e-5 of max |grad|; bf16 within one rounding step,
  2^-7 |g| + 1e-3 max |g| (both compute in fp32 and round once);
* (b) K8's plain backward (`kernels/rmsnorm.py::rmsnorm_bwd_plain`, run
  by the backward of `models.layers.rms_norm`) against `jax.grad` of the
  reference's `models.layers.rms_norm`: dx and d scale, fp32 within 1e-5
  of max |grad|, bf16 one rounding step as in (a);
* (c) the TinyLlama smoke model's `Model.loss` and its gradients against
  `jax.grad` of the reference's loss (built with `use_scan=False`, the
  attention through its flash kernel as the port's gate sends it, fp32,
  the weights carried across by `params_from_numpy`): every leaf within
  1e-4 relative in norm, the loss within 1e-5.  The weights are drawn
  well-conditioned (matrices with std 1/sqrt(fan-in), norm scales
  N(0, 0.2)): at `Model.init`'s weights the reference's own fp32
  gradients sit up to 5e-5 from its fp64 ones (its fan-in of a stacked
  matrix is the layer count, ROADMAP.md Queue 3), which would leave the
  bar no room;
* (d) `adamw_update` and `schedule` against the reference's on a random
  tree, clipped and not, fp32 and bf16 parameters, fp32 and bf16
  moments, three updates: fp32 within 1e-6 relative (+1e-9 absolute),
  bf16 one rounding step (2^-8 |x| + 1e-9) on parameters and moments;
* (e) three `make_train_step` steps, `grad_accum` 1 and 2, against the
  reference's `jax.jit(make_train_step)` on (c)'s weights: loss,
  `grad_norm` and `lr` within 1e-5 relative, every parameter leaf after
  each step within 1e-5 relative in norm;
* (f) the TinyLlama case of tests/test_archs_smoke.py::
  test_train_step_no_nans on the port: one bf16 step from
  `init_train_state`, loss, gradient norm and every leaf finite;
* (g) what the step does not take yet raises: an architecture of a
  family the port does not serve (`remat` and `blocked_xent` train:
  tests/test_torch_train_loop.py; the MoE family trains:
  tests/test_torch_moe_train.py).

The kernels themselves run on the card only: tests/test_torch_kernels.py
and chip_smoke.py hold K11 and K8's backward against these plain versions
there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.optim import adamw as RADAM  # noqa: E402
from repro.training import step as RSTEP  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.kernels import flash_attention as k5  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as k8  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.models.param import tree_map  # noqa: E402
from repro_torch.optim import adamw as ADAM  # noqa: E402
from repro_torch.training import step as STEP  # noqa: E402

TINY = "tinyllama-1.1b"


def _bf16(a):
    """A float32 array rounded to bf16 (both sides get the same values)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype):
    """A copy of `a` as a torch tensor (AdamW updates in place, and the
    reference's arrays may share the numpy buffer)."""
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def assert_grad_close(got, ref, dtype, what=""):
    """fp32: within 1e-5 of max |ref|; bf16: one rounding step,
    2^-7 |ref| + 1e-3 max |ref|."""
    got, ref = _np(got), _np(ref)
    scale = np.abs(ref).max()
    if dtype == "bfloat16":
        bar = 2.0 ** -7 * np.abs(ref) + 1e-3 * scale
    else:
        bar = 1e-5 * scale
    err = np.abs(got - ref)
    assert (err <= bar).all(), (what, float(err.max()), float(scale))


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.fixture
def pallas_mode():
    """The reference's attention through its flash kernel (Pallas interpret
    mode and `_fa_bwd`), which is what the port's gate runs."""
    saved = RL.kernel_mode()
    RL.set_kernel_mode("pallas")
    try:
        yield
    finally:
        RL.set_kernel_mode(saved)


# ---------------------------------------------------------------------------
# (a) K11's plain version through ops.flash_attention's autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal", [
    (2, 256, 256, 4, 2, 64, True),        # tests/test_kernels.py's vjp shape
    (1, 200, 200, 8, 1, 32, True),        # MQA
    (2, 128, 128, 4, 2, 64, False),       # non-causal
    (1, 96, 160, 4, 2, 16, True),         # Sq < Sk
    (1, 160, 96, 4, 2, 16, False),        # Sq > Sk
    (1, 1100, 1100, 2, 1, 16, True)],     # past one 1,024-query chunk
    ids=["vjp-shape", "mqa", "noncausal", "sq<sk", "sq>sk", "sq1100"])
def test_flash_attention_grad_matches_reference(b, sq, sk, h, hkv, d, causal,
                                                dtype):
    rng = np.random.default_rng(sq + sk + h)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)))
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(q_, k_, v_):
        o = ROPS.flash_attention(q_, k_, v_, causal, None, True)
        return jnp.sum(o.astype(jnp.float32) * do)
    ref = jax.grad(f, (0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))

    tdt = getattr(torch, dtype)
    tq, tk, tv = (_t(a, tdt).requires_grad_() for a in (q, k, v))
    before = (k5.launches, k5.bwd_launches)
    o = ops.flash_attention(tq, tk, tv, causal)
    got = torch.autograd.grad((o.float() * torch.as_tensor(do)).sum(),
                              (tq, tk, tv))
    assert (k5.launches, k5.bwd_launches) == before      # CPU: no launch
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == tdt and g.shape == tuple(r.shape)
        assert_grad_close(g, r, dtype, f"d{name}")


# ---------------------------------------------------------------------------
# (b) K8's plain backward through layers.rms_norm's autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 9, 64), (37, 100), (3, 512)])
def test_rms_norm_grad_matches_reference(shape, dtype):
    rng = np.random.default_rng(shape[-1])
    x = rng.normal(0, 2.0, shape).astype(np.float32)
    s = rng.normal(0, 0.3, shape[-1]).astype(np.float32)
    gy = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x, s = _bf16(x), _bf16(s)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(x_, s_):
        return jnp.sum(RL.rms_norm(x_, s_, 1e-6).astype(jnp.float32) * gy)
    rdx, rds = jax.grad(f, (0, 1))(jnp.asarray(x, jdt), jnp.asarray(s, jdt))

    tdt = getattr(torch, dtype)
    tx, ts = _t(x, tdt).requires_grad_(), _t(s, tdt).requires_grad_()
    before = k8.bwd_launches
    y = L.rms_norm(tx, ts, 1e-6)
    dx, ds = torch.autograd.grad((y.float() * torch.as_tensor(gy)).sum(),
                                 (tx, ts))
    assert k8.bwd_launches == before                     # CPU: no launch
    assert dx.dtype == ds.dtype == tdt
    assert_grad_close(dx, rdx, dtype, "dx")
    assert_grad_close(ds, rds, dtype, "dscale")


# ---------------------------------------------------------------------------
# (c) Model.loss gradients on the TinyLlama smoke model
# ---------------------------------------------------------------------------
def conditioned(params, seed=2):
    """The reference's tree redrawn well-conditioned in fp32: matrices
    N(0, 1/fan-in) (a stacked leaf's fan-in is its layer's, "wo"'s the
    product of its input axes), norm scales N(0, 0.2), the embedding
    N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if "norm" in key:
            std = 0.2
        elif "embed" in key:
            std = 1.0
        else:
            shape = a.shape[1:] if "segments" in key else a.shape
            fan = np.prod(shape[:-1]) if key.endswith("['wo']") else shape[0]
            std = float(fan) ** -0.5
        return jnp.asarray(rng.normal(0.0, std, a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def tiny():
    """The reference's TinyLlama smoke model (`use_scan=False`) with its
    weights drawn well-conditioned, and the port's model."""
    cfg = dataclasses.replace(ref_get_config(TINY, smoke=True), use_scan=False)
    rmodel = ref_build_model(cfg)
    params = conditioned(rmodel.init(jax.random.PRNGKey(0)))
    return rmodel, params, build_model(get_config(TINY, smoke=True))


def _port_state(params, opt):
    pparams = STEP.trainable(params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    return {"params": pparams, "opt": ADAM.init_opt_state(pparams, opt)}


def test_model_loss_grads_match_reference(tiny, pallas_mode):
    rmodel, params, pmodel = tiny
    batch = D.SyntheticLM(pmodel.cfg, 2, 24, seed=4).batch_at(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss(p, jbatch), has_aux=True)(params)
    pparams = STEP.trainable(params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    loss, met = pmodel.loss(pparams, batch)
    paths = _paths(pparams)
    grads = torch.autograd.grad(loss, [t for _, t in paths])
    loss, met = loss.detach(), {k: v.detach() for k, v in met.items()}
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(met["nll"]), float(rmet["nll"]),
                               rtol=1e-5, atol=0)
    ref = _by_path(rgrads)
    assert sorted(ref) == sorted(p for p, _ in paths)
    for (path, _), g in zip(paths, grads):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), ref[path]) <= 1e-4, path


# ---------------------------------------------------------------------------
# (d) AdamW
# ---------------------------------------------------------------------------
def test_schedule_matches_reference():
    for cfg in (dict(warmup_steps=3, total_steps=10),
                dict(warmup_steps=0, total_steps=5, min_lr_ratio=0.0),
                dict(warmup_steps=100, total_steps=1000)):
        steps = np.arange(0, 1200, 7 if cfg["total_steps"] > 100 else 1)
        got = ADAM.schedule(ADAM.AdamWConfig(**cfg),
                            torch.as_tensor(steps, dtype=torch.int32))
        ref = RADAM.schedule(RADAM.AdamWConfig(**cfg),
                             jnp.asarray(steps, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-12)


def _random_tree(rng, dtype):
    shapes = {"a": (7, 5), "blocks": [{"w": (3, 4, 6), "n": (6,)},
                                      {"w": (2, 9)}], "b": (11,)}

    def draw(s):
        a = rng.normal(0, 0.5, s).astype(np.float32)
        return _bf16(a) if dtype == "bfloat16" else a

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return draw(t)
    return walk(shapes)


def _tree_to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to_torch(v, dtype) for v in tree]
    return _t(tree, dtype)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,clip", [(1.0, 1.0), (0.01, 1.0),
                                             (1.0, 0.0)],
                         ids=["clipped", "unclipped", "no-clip"])
def test_adamw_update_matches_reference(grad_scale, clip, dtype,
                                        state_dtype):
    rng = np.random.default_rng(5)
    kw = dict(warmup_steps=2, total_steps=10, clip_norm=clip,
              state_dtype=state_dtype)
    cfg, rcfg = ADAM.AdamWConfig(**kw), RADAM.AdamWConfig(**kw)
    params = _random_tree(rng, dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    p = _tree_to_torch(params, tdt)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    st, rst = ADAM.init_opt_state(p, cfg), RADAM.init_opt_state(rp, rcfg)
    for step in range(3):
        grads = tree_map(                 # the port's key order
            lambda a: (rng.normal(0, 1, a.shape) * grad_scale).astype(
                np.float32), params)
        if dtype == "bfloat16":
            grads = tree_map(_bf16, grads)
        p, st, met = ADAM.adamw_update(p, _tree_to_torch(grads, tdt), st, cfg)
        rp, rst, rmet = RADAM.adamw_update(
            rp, jax.tree.map(lambda a: jnp.asarray(a, jdt), grads), rst, rcfg)
        assert int(st["step"]) == int(rst["step"]) == step + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(rmet[key]),
                                       rtol=1e-6, atol=0)
        if clip and grad_scale == 1.0:
            assert float(met["grad_norm"]) > clip          # clipping active
        for tree, rtree, tdtype in ((p, rp, dtype), (st["m"], rst["m"],
                                                     state_dtype),
                                    (st["v"], rst["v"], state_dtype)):
            ref = _by_path(rtree)
            for path, t in _paths(tree):
                assert t.dtype == getattr(torch, tdtype), path
                got, want = _np(t), ref[path]
                rtol = 2.0 ** -8 if tdtype == "bfloat16" else 1e-6
                np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9,
                                           err_msg=f"{step} {path}")


# ---------------------------------------------------------------------------
# (e) make_train_step against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_reference(tiny, pallas_mode, grad_accum):
    rmodel, params, pmodel = tiny
    kw = dict(warmup_steps=2, total_steps=10)
    opt, ropt = ADAM.AdamWConfig(**kw), RADAM.AdamWConfig(**kw)
    state = _port_state(params, opt)
    rstate = {"params": params, "opt": RADAM.init_opt_state(params, ropt)}
    step = STEP.make_train_step(pmodel, opt, grad_accum=grad_accum)
    rstep = jax.jit(RSTEP.make_train_step(rmodel, ropt,
                                          grad_accum=grad_accum))
    data = D.SyntheticLM(pmodel.cfg, 4, 16, seed=4)
    for s in range(3):
        batch = data.batch_at(s)
        state, met = step(state, batch)
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        assert sorted(met) == sorted(rmet) == ["acc", "aux", "grad_norm",
                                               "loss", "lr", "nll"]
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(rmet[key]),
                                       rtol=1e-5, atol=0, err_msg=key)
        ref = _by_path(rstate["params"])
        for path, t in _paths(state["params"]):
            assert t.requires_grad and t.dtype == torch.float32
            assert _rel(_np(t), ref[path]) <= 1e-5, (s, path)
        assert int(state["opt"]["step"]) == s + 1


# ---------------------------------------------------------------------------
# (f) tests/test_archs_smoke.py::test_train_step_no_nans, TinyLlama, bf16
# ---------------------------------------------------------------------------
def test_train_step_no_nans_tinyllama():
    cfg = get_config(TINY, smoke=True)
    model = build_model(cfg)
    opt = ADAM.AdamWConfig(total_steps=10, warmup_steps=2)
    state = STEP.init_train_state(model, torch.Generator().manual_seed(0),
                                  opt, "cpu")
    assert all(t.requires_grad and t.dtype == torch.bfloat16
               for _, t in _paths(state["params"]))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    step = STEP.make_train_step(model, opt)
    state, metrics = step(state, {"tokens": tokens.astype(np.int32)})
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    for _, leaf in _paths(state["params"]):
        assert bool(torch.isfinite(leaf.float()).all())


def test_prefill_and_decode_steps_are_the_models():
    model = build_model(get_config(TINY, smoke=True))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(np.arange(12).reshape(2, 6))
    logits, cache = STEP.make_prefill_step(model)(params, {"tokens": tokens})
    want, _ = model.prefill(params, {"tokens": tokens})
    assert torch.equal(logits, want)
    copy = tree_map(torch.clone, cache)
    out, _ = STEP.make_decode_step(model)(params, cache, tokens[:, :1], 5)
    want, _ = model.decode_step(params, copy, tokens[:, :1], 5)
    assert out.shape == (2, 1, model.cfg.vocab_size)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# (g) what the step does not take yet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,knobs", [("falcon-mamba-7b", {})])
def test_unported_training_raises(arch, knobs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
        STEP.make_train_step(build_model(cfg), ADAM.AdamWConfig())


def test_frozen_parameters_are_refused():
    model = build_model(get_config(TINY, smoke=True))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = ADAM.AdamWConfig()
    step = STEP.make_train_step(model, opt)
    with pytest.raises(ValueError, match="require grad"):
        step({"params": params, "opt": ADAM.init_opt_state(params, opt)},
             {"tokens": np.zeros((2, 8), np.int32)})
