"""The port's Mamba-1 slice held against the JAX package on the CPU:
`falcon-mamba-7b` (pure Mamba-1, attention-free), its smoke config (the
reference's `smoke_variant`: 2 layers, d 64, d_inner 128, N 8, dt_rank
4, d_conv 4, vocab 256, untied head) with the reference's weights carried
across (`params_from_numpy`):

* (a) per function against `repro.models.ssm`, fp32 within 1e-6 of the
  reference's max |value| (a bar relative to the output's scale, since
  single values cross zero) and bf16 2e-2 (tests/test_kernels.py):
  `_mamba_abc`, `_mamba_chunk_scan` (K12c's plain version on the CPU) at
  S = 100 off the reference's chunk of 64, `mamba_block` with its state
  and `mamba_decode`;
* (b) the port's `mamba_block` against its own `mamba_decode` run token
  by token, as the reference's tests/test_models_units.py does;
* (c) the inits (`a_log` the correctly rounded log(1..N) on every row,
  within one ulp of the reference's, whose XLA `log` of 7 is one ulp
  above it; softplus(`dt_bias`) in [1e-3, 1e-1]), `param_count` equal to
  the reference's (7,272,665,088 at full width, 92,096 in smoke) and to
  `Model.param_count`, the full-width tree of shapes, and every Mamba
  leaf carried by `params_from_numpy` bit for bit in its own dtype;
* (d) the smoke model against the reference built with `use_scan=False`
  and jitted, as its engine runs it: `Model.loss` (fp32 1e-5, bf16 1e-2),
  prefill and teacher-forced decode logits over two slots (fp32 1e-4,
  bf16 2e-2 of max |logit|) and the caches after them;
* (e) `ServingEngine` tokens on 8 requests over 4 slots (slots reused,
  so `conv` and `ssm` are written again);
* (f) the model reaches `kernels.selective_scan.selective_scan` (K12c)
  once per Mamba layer a prefill and never a decode step, and what the
  slice refuses: an input that requires grad, a device other than CUDA
  or the CPU, a prompt shorter than the conv tail (where the
  reference's slot write would broadcast or fail), and training the SSM
  family.

Every leaf is drawn from numpy seeds, well-conditioned (each matrix with
std 1 / sqrt(its fan-in); dt_proj a fifth of that, so dt stays near the
`dt_bias` init's range and the state keeps a long memory; A_log and D
near their inits; the norm scales and conv bias N(0, 0.2)).  With fp32
weights the reference's decode returns its conv tail in fp32 and so
leaves the bf16 of its own cache spec after the first step; the tests
cast its cache back to the spec's dtypes after every step, as the
port's cache keeps them.
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
from repro.models import ssm as RSSM  # noqa: E402
from repro.models.param import ParamSpec as RefParamSpec  # noqa: E402
from repro.models.param import init_params as ref_init_params  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro.serving.engine import _write_slot as ref_write_slot  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import selective_scan as k12c  # noqa: E402
from repro_torch.models import param as PA  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.model import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine, _write_slot  # noqa: E402
from test_torch_kernels import selective_inputs  # noqa: E402

ARCH = "falcon-mamba-7b"
FN_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LOSS_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _pair(a, dtype):
    """One numpy array as the reference's array and the port's tensor."""
    return jnp.asarray(a, JNP[dtype]), torch.as_tensor(a).to(dtype)


def _close(got, ref, tol):
    """|got - ref| within `tol` of max |ref|."""
    ref = _np(ref)
    err = np.abs(_np(got) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _cfg():
    return get_config(ARCH, smoke=True)


def _draw_leaf(rng, key, a):
    """A well-conditioned draw for leaf `key` of the layer-stacked shape
    `a.shape`."""
    shape, layer = a.shape, a.shape[1:]
    if key == "embed":
        x = rng.normal(0.0, 1.0, shape)
    elif key == "A_log":        # near the init's log(1..N)
        x = np.log(np.arange(1, shape[-1] + 1)) + rng.normal(0.0, 0.1, shape)
    elif key == "dt_bias":      # the init's softplus-inverse of U[1e-3, 0.1]
        x = np.log(np.expm1(rng.uniform(1e-3, 1e-1, shape)))
    elif key == "D":
        x = rng.normal(1.0, 0.2, shape)
    elif "norm" in key or key == "conv_b":
        x = rng.normal(0.0, 0.2, shape)
    else:
        fan = layer[1] if key == "conv_w" else int(np.prod(layer[:-1]))
        std = fan ** -0.5 * (0.2 if key == "dt_proj" else 1.0)
        x = rng.normal(0.0, std, shape)
    return jnp.asarray(x, a.dtype)


def _randomise(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        return _draw_leaf(rng, str(getattr(path[-1], "key", "")), a)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _block_params(seed, dtype):
    """One Mamba block's parameters (unstacked), reference and port."""
    cfg = ref_get_config(ARCH, smoke=True)
    spec = RSSM.mamba_spec(cfg)
    rng = np.random.default_rng(seed)
    ref = {}
    for k, s in spec.items():
        a = np.zeros((1,) + s.shape, np.float32)   # the draw's layer axis
        leaf = _draw_leaf(rng, k, a)[0]
        ref[k] = leaf.astype(s.dtype if s.dtype == jnp.float32
                             else JNP[dtype])
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    return cfg, ref, port


# ---------------------------------------------------------------------------
# (a) the functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_abc_matches_reference(dtype):
    """x_proj and dt_proj in the working dtype, dt cast to fp32 before
    `+ dt_bias`, softplus as `logaddexp(x, 0)`."""
    cfg, ref, port = _block_params(1, dtype)
    rng = np.random.default_rng(2)
    xc = rng.normal(size=(2, 9, 128)).astype(np.float32)
    jx, tx = _pair(xc, dtype)
    rdt, rbm, rcm = RSSM._mamba_abc(jx, ref, cfg)
    gdt, gbm, gcm = SSM._mamba_abc(tx, port, _cfg())
    assert gdt.dtype == torch.float32 and gbm.dtype == gcm.dtype == dtype
    assert gdt.shape == (2, 9, 128) and gbm.shape == gcm.shape == (2, 9, 8)
    _close(gdt, rdt, FN_TOL[dtype])
    _close(gbm, rbm, FN_TOL[dtype])
    _close(gcm, rcm, FN_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_chunk_scan_matches_reference(dtype, monkeypatch):
    """S = 100 with the reference's chunk of 64 (a short last chunk); the
    port reaches K12c's wrapper once; y and h_final in fp32 whatever the
    inputs' dtype."""
    dt, bm, cm, xc, A = (_np(t) for t in selective_inputs(
        2, 100, 24, 8, torch.float32, seed=3))
    jbm, tbm = _pair(bm, dtype)
    jcm, tcm = _pair(cm, dtype)
    jxc, txc = _pair(xc, dtype)
    calls = []
    scan = k12c.selective_scan
    monkeypatch.setattr(k12c, "selective_scan",
                        lambda *args: calls.append(1) or scan(*args))
    y, hf = SSM._mamba_chunk_scan(torch.as_tensor(dt), tbm, tcm, txc,
                                  torch.as_tensor(A))
    ry, rhf = RSSM._mamba_chunk_scan(jnp.asarray(dt), jbm, jcm, jxc,
                                     jnp.asarray(A), 64)
    assert len(calls) == 1
    assert y.dtype == hf.dtype == torch.float32
    assert y.shape == (2, 100, 24) and hf.shape == (2, 24, 8)
    _close(y, ry, 1e-6)      # both fp32 from the same (rounded) inputs
    _close(hf, rhf, 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_and_decode_match_reference(dtype):
    cfg, ref, port = _block_params(5, dtype)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    rout, (rconv, rh) = RSSM.mamba_block(jx, ref, cfg, chunk=4,
                                         return_state=True)
    gout, (gconv, gh) = SSM.mamba_block(tx, port, _cfg(),
                                        return_state=True)
    assert gout.dtype == dtype and gconv.shape == (2, 3, 128)
    assert gh.dtype == torch.float32 and gh.shape == (2, 128, 8)
    _close(gout, rout, FN_TOL[dtype])
    np.testing.assert_array_equal(_np(gconv), _np(rconv))  # pre-conv tail
    _close(gh, rh, FN_TOL[dtype])
    # one decode step from that state
    xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jt, tt = _pair(xt, dtype)
    ry, rc, rs = RSSM.mamba_decode(jt, ref, cfg, rconv, rh)
    gy, gc, gs = SSM.mamba_decode(tt, port, _cfg(), gconv, gh)
    assert gy.shape == (2, 1, cfg.d_model) and gs.dtype == torch.float32
    _close(gy, ry, FN_TOL[dtype])
    np.testing.assert_array_equal(_np(gc), _np(rc))
    _close(gs, rs, FN_TOL[dtype])


# ---------------------------------------------------------------------------
# (b) the block against its own decode
# ---------------------------------------------------------------------------
def test_mamba_block_matches_its_decode_step_by_step():
    _, _, port = _block_params(8, torch.float32)
    cfg = _cfg()
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(2, 10, cfg.d_model)),
                        dtype=torch.float32)
    full, (conv_f, h_f) = SSM.mamba_block(x, port, cfg, return_state=True)
    conv = torch.zeros((2, cfg.ssm.d_conv - 1, 128))
    h = torch.zeros((2, 128, cfg.ssm.d_state))
    outs = []
    for i in range(10):
        y, conv, h = SSM.mamba_decode(x[:, i:i + 1], port, cfg, conv, h)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full, 1e-5)
    _close(h, h_f, 1e-5)
    assert torch.equal(conv, conv_f)   # the raw inputs, exactly


# ---------------------------------------------------------------------------
# (c) inits, counts, the tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(128, 8), (3, 64, 16)])
def test_a_log_init_is_the_log_of_1_to_n(shape):
    """Every row log(1..N), rounded once from fp64 (the same bits on any
    device, no generator draw); the reference's (XLA's fp32 `log`) within
    one ulp: its log(7) is one ulp above the correctly rounded value."""
    spec = {"a": PA.ParamSpec(shape, init="a_log", dtype=torch.float32)}
    got = PA.init_params(spec, None, "cpu")["a"]
    want = np.log(np.arange(1, shape[-1] + 1, dtype=np.float64)).astype(
        np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np(got), np.broadcast_to(want, shape))
    ref = np.asarray(ref_init_params(
        {"a": RefParamSpec(shape, (None,) * len(shape), init="a_log",
                           dtype=jnp.float32)}, jax.random.PRNGKey(0))["a"])
    ulps = np.abs(_np(got).view(np.int32) - ref.view(np.int32))
    assert ulps.max() <= 1


def test_dt_bias_init_puts_dt_in_range():
    spec = {"b": PA.ParamSpec((8192,), init="dt_bias", dtype=torch.float32)}
    bias = PA.init_params(spec, torch.Generator().manual_seed(0), "cpu")["b"]
    dt = SSM._softplus(bias)
    assert bias.dtype == torch.float32
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert float(dt.max() - dt.min()) > 0.09          # it spans the range
    again = PA.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["b"], bias)              # from the generator


@pytest.mark.parametrize("smoke", [False, True])
def test_param_count_and_tree_match_reference(smoke):
    ref = ref_build_model(ref_get_config(ARCH, smoke=smoke))
    got = build_model(get_config(ARCH, smoke=smoke))
    want = 92_096 if smoke else 7_272_665_088
    assert got.cfg.param_count() == ref.cfg.param_count() == want
    assert got.param_count() == ref.param_count() == want
    assert got.cfg.dt_rank == ref.cfg.dt_rank == (4 if smoke else 256)
    flat = jax.tree_util.tree_flatten_with_path(ref.abstract_params())[0]
    theirs = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
              (tuple(s.shape), str(s.dtype)) for path, s in flat}
    mine = {}

    def walk(tree, path):
        if isinstance(tree, PA.ParamSpec):
            mine[path] = (tree.shape, str(tree.dtype).split(".")[1])
        else:
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            for k, v in items:
                walk(v, path + (k,))
    walk(got.spec(), ())
    assert mine == theirs


def test_params_from_numpy_carries_every_mamba_leaf(weights):
    params = weights[1]
    port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    block = params["segments"][0]["blocks"][0]
    pblock = port["segments"][0]["blocks"][0]
    assert sorted(pblock) == sorted(block) == ["mixer", "norm1"]
    mixer, pmixer = block["mixer"], pblock["mixer"]
    assert sorted(pmixer) == sorted(mixer) == sorted(
        ["in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
         "A_log", "D", "out_proj"])
    for k, a in mixer.items():
        t = pmixer[k]
        assert str(t.dtype).split(".")[1] == str(a.dtype)
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
    for k in ("A_log", "dt_bias", "D"):
        assert pmixer[k].dtype == torch.float32
    np.testing.assert_array_equal(_np(port["lm_head"]),
                                  np.asarray(params["lm_head"], np.float32))


# ---------------------------------------------------------------------------
# (d) the smoke model, (e) the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(ref_get_config(ARCH, smoke=True),
                              use_scan=False)
    rmodel = ref_build_model(cfg)
    params = _randomise(rmodel.abstract_params(), 11)
    pmodel = build_model(get_config(ARCH, smoke=True))
    return rmodel, params, pmodel


@pytest.fixture(scope="module")
def jitted(weights):
    """The reference's loss, prefill and decode step, jitted once."""
    rmodel = weights[0]
    return {name: jax.jit(getattr(rmodel, name))
            for name in ("loss", "prefill", "decode_step")}


@pytest.fixture(params=["bfloat16", "float32"])
def models(request, weights):
    rmodel, params, pmodel = weights
    if request.param == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    pmodel.bind(pparams)
    return rmodel, params, pmodel, pparams, request.param


def _to_spec(cache, zeros):
    """The reference's cache in the dtypes of its own cache spec."""
    return jax.tree.map(lambda a, z: a.astype(z.dtype), cache, zeros)


def test_smoke_loss_matches_reference(models, jitted):
    rmodel, params, pmodel, pparams, dt = models
    tokens = np.random.default_rng(12).integers(
        0, 256, (2, 40)).astype(np.int32)
    rl, rm = jitted["loss"](params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        pl, pm = pmodel.loss(pparams, {"tokens": tokens})
    assert pl.dtype == torch.float32 and bool(torch.isfinite(pl))
    assert float(pl) == pytest.approx(float(rl), rel=LOSS_TOL[dt])
    assert float(pm["acc"]) == pytest.approx(float(rm["acc"]), abs=1e-6)
    assert float(pm["aux"]) == 0.0


def test_prefill_and_decode_logits_match_reference(models, jitted):
    """Prompts of 37 and 45 tokens into two slots, then 6 teacher-forced
    steps over both; the caches (conv tail, state) agree after them."""
    rmodel, params, pmodel, pparams, dt = models
    cfg, tol = rmodel.cfg, LOGIT_TOL[dt]
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (37, 45)]
    s_max = 64
    zeros = rmodel.cache_zeros(2, s_max)
    rcache = zeros
    pcache = pmodel.cache_zeros(2, s_max, "cpu")
    tokens = np.zeros((2, 1), np.int32)
    for slot, prompt in enumerate(prompts):
        rl, rc = jitted["prefill"](params,
                                   {"tokens": jnp.asarray(prompt[None])})
        pl, pc = pmodel.prefill(
            pparams, {"tokens": torch.as_tensor(prompt[None]).long()})
        _close(pl, rl, tol)
        rcache = ref_write_slot(rcache, rc, slot, cfg, len(prompt))
        pcache = _write_slot(pcache, pc, slot, pmodel.cfg, len(prompt))
        tokens[slot, 0] = int(jnp.argmax(rl[0]))
    idx = np.array([len(p) for p in prompts], np.int32)
    for _ in range(6):
        rl, rcache = jitted["decode_step"](params, rcache,
                                           jnp.asarray(tokens),
                                           jnp.asarray(idx))
        rcache = _to_spec(rcache, zeros)
        pl, pcache = pmodel.decode_step(pparams, pcache,
                                        torch.as_tensor(tokens).long(),
                                        torch.as_tensor(idx).long())
        assert pl.shape == (2, 1, cfg.vocab_size)
        _close(pl, rl, tol)
        tokens = np.array(jnp.argmax(rl[:, 0], axis=-1), np.int32)[:, None]
        idx = idx + 1
    mamba, pmamba = rcache[0][0], pcache[0][0]
    assert tuple(pmamba["conv"].shape) == (2, 2, 3, 128)
    assert pmamba["conv"].dtype == torch.bfloat16
    assert tuple(pmamba["ssm"].shape) == (2, 2, 128, 8)
    assert pmamba["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        a = _np(mamba[key])
        np.testing.assert_allclose(_np(pmamba[key]), a, rtol=2e-2,
                                   atol=2e-2 * np.abs(a).max(), err_msg=key)


def _gap(row, tol):
    row = _np(row)
    top = np.sort(row)[-2:]
    return top[1] - top[0], tol * np.abs(row).max()


def test_engine_tokens_match_reference(models):
    """8 requests of 37 or 45 tokens over 4 slots (s_max 64): the
    reference's tokens wherever its top-2 gap exceeds the logit
    tolerance, and with fp32 weights the same logits up to there."""
    rmodel, params, pmodel, pparams, dt = models
    tol = LOGIT_TOL[dt]
    ref = RefEngine(rmodel, params, slots=4, s_max=64)
    got = ServingEngine(pmodel, pparams, slots=4, s_max=64, device="cpu")
    zeros = rmodel.cache_zeros(4, 64)
    decode = ref._decode

    def spec_decode(*args):
        logits, cache = decode(*args)
        return logits, _to_spec(cache, zeros)
    ref._decode = spec_decode
    logs = {}
    for name, engine in (("ref", ref), ("got", got)):
        log = logs[name] = {}
        prefill, step = engine._prefill, engine._decode

        def rec_prefill(p, batch, _log=log, _f=prefill, _e=engine):
            out = _f(p, batch)
            _log.setdefault(_e._next_rid_seen, []).append(_np(out[0][0]))
            _e._next_rid_seen += 1
            return out

        def rec_decode(p, c, t, i, _log=log, _f=step, _e=engine):
            out = _f(p, c, t, i)
            for s, r in enumerate(_e.active):
                if r is not None:
                    _log[r.rid].append(_np(out[0][s, 0]))
            return out
        engine._next_rid_seen = 0
        engine._prefill, engine._decode = rec_prefill, rec_decode
        rng = np.random.default_rng(14)
        for i in range(8):
            engine.submit(rng.integers(0, 256, (37, 45)[i % 2]).astype(
                np.int32), max_new=5)
    ref_done = {r.rid: r for r in ref.run_until_drained()}
    got_done = {r.rid: r for r in got.run_until_drained()}
    assert sorted(got_done) == sorted(ref_done) == list(range(8))
    compared = 0
    for rid, r in ref_done.items():
        g = got_done[rid]
        assert len(g.generated) == len(r.generated) == 5
        for i, (a, b) in enumerate(zip(r.generated, g.generated)):
            if dt == "float32":
                _close(logs["got"][rid][i], logs["ref"][rid][i], tol)
            if a != b:           # a tie within tolerance: stop comparing
                gap, bar = _gap(logs["ref"][rid][i], tol)
                assert gap <= bar, (rid, i, gap, bar)
                break
            compared += 1
    assert compared >= 30


# ---------------------------------------------------------------------------
# (f) the launches, and what the slice refuses
# ---------------------------------------------------------------------------
def test_prefill_reaches_k12c_once_per_mamba_layer(weights, monkeypatch):
    _, params, pmodel = weights
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    calls = []
    scan = k12c.selective_scan
    monkeypatch.setattr(k12c, "selective_scan",
                        lambda *a: calls.append(a[0].shape) or scan(*a))
    tokens = torch.as_tensor(np.arange(9)[None]).long()
    _, cache = pmodel.prefill(pparams, {"tokens": tokens})
    assert calls == [(1, 9, 128)] * 2               # 2 Mamba layers
    pmodel.decode_step(pparams, pmodel.cache_zeros(1, 16, "cpu"),
                       tokens[:, :1], 9)
    assert len(calls) == 2                          # decode: no scan


def test_scan_refusals():
    dt, bm, cm, xc, A = selective_inputs(1, 8, 4, 2, torch.float32, seed=15)
    with pytest.raises(RuntimeError, match="forward only"):
        SSM._mamba_chunk_scan(dt.requires_grad_(), bm, cm, xc, A)
    dt = dt.detach()
    with pytest.raises(RuntimeError, match="forward only"):
        SSM._mamba_chunk_scan(dt, bm, cm, xc, A.requires_grad_())
    meta = [t.detach().to("meta") for t in (dt, bm, cm, xc, A)]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        SSM._mamba_chunk_scan(*meta)


def test_short_prompt_is_refused_where_the_reference_breaks(weights,
                                                           jitted):
    """A 2-token prompt: the state is the 2-row tail in both packages
    (the reference's slice), which the reference's slot write cannot put
    into a 3-row cache; the port's engine refuses it."""
    rmodel, params, pmodel = weights
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    prompt = np.array([[5, 7]], np.int32)
    _, rc = jitted["prefill"](params, {"tokens": jnp.asarray(prompt)})
    _, pc = pmodel.prefill(pparams, {"tokens": torch.as_tensor(prompt).long()})
    assert rc[0][0]["conv"].shape == tuple(pc[0][0]["conv"].shape) == \
        (2, 1, 2, 128)
    with pytest.raises(Exception):
        ref_write_slot(rmodel.cache_zeros(2, 16), rc, 0, rmodel.cfg, 2)
    engine = ServingEngine(pmodel, pparams, slots=2, s_max=16, device="cpu")
    engine.submit(prompt[0], max_new=2)
    with pytest.raises(ValueError, match="shorter than the Mamba layer"):
        engine.tick()


def test_ssm_training_is_refused():
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.step import make_train_step
    with pytest.raises(NotImplementedError, match=r"item 6 \(c\)"):
        make_train_step(build_model(_cfg()), AdamWConfig())
