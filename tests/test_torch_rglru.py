"""The port's RG-LRU slice held against the JAX package on the CPU:
`recurrentgemma-9b` (the Griffin hybrid: RG-LRU blocks and local
attention), its smoke config (4 layers: rglru, rglru, local, rglru;
d 64, lru_width 64, window 32, 4 heads / 1 KV head of 16, vocab 256)
with the reference's weights carried across (`params_from_numpy`):

* (a) per function against `repro.models.ssm` / `repro.models.layers`,
  fp32 within 1e-6 of the reference's max |value| (a bar relative to
  the output's scale, since single values cross zero) and bf16 2e-2
  (tests/test_kernels.py): `causal_conv1d`, `conv1d_step`,
  `_rglru_gates` (`jax.nn.softplus` is `logaddexp(x, 0)`, kept past
  x = 20), `chunked_diag_scan` at S = 100 off the reference's chunk of
  64, `rglru_block` with its state and `rglru_decode`, windowed
  `attention` over query chunks (Sq 40, chunk_q 16, window 8) and the
  ring-buffer `attn_decode` over enough steps to wrap (a ring the size
  of the window, and one shorter);
* (b) the port's `rglru_block` against its own `rglru_decode` run token
  by token, as the reference's tests/test_models_units.py does;
* (c) the `lru_a` init (a = exp(-8 softplus(L)) in [0.9, 0.999]),
  `param_count` equal to the reference's (8,524,206,080 at full width,
  164,288 in smoke) and to `Model.param_count`, the full-width tree of
  shapes, and every RG-LRU leaf carried by `params_from_numpy` bit for
  bit in its own dtype;
* (d) the smoke model against the reference built with
  `use_scan=False` and jitted, as its engine runs it: `Model.loss` (fp32
  1e-5, bf16 1e-2), prefill and teacher-forced decode logits over two
  slots whose prompts (37 and 45 tokens) wrap the ring fill (fp32 1e-4,
  bf16 2e-2 of max |logit|; at this depth the jitted bf16 reference
  sits within the bar, 0.0098 at worst, and runs 8x faster than op by
  op);
* (e) `ServingEngine` tokens on 8 requests over 4 slots (prompts longer
  than the window, slots reused so `h` and `conv` are written again);
* (f) the model reaches `kernels.ssm_scan.ssm_scan` once per RG-LRU
  layer a prefill and never a decode step, and what the slice refuses:
  an `h0`, a device other than CUDA or the CPU, an input that requires
  grad, and a prompt shorter than the conv tail (where the reference's
  slot write would broadcast or fail).

Every leaf is drawn from numpy seeds, well-conditioned (each matrix with
std 1 / sqrt(its fan-in)): the reference's `rglru_spec` initialises the
gate vectors, `conv_b` and the norm scales to zeros, which would leave
the gate path unexercised.  With fp32 weights the reference's decode
returns its conv tail in fp32 and so leaves the bf16 of its own cache
spec after the first step; the tests cast its cache back to the spec's
dtypes after every step, as the port's cache keeps them.
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
from repro.models import ssm as RSSM  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro.serving.engine import _write_slot as ref_write_slot  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssm_scan as k7  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import param as PA  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.model import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine, _write_slot  # noqa: E402

ARCH = "recurrentgemma-9b"
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
    `a.shape` (or unstacked, for a block's own spec)."""
    shape, layer = a.shape, a.shape[1:]
    if key == "embed":
        x = rng.normal(0.0, 1.0, shape)
    elif key == "a_param":      # the lru_a init's range: a in [0.9, 0.999]
        u = rng.uniform(0.9, 0.999, shape)
        x = np.log(np.expm1(-np.log(u) / 8.0))
    elif key.startswith("gate_"):
        x = rng.normal(0.0, 1.0, shape)
    elif "norm" in key or key == "conv_b":
        x = rng.normal(0.0, 0.2, shape)
    else:
        fan = (layer[1] if key == "conv_w" else layer[0]
               if key in ("wq", "wk", "wv") else int(np.prod(layer[:-1])))
        x = rng.normal(0.0, fan ** -0.5, shape)
    return jnp.asarray(x, a.dtype)


def _randomise(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        return _draw_leaf(rng, str(getattr(path[-1], "key", "")), a)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _block_params(seed, dtype):
    """One RG-LRU block's parameters (unstacked), reference and port."""
    cfg = ref_get_config(ARCH, smoke=True)
    spec = RSSM.rglru_spec(cfg)
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
def test_causal_conv1d_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 11, 24), (24, 4), (24,)))
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    got = SSM.causal_conv1d(tx, tw, tb)
    assert got.dtype == dtype and got.shape == (2, 11, 24)
    _close(got, RSSM.causal_conv1d(jx, jw, jb), FN_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_step_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x, st, w, b = (rng.normal(size=s).astype(np.float32)
                   for s in ((3, 24), (3, 3, 24), (24, 4), (24,)))
    pairs = [_pair(a, dtype) for a in (x, st, w, b)]
    ry, rs = RSSM.conv1d_step(*(p[0] for p in pairs))
    gy, gs = SSM.conv1d_step(*(p[1] for p in pairs))
    assert gy.dtype == gs.dtype == dtype and gs.shape == (3, 3, 24)
    _close(gy, ry, FN_TOL[dtype])
    np.testing.assert_array_equal(_np(gs), _np(rs))      # a shift: exact


def test_rglru_gates_match_reference():
    """The gates run in fp32 whatever the weights; a_param reaches past
    20, where `F.softplus` would turn linear and `jax.nn.softplus` does
    not."""
    cfg, ref, port = _block_params(2, torch.float32)
    rng = np.random.default_rng(3)
    ap = np.asarray(ref["a_param"]).copy()
    ap[:8] = np.linspace(-30.0, 30.0, 8)
    ref["a_param"] = jnp.asarray(ap)
    port["a_param"] = torch.as_tensor(ap)
    xc = rng.normal(0.0, 2.0, (2, 7, 64)).astype(np.float32)
    ra, rb = RSSM._rglru_gates(jnp.asarray(xc), ref)
    ga, gb = SSM._rglru_gates(torch.as_tensor(xc), port)
    assert ga.dtype == gb.dtype == torch.float32
    _close(ga, ra, 1e-6)
    _close(gb, rb, 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_diag_scan_matches_reference(dtype, monkeypatch):
    """S = 100 with the reference's chunk of 64 (a short last chunk); the
    port reaches K7's wrapper once."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 1.0, (2, 100, 33)).astype(np.float32)
    b = rng.normal(0.0, 0.1, (2, 100, 33)).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    calls = []
    scan = k7.ssm_scan
    monkeypatch.setattr(k7, "ssm_scan",
                        lambda *args: calls.append(1) or scan(*args))
    hs, hf = SSM.chunked_diag_scan(ta, tb, chunk=64)
    rhs, rhf = RSSM.chunked_diag_scan(ja, jb, chunk=64)
    assert len(calls) == 1
    assert hs.dtype == hf.dtype == torch.float32 and hs.shape == a.shape
    _close(hs, rhs, 1e-6)      # both fp32 whatever the inputs' dtype
    _close(hf, rhf, 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_and_decode_match_reference(dtype):
    cfg, ref, port = _block_params(5, dtype)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    rout, (rconv, rh) = RSSM.rglru_block(jx, ref, cfg, chunk=4,
                                         return_state=True)
    gout, (gconv, gh) = SSM.rglru_block(tx, port, cfg, chunk=4,
                                        return_state=True)
    assert gout.dtype == dtype and gconv.shape == (2, 3, 64)
    assert gh.dtype == torch.float32
    _close(gout, rout, FN_TOL[dtype])
    np.testing.assert_array_equal(_np(gconv), _np(rconv))  # pre-conv tail
    _close(gh, rh, FN_TOL[dtype])
    # one decode step from that state
    xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jt, tt = _pair(xt, dtype)
    ry, rc, rhh = RSSM.rglru_decode(jt, ref, cfg, rconv, rh)
    gy, gc, ghh = SSM.rglru_decode(tt, port, cfg, gconv, gh)
    assert gy.shape == (2, 1, cfg.d_model) and ghh.dtype == torch.float32
    _close(gy, ry, FN_TOL[dtype])
    np.testing.assert_array_equal(_np(gc), _np(rc))
    _close(ghh, rhh, FN_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_offset", [0, 5])
def test_windowed_attention_over_query_chunks_matches_reference(q_offset,
                                                                dtype):
    """Sq 40 in chunks of 16 with a window of 8: each chunk masks at its
    own positions; MQA (4 query heads, 1 KV head)."""
    rng = np.random.default_rng(7 + q_offset)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40 + q_offset, 1, 16)).astype(np.float32)
            for _ in range(2))
    pairs = [_pair(a, dtype) for a in (q, k, v)]
    kw = dict(causal=True, window=8, chunk_q=16, q_offset=q_offset)
    ref = RL.attention(*(p[0] for p in pairs), **kw)
    got = L.attention(*(p[1] for p in pairs), **kw)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref, FN_TOL[dtype] if dtype == torch.bfloat16 else 1e-5)
    # the window matters: the full causal answer is another one
    full = L.attention(*(p[1] for p in pairs), causal=True, chunk_q=16,
                       q_offset=q_offset)
    assert np.abs(_np(full) - _np(got)).max() > 0.1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,size", [(6, 6), (8, 5)])
def test_ring_buffer_decode_matches_reference(window, size, dtype):
    """Two slots at positions 0 and 3 decode 12 steps into a ring of
    `size` positions: the write slot idx % size and the validity rule,
    through the wrap; the outputs and the whole caches every step."""
    cfg, rcfg = _cfg(), ref_get_config(ARCH, smoke=True)
    spec = RL.attn_spec(rcfg)
    rng = np.random.default_rng(window)
    ref = {k: jnp.asarray(rng.normal(0.0, 0.125, s.shape), JNP[dtype])
           for k, s in spec.items()}
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    rk = rv = jnp.zeros((2, size, 1, 16), jnp.bfloat16)
    pk, pv = (torch.zeros((2, size, 1, 16), dtype=torch.bfloat16)
              for _ in range(2))
    idx = np.array([0, 3], np.int32)
    for _ in range(12):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jx, tx = _pair(x, dtype)
        ro, rk, rv = RL.attn_decode(jx, ref, rcfg, rk, rv, jnp.asarray(idx),
                                    window=window)
        go, pk, pv = L.attn_decode(tx, port, cfg, pk, pv,
                                   torch.as_tensor(idx).long(),
                                   window=window)
        _close(go, ro, FN_TOL[dtype] if dtype == torch.bfloat16 else 1e-5)
        np.testing.assert_allclose(_np(pk), _np(rk), rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(_np(pv), _np(rv), rtol=1e-2, atol=1e-2)
        idx = idx + 1
    assert idx.min() > size        # wrapped


# ---------------------------------------------------------------------------
# (b) the block against its own decode
# ---------------------------------------------------------------------------
def test_rglru_block_matches_its_decode_step_by_step():
    cfg, _, port = _block_params(8, torch.float32)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(2, 10, cfg.d_model)),
                        dtype=torch.float32)
    full, (conv_f, h_f) = SSM.rglru_block(x, port, cfg, chunk=4,
                                          return_state=True)
    conv = torch.zeros((2, cfg.rglru.d_conv - 1, 64))
    h = torch.zeros((2, 64))
    outs = []
    for i in range(10):
        y, conv, h = SSM.rglru_decode(x[:, i:i + 1], port, cfg, conv, h)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full, 1e-5)
    _close(h, h_f, 1e-5)
    assert torch.equal(conv, conv_f)   # the raw inputs, exactly


# ---------------------------------------------------------------------------
# (c) init, counts, the tree
# ---------------------------------------------------------------------------
def test_lru_a_init_puts_a_in_range():
    spec = {"a": PA.ParamSpec((4096,), init="lru_a", dtype=torch.float32)}
    a_param = PA.init_params(spec, torch.Generator().manual_seed(0),
                             "cpu")["a"]
    a = torch.exp(-8.0 * SSM._softplus(a_param))
    assert a_param.dtype == torch.float32
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert float(a.max() - a.min()) > 0.09          # it spans the range


@pytest.mark.parametrize("smoke", [False, True])
def test_param_count_and_tree_match_reference(smoke):
    ref = ref_build_model(ref_get_config(ARCH, smoke=smoke))
    got = build_model(get_config(ARCH, smoke=smoke))
    want = 164_288 if smoke else 8_524_206_080
    assert got.cfg.param_count() == ref.cfg.param_count() == want
    assert got.param_count() == ref.param_count() == want
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


def test_params_from_numpy_carries_every_rglru_leaf(weights):
    params = weights[1]
    port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    mixer = params["segments"][0]["blocks"][0]["mixer"]
    pmixer = port["segments"][0]["blocks"][0]["mixer"]
    assert sorted(pmixer) == sorted(mixer) == sorted(
        ["in_x", "in_gate", "conv_w", "conv_b", "gate_i_w", "gate_i_b",
         "gate_r_w", "gate_r_b", "a_param", "out"])
    for k, a in mixer.items():
        t = pmixer[k]
        assert str(t.dtype).split(".")[1] == str(a.dtype)
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
    assert pmixer["a_param"].dtype == torch.float32
    assert pmixer["gate_i_w"].dtype == torch.float32


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


def test_prefill_and_decode_logits_match_reference(models, jitted):
    """Prompts of 37 and 45 tokens into a ring of 32 (so the fill wraps),
    then 6 teacher-forced steps over both slots."""
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
    # the caches agree: the ring (32 positions), the conv tail and h
    local, rglru = rcache[0][2], rcache[0][0]
    plocal, prglru = pcache[0][2], pcache[0][0]
    assert tuple(plocal["k"].shape) == (1, 2, 32, 1, 16)
    assert prglru["h"].dtype == torch.float32
    for key, (a, b) in {"k": (local["k"], plocal["k"]),
                        "v": (local["v"], plocal["v"]),
                        "conv": (rglru["conv"], prglru["conv"]),
                        "h": (rglru["h"], prglru["h"])}.items():
        a = _np(a)
        np.testing.assert_allclose(_np(b), a, rtol=2e-2,
                                   atol=2e-2 * np.abs(a).max(), err_msg=key)


def _gap(row, tol):
    row = _np(row)
    top = np.sort(row)[-2:]
    return top[1] - top[0], tol * np.abs(row).max()


def test_engine_tokens_match_reference(models):
    """8 requests of 37 or 45 tokens over 4 slots (s_max 64, a ring of
    32): the reference's tokens wherever its top-2 gap exceeds the logit
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
def test_prefill_reaches_the_scan_once_per_rglru_layer(weights, monkeypatch):
    _, params, pmodel, = weights
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    calls = []
    scan = k7.ssm_scan
    monkeypatch.setattr(k7, "ssm_scan",
                        lambda *a: calls.append(a[0].shape) or scan(*a))
    tokens = torch.as_tensor(np.arange(9)[None]).long()
    _, cache = pmodel.prefill(pparams, {"tokens": tokens})
    assert calls == [(1, 9, 64)] * 3                # 3 RG-LRU layers
    pmodel.decode_step(pparams, pmodel.cache_zeros(1, 16, "cpu"),
                       tokens[:, :1], 9)
    assert len(calls) == 3                          # decode: no scan


def test_scan_refusals():
    a = torch.rand(1, 8, 4)
    with pytest.raises(NotImplementedError, match="h0"):
        SSM.chunked_diag_scan(a, a, h0=torch.zeros(1, 4))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        SSM.chunked_diag_scan(a.to("meta"), a.to("meta"))
    with pytest.raises(RuntimeError, match="forward only"):
        SSM.chunked_diag_scan(a.requires_grad_(), a.detach())
    with pytest.raises(ValueError, match="chunk"):
        SSM.chunked_diag_scan(a.detach(), a.detach(), chunk=0)
    for fn in (SSM.mamba_spec, SSM.mamba_block, SSM.mamba_decode):
        with pytest.raises(NotImplementedError, match=r"item 6 \(b\)"):
            fn()


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
        (1, 1, 2, 64)
    with pytest.raises(Exception):
        ref_write_slot(rmodel.cache_zeros(2, 16), rc, 0, rmodel.cfg, 2)
    engine = ServingEngine(pmodel, pparams, slots=2, s_max=16, device="cpu")
    engine.submit(prompt[0], max_new=2)
    with pytest.raises(ValueError, match="shorter than the RG-LRU"):
        engine.tick()


def test_hybrid_training_is_refused():
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.step import make_train_step
    with pytest.raises(NotImplementedError, match=r"item 6 \(c\)"):
        make_train_step(build_model(_cfg()), AdamWConfig())
