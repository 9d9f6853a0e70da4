"""The port's serving slice held against the JAX package on the CPU, on
`tinyllama-1.1b` smoke (2 layers, d 64, 4/2 heads, head dim 16, vocab
256) with the reference's weights carried across (`params_from_numpy`):

* (a) `attention` at the prefill shape, against the reference under
  kernel mode "pallas" (its flash kernel K5 in Pallas interpret mode) and
  "xla" (its dense path): fp32 2e-5, bf16 2e-2, as tests/test_kernels.py;
* (b) `rms_norm` (K8's plain version) against the reference's
  `layers.rms_norm` and its Pallas `rmsnorm`, at the same tolerances;
* (c) `Model.prefill` logits and every `decode_step`'s logits over two
  slots at different positions, teacher-forced with the reference's
  tokens so that one bf16 tie cannot cascade: within 2e-2 * max |logit|
  of the reference with its prefill through K5 (`pallas_mode`), and
  within 1e-4 with the weights cast to fp32;
* (d) `ServingEngine.run_until_drained` on 3 requests x 4 tokens over 2
  slots: the reference's tokens wherever the reference's top-2 gap
  exceeds that tolerance, the same logits up to the first such tie with
  fp32 weights, and the same `ServingSession` live totals to 1e-12 for
  the same tick runtimes;
* (e) the live gate with its queue-pressure override and the tick
  accounting, mirroring tests/test_serving.py;
* (f) every family, kind and knob the port does not cover raises
  `NotImplementedError` (MoE and MLA are held in tests/test_torch_moe.py),
  and a session refuses a non-positive service rate, as the reference's.

The reference's module-global kernel mode is restored after every test
(`kernel_mode`, `pallas_mode` fixtures): xdist workers run files back to
back.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as ref_pallas_rmsnorm  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro.serving.engine import _write_slot as ref_write_slot  # noqa: E402

import repro_torch.carina as P  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.serve import ServingSession  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import param as PA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model, build_model, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine, _write_slot  # noqa: E402

ARCH = "tinyllama-1.1b"
# whole-model logits, as a fraction of max |logit|: bf16 weights round at
# other places in the two frameworks; fp32 weights (the caches stay bf16
# in both packages) leave only summation order
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
MIDWEST = R.HourlySignal(tuple(float(v) * R.DTE_FACTOR
                               for v in R.MIDWEST_HOURLY))
PMIDWEST = P.HourlySignal(tuple(float(v) * P.DTE_FACTOR
                                for v in P.MIDWEST_HOURLY))


def _with_mode(mode):
    saved = RL.kernel_mode()
    RL.set_kernel_mode(mode)
    try:
        yield mode
    finally:
        RL.set_kernel_mode(saved)


@pytest.fixture(params=["pallas", "xla"])
def kernel_mode(request):
    yield from _with_mode(request.param)


@pytest.fixture
def pallas_mode():
    """The reference's prefill through its flash kernel, which is what the
    port runs.  Its "xla" mode casts the softmax weights to bf16 before
    the PV product where the kernel keeps fp32, and on this model the two
    modes of the reference differ by more than LOGIT_TOL from each other,
    so whole-model logits are held against the mode the port follows."""
    yield from _with_mode("pallas")


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke model and weights (norm scales drawn non-zero
    so that `(1 + scale)` matters), and the port's on the same weights.

    The reference runs its layers as a Python loop (`use_scan=False`), as
    the port does: XLA compiles a `lax.scan` body as one program and keeps
    bf16 intermediates of its fusions in fp32, which moves bf16 logits by
    a few percent of max |logit| against any op-by-op evaluation, its own
    included (ROADMAP.md Queue 3)."""
    cfg = dataclasses.replace(ref_get_config(ARCH, smoke=True),
                              use_scan=False)
    rmodel = ref_build_model(cfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def norms(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return jnp.asarray(rng.normal(0.0, 0.2, a.shape), a.dtype)
        return a
    params = jax.tree_util.tree_map_with_path(norms, params)
    pmodel = build_model(get_config(ARCH, smoke=True))
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    pmodel.bind(pparams)
    return rmodel, params, pmodel, pparams


@pytest.fixture(params=["bfloat16", "float32"])
def models(request, weights):
    """The carried weights in bf16 (as served) and cast to fp32 on both
    sides, with the logit tolerance of that dtype."""
    rmodel, params, pmodel, pparams = weights
    if request.param == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return rmodel, params, pmodel, pparams, LOGIT_TOL[request.param]


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _logits_close(got, ref, tol):
    ref = _np(ref)
    err = np.abs(_np(got) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _gap(row, tol):
    """top-1 minus top-2 logit, and `tol` of the row's max |logit|."""
    row = _np(row)
    top = np.sort(row)[-2:]
    return top[1] - top[0], tol * np.abs(row).max()


# ---------------------------------------------------------------------------
# (a) attention, (b) rms_norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,causal", [(2, 12, 4, 2, True),
                                              (1, 9, 4, 4, False),
                                              (1, 20, 8, 1, True)])
def test_attention_matches_reference(kernel_mode, b, s, h, hkv, causal,
                                     dtype):
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(b, s, n, 16)).astype(np.float32)
               for n in (h, hkv, hkv))
    ref = RL.attention(*(jnp.asarray(a, JNP[dtype]) for a in (q, k, v)),
                       causal=causal)
    got = L.attention(*(torch.as_tensor(a).to(dtype) for a in (q, k, v)),
                      causal=causal)
    assert got.dtype == dtype and got.shape == (b, s, h, 16)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 48)])
@pytest.mark.parametrize("which", ["layers", "pallas"])
def test_rms_norm_matches_reference(which, shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(0.0, 3.0, shape).astype(np.float32)
    s = rng.normal(0.0, 0.3, shape[-1]).astype(np.float32)
    jx, js = jnp.asarray(x, JNP[dtype]), jnp.asarray(s, JNP[dtype])
    if which == "layers":
        ref = RL.rms_norm(jx, js)
    else:
        ref = ref_pallas_rmsnorm(jx.reshape(-1, shape[-1]), js,
                                 interpret=True).reshape(shape)
    got = L.rms_norm(torch.as_tensor(x).to(dtype),
                     torch.as_tensor(s).to(dtype))
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


# ---------------------------------------------------------------------------
# (c) prefill and teacher-forced decode
# ---------------------------------------------------------------------------
def test_prefill_and_decode_logits_match_reference(models, pallas_mode):
    rmodel, params, pmodel, pparams, tol = models
    cfg = rmodel.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 14)]
    s_max = 24
    rcache = rmodel.cache_zeros(2, s_max)
    pcache = pmodel.cache_zeros(2, s_max, "cpu")
    tokens = np.zeros((2, 1), np.int32)
    for slot, prompt in enumerate(prompts):
        rl, rc = rmodel.prefill(params, {"tokens": jnp.asarray(prompt[None])})
        pl, pc = pmodel.prefill(pparams,
                                {"tokens": torch.as_tensor(prompt[None]).long()})
        _logits_close(pl, rl, tol)
        rcache = ref_write_slot(rcache, rc, slot, cfg, len(prompt))
        pcache = _write_slot(pcache, pc, slot, pmodel.cfg, len(prompt))
        tokens[slot, 0] = int(jnp.argmax(rl[0]))
    idx = np.array([len(p) for p in prompts], np.int32)
    for _ in range(4):
        rl, rcache = rmodel.decode_step(params, rcache, jnp.asarray(tokens),
                                        jnp.asarray(idx))
        pl, pcache = pmodel.decode_step(pparams, pcache,
                                        torch.as_tensor(tokens).long(),
                                        torch.as_tensor(idx).long())
        assert pl.shape == (2, 1, cfg.vocab_size)
        _logits_close(pl, rl, tol)
        tokens = np.array(jnp.argmax(rl[:, 0], axis=-1),
                          np.int32)[:, None]             # teacher forcing
        idx = idx + 1
    # the caches agree where they were written (bf16: a few ulp of k)
    for key in ("k", "v"):
        a, b = _np(rcache[0][0][key]), _np(pcache[0][0][key])
        np.testing.assert_allclose(b, a, rtol=2e-2,
                                   atol=2e-2 * np.abs(a).max())


# ---------------------------------------------------------------------------
# (d) the engine end to end
# ---------------------------------------------------------------------------
def _record(engine, store):
    """Keep every step's logits per request id (prefill, then each
    decode step of the slot the request sits in)."""
    prefill, decode = engine._prefill, engine._decode
    next_rid = [0]

    def rec_prefill(params, batch):
        logits, cache = prefill(params, batch)
        store.setdefault(next_rid[0], []).append(_np(logits[0]))
        next_rid[0] += 1
        return logits, cache

    def rec_decode(params, cache, tokens, idx):
        logits, cache = decode(params, cache, tokens, idx)
        for s, r in enumerate(engine.active):
            if r is not None:
                store[r.rid].append(_np(logits[s, 0]))
        return logits, cache

    engine._prefill, engine._decode = rec_prefill, rec_decode


def _fixed_runtime(session, runtime_s=0.25):
    record = session.record_tick
    session.record_tick = lambda _, **kw: record(runtime_s, **kw)


def test_engine_matches_reference(models, pallas_mode):
    rmodel, params, pmodel, pparams, tol = models
    cfg = rmodel.cfg
    cost = dict(flops=2.0 * pmodel.param_count(),
                hbm_bytes=2.0 * pmodel.param_count(), ici_bytes=0.0)
    rsess = R.ServingSession(tracker=R.RunTracker("ref"),
                             clock=R.SimClock(start_hour=10.0),
                             step_cost=R.StepCost(**cost))
    psess = ServingSession(tracker=P.RunTracker("port"),
                           clock=P.SimClock(start_hour=10.0),
                           step_cost=P.StepCost(**cost))
    ref = RefEngine(rmodel, params, slots=2, s_max=32, session=rsess)
    got = ServingEngine(pmodel, pparams, slots=2, s_max=32, session=psess,
                        device="cpu")
    rlog, plog = {}, {}
    for engine, sess, log in ((ref, rsess, rlog), (got, psess, plog)):
        _record(engine, log)
        _fixed_runtime(sess)
        rng = np.random.default_rng(3)
        for _ in range(3):
            engine.submit(rng.integers(0, cfg.vocab_size,
                                       rng.integers(5, 12)).astype(np.int32),
                          max_new=4)
    ref_done = {r.rid: r for r in ref.run_until_drained()}
    got_done = {r.rid: r for r in got.run_until_drained()}
    assert sorted(got_done) == sorted(ref_done) == [0, 1, 2]
    for rid, r in ref_done.items():
        g = got_done[rid]
        assert len(g.generated) == len(r.generated) == 4
        for i, (a, b) in enumerate(zip(r.generated, g.generated)):
            if tol < LOGIT_TOL["bfloat16"]:
                # the reference's engine jits its steps, so in bf16 its
                # logits carry XLA's excess precision (see `weights`):
                # there the tokens are the check
                _logits_close(plog[rid][i], rlog[rid][i], tol)
            if a != b:           # a tie within tolerance: stop comparing
                gap, bar = _gap(rlog[rid][i], tol)
                assert gap <= bar, (rid, i, gap, bar)
                break
    assert psess.live_units == rsess.live_units > 0
    for f in ("live_energy_kwh", "live_co2_kg"):
        assert getattr(psess, f) == pytest.approx(getattr(rsess, f),
                                                  rel=1e-12)
    assert len(psess.tracker.records) == len(rsess.tracker.records)


# ---------------------------------------------------------------------------
# (e) the live session
# ---------------------------------------------------------------------------
def test_live_gate_and_queue_pressure_override():
    clean, dirty = 3.5, 18.5                  # Midwest night vs evening
    sess = ServingSession(carbon=PMIDWEST, gate=0.42, max_queue=4,
                          clock=P.SimClock(start_hour=clean))
    assert float(PMIDWEST.at(clean)) < 0.42 < float(PMIDWEST.at(dirty))
    assert sess.gate_open()
    sess.clock.advance_s((dirty - clean) * 3600.0)
    assert not sess.gate_open(queue_depth=0)
    assert sess.gate_open(queue_depth=4)      # backlog forces admission
    assert ServingSession(carbon=PMIDWEST).gate_open()   # no gate -> open


def test_closed_gate_holds_the_queue(weights):
    _, _, pmodel, pparams = weights
    sess = ServingSession(carbon=PMIDWEST, gate=0.42, max_queue=4,
                          clock=P.SimClock(start_hour=18.5))
    engine = ServingEngine(pmodel, pparams, slots=2, s_max=16, session=sess,
                           device="cpu")
    for _ in range(3):
        engine.submit(np.arange(5, dtype=np.int32), max_new=2)
    assert engine.tick() == 0 and len(engine.queue) == 3   # dirty: waits
    engine.submit(np.arange(5, dtype=np.int32), max_new=2)
    # a backlog of 4 forces one admission; then the gate shuts again
    assert engine.tick() == 1 and len(engine.queue) == 3


@pytest.mark.parametrize("kw", [dict(runtime_s=1.0, active=3, steps=2),
                                dict(runtime_s=10.0)])
def test_live_record_tick_accounting(kw):
    def pair(cost):
        ref = R.ServingSession(
            carbon=MIDWEST, tracker=R.RunTracker("live"),
            clock=R.SimClock(start_hour=2.0, speedup=3600.0),
            step_cost=R.StepCost(**cost) if cost else None)
        got = ServingSession(
            carbon=PMIDWEST, tracker=P.RunTracker("live"),
            clock=P.SimClock(start_hour=2.0, speedup=3600.0),
            step_cost=P.StepCost(**cost) if cost else None)
        return ref, got

    cost = dict(flops=1e12, hbm_bytes=1e10, ici_bytes=1e8) \
        if "active" in kw else None        # roofline, or runtime mode
    ref, got = pair(cost)
    runtime = kw.pop("runtime_s")
    kwh = got.record_tick(runtime, **kw)
    assert kwh > 0 and got.live_units == 1
    assert kwh == pytest.approx(ref.record_tick(runtime, **kw), rel=1e-12)
    assert got.live_co2_kg == pytest.approx(
        kwh * float(PMIDWEST.at(got.clock.hours)), rel=1e-12)
    assert got.live_co2_kg == pytest.approx(ref.live_co2_kg, rel=1e-12)
    assert got.tracker.records[0].meta == ref.tracker.records[0].meta
    assert got.tracker.records[0].phase == ref.tracker.records[0].phase


# ---------------------------------------------------------------------------
# the model surface
# ---------------------------------------------------------------------------
def test_full_width_spec_matches_reference():
    """TinyLlama-1.1B at its published widths: the same tree of shapes
    and the same parameter count, without allocating either."""
    ref = ref_build_model(ref_get_config(ARCH))
    got = build_model(get_config(ARCH))
    flat = jax.tree_util.tree_flatten_with_path(ref.abstract_params())[0]
    theirs = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
              tuple(s.shape) for path, s in flat}
    mine = {}

    def walk(tree, path):
        if isinstance(tree, PA.ParamSpec):
            mine[path] = tree.shape
        else:
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            for k, v in items:
                walk(v, path + (k,))
    walk(got.spec(), ())
    assert mine == theirs
    assert got.param_count() == ref.param_count() == \
        ref_get_config(ARCH).param_count()


def test_init_draws_from_the_generator_and_registers_the_tree():
    model = build_model(get_config(ARCH, smoke=True))
    a = model.init(torch.Generator().manual_seed(0), "cpu")
    b = build_model(model.cfg).init(torch.Generator().manual_seed(0), "cpu")
    wq = a["segments"][0]["blocks"][0]["mixer"]["wq"]
    assert wq.shape == (2, 64, 4, 16) and wq.dtype == torch.bfloat16
    assert torch.equal(wq, b["segments"][0]["blocks"][0]["mixer"]["wq"])
    assert not wq.requires_grad
    assert torch.count_nonzero(a["final_norm"]) == 0        # zeros init
    names = dict(model.named_parameters())
    assert names["params.segments.0.blocks.0.mixer.wq"] is wq
    assert sum(p.numel() for p in names.values()) == model.param_count()
    if not torch.cuda.is_available():        # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# (f) what the slice does not cover raises
# ---------------------------------------------------------------------------
def _smoke():
    return get_config(ARCH, smoke=True)


def _deepseek():
    return get_config("deepseek-v2-lite-16b", smoke=True)


def _long_mla_prompt():
    """An MLA prefill cache longer than s_max (a ring buffer's case)."""
    cache = build_model(_deepseek()).cache_zeros(2, 16, "cpu")
    pc = [[{"c_kv": torch.zeros(1, 1, 20, 32),
            "k_rope": torch.zeros(1, 1, 20, 8)}] for _ in range(2)]
    _write_slot(cache, pc, 0, _deepseek(), 20)


def _unknown_cache():
    return [[{"conv": torch.zeros(2, 2, 3, 8), "s": torch.zeros(2, 2, 8, 4)}]]


def _long_prompt():
    cfg = _smoke()
    model = build_model(cfg)
    pc = [[{k: torch.zeros(2, 1, 20, 2, 16) for k in ("k", "v")}]]
    _write_slot(model.cache_zeros(2, 16, "cpu"), pc, 0, cfg, 20)


UNPORTED = {
    "arch": lambda: get_config("qwen2-vl-7b"),
    "family": lambda: build_model(dataclasses.replace(_smoke(), family="vlm")),
    "encdec": lambda: build_model(dataclasses.replace(_smoke(), encdec=True)),
    "mla": lambda: T.lm_spec(dataclasses.replace(   # q-LoRA MLA
        _deepseek(), mla=dataclasses.replace(_deepseek().mla,
                                             q_lora_rank=16))),
    "mla-knob": lambda: build_model(dataclasses.replace(_smoke(),
                                                        attention_kind="mla")),
    "kernels-knob": lambda: build_model(dataclasses.replace(_smoke(),
                                                            kernels="xla")),
    "pad-heads-knob": lambda: build_model(
        dataclasses.replace(_smoke(), pad_heads_to_tp=True)),
    "seq-shard-knob": lambda: build_model(
        dataclasses.replace(_smoke(), decode_cache_seq_shard=True)),
    "gelu-mlp": lambda: T.lm_spec(dataclasses.replace(_smoke(),
                                                      mlp_kind="gelu")),
    "mrope": lambda: L._rope_for(dataclasses.replace(_smoke(),
                                                     rope_kind="mrope"),
                                 None, 16, 3, "cpu"),
    "softcap": lambda: L.attention(*[torch.zeros(1, 4, 2, 16)] * 3,
                                   causal=True, softcap=30.0),
    "pad-heads": lambda: L.attention(*[torch.zeros(1, 4, 2, 16)] * 3,
                                     causal=True, pad_heads=True),
    "group-kv": lambda: L.attention(*[torch.zeros(1, 4, 2, 16)] * 3,
                                    causal=False, group_kv=True),
    "loss": lambda: Model(dataclasses.replace(_smoke(), encdec=True)).loss(
        {}, {}),                              # the encoder-decoder loss
    "mla-cache": _long_mla_prompt,
    # a cache that is none of the ported kinds' is refused, not written
    "unknown-cache": lambda: _write_slot(_unknown_cache(), _unknown_cache(),
                                         0, _smoke(), 8),
    "ring-cache": _long_prompt,
    # the windowed mode is ported; the session's constructor refuses the
    # reference's `backend=` (the NumPy/JAX engine switch)
    "session-backend": lambda: ServingSession(backend="numpy"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_raises(name):
    with pytest.raises(NotImplementedError):
        UNPORTED[name]()


@pytest.mark.parametrize("kw", [dict(service_rate=0.0),
                                dict(service_rate=-3.0)])
def test_session_refuses_a_non_positive_service_rate(kw):
    """The workload template is built and checked as the reference's
    constructor does (src/repro/core/serve.py:790-795)."""
    for cls in (R.ServingSession, ServingSession):
        with pytest.raises(ValueError, match="positive rate_at_full"):
            cls(**kw)
    sess = ServingSession(service_rate=50.0, batch_overhead_s=1.5)
    ref = R.ServingSession(service_rate=50.0, batch_overhead_s=1.5)
    assert sess.workload.rate_at_full == ref.workload.rate_at_full == 50.0
    assert sess.workload.batch_overhead_s == ref.workload.batch_overhead_s
