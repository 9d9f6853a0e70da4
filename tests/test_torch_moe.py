"""The port's MoE slice held against the JAX package on the CPU: K9's
plain version, `moe_block`, MLA, and the two MoE smoke models
(`deepseek-v2-lite-16b`, MLA + MoE; `moonshot-v1-16b-a3b`, attention +
MoE) with the reference's weights carried across (`params_from_numpy`):

* (a) `grouped_gemm_plain` against the reference's Pallas kernel in
  interpret mode and its oracle `grouped_gemm_ref`, on the cases of
  tests/test_kernels.py (fp32 2e-5, bf16 2e-2), and the -1 block rule
  against a naive loop;
* (b) `moe_block` in fp32 and bf16 over two batch rows, at the default
  capacity and at one small enough that copies drop: the routing
  (`expert_idx`, `keep`) equal to the reference's first, then the output
  and the aux loss;
* (c) `mla_block` and `mla_decode` with per-slot positions, and
  `attention` over query chunks (Sq 2,500 > chunk_q 1,024) on the dense
  path: MLA's d != dv, causal and bidirectional, a query offset and a
  validity mask;
* (d) prefill + teacher-forced decode logits of both smoke models against
  the reference built with `use_scan=False`: fp32 1e-4 and bf16 2e-2 of
  max |logit|; DeepSeek smoke's `Model.loss` on 1 x 1,100 tokens (its
  MLA attention over two query chunks): fp32 1e-5, bf16 1e-2;
* (e) `ServingEngine` tokens and session totals against the reference's
  engine on the DeepSeek smoke model (the MLA `_write_slot`);
* (f) `param_count` and `active_param_count` equal to the reference's for
  every ported config (the three dense configs granite-34b, qwen2.5-14b
  and llama3-405b too), and the full DeepSeek-V2-Lite tree of shapes.
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
from repro.kernels import ref as KREF  # noqa: E402
from repro.kernels.moe_gemm import grouped_gemm as ref_grouped_gemm  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro.serving.engine import _write_slot as ref_write_slot  # noqa: E402

import repro_torch.carina as P  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.serve import ServingSession  # noqa: E402
from repro_torch.data import pipeline as PD  # noqa: E402
from repro_torch.kernels import moe_gemm as k9  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import param as PA  # noqa: E402
from repro_torch.models.model import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine, _write_slot  # noqa: E402

DEEPSEEK, MOONLIGHT = "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _pair(a, dtype):
    """One numpy array as the reference's array and the port's tensor."""
    return jnp.asarray(a, JNP[dtype]), torch.as_tensor(a).to(dtype)


def _scaled_max(got, ref):
    ref = _np(ref)
    return np.abs(_np(got) - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# (a) K9's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,bpe,d,f", [(4, 2, 256, 512), (8, 1, 512, 384),
                                       (2, 3, 128, 100)])
def test_grouped_gemm_plain_matches_reference(e, bpe, d, f, dtype):
    bm = 128
    t = e * bpe * bm
    rng = np.random.default_rng(e * d)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(e, d, f)) * 0.05).astype(np.float32)
    ids = np.repeat(np.arange(e, dtype=np.int32), bpe)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    got = k9.grouped_gemm(tx, tw, torch.as_tensor(ids), bm)
    assert got.dtype == dtype and got.shape == (t, f)
    pallas = ref_grouped_gemm(jx, jw, jnp.asarray(ids), block_m=bm,
                              interpret=True)
    oracle = KREF.grouped_gemm_ref(jx, jw, jnp.full((e,), bpe * bm,
                                                    jnp.int32))
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("bm", [8, 64])
def test_grouped_gemm_empty_blocks_are_zero(bm):
    """Blocks of id -1 come out as zeros, every other row as x @ w[id];
    the ids in any order, an expert in several blocks or in none."""
    rng = np.random.default_rng(bm)
    ids = np.array([2, -1, 0, 2, -1, 3], np.int32)
    x = torch.as_tensor(rng.normal(size=(len(ids) * bm, 40)),
                        dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(5, 40, 24)), dtype=torch.float32)
    got = k9.grouped_gemm(x, w, torch.as_tensor(ids), bm)
    want = torch.zeros((len(ids) * bm, 24), dtype=torch.float64)
    for i, e in enumerate(ids):
        for r in range(i * bm, (i + 1) * bm):
            if e >= 0:
                want[r] = x[r].double() @ w[e].double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not got[bm:2 * bm].any() and not got[4 * bm:5 * bm].any()


# ---------------------------------------------------------------------------
# (b) moe_block
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


def _as(tree, dtype, jax_side):
    def leaf(path, a):
        dt = torch.float32 if path == "router" else dtype
        a = np.asarray(a, np.float32)
        return jnp.asarray(a, JNP[dt]) if jax_side else \
            torch.as_tensor(a).to(dt)
    return {k: (_as(v, dtype, jax_side) if isinstance(v, dict) else leaf(k, v))
            for k, v in tree.items()}


def _ref_routing(x, p, cfg, c):
    """The reference's routing decisions, in its own lines
    (src/repro/models/moe.py:79-96), which `moe_block` keeps inside."""
    m = cfg.moe
    b, s, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, m.top_k)
    flat_e = expert_idx.reshape(b, s * m.top_k)
    eo = jax.nn.one_hot(flat_e, m.num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(eo, axis=1) - 1
    pos_in_e = jnp.take_along_axis(pos, flat_e[..., None], axis=2)[..., 0]
    return np.asarray(expert_idx), np.asarray(pos_in_e < c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,s,capacity", [(DEEPSEEK, 12, 0),
                                             (DEEPSEEK, 40, 0),
                                             (MOONLIGHT, 12, 3)])
def test_moe_block_matches_reference(arch, s, capacity, dtype):
    cfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    w = _moe_weights(cfg, seed=s)
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model))
    jx, tx = _pair(x.astype(np.float32), dtype)
    jp, tp = _as(w, dtype, True), _as(w, dtype, False)
    c = capacity or MOE.moe_capacity(cfg, s)
    assert c == (capacity or RMOE.moe_capacity(rcfg, s))
    r = MOE.route(tx, tp["router"], cfg, c)
    ridx, rkeep = _ref_routing(jx, jp, rcfg, c)
    np.testing.assert_array_equal(r.expert_idx.numpy(), ridx)
    np.testing.assert_array_equal(r.keep.numpy(), rkeep)
    if capacity:
        assert not rkeep.all()                   # copies were dropped
    y, aux = MOE.moe_block(tx, tp, cfg, capacity)
    ry, raux = RMOE.moe_block(jx, jp, rcfg, capacity)
    assert y.dtype == dtype and y.shape == (2, s, cfg.d_model)
    np.testing.assert_allclose(_np(y), _np(ry), **TOL[dtype])
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)


@pytest.mark.parametrize("copies,e,bm", [(24, 64, 8), (5496, 64, 64),
                                         (7, 4, 8), (200, 4, 64)])
def test_pack_layout(copies, e, bm):
    """`pack` gives each kept copy its own row inside a block of its
    expert, leaves dropped copies on the unused last block, and picks the
    row block by the copies per expert."""
    assert MOE.block_m_for(copies, e) == bm
    rng = np.random.default_rng(copies)
    eidx = torch.as_tensor(rng.integers(0, e, copies))
    keep = torch.as_tensor(rng.random(copies) < 0.8)
    dest, ids = MOE.pack(eidx, keep, e, bm)
    assert ids.dtype == torch.int32
    assert ids.shape == (-(-copies // bm) + e,) and int(ids[-1]) == -1
    kept = dest[keep]
    assert len(set(kept.tolist())) == int(keep.sum())      # one row each
    assert torch.equal(ids[kept // bm].long(), eidx[keep])
    assert bool((dest[~keep] == ids.shape[0] * bm - 1).all())


# ---------------------------------------------------------------------------
# (c) MLA
# ---------------------------------------------------------------------------
def _mla_weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    r = m.kv_lora_rank
    return {"wq": rng.normal(0, d ** -0.5,
                             (d, h, m.qk_nope_head_dim + m.qk_rope_head_dim)),
            "w_dkv": rng.normal(0, d ** -0.5, (d, r + m.qk_rope_head_dim)),
            "kv_norm": rng.normal(0, 0.2, (r,)),
            "w_uk": rng.normal(0, r ** -0.5, (r, h, m.qk_nope_head_dim)),
            "w_uv": rng.normal(0, r ** -0.5, (r, h, m.v_head_dim)),
            "wo": rng.normal(0, (h * m.v_head_dim) ** -0.5,
                             (h, m.v_head_dim, d))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_block_and_decode_match_reference(dtype):
    cfg = get_config(DEEPSEEK, smoke=True)
    rcfg = ref_get_config(DEEPSEEK, smoke=True)
    w = _mla_weights(cfg)
    jp = {k: jnp.asarray(v, JNP[dtype]) for k, v in w.items()}
    tp = {k: torch.as_tensor(v).to(dtype) for k, v in w.items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    (jx, tx) = _pair(x, dtype)
    out, (c_kv, k_rope) = L.mla_block(tx, tp, cfg)
    rout, (rc, rk) = RL.mla_block(jx, jp, rcfg)
    for got, ref in ((out, rout), (c_kv, rc), (k_rope, rk)):
        assert got.dtype == dtype and got.shape == ref.shape
        np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])

    # decode over two slots at different positions, from bf16 caches
    s_max = 16
    cache = rng.normal(size=(2, s_max, cfg.mla.kv_lora_rank))
    rope = rng.normal(size=(2, s_max, cfg.mla.qk_rope_head_dim))
    jc, tc = _pair(cache.astype(np.float32), torch.bfloat16)
    jr, tr = _pair(rope.astype(np.float32), torch.bfloat16)
    idx = np.array([3, 12], np.int32)
    xd = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jxd, txd = _pair(xd, dtype)
    out, tc2, tr2 = L.mla_decode(txd, tp, cfg, tc, tr,
                                 torch.as_tensor(idx).long())
    rout, rc2, rr2 = RL.mla_decode(jxd, jp, rcfg, jc, jr, jnp.asarray(idx))
    assert out.dtype == dtype and out.shape == (2, 1, cfg.d_model)
    np.testing.assert_allclose(_np(out), _np(rout), **TOL[dtype])
    np.testing.assert_allclose(_np(tc2), _np(rc2), **TOL[torch.bfloat16])
    np.testing.assert_allclose(_np(tr2), _np(rr2), **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,dv,sk,causal,q_offset,masked", [
    (2, 2, 24, 16, 2500, True, 0, False),      # MLA's d != dv
    (2, 2, 24, 16, 2500, False, 0, False),
    (4, 2, 16, 16, 2800, True, 300, False),    # a query offset (GQA)
    (2, 1, 16, 16, 2507, False, 7, True),      # bidirectional, kv mask
], ids=["mla-causal", "mla-bidir", "offset-causal", "offset-bidir-masked"])
def test_attention_over_query_chunks_matches_reference(h, hkv, d, dv, sk,
                                                       causal, q_offset,
                                                       masked, dtype):
    """Sq = 2,500 over chunk_q = 1,024: three chunks, the last padded.
    Every case fails the flash gate, so both packages chunk (the
    reference's default kernel mode)."""
    rng = np.random.default_rng(sk + q_offset)
    sq = 2500
    q = rng.normal(size=(1, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(1, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(1, sk, hkv, dv)).astype(np.float32)
    valid = rng.random((1, sk)) < 0.8 if masked else None
    kw = dict(causal=causal, q_offset=q_offset, chunk_q=1024)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    ref = RL.attention(jq, jk, jv, **kw, kv_valid=None if valid is None
                       else jnp.asarray(valid))
    got = L.attention(tq, tk, tv, **kw, kv_valid=None if valid is None
                      else torch.as_tensor(valid))
    assert got.dtype == dtype and got.shape == (1, sq, h, dv)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


# ---------------------------------------------------------------------------
# (d) whole models, (e) the engine
# ---------------------------------------------------------------------------
@pytest.fixture
def pallas_mode():
    """The reference's attention prefill through its flash kernel (Pallas
    interpret mode), which is what the port's gate runs; MLA's prefill
    takes the dense path in both modes."""
    saved = RL.kernel_mode()
    RL.set_kernel_mode("pallas")
    try:
        yield
    finally:
        RL.set_kernel_mode(saved)


@pytest.fixture(scope="module")
def weights():
    """Per arch: the reference's smoke model (a Python loop over layers,
    `use_scan=False`, as the port runs them) and weights with non-zero
    norm scales, and the port's model on the same weights."""
    out = {}
    for arch in (DEEPSEEK, MOONLIGHT):
        cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  use_scan=False)
        rmodel = ref_build_model(cfg)
        params = rmodel.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)

        def norms(path, a):
            if "norm" in jax.tree_util.keystr(path):
                return jnp.asarray(rng.normal(0.0, 0.2, a.shape), a.dtype)
            return a
        params = jax.tree_util.tree_map_with_path(norms, params)
        pmodel = build_model(get_config(arch, smoke=True))
        out[arch] = (rmodel, params, pmodel)
    return out


@pytest.fixture(params=[(DEEPSEEK, "bfloat16"), (DEEPSEEK, "float32"),
                        (MOONLIGHT, "bfloat16"), (MOONLIGHT, "float32")],
                ids=lambda p: f"{p[0].split('-')[0]}-{p[1]}")
def models(request, weights):
    arch, dt = request.param
    rmodel, params, pmodel = weights[arch]
    if dt == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return rmodel, params, pmodel, pparams, LOGIT_TOL[dt]


def test_router_keeps_fp32_through_init_and_carry_over(weights):
    rmodel, params, pmodel = weights[DEEPSEEK]
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    own = pmodel.init(torch.Generator().manual_seed(0), "cpu")
    for tree in (pparams, own):
        ffn = tree["segments"][1]["blocks"][0]["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert ffn["w_gate"].dtype == torch.bfloat16
        assert ffn["w_gate"].shape == (1, 4, 64, 32)
        mixer = tree["segments"][0]["blocks"][0]["mixer"]
        assert mixer["kv_norm"].shape == (1, 32)


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
        assert _scaled_max(pl, rl) <= tol
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
        assert _scaled_max(pl, rl) <= tol
        tokens = np.array(jnp.argmax(rl[:, 0], axis=-1),
                          np.int32)[:, None]             # teacher forcing
        idx = idx + 1
    for key in rcache[0][0]:        # the caches agree where written
        a, b = _np(rcache[0][0][key]), _np(pcache[0][0][key])
        np.testing.assert_allclose(b, a, rtol=2e-2,
                                   atol=2e-2 * np.abs(a).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_loss_over_query_chunks_matches_reference(weights, dtype):
    """DeepSeek smoke's `Model.loss` on 1 x 1,100 tokens: MLA fails the
    flash gate, so its attention runs over two query chunks of 1,024 in
    both packages (full logits, the reference's default mode); the bars
    of tests/test_torch_loss.py."""
    rmodel, params, pmodel = weights[DEEPSEEK]
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    batch = PD.SyntheticLM(pmodel.cfg, 1, 1100, seed=3).batch_at(0)
    rloss, rmet = rmodel.loss(params, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with torch.no_grad():
        loss, met = pmodel.loss(pparams, batch)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    if dtype == "bfloat16":
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-2)
        return
    for a, b in ((loss, rloss), (met["nll"], rmet["nll"]),
                 (met["aux"], rmet["aux"])):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=0)


def test_apply_segments_sums_the_aux_loss(weights):
    """`apply_segments` returns the sum of the MoE layers' aux losses, the
    reference's total; `prefill` drops it."""
    from repro.models import transformer as RT
    from repro_torch.models import transformer as T
    rmodel, params, pmodel = weights[DEEPSEEK]
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (2, 10))
    rx = params["embed"][jnp.asarray(tokens)]
    _, raux, _ = RT.apply_segments(rx, params["segments"], rmodel.cfg)
    px = pparams["embed"][torch.as_tensor(tokens)]
    _, aux, caches = T.apply_segments(px, pparams["segments"], pmodel.cfg)
    assert caches is None and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def _record(engine, store):
    """Keep every step's logits per request id."""
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_matches_reference_on_deepseek(weights, dtype):
    rmodel, params, pmodel = weights[DEEPSEEK]
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tol = LOGIT_TOL[dtype]
    cost = dict(flops=2.0 * pmodel.cfg.active_param_count(),
                hbm_bytes=2.0 * pmodel.cfg.active_param_count(),
                ici_bytes=0.0)
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
        record = sess.record_tick
        sess.record_tick = (lambda rec: lambda _, **kw: rec(0.25, **kw))(
            record)
        rng = np.random.default_rng(3)
        for _ in range(3):
            engine.submit(rng.integers(0, 256, rng.integers(5, 12)
                                       ).astype(np.int32), max_new=4)
    ref_done = {r.rid: r for r in ref.run_until_drained()}
    got_done = {r.rid: r for r in got.run_until_drained()}
    assert sorted(got_done) == sorted(ref_done) == [0, 1, 2]
    for rid, r in ref_done.items():
        g = got_done[rid]
        assert len(g.generated) == len(r.generated) == 4
        for i, (a, b) in enumerate(zip(r.generated, g.generated)):
            if dtype == "float32":
                assert _scaled_max(plog[rid][i], rlog[rid][i]) <= tol
            if a != b:            # a tie within tolerance: stop comparing
                row = rlog[rid][i]
                top = np.sort(row)[-2:]
                assert top[1] - top[0] <= tol * np.abs(row).max()
                break
    assert psess.live_units == rsess.live_units > 0
    for f in ("live_energy_kwh", "live_co2_kg"):
        assert getattr(psess, f) == pytest.approx(getattr(rsess, f),
                                                  rel=1e-12)


# ---------------------------------------------------------------------------
# (f) configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", DEEPSEEK, MOONLIGHT,
                                  "granite-34b", "qwen2.5-14b",
                                  "llama3-405b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_reference(arch, smoke):
    cfg, rcfg = get_config(arch, smoke), ref_get_config(arch, smoke)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert build_model(cfg).param_count() == cfg.param_count()
    assert cfg.moe == (None if rcfg.moe is None else
                       type(cfg.moe)(**dataclasses.asdict(rcfg.moe)))


def test_deepseek_full_width_spec_matches_reference():
    """DeepSeek-V2-Lite at its published widths: the same tree of shapes
    and dtypes as the reference's, 15,706,484,224 parameters of which
    2,661,150,208 are active per token, without allocating either."""
    ref = ref_build_model(ref_get_config(DEEPSEEK))
    got = build_model(get_config(DEEPSEEK))
    flat = jax.tree_util.tree_flatten_with_path(ref.abstract_params())[0]
    theirs = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
              (tuple(s.shape), str(s.dtype)) for path, s in flat}
    mine = {}

    def walk(tree, path):
        if isinstance(tree, PA.ParamSpec):
            mine[path] = (tree.shape, str(tree.dtype).split(".")[-1])
        else:
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            for k, v in items:
                walk(v, path + (k,))
    walk(got.spec(), ())
    assert mine == theirs
    assert got.param_count() == 15_706_484_224
    assert got.cfg.active_param_count() == 2_661_150_208
