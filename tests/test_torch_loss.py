"""The port's loss slice held against the JAX package on the CPU:

* (a) `data.pipeline`: `synth_tokens`, `SyntheticLM.batch_at` (LM, VLM and
  encoder-decoder batches) and the `Prefetcher` give the reference's
  batches bit for bit;
* (b) K10's plain version (`kernels/xent.py::blocked_xent_plain`, what the
  wrapper runs on CPU tensors) against the reference's Pallas kernel in
  interpret mode and its full-logits oracle, at the shapes of
  tests/test_kernels.py plus a bf16 case, the (d, V) head and a token
  tail: nll within rtol = atol = 1e-4 (that file's bar); its argmax is the
  first index of the oracle's row maximum wherever the top-2 gap exceeds
  1e-4 of max |logit|, and gives the reference `blocked_cross_entropy`'s
  accuracy;
* (c) `cross_entropy` and `blocked_cross_entropy` (several vocab blocks,
  both head layouts) with and without a mask against the reference's:
  1e-6 in fp32;
* (d) `Model.loss` on the TinyLlama smoke model (untied head, and a tied
  variant) and the DeepSeek-V2-Lite smoke model (MLA, MoE, non-zero aux
  loss), blocked and full-logits, with the reference's weights carried
  across and the reference built with `use_scan=False`, as the serving
  tests build it: in fp32 loss, nll and aux within 1e-5 relative and acc
  equal except at near-ties (top-2 gap at most 1e-4 of max |logit|); in
  bf16 the loss within 1e-2 relative.

The kernel itself runs on the card only: tests/test_torch_kernels.py and
chip_smoke.py hold it against its plain version there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as RD  # noqa: E402
from repro.kernels import ref as KREF  # noqa: E402
from repro.kernels.xent import blocked_xent as ref_pallas_xent  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import loss as RLOSS  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.kernels import xent as k10  # noqa: E402
from repro_torch.models import loss as LOSS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model, params_from_numpy  # noqa: E402

TINY, DEEPSEEK = "tinyllama-1.1b", "deepseek-v2-lite-16b"
NEAR_TIE = 1e-4          # top-2 gap, as a share of max |logit|


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _bf16(a):
    """A float32 array rounded to bf16 (both sides get the same values)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------------
# (a) the data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,batch,seq,vocab,start_row", [
    (0, 0, 4, 2048, 32000, 0), (7, 123456, 3, 37, 256, 5),
    (2 ** 20, 3, 1, 9, 102400, 2 ** 16)])
def test_synth_tokens_bitwise(seed, step, batch, seq, vocab, start_row):
    got = D.synth_tokens(seed, step, batch, seq, vocab, start_row)
    ref = RD.synth_tokens(seed, step, batch, seq, vocab, start_row)
    assert got.dtype == ref.dtype == np.int32 and got.shape == (batch, seq)
    assert np.array_equal(got, ref)
    assert got.min() >= 0 and got.max() < vocab


@pytest.mark.parametrize("kind", ["lm", "vlm", "encdec"])
def test_synthetic_lm_batches_bitwise(kind):
    kw = {"lm": {}, "vlm": dict(family="vlm", n_vision_tokens=8),
          "encdec": dict(encdec=True, dec_train_len=16)}[kind]
    cfg = dataclasses.replace(get_config(TINY, smoke=True), **kw)
    rcfg = dataclasses.replace(ref_get_config(TINY, smoke=True), **kw)
    src, ref = D.SyntheticLM(cfg, 2, 24, seed=3), RD.SyntheticLM(rcfg, 2, 24,
                                                                 seed=3)
    for step in (0, 1, 2):
        a, b = src.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), (kind, step, key)
    pre = D.Prefetcher(src.iterate(5), depth=2)
    try:
        for step in (5, 6, 7):
            got = next(pre)
            assert all(np.array_equal(got[k], v)
                       for k, v in ref.batch_at(step).items())
    finally:
        pre.close()


# ---------------------------------------------------------------------------
# (b) K10's plain version
# ---------------------------------------------------------------------------
def _xent_inputs(t, d, v, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, d)) * 0.5).astype(np.float32)
    emb = (rng.normal(size=(v, d)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":
        x, emb = _bf16(x), _bf16(emb)
    lab = rng.integers(0, v, t).astype(np.int32)
    logits = x.astype(np.float64) @ emb.astype(np.float64).T
    lab[::2] = logits[::2].argmax(axis=1)      # half the tokens are hits
    return x, emb, lab, logits


@pytest.mark.parametrize("t,d,v,bv,dtype,dv", [
    (512, 256, 1000, 512, "float32", False),      # tests/test_kernels.py
    (300, 128, 5000, 2048, "float32", False),
    (64, 64, 100, 64, "float32", False),
    (200, 128, 1000, 256, "bfloat16", False),     # bf16
    (128, 64, 700, 256, "float32", True),          # the (d, V) head
    (77, 96, 1000, 512, "bfloat16", True)])        # token tail, bf16, (d, V)
def test_blocked_xent_plain_matches_pallas_and_oracle(t, d, v, bv, dtype, dv):
    x, emb, lab, logits = _xent_inputs(t, d, v, seed=t + v, dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, je, jl = jnp.asarray(x, jdt), jnp.asarray(emb, jdt), jnp.asarray(lab)
    pallas = ref_pallas_xent(jx, je, jl, block_v=bv, interpret=True)
    oracle = KREF.blocked_xent_ref(jx, je, jl)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    px = torch.as_tensor(x).to(tdt)
    pe = torch.as_tensor(emb.T.copy() if dv else emb).to(tdt)
    before = k10.launches
    nll, amax, lse = k10.blocked_xent(px, pe, torch.as_tensor(lab),
                                      transpose_emb=dv, block_v=bv)
    assert k10.launches == before                      # CPU: no launch
    assert nll.dtype == lse.dtype == torch.float32
    assert amax.dtype == torch.int32
    assert nll.shape == amax.shape == lse.shape == (t,)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(_np(nll), _np(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(                        # lse - the label logit
        _np(lse) - logits[np.arange(t), lab], _np(oracle), rtol=1e-4,
        atol=1e-4)
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > NEAR_TIE * np.abs(logits).max()
    assert clear.mean() > 0.9
    assert np.array_equal(amax.numpy()[clear], logits.argmax(1)[clear])
    _, racc = RLOSS.blocked_cross_entropy(jx, je, jl, block=bv)
    np.testing.assert_allclose(float((amax.numpy() == lab).mean()),
                               float(racc), rtol=0, atol=1e-7)


def test_blocked_xent_plain_keeps_the_first_index_of_a_tie():
    """Equal logits within a block and across blocks: the first index, as
    `jnp.argmax` within a block and strict `>` across blocks give it."""
    x = torch.ones((3, 2))                 # logits -1, 2, 0, 2, 2
    emb = torch.tensor([[-1., 0.], [1., 1.], [-1., 1.], [1., 1.], [1., 1.]])
    for bv in (1, 2, 3, 8):
        _, amax, _ = k10.blocked_xent(
            x, emb, torch.zeros(3, dtype=torch.int64), block_v=bv)
        assert amax.tolist() == [1, 1, 1], bv


# ---------------------------------------------------------------------------
# (c) the losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (3, 7, 50)).astype(np.float32)
    lab = rng.integers(0, 50, (3, 7)).astype(np.int32)
    lab[:, ::3] = logits[:, ::3].argmax(-1)
    mask = (rng.uniform(size=(3, 7)) > 0.3).astype(np.float32) \
        if masked else None
    ref = RLOSS.cross_entropy(jnp.asarray(logits), jnp.asarray(lab),
                              None if mask is None else jnp.asarray(mask))
    got = LOSS.cross_entropy(torch.as_tensor(logits), torch.as_tensor(lab),
                             None if mask is None else torch.as_tensor(mask))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and a.dim() == 0
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=0)
    assert float(got[1]) > 0


@pytest.mark.parametrize("dv", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_blocked_cross_entropy_matches_reference(masked, dv):
    x, emb, lab, _ = _xent_inputs(96, 32, 1000, seed=11)
    x = x * 3.0
    mask = (np.random.default_rng(12).uniform(size=96) > 0.25).astype(
        np.float32) if masked else None
    je = jnp.asarray(emb.T if dv else emb)
    ref = RLOSS.blocked_cross_entropy(
        jnp.asarray(x), je, jnp.asarray(lab), block=256,
        mask=None if mask is None else jnp.asarray(mask), transpose_emb=dv)
    got = LOSS.blocked_cross_entropy(
        torch.as_tensor(x), torch.as_tensor(emb.T.copy() if dv else emb),
        torch.as_tensor(lab), block=256,
        mask=None if mask is None else torch.as_tensor(mask),
        transpose_emb=dv)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=0)
    assert float(got[1]) > 0.4                       # half are hits
    full = LOSS.cross_entropy(torch.as_tensor(x @ emb.T), torch.as_tensor(lab),
                              None if mask is None else torch.as_tensor(mask))
    for a, b in zip(got, full):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# (d) Model.loss on the smoke models
# ---------------------------------------------------------------------------
@pytest.fixture
def pallas_mode():
    """The reference's attention through its flash kernel (Pallas interpret
    mode), which is what the port's gate runs."""
    saved = RL.kernel_mode()
    RL.set_kernel_mode("pallas")
    try:
        yield
    finally:
        RL.set_kernel_mode(saved)


@pytest.fixture(scope="module")
def weights():
    """Per (arch, tied): the reference's smoke model (`use_scan=False`) with
    norm scales drawn non-zero, and the port's model."""
    out = {}
    for arch, tied in ((TINY, False), (TINY, True), (DEEPSEEK, False)):
        cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  use_scan=False, tie_embeddings=tied)
        rmodel = ref_build_model(cfg)
        params = rmodel.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)

        def norms(path, a):
            if "norm" in jax.tree_util.keystr(path):
                return jnp.asarray(rng.normal(0.0, 0.2, a.shape), a.dtype)
            return a
        params = jax.tree_util.tree_map_with_path(norms, params)
        pcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   tie_embeddings=tied)
        out[arch, tied] = (rmodel, params, pcfg)
    return out


def _near_ties(pmodel, pparams, tokens):
    """Masked positions whose port logits have a top-2 gap of at most
    NEAR_TIE of max |logit| (fp32 weights)."""
    x = pparams["embed"][torch.as_tensor(tokens).long()]
    x, _, _ = T.apply_segments(x, pparams["segments"], pmodel.cfg)
    x = L.rms_norm(x, pparams["final_norm"], pmodel.cfg.norm_eps)
    logits = pmodel._head(pparams, x)[:, :-1].float()
    top2 = logits.topk(2, dim=-1).values
    return int((top2[..., 0] - top2[..., 1]
                <= NEAR_TIE * logits.abs().max()).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("arch,tied", [(TINY, False), (TINY, True),
                                       (DEEPSEEK, False)],
                         ids=["tinyllama", "tinyllama-tied", "deepseek"])
def test_model_loss_matches_reference(weights, pallas_mode, arch, tied,
                                      blocked, dtype):
    rmodel, params, pcfg = weights[arch, tied]
    rcfg = dataclasses.replace(rmodel.cfg, blocked_xent=blocked,
                               vocab_block=96)
    pcfg = dataclasses.replace(pcfg, blocked_xent=blocked, vocab_block=96)
    rmodel = dataclasses.replace(rmodel, cfg=rcfg)
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    pmodel = build_model(pcfg)
    pparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    batch = D.SyntheticLM(pcfg, 2, 12, seed=4).batch_at(1)
    rloss, rmet = rmodel.loss(params, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with torch.no_grad():
        loss, met = pmodel.loss(pparams, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert sorted(met) == ["acc", "aux", "nll"]
    if dtype == "bfloat16":
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-2)
        return
    for a, b in ((loss, rloss), (met["nll"], rmet["nll"]),
                 (met["aux"], rmet["aux"])):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=0)
    assert (float(met["aux"]) > 0) == (arch == DEEPSEEK)
    denom = batch["tokens"].size - batch["tokens"].shape[0]
    flips = abs(float(met["acc"]) - float(rmet["acc"])) * denom
    assert flips <= _near_ties(pmodel, pparams, batch["tokens"]) + 1e-3
