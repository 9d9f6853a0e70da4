"""The port's blocked-loss training, checkpoints, fault-tolerant loop and
training CLI held against the JAX package on the CPU:

* (a) the blocked loss's gradients (`models.loss.blocked_cross_entropy`
  through `ops.BlockedXent`: K10's and K12a's plain versions here)
  against `jax.grad` of the reference's `blocked_cross_entropy`, fp32,
  T = 96, d = 64, V = 1,000 in blocks of 256 (a ragged last block), both
  head layouts, a mask with zeros: dx and d emb within 1e-5 relative in
  norm; and against the port's own full-logits `cross_entropy`;
* (b) the TinyLlama smoke model's `Model.loss` with `blocked_xent`
  (vocab blocks of 96: three, the last ragged) against `jax.grad` of the
  reference's (`use_scan=False`, weights well-conditioned and carried
  across by `params_from_numpy`): every leaf within 1e-4 relative in
  norm; then three `make_train_step` steps, `grad_accum` 1 and 2, against
  the reference's: loss, `grad_norm`, `lr` and every leaf within 1e-5;
* (c) `remat` "full" and "dots": gradients bitwise equal to "none" in the
  port, and the reference's own remat modes within 1e-4 of them;
* (d) checkpoints: the reference's three checkpoint tests
  (tests/test_distributed.py) on the port, and the on-disk format shared
  both ways, bitwise: a train state saved by `repro.checkpoint` restores
  in the port and one saved by the port in the reference;
  `AsyncCheckpointer` saves the state as it was at `submit`; a damaged
  member fails the restore;
* (e) `run_training` against the reference's from one step-0 checkpoint:
  six steps, final leaves and the metrics history within 1e-5;
* (f) the port twins of tests/test_distributed.py's failure-injection,
  restart-budget and straggler tests and tests/test_system.py's loss and
  accounting tests; a failed save of the final state is made again, or
  `run_training` raises;
* (g) `python -m repro_torch.launch.train --smoke --device cpu` in
  process; with no card and no `--device` it raises.

K12a itself runs on the card only: tests/test_torch_kernels.py and
chip_smoke.py hold it against its plain version there.
"""
import dataclasses
import json
import os
import tempfile
import zipfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as RCK  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import loss as RLOSS  # noqa: E402
from repro.optim import adamw as RADAM  # noqa: E402
from repro.training import loop as RLOOP  # noqa: E402
from repro.training import step as RSTEP  # noqa: E402

from repro_torch import checkpoint as CK  # noqa: E402
from repro_torch.checkpoint import checkpoint as CKM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import controller as CTRL  # noqa: E402
from repro_torch.core import energy as EN  # noqa: E402
from repro_torch.core import policy as POL  # noqa: E402
from repro_torch.core import tracker as TR  # noqa: E402
from repro_torch.core.verify import verify_unit_log  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.distributed import fault_tolerance as FT  # noqa: E402
from repro_torch.kernels import xent as k10  # noqa: E402
from repro_torch.launch import train as LAUNCH  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import loss as LOSS  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw as ADAM  # noqa: E402
from repro_torch.training import loop as LOOP  # noqa: E402
from repro_torch.training import step as STEP  # noqa: E402

TINY = "tinyllama-1.1b"
BLOCK = 96                    # the smoke vocab of 256 in three blocks


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


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _bits(t):
    """A tensor's raw bits as a numpy array (bf16 through int16)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


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
# (a) the blocked loss's gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("transpose_emb", [False, True])
def test_blocked_loss_grads_match_reference(transpose_emb):
    rng = np.random.default_rng(7)
    t, d, v = 96, 64, 1000
    x = rng.normal(0, 1.0, (t, d)).astype(np.float32)
    emb = rng.normal(0, d ** -0.5, (v, d)).astype(np.float32)
    if transpose_emb:
        emb = np.ascontiguousarray(emb.T)
    lab = rng.integers(0, v, t).astype(np.int32)
    lab[:3] = v - 1                                # the ragged last block
    mask = (rng.random(t) > 0.3).astype(np.float32)

    def rloss(x_, e_):
        return RLOSS.blocked_cross_entropy(x_, e_, jnp.asarray(lab),
                                           block=256, mask=jnp.asarray(mask),
                                           transpose_emb=transpose_emb)[0]
    rl = rloss(jnp.asarray(x), jnp.asarray(emb))
    rdx, rde = jax.grad(rloss, (0, 1))(jnp.asarray(x), jnp.asarray(emb))

    tx, te = (torch.tensor(a).requires_grad_() for a in (x, emb))
    before = (k10.launches, k10.bwd_launches)
    loss, acc = LOSS.blocked_cross_entropy(
        tx, te, torch.as_tensor(lab), block=256, mask=torch.as_tensor(mask),
        transpose_emb=transpose_emb)
    dx, de = torch.autograd.grad(loss, (tx, te))
    assert (k10.launches, k10.bwd_launches) == before      # CPU: no launch
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=1e-6)
    assert dx.shape == x.shape and de.shape == emb.shape
    assert _rel(dx.numpy(), rdx) <= 1e-5 and _rel(de.numpy(), rde) <= 1e-5

    # the port's own full-logits loss on the same inputs
    tx2, te2 = (torch.tensor(a).requires_grad_() for a in (x, emb))
    logits = tx2 @ (te2 if transpose_emb else te2.t())
    floss, facc = LOSS.cross_entropy(logits, torch.as_tensor(lab).long(),
                                     torch.as_tensor(mask))
    fdx, fde = torch.autograd.grad(floss, (tx2, te2))
    np.testing.assert_allclose(float(loss.detach()), float(floss.detach()),
                               rtol=1e-6)
    assert float(acc) == float(facc)
    assert _rel(dx.numpy(), fdx.numpy()) <= 1e-5
    assert _rel(de.numpy(), fde.numpy()) <= 1e-5


def test_blocked_xent_raw_wrapper_stays_forward_only():
    x, emb = torch.zeros(4, 8, requires_grad=True), torch.zeros(10, 8)
    with pytest.raises(RuntimeError, match="forward only"):
        k10.blocked_xent(x, emb, torch.zeros(4, dtype=torch.int64))


# ---------------------------------------------------------------------------
# (b) Model.loss with blocked_xent, and train steps, against the reference
# ---------------------------------------------------------------------------
def conditioned(params, seed=2):
    """The reference's tree redrawn well-conditioned in fp32 (as
    tests/test_torch_training.py draws it): matrices N(0, 1/fan-in), norm
    scales N(0, 0.2), the embedding N(0, 1)."""
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


def _configs(**knobs):
    kw = dict(dict(blocked_xent=True, vocab_block=BLOCK), **knobs)
    rcfg = dataclasses.replace(ref_get_config(TINY, smoke=True),
                               use_scan=False, **kw)
    return rcfg, dataclasses.replace(get_config(TINY, smoke=True), **kw)


@pytest.fixture(scope="module")
def tiny():
    """The reference's TinyLlama smoke model with the blocked loss, its
    weights drawn well-conditioned, and the port's model."""
    rcfg, pcfg = _configs()
    rmodel = ref_build_model(rcfg)
    params = conditioned(rmodel.init(jax.random.PRNGKey(0)))
    return rmodel, params, build_model(pcfg)


def _trainable(params):
    return STEP.trainable(params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))


def _grads(model, params, batch):
    loss, _ = model.loss(params, batch)
    paths = _paths(params)
    return loss, paths, torch.autograd.grad(loss, [t for _, t in paths])


def test_blocked_model_loss_grads_match_reference(tiny):
    rmodel, params, pmodel = tiny
    assert pmodel.cfg.vocab_size > 2 * BLOCK
    batch = D.SyntheticLM(pmodel.cfg, 2, 24, seed=4).batch_at(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, jbatch)[0]))(params)
    before = (k10.launches, k10.bwd_launches)
    loss, paths, grads = _grads(pmodel, _trainable(params), batch)
    assert (k10.launches, k10.bwd_launches) == before      # CPU: no launch
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    ref = _by_path(rgrads)
    assert sorted(ref) == sorted(p for p, _ in paths)
    for (path, _), g in zip(paths, grads):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), ref[path]) <= 1e-4, path


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_blocked_train_steps_match_reference(tiny, grad_accum):
    rmodel, params, pmodel = tiny
    kw = dict(warmup_steps=2, total_steps=10)
    opt, ropt = ADAM.AdamWConfig(**kw), RADAM.AdamWConfig(**kw)
    pparams = _trainable(params)
    state = {"params": pparams, "opt": ADAM.init_opt_state(pparams, opt)}
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
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(rmet[key]),
                                       rtol=1e-5, atol=0, err_msg=key)
        ref = _by_path(rstate["params"])
        for path, t in _paths(state["params"]):
            assert _rel(_np(t), ref[path]) <= 1e-5, (s, path)


# ---------------------------------------------------------------------------
# (c) remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_equal_none(tiny, remat, blocked):
    """The port's rematerialized layers give the gradients of "none"
    bitwise (the recompute runs the same ops on the same inputs); the
    reference's own remat mode gives them within 1e-4."""
    _, params, _ = tiny
    batch = D.SyntheticLM(get_config(TINY, smoke=True), 2, 24,
                          seed=5).batch_at(2)
    got = {}
    for mode in ("none", remat):
        _, pcfg = _configs(remat=mode, blocked_xent=blocked)
        loss, paths, grads = _grads(build_model(pcfg), _trainable(params),
                                    batch)
        got[mode] = (float(loss), paths, grads)
    assert got[remat][0] == got["none"][0]
    for a, b in zip(got[remat][2], got["none"][2]):
        assert torch.equal(a, b)
    rcfg, _ = _configs(remat=remat, blocked_xent=blocked)
    rmodel = ref_build_model(rcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = _by_path(jax.jit(jax.grad(
        lambda p: rmodel.loss(p, jbatch)[0]))(params))
    for (path, _), g in zip(got[remat][1], got[remat][2]):
        assert _rel(g.numpy(), ref[path]) <= 1e-4, path


# ---------------------------------------------------------------------------
# (d) checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_identity():
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                  "d": torch.zeros((), dtype=torch.int32) + 7}}
    with tempfile.TemporaryDirectory() as td:
        CK.save_checkpoint(td, 3, tree, {"step": 3})
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), tree)
        got, meta = CK.restore_checkpoint(td, like, device="cpu")
        assert meta["step"] == 3
        for a, b in zip(tree_leaves(tree), tree_leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_checkpoint_roundtrip_property(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": torch.as_tensor(rng.normal(size=(4, 4)).astype(np.float32)),
            "s": torch.tensor(int(rng.integers(0, 100)), dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as td:
        CK.save_checkpoint(td, 1, tree)
        got, _ = CK.restore_checkpoint(td, tree)
        assert torch.equal(tree["w"], got["w"])
        assert int(tree["s"]) == int(got["s"]) and got["s"].shape == ()


def test_checkpoint_keep_k_and_latest():
    tree = {"x": torch.ones(2)}
    with tempfile.TemporaryDirectory() as td:
        assert CK.latest_step(td) is None
        for s in (1, 2, 3, 4, 5):
            CK.save_checkpoint(td, s, tree, keep=2)
        assert CK.latest_step(td) == 5
        dirs = sorted(d for d in os.listdir(td) if d.startswith("step_"))
        assert dirs == ["step_00000004", "step_00000005"]
        with pytest.raises(FileNotFoundError):
            CK.restore_checkpoint(os.path.join(td, "none"), tree)


def test_checkpoint_restore_refuses_a_damaged_member():
    """`np.load` checks each member's CRC-32: one flipped byte of a saved
    array fails the restore instead of restoring other numbers."""
    tree = {"w": torch.arange(64, dtype=torch.float32),
            "b": torch.ones(8, dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(CK.save_checkpoint(td, 2, tree), "arrays.npz")
        with zipfile.ZipFile(path) as z:
            info = z.getinfo("w.npy")
        with open(path, "r+b") as f:
            f.seek(info.header_offset + 26)
            n_name, n_extra = np.frombuffer(f.read(4), "<u2")
            last = (info.header_offset + 30 + int(n_name) + int(n_extra)
                    + info.file_size - 1)    # the member's last data byte
            f.seek(last)
            byte = f.read(1)[0]
            f.seek(last)
            f.write(bytes([byte ^ 0x40]))
        with pytest.raises(zipfile.BadZipFile, match="CRC"):
            CK.restore_checkpoint(td, tree)


def _ref_state(seed=0):
    """A reference train state of the smoke model (bf16 parameters) with
    moments that are not zeros and a step count."""
    rmodel = ref_build_model(ref_get_config(TINY, smoke=True))
    params = rmodel.init(jax.random.PRNGKey(seed))
    opt = RADAM.init_opt_state(params, RADAM.AdamWConfig())
    rng = np.random.default_rng(seed)
    opt["m"] = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape), jnp.float32), opt["m"])
    opt["v"] = jax.tree.map(lambda a: jnp.asarray(
        rng.random(a.shape), jnp.float32), opt["v"])
    opt["step"] = jnp.asarray(17, jnp.int32)
    return rmodel, {"params": params, "opt": opt}


def test_reference_checkpoint_restores_bitwise_in_the_port():
    rmodel, rstate = _ref_state()
    model = build_model(get_config(TINY, smoke=True))
    like = STEP.abstract_train_state(model, ADAM.AdamWConfig())
    with tempfile.TemporaryDirectory() as td:
        RCK.save_checkpoint(td, 17, rstate, {"step": 17})
        got, meta = CK.restore_checkpoint(td, like, device="cpu")
    assert meta == {"step": 17}
    ref = {jax.tree_util.keystr(p): a for p, a in
           jax.tree_util.tree_flatten_with_path(rstate)[0]}
    paths = _paths(got)
    assert sorted(ref) == sorted(p for p, _ in paths)
    for path, t in paths:
        want = ref[path]
        assert str(t.dtype).split(".")[1] == str(np.asarray(want).dtype)
        assert tuple(t.shape) == np.asarray(want).shape
        assert np.array_equal(_bits(t), _jbits(want)), path


def test_port_checkpoint_restores_bitwise_in_the_reference():
    model = build_model(get_config(TINY, smoke=True))
    opt = ADAM.AdamWConfig()
    state = STEP.init_train_state(model, torch.Generator().manual_seed(3),
                                  opt, "cpu")
    gen = torch.Generator().manual_seed(4)
    for t in tree_leaves(state["opt"]["m"]) + tree_leaves(state["opt"]["v"]):
        t.copy_(torch.randn(t.shape, generator=gen))
    state["opt"]["step"] = torch.tensor(9, dtype=torch.int32)
    rmodel = ref_build_model(ref_get_config(TINY, smoke=True))
    like = RSTEP.abstract_train_state(rmodel, RADAM.AdamWConfig())
    with tempfile.TemporaryDirectory() as td:
        CK.save_checkpoint(td, 9, state, {"step": 9})
        manifest = json.load(open(os.path.join(td, "step_00000009",
                                               "manifest.json")))
        got, meta = RCK.restore_checkpoint(td, like)
    assert meta == {"step": 9} and manifest["step"] == 9
    assert manifest["entries"]["params/embed"]["dtype"] == "bfloat16"
    ref = {jax.tree_util.keystr(p): a for p, a in
           jax.tree_util.tree_flatten_with_path(got)[0]}
    paths = _paths(state)
    assert sorted(ref) == sorted(p for p, _ in paths)
    for path, t in paths:
        assert np.array_equal(_jbits(ref[path]), _bits(t)), path


def test_async_checkpointer_saves_the_state_at_submit():
    """`submit` copies every leaf to the host before it returns: an
    in-place AdamW step right after does not reach the pending save."""
    cfg = get_config(TINY, smoke=True)
    model = build_model(cfg)
    opt = ADAM.AdamWConfig(warmup_steps=1, total_steps=4)
    state = STEP.init_train_state(model, torch.Generator().manual_seed(0),
                                  opt, "cpu")
    step = STEP.make_train_step(model, opt)
    batch = D.SyntheticLM(cfg, 2, 16).batch_at(0)
    state, _ = step(state, batch)
    before = tree_map(lambda t: t.detach().clone(), state)
    with tempfile.TemporaryDirectory() as td:
        ck = CK.AsyncCheckpointer(td, keep=1)
        ck.submit(1, state, {"step": 1})
        state, _ = step(state, batch)                # in place
        ck.wait()
        assert ck.errors == [] and ck.last_saved == 1
        got, meta = CK.restore_checkpoint(
            td, STEP.abstract_train_state(model, opt), device="cpu")
    assert meta == {"step": 1}
    changed = 0
    for (path, a), b, c in zip(_paths(before), tree_leaves(got),
                               tree_leaves(state)):
        assert np.array_equal(_bits(a), _bits(b)), path
        changed += not torch.equal(a, c.detach())
    assert changed > 0                              # the step did write


# ---------------------------------------------------------------------------
# (e) run_training against the reference's
# ---------------------------------------------------------------------------
def _fp32_like(fn):
    """`abstract_train_state` with fp32 parameters, so both loops train
    the fp32 state they restore (the bf16 spec would round it)."""
    def like(model, opt_cfg):
        state = fn(model, opt_cfg)
        if isinstance(state["opt"]["step"], torch.Tensor):
            state["params"] = tree_map(
                lambda t: torch.empty(t.shape, device="meta"),
                state["params"])
        else:
            state["params"] = jax.tree.map(
                lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                state["params"])
        return state
    return like


def test_run_training_matches_reference(tiny, pallas_mode, monkeypatch,
                                        tmp_path):
    rmodel, params, pmodel = tiny
    kw = dict(warmup_steps=2, total_steps=6)
    ropt, opt = RADAM.AdamWConfig(**kw), ADAM.AdamWConfig(**kw)
    rstate = {"params": params, "opt": RADAM.init_opt_state(params, ropt)}
    monkeypatch.setattr(RSTEP, "abstract_train_state",
                        _fp32_like(RSTEP.abstract_train_state))
    monkeypatch.setattr(LOOP, "abstract_train_state",
                        _fp32_like(STEP.abstract_train_state))
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    for d in (rdir, pdir):
        RCK.save_checkpoint(d, 0, rstate, {"step": 0})
    lcfg = dict(total_steps=6, steps_per_unit=4, log_every=1)
    rres = RLOOP.run_training(
        rmodel, ropt, RSyntheticLM(rmodel.cfg, batch=2, seq=16, seed=3),
        RLOOP.LoopConfig(ckpt_dir=rdir, **lcfg))
    res = LOOP.run_training(
        pmodel, opt, D.SyntheticLM(pmodel.cfg, batch=2, seq=16, seed=3),
        LOOP.LoopConfig(ckpt_dir=pdir, **lcfg), device="cpu")
    assert res.final_step == rres.final_step == 6
    assert res.restarts == rres.restarts == 0
    assert len(res.metrics_history) == len(rres.metrics_history) == 6
    for got, want in zip(res.metrics_history, rres.metrics_history):
        assert sorted(got) == sorted(want) and got["step"] == want["step"]
        for key in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)
        for key in ("acc", "aux"):
            assert abs(got[key] - want[key]) <= 1e-5, key
    ref = _by_path(rres.state["params"])
    for path, t in _paths(res.state["params"]):
        assert t.dtype == torch.float32
        assert _rel(_np(t), ref[path]) <= 1e-5, path
    assert int(res.state["opt"]["step"]) == 6
    assert CK.latest_step(pdir) == RCK.latest_step(rdir) == 6


# ---------------------------------------------------------------------------
# (f) fault tolerance and the controller (port twins)
# ---------------------------------------------------------------------------
def test_failure_injection_and_restart(tmp_path):
    cfg = get_config(TINY, smoke=True)
    model = build_model(cfg)
    opt = ADAM.AdamWConfig(total_steps=20, warmup_steps=2)
    data = D.SyntheticLM(cfg, batch=4, seq=16)
    res = LOOP.run_training(
        model, opt, data,
        LOOP.LoopConfig(total_steps=20, steps_per_unit=4,
                        ckpt_dir=str(tmp_path)),
        injector=FT.FailureInjector(fail_at_steps=(6, 13)),
        supervisor=FT.Supervisor(elastic=False), device="cpu")
    assert res.final_step == 20 and res.restarts == 2
    assert CK.latest_step(str(tmp_path)) == 20


@pytest.mark.parametrize("failing", ["first", "every"])
def test_run_training_saves_the_final_state_or_raises(tmp_path, monkeypatch,
                                                      failing):
    """A failed background save of the last unit's state is made again at
    the end; if that fails too, `run_training` raises with the error
    instead of ending without a checkpoint of its final state."""
    cfg = get_config(TINY, smoke=True)
    model = build_model(cfg)
    opt = ADAM.AdamWConfig(total_steps=4, warmup_steps=1)
    save, calls = CKM.save_checkpoint, []

    def flaky(directory, step, *args, **kwargs):
        calls.append(step)
        if failing == "every" or len(calls) == 1:
            raise OSError("disk full")
        return save(directory, step, *args, **kwargs)
    monkeypatch.setattr(CKM, "save_checkpoint", flaky)

    def run():
        return LOOP.run_training(
            model, opt, D.SyntheticLM(cfg, batch=2, seq=16),
            LOOP.LoopConfig(total_steps=4, steps_per_unit=4,
                            ckpt_dir=str(tmp_path)), device="cpu")
    if failing == "every":
        with pytest.raises(RuntimeError, match="step 4.*disk full"):
            run()
    else:
        assert run().final_step == 4
        assert CK.latest_step(str(tmp_path)) == 4
    assert calls == [4, 4]


def test_restart_budget_exhaustion():
    s = FT.Supervisor(max_restarts=2, elastic=False)
    s.on_failure(1, 4, FT.WorkerFailure("x"))
    s.on_failure(2, 4, FT.WorkerFailure("x"))
    with pytest.raises(RuntimeError, match="budget"):
        s.on_failure(3, 4, FT.WorkerFailure("x"))


def test_straggler_detector():
    d = FT.StragglerDetector(threshold=2.0, policy="exclude")
    for i in range(10):
        assert d.observe(i, 1.0) is None
    ev = d.observe(10, 5.0)
    assert ev is not None and d.should_exclude(ev)
    assert d.observe(11, 1.0) is None


def test_training_loss_decreases():
    cfg = get_config(TINY, smoke=True)
    model = build_model(cfg)
    opt = ADAM.AdamWConfig(total_steps=30, warmup_steps=3, peak_lr=2e-3)

    class Fixed(D.SyntheticLM):          # one batch again and again
        def batch_at(self, step):
            return super().batch_at(0)

    res = LOOP.run_training(model, opt, Fixed(cfg, batch=4, seq=32),
                            LOOP.LoopConfig(total_steps=30,
                                            steps_per_unit=10, log_every=1),
                            device="cpu")
    losses = [m["loss"] for m in res.metrics_history]
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_carbon_aware_training_accounting():
    """A campaign crossing the bands: tracked energy is positive, carbon =
    factor x energy, peak units run at lower intensity than night
    units."""
    cfg = get_config(TINY, smoke=True)
    model = build_model(cfg)
    opt = ADAM.AdamWConfig(total_steps=24, warmup_steps=2)
    data = D.SyntheticLM(cfg, batch=2, seq=16)
    tracker = TR.RunTracker("e2e")
    ctrl = CTRL.CarinaController(
        policy=POL.PEAK_AWARE_BOOSTED, tracker=tracker, max_replicas=4,
        clock=CTRL.SimClock(start_hour=13.5, speedup=3.0e4),
        step_cost=EN.StepCost(flops=1e12, hbm_bytes=1e10, ici_bytes=1e8,
                              chips=4))
    LOOP.run_training(model, opt, data,
                      LOOP.LoopConfig(total_steps=24, steps_per_unit=3),
                      controller=ctrl, device="cpu")
    s = tracker.summary()
    assert s.units == 8
    assert s.energy_kwh > 0
    assert abs(s.co2_kg - 0.448 * s.energy_kwh) < 1e-9
    by_band = {r.phase: r.intensity for r in tracker.records}
    if "peak" in by_band and "night" in by_band:
        assert by_band["peak"] < by_band["night"]


def test_run_training_refuses_more_than_one_device():
    model = build_model(get_config(TINY, smoke=True))
    data = D.SyntheticLM(model.cfg, batch=2, seq=8)
    for kw in (dict(initial_replicas=2), dict(mesh_fn=lambda r: None)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            LOOP.run_training(model, ADAM.AdamWConfig(), data,
                              LOOP.LoopConfig(total_steps=1), device="cpu",
                              **kw)


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------
def test_train_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = LAUNCH.main(["--smoke", "--device", "cpu", "--steps", "4",
                       "--blocked-xent", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "done at step 4; restarts=0" in out
    assert "CARINA run dashboard" in out
    assert res.final_step == 4 and len(res.metrics_history) == 0
    rep = verify_unit_log(str(tmp_path / "experiments" / "train_run"
                              / "units.jsonl"))
    assert rep.ok and rep.n_units == 1, rep.errors


def test_train_cli_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LAUNCH.main(["--smoke", "--steps", "1"])
