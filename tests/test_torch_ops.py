"""The port's `kernels.ops.decode_attention` (K6) and `ops.ssm_scan` (K7)
held against the JAX package on the CPU, where both run their plain
versions:

* against the reference's Pallas kernels in interpret mode, run as
  tests/test_kernels.py runs them, and against their oracles
  `kernels/ref.py::decode_attention_ref` / `ssm_scan_ref`, on the
  reference's own shapes in fp32 and bf16: K6 at that file's `_tol`
  (fp32 2e-5, bf16 2e-2), K7 within 1e-5 of max |h|;
* K6's edge semantics, where the reference's kernel and oracle disagree:
  `length` 0 gives the kernel's zeros, `length` > Sk the oracle's answer
  (the kernel attends to its own zero padding there), and a one-element
  int32 tensor `length` the same result as the int;
* the entry points' argument checks.

Inputs are drawn with numpy and handed to both packages (bf16 rounded
from the same fp32 values on both sides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS  # noqa: E402
from repro.kernels import ref as KREF  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as pallas_scan  # noqa: E402

from repro_torch.kernels import decode_attention as k6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as k7  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SCAN_BAR = 1e-5             # of max |h|, and never above the reference's 1e-3
DECODE_CASES = [            # tests/test_kernels.py::test_decode_attention
    (2, 8, 2, 1024, 700, 4),
    (1, 4, 4, 512, 512, 2),
    (2, 16, 1, 2048, 100, 8),       # MQA, mostly masked
    (1, 8, 2, 300, 77, 3),          # non-divisible
]
SCAN_CASES = [              # tests/test_kernels.py::test_ssm_scan
    (2, 256, 512, 64, 256),
    (1, 100, 300, 32, 128),         # non-divisible both dims
    (2, 64, 64, 64, 64),            # single chunk/block
]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _pair(a, dtype):
    """One fp32 numpy array as the reference's array and the port's
    tensor, both in `dtype`."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _decode_inputs(b, h, hkv, sk, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, 64), (b, sk, hkv, 64), (b, sk, hkv, 64))
    return zip(*(_pair(rng.normal(size=s).astype(np.float32), dtype)
                 for s in shapes))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,sk,length,ns", DECODE_CASES)
def test_decode_attention_matches_pallas_and_oracle(b, h, hkv, sk, length,
                                                    ns, dtype):
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(b, h, hkv, sk, dtype, sk)
    kernel = pallas_decode(jq, jk, jv, length, nsplit=ns, interpret=True)
    oracle = KREF.decode_attention_ref(jq, jk, jv, length)
    got = ops.decode_attention(tq, tk, tv, length)
    assert got.dtype == tq.dtype and got.shape == (b, h, 64)
    for ref in (kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])
    # the reference's entry point, through its Pallas kernel at its defaults
    np.testing.assert_allclose(
        _np(got), _np(ROPS.decode_attention(jq, jk, jv, length,
                                            interpret=True)), **TOL[dtype])
    split = k6.decode_attention(tq, tk, tv, length, nsplit=ns)
    np.testing.assert_allclose(_np(split), _np(kernel), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,sk,length,ns", DECODE_CASES)
def test_decode_attention_edges_are_pinned(b, h, hkv, sk, length, ns,
                                           dtype):
    """length 0: the Pallas kernel's zeros (the oracle's uniform mean of v
    differs); length > Sk: the oracle's answer; a tensor length: the
    int's result, bit for bit."""
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(b, h, hkv, sk, dtype,
                                                sk + 1)
    zero = ops.decode_attention(tq, tk, tv, 0)
    kernel0 = pallas_decode(jq, jk, jv, 0, nsplit=ns, interpret=True)
    assert not bool(zero.any()) and not np.asarray(kernel0, np.float32).any()
    assert np.abs(_np(KREF.decode_attention_ref(jq, jk, jv, 0))).max() > 0
    for over in (sk + 1, sk + 100):
        got = ops.decode_attention(tq, tk, tv, over)
        np.testing.assert_allclose(
            _np(got), _np(KREF.decode_attention_ref(jq, jk, jv, over)),
            **TOL[dtype])
        assert torch.equal(got, ops.decode_attention(tq, tk, tv, sk))
    for n in (0, length, sk + 100):
        as_tensor = torch.tensor([n], dtype=torch.int32)
        assert torch.equal(ops.decode_attention(tq, tk, tv, as_tensor),
                           ops.decode_attention(tq, tk, tv, n))


def test_decode_attention_past_sk_differs_from_the_pallas_kernel():
    """The reference's kernel reads its zero padding past Sk (here Sk 300
    padded to 2 splits of 256): the port keeps the oracle's answer, which
    is a different number by design (ROADMAP Queue 3)."""
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(1, 8, 2, 300, "float32", 7)
    got = ops.decode_attention(tq, tk, tv, 400)
    kernel = pallas_decode(jq, jk, jv, 400, nsplit=3, interpret=True)
    oracle = KREF.decode_attention_ref(jq, jk, jv, 400)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL["float32"])
    assert np.abs(_np(got) - _np(kernel)).max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,C,ch,bc", SCAN_CASES)
def test_ssm_scan_matches_pallas_and_oracle(B, T, C, ch, bc, dtype):
    rng = np.random.default_rng(T + C)
    ja, ta = _pair(rng.uniform(0.5, 1.0, (B, T, C)).astype(np.float32), dtype)
    jb, tb = _pair((rng.normal(size=(B, T, C)) * 0.1).astype(np.float32),
                   dtype)
    hs, hf = ops.ssm_scan(ta, tb)
    assert hs.dtype == hf.dtype == torch.float32
    assert hs.shape == (B, T, C) and hf.shape == (B, C)
    for rhs, rhf in (pallas_scan(ja, jb, chunk=ch, block_c=bc,
                                 interpret=True),
                     KREF.ssm_scan_ref(ja, jb),
                     ROPS.ssm_scan(ja, jb, interpret=True)):
        bar = min(SCAN_BAR * np.abs(_np(rhs)).max(), 1e-3)
        assert np.abs(_np(hs) - _np(rhs)).max() <= bar
        assert np.abs(_np(hf) - _np(rhf)).max() <= bar


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,C,ch,bc", SCAN_CASES)
def test_ssm_scan_chunk_decomposition_matches_pallas_and_oracle(B, T, C, ch,
                                                                bc, dtype):
    """The CUDA kernel's chunk decomposition (`ssm_scan_chunked_plain`, at
    the chunks `scan_plan` gives on a 132-SM card) against the reference's
    Pallas kernel (interpret) and oracle, under the same bar."""
    rng = np.random.default_rng(T + C)
    ja, ta = _pair(rng.uniform(0.5, 1.0, (B, T, C)).astype(np.float32), dtype)
    jb, tb = _pair((rng.normal(size=(B, T, C)) * 0.1).astype(np.float32),
                   dtype)
    chunks, steps = k7.scan_plan(B, T, C, 132)
    assert chunks > 1
    hs, hf = k7.ssm_scan_chunked_plain(ta, tb, steps)
    for rhs, rhf in (pallas_scan(ja, jb, chunk=ch, block_c=bc,
                                 interpret=True),
                     KREF.ssm_scan_ref(ja, jb)):
        bar = min(SCAN_BAR * np.abs(_np(rhs)).max(), 1e-3)
        assert np.abs(_np(hs) - _np(rhs)).max() <= bar
        assert np.abs(_np(hf) - _np(rhf)).max() <= bar


def test_entry_points_check_their_arguments():
    (_, _, _), (q, k, v) = _decode_inputs(1, 4, 2, 16, "float32", 0)
    before = (k6.launches, k7.launches)
    with pytest.raises(TypeError, match="length"):
        ops.decode_attention(q, k, v, 3.5)
    with pytest.raises(TypeError):
        ops.decode_attention(q, k.bfloat16(), v.bfloat16(), 3)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :3], k, v, 3)
    a = torch.ones(1, 4, 3)
    with pytest.raises(ValueError):
        ops.ssm_scan(a, a[:, :2])
    with pytest.raises(TypeError):
        ops.ssm_scan(a, a.double())
    ops.decode_attention(q, k, v, 3)
    ops.ssm_scan(a, a)
    assert (k6.launches, k7.launches) == before          # CPU: no launch
