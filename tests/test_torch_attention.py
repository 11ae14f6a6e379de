"""The port's reference attention and ``multihead_attention`` against the JAX
package's ``_reference_attention``, on the same seeded numpy inputs: causal
and bidirectional, rectangular, dead rows (s_q > s_k), segment masks, bf16.

Tolerances: 2e-5 in f32 (the same algorithm in f32 on both sides; only the
order of sums differs), 2e-2 in bf16 (the JAX flash tests' own)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from easydl_tpu.ops.attention import _reference_attention  # noqa: E402
from easydl_tpu_torch.ops.attention import multihead_attention, reference_attention  # noqa: E402


def qkv(seed, b=2, s_q=128, s_k=None, h=4, d=32):
    rng = np.random.default_rng(seed)
    s_k = s_k or s_q
    return (rng.standard_normal((b, s_q, h, d), dtype=np.float32),
            rng.standard_normal((b, s_k, h, d), dtype=np.float32),
            rng.standard_normal((b, s_k, h, d), dtype=np.float32))


def jax_ref(q, k, v, causal, segment_ids=None, dtype=jnp.float32):
    out = _reference_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
        scale=q.shape[-1] ** -0.5,
        segment_ids=None if segment_ids is None else jnp.asarray(segment_ids))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_k", [(128, 128), (32, 64), (64, 32)])
def test_reference_matches_jax(causal, s_q, s_k):
    q, k, v = qkv(0, s_q=s_q, s_k=s_k)
    want = jax_ref(q, k, v, causal)
    got = reference_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              scale=q.shape[-1] ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    if causal and s_q > s_k:  # dead rows: zero output, not the mean of V
        np.testing.assert_array_equal(got[:, :s_q - s_k].numpy(), 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_match_jax(causal):
    q, k, v = qkv(1, s_q=64)
    seg = np.repeat(np.array([[0, 1, 2, 3], [0, 0, 1, 1]], np.int32), 16, axis=1)
    want = jax_ref(q, k, v, causal, segment_ids=seg)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for impl in ("reference", "flash", "auto"):  # flash hands segments to the reference
        got = multihead_attention(*t, causal=causal, impl=impl,
                                  segment_ids=torch.from_numpy(seg))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=impl)


@pytest.mark.parametrize("impl", ["auto", "reference", "flash"])
def test_multihead_attention_impls_match_jax(impl):
    q, k, v = qkv(2, s_q=64, s_k=96)
    want = jax_ref(q, k, v, True)
    got = multihead_attention(*map(torch.from_numpy, (q, k, v)), causal=True, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_bf16_matches_jax():
    q, k, v = qkv(3, s_q=64)
    want = jax_ref(q, k, v, True, dtype=jnp.bfloat16)
    got = reference_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                              causal=True, scale=q.shape[-1] ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_unknown_impl_raises():
    q, k, v = (torch.from_numpy(x) for x in qkv(4, s_q=8))
    with pytest.raises(ValueError, match="impl"):
        multihead_attention(q, k, v, impl="cudnn")
