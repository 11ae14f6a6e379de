"""The port's flash attention on the CPU — the plain versions of the three
CUDA kernels behind the ``torch.autograd.Function`` — against the JAX
package's Pallas kernels in interpret mode and ``jax.grad``, for every case
of ``tests/test_flash_attention.py`` at its tolerances (2e-5 forward in f32,
5e-4 gradients, 2e-2 bf16). A CPU call launches no CUDA kernel, so the
launch counters stay at 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from easydl_tpu.ops import flash_attention as jfa  # noqa: E402
from easydl_tpu_torch.ops import flash_attention as tfa  # noqa: E402


def qkv(seed, b=2, s_q=128, s_k=None, h=4, d=32):
    rng = np.random.default_rng(seed)
    s_k = s_k or s_q
    return (rng.standard_normal((b, s_q, h, d), dtype=np.float32),
            rng.standard_normal((b, s_k, h, d), dtype=np.float32),
            rng.standard_normal((b, s_k, h, d), dtype=np.float32))


def jax_flash(q, k, v, causal, block_q, block_k, dtype=jnp.float32):
    return jfa.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
                               block_q=block_q, block_k=block_k, interpret=True)


def jax_grads(q, k, v, causal, block_q, block_k):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, interpret=True)
        return (o * jnp.cos(o)).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def torch_grads(q, k, v, causal):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*t, causal=causal)
    (o * torch.cos(o)).sum().backward()
    return [x.grad.numpy() for x in t]


@pytest.fixture(autouse=True)
def no_launches():
    tfa.reset_launches()
    yield
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [32, 64, 128])
def test_forward_matches_jax_kernel(causal, block):
    q, k, v = qkv(0)
    want = np.asarray(jax_flash(q, k, v, causal, block, block))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_k", [(64, 64), (64, 32)])
def test_lse_matches_jax_kernel(causal, s_q, s_k):
    """(O, lse) of the plain forward against the Pallas ``_fwd`` on the
    [bh, s, d] view, dead rows' +|f32.min| lse included."""
    q, k, v = (x[0].transpose(1, 0, 2).copy() for x in qkv(5, s_q=s_q, s_k=s_k))
    scale = q.shape[-1] ** -0.5
    o_j, lse_j = jfa._fwd(*map(jnp.asarray, (q, k, v)), causal=causal, scale=scale,
                          block_q=32, block_k=32, interpret=True)
    o_t, lse_t = tfa.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal, scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_kernel(causal):
    q, k, v = qkv(1, b=1, s_q=64, h=2, d=16)
    want = jax_grads(q, k, v, causal, 32, 32)
    for g, w, name in zip(torch_grads(q, k, v, causal), want, "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=f"d{name}")


def test_uneven_blocks_and_rectangular():
    q, k, v = qkv(2, s_q=96, d=64)
    want = np.asarray(jax_flash(q, k, v, True, 96, 96))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_causal_cross_length_bottom_right_aligned():
    q, k, v = qkv(4, s_q=32, s_k=64, h=2)
    want = np.asarray(jax_flash(q, k, v, True, 16, 16))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    want_g = jax_grads(q, k, v, True, 16, 16)
    for g, w, name in zip(torch_grads(q, k, v, True), want_g, "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=f"d{name}")


def test_causal_cross_length_sq_gt_sk_dead_rows():
    q, k, v = qkv(6, s_q=64, s_k=32, h=2, d=16)
    n_dead = 64 - 32
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    np.testing.assert_array_equal(got[:, :n_dead], 0.0)
    for bq in (16, 32):
        want = np.asarray(jax_flash(q, k, v, True, bq, 16))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"bq={bq}")
    grads = torch_grads(q, k, v, True)
    np.testing.assert_array_equal(grads[0][:, :n_dead], 0.0)
    for g, w, name in zip(grads, jax_grads(q, k, v, True, 32, 16), "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=f"d{name}")


def test_untileable_length_needs_no_fallback():
    """72 has no block divisor for the Pallas kernel (JAX falls back to its
    reference); the port's kernels mask ragged tails, so it runs as is."""
    q, k, v = qkv(5, s_q=72, d=16)
    want = np.asarray(jax_flash(q, k, v, True, 48, 48))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_bf16_inputs():
    q, k, v = qkv(3, s_q=64)
    want = np.asarray(jax_flash(q, k, v, True, 32, 32, dtype=jnp.bfloat16), np.float32)
    got = tfa.flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_kernel_wrappers_reject_mixed_devices():
    q = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_fwd(q, q.to("meta"), q, True, 1.0)
