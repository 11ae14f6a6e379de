"""The port's chunked cross-entropy (``easydl_tpu_torch/ops/fused_xent.py``)
against the JAX package's ``fused_softmax_xent`` on the same seeded inputs,
in the six cases of ``tests/test_fused_xent.py`` (f32 and bf16; a sequence
that divides into chunks, one padded to the chunk, one shorter than the
chunk): the loss and both gradients.

Both take the head product's f32 sums, which the bf16 cases must show: a
port whose product rounded the logits to bf16 reads 1.2e-5 to 3.0e-5
relative on the loss and 2.1e-3 to 3.8e-3 relative L2 on the gradients
against JAX, where the sound port reads at most 1.0e-7 and 2.1e-4 (one
bf16 rounding that falls the other way). Tolerances: the loss within 2e-6
relative in both dtypes; the gradients within 1e-5 elementwise in f32 (the
same f32 sums in another order) and within 6e-4 in relative L2 in bf16,
between the sound and the rounded readings. Also: an all-masked batch stays
finite, and the GPT bundle's ``fused_loss`` agrees with its logits path."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from easydl_tpu.ops.fused_xent import fused_softmax_xent as jax_fused_xent  # noqa: E402
from easydl_tpu_torch.convert import params_from_jax  # noqa: E402
from easydl_tpu_torch.models.registry import get_model  # noqa: E402
from easydl_tpu_torch.ops.fused_xent import fused_softmax_xent  # noqa: E402

B, D, V = 4, 32, 96
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(dtype, seq):
    rng = np.random.RandomState(0)
    hidden = rng.randn(B, seq, D).astype(np.float32)
    head = (rng.randn(V, D) * 0.1).astype(np.float32)
    targets = rng.randint(0, V, (B, seq)).astype(np.int32)
    targets[:, :3] = -1
    # round to the dtype once, on the JAX side, and hand both the same values
    hidden_j, head_j = jnp.asarray(hidden, dtype), jnp.asarray(head, dtype)
    as_torch = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(  # noqa: E731
        TORCH_DTYPE[dtype]).requires_grad_()
    return (hidden_j, head_j, jnp.asarray(targets)), (
        as_torch(hidden_j), as_torch(head_j), torch.from_numpy(targets))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,chunk", [(64, 16), (60, 16), (8, 128)],
                         ids=["even", "ragged-pad", "chunk>seq"])
def test_matches_jax_loss_and_grads(dtype, seq, chunk):
    (h_j, w_j, t_j), (h_t, w_t, t_t) = _inputs(dtype, seq)
    loss_j, denom_j = jax_fused_xent(h_j, w_j, t_j, chunk_size=chunk)
    g_j = jax.grad(lambda h, w: jax_fused_xent(h, w, t_j, chunk_size=chunk)[0],
                   argnums=(0, 1))(h_j, w_j)

    loss_t, denom_t = fused_softmax_xent(h_t, w_t, t_t, chunk_size=chunk)
    loss_t.backward()
    assert loss_t.dtype == torch.float32
    assert float(denom_t) == float(denom_j) == B * (seq - 3)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-6)
    for got, want in zip((h_t.grad, w_t.grad), g_j):
        assert got.dtype == TORCH_DTYPE[dtype]
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.linalg.norm(got - want) <= 6e-4 * np.linalg.norm(want)


def test_all_masked_is_finite():
    hidden = torch.ones(2, 8, 16, requires_grad=True)
    head = torch.ones(32, 16)
    targets = torch.full((2, 8), -1, dtype=torch.int32)
    loss, denom = fused_softmax_xent(hidden, head, targets, chunk_size=4)
    loss.backward()
    assert loss.item() == 0.0 and float(denom) == 1.0
    assert torch.equal(hidden.grad, torch.zeros_like(hidden))


def test_gpt_bundle_fused_matches_logits_path():
    """The fused-loss bundle and the logits bundle on the same weights: the
    loss within 1e-6 relative and every gradient within 1e-4 relative /
    1e-6 absolute, the bounds of the JAX package's own test."""
    import flax

    from easydl_tpu.models.registry import get_model as jax_get_model

    kw = dict(size="test", seq_len=64, vocab=256)
    params = flax.linen.meta.unbox(jax_get_model("gpt", **kw).init_fn(jax.random.PRNGKey(0)))
    weights = params_from_jax(jax.tree.map(np.asarray, params))
    results = []
    for fused in (True, False):
        bundle = get_model("gpt", fused_loss=fused, loss_chunk=16, **kw)
        model = bundle.init_fn(0, "cpu")
        model.load_state_dict(weights)
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in next(iter(bundle.make_data(4, seed=3))).items()}
        loss, aux = bundle.loss_fn(model, batch)
        loss.backward()
        results.append((loss.item(), aux["perplexity"].item(),
                        {n: p.grad for n, p in model.named_parameters()}))
    (lf, pf, gf), (lp, pp, gp) = results
    np.testing.assert_allclose(lf, lp, rtol=1e-6)
    np.testing.assert_allclose(pf, pp, rtol=1e-6)
    for name in gp:
        torch.testing.assert_close(gf[name], gp[name], rtol=1e-4, atol=1e-6, msg=name)
