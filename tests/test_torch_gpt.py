"""The port's GPT against the JAX package's, from the same weights carried
over by ``easydl_tpu_torch/convert.py`` and the same ``SyntheticTokens``
batches: the conversion round trip is bit-exact; logits and loss match in
f32 (1e-4: the same f32 math, sums in another order); every parameter's
gradient matches (5e-4, the flash tests' gradient tolerance); with the
bf16 model dtype, logits, loss and every gradient match within bounds set
from the measured gap (see ``test_bf16_model_dtype_matches_jax``)."""

import collections
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from easydl_tpu.core.data import SyntheticTokens as JaxTokens  # noqa: E402
from easydl_tpu.models.registry import get_model as jax_get_model  # noqa: E402
from easydl_tpu.models.transformer import Transformer as JaxTransformer  # noqa: E402
from easydl_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from easydl_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from easydl_tpu_torch.core.data import SyntheticTokens  # noqa: E402
from easydl_tpu_torch.models.gpt import lm_loss  # noqa: E402
from easydl_tpu_torch.models.registry import get_model  # noqa: E402
from easydl_tpu_torch.models.transformer import SAVED_PRODUCTS  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

SEQ, VOCAB, BATCH = 64, 256, 4
N_HEADS = 4  # gpt "test": 2 layers, d_model 128, 4 heads


@functools.lru_cache(maxsize=1)
def _jax_params():
    bundle = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    params = flax.linen.meta.unbox(bundle.init_fn(jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, params)


def jax_params():
    return jax.tree.map(np.copy, _jax_params())


def jax_module(dtype):
    return JaxTransformer(JaxConfig(vocab=VOCAB, d_model=128, n_heads=4, n_layers=2,
                                    d_ff=512, max_seq=SEQ, dtype=dtype))


def torch_model(params, dtype="float32", attention_impl="auto"):
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB, dtype=dtype,
                       attention_impl=attention_impl)
    model = bundle.init_fn(0, "cpu")
    model.load_state_dict(params_from_jax(params))
    return bundle, model


def batch():
    return next(iter(SyntheticTokens(BATCH, seq_len=SEQ, vocab=VOCAB, seed=3)))


def test_synthetic_tokens_match_jax_stream():
    ours, theirs = iter(SyntheticTokens(4, 16, 100, seed=7)), iter(JaxTokens(4, 16, 100, seed=7))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(a[key], b[key])


def test_convert_round_trip_is_bit_exact():
    params = jax_params()
    back = params_to_jax(params_from_jax(params), n_heads=N_HEADS)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_state_dict_covers_every_parameter():
    _, model = torch_model(jax_params())
    n_jax = sum(x.size for x in jax.tree.leaves(jax_params()))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_logits_and_loss_match_jax_f32(attention_impl):
    params = jax_params()
    b = batch()
    logits_j = np.asarray(jax_module("float32").apply({"params": params}, jnp.asarray(b["inputs"])))
    bundle_j = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    loss_j, _ = bundle_j.loss_fn(params, b, None)

    bundle, model = torch_model(params, attention_impl=attention_impl)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    with torch.no_grad():
        logits_t = model(tb["inputs"])
        loss_t, aux = bundle.loss_fn(model, tb)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux["perplexity"]), float(np.exp(float(loss_j))), rtol=1e-4)


def test_lm_loss_ignores_minus_one_targets():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 7), dtype=np.float32)
    targets = rng.integers(0, 7, (2, 5)).astype(np.int32)
    targets[0, :3] = -1
    from easydl_tpu.models.gpt import lm_loss as jax_lm_loss

    want, want_denom = jax_lm_loss(jnp.asarray(logits), jnp.asarray(targets))
    got, denom = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(denom) == float(want_denom) == 7.0


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_every_gradient_matches_jax(attention_impl):
    params = jax_params()
    b = batch()
    bundle_j = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    grads_j = jax.grad(lambda p: bundle_j.loss_fn(p, b, None)[0])(
        jax.tree.map(jnp.asarray, params))

    bundle, model = torch_model(params, attention_impl=attention_impl)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    loss, _ = bundle.loss_fn(model, tb)
    loss.backward()
    grads_t = params_to_jax({n: p.grad for n, p in model.named_parameters()}, n_heads=N_HEADS)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads_t)[0])
    for path, gj in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        np.testing.assert_allclose(flat_t[path], np.asarray(gj), atol=5e-4, rtol=5e-4,
                                   err_msg=jax.tree_util.keystr(path))


def _bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _rel_norm(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
@pytest.mark.parametrize("emb_scale", [1.0, 8.0])
def test_bf16_model_dtype_matches_jax(attention_impl, emb_scale):
    """bf16 model dtype (what the 345M trainer runs) against JAX's bf16
    model: logits elementwise, the loss, and every parameter's gradient
    mapped back through ``convert.py``. The two frameworks round to bf16 at
    different places (XLA rounds inside fused elementwise chains such as
    GELU; PyTorch rounds once per op), so the bounds come from the measured
    gap, with about 2x margin:

    - logits: measured max |err| is 1 bf16 ulp of the largest logit (0.0078
      of max 1.66 at init; 0.125 of max 23.5 with the token embedding x8)
      and a relative L2 error of 0.0068 / 0.0032. Bound: 2 ulps of the
      largest logit elementwise and 1.5e-2 relative L2; the logits' std is
      0.24 / 2.2;
    - loss: measured |diff| 1.0e-4 at init, 1.0e-3 with the token embedding
      x8 (loss 19.4, far from ln(vocab) = 5.55). Bound: 2e-3;
    - gradients: measured max |err| at most 2.9% of the tensor's largest
      entry and relative L2 error at most 1.9% (``q.bias`` and ``v.bias``).
      Bound: 6% and 4%. The key bias has zero gradient in exact arithmetic
      (softmax ignores a per-row shift of the scores), so both sides are
      rounding noise (about 1e-6): bound 1e-5 absolute.
    """
    params = jax_params()
    params["tok_emb"]["embedding"] = params["tok_emb"]["embedding"] * np.float32(emb_scale)
    b = batch()
    bundle_j = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB, dtype="bfloat16")
    logits_j = np.asarray(jax_module("bfloat16").apply(
        {"params": params}, jnp.asarray(b["inputs"]))).astype(np.float32)
    loss_j = float(bundle_j.loss_fn(params, b, None)[0])
    grads_j = jax.grad(lambda p: bundle_j.loss_fn(p, b, None)[0])(
        jax.tree.map(jnp.asarray, params))

    bundle, model = torch_model(params, dtype="bfloat16", attention_impl=attention_impl)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    logits = model(tb["inputs"])
    assert logits.dtype == torch.bfloat16
    loss_t, _ = bundle.loss_fn(model, tb)
    loss_t.backward()

    logits_t = logits.detach().float().numpy()
    np.testing.assert_allclose(logits_t, logits_j, rtol=0,
                               atol=2 * _bf16_ulp(np.abs(logits_j).max()))
    assert _rel_norm(logits_t, logits_j) < 1.5e-2
    if emb_scale > 1:  # the loss says something only away from ln(vocab)
        assert abs(loss_j - np.log(VOCAB)) > 5.0
    assert abs(loss_t.item() - loss_j) < 2e-3, (loss_t.item(), loss_j)

    grads_t = params_to_jax({n: p.grad for n, p in model.named_parameters()}, n_heads=N_HEADS)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads_t)[0])
    for path, gj in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        name, gj, gt = jax.tree_util.keystr(path), np.asarray(gj), flat_t[path]
        if name == "['blocks']['k']['bias']":
            assert np.abs(gt).max() < 1e-5 and np.abs(gj).max() < 1e-5, name
            continue
        np.testing.assert_allclose(gt, gj, rtol=0, atol=6e-2 * np.abs(gj).max(), err_msg=name)
        assert _rel_norm(gt, gj) < 4e-2, name


@pytest.mark.parametrize("kwargs", [{"moe_experts": 8}, {"attention_fn": print},
                                    {"dropout": 0.1}, {"pipeline_fn": print}])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_model("gpt", size="test", **kwargs)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        get_model("gpt", size="test", remat=True, remat_policy="offload")


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products that run while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in SAVED_PRODUCTS:
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,attention_impl", [("full", "reference"), ("dots", "reference"),
                                                   ("dots", "flash")])
def test_remat_full_matches_plain_forward_and_grads(policy, attention_impl, monkeypatch):
    """Remat recomputes the same f32 ops: loss and every gradient equal to
    no remat exactly. "dots" recomputes no product: its backward runs the
    products of the backward without remat, no more. With the flash path
    (its plain versions on the CPU) the recompute runs
    ``FlashAttention.forward`` a second time for every block, as the JAX
    package reruns its forward ``pallas_call``."""
    from easydl_tpu_torch.ops import flash_attention as fa

    calls = []
    fwd = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd", lambda *a: calls.append(1) or fwd(*a))
    params = jax_params()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch().items()}
    results = []
    for remat in (False, True):
        bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB, remat=remat,
                           remat_policy=policy, attention_impl=attention_impl)
        model = bundle.init_fn(0, "cpu")
        model.load_state_dict(params_from_jax(params))
        calls.clear()
        loss, _ = bundle.loss_fn(model, tb)
        with _CountProducts() as products:
            loss.backward()
        if attention_impl == "flash":
            assert len(calls) == (2 if remat else 1) * model.cfg.n_layers
        results.append((loss.item(), [p.grad.clone() for p in model.parameters()],
                        products.counts))
    (loss_plain, grads_plain, products_plain), (loss_remat, grads_remat, products_remat) = results
    if policy == "dots":
        assert products_remat == products_plain
    else:
        assert products_remat["aten.addmm.default"] > products_plain["aten.addmm.default"] == 0
    assert loss_plain == loss_remat
    for a, b in zip(grads_plain, grads_remat):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("kwargs", [{"remat": True, "remat_policy": "dots"},
                                    {"fused_loss": True, "loss_chunk": 16}],
                         ids=["remat-dots", "fused-loss"])
def test_bundle_option_matches_jax(kwargs):
    """The JAX and the port's bundles of the same configuration, on the same
    converted weights: the loss within 1e-4 and every gradient within 5e-4
    (f32, as ``test_every_gradient_matches_jax``)."""
    params = jax_params()
    b = batch()
    bundle_j = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB, **kwargs)
    loss_j, grads_j = jax.value_and_grad(lambda p: bundle_j.loss_fn(p, b, None)[0])(
        jax.tree.map(jnp.asarray, params))

    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB, **kwargs)
    model = bundle.init_fn(0, "cpu")
    model.load_state_dict(params_from_jax(params))
    loss, _ = bundle.loss_fn(model, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-4, rtol=1e-4)
    grads_t = params_to_jax({n: p.grad for n, p in model.named_parameters()}, n_heads=N_HEADS)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads_t)[0])
    for path, gj in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        np.testing.assert_allclose(flat_t[path], np.asarray(gj), atol=5e-4, rtol=5e-4,
                                   err_msg=jax.tree_util.keystr(path))
