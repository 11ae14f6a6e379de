"""BERT family on the shared transformer stack, in PyTorch: masked-LM
pretraining, BASELINE config 3 ("BERT-base pretraining, elastic DP with one
injected worker preemption").

Counterpart of ``easydl_tpu/models/bert.py``: the same sizes, defaults and
loss. The stack is the shared ``Transformer``, bidirectional
(``causal=False``) with the tied head, in f32: the JAX bundle sets no model
dtype, so every product runs in f32 even when the trainer casts the
parameters to bf16, and on the card attention takes the f32 flash kernels
(the backward's products in 3xTF32, at f32-level accuracy). TF32 would
round the model's f32 products, so on a CUDA tensor the loss refuses to run
while ``torch.backends.cuda.matmul.allow_tf32`` is set.

The mask is drawn inside the loss from the key the trainer passes
(:func:`mlm_mask`): ``jax.random.bernoulli(rng, mask_prob, tokens.shape)``
bit for bit (``core/prng.py``), so masking is fully deterministic given
(seed, step), and a replayed step draws the mask it drew before. On a mesh
each rank draws its rows of the global microbatch's mask.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from easydl_tpu_torch import convert
from easydl_tpu_torch.core.data import SyntheticTokens
from easydl_tpu_torch.core.jax_state import JaxLayout
from easydl_tpu_torch.core.mesh import batch_sum
from easydl_tpu_torch.core.prng import BatchKey
from easydl_tpu_torch.core.sharding import gpt_param_axes
from easydl_tpu_torch.models.registry import ModelBundle, register_model
from easydl_tpu_torch.models.transformer import Transformer, TransformerConfig
from easydl_tpu_torch.utils.device import require_device

#: name -> (n_layers, d_model, n_heads)
SIZES: Dict[str, Tuple[int, int, int]] = {
    "base": (12, 768, 12),
    "large": (24, 1024, 16),
    "test": (2, 128, 4),
}

MASK_ID = 0  # reserved [MASK] token id in the synthetic vocab


def mlm_mask(rng: BatchKey, tokens: torch.Tensor, mask_prob: float) -> torch.Tensor:
    """The positions to mask: the caller's rows of
    ``jax.random.bernoulli(rng.key, mask_prob, global shape)``, on the
    tokens' device."""
    return rng.bernoulli(mask_prob, tokens.shape, tokens.device)


@register_model("bert")
def make_bert(
    size: str = "base",
    seq_len: int = 512,
    vocab: int = 30720,  # 30522 padded up to a multiple of 128
    mask_prob: float = 0.15,
    remat: bool = False,
    remat_policy: str = "full",
    attention_impl: str = "auto",
    attention_fn=None,
    pipeline_fn=None,
    pipeline_stages: int = 0,
) -> ModelBundle:
    for name, value in (("attention_fn", attention_fn), ("pipeline_fn", pipeline_fn),
                        ("pipeline_stages", pipeline_stages)):
        if value:
            raise NotImplementedError(f"bert {name}={value!r} is not ported yet")
    n_layers, d_model, n_heads = SIZES[size]
    cfg = TransformerConfig(
        vocab=vocab,
        d_model=d_model,
        n_heads=n_heads,
        n_layers=n_layers,
        d_ff=4 * d_model,
        max_seq=seq_len,
        causal=False,
        remat=remat,
        remat_policy=remat_policy,
        attention_impl=attention_impl,
    )

    def init_fn(seed: int = 0, device="cuda") -> Transformer:
        dev = require_device(device)
        with dev:
            model = Transformer(cfg)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        return model

    def loss_fn(model, batch, rng: BatchKey):
        """Cross-entropy against the unmasked tokens at the masked positions,
        divided by ``max(#masked, 1)``; both sums, and the accuracy's, over
        every rank's rows (``core.mesh.batch_sum``)."""
        tokens = batch["inputs"]
        if tokens.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("BERT's products are f32, as in the JAX package: "
                               "torch.backends.cuda.matmul.allow_tf32 must stay False")
        mask = mlm_mask(rng, tokens, mask_prob)
        logits = model(torch.where(mask, MASK_ID, tokens)).float()
        losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 tokens.reshape(-1).long(), reduction="none").view_as(mask)
        hits = (logits.argmax(-1) == tokens) & mask
        total, count, correct = batch_sum(torch.where(mask, losses, 0.0).sum(),
                                          mask.sum().float(), hits.sum().float())
        denom = count.clamp_min(1.0)
        return total / denom, {"mlm_accuracy": correct / denom}

    def make_data(global_batch: int, seed: int = 0):
        return SyntheticTokens(global_batch, seq_len=seq_len, vocab=vocab, seed=seed)

    return ModelBundle(
        name=f"bert-{size}",
        init_fn=init_fn,
        loss_fn=loss_fn,
        make_data=make_data,
        eval_fn=loss_fn,
        jax_layout=JaxLayout(to_jax=functools.partial(convert.to_jax_tree, n_heads=n_heads),
                             from_jax=convert.from_jax_tree),
        param_axes=gpt_param_axes,
        param_count_hint=cfg.param_count,
        # as the JAX bundle: no MFU numerator, so the worker writes no mfu
        flops_per_sample_hint=0.0,
    )
