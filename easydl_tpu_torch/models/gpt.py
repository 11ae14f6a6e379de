"""GPT family on the shared transformer stack, in PyTorch.

Counterpart of ``easydl_tpu/models/gpt.py``: the same sizes, the same loss,
the same synthetic token stream. "345m" (GPT-2 medium: 24 layers,
d_model 1024, 16 heads) is the flagship configuration.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from easydl_tpu_torch import convert
from easydl_tpu_torch.core.data import SyntheticTokens
from easydl_tpu_torch.core.jax_state import JaxLayout
from easydl_tpu_torch.core.mesh import batch_sum
from easydl_tpu_torch.core.mfu import model_flops_per_token
from easydl_tpu_torch.core.sharding import gpt_param_axes
from easydl_tpu_torch.models.registry import ModelBundle, register_model
from easydl_tpu_torch.models.transformer import Transformer, TransformerConfig
from easydl_tpu_torch.ops.fused_xent import fused_softmax_xent
from easydl_tpu_torch.ops.vocab_parallel import cross_entropy
from easydl_tpu_torch.utils.device import require_device

#: name -> (n_layers, d_model, n_heads)
SIZES: Dict[str, Tuple[int, int, int]] = {
    "124m": (12, 768, 12),
    "345m": (24, 1024, 16),
    "762m": (36, 1280, 20),
    "1558m": (48, 1600, 25),
    # tiny size for tests and dry runs
    "test": (2, 128, 4),
}


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, ignore_id: int = -1):
    """Mean next-token cross-entropy over targets != ``ignore_id``, in f32;
    over every rank's rows while the trainer holds a batch group
    (``core.mesh.batch_sum``). Logits split on the vocab over ``tp`` (a
    ``DTensor``) reduce over the ``tp`` group (``ops/vocab_parallel.py``)."""
    mask = (targets != ignore_id).float()
    losses = cross_entropy(logits, targets.clamp_min(0))
    total, count = batch_sum((losses * mask).sum(), mask.sum())
    denom = count.clamp_min(1.0)
    return total / denom, denom


@register_model("gpt")
def make_gpt(
    size: str = "345m",
    seq_len: int = 1024,
    vocab: int = 50304,
    remat: bool = False,
    remat_policy: str = "full",
    attention_impl: str = "auto",
    dtype: str = "float32",
    dropout: float = 0.0,
    moe_experts: int = 0,
    fused_loss: bool = False,
    loss_chunk: int = 128,
    attention_fn=None,
    pipeline_fn=None,
) -> ModelBundle:
    for name, value in (("dropout", dropout), ("moe_experts", moe_experts),
                        ("attention_fn", attention_fn), ("pipeline_fn", pipeline_fn)):
        if value:
            raise NotImplementedError(f"gpt {name}={value!r} is not ported yet")
    n_layers, d_model, n_heads = SIZES[size]
    cfg = TransformerConfig(
        vocab=vocab,
        d_model=d_model,
        n_heads=n_heads,
        n_layers=n_layers,
        d_ff=4 * d_model,
        max_seq=seq_len,
        causal=True,
        remat=remat,
        remat_policy=remat_policy,
        attention_impl=attention_impl,
        dtype=dtype,
    )

    def init_fn(seed: int = 0, device="cuda") -> Transformer:
        dev = require_device(device)
        with dev:
            model = Transformer(cfg)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        return model

    def loss_fn(model, batch, rng=None):
        """The LM loss, through the chunked tied head (``fused_loss``: the
        ``[B, S, V]`` logits never exist) or the full logits. GPT draws
        nothing: the trainer's key ``rng`` goes unused."""
        if fused_loss:
            hidden = model(batch["inputs"], return_hidden=True)
            # the stored-f32 head in the compute dtype, as on the logits path
            head = model.tok_emb.weight.to(hidden.dtype)
            loss, _ = fused_softmax_xent(hidden, head, batch["targets"], chunk_size=loss_chunk)
        else:
            loss, _ = lm_loss(model(batch["inputs"]), batch["targets"])
        return loss, {"perplexity": torch.exp(loss)}

    def make_data(global_batch: int, seed: int = 0):
        return SyntheticTokens(global_batch, seq_len=seq_len, vocab=vocab, seed=seed)

    return ModelBundle(
        name=f"gpt-{size}",
        init_fn=init_fn,
        loss_fn=loss_fn,
        make_data=make_data,
        # dense GPT: evaluation is the training loss
        eval_fn=loss_fn,
        jax_layout=JaxLayout(to_jax=functools.partial(convert.to_jax_tree, n_heads=n_heads,
                                                     head_dim=cfg.head_dim),
                             from_jax=convert.from_jax_tree),
        param_axes=gpt_param_axes,
        param_count_hint=cfg.param_count,
        flops_per_sample_hint=model_flops_per_token(
            cfg.param_count, n_layers, d_model, seq_len) * seq_len,
    )
