"""The GPT-2 345M training set-up that ``chip_smoke.py`` drives and the
scripts beside this module measure: one definition, so that every number
taken from it describes the same run.

Full width (24 layers, d_model 1024, 16 heads), seq 1024, vocab 50304, bf16
model dtype over f32 masters, AdamW(2e-4, weight decay 0.01), global batch
16 in 2 microbatches, ``STEPS`` steps on the bundle's synthetic data
(seed 0). :data:`BENCH` adds ``bench.py``'s model options.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
from easydl_tpu_torch.models.gpt import lm_loss
from easydl_tpu_torch.models.registry import ModelBundle, get_model
from easydl_tpu_torch.ops.fused_xent import fused_softmax_xent

SEQ, VOCAB, GLOBAL_BATCH, MICROBATCHES = 1024, 50304, 16, 2
STEPS = 4  # chip_smoke.py: 1 warm-up + 3 timed
#: bench.py's model options beside the set-up above (its b256/a32 batch is
#: cut to this file's b16/a2): remat of every block under the "dots" policy
BENCH = {"remat": True, "remat_policy": "dots"}


def bundle(dtype: str = "bfloat16", attention_impl: str = "auto", **options) -> ModelBundle:
    """The 345M bundle; ``options`` go to the GPT factory (``remat``,
    ``remat_policy``, ``fused_loss``, ...)."""
    return get_model("gpt", size="345m", seq_len=SEQ, vocab=VOCAB, dtype=dtype,
                     attention_impl=attention_impl, **options)


def trainer(model: ModelBundle) -> Trainer:
    """The run's ``Trainer`` on the GPU for ``model`` (from :func:`bundle`)."""
    return Trainer(
        init_fn=model.init_fn, loss_fn=model.loss_fn,
        optimizer=functools.partial(torch.optim.AdamW, lr=2e-4, weight_decay=0.01),
        config=TrainConfig(global_batch=GLOBAL_BATCH, grad_accum=MICROBATCHES),
        device="cuda",
        jax_layout=model.jax_layout,
    )


def logits_loss(model: torch.nn.Module, batch: dict):
    """The LM loss through the full logits: the bundle's loss without
    ``fused_loss``, as ``(loss, denom)``."""
    return lm_loss(model(batch["inputs"]), batch["targets"])


def f32_head_loss(model: torch.nn.Module, batch: dict):
    """The LM loss through the full logits, with the tied head's product
    taken in f32 on the compute-dtype hidden states and head: the f32 sums
    that ``fused_loss`` keeps, where the logits path rounds them to the
    compute dtype. The reference for ``fused_loss``."""
    hidden = model(batch["inputs"], return_hidden=True)
    head = model.tok_emb.weight.to(hidden.dtype)
    return lm_loss(F.linear(hidden.float(), head.float()), batch["targets"])


#: ``(hidden, head, targets) -> loss`` on the compute-dtype hidden states and
#: tied head: the chunked loss, the f32-head reference, the logits path
HEAD_LOSSES = {
    "fused": lambda h, w, t: fused_softmax_xent(h, w, t)[0],
    "f32 head": lambda h, w, t: lm_loss(F.linear(h.float(), w.float()), t)[0],
    "logits": lambda h, w, t: lm_loss(F.linear(h, w), t)[0],
}


def head_loss_grads(model: torch.nn.Module, batch: dict, head_loss) -> tuple:
    """``(loss, {"hidden": ..., "head": ...})``: ``head_loss`` (one of
    :data:`HEAD_LOSSES`) and its f32 gradients with respect to the model's
    hidden states and its tied head in the compute dtype, taken as leaves:
    the loss function's own gradients, before the model's backward adds
    its rounding."""
    with torch.no_grad():
        hidden = model(batch["inputs"], return_hidden=True)
    hidden.requires_grad_()
    head = model.tok_emb.weight.detach().to(hidden.dtype).requires_grad_()
    loss = head_loss(hidden, head, batch["targets"])
    loss.backward()
    return loss.item(), {"hidden": hidden.grad.float(), "head": head.grad.float()}


def grads(model: torch.nn.Module, batch: dict, loss_fn=logits_loss) -> dict:
    """Every parameter's gradient (f32) of ``loss_fn(model, batch)[0]`` (by
    default the logits path's LM loss) from one backward; leaves ``model``
    without gradients."""
    model.zero_grad(set_to_none=True)
    loss_fn(model, batch)[0].backward()
    out = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out
