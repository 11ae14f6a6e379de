"""The GPT-2 345M training set-up that ``chip_smoke.py`` drives and the
scripts beside this module measure: one definition, so that every number
taken from it describes the same run.

Full width (24 layers, d_model 1024, 16 heads), seq 1024, vocab 50304, bf16
model dtype over f32 masters, AdamW(2e-4, weight decay 0.01), global batch
16 in 2 microbatches, ``STEPS`` steps on the bundle's synthetic data
(seed 0).
"""

from __future__ import annotations

import functools

import torch

from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
from easydl_tpu_torch.models.gpt import lm_loss
from easydl_tpu_torch.models.registry import ModelBundle, get_model

SEQ, VOCAB, GLOBAL_BATCH, MICROBATCHES = 1024, 50304, 16, 2
STEPS = 4  # chip_smoke.py: 1 warm-up + 3 timed


def bundle(dtype: str = "bfloat16", attention_impl: str = "auto") -> ModelBundle:
    return get_model("gpt", size="345m", seq_len=SEQ, vocab=VOCAB, dtype=dtype,
                     attention_impl=attention_impl)


def trainer(model: ModelBundle) -> Trainer:
    """The run's ``Trainer`` on the GPU for ``model`` (from :func:`bundle`)."""
    return Trainer(
        init_fn=model.init_fn, loss_fn=model.loss_fn,
        optimizer=functools.partial(torch.optim.AdamW, lr=2e-4, weight_decay=0.01),
        config=TrainConfig(global_batch=GLOBAL_BATCH, grad_accum=MICROBATCHES),
        device="cuda",
    )


def grads(model: torch.nn.Module, batch: dict) -> dict:
    """Every parameter's gradient (f32) of the LM loss over ``batch``, from
    one backward; leaves ``model`` without gradients."""
    model.zero_grad(set_to_none=True)
    lm_loss(model(batch["inputs"]), batch["targets"])[0].backward()
    out = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out
