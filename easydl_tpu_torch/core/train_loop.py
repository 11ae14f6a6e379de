"""One-device training core of the port.

Counterpart of ``easydl_tpu/core/train_loop.py`` on one device:

- parameters and optimizer state stay f32; before the loss, EVERY floating
  parameter is cast to ``compute_dtype`` (default bf16) with an explicit,
  differentiable cast, so the gradient lands on the f32 masters. This is the
  JAX ``cast_floating``; ``torch.autocast`` would leave some ops in f32 and
  round at other places;
- gradient accumulation averages loss, aux metrics and gradients over
  ``grad_accum`` microbatches (sums, then one scale by 1/accum);
- ``grad_norm`` is the global L2 norm of the averaged gradients.

The state is updated in place (PyTorch's idiom; the JAX step donates and
replaces it): :meth:`Trainer.train_step` returns the same ``TrainState``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from easydl_tpu_torch.utils.device import require_device
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("core", "trainer")

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


@dataclass
class TrainConfig:
    global_batch: int = 32
    grad_accum: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    seed: int = 0

    def __post_init__(self) -> None:
        if self.global_batch % max(self.grad_accum, 1):
            raise ValueError(
                f"global_batch={self.global_batch} not divisible by grad_accum={self.grad_accum}"
            )


@dataclass
class TrainState:
    step: int
    model: nn.Module  # holds the f32 master parameters
    optimizer: torch.optim.Optimizer


class _LossModule(nn.Module):
    """Puts ``loss_fn(model, batch)`` behind ``forward`` so that
    ``functional_call`` can run it on cast parameters."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


class Trainer:
    """Runs the training step on one device.

    Args:
      init_fn: ``(seed, device) -> nn.Module`` with f32 parameters.
      loss_fn: ``(module, batch) -> (loss, aux_metrics)``; the module runs on
        parameters cast to ``config.compute_dtype``.
      optimizer: ``parameters -> torch.optim.Optimizer``.
      device: where to train; "cuda" unless the caller asks for "cpu".
    """

    def __init__(
        self,
        init_fn: Callable,
        loss_fn: Callable,
        optimizer: OptimizerFactory,
        config: TrainConfig,
        device="cuda",
    ):
        self.config = config
        self.device = require_device(device)
        self.init_fn = init_fn
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def init_state(self) -> TrainState:
        model = self.init_fn(self.config.seed, self.device)
        log.info("initialised state on %s (%d params)", self.device,
                 sum(p.numel() for p in model.parameters()))
        return TrainState(step=0, model=model, optimizer=self.optimizer(model.parameters()))

    def to_device(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
                for k, v in host_batch.items()}

    def _forward(self, wrapped: _LossModule, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        dtype = self.config.compute_dtype
        cast = {name: p.to(dtype) if p.is_floating_point() else p
                for name, p in wrapped.named_parameters()}
        loss, aux = functional_call(wrapped, cast, (batch,))
        return loss.float(), aux

    def train_step(self, state: TrainState, host_batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = self.to_device(host_batch)
        accum = max(self.config.grad_accum, 1)
        micro = self.config.global_batch // accum
        wrapped = _LossModule(state.model, self.loss_fn)
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        aux_sum: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            loss, aux = self._forward(wrapped, mb)
            loss.backward()  # .grad accumulates the sum over microbatches
            loss_sum += loss.detach()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        scale = 1.0 / accum
        if accum > 1:
            torch._foreach_mul_(grads, scale)
        # multi-tensor ops: a few launches for all the gradients together
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        state.optimizer.step()
        state.step += 1
        metrics = {
            "loss": loss_sum * scale,
            "grad_norm": grad_norm,
            **{k: v * scale for k, v in aux_sum.items()},
        }
        return state, metrics
