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

Checkpoints hold the state in the JAX ``TrainState``'s layout and leaf keys
(:meth:`Trainer.state_leaves`, ``core/jax_state.py``, through the model
bundle's ``JaxLayout``), so either package restores the other's;
:meth:`Trainer.restore_from` is the one way back in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from easydl_tpu_torch.core import jax_state
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
      jax_layout: the model's parameters in the JAX package's tree (the
        bundle's ``jax_layout``); checkpoints need it.
    """

    def __init__(
        self,
        init_fn: Callable,
        loss_fn: Callable,
        optimizer: OptimizerFactory,
        config: TrainConfig,
        device="cuda",
        jax_layout: Optional[jax_state.JaxLayout] = None,
    ):
        self.config = config
        self.jax_layout = jax_layout
        self.device = require_device(device)
        self.init_fn = init_fn
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def init_state(self) -> TrainState:
        model = self.init_fn(self.config.seed, self.device)
        log.info("initialised state on %s (%d params)", self.device,
                 sum(p.numel() for p in model.parameters()))
        return TrainState(step=0, model=model, optimizer=self.optimizer(model.parameters()))

    def _layout(self) -> jax_state.JaxLayout:
        if self.jax_layout is None:
            raise NotImplementedError("checkpoints need the model's jax_layout "
                                      "(ModelBundle.jax_layout)")
        return self.jax_layout

    def state_leaves(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """``state`` as the JAX ``TrainState``'s checkpoint leaves (key ->
        tensor on the state's device); what ``CheckpointManager.save`` takes."""
        return jax_state.to_leaves(state.step, state.model, state.optimizer,
                                   self.config.seed, self._layout())

    def leaf_shapes(self, state: TrainState) -> jax_state.Template:
        """(shape, dtype) of each of :meth:`state_leaves`, allocating none."""
        return jax_state.leaf_shapes(state.model, self._layout())

    def restore_from(self, checkpoint, step: Optional[int] = None) -> TrainState:
        """A fresh state loaded from ``step`` (default: the latest) of a
        ``CheckpointManager``, saved by this package or by the JAX one from
        any mesh. The single entry for resuming: the runner, the evaluator
        and ``evaluator_main`` all come through here."""
        if step is None:
            step = checkpoint.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {checkpoint.directory}")
        state = self.init_state()
        leaves = checkpoint.restore(step, self.leaf_shapes(state))
        state.step = jax_state.load_leaves(leaves, state.model, state.optimizer,
                                           self.config.seed, self._layout())
        return state

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

    def build_eval_step(self, eval_fn: Callable):
        """``(state, host_batch) -> aux`` of ``eval_fn(module, batch) ->
        (loss, aux)``: no gradients, parameters cast to ``compute_dtype`` as
        in the train step."""

        def eval_step(state: TrainState, host_batch) -> Dict[str, torch.Tensor]:
            with torch.no_grad():
                _, aux = self._forward(_LossModule(state.model, eval_fn),
                                       self.to_device(host_batch))
            return aux

        return eval_step
