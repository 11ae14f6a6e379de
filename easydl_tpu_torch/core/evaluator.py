"""Checkpoint-following evaluator.

Counterpart of ``easydl_tpu/core/evaluator.py``. The evaluator never joins
training: it follows the checkpoint directory, restores each newly committed
step through ``Trainer.restore_from`` and averages the model's eval function
over held-out batches. The held-out loss is in every result.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterator, Optional

from easydl_tpu_torch.core.checkpoint import CheckpointManager
from easydl_tpu_torch.core.train_loop import Trainer
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("core", "evaluator")


class Evaluator:
    """Evaluates every new checkpoint step.

    Args:
      trainer: a Trainer built with the same model and optimizer as the
        training run (it rebuilds the state a checkpoint restores into); its
        train step is never used here.
      checkpoint: manager over the training run's checkpoint directory.
      data: iterator of held-out host batches.
      eval_fn: ``(module, batch) -> (loss, aux)``; default the trainer's loss.
      batches_per_eval: batches averaged per checkpoint.
      on_result: called with each result.
    """

    def __init__(
        self,
        trainer: Trainer,
        checkpoint: CheckpointManager,
        data: Iterator[Any],
        eval_fn: Optional[Callable] = None,
        batches_per_eval: int = 8,
        on_result: Optional[Callable[[Dict[str, float]], None]] = None,
    ):
        self.trainer = trainer
        self.checkpoint = checkpoint
        self.data = data
        self.batches_per_eval = batches_per_eval
        self.on_result = on_result
        base_fn = eval_fn or trainer.loss_fn

        def with_loss(module, batch):  # the eval step returns aux only
            loss, aux = base_fn(module, batch)
            return loss, {"loss": loss, **aux}

        self._eval_step = trainer.build_eval_step(with_loss)
        self._last_step: Optional[int] = None
        self._stop = threading.Event()
        self.results: list = []

    def poll_once(self) -> Optional[Dict[str, float]]:
        """Evaluates the latest checkpoint if it is new; None otherwise."""
        step = self.checkpoint.latest_step()
        if step is None or step == self._last_step:
            return None
        state = self.trainer.restore_from(self.checkpoint, step)
        sums: Dict[str, float] = {}
        for _ in range(self.batches_per_eval):
            for k, v in self._eval_step(state, next(self.data)).items():
                sums[k] = sums.get(k, 0.0) + float(v)
        result = {k: v / self.batches_per_eval for k, v in sums.items()}
        result["step"] = float(step)
        self._last_step = step
        self.results.append(result)
        log.info("eval @ step %d: %s", step,
                 ", ".join(f"{k}={v:.4f}" for k, v in result.items() if k != "step"))
        if self.on_result is not None:
            self.on_result(result)
        return result

    def run(self, poll_interval_s: float = 5.0, max_evals: Optional[int] = None) -> None:
        """Follows the checkpoint directory until :meth:`stop` or ``max_evals``."""
        n = 0
        while not self._stop.is_set():
            if self.poll_once() is not None:
                n += 1
                if max_evals is not None and n >= max_evals:
                    return
            else:
                self._stop.wait(poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
