"""``python -m easydl_tpu_torch.models.run`` — the port's model-zoo entrypoint.

Counterpart of ``easydl_tpu/models/run.py``, trainer role only: a
single-device training loop on the model bundle's synthetic data. It runs on
the GPU (``--device cuda``, the default) and fails when there is none, unless
``--device cpu`` asks for the CPU. The optimizer is the JAX runner's
``optax.adamw(lr)``: AdamW with weight decay 1e-4.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Optional, Sequence

#: optax.adamw's default weight decay (torch.optim.AdamW's is 1e-2)
ADAMW_WEIGHT_DECAY = 1e-4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="easydl_tpu_torch model zoo runner")
    ap.add_argument("--model", required=True, help="registry name (gpt)")
    ap.add_argument("--role", choices=["trainer", "evaluator"], default="trainer")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--model-arg", action="append", default=[],
                    help="k=v forwarded to the model factory (repeatable)")
    ap.add_argument("--ckpt-dir", default="", help="not ported yet")
    ap.add_argument("--data-dir", default="", help="not ported yet")
    ap.add_argument("--pp", type=int, default=1, help="not ported yet (only 1)")
    ap.add_argument("--profile-dir", default="", help="not ported yet")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, unported in (("--role evaluator", args.role == "evaluator"),
                           ("--ckpt-dir", args.ckpt_dir), ("--data-dir", args.data_dir),
                           ("--pp", args.pp != 1), ("--profile-dir", args.profile_dir)):
        if unported:
            ap.error(f"{flag} is not ported yet")

    import torch

    from easydl_tpu_torch.core.metrics import MetricsRecorder
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.utils.device import require_device
    from easydl_tpu_torch.utils.logging import get_logger

    log = get_logger("models", "run")
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    kwargs = {}
    for kv in args.model_arg:
        k, _, v = kv.partition("=")
        try:
            kwargs[k] = json.loads(v)
        except json.JSONDecodeError:
            kwargs[k] = v
    bundle = get_model(args.model, **kwargs)
    trainer = Trainer(
        init_fn=bundle.init_fn,
        loss_fn=bundle.loss_fn,
        optimizer=functools.partial(torch.optim.AdamW, lr=args.lr,
                                    weight_decay=ADAMW_WEIGHT_DECAY),
        config=TrainConfig(global_batch=args.batch),
        device=device,
    )
    state = trainer.init_state()
    data = iter(bundle.make_data(args.batch, seed=0))
    recorder = MetricsRecorder(args.batch, world_size=1)
    while state.step < args.steps:
        recorder.start_step()
        state, metrics = trainer.train_step(state, next(data))
        rec = recorder.end_step(state.step, float(metrics["loss"]))
        if state.step % 10 == 0 or state.step == args.steps:
            log.info("step %d loss %.4f (%.1f samples/s on %s)", state.step, rec.loss,
                     rec.samples_per_sec, device)


if __name__ == "__main__":
    main()
