"""``python -m easydl_tpu_torch.models.run`` — the port's model-zoo entrypoint.

Counterpart of ``easydl_tpu/models/run.py``, on the model bundle's
synthetic data. One process trains on one device (so does one rank of
``torch.distributed.run``); under
``python -m torch.distributed.run --nproc-per-node N``, N > 1, each of the N ranks
trains on its own device (``cuda:LOCAL_RANK``, or the CPU with ``--device
cpu``) over ``--dp`` (0: all of them), takes its rows of the same seeded
global batch and rank 0 logs, so the loss log is that of the JAX runner on
N devices. FSDP is reached through ``Trainer(mesh_spec=...)``, as in the
JAX package, which has no flag for it either. Roles:

- ``--role trainer`` (default): the training loop; with ``--ckpt-dir`` it
  resumes from the latest committed step there and saves every
  ``--ckpt-every`` steps and at the last one;
- ``--role evaluator``: follows ``--ckpt-dir`` and evaluates each new step
  on held-out batches (``make_data(batch, seed=1)``), ``--eval-polls``
  times (0: until killed); one process, which restores a save of any
  world size.

Checkpoints are in the JAX package's format, so either runner resumes or
evaluates the other's. It runs on the GPU (``--device cuda``, the default)
and fails when there is none, unless ``--device cpu`` asks for the CPU. The
optimizer is the JAX runner's ``optax.adamw(lr)``: AdamW with weight decay
1e-4.
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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel size (0 = the world size of torch.distributed.run)")
    ap.add_argument("--eval-polls", type=int, default=0,
                    help="evaluator: stop after N evals (0 = forever)")
    ap.add_argument("--data-dir", default="", help="not ported yet")
    ap.add_argument("--pp", type=int, default=1, help="not ported yet (only 1)")
    ap.add_argument("--profile-dir", default="", help="not ported yet")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, unported in (("--data-dir", args.data_dir), ("--pp", args.pp != 1),
                           ("--profile-dir", args.profile_dir)):
        if unported:
            ap.error(f"{flag} is not ported yet")
    if args.role == "evaluator" and not args.ckpt_dir:
        ap.error("--role evaluator requires --ckpt-dir")

    import logging
    import os

    import torch
    import torch.distributed as dist

    from easydl_tpu_torch.core.checkpoint import CheckpointManager
    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed
    from easydl_tpu_torch.core.metrics import MetricsRecorder
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.utils.device import require_device
    from easydl_tpu_torch.utils.logging import get_logger

    log = get_logger("models", "run")
    world = int(os.environ.get("WORLD_SIZE", "0"))  # set by torch.distributed.run
    if world > 1 and args.role == "evaluator":
        ap.error("the evaluator is one process: run it without torch.distributed.run")
    distributed = world > 1 and args.role == "trainer"  # one rank: the one-device path
    dp = args.dp or max(world, 1)
    if dp != max(world, 1):
        ap.error(f"--dp {dp} needs {dp} processes (python -m torch.distributed.run "
                 f"--nproc-per-node {dp}); this run has {max(world, 1)}")
    try:
        device = init_distributed(args.device) if distributed else require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    rank = dist.get_rank() if distributed else 0
    if rank:
        logging.getLogger("easydl_tpu_torch").setLevel(logging.WARNING)

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
        jax_layout=bundle.jax_layout,
        mesh_spec=MeshSpec(dp=dp) if distributed else None,
        param_axes=bundle.param_axes,
    )
    try:
        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    except NotImplementedError as e:  # a storage backend not ported yet
        ap.error(str(e))

    if args.role == "evaluator":
        from easydl_tpu_torch.core.evaluator import Evaluator

        ev = Evaluator(trainer, ckpt, iter(bundle.make_data(args.batch, seed=1)),
                       eval_fn=bundle.eval_fn)
        ev.run(poll_interval_s=2.0, max_evals=args.eval_polls or None)
        return

    if ckpt is not None and ckpt.latest_step() is not None:
        state = trainer.restore_from(ckpt)
        log.info("resumed from step %d", state.step)
    else:
        state = trainer.init_state()
    data = iter(bundle.make_data(args.batch, seed=0))
    rows = slice(rank * args.batch // dp, (rank + 1) * args.batch // dp)
    recorder = MetricsRecorder(args.batch, world_size=dp)
    while state.step < args.steps:
        recorder.start_step()
        state, metrics = trainer.train_step(state, {k: v[rows] for k, v in next(data).items()})
        rec = recorder.end_step(state.step, float(metrics["loss"]))
        if state.step % 10 == 0 or state.step == args.steps:
            log.info("step %d loss %.4f (%.1f samples/s on %s)", state.step, rec.loss,
                     rec.samples_per_sec, device)
        if ckpt is not None and (state.step % args.ckpt_every == 0 or state.step == args.steps):
            ckpt.save(state.step, trainer.state_leaves(state))
        if ckpt is not None:
            ckpt.finalize()  # commits a save of several ranks once all have written
    if ckpt is not None:
        ckpt.wait()
    if distributed:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
