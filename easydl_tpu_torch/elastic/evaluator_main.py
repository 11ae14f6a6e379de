"""The evaluator pod's entrypoint, in the port.

Counterpart of ``easydl_tpu/elastic/evaluator_main.py``. It derives
everything from the shared job workdir: it waits for the trainer's
``job.json``, builds the same model bundle, then follows ``<workdir>/ckpt``
with :class:`~easydl_tpu_torch.core.evaluator.Evaluator`, never joining
training. Each evaluated checkpoint appends one JSON line to
``<workdir>/eval.jsonl`` (``--out`` overrides). Once the job's ``DONE``
marker exists and the last committed step has been evaluated, it exits 0.

It runs on the GPU unless ``--device cpu`` asks for the CPU. File-backed
data (``data_dir`` in ``job.json``) is not ported yet.

``python -m easydl_tpu_torch.elastic.evaluator_main --workdir <shared dir>``
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main() -> None:
    ap = argparse.ArgumentParser(description="easydl_tpu_torch evaluator pod")
    ap.add_argument("--workdir", required=True, help="shared job workdir")
    ap.add_argument("--poll-interval", type=float, default=1.0)
    ap.add_argument("--batches-per-eval", type=int, default=4)
    ap.add_argument("--out", default="",
                    help="eval metrics JSONL (default <workdir>/eval.jsonl)")
    ap.add_argument("--config-timeout", type=float, default=300.0,
                    help="max wait for the trainer to write job.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args()

    import torch

    from easydl_tpu_torch.utils.device import require_device

    try:
        device = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    workdir = args.workdir
    out_path = args.out or os.path.join(workdir, "eval.jsonl")
    cfg_path = os.path.join(workdir, "job.json")
    done_path = os.path.join(workdir, "DONE")

    # pods start in parallel: the trainer may not have written job.json yet
    deadline = time.monotonic() + args.config_timeout
    while not os.path.exists(cfg_path):
        if time.monotonic() > deadline:
            raise SystemExit(f"no {cfg_path} after {args.config_timeout}s: "
                             "is the trainer pod running?")
        time.sleep(0.5)
    with open(cfg_path) as f:
        cfg = json.load(f)
    model_kwargs = dict(cfg.get("model_kwargs", {}))
    if model_kwargs.get("embedding") == "ps":
        raise SystemExit("evaluator does not support embedding='ps' jobs")
    if cfg.get("data_dir"):
        raise SystemExit("file-backed data (job.json data_dir) is not ported yet")

    from easydl_tpu_torch.core.checkpoint import CheckpointManager
    from easydl_tpu_torch.core.evaluator import Evaluator
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.utils.logging import get_logger

    log = get_logger("elastic", "evaluator")
    bundle = get_model(cfg["model"], **model_kwargs)
    global_batch = int(cfg.get("global_batch", 32))
    lr = float(cfg.get("lr", 1e-3))
    trainer = Trainer(  # the JAX pod's optax.adam(lr): the same opt_state[0]
        init_fn=bundle.init_fn,
        loss_fn=bundle.loss_fn,
        optimizer=lambda params: torch.optim.Adam(params, lr=lr),
        config=TrainConfig(global_batch=global_batch, seed=int(cfg.get("seed", 0))),
        device=device,
        jax_layout=bundle.jax_layout,
    )
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), async_save=False)

    def append_result(result) -> None:
        with open(out_path, "a") as f:
            f.write(json.dumps(result) + "\n")

    ev = Evaluator(trainer, ckpt, iter(bundle.make_data(global_batch, seed=1)),
                   eval_fn=bundle.eval_fn, batches_per_eval=args.batches_per_eval,
                   on_result=append_result)
    log.info("following %s/ckpt on %s (results -> %s)", workdir, device, out_path)
    while True:
        # DONE is read BEFORE polling: it is written only after the final
        # save commits, so "DONE was visible and the poll found nothing new"
        # proves the final checkpoint was evaluated
        done_before = os.path.exists(done_path)
        if ev.poll_once() is None:
            if done_before:
                log.info("job done; %d checkpoints evaluated", len(ev.results))
                return
            time.sleep(args.poll_interval)


if __name__ == "__main__":
    main()
