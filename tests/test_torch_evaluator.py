"""The port's evaluator role (``easydl_tpu_torch/core/evaluator.py``, the
runner's ``--role evaluator``, ``easydl_tpu_torch/elastic/evaluator_main.py``)
on gpt ``test`` on the CPU: the counterparts of ``tests/test_evaluator.py``'s
checkpoint following, run loop, runner and evaluator-pod tests. An
evaluation of a restored step equals ``Trainer.build_eval_step`` on the live
state that was saved: the same weights, batches and ops."""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from easydl_tpu_torch.core.checkpoint import CheckpointManager
from easydl_tpu_torch.core.evaluator import Evaluator
from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
from easydl_tpu_torch.models.registry import get_model

REPO = Path(__file__).resolve().parent.parent
MODEL_KWARGS = {"size": "test", "seq_len": 32, "vocab": 128}
BATCH = 4


def make_trainer(bundle, optimizer=torch.optim.AdamW):
    return Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                   optimizer=functools.partial(optimizer, lr=1e-2),
                   config=TrainConfig(global_batch=BATCH, compute_dtype=torch.float32),
                   device="cpu", jax_layout=bundle.jax_layout)


@pytest.fixture(scope="module")
def bundle():
    return get_model("gpt", **MODEL_KWARGS)


def test_evaluator_follows_checkpoints(tmp_path, bundle):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    trainer = make_trainer(bundle)
    state = trainer.init_state()
    data = iter(bundle.make_data(BATCH, seed=0))
    ev = Evaluator(make_trainer(bundle), mgr, iter(bundle.make_data(BATCH, seed=7)),
                   eval_fn=bundle.eval_fn, batches_per_eval=2)
    assert ev.poll_once() is None  # nothing saved yet

    for _ in range(3):
        state, _ = trainer.train_step(state, next(data))
    mgr.save(3, trainer.state_leaves(state))
    r1 = ev.poll_once()
    assert r1 is not None and r1["step"] == 3 and {"loss", "perplexity"} <= set(r1)
    eval_step = trainer.build_eval_step(bundle.eval_fn)
    held_out = iter(bundle.make_data(BATCH, seed=7))
    live = [eval_step(state, next(held_out)) for _ in range(2)]
    assert r1["perplexity"] == sum(float(a["perplexity"]) for a in live) / 2
    assert math.isfinite(r1["loss"])
    assert ev.poll_once() is None  # the same step is not evaluated again

    for _ in range(3):
        state, _ = trainer.train_step(state, next(data))
    mgr.save(6, trainer.state_leaves(state))
    r2 = ev.poll_once()
    assert r2 is not None and r2["step"] == 6
    assert len(ev.results) == 2


def test_evaluator_run_loop_stops(tmp_path, bundle):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    trainer = make_trainer(bundle)
    state = trainer.init_state()
    state.step = 1
    mgr.save(1, trainer.state_leaves(state))
    ev = Evaluator(trainer, mgr, iter(bundle.make_data(BATCH, seed=3)), batches_per_eval=1)
    ev.run(poll_interval_s=0.01, max_evals=1)  # returns after one eval
    assert [r["step"] for r in ev.results] == [1.0]
    ev.stop()
    ev.run(poll_interval_s=0.01)  # stopped: returns at once
    assert len(ev.results) == 1


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_model_zoo_runner_cli(tmp_path):
    """Train with checkpoints, train on from the latest step, then evaluate
    it: ``--steps 4`` then ``--steps 6`` resumes from step 4."""
    run = ["-m", "easydl_tpu_torch.models.run", "--model", "gpt", "--batch", str(BATCH),
           "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    run += [a for k, v in MODEL_KWARGS.items() for a in ("--model-arg", f"{k}={v}")]
    r = _run(run + ["--steps", "4", "--ckpt-every", "2"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed" not in r.stderr
    r = _run(run + ["--steps", "6", "--ckpt-every", "2"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from step 4" in r.stderr
    assert CheckpointManager(str(tmp_path / "ck")).steps() == [2, 4, 6]
    r = _run(run + ["--role", "evaluator", "--eval-polls", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stderr.count("eval @ step 6: loss=") == 1


def test_evaluator_main_pod_entrypoint(tmp_path, bundle):
    """Given a workdir with ``job.json``, ``ckpt/`` and ``DONE``, the pod
    evaluates the latest step, appends ``eval.jsonl`` and exits 0."""
    workdir = tmp_path / "work"
    workdir.mkdir()
    cfg = {"model": "gpt", "model_kwargs": MODEL_KWARGS, "global_batch": BATCH,
           "lr": 1e-2, "seed": 0}
    (workdir / "job.json").write_text(json.dumps(cfg))
    trainer = make_trainer(bundle, optimizer=torch.optim.Adam)
    state = trainer.init_state()
    batch = next(iter(bundle.make_data(BATCH, seed=0)))
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    CheckpointManager(str(workdir / "ckpt"), async_save=False).save(
        2, trainer.state_leaves(state))
    (workdir / "DONE").write_text("2")

    r = _run(["-m", "easydl_tpu_torch.elastic.evaluator_main", "--workdir", str(workdir),
              "--batches-per-eval", "2", "--poll-interval", "0.2", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    evals = [json.loads(line) for line in
             (workdir / "eval.jsonl").read_text().strip().splitlines()]
    assert len(evals) == 1 and evals[0]["step"] == 2.0
    assert math.isfinite(evals[0]["loss"])
