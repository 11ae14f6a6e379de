"""The port's whole lifecycle as processes on the CPU
(``easydl_tpu_torch/scripts/operator_lifecycle.py``, which ``chip_smoke.py``
phase 18 drives on the card with BERT-base): an ElasticJob submitted to the
port's operator (``CrStore``, ``ElasticJobController``,
``LocalProcessPodApi``, the standalone ``ingest`` pump) starts the trainer
pod alone; the trainer asks the Brain pod over gRPC for the startup plan and
applies the JobResource; the operator starts one worker pod (the agent,
``--platform cpu``) and one evaluator pod. The worker pod is SIGKILLed at
step 3 with step 2 committed; the operator replaces it under a fresh name,
the master forms generation 2 on the new agent alone (one reshape, see
``operator_lifecycle.RESHAPES``), which replays steps 3 on from step 2's
save, each loss equal to the killed generation's within 1e-6, and trains to
step 8. Every pod and the job end
``Succeeded``, the pods stay put over four more reconcile ticks, step 8 is
checkpointed and evaluated, the operator decided with its native core, and
no process is left.

A small GPT (``size=test``, seq 32, vocab 256) on token shards; each step
straggles 0.2 s (the chaos hook, ``EASYDL_CHAOS_SPEC``) so that the kill
lands at step 3.
"""

import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from easydl_tpu_torch.data import write_token_shards  # noqa: E402
from easydl_tpu_torch.scripts import operator_lifecycle as lifecycle  # noqa: E402

STEPS, CKPT_EVERY, KILL_AT = 8, 2, 3
RUNNER_ARGS = (f"--model gpt --model-arg size=test --model-arg seq_len=32 --model-arg "
               f"vocab=256 --batch 4 --steps {STEPS} --ckpt-every {CKPT_EVERY} --lr 1e-3")
TOKENS = 20_000
REPLAY_ABS = 1e-6
STRAGGLE_S = 0.2
DEADLINE_S = 45


def test_the_operator_runs_a_job_through_a_killed_worker_pod(tmp_path):
    spec = tmp_path / "chaos.json"
    spec.write_text(json.dumps({"scenario": "lifecycle", "seed": 0, "t0": time.time(),
                                "events": [{"id": 0, "kind": "straggler", "start_s": 0,
                                            "end_s": 3600, "target": {},
                                            "params": {"sleep_s": STRAGGLE_S}}]}))
    # token shards: the checkpoint keeps the data cursor, so the replay
    # trains on the killed generation's batches
    write_token_shards(np.random.default_rng(0).integers(0, 256, TOKENS), tmp_path / "tokens")
    rec = lifecycle.run(str(tmp_path), f"{RUNNER_ARGS} --data-dir {tmp_path / 'tokens'}",
                        STEPS, KILL_AT, "cpu", DEADLINE_S,
                        pod_env={"OMP_NUM_THREADS": "1", "EASYDL_CHAOS_SPEC": str(spec)})
    assert lifecycle.failures(rec, REPLAY_ABS) == [], rec
    assert rec.saved == CKPT_EVERY and rec.brain_core == "native"
    assert sorted(rec.since_submit) == ["first step", "plan applied", "trainer pod Running",
                                        "worker pod Running"]
    assert len(rec.since_kill) == 3
    # the checks bite: a replayed loss off by 1e-5, a leftover process
    step = min(s for s in rec.killed_losses if s > rec.saved)
    rec.killed_losses[step] += 1e-5
    rec.leftover.append("worker: pid 1 (x)")
    assert [f[:3] for f in lifecycle.failures(rec, REPLAY_ABS)] == ["(d)", "(g)"]
