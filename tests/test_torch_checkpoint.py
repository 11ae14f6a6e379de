"""Checkpoints of the port (``easydl_tpu_torch/core/checkpoint.py``) in the
JAX package's on-disk format, both ways, with gpt ``test``, AdamW(1e-3,
weight decay 1e-4) and f32 compute:

- a JAX ``Trainer`` on an 8-device mesh (dp 2, fsdp 2, tp 2, so leaves are
  split over several chunks) trains 3 steps and the JAX manager saves it;
  the port's ``Trainer.restore_from`` gives every leaf (params, Adam
  moments, count, step, rng) bit-equal to the JAX state, and 2 more steps
  on each side agree within ``test_torch_train_loop.py``'s f32 bound (1e-5
  relative on loss and grad_norm);
- the reverse: the port saves, the JAX manager restores onto a dp 2 mesh;
- the counterparts of ``tests/test_checkpoint.py``'s async save and
  retention, uncommitted step, and missing-leaf tests, and
  ``restore_with_fallback`` quarantining a step with a truncated chunk;
- without the bundle's ``jax_layout`` the trainer neither saves nor restores."""

import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from easydl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from easydl_tpu.core.mesh import MeshSpec  # noqa: E402
from easydl_tpu.core.train_loop import TrainConfig as JaxTrainConfig  # noqa: E402
from easydl_tpu.core.train_loop import Trainer as JaxTrainer  # noqa: E402
from easydl_tpu.models.registry import get_model as jax_get_model  # noqa: E402
from easydl_tpu_torch.core.checkpoint import CheckpointManager, restore_with_fallback  # noqa: E402
from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer  # noqa: E402
from easydl_tpu_torch.models.registry import get_model  # noqa: E402

SEQ, VOCAB, BATCH = 64, 256, 8
LR, WD = 1e-3, 1e-4
TRAJECTORY_RTOL = 1e-5


def jax_trainer(spec):
    bundle = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    return bundle, JaxTrainer(
        init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
        optimizer=optax.adamw(LR, weight_decay=WD),
        config=JaxTrainConfig(global_batch=BATCH, compute_dtype=jnp.float32),
        mesh_spec=spec)


def torch_trainer(vocab=VOCAB):
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=vocab)
    return bundle, Trainer(
        init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
        optimizer=functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
        config=TrainConfig(global_batch=BATCH, compute_dtype=torch.float32), device="cpu",
        jax_layout=bundle.jax_layout)


def jax_leaves(state):
    return {jax.tree_util.keystr(p): np.asarray(jax.device_get(x))
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


def torch_leaves(trainer, state):
    return {k: v.numpy().copy() for k, v in trainer.state_leaves(state).items()}


def assert_leaves_equal(got, want):
    assert list(got) == list(want)  # the same keys, in the JAX flatten order
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def batches(skip):
    data = iter(get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB).make_data(BATCH, seed=0))
    for _ in range(skip):
        next(data)
    return data


def steps(trainer, state, data, n):
    """``n`` steps of either package's trainer: (state, [(loss, grad_norm)])."""
    out = []
    for _ in range(n):
        state, m = trainer.train_step(state, next(data))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def test_jax_checkpoint_from_a_sharded_mesh_restores_into_the_port(tmp_path, eight_devices):
    _, jt = jax_trainer(MeshSpec(dp=2, fsdp=2, tp=2))
    js, _ = steps(jt, jt.init_state(), batches(0), 3)
    JaxCheckpointManager(str(tmp_path), async_save=False).save(3, js)
    chunks = [len(os.listdir(tmp_path / "step_00000003" / d))
              for d in os.listdir(tmp_path / "step_00000003") if d.startswith("leaf_")]
    assert max(chunks) > 1  # sharded leaves: restore must assemble them

    tt = torch_trainer()[1]
    ts = tt.restore_from(CheckpointManager(str(tmp_path)))
    assert ts.step == 3
    assert_leaves_equal(torch_leaves(tt, ts), jax_leaves(js))

    _, want = steps(jt, js, batches(3), 2)
    ts, got = steps(tt, ts, batches(3), 2)
    assert ts.step == 5
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL, atol=0)


def test_port_checkpoint_restores_in_the_jax_package(tmp_path, eight_devices):
    tt = torch_trainer()[1]
    ts = tt.init_state()
    ts, _ = steps(tt, ts, batches(0), 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tt.state_leaves(ts))
    mgr.wait()

    _, jt = jax_trainer(MeshSpec(dp=2))
    js = JaxCheckpointManager(str(tmp_path)).restore(3, jt.abstract_state(), jt.state_shardings())
    assert js.int_step == 3
    assert_leaves_equal(jax_leaves(js), torch_leaves(tt, ts))

    _, want = steps(tt, ts, batches(3), 2)
    _, got = steps(jt, js, batches(3), 2)
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL, atol=0)


def test_async_save_and_retention(tmp_path):
    trainer = torch_trainer()[1]
    state = trainer.init_state()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for step in (1, 2, 3, 4):
        state.step = step
        mgr.save(step, trainer.state_leaves(state))
    mgr.wait()
    assert mgr.steps() == [3, 4]
    meta = mgr.metadata(4)
    assert meta["step"] == 4 and len(meta["leaves"]) > 0 and meta["cache_token"]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_save_snapshots_before_the_next_step(tmp_path):
    """The state is copied when save returns: training on while the write
    runs does not change what is saved."""
    trainer = torch_trainer()[1]
    state = trainer.init_state()
    before = torch_leaves(trainer, state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, trainer.state_leaves(state))
    steps(trainer, state, batches(0), 1)
    mgr.wait()
    restored = trainer.restore_from(mgr, 0)
    assert_leaves_equal(torch_leaves(trainer, restored), before)


def test_uncommitted_step_ignored(tmp_path):
    trainer = torch_trainer()[1]
    state = trainer.init_state()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state.step = 5
    mgr.save(5, trainer.state_leaves(state))
    os.makedirs(str(tmp_path / "step_00000009"))  # a save that died mid-write
    assert mgr.latest_step() == 5
    assert trainer.restore_from(mgr).step == 5


@pytest.mark.parametrize("case", ["missing-leaf", "other-shape"])
def test_restore_missing_leaf_fails(tmp_path, case):
    trainer = torch_trainer()[1]
    leaves = trainer.state_leaves(trainer.init_state())
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    if case == "missing-leaf":
        leaves.pop(".params['pos_emb'].value")
    mgr.save(1, leaves)
    if case == "missing-leaf":
        with pytest.raises(KeyError, match="missing leaf"):
            trainer.restore_from(mgr)
    else:
        with pytest.raises(ValueError, match="saved shape"):
            torch_trainer(vocab=2 * VOCAB)[1].restore_from(mgr)


def test_restore_with_fallback_quarantines_a_truncated_chunk(tmp_path):
    trainer = torch_trainer()[1]
    state = trainer.init_state()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for step in (1, 2):
        state.step = step
        mgr.save(step, trainer.state_leaves(state))
    leaf = tmp_path / "step_00000002" / "leaf_00001"
    (chunk,) = leaf.iterdir()
    chunk.write_bytes(chunk.read_bytes()[:-64])

    restored, step = restore_with_fallback(mgr, lambda s: trainer.restore_from(mgr, s))
    assert step == 1 and restored.step == 1
    assert mgr.steps() == [1]
    assert (tmp_path / "step_00000002" / "CORRUPT").exists()
    assert restore_with_fallback(CheckpointManager(str(tmp_path / "empty")),
                                 lambda s: None) == (None, -1)


def test_gs_urls_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        CheckpointManager("gs://bucket/prefix")


def test_other_optimizers_are_not_ported_yet(tmp_path):
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                      optimizer=functools.partial(torch.optim.SGD, lr=0.1),
                      config=TrainConfig(global_batch=BATCH), device="cpu",
                      jax_layout=bundle.jax_layout)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        trainer.state_leaves(trainer.init_state())


def test_checkpoints_need_the_models_layout(tmp_path):
    """The trainer knows no model's layout: without the bundle's
    ``jax_layout`` it can neither save nor restore."""
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                      optimizer=functools.partial(torch.optim.AdamW, lr=LR),
                      config=TrainConfig(global_batch=BATCH), device="cpu")
    with pytest.raises(NotImplementedError, match="jax_layout"):
        trainer.state_leaves(trainer.init_state())
    with_layout = torch_trainer()[1]
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, with_layout.state_leaves(with_layout.init_state()))
    with pytest.raises(NotImplementedError, match="jax_layout"):
        trainer.restore_from(mgr)
