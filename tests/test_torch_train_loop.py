"""Five training steps of the port's ``Trainer`` against the JAX ``Trainer``:
gpt ``test`` from the same converted init, the same ``SyntheticTokens``
batches, AdamW(1e-3, weight decay 1e-4) and grad_accum 2. Loss and
grad_norm trajectories agree within 1e-5 relative at
``compute_dtype=float32`` (f32 math in both, sums in another order, five
Adam steps; 3e-6 seen), and within 2e-3 at the default bf16
``compute_dtype`` (bf16 rounds at other places in the two frameworks;
3e-4 seen)."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from easydl_tpu.core.mesh import MeshSpec  # noqa: E402
from easydl_tpu.core.train_loop import TrainConfig as JaxTrainConfig  # noqa: E402
from easydl_tpu.core.train_loop import Trainer as JaxTrainer  # noqa: E402
from easydl_tpu.models.registry import get_model as jax_get_model  # noqa: E402
from easydl_tpu_torch.convert import params_from_jax  # noqa: E402
from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer  # noqa: E402
from easydl_tpu_torch.models.registry import get_model  # noqa: E402

SEQ, VOCAB, BATCH, ACCUM, STEPS = 64, 256, 8, 2, 5
LR, WD = 1e-3, 1e-4


def jax_run(compute_dtype):
    bundle = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = JaxTrainer(
        init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
        optimizer=optax.adamw(LR, weight_decay=WD),
        config=JaxTrainConfig(global_batch=BATCH, grad_accum=ACCUM,
                              compute_dtype=compute_dtype),
        mesh_spec=MeshSpec(dp=1),
    )
    state = trainer.init_state()
    init = jax.tree.map(np.asarray, flax.linen.meta.unbox(state.params))
    data = iter(bundle.make_data(BATCH, seed=0))
    traj = []
    for _ in range(STEPS):
        state, metrics = trainer.train_step(state, next(data))
        m = jax.device_get(metrics)
        traj.append((float(m["loss"]), float(m["grad_norm"]), float(m["perplexity"])))
    return init, np.array(traj)


def torch_run(init, compute_dtype):
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = Trainer(
        init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
        optimizer=functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
        config=TrainConfig(global_batch=BATCH, grad_accum=ACCUM,
                           compute_dtype=compute_dtype),
        device="cpu",
    )
    state = trainer.init_state()
    state.model.load_state_dict(params_from_jax(init))
    data = iter(bundle.make_data(BATCH, seed=0))
    traj = []
    for step in range(STEPS):
        state, metrics = trainer.train_step(state, next(data))
        assert state.step == step + 1
        traj.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     float(metrics["perplexity"])))
    return np.array(traj)


@pytest.mark.parametrize("jax_dtype,torch_dtype,tol", [
    (jnp.float32, torch.float32, 1e-5),
    (jnp.bfloat16, torch.bfloat16, 2e-3),
])
def test_trajectory_matches_jax_trainer(jax_dtype, torch_dtype, tol):
    init, want = jax_run(jax_dtype)
    got = torch_run(init, torch_dtype)
    assert want[-1, 0] < want[0, 0]  # it trains
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


def test_config_rejects_indivisible_accum():
    with pytest.raises(ValueError, match="not divisible"):
        TrainConfig(global_batch=6, grad_accum=4)


def test_cuda_trainer_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Trainer(init_fn=None, loss_fn=None, optimizer=None, config=TrainConfig())
