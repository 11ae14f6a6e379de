"""The port's multi-process training step and checkpoints, four gloo ranks on
the CPU, against the JAX package on the same global batches.

One spawn of four ranks serves the whole module: each rank is this file run
as a script (``python tests/test_torch_distributed.py RANK WORKDIR``), joins
a gloo group through a ``FileStore`` under the work dir (60 s collective
timeout), runs every case below and rank 0 writes what the tests compare.
The join has a deadline (:data:`DEADLINE_S`); on overrun the ranks are
killed and every test fails, so a stuck collective cannot hang the suite.
The rank side imports no JAX.

Cases, gpt ``test`` (seq 64, vocab 256), global batch 8, grad_accum 2,
AdamW(1e-3, weight decay 1e-4), from the JAX package's init carried over
by ``convert.py``:

- 3 steps at dp 2 x fsdp 2 and at dp 4, f32 and bf16 compute, against the
  JAX ``Trainer`` on the same meshes (4 of the forced host devices): loss,
  grad_norm and perplexity within 1e-5 relative in f32 and 2e-3 in bf16,
  the bounds of ``tests/test_torch_train_loop.py``, and the parameter
  vector within the same bounds in relative L2;
- the same with targets of -1 spread unevenly over the ranks, so the
  ranks' counts differ: the loss is the masked mean over the global
  microbatch. A planted fault (each rank's local mean, averaged) misses
  the JAX parameters by far more than the bound;
- remat "dots" at dp 2 x fsdp 2 in bf16: losses, gradients and parameters
  equal to those without remat, exactly;
- the f32 step against the one-process port: loss, grad_norm and every
  gradient of the first step within 1e-6 relative;
- FSDP2 keeps the gradients of skipped reductions in f32;
- a dp 2 x fsdp 2 checkpoint restores bit-exactly into a one-process port
  ``Trainer``, into the JAX ``CheckpointManager`` and onto fsdp 4 ranks;
  the JAX dp 2 x fsdp 2 x tp 2 checkpoint restores bit-exactly into the
  four ranks.

The key biases are left out of every parameter comparison: their gradient
is 0 in exact arithmetic (softmax ignores a shift of a row of scores), so
Adam steps them by rounding noise on every side.
"""

import functools
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD, DEADLINE_S = 4, 180
SEQ, VOCAB, N_HEADS, BATCH, ACCUM, STEPS = 64, 256, 4, 8, 2, 3
LR, WD, SEED = 1e-3, 1e-4, 0
MESHES = {"dp2xfsdp2": dict(dp=2, fsdp=2), "dp4": dict(dp=4)}
DTYPES = {"f32": ("float32", 1e-5), "bf16": ("bfloat16", 2e-3)}
K_BIAS = ".k.bias"


def host_batches(uneven: bool):
    """The global batches of every case: the bundle's synthetic stream
    (seed 0); ``uneven`` masks targets so that the four ranks' rows (two
    each) hold 8+40, 44+64, 64+64 and 64+4 targets, and each microbatch
    (rows 0-3, rows 4-7) is split unevenly too."""
    from easydl_tpu_torch.core.data import SyntheticTokens

    data = iter(SyntheticTokens(BATCH, SEQ, vocab=VOCAB, seed=0))
    for _ in range(STEPS):
        batch = next(data)
        if uneven:
            targets = batch["targets"].copy()
            targets[0, 8:] = -1
            targets[1, 40:] = -1
            targets[2, :20] = -1
            targets[7, 4:] = -1
            batch = {"inputs": batch["inputs"], "targets": targets}
        yield batch


# ------------------------------------------------------------------ rank side
def _rank_cases(rank: int, work: Path) -> None:
    import torch.distributed as dist

    from easydl_tpu_torch.core import mesh as port_mesh
    from easydl_tpu_torch.core.checkpoint import CheckpointManager, restore_with_fallback
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer, fsdp_params
    from easydl_tpu_torch.models import gpt
    from easydl_tpu_torch.models.registry import get_model

    torch.set_num_threads(2)
    port_mesh.init_distributed("cpu", rank=rank, world_size=WORLD, local_rank=rank,
                               store=dist.FileStore(str(work / "store"), WORLD),
                               timeout=timedelta(seconds=60))
    init = torch.load(work / "init.pt")
    out = {}

    def trainer(spec, dtype="float32", remat=False, loss_fn=None, mesh=None):
        bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB, remat=remat,
                           remat_policy="dots")

        def init_fn(seed, device):
            model = bundle.init_fn(seed, device)
            model.load_state_dict(init)
            return model

        return Trainer(init_fn=init_fn, loss_fn=loss_fn or bundle.loss_fn,
                       optimizer=functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
                       config=TrainConfig(global_batch=BATCH, grad_accum=ACCUM,
                                          compute_dtype=getattr(torch, dtype), seed=SEED),
                       device="cpu", jax_layout=bundle.jax_layout,
                       mesh=mesh, mesh_spec=None if mesh else port_mesh.MeshSpec(**spec),
                       param_axes=bundle.param_axes)

    def full(t):
        return t.full_tensor().detach().clone()

    def dump(state):
        opt = state.optimizer.state
        return {"step": state.step,
                "count": {int(opt[p]["step"]) for p in state.model.parameters()},
                "params": {n: full(p) for n, p in state.model.named_parameters()},
                "mu": {n: full(opt[p]["exp_avg"]) for n, p in state.model.named_parameters()},
                "nu": {n: full(opt[p]["exp_avg_sq"]) for n, p in state.model.named_parameters()}}

    def train(tr, uneven=False):
        state = tr.init_state()
        n = BATCH // WORLD
        traj, grads = [], None
        for batch in host_batches(uneven):
            state, m = tr.train_step(state, {k: v[rank * n:(rank + 1) * n]
                                             for k, v in batch.items()})
            traj.append([float(m["loss"]), float(m["grad_norm"]), float(m["perplexity"])])
            if grads is None:
                grads = {n: full(p.grad) for n, p in state.model.named_parameters()}
        return state, {"traj": traj, "grads": grads,
                       "params": {n: full(p) for n, p in state.model.named_parameters()}}

    # the mesh: ranks laid out as the JAX reshape, the batch over all four
    tr = trainer(MESHES["dp2xfsdp2"])
    coords = [None] * WORLD
    dist.all_gather_object(coords, tr.mesh.get_coordinate())
    out["layout"] = {"coords": coords, "batch_divisor": port_mesh.batch_divisor(tr.mesh)}

    # FSDP2's accumulation of the gradients it does not reduce
    state = trainer(MESHES["dp2xfsdp2"], "bfloat16").init_state()
    batch = next(host_batches(False))
    mb = {k: torch.as_tensor(v[rank:rank + 1]) for k, v in batch.items()}
    state.model.set_requires_gradient_sync(False)
    state.model(mb["inputs"]).float().sum().backward()
    out["accum_dtypes"] = sorted({str(fp.unsharded_accumulated_grad.dtype)
                                  for fp in fsdp_params(state.model)})
    del state

    for mesh in MESHES:
        for dtype, (name, _) in DTYPES.items():
            tr = trainer(MESHES[mesh], name)
            state, out[f"{mesh}-{dtype}"] = train(tr)
            if (mesh, dtype) == ("dp2xfsdp2", "f32"):
                mgr = CheckpointManager(str(work / "ckpt_port"))
                mgr.save(state.step, tr.state_leaves(state))
                mgr.wait()
                out["saved"] = dump(state)
                restored, step = restore_with_fallback(
                    mgr, lambda s: trainer(dict(fsdp=4)).restore_from(mgr, s))
                out["restored_fsdp4"] = {"at": step, **dump(restored)}
    for dtype, (name, _) in DTYPES.items():
        _, out[f"uneven-{dtype}"] = train(trainer(MESHES["dp2xfsdp2"], name), uneven=True)

    # the planted fault: each rank's local masked mean, averaged over ranks
    def mean_of_local_means(total, count):
        (mean,) = port_mesh.batch_sum(total / count.clamp_min(1.0))
        return mean / WORLD, torch.ones_like(count)

    gpt.batch_sum = mean_of_local_means
    try:
        _, out["uneven-fault"] = train(trainer(MESHES["dp2xfsdp2"]), uneven=True)
    finally:
        gpt.batch_sum = port_mesh.batch_sum

    # a loss that never sums over the ranks is refused
    def rank_mean(model, batch):
        return model(batch["inputs"]).float().logsumexp(-1).mean(), {}

    try:
        train(trainer(MESHES["dp2xfsdp2"], loss_fn=rank_mean))
        out["unsummed"] = None
    except RuntimeError as e:
        out["unsummed"] = str(e)

    # a mesh the caller built trains as the one its spec builds
    built = port_mesh.build_mesh(port_mesh.MeshSpec(**MESHES["dp2xfsdp2"]), "cpu")
    _, out["built-mesh"] = train(trainer(None, mesh=built))

    for remat in (False, True):
        _, out[f"remat-{remat}"] = train(trainer(MESHES["dp2xfsdp2"], "bfloat16", remat=remat))

    jax_ckpt = CheckpointManager(str(work / "ckpt_jax"))
    out["from_jax"] = dump(trainer(MESHES["dp2xfsdp2"]).restore_from(jax_ckpt))
    if rank == 0:
        torch.save(out, work / "out.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_cases(int(sys.argv[1]), Path(sys.argv[2]))
    sys.exit(0)

# --------------------------------------------------------------- parent side
jax = pytest.importorskip("jax")
import flax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from easydl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from easydl_tpu.core.mesh import MeshSpec  # noqa: E402
from easydl_tpu.core.train_loop import TrainConfig as JaxTrainConfig  # noqa: E402
from easydl_tpu.core.train_loop import Trainer as JaxTrainer  # noqa: E402
from easydl_tpu.models.registry import get_model as jax_get_model  # noqa: E402
from easydl_tpu_torch import convert  # noqa: E402
from easydl_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer  # noqa: E402
from easydl_tpu_torch.models.registry import get_model  # noqa: E402

JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def jax_trainer(spec, dtype="f32"):
    bundle = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    return JaxTrainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                      optimizer=optax.adamw(LR, weight_decay=WD),
                      config=JaxTrainConfig(global_batch=BATCH, grad_accum=ACCUM,
                                            compute_dtype=JAX_DTYPES[dtype], seed=SEED),
                      mesh_spec=MeshSpec(**spec))


def unboxed(params):
    return jax.tree.map(np.asarray, flax.linen.meta.unbox(params))


def jax_leaves(state):
    return {jax.tree_util.keystr(p): np.asarray(jax.device_get(x))
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


@functools.lru_cache(maxsize=None)
def jax_run(mesh: str, dtype: str, uneven: bool = False):
    """3 steps of the JAX ``Trainer``: (trajectory, final params)."""
    trainer = jax_trainer(MESHES[mesh], dtype)
    state = trainer.init_state()
    traj = []
    for batch in host_batches(uneven):
        state, m = trainer.train_step(state, batch)
        m = jax.device_get(m)
        traj.append([float(m["loss"]), float(m["grad_norm"]), float(m["perplexity"])])
    return np.array(traj), unboxed(state.params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eight_devices):
    """Runs the four ranks once; returns (rank 0's results, the JAX
    dp 2 x fsdp 2 x tp 2 state the ranks restored, the work dir)."""
    work = tmp_path_factory.mktemp("ranks")
    jt = jax_trainer(dict(dp=2, fsdp=2, tp=2))
    js = jt.init_state()
    torch.save(convert.params_from_jax(unboxed(js.params)), work / "init.pt")
    for batch in host_batches(False):
        js, _ = jt.train_step(js, batch)
    JaxCheckpointManager(str(work / "ckpt_jax"), async_save=False).save(STEPS, js)

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    logs = [open(work / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(work)], env=env, cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait out their timeout
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    tails = "\n".join(f"--- rank {r} (rc {rc}):\n" + (work / f"rank{r}.log").read_text()[-3000:]
                      for r, rc in enumerate(rcs) if rc != 0)
    assert rcs == [0] * WORLD, f"ranks {rcs} (killed at the {DEADLINE_S}s deadline if -9)\n{tails}"
    return torch.load(work / "out.pt"), jax_leaves(js), work


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_params_close(got: dict, want_tree, tol: float):
    """``got`` (port names -> tensors) against the JAX tree: the parameter
    vector in relative L2, the key biases left out. (Leaf by leaf, the
    zero-initialised biases, moved by three Adam steps, differ more: in f32
    up to 1.4e-5 of their own norm, in bf16 up to 8e-2.)"""
    want = dict(flat(want_tree))
    got = dict(flat(convert.params_to_jax(got, N_HEADS)))
    assert set(got) == set(want)
    keys = [k for k in want if "['k']['bias']" not in k]
    whole = rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                   np.concatenate([want[k].ravel() for k in keys]))
    worst = sorted(((k, rel_l2(got[k], want[k])) for k in keys), key=lambda kv: -kv[1])
    assert whole <= tol, (whole, worst[:4])


def flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat(tree[k], f"{prefix}['{k}']")
        else:
            yield f"{prefix}['{k}']", np.asarray(tree[k])


def test_ranks_are_laid_out_as_the_jax_mesh(ranks):
    out, _, _ = ranks
    from easydl_tpu.core.mesh import build_mesh

    mesh = build_mesh(MeshSpec(**MESHES["dp2xfsdp2"]))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    want = [tuple(int(c[0]) for c in np.nonzero(ids == r)) for r in range(WORLD)]
    assert [tuple(c) for c in out["layout"]["coords"]] == want
    assert out["layout"]["batch_divisor"] == WORLD


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_matches_the_jax_trainer(ranks, mesh, dtype):
    out, _, _ = ranks
    want, params = jax_run(mesh, dtype)
    got = out[f"{mesh}-{dtype}"]
    tol = DTYPES[dtype][1]
    assert want[-1, 0] < want[0, 0]  # it trains
    np.testing.assert_allclose(got["traj"], want, rtol=tol, atol=0)
    assert_params_close(got["params"], params, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_uneven_masks_match_the_jax_trainer(ranks, dtype):
    out, _, _ = ranks
    want, params = jax_run("dp2xfsdp2", dtype, uneven=True)
    got = out[f"uneven-{dtype}"]
    tol = DTYPES[dtype][1]
    np.testing.assert_allclose(got["traj"], want, rtol=tol, atol=0)
    assert_params_close(got["params"], params, tol)
    if dtype == "f32":  # the case tells the fault apart
        with pytest.raises(AssertionError):
            assert_params_close(out["uneven-fault"]["params"], params, 100 * tol)


def test_remat_dots_equals_no_remat(ranks):
    out, _, _ = ranks
    plain, remat = out["remat-False"], out["remat-True"]
    assert remat["traj"] == plain["traj"]
    for kind in ("grads", "params"):
        for name, t in plain[kind].items():
            torch.testing.assert_close(remat[kind][name], t, rtol=0, atol=0, msg=name)


def test_a_mesh_built_by_the_caller_trains_as_its_spec(ranks):
    out, _, _ = ranks
    got, want = out["built-mesh"], out["dp2xfsdp2-f32"]
    assert got["traj"] == want["traj"]
    for name, t in want["params"].items():
        torch.testing.assert_close(got["params"][name], t, rtol=0, atol=0, msg=name)


def test_a_loss_that_skips_batch_sum_is_refused(ranks):
    assert "never called core.mesh.batch_sum" in (ranks[0]["unsummed"] or "")


def test_f32_step_matches_the_one_process_port(ranks):
    out, _, work = ranks
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                      optimizer=functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
                      config=TrainConfig(global_batch=BATCH, grad_accum=ACCUM,
                                         compute_dtype=torch.float32), device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(torch.load(work / "init.pt"))
    state, m = trainer.train_step(state, next(host_batches(False)))
    for mesh in MESHES:
        got = out[f"{mesh}-f32"]
        np.testing.assert_allclose(got["traj"][0][:2], [float(m["loss"]), float(m["grad_norm"])],
                                   rtol=1e-6, atol=0)
        rel = {n: ((got["grads"][n] - p.grad).norm() / p.grad.norm()).item()
               for n, p in state.model.named_parameters() if not n.endswith(K_BIAS)}
        assert max(rel.values()) <= 1e-6, (mesh, sorted(rel.items(), key=lambda kv: -kv[1])[:4])


def test_gradients_not_yet_reduced_accumulate_in_f32(ranks):
    assert ranks[0]["accum_dtypes"] == ["torch.float32"]


def dump_leaves(d):
    """A rank dump in the JAX ``TrainState``'s checkpoint leaves."""
    (count,) = d["count"]
    out = {".step": np.asarray(d["step"], np.int32),
           ".opt_state[0].count": np.asarray(count, np.int32),
           ".rng": np.array([0, SEED], np.uint32)}
    for prefix, key in ((".params", "params"), (".opt_state[0].mu", "mu"),
                        (".opt_state[0].nu", "nu")):
        out.update({f"{prefix}{k}.value": v
                    for k, v in flat(convert.params_to_jax(d[key], N_HEADS))})
    return out


def assert_leaves_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_port_save_restores_into_one_process_and_onto_fsdp4(ranks):
    out, _, work = ranks
    saved = dump_leaves(out["saved"])
    chunks = [len(os.listdir(work / "ckpt_port" / "step_00000003" / d))
              for d in os.listdir(work / "ckpt_port" / "step_00000003") if d.startswith("leaf_")]
    assert max(chunks) == 2  # each leaf in its fsdp shards, written by dp replica 0 only
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                      optimizer=functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
                      config=TrainConfig(global_batch=BATCH, compute_dtype=torch.float32),
                      device="cpu", jax_layout=bundle.jax_layout)
    state = trainer.restore_from(CheckpointManager(str(work / "ckpt_port")))
    one = {k: v.numpy() for k, v in trainer.state_leaves(state).items()}
    assert_leaves_equal(one, saved)
    assert out["restored_fsdp4"].pop("at") == STEPS
    assert_leaves_equal(dump_leaves(out["restored_fsdp4"]), saved)


def test_port_save_restores_in_the_jax_package(ranks):
    out, _, work = ranks
    jt = jax_trainer(MESHES["dp2xfsdp2"])
    js = JaxCheckpointManager(str(work / "ckpt_port")).restore(STEPS, jt.abstract_state(),
                                                               jt.state_shardings())
    assert_leaves_equal(jax_leaves(js), dump_leaves(out["saved"]))


def test_jax_dp2_fsdp2_tp2_save_restores_into_the_ranks(ranks):
    out, want, _ = ranks
    assert_leaves_equal(dump_leaves(out["from_jax"]), want)
