"""The port's tensor parallelism (``tp``): four gloo ranks on the CPU at
fsdp 2 x tp 2 and dp 2 x tp 2, against the JAX package on the same meshes.

One spawn of four ranks serves the whole module, as in
``tests/test_torch_distributed.py``: each rank is this file run as a script
(``python tests/test_torch_tensor_parallel.py RANK WORKDIR``), joins a gloo
group through a ``FileStore`` (60 s collective timeout), runs every case
below, and rank 0 writes what the tests compare. The parent computes the
JAX runs while the ranks run; the join has a deadline (:data:`DEADLINE_S`).
The rank side imports no JAX.

Cases, gpt ``test`` (seq 64, vocab 256, 4 heads: 2 a rank), global batch 8,
grad_accum 2, AdamW(1e-3, weight decay 1e-4), from the JAX package's init
carried over by ``convert.py``, 3 steps against the JAX ``Trainer`` on the
same mesh (4 of the forced host devices): loss, grad_norm and perplexity
within 1e-5 relative in f32 and 2e-3 in bf16, the parameters in relative
L2 within the same bounds (key biases left out, as in
``test_torch_distributed.py``):

- the logits loss and the chunked loss (``fused_loss``), f32 and bf16, on
  both meshes: four runs, in which each two of mesh, dtype and loss meet
  in every combination;
- targets of -1 spread unevenly over the batch ranks;
- a planted fault, the batch group left as the whole world (each ``tp``
  group's rows counted twice in every sum): its grad_norm misses the JAX
  one by far more than the bound; a loss that never calls ``batch_sum`` is
  refused;
- remat "dots" equal to no remat, exactly (bf16);
- bert ``test`` in f32 at fsdp 2 x tp 2 (grad_accum 2) and dp 2 x tp 2
  (grad_accum 1): loss, grad_norm and ``mlm_accuracy``, the mask drawn by
  each rank for its rows, the accuracy's argmax across the vocab shards;
- the vocab-parallel cross-entropy, its gradient and the argmax (with ties
  across and within the shards) against the unsharded ones;
- a fsdp 2 x tp 2 checkpoint: every chunk written by exactly one rank;
  restored bit-exactly into a one-process port ``Trainer``, onto fsdp 4
  ranks and into the JAX ``CheckpointManager`` at dp 2 x fsdp 2 x tp 2; the
  JAX dp 2 x fsdp 2 x tp 2 save and a one-process port save restored
  bit-exactly onto fsdp 2 x tp 2; the q bias, split over tp and again by
  FSDP2 (``_StridedShard``), is whole heads of its JAX leaf on every rank.
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
WORLD, DEADLINE_S = 4, 360
SEQ, VOCAB, N_HEADS, BATCH, ACCUM, STEPS = 64, 256, 4, 8, 2, 3
LR, WD, SEED = 1e-3, 1e-4, 0
MESHES = {"fsdp2xtp2": dict(fsdp=2, tp=2), "dp2xtp2": dict(dp=2, tp=2)}
#: (mesh, dtype, fused_loss): every pair of two of the three choices, once
GPT_CASES = [("fsdp2xtp2", "f32", False), ("fsdp2xtp2", "bf16", True),
             ("dp2xtp2", "bf16", False), ("dp2xtp2", "f32", True)]
#: BERT's cases: (mesh, grad_accum), at f32 compute
BERT_CASES = [("fsdp2xtp2", 2), ("dp2xtp2", 1)]
DTYPES = {"f32": ("float32", 1e-5), "bf16": ("bfloat16", 2e-3)}
K_BIAS = ".k.bias"
Q_BIAS = ".params['blocks']['q']['bias'].value"


def case_name(mesh, dtype, fused):
    return f"{mesh}-{dtype}-{'fused' if fused else 'logits'}"


def host_batches(uneven: bool):
    """The global batches: the bundle's synthetic stream (seed 0);
    ``uneven`` masks targets so that the two batch ranks' rows (four each)
    hold unequal counts in each microbatch."""
    from easydl_tpu_torch.core.data import SyntheticTokens

    data = iter(SyntheticTokens(BATCH, SEQ, vocab=VOCAB, seed=0))
    for _ in range(STEPS):
        batch = next(data)
        if uneven:
            targets = batch["targets"].copy()
            targets[0, 8:] = -1
            targets[1, 40:] = -1
            targets[5, :20] = -1
            targets[7, 4:] = -1
            batch = {"inputs": batch["inputs"], "targets": targets}
        yield batch


# ------------------------------------------------------------------ rank side
def _vocab_parallel_case(tp_mesh) -> dict:
    """The vocab-parallel loss, its gradient and the argmax on this rank's
    half of seeded logits, beside the unsharded ones."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Shard

    from easydl_tpu_torch.ops import vocab_parallel

    gen = torch.Generator().manual_seed(7)
    full = torch.randn(2, 6, VOCAB, generator=gen)
    full[0, 0, 10] = full[0, 0, 200] = full[0, 0].max() + 1.0   # a tie across the shards
    full[0, 1, 30] = full[0, 1, 31] = full[0, 1].max() + 1.0    # within one shard
    full[1, 2, 250] = full[1, 2, 129] = full[1, 2].max() + 1.0  # within the other
    targets = torch.randint(0, VOCAB, (2, 6), generator=gen)
    half = VOCAB // tp_mesh.size()
    local = full[..., tp_mesh.get_local_rank() * half:][..., :half].clone().requires_grad_()
    logits = DTensor.from_local(local, tp_mesh, [Shard(2)], run_check=False)
    losses = vocab_parallel.cross_entropy(logits, targets)
    (losses * torch.arange(1.0, 13.0).view(2, 6)).sum().backward()
    grads = [torch.empty_like(local) for _ in range(tp_mesh.size())]
    torch.distributed.all_gather(grads, local.grad, group=tp_mesh.get_group())
    ref = full.clone().requires_grad_()
    ref_losses = F.cross_entropy(ref.view(-1, VOCAB), targets.view(-1),
                                 reduction="none").view(2, 6)
    (ref_losses * torch.arange(1.0, 13.0).view(2, 6)).sum().backward()
    return {"losses": losses.detach(), "ref_losses": ref_losses.detach(),
            "grad": torch.cat(grads, -1), "ref_grad": ref.grad,
            "argmax": vocab_parallel.argmax(logits), "ref_argmax": full.argmax(-1)}


def _rank_cases(rank: int, work: Path) -> None:
    import torch.distributed as dist

    from easydl_tpu_torch.core import jax_state, train_loop
    from easydl_tpu_torch.core import mesh as port_mesh
    from easydl_tpu_torch.core.checkpoint import (CheckpointManager, Shards,
                                                  restore_with_fallback)
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model

    torch.set_num_threads(2)
    port_mesh.init_distributed("cpu", rank=rank, world_size=WORLD, local_rank=rank,
                               store=dist.FileStore(str(work / "store"), WORLD),
                               timeout=timedelta(seconds=60))
    init = torch.load(work / "init.pt")
    out = {}

    def trainer(spec, dtype="float32", model="gpt", init_sd=init, accum=ACCUM, **options):
        bundle = get_model(model, size="test", seq_len=SEQ, vocab=VOCAB, **options)

        def init_fn(seed, device):
            net = bundle.init_fn(seed, device)
            net.load_state_dict(init_sd)
            return net

        return Trainer(init_fn=init_fn, loss_fn=bundle.loss_fn,
                       optimizer=functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
                       config=TrainConfig(global_batch=BATCH, grad_accum=accum,
                                          compute_dtype=getattr(torch, dtype), seed=SEED),
                       device="cpu", jax_layout=bundle.jax_layout,
                       mesh_spec=port_mesh.MeshSpec(**spec), param_axes=bundle.param_axes)

    def full(t):
        return t.full_tensor().detach().clone()

    def dump(state):
        opt = state.optimizer.state
        named = list(state.model.named_parameters())
        return {"step": state.step, "count": {int(opt[p]["step"]) for _, p in named},
                "params": {n: full(p) for n, p in named},
                "mu": {n: full(opt[p]["exp_avg"]) for n, p in named},
                "nu": {n: full(opt[p]["exp_avg_sq"]) for n, p in named}}

    def train(tr, uneven=False, metrics=("loss", "grad_norm", "perplexity")):
        state, traj, grads = tr.init_state(), [], None
        n = BATCH // tr.ranks
        for batch in host_batches(uneven):
            state, m = tr.train_step(state, {k: v[tr.rank * n:(tr.rank + 1) * n]
                                             for k, v in batch.items()})
            traj.append([float(m[k]) for k in metrics])
            if grads is None:
                grads = {k: full(p.grad) for k, p in state.model.named_parameters()}
        return state, {"traj": traj, "grads": grads,
                       "params": {k: full(p) for k, p in state.model.named_parameters()}}

    tr = trainer(MESHES["fsdp2xtp2"])
    layout = [None] * WORLD
    dist.all_gather_object(layout, (tr.mesh.get_coordinate(), tr.rank,
                                    port_mesh.batch_ranks(tr.mesh)))
    out["layout"] = layout
    out["vocab_parallel"] = _vocab_parallel_case(tr.mesh["tp"])

    for mesh, dtype, fused in GPT_CASES:
        tr = trainer(MESHES[mesh], DTYPES[dtype][0], fused_loss=fused)
        state, out[case_name(mesh, dtype, fused)] = train(tr)
        if (mesh, dtype, fused) != ("fsdp2xtp2", "f32", False):
            continue
        mgr = CheckpointManager(str(work / "ckpt_port"))
        leaves = tr.state_leaves(state)
        mgr.save(state.step, leaves)
        mgr.wait()
        chunks = {k: [b for b, _ in v.chunks] for k, v in leaves.items() if isinstance(v, Shards)}
        out["chunks"] = [None] * WORLD
        dist.all_gather_object(out["chunks"], chunks)
        regions = jax_state.leaf_regions(state.model, tr.jax_layout)
        q_bias = [None] * WORLD  # every rank writes its own block
        dist.all_gather_object(q_bias, (regions[Q_BIAS], leaves[Q_BIAS].chunks[0][1]))
        out["q_bias"] = q_bias
        out["saved"] = dump(state)
        restored, step = restore_with_fallback(
            mgr, lambda s: trainer(dict(fsdp=4)).restore_from(mgr, s))
        out["restored_fsdp4"] = {"at": step, **dump(restored)}
        del restored

    _, out["uneven"] = train(trainer(MESHES["fsdp2xtp2"]), uneven=True)

    # the planted fault: the loss's sums over the whole world, so that the tp
    # ranks' rows count again in every one
    real_group = train_loop.batch_group
    train_loop.batch_group = lambda group: real_group(dist.group.WORLD)
    try:
        _, out["world-sum"] = train(trainer(MESHES["fsdp2xtp2"]))
    finally:
        train_loop.batch_group = real_group

    def rank_mean(model, batch, rng):  # never sums over the ranks
        return model(batch["inputs"]).to_local().float().logsumexp(-1).mean(), {}

    tr = trainer(MESHES["fsdp2xtp2"])
    tr.loss_fn = rank_mean
    try:
        train(tr)
        out["unsummed"] = None
    except RuntimeError as e:
        out["unsummed"] = str(e)

    for remat in (False, True):
        _, out[f"remat-{remat}"] = train(trainer(MESHES["fsdp2xtp2"], "bfloat16", remat=remat,
                                                 remat_policy="dots"))

    for name in ("jax", "one"):
        out[f"from_{name}"] = dump(trainer(MESHES["fsdp2xtp2"]).restore_from(
            CheckpointManager(str(work / f"ckpt_{name}"))))

    bert_init = torch.load(work / "init_bert.pt")
    for mesh, accum in BERT_CASES:
        _, out[f"bert-{mesh}-a{accum}"] = train(
            trainer(MESHES[mesh], model="bert", init_sd=bert_init, accum=accum),
            metrics=("loss", "grad_norm", "mlm_accuracy"))
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
from easydl_tpu_torch.elastic.worker import agent_rows  # noqa: E402
from easydl_tpu_torch.models.registry import get_model  # noqa: E402

JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
JAX_SAVE_MESH = dict(dp=2, fsdp=2, tp=2)


def jax_trainer(spec, dtype="f32", model="gpt", accum=ACCUM, **options):
    bundle = jax_get_model(model, size="test", seq_len=SEQ, vocab=VOCAB, **options)
    return JaxTrainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                      optimizer=optax.adamw(LR, weight_decay=WD),
                      config=JaxTrainConfig(global_batch=BATCH, grad_accum=accum,
                                            compute_dtype=JAX_DTYPES[dtype], seed=SEED),
                      mesh_spec=MeshSpec(**spec))


def unboxed(params):
    return jax.tree.map(np.asarray, flax.linen.meta.unbox(params))


def jax_leaves(state):
    return {jax.tree_util.keystr(p): np.asarray(jax.device_get(x))
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


@functools.lru_cache(maxsize=None)
def jax_run(mesh: str, dtype: str = "f32", fused: bool = False, uneven: bool = False,
            model: str = "gpt", accum: int = ACCUM):
    """3 steps of the JAX ``Trainer``: (trajectory, final params)."""
    options = {"fused_loss": fused} if model == "gpt" else {}
    keys = ("loss", "grad_norm", "perplexity" if model == "gpt" else "mlm_accuracy")
    trainer = jax_trainer(MESHES[mesh], dtype, model=model, accum=accum, **options)
    state, traj = trainer.init_state(), []
    for batch in host_batches(uneven):
        state, m = trainer.train_step(state, batch)
        m = jax.device_get(m)
        traj.append([float(m[k]) for k in keys])
    return np.array(traj), unboxed(state.params)


def jax_runs():
    """Every JAX run the tests compare with, in the order they are read."""
    for mesh, dtype, fused in GPT_CASES:
        jax_run(mesh, dtype, fused)
    jax_run("fsdp2xtp2", uneven=True)
    for mesh, accum in BERT_CASES:
        jax_run(mesh, model="bert", accum=accum)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eight_devices):
    """Runs the four ranks once, the JAX runs meanwhile; returns (rank 0's
    results, the JAX dp 2 x fsdp 2 x tp 2 state the ranks restored, the
    work dir)."""
    work = tmp_path_factory.mktemp("tp_ranks")
    jt = jax_trainer(JAX_SAVE_MESH)
    js = jt.init_state()
    torch.save(convert.params_from_jax(unboxed(js.params)), work / "init.pt")
    for batch in host_batches(False):
        js, _ = jt.train_step(js, batch)
    JaxCheckpointManager(str(work / "ckpt_jax"), async_save=False).save(STEPS, js)
    one = one_process()  # the JAX save, restored and saved again by one process
    CheckpointManager(str(work / "ckpt_one"), async_save=False).save(
        STEPS, one.state_leaves(one.restore_from(CheckpointManager(str(work / "ckpt_jax")))))
    bert_params = jax_trainer(MESHES["dp2xtp2"], model="bert").init_state().params
    torch.save(convert.params_from_jax(unboxed(bert_params)), work / "init_bert.pt")

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    logs = [open(work / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(work)], env=env, cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        jax_runs()
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


def one_process():
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    return Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                   optimizer=functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD),
                   config=TrainConfig(global_batch=BATCH, compute_dtype=torch.float32),
                   device="cpu", jax_layout=bundle.jax_layout)


def flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat(tree[k], f"{prefix}['{k}']")
        else:
            yield f"{prefix}['{k}']", np.asarray(tree[k])


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_params_close(got: dict, want_tree, tol: float):
    """``got`` (port names -> tensors) against the JAX tree: the parameter
    vector in relative L2, the key biases left out."""
    want = dict(flat(want_tree))
    got = dict(flat(convert.params_to_jax(got, N_HEADS)))
    assert set(got) == set(want)
    keys = [k for k in want if "['k']['bias']" not in k]
    whole = rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                   np.concatenate([want[k].ravel() for k in keys]))
    worst = sorted(((k, rel_l2(got[k], want[k])) for k in keys), key=lambda kv: -kv[1])
    assert whole <= tol, (whole, worst[:4])


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


def test_ranks_are_laid_out_as_the_jax_mesh_with_tp_innermost(ranks):
    out, _, _ = ranks
    from easydl_tpu.core.mesh import build_mesh

    mesh = build_mesh(MeshSpec(**MESHES["fsdp2xtp2"]))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    want = [tuple(int(c[0]) for c in np.nonzero(ids == r)) for r in range(WORLD)]
    assert [tuple(coord) for coord, _, _ in out["layout"]] == want
    # the ranks of a tp group share their batch coordinate; a batch group
    # holds one rank of each tp group
    assert [place for _, place, _ in out["layout"]] == [0, 0, 1, 1]
    assert all(groups == [[0, 2], [1, 3]] for _, _, groups in out["layout"])


@pytest.mark.parametrize("mesh,dtype,fused", GPT_CASES,
                         ids=[case_name(*c) for c in GPT_CASES])
def test_gpt_matches_the_jax_trainer(ranks, mesh, dtype, fused):
    out, _, _ = ranks
    want, params = jax_run(mesh, dtype, fused)
    got = out[case_name(mesh, dtype, fused)]
    tol = DTYPES[dtype][1]
    assert want[-1, 0] < want[0, 0]  # it trains
    np.testing.assert_allclose(got["traj"], want, rtol=tol, atol=0)
    assert_params_close(got["params"], params, tol)


def test_uneven_masks_match_the_jax_trainer(ranks):
    out, _, _ = ranks
    want, params = jax_run("fsdp2xtp2", uneven=True)
    np.testing.assert_allclose(out["uneven"]["traj"], want, rtol=1e-5, atol=0)
    assert_params_close(out["uneven"]["params"], params, 1e-5)


def test_a_batch_group_over_the_whole_world_is_caught(ranks):
    """Summing over every rank counts each tp group's rows twice: loss and
    denominator double alike, the gradients halve, and the grad norm reads
    half the JAX one; the sound run holds it within 1e-5."""
    out, _, _ = ranks
    want, _ = jax_run("fsdp2xtp2")
    np.testing.assert_allclose(out["fsdp2xtp2-f32-logits"]["traj"], want, rtol=1e-5, atol=0)
    fault = np.array(out["world-sum"]["traj"])
    np.testing.assert_allclose(fault[:, 1], want[:, 1] / 2, rtol=1e-3)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(fault, want, rtol=100 * 1e-5, atol=0)


def test_a_loss_that_skips_batch_sum_is_refused_under_tp(ranks):
    assert "never called core.mesh.batch_sum" in (ranks[0]["unsummed"] or "")


def test_remat_dots_equals_no_remat_under_tp(ranks):
    out, _, _ = ranks
    plain, remat = out["remat-False"], out["remat-True"]
    assert remat["traj"] == plain["traj"]
    for kind in ("grads", "params"):
        for name, t in plain[kind].items():
            torch.testing.assert_close(remat[kind][name], t, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("mesh,accum", BERT_CASES)
def test_bert_matches_the_jax_trainer(ranks, mesh, accum):
    out, _, _ = ranks
    want, params = jax_run(mesh, model="bert", accum=accum)
    got = out[f"bert-{mesh}-a{accum}"]
    np.testing.assert_allclose(got["traj"], want, rtol=1e-5, atol=1e-7)
    assert_params_close(got["params"], params, 1e-5)


def test_vocab_parallel_loss_and_argmax_match_the_unsharded_ones(ranks):
    got = ranks[0]["vocab_parallel"]
    torch.testing.assert_close(got["losses"], got["ref_losses"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got["grad"], got["ref_grad"], rtol=1e-6, atol=1e-7)
    assert torch.equal(got["argmax"], got["ref_argmax"])
    assert got["argmax"][0, 0] == 10 and got["argmax"][0, 1] == 30  # ties: the lowest index
    assert got["argmax"][1, 2] == 129


def test_each_chunk_is_written_by_one_rank(ranks):
    out, _, work = ranks
    step_dir = work / "ckpt_port" / f"step_{STEPS:08d}"
    for key in out["chunks"][0]:
        written = [tuple(map(tuple, b)) for rank in out["chunks"] for b in rank[key]]
        assert len(written) == len(set(written)), (key, written)
    files = sum(len(os.listdir(step_dir / d)) for d in os.listdir(step_dir)
                if d.startswith("leaf_"))
    assert files == sum(len(r[k]) for r in out["chunks"] for k in r) + 3  # + step, count, rng
    # tok_emb: split on vocab (tp) and embed (fsdp), four blocks; a LayerNorm:
    # whole over tp, two fsdp blocks, written by the tp rank 0 of each
    emb = ".params['tok_emb']['embedding'].value"
    assert sorted(len(r[emb]) for r in out["chunks"]) == [1, 1, 1, 1]
    ln = ".params['ln_f']['scale'].value"
    assert [len(r[ln]) for r in out["chunks"]] == [1, 0, 1, 0]


def test_strided_bias_blocks_are_whole_heads(ranks):
    """The q bias has tp and FSDP2's fallback on one dimension: each rank's
    block is one head (of 4) of the JAX ``(L, heads, kv)`` leaf, in the
    order tp-major, and holds that head."""
    out, _, _ = ranks
    leaf = dump_leaves(out["saved"])[Q_BIAS]
    heads = []
    for bounds, block in out["q_bias"]:
        (l0, l1), (h0, h1), (k0, k1) = bounds
        assert (l0, l1, k0, k1) == (0, leaf.shape[0], 0, leaf.shape[2])
        np.testing.assert_array_equal(np.asarray(block), leaf[:, h0:h1])
        heads.append((h0, h1))
    assert heads == [(0, 1), (2, 3), (1, 2), (3, 4)]  # rank (fsdp f, tp t): head 2t + f


def test_tp_save_restores_into_one_process_and_onto_fsdp4(ranks):
    out, _, work = ranks
    saved = dump_leaves(out["saved"])
    trainer = one_process()
    state = trainer.restore_from(CheckpointManager(str(work / "ckpt_port")))
    assert_leaves_equal({k: v.numpy() for k, v in trainer.state_leaves(state).items()}, saved)
    assert out["restored_fsdp4"].pop("at") == STEPS
    assert_leaves_equal(dump_leaves(out["restored_fsdp4"]), saved)


def test_tp_save_restores_in_the_jax_package(ranks):
    out, _, work = ranks
    jt = jax_trainer(JAX_SAVE_MESH)
    js = JaxCheckpointManager(str(work / "ckpt_port")).restore(STEPS, jt.abstract_state(),
                                                               jt.state_shardings())
    assert_leaves_equal(jax_leaves(js), dump_leaves(out["saved"]))


@pytest.mark.parametrize("saved_by", ["jax", "one"])
def test_saves_restore_onto_fsdp2_tp2(ranks, saved_by):
    """The JAX dp 2 x fsdp 2 x tp 2 save, and the same state saved by one
    port process, restore bit-exactly onto the fsdp 2 x tp 2 ranks."""
    out, want, _ = ranks
    assert_leaves_equal(dump_leaves(out[f"from_{saved_by}"]), want)


@pytest.mark.parametrize("nproc,tp,want", [
    (4, 1, [(0, 2), (2, 4), (4, 6), (6, 8)]),
    (4, 2, [(0, 4), (0, 4), (4, 8), (4, 8)]),
    (4, 4, [(0, 8)] * 4),
    (2, 2, [(0, 8)] * 2),
])
def test_the_workers_rows_under_tp(nproc, tp, want):
    """An agent's local ranks: a tp group (consecutive local ranks) takes
    one share of the agent's 8 rows, the batch ranks in order."""
    got = [agent_rows(8, nproc, r, tp) for r in range(nproc)]
    assert [(s.start, s.stop) for s in got] == want


def test_the_workers_rows_refuse_a_split_tp_group():
    with pytest.raises(ValueError, match="does not divide"):
        agent_rows(8, 2, 0, tp=4)
