"""The port's sharding rules (``easydl_tpu_torch/core/sharding.py``) against
the JAX package's:

- ``DEFAULT_RULES`` is the JAX table, entry for entry;
- every parameter of the port's GPT has logical axes, one entry per
  dimension, and the dimension that FSDP2 shards is the one that the JAX
  ``Trainer.state_shardings`` puts on ``fsdp`` on a dp 2 x fsdp 2 mesh,
  carried through ``convert.py``'s layout; a parameter that JAX keeps
  whole (no ``fsdp`` in its spec) is sharded on dim 0;
- a mesh with ``tp``, ``sp``, ``ep`` or ``pp`` > 1 raises, naming the
  ROADMAP item that brings it.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import optax  # noqa: E402

from easydl_tpu.core import sharding as jax_sharding  # noqa: E402
from easydl_tpu.core.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from easydl_tpu.core.train_loop import TrainConfig as JaxTrainConfig  # noqa: E402
from easydl_tpu.core.train_loop import Trainer as JaxTrainer  # noqa: E402
from easydl_tpu.models.registry import get_model as jax_get_model  # noqa: E402
from easydl_tpu_torch import convert  # noqa: E402
from easydl_tpu_torch.core import sharding  # noqa: E402
from easydl_tpu_torch.core.mesh_shapes import MeshSpec  # noqa: E402
from easydl_tpu_torch.models.registry import get_model  # noqa: E402

SEQ, VOCAB, N_HEADS = 64, 256, 4


def test_rules_are_the_jax_packages():
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES


def port_model():
    return get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB).init_fn(0, "cpu")


def test_every_gpt_parameter_has_its_axes():
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    assert bundle.param_axes is sharding.gpt_param_axes
    for name, p in port_model().named_parameters():
        assert len(sharding.gpt_param_axes(name)) == p.dim(), name
    with pytest.raises(KeyError, match="no logical axes"):
        sharding.gpt_param_axes("blocks.0.moe.weight")


def jax_fsdp_dims(eight_devices):
    """JAX leaf path -> the dim its state sharding puts on fsdp (or None)."""
    bundle = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = JaxTrainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                         optimizer=optax.adamw(1e-3), config=JaxTrainConfig(global_batch=8),
                         mesh_spec=JaxMeshSpec(dp=2, fsdp=2))
    out = {}
    for path, shd in jax.tree_util.tree_flatten_with_path(trainer.state_shardings().params)[0]:
        key = jax.tree_util.keystr(path).removesuffix(".value")
        dims = [d for d, axes in enumerate(shd.spec)
                if axes == "fsdp" or (isinstance(axes, tuple) and "fsdp" in axes)]
        out[key] = dims[0] if dims else None
    return out


def leaf_keys(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaf_keys(tree[k], f"{prefix}['{k}']")
        else:
            yield f"{prefix}['{k}']", tuple(tree[k].shape)


def test_fsdp_dims_match_jax_state_shardings(eight_devices):
    """Halve each parameter's port fsdp dim (fsdp 2), carry the shapes
    through ``convert.to_jax_tree``: the JAX dim that halves is the one the
    JAX package shards on fsdp."""
    want = jax_fsdp_dims(eight_devices)
    params = dict(port_model().named_parameters())
    full = dict(leaf_keys(convert.to_jax_tree(
        {n: torch.empty(p.shape, device="meta") for n, p in params.items()}, N_HEADS)))
    assert set(full) == set(want)
    replicated = []
    for name, p in params.items():
        axes = sharding.gpt_param_axes(name)
        dim = sharding.fsdp_dim(axes)
        if dim is None:
            replicated.append(name)
            assert sharding.fsdp_placement(axes) == 0
            continue
        shapes = {n: torch.empty(q.shape, device="meta") for n, q in params.items()}
        half = list(p.shape)
        half[dim] //= 2
        shapes[name] = torch.empty(half, device="meta")
        if name.startswith("blocks."):  # the stacked leaf changes only if every layer's does
            suffix = name.split(".", 2)[2]
            for other in params:
                if other.endswith("." + suffix) and other.startswith("blocks."):
                    shapes[other] = torch.empty(half, device="meta")
        split = {k: [d for d, (a, b) in enumerate(zip(s, full[k])) if a != b]
                 for k, s in leaf_keys(convert.to_jax_tree(shapes, N_HEADS))}
        changed = {k: d for k, d in split.items() if d}
        assert len(changed) == 1, (name, changed)
        (key, dims), = changed.items()
        assert dims == [want[key]], (name, key, dims, want[key])
    # the parameters the rules replicate are the JAX leaves with no fsdp dim
    jax_whole = sorted(k for k, d in want.items() if d is None)
    assert jax_whole == ["['blocks']['k']['bias']", "['blocks']['q']['bias']",
                         "['blocks']['up']['bias']", "['blocks']['v']['bias']"]
    assert sorted({n.split(".", 2)[2] for n in replicated}) == ["k.bias", "q.bias", "up.bias",
                                                                "v.bias"]


def test_shard_placement_fn_gives_fsdp2_the_dims():
    from torch.distributed.tensor import Shard

    model = port_model()
    names = {p: n for n, p in model.named_parameters()}
    placement = sharding.shard_placement_fn(names, sharding.gpt_param_axes)
    got = {n: placement(p) for p, n in names.items()}
    assert got["blocks.0.q.weight"] == Shard(1) and got["blocks.1.out.weight"] == Shard(0)
    assert got["tok_emb.weight"] == Shard(1) and got["pos_emb"] == Shard(1)
    assert got["blocks.0.up.weight"] == Shard(1) and got["blocks.0.down.weight"] == Shard(0)
    assert got["blocks.0.q.bias"] == Shard(0)  # replicated by the rules: dim 0 for FSDP2


@pytest.mark.parametrize("axis,item", [("tp", "Queue A 9b"), ("sp", "Queue A 14"),
                                       ("ep", "Queue A 14"), ("pp", "Queue A 14")])
def test_unported_axes_raise_naming_their_roadmap_item(axis, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        sharding.check_mesh(MeshSpec(dp=2, **{axis: 2}))
    sharding.check_mesh(MeshSpec(dp=2, fsdp=4))


def test_mesh_axes_follow_the_rules():
    assert sharding.mesh_axes(sharding.gpt_param_axes("blocks.3.q.weight")) == (("tp",), ("fsdp",))
    assert sharding.mesh_axes(sharding.gpt_param_axes("tok_emb.weight")) == (("tp",), ("fsdp",))
    assert sharding.mesh_axes(sharding.gpt_param_axes("pos_emb")) == (("sp",), ("fsdp",))
    assert sharding.mesh_axes(sharding.gpt_param_axes("blocks.0.q.bias")) == (("tp",),)
    assert sharding.fsdp_dim(sharding.gpt_param_axes("blocks.0.q.bias")) is None
