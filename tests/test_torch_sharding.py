"""The port's sharding rules (``easydl_tpu_torch/core/sharding.py``) against
the JAX package's:

- ``DEFAULT_RULES`` is the JAX table, entry for entry;
- every parameter of the port's GPT has logical axes, one entry per
  dimension, and the dimension that FSDP2 shards is the one that the JAX
  ``Trainer.state_shardings`` puts on ``fsdp`` on a dp 2 x fsdp 2 mesh,
  carried through ``convert.py``'s layout; a parameter that JAX keeps
  whole (no ``fsdp`` in its spec) is sharded on dim 0;
- the dimension that the port splits over ``tp`` is the one that the JAX
  ``Trainer.state_shardings`` puts on ``tp`` on a dp 2 x tp 2 mesh,
  carried through ``convert.py``'s layout by whole heads;
- a mesh with ``sp``, ``ep`` or ``pp`` > 1 raises, naming the ROADMAP item
  that brings it; ``tp`` passes where it divides the heads, the hidden
  units and the vocab.
"""

import functools

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


def jax_fsdp_dims(eight_devices, axis="fsdp"):
    """JAX leaf path -> the dim its state sharding puts on ``axis`` (or
    None), on a mesh of 2 over ``axis`` and dp 2."""
    bundle = jax_get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB)
    trainer = JaxTrainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                         optimizer=optax.adamw(1e-3), config=JaxTrainConfig(global_batch=8),
                         mesh_spec=JaxMeshSpec(dp=2, **{axis: 2}))
    out = {}
    for path, shd in jax.tree_util.tree_flatten_with_path(trainer.state_shardings().params)[0]:
        key = jax.tree_util.keystr(path).removesuffix(".value")
        dims = [d for d, axes in enumerate(shd.spec)
                if axes == axis or (isinstance(axes, tuple) and axis in axes)]
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


@pytest.mark.parametrize("axis,item", [("sp", "Queue A 7"), ("ep", "Queue A 7"),
                                       ("pp", "Queue A 7")])
def test_unported_axes_raise_naming_their_roadmap_item(axis, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        sharding.check_mesh(MeshSpec(dp=2, **{axis: 2}))
    sharding.check_mesh(MeshSpec(dp=2, fsdp=4))


def test_tp_passes_where_it_divides_the_model():
    cfg = port_model().cfg  # 4 heads, d_ff 512, vocab 256
    for spec in (MeshSpec(tp=2), MeshSpec(fsdp=2, tp=2), MeshSpec(dp=2, tp=4)):
        sharding.check_mesh(spec, cfg)
    with pytest.raises(ValueError, match="tp=8 does not divide n_heads=4"):
        sharding.check_mesh(MeshSpec(tp=8), cfg)
    bundle = get_model("gpt", size="test", seq_len=SEQ, vocab=VOCAB + 2)
    with pytest.raises(ValueError, match="does not divide vocab=258"):
        sharding.check_mesh(MeshSpec(tp=4), bundle.init_fn(0, "cpu").cfg)


def test_tp_dims_match_jax_state_shardings(eight_devices):
    """Halve each parameter's port tp dim (tp 2), carry the shapes through
    ``convert.to_jax_tree`` (by head_dim: a block of whole heads): the JAX
    dim that halves is the one the JAX package shards on tp; the parameters
    the rules keep whole over tp are the JAX leaves with no tp dim."""
    want = jax_fsdp_dims(eight_devices, axis="tp")
    params = dict(port_model().named_parameters())
    head_dim = params["blocks.0.q.weight"].shape[0] // N_HEADS
    to_jax = functools.partial(convert.to_jax_tree, n_heads=N_HEADS, head_dim=head_dim)
    full = dict(leaf_keys(to_jax({n: torch.empty(p.shape, device="meta")
                                  for n, p in params.items()})))
    whole = []
    for name, p in params.items():
        suffix = name.split(".", 2)[2] if name.startswith("blocks.") else name
        dim = sharding.tp_dim(sharding.gpt_param_axes(name))
        if dim is None:
            whole.append(suffix)
            continue
        shapes = {n: torch.empty(q.shape, device="meta") for n, q in params.items()}
        half = list(p.shape)
        half[dim] //= 2
        for other in params:  # every layer's, so that the stacked leaf changes
            if other == name or (name.startswith("blocks.") and other.startswith("blocks.")
                                 and other.endswith("." + suffix)):
                shapes[other] = torch.empty(half, device="meta")
        split = {k: [d for d, (a, b) in enumerate(zip(s, full[k])) if a != b]
                 for k, s in leaf_keys(to_jax(shapes))}
        changed = {k: d for k, d in split.items() if d}
        assert len(changed) == 1, (name, changed)
        (key, dims), = changed.items()
        assert dims == [want[key]], (name, key, dims, want[key])
    jax_whole = sorted(k for k, d in want.items() if d is None)
    assert jax_whole == ["['blocks']['down']['bias']", "['blocks']['ln_attn']['bias']",
                         "['blocks']['ln_attn']['scale']", "['blocks']['ln_mlp']['bias']",
                         "['blocks']['ln_mlp']['scale']", "['blocks']['out']['bias']",
                         "['ln_f']['bias']", "['ln_f']['scale']", "['pos_emb']"]
    assert sorted(set(whole)) == ["down.bias", "ln_attn.bias", "ln_attn.weight", "ln_f.bias",
                                  "ln_f.weight", "ln_mlp.bias", "ln_mlp.weight", "out.bias",
                                  "pos_emb"]


def test_mesh_axes_follow_the_rules():
    assert sharding.mesh_axes(sharding.gpt_param_axes("blocks.3.q.weight")) == (("tp",), ("fsdp",))
    assert sharding.mesh_axes(sharding.gpt_param_axes("tok_emb.weight")) == (("tp",), ("fsdp",))
    assert sharding.mesh_axes(sharding.gpt_param_axes("pos_emb")) == (("sp",), ("fsdp",))
    assert sharding.mesh_axes(sharding.gpt_param_axes("blocks.0.q.bias")) == (("tp",),)
    assert sharding.fsdp_dim(sharding.gpt_param_axes("blocks.0.q.bias")) is None
    assert sharding.tp_dim(sharding.gpt_param_axes("blocks.0.q.weight")) == 0
    assert sharding.tp_dim(sharding.gpt_param_axes("blocks.0.out.weight")) == 1
    assert sharding.tp_dim(sharding.gpt_param_axes("tok_emb.weight")) == 0
    assert sharding.tp_dim(sharding.gpt_param_axes("blocks.0.down.bias")) is None
