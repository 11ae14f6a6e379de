"""The port's mesh modules against the JAX package's:

- ``easydl_tpu_torch/core/mesh_shapes.py`` gives the same answers as
  ``easydl_tpu.core.mesh_shapes`` (keys, parsing, ``from_world``, axis
  sizes, validation, enumeration) over a grid of world sizes and
  constraints;
- ``core/mesh.build_mesh`` lays the ranks out as the JAX reshape lays out
  the devices, and ``batch_divisor`` agrees; a mesh of the wrong size and
  an indivisible ``num_slices`` raise;
- ``init_distributed`` takes its backend from the device, and a CUDA rank
  without a card raises before joining a group.

One-rank gloo groups (a ``FileStore`` under ``tmp_path``) in this process
stand in for the world; ``tests/test_torch_distributed.py`` runs four.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from easydl_tpu.core import mesh_shapes as jax_shapes  # noqa: E402
from easydl_tpu_torch.core import mesh as port_mesh  # noqa: E402
from easydl_tpu_torch.core import mesh_shapes as port_shapes  # noqa: E402

WORLDS = [1, 2, 3, 4, 6, 8, 12, 16, 32]
CONSTRAINTS = [
    {},
    {"max_tp": 4, "tp_divides": 16, "max_fsdp": 4},
    {"max_fsdp": 8, "min_model": 2},
    {"max_tp": 2, "max_pp": 4, "pp_divides": 24, "max_dp": 4},
    {"max_tp": 8, "tp_divides": 12, "max_fsdp": 2, "max_pp": 2, "min_model": 4},
]


def as_tuple(spec):
    return tuple(getattr(spec, a) for a in ("dp", "fsdp", "tp", "sp", "ep", "pp"))


def test_axes_are_the_jax_packages():
    assert port_shapes.AXES == jax_shapes.AXES
    assert port_shapes.BATCH_AXES == jax_shapes.BATCH_AXES
    assert port_mesh.AXES is port_shapes.AXES


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("constraints", CONSTRAINTS, ids=lambda c: ",".join(c) or "default")
def test_shape_algebra_matches_jax(world, constraints):
    pc = port_shapes.MeshConstraints.from_dict({**constraints, "unknown": 3})
    jc = jax_shapes.MeshConstraints.from_dict({**constraints, "unknown": 3})
    port = port_shapes.enumerate_shapes(world, pc)
    want = jax_shapes.enumerate_shapes(world, jc)
    assert [as_tuple(s) for s in port] == [as_tuple(s) for s in want]
    for p, j in zip(port, want):
        assert p.key() == j.key() and p.describe() == j.describe()
        assert p.axis_sizes() == j.axis_sizes() and p.size == j.size
        assert as_tuple(port_shapes.MeshSpec.parse(p.key())) == as_tuple(p)
    # every factorization, valid or not, gets the same verdict
    for dp, fsdp, tp, pp in itertools.product(*[[d for d in range(1, world + 1)
                                                 if world % d == 0]] * 4):
        if dp * fsdp * tp * pp != world:
            continue
        args = dict(dp=dp, fsdp=fsdp, tp=tp, pp=pp)
        assert (port_shapes.validate_shape(port_shapes.MeshSpec(**args), world, pc)
                == jax_shapes.validate_shape(jax_shapes.MeshSpec(**args), world, jc))
    for model in ({}, {"fsdp": 2}, {"tp": 2, "pp": 2}, {"tp": 3}):
        try:
            want_spec = jax_shapes.MeshSpec.from_world(world, **model)
        except ValueError as e:
            with pytest.raises(ValueError, match="not divisible"):
                port_shapes.MeshSpec.from_world(world, **model)
            assert "not divisible" in str(e)
            continue
        assert as_tuple(port_shapes.MeshSpec.from_world(world, **model)) == as_tuple(want_spec)


@pytest.mark.parametrize("key", ["dp=1", "dp=2,fsdp=2,tp=2", " tp = 4 , dp=2", "pp=2,ep=2",
                                 "", "dp=0", "dp=2,dp=2", "xx=2", "dp=two"])
def test_parse_matches_jax(key):
    try:
        want = as_tuple(jax_shapes.MeshSpec.parse(key))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_shapes.MeshSpec.parse(key)
        assert str(got.value) == str(e)
        return
    assert as_tuple(port_shapes.MeshSpec.parse(key)) == want


@pytest.fixture
def one_rank_group(tmp_path):
    dev = port_mesh.init_distributed("cpu", rank=0, world_size=1, local_rank=0,
                                     store=dist.FileStore(str(tmp_path / "store"), 1))
    yield dev
    dist.destroy_process_group()


def test_init_distributed_takes_gloo_for_the_cpu(one_rank_group):
    assert one_rank_group == torch.device("cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1


@pytest.mark.parametrize("spec", [dict(), dict(pp=1, dp=1)])
def test_build_mesh_names_the_jax_axes(one_rank_group, spec):
    mesh = port_mesh.build_mesh(port_mesh.MeshSpec(**spec), "cpu")
    assert mesh.mesh_dim_names == port_mesh.AXES
    assert tuple(mesh.mesh.shape) == (1,) * len(port_mesh.AXES)
    assert port_mesh.batch_divisor(mesh) == 1
    with pytest.raises(ValueError, match="needs 4 ranks"):
        port_mesh.build_mesh(port_mesh.MeshSpec(dp=4), "cpu")


@pytest.mark.parametrize("spec", [dict(dp=4), dict(dp=2, fsdp=2), dict(dp=2, fsdp=2, tp=2),
                                  dict(pp=2, dp=2, tp=2), dict(fsdp=2, ep=2, sp=2)])
def test_rank_layout_is_the_jax_reshape(spec):
    """The ranks in ``AXES`` order, row-major: ``dp`` the major stride, as
    ``np.asarray(devices).reshape(spec.axis_sizes())`` lays devices out."""
    s = port_shapes.MeshSpec(**spec)
    ranks = torch.arange(s.size, dtype=torch.int).reshape(s.axis_sizes())
    want = np.arange(s.size).reshape(jax_shapes.MeshSpec(**spec).axis_sizes())
    np.testing.assert_array_equal(ranks.numpy(), want)
    assert want.shape[port_shapes.AXES.index("dp")] == s.dp


def test_batch_divisor_matches_jax(eight_devices):
    from easydl_tpu.core.mesh import batch_divisor, build_mesh

    class Fake:  # batch_divisor reads only the axis sizes
        def __init__(self, spec):
            self.mesh_dim_names = port_shapes.AXES
            self._sizes = spec.axis_sizes()

        def size(self, dim):
            return self._sizes[dim]

    for spec in (dict(dp=8), dict(dp=2, fsdp=2, tp=2), dict(fsdp=4, tp=2), dict(pp=2, dp=4)):
        want = batch_divisor(build_mesh(jax_shapes.MeshSpec(**spec), eight_devices))
        assert port_mesh.batch_divisor(Fake(port_shapes.MeshSpec(**spec))) == want


def test_num_slices_must_divide_dp(one_rank_group):
    with pytest.raises(ValueError, match="divisible by num_slices"):
        port_mesh.build_mesh(port_mesh.MeshSpec(dp=3), "cpu", num_slices=2)


def test_cuda_rank_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_mesh.init_distributed("cuda", rank=0, world_size=1, local_rank=0,
                                   store=dist.FileStore(str(tmp_path / "store"), 1))
    assert not dist.is_initialized()


def test_rank_and_world_come_from_the_environment(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="RANK is not set"):
        port_mesh.init_distributed("cpu")


@pytest.mark.parametrize("spec,error", [(dict(tp=2), "param_axes"),  # tp passes the axes
                                        (dict(pp=2), "ROADMAP.md Queue A 7"),
                                        (dict(dp=1), "param_axes")])
def test_trainer_refuses_a_mesh_it_cannot_shard(one_rank_group, spec, error):
    import functools

    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model

    bundle = get_model("gpt", size="test", seq_len=16, vocab=64)
    with pytest.raises((NotImplementedError, ValueError), match=error):
        Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                optimizer=functools.partial(torch.optim.AdamW, lr=1e-3),
                config=TrainConfig(global_batch=4), device="cpu",
                mesh_spec=port_mesh.MeshSpec(**spec))


def test_one_rank_mesh_trains_as_one_device(one_rank_group):
    """dp 1 x fsdp 1 through FSDP2 gives the one-device path's f32 losses."""
    import functools

    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model

    bundle = get_model("gpt", size="test", seq_len=16, vocab=64)
    runs = []
    for mesh in (None, port_mesh.MeshSpec()):
        trainer = Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                          optimizer=functools.partial(torch.optim.AdamW, lr=1e-3),
                          config=TrainConfig(global_batch=4, grad_accum=2,
                                             compute_dtype=torch.float32),
                          device="cpu", mesh_spec=mesh, param_axes=bundle.param_axes)
        state = trainer.init_state()
        data = iter(bundle.make_data(4, seed=0))
        runs.append([float(trainer.train_step(state, next(data))[1]["loss"])
                     for _ in range(2)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6, atol=0)


def test_tp_collectives_are_the_identity_without_a_group(one_rank_group):
    """No tp group, or one of a single rank: copy_to_tp and reduce_from_tp
    pass values and gradients through unchanged."""
    x = torch.randn(3, 4, requires_grad=True)
    for group in (None, dist.group.WORLD):
        for fn in (port_mesh.copy_to_tp, port_mesh.reduce_from_tp):
            y = fn(x, group)
            assert y is x
    mesh = port_mesh.build_mesh(port_mesh.MeshSpec(), "cpu")
    assert port_mesh.batch_coordinate(mesh) == 0
    assert port_mesh.batch_ranks(mesh) == [[0]]
    assert port_mesh.batch_process_group(mesh) is dist.group.WORLD
