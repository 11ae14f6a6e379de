"""Process groups and device meshes: the port's counterpart of
``easydl_tpu/core/mesh.py``.

The JAX package scales by adding chips to one ``jax.sharding.Mesh`` and
lets GSPMD insert the collectives. The port runs one process per GPU
(``python -m torch.distributed.run --nproc-per-node N``), joins them in a
``torch.distributed`` process group and lays their ranks out in a
``DeviceMesh`` whose dimensions carry the JAX axis names (:data:`AXES`), so
the same :class:`MeshSpec` describes a job in either package.

- :func:`init_distributed`: the one way into a process group. NCCL for a
  GPU (``cuda:LOCAL_RANK``), gloo for the CPU, unless the caller names the
  backend; a CUDA rank without a GPU raises, as
  :func:`~easydl_tpu_torch.utils.device.require_device` does.
- :func:`build_mesh` and :func:`batch_divisor`: the JAX functions of the
  same names.
- :func:`batch_group` and :func:`batch_sum`: a loss that is a mean over the
  batch (``models.gpt.lm_loss``, ``ops.fused_xent``) sums its numerator and
  denominator over every rank's rows while the trainer holds the batch
  group, so each rank computes the loss of the global batch, as the JAX
  step does on its sharded batch.
- :func:`batch_coordinate` and :func:`batch_process_group`: ``tp`` is the
  innermost axis of :data:`AXES`, and the ranks of one ``tp`` group hold
  the same rows. A rank's place in the batch is its coordinate on (``dp``,
  ``fsdp``), and the batch group is the ranks that share its ``tp``
  coordinate, one rank of each ``tp`` group.
- :func:`copy_to_tp` and :func:`reduce_from_tp`: Megatron's pair of
  collectives over a ``tp`` group, which GSPMD places in the JAX package.
  The input of a column-parallel product goes through :func:`copy_to_tp`
  (identity forward, all-reduce backward: each rank's product gives only
  its columns' share of the input's gradient); the output of a
  row-parallel product through :func:`reduce_from_tp` (all-reduce forward,
  identity backward). With no group, or a group of one rank, each is the
  identity.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from datetime import timedelta
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from easydl_tpu_torch.core.mesh_shapes import (  # noqa: F401  (re-exported, as in JAX)
    AXES,
    BATCH_AXES,
    MeshConstraints,
    MeshSpec,
    enumerate_shapes,
    validate_shape,
)
from easydl_tpu_torch.utils.device import require_device


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return given
    if name not in os.environ:
        raise ValueError(f"{name} is not set: launch with `python -m torch.distributed.run` "
                         "or pass rank, world_size and local_rank")
    return int(os.environ[name])


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None, store: Optional[dist.Store] = None,
                     timeout: timedelta = timedelta(minutes=10)) -> torch.device:
    """Joins this process to the default process group; returns its device.

    Rank, world size and local rank come from the arguments, else from
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (as ``torch.distributed.run``
    sets them). ``store`` (e.g. a ``FileStore``) replaces the ``env://``
    rendezvous (``MASTER_ADDR``/``MASTER_PORT``). ``device="cuda"`` means
    ``cuda:LOCAL_RANK``; an indexed device is taken as given. The backend is
    NCCL for a GPU and gloo for the CPU unless ``backend`` names another.
    """
    rank, world_size = _env_int("RANK", rank), _env_int("WORLD_SIZE", world_size)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", local_rank))
    dev = require_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, rank=rank, world_size=world_size, timeout=timeout,
        init_method=None if store is not None else "env://", store=store,
        device_id=dev if backend == "nccl" else None)
    return dev


def build_mesh(spec: MeshSpec, device="cuda", num_slices: int = 1) -> DeviceMesh:
    """A ``DeviceMesh`` of every rank of the default group, shaped
    ``spec.axis_sizes()`` and named :data:`AXES`; ranks are laid out in
    ``AXES`` order (row-major), so ``dp`` is the major stride, as in the
    JAX reshape of the device list.

    ``num_slices > 1`` needs ``spec.dp % num_slices == 0`` (only ``dp`` may
    cross the slow links between nodes). ``torch.distributed.run`` numbers
    the ranks of one node contiguously, so with ``dp`` the major stride the
    nodes already split ``dp`` and every other axis stays inside a node:
    that layout is the JAX package's hybrid mesh, and nothing is reordered.
    """
    if num_slices > 1 and spec.dp % num_slices:
        raise ValueError(f"dp={spec.dp} must be divisible by num_slices={num_slices} "
                         "(dp is the only axis that may cross nodes)")
    world = dist.get_world_size()
    if spec.size != world:
        raise ValueError(f"mesh {spec.key()} needs {spec.size} ranks, the group has {world}")
    ranks = torch.arange(world, dtype=torch.int).reshape(spec.axis_sizes())
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_divisor(mesh: DeviceMesh) -> int:
    """Number of ways the global batch is split (product of batch axes)."""
    return math.prod(axis_size(mesh, a) for a in BATCH_AXES)


def batch_coordinate(mesh: DeviceMesh) -> int:
    """This rank's place in the batch: its coordinate on the batch axes,
    row-major (``dp`` the major stride). The ranks' rows, in this order,
    make up the global batch; the ranks of one ``tp`` group share it."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    place = 0
    for a in BATCH_AXES:
        place = place * axis_size(mesh, a) + coord[a]
    return place


def batch_ranks(mesh: DeviceMesh) -> List[List[int]]:
    """The global ranks of each batch group: the ranks that share every
    coordinate but the batch axes', in batch order."""
    names = list(mesh.mesh_dim_names)
    batch = [names.index(a) for a in BATCH_AXES]
    rest = [i for i in range(len(names)) if i not in batch]
    ranks = mesh.mesh.permute(*rest, *batch).reshape(-1, batch_divisor(mesh))
    return ranks.tolist()


def batch_process_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group of this rank's batch group (the default group when
    the batch axes are the whole mesh). Every rank calls it together: each
    batch group is created on all of them."""
    groups = batch_ranks(mesh)
    if len(groups) == 1:
        return dist.group.WORLD
    mine, _ = dist.new_subgroups_by_enumeration(groups)
    return mine


# ------------------------------------------------------------ batch reductions
class BatchGroup:
    """An open :func:`batch_group`: the ranks whose rows make up the batch,
    and whether a :func:`batch_sum` has summed over them."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.summed = False


_BATCH_GROUP: contextvars.ContextVar[Optional[BatchGroup]] = contextvars.ContextVar(
    "easydl_batch_group", default=None)


@contextlib.contextmanager
def batch_group(group: dist.ProcessGroup) -> Iterator[BatchGroup]:
    """While open, :func:`batch_sum` sums over ``group``: the ranks whose
    rows make up the batch."""
    opened = BatchGroup(group)
    token = _BATCH_GROUP.set(opened)
    try:
        yield opened
    finally:
        _BATCH_GROUP.reset(token)


class _BatchSum(torch.autograd.Function):
    """All-reduce (sum) forward; the backward passes each rank's gradient
    through unchanged: it is the gradient of this rank's rows' share, and
    the trainer sums the ranks' parameter gradients."""

    @staticmethod
    def forward(ctx, group, *xs):
        out = torch.stack(xs)
        dist.all_reduce(out, group=group)
        return out.unbind()

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def batch_sum(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The scalars ``xs`` summed over the batch group (one all-reduce), or
    as given when no :func:`batch_group` is open."""
    opened = _BATCH_GROUP.get()
    if opened is None:
        return xs
    opened.summed = True
    return _BatchSum.apply(opened.group, *xs)


# ------------------------------------------------------- tensor parallelism
def _active(group: Optional[dist.ProcessGroup]) -> bool:
    return group is not None and dist.get_world_size(group) > 1


class _CopyToTp(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' gradients over the
    ``tp`` group (into a new tensor: the incoming one is left as it is)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return None, grad


class _ReduceFromTp(torch.autograd.Function):
    """Sums the ranks' partial results over the ``tp`` group (into a new
    tensor: a product that a selective checkpoint keeps must not change);
    the backward passes the gradient through, as every rank holds the sum."""

    @staticmethod
    def forward(ctx, group, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def copy_to_tp(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` on every rank of ``group``, whose backward all-reduces: the
    input of a column-parallel product."""
    return _CopyToTp.apply(group, x) if _active(group) else x


def reduce_from_tp(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` summed over ``group`` (all-reduce forward, identity backward):
    the output of a row-parallel product."""
    return _ReduceFromTp.apply(group, x) if _active(group) else x
