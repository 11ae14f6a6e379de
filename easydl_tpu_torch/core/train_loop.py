"""Training core of the port: one device, or one process per device on a
``dp`` x ``fsdp`` x ``tp`` mesh.

Counterpart of ``easydl_tpu/core/train_loop.py``. With no mesh, on one
device:

- parameters and optimizer state stay f32; before the loss, EVERY floating
  parameter is cast to ``compute_dtype`` (default bf16) with an explicit,
  differentiable cast, so the gradient lands on the f32 masters. This is the
  JAX ``cast_floating``; ``torch.autocast`` would leave some ops in f32 and
  round at other places;
- gradient accumulation averages loss, aux metrics and gradients over
  ``grad_accum`` microbatches (sums, then one scale by 1/accum);
- ``grad_norm`` is the global L2 norm of the averaged gradients;
- the loss gets the step's key, as the JAX step derives it from the state's
  key (``PRNGKey(seed)``, ``core/prng.py``): ``fold_in(rng, step)``, with
  ``step`` the count before the update; microbatch i draws from
  ``fold_in(step key, i)`` when ``grad_accum > 1`` and from the step key
  itself when ``grad_accum == 1``. The evaluation step passes the state's
  key, unfolded.

With a mesh (``mesh`` or ``mesh_spec``, after
``core.mesh.init_distributed``), every rank builds the same seeded f32 model.
With ``tp`` > 1 each parameter that the rules put on ``tp`` becomes a
``DTensor`` on the ``tp`` sub-mesh, this rank's block of it on the
dimension ``core/sharding.py`` reads from the rules (the model computes on
the blocks, ``models/transformer.py``). FSDP2 then shards each block and
the root over the (``dp``, ``fsdp``) sub-mesh: HSDP, parameters and Adam
moments split over ``fsdp`` on the dimension the rules give, whole on
every ``dp`` replica (HSDP+TP where ``tp`` > 1). FSDP2's mixed-precision
policy gathers the parameters in ``compute_dtype`` (the cast) and reduces
the gradients in f32, summing them over the ranks of the batch axes.
:meth:`Trainer.train_step` takes this process's rows of the global batch
(the batch groups' rows, concatenated in the order of their coordinate on
(``dp``, ``fsdp``), make it; the ranks of one ``tp`` group take the same
rows) and computes what the JAX step computes on the global batch:

- microbatch i is the global rows ``[i·m, (i+1)·m)``, ``m =
  global_batch / grad_accum``: the ranks all-gather the token ids and each
  takes its share of each microbatch;
- the loss is the masked mean over the global microbatch: the model's loss
  sums its numerator and denominator over the ranks
  (``core.mesh.batch_sum``), so loss and aux metrics are the global ones
  on every rank; the key it gets (``prng.BatchKey``) says where the
  rank's rows lie in the global microbatch, so that a random draw over it
  (BERT's mask) is the JAX step's, each rank drawing its own rows;
- the gradients of all but the last microbatch stay on their rank, summed
  in f32 (FSDP2 accumulates in its ``reduce_dtype``), and are reduced once;
  ``grad_norm`` is the norm over every shard: squares summed over ``fsdp``,
  and over ``tp`` for the parameters split on it, not for those whole on
  every ``tp`` rank.

The state is updated in place (PyTorch's idiom; the JAX step donates and
replaces it): :meth:`Trainer.train_step` returns the same ``TrainState``.

Checkpoints hold the state in the JAX ``TrainState``'s layout and leaf keys
(:meth:`Trainer.state_leaves`, ``core/jax_state.py``, through the model
bundle's ``JaxLayout``), so either package restores the other's;
:meth:`Trainer.restore_from` is the one way back in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from easydl_tpu_torch.core import jax_state, prng, sharding
from easydl_tpu_torch.core.checkpoint import Shards
from easydl_tpu_torch.core.mesh import (AXES, MeshSpec, axis_size, batch_coordinate, batch_group,
                                        batch_process_group, build_mesh)
from easydl_tpu_torch.utils.device import require_device
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("core", "trainer")

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


@dataclass
class TrainConfig:
    global_batch: int = 32
    grad_accum: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    seed: int = 0

    def __post_init__(self) -> None:
        if self.global_batch % max(self.grad_accum, 1):
            raise ValueError(
                f"global_batch={self.global_batch} not divisible by grad_accum={self.grad_accum}"
            )


@dataclass
class TrainState:
    step: int
    model: nn.Module  # holds the f32 master parameters
    optimizer: torch.optim.Optimizer
    rng: prng.Key  # PRNGKey(seed), the JAX TrainState's .rng


class _LossModule(nn.Module):
    """Puts ``loss_fn(model, batch, rng)`` behind ``forward`` so that
    ``functional_call`` can run it on cast parameters."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch, rng):
        return self.loss_fn(self.model, batch, rng)


def fsdp_params(model: nn.Module):
    """FSDP2's per-parameter records (``FSDPParam``) of every unit
    :class:`Trainer` sharded. FSDP2's private state: a unit holds one
    parameter group in torch 2.11 (``_fsdp_param_group``) and a list of
    them in later versions (``_fsdp_param_groups``)."""
    for m in model.modules():
        if hasattr(m, "_get_fsdp_state"):
            state = m._get_fsdp_state()
            groups = getattr(state, "_fsdp_param_groups", None) or [state._fsdp_param_group]
            for group in groups:
                yield from group.fsdp_params if group is not None else ()


class Trainer:
    """Runs the training step on one device, or on this rank's part of a
    mesh.

    Args:
      init_fn: ``(seed, device) -> nn.Module`` with f32 parameters.
      loss_fn: ``(module, batch, rng) -> (loss, aux_metrics)``; the module
        runs on parameters cast to ``config.compute_dtype``; ``rng`` is a
        ``prng.BatchKey`` (see the module docstring).
      optimizer: ``parameters -> torch.optim.Optimizer``.
      device: where to train; "cuda" unless the caller asks for "cpu". With
        a mesh, this rank's device (``core.mesh.init_distributed``'s).
      jax_layout: the model's parameters in the JAX package's tree (the
        bundle's ``jax_layout``); checkpoints need it.
      mesh: a ``DeviceMesh`` of :data:`~easydl_tpu_torch.core.mesh.AXES`
        (``core.mesh.build_mesh``), or None to build one from
        ``mesh_spec``; with neither, the one-device path.
      param_axes: parameter name -> its logical axes (the bundle's
        ``param_axes``); a mesh needs it.
    """

    def __init__(
        self,
        init_fn: Callable,
        loss_fn: Callable,
        optimizer: OptimizerFactory,
        config: TrainConfig,
        device="cuda",
        jax_layout: Optional[jax_state.JaxLayout] = None,
        mesh=None,
        mesh_spec: Optional[MeshSpec] = None,
        param_axes: Optional[Callable] = None,
    ):
        self.config = config
        self.jax_layout = jax_layout
        self.device = require_device(device)
        self.init_fn = init_fn
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        if mesh is not None or mesh_spec is not None:
            mesh_spec = mesh_spec if mesh is None else MeshSpec(
                **{a: axis_size(mesh, a) for a in AXES})
            sharding.check_mesh(mesh_spec)
            if param_axes is None:
                raise ValueError("a mesh needs the model's param_axes (ModelBundle.param_axes)")
            mesh = mesh if mesh is not None else build_mesh(mesh_spec, self.device)
        self.mesh = mesh
        self.mesh_spec = mesh_spec
        if mesh is not None:
            self.param_axes = param_axes
            self.batch_mesh = mesh["dp", "fsdp"]
            self.ranks = self.batch_mesh.size()
            #: this rank's place in the batch (its tp group shares it) and
            #: the ranks whose rows make up the batch
            self.rank = batch_coordinate(mesh)
            self.batch_pg = batch_process_group(mesh)
            micro = config.global_batch // max(config.grad_accum, 1)
            if micro % self.ranks:
                raise ValueError(f"microbatch {micro} (global_batch {config.global_batch} / "
                                 f"grad_accum {config.grad_accum}) is not divisible by the "
                                 f"{self.ranks} ranks of the batch axes")

    def init_state(self) -> TrainState:
        model = self.init_fn(self.config.seed, self.device)
        count = sum(p.numel() for p in model.parameters())
        if self.mesh is not None:
            self._shard(model)
        log.info("initialised state on %s (%d params%s)", self.device, count,
                 f", mesh {self.batch_mesh}" if self.mesh is not None else "")
        return TrainState(step=0, model=model, optimizer=self.optimizer(model.parameters()),
                          rng=prng.PRNGKey(self.config.seed))

    def _shard(self, model: nn.Module) -> None:
        """Each parameter the rules put on tp split over the tp sub-mesh,
        then FSDP2 over the (dp, fsdp) sub-mesh: each block, then the root."""
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        sharding.check_mesh(self.mesh_spec, getattr(model, "cfg", None))
        if self.mesh_spec.tp > 1:
            sharding.split_over_tp(model, self.param_axes, self.mesh["tp"])
        names = {p: n for n, p in model.named_parameters()}
        # the parameters in the compute dtype, as JAX's cast_floating; the
        # activations keep the model's dtype between the blocks
        kwargs = dict(mesh=self.batch_mesh,
                      mp_policy=MixedPrecisionPolicy(param_dtype=self.config.compute_dtype,
                                                     reduce_dtype=torch.float32,
                                                     cast_forward_inputs=False),
                      shard_placement_fn=sharding.shard_placement_fn(names, self.param_axes))
        units = [*getattr(model, "blocks", ()), model]
        for unit in units:
            fully_shard(unit, **kwargs)
        for unit in units:  # sum the ranks' gradients: the loss already divides
            unit.set_gradient_divide_factor(1.0)
            unit.set_force_sum_reduction_for_comms(True)

    def _layout(self) -> jax_state.JaxLayout:
        if self.jax_layout is None:
            raise NotImplementedError("checkpoints need the model's jax_layout "
                                      "(ModelBundle.jax_layout)")
        return self.jax_layout

    def state_leaves(self, state: TrainState) -> Dict[str, Any]:
        """``state`` as the JAX ``TrainState``'s checkpoint leaves (key ->
        tensor on the state's device); what ``CheckpointManager.save`` takes.
        With a mesh, the sharded leaves are this rank's :class:`Shards`
        (chunks on replica 0 only)."""
        leaves = jax_state.to_leaves(state.step, state.model, state.optimizer,
                                     self.config.seed, self._layout())
        if self.mesh is None:
            return leaves
        shapes = self.leaf_shapes(state)
        regions = jax_state.leaf_regions(state.model, self._layout())
        mine = jax_state.written_leaves(state.model, self._layout(),
                                        dict(zip(AXES, self.mesh.get_coordinate())))
        return {k: Shards(shapes[k][0], shapes[k][1], [(regions[k], v)] if k in mine else [])
                if k in regions else v for k, v in leaves.items()}

    def leaf_shapes(self, state: TrainState) -> jax_state.Template:
        """(shape, dtype) of each of :meth:`state_leaves`, allocating none."""
        return jax_state.leaf_shapes(state.model, self._layout())

    def restore_from(self, checkpoint, step: Optional[int] = None) -> TrainState:
        """A fresh state loaded from ``step`` (default: the latest) of a
        ``CheckpointManager``, saved by this package or by the JAX one from
        any mesh. The single entry for resuming: the runner, the evaluator
        and ``evaluator_main`` all come through here."""
        if step is None:
            step = checkpoint.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {checkpoint.directory}")
        state = self.init_state()
        regions = (jax_state.leaf_regions(state.model, self._layout())
                   if self.mesh is not None else None)
        leaves = checkpoint.restore(step, self.leaf_shapes(state), regions)
        state.step = jax_state.load_leaves(leaves, state.model, state.optimizer,
                                           self.config.seed, self._layout())
        return state

    def to_device(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
                for k, v in host_batch.items()}

    def _batch_key(self, key: prng.Key, batch: Dict[str, torch.Tensor]) -> prng.BatchKey:
        """``key`` for ``batch``: on a mesh, this rank's rows of the global
        batch, whose ranks' rows lie in rank order."""
        if self.mesh is None:
            return prng.BatchKey(key)
        rows = len(next(iter(batch.values())))
        return prng.BatchKey(key, start=self.rank * rows, rows=rows * self.ranks)

    def _forward(self, model: nn.Module, batch, loss_fn: Callable, key: prng.Key,
                 reduce_grads: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``loss_fn(model, batch, rng)`` on the compute-dtype parameters:
        cast here on one device, gathered so by FSDP2 on a mesh, where the
        loss sums over every rank's rows and ``reduce_grads`` says whether
        the backward reduces the gradients over the ranks."""
        rng = self._batch_key(key, batch)
        if self.mesh is None:
            dtype = self.config.compute_dtype
            wrapped = _LossModule(model, loss_fn)
            cast = {name: p.to(dtype) if p.is_floating_point() else p
                    for name, p in wrapped.named_parameters()}
            loss, aux = functional_call(wrapped, cast, (batch, rng))
        else:
            model.set_requires_gradient_sync(reduce_grads)
            with batch_group(self.batch_pg) as opened:
                loss, aux = loss_fn(model, batch, rng)
            if not opened.summed:  # the gradients are summed: the loss must divide
                raise RuntimeError(
                    "on a mesh the loss must be the mean over every rank's rows: this "
                    "loss_fn never called core.mesh.batch_sum, so its gradients would come "
                    f"out {self.ranks} times too large")
        return loss.float(), aux

    def _microbatches(self, batch: Dict[str, torch.Tensor]):
        """The microbatches of the global batch ``[accum, global/accum]``, as
        the JAX step splits it; on a mesh, this rank's share of each."""
        accum = max(self.config.grad_accum, 1)
        if self.mesh is None:
            micro = self.config.global_batch // accum
            return [{k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
                    for i in range(accum)]
        rows = {len(v) for v in batch.values()}
        if rows != {self.config.global_batch // self.ranks}:
            raise ValueError(f"rank {self.rank} got {rows} rows; it takes global_batch / "
                             f"{self.ranks} = {self.config.global_batch // self.ranks}")
        if accum == 1:  # the rank's rows are its share of the one microbatch
            return [batch]
        share = self.config.global_batch // accum // self.ranks
        whole = {}
        for k, v in batch.items():
            parts = [torch.empty_like(v) for _ in range(self.ranks)]
            dist.all_gather(parts, v.contiguous(), group=self.batch_pg)
            whole[k] = torch.cat(parts)
        first = [(i * self.ranks + self.rank) * share for i in range(accum)]
        return [{k: v[a:a + share] for k, v in whole.items()} for a in first]

    def train_step(self, state: TrainState, host_batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        micro = self._microbatches(self.to_device(host_batch))
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        aux_sum: Dict[str, torch.Tensor] = {}
        step_key = prng.fold_in(state.rng, state.step)
        for i, mb in enumerate(micro):
            key = prng.fold_in(step_key, i) if len(micro) > 1 else step_key
            loss, aux = self._forward(state.model, mb, self.loss_fn, key,
                                      reduce_grads=i == len(micro) - 1)
            loss.backward()  # .grad accumulates the sum over microbatches
            loss_sum += loss.detach()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        scale = 1.0 / len(micro)
        if self.mesh is None:
            if len(micro) > 1:
                torch._foreach_mul_(grads, scale)
            # multi-tensor ops: a few launches for all the gradients together
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        else:
            grad_norm = self._sharded_norm(grads, scale)
        state.optimizer.step()
        state.step += 1
        metrics = {
            "loss": loss_sum * scale,
            "grad_norm": grad_norm,
            **{k: v * scale for k, v in aux_sum.items()},
        }
        return state, metrics

    def _sharded_norm(self, grads, scale: float) -> torch.Tensor:
        """Scales this rank's shards of the reduced gradients by ``scale``
        and returns the norm over every shard: squares summed over fsdp,
        and over tp only for the gradients split on it (the others are whole
        on every tp rank)."""
        local = [g.to_local() for g in grads]
        if scale != 1.0:
            torch._foreach_mul_(local, scale)
        on_tp = [sharding.tp_group_of(g) is not None for g in grads]
        parts = [[g for g, t in zip(local, on_tp) if t == want] for want in (False, True)]
        whole, split = (torch.linalg.vector_norm(torch.stack(torch._foreach_norm(p))).square()
                        if p else torch.zeros((), device=self.device) for p in parts)
        if any(on_tp):
            dist.all_reduce(split, group=self.mesh.get_group("tp"))
        square = whole + split
        dist.all_reduce(square, group=self.batch_mesh.get_group("fsdp"))
        return square.sqrt()

    def build_eval_step(self, eval_fn: Callable):
        """``(state, host_batch) -> aux`` of ``eval_fn(module, batch, rng) ->
        (loss, aux)``: no gradients, parameters cast to ``compute_dtype`` as
        in the train step, the state's key unfolded; with a mesh, on this
        rank's rows, aux over all."""

        def eval_step(state: TrainState, host_batch) -> Dict[str, torch.Tensor]:
            with torch.no_grad():
                _, aux = self._forward(state.model, self.to_device(host_batch), eval_fn,
                                       state.rng)
            return aux

        return eval_step
