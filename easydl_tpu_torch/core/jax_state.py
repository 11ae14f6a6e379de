"""The training state under the JAX ``TrainState``'s checkpoint keys.

The JAX ``TrainState`` (step, params, optax Adam/AdamW state, rng) flattens
to the leaf keys that its checkpoint manifest records
(``jax.tree_util.keystr``). :func:`to_leaves` and :func:`load_leaves` map a
model and its ``torch.optim.Adam``/``AdamW`` to those keys:

- ``.step``: the step, int32;
- ``.params[...].value``: the weights in the JAX model's layout (``.value``
  is flax's ``Partitioned`` box);
- ``.opt_state[0].count``: each parameter's Adam ``state["step"]``, int32;
- ``.opt_state[0].mu[...].value`` / ``.nu[...].value``: ``exp_avg`` /
  ``exp_avg_sq``, in the weights' layout;
- ``.rng``: ``jax.random.PRNGKey(seed)``, which is ``[0, seed]`` uint32.

What this module knows of the model is one :class:`JaxLayout`, which the
model's bundle supplies: how its parameters map to the JAX model's parameter
tree. ``optax.adamw`` and ``optax.adam`` both keep their moments at
``opt_state[0]``. Hyperparameters are in no checkpoint, in either package.

A model sharded by FSDP2 holds ``DTensor`` parameters and moments. Then
:func:`to_leaves` and :func:`load_leaves` take this rank's blocks: the
layout maps a parameter's local shard to a block of its JAX leaf, and
:func:`leaf_regions` says where that block lies in the leaf, so that each
rank writes and reads only its own chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_ADAM = (torch.optim.Adam, torch.optim.AdamW)
_MOMENTS = ((".opt_state[0].mu", "exp_avg"), (".opt_state[0].nu", "exp_avg_sq"))

Template = Dict[str, Tuple[Tuple[int, ...], np.dtype]]


@dataclass(frozen=True)
class JaxLayout:
    """A model's parameters in the JAX package's parameter tree.

    Attributes:
      to_jax: ``{parameter name: tensor}`` -> the flax tree (nested dicts of
        tensors) in the JAX model's shapes, on the input's device (``meta``
        included). Tensors that are not a parameter's own may be new ones.
      from_jax: the inverse, on torch tensors.
    """

    to_jax: Callable[[Mapping[str, torch.Tensor]], Dict[str, Any]]
    from_jax: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    """``keystr`` keys of a boxed flax tree: dict keys in sorted order, as
    ``jax.tree_util`` flattens them, each leaf behind ``.value``."""
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            _flatten(tree[k], f"{prefix}['{k}']", out)
        else:
            out[f"{prefix}['{k}'].value"] = tree[k]


def _unflatten(leaves: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in leaves.items():
        if not (key.startswith(prefix + "[") and key.endswith(".value")):
            continue
        path = key[len(prefix) + 2:-len("'].value")].split("']['")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def _check_optimizer(optimizer: torch.optim.Optimizer) -> None:
    if type(optimizer) not in _ADAM or any(g.get("amsgrad") for g in optimizer.param_groups):
        raise NotImplementedError(
            f"checkpoints of optimizer {type(optimizer).__name__} (amsgrad: "
            f"{[g.get('amsgrad') for g in optimizer.param_groups]}) are not ported yet: "
            "torch.optim.Adam or AdamW without amsgrad (optax adam/adamw) only")


def _rng(seed: int) -> np.ndarray:
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32): PRNGKey(seed) is not [0, seed]")
    return np.array([0, seed], np.uint32)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``t``: the local shard of a ``DTensor``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _like(param: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """``block`` (this rank's part) as a tensor placed like ``param``."""
    if not isinstance(param, DTensor):
        return block
    return DTensor.from_local(block, param.device_mesh, param.placements, run_check=False,
                              shape=param.shape, stride=param.stride())


def _params_by_name(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    params = dict(model.named_parameters())
    if set(params) != set(model.state_dict()):
        raise ValueError("the model's state_dict holds more than its parameters")
    return params


def to_leaves(step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
              seed: int, layout: JaxLayout) -> Dict[str, torch.Tensor]:
    """The JAX ``TrainState``'s leaves by checkpoint key, as torch tensors in
    its layouts and dtypes, on the model's device (for a sharded model, this
    rank's blocks of them: see :func:`leaf_regions`). Leaves may share
    memory with the live state."""
    _check_optimizer(optimizer)
    params = _params_by_name(model)
    state = optimizer.state
    steps = {int(state[p]["step"]) for p in params.values() if p in state}
    if len(steps) > 1 or (steps and len(state) != len(params)):
        raise ValueError(f"parameters are at different optimizer steps: {sorted(steps)}")
    local = {n: _local(p.detach()) for n, p in params.items()}
    device = next(iter(local.values())).device

    out = {".step": torch.tensor(step, dtype=torch.int32, device=device)}
    _flatten(layout.to_jax(local), ".params", out)
    out[".opt_state[0].count"] = torch.tensor(steps.pop() if steps else 0, dtype=torch.int32,
                                              device=device)
    for prefix, key in _MOMENTS:
        moments = {n: _local(state[p][key]).detach() if p in state else torch.zeros_like(local[n])
                   for n, p in params.items()}
        _flatten(layout.to_jax(moments), prefix, out)
    out[".rng"] = torch.from_numpy(_rng(seed)).to(device)
    return out


def leaf_shapes(model: torch.nn.Module, layout: JaxLayout) -> Template:
    """(shape, dtype) of every leaf :func:`to_leaves` gives for ``model``
    with an Adam-family optimizer, without allocating them."""
    meta = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for n, p in _params_by_name(model).items()}
    tree = layout.to_jax(meta)
    leaves: Dict[str, Any] = {}
    for prefix in (".params", *(p for p, _ in _MOMENTS)):
        _flatten(tree, prefix, leaves)
    out = {k: (tuple(t.shape), np.dtype(str(t.dtype)[len("torch."):]))
           for k, t in leaves.items()}
    out[".step"] = out[".opt_state[0].count"] = ((), np.dtype(np.int32))
    out[".rng"] = ((2,), np.dtype(np.uint32))
    return out


def load_leaves(leaves: Mapping[str, np.ndarray], model: torch.nn.Module,
                optimizer: torch.optim.Optimizer, seed: int, layout: JaxLayout) -> int:
    """Loads the leaves of :func:`to_leaves` (numpy, as a checkpoint
    restores them; this rank's blocks for a sharded model) into ``model``
    and ``optimizer`` in place; returns the step. The optimizer takes its
    state through its own ``load_state_dict``, so ``state["step"]`` gets the
    dtype and device that the installed torch gives it."""
    _check_optimizer(optimizer)
    if not np.array_equal(np.asarray(leaves[".rng"]), _rng(seed)):
        raise ValueError(f"checkpoint rng {leaves['.rng']} is not PRNGKey({seed}) = "
                         f"{_rng(seed)}: it was saved by a run with another seed")
    params = _params_by_name(model)
    device = _local(next(iter(params.values()))).device

    def load(prefix):  # laid out on the model's device, placed like the parameters
        tree = _unflatten({k: torch.from_numpy(np.array(v)).to(device)
                           for k, v in leaves.items() if k.startswith(prefix + "[")}, prefix)
        return {n: _like(params[n], t) for n, t in layout.from_jax(tree).items()}

    model.load_state_dict(load(".params"))
    mu, nu = (load(prefix) for prefix, _ in _MOMENTS)
    count = float(leaves[".opt_state[0].count"])
    index = {p: i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    name_of = {p: n for n, p in params.items()}
    sd = optimizer.state_dict()
    sd["state"] = {index[p]: {"step": torch.tensor(count), "exp_avg": mu[name_of[p]],
                              "exp_avg_sq": nu[name_of[p]]} for p in index}
    optimizer.load_state_dict(sd)
    return int(leaves[".step"])


def _placement(param: torch.Tensor) -> Tuple[int, int, int]:
    """(dim, parts, index): ``param`` is split along ``dim`` into ``parts``
    chunks (``torch.chunk``'s sizes, as FSDP2 cuts them) and this rank holds
    chunk ``index``; (0, 1, 0) for a whole tensor."""
    if not isinstance(param, DTensor):
        return 0, 1, 0
    shards = [(pl.dim, m) for m, pl in enumerate(param.placements) if isinstance(pl, Shard)]
    if len(shards) > 1 or any(not isinstance(pl, (Shard, Replicate)) for pl in param.placements):
        raise NotImplementedError(f"placements {param.placements}: one Shard at most")
    if not shards:
        return 0, 1, 0
    dim, m = shards[0]
    return dim, param.device_mesh.size(m), param.device_mesh.get_local_rank(m)


def _chunk_shape(shape, dim: int, parts: int, index: int) -> Tuple[int, ...]:
    size = -(-shape[dim] // parts)
    out = list(shape)
    out[dim] = max(0, min(size, shape[dim] - index * size))
    return tuple(out)


def is_writer(model: torch.nn.Module) -> bool:
    """Whether this rank holds replica 0 of its shards (its coordinate is 0
    on every mesh dimension that replicates): the one that saves them."""
    for p in model.parameters():
        if isinstance(p, DTensor):
            return all(p.device_mesh.get_local_rank(m) == 0
                       for m, pl in enumerate(p.placements) if isinstance(pl, Replicate))
    return True


def leaf_regions(model: torch.nn.Module, layout: JaxLayout) -> Dict[str, List[Tuple[int, int]]]:
    """Where this rank's block of each parameter and moment leaf lies in the
    leaf, as ``[(start, stop)]`` per dimension, for the chunk names of the
    checkpoint format. Reckoned from shapes alone: the layout is applied to
    empty tensors shaped like each chunk index's shards, and the one leaf
    dimension whose size follows the index is the sharded one. Raises if the
    layout does not keep a shard whole."""
    params = _params_by_name(model)
    where = {n: _placement(p) for n, p in params.items()}
    parts = max(pl[1] for pl in where.values())

    def shapes(index: Optional[int]) -> Dict[str, Tuple[int, ...]]:
        meta = {n: torch.empty(tuple(p.shape) if index is None else
                               _chunk_shape(p.shape, where[n][0], where[n][1],
                                            index if where[n][1] > 1 else 0),
                               device="meta") for n, p in params.items()}
        flat: Dict[str, Any] = {}
        _flatten(layout.to_jax(meta), "", flat)
        return {k: tuple(t.shape) for k, t in flat.items()}

    full = shapes(None)
    by_index = [shapes(i) for i in range(parts)]
    index = max((pl[2] for pl in where.values()), default=0)
    regions: Dict[str, List[Tuple[int, int]]] = {}
    for key, shape in full.items():
        split = sorted({d for s in by_index for d in range(len(shape)) if s[key][d] != shape[d]})
        bounds = [(0, d) for d in shape]
        if len(split) > 1 or (split and sum(s[key][split[0]] for s in by_index) != shape[split[0]]):
            raise ValueError(f"leaf {key}: the layout splits a shard over dims {split}")
        if split:
            d = split[0]
            start = sum(s[key][d] for s in by_index[:index])
            bounds[d] = (start, start + by_index[index][key][d])
        for prefix in (".params", *(p for p, _ in _MOMENTS)):
            regions[prefix + key] = bounds
    return regions
