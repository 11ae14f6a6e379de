"""Model registry: name → factory of a :class:`ModelBundle`.

Counterpart of ``easydl_tpu/models/registry.py``. The trainer is
model-agnostic; a bundle hands it a module factory, a loss and a data source.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from easydl_tpu_torch.core.jax_state import JaxLayout

_REGISTRY: Dict[str, Callable[..., "ModelBundle"]] = {}
_MODULES = ("gpt",)


@dataclass
class ModelBundle:
    """Everything the Trainer needs."""

    name: str
    init_fn: Callable  # (seed, device) -> nn.Module with f32 params
    loss_fn: Callable  # (module, batch) -> (loss, aux); batch holds tensors
    make_data: Callable  # (global_batch, seed) -> host batch iterator (numpy)
    #: (module, batch) -> (loss, aux) for held-out evaluation; None = loss_fn
    eval_fn: Optional[Callable] = None
    #: the parameters in the JAX package's tree, for checkpoints in its
    #: format; None = this model cannot be checkpointed yet
    jax_layout: Optional[JaxLayout] = None
    #: parameter name -> the logical axes of each of its dimensions
    #: (``core/sharding.py``); None = this model cannot train on a mesh yet
    param_axes: Optional[Callable[[str], Any]] = None
    param_count_hint: int = 0
    #: training FLOPs per example (fwd+bwd, PaLM appendix-B accounting) —
    #: the MFU numerator (core/mfu.py); 0 = unknown
    flops_per_sample_hint: float = 0.0


def register_model(name: str):
    def deco(factory: Callable[..., ModelBundle]):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_model(name: str, **kwargs: Any) -> ModelBundle:
    if name not in _REGISTRY:
        for mod in _MODULES:  # import on demand so registering stays lazy
            importlib.import_module(f"easydl_tpu_torch.models.{mod}")
        if name not in _REGISTRY:
            raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)} "
                           "(the port has GPT only so far)")
    return _REGISTRY[name](**kwargs)
