"""Async checkpoints in the JAX package's on-disk format, in one process.

Counterpart of ``easydl_tpu/core/checkpoint.py``'s ``CheckpointManager``,
``_LeafReader`` and ``restore_with_fallback``. The layout is the same, so a
step saved by either package restores in the other (``core/jax_state.py``
names the leaves as the JAX ``TrainState`` does)::

    <dir>/step_00000010/
        manifest.json               # step, metadata, cache_token, leaves
        leaf_00003/0-128_0-64.npy   # chunk covering [0:128, 0:64]
        ...
        COMMITTED                   # written last: the step is valid iff present

- **save**: the leaves are copied to host memory before :meth:`save`
  returns (the optimizer updates the live tensors in place in the next
  step); the files are written on a background thread unless
  ``async_save=False``. Each leaf is one chunk. The chunks go into a tmp dir
  that is renamed into the step dir, then ``COMMITTED`` is written, then
  steps beyond ``keep`` are deleted, marker first.
- **restore**: each leaf is assembled from whichever of its chunks overlap
  it; a JAX save from a sharded mesh splits a leaf into several chunks.
- ``cache_token`` is written so that the JAX package's host-local chunk
  cache finds a well-formed manifest; the port has no chunk cache yet and
  reads storage.
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from easydl_tpu_torch.core.storage import CheckpointStorage, get_storage
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("core", "checkpoint")

_STEP_RE = re.compile(r"^step_(\d{8})$")
_COMMITTED = "COMMITTED"
#: written by quarantine(): the step's bytes proved unreadable at restore
_CORRUPT = "CORRUPT"

Shape = Tuple[int, ...]


def _chunk_name(bounds: List[Tuple[int, int]]) -> str:
    if not bounds:
        return "scalar.npy"
    return "_".join(f"{a}-{b}" for a, b in bounds) + ".npy"


def _parse_chunk_name(name: str) -> Optional[List[Tuple[int, int]]]:
    if name == "scalar.npy":
        return []
    if not name.endswith(".npy"):
        return None
    try:
        return [(int(a), int(b)) for a, b in (p.split("-") for p in name[:-4].split("_"))]
    except ValueError:
        return None


def _host_copy(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else references."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class _LeafReader:
    """Assembles any slice of one leaf from its saved chunks."""

    def __init__(self, storage: CheckpointStorage, leaf_dir: str, shape: Shape,
                 dtype: np.dtype):
        self.storage = storage
        self.shape = shape
        self.dtype = dtype
        self._chunks: List[Tuple[List[Tuple[int, int]], str]] = []
        for name in storage.listdir(leaf_dir):
            bounds = _parse_chunk_name(name)
            if bounds is not None:
                self._chunks.append((bounds, f"{leaf_dir}/{name}"))
        if not self._chunks:
            raise FileNotFoundError(f"no chunks in {leaf_dir}")

    def read(self, want: List[Tuple[int, int]]) -> np.ndarray:
        """The leaf's ``[a:b, ...]`` slice for ``want = [(a, b), ...]``."""
        if not self.shape:
            return self.storage.load_array(self._chunks[0][1])
        for bounds, path in self._chunks:
            if bounds == want:  # one chunk is the slice: no assembly copy
                return self.storage.load_array(path)
        out = np.empty([b - a for a, b in want], dtype=self.dtype)
        filled = 0
        for bounds, path in self._chunks:
            inter = [(max(a, ca), min(b, cb)) for (a, b), (ca, cb) in zip(want, bounds)]
            if any(a >= b for a, b in inter):
                continue
            data = self.storage.load_array(path)
            src = tuple(slice(a - ca, b - ca) for (a, b), (ca, _) in zip(inter, bounds))
            dst = tuple(slice(a - wa, b - wa) for (a, b), (wa, _) in zip(inter, want))
            out[dst] = data[src]
            filled += int(np.prod([b - a for a, b in inter]))
        if filled != out.size:
            raise ValueError(f"chunks cover {filled}/{out.size} elements of slice {want} "
                             f"(shape {self.shape})")
        return out


class CheckpointManager:
    """Saves and restores flat ``{key: array}`` states, keeping the last
    ``keep`` committed steps. ``directory`` is a path or ``file://`` URL."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.storage = get_storage(directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.storage.makedirs("")

    # ------------------------------------------------------------------ save
    def save(self, step: int, leaves: Mapping[str, Any]) -> None:
        """Copies ``leaves`` (torch tensors on any device, or numpy arrays)
        to host memory, then writes them, on a background thread unless
        ``async_save=False``. A step already committed is skipped."""
        self.wait()
        if step in self.steps():
            log.info("step %d already checkpointed; skipping", step)
            return
        snapshot = [(i, key, _host_copy(leaf)) for i, (key, leaf) in enumerate(leaves.items())]
        t0 = time.perf_counter()
        step_dir = f"step_{step:08d}"
        tmp_dir = step_dir + ".tmp.0"
        manifest = {
            "step": step,
            "metadata": {},
            "cache_token": f"{step:08d}-{uuid.uuid4().hex[:12]}",
            "leaves": [{"index": i, "key": key, "shape": list(arr.shape),
                        "dtype": str(arr.dtype)} for i, key, arr in snapshot],
        }

        def write_and_commit() -> None:
            storage = self.storage
            storage.delete_tree(tmp_dir)  # debris of a save that died here
            storage.makedirs(tmp_dir)
            for i, _, arr in snapshot:
                name = _chunk_name([(0, d) for d in arr.shape])
                storage.save_array(f"{tmp_dir}/leaf_{i:05d}/{name}", arr)
            storage.write_bytes(f"{tmp_dir}/manifest.json", json.dumps(manifest).encode())
            if self._uncommitted_debris(step_dir):
                log.warning("clearing aborted save at %s", step_dir)
                storage.delete_tree(step_dir)
            storage.rename(tmp_dir, step_dir)
            storage.write_bytes(f"{step_dir}/{_COMMITTED}", str(step).encode())
            log.info("saved step %d in %.2fs -> %s/%s", step, time.perf_counter() - t0,
                     self.directory, step_dir)
            self._gc()

        if not self.async_save:
            write_and_commit()
            return

        def run() -> None:
            try:
                write_and_commit()
            except BaseException as e:  # raised by the next wait() or save()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"ckpt-save-{step}", daemon=True)
        self._thread.start()

    def _uncommitted_debris(self, step_dir: str) -> bool:
        return (bool(self.storage.listdir(step_dir))
                and not self.storage.exists(f"{step_dir}/{_COMMITTED}"))

    def wait(self) -> None:
        """Blocks until an in-flight save is committed; raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}") from err

    # ---------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for name in self.storage.listdir(""):
            m = _STEP_RE.match(name)
            if m and self.storage.exists(f"{name}/{_COMMITTED}"):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def metadata(self, step: int) -> Dict[str, Any]:
        return json.loads(self.storage.read_bytes(f"step_{step:08d}/manifest.json"))

    def restore(self, step: int, template: Mapping[str, Tuple[Shape, np.dtype]]
                ) -> Dict[str, np.ndarray]:
        """The leaves named by ``template`` (key -> (shape, dtype)), each
        assembled whole and cast to the template's dtype. A leaf missing from
        the step, or saved with another shape, raises."""
        step_dir = f"step_{step:08d}"
        by_key = {leaf["key"]: leaf for leaf in self.metadata(step)["leaves"]}
        out = {}
        for key, (shape, dtype) in template.items():
            if key not in by_key:
                raise KeyError(f"checkpoint step {step} missing leaf {key}")
            rec = by_key[key]
            saved = tuple(rec["shape"])
            if saved != tuple(shape):
                raise ValueError(f"{key}: saved shape {saved} != target {tuple(shape)}")
            reader = _LeafReader(self.storage, f"{step_dir}/leaf_{rec['index']:05d}", saved,
                                 np.dtype(rec["dtype"]))
            arr = reader.read([(0, d) for d in saved])
            out[key] = arr if arr.dtype == dtype else arr.astype(dtype)
        return out

    # ------------------------------------------------------------ quarantine
    def quarantine(self, step: int) -> None:
        """Demotes a committed step whose bytes failed to restore: the
        ``CORRUPT`` marker first (evidence), then ``COMMITTED`` goes, so a
        crash between the two leaves the step committed or visibly corrupt."""
        step_dir = f"step_{step:08d}"
        try:
            self.storage.write_bytes(f"{step_dir}/{_CORRUPT}", str(step).encode())
        except OSError as e:  # the marker is evidence, not a gate
            log.warning("could not write corrupt marker for step %d: %s", step, e)
        self.storage.delete_tree(f"{step_dir}/{_COMMITTED}")
        log.warning("quarantined checkpoint step %d (%s/%s)", step, self.directory, step_dir)

    # -------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self.steps()
        for old in steps[: -self.keep] if self.keep > 0 else []:
            step_dir = f"step_{old:08d}"
            # marker first: a half-deleted step reads as uncommitted
            self.storage.delete_tree(f"{step_dir}/{_COMMITTED}")
            self.storage.delete_tree(step_dir)


def restore_with_fallback(manager: CheckpointManager, restore_fn: Callable[[int], Any],
                          max_attempts: int = 8):
    """Restores the newest committed step, falling back past corrupt ones:
    a step whose ``restore_fn(step)`` raises is quarantined and the next
    older one is tried. Returns ``(state, step)``, or ``(None, -1)`` when no
    step is left."""
    for _ in range(max_attempts):
        step = manager.latest_step()
        if step is None:
            return None, -1
        try:
            return restore_fn(step), step
        except Exception as e:
            log.warning("restore of step %d failed: %r", step, e)
        manager.quarantine(step)
    raise RuntimeError(f"no restorable checkpoint under {manager.directory} after "
                       f"{max_attempts} quarantine fallbacks")
