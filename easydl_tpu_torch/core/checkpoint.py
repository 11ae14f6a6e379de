"""Async checkpoints in the JAX package's on-disk format, from one process
or from every rank of a process group.

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
  ``async_save=False``. In one process each leaf is one chunk. In several,
  each rank writes the chunks of its replica-0 shards (:class:`Shards`,
  named by their bounds) and rank 0 the whole leaves, each rank into its
  own ``<step>.tmp.<rank>`` dir; after a barrier rank 0 moves them into the
  step dir, writes the manifest, then ``COMMITTED``, then deletes steps
  beyond ``keep``, marker first.
- **restore**: each leaf, or the block of it that a rank's placement
  needs, is assembled from whichever chunks overlap it, so a step saved on
  any mesh, by either package, restores onto any other
  (reshard-on-restore).
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
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from easydl_tpu_torch.core.storage import CheckpointStorage, get_storage
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("core", "checkpoint")

_STEP_RE = re.compile(r"^step_(\d{8})$")
_COMMITTED = "COMMITTED"
#: written by quarantine(): the step's bytes proved unreadable at restore
_CORRUPT = "CORRUPT"

Shape = Tuple[int, ...]
#: ``[(start, stop)]`` per dimension
Bounds = List[Tuple[int, int]]


def _chunk_name(bounds: Bounds) -> str:
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


@dataclass(frozen=True)
class Shards:
    """This process's part of one leaf of a sharded state: the leaf's global
    shape and dtype, and the chunks this process writes, each as the
    ``[(start, stop)]`` it covers in every dimension and its data (a torch
    tensor on any device, or a numpy array). A replica that another process
    writes has no chunks."""

    shape: Shape
    dtype: np.dtype
    chunks: Sequence[Tuple[Bounds, Any]]


def _process() -> Tuple[int, int]:
    """(rank, world size) of the default process group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _from_rank0(value):
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _all_true(flag: bool) -> bool:
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(flag))
    return all(flags)


class CheckpointManager:
    """Saves and restores flat ``{key: array}`` states, keeping the last
    ``keep`` committed steps. ``directory`` is a path or ``file://`` URL.

    With ``torch.distributed`` initialised, the manager acts for every rank
    of the default group, and every rank calls :meth:`save`,
    :meth:`latest_step`, :meth:`finalize` and :meth:`wait` together: each
    writes its own chunks, rank 0 commits, and all agree on the steps."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.storage = get_storage(directory)
        self.rank, self.world = _process()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending_commit: Optional[Callable[[], None]] = None
        self.storage.makedirs("")

    # ------------------------------------------------------------------ save
    def save(self, step: int, leaves: Mapping[str, Any]) -> None:
        """Copies ``leaves`` to host memory, then writes them, on a background
        thread unless ``async_save=False``. A leaf is a whole tensor (torch on
        any device, or numpy; in several processes rank 0 writes it) or a
        :class:`Shards`. A step already committed is skipped. With several
        processes an async save commits in a later :meth:`finalize` or
        :meth:`wait`, whose barriers run on the caller's thread."""
        self.wait()
        skip = step in self.steps()
        if self.world > 1:
            skip = _from_rank0(skip)
        if skip:
            log.info("step %d already checkpointed; skipping", step)
            return
        snapshot = []  # (index, key, shape, dtype, [(bounds, host array)])
        for i, (key, leaf) in enumerate(leaves.items()):
            if isinstance(leaf, Shards):
                snapshot.append((i, key, tuple(leaf.shape), np.dtype(leaf.dtype),
                                 [(list(b), _host_copy(c)) for b, c in leaf.chunks]))
            else:
                arr = _host_copy(leaf)
                snapshot.append((i, key, arr.shape, arr.dtype,
                                 [([(0, d) for d in arr.shape], arr)] if self.rank == 0 else []))
        t0 = time.perf_counter()
        step_dir = f"step_{step:08d}"
        tmp_dir = f"{step_dir}.tmp.{self.rank}"
        manifest = {
            "step": step,
            "metadata": {},
            "cache_token": f"{step:08d}-{uuid.uuid4().hex[:12]}",
            "leaves": [{"index": i, "key": key, "shape": list(shape), "dtype": str(dtype)}
                       for i, key, shape, dtype, _ in snapshot],
        }

        def write() -> None:  # chunk IO only: no collectives
            storage = self.storage
            storage.delete_tree(tmp_dir)  # debris of a save that died here
            storage.makedirs(tmp_dir)
            for i, _, _, _, chunks in snapshot:
                for bounds, arr in chunks:
                    storage.save_array(f"{tmp_dir}/leaf_{i:05d}/{_chunk_name(bounds)}", arr)

        def commit() -> None:  # in several processes: every rank, on its main thread
            storage = self.storage
            if self.world > 1:
                dist.barrier()  # every rank's chunks are written
            if self.rank == 0:
                if self._uncommitted_debris(step_dir):
                    log.warning("clearing aborted save at %s", step_dir)
                    storage.delete_tree(step_dir)
                storage.write_bytes(f"{tmp_dir}/manifest.json", json.dumps(manifest).encode())
                storage.rename(tmp_dir, step_dir)
                for rank in range(1, self.world):  # move the other ranks' chunks in
                    src = f"{step_dir}.tmp.{rank}"
                    for leaf in storage.listdir(src):
                        storage.makedirs(f"{step_dir}/{leaf}")
                        for chunk in storage.listdir(f"{src}/{leaf}"):
                            storage.rename(f"{src}/{leaf}/{chunk}", f"{step_dir}/{leaf}/{chunk}")
                    storage.delete_tree(src)
                storage.write_bytes(f"{step_dir}/{_COMMITTED}", str(step).encode())
                log.info("saved step %d in %.2fs -> %s/%s", step, time.perf_counter() - t0,
                         self.directory, step_dir)
                self._gc()
            if self.world > 1:
                dist.barrier()  # every rank sees the step committed

        if not self.async_save:
            try:
                write()
            except Exception as e:  # agreed on by every rank, then raised, by wait()
                self._error = e
            self._pending_commit = commit
            self.wait()
            return

        def run() -> None:
            try:
                write()
                if self.world == 1:
                    commit()
            except BaseException as e:  # raised by the next wait() or save()
                self._error = e

        if self.world > 1:
            self._pending_commit = commit
        self._thread = threading.Thread(target=run, name=f"ckpt-save-{step}", daemon=True)
        self._thread.start()

    def _uncommitted_debris(self, step_dir: str) -> bool:
        return (bool(self.storage.listdir(step_dir))
                and not self.storage.exists(f"{step_dir}/{_COMMITTED}"))

    def finalize(self) -> bool:
        """Commits a pending save once every rank's chunks are written,
        without waiting for them; True when nothing is left pending. All
        ranks call it together (it agrees by a collective)."""
        if self._pending_commit is None:
            return True
        if not self._agree(self._thread is None or not self._thread.is_alive()):
            return False
        self.wait()
        return True

    def wait(self) -> None:
        """Blocks until an in-flight save is committed; raises its error. In
        several processes a failure on any rank drops the commit on all."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        commit, self._pending_commit = self._pending_commit, None
        if commit is not None and not self._agree(err is None) and err is None:
            raise RuntimeError("checkpoint save failed on another rank; "
                               "commit dropped on all ranks")
        if err is not None:
            raise RuntimeError(f"checkpoint save failed: {err!r}") from err
        if commit is not None:
            commit()

    def _agree(self, flag: bool) -> bool:
        """``flag`` on every rank (a collective in several processes)."""
        return _all_true(flag) if self.world > 1 else flag

    # ---------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        """The committed steps, as this process sees the directory."""
        out = []
        for name in self.storage.listdir(""):
            m = _STEP_RE.match(name)
            if m and self.storage.exists(f"{name}/{_COMMITTED}"):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step; in several processes rank 0's answer,
        so that every rank restores the same step."""
        steps = self.steps()
        latest = steps[-1] if steps else None
        return _from_rank0(latest) if self.world > 1 else latest

    def metadata(self, step: int) -> Dict[str, Any]:
        return json.loads(self.storage.read_bytes(f"step_{step:08d}/manifest.json"))

    def restore(self, step: int, template: Mapping[str, Tuple[Shape, np.dtype]],
                regions: Optional[Mapping[str, Bounds]] = None) -> Dict[str, np.ndarray]:
        """The leaves named by ``template`` (key -> (global shape, dtype)),
        each cast to the template's dtype: whole, or the block
        ``regions[key]`` (``[(start, stop)]`` per dimension) where given, read
        from the chunks that overlap it, whatever mesh saved them. A leaf
        missing from the step, or saved with another shape, raises."""
        step_dir = f"step_{step:08d}"
        by_key = {leaf["key"]: leaf for leaf in self.metadata(step)["leaves"]}
        regions = regions or {}
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
            arr = reader.read(list(regions.get(key, [(0, d) for d in saved])))
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
    step is left. In several processes every rank calls it together: they
    try the same step, and if it fails on any rank all of them drop it and
    rank 0 quarantines it."""
    for _ in range(max_attempts):
        step = manager.latest_step()
        if step is None:
            return None, -1
        state = None
        try:
            state = restore_fn(step)
            ok = True
        except Exception as e:
            log.warning("restore of step %d failed: %r", step, e)
            ok = False
        if manager._agree(ok):
            return state, step
        del state  # a survivor's state from a bad step must not leak
        if manager.rank == 0:
            manager.quarantine(step)
        if manager.world > 1:
            dist.barrier()
    raise RuntimeError(f"no restorable checkpoint under {manager.directory} after "
                       f"{max_attempts} quarantine fallbacks")
