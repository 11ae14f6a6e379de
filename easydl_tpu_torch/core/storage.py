"""Chunk IO for checkpoints: the POSIX backend.

Counterpart of ``easydl_tpu/core/storage.py``'s ``CheckpointStorage``,
``PosixStorage`` and ``get_storage``. POSIX has atomic rename, so a save
writes its chunks into a tmp dir and commits by renaming it into the step
dir before the ``COMMITTED`` marker is written (core/checkpoint.py).

Not ported yet: the object-store backend (``gs://``, ``GcsStorage``; its
endpoint is an ``EASYDL_*`` knob, and the port declares none) and the chaos
write hook (``EASYDL_CHAOS_SPEC``).
"""

from __future__ import annotations

import os
import shutil
import urllib.parse
from typing import List

import numpy as np


class CheckpointStorage:
    """Chunk IO interface. Paths are ``/``-separated keys relative to the
    backend's root (the checkpoint directory URL). The manager commits a
    step by renaming its tmp dir, so a backend must rename atomically."""

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def save_array(self, path: str, arr: np.ndarray) -> None:
        raise NotImplementedError

    def load_array(self, path: str) -> np.ndarray:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        """Immediate child names under ``path``; [] when absent."""
        raise NotImplementedError

    def delete_tree(self, path: str) -> None:
        """Delete ``path``, a file or a whole subtree. Never raises on
        absence (concurrent GC)."""
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        raise NotImplementedError


class PosixStorage(CheckpointStorage):
    """Shared-filesystem backend, with memory-mapped chunk reads (a restore
    touches only the slices it needs)."""

    def __init__(self, root: str):
        self.root = root

    def _p(self, path: str) -> str:
        return os.path.join(self.root, path) if path else self.root

    def write_bytes(self, path: str, data: bytes) -> None:
        full = self._p(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)

    def read_bytes(self, path: str) -> bytes:
        with open(self._p(path), "rb") as f:
            return f.read()

    def save_array(self, path: str, arr: np.ndarray) -> None:
        full = self._p(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        np.save(full, arr)

    def load_array(self, path: str) -> np.ndarray:
        return np.load(self._p(path), mmap_mode="r", allow_pickle=False)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._p(path))

    def listdir(self, path: str) -> List[str]:
        try:
            return sorted(os.listdir(self._p(path)))
        except FileNotFoundError:
            return []

    def delete_tree(self, path: str) -> None:
        full = self._p(path)
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        else:
            try:
                os.remove(full)
            except OSError:
                pass

    def makedirs(self, path: str) -> None:
        os.makedirs(self._p(path), exist_ok=True)

    def rename(self, src: str, dst: str) -> None:
        os.replace(self._p(src), self._p(dst))


def get_storage(url: str) -> CheckpointStorage:
    """A plain path or ``file://`` URL -> :class:`PosixStorage`; ``gs://``
    raises: the object-store backend is not ported yet."""
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme == "gs":
        raise NotImplementedError(f"{url}: the gs:// checkpoint backend is not ported yet")
    if parsed.scheme == "file":
        return PosixStorage(parsed.path)
    return PosixStorage(url)
