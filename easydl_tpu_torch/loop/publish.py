"""Versioned model publication: immutable artifacts, commit-marker-gated
visibility, quarantine on corruption, one-file instant rollback.

The dense-model analogue of the read path's freshness contract: sparse
rows got per-table push-versions; dense models get *publication
versions*. A publish writes ``v_<n>/`` with the payload files, a
``manifest.json`` carrying per-file byte counts + CRC32s, and a
``COMMITTED`` marker LAST (fsync'd) — a version is visible iff the
marker exists, exactly the reshard-cutover discipline, so a publisher
crash mid-write can never be adopted by a serving replica. A version
whose bytes fail their manifest CRC at load time is *quarantined*
(``CORRUPT`` marker first, then the ``COMMITTED`` marker removed — the
CheckpointManager idiom: a crash between the two leaves the step
still-committed or visibly corrupt, never silently absent).

Rollback is one atomic file: ``rollback.json`` ``{"not_after": v}``
caps visibility — versions above the pin exist on disk but are invisible
until :func:`clear_rollback`. A serving replica's Rollout RPC writes the
pin and swaps to an already-loaded version in the same call: instant,
and never a half-updated model (only fully-loaded, CRC-validated
payloads ever enter the bank).

:class:`ModelVersionWatcher` is the serve-side poller: it adopts new
committed versions, loads + validates them OFF the request path, and
hands the built forward to the frontend, which swaps it between batches.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from easydl_tpu_torch.utils.env import knob_float, knob_int
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("loop", "publish")

_VERSION_RE = re.compile(r"^v_(\d{8})$")
_COMMITTED = "COMMITTED"
_CORRUPT = "CORRUPT"
ROLLBACK_FILE = "rollback.json"

ENV_POLL_S = "EASYDL_ROLLOUT_POLL_S"
ENV_KEEP = "EASYDL_ROLLOUT_KEEP"


class VersionCorrupt(RuntimeError):
    """A committed version's bytes fail their manifest CRC/size."""


_metrics_cache: Optional[tuple] = None


def _metrics():
    global _metrics_cache
    if _metrics_cache is None:
        from easydl_tpu_torch.obs import get_registry

        reg = get_registry()
        _metrics_cache = (
            reg.counter(
                "easydl_rollout_publishes_total",
                "Model versions published (COMMITTED marker written)."),
            reg.counter(
                "easydl_rollout_rollbacks_total",
                "Instant rollbacks applied (pin written + live swap).",
                ("replica",)),
            reg.counter(
                "easydl_rollout_quarantines_total",
                "Published versions quarantined for failing their "
                "manifest CRC at load time."),
        )
    return _metrics_cache


def _vdir(directory: str, version: int) -> str:
    return os.path.join(directory, f"v_{version:08d}")


# ---------------------------------------------------------------- publishing
def publish_version(directory: str, arrays: Dict[str, np.ndarray],
                    meta: Optional[Dict[str, Any]] = None,
                    version: Optional[int] = None,
                    keep: Optional[int] = None,
                    _crash_before_commit: bool = False) -> int:
    """Publish one immutable version; returns its number.

    Write order is the whole contract: payload files → manifest (with
    their CRCs) → fsync → ``COMMITTED``. ``_crash_before_commit`` stops
    right before the marker — the chaos drill's torn-publication
    injection point (everything on disk, nothing visible).
    ``keep`` retires the oldest committed versions past the bound
    (default ``EASYDL_ROLLOUT_KEEP``), never the active pin."""
    os.makedirs(directory, exist_ok=True)
    if version is None:
        existing = _all_versions(directory)
        version = (existing[-1] + 1) if existing else 1
    vdir = _vdir(directory, version)
    if os.path.exists(os.path.join(vdir, _COMMITTED)):
        raise FileExistsError(f"version {version} already committed")
    # debris from an aborted publish of the same number: clear first
    if os.path.isdir(vdir):
        shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    files: Dict[str, Dict[str, int]] = {}
    for name, arr in sorted(arrays.items()):
        if not re.fullmatch(r"[A-Za-z0-9._-]+", name):
            raise ValueError(f"bad payload name {name!r}")
        path = os.path.join(vdir, name + ".npy")
        with open(path, "wb") as f:
            np.save(f, np.ascontiguousarray(arr))
            f.flush()
            os.fsync(f.fileno())
        with open(path, "rb") as f:
            data = f.read()
        files[name + ".npy"] = {"bytes": len(data),
                                "crc32": zlib.crc32(data)}
    manifest = {"version": version, "meta": dict(meta or {}),
                "files": files}
    mpath = os.path.join(vdir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    if _crash_before_commit:
        log.warning("publish of version %d stopped BEFORE the commit "
                    "marker (injected crash)", version)
        return version
    cpath = os.path.join(vdir, _COMMITTED)
    with open(cpath, "w") as f:
        f.write(str(version))
        f.flush()
        os.fsync(f.fileno())
    _metrics()[0].inc()
    log.info("published model version %d -> %s", version, vdir)
    retire_versions(directory,
                    int(knob_int(ENV_KEEP)) if keep is None else int(keep))
    return version


def _all_versions(directory: str) -> List[int]:
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for n in names:
        m = _VERSION_RE.match(n)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def list_versions(directory: str) -> List[int]:
    """Committed, non-quarantined versions, ascending."""
    out = []
    for v in _all_versions(directory):
        d = _vdir(directory, v)
        if os.path.exists(os.path.join(d, _COMMITTED)) \
                and not os.path.exists(os.path.join(d, _CORRUPT)):
            out.append(v)
    return out


def read_rollback(directory: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, ROLLBACK_FILE)) as f:
            return int(json.load(f)["not_after"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def set_rollback(directory: str, not_after: int) -> None:
    """Atomically pin visibility to versions ≤ ``not_after``. One file,
    one rename — the rollback a single RPC applies."""
    path = os.path.join(directory, ROLLBACK_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"not_after": int(not_after)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def clear_rollback(directory: str) -> None:
    try:
        os.remove(os.path.join(directory, ROLLBACK_FILE))
    except OSError:
        pass


def active_version(directory: str) -> Optional[int]:
    """Newest committed version, capped by the rollback pin."""
    versions = list_versions(directory)
    pin = read_rollback(directory)
    if pin is not None:
        versions = [v for v in versions if v <= pin]
    return versions[-1] if versions else None


def load_version(directory: str, version: int
                 ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Read + CRC-validate one version's payload. Raises
    :class:`VersionCorrupt` when any file's bytes disagree with the
    manifest — the caller quarantines and falls back."""
    vdir = _vdir(directory, version)
    try:
        with open(os.path.join(vdir, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise VersionCorrupt(f"version {version}: unreadable manifest: {e}")
    arrays: Dict[str, np.ndarray] = {}
    import io

    for name, rec in sorted(manifest.get("files", {}).items()):
        path = os.path.join(vdir, name)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise VersionCorrupt(f"version {version}: missing {name}: {e}")
        if len(data) != int(rec["bytes"]) \
                or zlib.crc32(data) != int(rec["crc32"]):
            raise VersionCorrupt(
                f"version {version}: {name} fails its manifest CRC "
                f"({len(data)} bytes)")
        arrays[name[:-len(".npy")]] = np.load(io.BytesIO(data),
                                              allow_pickle=False)
    return manifest, arrays


def quarantine_version(directory: str, version: int) -> None:
    """Demote a committed version whose bytes failed validation: CORRUPT
    marker first (evidence), COMMITTED removed second — a crash between
    the two leaves it still-committed or visibly corrupt, never silently
    absent (the CheckpointManager discipline)."""
    vdir = _vdir(directory, version)
    try:
        with open(os.path.join(vdir, _CORRUPT), "w") as f:
            f.write(str(version))
            f.flush()
            os.fsync(f.fileno())
    except OSError as e:  # marker is evidence, not a gate
        log.warning("could not write corrupt marker for version %d: %s",
                    version, e)
    try:
        os.remove(os.path.join(vdir, _COMMITTED))
    except OSError:
        pass
    _metrics()[2].inc()
    log.warning("quarantined model version %d (%s)", version, vdir)


def retire_versions(directory: str, keep: int) -> int:
    """Delete the oldest committed versions past ``keep`` (marker first,
    so a half-deleted version reads uncommitted). The ACTIVE version —
    which under a rollback pin may be far older than the newest ``keep``
    — is never touched: a continuous publisher churning versions must
    not delete the model an operator just rolled the fleet back to.
    Torn debris (payload with no marker, left by a publisher crash) older
    than the newest committed version is swept too — the newest
    uncommitted dir is spared, it may be another publisher mid-write."""
    if keep <= 0:
        return 0
    versions = list_versions(directory)
    active = active_version(directory)
    removed = 0
    for v in versions[:-keep]:
        if v == active:
            continue
        vdir = _vdir(directory, v)
        try:
            os.remove(os.path.join(vdir, _COMMITTED))
        except OSError:
            continue
        shutil.rmtree(vdir, ignore_errors=True)
        removed += 1
    newest_committed = versions[-1] if versions else 0
    for v in _all_versions(directory):
        vdir = _vdir(directory, v)
        if (v < newest_committed
                and not os.path.exists(os.path.join(vdir, _COMMITTED))
                and not os.path.exists(os.path.join(vdir, _CORRUPT))):
            shutil.rmtree(vdir, ignore_errors=True)
            removed += 1
    return removed


# ------------------------------------------------------------------ watcher
class ModelVersionWatcher:
    """Serve-side publication watcher: polls the dir, adopts committed
    versions, and hands fully-built forwards to ``on_swap``.

    ``loader(manifest, arrays) -> forward`` builds the servable from a
    validated payload (e.g. ``make_deepfm_forward(params=...)``); loading
    and building run on the watcher thread, never the request path. The
    last ``bank_size`` built versions stay resident — that is what makes
    rollback *instant*: the pin write + an in-memory swap, no reload.

    ``on_swap(version, forward)`` must itself be atomic for the caller
    (the frontend stores the pair under its lock and reads it once per
    batch — a batch runs wholly on one version, swaps land between
    batches)."""

    def __init__(self, directory: str,
                 loader: Callable[[Dict[str, Any], Dict[str, np.ndarray]],
                                  Callable],
                 on_swap: Callable[[int, Callable], None],
                 replica: str = "serve-0",
                 poll_s: Optional[float] = None,
                 bank_size: int = 4):
        self.dir = directory
        self.loader = loader
        self.on_swap = on_swap
        self.replica = replica
        self.poll_s = float(knob_float(ENV_POLL_S)
                            if poll_s is None else poll_s)
        self.bank_size = int(bank_size)
        self._bank: Dict[int, Callable] = {}
        self._mu = threading.Lock()
        self.current: Optional[int] = None
        self.swaps = 0
        self.quarantined: List[int] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ModelVersionWatcher":
        self.poll_once()  # adopt whatever is already published, eagerly
        self._thread = threading.Thread(
            target=self._run, name=f"rollout-watch-{self.replica}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception as e:  # the watcher must outlive bad publishes
                log.warning("rollout watcher poll failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- adoption
    def poll_once(self) -> Optional[int]:
        """One adoption pass; returns the version swapped to (or None).
        A version that fails CRC validation is quarantined and the pass
        retries the next-newest committed one — the replica NEVER adopts
        bytes it could not validate, and never drops its current model."""
        for _ in range(8):  # bounded quarantine fallback, like restore
            want = active_version(self.dir)
            if want is None or want == self.current:
                return None
            fwd = self._bank.get(want)
            if fwd is None:
                try:
                    manifest, arrays = load_version(self.dir, want)
                    fwd = self.loader(manifest, arrays)
                except VersionCorrupt as e:
                    log.warning("refusing version %d: %s", want, e)
                    quarantine_version(self.dir, want)
                    self.quarantined.append(want)
                    continue
            self._install(want, fwd)
            return want
        return None

    def _install(self, version: int, fwd: Callable) -> None:
        with self._mu:
            self._bank[version] = fwd
            while len(self._bank) > self.bank_size:
                # evict oldest that is not current/target
                for v in sorted(self._bank):
                    if v not in (version, self.current):
                        self._bank.pop(v)
                        break
                else:
                    break
            self.current = version
            self.swaps += 1
        self.on_swap(version, fwd)
        log.info("serving replica %s swapped to model version %d",
                 self.replica, version)

    # ------------------------------------------------------------- rollback
    def rollback(self, to_version: Optional[int] = None) -> Tuple[bool, str]:
        """The one-RPC instant rollback: pin visibility to ``to_version``
        (default: the newest committed version BELOW the current one) and
        swap now. Only fully-loaded, CRC-validated versions are ever
        swapped in — a half-updated model cannot be served by
        construction."""
        with self._mu:
            cur = self.current
        if to_version is None:
            candidates = [v for v in list_versions(self.dir)
                          if cur is None or v < cur]
            if not candidates:
                return False, "no older committed version to roll back to"
            to_version = candidates[-1]
        if to_version not in list_versions(self.dir):
            return False, f"version {to_version} is not committed"
        # Validate/load BEFORE writing the pin: a failed rollback RPC
        # must not leave the fleet-visible visibility cap behind as a
        # side effect of an answer that said "failed".
        fwd = self._bank.get(to_version)
        if fwd is None:
            try:
                manifest, arrays = load_version(self.dir, to_version)
                fwd = self.loader(manifest, arrays)
            except VersionCorrupt as e:
                return False, f"rollback target corrupt: {e}"
        set_rollback(self.dir, to_version)
        self._install(to_version, fwd)
        _metrics()[1].inc(replica=self.replica)
        return True, f"active version {to_version}"
