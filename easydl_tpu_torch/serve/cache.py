"""Hot-id embedding cache: the client-side row store serving replicas put
in front of the PS pull path.

Recommendation id streams are Zipf-skewed (BENCH_PS.json measured dedup
ratio 0.50 on Zipf(1.1)), so a small byte-bounded LRU absorbs most of a
serving replica's reads — but a cache over MUTABLE rows is only correct
with an invalidation contract. Entries are keyed ``(table, id)`` and
tagged with:

- the **routing generation** the row was routed under — a live reshard
  (2→4 split, ps/reshard.py) commits a new generation and every entry is
  dropped wholesale: shard indices from the old partition mean nothing
  under the new one;
- the owning **shard index** and that shard's **table push-version**
  (``PullResponse.version``) at pull time — any trainer push (or restore /
  migration import) bumps the version, and a cached row is served ONLY
  while the shard still reports the version it was read under. The
  version check is the read client's job (ps/read_client.py validates
  per batch against live probe/pull responses); the cache just stores
  the tags.

Layout is a contiguous row **arena** per table with an id→slot dict and
parallel tag arrays — the same shape as the PS store itself — so every
batch operation (lookup, tag read, gather, insert, demote, evict) is one
lock hold plus numpy vectorized work. A per-id OrderedDict cache measured
~2× SLOWER than no cache at all on the serving hot path; this layout is
what makes the cache a win. LRU is batch-granular: every lookup bumps a
tick, touched slots take it, and eviction drops the smallest-tick slots.

The cache itself is dumb on purpose: lookup/put/demote/LRU/byte-bound,
no RPC, no policy. Batch calls are thread-safe; slot HANDLES returned by
``lookup`` are only stable until the next mutating call, so one batch's
lookup→gather sequence must not interleave with another writer — the
read client serializes its batches (each serving replica owns its cache).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

#: Per-entry bookkeeping overhead (index dict entry, tag array slots) the
#: byte bound charges on top of the row payload, so max_bytes approximates
#: real memory, not just numpy bytes.
ENTRY_OVERHEAD_BYTES = 96

#: Eviction drops to this fraction of max_bytes, not to the exact bound —
#: amortises the O(entries) LRU scan over many inserts.
_EVICT_TO = 0.9


class _TableCache:
    """One table's arena: rows + id→slot index + tag/LRU arrays."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self.row_cost = self.dim * 4 + ENTRY_OVERHEAD_BYTES
        self.index: Dict[int, int] = {}
        cap = 256
        self.rows = np.zeros((cap, self.dim), np.float32)
        self.ids = np.zeros(cap, np.int64)
        self.shard = np.zeros(cap, np.int32)
        self.version = np.zeros(cap, np.uint64)
        self.last_used = np.full(cap, -1, np.int64)  # -1 = free slot
        self.free: list = list(range(cap))

    def grow(self, extra: int) -> None:
        """Ensure at least ``extra`` free slots."""
        if extra <= len(self.free):
            return
        cap = len(self.rows)
        new_cap = max(2 * cap, cap + extra - len(self.free), 256)
        for name in ("rows", "ids", "shard", "version", "last_used"):
            old = getattr(self, name)
            shape = (new_cap,) + old.shape[1:]
            fresh = np.full(shape, -1, old.dtype) if name == "last_used" \
                else np.zeros(shape, old.dtype)
            fresh[:cap] = old
            setattr(self, name, fresh)
        self.free.extend(range(cap, new_cap))


class HotIdCache:
    """Byte-bounded, batch-vectorized LRU of embedding rows with
    staleness tags."""

    def __init__(self, max_bytes: int = 64 << 20):
        if max_bytes <= 0:
            raise ValueError("HotIdCache needs a positive byte bound")
        self.max_bytes = int(max_bytes)
        self._mu = threading.Lock()
        self._tables: Dict[str, _TableCache] = {}
        self._bytes = 0
        self._tick = 0
        self._generation: Optional[int] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0  # entries dropped for staleness (any cause)

    # ------------------------------------------------------------ generation
    def set_generation(self, generation: int) -> bool:
        """Adopt the client's current routing generation; a CHANGE drops
        every entry (old-partition shard tags are meaningless) and returns
        True."""
        with self._mu:
            if self._generation == generation:
                return False
            first = self._generation is None
            if not first:
                self.invalidations += sum(
                    len(t.index) for t in self._tables.values())
            self._tables.clear()
            self._bytes = 0
            self._generation = generation
            return not first

    # --------------------------------------------------------------- access
    def lookup(self, table: str, ids: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch probe: ``(slots, shards, versions)`` aligned to ``ids``
        (slot -1 = miss; tag arrays are 0-filled at misses). Found slots
        take the new LRU tick. Hit/miss accounting is provisional — a
        version-demoted hit is moved back to miss by :meth:`demote`."""
        k = len(ids)
        with self._mu:
            self._tick += 1
            t = self._tables.get(table)
            if t is None:
                self.misses += k
                return (np.full(k, -1, np.int64), np.zeros(k, np.int32),
                        np.zeros(k, np.uint64))
            index = t.index
            slots = np.fromiter(
                (index.get(i, -1) for i in ids.tolist()), np.int64, k)
            found = slots >= 0
            fs = slots[found]
            t.last_used[fs] = self._tick
            shards = np.zeros(k, np.int32)
            versions = np.zeros(k, np.uint64)
            shards[found] = t.shard[fs]
            versions[found] = t.version[fs]
            nf = int(found.sum())
            self.hits += nf
            self.misses += k - nf
            return slots, shards, versions

    def gather(self, table: str, slots: np.ndarray) -> np.ndarray:
        """Rows at ``slots`` (from the immediately-preceding lookup —
        handles are void after any mutating call)."""
        with self._mu:
            return self._tables[table].rows[slots].copy()

    def gather_into(self, table: str, slots: np.ndarray, out: np.ndarray,
                    positions: np.ndarray) -> None:
        """``out[positions] = rows[slots]`` in ONE fancy-index copy — the
        hot-path variant of gather (a gather-then-scatter would copy every
        hit row twice, and hit rows are most of a served batch)."""
        with self._mu:
            out[positions] = self._tables[table].rows[slots]

    def demote(self, table: str, ids: np.ndarray, slots: np.ndarray) -> None:
        """lookup() hits that version-validation rejected: free them and
        move their accounting from hit to miss."""
        k = len(ids)
        if not k:
            return
        with self._mu:
            t = self._tables.get(table)
            if t is None:
                return
            for i in ids.tolist():
                t.index.pop(i, None)
            t.last_used[slots] = -1
            t.free.extend(int(s) for s in slots)
            self._bytes -= k * t.row_cost
            self.hits -= k
            self.misses += k
            self.invalidations += k

    def put(self, table: str, ids: np.ndarray, rows: np.ndarray,
            shards: np.ndarray, versions: np.ndarray) -> None:
        """Insert/overwrite a batch of rows (vectorized); evicts LRU past
        the byte bound."""
        k = len(ids)
        if not k:
            return
        rows = np.ascontiguousarray(rows, np.float32)
        with self._mu:
            t = self._tables.get(table)
            if t is None:
                if rows.shape[1] * 4 + ENTRY_OVERHEAD_BYTES > self.max_bytes:
                    return  # one row can never fit — keep the cache sane
                t = self._tables[table] = _TableCache(rows.shape[1])
            # Overwrite ids already present in place; new ids take free
            # slots (grown as needed).
            slots = np.fromiter(
                (t.index.get(i, -1) for i in ids.tolist()), np.int64, k)
            new = slots < 0
            n_new = int(new.sum())
            if n_new > len(t.free):
                t.grow(n_new)
            if n_new:
                fresh = np.asarray([t.free.pop() for _ in range(n_new)],
                                   np.int64)
                slots[new] = fresh
                new_ids = ids[new]
                t.index.update(zip(new_ids.tolist(), fresh.tolist()))
                self._bytes += n_new * t.row_cost
            t.rows[slots] = rows
            t.ids[slots] = ids
            t.shard[slots] = shards
            t.version[slots] = versions
            t.last_used[slots] = self._tick
            if self._bytes > self.max_bytes:
                self._evict_locked()

    def _evict_locked(self) -> None:
        """Drop least-recently-used entries (cross-table, batch-granular
        LRU) until under _EVICT_TO × max_bytes."""
        target = int(self.max_bytes * _EVICT_TO)
        # Collect (tick, table, slot) for every live entry — O(entries),
        # amortised by evicting down to the low-water mark.
        pools = []
        for name, t in self._tables.items():
            live = np.nonzero(t.last_used >= 0)[0]
            if len(live):
                pools.append((name, t, live, t.last_used[live]))
        while self._bytes > target and pools:
            # Evict from the pool holding the globally-oldest entry, in
            # chunks of its oldest quartile — near-LRU without a global
            # sort per eviction.
            name, t, live, ticks = min(pools, key=lambda p: p[3].min())
            m = max(1, min(len(live),
                           -(-(self._bytes - target) // t.row_cost)))
            m = min(m, max(len(live) // 4, 1))
            idx = np.argpartition(ticks, m - 1)[:m]
            drop = live[idx]
            for i in t.ids[drop].tolist():
                t.index.pop(i, None)
            t.last_used[drop] = -1
            t.free.extend(int(s) for s in drop)
            self._bytes -= len(drop) * t.row_cost
            self.evictions += len(drop)
            keep = np.ones(len(live), bool)
            keep[idx] = False
            live, ticks = live[keep], ticks[keep]
            pools = [(n_, t_, l_, k_) for n_, t_, l_, k_ in pools
                     if n_ != name]
            if len(live):
                pools.append((name, t, live, ticks))

    # ---------------------------------------------------------------- admin
    def dim(self, table: str) -> int:
        with self._mu:
            t = self._tables.get(table)
            return t.dim if t is not None else 0

    def clear(self) -> None:
        with self._mu:
            self.invalidations += sum(
                len(t.index) for t in self._tables.values())
            self._tables.clear()
            self._bytes = 0

    @property
    def entries(self) -> int:
        return sum(len(t.index) for t in self._tables.values())

    @property
    def bytes(self) -> int:
        return self._bytes

    @property
    def generation(self) -> Optional[int]:
        return self._generation

    def stats(self) -> Dict[str, float]:
        with self._mu:
            total = self.hits + self.misses
            return {
                "entries": float(sum(len(t.index)
                                     for t in self._tables.values())),
                "bytes": float(self._bytes),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "evictions": float(self.evictions),
                "invalidations": float(self.invalidations),
                "hit_ratio": (self.hits / total) if total else 0.0,
            }
