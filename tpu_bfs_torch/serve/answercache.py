"""Byte-budgeted answer cache for the serve hot path, the port of
``tpu_bfs/serve/answercache.py`` (host-only).

The :class:`AnswerCache` resolves repeated queries without touching the
scheduler at all:

- **bounded LRU, byte-budgeted**: entries are whole terminal payloads
  (distance row, levels, reached, extras) keyed ``(graph_key,
  graph_generation, cache_generation, kind, source, k, target,
  want_distances)``; inserting past ``max_bytes`` evicts from the cold end.
  A dynamic graph's flip moves the graph generation
  (``set_graph_generation``), so every entry of the old graph becomes
  unreachable by key, not by scan;
- **CRC32 discipline**: each entry's payload is checksummed at ``put`` and
  re-verified at every hit; a mismatch (storage rot, or the
  ``corrupt_cache_entry`` chaos kind flipping a byte at the
  ``cache_lookup`` fault site) degrades the hit to a miss and evicts the
  entry. The ``stale_cache`` kind mutates a CRC-valid hit instead;
- **population at resolve time**: the extraction worker calls ``put``
  after a batch resolves (``serve/frontend._finish``); the dispatch path
  never writes the cache;
- **generation quarantine**: a confirmed stale or corrupt cached answer
  (the integrity tier's shadow audit) bumps the cache generation, which
  is part of every key, and drops the store.

Thread-safe: client threads call ``get`` concurrently with the extraction
worker's ``put``; one lock guards the store.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict

import numpy as np

from tpu_bfs_torch import faults
from tpu_bfs_torch import obs as _obs

#: Default payload budget: ~64 MB holds ~4000 scale-12 distance rows.
DEFAULT_MAX_BYTES = 64 << 20

#: Extras keys this tier STAMPS onto responses (provenance and bound
#: metadata); stored entries drop them so a re-served hit stamps fresh ones.
PROVENANCE_EXTRAS = frozenset(
    ("cache_hit", "landmark", "exact", "bound_lo", "bound_hi")
)


class _Entry:
    __slots__ = ("blob", "levels", "reached", "extras", "crc", "nbytes",
                 "width", "devices")

    def __init__(self, blob, levels, reached, extras, crc, nbytes, width,
                 devices):
        self.blob = blob  # distance row bytes, or None (metadata kinds)
        self.levels = levels
        self.reached = reached
        self.extras = extras
        self.crc = crc
        self.nbytes = nbytes
        self.width = width
        self.devices = devices


def _payload_crc(blob: bytes | None, levels, reached, extras) -> int:
    """CRC32 over the full terminal payload: the distance blob plus a
    canonical rendering of the metadata fields."""
    crc = zlib.crc32(blob) if blob is not None else zlib.crc32(b"\x00")
    meta = repr((levels, reached,
                 sorted(extras.items()) if extras else None))
    return zlib.crc32(meta.encode(), crc)


class AnswerCache:
    """The serve tier's resolved-answer store. ``metrics`` (a
    :class:`~tpu_bfs_torch.serve.metrics.ServeMetrics`) keeps hits, misses,
    evictions and bytes on statsz."""

    def __init__(self, *, graph_key: str = "", graph_generation: int = 0,
                 max_bytes: int = DEFAULT_MAX_BYTES, metrics=None, log=None):
        if max_bytes < 1:
            raise ValueError(f"cache byte budget must be >= 1, got "
                             f"{max_bytes}")
        self.graph_key = graph_key
        self.graph_generation = int(graph_generation)
        self.max_bytes = int(max_bytes)
        self.metrics = metrics
        self.log = log or (lambda *_a, **_k: None)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._generation = 0  # guarded-by: _lock
        self._quarantines = 0  # guarded-by: _lock

    def _key(self, kind, source, k, target, want_distances) -> tuple:
        # Callers hold _lock (both generations are part of the key).
        return (self.graph_key, self.graph_generation, self._generation,
                kind, int(source),
                None if k is None else int(k),
                None if target is None else int(target),
                bool(want_distances))

    def set_graph_generation(self, generation: int) -> None:
        """A dynamic-graph flip: adopt the new served graph version.
        Entries keyed under the old one become unreachable at once; their
        bytes drain off the cold end of the LRU as fresh traffic inserts."""
        with self._lock:
            self.graph_generation = int(generation)

    def put(self, *, kind: str, source: int, k=None, target=None,
            want_distances: bool = True, distances=None, levels=None,
            reached=None, extras=None, width=None, devices=None) -> None:
        """Insert one resolved payload (extraction-worker path), without
        this tier's own provenance keys."""
        if extras:
            extras = {k2: v for k2, v in extras.items()
                      if k2 not in PROVENANCE_EXTRAS}
        blob = None
        if distances is not None:
            blob = np.ascontiguousarray(distances, dtype=np.int32).tobytes()
        nbytes = (len(blob) if blob else 64) + 64
        if nbytes > self.max_bytes:
            return  # one oversized row must not wipe the whole cache
        crc = _payload_crc(blob, levels, reached, extras)
        evicted = 0
        with self._lock:
            key = self._key(kind, source, k, target, want_distances)
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(
                blob, levels, reached, extras, crc, nbytes, width, devices,
            )
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, cold = self._entries.popitem(last=False)
                self._bytes -= cold.nbytes
                evicted += 1
            nbytes_now = self._bytes
        if self.metrics is not None:
            if evicted:
                self.metrics.record_cache_eviction(evicted)
            self.metrics.set_cache_bytes(nbytes_now)

    def get(self, *, kind: str, source: int, k=None, target=None,
            want_distances: bool = True):
        """One lookup on the submit path: a payload dict (``distances``,
        ``levels``, ``reached``, ``extras``, ``width``, ``devices``) or None
        on a miss, including a hit whose CRC check failed (the entry is
        evicted and the miss counted)."""
        with self._lock:
            key = self._key(kind, source, k, target, want_distances)
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                blob = e.blob
        if e is None:
            if self.metrics is not None:
                self.metrics.record_cache_miss()
            return None
        if faults.ACTIVE is not None and blob is not None:
            # Chaos: corrupt_cache_entry rots the STORED blob so the
            # verification below fires as on real storage rot.
            blob, fired = faults.maybe_corrupt_cache_blob(
                blob, query_kind=kind, source=source,
            )
            if fired:
                with self._lock:
                    e.blob = blob
        if _payload_crc(e.blob, e.levels, e.reached, e.extras) != e.crc:
            self._evict_corrupt(key, e)
            return None
        dist = None
        if e.blob is not None:
            dist = np.frombuffer(e.blob, dtype=np.int32)
        extras = dict(e.extras) if e.extras else None
        reached = e.reached
        if faults.ACTIVE is not None:
            # Chaos: stale_cache serves a CRC-valid wrong answer.
            dist, extras, reached, _fired = faults.maybe_stale_cache(
                dist, extras, reached, query_kind=kind, source=source,
            )
        return {
            "distances": dist,
            "levels": e.levels,
            "reached": reached,
            "extras": extras,
            "width": e.width,
            "devices": e.devices,
        }

    def _evict_corrupt(self, key, e) -> None:
        with self._lock:
            if self._entries.get(key) is e:
                self._entries.pop(key)
                self._bytes -= e.nbytes
            nbytes_now = self._bytes
        self.log(f"answer cache: CRC mismatch on {key!r} — entry "
                 f"evicted, hit degraded to a miss")
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("cache_corrupt_entry", cat="serve.cache",
                      kind=key[3], source=key[4])
        if self.metrics is not None:
            self.metrics.record_cache_eviction()
            self.metrics.record_cache_miss()
            self.metrics.set_cache_bytes(nbytes_now)

    def quarantine_generation(self, *, detail: str = "") -> int:
        """A confirmed stale or corrupt CACHED answer poisons trust in the
        whole resident generation: bump the generation (every old key
        becomes unreachable) and drop the store. Returns the new one."""
        with self._lock:
            self._generation += 1
            self._quarantines += 1
            self._entries.clear()
            self._bytes = 0
            gen = self._generation
        self.log(f"answer cache QUARANTINED -> generation {gen}"
                 + (f" ({detail})" if detail else ""))
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("cache_quarantine", cat="serve.cache", generation=gen, detail=detail)
            rec.flight_dump("cache_quarantine")
        if self.metrics is not None:
            self.metrics.record_cache_quarantine()
            self.metrics.set_cache_bytes(0)
        return gen

    def stats(self) -> dict:
        """Entries, resident bytes, the budget, the cache generation and
        its quarantines."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "generation": self._generation,
                "quarantines": self._quarantines,
            }

    def config_summary(self) -> dict:
        """The statsz echo: :meth:`stats` and the served graph generation."""
        out = self.stats()
        out["graph_generation"] = self.graph_generation
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
