"""Level-checkpointed query resume, the port of
``tpu_bfs/resilience/resume.py``.

A long query on a wide mesh is the one a device loss costs most. The 2D
serve engine (``parallel/dist_bfs2d.Dist2DServeEngine``) therefore drives
its level loop K levels at a time and snapshots the state at each chunk
boundary as a real-id ``BfsCheckpoint`` ([V] arrays, portable across mesh
shapes), so a query re-admitted after a mesh fault resumes on the
degraded mesh from its last snapshot: a query that faulted at level F
re-runs at most ``F - last_snapshot_level <= K`` levels.

The cache is process-wide, one per graph object (weakly keyed): the
degraded rebuild constructs a new engine over the same registry-resident
graph and finds the faulted engine's snapshots here. On a mesh served
from one controller (``parallel/mesh.MeshController``) the cache lives in
the controller alone and the snapshots travel to the ranks as the chunk
commands' arguments. With a spool directory (``set_default_dir``,
``TPU_BFS_RESUME_DIR``, the server's ``--resume-dir``) every snapshot is
also written through ``utils/checkpoint.save_checkpoint`` as
``q<source>.npz`` (the JAX package's file), CRC-checked on load, a
corrupt file quarantined ``.corrupt`` and treated as absent.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref

#: The spool directory newly created caches persist through (None: memory
#: only), read when a cache is created.
_DEFAULT_DIR: str | None = os.environ.get("TPU_BFS_RESUME_DIR") or None
_DIR_LOCK = threading.Lock()


def set_default_dir(path: str | None) -> None:
    """Set the spool directory of newly created caches (``--resume-dir``);
    None reverts to memory only."""
    global _DEFAULT_DIR
    with _DIR_LOCK:
        _DEFAULT_DIR = path or None


@dataclasses.dataclass(frozen=True)
class ResumePolicy:
    """When a long query snapshots its state. ``every_levels`` (K) is the
    snapshot cadence and the chunk size of the level loop; a query
    snapshots at a chunk boundary once it counts as long: ``min_levels``
    levels done or ``min_wall_s`` seconds elapsed (either; 0 disables that
    arm, and with both 0 every boundary snapshots)."""

    every_levels: int
    min_levels: int = 0
    min_wall_s: float = 0.0

    def __post_init__(self):
        if self.every_levels < 1:
            raise ValueError(f"every_levels must be >= 1, got {self.every_levels}")

    def should_snapshot(self, level: int, elapsed_s: float) -> bool:
        """Snapshot at this chunk boundary?"""
        if self.min_levels and level >= self.min_levels:
            return True
        if self.min_wall_s and elapsed_s >= self.min_wall_s:
            return True
        return not self.min_levels and not self.min_wall_s


class ResumeCache:
    """Thread-safe source -> latest snapshot store for one graph. With a
    spool ``root`` each put also writes ``q<source>.npz`` atomically with
    its CRC; ``get`` falls back to the file when memory has no entry (a
    restarted replica), and a corrupt file is quarantined by the loader and
    treated as absent."""

    def __init__(self, root: str | None = None, *, log=None):
        self._log = log or (lambda msg: None)
        self.root = root
        if root:
            os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: dict = {}  # guarded-by: _lock — source -> ckpt
        self.snapshots = 0  # guarded-by: _lock
        self.resumes = 0  # guarded-by: _lock

    def _path(self, source: int) -> str:
        return os.path.join(self.root, f"q{int(source)}.npz")

    def put(self, source: int, ckpt) -> None:
        with self._lock:
            self._entries[int(source)] = ckpt
            self.snapshots += 1
        if self.root:
            from tpu_bfs_torch.utils.checkpoint import save_checkpoint

            try:
                save_checkpoint(self._path(source), ckpt)
            except OSError as exc:
                # The file only backs the in-memory copy; a full disk must
                # not fail the query.
                self._log(f"resume spool write failed ({exc!r}); "
                          f"keeping the in-memory snapshot only")

    def get(self, source: int):
        """The latest snapshot of ``source`` (None when there is none, or
        the only copy on disk failed its CRC)."""
        with self._lock:
            ckpt = self._entries.get(int(source))
        if ckpt is not None or not self.root:
            return ckpt
        from tpu_bfs_torch.utils.checkpoint import CorruptCheckpointError, load_checkpoint

        path = self._path(source)
        if not os.path.exists(path):
            return None
        try:
            ckpt = load_checkpoint(path)
        except CorruptCheckpointError as exc:
            # Quarantined (.corrupt) by the loader: start over rather than
            # resume from poisoned state.
            self._log(f"resume spool entry corrupt ({exc}); starting over")
            return None
        except (OSError, ValueError) as exc:
            self._log(f"resume spool read failed ({exc!r}); starting over")
            return None
        with self._lock:
            self._entries[int(source)] = ckpt
        return ckpt

    def mark_resumed(self, source: int) -> None:
        """Count one mid-query resume (a dispatch starting from a snapshot
        instead of the source)."""
        from tpu_bfs_torch.utils.recovery import COUNTERS

        with self._lock:
            self.resumes += 1
        COUNTERS.bump("query_resumes")

    def drop(self, source: int) -> None:
        """Forget ``source``'s snapshot (its query completed)."""
        with self._lock:
            self._entries.pop(int(source), None)
        if self.root:
            try:
                os.unlink(self._path(source))
            except OSError:
                pass

    def counts(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "snapshots": self.snapshots,
                "resumes": self.resumes,
            }


# One cache per live graph object, keyed by id() with a weakref finalizer
# (a Graph is not hashable; the identity check makes id reuse harmless).
_GRAPH_CACHES: dict = {}  # guarded-by: _CACHE_LOCK — id -> (ref, cache)
# RLock: the finalizer may fire from a gc this thread triggers while it
# holds the lock inside cache_for_graph.
_CACHE_LOCK = threading.RLock()


def cache_for_graph(graph, *, log=None) -> ResumeCache:
    """The process-wide resume cache of ``graph``, created on first use with
    the current spool directory."""
    key = id(graph)
    with _CACHE_LOCK:
        ent = _GRAPH_CACHES.get(key)
        if ent is not None and ent[0]() is graph:
            return ent[1]
        with _DIR_LOCK:
            root = _DEFAULT_DIR
        cache = ResumeCache(root, log=log)

        def _drop(_ref, _key=key):
            with _CACHE_LOCK:
                _GRAPH_CACHES.pop(_key, None)

        _GRAPH_CACHES[key] = (weakref.ref(graph, _drop), cache)
        return cache
