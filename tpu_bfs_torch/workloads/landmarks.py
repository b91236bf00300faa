"""Landmark distance tier: p2p answers without traversing, the port of
``tpu_bfs/workloads/landmarks.py`` (host-only).

The MS-BFS substrate runs thousands of sources per batch, so K extra
sources at warm-up are nearly free — landmarks are just lanes. One
flagship batch from the K highest-degree vertices yields distance
columns ``d(l, v)`` for every landmark ``l`` and vertex ``v``; on an
undirected graph the triangle inequality then brackets any pairwise
distance:

    max_l |d(l,s) - d(l,t)|  <=  d(s,t)  <=  min_l d(l,s) + d(l,t)

When the bounds meet the answer is EXACT and a p2p query resolves in
microseconds of NumPy indexing instead of a traversal. High-degree
landmarks make the bounds tight exactly where Zipfian traffic lands:
hub-adjacent pairs route through a landmark, collapsing the bracket.
The serve tier only ever returns exact landmark answers — a bounded
bracket is recorded (``landmark_bounded``) and the query falls back to
traversal, so armed-vs-off streams stay bit-identical.

Reachability is part of the contract: with one landmark per connected
component (high-degree selection gets there fast on real graphs), a
pair split across components shows one finite and one infinite column
entry for some landmark, which proves ``d(s,t) = INF`` exactly.
Both-infinite columns prove nothing and contribute no bound.

Directed graphs are gated off (like the p2p workload itself): the
symmetric triangle bound needs ``d(l,s) = d(s,l)``.

Columns are written once by :meth:`LandmarkIndex.warm` (the serve
warm-up path, under an obs span) and read lock-free afterwards; only
the hit counters take the lock.
"""

from __future__ import annotations

import threading

import numpy as np

from tpu_bfs_torch import obs as _obs
from tpu_bfs_torch.graph.csr import INF_DIST

#: Python-int unreachable sentinel used in bounds (int64 math: the
#: int32 INF would overflow in ``d(l,s) + d(l,t)``).
INF = int(INF_DIST)

#: Default landmark count: one flagship batch column per hub. 16 keeps
#: warm-up inside a single lane group on every ladder width.
DEFAULT_K = 16


def select_landmarks(graph, k: int) -> np.ndarray:
    """Top-``k`` vertices by degree, ties broken by vertex id (so the
    selection — and therefore every bound — is deterministic across
    processes)."""
    n = graph.num_vertices
    k = max(1, min(int(k), n))
    deg = graph.degrees
    order = np.lexsort((np.arange(n), -deg))
    return np.sort(order[:k]).astype(np.int64)


class LandmarkIndex:
    """K distance columns + the triangle-bound query path. Build with
    the host graph, then :meth:`warm` with a batch runner before the
    first :meth:`answer`."""

    def __init__(self, graph, k: int = DEFAULT_K, *, metrics=None):
        if not graph.undirected:
            raise ValueError(
                "landmark bounds need an undirected graph (d(l,s) must "
                "equal d(s,l)); directed graphs fall back to traversal"
            )
        self.landmarks = select_landmarks(graph, k)
        self.k = len(self.landmarks)
        self.num_vertices = graph.num_vertices
        self.metrics = metrics
        self._lock = threading.Lock()
        self._columns = None  # (K, V) int64; written ONCE by warm()
        self._warm_ms = 0.0
        self._exact = 0  # guarded-by: _lock
        self._bounded = 0  # guarded-by: _lock
        self._fallback = 0  # guarded-by: _lock
        self._invalidations = 0  # guarded-by: _lock

    @property
    def warmed(self) -> bool:
        return self._columns is not None

    def invalidate(self) -> None:
        """A dynamic-graph flip: drop the distance columns. They were
        computed over the pre-mutation edge set, and one added edge can
        tighten d(l, v) everywhere, so every triangle bound is suspect. The
        tier answers nothing until its owner re-warms it over the folded
        graph."""
        with self._lock:
            self._columns = None
            self._invalidations += 1

    # --- warm-up ----------------------------------------------------------

    def warm(self, run_batch) -> float:
        """Compute the K distance columns with ONE flagship batch.
        ``run_batch(sources)`` is any MS-BFS runner returning a result
        with ``distances_int32(i)`` per lane (engine.run wrapped by the
        caller). Returns the warm-up wall time in milliseconds."""
        import time

        rec = _obs.ACTIVE
        if rec is not None:
            rec.begin("landmark_warm", "landmarks", cat="serve.cache",
                      k=self.k)
        t0 = time.monotonic()
        try:
            res = run_batch(self.landmarks)
            cols = np.stack(
                [np.asarray(res.distances_int32(i), dtype=np.int64)
                 for i in range(self.k)]
            )
            if cols.shape != (self.k, self.num_vertices):
                raise ValueError(
                    f"landmark warm-up returned columns of shape "
                    f"{cols.shape}, wanted {(self.k, self.num_vertices)}"
                )
            self._columns = cols
            self._warm_ms = (time.monotonic() - t0) * 1e3
            return self._warm_ms
        finally:
            if rec is not None:
                rec.end("landmark_warm", "landmarks", cat="serve.cache",
                        warmed=self._columns is not None)

    # --- queries ----------------------------------------------------------

    def bounds(self, s: int, t: int) -> tuple[int, int, bool]:
        """Triangle-bound bracket ``(lo, hi, exact)`` on ``d(s, t)``,
        with ``(INF, INF, True)`` proving unreachability. ``exact`` iff
        ``lo == hi``; with no informative landmark the vacuous
        ``(0, INF, False)`` comes back."""
        if self._columns is None:
            raise RuntimeError("LandmarkIndex.bounds before warm()")
        if s == t:
            return 0, 0, True
        ds = self._columns[:, s]
        dt = self._columns[:, t]
        fs = ds != INF
        ft = dt != INF
        # One side reachable from l, the other not: different components.
        if bool(np.any(fs != ft)):
            return INF, INF, True
        both = fs & ft
        if not bool(np.any(both)):
            return 0, INF, False
        ds = ds[both]
        dt = dt[both]
        lo = int(np.max(np.abs(ds - dt)))
        hi = int(np.min(ds + dt))
        return lo, hi, lo == hi

    def answer_p2p(self, s: int, t: int):
        """The serve-path consult: an EXACT p2p extras payload, or None
        when only a bracket (or nothing) is known and the query must
        fall back to traversal. Counts exact/bounded/fallback either
        way."""
        lo, hi, exact = self.bounds(s, t)
        if exact:
            self._count("_exact")
            if self.metrics is not None:
                self.metrics.record_landmark(exact=True)
            met = hi != INF
            return {
                "target": int(t),
                "met": met,
                "distance": int(hi) if met else None,
                "path": None,
                "exact": True,
                "landmark": True,
            }
        informative = lo > 0 or hi != INF
        self._count("_bounded" if informative else "_fallback")
        if self.metrics is not None:
            self.metrics.record_landmark(exact=False,
                                         informative=informative)
        return None

    def _count(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    # --- introspection ----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "k": self.k,
                "warmed": self.warmed,
                "warm_ms": round(self._warm_ms, 3),
                "exact": self._exact,
                "bounded": self._bounded,
                "fallback": self._fallback,
                "invalidations": self._invalidations,
            }

    def config_summary(self) -> dict:
        out = self.stats()
        out["landmarks"] = [int(v) for v in self.landmarks[:8]]
        return out
