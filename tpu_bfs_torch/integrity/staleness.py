"""The staleness auditor of dynamic-graph serving and its CPU oracles, the
port of ``tpu_bfs/integrity/staleness.py``.

The failure the other integrity detectors cannot see is a TORN FLIP: a
mutation batch advances the served generation (the registry rekeys, the
cache adopts the new key, the answers claim generation G) but an engine's
overlay swap never landed, so its tables still encode G-1. Every
structural predicate passes (the answer IS a valid BFS over some graph)
and a shadow replay on the same torn service reproduces it. Only a replay
against the generation's own host truth can tell.

The auditor keeps a bounded ring of recent generation snapshots (host
``Graph`` objects, pushed by the serve flip path) and replays a
deterministic sample of resolved answers against CPU oracles, independent
of every device code path (the reference's bfsCPU and checkOutput
discipline, bfs.cu:374-384): a level-synchronous NumPy BFS for bfs (the
same distances as JAX's queue BFS, without a Python step per edge), a
binary-heap Dijkstra for sssp. For each sampled answer it walks the ring newest first:

    staleness = (generation the batch was stamped with at dispatch)
              - (newest generation whose oracle reproduces the answer)

A correct service measures 0: batches are stamped inside the flip lock, so
the stamp names the tables the traversal read. Anything above ``bound`` is
a confirmed over-bound stale answer, and ``on_over_bound`` quarantines the
stale serving state. An answer matching NO ringed generation is corruption,
the shadow and structural detectors' business, and is counted apart.

It runs synchronously on the extraction worker (sealed: an auditor error
never becomes a serving incident); the cost is one host traversal per
sampled answer.
"""

from __future__ import annotations

import heapq
import threading
from collections import OrderedDict

import numpy as np

from tpu_bfs_torch.graph.csr import INF_DIST


def oracle_bfs(graph, source: int) -> np.ndarray:
    """BFS distances (int32, INF_DIST unreached), level by level in NumPy
    over the CSR: each level gathers the frontier rows' neighbor slots and
    keeps the unvisited ones."""
    n = graph.num_vertices
    dist = np.full(n, INF_DIST, np.int32)
    dist[source] = 0
    row_ptr, col_idx = graph.row_ptr, graph.col_idx
    frontier = np.asarray([source], dtype=np.int64)
    level = 0
    while len(frontier):
        level += 1
        lo, hi = row_ptr[frontier], row_ptr[frontier + 1]
        lens = hi - lo
        # Slot positions of every frontier row, concatenated.
        slots = np.repeat(lo - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
        nbrs = col_idx[slots]
        frontier = np.unique(nbrs[dist[nbrs] == INF_DIST]).astype(np.int64)
        dist[frontier] = level
    return dist


def oracle_sssp(graph, source: int) -> np.ndarray:
    """Binary-heap Dijkstra over the int32 weights plane (int32, INF_DIST
    unreached). Parallel edge slots relax one by one, so the lightest
    wins."""
    n = graph.num_vertices
    dist = np.full(n, INF_DIST, np.int32)
    done = np.zeros(n, bool)
    dist[source] = 0
    heap = [(0, int(source))]
    row_ptr, col_idx, wts = graph.row_ptr, graph.col_idx, graph.weights
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for j in range(int(row_ptr[u]), int(row_ptr[u + 1])):
            v = int(col_idx[j])
            nd = d + int(wts[j])
            if not done[v] and nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


#: Kind -> oracle, for the kinds that answer a full distance row.
ORACLES = {"bfs": oracle_bfs, "sssp": oracle_sssp}


#: Ring depth: how many recent generations a stale answer can be
#: attributed to. Older answers report as unmatched.
WINDOW = 4


class StalenessAuditor:
    """The ring and the sampled per-generation replay. The serve flip path
    calls :meth:`push_generation` after every applied mutation batch; the
    extraction worker calls :meth:`observe_batch` after every resolved
    batch."""

    def __init__(self, *, rate: float, seed: int = 0, bound: int = 0,
                 on_over_bound=None, log=None):
        from tpu_bfs_torch.integrity.shadow import AuditSampler

        self.bound = max(int(bound), 0)
        # Decorrelated from the shadow sampler (seed + 1): the two audits
        # should not always pick the same queries.
        self._sampler = AuditSampler(rate, seed + 1)
        self._on_over_bound = on_over_bound or (lambda **kw: None)
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        self._ring: OrderedDict = OrderedDict()  # guarded-by: _lock — gen -> Graph
        self._oracle_cache: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._audits = 0  # guarded-by: _lock
        self._stale = 0  # guarded-by: _lock — matched an OLDER generation
        self._over_bound = 0  # guarded-by: _lock
        self._unmatched = 0  # guarded-by: _lock — corruption, not staleness
        self._errors = 0  # guarded-by: _lock

    # --- the flip-path hook -----------------------------------------------

    def push_generation(self, generation: int, graph) -> None:
        """Adopt ``graph`` as generation ``generation``'s host truth (the
        DynamicGraph's materialized twin). Evicts past the window, with the
        oracle rows of evicted generations."""
        with self._lock:
            self._ring[int(generation)] = graph
            self._ring.move_to_end(int(generation))
            while len(self._ring) > WINDOW:
                old, _ = self._ring.popitem(last=False)
                for key in [k for k in self._oracle_cache if k[0] == old]:
                    del self._oracle_cache[key]

    # --- the extraction-worker hook ---------------------------------------

    def observe_batch(self, pending) -> None:
        """Sampled replay of one resolved batch. Sealed: never lets an
        exception reach the serving path."""
        served_gen = int(getattr(pending, "generation", 0))
        for q in pending.queries:
            try:
                r = q.result(0)
                if not r.ok or r.kind not in ORACLES:
                    continue
                if getattr(r, "distances", None) is None:
                    continue
                if not self._sampler.should_sample():
                    continue
                self._audit_one(q, r, served_gen)
            except Exception as exc:  # noqa: BLE001 — the integrity seal
                with self._lock:
                    self._errors += 1
                self._log(
                    f"staleness audit errored (query "
                    f"{getattr(q, 'id', None)!r}): "
                    f"{type(exc).__name__}: {str(exc)[:200]}"
                )

    def _oracle_row(self, generation: int, kind: str, source: int) -> np.ndarray | None:
        with self._lock:
            graph = self._ring.get(generation)
            key = (generation, kind, int(source))
            row = self._oracle_cache.get(key)
        if graph is None:
            return None
        if row is None:
            row = ORACLES[kind](graph, int(source))
            with self._lock:
                self._oracle_cache[key] = row
                while len(self._oracle_cache) > 4 * WINDOW:
                    self._oracle_cache.popitem(last=False)
        return row

    def _audit_one(self, q, r, served_gen: int) -> None:
        with self._lock:
            self._audits += 1
            gens = list(self._ring)
        served = np.asarray(r.distances, np.int32)
        # Newest first: the common case (staleness 0) matches on the first
        # replay and pays one oracle traversal.
        for gen in sorted(gens, reverse=True):
            if gen > served_gen:
                continue
            truth = self._oracle_row(gen, r.kind, r.source)
            if truth is None or truth.shape != served.shape:
                continue
            if not np.array_equal(truth, served):
                continue
            staleness = served_gen - gen
            if staleness <= 0:
                return
            with self._lock:
                self._stale += 1
                over = staleness > self.bound
                if over:
                    self._over_bound += 1
            if over:
                self._on_over_bound(
                    query_id=q.id, kind=r.kind, source=r.source,
                    served_generation=served_gen, matched_generation=gen,
                    staleness=staleness,
                    detail=(
                        f"{r.kind} answer stamped generation "
                        f"{served_gen} reproduces generation {gen}'s "
                        f"oracle ({staleness} flip(s) stale, bound "
                        f"{self.bound})"
                    ),
                )
            return
        # No ringed generation reproduces it: a wrong answer, not a stale
        # one. Counted; the shadow and structural detectors own it.
        with self._lock:
            self._unmatched += 1
        self._log(
            f"staleness audit: query {q.id!r} ({r.kind}) matches no "
            f"generation in the window {sorted(gens)} — corruption "
            f"territory, deferred to the shadow/structural tier"
        )

    # --- introspection ----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "audits": self._audits,
                "stale": self._stale,
                "over_bound": self._over_bound,
                "unmatched": self._unmatched,
                "errors": self._errors,
                "bound": self.bound,
                "window": len(self._ring),
            }
