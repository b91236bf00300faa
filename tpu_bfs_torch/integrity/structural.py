"""Structural result audits, the port of ``tpu_bfs/integrity/structural.py``:
the ``validate.py`` / Graph500 predicates run in-band on served answers,
over the graph's edge list held on the device.

Auditing a lane costs one [V] host-to-device copy and a scalar read: the
checks are one gather-compare-reduce in plain PyTorch (in JAX they are
``jnp`` code, not a Pallas kernel). The device copy is also the far side
of the ``audit_checksum`` wire check (``integrity/wire.py``): the host and
device folds of the same row must agree, or the copy corrupted it.

Per kind:

- **bfs**: ``dist[source] == 0``, reached-count agreement, and the
  Graph500 edge-level property ``dist[v] <= dist[u] + 1`` over every
  directed edge slot with ``u`` reached;
- **sssp**: the weighted relaxation property ``dist[v] <= dist[u] +
  w(u, v)`` (the Bellman-Ford fixed point), plus the source row;
- **p2p**: path validity on the host (paths are O(levels)): endpoints,
  length == distance, every consecutive pair an edge (a binary search
  over the sorted edge keys, built once);
- **cc / khop**: range and consistency of the extras.

A finding means the served answer violates a property every correct
answer has: corruption, not noise. An error of the audit itself is
reported apart and never quarantines.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch.graph.csr import INF_DIST


class StructuralFinding(Exception):
    """One confirmed structural violation in a served answer."""


class StructuralAuditor:
    """Structure checks over one graph on ``device`` (None: CUDA). The
    device edge tables are built once, under a lock (:meth:`prepare`, or
    the first audit); ``checksum`` adds the wire check of each audited
    row's copy."""

    def __init__(self, graph, *, checksum: bool = False, device=None):
        from tpu_bfs_torch.algorithms._packed_common import resolve_device

        self._g = graph
        self._checksum = bool(checksum)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._dev = None  # guarded-by: _lock — device (src, dst, w) tables
        self._csum = None  # guarded-by: _lock — device checksum fold
        self._edge_keys = None  # guarded-by: _lock — sorted int64 edge keys

    def rebind(self, graph) -> None:
        """Swap the audited graph: the device edge tables and the edge keys
        rebuild on the next audit (the checksum fold keeps V)."""
        with self._lock:
            self._g = graph
            self._dev = None
            self._edge_keys = None

    def prepare(self) -> None:
        """Pay the one-time costs now, on the cold-start path: the device
        edge tables (2-3 x E x 4 bytes beside the engines' own) and the
        checksum fold's multipliers."""
        self._edges_dev()
        if self._checksum:
            self._checksum_fn()

    def _edges_dev(self):
        with self._lock:
            if self._dev is None:
                src, dst = self._g.coo
                w = self._g.weights

                def put(a):
                    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

                self._dev = (put(src), put(dst), None if w is None else put(w))
            return self._dev

    def violations(self, kind: str, dist: torch.Tensor) -> int:
        """Edge slots of a device int32 [V] row that break the kind's
        property: ``dist[v] > dist[u] + w`` (sssp) or ``+ 1`` (the level
        property) with ``u`` reached. int32 throughout: an unreached
        ``u`` is zeroed before the add, so INF never overflows."""
        src, dst, w = self._edges_dev()
        du = dist.index_select(0, src)
        reached = du != int(INF_DIST)
        step = w if kind == "sssp" else 1
        bad = reached & (dist.index_select(0, dst) > du.masked_fill(~reached, 0) + step)
        return int(bad.sum())

    def _checksum_fn(self):
        from tpu_bfs_torch.integrity.wire import make_i32_checksum

        with self._lock:
            if self._csum is None:
                self._csum = make_i32_checksum(self._g.num_vertices, self.device)
            return self._csum

    def _edge_key_set(self) -> np.ndarray:
        with self._lock:
            if self._edge_keys is None:
                src, dst = self._g.coo
                n = np.int64(self._g.num_vertices)
                self._edge_keys = np.sort(src.astype(np.int64) * n + dst.astype(np.int64))
            return self._edge_keys

    def _has_edge(self, u: int, v: int) -> bool:
        keys = self._edge_key_set()
        q = np.int64(u) * np.int64(self._g.num_vertices) + np.int64(v)
        j = np.searchsorted(keys, q)
        return j < len(keys) and keys[j] == q

    # --- the audit --------------------------------------------------------

    def audit(self, kind: str, result) -> None:
        """Check one served :class:`~tpu_bfs_torch.serve.scheduler.QueryResult`.
        Raises :class:`StructuralFinding` on a confirmed violation; any
        other exception is an error of the audit itself."""
        if _faults.ACTIVE is not None:
            # The fault site "audit_structural": a fault here hits the
            # audit tier, which must degrade to an audit error.
            _faults.ACTIVE.hit("audit_structural", lanes=0)
        if kind in ("bfs", "sssp") and result.distances is not None:
            self._audit_distances(kind, result)
        elif kind == "p2p":
            self._audit_p2p(result)
        elif kind == "cc":
            self._audit_cc(result)
        elif kind == "khop":
            self._audit_khop(result)
        else:
            self._sanity(result)  # a metadata-only bfs/sssp answer

    def _wire_verify(self, dist_np: np.ndarray, dev: torch.Tensor) -> None:
        """The ``audit_checksum`` half: the device copy and the host row it
        came from must fold alike. A ``corrupt_wire`` rule flips a bit of
        the host copy between the two folds."""
        from tpu_bfs_torch.integrity.wire import words_checksum_np

        host = dist_np
        if _faults.ACTIVE is not None and _faults.ACTIVE.take(
                "fetch", "corrupt_wire", n=len(dist_np)):
            host = dist_np.copy()
            fin = np.flatnonzero(host != INF_DIST)
            host[fin[len(fin) // 2] if len(fin) else 0] ^= 1
        dev_sum = self._checksum_fn()(dev)
        host_sum = words_checksum_np(host.astype(np.int32))
        if dev_sum != host_sum:
            raise StructuralFinding(
                f"wire checksum mismatch on the audited distance row: device fold "
                f"{dev_sum:#010x} != host fold {host_sum:#010x} — the transfer "
                f"corrupted the data")

    def _audit_distances(self, kind: str, result) -> None:
        dist = np.asarray(result.distances)
        if dist.shape != (self._g.num_vertices,):
            raise StructuralFinding(
                f"distance row is {dist.shape}, graph has {self._g.num_vertices} vertices")
        if int(dist[result.source]) != 0:
            raise StructuralFinding(
                f"source {result.source} at distance {int(dist[result.source])}, not 0")
        reached = int((dist != INF_DIST).sum())
        if result.reached is not None and reached != int(result.reached):
            raise StructuralFinding(
                f"reached count {result.reached} disagrees with the distance row's "
                f"{reached} finite entries")
        dev = torch.from_numpy(np.ascontiguousarray(dist, np.int32)).to(self.device)
        if self._checksum:
            self._wire_verify(dist, dev)
        bad = self.violations(kind, dev)
        if bad:
            prop = ("weighted relaxation property (dist[v] > dist[u] + w)" if kind == "sssp"
                    else "level property (dist[v] > dist[u] + 1)")
            raise StructuralFinding(
                f"{bad} edge(s) violate the {prop} for {kind} from source {result.source}")

    def _audit_p2p(self, result) -> None:
        ex = result.extras or {}
        met, distance = ex.get("met"), ex.get("distance")
        path, target = ex.get("path"), ex.get("target")
        if not met:
            if distance is not None or path is not None:
                raise StructuralFinding("unmet p2p answer carries a distance/path")
            return
        if path is None or distance is None:
            raise StructuralFinding("met p2p answer without a path")
        if len(path) != distance + 1:
            raise StructuralFinding(
                f"p2p path length {len(path)} disagrees with distance {distance}")
        if path[0] != result.source or (target is not None and path[-1] != target):
            raise StructuralFinding(
                f"p2p path endpoints ({path[0]}, {path[-1]}) are not "
                f"(source={result.source}, target={target})")
        for u, v in zip(path, path[1:]):
            if not self._has_edge(int(u), int(v)):
                raise StructuralFinding(f"p2p path edge ({u}, {v}) is not in the graph")

    def _audit_cc(self, result) -> None:
        ex = result.extras or {}
        label, size, total = ex.get("component"), ex.get("component_size"), ex.get("components")
        v = self._g.num_vertices
        if label is None or not (0 <= int(label) < v):
            raise StructuralFinding(f"cc label {label!r} out of range")
        if size is None or not (1 <= int(size) <= v):
            raise StructuralFinding(f"cc component size {size!r} out of range")
        if result.reached is not None and int(size) != int(result.reached):
            raise StructuralFinding(
                f"cc component size {size} disagrees with reached {result.reached}")
        if total is None or not (1 <= int(total) <= v):
            raise StructuralFinding(f"cc component count {total!r} invalid")

    def _audit_khop(self, result) -> None:
        k = (result.extras or {}).get("k")
        if k is None or int(k) < 0:
            raise StructuralFinding(f"khop answer with invalid k={k!r}")
        self._sanity(result)

    def _sanity(self, result) -> None:
        v = self._g.num_vertices
        if result.reached is not None and not (1 <= int(result.reached) <= v):
            raise StructuralFinding(f"reached count {result.reached} outside [1, {v}]")
        # levels is hops for bfs/khop but the WEIGHTED eccentricity for
        # sssp (legitimately > V); only a negative value is always wrong.
        if result.levels is not None and int(result.levels) < 0:
            raise StructuralFinding(f"negative levels {result.levels}")
