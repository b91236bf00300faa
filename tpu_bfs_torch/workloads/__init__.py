"""The query kinds beyond BFS over the packed multi-source substrate, the
port of ``tpu_bfs/workloads/__init__.py``.

========  ==========================================================
kind      semantics (and substrate)
========  ==========================================================
bfs       single-source BFS distances (the base engines themselves).
sssp      single-source shortest paths over the WEIGHTED graph:
          bucketed delta-stepping on int32 tentative distances over the
          ELL tables, both halves of each round through K1 ``minplus``
          (``sssp.py``).
cc        connected components: repeated wide MS-BFS sweeps re-seeded
          from the unvisited set, the per-row label folded on the device
          (``cc.py``).
khop      k-hop neighbourhood count: the MS-BFS loop capped at k levels,
          the count read from the on-device lane summaries (``khop.py``).
p2p       point-to-point shortest path: source and target on two lanes
          of one batch, stepped a level at a time until the two visited
          sets meet; the path from the device parent scan (``p2p.py``).
========  ==========================================================

Every kind also runs on a mesh: sssp as ``parallel/dist_sssp.py``'s
``DistSsspEngine`` (``devices > 1``), cc, k-hop and p2p over a
``DistWideMsBfsEngine`` base, every rank running every sweep, level and
scan pass in the same order, and k-hop also over the 2D serve adapter
(``parallel/dist_bfs2d.Dist2DServeEngine``). ``landmarks.py`` is the serve
tier's landmark distance tier.
"""

from __future__ import annotations

import numpy as np

#: Every servable query kind; "bfs" is the default.
KINDS = ("bfs", "sssp", "cc", "khop", "p2p")

#: Engine FAMILIES each kind can ride; ``devices`` then selects the
#: single-device or the mesh form within a family.
KIND_ENGINES = {
    "bfs": ("wide", "hybrid", "packed", "dist2d"),
    "sssp": ("wide",),
    "cc": ("wide",),
    "khop": ("wide", "hybrid", "packed", "dist2d"),
    "p2p": ("wide",),
}

#: Kinds whose responses carry no distance table: they answer from
#: on-device summaries or a cached index alone.
METADATA_ONLY_KINDS = ("cc", "khop", "p2p")


def kind_unsupported_reason(kind: str, engine: str, devices: int,
                            graph) -> str | None:
    """Why this (kind, engine, mesh, graph) combination cannot serve, or
    None when it can."""
    if kind not in KINDS:
        return f"unknown kind {kind!r} (one of {KINDS})"
    if engine not in KIND_ENGINES[kind]:
        return (
            f"kind {kind!r} rides engine families {KIND_ENGINES[kind]}; "
            f"this service runs engine {engine!r}"
        )
    if engine == "packed" and devices > 1:
        return "the packed engine is single-device (no exchange to shard)"
    if kind == "sssp" and getattr(graph, "weights", None) is None:
        return (
            "sssp relaxes weighted edges and this graph has no weights "
            "plane (generate with weights=W or attach one)"
        )
    if kind == "p2p" and not getattr(graph, "undirected", True):
        return (
            "p2p's bidirectional meet is exact on undirected graphs "
            "only, and this graph is directed"
        )
    return None


def supported_kinds(engine: str, devices: int, graph) -> tuple:
    """The kinds a service with this engine, mesh and graph can serve."""
    return tuple(
        kind for kind in KINDS
        if kind_unsupported_reason(kind, engine, devices, graph) is None
    )


def id_of_row_map(engine) -> np.ndarray:
    """[table rows] device-table row -> real vertex id (-1 on pad rows,
    which are never visited), for a full-coverage wide base: the ELL's
    ``old_of_new`` over its active rows on one device; on a mesh the result
    tables are chip-major over the sharded round-robin rank order (row m is
    shard ``m // v_loc``'s local row ``m % v_loc``, global rank
    ``(m % v_loc) * P + m // v_loc``), mapped through the rank inverse.
    The CC label fold and the p2p meet-vertex lookup both read it."""
    ell = getattr(engine, "ell", None)
    if ell is not None:
        return np.asarray(ell.old_of_new[: engine._act], dtype=np.int64)
    sell = engine.sell
    inv = np.full(sell.v_pad, -1, np.int64)
    inv[np.asarray(sell.rank, np.int64)] = np.arange(engine.num_vertices, dtype=np.int64)
    m = np.arange(sell.v_pad, dtype=np.int64)
    return inv[(m % sell.v_loc) * sell.num_shards + m // sell.v_loc]


def batch_params(queries) -> dict:
    """The batch-uniform dispatch kwargs of one coalesced same-kind batch:
    ``{"k": K}`` for khop, the ``targets`` array for p2p, ``{}`` otherwise."""
    kind = getattr(queries[0], "kind", "bfs")
    if kind == "khop":
        return {"k": int(queries[0].k)}
    if kind == "p2p":
        return {"targets": np.asarray([int(q.target) for q in queries],
                                      dtype=np.int64)}
    return {}


class ExchangeRecordDelegate:
    """Mixin for adapters over a ``base`` engine: the exchange-telemetry
    readers ride through to the base (single-device bases record nothing,
    so every reader answers None)."""

    def completed_exchange_record(self):
        taker = getattr(self.base, "completed_exchange_record", None)
        if taker is not None:
            return taker()
        return None, getattr(self.base, "last_exchange_bytes", None)

    def wire_bytes_per_level(self):
        fn = getattr(self.base, "wire_bytes_per_level", None)
        return fn() if fn is not None else None

    def exchange_branch_labels(self):
        fn = getattr(self.base, "exchange_branch_labels", None)
        return fn() if fn is not None else None


class ExtrasResult:
    """A batch result wrapper adding per-query ``extras(i)`` fields over an
    inner result's protocol (reached, ecc, distances)."""

    def __init__(self, inner, extras_list):
        self._inner = inner
        self._extras = extras_list

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def extras(self, i: int) -> dict | None:
        return self._extras[i] if i < len(self._extras) else None


class WorkloadResult:
    """A self-contained batch result (cc): per-lane ``reached``, ``ecc``
    (the ``levels`` source), optional ``edges_traversed``, per-query
    ``extras``, and no distance table."""

    def __init__(self, *, reached, ecc, extras_list=None,
                 edges_traversed=None):
        self.reached = np.asarray(reached)
        self.ecc = np.asarray(ecc, dtype=np.int32)
        self.edges_traversed = edges_traversed
        self._extras = extras_list

    def extras(self, i: int) -> dict | None:
        if self._extras is None:
            return None
        return self._extras[i] if i < len(self._extras) else None

    def distances_int32(self, i: int):
        raise ValueError(
            "this workload kind answers from on-device summaries only "
            "(no distance table exists to pull)"
        )


def build_workload_engine(kind: str, base, graph, spec):
    """The adapter for ``kind`` over an already-built base engine (``base``
    is None for sssp, which builds its own weighted tables). ``spec``
    carries ``lanes``, and optionally ``devices``, ``device`` and
    ``overlay``; for sssp on a mesh (``devices > 1``, built inside each
    rank of a group of that size, or on the rank's ``mesh`` when given)
    ``mesh_shape`` (R, C), ``exchange`` (default 'allreduce' on a 2D mesh,
    else 'ring'), ``delta_bits`` and ``predict``."""
    if kind == "sssp":
        devices = int(getattr(spec, "devices", 1))
        if devices > 1:
            from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
            from tpu_bfs_torch.parallel.mesh import make_mesh, make_mesh_2d

            device = getattr(spec, "device", None)
            mesh_shape = tuple(getattr(spec, "mesh_shape", ()) or ())
            # A serving rank passes its rung's mesh; otherwise this rank's
            # process group is the mesh.
            mesh = getattr(spec, "mesh", None)
            if mesh is None:
                mesh = make_mesh(devices, device=device)
                if mesh_shape:
                    mesh = make_mesh_2d(*mesh_shape, mesh=mesh)
            return DistSsspEngine(
                graph, mesh, lanes=spec.lanes,
                exchange=getattr(spec, "exchange", "") or (
                    "allreduce" if mesh_shape else "ring"),
                delta_bits=tuple(getattr(spec, "delta_bits", ())),
                predict=bool(getattr(spec, "predict", False)),
            )
        from tpu_bfs_torch.workloads.sssp import SsspEngine

        return SsspEngine(
            graph, lanes=spec.lanes, overlay=getattr(spec, "overlay", ()),
            device=getattr(spec, "device", None),
        )
    if kind == "khop":
        from tpu_bfs_torch.workloads.khop import KhopServeEngine

        return KhopServeEngine(base)
    if kind == "cc":
        from tpu_bfs_torch.workloads.cc import CcServeEngine

        return CcServeEngine(base)
    if kind == "p2p":
        from tpu_bfs_torch.workloads.p2p import P2pServeEngine

        return P2pServeEngine(base)
    raise ValueError(f"unknown workload kind {kind!r} (one of {KINDS})")
