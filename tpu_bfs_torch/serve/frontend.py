"""The serving front end: the in-process ``BfsService`` and the
stdin/stdout JSONL server, the port of ``tpu_bfs/serve/frontend.py``.

``BfsService`` is the API tests and benchmarks drive; the JSONL loop
(``python -m tpu_bfs_torch.serve``) is the same service behind a line
protocol:

    request   {"id": 7, "source": 12345}
              (+ "deadline_ms", + "want_distances": false,
               + "kind": "sssp"|"cc"|"khop"|"p2p", + "k", + "target")
    response  {"id": 7, "source": 12345, "status": "ok", "levels": 6,
               "reached": 104857, "latency_ms": ..., "batch_lanes": 31,
               "dispatched_lanes": 32, "distances_npy": "<base64 .npy>"}

With ``--mutations`` the wire also takes edge updates:

    request   {"id": 9, "op": "mutate", "add": [[1, 2], [3, 4, 7]],
               "remove": [[5, 6]]}
    response  {"id": 9, "op": "mutate", "ok": true, "generation": 3,
               "flip_ms": 1.8, "overlay_rows": 2, "compacted": false}

Non-ok responses carry ``status`` in {rejected, deadline_exceeded, error,
shutdown} plus ``error``. Responses are emitted as queries complete;
``id`` is the correlation key. stdout carries only protocol lines; logs
and the periodic statsz line go to stderr.

The service holds a geometric WIDTH LADDER of warmed engines and routes
each coalesced batch to the narrowest rung that fits; result extraction
runs on a worker thread (PIPELINED), so the scheduler thread dispatches
batch N+1 while batch N's distances are copied to the host. On the card
the worker extracts on its own CUDA stream, ordered after each batch's
dispatch by the event the executor records (``serve/executor.py``).

The integrity tier (``tpu_bfs_torch/integrity``) is armed by the audit
knobs: ``audit_structural`` checks sampled lanes of every served batch
against the graph's tree properties on the device, ``audit_rate``
replays that share of resolved queries on a disjoint rung and
bit-compares them, ``audit_checksum`` folds both sides of each audited
row's copy; a confirmed finding quarantines the rung that served it.

``dynamic=(rows, kcap)`` serves a mutating graph (``graph/dynamic.py``):
every engine builds with a bounded delta overlay, ``apply_edge_updates``
flips the served generation between batches (compacting into a new
persisted base generation when a batch does not fit), and with
``audit_rate`` the staleness auditor replays sampled answers against the
generation they were stamped with.

``devices=N`` serves on a mesh of N ranks (``parallel/mesh.serve_mesh``:
this process is rank 0 and keeps the queries; ranks 1 .. N-1 are followers
that replay its command stream). The ladder's rungs are then the mesh
engines (wide and hybrid on the 1D partition, ``engine='dist2d'`` on the
2D one, with ``exchange``, ``wire_pack``, ``delta_bits``, ``sieve``,
``predict`` and ``mesh_shape``). A mesh fault runs the failover ladder
(``resilience/failover.py``): the service rebuilds its rungs on half the
ranks, down to rank 0 alone, and re-admits the batch; with
``mesh_probe_interval_s`` a background heartbeat climbs back once the
wider mesh answers, and ``resume_levels=K`` (dist2d) continues a
re-admitted query from its last snapshot (``resilience/resume.py``).

``aot_dir`` preheats from an artifact store (``utils/aot.py``): every rung
whose exported programs are there installs them instead of tracing, and
``export_aot`` fills a store from the warmed rungs (the server's
``--preheat`` and ``--export-aot``). A mesh rung's ranks each export and
adopt their own programs; a mesh program counts once in the store's
counters, as JAX's one program does.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import os
import queue as _queue
import signal
import sys
import threading
import time

import numpy as np
import torch

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch import obs as _obs
from tpu_bfs_torch.resilience.failover import floor_config, next_mesh_rung
from tpu_bfs_torch.serve.answercache import AnswerCache
from tpu_bfs_torch.serve.executor import (
    BatchExecutor,
    CircuitBreaker,
    MeshFaultRequeue,
    OomRequeue,
    _stream_ctx,
    breaker_key,
    engine_device,
)
from tpu_bfs_torch.serve.metrics import ServeMetrics
from tpu_bfs_torch.serve.registry import (
    DEFAULT_PLANES,
    HYBRID_LANE_QUANTUM,
    EngineRegistry,
    EngineSpec,
)
from tpu_bfs_torch.serve.scheduler import (
    STATUS_ERROR,
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHUTDOWN,
    AdmissionQueue,
    InflightIndex,
    PendingQuery,
    QueryResult,
)
from tpu_bfs_torch.utils.recovery import (
    COUNTERS,
    is_mesh_fault,
    is_oom_failure,
    is_transient_failure,
)
from tpu_bfs_torch.workloads import (
    KINDS,
    METADATA_ONLY_KINDS,
    kind_unsupported_reason,
    supported_kinds,
)

MIN_LANES = 32
# Auto ladder spacing: each rung 4x the previous (32/128/512 at a 512-lane
# top), bounding pad waste per batch below 3/4 of the dispatched width.
LADDER_FACTOR = 4


def ladder_bounds(lanes: int, *, devices: int = 1,
                  engine: str = "wide") -> tuple[int, int]:
    """``(floor, quantum)`` of the serving widths for this engine and mesh:
    the hybrid engines serve whole 4096-lane steps (one device or a mesh);
    the others 32-lane steps from 32 on one device, and from ``32 *
    devices`` (at most ``lanes``) on a mesh, where a narrower batch pays
    every rank's collectives for work one device holds."""
    if engine == "hybrid":
        return HYBRID_LANE_QUANTUM, HYBRID_LANE_QUANTUM
    if devices > 1:
        return min(lanes, MIN_LANES * devices), MIN_LANES
    return MIN_LANES, MIN_LANES


def build_width_ladder(lanes: int, ladder="auto", *, devices: int = 1,
                       engine: str = "wide") -> list:
    """The service's resident widths, ascending, topped by ``lanes``.

    ``"auto"`` walks down from ``lanes`` by :data:`LADDER_FACTOR` to the
    engine and mesh floor (:func:`ladder_bounds`); ``"off"``/None serves
    one fixed width; an explicit sequence (or a comma-separated string)
    gives the rungs directly, each a multiple of the width quantum in
    [floor, lanes]."""
    floor, quantum = ladder_bounds(lanes, devices=devices, engine=engine)
    if ladder in (None, "off"):
        return [lanes]
    if isinstance(ladder, str) and ladder != "auto":
        ladder = [int(tok) for tok in ladder.replace(",", " ").split()]
    if ladder == "auto":
        rungs = {lanes}
        w = lanes
        while w > floor:
            w = max(floor, (w // LADDER_FACTOR) // quantum * quantum)
            rungs.add(w)
        return sorted(rungs)
    rungs = sorted({int(w) for w in ladder} | {lanes})
    for w in rungs:
        if w % quantum or not (floor <= w <= lanes):
            raise ValueError(
                f"ladder width {w} must be a multiple of {quantum} in "
                f"[{floor}, {lanes}]"
            )
    return rungs


@dataclasses.dataclass(frozen=True)
class MeshServeConfig:
    """The service's CURRENT engine and mesh configuration: everything
    ``_spec`` stamps into a registry key. One immutable object swapped
    whole by the failover ladder (degrade) and the health probe (restore),
    so every reader sees a consistent config with no lock on routing."""

    engine: str
    devices: int
    exchange: str
    wire_pack: bool
    delta_bits: tuple
    sieve: bool
    predict: bool
    mesh_shape: tuple
    resume_levels: int

    def degraded(self, new_devices: int) -> "MeshServeConfig":
        """This config one mesh rung down. At one device the exchange knobs
        drop and mesh-only engines map to their single-device twin
        (``resilience.failover.floor_config``); a rung still on a mesh
        keeps the exchange family, on the smaller mesh."""
        if new_devices == 1:
            engine, exchange = floor_config(self.engine, self.exchange)
            return MeshServeConfig(
                engine=engine, devices=1, exchange=exchange,
                wire_pack=False, delta_bits=(), sieve=False, predict=False,
                mesh_shape=(), resume_levels=0,
            )
        return dataclasses.replace(
            self, devices=new_devices,
            # An explicit RxC described the FULL mesh; the degraded shape
            # re-derives most-square.
            mesh_shape=(),
        )


class BfsService:
    """Long-lived lane-batching BFS query service over one graph, on one
    device or a mesh.

    ``graph`` is a loaded ``Graph`` or a CLI graph spec string (path /
    ``rmat:scale=...`` / ``random:n=...``). Queries submitted from any
    thread are coalesced into packed batches of up to ``lanes`` sources by
    one scheduler thread; each batch is routed to the narrowest
    ``width_ladder`` rung that fits. ``linger_ms`` bounds how long a
    partial batch waits for fill; ``queue_cap`` bounds the backlog
    (overload sheds with REJECTED); ``deadline_ms`` bounds each query's
    QUEUE wait. An OOM at rung W evicts W and every wider rung and
    re-admits the batch's queries below W (halving, down to the floor);
    transient failures retry in place; deterministic ones feed the
    per-width circuit breaker. With ``pipeline=True`` result extraction
    overlaps the next batch's dispatch on a worker thread
    (``pipeline_depth`` bounds the handoff). ``distances`` is the default
    of whether responses carry the distance table; distance-free queries
    never copy it off the device. ``kinds`` picks the query kinds served
    (default: all this engine and graph support). ``cache_bytes`` arms the
    answer cache and ``landmarks`` the landmark p2p tier; ``single_flight``
    collapses identical in-flight queries. ``audit_rate``,
    ``audit_structural``, ``audit_checksum`` and ``audit_seed`` arm the
    integrity tier (module docstring). ``dynamic=(rows, kcap)`` (True: the
    default capacity) serves a mutating graph through
    ``apply_edge_updates``; ``generation_dir`` persists its compactions
    (default: a temporary directory the service owns) and
    ``staleness_bound`` is how many flips a sampled answer may trail
    before the staleness auditor quarantines it (with ``audit_rate``).
    ``device`` is the torch device of the service's own registry (None:
    CUDA, raising without a card).

    With ``devices > 1`` the rungs are mesh engines over the process's
    serving mesh (``parallel/mesh.serve_mesh``, started by ``start()`` on
    ``device`` unless one of at least ``devices`` ranks exists, and then
    closed with the service): wide and hybrid on the 1D partition,
    ``engine='dist2d'`` on the 2D one; ``exchange``, ``wire_pack``,
    ``delta_bits``, ``sieve`` and ``predict`` pick the exchange,
    ``mesh_shape`` the R x C
    factorization, and the ladder floor, the OOM halving grid and the
    breaker keys follow the mesh. A MESH FAULT (``utils/recovery
    .is_mesh_fault``) rebuilds the ladder on half the ranks (down to one
    device) and re-admits the batch; ``mesh_probe_interval_s > 0``
    heartbeats the wider rungs in the background and promotes back once
    they answer; ``resume_levels=K`` (dist2d) continues re-admitted queries
    from their last snapshot.
    """

    def __init__(
        self,
        graph,
        *,
        engine: str = "wide",
        lanes: int = 512,
        planes: int = DEFAULT_PLANES,
        pull_gate: bool = False,
        devices: int = 1,
        exchange: str = "",
        wire_pack: bool = False,
        delta_bits=(),
        sieve: bool = False,
        predict: bool = False,
        mesh_shape=(),
        resume_levels: int = 0,
        mesh_probe_interval_s: float = 0.0,
        width_ladder="auto",
        pipeline: bool = True,
        pipeline_depth: int = 2,
        linger_ms: float = 2.0,
        queue_cap: int = 1024,
        deadline_ms: float = 0.0,
        max_retries: int = 2,
        max_requeues: int = 8,
        watchdog_ms: float = 0.0,
        breaker_threshold: int = 3,
        breaker_cooldown_ms: float = 30_000.0,
        audit_rate: float = 0.0,
        audit_structural: bool = False,
        audit_checksum: bool = False,
        audit_seed: int = 0,
        cache_bytes: int = 0,
        landmarks: int = 0,
        dynamic=(),
        generation_dir: str | None = None,
        staleness_bound: int = 0,
        single_flight: bool = True,
        distances: bool = True,
        kinds=None,
        registry: EngineRegistry | None = None,
        registry_capacity: int = 4,
        aot_dir: str | None = None,
        device=None,
        autostart: bool = True,
        log=None,
    ):
        self._log = log or (lambda msg: None)
        # Widths and the degrade cap share one lock: the scheduler routes
        # while the extraction worker may shrink the ladder after an OOM
        # (or a mesh fault rebuild it on fewer devices).
        self._width_lock = threading.Lock()
        self._ladder = build_width_ladder(  # guarded-by: _width_lock
            lanes, width_ladder, devices=devices, engine=engine
        )
        self._max_lanes = self._ladder[-1]  # guarded-by: _width_lock
        # The engine and mesh width grid: the OOM halving quantizes onto it
        # and stops at its floor.
        self._width_floor, self._width_quantum = ladder_bounds(
            lanes, devices=devices, engine=engine
        )
        # An internally created registry holds the whole ladder (plus one
        # degrade slot); a caller-supplied registry keeps its own policy.
        # ``aot_dir`` arms its artifact store: every rung whose artifacts
        # are present adopts them instead of tracing.
        self._registry = registry or EngineRegistry(
            capacity=max(registry_capacity, len(self._ladder) + 1),
            log=self._log, device=device, aot_store=aot_dir,
        )
        if isinstance(graph, str):
            self._graph_key = graph
        else:
            self._graph_key = f"graph@{id(graph):x}"
            self._registry.add_graph(self._graph_key, graph)
        self._graph = self._registry.graph(self._graph_key)
        self._planes = planes
        self._pull_gate = pull_gate
        # The CURRENT engine and mesh config, swapped whole by the failover
        # ladder (degrade) and the health probe (restore); _cfg0 is the
        # as-launched config a restore climbs back to, and _ladder_arg lets
        # a degraded ladder re-derive from the operator's intent.
        self._mesh_cfg = self._cfg0 = MeshServeConfig(
            engine=engine, devices=devices, exchange=exchange,
            wire_pack=bool(wire_pack), delta_bits=tuple(delta_bits),
            sieve=bool(sieve), predict=bool(predict),
            mesh_shape=tuple(mesh_shape),
            resume_levels=int(resume_levels),
        )
        self._ladder_arg = width_ladder
        self._mesh_probe_interval_s = max(mesh_probe_interval_s, 0.0)
        self._mesh_probe = None  # guarded-by: _lock (lifecycle state)
        auto_kinds = supported_kinds(engine, devices, self._graph)
        if kinds is None:
            self._kinds = auto_kinds
        else:
            kinds = tuple(kinds)
            for kind in kinds:
                if kind not in KINDS:
                    raise ValueError(
                        f"unknown kind {kind!r} (one of {KINDS})"
                    )
                if kind not in auto_kinds:
                    why = kind_unsupported_reason(kind, engine, devices, self._graph)
                    raise ValueError(
                        f"kind {kind!r} is not servable by this config: "
                        f"{why} (servable: {auto_kinds})"
                    )
            self._kinds = kinds
        if not self._kinds:
            raise ValueError("service must serve at least one kind")
        # The dynamic-graph tier: ``dynamic=(rows, kcap)`` (True: the
        # default capacity) builds every engine with a bounded overlay of
        # that shape, the flip lock serializes flips against batch
        # dispatch, and ``apply_edge_updates`` is the mutation API. The
        # flip state exists (cheap, inert) on static services too, so the
        # scheduler loop stays branch-free.
        self._flip_lock = threading.RLock()
        self._dynamic = None
        self._gen_store = None
        self._gen_tmp = None
        self._overlay_cap = ()
        # Writes serialize under _flip_lock; reads are lock-free (an int
        # snapshot): _spec and the cache straggler guard run on paths that
        # also hold _width_lock, and taking the flip lock there would close
        # a lock-order cycle.
        self._graph_generation = 0
        self._overlay_tables = None  # guarded-by: _flip_lock
        self._overlay_epoch = 0  # guarded-by: _flip_lock
        self._flips = 0  # guarded-by: _flip_lock
        self._compactions = 0  # guarded-by: _flip_lock
        self._staleness = None
        if dynamic:
            from tpu_bfs_torch.graph.dynamic import (
                DEFAULT_CAPACITY,
                DynamicGraph,
                GenerationStore,
            )

            cap = (DEFAULT_CAPACITY if dynamic is True
                   else (int(dynamic[0]), int(dynamic[1])))
            self._overlay_cap = cap
            # Raises on a directed base before any build (the engine and
            # pull-gate combinations are EngineSpec.validate's, below).
            self._dynamic = DynamicGraph(self._graph, capacity=cap, log=self._log)
            if generation_dir is None:
                import tempfile

                # A service-owned store: compactions keep the crash-safe
                # commit protocol, in a directory that does not outlive
                # the service (pass generation_dir for one that does).
                self._gen_tmp = tempfile.TemporaryDirectory(prefix="tpu-bfs-generations-")
                generation_dir = self._gen_tmp.name
            self._gen_store = GenerationStore(generation_dir, log=self._log)
            if "p2p" in self._kinds:
                # p2p's path reconstruction scans the build-time edge
                # tables, which the overlay fold never touches: a path
                # could walk a removed edge (EngineSpec.validate refuses
                # the same).
                self._kinds = tuple(k for k in self._kinds if k != "p2p")
                self._log(
                    "dynamic serving: p2p dropped from the served kinds "
                    "(path reconstruction reads build-time edge tables)"
                )
                if not self._kinds:
                    raise ValueError("dynamic serving cannot serve p2p alone")
            if audit_rate > 0:
                from tpu_bfs_torch.integrity.staleness import StalenessAuditor

                # The generation-staleness arm of the integrity tier, at
                # the shadow audits' rate, replaying against the
                # generation ring instead of a disjoint rung.
                self._staleness = StalenessAuditor(
                    rate=audit_rate, seed=audit_seed,
                    bound=staleness_bound,
                    on_over_bound=self._on_stale_generation,
                    log=self._log,
                )
                self._staleness.push_generation(0, self._graph)
        elif generation_dir is not None:
            raise ValueError(
                "generation_dir without dynamic=(rows, kcap): the "
                "generation store only exists to persist compactions"
            )
        if registry is None and len(self._kinds) > 1:
            # One resident engine per additional kind next to the ladder.
            self._registry.capacity = max(
                self._registry.capacity,
                len(self._ladder) + len(self._kinds),
            )
        for w in self._ladder:
            self._spec(w).validate()  # fail at construction, not first dispatch
        self._device = device
        self._owned_mesh = None  # guarded-by: _lock (lifecycle state)
        self._linger_s = max(linger_ms, 0.0) / 1e3
        self._default_deadline_s = max(deadline_ms, 0.0) / 1e3
        self._queue = AdmissionQueue(queue_cap)
        self.metrics = ServeMetrics()
        self._breaker = CircuitBreaker(
            threshold=breaker_threshold,
            cooldown_s=max(breaker_cooldown_ms, 0.0) / 1e3,
            log=self._log,
        )
        self._executor = BatchExecutor(
            self.metrics, max_retries=max_retries, log=self._log,
            watchdog_s=max(watchdog_ms, 0.0) / 1e3, breaker=self._breaker,
        )
        self._max_retries = max_retries
        # Bounded OOM requeue budget: a query re-admitted more than this
        # many times resolves with an error carrying its attempt history.
        self._max_requeues = max(int(max_requeues), 0)
        # The integrity tier, armed by any audit knob; a disarmed service
        # holds None and pays nothing. flush_audits waits for no batch in
        # the finish-and-observe window and an empty pipeline.
        self._audit_quiesce = threading.Lock()
        self._finishing = 0  # guarded-by: _audit_quiesce
        if audit_rate > 0 or audit_structural or audit_checksum:
            from tpu_bfs_torch.integrity import IntegrityTier

            self._integrity = IntegrityTier(
                self, rate=audit_rate,
                structural=bool(audit_structural) or bool(audit_checksum),
                checksum=audit_checksum, seed=audit_seed,
            )
            if registry is None:
                # The shadow replays keep a disjoint rung (plus a rebuild
                # slot) resident beside the serving ladder.
                self._registry.capacity = self._registry.capacity + 2
        else:
            self._integrity = None
        # Answer tier: single-flight (on by default) is independent of the
        # cache; hits bypass the scheduler and stamp provenance.
        self._inflight = InflightIndex() if single_flight else None
        self._cache = (
            AnswerCache(
                graph_key=self._graph_key, max_bytes=int(cache_bytes),
                metrics=self.metrics, log=self._log,
            )
            if cache_bytes else None
        )
        self._landmark_k = max(int(landmarks), 0)
        self._landmarks = None  # built by start()'s warm-up when armed
        self._want_distances_default = bool(distances)
        self._pipe_q: _queue.Queue | None = (
            _queue.Queue(maxsize=max(1, int(pipeline_depth)))
            if pipeline else None
        )
        # Lock-free single-word flags (submit must never block behind
        # start()'s builds); the thread handles are lifecycle state.
        self._closed = False
        self._draining = False
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._extract_thread: threading.Thread | None = None  # guarded-by: _lock
        self._lock = threading.Lock()
        if autostart:
            self.start()

    # --- lifecycle --------------------------------------------------------

    def _spec(self, width: int | None = None,
              cfg: MeshServeConfig | None = None,
              kind: str = "bfs") -> EngineSpec:
        cfg = self._mesh_cfg if cfg is None else cfg
        if kind == "sssp" and cfg.devices > 1:
            # The service's exchange config speaks the OR family's dialect;
            # the mesh SSSP engine exchanges under (min, +). Queue-style
            # stays queue-style (sparse with delta_bits and predict);
            # everything dense-like becomes the engine default; wire_pack
            # and sieve have no min twin and drop.
            sparse = cfg.exchange == "sparse"
            return EngineSpec(
                graph_key=self._graph_key,
                graph_generation=self._graph_generation,
                kind=kind,
                engine=cfg.engine,
                lanes=self.lanes if width is None else width,
                planes=self._planes,
                devices=cfg.devices,
                exchange=cfg.exchange if sparse else "",
                delta_bits=cfg.delta_bits if sparse else (),
                predict=cfg.predict if sparse else False,
                mesh_shape=cfg.mesh_shape,
            )
        return EngineSpec(
            graph_key=self._graph_key,
            graph_generation=self._graph_generation,
            overlay=self._overlay_cap,
            kind=kind,
            engine=cfg.engine,
            lanes=self.lanes if width is None else width,
            planes=self._planes,
            pull_gate=self._pull_gate,
            devices=cfg.devices,
            exchange=cfg.exchange,
            wire_pack=cfg.wire_pack,
            delta_bits=cfg.delta_bits,
            sieve=cfg.sieve,
            predict=cfg.predict,
            mesh_shape=cfg.mesh_shape,
            resume_levels=cfg.resume_levels,
        )

    def start(self) -> "BfsService":
        """Build and warm every ladder rung's engine (widest first, so the
        width most likely to OOM degrades the ladder before anything
        narrower is paid for), warm the landmark tier when armed, then
        start the scheduler thread and (pipelined) the extraction worker.
        Idempotent; called by the constructor unless ``autostart=False``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            if self._thread is not None:
                return self
            if self._cfg0.devices > 1 and self._owned_mesh is None:
                from tpu_bfs_torch.parallel.mesh import active_controller, serve_mesh

                # The serving mesh: this process as rank 0 of at least
                # ``devices`` ranks, started here (and closed with the
                # service) unless the process already serves one.
                had = active_controller()
                ctl = serve_mesh(self._cfg0.devices, device=self._device)
                if ctl is not had:
                    self._owned_mesh = ctl
            for w in sorted(self.width_ladder, reverse=True):
                if w <= self.lanes:  # rungs above a degraded cap died
                    self._acquire_engine(w, self._primary_kind)
            if self._landmark_k > 0:
                self._warm_landmarks()
            if (self._mesh_probe_interval_s > 0
                    and self._cfg0.devices > 1
                    and self._mesh_probe is None):
                from tpu_bfs_torch.resilience.probe import MeshHealthProbe

                # The background prober: heartbeats the rungs above a
                # degraded service and promotes back onto the widest that
                # answers (a no-op at full width).
                self._mesh_probe = MeshHealthProbe(
                    self._cfg0.devices,
                    interval_s=self._mesh_probe_interval_s,
                    current=lambda: self._mesh_cfg.devices,
                    on_healthy=self._on_mesh_healthy,
                    log=self._log,
                ).start()
            if self._pipe_q is not None:
                self._extract_thread = threading.Thread(
                    target=self._extract_loop, name="bfs-serve-extract",
                    daemon=True,
                )
                self._extract_thread.start()
            self._thread = threading.Thread(
                target=self._loop, name="bfs-serve-scheduler", daemon=True
            )
            self._thread.start()
            if self._integrity is not None:
                self._integrity.start()
        return self

    def drain(self) -> None:
        """Stop ADMISSION only: new submits shed with REJECTED while queued
        and in-flight queries run to resolution (the JSONL server's SIGTERM
        path; ``close`` completes it). Idempotent."""
        self._draining = True

    def close(self) -> None:
        """Stop serving: in-flight batches complete (the extraction worker
        drains its handoff first), queued queries resolve with SHUTDOWN.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
            extract_thread = self._extract_thread
            probe, self._mesh_probe = self._mesh_probe, None
        if probe is not None:
            probe.stop()
        self._queue.stop()
        if thread is not None:
            thread.join()
            if extract_thread is not None:
                self._pipe_q.put(None)  # after scheduler exit: no more puts
                extract_thread.join()
            if self._integrity is not None:
                # After both serving threads: close() drains every queued
                # audit, so the final statsz carries complete counts.
                self._integrity.close()
        else:
            # Never started: drain staged queries here instead.
            for q in self._queue.next_batch(self._queue.cap, 0.0):
                if q.resolve_status(STATUS_SHUTDOWN, error="service closed"):
                    self.metrics.record_shutdown()
        if self._gen_tmp is not None:
            # The service-owned generation store: reclaim it now rather
            # than at interpreter teardown.
            try:
                self._gen_tmp.cleanup()
            except OSError:
                pass
            self._gen_tmp = None
        with self._lock:
            owned, self._owned_mesh = self._owned_mesh, None
        if owned is not None:
            # The engines go with the mesh they span: drop this service's
            # mesh residencies, then stop the followers.
            for spec in self._registry.resident() or []:
                if spec.devices > 1:
                    self._registry.evict(spec)
            owned.close()

    def __enter__(self) -> "BfsService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- client API -------------------------------------------------------

    @property
    def num_vertices(self) -> int:
        return self._graph.num_vertices

    @property
    def kinds(self) -> tuple:
        """Query kinds this service answers."""
        return self._kinds

    @property
    def _primary_kind(self) -> str:
        """The kind whose ladder start() warms ("bfs" when served); other
        kinds' engines build on their first query."""
        return "bfs" if "bfs" in self._kinds else self._kinds[0]

    @property
    def lanes(self) -> int:
        """Current maximum serving batch width (halves on OOM degrade)."""
        with self._width_lock:
            return self._max_lanes

    @property
    def width_ladder(self) -> list:
        """Resident dispatch widths, ascending (shrinks on OOM degrade)."""
        with self._width_lock:
            return list(self._ladder)

    def submit(self, source, *, id=None, deadline_ms: float | None = None,
               want_distances: bool | None = None, kind: str = "bfs",
               k: int | None = None,
               target: int | None = None) -> PendingQuery:
        """Enqueue one query; the returned PendingQuery's ``result()``
        always resolves (ok / rejected / deadline_exceeded / error /
        shutdown). ``want_distances=False`` asks for levels and reached
        only (no distance copy); None uses the service default. ``kind``
        picks the query family; khop needs ``k`` >= 0, p2p a ``target``.
        A malformed query resolves with a structured error."""
        now = time.monotonic()
        ddl_s = (
            self._default_deadline_s
            if deadline_ms is None
            else max(deadline_ms, 0.0) / 1e3
        )
        kind = "bfs" if kind is None else kind
        if kind in METADATA_ONLY_KINDS:
            # cc/khop/p2p answer from summaries; no distance table exists.
            want_distances = False
        q = PendingQuery(
            source, id=id, now=now,
            deadline=(now + ddl_s) if ddl_s > 0 else None,
            want_distances=(
                self._want_distances_default
                if want_distances is None else want_distances
            ),
            kind=kind if kind in KINDS else "bfs",
            k=k, target=target,
        )
        err = self._validate_query(kind, q, k, target)
        if err is not None:
            q.resolve_status(STATUS_ERROR, error=err)
            self.metrics.record_errors()
            return q
        # Answer tier ahead of admission: a cache or landmark hit resolves
        # here; a duplicate of an in-flight query becomes a single-flight
        # follower riding the leader's dispatch.
        if not (self._closed or self._draining):
            if self._try_answer_tier(q):
                return q
            leader = (self._inflight.attach(q)
                      if self._inflight is not None else None)
            if leader is not None:
                self.metrics.record_single_flight()
                q.add_done_callback(self._account_follower)
                return q
        if self._closed or self._draining or not self._queue.offer(q):
            q.resolve_status(
                STATUS_REJECTED,
                error=(
                    "service closed" if self._closed
                    else "service draining" if self._draining
                    else "queue full"
                ),
            )
            self.metrics.record_rejected()
        return q

    def _validate_query(self, kind: str, q: PendingQuery,
                        k, target) -> str | None:
        """The per-kind admission contract: the error text of a malformed
        query, None when admissible."""
        if kind not in KINDS:
            return f"unknown kind {kind!r} (one of {KINDS})"
        if kind not in self._kinds:
            cfg = self._mesh_cfg
            why = kind_unsupported_reason(kind, cfg.engine, cfg.devices, self._graph)
            return (
                f"kind {kind!r} is not served by this service: "
                + (why if why is not None else
                   f"excluded by this service's kinds= selection "
                   f"(engine={cfg.engine!r}, devices={cfg.devices})")
                + f"; serving {self._kinds}"
            )
        if not (0 <= q.source < self._graph.num_vertices):
            return (
                f"source {q.source} out of range "
                f"[0, {self._graph.num_vertices})"
            )
        if kind == "khop":
            if k is None or int(k) < 0:
                return f'khop needs "k" >= 0, got {k!r}'
        if kind == "p2p":
            if target is None:
                return 'p2p needs a "target" vertex id'
            if not (0 <= int(target) < self._graph.num_vertices):
                return (
                    f"target {target} out of range "
                    f"[0, {self._graph.num_vertices})"
                )
        return None

    # --- answer tier ------------------------------------------------------

    def _try_answer_tier(self, q: PendingQuery) -> bool:
        """Resolve ``q`` from the answer cache or the landmark columns
        without traversing. Only EXACT landmark answers are served, so an
        armed service answers as a disarmed one does."""
        cache = self._cache
        if cache is not None:
            hit = cache.get(
                kind=q.kind, source=q.source, k=q.k, target=q.target,
                want_distances=q.want_distances,
            )
            if hit is not None:
                self._resolve_hit(q, hit)
                return True
        lm = self._landmarks
        if lm is not None and q.kind == "p2p" and lm.warmed:
            extras = lm.answer_p2p(q.source, q.target)
            if extras is not None:
                self._resolve_landmark(q, extras)
                return True
        return False

    def _resolve_hit(self, q: PendingQuery, hit: dict) -> None:
        extras = dict(hit["extras"]) if hit["extras"] else {}
        extras["cache_hit"] = True
        lat = (time.monotonic() - q.t_submit) * 1e3
        if q.resolve(QueryResult(
            id=q.id, source=q.source, status=STATUS_OK, kind=q.kind,
            distances=hit["distances"] if q.want_distances else None,
            levels=hit["levels"], reached=hit["reached"], extras=extras,
            latency_ms=lat,
            # No batch existed: 0/0 says no lane was paid for.
            batch_lanes=0, dispatched_lanes=0, devices=hit["devices"],
        )):
            self.metrics.record_cache_hit(lat)
            self._audit_answer(q, origin="cache")

    def _resolve_landmark(self, q: PendingQuery, extras: dict) -> None:
        lat = (time.monotonic() - q.t_submit) * 1e3
        if q.resolve(QueryResult(
            id=q.id, source=q.source, status=STATUS_OK, kind=q.kind,
            extras=extras, latency_ms=lat,
            batch_lanes=0, dispatched_lanes=0,
        )):
            self.metrics.record_cache_hit(lat, landmark=True)
            self._audit_answer(q, origin="landmark")

    def _audit_answer(self, q: PendingQuery, *, origin: str) -> None:
        """Sampled shadow audit of a cache- or landmark-resolved answer: a
        confirmed mismatch quarantines the answer tier, not a rung."""
        tier = self._integrity
        if tier is not None:
            tier.observe_answer(q, origin=origin)

    def _account_follower(self, q: PendingQuery) -> None:
        """Metrics of a single-flight follower's resolution, by terminal
        status (followers never enter a batch)."""
        r = q.result(0)
        if r.ok:
            self.metrics.record_follower_completed()
        elif r.status == STATUS_REJECTED:
            self.metrics.record_rejected()
        elif r.status == STATUS_EXPIRED:
            self.metrics.record_expired()
        elif r.status == STATUS_SHUTDOWN:
            self.metrics.record_shutdown()
        else:
            self.metrics.record_errors()

    def _warm_landmarks(self) -> None:
        """Build and warm the landmark distance columns with ONE batch of
        the K highest-degree vertices on a ladder rung. Degrades to
        disarmed on any failure: the tier is an optimization."""
        if "p2p" not in self._kinds:
            self._log(
                "landmark tier requested but p2p is not served by this "
                "config; skipping warm-up"
            )
            return
        from tpu_bfs_torch.workloads.landmarks import LandmarkIndex

        k = min(self._landmark_k, self.lanes)
        try:
            index = LandmarkIndex(self._graph, k, metrics=self.metrics)
            engine = self._acquire_engine(self._route_width(index.k), "bfs")
            ms = index.warm(
                lambda sources: engine.run(
                    np.asarray(sources, dtype=np.int64), time_it=False
                )
            )
            self._landmarks = index
            self._log(
                f"landmark tier warmed: K={index.k} columns in {ms:.0f}ms"
            )
        except Exception as exc:  # noqa: BLE001 — optimization, not liveness
            self._log(
                f"landmark warm-up failed ({type(exc).__name__}: "
                f"{str(exc)[:200]}); serving without the landmark tier"
            )

    def quarantine_answer_tier(self, origin: str, detail: str = "") -> None:
        """A confirmed stale or corrupt cached or landmark answer: the
        suspect is stored state, not a rung. Quarantine the cache
        generation, or drop the landmark columns."""
        if origin == "landmark":
            self._landmarks = None
            self._log("landmark tier DROPPED after a confirmed stale answer"
                      + (f" ({detail[:200]})" if detail else ""))
            rec = _obs.ACTIVE
            if rec is not None:
                rec.event("landmark_quarantine", cat="serve.cache", detail=detail[:300])
                rec.flight_dump("landmark_quarantine")
            return
        if self._cache is not None:
            self._cache.quarantine_generation(detail=detail)

    # --- dynamic graphs -----------------------------------------------------

    @property
    def graph_generation(self) -> int:
        """The served graph generation: bumps on every applied mutation
        batch (0 on a static service, and before the first mutation)."""
        return self._graph_generation

    def apply_edge_updates(self, add=(), remove=()) -> dict:
        """One streaming mutation batch: ``add`` edges ``(u, v)`` or
        ``(u, v, w)``, ``remove`` edges ``(u, v)``. Stages the bounded
        overlay on the host, CRC-checks it across the hand-off, and flips
        the served generation atomically BETWEEN batches (the flip lock
        excludes the scheduler's dispatch section): the registry rekeys
        resident engines, the answer cache invalidates by key, the
        landmark columns recompute and the staleness auditor adopts the
        generation's host truth. When the batch does not fit the overlay a
        COMPACTION runs first (a new persisted base generation, every
        engine rebuilt over the verified artifact) and the batch
        re-applies on the empty overlay; a compaction failure rolls back,
        serving continues on base + overlay and the error propagates with
        nothing mutated. Callable from any thread. Returns ``generation``,
        ``flip_ms``, ``overlay_rows`` and ``compacted``."""
        if self._dynamic is None:
            raise RuntimeError(
                "service is static: construct with dynamic=(rows, kcap) "
                "(or --mutations) to serve edge updates"
            )
        if self._closed:
            raise RuntimeError("service is closed")
        from tpu_bfs_torch.graph.dynamic import OverlayCapacityError

        t0 = time.monotonic()
        with self._flip_lock:
            compacted = False
            try:
                tables, stats = self._dynamic.apply(add=add, remove=remove)
            except OverlayCapacityError as exc:
                self._log(
                    f"overlay at capacity ({str(exc)[:200]}); compacting "
                    f"before applying the batch"
                )
                self._compact_locked()  # raises on failure (rolled back)
                compacted = True
                # Re-apply on the empty overlay over the new base. A second
                # capacity error (one batch larger than the whole overlay)
                # is the caller's and propagates: the compaction stands.
                tables, stats = self._dynamic.apply(add=add, remove=remove)
            self._install_overlay_locked(tables)
            gen = self._graph_generation
            flip_ms = (time.monotonic() - t0) * 1e3
            self._flips += 1
            overlay_rows = stats["overlay_rows"]
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("generation_flip", cat="serve.dynamic",
                      generation=gen, overlay_rows=overlay_rows,
                      compacted=compacted, flip_ms=round(flip_ms, 3))
        return {
            "generation": gen,
            "flip_ms": round(flip_ms, 3),
            "overlay_rows": overlay_rows,
            "compacted": compacted,
        }

    def _install_overlay_locked(self, tables) -> None:  # requires-lock: _flip_lock
        """The flip proper: CRC the staged tables across the host hand-off,
        then advance the generation and rekey every serve tier. Engines
        adopt the new tables at their next acquire
        (:meth:`_sync_engine_overlay`); under the flip lock that is
        indistinguishable from an eager swap."""
        from tpu_bfs_torch.graph.dynamic import overlay_crc32

        dyn = self._dynamic
        gen = dyn.generation
        want_crc = overlay_crc32(tables)
        if _faults.ACTIVE is not None:
            # The fault site "generation_flip": corrupt_overlay flips one
            # table word between the CRC and the install, the host-memory
            # rot window the re-check covers.
            tables, _fired = _faults.maybe_corrupt_overlay(tables, generation=gen)
        if overlay_crc32(tables) != want_crc:
            self._log(
                "staged overlay failed its CRC re-check before install "
                "— restaging from the host truth"
            )
            rec = _obs.ACTIVE
            if rec is not None:
                rec.event("overlay_corrupt", cat="serve.dynamic", generation=gen)
                rec.flight_dump("overlay_corrupt")
            tables = dyn.overlay_tables()
        torn = (_faults.ACTIVE is not None
                and _faults.ACTIVE.take("generation_flip", "torn_flip", generation=gen))
        if torn:
            # torn_flip: the metadata advances (generation, registry keys,
            # cache) but the tables do not, so every answer is one flip
            # stale while claiming the new generation. Only the staleness
            # auditor can catch it.
            self._log(
                "TORN FLIP injected: generation advanced without the "
                "overlay table swap"
            )
        else:
            self._overlay_tables = tables
        self._overlay_epoch += 1
        self._graph_generation = gen
        self._registry.rekey_generation(self._graph_key, gen)
        if self._cache is not None:
            self._cache.set_graph_generation(gen)
        lm = self._landmarks
        if lm is not None:
            # One added edge can tighten d(l, v) everywhere: disable the
            # columns FIRST (no answer over stale bounds), then recompute
            # them over the flipped engine.
            lm.invalidate()
            try:
                self._rewarm_landmarks_locked(lm)
            except Exception as exc:  # noqa: BLE001 — optimization tier
                self._landmarks = None
                self._log(
                    f"landmark re-warm failed after the flip "
                    f"({type(exc).__name__}: {str(exc)[:200]}); tier "
                    f"disabled"
                )
        if self._staleness is not None:
            self._staleness.push_generation(gen, dyn.materialize())
        tier = self._integrity
        if tier is not None and tier._structural is not None:
            # The structural auditor's edge tables follow the live
            # generation: a removed edge left in them would read a correct
            # post-flip answer as a violation. The tier's generation gate
            # sheds audits of superseded batches.
            tier._structural.rebind(dyn.materialize())

    def _rewarm_landmarks_locked(self, index) -> None:
        """Recompute the landmark columns over the flipped graph with one
        batch (the caller holds the flip lock, so the acquired engine is
        synced to the new generation)."""
        engine = self._acquire_engine(self._route_width(index.k), "bfs")
        index.warm(
            lambda sources: engine.run(
                np.asarray(sources, dtype=np.int64), time_it=False
            )
        )

    def _sync_engine_overlay(self, engine) -> None:
        """Bring one engine's overlay tables up to the installed epoch
        (every acquire path comes here, under the flip lock). Engines build
        with an EMPTY armed overlay; a lazily built one (a degrade rung, a
        shadow rung, another kind's first query) would otherwise serve the
        base graph after a flip. The per-engine epoch stamp closes that,
        and re-arms every engine after a restage heals a torn flip."""
        if self._dynamic is None:
            return
        with self._flip_lock:
            epoch = self._overlay_epoch
            if getattr(engine, "_overlay_epoch", 0) == epoch:
                return
            if self._overlay_tables is not None:
                engine.set_overlay(self._overlay_tables)
            engine._overlay_epoch = epoch

    def _restage_overlay(self) -> None:
        """Re-install the CURRENT overlay from the dynamic graph's host
        truth, the heal after a confirmed torn flip: the epoch bump makes
        every engine re-adopt the true tables at its next acquire."""
        with self._flip_lock:
            if self._dynamic is None:
                return
            self._overlay_tables = self._dynamic.overlay_tables()
            self._overlay_epoch += 1

    def _compact_locked(self) -> None:  # requires-lock: _flip_lock
        """Fold the overlay into a new persisted base generation (the
        caller holds the flip lock). On success the registry's graph is the
        VERIFIED loaded artifact and every resident engine drops (their
        ELL tables hold the old base; rebuilds are lazy). On ANY failure
        (the compactor dying at the ``compaction_crash`` site, or the new
        artifact failing its CRC at load) the previous generation stays
        served, orphaned uncommitted artifacts are quarantined, and the
        error propagates to the mutation caller."""
        dyn = self._dynamic
        store = self._gen_store
        t0 = time.monotonic()
        try:
            new_graph = dyn.compact(store)
        except Exception as exc:
            quarantined = store.quarantine_orphans()
            err = f"{type(exc).__name__}: {str(exc)[:300]}"
            self._log(
                f"compaction FAILED ({err}); rolled back — serving "
                f"continues on the previous generation"
                + (f"; quarantined {quarantined}" if quarantined else "")
            )
            rec = _obs.ACTIVE
            if rec is not None:
                rec.event("compaction_failed", cat="serve.dynamic",
                          error=err, quarantined=quarantined)
                rec.flight_dump("compaction_failed")
            raise
        self._registry.add_graph(self._graph_key, new_graph)
        self._graph = new_graph
        dropped = self._registry.drop_graph_engines(self._graph_key)
        self._overlay_tables = None
        self._overlay_epoch += 1
        self._compactions += 1
        ms = (time.monotonic() - t0) * 1e3
        self._log(
            f"compacted into base generation {store.current()} in "
            f"{ms:.0f}ms ({dropped} resident engines dropped; rebuilds "
            f"are lazy)"
        )
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("compaction", cat="serve.dynamic",
                      base_generation=store.current(), dropped=dropped,
                      ms=round(ms, 1))

    def _on_stale_generation(self, *, query_id, kind, source,
                             served_generation, matched_generation,
                             staleness, detail) -> None:
        """A CONFIRMED over-bound stale answer (the staleness auditor's
        oracle replay). The suspect is the stale serving STATE (an old
        generation's tables still installed past a flip), not a rung:
        quarantine the old generation (a flight dump naming its artifact),
        drop the answer cache's trust, and heal by restaging the true
        overlay onto every engine."""
        art = None
        if self._gen_store is not None:
            p = self._gen_store._path(matched_generation)
            art = p if os.path.exists(p) else None
        self._log(
            f"STALE GENERATION on query {query_id!r}: {detail[:300]} — "
            f"quarantining generation {matched_generation}"
            + (f" (artifact {art})" if art else "")
        )
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("stale_generation", cat="serve.dynamic",
                      query=query_id, kind=kind, source=source,
                      served_generation=served_generation,
                      stale_generation=matched_generation,
                      staleness=staleness,
                      artifact=art or f"generation {matched_generation} "
                                      f"(in-memory overlay state)",
                      detail=detail[:300])
            rec.flight_dump("stale_generation")
        if self._cache is not None:
            # Cache entries were admitted under the torn state's keys.
            self._cache.quarantine_generation(
                detail=f"stale generation {matched_generation} served "
                       f"as {served_generation}"
            )
        self._restage_overlay()

    def query(self, source, *, timeout: float | None = None,
              deadline_ms: float | None = None,
              want_distances: bool | None = None, kind: str = "bfs",
              k: int | None = None, target: int | None = None):
        """Blocking submit-and-wait convenience."""
        return self.submit(
            source, deadline_ms=deadline_ms, want_distances=want_distances,
            kind=kind, k=k, target=target,
        ).result(timeout)

    def statsz_extras(self) -> dict:
        """Service-level observations beyond the metrics counters, merged
        into statsz() and the JSONL server's statsz lines."""
        cfg = self._mesh_cfg
        out = {
            "breaker_open": self._breaker.open_keys(),
            "breaker_opens": self._breaker.opens,
            "draining": self._draining,
            # The CURRENT device count (down on a degrade, up on a
            # restore) and, when armed, the resume audit.
            "devices": cfg.devices,
        }
        if self._cfg0.devices > 1:
            out["mesh_degraded"] = cfg.devices < self._cfg0.devices
        if cfg.resume_levels:
            from tpu_bfs_torch.resilience.resume import cache_for_graph

            counts = cache_for_graph(self._graph).counts()
            out["query_resumes"] = counts["resumes"]
            out["resume_snapshots"] = counts["snapshots"]
        if self._integrity is not None:
            out["audit"] = self._integrity.config_summary()
        if self._cache is not None:
            out["cache"] = self._cache.config_summary()
        lm = self._landmarks
        if lm is not None:
            out["landmarks"] = lm.config_summary()
        if self._dynamic is not None:
            # The generation the counters on this line were served under,
            # how full the overlay is, and the staleness audit's verdicts.
            with self._flip_lock:
                dyn = {
                    "generation": self._graph_generation,
                    "overlay_rows": self._dynamic.overlay_rows_used(),
                    "overlay_capacity": list(self._overlay_cap),
                    "flips": self._flips,
                    "compactions": self._compactions,
                }
            if self._staleness is not None:
                dyn["staleness"] = self._staleness.stats()
            out["dynamic"] = dyn
        store = self._registry.aot_store
        if store is not None:
            # The preheat's record: artifact hits against eager fallbacks.
            out["aot"] = store.counts()
        if _faults.ACTIVE is not None:
            # Per-kind injected-fault counts: did every scheduled fault land.
            out["faults"] = _faults.ACTIVE.counts()
        return out

    def export_aot(self, store=None) -> dict:
        """Export every resident (warmed) engine's programs into an artifact
        store (a path, an ArtifactStore, or None for the registry's own):
        the ``--export-aot`` path, this warmed server filling the store a
        successor ``--preheat``s from. Returns ``{"programs": total
        exported, "engines": count}``."""
        out = self._registry.export_resident(store)
        return {"programs": sum(len(v) for v in out.values()), "engines": len(out)}

    def statsz(self) -> dict:
        out = self.metrics.snapshot(
            queue_depth=self._queue.depth(), lanes=self.lanes,
            extra=self.statsz_extras(),
        )
        out["ladder"] = self.width_ladder
        out["kinds"] = list(self._kinds)
        out["pipeline"] = self._pipe_q is not None
        resident = self._registry.resident()
        out["resident_engines"] = None if resident is None else len(resident)
        return out

    def metricz(self) -> str:
        """The one-shot /metricz observation: statsz()'s snapshot through
        ServeMetrics.prometheus_text (without consuming the periodic
        line's interval-QPS window)."""
        return self.metrics.prometheus_text(snapshot=self.statsz())

    # --- scheduler thread -------------------------------------------------

    def _route_width(self, n: int, kind: str = "bfs") -> int:
        """The narrowest ladder rung that fits ``n`` queries (the cap when
        none does), skipping rungs whose circuit breaker is open; when every
        candidate is open, the narrowest fitting rung anyway (the breaker
        must never wedge the service). A p2p query occupies two lanes."""
        need = 2 * n if kind == "p2p" else n
        with self._width_lock:
            fits = [w for w in self._ladder if w >= need] or [self._max_lanes]
        devices = self._mesh_cfg.devices
        for w in fits:
            if self._breaker.allow(breaker_key(w, devices, kind)):
                return w
        return fits[0]

    def _acquire_engine(self, width: int, kind: str = "bfs"):
        """The warmed engine for ``width`` x ``kind`` (clamped to the
        degrade cap), retrying transient build failures and degrading on a
        build-time OOM."""
        attempt = 0
        while True:
            width = min(width, self.lanes)
            try:
                engine = self._registry.get(self._spec(width, kind=kind))
                self._sync_engine_overlay(engine)
                return engine
            except Exception as exc:  # noqa: BLE001 — gated by classifiers
                if is_oom_failure(exc) and self._degrade(width):
                    continue
                devices = self._mesh_cfg.devices
                if devices > 1 and is_mesh_fault(exc):
                    # A mesh death during the build or its warm batch:
                    # degrade the mesh and rebuild on the smaller shape
                    # instead of retrying into the same dead collective.
                    COUNTERS.bump("mesh_faults")
                    self.metrics.record_mesh_fault()
                    rec = _obs.ACTIVE
                    if rec is not None:
                        rec.event("mesh_fault", cat="serve.mesh",
                                  site="engine_build", devices=devices,
                                  error=f"{type(exc).__name__}: "
                                        f"{str(exc)[:120]}")
                        rec.flight_dump("mesh_fault")
                    if self._degrade_mesh(devices, exc):
                        continue
                if is_transient_failure(exc) and attempt < self._max_retries:
                    attempt += 1
                    self.metrics.record_retry()
                    COUNTERS.bump("transient_retries")
                    self._log(
                        f"transient engine-build failure (attempt "
                        f"{attempt}/{self._max_retries}): {str(exc)[:200]}"
                    )
                    time.sleep(min(0.05 * attempt, 2.0))
                    continue
                raise

    def _degrade(self, at_width: int, requeued: int = 0) -> bool:
        """Shrink the ladder after an OOM at ``at_width``; False at the
        floor. The new cap is one halving below (on the width grid); every
        rung above it is evicted first, so the narrower rebuild need not fit
        beside the dying engines' tables."""
        with self._width_lock:
            new = max(
                self._width_floor,
                (at_width // 2) // self._width_quantum * self._width_quantum,
            )
            if new >= at_width:
                # At the floor: still collapse the ladder onto it, so
                # routing stops dispatching into guaranteed OOMs.
                dying = [w for w in self._ladder if w > at_width]
                self._ladder = [w for w in self._ladder if w <= at_width]
                self._max_lanes = at_width
            else:
                dying = [w for w in self._ladder if w > new]
                self._ladder = [w for w in self._ladder if w <= new]
                if new not in self._ladder:
                    self._ladder.append(new)
                self._max_lanes = new
        for w in dying:
            for kind in self._kinds:
                self._registry.evict(self._spec(w, kind=kind))
        if new >= at_width:
            if dying:
                self._log(
                    f"OOM at the {at_width}-lane floor: ladder collapsed "
                    f"to {at_width} (evicted {dying})"
                )
            return False
        self._log(f"OOM degrade: {at_width} -> {new} lanes (cap {new})")
        COUNTERS.bump("oom_degrades")
        self.metrics.record_oom_degrade(requeued)
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("oom_degrade", cat="serve.batch", from_width=at_width,
                      to_width=new, requeued=requeued)
        return True

    def _drop_resume_snapshots(self, queries) -> None:
        """Evict the resume snapshots of queries that will never finish a
        resumable drive (resolved terminally, or re-admitted onto a config
        without resume), so they do not pin the per-graph cache; dropping
        is always safe (a resume degrades to starting over)."""
        if not self._cfg0.resume_levels:
            return
        from tpu_bfs_torch.resilience.resume import cache_for_graph

        cache = cache_for_graph(self._graph)
        for q in queries:
            cache.drop(q.source)

    def _shed_over_budget(self, queries, at_width: int, why: str) -> list:
        """The bounded re-admission budget of the OOM and mesh failover
        paths: count this attempt on every query, resolve the over-budget
        ones with their attempt history, return the rest."""
        live = []
        shed = 0
        for q in queries:
            q.requeues += 1
            q.attempt_widths.append(at_width)
            if q.requeues > self._max_requeues:
                if q.resolve_status(
                    STATUS_ERROR,
                    error=(
                        f"requeue budget exhausted: {q.requeues} {why} "
                        f"re-admissions (attempted widths "
                        f"{q.attempt_widths}) — every remaining rung is "
                        f"failing"
                    ),
                ):
                    shed += 1
            else:
                live.append(q)
        if shed:
            self._drop_resume_snapshots(
                [q for q in queries if q not in live]
            )
            self._log(f"shed {shed} queries at the requeue budget "
                      f"({self._max_requeues})")
            COUNTERS.bump("requeue_sheds", shed)
            self.metrics.record_requeue_shed(shed)
            self.metrics.record_errors(shed)
            rec = _obs.ACTIVE
            if rec is not None:
                rec.event("requeue_shed", cat="serve.batch", shed=shed,
                          width=at_width)
                rec.flight_dump("requeue_shed")
        return live

    def _handle_batch_oom(self, queries, at_width: int, cause) -> None:
        """Degrade below the OOM'd width and re-admit, or resolve with
        errors at the floor; shared by the dispatch half (scheduler thread)
        and the fetch half (extraction worker)."""
        queries = self._shed_over_budget(queries, at_width, "OOM")
        if not queries:
            self._degrade(at_width)
            return
        if self._degrade(at_width, requeued=len(queries)):
            self._queue.requeue(queries)
            if self._queue.stopped:
                # The scheduler may have exited: re-admitted queries must
                # still resolve exactly once.
                n = 0
                for q in self._queue.next_batch(self._queue.cap, 0.0):
                    if q.resolve_status(
                        STATUS_SHUTDOWN, error="service closed"
                    ):
                        n += 1
                if n:
                    self.metrics.record_shutdown(n)
            return
        err = (
            f"out of memory at the minimum lane count "
            f"({at_width}): {str(cause)[:200]}"
        )
        self._log(err)
        self._drop_resume_snapshots(queries)
        n = 0
        for q in queries:
            if q.resolve_status(STATUS_ERROR, error=err):
                n += 1
        if n:
            self.metrics.record_errors(n)

    # --- mesh failover ----------------------------------------------------

    def _rebuild_ladder(self, new_cfg: MeshServeConfig) -> list:  # requires-lock: _width_lock
        """Swap in ``new_cfg`` with its width ladder: the operator's ladder
        at the new device count under the current width cap (an OOM cap
        survives), re-derived geometrically when it does not fit the new
        grid. Returns the specs of the old ladder, for eviction."""
        old_specs = [self._spec(w, self._mesh_cfg) for w in self._ladder]
        top = self._max_lanes
        try:
            ladder = build_width_ladder(top, self._ladder_arg, devices=new_cfg.devices,
                                        engine=new_cfg.engine)
        except ValueError:
            ladder = build_width_ladder(top, "auto", devices=new_cfg.devices,
                                        engine=new_cfg.engine)
        self._mesh_cfg = new_cfg
        self._ladder = ladder
        self._max_lanes = ladder[-1]
        self._width_floor, self._width_quantum = ladder_bounds(
            top, devices=new_cfg.devices, engine=new_cfg.engine)
        return old_specs

    def _degrade_mesh(self, at_devices: int, cause, requeued: int = 0) -> bool:
        """Rebuild the serving ladder one MESH rung down after a mesh fault
        at ``at_devices`` (full, half, ..., one device). True when the
        service now serves from a smaller mesh (or another batch already
        moved it), so re-admission makes sense; False at the one-device
        floor. The rebuild is an eviction and a config swap: the next
        dispatch builds the smaller mesh's engines through the registry,
        while the (width, devices) breaker keys the fault fed keep routing
        off the dead shape."""
        with self._width_lock:
            cfg = self._mesh_cfg
            if cfg.devices != at_devices:
                # Another batch already degraded (or restored) the mesh:
                # nothing to rebuild, the queries re-admit onto the live one.
                return True
            new_devices = next_mesh_rung(at_devices)
            if new_devices is None:
                return False
            new_cfg = cfg.degraded(new_devices)
            old_specs = self._rebuild_ladder(new_cfg)
            ladder = list(self._ladder)
        for spec in old_specs:
            # Free the dead mesh shape's tables before the rebuilds.
            self._registry.evict(spec)
        COUNTERS.bump("mesh_degrades")
        self.metrics.record_mesh_degrade(requeued)
        self._log(
            f"MESH DEGRADE: {at_devices} -> {new_devices} devices "
            f"(engine {new_cfg.engine}, ladder {ladder}) after: "
            f"{str(cause)[:200]}"
        )
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("mesh_degrade", cat="serve.mesh",
                      from_devices=at_devices, to_devices=new_devices,
                      engine=new_cfg.engine, ladder=ladder,
                      requeued=requeued)
        return True

    def _handle_mesh_fault(self, queries, at_width: int, at_devices: int,
                           cause) -> None:
        """Degrade the mesh one rung and re-admit, under the OOM path's
        bounded requeue budget; at the floor (never expected: the executor
        classifies one-device batches as transients) resolve with errors."""
        queries = self._shed_over_budget(queries, at_width, "mesh-fault")
        if self._degrade_mesh(at_devices, cause, requeued=len(queries)):
            if not self._mesh_cfg.resume_levels:
                # Re-admitted onto a config without resume: its engine
                # never drops snapshots, so evict theirs now.
                self._drop_resume_snapshots(queries)
            if queries:
                self._queue.requeue(queries)
                if self._queue.stopped:
                    # The scheduler may have exited: re-admitted queries
                    # must still resolve exactly once.
                    n = 0
                    for q in self._queue.next_batch(self._queue.cap, 0.0):
                        if q.resolve_status(
                            STATUS_SHUTDOWN, error="service closed"
                        ):
                            n += 1
                    if n:
                        self.metrics.record_shutdown(n)
            return
        err = (
            f"mesh fault with no smaller mesh to fail over to "
            f"({at_devices} devices): {str(cause)[:200]}"
        )
        self._log(err)
        self._drop_resume_snapshots(queries)
        n = 0
        for q in queries:
            if q.resolve_status(STATUS_ERROR, error=err):
                n += 1
        if n:
            self.metrics.record_errors(n)

    def mesh_restore(self, devices: int | None = None, *,
                     probe: bool = True) -> bool:
        """Promote a degraded service back onto a wider mesh: the widest
        rung of the original ladder that heartbeats healthy (or exactly
        ``devices``). Its engines rebuild through the registry at the next
        dispatch. False when the service is not degraded or nothing wider
        answers; ``probe=False`` skips the heartbeat its caller just ran
        (the background prober)."""
        from tpu_bfs_torch.resilience.failover import degrade_ladder
        from tpu_bfs_torch.resilience.probe import mesh_heartbeat

        target0 = self._cfg0.devices
        current = self._mesh_cfg.devices
        if current >= target0:
            return False
        rungs = degrade_ladder(target0)
        if devices and int(devices) not in rungs:
            # Only the halving ladder's rungs are restore targets: the
            # ladders and breaker keys are defined rung by rung.
            self._log(
                f"mesh restore: {devices} is not a failover rung of the "
                f"{target0}-device mesh ({rungs}); refusing"
            )
            return False
        candidates = (
            [int(devices)] if devices
            else [d for d in rungs if d > current]
        )
        chosen = None
        for d in candidates:
            if not (current < d <= target0):
                continue
            if probe:
                try:
                    mesh_heartbeat(d)
                except Exception as exc:  # noqa: BLE001 — a dead mesh is expected
                    self._log(
                        f"mesh restore: {d}-device heartbeat failed "
                        f"({type(exc).__name__}: {str(exc)[:120]})"
                    )
                    continue
            chosen = d
            break
        if chosen is None:
            return False
        with self._width_lock:
            if self._mesh_cfg.devices >= chosen:
                return False
            new_cfg = self._cfg0
            while new_cfg.devices > chosen:
                new_cfg = new_cfg.degraded(next_mesh_rung(new_cfg.devices))
            old_specs = self._rebuild_ladder(new_cfg)
            ladder = list(self._ladder)
        for spec in old_specs:
            self._registry.evict(spec)
        self._log(
            f"MESH RESTORE: {current} -> {chosen} devices "
            f"(engine {new_cfg.engine}, ladder {ladder})"
        )
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("mesh_restore", cat="serve.mesh",
                      from_devices=current, to_devices=chosen,
                      engine=new_cfg.engine)
        return True

    def _on_mesh_healthy(self, devices: int) -> None:
        """The background prober's promotion hook (it already ran the
        heartbeat on ``devices``)."""
        self.mesh_restore(devices, probe=False)

    # --- integrity tier ---------------------------------------------------

    def _quarantine_rung(self, width: int, kind: str) -> None:
        """Corruption quarantine: evict the suspect rung (its rebuild clears
        its device state) and force-open its (width, devices, kind) breaker
        so routing stops offering it until the cooldown's probe batch."""
        self._registry.evict(self._spec(width, kind=kind))
        self._breaker.trip(breaker_key(width, self._mesh_cfg.devices, kind))

    def _escalate_mesh(self, devices: int, cause) -> None:
        """Repeated device-attributed corruption on a mesh runs the mesh
        degrade ladder, as a mesh death does (smaller mesh, rebuilt
        engines, probe-gated restore)."""
        if devices > 1:
            self._degrade_mesh(devices, cause)

    def _shadow_spec(self, width: int, kind: str) -> EngineSpec:
        """The DISJOINT engine a shadow replay of a ``width``-lane answer
        runs on, so a corrupted rung cannot reproduce its own wrong answer:
        another ladder rung when one exists, else on a mesh the other
        exchange family (another collective program over the same ranks),
        else a width off the ladder (half, or one quantum more at the
        floor)."""
        others = [w for w in self.width_ladder if w != width]
        if others:
            return self._spec(others[0], kind=kind)
        cfg = self._mesh_cfg
        if cfg.devices > 1:
            alt = {
                "": "allreduce", "ring": "allreduce", "allreduce": "ring",
            }.get(cfg.exchange) if cfg.engine == "dist2d" else {
                "": "sparse", "dense": "sparse", "sparse": "dense",
                "sliced": "dense",
            }.get(cfg.exchange)
            if alt:
                return dataclasses.replace(
                    self._spec(width, kind=kind), exchange=alt,
                    wire_pack=False, delta_bits=(), sieve=False,
                    predict=False,
                )
        floor, quantum = self._width_floor, self._width_quantum
        w2 = max(floor, (width // 2) // quantum * quantum)
        if w2 == width:
            w2 = width + quantum
        return self._spec(w2, kind=kind)

    def _acquire_shadow_engine(self, width: int, kind: str):
        """The shadow auditor's engine: the disjoint rung, warmed and kept
        resident through the registry, and synced to the SERVED overlay
        (else every audited answer of a dynamic service would mismatch)."""
        engine = self._registry.get(self._shadow_spec(width, kind))
        self._sync_engine_overlay(engine)
        return engine

    def flush_audits(self, timeout: float = 60.0) -> bool:
        """Barrier: every enqueued audit processed (callers read the audit
        counters after this). True when flushed, or when disarmed."""
        if self._integrity is None:
            return True
        return self._integrity.flush(timeout)

    def _finish(self, pending, stream=None) -> None:
        """The extraction half, inline or on the worker (on ``stream``).
        Never lets an exception escape with queries unresolved."""
        with self._audit_quiesce:
            self._finishing += 1
        try:
            self._executor.finish_batch(pending, stream)
            self._populate_cache(pending)
            if self._staleness is not None:
                # The staleness arm: a sampled oracle replay against the
                # generation ring, on this worker, sealed internally.
                self._staleness.observe_batch(pending)
            tier = self._integrity
            if tier is not None:
                # Every query of the batch is resolved: audits add no
                # client latency, and observe_batch catches everything.
                # The audit's device work (the structural check's copy,
                # gathers and count) runs on the extraction stream, never
                # between the next batch's level kernels.
                with _stream_ctx(stream):
                    tier.observe_batch(pending)
        except OomRequeue as exc:
            width = pending.lanes
            # Drop the OOM'd engine's references before the narrower
            # rebuild, so the eviction in _degrade frees its tables.
            pending.engine = None
            pending.handle = None
            self._handle_batch_oom(exc.queries, width, exc.cause)
        except MeshFaultRequeue as exc:
            width = pending.lanes
            # The dead mesh shape's engines evict during the degrade.
            pending.engine = None
            pending.handle = None
            self._handle_mesh_fault(exc.queries, width, exc.devices, exc.cause)
        except Exception as exc:  # noqa: BLE001 — resolve, never strand
            err = f"{type(exc).__name__}: {str(exc)[:300]}"
            self._log(f"batch extraction failed: {err}")
            rec = _obs.ACTIVE
            if rec is not None:
                rec.event("executor_error", cat="serve.batch",
                          batch=getattr(pending, "bid", None), error=err,
                          queries=[q.id for q in pending.queries])
                rec.flight_dump("executor_error")
            n = 0
            for q in pending.queries:
                if q.resolve_status(STATUS_ERROR, error=err):
                    n += 1
            if n:
                self.metrics.record_errors(n)
        finally:
            with self._audit_quiesce:
                self._finishing -= 1

    def _populate_cache(self, pending) -> None:
        """After a batch's queries resolved (on the extraction worker),
        store every ok payload. Best-effort: a cache failure never turns a
        served batch into an incident."""
        cache = self._cache
        if cache is None:
            return
        if (self._dynamic is not None
                and pending.generation != self.graph_generation):
            # A flip landed while this batch was in flight: its answers are
            # right for the generation they were pinned to, but caching them
            # now would file generation G-1 payloads under generation G
            # keys. Stragglers do not cache.
            return
        for q in pending.queries:
            try:
                r = q.result(0)
            except TimeoutError:  # a racing path owns this query
                continue
            if not r.ok:
                continue
            try:
                cache.put(
                    kind=r.kind, source=r.source, k=q.k, target=q.target,
                    want_distances=q.want_distances,
                    distances=r.distances, levels=r.levels,
                    reached=r.reached, extras=r.extras,
                    width=r.dispatched_lanes, devices=r.devices,
                )
            except Exception as exc:  # noqa: BLE001 — cache is best-effort
                self._log(
                    f"cache put failed (query {q.id!r}): "
                    f"{type(exc).__name__}: {str(exc)[:200]}"
                )

    def _extract_loop(self) -> None:
        """The extraction worker. On the card it copies results on a CUDA
        stream of its own, so the copies do not queue behind the next
        batch's level kernels on the dispatching stream."""
        streams: dict = {}
        while True:
            pending = self._pipe_q.get()
            if pending is None:
                return
            stream = None
            dev = engine_device(pending.engine) if pending.ready is not None else None
            if dev is not None:
                stream = streams.get(dev)
                if stream is None:
                    stream = streams[dev] = torch.cuda.Stream(dev)
            self._finish(pending, stream)  # resolves its own failures
            pending = None  # noqa: F841 — releases device state while idle

    def _loop(self) -> None:
        while True:
            batch = self._queue.next_batch(self.lanes, self._linger_s)
            if self._queue.stopped:
                n = 0
                for q in batch:
                    if q.resolve_status(STATUS_SHUTDOWN, error="service closed"):
                        n += 1
                if n:
                    self.metrics.record_shutdown(n)
                if not batch:
                    return
                continue
            now = time.monotonic()
            live = []
            expired = 0
            for q in batch:
                if q.expired(now):
                    if q.resolve_status(
                        STATUS_EXPIRED,
                        error="deadline expired before dispatch",
                    ):
                        expired += 1
                else:
                    live.append(q)
            if expired:
                self.metrics.record_expired(expired)
            if not live:
                continue
            try:
                # The batch is kind-uniform (the queue coalesces only
                # same-batch-key queries).
                kind = getattr(live[0], "kind", "bfs")
                width = self._route_width(len(live), kind)
                rec = _obs.ACTIVE
                if rec is not None:
                    rec.event("coalesce", cat="serve.batch", n=len(live),
                              width=width, kind=kind,
                              queries=[q.id for q in live],
                              queue_depth=self._queue.depth())
                # The dispatch section runs under the flip lock: generation
                # flips happen BETWEEN batches, never between an engine's
                # overlay sync and its dispatch, so the stamp below names
                # the tables the batch traversed. Uncontended (and
                # reentrant) on static services.
                with self._flip_lock:
                    engine = self._acquire_engine(width, kind)
                    if len(live) > engine.lanes:
                        # An OOM degraded the cap after this batch was
                        # popped: serve what fits, re-admit the tail.
                        self._queue.requeue(live[engine.lanes:])
                        live = live[: engine.lanes]
                    pending = self._executor.dispatch_batch(engine, live)
                    if pending is not None:
                        pending.generation = self._graph_generation
                        pending.overlay_epoch = self._overlay_epoch
            except OomRequeue as exc:
                # Ladder units (p2p's capacity counts pairs).
                width = getattr(engine, "ladder_lanes", engine.lanes)
                engine = None  # noqa: F841 — releases device tables
                self._handle_batch_oom(exc.queries, width, exc.cause)
                continue
            except MeshFaultRequeue as exc:
                width = getattr(engine, "ladder_lanes", engine.lanes)
                engine = None  # noqa: F841 — releases device tables
                self._handle_mesh_fault(exc.queries, width, exc.devices, exc.cause)
                continue
            except Exception as exc:  # noqa: BLE001 — engine build failed
                engine = None  # noqa: F841 — don't pin a half-built engine
                err = f"{type(exc).__name__}: {str(exc)[:300]}"
                self._log(f"engine unavailable: {err}")
                for q in live:
                    q.resolve_status(STATUS_ERROR, error=err)
                self.metrics.record_errors(len(live))
                continue
            if pending is not None:
                if self._pipe_q is not None:
                    # Bounded handoff: blocks when the worker falls behind.
                    self._pipe_q.put(pending)
                else:
                    self._finish(pending)
            # Do not pin the batch's engine or device state while blocked
            # in the next next_batch() (an OOM degrade must free them).
            engine = pending = None  # noqa: F841 — releases device state


# --- JSONL protocol -------------------------------------------------------


def _encode_distances(d: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, d)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_distances(payload: str) -> np.ndarray:
    """Inverse of the response's ``distances_npy`` field (client helper)."""
    return np.load(io.BytesIO(base64.b64decode(payload)))


def result_to_response(r, *, with_distances: bool = True) -> dict:
    out = {"id": r.id, "source": r.source, "status": r.status}
    if getattr(r, "kind", "bfs") != "bfs":
        out["kind"] = r.kind
    if r.ok:
        out["levels"] = r.levels
        out["reached"] = r.reached
        out["latency_ms"] = round(r.latency_ms, 3)
        out["batch_lanes"] = r.batch_lanes
        out["dispatched_lanes"] = r.dispatched_lanes
        if r.devices is not None and r.devices > 1:
            # A mesh-served response carries its traversal record: the
            # mesh span, the query's edges, GTEPS under the batch time
            # share, and its share of the batch's modeled exchange bytes.
            out["devices"] = r.devices
            if r.edges is not None:
                out["edges"] = r.edges
            if r.gteps is not None:
                # Significant digits: CPU-mesh figures sit near 1e-5.
                out["gteps"] = float(f"{r.gteps:.6g}")
            if r.wire_bytes is not None:
                out["wire_bytes"] = round(r.wire_bytes, 1)
        if getattr(r, "extras", None):
            # Kind-specific fields; protocol keys always win.
            for key, val in r.extras.items():
                out.setdefault(key, val)
        if with_distances and r.distances is not None:
            out["distances_npy"] = _encode_distances(r.distances)
    else:
        out["error"] = r.error
        if r.latency_ms is not None:
            out["latency_ms"] = round(r.latency_ms, 3)
    return out


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_bfs_torch.serve",
        description="Lane-batching BFS query server: JSONL requests "
        '({"id":..,"source":..}) on stdin, one JSON response line each '
        "on stdout; logs and periodic statsz on stderr.",
    )
    ap.add_argument("graph", help="graph file path or generator spec "
                    "(rmat:scale=20,ef=16 | random:n=...,m=...)")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda, "
                    "which must be present; 'cpu' runs the kernels' plain "
                    "PyTorch versions)")
    ap.add_argument("--engine", default="wide",
                    choices=["wide", "hybrid", "packed", "dist2d"],
                    help="serving engine (default wide; hybrid needs "
                    ">= 4096 lanes; dist2d is the 2D-partition mesh engine "
                    "and needs --devices >= 2)")
    ap.add_argument("--lanes", type=int, default=512,
                    help="maximum batch width = max queries per dispatch "
                    "(multiple of 32; default 512)")
    ap.add_argument("--ladder", default="auto",
                    help="dispatch widths: 'auto' (geometric rungs down "
                    "from --lanes, e.g. 32/128/512), 'off' (one width), "
                    "or a list like '32,128,512' (default auto)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="extract results on the scheduler thread instead "
                    "of overlapping extraction with the next dispatch")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="max dispatched-but-unextracted batches in "
                    "flight (default 2)")
    ap.add_argument("--planes", type=int, default=DEFAULT_PLANES,
                    choices=range(1, 9), metavar="P",
                    help=f"bit-plane count (depth cap 2**P; default "
                    f"{DEFAULT_PLANES})")
    ap.add_argument("--pull-gate", action="store_true",
                    help="frontier-aware pull gate (wide/hybrid engines)")
    ap.add_argument("--devices", type=int, default=1,
                    help="serve on a mesh of N ranks (default 1): this "
                    "process is rank 0 and spawns the rest; wide/hybrid run "
                    "the 1D-partition engines, dist2d the 2D edge partition")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="explicit 2D mesh shape for --engine dist2d (e.g. "
                    "2x2; default: the most-square factorization of "
                    "--devices)")
    ap.add_argument("--exchange", default="",
                    help="mesh exchange family (engine default when "
                    "omitted): dense|sparse (wide), dense|sparse|sliced "
                    "(hybrid), ring|allreduce|sparse (dist2d)")
    ap.add_argument("--wire-pack", action="store_true",
                    help="bit-packed exchange wire (mesh engines)")
    ap.add_argument("--sparse-delta", default=None, metavar="BITS",
                    help="delta-encoded sparse-exchange ids, e.g. '8,16'; "
                    "needs --exchange sparse")
    ap.add_argument("--sparse-sieve", action="store_true",
                    help="backward visited sieve on the dist2d sparse row "
                    "exchange (the planner)")
    ap.add_argument("--sparse-predict", action="store_true",
                    help="history-predictive dense selection on the dist2d "
                    "sparse row exchange (the planner)")
    ap.add_argument("--resume-levels", type=int, default=0, metavar="K",
                    help="level-checkpointed query resume (--engine "
                    "dist2d): snapshot each query's state every K levels "
                    "so a mid-query mesh fault resumes from the last "
                    "snapshot on the degraded mesh (recompute <= K); 0 "
                    "disables (default)")
    ap.add_argument("--resume-dir", default=None, metavar="DIR",
                    help="also persist resume snapshots to DIR through the "
                    "CRC checkpoint files (atomic writes, quarantine on "
                    "corruption), so a restarted replica can resume too; "
                    "default: in memory only (or the TPU_BFS_RESUME_DIR "
                    "env var)")
    ap.add_argument("--mesh-probe-interval-s", type=float, default=0.0,
                    metavar="S",
                    help="background mesh health probe: a degraded service "
                    "heartbeats the wider mesh rungs every S seconds and "
                    "promotes back onto the widest that answers; 0 "
                    "disables (default)")
    ap.add_argument("--linger-ms", type=float, default=2.0,
                    help="max wait for batch fill before dispatching a "
                    "partial batch (default 2.0)")
    ap.add_argument("--queue-cap", type=int, default=1024,
                    help="admission queue bound; beyond it queries are "
                    "shed with status=rejected (default 1024)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="default per-query queue-wait deadline; 0 = none "
                    "(per-request \"deadline_ms\" overrides)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="transient-failure re-dispatches per batch "
                    "(default 2)")
    ap.add_argument("--max-requeues", type=int, default=8,
                    help="OOM re-admission budget per query (default 8)")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="dispatch watchdog: a batch's dispatch or fetch "
                    "exceeding this is classified as transient and "
                    "re-dispatched; 0 disables (default 0)")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive deterministic batch failures at one "
                    "width before its circuit breaker opens (default 3)")
    ap.add_argument("--breaker-cooldown-ms", type=float, default=30000.0,
                    help="how long an open breaker waits before admitting "
                    "one half-open probe batch (default 30000)")
    ap.add_argument("--audit-rate", type=float, default=0.0, metavar="R",
                    help="integrity tier: replay this fraction of resolved "
                    "queries on a disjoint rung and bit-compare (a mismatch "
                    "quarantines the serving rung); 0 disables (default)")
    ap.add_argument("--audit-structural", action="store_true",
                    help="integrity tier: check one sampled lane of every "
                    "served batch against the tree properties on the device")
    ap.add_argument("--audit-checksum", action="store_true",
                    help="integrity tier: fold both sides of each audited "
                    "row's host-to-device copy (implies --audit-structural)")
    ap.add_argument("--audit-seed", type=int, default=0,
                    help="seed of the deterministic audit sampler (default 0)")
    ap.add_argument("--cache-bytes", type=int, default=0, metavar="N",
                    help="answer cache: byte-budgeted LRU of resolved "
                    "payloads, CRC32-verified at every hit; 0 disables "
                    "(default)")
    ap.add_argument("--landmarks", type=int, default=0, metavar="K",
                    help="landmark distance tier: K high-degree landmark "
                    "columns from one batch; exact p2p answers without a "
                    "dispatch. 0 disables (default); needs p2p served")
    ap.add_argument("--mutations", default=None, metavar="DxK", nargs="?",
                    const="default",
                    help="dynamic-graph serving: arm streaming edge updates "
                    "over a bounded overlay of D mutated rows x K neighbor "
                    "slots (bare --mutations uses 256x16). Requests "
                    "{\"op\":\"mutate\",\"add\":[[u,v],[u,v,w]...],"
                    "\"remove\":[[u,v]...]} flip the served generation "
                    "atomically between batches; an overflowing batch "
                    "compacts into a new persisted base generation first. "
                    "Needs the wide engine on an undirected graph; p2p "
                    "drops from the served kinds")
    ap.add_argument("--generation-dir", default=None, metavar="DIR",
                    help="persist compacted base generations here through "
                    "the CRC checkpoint files (atomic writes, CURRENT "
                    "pointer committed last, corrupt artifacts quarantined "
                    ".corrupt); default: a temporary directory the service "
                    "owns")
    ap.add_argument("--staleness-bound", type=int, default=0, metavar="N",
                    help="max generation flips a sampled served answer may "
                    "trail before the staleness auditor quarantines the "
                    "stale generation (needs --mutations and --audit-rate "
                    "> 0; default 0: answers must match the generation "
                    "they were stamped with)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm a deterministic fault-injection schedule "
                    "(tpu_bfs_torch/faults.py), e.g. 'seed=7:transient@"
                    "serve_batch:n=2,slow_extract:ms=50:n=4'; default: the "
                    "TPU_BFS_FAULTS env var, else disabled")
    ap.add_argument("--kinds", default=None, metavar="K1,K2,...",
                    help="query kinds to serve: any of bfs,sssp,cc,khop,"
                    "p2p; default: every kind this engine and graph "
                    "support (sssp needs a weighted graph, p2p an "
                    "undirected one)")
    ap.add_argument("--no-distances", action="store_true",
                    help="metadata-only serving by default: responses "
                    "omit distances_npy and the rows never leave the "
                    "device (per-request \"want_distances\" overrides)")
    ap.add_argument("--statsz-interval-s", type=float, default=None,
                    metavar="S",
                    help="seconds between periodic telemetry emissions "
                    "(the stderr statsz line and the --metricz-out text); "
                    "0 disables. Default: TPU_BFS_STATSZ_INTERVAL, else 10")
    ap.add_argument("--statsz-every", type=float, default=None,
                    help="legacy alias of --statsz-interval-s")
    ap.add_argument("--obs", default=None, metavar="SPEC", nargs="?",
                    const="1",
                    help="arm the telemetry recorder (tpu_bfs_torch/obs): "
                    "span tracing through the serve lifecycle and the "
                    "flight recorder; default: TPU_BFS_OBS, else disabled")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                    "serving session here at exit (implies --obs)")
    ap.add_argument("--metricz-out", default=None, metavar="PATH",
                    help="write the Prometheus-style /metricz text here, "
                    "replaced every statsz interval and once at exit")
    ap.add_argument("--xprof-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the serving "
                    "session (CPU activity, and CUDA activity on the card) "
                    "from start-up to shutdown into DIR/serve_trace.json, so "
                    "device profiles line up with the host spans in "
                    "--trace-out")
    ap.add_argument("--registry-cap", type=int, default=4,
                    help="LRU bound on resident warmed engines (default 4, "
                    "raised to fit the ladder plus one degrade slot)")
    ap.add_argument("--preheat", default=None, metavar="DIR",
                    help="AOT artifact store to preheat from (utils/aot): "
                    "every ladder rung whose exported programs are present "
                    "installs them instead of tracing, so the server reaches "
                    "the READY line without a torch.export trace; stale or "
                    "corrupt artifacts fall back to the eager programs per "
                    "program (corrupt files are quarantined). With --devices N "
                    "every rank adopts its own programs")
    ap.add_argument("--export-aot", default=None, metavar="DIR",
                    help="after warm-up, export every resident engine's "
                    "programs into DIR so a successor started with --preheat "
                    "DIR skips the trace (the warm handoff pair: "
                    "python -m tpu_bfs_torch.tools.warm_handoff drives both ends)")
    return ap


def _int_field(req: dict, name: str):
    """Strict integer request field (None when absent): ints and integral
    floats only; bool and 7.9 are refused."""
    val = req.get(name)
    if val is None:
        return None
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise TypeError(f"{name} must be an integer, got {val!r}")
    if isinstance(val, float):
        if not val.is_integer():
            raise TypeError(f"{name} must be an integer, got {val!r}")
        val = int(val)
    return val


def _parse_request_line(line: str):
    """Parse one JSONL request into (id, source, deadline_ms, want, kind,
    k, target). Raises on anything malformed; the caller answers with a
    structured error line. ``kind`` is only type-checked here; the kind
    checks live in ``BfsService.submit``."""
    req = json.loads(line)
    if not isinstance(req, dict):
        raise TypeError("request must be a JSON object")
    qid = req.get("id")
    try:
        if "source" not in req:
            raise KeyError("source")
        source = _int_field(req, "source")
        if source is None:  # JSON null
            raise TypeError(
                f"source must be an integer vertex id, got "
                f"{req['source']!r}"
            )
        kind = req.get("kind")
        if kind is not None and not isinstance(kind, str):
            raise TypeError(f"kind must be a string, got {kind!r}")
        k = _int_field(req, "k")
        target = _int_field(req, "target")
        ddl = req.get("deadline_ms")
        if ddl is not None:
            if isinstance(ddl, bool) or not isinstance(ddl, (int, float)):
                raise TypeError(
                    f"deadline_ms must be a JSON number, got {ddl!r}"
                )
            ddl = float(ddl)
        want = req.get("want_distances")
        if want is not None and not isinstance(want, bool):
            raise TypeError(
                f"want_distances must be a JSON boolean, got {want!r}"
            )
    except Exception as exc:
        exc._request_id = qid  # the error line must still correlate
        raise
    return qid, source, ddl, want, kind, k, target


DEFAULT_STATSZ_INTERVAL_S = 10.0


def resolve_statsz_interval(args, *, env=None) -> float:
    """``--statsz-interval-s`` wins, then the legacy ``--statsz-every``,
    then ``TPU_BFS_STATSZ_INTERVAL``, then 10 s; an unparsable environment
    value falls back to the default."""
    interval = getattr(args, "statsz_interval_s", None)
    if interval is None:
        interval = getattr(args, "statsz_every", None)
    if interval is None:
        env_iv = (env if env is not None
                  else os.environ.get("TPU_BFS_STATSZ_INTERVAL", "")).strip()
        try:
            interval = float(env_iv) if env_iv else DEFAULT_STATSZ_INTERVAL_S
        except ValueError:
            interval = DEFAULT_STATSZ_INTERVAL_S
    return float(interval)


def _dynamic_from_args(args):
    """``--mutations``: () when absent, True when bare, else (D, K)."""
    dyn_raw = getattr(args, "mutations", None)
    if not dyn_raw:
        return ()
    if dyn_raw == "default":
        return True
    try:
        d, k = (int(x) for x in str(dyn_raw).lower().split("x"))
    except ValueError:
        raise SystemExit(
            f"--mutations must look like DxK (e.g. 256x16), got {dyn_raw!r}"
        ) from None
    return (d, k)


def _mesh_from_args(args) -> tuple[tuple, tuple]:
    """``(mesh_shape, delta_bits)`` from ``--mesh RxC`` and
    ``--sparse-delta 8,16``."""
    mesh_shape = ()
    if getattr(args, "mesh", None):
        try:
            r, c = (int(x) for x in str(args.mesh).lower().split("x"))
            mesh_shape = (r, c)
        except ValueError:
            raise SystemExit(
                f"--mesh must look like RxC (e.g. 2x4), got {args.mesh!r}"
            ) from None
    delta_bits = ()
    delta_raw = getattr(args, "sparse_delta", None)
    if delta_raw:
        try:
            delta_bits = tuple(int(b) for b in str(delta_raw).replace(",", " ").split())
        except ValueError:
            raise SystemExit(
                f"--sparse-delta must be comma-separated bit widths "
                f"(e.g. 8,16), got {delta_raw!r}"
            ) from None
    return mesh_shape, delta_bits


def _service_from_args(args, registry, log) -> BfsService:
    mesh_shape, delta_bits = _mesh_from_args(args)
    resume_dir = getattr(args, "resume_dir", None)
    if resume_dir:
        from tpu_bfs_torch.resilience.resume import set_default_dir

        set_default_dir(resume_dir)
    dynamic = _dynamic_from_args(args)
    return BfsService(
        args.graph,
        engine=args.engine,
        lanes=args.lanes,
        planes=args.planes,
        pull_gate=args.pull_gate,
        devices=args.devices,
        exchange=args.exchange or "",
        wire_pack=args.wire_pack,
        delta_bits=delta_bits,
        sieve=args.sparse_sieve,
        predict=args.sparse_predict,
        mesh_shape=mesh_shape,
        resume_levels=args.resume_levels,
        mesh_probe_interval_s=args.mesh_probe_interval_s,
        width_ladder=args.ladder,
        pipeline=not args.no_pipeline,
        pipeline_depth=args.pipeline_depth,
        linger_ms=args.linger_ms,
        queue_cap=args.queue_cap,
        deadline_ms=args.deadline_ms,
        max_retries=args.max_retries,
        max_requeues=args.max_requeues,
        watchdog_ms=args.watchdog_ms,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_ms=args.breaker_cooldown_ms,
        audit_rate=args.audit_rate,
        audit_structural=args.audit_structural,
        audit_checksum=args.audit_checksum,
        audit_seed=args.audit_seed,
        cache_bytes=args.cache_bytes,
        landmarks=args.landmarks,
        dynamic=dynamic,
        generation_dir=args.generation_dir,
        staleness_bound=args.staleness_bound,
        distances=not args.no_distances,
        kinds=(
            tuple(str(args.kinds).replace(",", " ").split())
            if args.kinds else None
        ),
        registry=registry,
        registry_capacity=args.registry_cap,
        aot_dir=args.preheat,
        device=args.device,
        log=log,
    )


def run_server(args, stdin=None, stdout=None, stderr=None,
               registry=None) -> int:
    """The JSONL loop, parameterized over streams (and optionally a shared
    registry) so tests run it in process. Reads requests until EOF, then
    drains outstanding responses, prints a final statsz line and closes
    the service.

    Requests are read on a reader thread; the main thread waits for the
    reader's EOF drain or a SIGTERM/SIGINT. A signal drains GRACEFULLY:
    admission stops (late submits shed REJECTED), in-flight batches flush,
    still-queued queries resolve SHUTDOWN, every resolution is emitted and
    the final statsz line lands. Handlers are installed only on the main
    thread and restored on exit."""
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr

    def log(msg: str) -> None:
        print(f"# {msg}", file=stderr, flush=True)

    sched = _faults.arm_from_spec_or_env(args.faults)
    if sched is not None:
        log(f"fault-injection schedule ARMED: {sched.to_spec()}")
    # Armed BEFORE the service, so registry build/warm spans land in the
    # trace.
    recorder = _obs.arm_for_run(args.obs, args.trace_out)
    if recorder is not None:
        log(f"telemetry recorder ARMED (capacity "
            f"{recorder.capacity}, flight window "
            f"{recorder.window_s:.0f}s, dump dir {recorder.dump_dir!r})")
    statsz_interval = resolve_statsz_interval(args)
    xprof = None
    if args.xprof_dir:
        from tpu_bfs_torch.utils.profile import ProfileSession

        xprof = ProfileSession(os.path.join(args.xprof_dir, "serve_trace.json"), args.device)
        xprof.start()
        log(f"torch.profiler trace started -> {args.xprof_dir}")
    try:
        service = _service_from_args(args, registry, log)
    except BaseException:
        if xprof is not None:
            xprof.stop(check=False)
        raise
    export_aot = getattr(args, "export_aot", None)
    if export_aot:
        # Fill the store from this warmed server (every rung is resident
        # now) so a successor started with --preheat skips the trace.
        try:
            counts = service.export_aot(export_aot)
            log(f"aot export -> {export_aot}: {counts['programs']} "
                f"programs from {counts['engines']} engines")
        except Exception as exc:  # noqa: BLE001 — export is an optimization
            log(f"aot export failed ({exc!r}); continuing without")
    # The readiness line: every rung is warmed (from artifacts when
    # preheating); tools/warm_handoff.py keys the old server's SIGTERM on it.
    store = service._registry.aot_store
    ready_extra = ""
    if store is not None:
        c = store.counts()
        ready_extra = f" aot_hits={c['aot_hits']} aot_fallbacks={c['aot_fallbacks']}"
    log(f"READY engine={args.engine} lanes={args.lanes} "
        f"ladder={service.width_ladder} "
        f"kinds={','.join(service.kinds)}{ready_extra}")
    out_lock = threading.Lock()
    outstanding = [0]
    drained = threading.Condition(out_lock)

    def emit(resp: dict) -> None:
        # A dead client pipe must never propagate into the resolver threads.
        try:
            with out_lock:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()
        except (OSError, ValueError) as exc:
            log(f"response emit failed ({exc!r}); dropping line")

    def on_done(q: PendingQuery) -> None:
        emit(result_to_response(q.result()))
        with drained:
            outstanding[0] -= 1
            if outstanding[0] == 0:
                drained.notify_all()

    stop = threading.Event()  # reader EOF-drain complete
    got_signal = [None]

    def on_signal(signum, frame) -> None:
        # Only plain stores here (the interrupted frame may hold the stop
        # Event's lock); the main loop polls got_signal.
        got_signal[0] = signum
        service.drain()

    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, on_signal)
            except (ValueError, OSError):
                pass

    metricz_out = args.metricz_out

    def emit_telemetry() -> None:
        """One snapshot, two renderings: the stderr statsz line and the
        --metricz-out text."""
        snap = service.metrics.snapshot(
            mark_interval=True, queue_depth=service._queue.depth(),
            lanes=service.lanes, extra=service.statsz_extras(),
        )
        print(service.metrics.statsz_line(snapshot=snap), file=stderr,
              flush=True)
        if not metricz_out:
            return
        from tpu_bfs_torch.obs.exporters import write_metricz

        try:
            write_metricz(service.metrics.prometheus_text(snapshot=snap),
                          metricz_out)
        except OSError as exc:
            log(f"metricz write failed ({exc!r})")

    stop_statsz = threading.Event()
    if statsz_interval > 0:
        def statsz_loop() -> None:
            while not stop_statsz.wait(statsz_interval):
                emit_telemetry()

        threading.Thread(
            target=statsz_loop, name="bfs-serve-statsz", daemon=True
        ).start()

    log(f"serving {args.graph!r}: engine={args.engine} lanes={args.lanes} "
        f"ladder={service.width_ladder} "
        f"pipeline={not args.no_pipeline} linger={args.linger_ms}ms "
        f"queue_cap={args.queue_cap}")

    def mutate_line(line: str) -> bool:
        """The {"op": "mutate"} request, handled ON the reader thread:
        mutations serialize with each other for free, and
        apply_edge_updates flips between dispatched batches through the
        flip lock. False when the line is not a mutate op (it falls through
        to the query path). Every failure answers a structured line."""
        try:
            req = json.loads(line)
        except Exception:  # noqa: BLE001 — the query path answers it
            return False
        if not (isinstance(req, dict) and req.get("op") == "mutate"):
            return False
        qid = req.get("id")
        try:
            add = req.get("add") or ()
            remove = req.get("remove") or ()
            if not isinstance(add, (list, tuple)) or not isinstance(remove, (list, tuple)):
                raise TypeError("add/remove must be arrays of [u, v] / [u, v, w]")
            out = service.apply_edge_updates(
                add=[tuple(int(x) for x in e) for e in add],
                remove=[tuple(int(x) for x in e) for e in remove],
            )
            emit({"id": qid, "op": "mutate", "ok": True, **out})
        except Exception as exc:  # noqa: BLE001 — answered, never fatal
            emit({
                "id": qid, "op": "mutate", "ok": False,
                "error": f"{type(exc).__name__}: {str(exc)[:300]}",
            })
        return True

    def reader() -> None:
        try:
            for line in stdin:
                line = line.strip()
                if not line:
                    continue
                if '"op"' in line and mutate_line(line):
                    continue
                qid = None
                try:
                    try:
                        (qid, source, ddl, want,
                         kind, k, target) = _parse_request_line(line)
                    except Exception as exc:  # noqa: BLE001 — answered, never fatal
                        emit({
                            "id": getattr(exc, "_request_id", None),
                            "status": STATUS_ERROR,
                            "error": f"bad request: {exc!r}",
                        })
                        continue
                    with drained:
                        outstanding[0] += 1
                    try:
                        service.submit(
                            source, id=qid, deadline_ms=ddl,
                            want_distances=want,
                            kind="bfs" if kind is None else kind,
                            k=k, target=target,
                        ).add_done_callback(on_done)
                    except Exception:
                        # No response will fire for this query: unwind the
                        # count or the EOF drain waits forever.
                        with drained:
                            outstanding[0] -= 1
                            if outstanding[0] == 0:
                                drained.notify_all()
                        raise
                except Exception as exc:  # noqa: BLE001 — keep reading
                    log(f"request line dropped ({exc!r})")
            with drained:
                while outstanding[0] > 0 and not stop.is_set():
                    drained.wait(0.2)
        finally:
            stop.set()
            with drained:
                drained.notify_all()

    reader_t = threading.Thread(
        target=reader, name="bfs-serve-reader", daemon=True
    )
    xprof_error = None
    try:
        reader_t.start()
        while not stop.wait(0.2):
            if got_signal[0] is not None:
                break
        if got_signal[0] is not None:
            name = signal.Signals(got_signal[0]).name
            log(f"{name} received: draining — admission stopped, flushing "
                f"in-flight batches, resolving queued queries as shutdown")
            rec = _obs.ACTIVE
            if rec is not None:
                rec.event("signal_drain", cat="serve.lifecycle", signal=name)
                rec.flight_dump(f"{name.lower()}_drain")
    finally:
        # close() flushes in-flight batches and resolves queued queries as
        # SHUTDOWN; wait for their lines with a hard bound.
        service.close()
        deadline = time.monotonic() + 30.0
        with drained:
            while outstanding[0] > 0 and time.monotonic() < deadline:
                drained.wait(0.2)
            if outstanding[0] > 0:
                log(f"drain timeout: {outstanding[0]} responses unemitted")
        stop_statsz.set()
        emit_telemetry()  # the final statsz line + --metricz-out text
        if xprof is not None:
            try:
                log(f"torch.profiler trace stopped -> {xprof.stop()}")
            except (RuntimeError, OSError) as exc:  # raised once the shutdown is done
                log(f"torch.profiler stop failed ({exc!r})")
                xprof_error = exc
        if args.trace_out and recorder is not None:
            from tpu_bfs_torch.obs.exporters import write_perfetto

            # A level track for each resident engine that recorded a
            # per-level trace (armed runs only).
            level_traces = []
            for spec, eng in service._registry.resident_engines():
                trace = getattr(eng, "last_run_trace", None)
                if trace:
                    # A mesh rung's track names its span, so single-device
                    # and mesh rungs of one width stay apart.
                    label = f"{spec.engine}/w{spec.lanes}"
                    if spec.devices > 1:
                        label += f"/d{spec.devices}"
                    level_traces.append((label, trace))
            try:
                write_perfetto(
                    recorder.snapshot(), args.trace_out, t0=recorder.t0,
                    level_traces=level_traces,
                    meta={"tool": "tpu_bfs_torch.serve", "graph": args.graph},
                )
                log(f"trace written -> {args.trace_out}")
            except OSError as exc:
                log(f"trace write failed ({exc!r})")
        for sig, handler in old_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
    if xprof_error is not None:
        # A failed profile fails the run (after a full shutdown): on the
        # card it means the trace lacks the device.
        raise xprof_error
    return 0


def main(argv=None) -> int:
    return run_server(build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
