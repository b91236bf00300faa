"""The serving front end: the in-process ``BfsService`` and the
stdin/stdout JSONL server, the port of ``tpu_bfs/serve/frontend.py`` on
one device.

``BfsService`` is the API tests and benchmarks drive; the JSONL loop
(``python -m tpu_bfs_torch.serve``) is the same service behind a line
protocol:

    request   {"id": 7, "source": 12345}
              (+ "deadline_ms", + "want_distances": false,
               + "kind": "sssp"|"cc"|"khop"|"p2p", + "k", + "target")
    response  {"id": 7, "source": 12345, "status": "ok", "levels": 6,
               "reached": 104857, "latency_ms": ..., "batch_lanes": 31,
               "dispatched_lanes": 32, "distances_npy": "<base64 .npy>"}

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

Not ported yet, each raising ``NotImplementedError`` at construction with
its ROADMAP item: the mesh (``devices > 1``, ``mesh_shape``,
``exchange``, ``wire_pack``, ``delta_bits``, ``sieve``, ``predict``,
``resume_levels``, ``mesh_probe_interval_s``), the integrity tier
(``audit_*``), dynamic graphs (``dynamic``, ``generation_dir``,
``staleness_bound``) and AOT preheat (``aot_dir``).
"""

from __future__ import annotations

import argparse
import base64
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
from tpu_bfs_torch.serve.answercache import AnswerCache
from tpu_bfs_torch.serve.executor import (
    BatchExecutor,
    CircuitBreaker,
    OomRequeue,
    breaker_key,
    engine_device,
)
from tpu_bfs_torch.serve.metrics import ServeMetrics
from tpu_bfs_torch.serve.registry import (
    DEFAULT_PLANES,
    HYBRID_LANE_QUANTUM,
    MESH_SERVE_ITEM,
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

INTEGRITY_ITEM = "ROADMAP Queue 1 item 4 (integrity/, the audit tier)"
DYNAMIC_ITEM = "ROADMAP Queue 1 item 4 (graph/dynamic.py, dynamic graphs)"
AOT_ITEM = "ROADMAP Queue 1 item 5 (utils/aot.py preheat)"


def ladder_bounds(lanes: int, *, engine: str = "wide") -> tuple[int, int]:
    """``(floor, quantum)`` of the serving widths on one device: the hybrid
    engine serves whole 4096-lane steps, the others 32-lane ones from 32."""
    if engine == "hybrid":
        return HYBRID_LANE_QUANTUM, HYBRID_LANE_QUANTUM
    return MIN_LANES, MIN_LANES


def build_width_ladder(lanes: int, ladder="auto", *, engine: str = "wide") -> list:
    """The service's resident widths, ascending, topped by ``lanes``.

    ``"auto"`` walks down from ``lanes`` by :data:`LADDER_FACTOR` to the
    engine's floor (:func:`ladder_bounds`); ``"off"``/None serves one fixed
    width; an explicit sequence (or a comma-separated string) gives the
    rungs directly, each a multiple of the width quantum in [floor,
    lanes]."""
    floor, quantum = ladder_bounds(lanes, engine=engine)
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


def _refuse_unported(*, devices, exchange, wire_pack, delta_bits, sieve,
                     predict, mesh_shape, resume_levels,
                     mesh_probe_interval_s, audit_rate, audit_structural,
                     audit_checksum, audit_seed, dynamic, generation_dir,
                     staleness_bound, aot_dir) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of the first
    constructor argument whose feature is not ported yet."""
    mesh = {"devices": devices > 1, "exchange": exchange,
            "wire_pack": wire_pack, "delta_bits": tuple(delta_bits),
            "sieve": sieve, "predict": predict,
            "mesh_shape": tuple(mesh_shape), "resume_levels": resume_levels,
            "mesh_probe_interval_s": mesh_probe_interval_s}
    audit = {"audit_rate": audit_rate, "audit_structural": audit_structural,
             "audit_checksum": audit_checksum, "audit_seed": audit_seed}
    dyn = {"dynamic": dynamic, "generation_dir": generation_dir,
           "staleness_bound": staleness_bound}
    for group, item in ((mesh, MESH_SERVE_ITEM), (audit, INTEGRITY_ITEM),
                        (dyn, DYNAMIC_ITEM), ({"aot_dir": aot_dir}, AOT_ITEM)):
        for name, val in group.items():
            if val:
                raise NotImplementedError(
                    f"BfsService({name}=...) waits for {item}"
                )


class BfsService:
    """Long-lived lane-batching BFS query service over one graph on one
    device.

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
    collapses identical in-flight queries. ``device`` is the torch device
    of the service's own registry (None: CUDA, raising without a card).
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
        _refuse_unported(
            devices=devices, exchange=exchange, wire_pack=wire_pack,
            delta_bits=delta_bits, sieve=sieve, predict=predict,
            mesh_shape=mesh_shape, resume_levels=resume_levels,
            mesh_probe_interval_s=mesh_probe_interval_s,
            audit_rate=audit_rate, audit_structural=audit_structural,
            audit_checksum=audit_checksum, audit_seed=audit_seed,
            dynamic=dynamic, generation_dir=generation_dir,
            staleness_bound=staleness_bound, aot_dir=aot_dir,
        )
        if engine == "dist2d":
            raise NotImplementedError(
                f"BfsService(engine='dist2d') waits for {MESH_SERVE_ITEM}"
            )
        self._log = log or (lambda msg: None)
        self._engine = engine
        # Widths and the degrade cap share one lock: the scheduler routes
        # while the extraction worker may shrink the ladder after an OOM.
        self._width_lock = threading.Lock()
        self._ladder = build_width_ladder(  # guarded-by: _width_lock
            lanes, width_ladder, engine=engine
        )
        self._max_lanes = self._ladder[-1]  # guarded-by: _width_lock
        self._width_floor, self._width_quantum = ladder_bounds(
            lanes, engine=engine
        )
        # An internally created registry holds the whole ladder (plus one
        # degrade slot); a caller-supplied registry keeps its own policy.
        self._registry = registry or EngineRegistry(
            capacity=max(registry_capacity, len(self._ladder) + 1),
            log=self._log, device=device,
        )
        if isinstance(graph, str):
            self._graph_key = graph
        else:
            self._graph_key = f"graph@{id(graph):x}"
            self._registry.add_graph(self._graph_key, graph)
        self._graph = self._registry.graph(self._graph_key)
        self._planes = planes
        self._pull_gate = pull_gate
        auto_kinds = supported_kinds(engine, 1, self._graph)
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
                    why = kind_unsupported_reason(kind, engine, 1, self._graph)
                    raise ValueError(
                        f"kind {kind!r} is not servable by this config: "
                        f"{why} (servable: {auto_kinds})"
                    )
            self._kinds = kinds
        if not self._kinds:
            raise ValueError("service must serve at least one kind")
        if registry is None and len(self._kinds) > 1:
            # One resident engine per additional kind next to the ladder.
            self._registry.capacity = max(
                self._registry.capacity,
                len(self._ladder) + len(self._kinds),
            )
        for w in self._ladder:
            self._spec(w).validate()  # fail at construction, not first dispatch
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

    def _spec(self, width: int | None = None, kind: str = "bfs") -> EngineSpec:
        return EngineSpec(
            graph_key=self._graph_key,
            kind=kind,
            engine=self._engine,
            lanes=self.lanes if width is None else width,
            planes=self._planes,
            pull_gate=self._pull_gate,
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
            for w in sorted(self.width_ladder, reverse=True):
                if w <= self.lanes:  # rungs above a degraded cap died
                    self._acquire_engine(w, self._primary_kind)
            if self._landmark_k > 0:
                self._warm_landmarks()
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
        self._queue.stop()
        if thread is not None:
            thread.join()
            if extract_thread is not None:
                self._pipe_q.put(None)  # after scheduler exit: no more puts
                extract_thread.join()
        else:
            # Never started: drain staged queries here instead.
            for q in self._queue.next_batch(self._queue.cap, 0.0):
                if q.resolve_status(STATUS_SHUTDOWN, error="service closed"):
                    self.metrics.record_shutdown()

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
            why = kind_unsupported_reason(kind, self._engine, 1, self._graph)
            return (
                f"kind {kind!r} is not served by this service: "
                + (why if why is not None else
                   f"excluded by this service's kinds= selection "
                   f"(engine={self._engine!r}, devices=1)")
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

    def _resolve_landmark(self, q: PendingQuery, extras: dict) -> None:
        lat = (time.monotonic() - q.t_submit) * 1e3
        if q.resolve(QueryResult(
            id=q.id, source=q.source, status=STATUS_OK, kind=q.kind,
            extras=extras, latency_ms=lat,
            batch_lanes=0, dispatched_lanes=0,
        )):
            self.metrics.record_cache_hit(lat, landmark=True)

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
        out = {
            "breaker_open": self._breaker.open_keys(),
            "breaker_opens": self._breaker.opens,
            "draining": self._draining,
            "devices": 1,
        }
        if self._cache is not None:
            out["cache"] = self._cache.config_summary()
        lm = self._landmarks
        if lm is not None:
            out["landmarks"] = lm.config_summary()
        if _faults.ACTIVE is not None:
            # Per-kind injected-fault counts: did every scheduled fault land.
            out["faults"] = _faults.ACTIVE.counts()
        return out

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
        for w in fits:
            if self._breaker.allow(breaker_key(w, 1, kind)):
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
                return self._registry.get(self._spec(width, kind=kind))
            except Exception as exc:  # noqa: BLE001 — gated by classifiers
                if is_oom_failure(exc) and self._degrade(width):
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

    def _shed_over_budget(self, queries, at_width: int) -> list:
        """Count this OOM re-admission on every query; resolve the
        over-budget ones with their attempt history; return the rest."""
        live = []
        shed = 0
        for q in queries:
            q.requeues += 1
            q.attempt_widths.append(at_width)
            if q.requeues > self._max_requeues:
                if q.resolve_status(
                    STATUS_ERROR,
                    error=(
                        f"requeue budget exhausted: {q.requeues} OOM "
                        f"re-admissions (attempted widths "
                        f"{q.attempt_widths}) — every remaining rung is "
                        f"failing"
                    ),
                ):
                    shed += 1
            else:
                live.append(q)
        if shed:
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
        queries = self._shed_over_budget(queries, at_width)
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
        n = 0
        for q in queries:
            if q.resolve_status(STATUS_ERROR, error=err):
                n += 1
        if n:
            self.metrics.record_errors(n)

    def _finish(self, pending, stream=None) -> None:
        """The extraction half, inline or on the worker (on ``stream``).
        Never lets an exception escape with queries unresolved."""
        try:
            self._executor.finish_batch(pending, stream)
            self._populate_cache(pending)
        except OomRequeue as exc:
            width = pending.lanes
            # Drop the OOM'd engine's references before the narrower
            # rebuild, so the eviction in _degrade frees its tables.
            pending.engine = None
            pending.handle = None
            self._handle_batch_oom(exc.queries, width, exc.cause)
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

    def _populate_cache(self, pending) -> None:
        """After a batch's queries resolved (on the extraction worker),
        store every ok payload. Best-effort: a cache failure never turns a
        served batch into an incident."""
        cache = self._cache
        if cache is None:
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
                engine = self._acquire_engine(width, kind)
                if len(live) > engine.lanes:
                    # An OOM degraded the cap after this batch was popped:
                    # serve what fits, re-admit the tail at the front.
                    self._queue.requeue(live[engine.lanes:])
                    live = live[: engine.lanes]
                pending = self._executor.dispatch_batch(engine, live)
            except OomRequeue as exc:
                # Ladder units (p2p's capacity counts pairs).
                width = getattr(engine, "ladder_lanes", engine.lanes)
                engine = None  # noqa: F841 — releases device tables
                self._handle_batch_oom(exc.queries, width, exc.cause)
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
                    ">= 4096 lanes; dist2d waits for the mesh serve slice)")
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
    # Refused at construction, naming their ROADMAP item: the mesh, the
    # integrity tier, dynamic graphs and AOT preheat.
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the engines over N devices (refused: the "
                    "mesh serve slice)")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="2D mesh shape (refused: the mesh serve slice)")
    ap.add_argument("--exchange", default="",
                    help="mesh exchange family (refused: the mesh serve "
                    "slice)")
    ap.add_argument("--wire-pack", action="store_true",
                    help="bit-packed exchange wire (refused: the mesh "
                    "serve slice)")
    ap.add_argument("--sparse-delta", default=None, metavar="BITS",
                    help="delta-encoded sparse ids (refused: the mesh "
                    "serve slice)")
    ap.add_argument("--sparse-sieve", action="store_true",
                    help="sparse-exchange sieve (refused: the mesh serve "
                    "slice)")
    ap.add_argument("--sparse-predict", action="store_true",
                    help="sparse-exchange prediction (refused: the mesh "
                    "serve slice)")
    ap.add_argument("--resume-levels", type=int, default=0, metavar="K",
                    help="level-checkpointed query resume (refused: the "
                    "mesh serve slice)")
    ap.add_argument("--mesh-probe-interval-s", type=float, default=0.0,
                    metavar="S",
                    help="mesh health probe cadence (refused: the mesh "
                    "serve slice)")
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
                    help="shadow audits (refused: the integrity tier)")
    ap.add_argument("--audit-structural", action="store_true",
                    help="structural audits (refused: the integrity tier)")
    ap.add_argument("--audit-checksum", action="store_true",
                    help="wire checksums (refused: the integrity tier)")
    ap.add_argument("--audit-seed", type=int, default=0,
                    help="audit sampler seed (refused: the integrity tier)")
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
                    help="dynamic-graph serving (refused: dynamic graphs)")
    ap.add_argument("--generation-dir", default=None, metavar="DIR",
                    help="compacted generations (refused: dynamic graphs)")
    ap.add_argument("--staleness-bound", type=int, default=0, metavar="N",
                    help="staleness audit bound (refused: dynamic graphs)")
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
    ap.add_argument("--registry-cap", type=int, default=4,
                    help="LRU bound on resident warmed engines (default 4, "
                    "raised to fit the ladder plus one degrade slot)")
    ap.add_argument("--preheat", default=None, metavar="DIR",
                    help="AOT artifact store (refused: AOT preheat)")
    ap.add_argument("--export-aot", default=None, metavar="DIR",
                    help="export AOT artifacts (refused: AOT preheat)")
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
    """``--statsz-interval-s`` wins, then ``TPU_BFS_STATSZ_INTERVAL``, then
    10 s; an unparsable environment value falls back to the default."""
    interval = args.statsz_interval_s
    if interval is None:
        env_iv = (env if env is not None
                  else os.environ.get("TPU_BFS_STATSZ_INTERVAL", "")).strip()
        try:
            interval = float(env_iv) if env_iv else DEFAULT_STATSZ_INTERVAL_S
        except ValueError:
            interval = DEFAULT_STATSZ_INTERVAL_S
    return float(interval)


def _service_from_args(args, registry, log) -> BfsService:
    if getattr(args, "export_aot", None):
        raise NotImplementedError(f"--export-aot waits for {AOT_ITEM}")
    return BfsService(
        args.graph,
        engine=args.engine,
        lanes=args.lanes,
        planes=args.planes,
        pull_gate=args.pull_gate,
        devices=args.devices,
        exchange=args.exchange or "",
        wire_pack=args.wire_pack,
        delta_bits=(args.sparse_delta,) if args.sparse_delta else (),
        sieve=args.sparse_sieve,
        predict=args.sparse_predict,
        mesh_shape=(args.mesh,) if args.mesh else (),
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
        dynamic=args.mutations or (),
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
    service = _service_from_args(args, registry, log)
    log(f"READY engine={args.engine} lanes={args.lanes} "
        f"ladder={service.width_ladder} "
        f"kinds={','.join(service.kinds)}")
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
        """A {"op": "mutate"} request answers a structured refusal (dynamic
        graphs are not ported); False when the line is not one."""
        try:
            req = json.loads(line)
        except Exception:  # noqa: BLE001 — the query path answers it
            return False
        if not (isinstance(req, dict) and req.get("op") == "mutate"):
            return False
        emit({"id": req.get("id"), "op": "mutate", "ok": False,
              "error": f"NotImplementedError: edge updates wait for "
                       f"{DYNAMIC_ITEM}"})
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
        if args.trace_out and recorder is not None:
            from tpu_bfs_torch.obs.exporters import write_perfetto

            try:
                write_perfetto(
                    recorder.snapshot(), args.trace_out, t0=recorder.t0,
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
    return 0


def main(argv=None) -> int:
    return run_server(build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
