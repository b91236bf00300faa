"""Batch execution with failure classification, retry and OOM degrade, the
port of ``tpu_bfs/serve/executor.py``.

The serving dispatch path reuses the one transient/deterministic
classifier the port shares (``utils/recovery.py``): transient errors
re-dispatch the SAME batch with capped backoff, an OOM hands the queries
back to the service for re-admission at a narrower lane count (the degrade
ladder), and everything else resolves the batch's queries with explicit
error results and feeds the circuit breaker.

The execution is split into PIPELINE HALVES: ``dispatch_batch`` runs the
engine's ``dispatch`` and returns a :class:`PendingBatch`;
``finish_batch`` runs ``fetch`` and the extraction and resolves every
query. The same classifier runs on both halves.

Where the port differs from JAX: JAX's ``dispatch`` returns as soon as the
level loop is enqueued, and the wait for the device sits in ``fetch``. The
port's packed engines run the level loop from the host with one device read
a level, so ``dispatch`` returns only after the traversal; ``fetch``
assembles the result (the lane summaries) and the extraction copies each
query's distances to the host. On a CUDA engine, dispatch records an event
on its stream after the loop (``PendingBatch.ready``), and
``finish_batch`` runs on the stream the caller names (the service's
extraction worker has its own), waiting on that event first. The dispatch
tables the worker reads are marked with ``record_stream`` for its stream,
so the caching allocator never hands their memory to the next batch while
the worker's copies are still queued.

The dispatch WATCHDOG (``watchdog_s > 0``) therefore guards both halves:
each runs on a helper thread, and one that outlives the deadline is
classified as transient (a ``DEADLINE_EXCEEDED`` error the retry ladder
takes) instead of hanging the executor. It cannot interrupt anything: the
abandoned call (a host level loop, a kernel, a blocking copy) runs on to
its end and its result is dropped. A retry of a wedged dispatch waits on
the engine's dispatch lock behind it, trips in turn, and past the retry
budget resolves the batch with errors, which feeds the breaker. Past
``max_abandoned`` abandoned calls, new watched calls are refused outright.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch import obs as _obs
from tpu_bfs_torch.serve.scheduler import (
    STATUS_ERROR,
    STATUS_EXPIRED,
    STATUS_OK,
    QueryResult,
)
from tpu_bfs_torch.utils.recovery import (
    COUNTERS,
    is_oom_failure,
    is_transient_failure,
)
from tpu_bfs_torch.workloads import batch_params


def pad_batch(sources: np.ndarray, lanes: int) -> tuple[np.ndarray, int]:
    """Pad a partial batch to exactly ``lanes`` sources, so every dispatch
    of one ladder width has one shape. Pad lanes repeat the first real
    source (a valid vertex) and are never read on extract."""
    n = len(sources)
    if n > lanes:
        raise ValueError(f"batch of {n} exceeds {lanes} lanes")
    if n == lanes:
        return np.asarray(sources, dtype=np.int64), n
    out = np.empty(lanes, dtype=np.int64)
    out[:n] = sources
    out[n:] = sources[0]
    return out, n


def engine_devices(engine) -> int:
    """The device count an engine's batches span (1 on one device), half of
    the breaker key; one definition with the fault sites' ``devices``."""
    return _faults.mesh_devices(engine)


def engine_device(engine) -> torch.device | None:
    """The torch device an engine (or a workload adapter's base) runs on."""
    dev = getattr(engine, "device", None)
    if dev is None:
        dev = getattr(getattr(engine, "base", None), "device", None)
    return None if dev is None else torch.device(dev)


def breaker_key(width: int, devices: int, kind: str = "bfs") -> tuple:
    """The breaker/degrade key: ``(width, devices)``, extended with the
    query kind when it is not bfs (a broken sssp rung must not blackhole
    the same width's bfs engine)."""
    base = (int(width), int(devices))
    return base if kind == "bfs" else base + (kind,)


class CircuitBreaker:
    """Per-key (width x devices [x kind]) circuit breaker over
    DETERMINISTIC batch failures.

    The breaker OPENS after ``threshold`` consecutive deterministic
    failures at a key: the service's router then skips that rung. After
    ``cooldown_s`` it HALF-OPENS: one probe batch is admitted; success
    closes the breaker, failure re-opens it for another cooldown. OOMs and
    transient failures never count. Open transitions bump
    ``RecoveryCounters.breaker_opens``."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 now=time.monotonic, log=None):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._now = now
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        # key -> [state, consecutive_fails, opened_at]
        self._state: dict = {}  # guarded-by: _lock
        self.opens = 0  # guarded-by: _lock

    def allow(self, key) -> bool:
        """May a batch be routed to ``key`` now? Open keys refuse until the
        cooldown elapses, then admit one probe (again each cooldown, so a
        probe lost outside the executor cannot block the rung forever)."""
        with self._lock:
            st = self._state.get(key)
            if st is None or st[0] == self.CLOSED:
                return True
            if self._now() - st[2] >= self.cooldown_s:
                st[0] = self.HALF_OPEN
                st[2] = self._now()
                self._log(f"circuit breaker half-open for width {key}: "
                          f"admitting one probe batch")
                return True
            return False  # open, or half-open with the probe in flight

    def record_success(self, key) -> None:
        with self._lock:
            st = self._state.pop(key, None)
            if st is not None and st[0] != self.CLOSED:
                self._log(f"circuit breaker closed for width {key} "
                          f"(probe batch succeeded)")

    def record_failure(self, key) -> bool:
        """Count one deterministic failure; True when the breaker OPENED
        (first crossing of the threshold, or a failed half-open probe)."""
        with self._lock:
            st = self._state.setdefault(key, [self.CLOSED, 0, 0.0])
            st[1] += 1
            opened = (
                st[0] == self.HALF_OPEN
                or (st[0] == self.CLOSED and st[1] >= self.threshold)
            )
            if opened:
                st[0] = self.OPEN
                st[2] = self._now()
                self.opens += 1
        if opened:
            COUNTERS.bump("breaker_opens")
            self._log(
                f"circuit breaker OPEN for width {key} after {st[1]} "
                f"consecutive deterministic failures (cooldown "
                f"{self.cooldown_s:.1f}s)"
            )
        return opened

    def open_keys(self) -> list:
        """Keys currently open or half-open (for statsz)."""
        with self._lock:
            return sorted(
                k for k, st in self._state.items() if st[0] != self.CLOSED
            )


_BATCH_SEQ = itertools.count(1)


class OomRequeue(Exception):
    """The batch ran out of memory; its queries ride up UNRESOLVED for the
    service to degrade the lane count and re-admit them."""

    def __init__(self, queries, cause: BaseException):
        super().__init__(str(cause))
        self.queries = queries
        self.cause = cause


class PendingBatch:
    """One dispatched, unresolved batch crossing the pipeline handoff: the
    engine, the queries (resolved exactly once), the padded sources (a
    transient failure re-dispatches the identical batch), the dispatch
    handle, its ``ready`` event on a CUDA engine, and the retry count
    shared by both halves."""

    __slots__ = ("engine", "queries", "n", "padded", "handle", "ready",
                 "attempt", "lanes", "bid", "devices", "kind", "params")

    def __init__(self, engine, queries, n: int, padded: np.ndarray,
                 kind: str = "bfs", params: dict | None = None):
        self.engine = engine
        self.queries = list(queries)
        self.n = n
        self.padded = padded
        # The batch's kind and its batch-uniform dispatch kwargs (khop's k,
        # p2p's padded targets), replayed by a transient re-dispatch.
        self.kind = kind
        self.params = params or {}
        self.handle = None
        self.ready = None
        self.attempt = 0
        # In LADDER units: the p2p adapter's capacity counts pairs and it
        # publishes ``ladder_lanes``, the service's width grid.
        self.lanes = getattr(engine, "ladder_lanes", engine.lanes)
        self.devices = engine_devices(engine)
        # The span-correlation id of every obs event of this batch.
        self.bid = next(_BATCH_SEQ)


class _Ready:
    """Handle of engines with only the blocking ``run`` protocol (test
    doubles): the whole run happens at dispatch."""

    __slots__ = ("res",)

    def __init__(self, res):
        self.res = res


def _stream_ctx(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _handle_tensors(handle, depth: int = 3):
    """The tensors a dispatch handle holds (its fields and tuples of them,
    nested as the adapters nest them: k-hop's ``(pending, k)``): what the
    extraction stream reads."""
    if isinstance(handle, torch.Tensor):
        yield handle
    elif depth <= 0 or handle is None:
        return
    elif isinstance(handle, (tuple, list)):
        for x in handle:
            yield from _handle_tensors(x, depth - 1)
    elif dataclasses.is_dataclass(handle) and not isinstance(handle, type):
        for f in dataclasses.fields(handle):
            yield from _handle_tensors(getattr(handle, f.name), depth - 1)
    elif hasattr(handle, "__dict__") or hasattr(handle, "__slots__"):
        names = list(getattr(handle, "__dict__", {})) + list(getattr(handle, "__slots__", ()))
        for name in names:
            yield from _handle_tensors(getattr(handle, name, None), depth - 1)


class BatchExecutor:
    """Runs coalesced batches through an engine's dispatch/fetch halves."""

    def __init__(self, metrics, *, max_retries: int = 2,
                 backoff_s: float = 0.05, backoff_cap_s: float = 2.0,
                 log=None, sleep=time.sleep, watchdog_s: float = 0.0,
                 breaker: CircuitBreaker | None = None):
        self.metrics = metrics
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self._log = log or (lambda msg: None)
        self._sleep = sleep
        self.watchdog_s = watchdog_s
        self.breaker = breaker
        self.max_abandoned = 8
        self._abandoned = 0  # guarded-by: _abandon_lock
        self._abandon_lock = threading.Lock()

    # --- pipeline halves --------------------------------------------------

    def dispatch_batch(self, engine, queries) -> PendingBatch | None:
        """Pad and dispatch ``queries`` (<= engine.lanes of them) as one
        batch. Returns the pending handoff (resolve via
        :meth:`finish_batch`), or None when the batch already resolved with
        deterministic errors. Raises :class:`OomRequeue` on an OOM."""
        # Deadline re-check at dispatch: a query can come back here long
        # after batch forming (an OOM requeue, a breaker reroute).
        now = time.monotonic()
        live = []
        expired = 0
        for q in queries:
            if q.expired(now):
                if q.resolve_status(
                    STATUS_EXPIRED,
                    error="deadline expired before dispatch "
                          "(after requeue/reroute)",
                ):
                    expired += 1
            else:
                live.append(q)
        if expired:
            self.metrics.record_expired(expired)
        if not live:
            return None
        queries = live
        sources = np.asarray([q.source for q in queries], dtype=np.int64)
        padded, n = pad_batch(sources, engine.lanes)
        # The scheduler coalesces only same-batch-key queries, so the first
        # query's kind and parameters speak for the batch; p2p's targets
        # pad like the sources.
        kind = getattr(queries[0], "kind", "bfs")
        params = batch_params(queries)
        if "targets" in params:
            params["targets"], _ = pad_batch(params["targets"], engine.lanes)
        pending = PendingBatch(engine, queries, n, padded, kind, params)
        rec = _obs.ACTIVE
        if rec is not None:
            for q in pending.queries:
                if hasattr(q, "obs_batch"):
                    q.obs_batch = pending.bid
            rec.begin("batch", f"b{pending.bid}",  # span-outlives: finish_batch/_extract/_classify_failure close it
                      cat="serve.batch",
                      batch=pending.bid, n=n, width=pending.lanes,
                      queries=[q.id for q in pending.queries])
            rec.begin("dispatch", f"b{pending.bid}", cat="serve.batch",
                      batch=pending.bid, width=pending.lanes)
        while True:
            try:
                if _faults.ACTIVE is not None:
                    _faults.ACTIVE.hit("serve_batch", lanes=pending.lanes,
                                       n=pending.n)
                pending.handle, pending.ready = self._watched(
                    lambda: self._dispatch(engine, padded, pending.params),
                    pending, "dispatch")
                if rec is not None:
                    rec.end("dispatch", f"b{pending.bid}", cat="serve.batch",
                            batch=pending.bid, attempt=pending.attempt)
                return pending
            except Exception as exc:  # noqa: BLE001 — gated by the classifier
                try:
                    retry = self._classify_failure(pending, exc)
                except OomRequeue:
                    if rec is not None:
                        rec.end("dispatch", f"b{pending.bid}",
                                cat="serve.batch", batch=pending.bid, oom=True)
                    raise
                if not retry:
                    if rec is not None:
                        rec.end("dispatch", f"b{pending.bid}",
                                cat="serve.batch", batch=pending.bid,
                                failed=True)
                        rec.end("batch", f"b{pending.bid}", cat="serve.batch",
                                batch=pending.bid, failed=True)
                    return None

    def finish_batch(self, pending: PendingBatch, stream=None) -> None:
        """Fetch a dispatched batch and resolve every query exactly once,
        on ``stream`` (a ``torch.cuda.Stream``, or None for the caller's
        current stream), after the batch's ready event. A transient fetch
        failure re-dispatches the same padded batch; an OOM raises
        :class:`OomRequeue` as the dispatch half does."""
        with _stream_ctx(stream):
            self._finish_on_stream(pending, stream)

    def _finish_on_stream(self, pending: PendingBatch, stream) -> None:
        engine = pending.engine
        rec = _obs.ACTIVE
        if rec is not None:
            rec.begin("fetch", f"b{pending.bid}", cat="serve.batch",
                      batch=pending.bid, n=pending.n)
        while True:
            try:
                if pending.handle is None:  # re-dispatch after a retry
                    pending.handle, pending.ready = self._watched(
                        lambda: self._dispatch(engine, pending.padded,
                                               pending.params),
                        pending, "dispatch", stream)
                self._order_after_dispatch(pending, stream)
                handle = pending.handle
                res = self._watched(lambda: self._fetch(engine, handle),
                                    pending, "fetch", stream)
                break
            except Exception as exc:  # noqa: BLE001 — gated by the classifier
                pending.handle = None
                try:
                    retry = self._classify_failure(pending, exc)
                except OomRequeue:
                    if rec is not None:
                        rec.end("fetch", f"b{pending.bid}", cat="serve.batch",
                                batch=pending.bid, oom=True)
                    raise
                if not retry:
                    if rec is not None:
                        rec.end("fetch", f"b{pending.bid}", cat="serve.batch",
                                batch=pending.bid, failed=True)
                        rec.end("batch", f"b{pending.bid}", cat="serve.batch",
                                batch=pending.bid, failed=True)
                    return
        if rec is not None:
            rec.end("fetch", f"b{pending.bid}", cat="serve.batch",
                    batch=pending.bid, attempt=pending.attempt)
        # The result now owns what extraction needs; drop the handle.
        pending.handle = None
        self._resolve_ok(pending, res)

    def run_batch(self, engine, queries) -> None:
        """The unpipelined path: dispatch immediately finished."""
        pending = self.dispatch_batch(engine, queries)
        if pending is not None:
            self.finish_batch(pending)

    # --- internals --------------------------------------------------------

    @staticmethod
    def _dispatch(engine, padded, params=None):
        """(handle, ready event or None). The event is recorded on the
        stream the dispatch ran on, in the thread that ran it."""
        dispatch = getattr(engine, "dispatch", None)
        if dispatch is not None:
            handle = dispatch(padded, **params) if params else dispatch(padded)
        elif params:
            handle = _Ready(engine.run(padded, time_it=False, **params))
        else:
            handle = _Ready(engine.run(padded, time_it=False))
        ready = None
        dev = engine_device(engine)
        if dev is not None and dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        return handle, ready

    @staticmethod
    def _order_after_dispatch(pending: PendingBatch, stream) -> None:
        """Order ``stream`` after the dispatch and mark the handle's tensors
        as used on it (no-op off the card or on the dispatching stream)."""
        if stream is None or pending.ready is None:
            return
        stream.wait_event(pending.ready)
        for t in _handle_tensors(pending.handle):
            if t.device.type == "cuda":
                t.record_stream(stream)

    @staticmethod
    def _fetch(engine, handle):
        if isinstance(handle, _Ready):
            return handle.res
        return engine.fetch(handle)

    def _watched(self, fn, pending: PendingBatch, half: str, stream=None):
        """``fn()``, under the watchdog when armed: on a helper thread (on
        ``stream``), classified as a transient DEADLINE_EXCEEDED failure
        when it outlives ``watchdog_s``. The abandoned call runs on; its
        result is dropped."""
        if self.watchdog_s <= 0:
            return fn()
        with self._abandon_lock:
            abandoned = self._abandoned
        if abandoned >= self.max_abandoned:
            # Deterministic (no transient marker): the batch resolves with
            # errors and feeds the breaker.
            raise RuntimeError(
                f"dispatch watchdog: {abandoned} abandoned calls still "
                f"running (cap {self.max_abandoned}); refusing to watch "
                f"another {half} on this engine"
            )
        box: list = []
        done = threading.Event()
        state = {"abandoned": False}

        def work():
            try:
                with _stream_ctx(stream):
                    box.append(("ok", fn()))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                box.append(("err", exc))
            finally:
                with self._abandon_lock:
                    if state["abandoned"]:
                        self._abandoned -= 1
                    done.set()

        threading.Thread(target=work, name=f"bfs-serve-{half}",
                         daemon=True).start()
        if not done.wait(self.watchdog_s):
            tripped = False
            with self._abandon_lock:
                if not done.is_set():
                    state["abandoned"] = True
                    self._abandoned += 1
                    tripped = True
            if tripped:
                COUNTERS.bump("watchdog_trips")
                self.metrics.record_watchdog_trip()
                rec = _obs.ACTIVE
                if rec is not None:
                    rec.event("watchdog_trip", cat="serve.batch",
                              batch=pending.bid, n=pending.n, half=half,
                              watchdog_s=self.watchdog_s,
                              queries=[q.id for q in pending.queries])
                    rec.flight_dump("watchdog_trip")
                raise RuntimeError(
                    f"DEADLINE_EXCEEDED: dispatch watchdog: a "
                    f"{pending.n}-query batch's {half} is still running "
                    f"after {self.watchdog_s:.1f}s — classifying as transient"
                )
        kind, val = box[0]
        if kind == "err":
            raise val
        return val

    def _classify_failure(self, pending: PendingBatch, exc) -> bool:
        """The one classifier both halves share. True = retry the batch;
        False = resolved as deterministic errors; OOM raises OomRequeue."""
        rec = _obs.ACTIVE
        if is_oom_failure(exc):
            if rec is not None:
                rec.event("batch_oom", cat="serve.batch", batch=pending.bid,
                          width=pending.lanes,
                          queries=[q.id for q in pending.queries])
                rec.end("batch", f"b{pending.bid}", cat="serve.batch",
                        batch=pending.bid, oom=True)
            raise OomRequeue(list(pending.queries), exc) from exc
        if is_transient_failure(exc) and pending.attempt < self.max_retries:
            pending.attempt += 1
            wait = min(self.backoff_s * pending.attempt, self.backoff_cap_s)
            self.metrics.record_retry()
            COUNTERS.bump("transient_retries")
            if rec is not None:
                rec.event("retry", cat="serve.batch", batch=pending.bid,
                          attempt=pending.attempt,
                          error=f"{type(exc).__name__}: {str(exc)[:120]}")
            self._log(
                f"transient failure serving a {pending.n}-query batch "
                f"(attempt {pending.attempt}/{self.max_retries}): "
                f"{type(exc).__name__}: {str(exc)[:200]} — "
                f"retrying in {wait:.2f}s"
            )
            self._sleep(wait)
            return True
        err = f"{type(exc).__name__}: {str(exc)[:300]}"
        self._log(f"batch failed deterministically: {err}")
        if rec is not None:
            rec.event("batch_error", cat="serve.batch", batch=pending.bid,
                      width=pending.lanes, error=err,
                      queries=[q.id for q in pending.queries])
        if self.breaker is not None:
            opened = self.breaker.record_failure(
                breaker_key(pending.lanes, pending.devices, pending.kind)
            )
            if opened and rec is not None:
                rec.event("breaker_open", cat="serve.batch",
                          width=pending.lanes, batch=pending.bid)
                rec.flight_dump("breaker_open")
        for q in pending.queries:
            q.resolve_status(STATUS_ERROR, error=err)
        self.metrics.record_errors(pending.n)
        return False

    def _resolve_ok(self, pending: PendingBatch, res) -> None:
        if self.breaker is not None:
            self.breaker.record_success(
                breaker_key(pending.lanes, pending.devices, pending.kind)
            )
        rec = _obs.ACTIVE
        if rec is not None:
            rec.begin("extract", f"b{pending.bid}",  # span-outlives: _extract ends it; the except arm below covers the failure path
                      cat="serve.batch",
                      batch=pending.bid, n=pending.n)
        try:
            self._extract(pending, res, rec)
        except Exception:
            if rec is not None:
                rec.end("extract", f"b{pending.bid}", cat="serve.batch",
                        batch=pending.bid, failed=True)
                rec.end("batch", f"b{pending.bid}", cat="serve.batch",
                        batch=pending.bid, failed=True)
            raise

    def _extract(self, pending: PendingBatch, res, rec) -> None:
        from tpu_bfs_torch.graph.csr import INF_DIST

        queries, n = pending.queries, pending.n
        width = pending.lanes
        # The on-device eccentricity is worth its reduction only when some
        # query skips the distance copy.
        ecc = (
            getattr(res, "ecc", None)
            if any(not getattr(q, "want_distances", True) for q in queries)
            else None
        )
        extras_fn = getattr(res, "extras", None)
        t_x0 = time.monotonic()
        latencies = []
        for i, q in enumerate(queries):
            want = getattr(q, "want_distances", True)
            d = None
            if want or ecc is None:
                # The one per-lane device-to-host distance copy; a
                # metadata-only query skips it when ecc is on hand.
                d = res.distances_int32(i)
            if ecc is not None:
                levels = int(ecc[i])
            else:
                finite = d[d != INF_DIST]
                levels = int(finite.max()) if finite.size else 0
            extras_i = extras_fn(i) if extras_fn is not None else None
            reached_i = int(res.reached[i])
            if _faults.ACTIVE is not None:
                d, extras_i, reached_i, _fired = _faults.maybe_corrupt_result(
                    d, extras_i, reached_i, lanes=width, batch=pending.bid,
                )
            latency_ms = (time.monotonic() - q.t_submit) * 1e3
            q.resolve(QueryResult(
                id=q.id,
                source=q.source,
                status=STATUS_OK,
                kind=pending.kind,
                extras=extras_i,
                distances=d if want else None,
                levels=levels,
                reached=reached_i,
                latency_ms=latency_ms,
                batch_lanes=n,
                dispatched_lanes=width,
                devices=pending.devices,
            ))
            latencies.append(latency_ms)
        extract_ms = (time.monotonic() - t_x0) * 1e3
        if rec is not None:
            rec.end("extract", f"b{pending.bid}", cat="serve.batch",
                    batch=pending.bid, extract_ms=round(extract_ms, 3))
            rec.end("batch", f"b{pending.bid}", cat="serve.batch",
                    batch=pending.bid, n=n, width=width)
        self.metrics.record_batch(n, width, latencies, extract_ms=extract_ms)
