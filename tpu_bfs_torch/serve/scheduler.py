"""Admission queue + lane-batch coalescing for the BFS query server, the
port of ``tpu_bfs/serve/scheduler.py`` (host-only, copied).

Single-source queries arrive one at a time; the packed engines answer up
to ``lanes`` of them in one device dispatch. The scheduler's whole job is
bridging that impedance:

- a BOUNDED queue (``queue_cap``): at overload, new queries are shed with
  an explicit REJECTED result instead of growing an unbounded backlog —
  a server that queues forever converts overload into timeout storms;
- COALESCING: each dispatch drains up to ``max_n`` pending queries into
  one batch, lingering up to ``linger_s`` for stragglers when the batch
  is not yet full (latency <-> fill trade, the --linger-ms knob);
- DEADLINES: a query whose deadline passes while queued resolves with
  DEADLINE_EXCEEDED at batch-forming time, and ``expired()`` is checked
  AGAIN at dispatch (serve/executor.dispatch_batch) — a query that
  survived an OOM requeue, a breaker reroute, or a mesh-degrade
  re-admission must not burn device time after its client stopped
  waiting. Deadlines bound time BEFORE dispatch, not device execution —
  once dispatched, a batch runs to completion and late results are
  still delivered (killing a running batch would punish its 8000
  batch-mates for one impatient client).

Every admitted query is resolved exactly once — completion, expiry,
rejection, error, or shutdown — never silently dropped (the acceptance
bar: "never hangs, never silent drops").
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque

import numpy as np

from tpu_bfs_torch import obs as _obs

STATUS_OK = "ok"
STATUS_REJECTED = "rejected"  # shed at admission (queue full / closed)
STATUS_EXPIRED = "deadline_exceeded"
STATUS_ERROR = "error"
STATUS_SHUTDOWN = "shutdown"  # still queued when the service closed


@dataclasses.dataclass
class QueryResult:
    """One query's terminal outcome (exactly one per admitted query)."""

    id: object
    source: int
    status: str
    kind: str = "bfs"  # query kind: bfs|sssp|cc|khop|p2p
    distances: np.ndarray | None = None  # [V] int32, INF_DIST unreached
    levels: int | None = None  # this source's eccentricity (max finite dist)
    reached: int | None = None
    # Kind-specific response fields: e.g. p2p's target/
    # distance/path, cc's component/size/count, khop's k. Merged into
    # the JSONL response verbatim.
    extras: dict | None = None
    latency_ms: float | None = None  # submit -> resolve (extraction included)
    batch_lanes: int | None = None  # real queries in the serving batch
    dispatched_lanes: int | None = None  # width the batch was routed to
    devices: int | None = None  # mesh span of the serving engine
    edges: int | None = None  # input edges this query's traversal covered
    device_ms: float | None = None  # its batch's dispatch -> fetch time
    wire_bytes: float | None = None  # modeled exchange bytes, per-query share
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    @property
    def gteps(self) -> float | None:
        """Per-query GTEPS under the batch time share (the batch's device
        time divides evenly over its real queries, so the mean of a
        batch's per-query figures is its aggregate rate). None when the
        engine gives no edge counts or the batch was not timed."""
        if not self.edges or not self.device_ms or not self.batch_lanes:
            return None
        share_s = self.device_ms / 1e3 / self.batch_lanes
        return self.edges / share_s / 1e9


_QUERY_SEQ = itertools.count(1)


class PendingQuery:
    """A submitted query: a one-shot future the scheduler resolves.

    ``resolve`` is idempotent (first writer wins) so racy paths — e.g. a
    shutdown drain against an in-flight batch completing — can both try
    without double-delivery. Callbacks added after resolution fire
    immediately on the caller's thread.

    ``want_distances=False`` marks a metadata-only query (levels/reached
    only): with the engines' on-device summaries, such a query never
    pulls its distance row off the device at all.

    ``requeues``/``attempt_widths`` record every OOM-driven re-admission
    (the service's degrade ladder): the requeue budget reads the count,
    and a query shed at the budget carries its attempt history in the
    error so the failure names every width that was tried."""

    __slots__ = ("id", "source", "kind", "k", "target", "deadline",
                 "t_submit", "want_distances",
                 "requeues", "attempt_widths", "obs_batch",
                 "_event", "_lock", "_result", "_callbacks")

    def __init__(self, source: int, *, id=None, deadline: float | None = None,
                 now: float | None = None, want_distances: bool = True,
                 kind: str = "bfs", k: int | None = None,
                 target: int | None = None):
        self.id = next(_QUERY_SEQ) if id is None else id
        self.source = int(source)
        # Query kind + its per-kind parameters: khop's hop
        # bound k, p2p's target endpoint. Immutable after admission —
        # the batch key below coalesces only compatible queries.
        self.kind = kind
        self.k = k if k is None else int(k)
        self.target = target if target is None else int(target)
        self.deadline = deadline  # absolute time.monotonic() value, or None
        self.t_submit = time.monotonic() if now is None else now
        self.want_distances = bool(want_distances)
        self.requeues = 0  # OOM-driven re-admissions so far
        self.attempt_widths: list = []  # width each failed attempt ran at
        self.obs_batch = None  # serving batch id (telemetry; armed only)
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: QueryResult | None = None  # guarded-by: _lock
        self._callbacks: list = []  # guarded-by: _lock
        rec = _obs.ACTIVE
        if rec is not None:
            # The query's span opens at ADMISSION; resolve() closes it
            # with the terminal status, batch id, and attempt history —
            # one span chain per query id across whichever threads serve
            # it (tpu_bfs_torch/obs).
            rec.begin("query", f"q{self.id}",  # span-outlives: resolve() closes it with the terminal status
                      cat="serve.query",
                      query=self.id, source=self.source, kind=self.kind,
                      want_distances=self.want_distances)

    @property
    def batch_key(self):
        """Coalescing compatibility class: only queries whose
        one device dispatch can answer them together share a batch —
        same kind, and for khop the same hop bound (one ``max_levels``
        per dispatch)."""
        if self.kind == "khop":
            return ("khop", self.k)
        return (self.kind,)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def resolve(self, result: QueryResult) -> bool:
        """Deliver the terminal result; False if already resolved."""
        with self._lock:
            if self._result is not None:
                return False
            self._result = result
            callbacks, self._callbacks = self._callbacks, []
        rec = _obs.ACTIVE
        if rec is not None:
            rec.end("query", f"q{self.id}", cat="serve.query",
                    query=self.id, status=result.status,
                    latency_ms=result.latency_ms, batch=self.obs_batch,
                    dispatched_lanes=result.dispatched_lanes,
                    requeues=self.requeues,
                    attempt_widths=list(self.attempt_widths))
        self._event.set()
        for cb in callbacks:
            cb(self)
        return True

    def resolve_status(self, status: str, *, error: str | None = None) -> bool:
        return self.resolve(QueryResult(
            id=self.id, source=self.source, status=status, error=error,
            kind=self.kind,
            latency_ms=(time.monotonic() - self.t_submit) * 1e3,
        ))

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> QueryResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"query {self.id!r} still pending after {timeout}s")
        # The event wait already orders this read after resolve()'s write;
        # the lock keeps the access inside the attribute's stated discipline.
        with self._lock:
            return self._result

    def add_done_callback(self, cb) -> None:
        with self._lock:
            if self._result is None:
                self._callbacks.append(cb)
                return
        cb(self)


def dedupe_key(q) -> tuple:
    """The identity class single-flight collapses on: two
    queries whose terminal payloads are interchangeable — same kind,
    source, per-kind params, and distance appetite. Deadlines and ids
    deliberately excluded: a follower rides the leader's dispatch and
    keeps its own id/latency."""
    return (q.kind, q.source, q.k, q.target, q.want_distances)


def _fanout(leader: PendingQuery, follower: PendingQuery) -> None:
    """Resolve a single-flight follower from its leader's terminal
    result: same payload (arrays shared read-only), the follower's own
    id and submit-to-now latency."""
    r = leader.result(0)
    follower.resolve(dataclasses.replace(
        r, id=follower.id,
        latency_ms=(time.monotonic() - follower.t_submit) * 1e3,
    ))


class InflightIndex:
    """Single-flight collapsing of identical in-flight queries:
    the FIRST submission of a ``dedupe_key`` becomes the
    LEADER and proceeds to admission; every concurrent duplicate becomes
    a FOLLOWER that never enters the queue — it resolves the moment the
    leader does, from a per-follower copy of the leader's result. N
    duplicate submissions occupy ONE lane instead of N, independent of
    whether the answer cache is armed.

    Thread-safe; leaders self-release on resolution (any terminal
    status, including REJECTED/ERROR — a failed leader fans its failure
    out rather than leaving followers hanging)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._leaders: dict = {}  # guarded-by: _lock

    def attach(self, q: PendingQuery) -> PendingQuery | None:
        """Register ``q`` as leader (returns None: caller admits it) or
        attach it as a follower to the in-flight leader (returns the
        leader: caller must NOT admit ``q`` — it is already wired to
        resolve)."""
        key = dedupe_key(q)
        with self._lock:
            leader = self._leaders.get(key)
            if leader is None:
                self._leaders[key] = q
        if leader is None:
            # Self-release on ANY terminal status; a later identical
            # query then leads its own dispatch (resolved results are
            # the cache's business, not the inflight index's).
            q.add_done_callback(lambda _p, k=key: self._release(k))
            return None
        leader.add_done_callback(
            lambda lead, fq=q: _fanout(lead, fq)
        )
        return leader

    def _release(self, key) -> None:
        with self._lock:
            self._leaders.pop(key, None)

    def depth(self) -> int:
        with self._lock:
            return len(self._leaders)


class AdmissionQueue:
    """Bounded FIFO of PendingQuery with batch-draining semantics.

    The queue itself never resolves queries (metrics and result policy
    stay with the service); it only admits, re-admits, and hands out
    batches. ``requeue`` bypasses the cap: those queries were already
    admitted once, and dropping them on re-admission after an OOM would
    be a silent drop."""

    def __init__(self, cap: int):
        if cap < 1:
            raise ValueError(f"queue cap must be >= 1, got {cap}")
        self.cap = cap
        self._items: deque = deque()  # guarded-by: _cond
        # Per-batch-key pending counts, maintained incrementally so the
        # kind-aware linger condition stays O(1) per wake —
        # and so pure single-kind traffic (the common case) keeps the
        # original popleft fast path with no deque rebuild.
        self._key_counts: dict = {}  # guarded-by: _cond
        self._cond = threading.Condition()
        self._stopped = False  # guarded-by: _cond

    def _bump(self, key, d: int) -> None:  # requires-lock: _cond
        c = self._key_counts.get(key, 0) + d
        if c:
            self._key_counts[key] = c
        else:
            self._key_counts.pop(key, None)

    def offer(self, q: PendingQuery) -> bool:
        """Admit, or False when the queue is full/stopped (caller sheds)."""
        with self._cond:
            if self._stopped or len(self._items) >= self.cap:
                return False
            self._items.append(q)
            self._bump(self._key_of(q), 1)
            depth = len(self._items)
            self._cond.notify()
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("enqueue", cat="serve.queue", query=q.id, depth=depth)
        return True

    def requeue(self, queries) -> None:
        """Re-admit (at the FRONT, preserving order) queries popped by a
        batch that could not run — an OOM'd dispatch being re-served at a
        narrower lane count must not send its queries to the back of the
        line, and must never shed them against the cap."""
        queries = list(queries)
        with self._cond:
            for q in reversed(queries):
                self._items.appendleft(q)
                self._bump(self._key_of(q), 1)
            self._cond.notify()
        rec = _obs.ACTIVE
        if rec is not None:
            rec.event("requeue", cat="serve.queue",
                      queries=[q.id for q in queries])

    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def stopped(self) -> bool:
        with self._cond:  # one mutex hop; callers poll at batch cadence
            return self._stopped

    @staticmethod
    def _key_of(q) -> tuple:
        return getattr(q, "batch_key", ("bfs",))

    def next_batch(self, max_n: int, linger_s: float) -> list:
        """Block until work exists, then drain up to ``max_n`` queries
        COMPATIBLE with the head query's batch key (only
        same-kind — and same-k for khop — queries can share a device
        dispatch; other kinds keep their queue order for later batches).

        When fewer than ``max_n`` compatible queries are pending, lingers
        up to ``linger_s`` from the moment the batch starts forming,
        returning early the instant it fills. After ``stop()`` the
        remaining queries drain immediately (no linger, no kind filter —
        the caller only resolves them as SHUTDOWN); returns [] only when
        stopped AND empty."""
        with self._cond:
            while not self._items and not self._stopped:
                self._cond.wait()
            if self._stopped:
                taken = []
                while self._items and len(taken) < max_n:
                    q = self._items.popleft()
                    self._bump(self._key_of(q), -1)
                    taken.append(q)
                return taken
            key = self._key_of(self._items[0])
            if linger_s > 0:
                deadline = time.monotonic() + linger_s
                while (self._key_counts.get(key, 0) < max_n
                       and not self._stopped):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            if len(self._key_counts) == 1:
                # Single-kind traffic: the original O(batch) popleft path.
                n = min(max_n, len(self._items))
                taken = [self._items.popleft() for _ in range(n)]
                self._bump(key, -n)
                return taken
            taken = []
            rest: deque = deque()
            for q in self._items:
                if len(taken) < max_n and self._key_of(q) == key:
                    taken.append(q)
                else:
                    rest.append(q)
            self._items = rest
            self._bump(key, -len(taken))
            return taken

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
