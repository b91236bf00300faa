"""Sampled shadow re-execution, the port of ``tpu_bfs/integrity/shadow.py``:
replay served queries on a DISJOINT engine config and bit-compare the
answers.

The structural checks (integrity/structural.py) prove a served answer is
*a* valid BFS/SSSP labeling — but a miscompiled rung that computes a
correct-shaped wrong tree, or a corrupted reduction that misreports a
count, can pass properties while still lying. The shadow auditor closes
that hole the way the fuzz suite does, continuously and in production:
a deterministic sample of resolved queries is re-executed on a warm
engine of a DIFFERENT shape — another width rung of the ladder, or the
alternate exchange family of a mesh — and the two
answers are compared bit-for-bit per kind (distances for bfs/sssp,
reached counts and extras for the metadata kinds, met/distance for p2p,
whose meet vertex is legitimately batch-composition-dependent). Two
independent programs agreeing bit-exactly is as close to an oracle as a
system serving graphs no CPU golden can hold gets (the Graph500
validation stance, arXiv:1104.4518).

Replays run on ONE background worker off the serving threads, through
the same registry (the disjoint rung stays warm after its first build);
a bounded queue sheds audits — never queries — under overload. Audit
failures are CONFIRMED corruption (the comparison is exact and the
sampler replays the served payload, not a re-extraction) and feed the
quarantine path; replay infrastructure failures (a transient during the
shadow run) retry once, then count as audit errors and never quarantine.

A replay runs through the replay engine's ``run``, which takes that
engine's dispatch lock; the replay rung is never the rung whose batch the
extraction worker is copying, and each batch holds its own result tensors,
so a replay cannot overwrite state an extraction still reads.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time

import numpy as np

from tpu_bfs_torch import faults as _faults

#: The replay backlog: at most this many queued jobs, holding at most this
#: many bytes of served payload (each bfs/sssp job pins a full [V] int32
#: distance row). Past either bound an audit sheds, never a query.
MAX_PENDING = 64
MAX_PENDING_BYTES = 256 << 20
#: Retries of a replay that failed with a transient error.
SHADOW_RETRIES = 1


def splitmix32(x: int) -> int:
    """Deterministic 32-bit mix (the graph generator's family): the
    sampler's coin, a pure function of (seed, sequence number)."""
    x = (x + 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


class AuditSampler:
    """Deterministic Bernoulli sampler over the resolve sequence.

    ``should_sample()`` consumes one sequence slot and answers whether
    that resolution is audited: ``splitmix32(seed ^ seq) / 2^32 <
    rate``. Pure function of (seed, seq), so the same serve run samples
    the same queries — the determinism the chaos soaks replay on."""

    def __init__(self, rate: float, seed: int = 0):
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"audit rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.seed = int(seed) & 0xFFFFFFFF
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock

    def should_sample(self) -> bool:
        if self.rate <= 0.0:
            return False
        with self._lock:
            seq = self._seq
            self._seq += 1
        if self.rate >= 1.0:
            return True
        return splitmix32(self.seed ^ seq) < self.rate * 4294967296.0

    def picks(self, n: int) -> list:
        """The sample decisions for sequence slots [0, n) WITHOUT
        consuming them — test/inspection helper."""
        if self.rate >= 1.0:
            return [True] * n
        if self.rate <= 0.0:
            return [False] * n
        bar = self.rate * 4294967296.0
        return [splitmix32(self.seed ^ i) < bar for i in range(n)]


@dataclasses.dataclass
class ShadowJob:
    """One sampled resolution: the served payload plus where it came
    from (the suspect rung the quarantine path indicts on mismatch)."""

    query_id: object
    kind: str
    source: int
    k: int | None
    target: int | None
    width: int
    devices: int
    distances: np.ndarray | None
    levels: int | None
    reached: int | None
    extras: dict | None
    t_resolved: float
    # Where the served answer came from: "serve" for a batch
    # resolution, "cache"/"landmark" for the answer tier's bypass paths.
    # The quarantine routing keys on this — a stale cached answer
    # indicts the cache generation, never the replay rung.
    origin: str = "serve"
    # The graph generation the answer was served under. The replay worker
    # sheds jobs whose generation no longer matches the live service: a
    # replay engine always syncs to the CURRENT overlay, so comparing a
    # pre-flip answer against it would indict a healthy rung for the graph
    # having legitimately changed (the staleness auditor's business).
    generation: int = 0
    # The overlay install epoch at resolution: it also moves on a restage
    # healing a torn flip and on a compaction, which the generation does
    # not see; a replay across either compares two table installs.
    epoch: int = 0


#: Extras keys that legitimately vary with batch composition (the sssp
#: round count is the WHOLE batch's fixed-point iteration count) — the
#: shadow compare must not read them as corruption. The answer tier's
#: provenance stamps (cache_hit/landmark/exact/bounds) are
#: metadata about HOW the answer was served, not part of the payload,
#: so a replay legitimately lacks them.
from tpu_bfs_torch.serve.answercache import PROVENANCE_EXTRAS  # noqa: E402

_BATCH_DEPENDENT_EXTRAS = frozenset(("sssp_rounds",)) | PROVENANCE_EXTRAS


def compare_payloads(job: ShadowJob, res) -> str | None:
    """Bit-compare the served payload against a shadow result's lane 0.
    Returns a human-readable mismatch description, or None when they
    agree. p2p compares met/distance/target (the meet vertex and path
    depend on batch composition — structural.py validates the path)."""
    if job.kind == "p2p":
        ex = dict(res.extras(0) or {})
        served = dict(job.extras or {})
        for key in ("met", "distance", "target"):
            if served.get(key) != ex.get(key):
                return (
                    f"p2p {key} mismatch: served {served.get(key)!r} vs "
                    f"shadow {ex.get(key)!r}"
                )
        return None
    if job.reached is not None:
        shadow_reached = int(np.asarray(res.reached)[0])
        if int(job.reached) != shadow_reached:
            return (
                f"reached mismatch: served {job.reached} vs shadow "
                f"{shadow_reached}"
            )
    extras_fn = getattr(res, "extras", None)
    if extras_fn is not None and job.extras is not None:
        shadow_ex = extras_fn(0) or {}
        for key, val in job.extras.items():
            if key in _BATCH_DEPENDENT_EXTRAS:
                continue
            if key in shadow_ex and shadow_ex[key] != val:
                return (
                    f"extras[{key!r}] mismatch: served {val!r} vs shadow "
                    f"{shadow_ex[key]!r}"
                )
    if job.distances is not None:
        shadow_d = res.distances_int32(0)
        if not np.array_equal(np.asarray(job.distances), shadow_d):
            i = int(np.flatnonzero(
                np.asarray(job.distances) != shadow_d
            )[0])
            return (
                f"distance mismatch at vertex {i}: served "
                f"{int(np.asarray(job.distances)[i])} vs shadow "
                f"{int(shadow_d[i])}"
            )
    elif job.levels is not None and job.kind in ("bfs", "sssp"):
        shadow_levels = int(np.asarray(res.ecc)[0])
        if int(job.levels) != shadow_levels:
            return (
                f"levels mismatch: served {job.levels} vs shadow "
                f"{shadow_levels}"
            )
    return None


class ShadowAuditor:
    """The background replay worker. ``replay(spec_fn, registry)`` are
    bound by the integrity tier; this class owns only the queue, the
    thread, and the compare."""

    def __init__(self, *, acquire_engine, on_mismatch, metrics, current_state,
                 log=None):
        self._acquire_engine = acquire_engine  # (width, kind) -> engine
        self._on_mismatch = on_mismatch  # (job, detail) -> None
        # () -> (generation, epoch): the service's live overlay state
        # ((0, 0) on a static service, so no job is shed there).
        self._current_state = current_state
        self._metrics = metrics
        self._log = log or (lambda msg: None)
        self._q: _queue.Queue = _queue.Queue(maxsize=MAX_PENDING)
        self._pending_lock = threading.Lock()
        self._pending_bytes = 0  # guarded-by: _pending_lock
        self._thread: threading.Thread | None = None
        self._stopped = False  # lock-free flag (submit-side shed only)

    @staticmethod
    def _job_bytes(job: ShadowJob) -> int:
        d = job.distances
        return 256 + (0 if d is None else int(np.asarray(d).nbytes))

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "ShadowAuditor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="bfs-serve-audit", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        """Drain every queued audit, then stop the worker. Idempotent."""
        self._stopped = True
        thread = self._thread
        if thread is None:
            return
        self._q.put(None)  # sentinel AFTER the queued jobs: full drain
        thread.join()
        self._thread = None

    def flush(self, timeout: float = 60.0) -> bool:
        """Block until every enqueued audit has been processed (the
        bench/smoke barrier before reading the audit counters). True on
        a complete flush."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return self._q.unfinished_tasks == 0

    # --- submission (extraction-worker side) ------------------------------

    def offer(self, job: ShadowJob) -> bool:
        """Enqueue one sampled resolution; sheds (False) when the audit
        backlog is full or the auditor stopped — audits degrade, serving
        never blocks."""
        if self._stopped:
            return False
        cost = self._job_bytes(job)
        with self._pending_lock:
            if self._pending_bytes + cost > MAX_PENDING_BYTES:
                over = True
            else:
                over = False
                self._pending_bytes += cost
        if over:
            self._metrics.record_audit_dropped()
            return False
        try:
            self._q.put_nowait(job)
            return True
        except _queue.Full:
            with self._pending_lock:
                self._pending_bytes -= cost
            self._metrics.record_audit_dropped()
            return False

    # --- the worker -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._audit(job)
            except Exception as exc:  # noqa: BLE001 — audit must not die
                self._metrics.record_audit_error()
                self._log(f"shadow audit errored (query "
                          f"{job.query_id!r}): {type(exc).__name__}: "
                          f"{str(exc)[:200]}")
            finally:
                cost = self._job_bytes(job)
                with self._pending_lock:
                    self._pending_bytes -= cost
                self._q.task_done()

    def _replay(self, job: ShadowJob):
        if _faults.ACTIVE is not None:
            # Chaos site: kinds scheduled here target the audit tier
            # itself (a transient shadow replay must degrade to an audit
            # error, never a serving failure — tests pin it).
            _faults.ACTIVE.hit("audit_shadow", lanes=job.width,
                               devices=job.devices)
        engine = self._acquire_engine(job.width, job.kind)
        kwargs = {}
        if job.kind == "khop":
            kwargs["k"] = int(job.k)
        elif job.kind == "p2p":
            kwargs["targets"] = np.asarray([int(job.target)], dtype=np.int64)
        return engine.run(
            np.asarray([job.source], dtype=np.int64), time_it=False, **kwargs
        )

    def _audit(self, job: ShadowJob) -> None:
        if (job.generation, job.epoch) != self._current_state():
            # A flip, restage or compaction landed between resolution and
            # replay: the served bits came from another table install than
            # any engine the replay could run on. Not a finding: shed it.
            self._metrics.record_audit_dropped()
            self._log(
                f"shadow audit shed (query {job.query_id!r}): served "
                f"overlay state (gen {job.generation}, epoch "
                f"{job.epoch}) superseded"
            )
            return
        attempt = 0
        while True:
            try:
                res = self._replay(job)
                break
            except Exception as exc:  # noqa: BLE001 — retried, then counted
                from tpu_bfs_torch.utils.recovery import is_transient_failure

                if is_transient_failure(exc) and attempt < SHADOW_RETRIES:
                    attempt += 1
                    continue
                raise
        detail = compare_payloads(job, res)
        if (detail is not None
                and (job.generation, job.epoch) != self._current_state()):
            # The flip or restage landed DURING the replay: the replay
            # engine may have synced to the new overlay, so the mismatch is
            # the graph changing, not corruption. Shed, do not indict.
            self._metrics.record_audit_dropped()
            self._log(
                f"shadow audit shed (query {job.query_id!r}): "
                f"overlay state changed mid-replay"
            )
            return
        lag_ms = (time.monotonic() - job.t_resolved) * 1e3
        self._metrics.record_audit(lag_ms, failed=detail is not None)
        if detail is not None:
            self._on_mismatch(job, detail)
