"""Deterministic fault injection, the port of ``tpu_bfs/faults.py``: one
seeded, replayable :class:`FaultSchedule` armed process-wide and consulted
at NAMED INJECTION SITES inside the production code.

The spec grammar, the site and kind tables and the schedule are the JAX
package's, whole, so one spec string arms both packages identically. The
port visits these sites:

============ =====================================================
site         where it lives
============ =====================================================
dispatch     algorithms/_packed_common.dispatch_packed_batch
fetch        algorithms/_packed_common.fetch_packed_batch
serve_batch  serve/executor.BatchExecutor.dispatch_batch
engine_build serve/registry.EngineRegistry._build_inner
cache_lookup serve/answercache.AnswerCache.get
============ =====================================================

The other sites of the table wait for their readers: ``ckpt_save``,
``ckpt_load``, ``advance``, ``sssp_dispatch`` and ``sssp_fetch`` (ROADMAP
Queue 1 item 4), ``probe`` (the mesh serve slice), ``audit_*`` (integrity),
``generation_flip`` and ``compact`` (dynamic graphs) and ``aot_load``
(item 5). A clause naming one of them parses and never fires.

Production code never pays for this when disabled: every site guard is
one module-attribute check (``if faults.ACTIVE is not None``) against a
global that is ``None`` unless a schedule was armed through ``--faults``
(the serve entry point), the ``TPU_BFS_FAULTS`` environment variable, or
:func:`arm` in tests.

Spec grammar (``--faults`` / ``TPU_BFS_FAULTS``)::

    spec    := [ "seed=" INT ":" ] clause ("," clause)*
    clause  := kind ( "@" target )* ( ":" param )*
    target  := SITE                 (e.g. "@fetch")
             | QUAL "=" INT         (e.g. "@rung=512" — context match)
               (targets compose: at most one site + any qualifiers,
                e.g. "oom@fetch@rung=64")
    param   := "p=" FLOAT | "n=" INT | "ms=" FLOAT | "skip=" INT
    kind    := "transient" | "oom" | "slow" | "slow_extract"
             | "corrupt_ckpt" | "corrupt_aot"
             | "corrupt_result" | "corrupt_wire"
             | "stale_cache" | "corrupt_cache_entry"
             | "torn_flip" | "corrupt_overlay" | "compaction_crash"
             | "device_lost" | "collective_hang" | "backend_restart"

Example::

    seed=7:transient@serve_batch:n=2,slow_extract:ms=50:n=4

``n`` bounds how many times a clause fires (default 1 when no ``p`` is
given); ``p`` is a per-visit probability drawn from the schedule's own
seeded RNG, so the same seed over the same visit sequence injects the
same faults. ``rung`` matches the dispatch width (``lanes`` in the site's
context); ``rank=K`` matches a mesh site whose mesh contains rank K
(``devices > K``); ``ms`` is the sleep of the slow kinds; ``skip=K``
passes over the first K matching visits. Injected transients carry an
``INTERNAL:`` message and injected OOMs a ``RESOURCE_EXHAUSTED`` one, so
the one classifier the port shares (``utils/recovery.py``) routes them as
it routes real failures; the mesh kinds carry the mesh-death markers. Every
firing is recorded in ``schedule.events`` and bumps
``RecoveryCounters.faults_injected``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time

SITES = (
    "dispatch",
    "fetch",
    "serve_batch",
    "engine_build",
    "ckpt_save",
    "ckpt_load",
    "advance",
    "aot_load",
    "probe",
    # The SSSP engine's dispatch/fetch halves.
    "sssp_dispatch",
    "sssp_fetch",
    # The integrity tier's auditors.
    "audit_structural",
    "audit_shadow",
    # The answer cache's hit path (serve/answercache.py):
    # corrupt_cache_entry flips a stored payload byte so the CRC32
    # verification fires (the hit degrades to a miss and an eviction);
    # stale_cache serves a CRC-valid but wrong answer.
    "cache_lookup",
    # The dynamic-graph flip and compaction.
    "generation_flip",
    "compact",
)

# Where a clause lands when it names no "@site". slow_extract is the
# spec-friendly alias for slowing the blocking result half. The mesh
# kinds default to fetch: async dispatch returns before any collective
# runs, so a real mesh death surfaces at the blocking result half.
DEFAULT_SITE = {
    "transient": "dispatch",
    "oom": "dispatch",
    "slow": "fetch",
    "slow_extract": "fetch",
    "corrupt_ckpt": "ckpt_save",
    "corrupt_aot": "aot_load",
    # Bit flips at the result boundary.
    "corrupt_result": "fetch",
    "corrupt_wire": "fetch",
    # In-place mutations of a cache hit, at the cache's lookup site.
    "stale_cache": "cache_lookup",
    "corrupt_cache_entry": "cache_lookup",
    # The dynamic-graph kinds.
    "torn_flip": "generation_flip",
    "corrupt_overlay": "generation_flip",
    "compaction_crash": "compact",
    "device_lost": "fetch",
    "collective_hang": "fetch",
    "backend_restart": "fetch",
}
KINDS = tuple(DEFAULT_SITE)

#: The mesh fault kinds: injected errors carry the mesh-death markers
#: (utils/recovery.MESH_FAULT_MARKERS).
MESH_KINDS = ("device_lost", "collective_hang", "backend_restart")

# Raising kinds produce messages the shared classifier (utils/recovery.py)
# routes like real infrastructure failures; the non-raising kinds act in
# place (sleep / corrupt-after-write).
_RAISING_KINDS = ("transient", "oom", "compaction_crash", *MESH_KINDS)

# Context-qualifier aliases: "rung" reads the site's "lanes" context key
# (the spec grammar talks about ladder rungs; the sites report widths).
_QUAL_ALIASES = {"rung": "lanes"}

# Range-matched qualifiers: "rank=K" matches when the site's mesh
# CONTAINS rank K (ctx devices > K) — a lost chip fails every mesh that
# includes it, while a degraded re-dispatch on a mesh too small to
# include it escapes (the failover ladder's escape hatch).
_QUAL_RANGES = {"rank": "devices"}


@dataclasses.dataclass
class FaultRule:
    """One parsed spec clause plus its runtime budget."""

    kind: str
    site: str
    qual: tuple = ()  # ((ctx_key, int_value), ...) — all must match
    p: float | None = None  # per-visit probability (None = always)
    n: int | None = None  # firing budget (None = unlimited)
    ms: float | None = None  # sleep for slow kinds
    skip: int = 0  # matching visits to pass over before becoming eligible
    remaining: int | None = dataclasses.field(default=None, compare=False)
    fired: int = dataclasses.field(default=0, compare=False)
    visits: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {KINDS})"
            )
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} (one of {SITES})"
            )
        if self.kind in ("slow", "slow_extract") and self.ms is None:
            raise ValueError(f"{self.kind} needs an ms= parameter")
        if self.p is not None and not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.remaining is None:
            self.remaining = self.n

    def matches(self, site: str, ctx: dict) -> bool:
        """Site + context-qualifier match (budget/skip/probability are the
        schedule's concern — see ``FaultSchedule._select``)."""
        if site != self.site:
            return False
        for key, want in self.qual:
            rng = _QUAL_RANGES.get(key)
            if rng is not None:
                # Range semantics: "rank=K" matches meshes CONTAINING
                # rank K — the injected chip loss follows the chip, not
                # one mesh shape, so a degraded (smaller) mesh escapes.
                got = ctx.get(rng)
                if got is None or int(got) <= want:
                    return False
                continue
            got = ctx.get(_QUAL_ALIASES.get(key, key))
            if got is None or int(got) != want:
                return False
        return True

    def to_clause(self) -> str:
        out = self.kind
        if self.site != DEFAULT_SITE[self.kind]:
            out += f"@{self.site}"
        out += "".join(f"@{k}={v}" for k, v in self.qual)
        if self.p is not None:
            out += f":p={self.p:g}"
        if self.n is not None:
            out += f":n={self.n}"
        if self.ms is not None:
            out += f":ms={self.ms:g}"
        if self.skip:
            out += f":skip={self.skip}"
        return out


def _parse_clause(clause: str) -> FaultRule:
    head, *params = clause.split(":")
    head = head.strip()
    kind, _, target = head.partition("@")
    kind = kind.strip()
    if kind not in KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} in clause {clause!r} "
            f"(one of {KINDS})"
        )
    site = DEFAULT_SITE[kind]
    qual = []
    explicit_site = False
    # "@" targets compose: at most one site plus any context qualifiers
    # (e.g. "oom@fetch@rung=64" — OOM the fetch half of 64-wide batches).
    for tok in target.split("@") if target else ():
        tok = tok.strip()
        if "=" in tok:
            qk, _, qv = tok.partition("=")
            try:
                qual.append((qk.strip(), int(qv)))
            except ValueError:
                raise ValueError(
                    f"qualifier {tok!r} in clause {clause!r} must be "
                    f"name=int"
                ) from None
        elif explicit_site:
            raise ValueError(
                f"clause {clause!r} names two sites ({site!r}, {tok!r})"
            )
        else:
            site = tok
            explicit_site = True
    qual = tuple(qual)
    p = n = ms = None
    skip = 0
    for param in params:
        k, eq, v = param.partition("=")
        k = k.strip()
        if not eq:
            raise ValueError(f"parameter {param!r} in clause {clause!r} "
                             f"must be key=value")
        try:
            if k == "p":
                p = float(v)
            elif k == "n":
                n = int(v)
            elif k == "ms":
                ms = float(v)
            elif k == "skip":
                skip = int(v)
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"unknown/invalid parameter {param!r} in clause {clause!r} "
                "(p=FLOAT, n=INT, ms=FLOAT, skip=INT)"
            ) from None
    if p is None and n is None:
        n = 1  # a bare clause fires exactly once — deterministic by default
    return FaultRule(kind=kind, site=site, qual=qual, p=p, n=n, ms=ms,
                     skip=skip)


class FaultSchedule:
    """A seeded set of :class:`FaultRule` consulted at injection sites.

    Thread-safe: the serve scheduler, extraction worker, and client
    threads may all hit sites concurrently; rule budgets and the RNG are
    guarded by one lock. Probability draws consume the schedule's own
    ``random.Random(seed)``, so the injection sequence is a pure function
    of (seed, site-visit sequence)."""

    def __init__(self, rules, *, seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._seq = 0
        self.events: list[dict] = []  # audit log of every firing

    # --- construction -----------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str) -> "FaultSchedule":
        spec = spec.strip()
        if not spec:
            raise ValueError("empty fault spec")
        seed = 0
        if spec.startswith("seed="):
            head, _, rest = spec.partition(":")
            try:
                seed = int(head[len("seed="):])
            except ValueError:
                raise ValueError(f"bad seed in fault spec {spec!r}") from None
            spec = rest
        clauses = [c for c in spec.split(",") if c.strip()]
        if not clauses:
            raise ValueError("fault spec has no clauses")
        return cls([_parse_clause(c) for c in clauses], seed=seed)

    def to_spec(self) -> str:
        """Canonical spec string; ``from_spec(to_spec())`` round-trips."""
        return f"seed={self.seed}:" + ",".join(
            r.to_clause() for r in self.rules
        )

    # --- runtime ----------------------------------------------------------

    def _select(self, site: str, ctx: dict, kinds=None) -> list[FaultRule]:
        """Consume budgets/RNG for matching rules; returns fired rules."""
        fired = []
        with self._lock:
            for rule in self.rules:
                if kinds is not None and rule.kind not in kinds:
                    continue
                if not rule.matches(site, ctx):
                    continue
                rule.visits += 1
                if rule.visits <= rule.skip:
                    continue  # not eligible yet (skip=K targets visit K+1)
                if rule.remaining is not None and rule.remaining <= 0:
                    continue
                if rule.p is not None and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                if rule.remaining is not None:
                    rule.remaining -= 1
                self._seq += 1
                self.events.append({
                    "seq": self._seq,
                    "site": site,
                    "kind": rule.kind,
                    "clause": rule.to_clause(),
                    "ctx": {k: v for k, v in ctx.items()},
                })
                fired.append(rule)
                if rule.kind in _RAISING_KINDS:
                    break  # one raise per visit; later rules keep budget
        for rule in fired:
            self._count_injected()
            self._record_obs(site, rule, ctx)
        return fired

    @staticmethod
    def _record_obs(site: str, rule: FaultRule, ctx: dict) -> None:
        # Telemetry cross-link (lazy import, same stdlib-only discipline
        # as _count_injected): when the obs recorder is armed, every
        # firing lands in the span stream — a flight-recorder dump of a
        # chaos incident then names the injected fault's site alongside
        # the spans it broke.
        from tpu_bfs_torch import obs as _obs

        if _obs.ACTIVE is not None:
            _obs.ACTIVE.event(
                "fault_injected", cat="faults", site=site, kind=rule.kind,
                clause=rule.to_clause(), **ctx,
            )

    @staticmethod
    def _count_injected() -> None:
        # Lazy import: recovery counters live under tpu_bfs_torch.utils and this
        # module must stay stdlib-only at import time.
        from tpu_bfs_torch.utils.recovery import COUNTERS

        COUNTERS.bump("faults_injected")

    def hit(self, site: str, **ctx) -> None:
        """Consult the schedule at ``site``. Sleeps for slow rules, then
        raises for at most one transient/oom rule — messages routed by the
        shared classifier exactly like real infrastructure failures."""
        raising = None
        # Only the kinds hit() can act on — in-place kinds (corrupt_ckpt)
        # keep their budget for the dedicated take() consultation.
        kinds = (*_RAISING_KINDS, "slow", "slow_extract")
        for rule in self._select(site, ctx, kinds=kinds):
            if rule.kind in ("slow", "slow_extract"):
                time.sleep((rule.ms or 0.0) / 1e3)
            elif raising is None and rule.kind in _RAISING_KINDS:
                raising = rule
        if raising is None:
            return
        where = f"site={site}" + "".join(
            f" {k}={v}" for k, v in sorted(ctx.items())
        )
        tail = f"({where}, clause {raising.to_clause()!r}) [tpu_bfs_torch.faults]"
        if raising.kind == "transient":
            raise RuntimeError(f"INTERNAL: injected transient fault {tail}")
        if raising.kind == "device_lost":
            # utils/recovery.is_mesh_fault keys on DATA_LOSS.
            raise RuntimeError(
                f"DATA_LOSS: injected device loss — a mesh participant "
                f"disappeared mid-collective; the remaining replicas "
                f"cannot complete the exchange {tail}"
            )
        if raising.kind == "collective_hang":
            raise RuntimeError(
                f"INTERNAL: injected collective hang — Program hung "
                f"(awaiting completion of an all-reduce that a lost "
                f"participant will never join) {tail}"
            )
        if raising.kind == "compaction_crash":
            # The compactor dying mid-fold: new generation files are on
            # disk, CURRENT still points at the old one. INTERNAL so the
            # shared classifier treats it as a crash, not a retryable
            # transient — the caller's contract is rollback, not retry.
            raise RuntimeError(
                f"INTERNAL: injected compactor crash — the compaction "
                f"process died after writing the new generation but "
                f"before the commit pointer advanced {tail}"
            )
        if raising.kind == "backend_restart":
            raise RuntimeError(
                f"UNAVAILABLE: injected backend restart — slice health "
                f"check failed; the TPU runtime is restarting the slice "
                f"{tail}"
            )
        raise RuntimeError(
            f"RESOURCE_EXHAUSTED: injected out-of-memory fault {tail}"
        )

    def take(self, site: str, kind: str, **ctx) -> bool:
        """Non-raising consultation for in-place kinds (corrupt_ckpt):
        True when a matching rule fired (budget consumed)."""
        return bool(self._select(site, ctx, kinds=(kind,)))

    def counts(self) -> dict:
        """Fired-count per kind — the statsz/audit summary."""
        with self._lock:
            out: dict = {}
            for rule in self.rules:
                out[rule.kind] = out.get(rule.kind, 0) + rule.fired
            return out

    def exhausted(self) -> bool:
        """True once every bounded rule has spent its budget."""
        with self._lock:
            return all(
                r.remaining is not None and r.remaining <= 0
                for r in self.rules
            )


# --- process-wide arming ---------------------------------------------------

# THE guard production sites check: None (the default) keeps every
# injection site a single attribute test with no further work.
ACTIVE: FaultSchedule | None = None

ENV_VAR = "TPU_BFS_FAULTS"


def arm(schedule: FaultSchedule) -> FaultSchedule:
    global ACTIVE
    ACTIVE = schedule
    return schedule


def arm_from_spec(spec: str) -> FaultSchedule:
    return arm(FaultSchedule.from_spec(spec))


def arm_from_env(env: str = ENV_VAR) -> FaultSchedule | None:
    spec = os.environ.get(env, "").strip()
    return arm_from_spec(spec) if spec else None


def arm_from_spec_or_env(spec: str | None,
                         env: str = ENV_VAR) -> FaultSchedule | None:
    """The entry points' shared precedence: an explicit ``--faults`` spec
    wins over the environment variable; neither set = stay disarmed."""
    return arm_from_spec(spec) if spec else arm_from_env(env)


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def mesh_devices(engine) -> int:
    """Mesh span of an engine (1 on one device): the ``devices`` context of
    the fault sites, which ``rank`` qualifiers range-match on, and half of
    the serve breaker key (serve/executor.engine_devices)."""
    mesh = getattr(engine, "mesh", None)
    return 1 if mesh is None else int(mesh.num_shards)


def _flip_answer(dist, extras, reached):
    """One seeded mutation of an answer: a low bit of a finite distance, or
    (table-free kinds) the first numeric extras field, or the reached
    count. The inputs are never mutated in place."""
    import numpy as np

    from tpu_bfs_torch.graph.csr import INF_DIST

    if dist is not None:
        dist = np.array(dist, copy=True)
        fin = np.flatnonzero(dist != INF_DIST)
        i = int(fin[len(fin) // 2]) if len(fin) else 0
        dist[i] ^= 1
        return dist, extras, reached
    if extras:
        extras = dict(extras)
        for key, val in extras.items():
            if isinstance(val, int) and not isinstance(val, bool):
                extras[key] = val + 1
                return dist, extras, reached
    return dist, extras, (reached if reached is None else reached + 1)


def maybe_corrupt_result(dist, extras, reached, **ctx):
    """``fetch``-site hook for ``corrupt_result`` rules: flip one seeded
    bit of a just-extracted answer, so the client-visible result is wrong
    by exactly one mutation. Returns ``(dist, extras, reached, fired)``."""
    sched = ACTIVE
    if sched is None or not sched.take("fetch", "corrupt_result", **ctx):
        return dist, extras, reached, False
    return (*_flip_answer(dist, extras, reached), True)


def maybe_corrupt_cache_blob(blob: bytes, **ctx) -> tuple[bytes, bool]:
    """``cache_lookup`` site hook for ``corrupt_cache_entry`` rules: flip
    one byte of a cache entry's stored payload blob at hit time, so the
    entry's CRC32 verification fires and the hit degrades to a miss and
    an eviction. Returns ``(blob, fired)``."""
    sched = ACTIVE
    if sched is None or not sched.take("cache_lookup",
                                       "corrupt_cache_entry", **ctx):
        return blob, False
    if not blob:
        return b"\x00", True
    off = len(blob) // 2
    return (blob[:off] + bytes([blob[off] ^ 0xFF]) + blob[off + 1:]), True


def maybe_stale_cache(dist, extras, reached, **ctx):
    """``cache_lookup`` site hook for ``stale_cache`` rules: mutate a
    CRC-valid cache hit as ``maybe_corrupt_result`` mutates a fresh answer
    (the checksum cannot catch a stale but intact entry). Returns
    ``(dist, extras, reached, fired)``."""
    sched = ACTIVE
    if sched is None or not sched.take("cache_lookup", "stale_cache",
                                       **ctx):
        return dist, extras, reached, False
    return (*_flip_answer(dist, extras, reached), True)
