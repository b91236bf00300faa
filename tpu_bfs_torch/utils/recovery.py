"""Failure classification and the recovery counters, the part of
``tpu_bfs/utils/recovery.py`` the serve tier reads.

The serve executor and the service route every failure through one
classifier: transient infrastructure trouble is retried in place, an
out-of-memory failure degrades the lane count, and everything else is a
deterministic failure that resolves its queries with errors and feeds the
circuit breaker.

The tables keep the JAX package's markers, so an injected fault
(``tpu_bfs_torch/faults.py`` raises with XLA's status texts) classifies
as it does there. What PyTorch and the port's kernels raise on the card:

- an out-of-memory error is ``torch.OutOfMemoryError`` ("CUDA out of
  memory. Tried to allocate ..."), a RuntimeError whose text the
  lower-case ``"out of memory"`` marker matches: OOM, never transient;
- a sticky CUDA error ("an illegal memory access was encountered",
  "unspecified launch failure", a device-side assert, ...) leaves the CUDA
  context unusable, so every later call fails too. Its texts are
  :data:`STICKY_CUDA_MARKERS`: neither transient nor OOM, so the executor
  never retries or degrades on a dead context;
- a failed kernel launch raises ``RuntimeError("<kernel>: CUDA launch
  failed with cudaError_t N")`` (``ops/_build.check_launch``): no marker
  matches, so it is deterministic.

``reset_failed_backend_init`` (jax's backend-cache reset) has no PyTorch
counterpart and is not ported; ``advance_with_recovery`` waits for its
reader, the CLI (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class RecoveryCounters:
    """Process-wide retry and degrade counts (one instance: ``COUNTERS``),
    the JAX package's fields."""

    transient_retries: int = 0  # re-attempts after a transient classification
    engine_rebuilds: int = 0  # advance_with_recovery engine reconstructions
    backend_init_resets: int = 0  # backend-init resets (JAX only)
    oom_degrades: int = 0  # OOM-driven lane halvings
    watchdog_trips: int = 0  # serve dispatch-watchdog deadline firings
    breaker_opens: int = 0  # serve circuit-breaker open transitions
    requeue_sheds: int = 0  # queries shed at the serve requeue budget
    faults_injected: int = 0  # tpu_bfs_torch/faults.py injections
    mesh_faults: int = 0  # mesh-death classifications
    mesh_degrades: int = 0  # degraded-mesh failover rebuilds
    query_resumes: int = 0  # level-checkpointed mid-query resumes
    quarantines: int = 0  # corruption-audit rung quarantines

    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name != "_lock"
            }

    def any(self) -> bool:
        return any(self.as_dict().values())

    def reset(self) -> None:
        with self._lock:
            for f in dataclasses.fields(self):
                if f.name != "_lock":
                    setattr(self, f.name, 0)


COUNTERS = RecoveryCounters()

# Mesh-death markers: a participant dropping out of the mesh, a failed
# health check, or a hung collective. They feed the transient patterns and
# is_mesh_fault.
MESH_FAULT_MARKERS = (
    "DATA_LOSS",
    "slice health",
    "Program hung",
)


def is_mesh_fault(exc: BaseException) -> bool:
    """True when ``exc`` carries a mesh-death marker."""
    msg = str(exc)
    return any(m in msg for m in MESH_FAULT_MARKERS)


# Substrings that mark an error as plausibly transient infrastructure
# trouble (transport failures and the INTERNAL/UNAVAILABLE status codes).
TRANSIENT_PATTERNS = (
    "remote_compile",
    "read body closed",
    "Socket closed",
    "Connection reset",
    "Broken pipe",
    "INTERNAL:",
    "UNAVAILABLE:",
    "DEADLINE_EXCEEDED:",
    "Unable to initialize backend",
    *MESH_FAULT_MARKERS,
)

# Out-of-memory flavors, matched case-insensitively: XLA's status and
# PyTorch's torch.OutOfMemoryError ("CUDA out of memory").
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
)


def is_oom_failure(exc: BaseException) -> bool:
    low = str(exc).lower()
    return any(m.lower() in low for m in OOM_MARKERS)


# Sticky CUDA errors: the context is dead and every later call fails, so a
# retry can only fail again (and an OOM degrade would rebuild on it).
STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "illegal instruction",
    "misaligned address",
)

# Deterministic failures that can carry an INTERNAL: status but are bugs,
# not infrastructure blips.
NON_TRANSIENT_MARKERS = (
    "Mosaic",
    *OOM_MARKERS,
    "Invalid argument",
    *STICKY_CUDA_MARKERS,
)

# Exception type names eligible for retry, matched by name. Validation
# failures (AssertionError, ValueError) are excluded by this list; a plain
# RuntimeError must still carry a transient pattern in its message.
TRANSIENT_TYPE_NAMES = (
    "JaxRuntimeError",
    "XlaRuntimeError",
    "InternalError",
    "UnavailableError",
    "DeadlineExceededError",
    "RuntimeError",
)


def is_transient_failure(exc: BaseException) -> bool:
    """True for infrastructure-flavoured runtime errors worth retrying;
    never for validation failures, OOM, sticky CUDA errors or
    deterministic compiler errors."""
    names = {t.__name__ for t in type(exc).__mro__}
    if not names.intersection(TRANSIENT_TYPE_NAMES):
        return False
    msg = str(exc)
    if any(p in msg for p in NON_TRANSIENT_MARKERS):
        return False
    return any(p in msg for p in TRANSIENT_PATTERNS)
