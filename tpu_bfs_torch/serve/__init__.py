"""Lane-batching BFS query server on one device, the port of
``tpu_bfs/serve``.

The packed engines' lane axis is a request-batching axis: one dispatch
answers up to ``lanes`` independent sources. This package turns that into
a long-lived query service:

- ``registry``    — load graphs once, build and warm engines keyed by
  ``EngineSpec`` (graph, engine, lanes, planes, pull gate, kind) with an
  LRU bound;
- ``scheduler``   — bounded admission queue coalescing pending queries into
  one packed batch per dispatch (linger, deadlines, shed on overload,
  single-flight);
- ``executor``    — batch dispatch through the engines' dispatch/fetch
  halves, with transient retry, OOM lane degrade, the dispatch watchdog
  and the per-width circuit breaker (the classifier of
  ``utils/recovery.py``);
- ``frontend``    — ``BfsService`` (width ladder, pipelined extraction on
  its own CUDA stream, kinds, answer tier) and the stdin/stdout JSONL
  server behind ``python -m tpu_bfs_torch.serve``;
- ``metrics``     — /statsz counters and the /metricz export;
- ``answercache`` — the byte-budgeted, CRC-checked answer cache.

``devices > 1`` serves on a mesh of ranks (``parallel/mesh.serve_mesh``)
with the failover ladder, the health probe and level-checkpointed resume
of ``tpu_bfs_torch/resilience``. ``aot_dir`` (the server's ``--preheat``)
adopts single-device rungs' exported programs from an artifact store
(``utils/aot.py``); on a mesh it raises ``NotImplementedError``.
"""

from tpu_bfs_torch.serve.executor import CircuitBreaker  # noqa: F401
from tpu_bfs_torch.serve.frontend import BfsService  # noqa: F401
from tpu_bfs_torch.serve.metrics import ServeMetrics  # noqa: F401
from tpu_bfs_torch.serve.registry import EngineRegistry, EngineSpec  # noqa: F401
from tpu_bfs_torch.serve.scheduler import (  # noqa: F401
    STATUS_ERROR,
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHUTDOWN,
    AdmissionQueue,
    PendingQuery,
    QueryResult,
)
