"""Warm-engine registry: graphs loaded once, engines built and warmed once,
the port of ``tpu_bfs/serve/registry.py``.

An engine build costs an ELL and tile build plus, on the card, the first
load of the CUDA kernel library; a server cannot pay that per query. The
registry keys resident engines by ``EngineSpec`` (graph, engine, lanes,
planes, pull gate, kind, graph generation, overlay capacity), warms each
build with one full-width batch plus the engine's ``warm_residency`` hook,
and bounds residency with an LRU.

Against JAX: there is no XLA compile cache to arm (the warm batch is the
whole warm-up), no ``expand_impl`` axis (the port always runs its K1
kernel, JAX's ``xla``/``pallas`` choice has no counterpart), and no
artifact store (``aot_dir``, ROADMAP Queue 1 item 5). Mesh specs
(``devices > 1``, the ``dist2d`` engine) wait for the mesh serve slice
(ROADMAP Queue 1 item 4) and raise ``NotImplementedError``. The registry
builds every engine on one torch device (``device``; None is CUDA).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import types
from collections import OrderedDict

import numpy as np

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch import obs as _obs

ENGINE_KINDS = ("wide", "hybrid", "packed", "dist2d")

# The hybrid engine's serving widths come in whole 4096-lane steps, as in
# the JAX package (its dense kernel's quantum there).
HYBRID_LANE_QUANTUM = 4096

# Serving engines default to 8 planes (254-level depth cap) where the
# one-shot CLI defaults to 5: one high-eccentricity query truncating a
# whole batch into errors costs more than the 3 extra planes.
DEFAULT_PLANES = 8

MESH_SERVE_ITEM = "ROADMAP Queue 1 item 4 (the serve tier on a mesh)"


def mesh_shape_2d(devices: int, mesh_shape=()) -> tuple[int, int]:
    """The (rows, cols) factorization a 2D engine serves on: an explicit
    ``mesh_shape`` wins; otherwise the most-square factorization of
    ``devices``."""
    if mesh_shape:
        r, c = int(mesh_shape[0]), int(mesh_shape[1])
        if r < 1 or c < 1 or r * c != devices:
            raise ValueError(
                f"mesh_shape {r}x{c} does not cover {devices} devices"
            )
        return r, c
    r = int(np.sqrt(devices))
    while devices % r:
        r -= 1
    return r, devices // r


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One resident engine's identity: everything that changes its tables
    or the answers it computes. ``kind`` selects a workload adapter over
    the base engine (sssp builds its own weighted tables)."""

    graph_key: str
    engine: str = "wide"
    lanes: int = 512
    planes: int = DEFAULT_PLANES
    pull_gate: bool = False
    devices: int = 1
    kind: str = "bfs"
    #: The served graph's version, bumped on every applied mutation batch.
    #: A key field (post-flip queries must never alias a pre-flip
    #: residency by key), but the registry REKEYS a resident engine across
    #: a flip (:meth:`EngineRegistry.rekey_generation`) instead of
    #: rebuilding it: only the overlay table values change.
    graph_generation: int = 0
    #: The delta-overlay capacity ``(rows, kcap)``; () is a static graph.
    #: The engine's fold runs over fixed-shape tables of this size.
    overlay: tuple = ()

    def __post_init__(self):
        # A hashable, stable key whatever sequence the capacity came in.
        object.__setattr__(self, "overlay", tuple(int(x) for x in self.overlay))

    def validate(self) -> None:
        if self.engine not in ENGINE_KINDS:
            raise ValueError(
                f"engine must be one of {ENGINE_KINDS}, got {self.engine!r}"
            )
        if self.devices > 1 or self.engine == "dist2d":
            raise NotImplementedError(
                f"serving on a mesh (devices={self.devices}, engine="
                f"{self.engine!r}) waits for {MESH_SERVE_ITEM}"
            )
        if self.lanes % 32 or self.lanes < 32:
            raise ValueError(
                f"lanes must be a multiple of 32 >= 32, got {self.lanes}"
            )
        if self.engine == "hybrid" and self.lanes % HYBRID_LANE_QUANTUM:
            raise ValueError(
                f"the hybrid engine's dense kernel takes whole "
                f"{HYBRID_LANE_QUANTUM}-lane steps, got {self.lanes}"
            )
        if self.engine == "packed" and self.pull_gate:
            raise ValueError(
                "pull_gate applies to the wide/hybrid engines (the packed "
                "engine keeps no settled-mask state)"
            )
        if self.graph_generation < 0:
            raise ValueError(
                f"graph_generation must be >= 0, got {self.graph_generation}"
            )
        if self.overlay:
            if len(self.overlay) != 2 or min(self.overlay) < 1:
                raise ValueError(
                    f"overlay must be (rows, kcap) with both >= 1, got "
                    f"{self.overlay}"
                )
            if self.engine != "wide" or self.devices > 1:
                raise ValueError(
                    "the delta overlay rides the single-chip wide "
                    "substrate (dynamic graphs); the mesh generalization "
                    "follows the partitioned tiles"
                )
            if self.pull_gate:
                raise ValueError(
                    "overlay does not compose with pull_gate (the gate "
                    "skips settled BASE rows; overlay edges would escape "
                    "it untraversed)"
                )
            if self.kind == "p2p":
                raise ValueError(
                    "kind 'p2p' is excluded from dynamic serving: its "
                    "path reconstruction scans the BUILD-TIME edge "
                    "tables, so a post-mutation path could silently "
                    "traverse removed edges"
                )
        if self.kind != "bfs":
            from tpu_bfs_torch.workloads import KIND_ENGINES, KINDS

            if self.kind not in KINDS:
                raise ValueError(
                    f"kind must be one of {KINDS}, got {self.kind!r}"
                )
            if self.engine not in KIND_ENGINES[self.kind]:
                raise ValueError(
                    f"kind {self.kind!r} runs on engines "
                    f"{KIND_ENGINES[self.kind]}, not {self.engine!r}"
                )
            if self.kind in ("p2p", "sssp") and self.pull_gate:
                raise ValueError(
                    f"kind {self.kind!r} does not compose with pull_gate "
                    "(p2p steps the resumable core level by level under "
                    "its own lane pairing; sssp runs min-plus tiles with "
                    "no settled-mask machinery)"
                )


class EngineRegistry:
    """LRU-bounded store of warmed engines over once-loaded graphs, all on
    one torch ``device`` (None: CUDA, raising without a card)."""

    def __init__(self, *, capacity: int = 4, warm: bool = True, log=None,
                 device=None):
        if capacity < 1:
            raise ValueError(f"registry capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = device
        self._warm = warm
        self._log = log or (lambda msg: None)
        self._graphs: dict = {}  # guarded-by: _lock
        self._engines: OrderedDict = OrderedDict()  # guarded-by: _lock
        # One build at a time (builds allocate device tables); RLock so
        # get() -> _build() -> graph() nests.
        self._lock = threading.RLock()
        self.builds = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        # Seconds of each spec's last build and warm-up.
        self.build_s: dict = {}  # guarded-by: _lock
        self.warm_s: dict = {}  # guarded-by: _lock

    # --- graphs -----------------------------------------------------------

    def add_graph(self, key: str, graph) -> str:
        """Register an already-loaded Graph under ``key``."""
        with self._lock:
            self._graphs[key] = graph
        return key

    def graph(self, key: str):
        """The graph for ``key``, loading it on first use when the key is
        a CLI graph spec (path / rmat:... / random:...)."""
        with self._lock:
            g = self._graphs.get(key)
            if g is None:
                from tpu_bfs_torch.cli import load_graph

                t0 = time.perf_counter()
                g = load_graph(key)
                self._graphs[key] = g
                self._log(
                    f"graph {key!r} loaded: V={g.num_vertices} "
                    f"E={g.num_edges} in {time.perf_counter() - t0:.1f}s"
                )
            return g

    # --- engines ----------------------------------------------------------

    def get(self, spec: EngineSpec):
        """The warmed engine for ``spec``, building it on first use and
        evicting least-recently-served engines over ``capacity``."""
        spec.validate()
        with self._lock:
            eng = self._engines.get(spec)
            if eng is not None:
                self._engines.move_to_end(spec)
                return eng
            eng = self._build(spec)
            if self._warm:
                self._warm_up(spec, eng)
            self._engines[spec] = eng
            while len(self._engines) > self.capacity:
                old_spec, _ = self._engines.popitem(last=False)
                self.evictions += 1
                self._log(f"evicted engine {old_spec}")
            return eng

    def _build(self, spec: EngineSpec):  # requires-lock: _lock
        rec = _obs.ACTIVE
        if rec is not None:
            rec.begin("engine_build", f"w{spec.lanes}", cat="serve.registry",
                      engine=spec.engine, width=spec.lanes,
                      planes=spec.planes, devices=spec.devices)
        try:
            eng = self._build_inner(spec)
        except Exception as exc:
            if rec is not None:
                rec.end("engine_build", f"w{spec.lanes}",
                        cat="serve.registry", width=spec.lanes,
                        error=f"{type(exc).__name__}: {str(exc)[:120]}")
            raise
        if rec is not None:
            rec.end("engine_build", f"w{spec.lanes}", cat="serve.registry",
                    width=spec.lanes)
        return eng

    def _build_inner(self, spec: EngineSpec):  # requires-lock: _lock
        if _faults.ACTIVE is not None:
            # A transient raised here runs the service's engine-build
            # retry; an OOM runs the width degrade.
            _faults.ACTIVE.hit("engine_build", lanes=spec.lanes)
        g = self.graph(spec.graph_key)
        t0 = time.perf_counter()
        from tpu_bfs_torch.workloads import build_workload_engine

        if spec.kind == "sssp":
            # SSSP builds its own weighted tables (no base engine).
            eng = build_workload_engine(
                "sssp", None, g,
                types.SimpleNamespace(lanes=spec.lanes, device=self.device,
                                      overlay=spec.overlay),
            )
        else:
            if spec.engine == "packed":
                from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine

                eng = PackedMsBfsEngine(g, lanes=spec.lanes, device=self.device)
            elif spec.engine == "hybrid":
                from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine

                eng = HybridMsBfsEngine(
                    g, lanes=spec.lanes, num_planes=spec.planes,
                    pull_gate=spec.pull_gate, device=self.device,
                )
            else:
                from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine

                eng = WidePackedMsBfsEngine(
                    g, lanes=spec.lanes, num_planes=spec.planes,
                    pull_gate=spec.pull_gate, overlay=spec.overlay,
                    device=self.device,
                )
            if spec.kind != "bfs":
                eng = build_workload_engine(spec.kind, eng, g, spec)
        self.builds += 1
        self.build_s[spec] = time.perf_counter() - t0
        self._log(f"engine built {spec} in {self.build_s[spec]:.1f}s")
        return eng

    def _warm_up(self, spec: EngineSpec, eng) -> None:
        """One full-width batch (the serving executor pads every batch to
        ``lanes``), then the engine's ``warm_residency`` hook (the p2p
        adapter's parent scanner), before the first real dispatch. Vertex
        0 always exists; its answer is discarded."""
        t0 = time.perf_counter()
        with _obs.maybe_span("engine_warm", f"w{spec.lanes}",
                             cat="serve.registry", width=spec.lanes,
                             engine=spec.engine):
            eng.run(np.zeros(eng.lanes, dtype=np.int64), time_it=False)
            warm = getattr(eng, "warm_residency", None)
            if warm is not None:
                warm()
        self.warm_s[spec] = time.perf_counter() - t0
        self._log(f"engine warmed {spec} in {self.warm_s[spec]:.1f}s")

    def rekey_generation(self, graph_key: str, generation: int) -> int:
        """Move every resident engine of ``graph_key`` onto the new
        ``graph_generation`` key WITHOUT a rebuild: a mutation flip swaps
        overlay table values under the same engine, so the residency
        survives and only its registry identity moves, atomically under
        the lock, in LRU order. In-flight batches keep their engine
        reference. Returns how many residencies moved."""
        moved = 0
        with self._lock:
            items = list(self._engines.items())
            self._engines.clear()
            for spec, eng in items:
                if spec.graph_key == graph_key and spec.graph_generation != generation:
                    spec = dataclasses.replace(spec, graph_generation=generation)
                    moved += 1
                self._engines[spec] = eng
            return moved

    def drop_graph_engines(self, graph_key: str) -> int:
        """Evict every resident engine of ``graph_key`` (the compaction
        path: a new base generation changes the ELL itself, unlike a
        flip). Returns the eviction count."""
        dropped = 0
        with self._lock:
            for spec in [s for s in self._engines if s.graph_key == graph_key]:
                self._engines.pop(spec)
                self.evictions += 1
                dropped += 1
                self._log(f"evicted engine {spec} (compaction)")
            return dropped

    def evict(self, spec: EngineSpec) -> bool:
        """Drop ``spec``'s engine (if resident) so its device tables can
        free; the OOM-degrade ladder calls this on the failed width before
        building a narrower one."""
        with self._lock:
            if self._engines.pop(spec, None) is None:
                return False
            self.evictions += 1
            self._log(f"evicted engine {spec} (explicit)")
            return True

    def resident(self) -> list | None:
        """Resident specs, least-recently-served first (for /statsz), or
        None when a build holds the registry lock right now (this read
        never blocks behind a build)."""
        if not self._lock.acquire(timeout=0.05):
            return None
        try:
            return list(self._engines)
        finally:
            self._lock.release()

    def resident_engines(self) -> list:
        """``(spec, engine)`` pairs, with :meth:`resident`'s non-blocking
        read (empty when a build holds the lock): the trace exporter
        walks them for ``last_run_trace`` level tracks."""
        if not self._lock.acquire(timeout=0.05):
            return []
        try:
            return list(self._engines.items())
        finally:
            self._lock.release()
