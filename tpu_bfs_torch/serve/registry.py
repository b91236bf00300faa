"""Warm-engine registry: graphs loaded once, engines built and warmed once,
the port of ``tpu_bfs/serve/registry.py``.

An engine build costs an ELL and tile build plus, on the card, the first
load of the CUDA kernel library; a server cannot pay that per query. The
wide and packed rungs of one graph share one host ELL (``_shared_ell``:
it does not depend on the lanes), so a ladder pays one ``build_ell``. The
registry keys resident engines by ``EngineSpec`` (graph, engine, lanes,
planes, pull gate, mesh span and exchange configuration, kind, graph
generation, overlay capacity, resume cadence), warms each build with one
full-width batch plus the engine's ``warm_residency`` hook, and bounds
residency with an LRU.

A mesh spec (``devices > 1``) builds its engine on the first ``devices``
ranks of the process's serving mesh (``parallel/mesh.serve_mesh``): every
rank builds its replica from the same command, and the registry keeps rank
0's handle (``parallel/mesh.Remote``). The 2D engine's serve adapter and
the k-hop and cc adapters run on rank 0 over such a handle, so their fault
sites are rank 0's as in JAX; the p2p adapter, which steps the base's
level loop on its device tables, is replicated with its base.

``aot_store`` (an ``utils.aot.ArtifactStore`` or a directory) turns
builds into adoptions where artifacts exist: the build still makes the
tables, then installs the store's loaded programs over the engine's eager
entries instead of tracing them (the ``--preheat`` path);
``export_resident`` fills a store from the resident engines (the
``--export-aot`` path). A mesh spec's engine exports and adopts on every
rank of its rung, each rank its own programs, through one command of the
mesh's stream (``parallel/mesh.MeshController.aot``); a mesh program
counts once in the store's counters, as JAX's one program does.
Construction resolves the kernel build cache
(``utils/compile_cache``) once per process, as JAX arms its compile cache.

Against JAX: no ``expand_impl`` axis (the port always runs its K1 kernel,
JAX's ``xla``/``pallas`` choice has no counterpart). The registry builds
every single-device engine on one torch ``device`` (None is CUDA), and a
mesh's ranks on the serving mesh's devices.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import types
from collections import OrderedDict

import numpy as np

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch import obs as _obs
from tpu_bfs_torch.utils.aot import ArtifactStore
from tpu_bfs_torch.utils.compile_cache import enable_compile_cache

ENGINE_KINDS = ("wide", "hybrid", "packed", "dist2d")

# The hybrid engine's serving widths come in whole 4096-lane steps, as in
# the JAX package (its dense kernel's quantum there).
HYBRID_LANE_QUANTUM = 4096

# Per-engine legal exchange families ("" = the engine's own default).
# Mesh-only: single-device engines run no exchange at all.
ENGINE_EXCHANGES = {
    "wide": ("", "dense", "sparse"),
    "hybrid": ("", "dense", "sparse", "sliced"),
    "dist2d": ("", "ring", "allreduce", "sparse"),
    "packed": ("",),
}

# Kind-specific mesh exchange families: sssp on a mesh runs the (min, +)
# delta-stepping engine (parallel/dist_sssp.py), whose value exchanges are
# ring/allreduce/sparse, not the wide family's OR row gathers.
KIND_EXCHANGES = {
    "sssp": ("", "ring", "allreduce", "sparse"),
}

# Serving engines default to 8 planes (254-level depth cap) where the
# one-shot CLI defaults to 5: one high-eccentricity query truncating a
# whole batch into errors costs more than the 3 extra planes.
DEFAULT_PLANES = 8


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
    from tpu_bfs_torch.parallel.mesh import square_shape

    return square_shape(devices)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One resident engine's identity: everything that changes its tables
    or the answers it computes. The mesh axes (``devices``, ``mesh_shape``)
    and the exchange configuration (``exchange``, ``wire_pack``,
    ``delta_bits``, ``sieve``, ``predict``) are key fields, so two configs
    never alias one resident engine. ``kind`` selects a workload adapter
    over the base engine (sssp builds its own weighted tables)."""

    graph_key: str
    engine: str = "wide"
    lanes: int = 512
    planes: int = DEFAULT_PLANES
    pull_gate: bool = False
    devices: int = 1
    kind: str = "bfs"
    #: The exchange family ("" = the engine's default): wide/hybrid row
    #: gathers (dense/sparse; hybrid also 'sliced'), the dist2d row
    #: exchange (ring/allreduce/sparse). Mesh engines only.
    exchange: str = ""
    #: The bit-packed wire (mesh engines).
    wire_pack: bool = False
    #: The planner's pieces (sparse exchanges only; sieve/predict are the
    #: 2D planner's, the row gathers take delta_bits alone).
    delta_bits: tuple = ()
    sieve: bool = False
    predict: bool = False
    #: Explicit (rows, cols) of the dist2d engine; () = most-square.
    mesh_shape: tuple = ()
    #: The served graph's version, bumped on every applied mutation batch.
    #: A key field (post-flip queries must never alias a pre-flip
    #: residency by key), but the registry REKEYS a resident engine across
    #: a flip (:meth:`EngineRegistry.rekey_generation`) instead of
    #: rebuilding it: only the overlay table values change.
    graph_generation: int = 0
    #: The delta-overlay capacity ``(rows, kcap)``; () is a static graph.
    #: The engine's fold runs over fixed-shape tables of this size.
    overlay: tuple = ()
    #: The level-checkpointed resume cadence K (dist2d only; 0 = off): a
    #: key field, so a resuming and a non-resuming service never alias one
    #: resident engine.
    resume_levels: int = 0

    def __post_init__(self):
        # A hashable, stable key whatever sequence the knobs came in.
        object.__setattr__(self, "delta_bits", tuple(self.delta_bits))
        object.__setattr__(self, "mesh_shape", tuple(self.mesh_shape))
        object.__setattr__(self, "overlay", tuple(int(x) for x in self.overlay))

    def validate(self) -> None:
        if self.engine not in ENGINE_KINDS:
            raise ValueError(
                f"engine must be one of {ENGINE_KINDS}, got {self.engine!r}"
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
        if self.engine == "packed" and self.devices > 1:
            raise ValueError("the packed engine is single-device")
        if self.engine == "dist2d" and self.devices < 2:
            raise ValueError(
                "the dist2d engine is the 2D-partition mesh path; "
                "use devices >= 2 (single-chip serving has no exchange "
                "to partition)"
            )
        if self.engine == "wide" and self.devices > 1 and self.pull_gate:
            raise ValueError(
                "pull_gate on a mesh runs through the distributed hybrid "
                "engine; use engine='hybrid' with devices > 1"
            )
        if self.engine == "dist2d" and self.pull_gate:
            raise ValueError(
                "pull_gate gates the packed MS engines' pull expansion; "
                "the 2D engine has no settled-mask machinery"
            )
        if self.devices == 1 and (
            self.exchange or self.wire_pack or self.delta_bits
            or self.sieve or self.predict
        ):
            raise ValueError(
                "exchange/wire_pack/delta_bits/sieve/predict shape the "
                "MESH exchanges; single-chip engines (devices=1) run none"
            )
        legal_exchanges = (
            KIND_EXCHANGES.get(self.kind, ENGINE_EXCHANGES[self.engine])
            if self.devices > 1 else ENGINE_EXCHANGES[self.engine]
        )
        if self.exchange not in legal_exchanges:
            raise ValueError(
                f"exchange {self.exchange!r} is not one of "
                f"{legal_exchanges} for engine {self.engine!r}"
                + (f" serving kind {self.kind!r}"
                   if self.kind in KIND_EXCHANGES and self.devices > 1
                   else "")
            )
        if self.delta_bits and self.exchange != "sparse":
            raise ValueError(
                "delta_bits compresses the SPARSE exchanges' id streams; "
                f"set exchange='sparse' (got {self.exchange!r})"
            )
        if (self.sieve or self.predict) and not (
            (self.engine == "dist2d" and self.exchange == "sparse")
            or (self.kind == "sssp" and self.devices > 1
                and self.exchange == "sparse" and not self.sieve)
        ):
            raise ValueError(
                "sieve/predict are the exchange planner's pieces; on the "
                "serve tier they apply to engine='dist2d' with "
                "exchange='sparse', plus predict (alone — min carries no "
                "sieve residue to compact) on the distributed sssp "
                "engine's sparse exchange (the MS row gathers take "
                "delta_bits only)"
            )
        if self.mesh_shape:
            if self.engine != "dist2d" and not (
                self.kind == "sssp" and self.devices > 1
            ):
                raise ValueError(
                    "mesh_shape picks a 2D (rows, cols) partition — the "
                    "dist2d engine's, or the distributed sssp engine's "
                    f"(kind='sssp', devices > 1); engine {self.engine!r} "
                    "runs a 1D mesh"
                )
            mesh_shape_2d(self.devices, self.mesh_shape)  # raises on mismatch
            if self.kind == "sssp" and self.exchange not in ("", "allreduce"):
                raise ValueError(
                    "the 2D distributed sssp engine exchanges "
                    "hierarchically (pmin over both axes) — exchange must "
                    f"be '' or 'allreduce', got {self.exchange!r}"
                )
        if self.resume_levels < 0:
            raise ValueError(
                f"resume_levels must be >= 0, got {self.resume_levels}"
            )
        if self.resume_levels and self.engine != "dist2d":
            raise ValueError(
                "resume_levels drives the dist2d serve adapter's chunked "
                "level loop (one single-source loop per unique lane); the "
                "packed MS engines answer a whole batch in one fused loop "
                "with no per-query carry to snapshot — a mesh fault there "
                "re-traverses the batch on the degraded mesh instead"
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
            if (self.devices > 1 and self.kind == "sssp"
                    and self.wire_pack):
                raise ValueError(
                    "wire_pack packs the OR exchanges' frontier words; "
                    "the distributed sssp engine ships int32 distance "
                    "rows (delta_bits compresses its id stream instead)"
                )
            if self.kind in ("p2p", "sssp") and self.pull_gate:
                raise ValueError(
                    f"kind {self.kind!r} does not compose with pull_gate "
                    "(p2p steps the resumable core level by level under "
                    "its own lane pairing; sssp runs min-plus tiles with "
                    "no settled-mask machinery)"
                )


def _mesh_sites(spec: EngineSpec) -> dict:
    """The fault sites a mesh engine's calls visit, consulted on rank 0
    before each call is posted (``parallel/mesh.Remote``): the packed
    engines' dispatch and fetch, or SSSP's."""
    if spec.kind == "sssp":
        d, f = ("sssp_dispatch", {"lanes": spec.lanes}), ("sssp_fetch", {"lanes": spec.lanes})
    elif spec.kind in ("bfs", "khop", "cc") and spec.engine in ("wide", "hybrid"):
        ctx = {"lanes": spec.lanes, "devices": spec.devices}
        d, f = ("dispatch", ctx), ("fetch", ctx)
    else:
        return {}
    return {"dispatch": [d], "fetch": [f], "run": [d, f]}


def build_mesh_engine(rank, graph, spec: EngineSpec):
    """One rank's replica of a mesh spec's engine (run on each of the
    first ``spec.devices`` ranks of the serving mesh; ``rank`` is its
    ``parallel/mesh.RankContext``): the distributed engine of the spec's
    engine family, or of its kind (SSSP; p2p over its base). The 2D engine
    is the bare ``Dist2DBfsEngine``: its serve adapter runs on rank 0."""
    d = spec.devices
    if spec.kind == "sssp":
        from tpu_bfs_torch.workloads import build_workload_engine

        mesh = (rank.mesh_2d(*mesh_shape_2d(d, spec.mesh_shape)) if spec.mesh_shape
                else rank.mesh(d))
        return build_workload_engine("sssp", None, graph, types.SimpleNamespace(
            lanes=spec.lanes, devices=d, mesh=mesh, mesh_shape=spec.mesh_shape,
            exchange=spec.exchange, delta_bits=spec.delta_bits, predict=spec.predict))
    if spec.engine == "dist2d":
        from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine

        return Dist2DBfsEngine(
            graph, rank.mesh_2d(*mesh_shape_2d(d, spec.mesh_shape)),
            exchange=spec.exchange or "ring", backend="dopt", wire_pack=spec.wire_pack,
            delta_bits=spec.delta_bits, sieve=spec.sieve, predict=spec.predict)
    if spec.engine == "wide":
        from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

        eng = DistWideMsBfsEngine(
            graph, rank.mesh(d), num_planes=spec.planes, lanes=spec.lanes,
            exchange=spec.exchange or "dense", wire_pack=spec.wire_pack,
            delta_bits=spec.delta_bits)
    else:
        from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine

        eng = DistHybridMsBfsEngine(
            graph, rank.mesh(d), num_planes=spec.planes, lanes=spec.lanes,
            pull_gate=spec.pull_gate, exchange=spec.exchange or "dense",
            wire_pack=spec.wire_pack, delta_bits=spec.delta_bits)
    if spec.kind == "p2p":
        # p2p steps the base's level loop on its own device tables, so
        # every rank runs its adapter (k-hop and cc run on rank 0).
        from tpu_bfs_torch.workloads import build_workload_engine

        return build_workload_engine(spec.kind, eng, graph, spec)
    return eng


class EngineRegistry:
    """LRU-bounded store of warmed engines over once-loaded graphs: the
    single-device ones on one torch ``device`` (None: CUDA, raising without
    a card), the mesh ones on the serving mesh. ``aot_store`` (a store or a
    path) adopts single-device engines' programs from artifacts."""

    def __init__(self, *, capacity: int = 4, warm: bool = True, log=None,
                 device=None, aot_store=None):
        if capacity < 1:
            raise ValueError(f"registry capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = device
        self._warm = warm
        self._log = log or (lambda msg: None)
        if isinstance(aot_store, (str, os.PathLike)):
            aot_store = ArtifactStore(aot_store, log=self._log)
        self.aot_store = aot_store
        self._graphs: dict = {}  # guarded-by: _lock
        # graph key -> (graph, its build_ell): one ELL for the wide and
        # packed rungs of a graph (it does not depend on the lanes).
        self._ells: dict = {}  # guarded-by: _lock
        self._engines: OrderedDict = OrderedDict()  # guarded-by: _lock
        # One build at a time (builds allocate device tables); RLock so
        # get() -> _build() -> graph() nests.
        self._lock = threading.RLock()
        self.builds = 0  # guarded-by: _lock
        self.adoptions = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        # Seconds of each spec's last build (its tables), adoption (loading
        # its programs from the store) and warm-up.
        self.build_s: dict = {}  # guarded-by: _lock
        self.adopt_s: dict = {}  # guarded-by: _lock
        self.warm_s: dict = {}  # guarded-by: _lock
        enable_compile_cache(log=self._log)

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
                self._forget_ell(old_spec.graph_key)
                self._log(f"evicted engine {old_spec}")
            return eng

    def _build(self, spec: EngineSpec):  # requires-lock: _lock
        rec = _obs.ACTIVE
        store = self.aot_store
        # The span says what the build costs: a spec whose core artifact
        # probes valid (on every rank of a mesh spec) is an engine_adopt
        # (tables, then installed programs, no trace); only a from-scratch
        # build is an engine_build.
        adopting = store is not None and store.probe(spec, mesh=self._mesh_fingerprint(spec))
        span = "engine_adopt" if adopting else "engine_build"
        if rec is not None:
            rec.begin(span, f"w{spec.lanes}", cat="serve.registry",
                      engine=spec.engine, width=spec.lanes,
                      planes=spec.planes, devices=spec.devices)
        adopted: list = []
        try:
            eng = self._build_inner(spec)
            if store is not None:
                from tpu_bfs_torch.utils.aot import adopt_engine_programs

                t0 = time.perf_counter()
                adopted = adopt_engine_programs(eng, spec, store, log=self._log)
                self.adopt_s[spec] = time.perf_counter() - t0
                if adopted:
                    self.adoptions += 1
                elif adopting:
                    # The probe said adoptable but nothing was installed
                    # (unloadable here, or quarantined meanwhile): flag it,
                    # or the engine_adopt span would read as a phantom.
                    self._log(f"aot adoption of {spec} installed nothing; "
                              "this build runs the eager programs")
                    if rec is not None:
                        rec.event("aot_adopt_failed", cat="serve.registry",
                                  width=spec.lanes, engine=spec.engine)
        except Exception as exc:
            if rec is not None:
                rec.end(span, f"w{spec.lanes}",
                        cat="serve.registry", width=spec.lanes,
                        error=f"{type(exc).__name__}: {str(exc)[:120]}")
            raise
        if rec is not None:
            rec.end(span, f"w{spec.lanes}", cat="serve.registry",
                    width=spec.lanes, adopted=len(adopted))
        return eng

    @staticmethod
    def _mesh_fingerprint(spec: EngineSpec) -> dict | None:
        """The serving mesh's part of a mesh spec's artifact fingerprint
        (``utils/aot.mesh_fingerprint``: its backend and device type), None
        on one device or with no serving mesh yet."""
        if spec.devices <= 1:
            return None
        from tpu_bfs_torch.parallel.mesh import active_controller

        ctl = active_controller()
        if ctl is None:
            return None
        return {"backend": ctl.backend, "device": ctl.device.type}

    def _build_inner(self, spec: EngineSpec):  # requires-lock: _lock
        if _faults.ACTIVE is not None:
            # A transient raised here runs the service's engine-build
            # retry; an OOM runs the width degrade.
            _faults.ACTIVE.hit("engine_build", lanes=spec.lanes)
        g = self.graph(spec.graph_key)
        t0 = time.perf_counter()
        from tpu_bfs_torch.workloads import build_workload_engine

        if spec.devices > 1:
            eng = self._build_mesh(spec, g)
        elif spec.kind == "sssp":
            # SSSP builds its own weighted tables (no base engine).
            eng = build_workload_engine(
                "sssp", None, g,
                types.SimpleNamespace(lanes=spec.lanes, device=self.device,
                                      overlay=spec.overlay),
            )
        else:
            if spec.engine == "packed":
                from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine

                eng = PackedMsBfsEngine(g, lanes=spec.lanes, device=self.device,
                                        ell=self._shared_ell(spec.graph_key, g))
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
                    ell=self._shared_ell(spec.graph_key, g), device=self.device,
                )
            if spec.kind != "bfs":
                eng = build_workload_engine(spec.kind, eng, g, spec)
        self.builds += 1
        self.build_s[spec] = time.perf_counter() - t0
        self._log(f"engine built {spec} in {self.build_s[spec]:.1f}s")
        return eng

    def _shared_ell(self, key: str, g):  # requires-lock: _lock
        """The wide and packed rungs' one ``build_ell`` of the graph under
        ``key``, rebuilt when the key names another graph object (a
        compaction's new base)."""
        hit = self._ells.get(key)
        if hit is None or hit[0] is not g:
            from tpu_bfs_torch.graph.ell import build_ell

            hit = self._ells[key] = (g, build_ell(g))
        return hit[1]

    def _forget_ell(self, key: str) -> None:  # requires-lock: _lock
        """Drop the shared host ELL of ``key`` once no resident engine of
        that graph is left (an evicted ladder frees its host tables too)."""
        if not any(s.graph_key == key for s in self._engines):
            self._ells.pop(key, None)

    def _build_mesh(self, spec: EngineSpec, g):  # requires-lock: _lock
        """A mesh spec's engine on the first ``spec.devices`` ranks of the
        process's serving mesh (``BfsService.start`` or an explicit
        ``serve_mesh`` starts it and owns its life): the replicated
        engine's rank-0 handle, with the 2D serve adapter or the k-hop or
        cc adapter on rank 0 over it."""
        from tpu_bfs_torch.parallel.mesh import active_controller

        ctl = active_controller()
        if ctl is None:
            raise RuntimeError(
                f"a {spec.devices}-device engine needs the process's serving mesh: "
                f"start one with parallel.mesh.serve_mesh (BfsService.start does)")
        ctl.ensure_rung(spec.devices)
        if spec.engine == "dist2d" or spec.mesh_shape:
            ctl.ensure_2d(*mesh_shape_2d(spec.devices, spec.mesh_shape))
        eng = ctl.build(spec.devices, build_mesh_engine, ctl.share(g), spec,
                        sites=_mesh_sites(spec))
        if spec.engine == "dist2d" and spec.kind != "sssp":
            from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DServeEngine

            eng = Dist2DServeEngine(g, eng, lanes=spec.lanes,
                                    resume_levels=spec.resume_levels)
        if spec.kind in ("khop", "cc"):
            from tpu_bfs_torch.workloads import build_workload_engine

            eng = build_workload_engine(spec.kind, eng, g, spec)
        return eng

    def _warm_up(self, spec: EngineSpec, eng) -> None:  # requires-lock: _lock
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
            self._ells.pop(graph_key, None)
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
            self._forget_ell(spec.graph_key)
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

    def export_resident(self, store=None) -> dict:
        """Export every resident engine's serving programs into ``store``
        (default: the registry's own): the ``--export-aot`` path, a warmed
        server filling the store a successor preheats from. Returns
        ``{spec: [exported names]}``."""
        from tpu_bfs_torch.utils.aot import export_engine_programs

        if isinstance(store, (str, os.PathLike)):
            store = ArtifactStore(store, log=self._log)
        store = store or self.aot_store
        if store is None:
            raise ValueError(
                "export_resident needs an artifact store (construct the "
                "registry with aot_store=... or pass one here)"
            )
        out = {}
        for spec, eng in self.resident_engines():
            names = export_engine_programs(eng, spec, store, log=self._log)
            self._log(f"aot export {spec.engine}/w{spec.lanes}: "
                      f"{len(names)} programs -> {store.root}")
            out[spec] = names
        return out
