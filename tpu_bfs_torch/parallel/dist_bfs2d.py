"""Single-source BFS over an R x C mesh with 2D edge partitioning, the port
of ``Dist2DBfsEngine`` in ``tpu_bfs/parallel/dist_bfs2d.py``.

The scale-out path the reference lacks (its only distribution replicates
the CSR on every card and partitions ownership 1D, bfs.cu:29-32, 346-351).
A level, on every rank (``parallel/partition2d.py`` lays out the edges):

    column all-gather ('r')  ->  local expansion  ->
    row OR-reduce-scatter ('c')  ->  claim of the owned slice  ->
    termination sum over the whole mesh

The claim of the owned slice is a fixed-shape rank-local program between
the row exchange and the column all-gather (``dist_core``, the engine's AOT
inventory, ``utils/aot.py``); the exchanges, the sparse rung and the
direction choice of ``backend='dopt'`` stay in the host loop.

Both exchanges move O(vp / mesh dimension) per rank, against the 1D
exchange's O(vp). The level loop runs on the host, one host read a level,
as in ``dist_bfs.py``; the column all-gather of a level's new frontier
runs before that read, so that the read also carries the rank's column
frontier size and out-degree sum for ``backend='dopt'`` (a last gather of
the empty frontier is the price). With ``exchange='sparse'`` the row
exchange is the queue-style id exchange over the mesh row: each mesh row
picks its rung from a MAX over its own ranks, so rows may take different
rungs at one level, and the branch recorded for the level is the MAX over
the mesh column, as in JAX. The planner's knobs are ``DistBfsEngine``'s, on
the row exchange: its values are MAX-reduced over the mesh row only, so
rows may take different branches, each on its own subgroup; ``wire_pack``
also packs the column all-gather.

``Dist2DServeEngine`` is the serve tier's adapter (JAX's, at
``tpu_bfs/parallel/dist_bfs2d.py:652``): one loop per unique source of a
padded batch, and, with ``resume_levels=K``, the level loop driven K
levels a chunk with a real-id snapshot at each boundary
(``resilience/resume.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch.algorithms.frontier import (
    INT32_MAX,
    expand_or,
)
from tpu_bfs_torch.graph.csr import INF_DIST, Graph
from tpu_bfs_torch.obs.engine_trace import DistTraceHost, LevelRecord
from tpu_bfs_torch.parallel.collectives import (
    column_gather_wire_bytes,
    pack_bits,
    reduce_scatter_min,
    unpack_bits,
)
from tpu_bfs_torch.parallel.dist_bfs import (
    PlannedExchange,
    PlannerCarry,
    VertexCheckpointMixin,
    _put,
    check_engine_args,
    claim_step,
)
from tpu_bfs_torch.parallel.dist_msbfs_wide import MeshAotHost
from tpu_bfs_torch.parallel.mesh import Mesh2D, make_mesh_2d
from tpu_bfs_torch.parallel.partition2d import out_csr_2d_rank, partition_2d_rank
from tpu_bfs_torch.utils.aot import AotProgramProtocol, ArgSpec


def partition_shard_2d(graph: Graph, mesh: Mesh2D):
    """This rank's (partition, src_gidx, dst_l, rp) of ``graph`` on ``mesh``."""
    return partition_2d_rank(graph, mesh.rows, mesh.cols, mesh.r.rank, mesh.c.rank)


class Dist2DBfsEngine(MeshAotHost, AotProgramProtocol, PlannedExchange, VertexCheckpointMixin,
                      DistTraceHost):
    """BFS over an R x C mesh (a :class:`~tpu_bfs_torch.parallel.mesh.Mesh2D`,
    default ``make_mesh_2d(1, 1)``) with 2D edge
    partitioning; the API of ``DistBfsEngine``. ``exchange`` is the row
    exchange ('ring', 'allreduce' or 'sparse'); ``backend`` and the
    planner's knobs as there.

    A rank holds its [w] slice of the padded id space, its edge shard with
    its [C*w + 1] row pointer, and a level's [R*w] column frontier and
    [C*w] row contribution. ``shard`` is this rank's
    :func:`partition_shard_2d`, shared by engines over one graph."""

    def __init__(self, graph: Graph, mesh: Mesh2D | None = None, *, exchange: str = "ring",
                 backend: str = "scan", dopt_caps=None, wire_pack: bool = False, sparse_caps=None, delta_bits=(),
                 sieve: bool = False, predict: bool = False, device=None, shard=None):
        check_engine_args(exchange, backend, " for the 2D engine",
                          planner=bool(delta_bits or sieve or predict), row="row ")
        if mesh is None:
            mesh = make_mesh_2d(1, 1, device=device)
        if not isinstance(mesh, Mesh2D):
            raise ValueError("2D engine needs a mesh with axes ('r', 'c')")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
        self.mesh, self.device = mesh, mesh.device
        self.rows, self.cols = mesh.rows, mesh.cols
        self._exchange, self.backend = exchange, backend
        self._degrees, self._undirected = graph.degrees, graph.undirected
        if shard is None:
            shard = partition_shard_2d(graph, mesh)
        part, src_g, dst_l, rp = shard
        self.part = part
        self.src_g, self.dst_l, self.rp = (_put(a, self.device) for a in (src_g, dst_l, rp))
        w = part.w
        row_block, col_block = self.cols * w, self.rows * w
        dopt = backend == "dopt"
        dense_backend = "scan" if dopt else backend

        def dense(col_frontier):
            active = col_frontier.index_select(0, self.src_g)
            return expand_or(active, self.dst_l, self.rp, row_block, backend=dense_backend)

        self._expand = dense
        self.dopt_caps = ()
        if dopt:
            self._expand = self._dopt_expand(
                self.src_g, self.dst_l, out_csr_2d_rank(part, src_g, dst_l), dopt_caps,
                part.ep2, vert_limit=col_block, out_size=row_block, dense_fn=dense)
        self._set_planner(wire_pack, delta_bits, sieve, predict, sparse_caps, w)
        if exchange != "sparse":
            self.sparse_caps = ()  # the 2D engine keeps no ladder then, as in JAX
        # The parent merge rides the ring when the level exchange is sparse.
        self._parent_impl = "ring" if exchange == "sparse" else exchange
        self.last_host_syncs = 0
        self._warmed = False
        self._dist_core = self._claim_step
        self._level_t = torch.zeros((), dtype=torch.int32, device=self.device)

    # --- the rank-local program (the AOT inventory) ---------------------------

    @property
    def _aot_world(self):
        return self.mesh.world

    def _aot_layout_of(self) -> dict:
        return {"w": int(self.part.w), "vp": int(self.part.vp), "rows": self.rows,
                "cols": self.cols}

    def _aot_programs(self):
        """The AOT inventory, JAX's name: ``dist_core``, the claim of this
        rank's [w] slice (:meth:`_claim_step`)."""
        w, dev = self.part.w, self.device
        flag = ArgSpec((w,), torch.bool, dev)
        fn = getattr(self._dist_core, "_aot_original", self._dist_core)
        return [("dist_core", "_dist_core", fn,
                 (flag, flag, ArgSpec((w,), torch.int32, dev), ArgSpec((), torch.int32, dev)))]

    @staticmethod
    def _claim_step(hit, visited, dist, level):
        """The claim of the owned slice: ``new = hit & ~visited`` labeled
        ``level`` (a 0-d device int32) in ``dist`` and ORed into ``visited``
        (both in place). Returns ``(new, count)``, ``count`` the [1] int32
        new-frontier size for the host's all-reduce."""
        return claim_step(hit, visited, dist, level)

    def wire_bytes_per_level(self) -> list[float]:
        """Modeled bytes one rank moves a level, per row-exchange branch,
        each with the column all-gather that runs on every branch. When
        mesh rows split at a level, the recorded branch is the row MAX, so
        the priced bytes are one representative, as in JAX."""
        w = self.part.w
        ag = column_gather_wire_bytes(self.rows, w, wire_pack=self.wire_pack)
        return [ag + x for x in self._exchange_model(self.cols, w)]

    def _gather_col(self, new: torch.Tensor) -> torch.Tensor:
        """The [R*w] column frontier: every mesh-column rank's [w] slice
        (as 32-bit words with ``wire_pack`` on more than one row)."""
        if self.wire_pack and self.rows > 1:
            gw = self.mesh.r.all_gather_rows(pack_bits(new)[None])  # [R, ceil(w/32)]
            return unpack_bits(gw, new.shape[0]).reshape(-1)
        return self.mesh.r.all_gather_rows(new)

    def _first(self, nfront: int, col_own: np.ndarray) -> tuple:
        """The global frontier count and, for 'dopt', this rank's column
        frontier size and out-degree sum (``col_own``: its set gather
        indices on the host)."""
        if self.backend != "dopt":
            return (nfront,)
        rp = self._out_rp_host
        return (nfront, len(col_own), int((rp[col_own + 1] - rp[col_own]).sum()))

    def _loop(self, frontier, visited, dist, col_frontier, level0: int, max_levels: int,
              first, vis_total: int):
        """The host level loop from this rank's [w] slices and its [R*w]
        column frontier; ``vis_total`` is the mesh's visited count.
        Returns the frontier, the level and the per-branch level counts;
        ``visited`` and ``dist`` change in place."""
        mesh, dopt = self.mesh, self.backend == "dopt"
        sparse = self._exchange == "sparse"
        counts = np.zeros(self._nb, dtype=np.int32)
        level, count, info = level0, first[0], first[1:]
        syncs = 0
        # The sieve prices against this row's [C*w] chunks: the mesh's
        # visited total scaled down by the row count, as in JAX.
        plan = PlannerCarry(vis_total)
        trace = LevelRecord(level0)
        while count > 0 and level < max_levels:
            contrib = self._expand(col_frontier, *info)
            hit, branch, reads = self._exchange_step(contrib, mesh.c, visited, plan, count,
                                                     self.rows)
            # Read anew each level: an adopted dist_core takes over.
            new, nnew = self._dist_core(hit, visited, dist, self._level_t.fill_(level + 1))
            frontier = new
            col_frontier = self._gather_col(new)
            parts = [mesh.world.all_reduce_(nnew, "sum")]
            if dopt:
                parts.append(self._expand.sums(col_frontier))
            if sparse:
                parts.append(mesh.r.all_reduce_(
                    torch.full((1,), branch, dtype=torch.int32, device=self.device), "max"))
            vals = torch.cat(parts).tolist()
            front = count
            count, info = vals[0], vals[1:3] if dopt else ()
            recorded = vals[-1] if sparse else 0  # the row MAX when rows split
            counts[recorded] += 1
            trace.add(level, count, recorded)
            level += 1
            plan.advance(front, count)
            syncs += 1 + reads
        self.last_host_syncs = syncs
        self._record_trace(trace, level - level0)
        return frontier, level, counts

    def _fresh_state(self, source: int):
        """This rank's level-0 slices and column frontier, made on the
        device, and the first host values."""
        part, w, dev = self.part, self.part.w, self.device
        frontier = torch.zeros(w, dtype=torch.bool, device=dev)
        dist = torch.full((w,), INT32_MAX, dtype=torch.int32, device=dev)
        col_frontier = torch.zeros(self.rows * w, dtype=torch.bool, device=dev)
        pid = int(part.to_padded(source))
        si, sj = divmod(pid // w, self.cols)
        if pid // w == self.mesh.world.rank:
            frontier[pid % w] = True
            dist[pid % w] = 0
        col_own = np.zeros(0, dtype=np.int64)
        if sj == self.mesh.c.rank:
            col_own = np.asarray([si * w + pid % w])
            col_frontier[col_own[0]] = True
        return frontier, frontier.clone(), dist, col_frontier, self._first(1, col_own)

    def distances_padded(self, source: int, *, max_levels: int | None = None):
        """This rank's [w] distance slice (on the device) and the level."""
        frontier, visited, dist, col_frontier, first = self._fresh_state(source)
        ml = max_levels if max_levels is not None else self.part.vp
        _, level, counts = self._loop(frontier, visited, dist, col_frontier, 0, ml, first, 1)
        self._record_exchange(counts)
        return dist, level

    def _advance_loop(self, f0, vis0, d0, level0: int, cap: int, *, chain_nonce=None):
        w, j = self.part.w, self.mesh.c.rank
        col_host = np.concatenate([f0[(i * self.cols + j) * w : (i * self.cols + j + 1) * w]
                                   for i in range(self.rows)])
        frontier, visited, dist = self._local(f0), self._local(vis0), self._local(d0)
        frontier, level, counts = self._loop(
            frontier, visited, dist, _put(col_host, self.device), level0, cap,
            self._first(int(f0.sum()), np.flatnonzero(col_host)), int(vis0.sum()))
        self._record_exchange(counts, resumed_level=level0, chain_nonce=chain_nonce)
        return frontier, visited, dist, level

    def serve_runs(self, sources, max_levels: int) -> "Runs2D":
        """One level loop from each of ``sources`` (the serve adapter's
        unique sources), to ``max_levels`` at most; every rank keeps its
        distance slices in the returned :class:`Runs2D`, whose per-run
        summaries are reduced over the mesh here. ``last_exchange_bytes``
        ends as the sum over the runs."""
        world = self.mesh.world
        if getattr(self, "_deg_loc", None) is None:
            part = self.part
            deg_pad = np.zeros(part.vp, dtype=np.int64)
            deg_pad[part.to_padded(np.arange(part.num_vertices))] = self._degrees
            self._deg_loc = self._local(deg_pad)
        dists, wire = [], 0.0
        sums = torch.zeros((max(len(sources), 1), 2), dtype=torch.int64, device=self.device)
        ecc = torch.zeros(max(len(sources), 1), dtype=torch.int64, device=self.device)
        for u, s in enumerate(sources):
            frontier, visited, dist, col_frontier, first = self._fresh_state(int(s))
            _, _, counts = self._loop(frontier, visited, dist, col_frontier, 0, max_levels,
                                      first, 1)
            self._record_exchange(counts)
            wire += float(self.last_exchange_bytes or 0.0)
            dists.append(dist)
            # Padded phantoms are never reached, so the sums over the
            # padded slice are the real-vertex figures.
            fin = dist != INT32_MAX
            sums[u, 0] = fin.sum()
            sums[u, 1] = self._deg_loc[fin].sum()
            ecc[u] = torch.where(fin, dist, 0).max().long()
        world.all_reduce_(sums, "sum")
        world.all_reduce_(ecc, "max")
        self.last_exchange_bytes = wire
        n = len(sources)
        sums_h, ecc_h = sums.cpu().numpy()[:n], ecc.cpu().numpy()[:n]
        return Runs2D(self, dists, reached=sums_h[:, 0].astype(np.int64),
                      ecc=ecc_h.astype(np.int32), slots=sums_h[:, 1].astype(np.int64))

    def _parents_loc(self, dist_loc: torch.Tensor) -> torch.Tensor:
        """This rank's parent slice: the distances all-gathered over the
        mesh, the min candidate of the rank's edges scattered into its row
        block, and a MIN reduce-scatter over the mesh row."""
        w, cols = self.part.w, self.cols
        i, j = self.mesh.r.rank, self.mesh.c.rank
        dist_full = self.mesh.world.all_gather_rows(dist_loc)
        # Global padded ids from the gather indices and the row-block-local dst.
        src = ((self.src_g // w) * cols + j) * w + self.src_g % w
        dst = i * cols * w + self.dst_l
        du = dist_full.index_select(0, src)
        ok = (du != INT32_MAX) & (du + 1 == dist_full.index_select(0, dst))
        cand = torch.where(ok, src, INT32_MAX)
        contrib = torch.full((cols * w,), INT32_MAX, dtype=torch.int32, device=self.device)
        contrib.scatter_reduce_(0, self.dst_l.long(), cand, "amin")
        parent = reduce_scatter_min(contrib, self.mesh.c, impl=self._parent_impl)
        parent = torch.where(parent == INT32_MAX, -1, parent)
        return torch.where(dist_loc == INT32_MAX, -1, parent)


# --- the serve adapter ----------------------------------------------------


class Runs2D:
    """Every rank's distance slices of one batch's unique runs, with their
    mesh-reduced summaries (``reached``, ``ecc``, the degree-slot sum
    ``slots``); :meth:`unshard` gathers one run's row."""

    def __init__(self, engine: Dist2DBfsEngine, slices, *, reached, ecc, slots):
        self._engine = engine
        self._slices = slices
        self.reached, self.ecc, self.slots = reached, ecc, slots

    def unshard(self, u: int) -> np.ndarray:
        """[V] int32 distances of run ``u`` (INF_DIST unreached), gathered
        over the mesh."""
        eng = self._engine
        return eng.part.unshard(eng._gather_vec(self._slices[u])).astype(np.int32)


@dataclasses.dataclass
class _Pending2D:
    """A dispatched 2D serving batch: the lane -> unique-run map, and either
    the unique runs (:class:`Runs2D`) or, with resume armed, each run's
    latest chunk (a real-id checkpoint) and its cursor."""

    sources: np.ndarray  # [S] the padded lane sources
    uniq: np.ndarray  # [U] unique sources
    inv: np.ndarray  # [S] lane -> unique-run index
    runs: object = None  # Runs2D (no resume)
    chunks: list | None = None  # per-unique BfsCheckpoint (resume)
    cursors: list | None = None  # per-unique chunk state (resume)
    total_cap: int = 0  # absolute level cap of the whole query


class Dist2DServeResult:
    """The serve protocol's result over the unique runs: lane-mapped
    ``reached``/``ecc``/``edges_traversed``, and each unique run's row
    fetched (unsharded) once, when a lane of it is asked for."""

    def __init__(self, rows, inv, sources, reached, ecc, edges):
        self._rows = rows  # u -> [V] int32 (a Runs2D's unshard, or host rows)
        self._inv = inv
        self.sources = sources
        self.reached = reached  # [S] int64
        self.ecc = ecc  # [S] int32
        self.edges_traversed = edges  # [S] int64
        self._cache: dict = {}

    def _dist_of(self, u: int) -> np.ndarray:
        d = self._cache.get(u)
        if d is None:
            d = self._cache[u] = self._rows(u)
        return d

    def distances_int32(self, i: int) -> np.ndarray:
        """[V] int32 distances of lane ``i`` (INF_DIST unreached)."""
        if not (0 <= i < len(self.sources)):
            raise IndexError(i)
        return self._dist_of(int(self._inv[i]))


class Dist2DServeEngine:
    """The 2D engine behind the serve executor's batch protocol. A batch
    becomes one level loop per UNIQUE source (the executor pads a partial
    batch by repeating a real source, so 3 queries padded to 32 lanes run 3
    loops); ``fetch`` assembles a result whose lanes index the unique runs.

    ``resume_levels=K`` arms level-checkpointed resume: each run advances
    K levels a chunk (``advance``) and its state is snapshotted at each
    boundary into the process-wide per-graph resume cache, so a later
    dispatch of the same source (the service's re-admission after a mesh
    fault, on an engine over the degraded mesh) starts from the last
    snapshot; a completed run drops its snapshot.

    ``engine`` is the ``Dist2DBfsEngine`` over ``graph``: the serve tier
    passes the handle of one replicated on every rank of a mesh
    controller's rung (``parallel/mesh.Remote``), and this adapter then
    runs on rank 0 alone, each collective step a command of the stream. Its
    fault sites are consulted here, between the commands, as JAX consults
    them."""

    def __init__(self, graph: Graph, engine, *, lanes: int = 32, resume_levels: int = 0):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if resume_levels < 0:
            raise ValueError(f"resume_levels must be >= 0, got {resume_levels}")
        self.lanes = int(lanes)
        self.resume_levels = int(resume_levels)
        if resume_levels:
            from tpu_bfs_torch.resilience.resume import ResumePolicy, cache_for_graph

            self._resume = ResumePolicy(every_levels=int(resume_levels))
            self._resume_cache = cache_for_graph(graph)
        else:
            self._resume = None
            self._resume_cache = None
        self.engine = engine
        self.device = engine.device
        self._num_vertices = graph.num_vertices
        self._undirected = graph.undirected
        self._degrees = np.asarray(graph.degrees, dtype=np.int64)
        #: Modeled bytes one rank moved for the last fetched batch (summed
        #: over its unique runs): the serve tier's wire-bytes record.
        self.last_exchange_bytes: float | None = None

    # --- passthroughs the serve and obs layers read ----------------------

    @property
    def mesh(self):
        return self.engine.mesh

    @property
    def num_vertices(self) -> int:
        return self._num_vertices

    @property
    def max_levels_cap(self) -> int:
        """The deepest level bound of a dispatch: the padded vertex count
        (the 2D loop labels int32 distances, with no plane cap)."""
        return int(self.engine.part.vp)

    @property
    def last_run_trace(self):
        return self.engine.last_run_trace

    @property
    def aot_engine(self):
        """The engine whose ``dist_core`` serves this adapter (``utils/aot``
        exports and adopts it, on every rank when it is a mesh handle)."""
        return self.engine

    @property
    def _aot_adopted(self):
        return getattr(self.engine, "_aot_adopted", ())

    def export_programs(self):
        return self.engine.export_programs()

    def adopt_programs(self, programs: dict) -> list:
        return self.engine.adopt_programs(programs)

    def exchange_branch_labels(self):
        return self.engine.exchange_branch_labels()

    def wire_bytes_per_level(self):
        return self.engine.wire_bytes_per_level()

    # --- dispatch / fetch -------------------------------------------------

    @property
    def _devices_n(self) -> int:
        return _faults.mesh_devices(self)

    def dispatch(self, sources, *, max_levels: int | None = None) -> _Pending2D:
        if _faults.ACTIVE is not None:
            # The mesh kinds target this engine's launches; ``devices``
            # feeds the rank qualifiers.
            _faults.ACTIVE.hit("dispatch", lanes=self.lanes, devices=self._devices_n)
        sources = np.asarray(sources, dtype=np.int64)
        if len(sources) > self.lanes:
            raise ValueError(f"batch of {len(sources)} exceeds {self.lanes} lanes")
        nv = self.num_vertices
        if sources.size and (sources.min() < 0 or sources.max() >= nv):
            raise ValueError(f"source out of range [0, {nv})")
        uniq, inv = np.unique(sources, return_inverse=True)
        total_cap = int(max_levels if max_levels is not None else self.max_levels_cap)
        if self._resume is None:
            runs = self.engine.serve_runs(uniq, total_cap)
            return _Pending2D(sources=sources, uniq=uniq, inv=inv, runs=runs,
                              total_cap=total_cap)
        # Resume: each run's first chunk (K levels) now, the rest in fetch.
        # A source with an intact snapshot (left by a mesh-faulted engine
        # over the same graph) starts from its last snapshotted level.
        from tpu_bfs_torch.utils.checkpoint import initial_checkpoint

        k = self._resume.every_levels
        chunks, cursors = [], []
        for s in uniq:
            s = int(s)
            state = self._resume_cache.get(s)
            if (state is not None and state.source == s and len(state.frontier) == nv
                    # A snapshot deeper than this call's cap cannot be
                    # adopted: the capped loop would return levels beyond
                    # the requested bound. Start over instead.
                    and int(state.level) <= total_cap):
                self._resume_cache.mark_resumed(s)
            else:
                state = initial_checkpoint(nv, s)
            start = int(state.level)
            chunks.append(self.engine.advance(state, min(start + k, total_cap) - start))
            cursors.append({"source": s, "start": start, "t0": time.monotonic()})
        return _Pending2D(sources=sources, uniq=uniq, inv=inv, chunks=chunks,
                          cursors=cursors, total_cap=total_cap)

    def _drive_chunks(self, pend: _Pending2D, u: int):
        """Complete run ``u``: at each chunk boundary consult the fault site
        (``level`` = the chunk's start level), snapshot the state, advance
        the next chunk; returns the final checkpoint. A mesh kind injected
        here fires mid-query, after at least one snapshot."""
        from tpu_bfs_torch.utils.checkpoint import BfsCheckpoint

        cur = pend.cursors[u]
        k = self._resume.every_levels
        while True:
            if _faults.ACTIVE is not None:
                _faults.ACTIVE.hit("fetch", lanes=self.lanes, devices=self._devices_n,
                                   level=cur["start"])
            out = pend.chunks[u]
            level = int(out.level)
            if not out.frontier.any() or level >= pend.total_cap:
                self._resume_cache.drop(cur["source"])
                return out
            if self._resume.should_snapshot(level, time.monotonic() - cur["t0"]):
                self._resume_cache.put(cur["source"], BfsCheckpoint(
                    source=cur["source"], level=level, frontier=out.frontier,
                    visited=out.visited, distance=out.distance, nonce=out.nonce))
            cur["start"] = level
            pend.chunks[u] = self.engine.advance(out, min(level + k, pend.total_cap) - level)

    def fetch(self, pend: _Pending2D, *, check_cap: bool = True,
              **_ignored) -> Dist2DServeResult:
        # ``check_cap`` is accepted for protocol uniformity (the k-hop
        # adapter passes it): the bound is the padded vertex count, so a
        # capped run is always the caller's explicit max_levels.
        if _faults.ACTIVE is not None:
            # The blocking half's site (the chunked drive consults it per
            # chunk, with ``level``).
            _faults.ACTIVE.hit("fetch", lanes=self.lanes, devices=self._devices_n)
        u_count = len(pend.uniq)
        if pend.cursors is None:
            runs = pend.runs
            reached_u, ecc_u, slots_u = runs.reached, runs.ecc, runs.slots
            self.last_exchange_bytes = float(self.engine.last_exchange_bytes or 0.0)
            rows = runs.unshard
        else:
            reached_u = np.empty(u_count, dtype=np.int64)
            ecc_u = np.empty(u_count, dtype=np.int32)
            slots_u = np.empty(u_count, dtype=np.int64)
            finals, wire = [], 0.0
            for u in range(u_count):
                out = self._drive_chunks(pend, u)
                # The chunks' exchange records chain on the query's nonce,
                # so the engine's last record covers the whole query.
                wire += float(self.engine.last_exchange_bytes or 0.0)
                dist = np.asarray(out.distance, dtype=np.int32)
                fin = dist != INF_DIST
                reached_u[u] = int(fin.sum())
                ecc_u[u] = int(dist[fin].max()) if fin.any() else 0
                slots_u[u] = int(self._degrees[fin].sum())
                finals.append(dist)
            self.last_exchange_bytes = wire
            rows = finals.__getitem__
        inv = pend.inv
        edges = slots_u[inv]
        if self._undirected:
            edges = edges // 2
        return Dist2DServeResult(rows, inv, pend.sources, reached_u[inv], ecc_u[inv], edges)

    def run(self, sources, *, max_levels: int | None = None,
            time_it: bool = False) -> Dist2DServeResult:
        """The blocking batch entry (the registry's warm-up, one-shot
        callers); ``time_it`` is accepted for protocol uniformity."""
        return self.fetch(self.dispatch(sources, max_levels=max_levels))
