"""Single-source BFS over a 1D mesh, the port of
``tpu_bfs/parallel/dist_bfs.py``.

It replaces both multi-GPU paths of the reference: the single-process
``runCudaQueueBfs`` (bfs.cu:542-629), which moves the frontier between
``DeviceNum`` cards with peer copies, and the MPI fork (bfs_mpi.cu:549-643),
one GPU a rank. Each rank is a process holding one device
(``parallel/mesh.py``) and the edges whose source it owns
(``parallel/partition.py``). Per level, each rank:

1. expands its owned frontier over its edges into a [vp] contribution
   (the analog of the per-destination buckets, bfs.cu:148-150);
2. OR-reduce-scatters the contributions (``ring``, ``allreduce``, or the
   queue-style ``sparse`` exchange of ``collectives.py``), replacing
   ``cudaMemcpyPeer`` (bfs.cu:604-606) and ``MPI_Sendrecv``
   (bfs_mpi.cu:615);
3. claims the unvisited vertices of its slice (the ``atomicMin`` claim,
   bfs.cu:146);
4. sums the new frontier over the mesh for termination (``MPI_Allreduce``,
   bfs_mpi.cu:621).

JAX runs the level loop as one ``lax.while_loop`` inside ``shard_map``.
Here every rank drives it from the host, as every engine of the port does,
with one host read a level: the termination count (with ``backend='dopt'``,
the same read carries the rank's own frontier size and out-degree sum,
which pick its expansion branch). The sparse exchange's rung pick is a
second read on meshes of more than one rank. Every collective sits
outside the per-rank branch, so ranks that pick different dopt branches
still meet in the same collectives.

The exchange planner's knobs: ``wire_pack`` ships every bool exchange as
32-bit words; ``delta_bits``, ``sieve`` and ``predict`` turn the sparse
exchange into ``collectives.planned_sparse_exchange_or``, whose carried
values (the last measured count, the frontier's growth, the visited
total) come from all-reduced counts, so every rank holds the same. A
planner level reads the host once (its phase 1), twice sieved, and not at
all when predicted dense.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms.bfs import BfsResult
from tpu_bfs_torch.algorithms.frontier import (
    INT32_MAX,
    DoptExpand,
    EdgeData,
    default_dopt_caps,
    expand_or,
)
from tpu_bfs_torch.graph.csr import INF_DIST, Graph
from tpu_bfs_torch.obs.engine_trace import DistTraceHost, LevelRecord
from tpu_bfs_torch.parallel.collectives import (
    ExchangeAccounting,
    check_delta_bits,
    dense_or_wire_bytes,
    planned_branch_count,
    planned_branch_labels,
    planned_reads,
    planned_sparse_exchange_or,
    planned_sparse_wire_bytes_per_level,
    reduce_scatter_min,
    reduce_scatter_or,
    resolve_sparse_caps,
    sparse_exchange_or,
    sparse_wire_bytes_per_level,
)
from tpu_bfs_torch.parallel.mesh import Mesh, make_mesh
from tpu_bfs_torch.parallel.partition import (
    make_partition_1d,
    out_csr_1d_rank,
    partition_1d_rank,
)
from tpu_bfs_torch.utils.aot import ArgSpec
from tpu_bfs_torch.utils.timing import run_timed

#: The expansion backends of the mesh engines: the dense edge-centric
#: forms, and 'dopt' (their sparse top-down rungs over 'scan').
BACKENDS = ("scan", "segment", "scatter", "dopt")
EXCHANGES = ("ring", "allreduce", "sparse")


def check_engine_args(exchange: str, backend: str, what: str = "", *, planner: bool = False,
                      row: str = "") -> None:
    """The mesh engines' refusals, before any host work: JAX's texts.
    ``planner`` is whether delta_bits, sieve or predict is on; ``row``
    names the 2D engine's row exchange."""
    if exchange not in EXCHANGES:
        raise ValueError(
            f"unknown exchange {exchange!r}{what}; have 'ring', 'allreduce', 'sparse'")
    if planner and exchange != "sparse":
        raise ValueError(
            f"delta_bits/sieve/predict reshape the SPARSE {row}exchange (the exchange "
            f"planner); exchange={exchange!r} has no id buffers to compress — use "
            "exchange='sparse'")
    if backend not in BACKENDS:
        raise KeyError(f"unknown expansion backend {backend!r}; have {sorted(BACKENDS)}")


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class VertexCheckpointMixin:
    """Checkpoint and resume of the single-source mesh engines, over the
    port's real-id ``utils/checkpoint.BfsCheckpoint``: a traversal saved on
    one mesh, 1D or 2D, resumes on any other, on ``BfsEngine`` and in the
    JAX package. Hosts provide ``part``, ``mesh`` (whose world rank k holds
    padded slice k), ``device``, ``rp``, ``_parents_loc(dist_loc)`` and
    ``_advance_loop(f0, vis0, d0, level0, cap, chain_nonce)`` over host
    [vp] arrays, returning this rank's (frontier, visited, dist) slices and
    the level."""

    _pids = None

    @property
    def _num_real_vertices(self) -> int:
        return self.part.num_vertices

    def _world(self) -> Mesh:
        return getattr(self.mesh, "world", self.mesh)

    def _slice_len(self) -> int:
        return self.part.vp // self._world().num_shards

    def _local(self, a: np.ndarray) -> torch.Tensor:
        """This rank's slice of a host [vp] array, on the device."""
        n = self._slice_len()
        lo = self._world().rank * n
        return _put(a[lo : lo + n], self.device)

    def _gather_vec(self, t_loc: torch.Tensor) -> np.ndarray:
        """Every rank's slice of a [vp] vector, on the host, in id order."""
        return self._world().all_gather_rows(t_loc).cpu().numpy()

    def start(self, source: int):
        """Level-0 traversal state as a host checkpoint (real vertex ids)."""
        from tpu_bfs_torch.utils.checkpoint import initial_checkpoint

        return initial_checkpoint(self._num_real_vertices, source)

    def _pad_state(self, ckpt):
        """Real-id [V] checkpoint arrays -> padded-id [vp] host arrays."""
        part = self.part
        if self._pids is None:  # constant for the engine's lifetime
            self._pids = part.to_padded(np.arange(self._num_real_vertices))
        f = np.zeros(part.vp, dtype=bool)
        f[self._pids] = ckpt.frontier
        vis = np.zeros(part.vp, dtype=bool)
        vis[self._pids] = ckpt.visited
        d = np.full(part.vp, INF_DIST, dtype=np.int32)
        d[self._pids] = ckpt.distance
        return f, vis, d

    def advance(self, ckpt, levels: int | None = None):
        """At most ``levels`` more levels across the mesh from a checkpoint."""
        from tpu_bfs_torch.utils.checkpoint import BfsCheckpoint

        part = self.part
        if len(ckpt.frontier) != self._num_real_vertices:
            raise ValueError(f"checkpoint has {len(ckpt.frontier)} vertices, graph has "
                             f"{self._num_real_vertices}")
        f0, vis0, d0 = self._pad_state(ckpt)
        cap = ckpt.level + levels if levels is not None else part.vp
        frontier, visited, dist, level = self._advance_loop(
            f0, vis0, d0, ckpt.level, min(cap, part.vp), chain_nonce=ckpt.nonce)
        return BfsCheckpoint(
            source=ckpt.source, level=int(level),
            frontier=part.unshard(self._gather_vec(frontier)),
            visited=part.unshard(self._gather_vec(visited)),
            distance=part.unshard(self._gather_vec(dist)),
            nonce=ckpt.nonce,  # the chain's identity survives the chunks
        )

    def finish(self, ckpt, *, with_parents: bool = True) -> BfsResult:
        """A (finished or partial) checkpoint as a BfsResult."""
        _, _, d0 = self._pad_state(ckpt)
        return self._package(self._local(d0), ckpt.source, with_parents, None)

    def run(self, source: int, *, max_levels: int | None = None, with_parents: bool = True,
            time_it: bool = False) -> BfsResult:
        if not (0 <= source < self._num_real_vertices):
            raise ValueError(f"source {source} out of range")
        elapsed = None
        if time_it:
            (dist_loc, _), elapsed = run_timed(
                lambda: self.distances_padded(source, max_levels=max_levels),
                warm=not self._warmed, device=self.device)
            self._warmed = True
        else:
            dist_loc, _ = self.distances_padded(source, max_levels=max_levels)
        return self._package(dist_loc, source, with_parents, elapsed)

    def _dopt_expand(self, src, dst, out_csr, dopt_caps, ep: int, *, vert_limit: int,
                     out_size: int, dense_fn) -> DoptExpand:
        """The rank's dopt expansion over its edges and their out-CSR
        ``(out_rp, nbr)``; sets ``dopt_caps`` (default ``default_dopt_caps``
        of the ``ep`` edge slots) and the host out-row pointer."""
        out_rp, nbr = out_csr
        self._out_rp_host = out_rp.astype(np.int64)
        self.dopt_caps = tuple(sorted(set(dopt_caps or default_dopt_caps(ep))))
        edata = EdgeData(src=src, dst=dst, in_rp=self.rp, out_rp=_put(out_rp, self.device),
                         nbr_sm=_put(nbr, self.device))
        return DoptExpand(edata, self.dopt_caps, vert_limit=vert_limit, out_size=out_size,
                          dense_fn=dense_fn)

    def _package(self, dist_loc, source: int, with_parents: bool, elapsed) -> BfsResult:
        parent_loc = self._parents_loc(dist_loc) if with_parents else None
        return self._result(dist_loc, parent_loc, source, elapsed)

    def _result(self, dist_loc, parent_loc, source: int, elapsed) -> BfsResult:
        """The BfsResult of this rank's distance (and parent) slices, every
        rank's gathered; the TEPS numerator from the reached vertices'
        degrees, as in JAX."""
        part = self.part
        parent = None
        if parent_loc is not None:
            parent_pad = part.unshard(self._gather_vec(parent_loc))
            # Padded ids -> real ids; -1 passes through; the source -> itself.
            parent = np.where(parent_pad >= 0, part.from_padded(np.abs(parent_pad)),
                              -1).astype(np.int32)
            parent[source] = source
        dist = part.unshard(self._gather_vec(dist_loc))
        reached_mask = dist != INF_DIST
        reached = int(reached_mask.sum())
        num_levels = int(dist[reached_mask].max()) if reached else 0
        slots = int(self._degrees[reached_mask].sum()) if reached else 0
        return BfsResult(
            source=source, distance=dist, parent=parent, num_levels=num_levels,
            reached=reached, edges_traversed=slots // 2 if self._undirected else slots,
            elapsed_s=elapsed,
        )


def partition_shard(graph: Graph, mesh: Mesh):
    """This rank's (partition, src, dst, rp) of ``graph`` on ``mesh``."""
    part = make_partition_1d(graph, mesh.num_shards)
    return (part,) + partition_1d_rank(graph, part, mesh.rank)


def _mesh_of(mesh, device) -> Mesh:
    if mesh is None:
        return make_mesh(device=device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
    return mesh


def claim_step(hit, visited, dist, level):
    """The claim of a rank's slice: ``new = hit & ~visited`` labeled
    ``level`` in ``dist`` and ORed into ``visited`` (both in place).
    Returns ``(new, count)``, ``count`` the [1] int32 size of ``new`` for
    the host's all-reduce."""
    new = hit & ~visited
    dist.masked_fill_(new, level)
    visited |= new
    return new, new.sum(dtype=torch.int32).reshape(1)


class PlannerCarry:
    """The planner's values carried from level to level, the same on every
    rank: the last measured count (-1 before the first), the frontier
    count before the last level, and the mesh's visited count."""

    def __init__(self, vis_total: int):
        self.prev_biggest, self.prev_count, self.vis_total = -1, 0, vis_total
        self.biggest = -1

    def advance(self, front: int, new: int) -> None:
        """After a level that expanded ``front`` vertices and claimed
        ``new``."""
        self.prev_biggest, self.prev_count = self.biggest, front
        self.vis_total += new


class PlannedExchange(ExchangeAccounting):
    """The single-source engines' exchange over one mesh axis, with the
    planner's knobs. Hosts set ``_exchange`` and call :meth:`_set_planner`;
    the 2D engine passes its row mesh and scales the visited total."""

    def _set_planner(self, wire_pack, delta_bits, sieve, predict, sparse_caps, n: int):
        self.wire_pack = bool(wire_pack)
        self.delta_bits = check_delta_bits(delta_bits)
        self.sieve, self.predict = bool(sieve), bool(predict)
        sparse = self._exchange == "sparse"
        self._planned = sparse and bool(self.delta_bits or self.sieve or self.predict)
        self.sparse_caps = resolve_sparse_caps(sparse_caps, n, wire_pack=self.wire_pack,
                                               delta_bits=self.delta_bits)
        self._nb = 1 if not sparse else (
            planned_branch_count(self.sparse_caps, self.delta_bits) if self._planned
            else len(self.sparse_caps) + 1)

    def _exchange_model(self, p: int, n: int) -> list[float]:
        """The exchange's modeled bytes a level, per branch, over ``p``
        ranks of ``n``-vertex chunks."""
        if self._planned:
            return planned_sparse_wire_bytes_per_level(p, n, self.sparse_caps,
                                                       self.delta_bits, wire_pack=self.wire_pack)
        if self._exchange == "sparse":
            return sparse_wire_bytes_per_level(p, n, self.sparse_caps, wire_pack=self.wire_pack)
        return [dense_or_wire_bytes(p, n, self._exchange, wire_pack=self.wire_pack)]

    def exchange_branch_labels(self) -> list[str] | None:
        if self._planned:
            return planned_branch_labels(self.sparse_caps, self.delta_bits)
        return super().exchange_branch_labels()

    def _exchange_step(self, contrib: torch.Tensor, mesh, visited, plan: PlannerCarry,
                       front: int, vis_scale: int = 1):
        """(hit, branch, host reads) of a level's contribution over
        ``mesh``; ``front`` is the frontier count (the planner's growth)."""
        if self._planned:
            hit, branch, plan.biggest = planned_sparse_exchange_or(
                contrib, mesh, caps=self.sparse_caps, delta_bits=self.delta_bits,
                sieve=self.sieve, visited=visited, visited_total=plan.vis_total // vis_scale,
                predict=self.predict, prev_biggest=plan.prev_biggest,
                growing=front >= plan.prev_count, wire_pack=self.wire_pack)
            return hit, branch, planned_reads(branch, self.sparse_caps, self.delta_bits,
                                              mesh.num_shards)
        if self._exchange == "sparse":
            hit, branch = sparse_exchange_or(contrib, mesh, caps=self.sparse_caps,
                                             wire_pack=self.wire_pack)
            return hit, branch, int(mesh.num_shards > 1)
        return reduce_scatter_or(contrib, mesh, impl=self._exchange,
                                 wire_pack=self.wire_pack), 0, 0


class DistBfsEngine(PlannedExchange, VertexCheckpointMixin, DistTraceHost):
    """Single-source BFS over a 1D vertex partition, built inside every
    rank of ``mesh`` (default: this process's rank group, CUDA unless
    ``device`` names another). With one rank it is ``BfsEngine`` plus the
    mesh's collectives. ``exchange`` is 'ring', 'allreduce' or 'sparse'
    (``sparse_caps``, default ``default_sparse_caps``); ``backend`` is
    'scan', 'segment', 'scatter' or 'dopt' (``dopt_caps``, default
    ``default_dopt_caps`` of the rank's edges). ``wire_pack``, ``delta_bits``,
    ``sieve`` and ``predict`` are the exchange planner's knobs (the last
    three need 'sparse'; see the module docstring). ``shard`` is this rank's
    :func:`partition_shard`, to build several engines over one graph
    without repeating the host partition.

    A rank holds its slice of the padded id space (frontier, visited and
    distances, [vloc]), its [ep_chip] edges and the [vp + 1] row pointer;
    a level's transient is the [vp] contribution. Host memory a rank: its
    edge shard, built from its own range of the CSR."""

    def __init__(self, graph: Graph, mesh: Mesh | None = None, *, exchange: str = "ring",
                 backend: str = "scan", sparse_caps=None, dopt_caps=None,
                 wire_pack: bool = False, delta_bits=(), sieve: bool = False,
                 predict: bool = False, device=None, shard=None):
        check_engine_args(exchange, backend, planner=bool(delta_bits or sieve or predict))
        self.mesh = _mesh_of(mesh, device)
        self.device = self.mesh.device
        self.p = p = self.mesh.num_shards
        k = self.mesh.rank
        self._exchange, self.backend = exchange, backend
        self._degrees, self._undirected = graph.degrees, graph.undirected
        if shard is None:
            shard = partition_shard(graph, self.mesh)
        part, src, dst, rp = shard
        self.part = part
        self.src, self.dst, self.rp = (_put(a, self.device) for a in (src, dst, rp))
        self._src_local = self.src - k * part.vloc  # owned sources: in [0, vloc)
        vp, dopt = part.vp, backend == "dopt"
        dense_backend = "scan" if dopt else backend

        def dense(frontier):
            active = frontier.index_select(0, self._src_local)
            return expand_or(active, self.dst, self.rp, vp, backend=dense_backend)

        self._expand = self._dense_expand = dense
        self.dopt_caps = ()
        if dopt:
            self._expand = self._dopt_expand(
                self.src, self.dst, out_csr_1d_rank(part, k, src, dst), dopt_caps,
                part.ep_chip, vert_limit=part.vloc, out_size=vp, dense_fn=dense)
        self._set_planner(wire_pack, delta_bits, sieve, predict, sparse_caps, part.vloc)
        # The parent merge is one int32 MIN reduce-scatter; ids do not
        # apply, so 'sparse' rides the ring there, as in JAX.
        self._parent_impl = "ring" if exchange == "sparse" else exchange
        self.last_host_syncs = 0
        self._warmed = False

    def wire_bytes_per_level(self) -> list[float]:
        """Modeled bytes one rank moves a level, per exchange branch
        (aligned with ``exchange_branch_labels`` and the counters)."""
        return self._exchange_model(self.p, self.part.vloc)

    def analysis_programs(self):
        """This rank's programs of a level for ``analysis/`` (JAX's
        ``analysis_programs``, whose one program is the level loop): the
        dense expansion of the [vloc] frontier into the [vp] contribution
        (dopt's dense fallback; its sparse rungs are host-sized), and the
        claim. The exchange between them is the host's."""
        vloc, dev = self.part.vloc, self.device
        flag = ArgSpec((vloc,), torch.bool, dev)
        return [("level_expand", self._dense_expand, (flag,)),
                ("claim", claim_step, (flag, flag, ArgSpec((vloc,), torch.int32, dev),
                                       ArgSpec((), torch.int32, dev)))]

    def _first(self, nfront: int, own) -> tuple:
        """The loop's first host values: the global frontier count and,
        for 'dopt', this rank's frontier size and out-degree sum (``own``,
        the rank's local frontier ids on the host)."""
        if self.backend != "dopt":
            return (nfront,)
        rp = self._out_rp_host
        return (nfront, len(own), int((rp[own + 1] - rp[own]).sum()))

    def _loop(self, frontier, visited, dist, level0: int, max_levels: int, first,
              vis_total: int):
        """The host level loop from this rank's slices; ``first`` as
        :meth:`_first`, ``vis_total`` the mesh's visited count. Returns the
        frontier, the level and the per-branch level counts; ``visited``
        and ``dist`` are updated in place."""
        mesh, dopt = self.mesh, self.backend == "dopt"
        counts = np.zeros(self._nb, dtype=np.int32)
        level, count, info = level0, first[0], first[1:]
        syncs = 0
        plan = PlannerCarry(vis_total)
        trace = LevelRecord(level0)
        while count > 0 and level < max_levels:
            contrib = self._expand(frontier, *info)
            hit, branch, reads = self._exchange_step(contrib, mesh, visited, plan, count)
            counts[branch] += 1
            new, nnew = claim_step(hit, visited, dist, level + 1)
            frontier = new
            sums = self._expand.sums(new) if dopt else nnew
            total = mesh.all_reduce_(sums[:1].clone(), "sum")
            front = count
            count, *info = torch.cat([total, sums] if dopt else [total]).tolist()
            trace.add(level, count, branch)
            level += 1
            plan.advance(front, count)
            syncs += 1 + reads
        self.last_host_syncs = syncs
        self._record_trace(trace, level - level0)
        return frontier, level, counts

    def _fresh_state(self, source: int):
        """This rank's level-0 slices, made on the device, and the first
        host values."""
        part, vloc = self.part, self.part.vloc
        frontier = torch.zeros(vloc, dtype=torch.bool, device=self.device)
        dist = torch.full((vloc,), INT32_MAX, dtype=torch.int32, device=self.device)
        pid = int(part.to_padded(source))
        own = np.zeros(0, dtype=np.int64)
        if pid // vloc == self.mesh.rank:
            frontier[pid % vloc] = True
            dist[pid % vloc] = 0
            own = np.asarray([pid % vloc])
        return frontier, frontier.clone(), dist, self._first(1, own)

    def distances_padded(self, source: int, *, max_levels: int | None = None):
        """This rank's [vloc] distance slice (on the device) and the level
        counter."""
        frontier, visited, dist, first = self._fresh_state(source)
        ml = max_levels if max_levels is not None else self.part.vp
        _, level, counts = self._loop(frontier, visited, dist, 0, ml, first, 1)
        self._record_exchange(counts)
        return dist, level

    def _advance_loop(self, f0, vis0, d0, level0: int, cap: int, *, chain_nonce=None):
        vloc, k = self.part.vloc, self.mesh.rank
        own = np.flatnonzero(f0[k * vloc : (k + 1) * vloc])
        frontier, visited, dist = self._local(f0), self._local(vis0), self._local(d0)
        frontier, level, counts = self._loop(frontier, visited, dist, level0, cap,
                                             self._first(int(f0.sum()), own), int(vis0.sum()))
        self._record_exchange(counts, resumed_level=level0, chain_nonce=chain_nonce)
        return frontier, visited, dist, level

    def _parents_loc(self, dist_loc: torch.Tensor) -> torch.Tensor:
        """This rank's parent slice: every rank's distances all-gathered
        once (the result merge, finalizeCudaBfs, bfs.cu:424-441), the min
        candidate of the rank's edges scattered into a [vp] buffer, and a
        MIN reduce-scatter back to the owners."""
        dist_full = self._world().all_gather_rows(dist_loc)
        du = dist_full.index_select(0, self.src)
        ok = (du != INT32_MAX) & (du + 1 == dist_full.index_select(0, self.dst))
        cand = torch.where(ok, self.src, INT32_MAX)
        contrib = torch.full((self.part.vp,), INT32_MAX, dtype=torch.int32, device=self.device)
        contrib.scatter_reduce_(0, self.dst.long(), cand, "amin")
        parent = reduce_scatter_min(contrib, self.mesh, impl=self._parent_impl)
        parent = torch.where(parent == INT32_MAX, -1, parent)
        return torch.where(dist_loc == INT32_MAX, -1, parent)
