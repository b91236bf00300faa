"""Single-source BFS over an R x C mesh with 2D edge partitioning, the port
of ``Dist2DBfsEngine`` in ``tpu_bfs/parallel/dist_bfs2d.py``.

The scale-out path the reference lacks (its only distribution replicates
the CSR on every card and partitions ownership 1D, bfs.cu:29-32, 346-351).
A level, on every rank (``parallel/partition2d.py`` lays out the edges):

    column all-gather ('r')  ->  local expansion  ->
    row OR-reduce-scatter ('c')  ->  claim of the owned slice  ->
    termination sum over the whole mesh

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

``Dist2DServeEngine`` (the serve tier's adapter) is not ported: it comes
with its first reader (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms.frontier import (
    INT32_MAX,
    expand_or,
)
from tpu_bfs_torch.graph.csr import Graph
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
)
from tpu_bfs_torch.parallel.mesh import Mesh2D, make_mesh_2d
from tpu_bfs_torch.parallel.partition2d import out_csr_2d_rank, partition_2d_rank


def partition_shard_2d(graph: Graph, mesh: Mesh2D):
    """This rank's (partition, src_gidx, dst_l, rp) of ``graph`` on ``mesh``."""
    return partition_2d_rank(graph, mesh.rows, mesh.cols, mesh.r.rank, mesh.c.rank)


class Dist2DBfsEngine(PlannedExchange, VertexCheckpointMixin, DistTraceHost):
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
            new = hit & ~visited
            dist.masked_fill_(new, level + 1)
            visited |= new
            frontier = new
            col_frontier = self._gather_col(new)
            parts = [mesh.world.all_reduce_(new.sum(dtype=torch.int64).reshape(1), "sum")]
            if dopt:
                parts.append(self._expand.sums(col_frontier))
            if sparse:
                parts.append(mesh.r.all_reduce_(
                    torch.full((1,), branch, dtype=torch.int64, device=self.device), "max"))
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
