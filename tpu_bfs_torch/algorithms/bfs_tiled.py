"""Single-source BFS with the dense-tile bitset expansion (backend 'tiled'),
the port of ``tpu_bfs/algorithms/bfs_tiled.py``.

The hybrid engines' bit-packed 128x128 adjacency tiles (``[AW, 128]`` int32
words, row r at word r % AW, bit r // AW) admit a gather-free boolean
expansion:

    hit_bits[tile] = OR over columns c with frontier[c] of A_tile[:, c]

as int32 AND and an OR-reduce over contiguous words; the one indexed access
is a [128]-row frontier lookup per tile. The level structure is the
direction-optimizing ladder of ``frontier.level_step_dopt``: light levels run
``sparse_topdown`` over the full adjacency; heavy levels run the tile pass
plus the edge-centric scan over the residual (non-tiled) edges only. All of
it is plain PyTorch; the tile pass is the JAX package's VPU formulation,
not the K2 kernel.

The pull gate over the tiles (``pull_gate=True``) waits for ROADMAP Queue 1
item 7, with checkpoint and resume.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import resolve_device
from tpu_bfs_torch.algorithms.bfs import BfsResult, checkpoint_unported, run_level_loop
from tpu_bfs_torch.algorithms.frontier import (
    INT32_MAX,
    EdgeData,
    default_dopt_caps,
    dopt_rung,
    frontier_sums,
    level_step_dopt,
    out_degrees,
)
from tpu_bfs_torch.algorithms.msbfs_hybrid import fill_a_tiles, select_dense_tiles
from tpu_bfs_torch.graph.csr import INF_DIST, NO_PARENT, Graph, _sorted_pairs
from tpu_bfs_torch.graph.ell import rank_vertices
from tpu_bfs_torch.ops.tile_spmm import TILE


def make_tiles_expand(vt: int):
    """Gather-free boolean expansion over bit-packed dense tiles.

    ``a_tiles`` [NT, AW, TILE] int32, ``col_t`` [NT] column-tile ids, ``seg``
    [NT] row-tile ids (non-decreasing), ``fb`` [vt, TILE] bool frontier.
    Returns [vt*TILE] bool hits."""

    def tiles_expand(a_tiles, col_t, seg, fb):
        dev = a_tiles.device
        shifts = torch.arange(32, dtype=torch.int32, device=dev)
        fm = fb.index_select(0, col_t)  # [NT, TILE] bool
        red = torch.where(fm[:, None, :], a_tiles, 0)
        # OR-reduce the 128 columns by tree halving.
        while red.shape[-1] > 1:
            half = red.shape[-1] // 2
            red = red[..., :half] | red[..., half:]
        red = red[..., 0]  # [NT, AW]
        # Row r of a tile lives at word r % AW, bit r // AW: the [32, AW]
        # C-order reshape lands index bit * AW + word = r.
        contrib = ((red[:, None, :] >> shifts[None, :, None]) & 1).reshape(-1, TILE)
        # Many tiles share a row tile: index_add_ accumulates them.
        hit = torch.zeros((vt, TILE), dtype=torch.int32, device=dev)
        hit.index_add_(0, seg, contrib)
        return (hit > 0).reshape(-1)

    return tiles_expand


class TiledBfsEngine:
    """Single-source BFS: the dopt ladder plus the dense-tile bitset pass on
    heavy levels. The API follows ``BfsEngine`` (``run`` -> ``BfsResult``).
    State lives in rank-row space (descending in-degree, active vertices
    first, padded to 128-row tiles); distances map back to vertex ids at
    extraction. ``device`` is CUDA unless named."""

    def __init__(self, graph: Graph, *, tile_thr: int = 32, a_budget_bytes: int = int(0.8e9),
                 dopt_caps: tuple[int, ...] | None = None, pull_gate: bool = False,
                 device=None):
        if pull_gate:
            raise NotImplementedError(
                "the pull gate of the tiled engine is not ported to tpu_bfs_torch yet "
                "(ROADMAP Queue 1 item 7)"
            )
        self.device = dev = resolve_device(device)
        g = graph
        self.host_graph = g  # parent extraction (min_parent_from_dist)
        self.undirected = g.undirected
        self._degrees = g.degrees
        src, dst = g.coo
        _, act, _, rank = rank_vertices(src, dst, g.num_vertices)
        self._rank, self._act = rank, act
        self.num_vertices = g.num_vertices
        vt = -(-(act + 1) // TILE)
        rows = vt * TILE
        self.vt, self.rows = vt, rows
        r, c = rank[dst], rank[src]

        dense_edge, uniq, tid = select_dense_tiles(
            r, c, vt, tile_thr=tile_thr, a_budget_bytes=a_budget_bytes
        )
        self.num_tiles = len(uniq)
        self.num_dense_edges = int(dense_edge.sum())
        a_tiles = fill_a_tiles(dense_edge, uniq, tid, r, c)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

        self._a = put(a_tiles)
        self._col_t = put((uniq % vt).astype(np.int32))
        self._seg = put((uniq // vt).astype(np.int32))
        self._tiles_expand = make_tiles_expand(vt)

        # Full adjacency, src-major: the sparse top-down rungs.
        _, nbr_sm = _sorted_pairs(c, r, rows)
        out_rp = np.zeros(rows + 1, dtype=np.int32)
        np.cumsum(np.bincount(c, minlength=rows), out=out_rp[1:])
        self._out_rp_host = out_rp
        # Residual edges, dst-major: the heavy levels' scan complement.
        re = np.flatnonzero(~dense_edge)
        rr, cc = _sorted_pairs(r[re], c[re], rows)
        res_rp = np.zeros(rows + 1, dtype=np.int32)
        np.cumsum(np.bincount(rr, minlength=rows), out=res_rp[1:])
        self._edges = EdgeData(
            src=put(cc.astype(np.int32)),
            dst=put(rr.astype(np.int32)),
            in_rp=put(res_rp),
            out_rp=put(out_rp),
            nbr_sm=put(nbr_sm.astype(np.int32)),
        )
        self._out_deg = out_degrees(self._edges)
        if dopt_caps is None:
            dopt_caps = default_dopt_caps(g.num_edges)
        self.dopt_caps = tuple(sorted(set(dopt_caps)))
        self.last_host_syncs = 0
        self._warmed = False

    def _step(self, frontier, visited, nfront: int, fsum: int):
        """One level: the dopt rung ladder over every edge (the dense step
        over the residual only), plus the tile pass exactly on the levels
        where no rung fits (the dense step's levels; the rungs already find
        those hits on the others)."""
        edges, caps = self._edges, self.dopt_caps
        hit = level_step_dopt(edges, frontier, visited, caps=caps, nfront=nfront, fsum=fsum)
        if self.num_tiles and dopt_rung((max(caps),), nfront, fsum, self.rows) is None:
            tiles = self._tiles_expand(self._a, self._col_t, self._seg,
                                       frontier.view(self.vt, TILE))
            hit = hit | (tiles & ~visited)
        return hit

    def _loop(self, rs: int, max_levels: int):
        dev, rows = self.device, self.rows
        f0 = torch.zeros(rows, dtype=torch.bool, device=dev)
        f0[rs] = True
        d0 = torch.full((rows,), INT32_MAX, dtype=torch.int32, device=dev)
        d0[rs] = 0
        rp = self._out_rp_host
        _, level, syncs = run_level_loop(
            self._step, f0, f0.clone(), d0, 0, max_levels,
            sums=lambda f: frontier_sums(f, self._out_deg),
            first_sums=(1, int(rp[rs + 1] - rp[rs])),
        )
        self.last_host_syncs = syncs
        return d0, level

    def run(self, source: int, *, max_levels: int | None = None, with_parents: bool = True,
            time_it: bool = False) -> BfsResult:
        if not (0 <= source < self.num_vertices):
            raise ValueError(f"source {source} out of range")
        rs = int(self._rank[source])
        dist_v = np.full(self.num_vertices, INF_DIST, np.int32)
        dist_v[source] = 0
        if rs >= self._act:  # an isolated source: its component is {source}
            parent = None
            if with_parents:
                parent = np.full(self.num_vertices, NO_PARENT, np.int32)
                parent[source] = source
            return BfsResult(source=source, distance=dist_v, parent=parent, num_levels=0,
                             reached=1, edges_traversed=0, elapsed_s=None)
        ml = max_levels if max_levels is not None else self.rows
        elapsed = None
        if time_it:
            from tpu_bfs_torch.utils.timing import run_timed

            (dist_dev, _), elapsed = run_timed(lambda: self._loop(rs, ml),
                                               warm=not self._warmed, device=self.device)
            self._warmed = True
        else:
            dist_dev, _ = self._loop(rs, ml)
        dr = dist_dev.cpu().numpy()
        live = self._rank < self._act
        dist_v[live] = dr[self._rank[live]]
        return self._package(dist_v, source, with_parents, elapsed)

    def _package(self, dist_v, source: int, with_parents: bool, elapsed) -> BfsResult:
        reached_mask = dist_v != INF_DIST
        reached = int(reached_mask.sum())
        num_levels = int(dist_v[reached_mask].max()) if reached else 0
        slots = int(self._degrees[reached_mask].sum()) if reached else 0
        parent = None
        if with_parents:
            # One O(E) host scatter-min outside the timed loop: the same
            # deterministic tree every engine emits.
            from tpu_bfs_torch.validate import min_parent_from_dist

            parent = min_parent_from_dist(self.host_graph, source, dist_v)
        return BfsResult(
            source=source, distance=dist_v, parent=parent, num_levels=num_levels,
            reached=reached, edges_traversed=slots // 2 if self.undirected else slots,
            elapsed_s=elapsed,
        )

    def start(self, source: int):
        raise checkpoint_unported()

    def advance(self, ckpt, levels: int | None = None):
        raise checkpoint_unported()

    def finish(self, ckpt, *, with_parents: bool = True):
        raise checkpoint_unported()
