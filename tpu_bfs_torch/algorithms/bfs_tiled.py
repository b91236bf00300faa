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

``pull_gate=True`` gates the tile pass (``make_gated_tiles_expand``): a
tile runs only if its source column tile holds a frontier bit and its row
tile is not wholly visited, bit-identical to the dense pass. The host
learns how many tiles qualify in the level's one sync, with the dopt sums.
``start`` / ``advance`` / ``finish`` checkpoint the traversal in real
vertex ids, so it resumes on any single-source engine of either package.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import GATE_DENSE_DEN, resolve_device
from tpu_bfs_torch.algorithms.bfs import BfsResult, host_frontier_sums, run_level_loop
from tpu_bfs_torch.algorithms.frontier import (
    INT32_MAX,
    EdgeData,
    _nonzero_static,
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


def tiles_on(vt: int, col_t, seg, fb, visited):
    """[NT] bool: the tiles whose column tile holds a frontier bit and whose
    row tile is not wholly visited (``fb`` [vt, TILE], ``visited`` [vt*TILE];
    torch tensors, or numpy arrays on the host)."""
    if isinstance(fb, np.ndarray):
        return fb.any(axis=1)[col_t] & ~visited.reshape(vt, TILE).all(axis=1)[seg]
    return (fb.any(dim=1).index_select(0, col_t)
            & ~visited.view(vt, TILE).all(dim=1).index_select(0, seg))


def make_gated_tiles_expand(vt: int, num_tiles: int):
    """The pull-gated tile pass: only the tiles of :func:`tiles_on`. The
    source half is exact (an empty column tile contributes nothing); the
    row half is masked by the caller's ``& ~visited`` claim. When more than
    1/GATE_DENSE_DEN of the tiles qualify the dense pass runs, as in JAX.

    Returns ``expand(a_tiles, col_t, seg, fb, visited, nz) -> ([vt*TILE]
    bool hits, skipped tiles)``: ``nz`` is the qualifying count, which the
    host read in the previous level's sync; the qualifying tiles are
    gathered without a host read, and their contributions to a shared row
    tile accumulate through ``index_add_``."""
    dense = make_tiles_expand(vt)

    def expand(a_tiles, col_t, seg, fb, visited, nz: int):
        if nz * GATE_DENSE_DEN > num_tiles:
            return dense(a_tiles, col_t, seg, fb), 0
        idx = _nonzero_static(tiles_on(vt, col_t, seg, fb, visited), nz).long()
        hits = dense(a_tiles.index_select(0, idx), col_t.index_select(0, idx),
                     seg.index_select(0, idx), fb)
        return hits, num_tiles - nz

    return expand


class TiledBfsEngine:
    """Single-source BFS: the dopt ladder plus the dense-tile bitset pass on
    heavy levels. The API follows ``BfsEngine`` (``run`` -> ``BfsResult``).
    State lives in rank-row space (descending in-degree, active vertices
    first, padded to 128-row tiles); distances map back to vertex ids at
    extraction. ``device`` is CUDA unless named. With ``pull_gate``,
    ``last_gate_skipped_tiles`` is the skipped-tile total of the latest
    loop: a whole ``run``, or one ``advance`` chunk. ``tables`` is another
    engine over the same graph, tile threshold and budget on the same
    device, whose tables this one shares instead of building its own (a
    gated and an ungated engine of one graph)."""

    def __init__(self, graph: Graph, *, tile_thr: int = 32, a_budget_bytes: int = int(0.8e9),
                 dopt_caps: tuple[int, ...] | None = None, pull_gate: bool = False,
                 device=None, tables=None):
        self.device = dev = resolve_device(device)
        g = graph
        self.host_graph = g  # parent extraction (min_parent_from_dist)
        self.undirected = g.undirected
        self._degrees = g.degrees
        self._table_args = (tile_thr, int(a_budget_bytes))
        if dopt_caps is None:
            dopt_caps = default_dopt_caps(g.num_edges)
        self.dopt_caps = tuple(sorted(set(dopt_caps)))
        self.pull_gate = pull_gate
        self.last_gate_skipped_tiles = None
        self._skipped = 0
        self.last_host_syncs = 0
        self._warmed = False
        if tables is not None:
            if (tables.host_graph is not g or tables._table_args != self._table_args
                    or tables.device != dev):
                raise ValueError("tables must come from an engine over the same graph, "
                                 "tile_thr and a_budget_bytes on the same device")
            for name in ("_rank", "_act", "num_vertices", "vt", "rows", "num_tiles",
                         "num_dense_edges", "_a", "_col_t_host", "_seg_host", "_col_t",
                         "_seg", "_tiles_expand", "_out_rp_host", "_edges", "_out_deg"):
                setattr(self, name, getattr(tables, name))
            self._arm_gate()
            return
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
        self._col_t_host = (uniq % vt).astype(np.int32)
        self._seg_host = (uniq // vt).astype(np.int32)
        self._col_t = put(self._col_t_host)
        self._seg = put(self._seg_host)
        self._tiles_expand = make_tiles_expand(vt)
        self._arm_gate()

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

    def _arm_gate(self) -> None:
        self._gated = self.pull_gate and self.num_tiles > 0
        self._gated_tiles_expand = (make_gated_tiles_expand(self.vt, self.num_tiles)
                                    if self._gated else None)

    def _step(self, frontier, visited, nfront: int, fsum: int, nz: int | None = None):
        """One level: the dopt rung ladder over every edge (the dense step
        over the residual only), plus the tile pass exactly on the levels
        where no rung fits (the dense step's levels; the rungs already find
        those hits on the others). ``nz``: the gate's qualifying tiles."""
        edges, caps = self._edges, self.dopt_caps
        hit = level_step_dopt(edges, frontier, visited, caps=caps, nfront=nfront, fsum=fsum)
        if self.num_tiles and dopt_rung((max(caps),), nfront, fsum, self.rows) is None:
            fb = frontier.view(self.vt, TILE)
            if self._gated:
                tiles, skipped = self._gated_tiles_expand(
                    self._a, self._col_t, self._seg, fb, visited, nz)
                self._skipped += skipped
            else:
                tiles = self._tiles_expand(self._a, self._col_t, self._seg, fb)
            hit = hit | (tiles & ~visited)
        return hit

    def _loop(self, frontier, visited, dist, level0: int, max_levels: int, first: tuple):
        """The level loop from a device rank-row state [rows]; ``first`` is
        the initial frontier's (size, out-degree sum) and, gated, its
        qualifying tiles, known on the host. Returns the device (frontier,
        visited, dist) and the level count."""

        def sums(f):
            s = frontier_sums(f, self._out_deg)
            if not self._gated:
                return s
            on = tiles_on(self.vt, self._col_t, self._seg, f.view(self.vt, TILE), visited)
            return torch.cat([s, on.sum().view(1)])

        self._skipped = 0
        frontier, level, syncs = run_level_loop(
            self._step, frontier, visited, dist, level0, max_levels,
            sums=sums, first_sums=first,
        )
        self.last_host_syncs = syncs
        if self._gated:
            self.last_gate_skipped_tiles = self._skipped
        return frontier, visited, dist, level

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
        rp = self._out_rp_host
        first = (1, int(rp[rs + 1] - rp[rs]))
        if self._gated:  # one visited row: no row tile is wholly visited yet
            first += (int(np.count_nonzero(self._col_t_host == rs // TILE)),)

        def go():
            dev, rows = self.device, self.rows
            f0 = torch.zeros(rows, dtype=torch.bool, device=dev)
            f0[rs] = True
            d0 = torch.full((rows,), INT32_MAX, dtype=torch.int32, device=dev)
            d0[rs] = 0
            return self._loop(f0, f0.clone(), d0, 0, ml, first)

        elapsed = None
        if time_it:
            from tpu_bfs_torch.utils.timing import run_timed

            out, elapsed = run_timed(go, warm=not self._warmed, device=self.device)
            self._warmed = True
        else:
            out = go()
        dr = out[2].cpu().numpy()
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

    # --- checkpoint and resume (utils/checkpoint.py): real vertex ids [V],
    # as every single-source engine's, so a checkpoint moves between them.

    def start(self, source: int):
        """Level-0 state as a host checkpoint (no device work)."""
        from tpu_bfs_torch.utils.checkpoint import initial_checkpoint

        return initial_checkpoint(self.num_vertices, source)

    def advance(self, ckpt, levels: int | None = None):
        """At most ``levels`` more levels; bit-identical to no stop."""
        from tpu_bfs_torch.utils.checkpoint import BfsCheckpoint

        if len(ckpt.frontier) != self.num_vertices:
            raise ValueError(f"checkpoint has {len(ckpt.frontier)} vertices, graph has "
                             f"{self.num_vertices}")
        live = self._rank < self._act
        rows_live = self._rank[live]
        f0 = np.zeros(self.rows, dtype=bool)
        f0[rows_live] = ckpt.frontier[live]
        vis0 = np.zeros(self.rows, dtype=bool)
        vis0[rows_live] = ckpt.visited[live]
        d0 = np.full(self.rows, INT32_MAX, np.int32)
        d0[rows_live] = ckpt.distance[live]  # INF_DIST == INT32_MAX
        cap = ckpt.level + levels if levels is not None else self.rows
        first = host_frontier_sums(f0, self._out_rp_host)
        if self._gated:
            first += (int(tiles_on(self.vt, self._col_t_host, self._seg_host,
                                   f0.reshape(self.vt, TILE), vis0).sum()),)
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        frontier, visited, dist, level = self._loop(put(f0), put(vis0), put(d0), ckpt.level,
                                                    min(cap, self.rows), first)
        fr, vr, dr = (t.cpu().numpy() for t in (frontier, visited, dist))
        f_v = np.zeros(self.num_vertices, dtype=bool)
        f_v[live] = fr[rows_live]
        vis_v = np.zeros(self.num_vertices, dtype=bool)
        vis_v[live] = vr[rows_live]
        d_v = np.full(self.num_vertices, INF_DIST, np.int32)
        d_v[live] = dr[rows_live]
        # An isolated source has no rank row: its component is {source}.
        if not live[ckpt.source]:
            vis_v[ckpt.source] = True
            d_v[ckpt.source] = 0
        return BfsCheckpoint(source=ckpt.source, level=int(level), frontier=f_v,
                             visited=vis_v, distance=d_v, nonce=ckpt.nonce)

    def finish(self, ckpt, *, with_parents: bool = True) -> BfsResult:
        """A (finished or partial) checkpoint as a BfsResult."""
        return self._package(ckpt.distance.copy(), ckpt.source, with_parents, None)
