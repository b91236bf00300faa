"""Hybrid dense-tile + sparse-gather wide multi-source BFS, the port of
``tpu_bfs/algorithms/msbfs_hybrid.py`` and the flagship engine.

The graph splits once at build time:

- **dense part**: 128x128 adjacency tiles holding >= ``tile_thr`` edges
  (trimmed to a storage budget, 2 KB per bit-packed tile), expanded each
  level by ``tile_spmm`` (K2);
- **residual part**: every other edge, in an ELL bucketed by residual
  in-degree, expanded by ``ell_expand`` (K1) as in the wide engine.

Row space is rank0 order (active vertices first, by descending full
in-degree) padded to ``vt * 128`` rows; the residual outputs come out in
bucket order and one permutation gather (``inv_perm_ext``) routes them back
before the claim. The residual's pad sentinel is row ``vt * 128 - 1``,
which stays all-zero in every frontier table: K1 gathers it for every pad
slot.

The JAX engine's 4096-lane quantum (``MAX_LANES``/``LanesDontFitError``)
comes from Mosaic's 128-word DMA tiling; both CUDA kernels take any width,
so this engine takes any multiple of 32 lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import (
    HBM_BUDGET_BYTES,
    ExpandSpec,
    PackedRunProtocol,
    arrs_nbytes,
    auto_lanes,
    auto_planes,
    expand_arrays,
    floor_lanes,
    lazy_full_parent_ell,
    make_expand,
    make_packed_loop,
    make_state_kernels,
    pallas_expand_arrays,
    resolve_device,
)
from tpu_bfs_torch.graph.csr import Graph, _lexsort_pairs
from tpu_bfs_torch.graph.ell import EllBucket, bucketize_rows, rank_vertices
from tpu_bfs_torch.ops.tile_spmm import AW, TILE, row_masks, tile_spmm

W = 128
LANES = 32 * W
MAX_LANES = 4 * LANES
DEFAULT_MAX_LANES = 2 * LANES  # 8192 lanes, the flagship width


@dataclasses.dataclass(frozen=True)
class HybridGraph:
    """Build-time split of a graph into dense tiles + residual ELL.

    Row r of the frontier table is vertex ``old_of_new[r]``; rows
    [num_active, vt*128) are zero padding (the ELL pad sentinel is
    vt*128-1). ``inv_perm_ext`` routes a rank0 row to its residual bucket
    output row (pad and empty rows to the appended all-zero row)."""

    num_vertices: int
    num_edges: int
    undirected: bool
    kcap: int
    num_active: int
    vt: int  # frontier slabs of 128 rows; table height = vt * 128
    old_of_new: np.ndarray  # [V] int32
    rank: np.ndarray  # [V] int32
    in_degree: np.ndarray  # [V] int64, original ids
    num_dense_edges: int
    row_start: np.ndarray  # [vt+1] int32 CSR over row tiles
    col_tile: np.ndarray  # [NT] int32
    a_tiles: np.ndarray  # [NT, AW, TILE] uint32, rows in bits (tile_spmm layout)
    res_heavy: int
    res_num_virtual: int
    res_fold_steps: int
    res_virtual: EllBucket | None
    res_fold_pad_map: np.ndarray | None
    res_heavy_pick: np.ndarray | None
    res_light: list[EllBucket]
    res_tail_rows: int
    inv_perm_ext: np.ndarray  # [vt*128] int32

    # the expand_arrays protocol
    @property
    def virtual(self):
        return self.res_virtual

    @property
    def fold_pad_map(self):
        return self.res_fold_pad_map

    @property
    def heavy_pick(self):
        return self.res_heavy_pick

    @property
    def light(self):
        return self.res_light

    @property
    def num_tiles(self) -> int:
        return len(self.col_tile)


def select_dense_tiles(r, c, vt, *, tile_thr: int, a_budget_bytes: int):
    """Dense 128x128 tiles over rank-space endpoints (r = dst rank, c = src
    rank): tiles with >= tile_thr edges, trimmed to the 2 KB/tile budget by
    descending edge count. Returns (dense_edge mask, sorted tile ids, tid)."""
    max_tiles = max(a_budget_bytes // (TILE * AW * 4), 0)

    def select(counts):
        eligible = np.flatnonzero(counts >= max(tile_thr, 1))
        if len(eligible) > max_tiles:
            order = eligible[np.argsort(-counts[eligible], kind="stable")][:max_tiles]
            eligible = np.sort(order)
        return eligible

    if vt * vt <= 3 * 10**8:
        tid = (r // TILE).astype(np.int32) * np.int32(vt) + (c // TILE).astype(np.int32)
        eligible = select(np.bincount(tid, minlength=vt * vt))
        dense_tile_mask = np.zeros(vt * vt, dtype=bool)
        dense_tile_mask[eligible] = True
        dense_edge = dense_tile_mask[tid]
        dense_uniq = eligible.astype(np.int64)
    else:
        tid = (r.astype(np.int64) // TILE) * vt + (c.astype(np.int64) // TILE)
        uniq, inv, cnt = np.unique(tid, return_inverse=True, return_counts=True)
        eligible = select(cnt)
        is_dense_tile = np.zeros(len(uniq), dtype=bool)
        is_dense_tile[eligible] = True
        dense_edge = is_dense_tile[inv]
        dense_uniq = uniq[eligible]
    return dense_edge, dense_uniq, tid


def fill_a_tiles(dense_edge, dense_uniq, tid, r, c):
    """Bit-packed tiles: A[row, col] at [t, row % AW, col] bit row // AW."""
    nt = len(dense_uniq)
    a_tiles = np.zeros((max(nt, 1), AW, TILE), dtype=np.uint32)
    if nt:
        de = np.flatnonzero(dense_edge)
        slot = np.searchsorted(dense_uniq, tid[de])
        rin = (r[de] % TILE).astype(np.int64)
        flat = slot * (AW * TILE) + (rin % AW) * TILE + c[de] % TILE
        comb = (flat << np.int64(5)) | (rin // AW)
        comb.sort()
        vals = np.uint32(1) << (comb & 31).astype(np.uint32)
        f2 = comb >> np.int64(5)
        starts = np.flatnonzero(np.r_[True, np.diff(f2) != 0])
        a_tiles.reshape(-1)[f2[starts]] = np.bitwise_or.reduceat(vals, starts)
    return a_tiles


def build_hybrid(g: Graph, *, kcap: int = 64, tile_thr: int = 64,
                 a_budget_bytes: int = int(0.2e9)) -> HybridGraph:
    """Split ``g`` into dense tiles and a residual ELL (NumPy, on the host)."""
    v = g.num_vertices
    src, dst = g.coo
    in_deg, num_active, rank_order, rank = rank_vertices(src, dst, v)
    vt = -(-(num_active + 1) // TILE)
    r = rank[dst]
    c = rank[src]
    dense_edge, dense_uniq, tid = select_dense_tiles(
        r, c, vt, tile_thr=tile_thr, a_budget_bytes=a_budget_bytes
    )

    nt = len(dense_uniq)
    row_tiles = (dense_uniq // vt).astype(np.int64)
    col_tile = (dense_uniq % vt).astype(np.int32)
    row_start = np.searchsorted(row_tiles, np.arange(vt + 1)).astype(np.int32)
    a_tiles = fill_a_tiles(dense_edge, dense_uniq, tid, r, c)

    # Residual ELL, bucketed by residual in-degree, targets in rank0 ids.
    re_mask = ~dense_edge
    res_dst_rank = r[re_mask]
    res_src_rank = c[re_mask].astype(np.int32)
    res_deg_rank = np.bincount(res_dst_rank, minlength=v).astype(np.int64)
    r_order = np.argsort(-res_deg_rank, kind="stable").astype(np.int64)
    bucket_pos = np.empty(v, dtype=np.int64)
    bucket_pos[r_order] = np.arange(v)
    order_e = _lexsort_pairs(bucket_pos[res_dst_rank], res_src_rank)
    nbrs = res_src_rank[order_e]
    lens = res_deg_rank[r_order]
    new_rp = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(lens, out=new_rp[1:])

    sentinel = vt * TILE - 1
    (
        num_heavy, num_nonzero, num_virtual, fold_steps,
        virtual, fold_pad_map, heavy_pick, light,
    ) = bucketize_rows(lens, nbrs, new_rp, kcap, sentinel)

    inv_perm_ext = np.full(vt * TILE, num_nonzero, dtype=np.int32)
    inv_perm_ext[r_order[:num_nonzero]] = np.arange(num_nonzero, dtype=np.int32)

    return HybridGraph(
        num_vertices=v,
        num_edges=g.num_edges,
        undirected=g.undirected,
        kcap=kcap,
        num_active=num_active,
        vt=vt,
        old_of_new=rank_order,
        rank=rank,
        in_degree=in_deg,
        num_dense_edges=int(dense_edge.sum()),
        row_start=row_start,
        col_tile=col_tile,
        a_tiles=a_tiles if nt else a_tiles[:0],
        res_heavy=num_heavy,
        res_num_virtual=num_virtual,
        res_fold_steps=fold_steps,
        res_virtual=virtual,
        res_fold_pad_map=fold_pad_map,
        res_heavy_pick=heavy_pick,
        res_light=light,
        res_tail_rows=1,  # one shared all-zero output row
        inv_perm_ext=inv_perm_ext,
    )


def expand_spec(hg: HybridGraph) -> ExpandSpec:
    """Residual-ELL expansion spec of a hybrid graph."""
    return ExpandSpec(
        kcap=hg.kcap,
        heavy=hg.res_heavy > 0,
        num_virtual=hg.res_num_virtual,
        fold_steps=hg.res_fold_steps,
        light_meta=tuple((b.k, b.n) for b in hg.res_light),
        tail_rows=hg.res_tail_rows,
    )


def make_hit(hg: HybridGraph, w: int):
    """One level's hit table: the residual expansion (K1 per bucket)
    permuted back to rank0 rows, which the dense-tile pass (K2) ORs into
    in place."""
    expand_residual = make_expand(expand_spec(hg), w)

    def hit_of(arrs, fw):
        hit = expand_residual(arrs, fw).index_select(0, arrs["inv_perm_ext"])
        if hg.num_tiles:
            tile_spmm(
                arrs["row_start"], arrs["col_tile"], None, fw,
                num_row_tiles=hg.vt, masks=arrs["a_masks"], out=hit,
            )
        return hit

    return hit_of


class HybridMsBfsEngine(PackedRunProtocol):
    """Up to 8192 concurrent BFS sources by default (``max_lanes``; auto
    sizing walks down when the state does not fit): dense tiles through
    K2, the residual through K1. Results are PackedBatchResult. ``device``
    defaults to CUDA and raises when there is none."""

    def __init__(
        self,
        graph: Graph | HybridGraph,
        *,
        lanes: int | str = "auto",
        kcap: int = 64,
        tile_thr: int = 64,
        a_budget_bytes: int = int(0.2e9),
        num_planes: int | str = "auto",
        hbm_budget_bytes: int = HBM_BUDGET_BYTES,
        max_lanes: int = DEFAULT_MAX_LANES,
        device=None,
    ):
        if num_planes != "auto" and not (1 <= num_planes <= 8):
            raise ValueError("num_planes must be in [1, 8]")
        if max_lanes % 32 or not (32 <= max_lanes <= MAX_LANES):
            raise ValueError(f"max_lanes must be a multiple of 32 in [32, {MAX_LANES}]")
        self.device = resolve_device(device)
        max_lanes = floor_lanes(max_lanes)
        self.hg = (
            build_hybrid(graph, kcap=kcap, tile_thr=tile_thr, a_budget_bytes=a_budget_bytes)
            if isinstance(graph, Graph) else graph
        )
        hg = self.hg
        # The edge list for the parent scan's full ELL and the host path.
        self.host_graph = graph if isinstance(graph, Graph) else None
        rows = hg.vt * TILE
        sentinel = rows - 1
        host_tables = pallas_expand_arrays(hg, sentinel)
        fixed_bytes = (  # the tiles as K2's row masks, as large as the JAX layout
            arrs_nbytes(host_tables) + hg.a_tiles.nbytes + hg.inv_perm_ext.size * 8
        )
        sizing = dict(fixed_bytes=fixed_bytes, hbm_budget_bytes=hbm_budget_bytes)
        if num_planes == "auto" and lanes == "auto":
            # Trade depth (2**planes levels) for width, walking the width
            # ladder down from the cap (the JAX engine's rule).
            cand = max_lanes
            while True:
                num_planes = auto_planes(rows, max_lanes=cand, **sizing)
                lanes = auto_lanes(rows, num_planes, max_lanes=cand, **sizing)
                if lanes == cand or cand <= LANES:
                    break
                cand //= 2
        elif num_planes == "auto":
            num_planes = auto_planes(rows, max_lanes=max_lanes, **sizing)
        self.num_planes = num_planes
        self.max_levels_cap = min(1 << num_planes, 254)
        if lanes == "auto":
            lanes = auto_lanes(rows, num_planes, max_lanes=max_lanes, **sizing)
        if lanes % 32 or not (32 <= lanes <= MAX_LANES):
            raise ValueError(f"lanes must be a multiple of 32 in [32, {MAX_LANES}]")
        self.w = lanes // 32
        self.lanes = lanes
        self.undirected = hg.undirected
        dev = self.device
        arrs = expand_arrays(hg, sentinel, dev)
        arrs["inv_perm_ext"] = torch.from_numpy(hg.inv_perm_ext.astype(np.int64)).to(dev)
        if hg.num_tiles:
            arrs["row_start"] = torch.from_numpy(hg.row_start).to(dev)
            arrs["col_tile"] = torch.from_numpy(hg.col_tile).to(dev)
            # Only the row masks stay resident: the kernel and the twin read them.
            arrs["a_masks"] = row_masks(
                torch.from_numpy(np.ascontiguousarray(hg.a_tiles).view(np.int32)).to(dev)
            )
        self.arrs = arrs
        self._act = hg.num_active
        self._table_rows = rows
        self._core, self._core_from = make_packed_loop(make_hit(hg, self.w), num_planes)
        in_deg_ranked = hg.in_degree[hg.old_of_new].astype(np.int32)
        self._seed, self._lane_stats, self._extract_word, self._lane_ecc = make_state_kernels(
            hg.num_vertices, rows, self.w, num_planes,
            active=self._act, in_deg_host=in_deg_ranked, device=dev,
        )
        self._rank = hg.rank
        self._warmed = False

    @property
    def num_vertices(self) -> int:
        return self.hg.num_vertices

    def _full_parent_ell(self):
        """The parent scan's structure. The residual ELL misses the
        dense-tile edges, so this builds a full in-neighbor ELL of the
        retained host graph (the same rank order by construction), with
        tables the scanner owns and frees after the export."""
        return lazy_full_parent_ell(self.host_graph, self.hg.kcap)
