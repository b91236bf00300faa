"""Distributed hybrid (dense tiles + residual ELL) multi-source BFS over a
1D mesh, the port of ``tpu_bfs/parallel/dist_msbfs_hybrid.py``.

The mesh form of the flagship ``HybridMsBfsEngine``, with every O(V)-row
table sharded. Row tiles (128 rows of the active-first rank order) are
dealt round-robin, tile t to rank t % P; one ownership map covers the
dense tiles, the residual rows and the frontier, visited and plane shards
([rows_loc, w] a rank). The global row order of those tables ("tau") is
chip-major: rank p's rows are [p * rows_loc, (p + 1) * rows_loc).

Two layouts:

- ``gather`` (exchange 'dense' or 'sparse'): each level gathers the full
  frontier transiently (an ``all_gather`` of every rank's rows, or the
  sparse row gather), then K2 runs the rank's own row tiles and K1 its
  residual buckets against it, producing hits for exactly its own rows;
- ``sliced`` (exchange 'sliced'): edges regroup by (source rank, ring
  step), each rank expands against its resident frontier shard, and a
  [rows_loc, w] accumulator rotates the ring (``batch_isend_irecv``),
  landing home after P partial sums: no gathered frontier exists.

The claim, visited update and plane ripple run on own rows. One
``all_reduce`` (max) a level carries ``alive`` and, for the sparse
exchange, the next level's row count (and, with ``delta_bits``, its widest
row-id gap); with the pull gate the rank's own
gate values ride the same host read. The gather and sparse layouts with
``pull_gate`` skip settled rows' residual blocks inside K1 (counted in
128-row blocks, summed over the ranks); the sliced layout skips a rank's
contributions on a level whose resident frontier shard is empty (counted
in contributions, P a rank), as in JAX. A row is settled when every lane
of the batch has visited it (``host_lane_mask``).

The rank-local work of a level is fixed-shape programs between the host's
collectives (the AOT inventory, ``utils/aot.py``): in the gather layout
``dist_core`` is K1 on the gathered frontier, K2 into it and the settle
(the gated form carries ``needed`` and the lane mask, as JAX's does); in
the sliced layout ``dist_core`` is one ring step's contribution, called
once a step with that step's tables between the ring shifts, and
``dist_settle`` the settle. The gather, the sparse exchange's rung and the
ring shifts stay in the host loop.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import (
    ExpandSpec,
    PackedRunProtocol,
    gate_block_arrays,
    host_lane_mask,
    lazy_full_parent_ell,
    make_expand,
    make_gated_expand,
    packed_layout,
    ripple_increment_,
    seed_scatter_args,
)
from tpu_bfs_torch.algorithms.msbfs_hybrid import MAX_LANES, fill_a_tiles, select_dense_tiles
from tpu_bfs_torch.graph.csr import Graph, _sorted_pairs
from tpu_bfs_torch.graph.ell import _ell_fill, gate_forward_map, pad_heavy_shards, rank_vertices
from tpu_bfs_torch.ops.tile_spmm import AW, TILE, row_masks, tile_spmm
from tpu_bfs_torch.parallel.collectives import (
    RowGatherExchangeAccounting,
    branch_rung,
    row_gather_flags,
    rows_gather_branch,
    rows_gather_branch_count,
    sparse_rows_gather,
)
from tpu_bfs_torch.parallel.dist_msbfs_wide import (
    MeshAotHost,
    MeshTableHost,
    check_packed_mesh_knobs,
    resolve_mesh,
    resolve_row_caps,
    shard_expand_arrays,
)
from tpu_bfs_torch.parallel.mesh import Mesh
from tpu_bfs_torch.utils.aot import ArgSpec

W = 128
LANES = 32 * W
#: The dense tiles' storage budget (2 KB a tile), the JAX package's default.
A_BUDGET_BYTES = int(0.2e9)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _build_residual_groups(groups, rows_loc: int, n_minor: int, sentinel: int, kcap: int):
    """One bucketed ELL per edge group, every bucket shape padded to the
    maximum over the groups.

    ``groups`` holds ``(ldst, nbr)`` pairs: each group's local destination
    rows (in [0, rows_loc)) and neighbor ids (below ``n_minor``;
    ``sentinel`` pads the slots). Rows sort by group degree and bucket as
    in the single-device hybrid. Returns ``(spec, res_arrs, perm)``:
    stacked transposed tables ``[G, ...]`` (``virtual_t``, ``fold_pad_map``,
    ``heavy_pick``, ``light{i}_t``) and ``perm`` [G, rows_loc], each local
    row's bucket-output position (rows without edges: the zero row)."""
    per_group = []
    for ldst, nbr in groups:
        lens_local = np.bincount(ldst, minlength=rows_loc).astype(np.int64)
        order_rows = np.argsort(-lens_local, kind="stable").astype(np.int64)
        pos_of_row = np.empty(rows_loc, dtype=np.int64)
        pos_of_row[order_rows] = np.arange(rows_loc)
        # Neighbors grouped by (sorted row, neighbor id), deterministic.
        _, nbrs = _sorted_pairs(pos_of_row[ldst], nbr.astype(np.int64), n_minor)
        lens = lens_local[order_rows]
        rp = np.zeros(rows_loc + 1, dtype=np.int64)
        np.cumsum(lens, out=rp[1:])
        per_group.append((lens, nbrs.astype(np.int32), rp, order_rows))

    nh_p = [int(np.searchsorted(-t[0], -kcap, side="left")) for t in per_group]
    nh, num_virtual, fold_steps, _m2, virtual_s, fold_pad_map_s, heavy_pick_s = (
        pad_heavy_shards([t[0][:n] for t, n in zip(per_group, nh_p)],
                         [t[1][: int(t[2][n])] for t, n in zip(per_group, nh_p)],
                         kcap, sentinel))

    # The light ladder: the union of the groups' buckets, counts padded.
    nz_p = [int(np.searchsorted(-t[0], 0, side="left")) for t in per_group]
    bounds_p = []  # per group: {k: (lo, hi)} sorted-row ranges
    for (lens, _, _, _), n_h, nz in zip(per_group, nh_p, nz_p):
        row, k, b = n_h, kcap, {}
        while row < nz and k >= 1:
            hi = nz if k == 1 else int(np.searchsorted(-lens, -(k // 2 + 1), side="right"))
            if hi > row:
                b[k] = (row, hi)
                row = hi
            k //= 2
        bounds_p.append(b)
    ks = [k for k in (kcap >> i for i in range(kcap.bit_length()))
          if k >= 1 and any(k in b for b in bounds_p)]
    n_of_k = {k: max(b[k][1] - b[k][0] if k in b else 0 for b in bounds_p) for k in ks}
    light_s = []
    for k in ks:
        blocks = []
        for (lens, nbrs, rp, _), b in zip(per_group, bounds_p):
            lo, hi = b.get(k, (0, 0))
            filled = _ell_fill(lens[lo:hi], nbrs[int(rp[lo]) : int(rp[hi])], k, sentinel)
            pad = np.full((n_of_k[k] - (hi - lo), k), sentinel, np.int32)
            blocks.append(np.concatenate([filled, pad]) if len(pad) else filled)
        light_s.append((k, np.stack(blocks)))

    out_height = nh + sum(n_of_k[k] for k in ks) + 1  # + the zero row
    perms = []
    for (_, _, _, order_rows), n_h, b in zip(per_group, nh_p, bounds_p):
        pos_of_sorted = np.full(rows_loc, out_height - 1, dtype=np.int32)
        pos_of_sorted[:n_h] = np.arange(n_h, dtype=np.int32)
        off = nh
        for k in ks:
            lo, hi = b.get(k, (0, 0))
            pos_of_sorted[lo:hi] = off + np.arange(hi - lo, dtype=np.int32)
            off += n_of_k[k]
        perm = np.empty(rows_loc, dtype=np.int32)
        perm[order_rows] = pos_of_sorted
        perms.append(perm)

    spec = ExpandSpec(kcap=kcap, heavy=nh > 0, num_virtual=num_virtual,
                      fold_steps=fold_steps, light_meta=tuple((k, n_of_k[k]) for k in ks),
                      tail_rows=1)
    res_arrs = {}
    if nh > 0:
        res_arrs["virtual_t"] = np.ascontiguousarray(virtual_s.transpose(0, 2, 1))
        res_arrs["fold_pad_map"] = fold_pad_map_s
        res_arrs["heavy_pick"] = heavy_pick_s
    for i, (_k, blocks) in enumerate(light_s):
        res_arrs[f"light{i}_t"] = np.ascontiguousarray(blocks.transpose(0, 2, 1))
    return spec, res_arrs, np.stack(perms)


def _build_residual_shards(res_dst, res_src_rank, p_count: int, nrt: int, rows: int,
                           kcap: int):
    """The gather layout's residual: one group per rank, its own rows'
    residual in-edges, neighbor ids global rank0 rows (sentinel
    ``rows - 1``, a pad row every frontier keeps zero)."""
    rows_loc = nrt * TILE
    g_tile = res_dst // TILE
    owner = g_tile % p_count
    local_row = (g_tile // p_count) * TILE + res_dst % TILE
    groups = []
    for p in range(p_count):
        sel = np.flatnonzero(owner == p)
        groups.append((local_row[sel], res_src_rank[sel]))
    return _build_residual_groups(groups, rows_loc, rows, rows - 1, kcap)


def _build_residual_pair_shards(res_dst, res_src_rank, p_count: int, nrt: int, kcap: int):
    """The sliced layout's residual: P * P groups, one per (source rank p,
    ring step s), holding the edges from rows of p's frontier shard to rows
    owned by d = (p - s - 1) mod P. At step s rank p adds its contribution
    to the accumulator bound for d and passes it on; after P steps each
    accumulator is home. Neighbor ids are local to the source shard
    (sentinel ``rows_loc``, an appended zero row). Returns ``(spec,
    res_arrs [P, P, ...], perm [P, P, rows_loc])``."""
    rows_loc = nrt * TILE
    d_tile = res_dst // TILE
    dst_owner = d_tile % p_count
    dst_local = (d_tile // p_count) * TILE + res_dst % TILE
    s_tile = res_src_rank // TILE
    src_owner = s_tile % p_count
    src_local = (s_tile // p_count) * TILE + res_src_rank % TILE
    groups = []
    for p in range(p_count):
        for s in range(p_count):
            d = (p - s - 1) % p_count
            sel = np.flatnonzero((src_owner == p) & (dst_owner == d))
            groups.append((dst_local[sel], src_local[sel]))
    spec, res_arrs, perm = _build_residual_groups(groups, rows_loc, rows_loc + 1, rows_loc,
                                                  kcap)
    res_arrs = {k: a.reshape((p_count, p_count) + a.shape[1:]) for k, a in res_arrs.items()}
    return spec, res_arrs, perm.reshape(p_count, p_count, rows_loc)


def build_dist_hybrid(g: Graph, num_shards: int, *, kcap: int = 64, tile_thr: int = 64,
                      layout: str = "gather") -> dict:
    """Sharded dense tiles, per-rank residual ELL and the maps between them,
    as a dict of host arrays (the JAX package's keys). Every rank of a mesh
    builds it whole (the shapes are maxima over the ranks) and keeps its
    own slice. ``layout`` is 'gather' or 'sliced' (see the module)."""
    if layout not in ("gather", "sliced"):
        raise ValueError(f"unknown layout {layout!r}; have 'gather', 'sliced'")
    p_count = num_shards
    v = g.num_vertices
    src, dst = g.coo
    in_deg, num_active, rank_order, rank = rank_vertices(src, dst, v)

    # Row tiles over the active rows, a multiple of P of them.
    vt = _round_up(-(-(num_active + 1) // TILE), p_count)
    rows = vt * TILE
    nrt = vt // p_count
    r = rank[dst]
    c = rank[src]
    dense_edge, dense_uniq, tid = select_dense_tiles(
        r, c, vt, tile_thr=tile_thr, a_budget_bytes=A_BUDGET_BYTES)

    nt = len(dense_uniq)
    g_row_tile = dense_uniq // vt
    g_col_tile = (dense_uniq % vt).astype(np.int32)
    a_global = (fill_a_tiles(dense_edge, dense_uniq, tid, r, c) if nt
                else np.zeros((1, AW, TILE), np.uint32))
    if layout == "gather":
        # A tile belongs to its row tile's rank; columns index the gathered frontier.
        owner = (g_row_tile % p_count).astype(np.int64)
        nt_max = max(int(np.bincount(owner, minlength=p_count).max(initial=0)), 1)
        row_start_s = np.zeros((p_count, nrt + 1), np.int32)
        col_tile_s = np.zeros((p_count, nt_max), np.int32)
        a_tiles_s = np.zeros((p_count, nt_max, AW, TILE), np.uint32)
        if nt:
            for p in range(p_count):
                mine = np.flatnonzero(owner == p)
                local_rt = (g_row_tile[mine] // p_count).astype(np.int64)
                row_start_s[p] = np.searchsorted(local_rt, np.arange(nrt + 1)).astype(np.int32)
                col_tile_s[p, : len(mine)] = g_col_tile[mine]
                a_tiles_s[p, : len(mine)] = a_global[mine]
    else:
        # A tile lives with its source columns (rank col_tile % P), at the
        # ring step toward its row tile's rank; columns index the resident
        # frontier shard (local col tile = col_tile // P).
        src_own = (g_col_tile % p_count).astype(np.int64)
        dst_own = (g_row_tile % p_count).astype(np.int64)
        pair = src_own * p_count + (src_own - dst_own - 1) % p_count
        nt_max = max(int(np.bincount(pair, minlength=p_count * p_count).max(initial=0)), 1)
        row_start_s = np.zeros((p_count, p_count, nrt + 1), np.int32)
        col_tile_s = np.zeros((p_count, p_count, nt_max), np.int32)
        a_tiles_s = np.zeros((p_count, p_count, nt_max, AW, TILE), np.uint32)
        if nt:
            for p in range(p_count):
                for s in range(p_count):
                    mine = np.flatnonzero(pair == p * p_count + s)
                    local_rt = (g_row_tile[mine] // p_count).astype(np.int64)
                    order = np.argsort(local_rt, kind="stable")
                    mine, local_rt = mine[order], local_rt[order]
                    row_start_s[p, s] = np.searchsorted(
                        local_rt, np.arange(nrt + 1)).astype(np.int32)
                    col_tile_s[p, s, : len(mine)] = g_col_tile[mine] // p_count
                    a_tiles_s[p, s, : len(mine)] = a_global[mine]

    re_mask = ~dense_edge
    if layout == "gather":
        spec, res_arrs, perm_s = _build_residual_shards(
            r[re_mask].astype(np.int64), c[re_mask].astype(np.int32), p_count, nrt, rows, kcap)
    else:
        spec, res_arrs, perm_s = _build_residual_pair_shards(
            r[re_mask].astype(np.int64), c[re_mask].astype(np.int64), p_count, nrt, kcap)

    # Valid rows: each rank's real active rows (global rank0 row < active).
    rows_loc = nrt * TILE
    j = np.arange(rows_loc) // TILE
    i = np.arange(rows_loc) % TILE
    g_rows = (j[None, :] * p_count + np.arange(p_count)[:, None]) * TILE + i
    valid_s = ((g_rows < num_active).astype(np.uint32) * np.uint32(0xFFFFFFFF))[:, :, None]

    # Vertex -> tau row; isolated vertices (rank >= active) -> rows (no row).
    g_tile_of = rank // TILE
    tau = ((g_tile_of % p_count).astype(np.int64) * rows_loc
           + (g_tile_of // p_count).astype(np.int64) * TILE + rank % TILE)
    tau_of_vertex = np.where(rank < num_active, tau, rows).astype(np.int64)

    return {
        "layout": layout, "num_vertices": v, "num_active": num_active,
        "num_edges": g.num_edges, "undirected": g.undirected, "num_shards": p_count,
        "vt": vt, "rows": rows, "rank": rank, "old_of_new": rank_order,
        "in_degree": in_deg, "tau_of_vertex": tau_of_vertex,
        "num_dense_edges": int(dense_edge.sum()), "num_tiles": nt,
        "row_start_s": row_start_s, "col_tile_s": col_tile_s, "a_tiles_s": a_tiles_s,
        "res_spec": spec, "res_arrs": res_arrs, "perm_s": perm_s, "valid_s": valid_s,
    }


class DistHybridMsBfsEngine(MeshAotHost, MeshTableHost, RowGatherExchangeAccounting,
                            PackedRunProtocol):
    """Mesh hybrid multi-source BFS: dense tiles through K2, the residual
    through K1, every table sharded [rows_loc, w] a rank (tau order). Built
    inside every rank of ``mesh`` (default: this process's rank group, CUDA
    unless ``device`` names another), from a Graph or a prebuilt
    :func:`build_dist_hybrid` dict of the exchange's layout. ``lanes`` is a
    multiple of 32 (both CUDA kernels take any width), 4096 by default as
    in JAX.

    ``sparse_caps`` and ``delta_bits`` shape the sparse row gather, and
    ``wire_pack`` is accepted and recorded, as in ``DistWideMsBfsEngine``.

    ``pull_gate=True`` works on every exchange. The unit of
    ``last_gate_level_counts`` differs by layout, as in JAX: the gather
    layout counts skipped 128-row residual blocks, the sliced one skipped
    contributions (a rank with an empty resident frontier skips all P).

    Device memory a rank: (num_planes + 2) own tables of rows_loc x 4w
    bytes, plus a level's transients: the gathered frontier (rows x 4w) in
    the gather layout, two own-sized tables in the sliced one."""

    def __init__(
        self,
        graph: Graph | dict,
        mesh: Mesh | None = None,
        *,
        kcap: int = 64,
        tile_thr: int = 64,
        num_planes: int = 5,
        exchange: str = "dense",
        lanes: int = LANES,
        pull_gate: bool = False,
        sparse_caps=None,
        wire_pack: bool = False,
        delta_bits=(),
        device=None,
    ):
        if not (1 <= num_planes <= 8):
            raise ValueError("num_planes must be in [1, 8]")
        self.delta_bits = check_packed_mesh_knobs(exchange, delta_bits)
        self.wire_pack = bool(wire_pack)
        if exchange not in ("dense", "sparse", "sliced"):
            raise ValueError(f"unknown exchange {exchange!r}; have 'dense', 'sparse', 'sliced'")
        if lanes % 32 or not (32 <= lanes <= MAX_LANES):
            raise ValueError(f"lanes must be a multiple of 32 in [32, {MAX_LANES}]")
        self.mesh = resolve_mesh(mesh, device)
        self.device = dev = self.mesh.device
        self.w, self.lanes, self.num_planes = lanes // 32, lanes, num_planes
        self.max_levels_cap = min(1 << num_planes, 254)
        p_count, p = self.mesh.num_shards, self.mesh.rank
        layout = "sliced" if exchange == "sliced" else "gather"
        hd = (build_dist_hybrid(graph, p_count, kcap=kcap, tile_thr=tile_thr, layout=layout)
              if isinstance(graph, Graph) else graph)
        if hd["num_shards"] != p_count:
            raise ValueError(f"built for {hd['num_shards']} shards, mesh has {p_count}")
        if hd.get("layout", "gather") != layout:
            raise ValueError(
                f"prebuilt shard dict has layout {hd.get('layout', 'gather')!r} "
                f"but exchange {exchange!r} needs {layout!r}")
        self.hd = hd
        self._parent_kcap = kcap
        # The edge list for the parent scan's full ELL; a prebuilt dict has none.
        self.host_graph = graph if isinstance(graph, Graph) else None
        self.undirected = hd["undirected"]
        self._exchange, self._sliced = exchange, layout == "sliced"
        rows = hd["rows"]
        self._nrt = nrt = hd["vt"] // p_count
        rows_loc = nrt * TILE
        spec = hd["res_spec"]
        self._has_dense = hd["num_tiles"] > 0
        self._expand = make_expand(spec, self.w)

        def group_arrs(idx, sentinel):
            """Device tables of one residual group and its dense tiles."""
            res = hd["res_arrs"]
            arrs = shard_expand_arrays(
                res["virtual_t"][idx] if spec.heavy else None,
                res["fold_pad_map"][idx] if spec.heavy else None,
                res["heavy_pick"][idx] if spec.heavy else None,
                [res[f"light{i}_t"][idx] for i in range(len(spec.light_meta))], sentinel, dev)
            arrs["perm"] = torch.from_numpy(hd["perm_s"][idx].astype(np.int64)).to(dev)
            if self._has_dense:
                arrs["row_start"] = torch.from_numpy(hd["row_start_s"][idx]).to(dev)
                arrs["col_tile"] = torch.from_numpy(hd["col_tile_s"][idx]).to(dev)
                arrs["a_masks"] = row_masks(torch.from_numpy(
                    np.ascontiguousarray(hd["a_tiles_s"][idx]).view(np.int32)).to(dev))
            return arrs

        if self._sliced:  # one group a ring step, sentinel = the appended zero row
            self._steps = [group_arrs((p, s), rows_loc) for s in range(p_count)]
            self.arrs = self._steps[0]
            self._dist_core, self._dist_settle = self._ring_step, self._sliced_settle
        else:
            self.arrs = group_arrs(p, rows - 1)
            self._dist_core = self._gated_step if pull_gate else self._gather_step

        self.sparse_caps = resolve_row_caps(sparse_caps, rows_loc, self.w, self.delta_bits)
        self._nb = (rows_gather_branch_count(self.sparse_caps, self.delta_bits)
                    if exchange == "sparse" else 1)
        self._gather_p, self._gather_rows_loc = p_count, rows_loc

        self.pull_gate = pull_gate
        if pull_gate and not self._sliced:
            # Bucket outputs are in bucket order: the forward routing map
            # takes the per-row unsettled mask there.
            nh = hd["res_arrs"]["heavy_pick"].shape[1] if spec.heavy else 0
            out_height = nh + sum(n for _, n in spec.light_meta) + spec.tail_rows
            self.arrs["gate_fwd"] = torch.from_numpy(gate_forward_map(
                hd["perm_s"][p], out_height, out_height - 1).astype(np.int64)).to(dev)
            self._heavy_rows = nh
            self.arrs.update(gate_block_arrays(spec, self.arrs))
            self._gated_expand = make_gated_expand(spec, self.w)
            self.arrs["valid"] = torch.from_numpy(hd["valid_s"][p, :, 0] != 0).to(dev)

        self._rank = hd["tau_of_vertex"]
        self._table_rows = self._act = rows
        in_deg_tau = np.zeros(rows, dtype=np.int32)
        valid_v = hd["tau_of_vertex"] < rows
        in_deg_tau[hd["tau_of_vertex"][valid_v]] = hd["in_degree"][valid_v]
        self._init_mesh_state(rows_loc, in_deg_tau[p * rows_loc : (p + 1) * rows_loc])
        self._warmed = False

    @property
    def num_vertices(self) -> int:
        return self.hd["num_vertices"]

    def _note_batch_sources(self, sources) -> None:
        """The batch's lane mask, for the gather layout's gate."""
        if self.pull_gate:
            mask = host_lane_mask(self._rank[np.asarray(sources, dtype=np.int64)], self._act,
                                  self.w)
            self._lane_mask = torch.from_numpy(mask.view(np.int32)).to(self.device)

    def _note_resume_state(self, vis_host) -> None:
        """Nothing: the loop reads the first level's gate on the device."""

    def _seed_dev(self, sources: np.ndarray) -> torch.Tensor:
        """This rank's [rows_loc, w] rows of the tau-order seed table."""
        rws, words, bits = seed_scatter_args(self._rank[sources], self._act)
        r0 = self.mesh.rank * self._rows_loc
        mine = (rws >= r0) & (rws < r0 + self._rows_loc)
        fw0 = torch.zeros((self._rows_loc, self.w), dtype=torch.int32, device=self.device)
        dev = self.device
        fw0.index_put_((torch.from_numpy(rws[mine] - r0).to(dev),
                        torch.from_numpy(words[mine]).to(dev)),
                       torch.from_numpy(bits[mine]).to(dev), accumulate=True)
        return fw0

    # --- one level's pieces -------------------------------------------------

    def _gather(self, fw: torch.Tensor, branch: int) -> torch.Tensor:
        """The full [rows, w] frontier in rank0 order from every rank's
        rows: global tile t = local tile j * P + rank p."""
        p_count, p, nrt, w = self.mesh.num_shards, self.mesh.rank, self._nrt, self.w
        rows = self.hd["rows"]
        rung = branch_rung(branch, self.sparse_caps, self.delta_bits)
        if self._exchange == "sparse" and rung is not None:
            return sparse_rows_gather(
                self.mesh, fw, cap=rung[0], bits=rung[1], out_rows=rows,
                gid_of=lambda ids: ((ids // TILE) * p_count + p) * TILE + ids % TILE,
                gid_of_src=lambda ids, src: ((ids // TILE) * p_count + src) * TILE + ids % TILE,
            )[:rows]
        ag = self.mesh.all_gather_rows(fw).view(p_count, nrt, TILE, w)
        return ag.transpose(0, 1).reshape(rows, w)

    def _contrib(self, arrs, fw_src, fw_ext, needed=None, heavy=True):
        """One group's hits on own rows: K1's residual routed to local rows,
        then K2 ORed in place. ``needed`` (bucket order) gates K1."""
        if needed is None:
            res, skipped = self._expand(arrs, fw_ext), None
        else:
            res, skipped = self._gated_expand(arrs, fw_ext, needed, heavy)
        hit = res.index_select(0, arrs["perm"])
        if self._has_dense:
            tile_spmm(arrs["row_start"], arrs["col_tile"], None, fw_src,
                      num_row_tiles=self._nrt, masks=arrs["a_masks"], out=hit)
        return hit, skipped

    # --- the rank-local programs (the AOT inventory) -------------------------

    def _row_flags(self, nxt):
        """The level's device flags for the host's all-reduce (MAX):
        ``alive`` and, for the sparse exchange, the next level's row count
        (and widest id gap)."""
        flags = nxt.any().to(torch.int32).reshape(1)
        if self._nb > 1:
            flags = torch.cat([flags, row_gather_flags((nxt != 0).any(dim=1), self.delta_bits)])
        return flags

    def _settle(self, hit, vis, planes):
        """The claim ``hit & ~vis``, the visited OR and the plane ripple on
        own rows (``vis`` and ``planes`` in place): ``(nxt, flags)``."""
        hit &= ~vis
        vis |= hit
        ripple_increment_(planes, ~vis)
        return hit, self._row_flags(hit)

    def _gather_step(self, arrs, fw_g, vis, planes):
        """The gather layout's ``dist_core``: the rank's hits from the
        gathered frontier (K1's residual, K2 ORed in), then the settle."""
        return self._settle(self._contrib(arrs, fw_g, fw_g)[0], vis, planes)

    def _gated_step(self, arrs, fw_g, vis, planes, needed, lane_mask, heavy=True):
        """The gated gather layout's level: the expansion gated by
        ``needed`` (bucket order) and ``heavy``, the settle, and the next
        level's ``needed`` and this rank's heavy flag from the new visited
        table. Returns ``(nxt, flags, gate, needed, skipped)``. With the heavy
        section on it is the ``dist_core`` program; a level whose gate skips
        the heavy section runs it eagerly, as the single-device gate does."""
        hit, skipped = self._contrib(arrs, fw_g, fw_g, needed, heavy)
        nxt, flags = self._settle(hit, vis, planes)
        needed = self._needed(arrs, vis, lane_mask)
        gate = needed[: self._heavy_rows].any().to(torch.int32).reshape(1)
        return nxt, flags, gate, needed, skipped

    def _ring_step(self, arrs, fw, fw_ext):
        """The sliced layout's ``dist_core``: one ring step's contribution
        to the accumulator, from that step's tables (``arrs``) and the
        resident frontier shard (``fw_ext`` with its appended zero row)."""
        return self._contrib(arrs, fw, fw_ext)[0]

    def _sliced_settle(self, hit, vis, planes):
        """The sliced layout's ``dist_settle``: the settle of the rotated-home
        accumulator and this rank's gate value for the next level (its new
        resident frontier is empty): ``(nxt, flags, gate)``."""
        nxt, flags = self._settle(hit, vis, planes)
        return nxt, flags, (nxt == 0).all().to(torch.int32).reshape(1)

    @property
    def _aot_world(self) -> Mesh:
        return self.mesh

    def _aot_layout_of(self) -> dict:
        return dict(packed_layout(self, self.hd["res_spec"], rows_loc=self._rows_loc,
                                  nrt=self._nrt, dense=self._has_dense, sliced=self._sliced,
                                  heavy_rows=getattr(self, "_heavy_rows", 0),
                                  gated=self.pull_gate),
                    delta_bits=list(self.delta_bits))

    def _aot_programs(self):
        """The AOT inventory, JAX's names: ``dist_core``, this rank's step
        (the gather layout's :meth:`_gather_step`, or :meth:`_gated_step`
        carrying ``needed`` and the lane mask; the sliced layout's
        :meth:`_ring_step`, called once a ring step with that step's
        tables), and in the sliced layout ``dist_settle``
        (:meth:`_sliced_settle`). The state tables are :class:`ArgSpec`."""
        dev, w = self.device, self.w
        own = ArgSpec((self._rows_loc, w), torch.int32, dev)
        planes = (own,) * self.num_planes

        def orig(attr):
            fn = getattr(self, attr)
            return getattr(fn, "_aot_original", fn)

        if self._sliced:
            ext = ArgSpec((self._rows_loc + 1, w), torch.int32, dev)
            return [("dist_core", "_dist_core", orig("_dist_core"), (self.arrs, own, ext)),
                    ("dist_settle", "_dist_settle", orig("_dist_settle"), (own, own, planes))]
        fw_g = ArgSpec((self.hd["rows"], w), torch.int32, dev)
        args = (self.arrs, fw_g, own, planes)
        if self.pull_gate:
            args += (ArgSpec((self.arrs["gate_fwd"].shape[0],), torch.bool, dev),
                     ArgSpec((w,), torch.int32, dev))
        return [("dist_core", "_dist_core", orig("_dist_core"), args)]

    # --- the level loop -------------------------------------------------------

    def _hit(self, fw, vis, branch: int, gate):
        """(own hits, skipped) of one level, eagerly (the truncation probe).
        ``gate`` is the host's view of this level's gate: the heavy flag
        (gather layout) or whether the resident frontier is empty (sliced),
        None ungated."""
        if self._sliced:
            return self._hit_sliced(fw, gate)
        fw_g = self._gather(fw, branch)
        if gate is None:
            return self._contrib(self.arrs, fw_g, fw_g)[0], 0
        return self._contrib(self.arrs, fw_g, fw_g,
                             self._needed(self.arrs, vis, self._lane_mask), gate)

    def _hit_sliced(self, fw, empty):
        """The ring: at step s this rank adds its group (rank, s) to the
        accumulator and passes it to rank + 1; after P steps its own is home.
        Each step's contribution is one call of ``_dist_core`` (read anew, so
        an adopted program takes over) with that step's tables. Gated, a
        rank whose resident frontier is empty adds nothing (its P
        contributions are skipped); the rotation always runs."""
        p_count = self.mesh.num_shards
        fw_ext = torch.cat([fw, torch.zeros((1, self.w), dtype=fw.dtype, device=fw.device)])

        def step(s):
            if empty:
                return torch.zeros_like(fw)
            return self._dist_core(self._steps[s], fw, fw_ext)

        acc = step(0)
        for s in range(1, p_count):
            acc = self.mesh.ring_shift(acc)
            acc |= step(s)
        return acc, (p_count if empty else 0)

    def _needed(self, arrs, vis, lane_mask):
        """Bucket-order needed rows: own real rows that a batch lane has
        not visited."""
        m = lane_mask[None, :]
        need = ((vis & m) != m).any(dim=1) & arrs["valid"]
        return torch.cat([need, need.new_zeros(1)]).index_select(0, arrs["gate_fwd"])

    def _flags_of(self, nxt, vis):
        """Eager ``(flags, gate, needed)`` of a frontier ``nxt`` and its
        visited table: the first level's read, and the truncation probe's."""
        gate = needed = None
        if self.pull_gate and self._sliced:
            gate = (nxt == 0).all().to(torch.int32).reshape(1)
        elif self.pull_gate:
            needed = self._needed(self.arrs, vis, self._lane_mask)
            gate = needed[: self._heavy_rows].any().to(torch.int32).reshape(1)
        return self._row_flags(nxt), gate, needed

    def _read(self, flags, gate):
        """The level's one host read: ``alive`` and the next level's
        exchange branch (from the largest row count and id gap over the
        ranks, all-reduced), and this rank's gate value (None ungated)."""
        self.mesh.all_reduce_(flags, "max")
        nf = flags.shape[0]
        if gate is not None:
            flags = torch.cat([flags, gate])
        vals = flags.tolist()
        branch = (rows_gather_branch(vals[1], vals[nf - 1], self.sparse_caps, self.delta_bits)
                  if self._nb > 1 else 0)
        return bool(vals[0]), branch, bool(vals[-1]) if gate is not None else None

    def _level(self, fw, vis, planes, branch: int, gate, needed):
        """One level through the rank-local programs (read anew each level,
        so adopted ones take over); the exchanges and the ring stay here.
        Returns ``(nxt, flags, gate, needed, skipped)``."""
        if self._sliced:
            hit, skipped = self._hit_sliced(fw, gate)
            nxt, flags, g = self._dist_settle(hit, vis, planes)
            return nxt, flags, g if self.pull_gate else None, None, skipped
        fw_g = self._gather(fw, branch)
        if not self.pull_gate:
            nxt, flags = self._dist_core(self.arrs, fw_g, vis, planes)
            return nxt, flags, None, None, 0
        if gate or not self._heavy_rows:
            return self._dist_core(self.arrs, fw_g, vis, planes, needed, self._lane_mask)
        return self._gated_step(self.arrs, fw_g, vis, planes, needed, self._lane_mask,
                                heavy=False)

    def _loop(self, fw, vis, planes, level0, max_levels):
        """The level loop. Returns the state, the branch counts, the skipped
        units per level (gated), the last read and the host reads."""
        gated = self.pull_gate
        counts = np.zeros(self._nb, dtype=np.int32)
        skips = np.zeros(self.max_levels_cap, dtype=np.int64)
        branch, gate, needed, syncs = 0, None, None, 0
        if self._nb > 1 or gated:
            # The first level's rung and gate come from the starting state.
            flags, g, needed = self._flags_of(fw, vis)
            _, branch, gate = self._read(flags, g)
            syncs += 1
        level, alive = int(level0), True
        while alive and level < max_levels:
            counts[branch] += 1
            fw, flags, g, needed, skipped = self._level(fw, vis, planes, branch, gate, needed)
            if gated:
                skips[min(level, self.max_levels_cap - 1)] = int(skipped)
            alive, branch, gate = self._read(flags, g)
            syncs += 1
            level += 1
        self.last_host_syncs = syncs
        return fw, vis, planes, level, alive, counts, skips, (branch, gate)

    def _record_gate(self, skips) -> None:
        if self.pull_gate:
            t = torch.from_numpy(skips).to(self.device)
            self.last_gate_level_counts = self.mesh.all_reduce_(t, "sum")

    def _core(self, arrs, fw0, max_levels):
        vis = fw0.clone()
        planes = tuple(torch.zeros_like(vis) for _ in range(self.num_planes))
        fw, vis, planes, levels, alive, counts, skips, last = self._loop(
            fw0, vis, planes, 0, max_levels)
        truncated = alive and levels >= max_levels and self._probe(fw, vis, last)
        self._record_exchange(counts, 0)
        self._record_gate(skips)
        return planes, vis, levels, alive, truncated

    def _core_from(self, arrs, fw, vis, planes, level0, max_levels):
        fw, vis, planes, level, alive, counts, skips, _ = self._loop(
            fw, vis, planes, level0, max_levels)
        self._record_exchange(counts, int(level0), getattr(self, "_pending_chain_nonce", None))
        self._record_gate(skips)
        return fw, vis, planes, level, alive

    def _probe(self, fw, vis, last) -> bool:
        """Whether one more level would claim (claim-free; state untouched)."""
        branch, gate = last
        return self._any(self._hit(fw, vis, branch, gate)[0] & ~vis)

    def _deeper(self, arrs, fw, vis) -> bool:
        flags, g, _ = self._flags_of(fw, vis)
        _, branch, gate = self._read(flags, g)
        return self._probe(fw, vis, (branch, gate))

    def _full_parent_ell(self):
        """The parent scan's structure: neither the dense tiles nor the
        residual shards cover the graph, so a full in-neighbor ELL of the
        retained host graph, built on every rank; the scan's row map reaches
        the tau-order tables."""
        return lazy_full_parent_ell(self.host_graph, self._parent_kcap)
