"""Distributed bit-packed multi-source BFS over a 1D mesh, the port of
``tpu_bfs/parallel/dist_msbfs_wide.py``.

The mesh form of the wide engine (``algorithms/msbfs_wide.py``). The ELL
edge structure is sharded, rows dealt round-robin over the degree-sorted
order (``graph/ell.build_ell_sharded``); the packed frontier words are
replicated, [v_pad + 1, w] in rank order with the all-zero sentinel row.
Each rank runs, per level:

- K1 over its shard's buckets against the replicated frontier, giving its
  own rows' hits; the claim ``hit & ~visited`` and the plane ripple on its
  own [v_loc, w] rows;
- these and the level's device flags below are one fixed-shape
  rank-local step (``_dist_core``, the ``dist_core`` program of the
  engine's AOT inventory, ``utils/aot.py``);
- one ``all_reduce`` (max) of the ``alive`` flag and, for the sparse
  exchange, its new-frontier row count (and, with ``delta_bits``, the
  widest gap between its row ids): the level's one host read;
- the exchange that rebuilds the replicated frontier: ``dense``, an
  ``all_gather`` of every rank's rows, or ``sparse``, the row gather of
  ``collectives.sparse_rows_gather`` at the rung (and id encoding) the
  count and gap pick.

Result tables are chip-major: row ``p * v_loc + l`` holds global rank
``l * P + p``, and ``_rank`` maps vertex ids straight to those rows. A
rank keeps only its own rows; the lazy extraction gathers one 32-lane
distance column when a lane is asked for, and every rank asks in the same
order (SPMD). The default width stays the JAX mesh engines' 4096 lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import (
    ExpandSpec,
    PackedRunProtocol,
    device_expand_arrays,
    expand_arrays,
    lazy_full_parent_ell,
    make_expand,
    make_state_kernels,
    min_lane,
    packed_layout,
    ripple_increment_,
    seed_scatter_args,
)
from tpu_bfs_torch.algorithms.msbfs_wide import MAX_LANES
from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.ell import ShardedEllGraph, build_ell_sharded, pad_gate_blocks
from tpu_bfs_torch.parallel.collectives import (
    RowGatherExchangeAccounting,
    branch_rung,
    check_delta_bits,
    default_row_gather_caps,
    normalize_caps,
    row_gather_flags,
    rows_gather_branch,
    rows_gather_branch_count,
    sparse_rows_gather,
)
from tpu_bfs_torch.parallel.mesh import Mesh, make_mesh
from tpu_bfs_torch.utils.aot import ArgSpec

W = 128
LANES = 32 * W


def shard_expand_arrays(virtual_t, fold_pad_map, heavy_pick, light_t, sentinel: int,
                        device) -> dict:
    """``expand_arrays`` of one shard, from its transposed bucket tables
    (``virtual_t`` [kcap, M] or None, ``light_t`` [[k, n], ...]), each
    padded to whole 128-row blocks with ``sentinel``."""
    tables = {} if virtual_t is None else {"virtual_gt": pad_gate_blocks(virtual_t, sentinel)}
    tables.update({f"light{i}_gt": pad_gate_blocks(t, sentinel) for i, t in enumerate(light_t)})
    return device_expand_arrays(tables, fold_pad_map, heavy_pick, device)


class MeshTableHost:
    """State tables of a mesh engine: each rank holds its [rows_loc, w]
    rows of a chip-major table. Lane stats reduce over the ranks, a
    distance column is gathered when asked for, and checkpoint tables are
    assembled (``_gather_rows``) and split (``_own_rows``) by rank. Hosts
    call :meth:`_init_mesh_state` after setting ``mesh``, ``w``,
    ``num_planes`` and ``device``."""

    def _init_mesh_state(self, rows_loc: int, in_deg_local: np.ndarray) -> None:
        self._rows_loc = rows_loc
        _, self._stats_loc, self._extract_loc, self._ecc_loc, self._in_deg = make_state_kernels(
            rows_loc, rows_loc, self.w, self.num_planes, in_deg_host=in_deg_local,
            device=self.device)

    def _lane_stats(self, vis, in_deg):
        r, d = self._stats_loc(vis, in_deg)
        return self.mesh.all_reduce_(r, "sum"), self.mesh.all_reduce_(d, "sum")

    def _extract_word(self, planes, vis, src_bits, wi):
        return self.mesh.all_gather_rows(self._extract_loc(planes, vis, src_bits, wi))

    def _lane_ecc(self, planes, vis, src_bits):
        return self.mesh.all_reduce_(self._ecc_loc(planes, vis, src_bits), "max")

    def _gather_rows(self, table: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather_rows(table)

    def _own_rows(self, table: np.ndarray) -> np.ndarray:
        r0 = self.mesh.rank * self._rows_loc
        return table[r0 : r0 + self._rows_loc]

    def row_min_lanes(self, pend) -> np.ndarray:
        """[rows] smallest visiting lane of every chip-major table row of a
        dispatched batch (the CC label fold): each rank folds its own rows
        and the folds are all-gathered."""
        return self._gather_rows(min_lane(pend.vis, pend.vis.shape[0])).cpu().numpy()

    def _any(self, t: torch.Tensor) -> bool:
        """Whether any rank's ``t`` holds a set bit (a psum > 0 in JAX)."""
        return bool(self.mesh.all_reduce_(t.any().to(torch.int32).reshape(1), "max").item())


class MeshAotHost:
    """The AOT view of a mesh engine (``utils/aot.py``): its inventory holds
    rank-local fixed-shape programs, every collective stays in the host
    loop, and :meth:`aot_mesh` names the rank that stores and loads them.
    Hosts define ``_aot_world`` (the mesh over every rank of the engine),
    ``_aot_programs()`` (the inventory) and ``_aot_layout_of()`` (their
    Python constants, without the rank)."""

    def aot_mesh(self) -> dict:
        """The rank's place in the mesh and the group's backend."""
        w = self._aot_world
        return {"rank": int(w.rank), "world": int(w.num_shards), "backend": w.backend,
                "device": w.device.type}

    def aot_layout(self) -> dict:
        """The programs' Python constants with the rank's place: shard
        shapes, bucket boundaries and rank constants differ per rank, so
        an artifact another rank wrote is stale here."""
        return {**self._aot_layout_of(), **self.aot_mesh()}

    def export_programs(self):
        return self._aot_programs()


def resolve_mesh(mesh: Mesh | None, device) -> Mesh:
    """The engine's mesh: ``mesh``, or this process's (``make_mesh``)."""
    if mesh is None:
        return make_mesh(device=device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
    return mesh


def check_packed_mesh_knobs(exchange: str, delta_bits) -> tuple[int, ...]:
    """The packed mesh engines' planner knobs: ``delta_bits`` canonical,
    refused (JAX's text) without the sparse row gather."""
    if delta_bits and exchange != "sparse":
        raise ValueError(
            "delta_bits compresses the SPARSE row gather's id stream "
            f"(the exchange planner); exchange={exchange!r} ships whole slabs — "
            "use exchange='sparse'")
    return check_delta_bits(delta_bits)


def resolve_row_caps(caps, rows_loc: int, w: int, delta_bits) -> tuple[int, ...]:
    """An engine's row-gather ``sparse_caps``: None is
    ``default_row_gather_caps``, an int one rung."""
    if caps is None:
        return default_row_gather_caps(rows_loc, w, delta_bits)
    return normalize_caps((caps,) if isinstance(caps, int) else caps)


class DistWideMsBfsEngine(MeshAotHost, MeshTableHost, RowGatherExchangeAccounting,
                          PackedRunProtocol):
    """Mesh multi-source BFS: sharded ELL, replicated frontier, up to
    ``lanes`` sources a batch (a multiple of 32). Built inside every rank
    of ``mesh`` (default: this process's rank group, CUDA unless
    ``device`` names another). ``exchange`` is 'dense' or 'sparse'
    (``sparse_caps``, default ``default_row_gather_caps``; ``delta_bits``
    delta-encodes its row ids). ``wire_pack`` is accepted and recorded, as
    in JAX: the exchange already ships one bit a (vertex, lane). ``shard``
    is ``build_ell_sharded`` of the Graph ``graph`` for the mesh's size, to
    build several engines over one graph without repeating the host build
    (a prebuilt shard set as ``graph`` keeps no edge list for the parent
    scan).

    Device memory a rank: the replicated frontier (and the exchange's
    transient) at (v_pad + 1) x 4w bytes, plus (num_planes + 3) own
    [v_loc, w] tables and the shard's ELL."""

    def __init__(
        self,
        graph: Graph | ShardedEllGraph,
        mesh: Mesh | None = None,
        *,
        lanes: int = LANES,
        kcap: int = 64,
        num_planes: int = 5,
        exchange: str = "dense",
        sparse_caps=None,
        wire_pack: bool = False,
        delta_bits=(),
        device=None,
        shard: ShardedEllGraph | None = None,
    ):
        if not (1 <= num_planes <= 8):
            raise ValueError("num_planes must be in [1, 8]")
        if exchange not in ("dense", "sparse"):
            raise ValueError(f"unknown exchange {exchange!r}; have 'dense', 'sparse'")
        self.delta_bits = check_packed_mesh_knobs(exchange, delta_bits)
        self.wire_pack = bool(wire_pack)
        if lanes % 32 or not (32 <= lanes <= MAX_LANES):
            raise ValueError(f"lanes must be a multiple of 32 in [32, {MAX_LANES}]")
        self.mesh = resolve_mesh(mesh, device)
        self.device = self.mesh.device
        self.w, self.lanes, self.num_planes = lanes // 32, lanes, num_planes
        self.max_levels_cap = min(1 << num_planes, 254)
        p_count, p = self.mesh.num_shards, self.mesh.rank
        if shard is None:
            shard = (build_ell_sharded(graph, p_count, kcap=kcap) if isinstance(graph, Graph)
                     else graph)
        self.sell = shard
        sell = self.sell
        if sell.num_shards != p_count:
            raise ValueError(f"ELL built for {sell.num_shards} shards, mesh has {p_count}")
        # The edge list for the parent scan's full ELL; a prebuilt shard set has none.
        self.host_graph = graph if isinstance(graph, Graph) else None
        self.undirected = sell.undirected
        # Every vertex has a row here, so isolated sources traverse as any
        # other; the mask marks them for checkpoints resumed on engines
        # that give them none (exact from a Graph; a prebuilt undirected
        # shard set has in-degree 0 for them; a prebuilt directed one
        # cannot tell).
        if isinstance(graph, Graph):
            src, dst = graph.coo
            seen = np.zeros(graph.num_vertices, dtype=bool)
            seen[src] = True
            seen[dst] = True
            self._iso_mask = ~seen
        else:
            self._iso_mask = (sell.in_degree == 0 if sell.undirected
                              else np.zeros(sell.num_vertices, dtype=bool))

        self.arrs = shard_expand_arrays(
            None if sell.virtual is None else sell.virtual[p].T,
            None if sell.virtual is None else sell.fold_pad_map[p],
            None if sell.virtual is None else sell.heavy_pick[p],
            [blocks[p].T for _k, blocks in sell.light], sell.v_pad, self.device)
        self._spec = ExpandSpec(
            kcap=sell.kcap, heavy=sell.heavy_per_shard > 0, num_virtual=sell.num_virtual,
            fold_steps=sell.fold_steps,
            light_meta=tuple((k, b.shape[1]) for k, b in sell.light),
            tail_rows=sell.tail_rows,
        )
        self._expand = make_expand(self._spec, self.w)
        self._dist_core = self._level_step

        self._exchange = exchange
        self.sparse_caps = resolve_row_caps(sparse_caps, sell.v_loc, self.w, self.delta_bits)
        self._nb = (rows_gather_branch_count(self.sparse_caps, self.delta_bits)
                    if exchange == "sparse" else 1)
        self._gather_p, self._gather_rows_loc = p_count, sell.v_loc
        # Chip-major row of global rank r: (r % P) * v_loc + r // P.
        ranks = sell.rank.astype(np.int64)
        self._rank = (ranks % p_count) * sell.v_loc + ranks // p_count
        self._table_rows = self._act = sell.v_pad
        in_deg_rank = np.zeros(sell.v_pad, dtype=np.int32)
        in_deg_rank[: sell.num_vertices] = sell.in_degree[sell.old_of_new]
        self._init_mesh_state(sell.v_loc, in_deg_rank[p::p_count])
        self._warmed = False

    @property
    def num_vertices(self) -> int:
        return self.sell.num_vertices

    @property
    def _aot_world(self) -> Mesh:
        return self.mesh

    def _aot_layout_of(self) -> dict:
        return dict(packed_layout(self, self._spec, rows_loc=self.sell.v_loc,
                                  sparse=self._exchange == "sparse"),
                    delta_bits=list(self.delta_bits))

    def _aot_programs(self):
        """The AOT inventory, JAX's name: ``dist_core``, this rank's level
        step (:meth:`_level_step`) over its shard's tables and the
        replicated frontier, with the state tables as :class:`ArgSpec`."""
        sell, dev = self.sell, self.device
        own = ArgSpec((sell.v_loc, self.w), torch.int32, dev)
        fw = ArgSpec((sell.v_pad + 1, self.w), torch.int32, dev)
        fn = getattr(self._dist_core, "_aot_original", self._dist_core)
        return [("dist_core", "_dist_core", fn,
                 (self.arrs, fw, own, (own,) * self.num_planes))]

    def _level_step(self, arrs, fw, vis, planes):
        """One level on this rank, ``(nxt, flags)``: K1 over the shard
        against the replicated frontier ``fw``, the claim ``hit & ~vis``,
        the visited OR and the plane ripple (``vis`` and ``planes`` in
        place), and the level's device flags for the host's all-reduce:
        ``alive`` and, sparse, the rung's row count (and widest id gap)."""
        nxt = self._expand(arrs, fw)
        nxt &= ~vis
        vis |= nxt
        ripple_increment_(planes, ~vis)
        flags = nxt.any().to(torch.int32).reshape(1)
        if self._exchange == "sparse":
            flags = torch.cat([flags, row_gather_flags((nxt != 0).any(dim=1),
                                                       self.delta_bits)])
        return nxt, flags

    def _iso_of(self, sources: np.ndarray) -> np.ndarray:
        return self._iso_mask[np.asarray(sources, dtype=np.int64)]

    def _seed_dev(self, sources: np.ndarray) -> torch.Tensor:
        """The replicated rank-order [v_pad + 1, w] seed table."""
        sell = self.sell
        rws, words, bits = seed_scatter_args(sell.rank[sources], sell.v_pad)
        fw0 = torch.zeros((sell.v_pad + 1, self.w), dtype=torch.int32, device=self.device)
        dev = self.device
        fw0.index_put_((torch.from_numpy(rws).to(dev), torch.from_numpy(words).to(dev)),
                       torch.from_numpy(bits).to(dev), accumulate=True)
        return fw0

    def _src_bits_view(self, fw: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a replicated rank-order table: the rows of
        its chip-major block."""
        sell = self.sell
        return fw[: sell.v_pad].view(sell.v_loc, sell.num_shards, self.w)[:, self.mesh.rank]

    def _exchange_rows(self, nxt: torch.Tensor, branch: int) -> torch.Tensor:
        """The replicated [v_pad + 1, w] frontier of every rank's ``nxt``."""
        sell, p_count, p = self.sell, self.mesh.num_shards, self.mesh.rank
        rung = branch_rung(branch, self.sparse_caps, self.delta_bits)
        if rung is not None and self._exchange == "sparse":
            return sparse_rows_gather(self.mesh, nxt, cap=rung[0], bits=rung[1],
                                      out_rows=sell.v_pad, gid_of=lambda ids: ids * p_count + p,
                                      gid_of_src=lambda ids, src: ids * p_count + src)
        gathered = self.mesh.all_gather_rows(nxt)  # chip-major
        fw = torch.empty((sell.v_pad + 1, self.w), dtype=nxt.dtype, device=nxt.device)
        fw[: sell.v_pad].view(sell.v_loc, p_count, self.w).copy_(
            gathered.view(p_count, sell.v_loc, self.w).transpose(0, 1))
        fw[sell.v_pad] = 0
        return fw

    def _loop(self, fw, vis, planes, level0, max_levels):
        """The level loop: one host read a level (``alive`` and, sparse,
        the rung's row count). The step is read anew each level, so an
        adopted ``dist_core`` takes over; the all-reduce and the exchange
        stay here. Returns the state and the branch counts."""
        sparse = self._exchange == "sparse"
        counts = np.zeros(self._nb, dtype=np.int32)
        level, alive = int(level0), True
        while alive and level < max_levels:
            nxt, flags = self._dist_core(self.arrs, fw, vis, planes)
            alive, *rows = self.mesh.all_reduce_(flags, "max").tolist()
            branch = (rows_gather_branch(rows[0], rows[-1], self.sparse_caps, self.delta_bits)
                      if sparse else 0)
            counts[branch] += 1
            # A dead level's frontier is empty on every rank: no exchange.
            fw = (self._exchange_rows(nxt, branch) if alive
                  else torch.zeros((self.sell.v_pad + 1, self.w), dtype=torch.int32,
                                   device=self.device))
            level += 1
        return fw, vis, planes, level, bool(alive), counts

    def _core(self, arrs, fw0, max_levels):
        vis = self._src_bits_view(fw0).clone()
        planes = tuple(torch.zeros_like(vis) for _ in range(self.num_planes))
        fw, vis, planes, levels, alive, counts = self._loop(fw0, vis, planes, 0, max_levels)
        # Claim-free truncation probe: only when the loop stopped at the cap
        # with a live frontier.
        truncated = alive and levels >= max_levels and self._deeper(arrs, fw, vis)
        self._record_exchange(counts, 0)
        return planes, vis, levels, alive, truncated

    def _core_from(self, arrs, fw, vis, planes, level0, max_levels):
        fw, vis, planes, level, alive, counts = self._loop(fw, vis, planes, level0, max_levels)
        self._record_exchange(counts, int(level0), getattr(self, "_pending_chain_nonce", None))
        return fw, vis, planes, level, alive

    def _deeper(self, arrs, fw, vis) -> bool:
        return self._any(self._expand(arrs, fw) & ~vis)

    # The loop carries the frontier replicated in rank order with the
    # sentinel row, unlike the chip-major visited and plane tables.
    def _fw_table_from_real(self, real: np.ndarray) -> torch.Tensor:
        sell = self.sell
        if real.shape != (self.num_vertices, self.w):
            raise ValueError(
                f"checkpoint table is {real.shape}, engine expects "
                f"({self.num_vertices}, {self.w}) — lane count and graph "
                "must match the engine the checkpoint resumes on"
            )
        t = np.zeros((sell.v_pad + 1, self.w), np.uint32)
        t[sell.rank] = real
        return torch.from_numpy(t.view(np.int32)).to(self.device)

    def _fw_real_from_table(self, fw: torch.Tensor) -> np.ndarray:
        return fw.cpu().numpy().view(np.uint32)[self.sell.rank]

    def _full_parent_ell(self):
        """The parent scan's structure: the shards do not concatenate into
        one coverage ELL, so a full ELL of the retained host graph, built on
        every rank; the scan's row map reaches the chip-major tables. Its
        device tables are built here and lent, so ``parent_scanner_of``
        keeps the scanner on the engine: p2p walks paths every batch, and a
        rebuild would cost each batch seconds at the flagship size."""
        ell, _ = lazy_full_parent_ell(self.host_graph, self.sell.kcap)
        if ell is None:
            return None, None
        return ell, expand_arrays(ell, ell.num_active, self.device)
