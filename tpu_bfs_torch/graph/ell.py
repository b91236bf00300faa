"""Degree-sorted bucketed ELL over in-neighborhoods, the port's NumPy copy of
the single-device builders in ``tpu_bfs/graph/ell.py``.

- Vertices are relabeled active-first by descending in-degree ("rank"
  order), so each degree bucket is a contiguous row range and bucket outputs
  concatenate back into the table with no scatter.
- A light bucket holds rows with in-degree in (k/2, k], padded to k columns
  with a sentinel row id whose frontier words are always zero.
- A heavy row (in-degree > kcap) splits into ceil(deg/kcap) virtual rows; a
  fold pyramid ORs them back per vertex (``fold_pad_map``, ``heavy_pick``).

``pad_gate_blocks`` pads a transposed bucket table to whole 128-row blocks:
the layout the ``ell_expand`` kernel takes. ``build_ell_weights`` lays a
weighted graph's weights out slot for slot with an ELL's index tables (the
SSSP engine's weight planes). ``build_ell_sharded`` deals the rows of a
1D mesh's shards round-robin (the distributed wide engine's tables).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_bfs_torch.graph.csr import Graph, _sorted_pairs, _stable_argsort


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """Rows [row_start, row_start + n) in rank order, padded to width k."""

    row_start: int
    n: int
    k: int
    idx: np.ndarray  # [n, k] int32 rank-space neighbor ids, pad = sentinel


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Bucketed ELL in active-first descending-in-degree rank space.

    Row r is original vertex ``old_of_new[r]``; rows [0, num_heavy) are heavy,
    rows [num_nonzero, num_active) have in-degree 0, rows >= num_active are
    isolated and have no table row. The neighbor sentinel is ``num_active``.
    """

    num_vertices: int
    num_edges: int  # directed edge slots (== sum of in-degrees)
    undirected: bool
    kcap: int
    num_active: int
    old_of_new: np.ndarray  # [V] int32
    rank: np.ndarray  # [V] int32
    in_degree: np.ndarray  # [V] int64, original-id order
    num_heavy: int
    num_nonzero: int
    num_virtual: int
    virtual: EllBucket | None  # [M, kcap]
    fold_pad_map: np.ndarray | None  # [M2] int32 into virtual results, pad = M
    heavy_pick: np.ndarray | None  # [H] int32 into the fold pyramid
    fold_steps: int
    light: list[EllBucket]

    @property
    def total_slots(self) -> int:
        m = 0 if self.virtual is None else self.virtual.idx.size
        return m + sum(b.idx.size for b in self.light)


def pad_gate_blocks(idx_t: np.ndarray, sentinel: int, tile: int = 128) -> np.ndarray:
    """Pad a transposed [k, n] bucket table (an array or a view such as
    ``idx.T``) to an int32 [k, ceil(n/tile)*tile] with ``sentinel`` (which
    must name the engine's identity frontier row)."""
    k, n = idx_t.shape
    nb = max(-(-n // tile), 1)
    out = np.empty((k, nb * tile), dtype=np.int32)
    out[:, n:] = sentinel
    # A block of columns at a time: a transposed view (``idx.T``) is copied
    # several times faster than by one strided copy of the whole table.
    step = max((1 << 16) // max(k, 1), 1)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        out[:, lo:hi] = idx_t[:, lo:hi]
    return out


def gate_forward_map(routing: np.ndarray, out_height: int, num_real: int) -> np.ndarray:
    """Forward form of a bucket routing map, for the pull gate.

    ``routing`` maps each table row to its bucket-output position (the
    hybrid's ``inv_perm_ext``; positions >= ``num_real`` are the shared
    identity row). Returns ``fwd`` [out_height] int32: ``fwd[p]`` is the
    table row whose bucket output is position p, and ``len(routing)`` (one
    past the table) at pad and tail positions, so a per-row needed vector
    extended by one trailing False never marks them needed."""
    fwd = np.full(out_height, len(routing), dtype=np.int32)
    pos = routing.astype(np.int64)
    m = pos < num_real
    fwd[pos[m]] = np.flatnonzero(m).astype(np.int32)
    return fwd


def _ell_fill(lens: np.ndarray, flat: np.ndarray, k: int, pad: int) -> np.ndarray:
    """Pack concatenated rows (lengths ``lens``) into [len(lens), k], pad ``pad``."""
    n = len(lens)
    out = np.full((n, k), pad, dtype=np.int32)
    if n:
        mask = np.arange(k, dtype=np.int64)[None, :] < lens[:, None]
        out[mask] = flat
    return out


def _flat_positions(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ranges [starts[i], starts[i]+lens[i]) into one index array."""
    total = int(lens.sum())
    ends = np.cumsum(lens)
    return (
        starts.repeat(lens)
        + np.arange(total, dtype=np.int64)
        - (ends - lens).repeat(lens)
    )


def _heavy_pick(rp2, pstart, m2: int, fold_steps: int) -> np.ndarray:
    """Pyramid positions of finished heavy rows (level s has m2 >> s rows;
    vertex h finishes at level log2(rp2[h]))."""
    lvl = np.log2(rp2).astype(np.int64)
    lvl_offset = np.zeros(fold_steps + 1, dtype=np.int64)
    off = 0
    for s in range(fold_steps + 1):
        lvl_offset[s] = off
        off += m2 >> s
    return (lvl_offset[lvl] + (pstart >> lvl)).astype(np.int32)


def rank_vertices(src: np.ndarray, dst: np.ndarray, v_count: int):
    """(in_degree, num_active, rank_order, rank): active vertices (touching
    any edge) first, each group by descending in-degree, stable on ties."""
    in_deg = np.bincount(dst, minlength=v_count).astype(np.int64)
    inactive = in_deg == 0
    if len(src):
        inactive &= np.bincount(src, minlength=v_count) == 0
    num_active = v_count - int(inactive.sum())
    rank_order = np.lexsort((-in_deg, inactive)).astype(np.int32)
    rank = np.empty(v_count, dtype=np.int32)
    rank[rank_order] = np.arange(v_count, dtype=np.int32)
    return in_deg, num_active, rank_order, rank


def bucketize_rows(lens: np.ndarray, nbrs: np.ndarray, new_rp: np.ndarray,
                   kcap: int, pad: int):
    """Split degree-sorted rows (``lens`` non-increasing, neighbor lists
    ``nbrs`` with ``new_rp`` boundaries) into the heavy virtual-row + fold
    pyramid section and the light width ladder. Returns ``(num_heavy,
    num_nonzero, num_virtual, fold_steps, virtual, fold_pad_map,
    heavy_pick, light)``."""
    num_heavy = int(np.searchsorted(-lens, -kcap, side="left"))
    num_nonzero = int(np.searchsorted(-lens, 0, side="left"))

    virtual = fold_pad_map = heavy_pick = None
    fold_steps = num_virtual = 0
    if num_heavy:
        hlens = lens[:num_heavy]
        r_per = -(-hlens // kcap)
        num_virtual = int(r_per.sum())
        vlens = np.full(num_virtual, kcap, dtype=np.int64)
        vr_last = np.cumsum(r_per) - 1
        vlens[vr_last] = hlens - kcap * (r_per - 1)
        heavy_flat = nbrs[: int(new_rp[num_heavy])]
        virtual = EllBucket(
            row_start=0, n=num_virtual, k=kcap,
            idx=_ell_fill(vlens, heavy_flat, kcap, pad),
        )
        # Vertex h owns the aligned run [pstart[h], pstart[h] + rp2[h]).
        rp2 = 1 << np.ceil(np.log2(r_per)).astype(np.int64)
        fold_steps = int(np.log2(rp2[0]))
        m2 = int(rp2.sum())
        m2 = -(-m2 // (1 << fold_steps)) * (1 << fold_steps)
        pstart = np.concatenate([[0], np.cumsum(rp2)[:-1]])
        fold_pad_map = np.full(m2, num_virtual, dtype=np.int32)
        vr_start = vr_last - r_per + 1
        fold_pad_map[_flat_positions(pstart, r_per)] = _flat_positions(
            vr_start, r_per
        ).astype(np.int32)
        heavy_pick = _heavy_pick(rp2, pstart, m2, fold_steps)

    light: list[EllBucket] = []
    row = num_heavy
    k = kcap
    while row < num_nonzero and k >= 1:
        lo_deg = k // 2  # this bucket: lo_deg < deg <= k
        hi = int(np.searchsorted(-lens, -(lo_deg + 1), side="right"))
        if hi > row:
            flat = nbrs[int(new_rp[row]) : int(new_rp[hi])]
            light.append(EllBucket(
                row_start=row, n=hi - row, k=k,
                idx=_ell_fill(lens[row:hi], flat, k, pad),
            ))
            row = hi
        k //= 2

    return (
        num_heavy, num_nonzero, num_virtual, fold_steps,
        virtual, fold_pad_map, heavy_pick, light,
    )


def bucketize_values(lens: np.ndarray, vals: np.ndarray, new_rp: np.ndarray,
                     kcap: int, pad: int):
    """Per-bucket VALUE tables slot-aligned with :func:`bucketize_rows`'s
    index tables: ``vals`` holds one value per edge slot in the flat order
    of its ``nbrs``, and the same slicing (it is :func:`bucketize_rows` on
    the values) puts the value of the neighbor ``idx[row, col]`` names at
    slot (row, col); unused slots hold ``pad``. Returns ``(virtual_vals |
    None, [light value tables])``."""
    *_, virtual, _, _, light = bucketize_rows(lens, vals, new_rp, kcap, pad)
    return (None if virtual is None else virtual.idx), [b.idx for b in light]


def build_ell_weights(g: Graph, ell: EllGraph):
    """The per-slot weight tables of ``ell``'s buckets. ``ell`` must be
    ``build_ell(g)`` of the same weighted graph. Returns ``(virtual_w |
    None, [light_w])``, each of exactly its bucket's ``idx`` shape: slot
    (row, col) holds the weight of the in-edge from ``idx[row, col]``,
    unused slots 0 (they gather the engines' sentinel row, so their weight
    is inert under min-plus)."""
    if g.weights is None:
        raise ValueError("graph has no weights plane (build it with weights=W)")
    v_count = g.num_vertices
    src, dst = g.coo
    # The (dst, src) order of build_ell's neighbor lists: coo is src-major,
    # so a stable sort by dst alone gives it, ties in CSR order.
    order_ds = _stable_argsort(dst)
    in_deg = np.bincount(dst, minlength=v_count).astype(np.int64)
    in_rp = np.zeros(v_count + 1, dtype=np.int64)
    np.cumsum(in_deg, out=in_rp[1:])
    rank_order = ell.old_of_new
    lens = in_deg[rank_order]
    new_rp = np.zeros(v_count + 1, dtype=np.int64)
    np.cumsum(lens, out=new_rp[1:])
    wflat = g.weights[order_ds][_flat_positions(in_rp[rank_order], lens)]
    virtual_w, light_w = bucketize_values(lens, wflat, new_rp, ell.kcap, 0)
    # Shape pin: a plane out of line with its bucket would make every
    # downstream gather-add silently wrong.
    if (virtual_w is None) != (ell.virtual is None) or (
        virtual_w is not None and virtual_w.shape != ell.virtual.idx.shape
    ):
        raise AssertionError("weight plane misaligned with ell heavy bucket")
    if len(light_w) != len(ell.light) or any(
        w.shape != b.idx.shape for w, b in zip(light_w, ell.light)
    ):
        raise AssertionError("weight plane misaligned with ell light buckets")
    return virtual_w, light_w


def build_ell(g: Graph, *, kcap: int = 64) -> EllGraph:
    """Bucketed in-neighbor ELL of a host CSR graph; tables need only
    ``num_active + 1`` rows (the last is the all-zero sentinel row)."""
    v_count = g.num_vertices
    src, dst = g.coo
    _, in_col = _sorted_pairs(dst, src, v_count)
    in_deg, num_active, rank_order, rank = rank_vertices(src, dst, v_count)

    in_rp = np.zeros(v_count + 1, dtype=np.int64)
    np.cumsum(in_deg, out=in_rp[1:])
    lens = in_deg[rank_order]
    new_rp = np.zeros(v_count + 1, dtype=np.int64)
    np.cumsum(lens, out=new_rp[1:])
    nbrs = rank[in_col[_flat_positions(in_rp[rank_order], lens)]]

    (
        num_heavy, num_nonzero, num_virtual, fold_steps,
        virtual, fold_pad_map, heavy_pick, light,
    ) = bucketize_rows(lens, nbrs, new_rp, kcap, num_active)

    return EllGraph(
        num_vertices=v_count,
        num_edges=int(new_rp[-1]),
        undirected=g.undirected,
        kcap=kcap,
        num_active=num_active,
        old_of_new=rank_order,
        rank=rank,
        in_degree=in_deg,
        num_heavy=num_heavy,
        num_nonzero=num_nonzero,
        num_virtual=num_virtual,
        virtual=virtual,
        fold_pad_map=fold_pad_map,
        heavy_pick=heavy_pick,
        fold_steps=fold_steps,
        light=light,
    )


# --- The sharded ELL of the distributed wide engine --------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def rank_by_in_degree(dst: np.ndarray, v_count: int):
    """(in_degree, rank_order, rank) of the descending-in-degree relabeling
    over every vertex, stable on ties (the sharded ELL's order: every
    vertex has a row there)."""
    in_deg = np.bincount(dst, minlength=v_count).astype(np.int64)
    rank_order = np.argsort(-in_deg, kind="stable").astype(np.int32)
    rank = np.empty(v_count, dtype=np.int32)
    rank[rank_order] = np.arange(v_count, dtype=np.int32)
    return in_deg, rank_order, rank


def pad_heavy_shards(hlens_list, flat_list, kcap: int, sentinel: int):
    """Heavy sections of several shards at one common shape.

    Each shard's heavy rows (``hlens_list[p]``, non-increasing, neighbor
    lists concatenated in ``flat_list[p]``) split into kcap-wide virtual
    rows plus a fold pyramid, as in :func:`bucketize_rows`, every shape
    padded to the maximum over the shards. ``m2`` always holds a padded
    level-0 slot, so a shard with fewer heavy rows pads ``heavy_pick`` onto
    an all-identity pyramid slot.

    Returns ``(nh, num_virtual, fold_steps, m2, virtual [P, M, kcap],
    fold_pad_map [P, m2], heavy_pick [P, nh])``, or zeros and Nones when no
    shard has a heavy row."""
    nh = max((len(h) for h in hlens_list), default=0)
    if nh == 0:
        return 0, 0, 0, 0, None, None, None
    r_per_all = [np.maximum(-(-h // kcap), 1) for h in hlens_list]
    num_virtual = max(max((int(r.sum()) for r in r_per_all), default=1), 1)
    rp2_all = [
        1 << np.ceil(np.log2(r)).astype(np.int64) if len(r) else np.zeros(0, np.int64)
        for r in r_per_all
    ]
    fold_steps = max((int(np.log2(r[0])) for r in rp2_all if len(r)), default=0)
    block = 1 << fold_steps
    m2 = _round_up(max((int(r.sum()) for r in rp2_all), default=0) + 1, block)
    v_parts, f_parts, h_parts = [], [], []
    for hlens, flat, r_per, rp2 in zip(hlens_list, flat_list, r_per_all, rp2_all):
        n_h = len(hlens)
        vlens = np.zeros(num_virtual, dtype=np.int64)
        fpm = np.full(m2, num_virtual, dtype=np.int32)
        hpick = np.zeros(nh, dtype=np.int32)
        if n_h:
            vlens[: int(r_per.sum())] = kcap
            vr_last = np.cumsum(r_per) - 1
            vlens[vr_last] = hlens - kcap * (r_per - 1)
            pstart = np.concatenate([[0], np.cumsum(rp2)[:-1]]).astype(np.int64)
            vr_start = vr_last - r_per + 1
            fpm[_flat_positions(pstart, r_per)] = _flat_positions(vr_start, r_per).astype(
                np.int32)
            hpick[:n_h] = _heavy_pick(rp2, pstart, m2, fold_steps)
        v_parts.append(_ell_fill(vlens, flat, kcap, sentinel))
        f_parts.append(fpm)
        h_parts.append(hpick)
    return (nh, num_virtual, fold_steps, m2,
            np.stack(v_parts), np.stack(f_parts), np.stack(h_parts))


@dataclasses.dataclass(frozen=True)
class ShardedEllGraph:
    """Per-shard ELL tables of one common shape, for a 1D mesh.

    The rank space (descending in-degree over every vertex) is padded to
    ``num_shards * v_loc`` rows; shard p owns the rows r with
    ``r % num_shards == p``, dealt round-robin so every shard sees the same
    degree mix. Bucket boundaries are multiples of ``num_shards``, so every
    shard has the same bucket row counts and its bucket outputs are its own
    rows in local order. Neighbor ids are global ranks (sentinel ``v_pad``):
    the shards gather from a replicated frontier table of ``v_pad + 1``
    rows. Array fields carry a leading shard axis."""

    num_vertices: int
    num_edges: int
    undirected: bool
    kcap: int
    num_shards: int
    v_loc: int  # rows per shard; v_pad = num_shards * v_loc
    old_of_new: np.ndarray  # [V] int32
    rank: np.ndarray  # [V] int32
    in_degree: np.ndarray  # [V] int64, original-id order
    heavy_per_shard: int
    num_virtual: int  # virtual rows per shard (the maximum, padded)
    m2: int
    fold_steps: int
    virtual: np.ndarray | None  # [P, M, kcap] int32
    fold_pad_map: np.ndarray | None  # [P, m2] int32
    heavy_pick: np.ndarray | None  # [P, heavy_per_shard] int32
    light: list  # (k, [P, n_k, k] int32)
    tail_rows: int  # identity rows after each shard's buckets

    @property
    def v_pad(self) -> int:
        return self.num_shards * self.v_loc


def starts_of(rows: np.ndarray, new_rp: np.ndarray) -> np.ndarray:
    """Flat-neighbor start offsets of the given rank rows."""
    return new_rp[rows]


def _rank_space(in_deg: np.ndarray, rank_order: np.ndarray, v_pad: int):
    """``(lens, starts, new_rp)`` of the rank space padded to ``v_pad`` rows:
    rank row r's in-degree, its first slot in the dst-major in-edge list, and
    the row pointers of the in-edges laid out in rank order. Both sharded
    builders slice by these, so their slabs stay slot-aligned."""
    v_count = len(in_deg)
    in_rp = np.zeros(v_count + 1, dtype=np.int64)
    np.cumsum(in_deg, out=in_rp[1:])
    lens = np.zeros(v_pad, dtype=np.int64)
    lens[:v_count] = in_deg[rank_order]
    starts = np.zeros(v_pad, dtype=np.int64)
    starts[:v_count] = in_rp[rank_order]
    new_rp = np.zeros(v_pad + 1, dtype=np.int64)
    np.cumsum(lens, out=new_rp[1:])
    return lens, starts, new_rp


def _shard_slabs(lens: np.ndarray, new_rp: np.ndarray, flat: np.ndarray, kcap: int,
                 p_count: int, pad: int):
    """The sharded bucket slabs of rank rows of in-degrees ``lens`` (the
    rank space padded to ``p_count`` shards) whose per-edge payload ``flat``
    lies in ``new_rp`` order: neighbour ranks (pad the sentinel row) or
    edge weights (pad 0), slot for slot the same slicing. Returns
    ``(h_bound, pad_heavy_shards' tuple, [(k, [P, n_k, k])])``; bucket
    boundaries are multiples of ``p_count``."""
    v_pad = len(lens)
    num_heavy = int(np.searchsorted(-lens, -kcap, side="left"))
    h_bound = min(_round_up(num_heavy, p_count), v_pad)

    def shard_rows(lo: int, hi: int, p: int) -> np.ndarray:
        return np.arange(lo + p, hi, p_count, dtype=np.int64)

    def shard_flat(rows):
        return flat[_flat_positions(starts_of(rows, new_rp), lens[rows])]

    heavy = (0, 0, 0, 0, None, None, None)
    if h_bound:
        rows_p = [shard_rows(0, h_bound, p) for p in range(p_count)]
        heavy = pad_heavy_shards([lens[r] for r in rows_p], [shard_flat(r) for r in rows_p],
                                 kcap, pad)

    # The light ladder, its global boundaries multiples of num_shards.
    light = []
    prev = h_bound
    k = kcap
    while prev < v_pad and k >= 1:
        hi = int(np.searchsorted(-lens, -(k // 2 + 1), side="right"))
        hi = min(max(_round_up(hi, p_count), prev), v_pad)
        if k == 1:  # the last bucket takes every remaining nonzero row
            nz = int(np.searchsorted(-lens, 0, side="left"))
            hi = min(max(_round_up(nz, p_count), prev), v_pad)
        if hi > prev:
            blocks = []
            for p in range(p_count):
                rows = shard_rows(prev, hi, p)
                blocks.append(_ell_fill(lens[rows], shard_flat(rows), k, pad))
            light.append((k, np.stack(blocks)))
            prev = hi
        k //= 2
    return h_bound, heavy, light


def build_ell_weights_sharded(g: Graph, sell: "ShardedEllGraph"):
    """The per-shard weight tables of ``sell``'s buckets, slot-aligned with
    its index slabs. ``sell`` must be ``build_ell_sharded`` of the same
    weighted graph. Slot (p, row, col) holds the weight of the in-edge whose
    source ``sell``'s slot names; unused slots hold 0 (they gather the
    engines' all-INF sentinel row, so their weight is inert under min-plus).
    Returns ``(virtual_w [P, M, kcap] | None, [light_w [P, n_k, k]])``."""
    if g.weights is None:
        raise ValueError("graph has no weights plane (build it with weights=W)")
    src, dst = g.coo
    # build_ell_sharded's (dst, src) neighbour order: coo is src-major, so
    # a stable sort by dst alone gives it, ties in CSR order.
    order_ds = _stable_argsort(dst)
    in_deg = np.bincount(dst, minlength=g.num_vertices).astype(np.int64)
    lens, starts, new_rp = _rank_space(in_deg, sell.old_of_new, sell.v_pad)
    wflat = np.asarray(g.weights)[order_ds][_flat_positions(starts, lens)].astype(np.int32)
    _, heavy, light = _shard_slabs(lens, new_rp, wflat, sell.kcap, sell.num_shards, 0)
    virtual_w, light_w = heavy[4], [blocks for _k, blocks in light]
    # Shape pin: a plane out of line with its slab would make every
    # downstream gather-add silently wrong.
    if (virtual_w is None) != (sell.virtual is None) or (
        virtual_w is not None and virtual_w.shape != sell.virtual.shape
    ):
        raise AssertionError("weight plane misaligned with sharded heavy bucket")
    if len(light_w) != len(sell.light) or any(
        w.shape != blk.shape for w, (_k, blk) in zip(light_w, sell.light)
    ):
        raise AssertionError("weight plane misaligned with sharded light buckets")
    return virtual_w, light_w


def build_ell_sharded(g: Graph, num_shards: int, *, kcap: int = 64) -> ShardedEllGraph:
    """The ELL tables of every shard of a ``num_shards``-way 1D partition
    (NumPy, on the host). A mesh rank builds all of them and keeps its own:
    the shapes are the maxima over the shards."""
    p_count = num_shards
    v_count = g.num_vertices
    src, dst = g.coo
    _, in_col = _sorted_pairs(dst, src, v_count)
    in_deg, rank_order, rank = rank_by_in_degree(dst, v_count)

    v_loc = -(-v_count // p_count)
    v_pad = p_count * v_loc
    lens, starts, new_rp = _rank_space(in_deg, rank_order, v_pad)
    nbrs = rank[in_col[_flat_positions(starts, lens)]].astype(np.int32)
    h_bound, heavy, light = _shard_slabs(lens, new_rp, nbrs, kcap, p_count, v_pad)
    (_, num_virtual, fold_steps, m2, virtual, fold_pad_map, heavy_pick) = heavy
    heavy_per_shard = h_bound // p_count

    return ShardedEllGraph(
        num_vertices=v_count, num_edges=int(new_rp[-1]), undirected=g.undirected,
        kcap=kcap, num_shards=p_count, v_loc=v_loc, old_of_new=rank_order, rank=rank,
        in_degree=in_deg, heavy_per_shard=heavy_per_shard, num_virtual=num_virtual, m2=m2,
        fold_steps=fold_steps, virtual=virtual, fold_pad_map=fold_pad_map,
        heavy_pick=heavy_pick, light=light,
        tail_rows=v_loc - heavy_per_shard - sum(b.shape[1] for _, b in light),
    )
