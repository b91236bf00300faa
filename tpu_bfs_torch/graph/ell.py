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
SSSP engine's weight planes).
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
    """Pad a transposed [k, n] bucket table to [k, ceil(n/tile)*tile] with
    ``sentinel`` (which must name the engine's identity frontier row)."""
    k, n = idx_t.shape
    nb = max(-(-n // tile), 1)
    out = np.full((k, nb * tile), sentinel, dtype=np.int32)
    out[:, :n] = idx_t
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
