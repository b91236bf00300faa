"""2D edge partitioning over an R x C mesh, the port of
``tpu_bfs/parallel/partition2d.py``.

The Buluc-Madduri decomposition, absent from the reference (whose only
sharding axis is the 1D vertex partition):

- vertices take the 1D partition's padded id space with P = R * C slices of
  w padded ids; slice k is owned by mesh rank (i, j) = (k // C, k % C),
  row-major, which is global rank k;
- "row block i" is the padded range [i*C*w, (i+1)*C*w), the slices of mesh
  row i; "column block j" is the strided union of the slices k % C == j;
- edge (u, v) lives on rank (row_of(v), col_of(u)): its frontier bit
  arrives in the column all-gather and its contribution leaves in the row
  reduce-scatter.

Each rank builds only its own edge shard (:func:`partition_2d_rank`);
:func:`partition_2d` stacks every shard, for the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_bfs_torch.graph.csr import EDGE_PAD, Graph, _round_up, _stable_argsort
from tpu_bfs_torch.parallel.partition import Partition1D


@dataclasses.dataclass(frozen=True)
class Partition2D:
    rows: int  # R
    cols: int  # C
    base: Partition1D  # the flat slices (num_devices = R*C)
    ep2: int = 0  # padded edges per rank (the common max, a multiple of EDGE_PAD)

    @property
    def num_devices(self) -> int:
        return self.rows * self.cols

    @property
    def num_vertices(self) -> int:
        return self.base.num_vertices

    @property
    def w(self) -> int:
        """Padded vertices per slice."""
        return self.base.vloc

    @property
    def vp(self) -> int:
        return self.base.vp

    def to_padded(self, v):
        return self.base.to_padded(v)

    def from_padded(self, pid):
        return self.base.from_padded(pid)

    def unshard(self, arr_vp):
        return self.base.unshard(arr_vp)

    def chip_of_edge(self, psrc, pdst):
        """(row, col) mesh coordinates owning padded edge (psrc, pdst)."""
        w = self.w
        return (pdst // w) // self.cols, (psrc // w) % self.cols

    def src_gather_index(self, psrc):
        """Index of padded src id within its column's all-gathered [R*w]
        frontier: the strided slices stacked in mesh-row order."""
        w = self.w
        return ((psrc // w) // self.cols) * w + psrc % w


def _layout(graph: Graph, rows: int, cols: int, vertex_pad: int, edge_pad: int):
    """(partition, psrc, pdst, chip): the sizes, and every edge's padded
    ids and owning rank, in the CSR's edge order (O(E))."""
    v, p = graph.num_vertices, rows * cols
    cpk = (v + p - 1) // p
    w = _round_up(cpk + 1, vertex_pad)
    part = Partition2D(rows=rows, cols=cols,
                       base=Partition1D(num_devices=p, num_vertices=v, cpk=cpk, vloc=w,
                                        ep_chip=0))
    src, dst = graph.coo
    psrc = (src.astype(np.int64) // cpk) * w + src % cpk
    pdst = (dst.astype(np.int64) // cpk) * w + dst % cpk
    row, col = part.chip_of_edge(psrc, pdst)
    chip = row * cols + col
    ep2 = _round_up(int(np.bincount(chip, minlength=p).max(initial=0)) + 1, edge_pad)
    if ep2 >= 2**31 - 1:
        raise ValueError("per-chip edge slots overflow int32; use a larger mesh")
    return dataclasses.replace(part, ep2=ep2), psrc, pdst, chip


def _shard(part: Partition2D, psrc, pdst, chip, i: int, j: int):
    w, cols, ep2 = part.w, part.cols, part.ep2
    row_block = cols * w
    mine = np.flatnonzero(chip == i * cols + j)
    psrc, pdst = psrc[mine], pdst[mine]
    # psrc is non-decreasing along the CSR: a stable sort by dst gives (dst, src).
    order = _stable_argsort(pdst - i * row_block) if len(mine) else np.zeros(0, np.int64)
    n = len(mine)
    src_g = np.full(ep2, w - 1, dtype=np.int32)
    dst_l = np.full(ep2, row_block - 1, dtype=np.int32)
    src_g[:n] = part.src_gather_index(psrc[order])
    dst_l[:n] = pdst[order] - i * row_block
    rp = np.empty(row_block + 1, dtype=np.int32)
    rp[0] = 0
    np.cumsum(np.bincount(dst_l, minlength=row_block), out=rp[1:])
    return src_g, dst_l, rp


def partition_2d_rank(graph: Graph, rows: int, cols: int, i: int, j: int, *,
                      vertex_pad: int = 256, edge_pad: int = EDGE_PAD):
    """Rank (i, j)'s shard: (partition, src_gidx [ep2], dst_l [ep2], rp
    [C*w + 1]), int32 arrays. Sources are column-gather indices
    (:meth:`Partition2D.src_gather_index`), destinations local to the row
    block, sorted by (dst, src). Padding edges run from gather index w - 1
    (slice (0, j)'s phantom, never in a frontier) to the row block's last
    phantom."""
    part, psrc, pdst, chip = _layout(graph, rows, cols, vertex_pad, edge_pad)
    return (part,) + _shard(part, psrc, pdst, chip, i, j)


def partition_2d(graph: Graph, rows: int, cols: int, *, vertex_pad: int = 256,
                 edge_pad: int = EDGE_PAD):
    """Shard edges over an R x C mesh: (part, src_gidx [R, C, ep2],
    dst_stacked [R, C, ep2], rp_stacked [R, C, C*w + 1]), every rank's
    :func:`partition_2d_rank` shard."""
    layout = _layout(graph, rows, cols, vertex_pad, edge_pad)
    shards = [[_shard(*layout, i, j) for j in range(cols)] for i in range(rows)]
    return (layout[0],) + tuple(
        np.stack([np.stack([s[f] for s in row]) for row in shards]) for f in range(3))


def out_csr_2d_rank(part: Partition2D, src_g: np.ndarray, dst_l: np.ndarray):
    """A shard's CSR by source, for the direction-optimizing top-down
    branch: (out_rp [R*w + 1], nbr [ep2]) int32. Rows are column-gather
    indices, neighbours row-block-local ids; the padding edges sit on
    gather row w - 1, never in a frontier."""
    col_block = part.rows * part.w
    sg = src_g.astype(np.int64)
    nbr = dst_l[_stable_argsort(sg)]
    out_rp = np.empty(col_block + 1, dtype=np.int32)
    out_rp[0] = 0
    np.cumsum(np.bincount(sg, minlength=col_block), out=out_rp[1:])
    return out_rp, nbr


def out_csr_2d(part: Partition2D, src_gidx, dst_stacked):
    """Every shard's :func:`out_csr_2d_rank`: (out_rp [R, C, R*w + 1], nbr
    [R, C, ep2])."""
    outs = [[out_csr_2d_rank(part, src_gidx[i, j], dst_stacked[i, j])
             for j in range(part.cols)] for i in range(part.rows)]
    return tuple(np.stack([np.stack([o[f] for o in row]) for row in outs])
                 for f in range(2))
