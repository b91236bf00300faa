"""1D contiguous vertex partitioning, the port of
``tpu_bfs/parallel/partition.py``.

The reference's ownership map is ``getDev(v) = v / (numVertices /
DeviceNum)`` (bfs.cu:29-32), which sends the tail vertices to an
out-of-range device when ``V % DeviceNum != 0``. Here, as in the JAX
package, ``owner(v) = v // ceil(V / P)``.

Vertex ids live in a padded id space: rank k owns real ids [k*cpk,
(k+1)*cpk) and padded ids [k*vloc, (k+1)*vloc), vloc > cpk. The phantoms
at the end of each slice absorb the padding edges, and the padded-id map is
strictly monotone, so the min-parent tree is the same on every mesh size.
Edges are sharded by the owner of their source.

Each rank builds only its own row of the JAX package's [P, ...] stacks
(:func:`partition_1d_rank`): its sources are one contiguous range of the
CSR, so the row costs O(E/P) host work past the O(V) row pointer.
:func:`partition_1d` stacks every row, for the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_bfs_torch.graph.csr import EDGE_PAD, Graph, _round_up, _stable_argsort


@dataclasses.dataclass(frozen=True)
class Partition1D:
    num_devices: int
    num_vertices: int  # real V
    cpk: int  # real vertices per rank (ceil(V / P))
    vloc: int  # padded local vertex count (> cpk, a multiple of vertex_pad)
    ep_chip: int  # padded edges per rank (the common max, a multiple of EDGE_PAD)

    @property
    def vp(self) -> int:
        """The whole padded vertex-id space."""
        return self.num_devices * self.vloc

    def owner(self, v):
        """The rank owning real vertex ``v`` (getDev, bfs.cu:29-32, without
        its remainder bug)."""
        return np.asarray(v) // self.cpk

    def to_padded(self, v):
        """Real vertex id -> padded id."""
        v = np.asarray(v)
        return (v // self.cpk) * self.vloc + v % self.cpk

    def from_padded(self, pid):
        """Padded id -> real vertex id (phantoms map out of range)."""
        pid = np.asarray(pid)
        return (pid // self.vloc) * self.cpk + pid % self.vloc

    def unshard(self, arr_vp: np.ndarray) -> np.ndarray:
        """[vp] padded-id-space array -> [V] real-id-space array."""
        per_chip = np.asarray(arr_vp).reshape(self.num_devices, self.vloc)
        return per_chip[:, : self.cpk].reshape(-1)[: self.num_vertices]


def _owned_vertices(graph: Graph, p: int, cpk: int) -> np.ndarray:
    """[P + 1] bounds: rank k owns the real vertices [b[k], b[k+1])."""
    return np.minimum(np.arange(p + 1, dtype=np.int64) * cpk, graph.num_vertices)


def _owned_ranges(graph: Graph, p: int, cpk: int) -> np.ndarray:
    """[P + 1] CSR offsets: rank k's source edges are slots [b[k], b[k+1])."""
    return np.asarray(graph.row_ptr, dtype=np.int64)[_owned_vertices(graph, p, cpk)]


def make_partition_1d(graph: Graph, num_devices: int, *, vertex_pad: int = 1024,
                      edge_pad: int = EDGE_PAD) -> Partition1D:
    """The partition's sizes, from the row pointer alone."""
    v, p = graph.num_vertices, num_devices
    if p < 1:
        raise ValueError("num_devices must be >= 1")
    cpk = (v + p - 1) // p
    vloc = _round_up(cpk + 1, vertex_pad)
    counts = np.diff(_owned_ranges(graph, p, cpk))
    ep_chip = _round_up(int(counts.max(initial=0)) + 1, edge_pad)
    if ep_chip >= 2**31 - 1:
        raise ValueError(
            f"{ep_chip} edge slots on one chip overflow int32 row pointers; "
            "increase the device count"
        )
    return Partition1D(num_devices=p, num_vertices=v, cpk=cpk, vloc=vloc, ep_chip=ep_chip)


def partition_1d_rank(graph: Graph, part: Partition1D, k: int):
    """Rank ``k``'s row of :func:`partition_1d`: (src [ep_chip], dst
    [ep_chip], rp [vp + 1]) int32, its edges in padded ids sorted by (dst,
    src). Padding edges run from the rank's own last phantom to the
    globally last phantom vp - 1, which keeps dst non-decreasing."""
    cpk, vloc, vp, ep = part.cpk, part.vloc, part.vp, part.ep_chip
    v0, v1 = _owned_vertices(graph, part.num_devices, cpk)[k : k + 2]
    rp = np.asarray(graph.row_ptr, dtype=np.int64)
    lo, hi = rp[v0], rp[v1]
    # The rank's slice of the CSR's (src, dst) list, without the whole list.
    src = np.repeat(np.arange(v0, v1, dtype=np.int64), np.diff(rp[v0 : v1 + 1]))
    dst = graph.col_idx[lo:hi].astype(np.int64)
    psrc = (src // cpk) * vloc + src % cpk
    pdst = (dst // cpk) * vloc + dst % cpk
    # The slice is src-major (the CSR) and psrc is monotone in src, so a
    # stable sort by dst alone gives the (dst, src) order.
    order = _stable_argsort(pdst) if len(pdst) else np.zeros(0, np.int64)
    n = hi - lo
    src_row = np.full(ep, (k + 1) * vloc - 1, dtype=np.int32)
    dst_row = np.full(ep, vp - 1, dtype=np.int32)
    src_row[:n] = psrc[order]
    dst_row[:n] = pdst[order]
    rp_row = np.empty(vp + 1, dtype=np.int32)
    rp_row[0] = 0
    np.cumsum(np.bincount(dst_row, minlength=vp), out=rp_row[1:])
    return src_row, dst_row, rp_row


def partition_1d(graph: Graph, num_devices: int, *, vertex_pad: int = 1024,
                 edge_pad: int = EDGE_PAD):
    """Shard a graph's edges by source owner over ``num_devices`` ranks.

    Returns (partition, src_stacked, dst_stacked, rp_stacked): [P, ep_chip]
    int32 edge arrays in padded ids and the [P, vp + 1] CSR-by-dst row
    pointers, every rank's :func:`partition_1d_rank` row."""
    part = make_partition_1d(graph, num_devices, vertex_pad=vertex_pad, edge_pad=edge_pad)
    rows = [partition_1d_rank(graph, part, k) for k in range(num_devices)]
    return (part,) + tuple(np.stack(col) for col in zip(*rows))


def out_csr_1d_rank(part: Partition1D, k: int, src_row: np.ndarray, dst_row: np.ndarray):
    """Rank ``k``'s CSR by local source, for the direction-optimizing
    top-down branch: (out_rp [vloc + 1], nbr [ep_chip]) int32. Rows are
    local ids [0, vloc); neighbours stay global padded ids. The padding
    edges sit on the phantom row vloc - 1, never in a frontier."""
    vloc = part.vloc
    src_local = src_row.astype(np.int64) - k * vloc
    nbr = dst_row[_stable_argsort(src_local)]
    out_rp = np.empty(vloc + 1, dtype=np.int32)
    out_rp[0] = 0
    np.cumsum(np.bincount(src_local, minlength=vloc), out=out_rp[1:])
    return out_rp, nbr


def out_csr_1d(part: Partition1D, src_stacked, dst_stacked):
    """Every rank's :func:`out_csr_1d_rank`, stacked: (out_rp [P, vloc + 1],
    nbr [P, ep_chip])."""
    rows = [out_csr_1d_rank(part, k, src_stacked[k], dst_stacked[k])
            for k in range(part.num_devices)]
    return tuple(np.stack(col) for col in zip(*rows))
