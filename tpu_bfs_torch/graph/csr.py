"""Host-side CSR graph (NumPy), the port's copy of ``tpu_bfs/graph/csr.py``.

``Graph`` is the reference's global ``Graph`` struct (bfs.cu:21-28:
``adjacencyList`` / ``edgesOffset`` / ``numVertices`` / ``numEdges``), but
immutable and never global. ``DeviceGraph`` is its padded edge-centric form,
the host layout of the single-source and batched boolean engines
(``algorithms/bfs.py``, ``algorithms/msbfs.py``); the packed engines build
their device tables from the ELL layouts instead.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Sentinel for "unreached" distance; reference uses INT_MAX (bfs.cu:404-406).
INF_DIST = np.int32(np.iinfo(np.int32).max)
NO_PARENT = np.int32(-1)

# Vertex and edge counts are padded to multiples of these, as in the JAX
# package, so that both packages lay out the same padded arrays.
VERTEX_PAD = 1024
EDGE_PAD = 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _lexsort_pairs(
    major: np.ndarray, minor: np.ndarray, n: int, n_minor: int | None = None
) -> np.ndarray:
    """Permutation ordering by (major, minor): the native O(E) counting sort
    when built (native/loader.cpp), np.lexsort otherwise. ``n``/``n_minor``
    bound the key value ranges (both default n); undersized bounds make the
    native path reject and fall back to the O(E log E) sort. Both are
    stable, so the permutation is the same either way."""
    try:
        from tpu_bfs_torch.utils.native import lexsort_pairs

        perm = lexsort_pairs(major, minor, n, n if n_minor is None else n_minor)
        if perm is not None:
            return perm
    except Exception:
        pass
    return np.lexsort((minor, major))


def _sorted_pairs(major: np.ndarray, minor: np.ndarray, n_minor: int):
    """The (major, minor) pairs in (major, minor) order, as two int64
    arrays: the values ``_lexsort_pairs`` would order, from one sort of
    packed int64 keys (several times faster than the two-key lexsort). For
    callers that need the sorted values, not the permutation. Both arrays
    are non-negative, ``minor < n_minor`` and ``major * n_minor < 2**63``."""
    key = major.astype(np.int64)
    key *= n_minor
    key += minor
    key.sort()
    return key // n_minor, key % n_minor


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for non-negative int keys below
    2**31 and fewer than 2**32 of them, from one sort of (key << 32 | index)
    int64 words, which is several times faster."""
    packed = keys.astype(np.int64)
    packed <<= 32
    packed |= np.arange(len(keys), dtype=np.int64)
    packed.sort()
    return packed & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Graph:
    """Host-side CSR graph (0-indexed, directed edge slots).

    An undirected input edge (u, v) is stored as two directed slots, matching
    the reference loader's double-insert (bfs.cu:860-861), so ``num_edges`` is
    2m for an undirected graph with m input edges.
    """

    row_ptr: np.ndarray  # [V+1] int64
    col_idx: np.ndarray  # [E]   int32
    num_input_edges: int  # m as given in the input (before direction doubling)
    undirected: bool = True
    # Optional per-edge-slot int32 weights (>= 1) aligned with col_idx.
    weights: np.ndarray | None = None

    def __post_init__(self):
        assert self.row_ptr.ndim == 1 and self.col_idx.ndim == 1
        assert self.row_ptr[0] == 0 and self.row_ptr[-1] == len(self.col_idx)
        if self.weights is not None:
            assert self.weights.shape == self.col_idx.shape

    @property
    def num_vertices(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def num_edges(self) -> int:
        """Directed edge slots (reference: numEdges, bfs.cu:875)."""
        return len(self.col_idx)

    @cached_property
    def degrees(self) -> np.ndarray:
        """Per-vertex out-degree (reference: edgesSize, bfs.cu:25)."""
        return np.diff(self.row_ptr).astype(np.int64)

    @cached_property
    def coo(self) -> tuple[np.ndarray, np.ndarray]:
        """Edge-centric (src, dst) view, row-major (sorted by src)."""
        src = np.repeat(np.arange(self.num_vertices, dtype=np.int32), self.degrees)
        return src, self.col_idx.astype(np.int32)

    def has_edge(self, u: int, v: int) -> bool:
        """Whether the edge slot u -> v exists (binary search in a sorted
        adjacency list, a scan in an unsorted one)."""
        lo, hi = self.row_ptr[u], self.row_ptr[u + 1]
        sl = self.col_idx[lo:hi]
        j = np.searchsorted(sl, v)
        if j < len(sl) and sl[j] == v:
            return True
        # Adjacency may be unsorted when built with sort_neighbors=False.
        return bool(np.any(sl == v))

    def to_scipy(self, *, weighted: bool = False):
        """The CSR as a SciPy matrix: ones, or the weights plane."""
        import scipy.sparse as sp

        if weighted:
            if self.weights is None:
                raise ValueError("graph has no weights plane")
            data = self.weights.astype(np.int64)
        else:
            data = np.ones(self.num_edges, dtype=np.int8)
        return sp.csr_matrix(
            (data, self.col_idx, self.row_ptr),
            shape=(self.num_vertices, self.num_vertices),
        )


def build_csr(
    src: np.ndarray,
    dst: np.ndarray,
    num_vertices: int,
    *,
    num_input_edges: int | None = None,
    sort_neighbors: bool = True,
    undirected: bool = True,
    weights: np.ndarray | None = None,
) -> Graph:
    """Build a CSR Graph from directed edge slots (a vectorized counting sort;
    the reference concatenates per-vertex vectors, bfs.cu:866-872)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    assert src.shape == dst.shape
    if len(src) and (src.min() < 0 or src.max() >= num_vertices):
        raise ValueError("src vertex id out of range")
    if len(dst) and (dst.min() < 0 or dst.max() >= num_vertices):
        raise ValueError("dst vertex id out of range")
    if weights is not None:
        weights = np.asarray(weights, dtype=np.int32)
        if weights.shape != src.shape:
            raise ValueError(f"weights shape {weights.shape} != edge count {src.shape}")
        if len(weights) and weights.min() < 1:
            raise ValueError("edge weights must be >= 1")

    if sort_neighbors and weights is None:
        # Without weights only the sorted values matter.
        src_sorted, col_idx = _sorted_pairs(src, dst, num_vertices)
        col_idx = col_idx.astype(np.int32)
    else:
        order = (_lexsort_pairs(src, dst, num_vertices) if sort_neighbors
                 else np.argsort(src, kind="stable"))
        src_sorted = src[order]
        col_idx = dst[order].astype(np.int32)
        if weights is not None:
            weights = weights[order]
    counts = np.bincount(src_sorted, minlength=num_vertices)
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(
        row_ptr=row_ptr,
        col_idx=col_idx,
        num_input_edges=num_input_edges if num_input_edges is not None else len(src),
        undirected=undirected,
        weights=weights,
    )


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Padded, edge-centric graph: the host arrays the single-source and
    batched boolean engines move to the device.

    - Vertex ids in [num_vertices, vp) are phantoms: no real edge touches them,
      padding edges are phantom->phantom self-loops, and phantoms are never in
      the frontier, so they are inert in every level step.
    - Edges are sorted by (dst, src): destination-major order makes the
      scatter-min of a level segment-local, which the scan backend exploits;
      the min-src tie-break makes parents deterministic (unlike the
      reference's atomic-race winner, bfs.cu:146-147).
    """

    src: np.ndarray  # [ep] int32, dst-major order
    dst: np.ndarray  # [ep] int32, non-decreasing
    num_vertices: int  # real V
    num_edges: int  # real directed edge slots
    num_input_edges: int
    undirected: bool
    vp: int  # padded vertex count (>= V+1, multiple of VERTEX_PAD)
    ep: int  # padded edge count (multiple of EDGE_PAD)
    # CSR-by-destination over the padded arrays: in_row_ptr[v] is the first
    # padded-edge index with dst == v.
    in_row_ptr: np.ndarray  # [vp+1] int64
    # CSR-by-source over the src-major padded edge order (real edges in
    # (src, dst) order, then phantom padding), for the 'delta' and 'dopt'
    # backends.
    out_row_ptr: np.ndarray  # [vp+1] int64
    # perm_ds[i] = src-major position of the i-th dst-major edge.
    perm_ds: np.ndarray  # [ep] int32

    @classmethod
    def from_graph(cls, g: Graph, *, vertex_pad: int = VERTEX_PAD,
                   edge_pad: int = EDGE_PAD) -> "DeviceGraph":
        v, e = g.num_vertices, g.num_edges
        # At least one phantom vertex, so padding edges have a target.
        vp = _round_up(v + 1, vertex_pad)
        ep = _round_up(max(e, 1), edge_pad)
        src, dst = g.coo  # src-major (CSR) order
        # The (dst, src) order: src never decreases along the CSR's edges,
        # so a stable sort by dst alone gives it, and duplicate (dst, src)
        # slots keep their CSR order, as in the JAX package's stable sort.
        order = _stable_argsort(dst)
        src_p = np.full(ep, vp - 1, dtype=np.int32)
        dst_p = np.full(ep, vp - 1, dtype=np.int32)
        src_p[:e] = src[order]
        dst_p[:e] = dst[order]
        in_row_ptr = np.zeros(vp + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst_p.astype(np.int64), minlength=vp), out=in_row_ptr[1:])
        out_counts = np.bincount(src.astype(np.int64), minlength=vp)
        out_counts[vp - 1] += ep - e  # the padding edges
        out_row_ptr = np.zeros(vp + 1, dtype=np.int64)
        np.cumsum(out_counts, out=out_row_ptr[1:])
        perm_ds = np.empty(ep, dtype=np.int32)
        perm_ds[:e] = order
        perm_ds[e:] = np.arange(e, ep)
        return cls(
            src=src_p, dst=dst_p, num_vertices=v, num_edges=e,
            num_input_edges=g.num_input_edges, undirected=g.undirected,
            vp=vp, ep=ep, in_row_ptr=in_row_ptr, out_row_ptr=out_row_ptr,
            perm_ds=perm_ds,
        )
