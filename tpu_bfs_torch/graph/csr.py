"""Host-side CSR graph (NumPy), the port's copy of ``tpu_bfs/graph/csr.py``.

``Graph`` is the reference's global ``Graph`` struct (bfs.cu:21-28:
``adjacencyList`` / ``edgesOffset`` / ``numVertices`` / ``numEdges``), but
immutable and never global. The JAX package's padded ``DeviceGraph`` is not
ported: the PyTorch engines build their device tables from the ELL layouts.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Sentinel for "unreached" distance; reference uses INT_MAX (bfs.cu:404-406).
INF_DIST = np.int32(np.iinfo(np.int32).max)
NO_PARENT = np.int32(-1)


def _lexsort_pairs(major: np.ndarray, minor: np.ndarray) -> np.ndarray:
    """Permutation ordering by (major, minor). Any stable order gives the
    same sorted keys, so the arrays built from it equal the JAX package's
    (which may take a native counting sort instead)."""
    return np.lexsort((minor, major))


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

    def to_scipy(self):
        import scipy.sparse as sp

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

    if sort_neighbors:
        order = _lexsort_pairs(src, dst)
    else:
        order = np.argsort(src, kind="stable")
    src_sorted = src[order]
    col_idx = dst[order].astype(np.int32)
    counts = np.bincount(src_sorted, minlength=num_vertices)
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(
        row_ptr=row_ptr,
        col_idx=col_idx,
        num_input_edges=num_input_edges if num_input_edges is not None else len(src),
        undirected=undirected,
        weights=None if weights is None else weights[order],
    )
