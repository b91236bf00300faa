"""Graph loaders, the port's NumPy copy of ``tpu_bfs/graph/io.py``.

- ``read_edge_list_text`` / ``load_edge_list``: the reference's text format
  (readGraphFromFile, bfs.cu:829-880): a header ``n m`` then m lines ``u v``
  (0-indexed), inserted in both directions (bfs.cu:860-861). ``%``/``#``
  comment lines are skipped and a 3-int MatrixMarket header (``rows cols
  nnz``, 1-indexed body) is detected. ``load_edge_list`` takes the native
  loader first, as the JAX package does.
- ``read_stdin``: directed single-insert edge list on stdin (bfs.cu:898-903).
- ``save_npz`` / ``load_npz``: the CSR arrays as one ``.npz``.
"""

from __future__ import annotations

import sys

import numpy as np

from tpu_bfs_torch.graph.csr import Graph, build_csr


def read_edge_list_text(
    text: str, *, directed: bool = False, drop_self_loops: bool = False
) -> Graph:
    """Parse an edge-list string into a Graph (format: module docstring)."""
    lines = []
    for ln in text.splitlines():
        s = ln.strip()
        if not s or s[0] in "%#":
            continue
        lines.append(s)
    if not lines:
        raise ValueError("empty graph file")

    header = lines[0].split()
    one_indexed = False
    if len(header) == 3:
        n = max(int(header[0]), int(header[1]))
        m = int(header[2])
        one_indexed = True
    elif len(header) == 2:
        n, m = int(header[0]), int(header[1])
    else:
        raise ValueError(f"unrecognized header line: {lines[0]!r}")

    # float64 so .mtx weight columns parse; ids are exact up to 2**53.
    nums = np.array("\n".join(lines[1:]).split(), dtype=np.float64)
    if len(nums) < 2 * m:
        raise ValueError(f"expected {m} edges, found {len(nums) // 2}")
    if len(nums) == 3 * m:
        nums = nums.reshape(m, 3)[:, :2].ravel()
    else:
        nums = nums[: 2 * m]
    uv = nums.astype(np.int64).reshape(m, 2)
    if one_indexed:
        uv = uv - 1
    u, v = uv[:, 0], uv[:, 1]
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    return from_edges(u, v, num_vertices=n, directed=directed, num_input_edges=m)


def from_edges(
    u: np.ndarray,
    v: np.ndarray,
    *,
    num_vertices: int | None = None,
    directed: bool = False,
    num_input_edges: int | None = None,
    dedup: bool = False,
    weights: np.ndarray | None = None,
) -> Graph:
    """Build a Graph from input edge endpoints (undirected -> double-insert).
    ``dedup`` with weights keeps each surviving slot's minimum weight."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if num_vertices is None:
        num_vertices = int(max(u.max(initial=-1), v.max(initial=-1)) + 1)
    if weights is not None:
        weights = np.asarray(weights, dtype=np.int32)
        if weights.shape != u.shape:
            raise ValueError(
                f"weights shape {weights.shape} != input edge count {u.shape}"
            )
    if directed:
        src, dst, wts = u, v, weights
    else:
        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
        wts = None if weights is None else np.concatenate([weights, weights])
    if dedup:
        packed = src * np.int64(num_vertices) + dst
        if wts is None:
            packed = np.unique(packed)
        else:
            order = np.lexsort((wts, packed))
            packed, wts = packed[order], wts[order]
            first = np.ones(len(packed), dtype=bool)
            first[1:] = packed[1:] != packed[:-1]
            packed, wts = packed[first], wts[first]
        src, dst = packed // num_vertices, packed % num_vertices
    return build_csr(
        src,
        dst,
        num_vertices,
        num_input_edges=num_input_edges if num_input_edges is not None else len(u),
        undirected=not directed,
        weights=wts,
    )


def load_edge_list(path: str, **kw) -> Graph:
    """Load the reference's text format from a file (bfs.cu:829): the native
    C++ loader when it builds (``utils/native.py``), else the text parser."""
    try:
        from tpu_bfs_torch.utils.native import load_edge_list_native

        g = load_edge_list_native(path, **kw)
        if g is not None:
            return g
    except Exception:
        pass  # fall back to the Python parser, whose error names the fault
    with open(path, "r") as f:
        return read_edge_list_text(f.read(), **kw)


def read_stdin(stream=None, *, directed: bool = True) -> Graph:
    """Edge list from stdin, directed single-insert (bfs.cu:898-903)."""
    stream = stream if stream is not None else sys.stdin
    text = stream.read() if hasattr(stream, "read") else str(stream)
    return read_edge_list_text(text, directed=directed)


def save_npz(path: str, g: Graph) -> None:
    extra = {} if g.weights is None else {"weights": g.weights}
    np.savez(
        path,
        row_ptr=g.row_ptr,
        col_idx=g.col_idx,
        num_input_edges=np.int64(g.num_input_edges),
        undirected=np.bool_(g.undirected),
        **extra,
    )


def load_npz(path: str) -> Graph:
    d = np.load(path)
    return Graph(
        row_ptr=d["row_ptr"],
        col_idx=d["col_idx"],
        num_input_edges=int(d["num_input_edges"]),
        undirected=bool(d["undirected"]) if "undirected" in d else True,
        weights=d["weights"] if "weights" in d else None,
    )
