"""The reference's own adjacency: undirected CSR from an input edge list."""

from __future__ import annotations

import numpy as np


def undirected_csr(u: np.ndarray, v: np.ndarray, num_vertices: int):
    """``(row_ptr [V+1] int64, col [2E] int32)``: every input edge (u, v)
    inserted in both directions, rows in vertex order. Parallel edges stay,
    as the input has them."""
    u = np.asarray(u)
    v = np.asarray(v)
    src = np.concatenate([u, v]).astype(np.int32, copy=False)
    dst = np.concatenate([v, u]).astype(np.int32, copy=False)
    order = np.argsort(src, kind="stable")
    col = dst[order]
    del order, dst
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=num_vertices), out=row_ptr[1:])
    return row_ptr, col


def degrees(u: np.ndarray, v: np.ndarray, num_vertices: int) -> np.ndarray:
    """[V] int64 undirected degree: slots per vertex in the doubled list."""
    return (np.bincount(u, minlength=num_vertices)
            + np.bincount(v, minlength=num_vertices)).astype(np.int64)
