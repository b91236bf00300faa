"""Reference breadth-first search over the reference's CSR, NumPy only.

Up to 64 sources run together, one bit of a word per source: a level ORs
each row's neighbours' frontier words (``np.bitwise_or.reduceat`` over the
row segments), drops the visited bits, and records the level of every
newly set bit. Each source's result is what a one-source search gives.
"""

from __future__ import annotations

import numpy as np

UNREACHED = -1


def distances(row_ptr: np.ndarray, col: np.ndarray, sources) -> np.ndarray:
    """[len(sources), V] int32 hop distances, ``UNREACHED`` where none."""
    sources = np.asarray(sources, dtype=np.int64)
    k = len(sources)
    if not 1 <= k <= 64:
        raise ValueError(f"need 1..64 sources, got {k}")
    dt = np.uint32 if k <= 32 else np.uint64
    nv = len(row_ptr) - 1
    bits = np.left_shift(np.ones(k, dtype=dt), np.arange(k, dtype=dt))
    fw = np.zeros(nv, dtype=dt)
    np.bitwise_or.at(fw, sources, bits)
    vis = fw.copy()
    dist = np.full((k, nv), UNREACHED, dtype=np.int32)
    dist[np.arange(k), sources] = 0
    has = np.flatnonzero(row_ptr[1:] > row_ptr[:-1])
    starts = row_ptr[has]
    level = 0
    while fw.any():
        level += 1
        nxt = np.zeros(nv, dtype=dt)
        if len(starts):
            nxt[has] = np.bitwise_or.reduceat(fw[col], starts)
        nxt &= ~vis
        vis |= nxt
        rows = np.flatnonzero(nxt)
        words = nxt[rows]
        for i in range(k):
            dist[i, rows[(words >> dt(i)) & dt(1) != 0]] = level
        fw = nxt
    return dist


def eccentricity(dist: np.ndarray) -> np.ndarray:
    """[k] int32: each row's largest finite distance."""
    return dist.max(axis=1).astype(np.int32)
