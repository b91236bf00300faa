"""Reference connected components and Graph500's traversed-edge counts.

In an undirected graph a search from key s reaches exactly s's component,
and Graph500 counts as traversed the input edges with both endpoints
reached: the input edges of that component. So one component table gives
every lane's expected ``reached`` and ``edges_traversed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def labels(row_ptr: np.ndarray, col: np.ndarray) -> np.ndarray:
    """[V] int32: each vertex's component, named by its least vertex id.

    Min-label propagation over the rows, each round followed by pointer
    jumping to a fixed point. Every label stays a vertex of the same
    component with an id no larger, so at the fixed point a component's
    labels are equal and are its least id."""
    nv = len(row_ptr) - 1
    lab = np.arange(nv, dtype=np.int32)
    has = np.flatnonzero(row_ptr[1:] > row_ptr[:-1])
    starts = row_ptr[has]
    while True:
        new = lab.copy()
        if len(starts):
            new[has] = np.minimum(lab[has], np.minimum.reduceat(lab[col], starts))
        while True:
            jumped = new[new]
            if np.array_equal(jumped, new):
                break
            new = jumped
        if np.array_equal(new, lab):
            return lab
        lab = new


@dataclasses.dataclass(frozen=True)
class ComponentTable:
    """Per vertex: its component's label; per label: vertices and input edges."""

    label: np.ndarray  # [V] int32
    size: np.ndarray  # [V] int64, indexed by label
    edges: np.ndarray  # [V] int64, indexed by label

    def reached(self, keys: np.ndarray) -> np.ndarray:
        return self.size[self.label[keys]]

    def traversed(self, keys: np.ndarray) -> np.ndarray:
        return self.edges[self.label[keys]]


def table(lab: np.ndarray, u: np.ndarray) -> ComponentTable:
    """The component table of input edges ``(u, v)`` under ``lab`` (an
    edge's endpoints share a component, so ``u`` alone places it)."""
    nv = len(lab)
    return ComponentTable(
        label=lab,
        size=np.bincount(lab, minlength=nv).astype(np.int64),
        edges=np.bincount(lab[u], minlength=nv).astype(np.int64),
    )
