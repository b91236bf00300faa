"""Carry graph structures into the port from plain dicts of NumPy arrays.

A traversal's state is its graph structure, so this is the port's
"weights across": ``graph_from_numpy``, ``ell_from_numpy`` and
``hybrid_from_numpy`` rebuild the port's ``Graph``, ``EllGraph`` and
``HybridGraph`` from the field dicts that ``dataclasses.asdict`` gives for
the JAX package's objects of the same names (nested buckets arrive as
dicts). With them the two packages' engines run on identical structures.
"""

from __future__ import annotations

import dataclasses

from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridGraph
from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.ell import EllBucket, EllGraph


def _fields(cls, fields: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    missing = names - fields.keys()
    extra = fields.keys() - names
    if missing or extra:
        raise ValueError(
            f"{cls.__name__} fields: missing {sorted(missing)}, unknown {sorted(extra)}"
        )
    return dict(fields)


def _bucket(d) -> EllBucket | None:
    if d is None or isinstance(d, EllBucket):
        return d
    return EllBucket(**_fields(EllBucket, d))


def graph_from_numpy(fields: dict) -> Graph:
    return Graph(**_fields(Graph, fields))


def ell_from_numpy(fields: dict) -> EllGraph:
    f = _fields(EllGraph, fields)
    f["virtual"] = _bucket(f["virtual"])
    f["light"] = [_bucket(b) for b in f["light"]]
    return EllGraph(**f)


def hybrid_from_numpy(fields: dict) -> HybridGraph:
    f = _fields(HybridGraph, fields)
    f["res_virtual"] = _bucket(f["res_virtual"])
    f["res_light"] = [_bucket(b) for b in f["res_light"]]
    return HybridGraph(**f)
