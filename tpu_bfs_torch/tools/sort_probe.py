#!/usr/bin/env python3
"""Which sort builds the flagship's host tables faster: the packed-key
sorts the port uses, or the native O(E) counting sort the JAX package takes.

    python3 -m tpu_bfs_torch.tools.sort_probe                # RMAT 21, ef 16, native stream
    python3 -m tpu_bfs_torch.tools.sort_probe --scale 12 --turns 2

The port sorts pairs by packing each (major, minor) into one int64 key and
sorting the keys (``graph/csr.py``: ``_sorted_pairs``, ``_stable_argsort``;
used by ``build_csr``, ``build_ell`` and ``build_hybrid``). JAX routes the
same sorts through the native counting sort (``lexsort_pairs``) when it is
built. Both give the same arrays. This probe generates RMAT ``--scale``
(ef ``--ef``, seed 1) with the native generator, then times, in turns
(packed, native, native, packed, ...), ``from_edges`` over its endpoints
(the CSR build of ``rmat_graph``) and ``build_hybrid`` on the graph, once
with the packed sorts and once with the counting sort patched in, and
checks every array of the two builds equal. Prints one JSON line a turn and
a summary line last; the host has no GPU work, so this runs anywhere.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np


def native_sorted_pairs(major, minor, n_minor: int):
    """``csr._sorted_pairs`` through the native counting sort."""
    from tpu_bfs_torch.utils.native import lexsort_pairs

    major = np.asarray(major, dtype=np.int64)
    minor = np.asarray(minor, dtype=np.int64)
    n_major = int(major.max()) + 1 if len(major) else 1
    perm = lexsort_pairs(major, minor, n_major, n_minor)
    if perm is None:
        raise RuntimeError("native counting sort unavailable")
    return major[perm], minor[perm]


def native_stable_argsort(keys):
    """``csr._stable_argsort`` through the native counting sort (one key)."""
    from tpu_bfs_torch.utils.native import lexsort_pairs

    keys = np.asarray(keys, dtype=np.int64)
    n = int(keys.max()) + 1 if len(keys) else 1
    perm = lexsort_pairs(keys, np.zeros(len(keys), np.int64), n, 1)
    if perm is None:
        raise RuntimeError("native counting sort unavailable")
    return perm


@contextlib.contextmanager
def native_sorts():
    """Patch the counting sort into every loaded module of the package that
    binds one of the packed sorts (found by identity with ``csr``'s
    functions, so a new importer is patched too). The caller imports the
    builds it times first."""
    from tpu_bfs_torch.graph import csr

    patches = {id(csr._sorted_pairs): native_sorted_pairs,
               id(csr._stable_argsort): native_stable_argsort}
    saved = []
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith("tpu_bfs_torch"):
            continue
        for name, fn in list(vars(mod).items()):
            if id(fn) in patches:
                saved.append((mod, name, fn))
                setattr(mod, name, patches[id(fn)])
    if not saved:
        raise RuntimeError("no module binds the packed sorts")
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def same_arrays(a, b, what: str) -> None:
    """Every field of two builds equal (arrays, buckets, scalars)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_arrays(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: lengths {len(a)} != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_arrays(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: arrays differ")
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--turns", type=int, default=4,
                    help="builds a sort, in turns packed/native/native/packed (4)")
    args = ap.parse_args(argv)

    from tpu_bfs_torch.algorithms.msbfs_hybrid import build_hybrid
    from tpu_bfs_torch.graph.generate import rmat_edges
    from tpu_bfs_torch.graph.io import from_edges
    from tpu_bfs_torch.utils import native

    t0 = time.perf_counter()
    native.ensure_built(log=lambda m: print(f"# {m}", file=sys.stderr))
    if not native.has_rmat():
        print("sort_probe: the native library did not build", file=sys.stderr)
        return 1
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    u, v = rmat_edges(args.scale, args.ef, seed=1, impl="native")
    keep = u != v
    gen_s = time.perf_counter() - t0

    def csr_build():
        return from_edges(u[keep], v[keep], num_vertices=1 << args.scale, directed=False,
                          num_input_edges=len(u))

    order = ["packed", "native", "native", "packed"]
    order = (order * (args.turns // 2 + 1))[: 2 * args.turns]
    times = {"packed": {"csr_s": [], "hybrid_s": []}, "native": {"csr_s": [], "hybrid_s": []}}
    first = {}
    for turn, sort in enumerate(order):
        with native_sorts() if sort == "native" else contextlib.nullcontext():
            t0 = time.perf_counter()
            g = csr_build()
            csr_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            hg = build_hybrid(g)
            hybrid_s = time.perf_counter() - t0
        if "graph" in first:
            same_arrays(first["graph"], g, f"{sort} graph")
            same_arrays(first["hybrid"], hg, f"{sort} hybrid")
        else:
            first.update(graph=g, hybrid=hg)
        times[sort]["csr_s"].append(csr_s)
        times[sort]["hybrid_s"].append(hybrid_s)
        print(json.dumps({"turn": turn, "sort": sort, "csr_s": csr_s, "hybrid_s": hybrid_s}),
              flush=True)
        del g, hg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip() if _has_smi() else None
    summary = {
        "scale": args.scale, "ef": args.ef, "stream": "native", "cores": os.cpu_count(),
        "library_build_s": build_s, "generate_s": gen_s,
        "edge_slots": int(first["graph"].num_edges),
        "median_s": {s: {k: float(np.median(x)) for k, x in t.items()} for s, t in times.items()},
        "arrays_equal": True, "card": smi,
    }
    med = summary["median_s"]
    summary["faster_hybrid"] = min(med, key=lambda s: med[s]["hybrid_s"])
    summary["faster_csr"] = min(med, key=lambda s: med[s]["csr_s"])
    print(json.dumps(summary), flush=True)
    return 0


def _has_smi() -> bool:
    from shutil import which

    return which("nvidia-smi") is not None


if __name__ == "__main__":
    sys.exit(main())
