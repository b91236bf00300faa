#!/usr/bin/env python3
"""Roofline attribution of the flagship as JAX's bench runs it, on one GPU.

    python3 -m tpu_bfs_torch.tools.roofline                   # RMAT 21, ef 16, 8192 lanes
    python3 -m tpu_bfs_torch.tools.roofline --adaptive off    # the plain flagship
    python3 -m tpu_bfs_torch.tools.roofline --scale 10 --lanes 64 --device cpu

Builds ``HybridMsBfsEngine`` on RMAT ``--scale`` (ef ``--ef``, seed 1, the
numpy generator; cached under ``build/``, the file ``chip_smoke.py``
shares) with ``max_lanes=--lanes`` and ``adaptive_push=--adaptive``
(default ``8192,64``, the caps JAX's bench runs by default), draws the
bench's sources (a pilot BFS from the highest in-degree vertex, then
``default_rng(7)`` among the vertices it reached), times one batch for the
anchor hmean GTEPS, then attributes a traversal level by level
(``tpu_bfs_torch/utils/roofline.py``). Prints one JSON line a level
(``{"roofline_level": ...}``) and a summary line as the last, with the
card's name and power limit. Exits 1 when the stepping loop's level count
is not the anchor batch's (the guard that the slices did not perturb the
traversal). ``--profile-dir DIR`` also writes a ``torch.profiler`` trace of
one more batch into DIR. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def load_rmat(scale: int, ef: int):
    """``(graph, cached)``: RMAT scale/ef/seed 1, cached as ``.npz`` under
    ``build/`` (``chip_smoke.py``'s flagship graph is this file at ef 16)."""
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.graph.io import load_npz, save_npz
    from tpu_bfs_torch.ops._build import BUILD_DIR

    path = BUILD_DIR / f"rmat{scale}_ef{ef}_seed1.npz"
    if path.is_file():
        return load_npz(str(path)), True
    g = rmat_graph(scale, ef, seed=1)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + ".tmp.npz")
    save_npz(str(tmp), g)
    tmp.replace(path)
    return g, False


def bench_sources(engine, lanes: int, seed: int = 7) -> np.ndarray:
    """The bench protocol's sources: a hub pilot, then ``lanes`` draws
    among the vertices it reached."""
    from tpu_bfs_torch.algorithms.msbfs_packed import UNREACHED

    pilot = engine.run(np.array([int(np.argmax(engine.hg.in_degree))]))
    traversable = np.flatnonzero(pilot.distance_u8_lane(0) != UNREACHED)
    return np.random.default_rng(seed).choice(
        traversable, size=lanes, replace=len(traversable) < lanes)


def parse_adaptive(text: str):
    if text == "off":
        return None
    r, d = (int(t) for t in text.split(","))
    return r, d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=8192, help="max_lanes (8192)")
    ap.add_argument("--adaptive", default="8192,64", type=parse_adaptive,
                    help="ROWS,DEG for adaptive_push, or 'off' (default 8192,64)")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="also write a torch.profiler trace of one batch into DIR")
    args = ap.parse_args(argv)

    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.utils.roofline import roofline_hybrid

    t0 = time.perf_counter()
    g, _ = load_rmat(args.scale, args.ef)
    log(f"graph {time.perf_counter() - t0:.1f}s: V={g.num_vertices} E={g.num_edges}")
    t0 = time.perf_counter()
    engine = HybridMsBfsEngine(g, max_lanes=args.lanes, adaptive_push=args.adaptive,
                               device=args.device)
    build_s = time.perf_counter() - t0
    log(f"engine build {build_s:.1f}s: lanes={engine.lanes} planes={engine.num_planes} "
        f"tiles={engine.hg.num_tiles}")
    sources = bench_sources(engine, engine.lanes)
    res = engine.run(sources, time_it=True)
    gteps = res.teps / 1e9
    anchor_levels = res.num_levels
    log(f"anchor batch: {res.elapsed_s * 1e3:.1f}ms, levels={anchor_levels}, "
        f"hmean GTEPS={gteps:.3f}")
    batch_ms = res.elapsed_s * 1e3
    del res
    if args.profile_dir:
        from tpu_bfs_torch.utils.profile import profiled

        with profiled(os.path.join(args.profile_dir, "roofline_batch.json"), engine.device):
            engine.run(sources)
        log(f"profiler trace written to {args.profile_dir}")

    report = roofline_hybrid(engine, sources, measured_gteps=gteps, log=log)
    # The stepping runs one level more than the anchor counts (the last,
    # whose frontier claims nothing), or as many at the plane cap.
    ok = report["num_levels"] in (anchor_levels, anchor_levels + 1)
    report["anchor_levels"] = anchor_levels
    report["stepping_matches_run"] = ok
    for la in report["levels"]:
        print(json.dumps({"roofline_level": la}), flush=True)
    summary = {k: v for k, v in report.items() if k != "levels"}
    summary.update(
        graph=f"RMAT scale {args.scale}, ef {args.ef}, seed 1", lanes=engine.lanes,
        adaptive_push=args.adaptive, engine_build_s=build_s, anchor_batch_ms=batch_ms,
        device=str(engine.device), card=None)
    if engine.device.type == "cuda":
        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary["value"] = report["t_full_sum_s"] if ok else None
    summary["unit"] = "s (stepped level sum)"
    print(json.dumps(summary), flush=True)
    if not ok:
        log(f"LEVEL MISMATCH: stepping ran {report['num_levels']} levels, "
            f"the anchor batch reported {anchor_levels}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
