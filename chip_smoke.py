#!/usr/bin/env python3
"""Drive the PyTorch port (tpu_bfs_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # the full run: RMAT scale 21, 8192 lanes
    python3 chip_smoke.py --scale 16      # a quicker flagship (cut stated in output)

Phases, one JSON line each:
 1. device: the card and its power limit (nvidia-smi);
 2. build: both CUDA kernels compiled from tpu_bfs_torch/csrc with nvcc;
 3. parity: each kernel against its plain PyTorch twin, bit-exact, at small
    ragged shapes (K1 ell_expand: or/min/minplus, w 1/8/33/256, k 1/7/64/70,
    gated tiles, and min at w 128 over keys with bit 31 set and an all-ones
    sentinel row; K2 tile_spmm: w 1/8/33/64/256, fresh and accumulating into
    a prior table from the row masks alone, empty and split row tiles); and
    a ParentScanner on RMAT scale 12, on the card, on CPU tensors and as
    validate.min_parent_from_dist, all equal;
 4. wide: WidePackedMsBfsEngine, RMAT scale 18, 4096 lanes, 3 lanes
    validated against the SciPy oracle, K1 launches counted;
 5. flagship: HybridMsBfsEngine, RMAT scale 21 (ef 16, seed 1), 8192 lanes,
    the bench protocol (hub pilot as warm-up, sources from default_rng(7)
    among traversable vertices, one timed batch, 5 lanes validated), with
    both kernels' launch counts and summed CUDA-event times;
 6. kernels: each kernel at the flagship's shapes against its twin
    (bit-exact), its time, the twin's time, its device-memory bound, its
    streamed-bytes model and nvcc's register and shared-memory report;
 7. parents: the flagship batch's BFS trees through the device parent scan
    (K1 op=min over a full ELL, 64 passes of 128 lanes), each pass timed on
    the device and copied to the host, every lane of the first pass decoded
    there (timed), the validated lanes of the others; the 5 validated lanes
    equal validate.min_parent_from_dist and pass certify_bfs; then the
    public parents_into(device="device") on a 256-lane batch. The K1 min
    entry of the kernels line is timed here, at the scan's shape;
 8. single: the reference's single-source BFS on the flagship graph,
    through BfsEngine with each of the scan, segment, scatter, delta and
    dopt backends and through TiledBfsEngine: 4 sources (the hub and 3
    drawn with default_rng(7) among the traversable vertices), each run
    once to warm and once timed; every distance array equals SciPy's and
    every tree equals the first engine's, which passes check_parents. Per
    backend: ms per BFS, levels, GTEPS, host syncs and peak memory. These
    engines are plain PyTorch: no kernel launches;
 9. packed: the 512-lane PackedMsBfsEngine on the flagship graph, one
    build_ell shared by a 256-lane (w 8) and a 32-lane (w 1) engine, each
    with the single phase's sources in lanes 0-2 (checked against SciPy)
    and lane 0's tree from parents_int32 (the device scan), equal to the
    single phase's checked tree; K1 launches counted, and K1 held
    against its twin bit for bit at both widths on the run's own tables
    (the "K1 or, packed w 8" and "K1 or, packed w 1" kernel entries);
10. graph500: run_graph500(scale 18, ef 16, mode="hybrid", 64 searches,
    4 validated) on the card, its trees from the device scan through the
    default parents_int32 (the host scatter-min is made to raise while it
    runs): scale 18, not 21 (the flagship phase runs the hybrid at 21),
    keeps the whole script near 11 minutes (--graph500-scale 20 or 21 runs
    the larger graphs; the line states the cut).
    Then mode="single" (16 searches, 4 validated) and mode="batched" (64
    searches) at scale 18 (--graph500-small-scale; the single phase runs the
    single-source path at the flagship's scale 21).
11. pullgate (run after parents): HybridMsBfsEngine(pull_gate=True) on the
    flagship's HybridGraph, a gated and an ungated batch on the flagship's
    8192 sources: visited tables equal and plane bits equal on real rows of
    active lanes (compared on the device), 3 lanes against SciPy; both batch
    times, hmean GTEPS, the skipped blocks (gated_tiles), state blocks and
    host reads per level, K1's time per level in each and peak memory; then
    the wide engine at the wide phase's scale, gated against ungated. The
    gated batch's K1 launches, replayed on their own masks, are the "K1 or,
    gated" kernels entry. After the single phase, TiledBfsEngine(pull_gate=
    True) from its sources, equal to SciPy and to its checked trees;
12. ckpt (after packed): a 256-lane hybrid batch on the flagship graph,
    its first --ckpt-every levels (4) on the hybrid, saved, loaded and
    resumed to the end on the wide engine (one save a mode, cut from one
    a chunk to keep the script's time), equal on every lane to an
    uninterrupted run; ungated, then gated. Then a single-source BfsEngine
    (scan) started, advanced to level 2, saved, loaded and finished, equal
    to run.
13. workloads, one line a kind. khop (after pullgate): KhopServeEngine over
    the flagship HybridMsBfsEngine, k = 3, on its 8192 sources, 3 lanes'
    reached equal to SciPy's vertices within 3 hops. Then, after ckpt:
    sssp, SsspEngine at 256 lanes on the flagship graph with
    edge_weights(seed=1, wmax=8) attached, from the hub and sources drawn
    with default_rng(7) among the traversable vertices, a warm batch (CUDA
    events on every K1 launch) and a timed one, 3 lanes equal to SciPy's
    dijkstra; both halves of every round are K1 minplus launches, and the
    run's distances against its light-plane tables are the "K1 minplus,
    sssp w 256" kernels entry (bit-exact against its twin on those tables
    and on the full-weight plane of the heavy close). cc, connected_components over a 8192-lane
    WidePackedMsBfsEngine on the flagship ELL, labels and count equal to
    SciPy's components. p2p, P2pServeEngine over a 256-lane wide engine,
    128 pairs: every path walked edge by edge, 4 distances equal to
    SciPy's, fewer levels than those sources' BFS depth.
14. mesh (after khop): the mesh engines on a one-rank NCCL group on
    cuda:0. DistHybridMsBfsEngine (dense exchange) at the flagship's full
    size on the flagship's 8192 sources: its visited and plane tables equal
    a single-device batch's of the same call (at one rank the tau order is
    the rank order), every lane's distances, reached counts and
    eccentricities too, and the
    flagship's validated lanes equal SciPy; its batch ms and hmean GTEPS
    beside the single-device batch's, the all-gather ms a level (CUDA
    events), host reads a level, the build seconds and peak memory. Its
    shard tables give the "K1 or, mesh shard" and "K2, mesh shard" kernels
    entries. Then at the wide phase's scale 18 with 4096 lanes: the hybrid's
    sparse and sliced exchanges against a single-device HybridMsBfsEngine
    and DistWideMsBfsEngine (dense, sparse) against the wide phase's
    engine, every lane's distances compared on the device. Last, two gloo
    ranks sharing cuda:0 (NCCL refuses two ranks on one device) run
    DistHybridMsBfsEngine at the same scale, equal to a single-device batch.
15. mesh_single (after single): the single-source mesh engines on a
    one-rank NCCL group on cuda:0 at the flagship's full size, from the
    single phase's 4 sources: DistBfsEngine with the ring, allreduce and
    sparse exchanges (scan) and with dopt (ring), and Dist2DBfsEngine 1x1
    with ring and sparse. Each BFS runs once to warm and once timed; every
    distance array equals SciPy's and every tree the single phase's checked
    tree. Per engine: ms per BFS (the timed run, and the median of 3 more
    in turns with BfsEngine's of the same backend, scan or dopt), GTEPS, levels, host reads a level, the exchange's ms a level
    (CUDA events around the row exchange and the 2D column gather), branch
    counts and modeled bytes, build seconds and peak memory above the
    memory held just before the engine is built (its build and its checked
    runs). These engines are plain PyTorch: no kernel launches.
    One host partition a mesh shape is shared by its engines (its seconds
    stated). Then gloo ranks sharing cuda:0 at the wide phase's scale 18: the 1D
    engine on 2 ranks and the 2D engine on 2x2, ring and sparse, every
    source's distances and tree equal to BfsEngine's on the card.
16. mesh_kinds (after p2p): every workload kind on a one-rank NCCL group on
    cuda:0 at the flagship's full size, over one build_ell_sharded of the
    flagship graph (the weights do not change it) and one
    build_ell_weights_sharded. DistSsspEngine at 256
    lanes on the sssp phase's weighted graph and sources, with the ring,
    allreduce and sparse (delta ids 8/16, prediction) exchanges: a warm
    batch, a timed one (its K1 launches exactly buckets x (rounds +
    closes)), 2 more in turns with the sssp phase's SsspEngine; every lane's
    distances equal SsspEngine's bit for bit on the device and the checked
    lanes SciPy's dijkstra; rounds, closes, host reads a round, the exchange
    ms a round (CUDA events) and peak memory per engine. The ring engine's
    shard tables give the "K1 minplus, mesh shard, w 256" kernels entry
    (light plane, and the heavy close's plane held to the twin too). Then
    connected_components and k-hop (k = 3) over an 8192-lane
    DistWideMsBfsEngine on the flagship's sources, and p2p (the p2p phase's
    128 pairs) over a 256-lane one: equal to the single-device phases'
    labels, counts and answers, every path walked. Last, two gloo ranks
    sharing cuda:0 at RMAT scale 16 (--mesh-kinds-small-scale): the mesh
    SSSP (sparse, delta, prediction), DistBfsEngine with every planner knob
    and k-hop over the wide mesh engine with delta ids, equal to their
    one-device engines.
17. serve (after mesh_kinds, the flagship graph still loaded): the serve
    tier (tpu_bfs_torch/serve). BfsService(engine="wide", lanes=256,
    width_ladder="auto" (32/64/256), linger_ms=2) on the flagship graph, the
    JAX bench_serve protocol not cut: 64 client threads x 8 queries, closed
    loop, sources from default_rng(7) among the traversable vertices;
    pipelined, then the same loop unpipelined on the same warmed rungs. Every
    response's reached and levels equal the 256-lane rung engine's direct
    batches, 8 rows of distances those batches' and 3 SciPy's. QPS, p50/p99,
    fill, routing, extract p50, peak memory, K1 launches, each rung's build
    and warm seconds and the dispatch's host reads a level. One 48-query
    batch routed to the 64-lane rung (w 2) gives the "K1 or, serve rung
    w 2" kernels entry. Then `python -m tpu_bfs_torch.serve` on RMAT 16 as
    a subprocess (three queries, a malformed line, an out-of-range source;
    SIGTERM drains it, exit 0); the chaos arm (the flagship service under
    seed=7:transient@serve_batch:n=2,slow_extract:ms=50:n=4, 64 queries,
    the recovery counters exactly the fired faults); at the wide phase's
    scale with edge_weights(seed=1, wmax=8) a five-kind service (8 queries
    a kind, each equal to that kind's engine run directly), a hybrid service
    (4096 lanes, 64 queries, K2 on the serve path) and the answer tier (a
    repeat is a cache hit, a landmark-exact p2p pair needs no dispatch).
The last line is {"ok": true, "device": {...}}. Any failed check raises and
the script exits non-zero; it also exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# Parent-scan passes whose 128 lanes are all decoded on the host (timed);
# the rest decode only the validated lanes (a whole pass takes seconds).
# One pass keeps the whole script near 9 minutes.
DECODE_PASSES = 1
# Threads checking BFS trees on the host side by side (a lane's check is
# a few O(E) numpy passes, some 2 GB of temporaries at scale 21).
CHECK_THREADS = 4
# Timed runs a source in the mesh_single phase past the protocol's one, in
# turns with BfsEngine's: the spread of a ~10 ms BFS driven from the host.
REPEATS = 3
# Turns of each mesh SSSP engine with SsspEngine in the mesh_kinds phase
# (a ~0.7 s batch: two keep the phase near its 100 s).
MESH_KINDS_TURNS = 2
# The serve phase's closed loop (the JAX bench_serve's: 64 clients x 8
# queries) and its chaos arm's fault spec (scripts/chip_session.sh:203-204).
SERVE_CLIENTS = 64
SERVE_PER_CLIENT = 8
SERVE_SPEC = "seed=7:transient@serve_batch:n=2,slow_extract:ms=50:n=4"
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj["at_s"] = time.perf_counter() - T0  # since the script started
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def reset_counts(k1, k2) -> None:
    k1.ell_expand.launches = 0
    k2.tile_spmm.launches = 0


def phase_parity(dev, k1, k2) -> None:
    rng = np.random.default_rng(0)

    def i32(x):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)

    checks = 0
    for op in ("or", "min", "minplus"):
        for w in (1, 8, 33, 256):
            for k in (1, 7, 64, 70):
                nb, rows = 5, 1000 + 37  # a ragged frontier height
                need = (rng.random(nb) < 0.6).astype(np.int32)
                need[0], need[-1] = 1, 0
                gt = rng.integers(0, rows, size=(k, nb * 128)).astype(np.int32)
                fw = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
                wt = None
                if op == "minplus":
                    fw = (fw >> np.uint32(12)).view(np.int32)
                    wt = i32(rng.integers(0, 9, size=(k, nb * 128)).astype(np.int32))
                args = (i32(need), i32(gt), i32(fw), wt)
                got = k1.ell_expand(*args, op=op)
                torch.cuda.synchronize()
                require(torch.equal(got, k1.ell_expand_plain(*args, op=op)),
                        f"ell_expand {op} w={w} k={k} != twin")
                checks += 1
    # The parent scan's shape: min over w = 128 words of keys, most with bit
    # 31 set, and the all-ones sentinel row (every pad slot gathers it).
    for k in (1, 64, 70):
        rows = 2001
        keys = rng.integers(0, 2**32, size=(rows, 128), dtype=np.uint32) | np.uint32(1 << 31)
        keys[rng.random(rows) < 0.3] &= np.uint32(0x7FFFFFFF)
        keys[-1] = 0xFFFFFFFF
        gt = rng.integers(0, rows, size=(k, 5 * 128)).astype(np.int32)
        gt[rng.random(gt.shape) < 0.2] = rows - 1
        args = (i32(np.ones(5, np.int32)), i32(gt), i32(keys))
        got = k1.ell_expand(*args, op="min")
        torch.cuda.synchronize()
        require(torch.equal(got, k1.ell_expand_plain(*args, op="min")),
                f"ell_expand min w=128 k={k} high-bit keys != twin")
        require(np.array_equal(got.cpu().numpy().view(np.uint32), keys[gt].min(axis=0)),
                f"ell_expand min w=128 k={k} != unsigned numpy min")
        checks += 1
    checks += parity_parent_scan(dev)
    for w in (1, 8, 33, 64, 256):
        # Row tile 0 takes every column tile and row tile 2 takes 33 (both
        # split over blocks, K2's atomicOr path); row tile 3 takes exactly 32
        # (one block); row tiles 1 and 4 are empty.
        vt = 40
        row_start, col_tile = [0], []
        for j in range(vt):
            n = {0: vt, 1: 0, 2: 33, 3: 32, 4: 0}.get(j, 3)
            col_tile += sorted(int(c) for c in rng.choice(vt, size=n, replace=False))
            row_start.append(len(col_tile))
        a = rng.integers(0, 2**32, size=(len(col_tile), 4, 128), dtype=np.uint32)
        a &= rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
        a &= rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
        fw = rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32)
        fw &= rng.integers(0, 2**32, size=fw.shape, dtype=np.uint32)
        args = [i32(np.array(row_start, np.int32)), i32(np.array(col_tile, np.int32)),
                i32(a), i32(fw)]
        want = k2.tile_spmm_plain(*args, num_row_tiles=vt)
        prior = i32(rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32)
                    & rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32))
        masks = k2.row_masks(args[2])
        got = k2.tile_spmm(*args, num_row_tiles=vt)
        acc = k2.tile_spmm(args[0], args[1], None, args[3], num_row_tiles=vt, masks=masks,
                           out=prior.clone())
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"tile_spmm w={w} != twin")
        require(not got[128:256].any() and not got[512:640].any(), "empty row tile not zero")
        require(torch.equal(acc, prior | want), f"tile_spmm out= w={w} != prior | twin")
        require(torch.equal(acc[128:256], prior[128:256]), "empty row tile touched")
        checks += 2
    # The twins' own time at one small shape (labelled: the twin, not the kernel).
    need = i32(np.ones(5, np.int32))
    gt = i32(rng.integers(0, 1000, size=(64, 640)).astype(np.int32))
    fw = i32(rng.integers(0, 2**32, size=(1000, 256), dtype=np.uint32))
    twin_k1 = cuda_ms(lambda: k1.ell_expand_plain(need, gt, fw), 3)
    twin_k2 = cuda_ms(lambda: k2.tile_spmm_plain(*args, num_row_tiles=vt), 3)
    emit({"phase": "parity", "checks": checks, "exact": True,
          "twin_ms_small": {"ell_expand_plain[k=64,n=640,w=256]": twin_k1,
                            "tile_spmm_plain[NT=219,vt=40,w=256]": twin_k2}})


def parity_parent_scan(dev) -> int:
    """A ParentScanner over RMAT scale 12 (ef 16, seed 11; kcap 16, so the
    heavy fold pyramid runs) on 100 SciPy-BFS lanes: the CUDA scan, the same
    scanner on CPU tensors and validate.min_parent_from_dist, all equal."""
    from tpu_bfs_torch.algorithms.parent_scan import ParentScanner
    from tpu_bfs_torch.graph.ell import build_ell
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.reference import bfs_scipy
    from tpu_bfs_torch.validate import min_parent_from_dist

    g = rmat_graph(12, 16, seed=11)
    ell = build_ell(g, kcap=16)
    act = ell.num_active
    rows = ell.old_of_new[:act]
    sources = np.random.default_rng(2).choice(g.num_vertices, size=100, replace=False)
    cols = np.full((act, 128), 255, np.uint8)
    want = np.full((act, 128), -1, np.int32)
    for j, s in enumerate(sources):
        d = bfs_scipy(g, int(s))
        cols[:, j] = np.minimum(d, 255)[rows]
        want[:, j] = min_parent_from_dist(g, int(s), d)[rows]
    got = ParentScanner(ell, device=dev).scan(torch.from_numpy(cols).to(dev))
    torch.cuda.synchronize()
    twin = ParentScanner(ell, device="cpu").scan(torch.from_numpy(cols))
    require(torch.equal(got.cpu(), twin), "parent scan on the card != on CPU tensors")
    require(np.array_equal(twin.numpy(), want), "parent scan != min_parent_from_dist")
    return 1


def hub_component_sources(eng, lanes: int, *, seed: int, with_component: bool = False):
    """The bench protocol's sources: a pilot BFS from the highest-degree vertex
    (also the warm-up), then ``lanes`` draws from ``default_rng(seed)`` among
    the vertices it reached (Graph500 samples in the traversable component)."""
    from tpu_bfs_torch.algorithms.msbfs_packed import UNREACHED

    in_degree = eng.hg.in_degree if hasattr(eng, "hg") else eng.ell.in_degree
    pilot = eng.run(np.array([int(np.argmax(in_degree))]))
    traversable = np.flatnonzero(pilot.distance_u8_lane(0) != UNREACHED)
    sources = np.random.default_rng(seed).choice(
        traversable, size=lanes, replace=len(traversable) < lanes)
    return (sources, traversable) if with_component else sources


def validate_lanes(g, res, sources, picks) -> None:
    from tpu_bfs_torch.reference import bfs_scipy
    from tpu_bfs_torch.validate import check_distances

    csr = g.to_scipy()
    for i in picks:
        check_distances(res.distances_int32(i), bfs_scipy(g, int(sources[i]), csr=csr))


def phase_wide(dev, k1, k2, scale: int) -> None:
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.graph.generate import rmat_graph

    t0 = time.perf_counter()
    g = rmat_graph(scale, 16, seed=1)
    eng = WidePackedMsBfsEngine(g, lanes=4096, device=dev)
    build_s = time.perf_counter() - t0
    sources = hub_component_sources(eng, 4096, seed=3)  # the run doubles as warm-up
    reset_counts(k1, k2)
    res = eng.run(sources, time_it=True)
    launches = k1.ell_expand.launches
    require(launches > 0, "wide engine launched no ell_expand kernel")
    require(k2.tile_spmm.launches == 0, "wide engine launched tile_spmm")
    picks = [0, 2048, 4095]
    validate_lanes(g, res, sources, picks)
    emit({"phase": "wide", "scale": scale, "edge_factor": 16, "lanes": 4096,
          "host_build_s": build_s, "levels": res.num_levels,
          "batch_ms": res.elapsed_s * 1e3, "hmean_gteps": res.teps / 1e9,
          "ell_expand_launches": launches, "validated_lanes": picks})
    return g, eng, res, sources


def flagship_graph(scale: int):
    """RMAT scale/ef16/seed1 (numpy generator), cached as .npz under build/."""
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.graph.io import load_npz, save_npz
    from tpu_bfs_torch.ops._build import BUILD_DIR

    path = BUILD_DIR / f"rmat{scale}_ef16_seed1.npz"
    if path.is_file():
        return load_npz(str(path)), True
    g = rmat_graph(scale, 16, seed=1)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + ".tmp.npz")
    save_npz(str(tmp), g)
    tmp.replace(path)
    return g, False


def phase_flagship(dev, k1, k2, scale: int, lanes: int):
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine

    t0 = time.perf_counter()
    g, cached = flagship_graph(scale)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = HybridMsBfsEngine(g, max_lanes=lanes, device=dev)
    engine_s = time.perf_counter() - t0
    require(eng.lanes == lanes, f"auto sizing chose {eng.lanes} lanes, not {lanes}")
    hg = eng.hg

    t0 = time.perf_counter()
    sources, traversable = hub_component_sources(eng, lanes, seed=7, with_component=True)
    pilot_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(k1, k2)
    res = eng.run(sources, time_it=True)
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    t0 = time.perf_counter()
    picks = sorted({0, lanes // 2, lanes - 1}
                   | {int(x) for x in np.linspace(0, lanes - 1, 4).round()})
    validate_lanes(g, res, sources, picks)
    validate_s = time.perf_counter() - t0

    # A second, identical batch with CUDA events around every launch: each
    # kernel's summed device time over one batch (events cost a little, so
    # the batch time above comes from the un-instrumented run).
    k1.ell_expand.timings, k2.tile_spmm.timings = [], []
    eng.run(sources)
    torch.cuda.synchronize()
    ev_ms = {name: sum(a.elapsed_time(b) for a, b in fn.timings)
             for name, fn in (("ell_expand", k1.ell_expand), ("tile_spmm", k2.tile_spmm))}
    ev_n = {"ell_expand": len(k1.ell_expand.timings), "tile_spmm": len(k2.tile_spmm.timings)}
    k1.ell_expand.timings = k2.tile_spmm.timings = None

    w = eng.w
    k1_bytes = sum(
        k1.ell_expand_hbm_bytes(k, n, w)
        for k, n in ([(hg.kcap, hg.res_num_virtual)] if hg.res_heavy else [])
        + [(b.k, b.n) for b in hg.res_light]
    )
    k1_per_level = (1 if hg.res_heavy else 0) + len(hg.res_light)
    k2_bytes = k2.tile_spmm_hbm_bytes(hg.num_tiles, hg.vt, w)
    bodies = launches["tile_spmm"]
    emit({
        "phase": "flagship", "graph": f"RMAT scale {scale}, ef 16, seed 1 (numpy)",
        "scale_cut": None if scale == 21 else f"scale {scale} instead of 21 (--scale)",
        "V": g.num_vertices, "edge_slots": g.num_edges, "active": hg.num_active,
        "dense_tiles": hg.num_tiles, "dense_edges": hg.num_dense_edges,
        "residual_buckets": k1_per_level, "lanes": lanes, "planes": eng.num_planes,
        "graph_s": graph_s, "graph_cached": cached, "engine_build_s": engine_s,
        "pilot_s": pilot_s, "traversable": int(len(traversable)),
        "levels": res.num_levels, "level_bodies": bodies,
        "batch_ms": res.elapsed_s * 1e3, "hmean_gteps": res.teps / 1e9,
        "peak_mem_gb": peak_gb, "launches": launches,
        "validated_lanes": picks, "validate_s": validate_s,
        "event_ms_per_batch": ev_ms, "event_launches": ev_n,
        "ms_per_launch": {k: ev_ms[k] / max(ev_n[k], 1) for k in ev_ms},
        # The kernels' streamed-bytes models (ell_expand_hbm_bytes; K2: each
        # dense tile's bit tile and frontier slab, plus the output) over 3.35 TB/s.
        "model_ms_per_launch": {
            "ell_expand": k1_bytes / k1_per_level / HBM_BYTES_PER_S * 1e3,
            "tile_spmm": k2_bytes / HBM_BYTES_PER_S * 1e3,
        },
    })
    return g, eng, res, sources, picks, launches, traversable


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel template instance (integer and
    bool arguments), else the mangled name."""
    m = re.search(r"([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"


def ptxas_report(log) -> dict:
    """Each compiled kernel's registers, static shared memory and spill
    bytes, from nvcc's ``-Xptxas -v`` output, keyed by source file."""
    report = {}
    for chunk in log:
        head = re.match(r"\[nvcc (\S+)\]", chunk)
        if not head:
            continue
        entries, cur = [], None
        for line in chunk.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                cur = {"entry": kernel_name(m.group(1))}
                entries.append(cur)
            elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                                     r"spill loads", line)):
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
                cur["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
        report[head.group(1)] = entries
    return report


def flagship_operands(eng, res):
    """The flagship's kernel operands: its visited table as the frontier and
    the residual hit table K2 accumulates into (``make_hit``'s first half)."""
    from tpu_bfs_torch.algorithms._packed_common import make_expand
    from tpu_bfs_torch.algorithms.msbfs_hybrid import expand_spec

    arrs, hg = eng.arrs, eng.hg
    fw = res._vis
    prior = make_expand(expand_spec(hg), eng.w)(arrs, fw).index_select(0, arrs["inv_perm_ext"])
    return fw, prior


def phase_kernels(eng, res, launches, k1, k2, ptxas):
    """Each kernel at the flagship's shapes, on a frontier-sized table from
    the run (its visited table): against the twin, then timed. K1's unit is
    one level's residual pass (every bucket); K2's is its one launch, ORing
    into the residual hits as the engine does. The bound reads each input
    once (only the frontier rows the indices name; for K2 only the touched
    output rows, read and written) and writes each output once, over
    3.35 TB/s. The model is the streamed-bytes formula of each wrapper
    module (every gathered row, every tile's slab) over the same rate."""
    arrs, hg, w = eng.arrs, eng.hg, eng.w
    row_bytes = w * 4
    names = (["virtual"] if hg.res_heavy else []) + [f"light{i}" for i in range(len(hg.res_light))]
    saved = (k1.ell_expand.launches, k2.tile_spmm.launches)
    fw, prior = flagship_operands(eng, res)

    def k1_level(fn):
        return [fn(arrs[f"{n}_need"], arrs[f"{n}_gt"], fw) for n in names]

    buf = prior.clone()

    def k2_pass():
        return k2.tile_spmm(arrs["row_start"], arrs["col_tile"], None, fw,
                            num_row_tiles=hg.vt, masks=arrs["a_masks"], out=buf)

    def k2_plain():
        return k2.tile_spmm_plain(arrs["row_start"], arrs["col_tile"], None, fw,
                                  num_row_tiles=hg.vt, masks=arrs["a_masks"])

    k1_rows = int(torch.unique(torch.cat([arrs[f"{n}_gt"].reshape(-1) for n in names])).numel())
    k1_bytes = k1_rows * row_bytes + sum(  # + each bucket's gate, indices and output
        arrs[f"{n}_need"].nbytes + arrs[f"{n}_gt"].nbytes + arrs[f"{n}_gt"].shape[1] * row_bytes
        for n in names)
    k1_model = sum(k1.ell_expand_hbm_bytes(arrs[f"{n}_gt"].shape[0], arrs[f"{n}_gt"].shape[1], w)
                   for n in names)
    k2_slabs = int(torch.unique(arrs["col_tile"]).numel())
    touched = int((arrs["row_start"][1:] > arrs["row_start"][:-1]).sum())
    k2_bytes = (arrs["row_start"].nbytes + arrs["col_tile"].nbytes + arrs["a_masks"].nbytes
                + k2_slabs * 128 * row_bytes + 2 * touched * 128 * row_bytes)
    k2_model = k2.tile_spmm_hbm_bytes(hg.num_tiles, hg.vt, w)

    got1, want1 = k1_level(k1.ell_expand), k1_level(k1.ell_expand_plain)
    k2_pass()
    want2 = prior | k2_plain()
    torch.cuda.synchronize()
    err1 = max(max_abs_err(a, b) for a, b in zip(got1, want1))
    err2 = max_abs_err(buf, want2)
    require(all(torch.equal(a, b) for a, b in zip(got1, want1)),
            "ell_expand != twin at flagship shapes")
    require(torch.equal(buf, want2), "tile_spmm out= != prior | twin at flagship shapes")
    del got1, want1, want2
    rows = [
        ("ell_expand", "tpu_bfs_torch/csrc/ell_expand.cu", "tpu_bfs/ops/ell_expand.py:225",
         err1, cuda_ms(lambda: k1_level(k1.ell_expand), 5),
         cuda_ms(lambda: k1_level(k1.ell_expand_plain), 2), k1_bytes, k1_model,
         "one level: every bucket"),
        ("tile_spmm", "tpu_bfs_torch/csrc/tile_spmm.cu", "tpu_bfs/ops/tile_spmm.py:184",
         err2, cuda_ms(k2_pass, 5), cuda_ms(k2_plain, 1), k2_bytes, k2_model,
         "one launch, out= form"),
    ]
    k1.ell_expand.launches, k2.tile_spmm.launches = saved  # comparisons do not count
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain,
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None, "model_ms": model / HBM_BYTES_PER_S * 1e3, "unit": unit,
         "ptxas": ptxas.get(Path(src).name, [])}
        for name, src, rep, err, ms, plain, nbytes, model, unit in rows
    ]
    return kernels


def _check_trees(g, res, sources, lanes, trees) -> None:
    """Each lane's tree equals validate.min_parent_from_dist and passes
    validate.certify_bfs. The lanes are checked in CHECK_THREADS threads
    (numpy's O(E) passes release the GIL), each lane in full."""
    from tpu_bfs_torch.validate import certify_bfs, min_parent_from_dist

    def check(i, d):
        s = int(sources[i])
        require(np.array_equal(trees[i], min_parent_from_dist(g, s, d)),
                f"lane {i}: scanned tree != min_parent_from_dist")
        certify_bfs(g, s, d, trees[i])

    dists = [res.distances_int32(i) for i in lanes]  # device reads stay on this thread
    g.coo  # built once, before the threads share it
    with ThreadPoolExecutor(CHECK_THREADS) as pool:
        list(pool.map(check, lanes, dists))  # re-raises a lane's failure


def k1_check(k1, arrs, names, fw, op: str, wsuf: str | None, name: str) -> float:
    """K1 against its twin, bit for bit, over one pass of every bucket
    ``names`` of ``arrs`` (with weight slabs ``{bucket}_{wsuf}_gt`` for
    minplus). Returns the max abs error; its launches do not count."""
    saved = k1.ell_expand.launches
    got, want = ([fn(arrs[f"{n}_need"], arrs[f"{n}_gt"], fw,
                     None if wsuf is None else arrs[f"{n}_{wsuf}_gt"], op=op) for n in names]
                 for fn in (k1.ell_expand, k1.ell_expand_plain))
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(all(torch.equal(a, b) for a, b in zip(got, want)), f"{name}: ell_expand != twin")
    k1.ell_expand.launches = saved
    return err


def k1_entry(k1, arrs, names, fw, op: str, launches: int, ptxas, *, name: str,
             unit: str, plain_reps: int = 1, wsuf: str | None = None) -> dict:
    """A kernels-line entry of K1 over one pass of every bucket ``names`` of
    ``arrs`` with frontier (or key, or distance) table ``fw``: the kernel
    against its twin, bit for bit, then both timed. The bound reads the
    rows the indices name, each bucket's gate and index slab (and weight
    slab ``{bucket}_{wsuf}_gt`` for minplus), and writes each output,
    once, over 3.35 TB/s; the model is ell_expand_hbm_bytes."""
    w = fw.shape[1]

    def wt(n):
        return None if wsuf is None else arrs[f"{n}_{wsuf}_gt"]

    def k1_pass(fn):
        return [fn(arrs[f"{n}_need"], arrs[f"{n}_gt"], fw, wt(n), op=op) for n in names]

    saved = k1.ell_expand.launches
    err = k1_check(k1, arrs, names, fw, op, wsuf, name)
    named = int(torch.unique(torch.cat([arrs[f"{n}_gt"].reshape(-1) for n in names])).numel())
    nbytes = named * w * 4 + sum(
        arrs[f"{n}_need"].nbytes + arrs[f"{n}_gt"].nbytes + arrs[f"{n}_gt"].shape[1] * w * 4
        + (0 if wsuf is None else wt(n).nbytes) for n in names)
    model = sum(k1.ell_expand_hbm_bytes(*arrs[f"{n}_gt"].shape, w, weighted=wsuf is not None)
                for n in names)
    entry = {
        "name": name, "route": "cuda", "source": "tpu_bfs_torch/csrc/ell_expand.cu",
        "replaces": "tpu_bfs/ops/ell_expand.py:225", "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: k1_pass(k1.ell_expand), 5),
        "plain_ms": cuda_ms(lambda: k1_pass(k1.ell_expand_plain), plain_reps),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "model_ms": model / HBM_BYTES_PER_S * 1e3, "unit": unit,
        "ptxas": ptxas.get("ell_expand.cu", []),
    }
    k1.ell_expand.launches = saved  # comparisons do not count
    return entry


def bucket_names(ell) -> list:
    return (["virtual"] if ell.num_heavy else []) + [f"light{i}" for i in range(len(ell.light))]


def phase_parents(k1, k2, g, eng, res, sources, picks, ptxas) -> dict:
    """The flagship batch's BFS trees through the device parent scan, pass
    by pass (the body of PackedBatchResult._parents_into_scan, with the
    host half decoding into one reused [128, V] buffer instead of a
    [S, V] array: every lane in the first DECODE_PASSES passes, only the
    validated lanes after), then the public parents_into on a 256-lane
    batch. Returns the K1 min entry of the kernels line."""
    from tpu_bfs_torch.algorithms._packed_common import _decode_pass, acquire_parent_scanner

    require(res._iso is None, "flagship sources are traversable: none isolated")
    t0 = time.perf_counter()
    scanner = acquire_parent_scanner(eng, "device")  # builds and moves a full ELL
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ell = scanner.ell
    lpp, n = scanner.lanes_per_pass, len(sources)
    perm = res._scan_row_map(scanner)
    id_of_row = ell.old_of_new[: ell.num_active]
    buf = np.empty((lpp, g.num_vertices), np.int32)
    trees = {}
    pass_ms, k1_ms, d2h_ms, decode_ms = [], [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_counts(k1, k2)
    k1.ell_expand.timings = []
    t_scan = time.perf_counter()
    for lane0 in range(0, n, lpp):
        m = min(lpp, n - lane0)
        ev0 = len(k1.ell_expand.timings)
        start.record()
        pc = res._scan_pass(scanner, lane0 // 32, -(-m // 32), perm)
        end.record()
        torch.cuda.synchronize()
        pass_ms.append(start.elapsed_time(end))
        k1_ms.append(sum(a.elapsed_time(b) for a, b in k1.ell_expand.timings[ev0:]))
        t0 = time.perf_counter()
        host = pc.cpu().numpy()
        d2h_ms.append((time.perf_counter() - t0) * 1e3)
        mine = [i for i in picks if lane0 <= i < lane0 + m]
        if len(decode_ms) < DECODE_PASSES:  # every lane: the export's host cost
            t0 = time.perf_counter()
            _decode_pass(buf[:m], host, id_of_row)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            trees.update({i: buf[i - lane0].copy() for i in mine})
        else:  # only the lanes to validate
            _decode_pass(buf[: len(mine)], host[:, [i - lane0 for i in mine]], id_of_row)
            trees.update({i: buf[j].copy() for j, i in enumerate(mine)})
        del pc, host
    scan_s = time.perf_counter() - t_scan
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    k1.ell_expand.timings = None
    buckets = len(bucket_names(ell))
    require(launches["ell_expand"] == len(pass_ms) * buckets,
            f"parent scan launched {launches['ell_expand']} K1, not {len(pass_ms)} x {buckets}")
    require(launches["tile_spmm"] == 0, "the parent scan launched tile_spmm")
    t0 = time.perf_counter()
    _check_trees(g, res, sources, picks, trees)
    validate_s = time.perf_counter() - t0
    # K1 op=min at the scan's shape: one pass over a pass's real key table.
    entry = k1_entry(k1, scanner.arrs, bucket_names(ell), scanner.keys(res._scan_cols(
        scanner, 0, lpp // 32, perm)), "min", launches["ell_expand"], ptxas,
        name="ell_expand_min",
        unit=f"one parent-scan pass: every bucket of the full ELL, w {lpp}")
    del scanner, buf, trees

    # The public export on a 256-lane batch of the same engine; it builds
    # its own scanner (the hybrid's is not cached) and a 2.1 GB [S, V] array.
    res2 = eng.run(sources[:256])
    out = np.empty((256, g.num_vertices), np.int32)
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    res2.parents_into(out, device="device")
    export_s = time.perf_counter() - t0
    export_launches = k1.ell_expand.launches
    require(export_launches == 2 * buckets, f"parents_into launched {export_launches} K1")
    checked = [0, 128, 255]
    _check_trees(g, res2, sources, checked, out)
    emit({
        "phase": "parents", "lanes": n, "passes": len(pass_ms), "lanes_per_pass": lpp,
        "full_ell": {"kcap": ell.kcap, "buckets": buckets, "slots": ell.total_slots,
                     "active": ell.num_active},
        "row_map": "identity" if perm is None else "permuted",
        "scanner_build_s": build_s, "scan_s": scan_s, "launches": launches,
        "device_ms_per_pass": sum(pass_ms) / len(pass_ms), "device_ms": sum(pass_ms),
        "k1_min_ms_per_pass": sum(k1_ms) / len(k1_ms), "k1_min_ms": sum(k1_ms),
        "d2h_ms_per_pass": sum(d2h_ms) / len(d2h_ms), "d2h_ms": sum(d2h_ms),
        "d2h_bytes_per_pass": ell.num_active * lpp * 4,
        "host_decode_ms_per_pass": sum(decode_ms) / len(decode_ms),
        "host_decode_passes_timed": len(decode_ms),
        "validated_lanes": sorted(picks), "validate_s": validate_s,
        "parents_into_256": {"seconds": export_s, "ell_expand_launches": export_launches,
                             "checked_lanes": checked, "host_bytes": out.nbytes},
    })
    return entry


def phase_single(dev, k1, k2, g, traversable):
    """The reference's run, one source at a time, on the flagship graph:
    each single-source backend from 4 sources, warm then timed, every
    distance array against SciPy and every tree checked. Returns the
    sources, their SciPy distances, their checked trees and the
    DeviceGraph."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine
    from tpu_bfs_torch.graph.csr import DeviceGraph
    from tpu_bfs_torch.reference import bfs_scipy
    from tpu_bfs_torch.validate import check_distances, check_parents

    hub = int(np.argmax(g.degrees))
    draws = np.random.default_rng(7).choice(traversable, size=3, replace=False)
    sources = [hub] + [int(x) for x in draws]
    t0 = time.perf_counter()
    csr = g.to_scipy()
    golden = {s: bfs_scipy(g, s, csr=csr) for s in sources}
    golden_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = DeviceGraph.from_graph(g)
    dg_s = time.perf_counter() - t0
    trees, backends = {}, {}
    reset_counts(k1, k2)
    for backend in ("scan", "segment", "scatter", "delta", "dopt", "tiled"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        eng = (TiledBfsEngine(g, device=dev) if backend == "tiled"
               else BfsEngine(dg, backend=backend, device=dev))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        runs = []
        for s in sources:
            eng.run(s, with_parents=False, time_it=True)  # warm (the first also warms inside)
            r = eng.run(s, time_it=True)
            check_distances(r.distance, golden[s])
            if s not in trees:
                check_parents(g, s, r.distance, r.parent)
                trees[s] = r.parent
            require(np.array_equal(r.parent, trees[s]), f"{backend}: tree of {s} differs")
            runs.append({"source": s, "ms": r.elapsed_s * 1e3, "levels": r.num_levels,
                         "gteps": r.teps / 1e9, "host_syncs": eng.last_host_syncs,
                         "reached": r.reached, "edges_traversed": r.edges_traversed})
        ms = [x["ms"] for x in runs]
        backends[backend] = {
            "engine": type(eng).__name__, "build_s": build_s, "runs": runs,
            "mean_ms": sum(ms) / len(ms),
            "hmean_gteps": len(runs) / sum(1 / x["gteps"] for x in runs),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "peak_above_resident_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9,
        }
        if backend == "tiled":
            backends[backend].update(tiles=eng.num_tiles, dense_edges=eng.num_dense_edges)
        del eng
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(launches == {"ell_expand": 0, "tile_spmm": 0},
            f"the single-source engines are plain PyTorch, yet launched {launches}")
    emit({"phase": "single", "graph": "the flagship graph", "V": g.num_vertices,
          "edge_slots": g.num_edges, "vp": dg.vp, "ep": dg.ep, "sources": sources,
          "golden_s": golden_s, "device_graph_s": dg_s, "validated": "every run",
          "launches": launches, "backends": backends})
    return sources, golden, trees, dg


def phase_mesh_single(dev, k1, k2, g, dg, sources, golden, trees, small_scale: int):
    """The single-source mesh engines on a one-rank NCCL group (see the
    module docstring, phase 15), then on gloo ranks sharing the card. Each
    engine's timed runs alternate with BfsEngine's of its backend on the
    single phase's DeviceGraph ``dg``."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine, partition_shard
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine, partition_shard_2d
    from tpu_bfs_torch.parallel.mesh import close_mesh, make_mesh, make_mesh_2d
    from tpu_bfs_torch.validate import check_distances

    t_phase = time.perf_counter()
    mesh = make_mesh(device=dev)
    require(mesh.num_shards == 1 and mesh.backend == "nccl", f"mesh {mesh}")
    m2 = make_mesh_2d(1, 1, mesh=mesh)
    # One host partition a mesh shape, shared by its engines.
    t0 = time.perf_counter()
    shard = partition_shard(g, mesh)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard2 = partition_shard_2d(g, m2)
    partition_2d_s = time.perf_counter() - t0

    def one(kw):
        return DistBfsEngine(g, mesh, shard=shard, **kw)

    def two(kw):
        return Dist2DBfsEngine(g, m2, shard=shard2, **kw)

    engines = (("DistBfsEngine", dict(exchange="ring"), one),
               ("DistBfsEngine", dict(exchange="allreduce"), one),
               ("DistBfsEngine", dict(exchange="sparse"), one),
               ("DistBfsEngine", dict(exchange="ring", backend="dopt"), one),
               ("Dist2DBfsEngine", dict(exchange="ring"), two),
               ("Dist2DBfsEngine", dict(exchange="sparse"), two))
    gc.collect()
    torch.cuda.empty_cache()
    refs = {b: BfsEngine(dg, backend=b, device=dev) for b in ("scan", "dopt")}
    reset_counts(k1, k2)
    out = []
    for name, kw, make in engines:
        # Each engine's own peak: its build and its checked runs, from the
        # memory held just before it is built (BfsEngine's runs excluded).
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        eng = make(kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        runs = []
        ref = refs[kw.get("backend", "scan")]
        for s in sources:
            torch.cuda.reset_peak_memory_stats(dev)
            eng.run(s, with_parents=False, time_it=True)  # warm (the first also warms inside)
            r = eng.run(s, time_it=True)
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
            check_distances(r.distance, golden[s])
            require(np.array_equal(r.parent, trees[s]), f"{name} {kw}: tree of {s} differs")
            bodies = int(eng.last_exchange_level_counts.sum())
            # The spread: REPEATS more timed runs, in turns with BfsEngine's.
            mine, theirs = [], []
            for _ in range(REPEATS):
                theirs.append(ref.run(s, with_parents=False, time_it=True).elapsed_s * 1e3)
                mine.append(eng.run(s, with_parents=False, time_it=True).elapsed_s * 1e3)
            runs.append({"source": s, "ms": r.elapsed_s * 1e3,
                         "median_ms": float(np.median(mine)), "repeats_ms": mine,
                         "bfs_engine_median_ms": float(np.median(theirs)),
                         "bfs_engine_repeats_ms": theirs,
                         "levels": r.num_levels, "level_bodies": bodies,
                         "gteps": r.edges_traversed / float(np.median(mine)) / 1e6,
                         "host_reads": eng.last_host_syncs,
                         "host_reads_per_level": eng.last_host_syncs / bodies,
                         "exchange_counts": eng.last_exchange_level_counts.tolist()})
        # The exchange a level by CUDA events: the row exchange and (2D) the
        # column all-gather, around the engine's own calls, in one more BFS.
        evs = []

        def timed(fn):
            def call(*a):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                res = fn(*a)
                e1.record()
                evs.append((e0, e1))
                return res
            return call

        wrapped = ["_exchange_step"] + (["_gather_col"] if hasattr(eng, "_gather_col") else [])
        for attr in wrapped:
            setattr(eng, attr, timed(getattr(eng, attr)))
        eng.run(sources[0], with_parents=False)
        torch.cuda.synchronize()
        bodies = int(eng.last_exchange_level_counts.sum())
        exchange_ms = sum(a.elapsed_time(b) for a, b in evs) / bodies
        ms = [x["median_ms"] for x in runs]
        out.append({"engine": name, **kw, "mesh": "1x1" if "2D" in name else "1",
                    "engine_build_s": build_s, "runs": runs, "mean_median_ms": sum(ms) / len(ms),
                    "bfs_engine": kw.get("backend", "scan"),
                    "bfs_engine_mean_median_ms":
                        sum(x["bfs_engine_median_ms"] for x in runs) / len(runs),
                    "hmean_gteps": len(runs) / sum(1 / x["gteps"] for x in runs),
                    "exchange_ms_per_level": exchange_ms, "exchange_calls": len(evs),
                    "labels": eng.exchange_branch_labels(),
                    "wire_bytes_per_level": eng.wire_bytes_per_level(),
                    "modeled_bytes_last_run": eng.last_exchange_bytes,
                    "peak_above_start_gb": (peak - base) / 1e9})
        del eng, r
        gc.collect()
        torch.cuda.empty_cache()
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(launches == {"ell_expand": 0, "tile_spmm": 0},
            f"the single-source mesh engines are plain PyTorch, yet launched {launches}")
    del shard, shard2, refs
    close_mesh()
    emit({"phase": "mesh_single", "ranks": 1, "backend": "nccl", "graph": "the flagship graph",
          "sources": sources, "validated": "every run: distances = SciPy, tree = the single "
          "phase's checked tree", "launches": launches, "partition_1d_s": partition_s,
          "partition_2d_s": partition_2d_s, "engines": out,
          "seconds": time.perf_counter() - t_phase})
    phase_shared_card_single(dev, small_scale)


def shared_card_single_rank(mesh, scale: int, shape, sources):
    """Rank entry of the shared-card single-source check: DistBfsEngine
    (ring and sparse) for an int ``shape``, Dist2DBfsEngine (ring and
    sparse) for an (R, C) one, on RMAT ``scale``; each source's distances
    and parents, and the backend and device."""
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    g = rmat_graph(scale, 16, seed=1)
    m2 = make_mesh_2d(*shape, mesh=mesh) if isinstance(shape, tuple) else None
    out = {}
    for exchange in ("ring", "sparse"):
        eng = (Dist2DBfsEngine(g, m2, exchange=exchange) if m2
               else DistBfsEngine(g, mesh, exchange=exchange))
        for s in sources:
            r = eng.run(s)
            out[(exchange, s)] = (r.distance, r.parent)
    return out, mesh.backend, str(mesh.device)


def phase_shared_card_single(dev, scale: int) -> None:
    """Gloo ranks sharing the card (NCCL takes one rank a device): the 1D
    engine on 2 ranks and the 2D engine on a 2x2 mesh, every source's
    distances and tree equal to BfsEngine's on the card."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.parallel.mesh import launch

    g = rmat_graph(scale, 16, seed=1)
    hub = int(np.argmax(g.degrees))
    draws = np.random.default_rng(7).choice(np.flatnonzero(g.degrees > 0), size=2, replace=False)
    sources = [hub] + [int(x) for x in draws]
    ref = BfsEngine(g, device=dev)
    want = {s: ref.run(s) for s in sources}
    runs = []
    for ranks, shape in ((2, 2), (4, (2, 2))):
        t0 = time.perf_counter()
        got, backend, where = launch(ranks, shared_card_single_rank, scale, shape, sources,
                                     device=f"cuda:{dev.index or 0}", backend="gloo")
        for (exchange, s), (dist, parent) in got.items():
            require(np.array_equal(dist, want[s].distance)
                    and np.array_equal(parent, want[s].parent),
                    f"shared card {shape} {exchange}: source {s} != BfsEngine")
        runs.append({"mesh": "x".join(map(str, shape)) if isinstance(shape, tuple) else shape,
                     "ranks": ranks, "backend": backend, "device": where,
                     "exchanges": ["ring", "sparse"], "seconds": time.perf_counter() - t0})
    emit({"phase": "mesh_single", "shared_card": True, "scale": scale, "sources": sources,
          "equal_to": "BfsEngine on the card: distances and trees", "runs": runs})


def phase_packed(dev, k1, k2, g, sources, golden, trees, traversable, ptxas) -> list:
    """The 512-lane packed engine on the flagship graph at w 8 and w 1,
    sharing one ELL. Returns the two K1 entries of the kernels line and
    the ELL."""
    from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine
    from tpu_bfs_torch.graph.ell import build_ell
    from tpu_bfs_torch.validate import check_distances

    t0 = time.perf_counter()
    ell = build_ell(g)
    ell_s = time.perf_counter() - t0
    names = bucket_names(ell)
    rest = np.random.default_rng(7).choice(traversable, size=256, replace=False)
    batch = np.concatenate([np.asarray(sources[:3]), rest])[:256]
    out, entries = {}, []
    for lanes in (256, 32):
        t0 = time.perf_counter()
        eng = PackedMsBfsEngine(ell, lanes=lanes, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        src = batch[:lanes]
        eng.run(src, time_it=True)  # warm
        reset_counts(k1, k2)
        res = eng.run(src, time_it=True)
        launches = k1.ell_expand.launches
        require(launches == len(names) * (res.num_levels + 1),
                f"packed w {eng.w}: {launches} K1 launches, not {len(names)} per level")
        require(k2.tile_spmm.launches == 0, "the packed engine launched tile_spmm")
        for i in range(3):
            check_distances(res.distances_int32(i), golden[int(src[i])])
        t0 = time.perf_counter()
        tree = res.parents_int32(0)  # the device scan (K1 min) over the engine's tables
        tree_s = time.perf_counter() - t0
        require(np.array_equal(tree, trees[int(src[0])]),
                f"packed w {eng.w}: lane 0's tree != the single phase's checked tree")
        out[f"w{eng.w}"] = {"lanes": lanes, "build_s": build_s, "levels": res.num_levels,
                            "batch_ms": res.elapsed_s * 1e3, "hmean_gteps": res.teps / 1e9,
                            "k1_launches": launches, "tree_s": tree_s,
                            "validated_lanes": [0, 1, 2]}
        entries.append(k1_entry(
            k1, eng.arrs, names, res._vis, "or", launches, ptxas, plain_reps=2,
            name=f"K1 or, packed w {eng.w}",
            unit=f"one level of the packed engine: every bucket of the full ELL, w {eng.w}"))
        del eng, res
    emit({"phase": "packed", "graph": "the flagship graph", "kcap": ell.kcap,
          "buckets": len(names), "slots": ell.total_slots, "active": ell.num_active,
          "build_ell_s": ell_s, "engines": out})
    return entries, ell


def phase_graph500(dev, k1, k2, scale: int, small_scale: int) -> None:
    from tpu_bfs_torch.algorithms import _packed_common
    from tpu_bfs_torch.graph500 import run_graph500

    def host_tree(*args):
        raise AssertionError("graph500: a validated tree came from the host scatter-min")

    # The validated trees must come from the device scan (K1 min), not the host.
    host_lane, _packed_common.min_parents_lane = _packed_common.min_parents_lane, host_tree
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    try:
        r = run_graph500(scale, 16, mode="hybrid", num_searches=64, validate_searches=4,
                         device=dev)
    finally:
        _packed_common.min_parents_lane = host_lane
    total_s = time.perf_counter() - t0
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    require(r.validated, "graph500 validated no search")
    emit({"phase": "graph500", "scale": scale, "edge_factor": 16,
          "scale_cut": None if scale == 21 else f"scale {scale} instead of 21 (--graph500-scale)",
          "mode": r.mode, "searches": r.num_searches, "validated_searches": 4,
          "validated": r.validated, "hmean_gteps": r.harmonic_mean_teps / 1e9,
          "launches": launches, "graph_s": r.graph_s, "engine_build_s": r.engine_s,
          "total_s": total_s})
    cut = f"scale {small_scale}, not the flagship's 21: the single phase runs this path at 21"
    for mode, n, checked in (("single", 16, 4), ("batched", 64, 4)):
        reset_counts(k1, k2)
        t0 = time.perf_counter()
        r = run_graph500(small_scale, 16, mode=mode, num_searches=n, validate_searches=checked,
                         device=dev)
        total_s = time.perf_counter() - t0
        launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
        require(r.validated, f"graph500 {mode} validated no search")
        emit({"phase": "graph500", "scale": small_scale, "edge_factor": 16, "scale_cut": cut,
              "mode": mode, "backend": "scan" if mode == "single" else None,
              "searches": r.num_searches, "validated_searches": checked,
              "validated": r.validated, "hmean_gteps": r.harmonic_mean_teps / 1e9,
              "launches": launches, "graph_s": r.graph_s, "engine_build_s": r.engine_s,
              "total_s": total_s})


def level_k1_ms(k1, k2, run):
    """K1's summed CUDA-event time per level of one hybrid batch: K2 runs
    once a level, after the level's K1 launches, so the K2 launches so far
    tag each K1 launch with its level. Returns (ms per level, K1 launches)."""
    k2_t = []

    class Tagged(list):
        def append(self, ev):
            super().append((ev, len(k2_t)))

    k1_t = Tagged()
    k1.ell_expand.timings, k2.tile_spmm.timings = k1_t, k2_t
    try:
        run()
        torch.cuda.synchronize()
    finally:
        k1.ell_expand.timings = k2.tile_spmm.timings = None
    per = {}
    for (a, b), lvl in k1_t:
        per[lvl] = per.get(lvl, 0.0) + a.elapsed_time(b)
    return [per.get(i, 0.0) for i in range(max(per) + 1 if per else 0)], len(k1_t)


@contextlib.contextmanager
def captured_k1(pc):
    """Record every K1 call of the packed loop (the gate mask, index table,
    frontier and op), for the kernels line to replay on the same inputs."""
    calls = []
    real = pc.ell_expand

    def record(need_blk, gt, fw, wt=None, *, op="or"):
        calls.append((need_blk.clone(), gt, fw, op))
        return real(need_blk, gt, fw, wt, op=op)

    pc.ell_expand = record
    try:
        yield calls
    finally:
        pc.ell_expand = real


def k1_gated_entry(k1, calls, launches: int, ptxas) -> dict:
    """The kernels-line entry of K1 under the pull gate: every launch of one
    gated flagship batch replayed on its own mask, index table and frontier,
    against the twin bit for bit, then both timed over the whole batch. The
    bound reads, per level (the launches that share one frontier), the
    frontier rows that the active tiles' indices name, once, and per launch
    the active tiles' index slabs and the mask, and writes every output
    once (gated-out tiles write the identity), over 3.35 TB/s: the
    convention of the other K1 entries, summed over the batch. The model is
    ell_expand_hbm_bytes(..., active_tiles=)."""
    saved = k1.ell_expand.launches
    err = 0
    for m, gt, fw, op in calls:
        a, b = k1.ell_expand(m, gt, fw, op=op), k1.ell_expand_plain(m, gt, fw, op=op)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(a, b))
        require(torch.equal(a, b), "gated ell_expand != twin on the batch's masks")
    del a, b
    nbytes = model = active = tiles = 0
    levels = {}
    for m, gt, fw, op in calls:
        levels.setdefault(fw.data_ptr(), []).append((m, gt, fw))
    for level in levels.values():
        w = level[0][2].shape[1]
        named = []
        for m, gt, fw in level:
            k, ncols = gt.shape
            nb = ncols // 128
            on = m != 0
            at = int(on.sum())
            named.append(gt.view(k, nb, 128)[:, on].reshape(-1))
            nbytes += at * k * 128 * 4 + m.nbytes + ncols * w * 4
            model += k1.ell_expand_hbm_bytes(k, ncols, w, active_tiles=at)
            active, tiles = active + at, tiles + nb
        nbytes += int(torch.unique(torch.cat(named)).numel()) * w * 4

    def batch(fn):
        for m, gt, fw, op in calls:
            fn(m, gt, fw, op=op)

    entry = {
        "name": "K1 or, gated (pull gate), flagship residual", "route": "cuda",
        "source": "tpu_bfs_torch/csrc/ell_expand.cu",
        "replaces": "tpu_bfs/ops/ell_expand.py:225", "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: batch(k1.ell_expand), 3),
        "plain_ms": cuda_ms(lambda: batch(k1.ell_expand_plain), 1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "model_ms": model / HBM_BYTES_PER_S * 1e3,
        "unit": f"one gated flagship batch: {len(calls)} launches, {active} of {tiles} tiles "
                "active",
        "ptxas": ptxas.get("ell_expand.cu", []),
    }
    k1.ell_expand.launches = saved  # comparisons do not count
    return entry


def compare_state(gated, plain, act: int, lane_mask) -> int:
    """Require the gated batch's raw state to equal the ungated batch's on
    the device: the visited tables whole, the counter planes on real rows of
    active lanes. Returns the plane words that differ elsewhere (the ripples
    the gate skipped on inactive lanes and pad rows)."""
    require(torch.equal(gated._vis, plain._vis), "gated visited table != ungated")
    m = lane_mask[None, :]
    off = 0
    for p, q in zip(gated._planes, plain._planes):
        d = p ^ q
        require(not (d[:act] & m).any().item(), "gated plane bits != ungated on active lanes")
        off += int((d != 0).sum())
    return off


def phase_pullgate(dev, k1, k2, g, eng, sources, picks, wide, ptxas) -> dict:
    """The pull gate on the flagship: HybridMsBfsEngine(pull_gate=True) on
    the flagship's HybridGraph, a gated and an ungated batch on the same
    sources (state compared on the device, lanes against SciPy), K1's time
    per level in each, the gate's skipped blocks and host reads per level;
    then the wide engine gated and ungated (the wide phase's batch). Returns
    the gated K1 entry of the kernels line."""
    from tpu_bfs_torch.algorithms import _packed_common as pc
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine

    t0 = time.perf_counter()
    geng = HybridMsBfsEngine(eng.hg, lanes=eng.lanes, num_planes=eng.num_planes,
                             pull_gate=True, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    geng.run(sources)  # warm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_counts(k1, k2)
    rg = geng.run(sources, time_it=True)
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(all(n > 0 for n in launches.values()), f"the gated batch skipped a kernel: {launches}")
    gated_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    levels_run = len(geng.last_gate_active_blocks)
    counts = geng.last_gate_level_counts.cpu().numpy()[:levels_run].tolist()
    syncs = geng.last_host_syncs
    require(syncs == levels_run == rg.num_levels + 1,
            f"gated loop: {syncs} host reads over {levels_run} levels")
    active_blocks = list(geng.last_gate_active_blocks)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_counts(k1, k2)
    ru = eng.run(sources, time_it=True)
    plain_launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    plain_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    hg = eng.hg
    off_words = compare_state(rg, ru, hg.num_active, geng._lane_mask_dev)
    require(rg.num_levels == ru.num_levels and np.array_equal(rg.reached, ru.reached),
            "gated levels or reached counts != ungated")
    t0 = time.perf_counter()
    validate_lanes(g, rg, sources, picks)
    validate_s = time.perf_counter() - t0
    out = {
        "gated_batch_ms": rg.elapsed_s * 1e3, "gated_hmean_gteps": rg.teps / 1e9,
        "ungated_batch_ms": ru.elapsed_s * 1e3, "ungated_hmean_gteps": ru.teps / 1e9,
        "levels": rg.num_levels, "levels_run": levels_run, "host_syncs": syncs,
        "syncs_per_level": syncs / levels_run, "gated_tiles": counts,
        "state_blocks_active": active_blocks, "state_blocks": geng._table_rows // 128,
        "residual_blocks": sum(-(-b.n // 128) for b in hg.res_light)
        + (-(-hg.res_num_virtual // 128) if hg.res_heavy else 0),
        # Each batch's peak above what was allocated when it started (the
        # ungated batch starts with the gated result held for the comparison).
        "gated_peak_above_start_gb": gated_peak, "ungated_peak_above_start_gb": plain_peak,
        "launches": launches, "ungated_launches": plain_launches,
        "plane_words_differing_off_active_lanes": off_words,
        "validated_lanes": picks, "validate_s": validate_s, "engine_build_s": build_s,
    }
    del rg, ru
    gc.collect()
    torch.cuda.empty_cache()
    # K1 per level, CUDA events around each launch, in a further batch of
    # each; the gated one's launches are kept for the kernels line.
    with captured_k1(pc) as calls:
        out["k1_gated_ms_per_level"], n_gated = level_k1_ms(k1, k2, lambda: geng.run(sources))
    out["k1_ungated_ms_per_level"], n_plain = level_k1_ms(k1, k2, lambda: eng.run(sources))
    out["k1_gated_ms"] = sum(out["k1_gated_ms_per_level"])
    out["k1_ungated_ms"] = sum(out["k1_ungated_ms_per_level"])
    require(n_gated == len(calls) == launches["ell_expand"], "K1 launches differ between batches")
    entry = k1_gated_entry(k1, calls, launches["ell_expand"], ptxas)
    del calls, geng
    gc.collect()
    torch.cuda.empty_cache()

    # The wide engine at the wide phase's scale, gated against ungated.
    wg, weng, wres, wsrc = wide
    gw = WidePackedMsBfsEngine(weng.ell, lanes=weng.lanes, num_planes=weng.num_planes,
                               pull_gate=True, device=dev)
    gw.run(wsrc)  # warm
    reset_counts(k1, k2)
    rgw = gw.run(wsrc, time_it=True)
    wl = k1.ell_expand.launches
    require(wl > 0 and k2.tile_spmm.launches == 0, "gated wide engine: K1 did not launch")
    wn = len(gw.last_gate_active_blocks)
    require(gw.last_host_syncs == wn == rgw.num_levels + 1, "gated wide loop: a level read twice")
    off_w = compare_state(rgw, wres, weng.ell.num_active, gw._lane_mask_dev)
    validate_lanes(wg, rgw, wsrc, [0, 2048, 4095])
    out["wide"] = {
        "scale": int(np.log2(wg.num_vertices)), "lanes": gw.lanes,
        "gated_batch_ms": rgw.elapsed_s * 1e3, "ungated_batch_ms": wres.elapsed_s * 1e3,
        "gated_hmean_gteps": rgw.teps / 1e9, "ungated_hmean_gteps": wres.teps / 1e9,
        "levels": rgw.num_levels, "host_syncs": gw.last_host_syncs,
        "gated_tiles": gw.last_gate_level_counts.cpu().numpy()[:wn].tolist(),
        "state_blocks_active": list(gw.last_gate_active_blocks),
        "state_blocks": gw._table_rows // 128, "ell_expand_launches": wl,
        "plane_words_differing_off_active_lanes": off_w, "validated_lanes": [0, 2048, 4095],
    }
    emit({"phase": "pullgate", "graph": "the flagship graph", "lanes": eng.lanes, **out})
    return entry


def phase_pullgate_tiled(dev, k1, k2, g, sources, golden, trees) -> None:
    """TiledBfsEngine(pull_gate=True) from the single phase's sources:
    distances equal SciPy's, trees the single phase's checked ones."""
    from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine

    t0 = time.perf_counter()
    eng = TiledBfsEngine(g, pull_gate=True, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset_counts(k1, k2)
    runs = []
    for s in sources:
        eng.run(s, with_parents=False, time_it=True)  # warm
        r = eng.run(s, time_it=True)
        np.testing.assert_array_equal(r.distance, golden[s])
        require(np.array_equal(r.parent, trees[s]), f"gated tiled: tree of {s} differs")
        runs.append({"source": s, "ms": r.elapsed_s * 1e3, "levels": r.num_levels,
                     "gteps": r.teps / 1e9, "host_syncs": eng.last_host_syncs,
                     "skipped_tiles": eng.last_gate_skipped_tiles})
    require(k1.ell_expand.launches == k2.tile_spmm.launches == 0,
            "the tiled engine is plain PyTorch, yet launched a kernel")
    emit({"phase": "pullgate", "engine": "TiledBfsEngine(pull_gate=True)",
          "graph": "the flagship graph", "tiles": eng.num_tiles, "build_s": build_s,
          "validated": "every run", "runs": runs,
          "mean_ms": sum(x["ms"] for x in runs) / len(runs)})


def phase_ckpt(dev, k1, k2, hg, ell, dg, sources, single_source, every: int) -> None:
    """Checkpoint and resume on the flagship graph: a 256-lane hybrid batch
    started, advanced ``every`` levels, saved, loaded and resumed on the
    wide engine to its end, its finish equal to an uninterrupted hybrid run
    on every lane; ungated, then gated. One save a mode: the saves are host
    zlib, the phase's cost. Then a single-source BfsEngine (scan): start,
    advance to level 2, save, load, advance, finish, equal to run."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.ops._build import BUILD_DIR
    from tpu_bfs_torch.utils import checkpoint as ck

    d = BUILD_DIR / "ckpt"
    d.mkdir(parents=True, exist_ok=True)
    path = str(d / "state.npz")
    src = np.asarray(sources[:256])
    out = {}
    for gate in (False, True):
        heng = HybridMsBfsEngine(hg, lanes=256, num_planes=5, pull_gate=gate, device=dev)
        weng = WidePackedMsBfsEngine(ell, lanes=256, num_planes=5, pull_gate=gate, device=dev)
        full = heng.run(src)
        reset_counts(k1, k2)
        t_all = time.perf_counter()
        st = heng.advance(heng.start(src), every)  # the first chunk, on the hybrid
        require(not st.done, "the batch ended in its first chunk: nothing resumed")
        t0 = time.perf_counter()
        ck.save_packed_checkpoint(path, st)
        save_s = [time.perf_counter() - t0]
        sizes = [Path(path).stat().st_size]
        t0 = time.perf_counter()
        st = ck.load_packed_checkpoint(path)
        load_s = [time.perf_counter() - t0]
        levels = [st.level]
        st = weng.advance(st)  # the rest, resumed on the wide engine
        levels.append(st.level)
        res = weng.finish(st)
        total_s = time.perf_counter() - t_all
        launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
        require(launches["ell_expand"] > 0 and launches["tile_spmm"] > 0,
                f"the chunked batch skipped a kernel: {launches}")
        require(res.num_levels == full.num_levels, "resumed levels != uninterrupted")
        require(np.array_equal(res.reached, full.reached) and np.array_equal(res.ecc, full.ecc),
                "resumed reached/ecc != uninterrupted")
        for i in range(len(src)):
            require(np.array_equal(res.distance_u8_lane(i), full.distance_u8_lane(i)),
                    f"resumed lane {i} distances != uninterrupted")
        out["gated" if gate else "ungated"] = {
            "chunk_levels": levels, "save_s": save_s, "load_s": load_s, "file_bytes": sizes,
            "table_bytes": int(st.frontier.nbytes) * (2 + len(st.planes)),
            "chunked_total_s": total_s, "launches": launches, "levels": res.num_levels,
            "lanes_equal": len(src)}
        del heng, weng, full, res, st
        gc.collect()
        torch.cuda.empty_cache()
    beng = BfsEngine(dg, backend="scan", device=dev)
    st = beng.advance(beng.start(single_source), 2)
    ck.save_checkpoint(path, st)
    st = beng.advance(ck.load_checkpoint(path))
    r, want = beng.finish(st), beng.run(single_source)
    require(np.array_equal(r.distance, want.distance) and np.array_equal(r.parent, want.parent),
            "single-source resume != run")
    Path(path).unlink()
    emit({"phase": "ckpt", "graph": "the flagship graph", "lanes": 256, "every": every,
          "packed": out, "single": {"backend": "scan", "source": int(single_source),
                                    "resumed_at": 2, "levels": r.num_levels,
                                    "equal_to_run": True}})


def _dijkstra_oracle(g, sources):
    """SciPy dijkstra over the weighted graph, duplicate slots min-folded
    (parallel edges hash to one weight, but keep the oracle honest)."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    m = g.to_scipy(weighted=True).tocoo()
    key = m.row.astype(np.int64) * g.num_vertices + m.col
    order = np.lexsort((m.data, key))
    k2, d2 = key[order], m.data[order]
    first = np.ones(len(k2), bool)
    first[1:] = k2[1:] != k2[:-1]
    mm = sp.csr_matrix(
        (d2[first], (k2[first] // g.num_vertices, k2[first] % g.num_vertices)),
        shape=(g.num_vertices, g.num_vertices),
    )
    return csgraph.dijkstra(mm, directed=True, indices=sources)


def phase_khop(dev, k1, k2, g, eng, sources) -> np.ndarray:
    """k-hop counts (k = 3) over the flagship HybridMsBfsEngine on its 8192
    sources: the validated lanes' reached counts equal SciPy's vertices
    within 3 hops (a search bounded at 3). Returns every lane's count."""
    from scipy.sparse import csgraph

    from tpu_bfs_torch.workloads.khop import KhopServeEngine

    kh = KhopServeEngine(eng)
    kh.run(sources, k=3)  # warm
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    res = kh.run(sources, k=3)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(all(n > 0 for n in launches.values()), f"khop skipped a kernel: {launches}")
    # 3 levels, then the claim-free probe the loop runs at its bound.
    require(res.num_levels == 3 and launches["tile_spmm"] == 4,
            f"khop: {res.num_levels} levels, {launches['tile_spmm']} K2 launches")
    picks = [0, len(sources) // 2, len(sources) - 1]
    t0 = time.perf_counter()
    d = csgraph.dijkstra(g.to_scipy(), unweighted=True, indices=sources[picks], limit=3.0)
    want = np.isfinite(d).sum(axis=1)
    require(np.array_equal(res.reached[picks], want),
            f"khop reached {res.reached[picks].tolist()} != SciPy {want.tolist()}")
    require(all(res.extras(i) == {"k": 3} for i in picks), "khop extras")
    emit({"phase": "workloads", "kind": "khop", "graph": "the flagship graph",
          "engine": "HybridMsBfsEngine", "lanes": eng.lanes, "k": 3, "batch_ms": batch_ms,
          "launches": launches, "validated_lanes": picks, "reached": want.tolist(),
          "validate_s": time.perf_counter() - t0})
    return np.asarray(res.reached)


def word_distances(eng, res, wi: int, num_vertices: int) -> torch.Tensor:
    """[V, 32] uint8 distances of word ``wi``'s lanes in vertex-id order, on
    the device (UNREACHED for vertices without a table row)."""
    d = eng._extract_word(res._planes, res._vis, res._src_bits, wi)
    rank = torch.from_numpy(np.asarray(eng._rank, dtype=np.int64)).to(d.device)
    has_row = rank < eng._act
    out = torch.full((num_vertices, 32), 255, dtype=torch.uint8, device=d.device)
    out[has_row] = d.index_select(0, rank[has_row])
    return out


def same_lanes(eng_a, res_a, eng_b, res_b, name: str) -> int:
    """Every lane's distances, reached count and eccentricity equal in the
    two results (compared on the device, word by word). Returns the lanes."""
    n = len(res_a.sources)
    require(np.array_equal(res_a.reached, res_b.reached), f"{name}: reached counts differ")
    require(np.array_equal(res_a.ecc, res_b.ecc), f"{name}: eccentricities differ")
    require(res_a.num_levels == res_b.num_levels, f"{name}: levels differ")
    v = eng_a.num_vertices
    for wi in range(-(-n // 32)):
        require(torch.equal(word_distances(eng_a, res_a, wi, v),
                            word_distances(eng_b, res_b, wi, v)),
                f"{name}: distances of word {wi} differ")
    return n


def k2_entry(k2, arrs, fw, prior, num_row_tiles: int, launches: int, ptxas, *, name: str,
             unit: str) -> dict:
    """A kernels-line entry of K2 over ``arrs``' dense tiles against frontier
    ``fw``, ORing into ``prior`` as the engines do: the kernel against its
    twin, bit for bit, then both timed. The bound reads the named column
    slabs, the tiles and the touched output rows and writes those rows,
    once, over 3.35 TB/s; the model is tile_spmm_hbm_bytes."""
    row_bytes = fw.shape[1] * 4
    saved = k2.tile_spmm.launches
    buf = prior.clone()

    def k2_pass():
        return k2.tile_spmm(arrs["row_start"], arrs["col_tile"], None, fw,
                            num_row_tiles=num_row_tiles, masks=arrs["a_masks"], out=buf)

    def k2_plain():
        return k2.tile_spmm_plain(arrs["row_start"], arrs["col_tile"], None, fw,
                                  num_row_tiles=num_row_tiles, masks=arrs["a_masks"])

    k2_pass()
    want = prior | k2_plain()
    torch.cuda.synchronize()
    err = max_abs_err(buf, want)
    require(torch.equal(buf, want), f"{name}: tile_spmm out= != prior | twin")
    del want
    nt = int(arrs["row_start"][-1])
    slabs = int(torch.unique(arrs["col_tile"][:nt]).numel())
    touched = int((arrs["row_start"][1:] > arrs["row_start"][:-1]).sum())
    nbytes = (arrs["row_start"].nbytes + arrs["col_tile"].nbytes + arrs["a_masks"].nbytes
              + slabs * 128 * row_bytes + 2 * touched * 128 * row_bytes)
    entry = {
        "name": name, "route": "cuda", "source": "tpu_bfs_torch/csrc/tile_spmm.cu",
        "replaces": "tpu_bfs/ops/tile_spmm.py:184", "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(k2_pass, 5), "plain_ms": cuda_ms(k2_plain, 1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "model_ms": k2.tile_spmm_hbm_bytes(nt, num_row_tiles, fw.shape[1])
        / HBM_BYTES_PER_S * 1e3,
        "unit": unit, "ptxas": ptxas.get("tile_spmm.cu", []),
    }
    k2.tile_spmm.launches = saved  # comparisons do not count
    return entry


def phase_mesh(dev, k1, k2, g, eng, sources, picks, wide, wide_scale: int, ptxas) -> list:
    """The mesh engines on a one-rank NCCL group (see the module docstring,
    phase 14). Returns the two mesh kernels entries."""
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.mesh import close_mesh, make_mesh

    mesh = make_mesh(device=dev)
    require(mesh.num_shards == 1 and mesh.backend == "nccl", f"mesh {mesh}")
    single = eng.run(sources, time_it=True)  # the single-device batch of this call

    t0 = time.perf_counter()
    meng = DistHybridMsBfsEngine(g, mesh, lanes=eng.lanes, num_planes=eng.num_planes)
    build_s = time.perf_counter() - t0
    meng.run(sources)  # warm
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)  # the single engine and its batch stay live
    reset_counts(k1, k2)
    res = meng.run(sources, time_it=True)
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(all(n > 0 for n in launches.values()), f"mesh: a kernel never launched: {launches}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    peak_above_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    syncs = meng.last_host_syncs
    bodies = int(meng.last_exchange_level_counts.sum())  # one exchange a level body

    # At one rank tau rows are rank0 rows: the tables equal the single batch's.
    require(torch.equal(res._vis, single._vis), "mesh visited table != single-device")
    require(all(torch.equal(a, b) for a, b in zip(res._planes, single._planes)),
            "mesh planes != single-device")
    same_lanes(meng, res, eng, single, "mesh flagship")  # every lane's distances too
    validate_lanes(g, res, sources, picks)

    # The all-gather a level, by CUDA events around the engine's gather.
    gather, evs = meng._gather, []

    def timed_gather(fw, branch):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = gather(fw, branch)
        b.record()
        evs.append((a, b))
        return out

    meng._gather = timed_gather
    meng.run(sources)
    torch.cuda.synchronize()
    meng._gather = gather
    gather_ms = sum(a.elapsed_time(b) for a, b in evs) / len(evs)

    # The kernels on the rank's shard tables, the run's visited table as frontier.
    fw = meng._gather(res._vis, 0)
    arrs, spec = meng.arrs, meng.hd["res_spec"]
    names = (["virtual"] if spec.heavy else []) + [f"light{i}" for i in
                                                   range(len(spec.light_meta))]
    entries = [k1_entry(k1, arrs, names, fw, "or", launches["ell_expand"], ptxas,
                        name="K1 or, mesh shard", unit="one level: every bucket of the "
                        "rank's residual shard (one rank)")]
    prior = meng._expand(arrs, fw).index_select(0, arrs["perm"])
    entries.append(k2_entry(k2, arrs, fw, prior, meng._nrt, launches["tile_spmm"], ptxas,
                            name="K2, mesh shard", unit="one launch on the rank's row "
                            "tiles, out= form (one rank)"))
    del fw, prior
    emit({"phase": "mesh", "engine": "DistHybridMsBfsEngine", "exchange": "dense",
          "ranks": 1, "backend": mesh.backend, "graph": "the flagship graph",
          "lanes": meng.lanes, "planes": meng.num_planes, "engine_build_s": build_s,
          "levels": res.num_levels, "level_bodies": bodies,
          "batch_ms": res.elapsed_s * 1e3, "hmean_gteps": res.teps / 1e9,
          "single_batch_ms": single.elapsed_s * 1e3, "single_hmean_gteps": single.teps / 1e9,
          "all_gather_ms_per_level": gather_ms, "gathers": len(evs),
          "host_reads": syncs, "host_reads_per_level": syncs / bodies,
          "peak_mem_gb": peak_gb, "peak_above_start_gb": peak_above_gb,
          "launches": launches, "validated_lanes": picks,
          "equal_to_single_device": "visited, planes, every lane's distances, reached, ecc"})
    del res, single, meng
    gc.collect()
    torch.cuda.empty_cache()

    # The wide phase's scale, 4096 lanes: the other exchanges against
    # single-device engines.
    g18, weng, wres, wsources = wide
    hyb = HybridMsBfsEngine(g18, lanes=4096, num_planes=5, device=dev)
    hres = hyb.run(wsources)
    runs = []
    for cls, base, bres, kw in (
            (DistHybridMsBfsEngine, hyb, hres, dict(exchange="sparse")),
            (DistHybridMsBfsEngine, hyb, hres, dict(exchange="sliced")),
            (DistWideMsBfsEngine, weng, wres, dict(exchange="dense")),
            (DistWideMsBfsEngine, weng, wres, dict(exchange="sparse"))):
        t0 = time.perf_counter()
        e = cls(g18, mesh, lanes=4096, num_planes=base.num_planes, **kw)
        build_s = time.perf_counter() - t0
        e.run(wsources)  # warm
        reset_counts(k1, k2)
        r = e.run(wsources, time_it=True)
        n = same_lanes(e, r, base, bres, f"{cls.__name__} {kw['exchange']}")
        runs.append({"engine": cls.__name__, **kw, "lanes_equal": n,
                     "levels": r.num_levels, "batch_ms": r.elapsed_s * 1e3,
                     "single_device": type(base).__name__, "engine_build_s": build_s,
                     "exchange_counts": np.asarray(e.last_exchange_level_counts).tolist(),
                     "launches": {"ell_expand": k1.ell_expand.launches,
                                  "tile_spmm": k2.tile_spmm.launches}})
        del e, r
    close_mesh()
    emit({"phase": "mesh", "scale": wide_scale, "edge_factor": 16, "lanes": 4096, "ranks": 1,
          "runs": runs})
    del hyb, hres
    gc.collect()
    torch.cuda.empty_cache()
    phase_shared_card(dev, wide_scale)
    return entries


def shared_card_rank(mesh, scale: int, lanes: int):
    """Rank entry of the shared-card check: DistHybridMsBfsEngine (dense
    exchange) at RMAT ``scale`` with the bench's hub sources; returns the
    reached counts, eccentricities and three lanes' distances."""
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine

    g = rmat_graph(scale, 16, seed=1)
    eng = DistHybridMsBfsEngine(g, mesh, lanes=lanes)
    sources = np.random.default_rng(3).choice(np.flatnonzero(g.degrees > 0), size=lanes)
    res = eng.run(sources)
    picks = [0, lanes // 2, lanes - 1]
    return (sources, res.reached, res.ecc, [res.distances_int32(i) for i in picks],
            picks, mesh.backend, str(mesh.device))


def phase_shared_card(dev, scale: int, ranks: int = 2) -> dict:
    """Several gloo ranks on the one card (NCCL takes one rank a device):
    their DistHybridMsBfsEngine run equals a single-device batch."""
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    sources, reached, ecc, dists, picks, backend, where = launch(
        ranks, shared_card_rank, scale, 4096, device=f"cuda:{dev.index or 0}", backend="gloo")
    mesh_s = time.perf_counter() - t0
    eng = HybridMsBfsEngine(rmat_graph(scale, 16, seed=1), lanes=4096, num_planes=5,
                            device=dev)
    res = eng.run(sources)
    require(np.array_equal(reached, res.reached) and np.array_equal(ecc, res.ecc),
            "shared card: reached or ecc != single-device")
    require(all(np.array_equal(d, res.distances_int32(i)) for d, i in zip(dists, picks)),
            "shared card: distances != single-device")
    out = {"phase": "mesh", "shared_card": True, "ranks": ranks, "backend": backend,
           "device": where, "scale": scale, "lanes": 4096, "seconds": mesh_s,
           "validated_lanes": picks}
    emit(out)
    return out


def phase_sssp(dev, k1, k2, g, traversable, ptxas):
    """SSSP at 256 lanes on the flagship graph with edge_weights(seed=1,
    wmax=8) attached (the JAX bench's kinds graph): a warm batch with CUDA
    events around every K1 launch, then a timed batch; 3 lanes against
    SciPy's dijkstra. Returns the "K1 minplus, sssp w 256" kernels entry,
    K1 on the engine's own light-plane tables and the run's distances, and
    held bit for bit against its twin on the heavy close's plane too; and
    what the mesh_kinds phase reuses: the weighted graph, the sources, the
    engine, its batch, the checked lanes and SciPy's rows of them."""
    from tpu_bfs_torch.graph.generate import edge_weights
    from tpu_bfs_torch.workloads.sssp import INF_W, SsspEngine

    t0 = time.perf_counter()
    gw = dataclasses.replace(g, weights=edge_weights(*g.coo, seed=1, wmax=8))
    weights_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = SsspEngine(gw, lanes=256, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hub = int(np.argmax(g.degrees))
    draws = np.random.default_rng(7).choice(traversable[traversable != hub], size=255,
                                            replace=False)
    src = np.concatenate([[hub], draws])
    names = bucket_names(eng.ell)
    k1.ell_expand.timings = []
    eng.run(src)  # warm, with CUDA events around each K1 launch
    torch.cuda.synchronize()
    ev_ms, ev_n = sum(a.elapsed_time(b) for a, b in k1.ell_expand.timings), \
        len(k1.ell_expand.timings)
    k1.ell_expand.timings = None
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_counts(k1, k2)
    res = eng.run(src, time_it=True)
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    bodies = res.rounds + eng.last_closes
    require(launches["ell_expand"] == len(names) * bodies == ev_n,
            f"sssp: {launches} K1 launches, not {len(names)} x {bodies} expansions")
    require(launches["tile_spmm"] == 0, "sssp launched tile_spmm")
    require(eng.last_host_reads == bodies, f"sssp: {eng.last_host_reads} host reads")
    picks = [0, 128, 255]
    t0 = time.perf_counter()
    oracle = _dijkstra_oracle(gw, src[picks])
    for j, i in enumerate(picks):
        got = res.distances_int32(i).astype(float)
        got[got == np.iinfo(np.int32).max] = np.inf
        require(np.array_equal(got, oracle[j]), f"sssp lane {i} != dijkstra")
        require(int(res.reached[i]) == int(np.isfinite(oracle[j]).sum()), "sssp reached")
    validate_s = time.perf_counter() - t0
    emit({"phase": "workloads", "kind": "sssp", "graph": "the flagship graph, "
          "edge_weights(seed=1, wmax=8)", "lanes": eng.lanes, "delta": eng.delta,
          "weights_s": weights_s, "engine_build_s": build_s,
          "batch_ms": res.elapsed_s * 1e3, "rounds": res.rounds, "heavy_closes": eng.last_closes,
          "host_reads": eng.last_host_reads, "launches": launches,
          "k1_event_ms_per_batch": ev_ms, "k1_event_launches": ev_n,
          "peak_above_start_gb": peak_gb, "max_distance": res.num_levels,
          "validated_lanes": picks, "validate_s": validate_s})
    fw = res._dist
    require(int(fw[-1].min()) == int(INF_W), "the sentinel row is not all INF")
    entry = k1_entry(k1, eng.arrs, names, fw, "minplus", launches["ell_expand"], ptxas,
                     wsuf="wl", name="K1 minplus, sssp w 256",
                     unit="one light sweep: every bucket of the full ELL, w 256, "
                          "the run's distances against its light-plane tables")
    # The heavy close runs K1 over the full-weight plane at the same shapes.
    entry["heavy_close_max_abs_err"] = k1_check(
        k1, eng.arrs, names, fw, "minplus", "w", "K1 minplus, sssp heavy close")
    return entry, {"graph": gw, "sources": src, "engine": eng, "result": res,
                   "picks": picks, "oracle": oracle}


def phase_cc(dev, k1, k2, g, ell, lanes: int):
    """connected_components over a WidePackedMsBfsEngine at 8192 lanes on
    the flagship graph's ELL: labels equal the smallest vertex id of each
    SciPy component, and the component counts are equal. Returns the labels
    and the engine's table rows."""
    from scipy.sparse import csgraph

    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.workloads.cc import connected_components

    t0 = time.perf_counter()
    eng = WidePackedMsBfsEngine(ell, lanes=lanes, num_planes=5, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    labels, n, sweeps = connected_components(eng)
    cc_s = time.perf_counter() - t0
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    require(launches["ell_expand"] > 0 and launches["tile_spmm"] == 0, f"cc: {launches}")
    t0 = time.perf_counter()
    nc, lbl = csgraph.connected_components(g.to_scipy(), directed=False)
    smallest = np.full(nc, g.num_vertices)
    np.minimum.at(smallest, lbl, np.arange(g.num_vertices))
    require(n == nc, f"cc: {n} components, SciPy {nc}")
    require(np.array_equal(labels, smallest[lbl]), "cc labels != smallest id of SciPy's")
    emit({"phase": "workloads", "kind": "cc", "graph": "the flagship graph",
          "engine": "WidePackedMsBfsEngine", "lanes": eng.lanes, "components": n,
          "sweeps": sweeps, "seconds": cc_s, "ms_per_sweep": cc_s * 1e3 / sweeps,
          "engine_build_s": build_s, "launches": launches,
          "validate_s": time.perf_counter() - t0})
    return labels, eng._table_rows


def walk_paths(g, res, s, t, name: str) -> None:
    """Every pair met, and its path runs from s to t edge by edge with the
    distance's length."""
    for i in range(len(s)):
        ex = res.extras(i)
        require(ex["met"] and ex["path"] is not None, f"{name} pair {i} did not meet")
        path = ex["path"]
        require(path[0] == s[i] and path[-1] == t[i] and len(path) == ex["distance"] + 1,
                f"{name} pair {i}: path ends or length wrong")
        require(all(g.has_edge(a, b) for a, b in zip(path, path[1:])),
                f"{name} pair {i}: a path step is not an edge")


def phase_p2p(dev, k1, k2, g, ell, traversable):
    """P2pServeEngine over a 256-lane wide engine on the flagship graph, a
    full batch of 128 pairs drawn among the traversable vertices: every path
    walked edge by edge, its length the distance; 4 pairs' distances equal
    SciPy's, and the levels expanded are below those sources' BFS depth.
    Returns the pairs and every pair's answer."""
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.reference import bfs_scipy
    from tpu_bfs_torch.workloads.p2p import P2pServeEngine

    eng = P2pServeEngine(WidePackedMsBfsEngine(ell, lanes=256, num_planes=5, device=dev))
    s, t = np.random.default_rng(11).choice(traversable, size=(2, 128))
    eng.run(s[:4], targets=t[:4])  # warm, and the parent scanner built
    reset_counts(k1, k2)
    k1.ell_expand.timings = []
    t0 = time.perf_counter()
    res = eng.run(s, targets=t)
    total_s = time.perf_counter() - t0
    k1_ms = sum(a.elapsed_time(b) for a, b in k1.ell_expand.timings)
    k1.ell_expand.timings = None
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    levels = int(res.ecc[0])
    buckets = len(bucket_names(ell))
    walked = [i for i in range(128) if res.extras(i)["distance"]]
    passes = -(-2 * (max(walked) + 1) // 128) if walked else 0
    require(launches["ell_expand"] == buckets * (levels + passes) and launches["tile_spmm"] == 0,
            f"p2p: {launches} K1 launches, not {buckets} x ({levels} levels + {passes} scans)")
    walk_paths(g, res, s, t, "p2p")
    t0 = time.perf_counter()
    csr = g.to_scipy()
    depth = []
    for i in range(4):
        d = bfs_scipy(g, int(s[i]), csr=csr)
        require(res.extras(i)["distance"] == int(d[t[i]]), f"p2p pair {i} != SciPy")
        depth.append(int(d[d != np.iinfo(np.int32).max].max()))
    require(levels < min(depth), f"p2p expanded {levels} levels, BFS depth {depth}")
    emit({"phase": "workloads", "kind": "p2p", "graph": "the flagship graph",
          "engine": "WidePackedMsBfsEngine", "lanes": 256, "pairs": 128, "levels": levels,
          "bfs_depth_of_checked": depth, "host_reads": eng.last_host_reads,
          "batch_s": total_s, "paths_s": eng.last_paths_s, "k1_event_ms": k1_ms,
          "scan_passes": passes,
          "launches": launches,
          "distances": sorted({res.extras(i)["distance"] for i in range(128)}),
          "validated_pairs": [0, 1, 2, 3], "validate_s": time.perf_counter() - t0})
    return s, t, [res.extras(i) for i in range(128)], int(res.ecc[0])


def same_sssp_tables(a, da, b, db, name: str) -> None:
    """Every vertex's row of two SSSP distance tables equal on the device:
    ``a`` a single-device SsspEngine (rows of the vertices in an edge),
    ``b`` a DistSsspEngine (a row a vertex; the others all INF there)."""
    from tpu_bfs_torch.workloads.sssp import INF_W

    ra, rb = np.asarray(a._rank, np.int64), np.asarray(b._rank, np.int64)
    has = ra < a._act
    step = 1 << 18
    for lo in range(0, len(ra), step):
        h = has[lo:lo + step]
        ia = torch.from_numpy(ra[lo:lo + step][h]).to(da.device)
        ib = torch.from_numpy(rb[lo:lo + step][h]).to(db.device)
        require(torch.equal(da.index_select(0, ia), db.index_select(0, ib)),
                f"{name}: distances != SsspEngine's")
        iso = torch.from_numpy(rb[lo:lo + step][~h]).to(db.device)
        require(bool((db.index_select(0, iso) == int(INF_W)).all()),
                f"{name}: a row-less vertex is reached")


def shared_card_kinds_rank(mesh, scale: int):
    """Rank entry of the mesh_kinds phase's shared-card check, RMAT
    ``scale``: DistSsspEngine (sparse, delta ids, prediction) at 64 lanes,
    DistBfsEngine (sparse, with wire_pack, delta ids, sieve and prediction)
    from 3 sources, and k-hop (k = 3) over DistWideMsBfsEngine (sparse, delta
    ids) at 256 lanes; their answers and the backend and device."""
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.workloads.khop import KhopServeEngine

    g, gw, src = shared_kinds_inputs(scale)
    sssp = DistSsspEngine(gw, mesh, lanes=64, exchange="sparse", delta_bits=(8, 16),
                          predict=True).run(src[:64])
    bfs = DistBfsEngine(g, mesh, exchange="sparse", wire_pack=True, delta_bits=(8, 16),
                        sieve=True, predict=True)
    trees = {int(s): (r.distance, r.parent) for s in src[:3] for r in [bfs.run(int(s))]}
    khop = KhopServeEngine(DistWideMsBfsEngine(g, mesh, lanes=256, exchange="sparse",
                                               delta_bits=(8, 16))).run(src, k=3)
    return ([sssp.distances_int32(i) for i in range(64)], int(sssp.rounds), trees,
            np.asarray(khop.reached), mesh.backend, str(mesh.device))


def shared_kinds_inputs(scale: int):
    """The shared-card check's graph, weighted graph and 256 sources."""
    from tpu_bfs_torch.graph.generate import edge_weights, rmat_graph

    g = rmat_graph(scale, 16, seed=1)
    gw = dataclasses.replace(g, weights=edge_weights(*g.coo, seed=1, wmax=8))
    src = np.random.default_rng(7).choice(np.flatnonzero(g.degrees > 0), size=256,
                                          replace=False)
    return g, gw, src


def phase_mesh_kinds(dev, k1, k2, g, sssp, flagship_sources, khop_reached, cc, p2p,
                     ptxas, small_scale: int) -> dict:
    """Every workload kind on a one-rank NCCL group on cuda:0 at the
    flagship's full size (see the module docstring, phase 16), then on gloo
    ranks sharing the card. Returns the "K1 minplus, mesh shard, w 256"
    kernels entry."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.graph.ell import build_ell_sharded, build_ell_weights_sharded
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.parallel.mesh import close_mesh, launch, make_mesh
    from tpu_bfs_torch.workloads.cc import connected_components
    from tpu_bfs_torch.workloads.khop import KhopServeEngine
    from tpu_bfs_torch.workloads.p2p import P2pServeEngine
    from tpu_bfs_torch.workloads.sssp import SsspEngine

    t_phase = time.perf_counter()
    gw, src, ref, ref_res = sssp["graph"], sssp["sources"], sssp["engine"], sssp["result"]
    cc_labels, cc_table_rows = cc
    mesh = make_mesh(device=dev)
    require(mesh.num_shards == 1 and mesh.backend == "nccl", f"mesh {mesh}")
    # One sharded ELL for every engine: the weights do not change it.
    t0 = time.perf_counter()
    shard = build_ell_sharded(g, 1)
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    weights = build_ell_weights_sharded(gw, shard)
    weights_s = time.perf_counter() - t0
    names = (["virtual"] if shard.virtual is not None else []) + [
        f"light{i}" for i in range(len(shard.light))]
    out, entry = [], None
    for kw in (dict(exchange="ring"), dict(exchange="allreduce"),
               dict(exchange="sparse", delta_bits=(8, 16), predict=True)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        eng = DistSsspEngine(gw, mesh, lanes=256, shard=shard, weights=weights, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        eng.run(src)  # warm
        reset_counts(k1, k2)
        res = eng.run(src, time_it=True)
        launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        bodies = res.rounds + eng.last_closes
        require(launches["ell_expand"] == len(names) * bodies > 0 and launches["tile_spmm"] == 0,
                f"mesh sssp {kw}: {launches} K1 launches, not {len(names)} x {bodies}")
        same_sssp_tables(ref, ref_res._dist, eng, res._dist, f"mesh sssp {kw}")
        require(res.rounds == ref_res.rounds, f"mesh sssp {kw}: {res.rounds} rounds")
        for j, i in enumerate(sssp["picks"]):
            got = res.distances_int32(i).astype(float)
            got[got == np.iinfo(np.int32).max] = np.inf
            require(np.array_equal(got, sssp["oracle"][j]), f"mesh sssp {kw} lane {i} != dijkstra")
        mine, theirs = [], []
        for _ in range(MESH_KINDS_TURNS):  # in turns with SsspEngine
            theirs.append(ref.run(src, time_it=True).elapsed_s * 1e3)
            mine.append(eng.run(src, time_it=True).elapsed_s * 1e3)
        # The exchange a round by CUDA events, in one more batch.
        evs, exchange = [], eng._exchange_round

        def timed(*a):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            got = exchange(*a)
            e1.record()
            evs.append((e0, e1))
            return got
        eng._exchange_round = timed
        eng.run(src)
        torch.cuda.synchronize()
        eng._exchange_round = exchange
        out.append({"engine": "DistSsspEngine", **kw, "engine_build_s": build_s,
                    "batch_ms": res.elapsed_s * 1e3, "median_ms": float(np.median(mine)),
                    "repeats_ms": mine, "sssp_engine_median_ms": float(np.median(theirs)),
                    "sssp_engine_repeats_ms": theirs, "rounds": res.rounds,
                    "table_rows": eng._table_rows, "sssp_engine_table_rows": ref._table_rows,
                    "heavy_closes": eng.last_closes, "host_reads": eng.last_host_reads,
                    "host_reads_per_round": eng.last_host_reads / res.rounds,
                    "exchange_ms_per_round": sum(a.elapsed_time(b) for a, b in evs) / len(evs),
                    "exchange_counts": eng.last_exchange_level_counts.tolist(),
                    "labels": eng.exchange_branch_labels(), "launches": launches,
                    "peak_above_start_gb": peak_gb})
        if entry is None:
            entry = k1_entry(k1, eng.arrs, names, res._dist, "minplus", launches["ell_expand"],
                             ptxas, wsuf="wl", name="K1 minplus, mesh shard, w 256",
                             unit="one light sweep: every bucket of the rank's shard, w 256, "
                                  "the run's distances against its light-plane tables")
            entry["heavy_close_max_abs_err"] = k1_check(
                k1, eng.arrs, names, res._dist, "minplus", "w", "K1 minplus, mesh heavy close")
            require(entry["max_abs_err"] == entry["heavy_close_max_abs_err"] == 0,
                    "mesh shard minplus != twin")
        del eng, res
    del ref, ref_res, sssp
    gc.collect()
    torch.cuda.empty_cache()
    kinds = {}
    # CC and k-hop over one 8192-lane wide mesh engine, p2p over a 256-lane one.
    t0 = time.perf_counter()
    wide = DistWideMsBfsEngine(g, mesh, lanes=8192, shard=shard)
    build_s = time.perf_counter() - t0
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    labels, n, sweeps = connected_components(wide)
    kinds["cc"] = {"lanes": 8192, "table_rows": wide._table_rows, "single_device_table_rows":
                   cc_table_rows, "engine_build_s": build_s, "components": n, "sweeps": sweeps,
                   "seconds": time.perf_counter() - t0, "launches": k1.ell_expand.launches}
    require(k1.ell_expand.launches > 0 and k2.tile_spmm.launches == 0, "mesh cc launches")
    require(np.array_equal(labels, cc_labels), "mesh cc labels != the cc phase's (SciPy's)")
    kh = KhopServeEngine(wide)
    kh.run(flagship_sources, k=3)  # warm
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    res = kh.run(flagship_sources, k=3)
    torch.cuda.synchronize()
    kinds["khop"] = {"lanes": 8192, "k": 3, "batch_ms": (time.perf_counter() - t0) * 1e3,
                     "launches": k1.ell_expand.launches}
    require(k1.ell_expand.launches > 0, "mesh khop launched no K1")
    require(np.array_equal(res.reached, khop_reached), "mesh khop reached != the khop phase's")
    del wide, kh, res
    gc.collect()
    torch.cuda.empty_cache()
    s, t, extras, levels = p2p
    pe = P2pServeEngine(DistWideMsBfsEngine(g, mesh, lanes=256, shard=shard))
    pe.run(s[:4], targets=t[:4])  # warm, and the parent scanner built
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    res = pe.run(s, targets=t)
    kinds["p2p"] = {"lanes": 256, "pairs": 128, "batch_s": time.perf_counter() - t0,
                    "levels": int(res.ecc[0]), "host_reads": pe.last_host_reads,
                    "paths_s": pe.last_paths_s, "launches": k1.ell_expand.launches}
    require(k1.ell_expand.launches > 0, "mesh p2p launched no K1")
    require([res.extras(i) for i in range(128)] == extras and int(res.ecc[0]) == levels,
            "mesh p2p answers != the p2p phase's")
    walk_paths(g, res, s, t, "mesh p2p")
    del pe, res, shard, weights
    close_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "mesh_kinds", "ranks": 1, "backend": "nccl",
          "graph": "the flagship graph, edge_weights(seed=1, wmax=8) for sssp",
          "sssp_lanes": 256, "shard_build_s": shard_s, "weights_build_s": weights_s,
          "sssp": out, "kinds": kinds,
          "validated": "sssp: every lane = SsspEngine's, 3 lanes = dijkstra; cc labels, khop "
                       "reached and p2p answers = the single-device phases'; every p2p path "
                       "walked", "seconds": time.perf_counter() - t_phase})
    # Two gloo ranks sharing the card, correctness only.
    t0 = time.perf_counter()
    dists, rounds, trees, reached, backend, where = launch(
        2, shared_card_kinds_rank, small_scale, device=f"cuda:{dev.index or 0}", backend="gloo")
    mesh_s = time.perf_counter() - t0
    g2, gw2, src2 = shared_kinds_inputs(small_scale)
    want = SsspEngine(gw2, lanes=64, device=dev).run(src2[:64])
    require(rounds == want.rounds and all(
        np.array_equal(d, want.distances_int32(i)) for i, d in enumerate(dists)),
        "shared card: DistSsspEngine != SsspEngine")
    bfs = BfsEngine(g2, device=dev)
    for s0, (dist, parent) in trees.items():
        r = bfs.run(s0)
        require(np.array_equal(dist, r.distance) and np.array_equal(parent, r.parent),
                f"shared card: DistBfsEngine planner from {s0} != BfsEngine")
    kw = KhopServeEngine(WidePackedMsBfsEngine(g2, lanes=256, device=dev)).run(src2, k=3)
    require(np.array_equal(reached, kw.reached), "shared card: mesh khop != wide khop")
    emit({"phase": "mesh_kinds", "shared_card": True, "ranks": 2, "backend": backend,
          "device": where, "scale": small_scale, "seconds": mesh_s,
          "equal_to": "SsspEngine (64 lanes), BfsEngine (3 sources, trees), "
                      "WidePackedMsBfsEngine k-hop (256 lanes)",
          "phase_seconds": time.perf_counter() - t_phase})
    return entry


def closed_loop(svc, picks) -> tuple[list, float]:
    """``len(picks)`` client threads, each querying its row of sources one
    after another; (results in pick order, seconds)."""
    import threading

    results, errs = [None] * len(picks), []

    def client(ci):
        try:
            results[ci] = [svc.query(int(s), timeout=600) for s in picks[ci]]
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(picks))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    if errs:
        raise errs[0]
    flat = [r for row in results for r in row]
    bad = [r for r in flat if not r.ok]
    require(not bad, f"{len(bad)} serve queries failed; first: "
                     f"{bad[0].status if bad else ''} {bad[0].error if bad else ''}")
    return flat, seconds


def direct_answers(eng, sources) -> dict:
    """source -> (reached, levels, result, lane) from the engine's own
    batches of ``sources`` (``eng.lanes`` at a time)."""
    out = {}
    for lo in range(0, len(sources), eng.lanes):
        chunk = np.asarray(sources[lo:lo + eng.lanes])
        res = eng.run(chunk)
        for i, s in enumerate(chunk):
            out[int(s)] = (int(res.reached[i]), int(res.ecc[i]), res, i)
    return out


def same_as_direct(results, direct, name: str, sample: int = 0) -> int:
    """Every result's reached and levels equal the direct batch's, and the
    distances of ``sample`` spread results too. Returns how many rows were
    compared in full."""
    for r in results:
        reached, levels, _, _ = direct[r.source]
        require((r.reached, r.levels) == (reached, levels),
                f"{name}: source {r.source} {(r.reached, r.levels)} != direct "
                f"{(reached, levels)}")
    rows = [r for r in results if r.distances is not None]
    picked = rows[:: max(1, len(rows) // sample)][:sample] if sample else []
    for r in picked:
        _, _, res, i = direct[r.source]
        require(np.array_equal(r.distances, res.distances_int32(i)),
                f"{name}: source {r.source}'s distances != the direct batch's")
    return len(picked)


def host_reads(fn) -> int:
    """Device-to-host synchronizations of ``fn()`` (CUDA's sync debug mode
    warns on each)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def extract_split(eng, res) -> dict:
    """One 32-lane word of a batch's distance extraction (what the serve
    worker does for a query's row, ``PackedBatchResult.distance_u8_lane``
    and ``distances_int32``), timed step by step: the device word table,
    its copy to the host, the host scatter into vertex order, and one
    lane's int32 row. Milliseconds (host clock, device synchronised)."""
    from tpu_bfs_torch.algorithms.msbfs_packed import UNREACHED
    from tpu_bfs_torch.graph.csr import INF_DIST

    torch.cuda.synchronize()
    t = [time.perf_counter()]
    word = eng._extract_word(res._planes, res._vis, res._src_bits, 0)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    dr = word.cpu().numpy()
    t.append(time.perf_counter())
    full = np.full((eng.num_vertices, 32), UNREACHED, np.uint8)
    m = eng._rank < eng._act
    full[m] = dr[eng._rank[m]]
    t.append(time.perf_counter())
    d8 = full[:, 0]
    row = np.where(d8 == UNREACHED, INF_DIST, d8.astype(np.int32))
    t.append(time.perf_counter())
    require(np.array_equal(row, res.distances_int32(0)), "extract split: lane 0's row")
    steps = ("word_table_ms", "word_copy_ms", "host_scatter_ms", "int32_row_ms")
    return {k: (b - a) * 1e3 for k, a, b in zip(steps, t, t[1:])} | {
        "word_table_mb": word.numel() / 1e6}


def serve_flagship(dev, k1, k2, g, traversable, reg) -> dict:
    """bench_serve's closed loop on the flagship graph, pipelined then not,
    every answer held to the 256-lane rung engine's direct batches (8 rows
    of distances too, 3 to SciPy's)."""
    from tpu_bfs_torch.reference import bfs_scipy
    from tpu_bfs_torch.serve import BfsService

    picks = np.random.default_rng(7).choice(
        traversable, size=(SERVE_CLIENTS, SERVE_PER_CLIENT), replace=False)
    out, direct = {}, None
    for pipeline in (True, False):
        t0 = time.perf_counter()
        svc = BfsService(g, engine="wide", lanes=256, width_ladder="auto",
                         pipeline=pipeline, linger_ms=2.0, queue_cap=1024,
                         registry=reg, device=dev)
        up_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts(k1, k2)
        flat, seconds = closed_loop(svc, picks)
        launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        snap = svc.statsz()
        svc.close()
        require(launches["ell_expand"] > 0 and launches["tile_spmm"] == 0,
                f"serve loop launches {launches}")
        require(snap["completed"] == len(flat) and snap["errors"] == 0, f"statsz {snap}")
        if direct is None:
            eng = reg.get(svc._spec(256))
            direct = direct_answers(eng, picks.reshape(-1))
            batch = picks.reshape(-1)[:eng.lanes]
            reads = host_reads(lambda: eng.dispatch(batch))
            seed_reads = host_reads(lambda: eng._seed_dev(batch))
            levels = direct[int(batch[0])][2].num_levels
            split = extract_split(eng, direct[int(batch[0])][2])
        compared = same_as_direct(flat, direct, "serve loop", sample=8)
        csr = g.to_scipy()
        for r in [r for r in flat if r.distances is not None][:3]:
            require(np.array_equal(r.distances, bfs_scipy(g, r.source, csr=csr)),
                    f"serve loop: source {r.source} != SciPy")
        key = "pipelined" if pipeline else "unpipelined"
        out[key] = {
            "service_up_s": up_s, "queries": len(flat), "seconds": seconds,
            "qps": len(flat) / seconds, "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
            "fill_ratio": snap["fill_ratio"], "routing": snap["routing"],
            "batches": snap["batches"], "extract_p50_ms": snap["extract_p50_ms"],
            "peak_above_start_gb": peak_gb, "launches": launches,
            "rows_equal_direct": compared, "rows_equal_scipy": 3,
        }
    out["ladder"] = [32, 64, 256]
    out["rung_build_s"] = {str(s.lanes): reg.build_s[s] for s in reg.build_s if s.kind == "bfs"}
    out["rung_warm_s"] = {str(s.lanes): reg.warm_s[s] for s in reg.warm_s if s.kind == "bfs"}
    out["dispatch_host_reads"] = reads
    out["seed_host_reads"] = seed_reads
    out["dispatch_levels"] = levels
    # The level loop's reads: one a level body (levels + 1 bodies).
    out["host_reads_per_level"] = (reads - seed_reads) / (levels + 1)
    out["extract_split_one_word"] = split
    return out, picks, direct


def serve_w2_batch(dev, k1, k2, g, reg, picks, direct, ptxas) -> dict:
    """One 48-query batch through BfsService routed to the 64-lane rung
    (w 2): its K1 launches, answers equal to the direct batches, then the
    "K1 or, serve rung w 2" kernels entry on that rung's own tables."""
    from tpu_bfs_torch.serve import BfsService

    svc = BfsService(g, engine="wide", lanes=256, width_ladder="auto", registry=reg,
                     device=dev, autostart=False)
    srcs = picks.reshape(-1)[:48]
    pend = [svc.submit(int(s)) for s in srcs]
    reset_counts(k1, k2)
    svc.start()
    res = [p.result(600) for p in pend]
    launches = k1.ell_expand.launches
    snap = svc.statsz()
    svc.close()
    require(snap["routing"] == {"64": 1}, f"the 48-query batch routed {snap['routing']}")
    same_as_direct(res, direct, "w 2 batch", sample=2)
    eng = reg.get(svc._spec(64))
    require(eng.w == 2, f"the 64-lane rung has w {eng.w}")
    run = eng.run(np.asarray(srcs))
    names = bucket_names(eng.ell)
    require(launches == len(names) * (run.num_levels + 1),
            f"w 2 batch: {launches} K1 launches, not {len(names)} x {run.num_levels + 1}")
    entry = k1_entry(k1, eng.arrs, names, run._vis, "or", launches, ptxas, plain_reps=2,
                     name="K1 or, serve rung w 2",
                     unit="one level of the serve ladder's 64-lane rung: every bucket "
                          "of the full ELL, w 2, the batch's visited table")
    entry["launches_per"] = "one 48-query batch served at the 64-lane rung"
    return entry, {"batch_queries": 48, "routing": snap["routing"], "k1_launches": launches,
                   "levels": run.num_levels, "buckets": len(names)}


def serve_jsonl(dev) -> dict:
    """``python -m tpu_bfs_torch.serve`` on RMAT 16 as a subprocess: three
    queries (one distance-free), a malformed line and an out-of-range
    source; the lines equal the expected ones (the CPU parity test's
    forms), the distances decode and equal the engine's, and SIGTERM
    drains it with a final statsz line and exit code 0."""
    import threading

    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.cli import load_graph
    from tpu_bfs_torch.serve.frontend import _parse_request_line, decode_distances

    spec = "rmat:scale=16"
    g = load_graph(spec)
    v = g.num_vertices
    eng = WidePackedMsBfsEngine(g, lanes=32, num_planes=8, device=dev)
    want = eng.run(np.asarray([0, 5, 9]))
    bad = "this is not json"
    try:
        _parse_request_line(bad)
    except Exception as exc:  # noqa: BLE001 — the server's own error text
        bad_err = f"bad request: {exc!r}"
    lines = [json.dumps({"id": 0, "source": 0}), json.dumps({"id": 1, "source": 5}),
             json.dumps({"id": 2, "source": 9, "want_distances": False}), bad,
             json.dumps({"id": "far", "source": v + 5})]
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_bfs_torch.serve", spec, "--lanes", "256",
         "--device", str(dev), "--statsz-interval-s", "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=here, env=dict(os.environ, PYTHONPATH=str(here)))
    killer = threading.Timer(300, proc.kill)
    killer.start()
    try:
        proc.stdin.write("\n".join(lines) + "\n")
        proc.stdin.flush()
        got = [json.loads(proc.stdout.readline()) for _ in lines]
        answered_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0, f"serve subprocess exited {proc.returncode}: {err[-2000:]}")
    require("SIGTERM received: draining" in err, "no SIGTERM drain in the server's log")
    final = [ln for ln in err.splitlines() if ln.startswith("statsz ")]
    require(bool(final) and json.loads(final[-1][7:])["completed"] == 3, "final statsz line")
    by_id = {r.get("id"): r for r in got}
    for r in got:
        r.pop("latency_ms", None)
    require(by_id[None] == {"id": None, "status": "error", "error": bad_err},
            f"malformed line answered {by_id[None]}")
    require(by_id["far"] == {"id": "far", "source": v + 5, "status": "error",
                             "error": f"source {v + 5} out of range [0, {v})"},
            f"out-of-range answered {by_id['far']}")
    for i, s in enumerate((0, 5, 9)):
        r = by_id[i]
        require(r["status"] == "ok" and r["source"] == s, f"query {i}: {r}")
        require((r["reached"], r["levels"]) == (int(want.reached[i]), int(want.ecc[i])),
                f"query {i}: reached/levels != the engine's")
        if i < 2:
            require(np.array_equal(decode_distances(r["distances_npy"]),
                                   want.distances_int32(i)), f"query {i}: distances_npy")
        else:
            require("distances_npy" not in r, "a distance-free query carried distances")
    return {"graph": spec, "V": v, "lines": len(lines), "answered_s": answered_s,
            "drain": "SIGTERM, final statsz, exit 0"}


def serve_chaos(dev, g, reg, picks, direct) -> dict:
    """The flagship service under SERVE_SPEC, 16 clients x 4 queries: every
    answer equal to the direct batches, and the recovery counters exactly
    the schedule's firings."""
    from tpu_bfs_torch import faults
    from tpu_bfs_torch.serve import BfsService
    from tpu_bfs_torch.utils.recovery import COUNTERS

    svc = BfsService(g, engine="wide", lanes=256, width_ladder="auto", linger_ms=2.0,
                     registry=reg, device=dev)
    COUNTERS.reset()
    sched = faults.arm_from_spec(SERVE_SPEC)
    try:
        flat, seconds = closed_loop(svc, picks.reshape(-1)[:64].reshape(16, 4))
        snap = svc.statsz()
    finally:
        faults.disarm()
        svc.close()
    same_as_direct(flat, direct, "chaos", sample=4)
    counts = sched.counts()
    c = COUNTERS.as_dict()
    require(counts == {"transient": 2, "slow_extract": 4}, f"fired {counts}")
    require(c["faults_injected"] == 6 and c["transient_retries"] == 2
            and sum(c.values()) == 8, f"recovery counters {c}")
    require(snap["retries"] == 2 and snap["errors"] == 0, f"statsz {snap}")
    return {"spec": SERVE_SPEC, "queries": len(flat), "seconds": seconds,
            "fired": counts, "counters": {k: v for k, v in c.items() if v},
            "batches": snap["batches"], "p99_ms": snap["p99_ms"]}


def serve_kinds(dev, k1, k2, scale: int) -> dict:
    """At RMAT ``scale`` (the wide phase's) with edge_weights(seed=1,
    wmax=8): a five-kind service, 8 queries a kind, each equal to that
    kind's engine run directly; a hybrid service (K2 on the serve path),
    64 queries; and the answer tier (a repeat is a cache hit, a
    landmark-exact p2p pair resolves without a dispatch)."""
    from tpu_bfs_torch.graph.generate import edge_weights, rmat_graph
    from tpu_bfs_torch.reference import bfs_scipy
    from tpu_bfs_torch.serve import BfsService, EngineRegistry

    g = rmat_graph(scale, 16, seed=1)
    gw = dataclasses.replace(g, weights=edge_weights(*g.coo, seed=1, wmax=8))
    rng = np.random.default_rng(7)
    live = np.flatnonzero(g.degrees > 0)
    src = [int(s) for s in rng.choice(live, 40, replace=False)]
    tgt = [int(s) for s in rng.choice(live, 8, replace=False)]
    reg = EngineRegistry(capacity=16, device=dev)
    t0 = time.perf_counter()
    # One 256-lane width for every kind: CC's sweeps seed a lane per
    # unlabelled vertex, and a 32-lane rung would take thousands of them.
    svc = BfsService(gw, kinds=("bfs", "sssp", "cc", "khop", "p2p"), lanes=256,
                     width_ladder="off", registry=reg, device=dev, autostart=False)
    queries = ([("bfs", {"source": s}) for s in src[:8]]
               + [("sssp", {"source": s}) for s in src[8:16]]
               + [("cc", {"source": s}) for s in src[16:24]]
               + [("khop", {"source": s, "k": 2}) for s in src[24:32]]
               + [("p2p", {"source": s, "target": t}) for s, t in zip(src[32:40], tgt)])
    pend = [(kind, svc.submit(kind=kind, **q)) for kind, q in queries]
    reset_counts(k1, k2)
    svc.start()
    res = [(kind, p.result(600)) for kind, p in pend]
    kinds_launches = k1.ell_expand.launches
    snap = svc.statsz()
    svc.close()
    kinds_routing = snap["routing"]
    require(snap["errors"] == 0 and kinds_launches > 0, f"kinds: {snap}")
    for kind in ("bfs", "sssp", "cc", "khop", "p2p"):
        mine = [(q, r) for (kd, q), (_, r) in zip(queries, res) if kd == kind]
        widths = {r.dispatched_lanes for _, r in mine}
        require(len(widths) == 1 and all(r.ok for _, r in mine), f"{kind}: {widths}")
        eng = reg.get(svc._spec(widths.pop(), kind))
        s = np.asarray([q["source"] for q, _ in mine])
        if kind == "p2p":
            d = eng.run(s, targets=np.asarray([q["target"] for q, _ in mine]))
        elif kind == "khop":
            d = eng.run(s, k=2)
        else:
            d = eng.run(s)
        for i, (q, r) in enumerate(mine):
            ex = d.extras(i) if hasattr(d, "extras") else None
            require((r.reached, r.extras) == (int(d.reached[i]), ex),
                    f"{kind} query {i}: {(r.reached, r.extras)} != direct "
                    f"{(int(d.reached[i]), ex)}")
            if r.distances is not None:
                require(np.array_equal(r.distances, d.distances_int32(i)),
                        f"{kind} query {i}: distances != direct")
    kinds_s = time.perf_counter() - t0

    # The hybrid engine behind the service: K2 on the serve path.
    t0 = time.perf_counter()
    hsvc = BfsService(g, engine="hybrid", lanes=4096, width_ladder="off",
                      registry=reg, device=dev, autostart=False)
    hsrc = [int(s) for s in rng.choice(live, 64, replace=False)]
    pend = [hsvc.submit(s) for s in hsrc]
    reset_counts(k1, k2)
    hsvc.start()
    hres = [p.result(600) for p in pend]
    hybrid_launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    hsvc.close()
    require(all(n > 0 for n in hybrid_launches.values()),
            f"hybrid service launches {hybrid_launches}")
    same_as_direct(hres, direct_answers(reg.get(hsvc._spec(4096)), hsrc), "hybrid",
                   sample=4)
    hybrid_s = time.perf_counter() - t0

    # The answer tier.
    t0 = time.perf_counter()
    csvc = BfsService(g, kinds=("bfs", "p2p"), lanes=256, width_ladder="off",
                      cache_bytes=64 << 20, landmarks=8, registry=reg, device=dev)
    first = csvc.query(src[0], timeout=600)
    # The extraction worker fills the cache just after it resolves a batch.
    deadline = time.monotonic() + 60
    while not len(csvc._cache) and time.monotonic() < deadline:
        time.sleep(0.01)
    again = csvc.query(src[0], timeout=600)
    require(first.ok and again.ok and again.extras == {"cache_hit": True}
            and again.batch_lanes == 0 and np.array_equal(again.distances, first.distances),
            f"the repeat was no cache hit: {again.extras}")
    lm = int(csvc._landmarks.landmarks[0])
    before = csvc.statsz()["batches"]
    pair = csvc.query(lm, kind="p2p", target=src[1], timeout=600)
    snap = csvc.statsz()
    csvc.close()
    want = int(bfs_scipy(g, lm)[src[1]])
    require(pair.ok and pair.extras.get("landmark") and pair.extras["distance"] == want
            and pair.batch_lanes == 0 and snap["batches"] == before,
            f"landmark pair: {pair.extras}, batches {before} -> {snap['batches']}")
    return {"scale": scale, "scale_cut": f"scale {scale}, not the flagship's 21: "
                                         "the flagship loop serves the wide kind at 21",
            "kinds_queries": len(queries), "kinds_launches": kinds_launches,
            "kinds_routing": kinds_routing, "kinds_s": kinds_s,
            "hybrid_queries": len(hsrc), "hybrid_launches": hybrid_launches,
            "hybrid_s": hybrid_s, "cache_hits": snap["cache_hits"],
            "landmark_exact": snap["landmark_exact"], "answer_tier_s": time.perf_counter() - t0}


def phase_serve(dev, k1, k2, g, traversable, wide_scale: int, ptxas) -> dict:
    """The serve tier (see the module docstring, phase 17). Returns the
    "K1 or, serve rung w 2" kernels entry."""
    from tpu_bfs_torch.serve import EngineRegistry

    t_phase = time.perf_counter()
    reg = EngineRegistry(capacity=8, device=dev)
    loop, picks, direct = serve_flagship(dev, k1, k2, g, traversable, reg)
    entry, w2 = serve_w2_batch(dev, k1, k2, g, reg, picks, direct, ptxas)
    chaos = serve_chaos(dev, g, reg, picks, direct)
    emit({"phase": "serve", "graph": "the flagship graph", "engine": "wide",
          "lanes": 256, "clients": SERVE_CLIENTS, "queries_per_client": SERVE_PER_CLIENT,
          **loop, "w2_batch": w2, "chaos": chaos,
          "seconds": time.perf_counter() - t_phase})
    del reg, direct
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    jsonl = serve_jsonl(dev)
    jsonl["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kinds = serve_kinds(dev, k1, k2, wide_scale)
    kinds["seconds"] = time.perf_counter() - t0
    emit({"phase": "serve", "jsonl": jsonl, "small": kinds,
          "phase_seconds": time.perf_counter() - t_phase})
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21, help="flagship RMAT scale (21)")
    ap.add_argument("--lanes", type=int, default=8192, help="flagship lanes (8192)")
    ap.add_argument("--wide-scale", type=int, default=18, help="wide-engine RMAT scale (18)")
    ap.add_argument("--graph500-scale", type=int, default=18,
                    help="RMAT scale of the graph500 phase (18; the flagship's is 21)")
    ap.add_argument("--graph500-small-scale", type=int, default=18,
                    help="RMAT scale of the graph500 single and batched runs (18)")
    ap.add_argument("--ckpt-every", type=int, default=4,
                    help="levels before the ckpt phase's checkpoint (4)")
    ap.add_argument("--mesh-kinds-small-scale", type=int, default=16,
                    help="RMAT scale of the mesh_kinds phase's shared-card ranks (16)")
    ap.add_argument("--parity-only", action="store_true",
                    help="stop after the build and the small-shape parity checks")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import tpu_bfs_torch
    from tpu_bfs_torch.ops import _build
    from tpu_bfs_torch.ops import ell_expand as k1
    from tpu_bfs_torch.ops import tile_spmm as k2

    here = Path(__file__).resolve().parent
    require(Path(tpu_bfs_torch.__file__).resolve().parent == here / "tpu_bfs_torch",
            "tpu_bfs_torch must come from this checkout")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = []
    _build.build(force=True, log=log.append)
    _build.load_library()
    ptxas = ptxas_report(log)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": _build.find_nvcc(), "ptxas": ptxas})
    print("\n".join(log), file=sys.stderr, flush=True)

    phase_parity(dev, k1, k2)
    if args.parity_only:
        return 0
    wide = phase_wide(dev, k1, k2, args.wide_scale)
    g, eng, res, sources, picks, launches, traversable = phase_flagship(
        dev, k1, k2, args.scale, args.lanes)
    kernels = phase_kernels(eng, res, launches, k1, k2, ptxas)
    kernels.append(phase_parents(k1, k2, g, eng, res, sources, picks, ptxas))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_pullgate(dev, k1, k2, g, eng, sources, picks[:3], wide, ptxas))
    khop_reached = phase_khop(dev, k1, k2, g, eng, sources)
    kernels += phase_mesh(dev, k1, k2, g, eng, sources, picks[:3], wide, args.wide_scale,
                          ptxas)
    gc.collect()
    torch.cuda.empty_cache()
    hg = eng.hg
    del eng, wide  # free the flagship's device state; its graph stays
    gc.collect()
    torch.cuda.empty_cache()
    single_sources, golden, trees, dg = phase_single(dev, k1, k2, g, traversable)
    phase_mesh_single(dev, k1, k2, g, dg, single_sources, golden, trees, args.wide_scale)
    phase_pullgate_tiled(dev, k1, k2, g, single_sources, golden, trees)
    entries, ell = phase_packed(dev, k1, k2, g, single_sources, golden, trees, traversable, ptxas)
    kernels += entries
    phase_ckpt(dev, k1, k2, hg, ell, dg, sources, single_sources[0], args.ckpt_every)
    del golden, trees, dg, hg
    gc.collect()
    torch.cuda.empty_cache()
    entry, sssp = phase_sssp(dev, k1, k2, g, traversable, ptxas)
    kernels.append(entry)
    gc.collect()
    torch.cuda.empty_cache()
    cc = phase_cc(dev, k1, k2, g, ell, args.lanes)
    gc.collect()
    torch.cuda.empty_cache()
    p2p = phase_p2p(dev, k1, k2, g, ell, traversable)
    del ell
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_mesh_kinds(dev, k1, k2, g, sssp, sources, khop_reached, cc, p2p,
                                    ptxas, args.mesh_kinds_small_scale))
    del sssp, sources
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_serve(dev, k1, k2, g, traversable, args.wide_scale, ptxas))
    del g
    gc.collect()
    torch.cuda.empty_cache()
    phase_graph500(dev, k1, k2, args.graph500_scale, args.graph500_small_scale)

    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
