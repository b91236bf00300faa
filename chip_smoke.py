#!/usr/bin/env python3
"""Drive the PyTorch port (tpu_bfs_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # the full run: RMAT scale 21, 8192 lanes
    python3 chip_smoke.py --scale 16      # a quicker flagship (cut stated in output)

Phases, one JSON line each:
 1. device: the card and its power limit (nvidia-smi);
 2. build: both CUDA kernels compiled from tpu_bfs_torch/csrc with nvcc, and
    the native host library (tpu_bfs_torch/native: the RMAT generator, the
    edge-list loader, the counting sort) with g++; a failed native build
    ends the script: every RMAT graph it generates for itself (STREAM) comes
    from the native generator, the stream of JAX's bench graphs, never the
    NumPy one (the JSONL servers' and the obs CLI's ``rmat:`` specs and
    run_graph500 generate as JAX's CLI and graph500.py do, with NumPy);
 3. parity: each kernel against its plain PyTorch twin, bit-exact, at small
    ragged shapes (K1 ell_expand: or/min/minplus, w 1/8/33/256, k 1/7/64/70,
    gated tiles, and min at w 128 over keys with bit 31 set and an all-ones
    sentinel row; K2 tile_spmm: w 1/8/33/64/256, fresh and accumulating into
    a prior table from the row masks alone, empty and split row tiles); and
    a ParentScanner on RMAT scale 12, on the card, on CPU tensors and as
    validate.min_parent_from_dist, all equal;
 4. wide: WidePackedMsBfsEngine, RMAT scale 16 (--wide-scale; 17 until the
    fleet arm, 18 before the aot phase, cut to pay for them), 4096 lanes,
    3 lanes
    validated against the SciPy oracle, K1 launches counted;
 5. flagship: HybridMsBfsEngine, RMAT scale 21 (ef 16, seed 1, the native
    stream, cached as build/rmat21_ef16_seed1_native.npz), 8192 lanes,
    the bench protocol (hub pilot as warm-up, sources from default_rng(7)
    among traversable vertices, one timed batch, 3 lanes validated: 5 until
    the aot phase), with
    both kernels' launch counts and summed CUDA-event times;
 6. kernels: each kernel at the flagship's shapes against its twin
    (bit-exact), its time, the twin's time, its device-memory bound, its
    streamed-bytes model and nvcc's register and shared-memory report;
 7. parents: the flagship batch's BFS trees through the device parent scan
    (K1 op=min over a full ELL, passes of 128 lanes): the pass that holds
    the first of the flagship's validated lanes (1 of 64 passes, cut from
    2 to pay for the aot phase; the 8192-lane export stated as per-pass x 64),
    timed on the device and copied to the host, every lane of it decoded
    there (timed); that lane's tree
    equals validate.min_parent_from_dist and passes certify_bfs; then the
    public parents_into(device="device") on a 32-lane batch (64 before
    the aot phase): its lane 0, the same source, equals that checked tree,
    and its last lane passes both checks. The K1 min
    entry of the kernels line is timed here, at the scan's shape;
 8. single: the reference's single-source BFS on the flagship graph,
    through BfsEngine with each of the scan, segment, scatter, delta and
    dopt backends and through TiledBfsEngine: 1 source, the hub (4, then
    2, cut to pay for the mesh_serve and aot phases), run
    once to warm and once timed; every distance array equals SciPy's and
    every tree equals the first engine's, which passes check_parents. Per
    backend: ms per BFS, levels, GTEPS, host syncs and peak memory. These
    engines are plain PyTorch: no kernel launches;
 9. packed: the 512-lane PackedMsBfsEngine on the flagship graph, one
    build_ell shared by a 256-lane (w 8) and a 32-lane (w 1) engine, each
    with the single phase's source in lane 0 (checked against SciPy)
    and lane 0's tree from parents_int32 (the device scan), equal to the
    single phase's checked tree; K1 launches counted, and K1 held
    against its twin bit for bit at both widths on the run's own tables
    (the "K1 or, packed w 8" and "K1 or, packed w 1" kernel entries);
10. graph500: run_graph500(scale 17, ef 16, mode="hybrid", 64 searches,
    4 validated) on the card, its trees from the device scan through the
    default parents_int32 (the host scatter-min is made to raise while it
    runs): scale 17, not 21 (the flagship phase runs the hybrid at 21),
    keeps the whole script near 11 minutes (--graph500-scale 20 or 21 runs
    the larger graphs; the line states the cut).
    Then mode="single" (16 searches, 4 validated) and mode="batched" (64
    searches) at scale 17 (--graph500-small-scale; the single phase runs the
    single-source path at the flagship's scale 21).
11. pullgate (run after parents): HybridMsBfsEngine(pull_gate=True) on the
    flagship's HybridGraph, a gated and an ungated batch on the flagship's
    8192 sources: visited tables equal and plane bits equal on real rows of
    active lanes (compared on the device), 1 lane against SciPy (3 before
    the adaptive phase was added: the state check covers them); both batch
    times, hmean GTEPS, the skipped blocks (gated_tiles), state blocks and
    host reads per level, K1's time per level in each and peak memory; then
    the wide engine at the wide phase's scale, gated against ungated. The
    gated batch's K1 launches, replayed on their own masks, are the "K1 or,
    gated" kernels entry. After the single phase, TiledBfsEngine(pull_gate=
    True) from its sources, equal to SciPy and to its checked trees;
12. ckpt (after packed): a CKPT_LANES-lane (64; 256 before, cut to keep
    the script's time) hybrid batch on the flagship graph,
    its first --ckpt-every levels (4) on the hybrid, saved, loaded and
    resumed to the end on the wide engine (one save, cut from one a chunk
    and then from one a mode to keep the script's time), equal on every
    lane to an uninterrupted run; ungated, then gated (resumed from the
    checkpoint in memory). Then a single-source BfsEngine
    (scan) started, advanced to level 2, saved, loaded and finished, equal
    to run; the same level-2 state saved as 4 shards
    (save_checkpoint_sharded), reloaded and finished, equal to run; and the
    run's result through save_result / load_result. Seconds of each.
13. workloads, one line a kind. khop (after pullgate): KhopServeEngine over
    the flagship HybridMsBfsEngine, k = 3, on its 8192 sources, 3 lanes'
    reached equal to SciPy's vertices within 3 hops. Then, after ckpt:
    sssp, SsspEngine at 256 lanes on the flagship graph with
    edge_weights(seed=1, wmax=8) attached, from the hub and sources drawn
    with default_rng(7) among the traversable vertices, a warm batch (CUDA
    events on every K1 launch) and a timed one, 2 lanes equal to SciPy's
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
    entries. Then at the wide phase's scale (16) with 4096 lanes: the hybrid's
    sparse and sliced exchanges against a single-device HybridMsBfsEngine
    and DistWideMsBfsEngine (dense, sparse) against the wide phase's
    engine, every lane's distances compared on the device. Last (a side
    arm, 23), two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
    device) run DistHybridMsBfsEngine at the same scale, equal to a
    single-device batch.
15. mesh_single (after single): the single-source mesh engines on a
    one-rank NCCL group on cuda:0 at the flagship's full size, from the
    single phase's 2 sources: DistBfsEngine with the ring, allreduce and
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
    stated). Then (a side arm, 23) gloo ranks sharing cuda:0 at the wide
    phase's scale (16): the 1D engine on 2 ranks and the 2D engine on 2x2,
    ring and sparse, every source's distances and tree equal to BfsEngine's
    on the card.
16. mesh_kinds (after p2p): every workload kind on a one-rank NCCL group on
    cuda:0 at the flagship's full size, over one build_ell_sharded of the
    flagship graph (the weights do not change it) and one
    build_ell_weights_sharded. DistSsspEngine at 256
    lanes on the sssp phase's weighted graph and sources, with the ring,
    allreduce and sparse (delta ids 8/16, prediction) exchanges: a warm
    batch, a timed one (its K1 launches exactly buckets x (rounds +
    closes)), 1 more in turns with the sssp phase's SsspEngine (2 until PR
    13); every lane's
    distances equal SsspEngine's bit for bit on the device and the checked
    lanes SciPy's dijkstra; rounds, closes, host reads a round, the exchange
    ms a round (CUDA events) and peak memory per engine. The ring engine's
    shard tables give the "K1 minplus, mesh shard, w 256" kernels entry
    (light plane, and the heavy close's plane held to the twin too). Then
    connected_components and k-hop (k = 3) over an 8192-lane
    DistWideMsBfsEngine on the flagship's sources, and p2p (the p2p phase's
    128 pairs) over a 256-lane one: equal to the single-device phases'
    labels, counts and answers, every path walked. Last (a side arm, 23),
    two gloo ranks sharing cuda:0 at RMAT scale 14 (--mesh-kinds-small-scale; 16 before
    the aot phase): the mesh
    SSSP (sparse, delta, prediction), DistBfsEngine with every planner knob
    and k-hop over the wide mesh engine with delta ids, equal to their
    one-device engines.
17. serve (after mesh_kinds, the flagship graph still loaded): the serve
    tier (tpu_bfs_torch/serve). BfsService(engine="wide", lanes=256,
    width_ladder="auto" (32/64/256), linger_ms=2) on the flagship graph, the
    JAX bench_serve protocol cut to 64 client threads x 2 queries (x 4
    until the fleet arm, x 8 before the aot phase), closed
    loop, sources from default_rng(7) among the traversable vertices;
    pipelined, then unpipelined (64 clients x 2 queries since PR 13, to
    pay for the mesh_serve phase) in turns: on the warmed rungs, on the aot
    phase's preheated service (b), and on the warmed rungs again. Every
    response's reached and levels equal the 256-lane rung engine's direct
    batches, 8 rows of distances those batches' and 3 SciPy's. QPS, p50/p99,
    fill, routing, extract p50, peak memory, K1 launches, each rung's build
    and warm seconds and the dispatch's host reads a level. One 48-query
    batch routed to the 64-lane rung (w 2) gives the "K1 or, serve rung
    w 2" kernels entry. Then (a side arm, 23) `python -m
    tpu_bfs_torch.serve` on RMAT 16 as a subprocess (three queries, a malformed line, an out-of-range source;
    SIGTERM drains it, exit 0); the chaos arm (the flagship service under
    seed=7:transient@serve_batch:n=2,slow_extract:ms=50:n=4, 64 queries,
    the recovery counters exactly the fired faults); at the wide phase's
    scale with edge_weights(seed=1, wmax=8) a five-kind service (8 queries
    a kind, each equal to that kind's engine run directly), a hybrid service
    (4096 lanes, 64 queries, K2 on the serve path) and the answer tier (a
    repeat is a cache hit, a landmark-exact p2p pair needs no dispatch).
    The integrity arm: (a) the flagship loop once more (64 clients x 2
    queries since PR 13), pipelined, with
    audit_rate=0.1, audit_structural and audit_checksum: zero findings and
    audit errors, every answer equal to the direct batches; audits run,
    the audit p50 lag, the structural audit's ms, QPS and p50 beside the
    unaudited pipelined loop; (b) at the wide phase's scale, corrupt_result
    (one finding, one quarantine, every later answer equal to SciPy's, a
    flight dump naming the query) and corrupt_wire (a checksum finding).
18. obs (after ckpt): the operations surface. The port CLI as a
    subprocess at the wide phase's scale (a side arm, 23): a gated hybrid batch with
    --stats --trace-out, its trace line's levels equal to the batch's and
    the Perfetto file one level-track row a level; a 256-lane gated wide
    batch in turns with the recorder disarmed and armed (the overhead,
    printed, not gated); and the CLI in process under --ckpt --faults
    'seed=7:transient@advance:n=1,corrupt_ckpt:n=1', its distances equal
    to an unfaulted run and its recovery line the fired faults. The
    mesh_single phase also checks each engine's last_run_trace: frontier
    total = reached - 1, its rows' wire bytes = the exchange accounting.
19. dynamic (after p2p): dynamic graphs (tpu_bfs_torch/graph/dynamic.py),
    overlay capacity 256 x 32. (a) WidePackedMsBfsEngine(lanes=256,
    overlay=...) over the packed phase's full ELL of the flagship graph,
    not cut: with the empty overlay every lane equals a plain 256-lane
    engine's; then an add-only batch of 64 edges between mutable vertices
    (default_rng(23), degree 1 to kcap - 2, JAX's bench rule) and a batch
    of 16 base-edge removals (override rows), each followed by one batch
    from the mutated endpoints: 2 lanes (an added and a removed edge's
    endpoint; 5 before the adaptive phase) equal to SciPy on materialize(),
    some lane's distances changed; K1 ms a level (CUDA events), the
    plain-torch fold's ms a level and the batch ms with and without the
    overlay. (b) SsspEngine(lanes=256, overlay=...) on the sssp phase's
    weighted graph and sources after a batch of 48 adds and 16 re-weights:
    1 lane equal to Dijkstra on materialize() (5, then 2, before); K1 minplus and the fold's
    ms a light sweep. Their K1 launches give the "K1 or, dynamic wide w 8"
    and "K1 minplus, dynamic sssp w 256" kernels entries, each bit-exact
    against its twin on the engine's own tables. (c) At the wide phase's
    scale (every flip materializes the graph for the staleness ring):
    BfsService(wide, 256 lanes, ladder auto, dynamic=..., kinds bfs, sssp
    and cc, audit_rate=0.1, staleness_bound=0) under JAX's mutation soak,
    16 closed-loop clients and 32 one-edge flips 0.05 s apart: no query
    dropped, no staleness finding, 8 answers equal to SciPy on their
    generation's graph; flip ms p50 and max, overlay occupancy, queries;
    one forced compaction (answers unchanged, its seconds); torn_flip (one
    staleness finding, then healed), corrupt_overlay (restaged from host
    truth, no finding) and compaction_crash (rolled back, the orphan
    quarantined, answers unchanged).
20. mesh_serve (after serve): the serve tier on a mesh. This process joins
    as rank 0 of 4 gloo ranks sharing the card (``serve_mesh``; NCCL takes
    one rank a card, so this measures the mesh serving machinery, not
    scaling) on RMAT --wide-scale (16, cut from the flagship's 21; every
    rank builds its own shard tables and gloo stages rows through the
    host). The phase draws its own pool of 64 x 4 sources (MESH_SERVE_*).
    (a) BfsService(wide, devices=2, 256 lanes, ladder auto = 64/256)
    under JAX's bench_serve loop, 64 clients x 2 queries (SERVE_PER_CLIENT
    of each pool row): every answer's
    reached and levels equal a single-device WidePackedMsBfsEngine batch,
    8 rows of distances too and 3 SciPy's, every traversal record devices
    2 with the engine's edges and a wire-bytes share; QPS, p50/p99, fill,
    routing; then a 192-query batch queued before start() takes the
    256-lane rung, and rank 0's shard of it gives the "K1 or, mesh serve
    rung w 8 (shard)" kernels entry. (b) That service under
    device_lost@fetch@rank=1:n=1 armed after start, 16 clients x 4
    queries: it degrades 2 -> 1
    with no failed query, mesh_faults = mesh_degrades = 1; a probe fault
    holds mesh_restore(2); cleared, it serves on 2 ranks again (16 x 4
    more queries), answers
    equal. (e) A hybrid service on 2 ranks, 4096 lanes, three 64-query
    batches equal to a single-device HybridMsBfsEngine; rank 0's row tiles give the
    "K2, mesh serve rung (shard)" entry. (c) dist2d on 2x2, 32 lanes,
    resume_levels=2, a resume spool, device_lost@fetch@level=2: the query
    answers from the degraded 1x2 mesh equal to SciPy, resumed at the
    level-2 snapshot, every spooled snapshot reloaded through its CRC.
    (d) (a side arm, 23) ``python -m tpu_bfs_torch.serve rmat:scale=16
    --devices 2`` as a subprocess: three answers with devices 2, SIGTERM
    drains, exit 0.
21. adaptive (after pullgate): the flagship as JAX's bench runs it.
    (a) HybridMsBfsEngine(max_lanes=8192, adaptive_push=(8192, 64)) built
    from the flagship graph (its push table needs the edge list), on the
    flagship's sources, a timed batch in turns with the plain flagship
    engine (plain, adaptive, adaptive, plain): its visited table and every
    counter plane equal the plain batch's on the device, levels, reached
    and traversed edges too, lane 0 equal to SciPy; one host read a level;
    K1 launches fewer by the buckets a level and K2's by one for each
    light level. Each light level is replayed on its own frontier: the push
    pass equals the pull hit on the card, both timed with CUDA events.
    The "K1 or, adaptive flagship (pull levels)" and "K2, adaptive flagship
    (pull levels)" kernels entries are the adaptive batch's launch counts
    with the kernels phase's measurements: the adaptive engine's kernel
    tables are checked equal to the flagship engine's, and its frontiers
    are the plain batch's. (b) The roofline (tpu_bfs_torch/utils/roofline.py) on
    that engine: per-phase totals, shares, achieved GB/s, the binding term,
    the ceiling at 3.35 TB/s; its stepped level count equals the batch's
    (the guard) and its push levels the loop's. (c) The wide phase's scale-16
    engine with the same caps against its plain run: state equal.
    The obs phase's traced CLI run also writes a torch.profiler trace
    (--profile-dir) that must parse and name both CUDA kernels, and the
    serve phase's JSONL subprocess runs with --xprof-dir: its trace must
    exist after the SIGTERM drain and name K1.
22. aot: cold start and preheat (tpu_bfs_torch/utils/aot.py). (a) After
    adaptive: the flagship engine's five programs (core, the level step;
    seed; lane_stats; extract_word; lane_ecc) exported with torch.export,
    each export's seconds and artifact bytes; adopted on the same engine
    (its own tables), the adopted core naming both kernel ops and no copy;
    then the eager and the adopted batch in turns (eager, adopted, adopted,
    eager): visited tables and every plane equal on the device, levels,
    reached and ecc too, K1 and K2 launches equal; K1 and K2 timed through
    the registered ops on the kernels phase's operands, bit-exact against
    their twins (the "adopted flagship" kernels entries); the host time of
    one level step's call (its enqueue, the level's critical path after the
    level's one read) eager, adopted, and adopted through the loaded
    module's own input check, with the adopted call's signature check
    alone. (b) In the serve
    phase: the warmed flagship registry's three rungs exported, a fresh
    registry over the store, torch.export.export made to raise: every rung
    an engine_adopt span, no engine_build, 5 artifact hits a rung and no
    fallback; the unpipelined 64 x 2 loop runs on that service between two
    turns of it on the warmed rungs, every answer equal to the direct
    batches; its QPS over the eager turns' mean, each rung's adopt seconds
    beside its build seconds. (d) The serve phase's JSONL server (RMAT 16, one
    256-lane rung since this phase) runs with --export-aot; a --preheat
    successor started through tools/warm_handoff.py reads hits and no
    fallback on its READY line, then the handoff SIGTERMs the first server,
    which drains with exit 0; the successor answers the same lines bit for
    bit. (c) A copy of that store under corrupt_aot:n=1 in process: one
    quarantine, one fallback, four hits, answers equal to the engine's.
    The fleet arm, on (d)'s graph and store and beside (d):
    tools/fleet_supervisor.py over 2 --preheat replicas of that server on
    the card; 24 queries, one
    replica SIGKILLed once half are submitted (its unanswered queries
    requeue onto the sibling): every query answered exactly once, equal to
    the one-shot server's answers and the engine's; one restart, READY-
    gated; each replica's seconds to READY.
23. side (after serve): the arms that drive processes of their own run
    side by side in threads while this process's own phases wait, so no
    kernel timing of theirs overlaps them: the serve phase's JSONL act with
    the aot phase's (c), (d) and fleet arm, the obs phase's traced CLI, the
    mesh_serve phase's (d) and the gloo ranks sharing the card of the mesh,
    mesh_single and mesh_kinds phases; the arms beside the JSONL act, the
    longest chain, run at nice 10 with the processes they start. Each keeps
    its checks and prints its line after all have ended; the seconds of each
    were taken beside the others (a READY or an answer time includes the
    shared host).
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
import shutil
import signal
import subprocess
import sys
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# The H100's HBM rate (3.35 TB/s, NVIDIA data sheet), the package's one constant.
from tpu_bfs_torch.utils.roofline import HBM_BYTES_PER_S

# The adaptive push caps JAX's bench runs the flagship at (bench.py:543-566).
ADAPTIVE_CAPS = (8192, 64)
# Parent-scan passes whose 128 lanes are all decoded on the host (timed);
# the rest decode only the validated lanes (a whole pass takes seconds).
# One pass keeps the whole script near 9 minutes.
DECODE_PASSES = 1
# Lanes of the parents phase's public parents_into export (256 until PR 13).
PARENTS_INTO_LANES = 32
# Sources of the single phase (the hub and draws), which the mesh_single,
# pullgate (tiled), packed and ckpt phases reuse: a source costs each of
# them its warm and timed runs and its host checks at scale 21.
SINGLE_SOURCES = 1
# Lanes of the ckpt phase's checkpointed batch (256 before, cut to keep the
# script's time: its one file save is host zlib, ~14 s at 256 lanes).
CKPT_LANES = 64
# Threads checking BFS trees on the host side by side (a lane's check is
# a few O(E) numpy passes, some 2 GB of temporaries at scale 21).
CHECK_THREADS = 4
# Timed runs a source in the mesh_single phase past the protocol's one, in
# turns with BfsEngine's: the spread of a ~10 ms BFS driven from the host.
REPEATS = 3
# Turns of each mesh SSSP engine with SsspEngine in the mesh_kinds phase
# (a ~0.7 s batch; one since PR 13, to pay for the mesh_serve phase).
MESH_KINDS_TURNS = 1
# The serve phase's closed loop (the JAX bench_serve's 64 clients, with 2
# queries each: 4 until the fleet arm, 8 before the aot phase, cut to pay
# for them) and its chaos arm's fault spec (scripts/chip_session.sh:203-204).
SERVE_CLIENTS = 64
SERVE_PER_CLIENT = 2
# Queries a client in the unpipelined and audited loops, which run beside
# the pipelined one at its concurrency (8 until PR 13, cut to pay for the
# mesh_serve phase).
SERVE_SHORT_PER_CLIENT = 2
# Sources a client in the mesh_serve phase's pool: (a)'s closed loop takes
# SERVE_PER_CLIENT of each row; its w 8 burst and (e)'s 64-query batches take
# MESH_SERVE_BURST of the pool, and (b)'s two 16-client loops whole rows.
MESH_SERVE_PER_CLIENT = 4
MESH_SERVE_BURST = 192
SERVE_SPEC = "seed=7:transient@serve_batch:n=2,slow_extract:ms=50:n=4"
# Queries through the aot phase's two-replica fleet (at most 32: the
# arm's reference engine answers the rest in one 32-lane batch).
FLEET_QUERIES = 24
# The dynamic phase's overlay capacity (rows, kcap): JAX's bench default.
DYN_CAP = (256, 32)
# The edge stream of every RMAT graph the script generates for itself: the
# native generator, whose stream JAX's bench graphs come from
# (bench.py:686-710). The library is built at the start; a failed build
# ends the script, never a fall back to the NumPy stream.
STREAM = "native"
# The edge stream of each graph the script made (id -> (weakref, stream)):
# a kernels row names the stream of the graph its tables were built from.
_STREAMS: dict = {}
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


# SciPy's BFS on the graphs the script holds: one float64 matrix in
# canonical form a graph (csgraph converts an int8 one on every call, most of
# a call's time at scale 21) and each source's distances once. An entry lives
# as long as its graph: id -> (weakref, matrix, {source: distances}).
_ORACLE: dict = {}


def oracle_matrix(g):
    """``g.to_scipy()`` as csgraph takes it (float64, duplicate slots summed,
    indices sorted), built once a graph."""
    key = id(g)
    hit = _ORACLE.get(key)
    if hit is None or hit[0]() is not g:
        mat = g.to_scipy().astype(np.float64)
        mat.sum_duplicates()
        hit = (weakref.ref(g, lambda _, key=key: _ORACLE.pop(key, None)), mat, {})
        _ORACLE[key] = hit
    return hit[1]


def scipy_bfs(g, source: int) -> np.ndarray:
    """``bfs_scipy(g, source)`` over :func:`oracle_matrix`, computed once a
    (graph, source); the array is read-only."""
    from tpu_bfs_torch.reference import bfs_scipy

    mat, s = oracle_matrix(g), int(source)
    dists = _ORACLE[id(g)][2]
    if s not in dists:
        dists[s] = bfs_scipy(g, s, csr=mat)
        dists[s].setflags(write=False)
    return dists[s]


def validate_lanes(g, res, sources, picks) -> None:
    from tpu_bfs_torch.validate import check_distances

    for i in picks:
        check_distances(res.distances_int32(i), scipy_bfs(g, int(sources[i])))


def phase_wide(dev, k1, k2, scale: int) -> None:
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine

    t0 = time.perf_counter()
    g = rmat(scale)
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
    emit({"phase": "wide", "scale": scale, "edge_factor": 16, "edge_stream": STREAM,
          "lanes": 4096,
          "host_build_s": build_s, "levels": res.num_levels,
          "batch_ms": res.elapsed_s * 1e3, "hmean_gteps": res.teps / 1e9,
          "ell_expand_launches": launches, "validated_lanes": picks})
    return g, eng, res, sources


def tagged(g, stream: str):
    """Record ``g``'s edge stream (see stream_of); returns ``g``."""
    _STREAMS[id(g)] = (weakref.ref(g), stream)
    return g


def stream_of(g) -> str:
    """The edge stream recorded for ``g`` by rmat, flagship_graph or
    tagged; fails for a graph the script did not record."""
    ref, stream = _STREAMS.get(id(g), (None, None))
    require(ref is not None and ref() is g, "a kernels row's graph has no recorded edge stream")
    return stream


def rmat(scale: int, **kw):
    """RMAT scale/ef16/seed1 from the script's edge stream (STREAM)."""
    from tpu_bfs_torch.graph.generate import rmat_graph

    return tagged(rmat_graph(scale, 16, seed=1, impl=STREAM, **kw), STREAM)


def flagship_graph(scale: int):
    """RMAT scale/ef16/seed1 (native generator), cached as .npz under build/
    with the stream in the file's name. Returns (graph, cached)."""
    from tpu_bfs_torch.tools.roofline import load_rmat

    g, cached = load_rmat(scale, 16)
    return tagged(g, "native"), cached


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
    # 3 lanes (5 before, cut to pay for the aot phase; the later
    # phases check their state against this batch's on the card).
    picks = sorted({0, lanes // 2, lanes - 1})
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
        "phase": "flagship", "graph": f"RMAT scale {scale}, ef 16, seed 1 ({STREAM} stream)",
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


def phase_kernels(g, eng, res, launches, k1, k2, ptxas):
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
         "ptxas": ptxas.get(Path(src).name, []), "edge_stream": stream_of(g)}
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


def k1_entry(k1, arrs, names, fw, op: str, launches: int, ptxas, *, g, name: str,
             unit: str, plain_reps: int = 1, wsuf: str | None = None) -> dict:
    """A kernels-line entry of K1 over one pass of every bucket ``names`` of
    ``arrs`` (built from graph ``g``, whose edge stream it names) with
    frontier (or key, or distance) table ``fw``: the kernel
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
        "ptxas": ptxas.get("ell_expand.cu", []), "edge_stream": stream_of(g),
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
    batch. Only the passes that hold a validated lane (and the first) run:
    every pass is the same work on other lanes, so the whole 8192-lane
    export is stated as the per-pass figures times the pass count. Returns
    the K1 min entry of the kernels line."""
    from tpu_bfs_torch.algorithms._packed_common import _decode_pass, acquire_parent_scanner

    require(res._iso is None, "flagship sources are traversable: none isolated")
    # The first of the flagship's validated lanes (a tree check at scale 21
    # takes 5-6 s of host work; the first and last before, cut to pay for
    # the aot phase).
    picks = [picks[0]]
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
    all_passes = -(-n // lpp)
    scanned = sorted({0} | {i // lpp for i in picks})
    torch.cuda.synchronize()
    reset_counts(k1, k2)
    k1.ell_expand.timings = []
    t_scan = time.perf_counter()
    for lane0 in (p * lpp for p in scanned):
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
        scanner, 0, lpp // 32, perm)), "min", launches["ell_expand"], ptxas, g=g,
        name="ell_expand_min",
        unit=f"one parent-scan pass: every bucket of the full ELL, w {lpp}")
    first_tree = trees[picks[0]]
    del scanner, buf, trees

    # The public export on a small batch of the same engine; it builds its
    # own scanner (the hybrid's is not cached) and an [S, V] host array.
    res2 = eng.run(sources[:PARENTS_INTO_LANES])
    out = np.empty((PARENTS_INTO_LANES, g.num_vertices), np.int32)
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    res2.parents_into(out, device="device")
    export_s = time.perf_counter() - t0
    export_launches = k1.ell_expand.launches
    require(export_launches == -(-PARENTS_INTO_LANES // lpp) * buckets,
            f"parents_into launched {export_launches} K1")
    checked = [0, PARENTS_INTO_LANES - 1]
    # Lane 0 is the scan's checked lane (the same source): its tree must be
    # that one; the last lane is checked in full.
    require(picks[0] == 0 and np.array_equal(out[0], first_tree),
            "parents_into lane 0 != the scan's checked tree of the same source")
    _check_trees(g, res2, sources, checked[1:], out)
    per_pass_s = scan_s / len(pass_ms)
    emit({
        "phase": "parents", "lanes": n, "passes": len(pass_ms), "passes_scanned": scanned,
        "passes_of_the_batch": all_passes, "lanes_per_pass": lpp,
        "cut": f"{len(pass_ms)} of {all_passes} passes (those of the validated lanes and "
               f"the first); the export figures below are per pass x {all_passes}",
        "export_s_est": per_pass_s * all_passes,
        "export_device_ms_est": sum(pass_ms) / len(pass_ms) * all_passes,
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
        f"parents_into_{PARENTS_INTO_LANES}": {
            "seconds": export_s, "ell_expand_launches": export_launches,
            "checked_lanes": checked, "host_bytes": out.nbytes},
    })
    return entry


def phase_single(dev, k1, k2, g, traversable):
    """The reference's run, one source at a time, on the flagship graph:
    each single-source backend from SINGLE_SOURCES sources, warm then timed, every
    distance array against SciPy and every tree checked. Returns the
    sources, their SciPy distances, their checked trees and the
    DeviceGraph."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine
    from tpu_bfs_torch.graph.csr import DeviceGraph
    from tpu_bfs_torch.validate import check_distances, check_parents

    hub = int(np.argmax(g.degrees))
    draws = np.random.default_rng(7).choice(traversable, size=SINGLE_SOURCES - 1,
                                            replace=False)
    sources = [hub] + [int(x) for x in draws]
    t0 = time.perf_counter()
    golden = {s: scipy_bfs(g, s) for s in sources}
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


def phase_mesh_single(dev, k1, k2, g, dg, sources, golden, trees):
    """The single-source mesh engines on a one-rank NCCL group (see the
    module docstring, phase 15; gloo ranks sharing the card are a side arm,
    shared_card_single). Each
    engine's timed runs alternate with BfsEngine's of its backend on the
    single phase's DeviceGraph ``dg``."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.obs.engine_trace import trace_summary
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
            # The engine trace of the checked run (no host read of its own).
            summ = trace_summary(eng.last_run_trace)
            require(summ["frontier_total"] == r.reached - 1 and summ["levels"] == bodies
                    and summ["wire_bytes_total"] == eng.last_exchange_bytes,
                    f"{name} {kw}: trace {summ} against reached {r.reached}, {bodies} "
                    f"levels, {eng.last_exchange_bytes} bytes")
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
                         "exchange_counts": eng.last_exchange_level_counts.tolist(),
                         "trace": summ})
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


def shared_card_single_rank(mesh, scale: int, shape, sources):
    """Rank entry of the shared-card single-source check: DistBfsEngine
    (ring and sparse) for an int ``shape``, Dist2DBfsEngine (ring and
    sparse) for an (R, C) one, on RMAT ``scale``; each source's distances
    and parents, and the backend and device."""
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    g = rmat(scale)
    m2 = make_mesh_2d(*shape, mesh=mesh) if isinstance(shape, tuple) else None
    out = {}
    for exchange in ("ring", "sparse"):
        eng = (Dist2DBfsEngine(g, m2, exchange=exchange) if m2
               else DistBfsEngine(g, mesh, exchange=exchange))
        for s in sources:
            r = eng.run(s)
            out[(exchange, s)] = (r.distance, r.parent)
    return out, mesh.backend, str(mesh.device)


def shared_card_single(dev, scale: int) -> dict:
    """The mesh_single phase's side arm: gloo ranks sharing the card (NCCL
    takes one rank a device), the 1D engine on 2 ranks and the 2D engine on
    a 2x2 mesh, the two groups side by side; every source's distances and
    tree equal to BfsEngine's on the card. Returns the phase line."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.parallel.mesh import start

    g = rmat(scale)
    hub = int(np.argmax(g.degrees))
    draws = np.random.default_rng(7).choice(np.flatnonzero(g.degrees > 0), size=2, replace=False)
    sources = [hub] + [int(x) for x in draws]
    t0 = time.perf_counter()
    groups = [(ranks, shape, start(ranks, shared_card_single_rank, scale, shape, sources,
                                   device=f"cuda:{dev.index or 0}", backend="gloo"))
              for ranks, shape in ((2, 2), (4, (2, 2)))]
    ref = BfsEngine(g, device=dev)
    want = {s: ref.run(s) for s in sources}
    runs = []
    for ranks, shape, group in groups:
        got, backend, where = group.result()
        for (exchange, s), (dist, parent) in got.items():
            require(np.array_equal(dist, want[s].distance)
                    and np.array_equal(parent, want[s].parent),
                    f"shared card {shape} {exchange}: source {s} != BfsEngine")
        runs.append({"mesh": "x".join(map(str, shape)) if isinstance(shape, tuple) else shape,
                     "ranks": ranks, "backend": backend, "device": where,
                     "exchanges": ["ring", "sparse"], "seconds": time.perf_counter() - t0})
    return {"phase": "mesh_single", "shared_card": True, "scale": scale, "sources": sources,
            "equal_to": "BfsEngine on the card: distances and trees", "runs": runs}


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
    batch = np.concatenate([np.asarray(sources), rest])[:256]
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
        for i in range(len(sources)):
            check_distances(res.distances_int32(i), golden[int(src[i])])
        t0 = time.perf_counter()
        tree = res.parents_int32(0)  # the device scan (K1 min) over the engine's tables
        tree_s = time.perf_counter() - t0
        require(np.array_equal(tree, trees[int(src[0])]),
                f"packed w {eng.w}: lane 0's tree != the single phase's checked tree")
        out[f"w{eng.w}"] = {"lanes": lanes, "build_s": build_s, "levels": res.num_levels,
                            "batch_ms": res.elapsed_s * 1e3, "hmean_gteps": res.teps / 1e9,
                            "k1_launches": launches, "tree_s": tree_s,
                            "validated_lanes": list(range(len(sources)))}
        entries.append(k1_entry(
            k1, eng.arrs, names, res._vis, "or", launches, ptxas, plain_reps=2, g=g,
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
          "edge_stream": "numpy (run_graph500 generates its graph as tpu_bfs/graph500.py:85 "
                         "does)",
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


def k1_gated_entry(k1, g, calls, launches: int, ptxas) -> dict:
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
        "ptxas": ptxas.get("ell_expand.cu", []), "edge_stream": stream_of(g),
    }
    k1.ell_expand.launches = saved  # comparisons do not count
    return entry


def same_state(a, b, name: str) -> None:
    """Require two batches' raw state equal on the device: the visited
    tables and every counter plane, whole."""
    require(torch.equal(a._vis, b._vis), f"{name}: visited tables differ")
    require(len(a._planes) == len(b._planes)
            and all(torch.equal(p, q) for p, q in zip(a._planes, b._planes)),
            f"{name}: counter planes differ")


def timed_batch(k1, k2, eng, sources) -> dict:
    """One timed batch: ms, hmean GTEPS, levels, K1 and K2 launches, and the
    result."""
    reset_counts(k1, k2)
    res = eng.run(sources, time_it=True)
    return {"res": res, "batch_ms": res.elapsed_s * 1e3, "hmean_gteps": res.teps / 1e9,
            "ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}


def push_levels(k1, k2, aeng, sources) -> list:
    """Each light level of one adaptive batch, replayed on its own frontier:
    the push pass against the pull hit it replaces, bit for bit on the
    card, then both timed with CUDA events (the push with the plan the
    loop read; the pull as make_hit composes it, K1 then K2)."""
    from tpu_bfs_torch.algorithms.msbfs_hybrid import make_hit

    push, caught = aeng._push, []
    real = push.hit

    def capture(arrs, fw, plan, active=None):
        caught.append((fw.clone(), plan))
        return real(arrs, fw, plan, active)

    push.hit = capture
    try:
        aeng.run(sources)
    finally:
        del push.hit
    pull = make_hit(aeng.hg, aeng.w)
    arrs, saved = aeng.arrs, (k1.ell_expand.launches, k2.tile_spmm.launches)
    light = [i for i, p in enumerate(aeng.last_push_levels) if p]
    require(len(light) == len(caught), f"{len(caught)} push passes for light levels {light}")
    out = []
    for level, (fw, plan) in zip(light, caught):
        got, want = real(arrs, fw, plan), pull(arrs, fw)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"level {level}: push pass != pull hit on the card")
        del got, want
        out.append({"level": level, "rows": plan.rows, "pairs": plan.pairs,
                    "push_ms": cuda_ms(lambda: real(arrs, fw, plan), 5),
                    "pull_hit_ms": cuda_ms(lambda: pull(arrs, fw), 3)})
    k1.ell_expand.launches, k2.tile_spmm.launches = saved  # comparisons do not count
    return out


def phase_adaptive(dev, k1, k2, g, eng, sources, picks, wide, flagship_entries) -> list:
    """The flagship as JAX's bench runs it: HybridMsBfsEngine with
    adaptive_push at ADAPTIVE_CAPS on the flagship graph and sources,
    against the plain flagship engine in turns (see the module docstring,
    phase 21). Returns the kernels-line entries of K1 and K2 on its pull
    levels: the kernels phase's entries (``flagship_entries``, measured in
    this run), since those launches have the same tables and frontiers."""
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.utils.roofline import roofline_hybrid

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    aeng = HybridMsBfsEngine(g, max_lanes=eng.lanes, adaptive_push=ADAPTIVE_CAPS, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require((aeng.lanes, aeng.num_planes) == (eng.lanes, eng.num_planes),
            f"adaptive engine sized {aeng.lanes} lanes, {aeng.num_planes} planes")
    aeng.run(sources)  # warm
    # In turns: plain, adaptive, adaptive, plain; the first of each is kept.
    turns = {"plain": [], "adaptive": []}
    for name, e in (("plain", eng), ("adaptive", aeng), ("adaptive", aeng), ("plain", eng)):
        turns[name].append(timed_batch(k1, k2, e, sources))
        if len(turns[name]) > 1:
            del turns[name][-1]["res"]
    plain, adap = turns["plain"][0], turns["adaptive"][0]
    rp, ra = plain.pop("res"), adap.pop("res")
    same_state(ra, rp, "adaptive flagship against the plain one")
    require(ra.num_levels == rp.num_levels and np.array_equal(ra.reached, rp.reached)
            and np.array_equal(ra.edges_traversed, rp.edges_traversed),
            "adaptive levels, reached or traversed edges != the plain flagship's")
    hg = aeng.hg
    per_level = (1 if hg.res_heavy else 0) + len(hg.res_light)
    pushed = list(aeng.last_push_levels)
    nlev = ra.num_levels
    light = sum(pushed)
    require(aeng.last_host_syncs == len(pushed) == ra.num_levels + 1,
            f"adaptive loop: {aeng.last_host_syncs} host reads over {len(pushed)} levels")
    require(adap["ell_expand"] == plain["ell_expand"] - per_level * light
            and adap["tile_spmm"] == plain["tile_spmm"] - light,
            f"launches {adap} against {plain} with {light} light levels")
    t0 = time.perf_counter()
    validate_lanes(g, ra, sources, picks)
    validate_s = time.perf_counter() - t0
    del rp
    gc.collect()
    torch.cuda.empty_cache()

    levels = push_levels(k1, k2, aeng, sources)
    # K1 and K2 on the pull levels launch on the flagship engine's tables
    # (one build_hybrid of one graph: checked equal here) and frontiers (the
    # state is the plain batch's, checked above), so their entries are the
    # kernels phase's measurements with this batch's launch counts.
    names = (["virtual"] if hg.res_heavy else []) + [f"light{i}" for i in range(len(hg.res_light))]
    keys = [f"{n}_{t}" for n in names for t in ("gt", "need")] + [
        "inv_perm_ext", "row_start", "col_tile", "a_masks"]
    require(all(torch.equal(aeng.arrs[k], eng.arrs[k]) for k in keys),
            "the adaptive engine's kernel tables != the flagship engine's")
    k1e, k2e = flagship_entries
    require((k1e["name"], k2e["name"]) == ("ell_expand", "tile_spmm"), "flagship entries")
    entries = [
        dict(k1e, name=f"K1 or, adaptive flagship (pull levels), w {aeng.w}",
             launches=adap["ell_expand"], unit=k1e["unit"] + " (the kernels phase's timing)"),
        dict(k2e, name="K2, adaptive flagship (pull levels)", launches=adap["tile_spmm"],
             unit=k2e["unit"] + " (the kernels phase's timing)"),
    ]
    del ra
    gc.collect()
    torch.cuda.empty_cache()

    # The roofline attribution on the adaptive engine, anchored to its batch.
    t0 = time.perf_counter()
    rep = roofline_hybrid(aeng, sources, measured_gteps=adap["hmean_gteps"])
    roofline_s = time.perf_counter() - t0
    require(rep["num_levels"] in (nlev, nlev + 1),
            f"roofline stepped {rep['num_levels']} levels, the batch {nlev}")
    require([la["took"] == "push" for la in rep["levels"]] == pushed,
            "roofline's push levels != the loop's")
    roofline = {k: rep[k] for k in (
        "num_levels", "t_full_sum_s", "t_attributed_sum_s", "fusion_dividend_s", "phase_share",
        "phase_achieved_gbs", "binding_term", "unmeasured_phase_slices", "peak_gbs",
        "hbm_bytes_total", "t_at_peak_bw_s", "measured_gteps", "ceiling_gteps_at_peak_bw",
        "expand_kernel_t_at_peak_bw_s")}
    totals = {}
    for la in rep["levels"]:
        for n in (["push"] if la["took"] == "push" else ["residual", "dense"]) + ["state"]:
            if la["phases_s"].get(n) is not None:
                totals[n] = totals.get(n, 0.0) + la["phases_s"][n]
    roofline["phase_totals_s"] = totals
    roofline["per_level"] = [{"level": la["level"], "rows": la["frontier_rows"],
                              "took": la["took"], "t_full_s": la["t_full_s"],
                              "phases_s": la["phases_s"]} for la in rep["levels"]]
    roofline["seconds"] = roofline_s
    del aeng, rep
    gc.collect()
    torch.cuda.empty_cache()

    # The wide engine at the wide phase's scale, adaptive against plain.
    wg, weng, wres, wsrc = wide
    t0 = time.perf_counter()
    aw = WidePackedMsBfsEngine(wg, lanes=weng.lanes, num_planes=weng.num_planes,
                               adaptive_push=ADAPTIVE_CAPS, device=dev)
    wbuild_s = time.perf_counter() - t0
    aw.run(wsrc)  # warm
    wa = timed_batch(k1, k2, aw, wsrc)
    wp = timed_batch(k1, k2, weng, wsrc)
    rw = wa.pop("res")
    del wp["res"]
    same_state(rw, wres, "adaptive wide engine against the plain one")
    require(rw.num_levels == wres.num_levels, "adaptive wide levels differ")
    wide_out = {"scale": int(np.log2(wg.num_vertices)), "lanes": aw.lanes,
                "engine_build_s": wbuild_s, "adaptive": wa, "plain": wp,
                "light_levels": int(sum(aw.last_push_levels)),
                "levels_run": len(aw.last_push_levels), "host_syncs": aw.last_host_syncs}
    del aw, rw
    emit({"phase": "adaptive", "graph": "the flagship graph", "caps": list(ADAPTIVE_CAPS),
          "lanes": eng.lanes, "engine_build_s": build_s, "levels": nlev,
          "levels_run": len(pushed), "light_levels": light, "pull_levels": len(pushed) - light,
          "pushed": pushed, "host_syncs": len(pushed), "k1_per_pull_level": per_level,
          # The fastest turn of each: the first batch after the other
          # engine's result can pay fresh allocations.
          "turns": turns, "adaptive_over_plain": min(t["batch_ms"] for t in turns["adaptive"])
          / min(t["batch_ms"] for t in turns["plain"]) - 1,
          "push_levels": levels, "validated_lanes": picks, "validate_s": validate_s,
          "roofline": roofline, "wide": wide_out,
          "phase_seconds": time.perf_counter() - t_phase})
    return entries


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
    entry = k1_gated_entry(k1, g, calls, launches["ell_expand"], ptxas)
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
    """Checkpoint and resume on the flagship graph: a CKPT_LANES-lane hybrid batch
    started, advanced ``every`` levels, saved, loaded and resumed on the
    wide engine to its end, its finish equal to an uninterrupted hybrid run
    on every lane; ungated, then gated, whose checkpoint resumes from
    memory: the saves are host zlib, the phase's cost. Then a single-source BfsEngine (scan): start,
    advance to level 2, save, load, advance, finish, equal to run."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.ops._build import BUILD_DIR
    from tpu_bfs_torch.utils import checkpoint as ck

    d = BUILD_DIR / "ckpt"
    d.mkdir(parents=True, exist_ok=True)
    path = str(d / "state.npz")
    src = np.asarray(sources[:CKPT_LANES])
    out = {}
    for gate in (False, True):
        heng = HybridMsBfsEngine(hg, lanes=CKPT_LANES, num_planes=5, pull_gate=gate,
                                 device=dev)
        weng = WidePackedMsBfsEngine(ell, lanes=CKPT_LANES, num_planes=5, pull_gate=gate,
                                     device=dev)
        full = heng.run(src)
        reset_counts(k1, k2)
        t_all = time.perf_counter()
        st = heng.advance(heng.start(src), every)  # the first chunk, on the hybrid
        require(not st.done, "the batch ended in its first chunk: nothing resumed")
        save_s, sizes, load_s = [], [], []
        if not gate:
            # The file round trip once (one host zlib save was ~13 s at
            # 256 lanes); the gated mode resumes the same checkpoint class
            # from memory.
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
        # Reached, ecc, levels and every lane's distances, compared on the
        # device word by word (lane by lane on the host took 13 s).
        same_lanes(weng, res, heng, full, "resumed vs uninterrupted")
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
    # The same level-2 state as 4 shard files, reloaded and finished.
    files = {}
    mid = beng.advance(beng.start(single_source), 2)
    t0 = time.perf_counter()
    ck.save_checkpoint_sharded(str(d / "sharded"), mid, num_shards=4)
    files["sharded_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ck.load_checkpoint_sharded(str(d / "sharded"))
    files["sharded_load_s"] = time.perf_counter() - t0
    require(back.level == 2 and np.array_equal(back.distance, mid.distance),
            "sharded reload != the saved state")
    r = beng.finish(beng.advance(back))
    require(np.array_equal(r.distance, want.distance) and np.array_equal(r.parent, want.parent),
            "sharded resume != run")
    t0 = time.perf_counter()
    ck.save_result(str(d / "result.npz"), want)
    files["result_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = ck.load_result(str(d / "result.npz"))
    files["result_load_s"] = time.perf_counter() - t0
    require(np.array_equal(got.distance, want.distance) and np.array_equal(got.parent, want.parent)
            and (got.reached, got.num_levels) == (want.reached, want.num_levels),
            "result round trip")
    shutil.rmtree(d)
    emit({"phase": "ckpt", "graph": "the flagship graph", "lanes": CKPT_LANES, "every": every,
          "packed": out, "single": {"backend": "scan", "source": int(single_source),
                                    "resumed_at": 2, "levels": r.num_levels,
                                    "equal_to_run": True},
          "files": {"shards": 4, "resumed_at": 2, "equal_to_run": True, **files}})


OBS_FAULTS = "seed=7:transient@advance:n=1,corrupt_ckpt:n=1"


def run_cli(argv) -> list:
    """stdout lines of the port CLI run in this process (exit code 0)."""
    import io

    from tpu_bfs_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    require(rc == 0, f"cli {argv} exited {rc}")
    return buf.getvalue().splitlines()


def profile_kernels(prof_dir: Path, want) -> dict:
    """The torch.profiler Chrome traces in ``prof_dir``: each parses, and
    their kernels name every entry of ``want``. Returns the files, the
    event count and the kernels named (``kernel_name`` of each)."""
    from tpu_bfs_torch.utils.profile import kernel_names

    files = sorted(prof_dir.glob("*.json"))
    require(bool(files), f"no profiler trace in {prof_dir}")
    names, events = set(), 0
    for f in files:
        events += len(json.loads(f.read_text())["traceEvents"])
        names |= kernel_names(f)
    for k in want:
        require(any(k in n for n in names), f"the profiler trace names no {k}")
    return {"files": [f.name for f in files], "events": events, "kernel_launch_names":
            len(names), "our_kernels": sorted({kernel_name(n) for n in names
                                               if any(k in n for k in want)})}


def obs_sources(scale: int):
    """The obs phase's graph spec and its 600 sources (default_rng(3) among
    the vertices with an edge)."""
    from tpu_bfs_torch.cli import load_graph

    spec = f"rmat:scale={scale}"
    live = np.flatnonzero(load_graph(spec).degrees > 0)
    return spec, [int(x) for x in np.random.default_rng(3).choice(live, 600, replace=False)]


def obs_cli(scale: int) -> dict:
    """The obs phase's traced CLI run (a side arm): the port CLI as a
    subprocess, a gated hybrid batch with --stats --trace-out and
    --profile-dir; its trace line, its Perfetto level track and its
    profiler trace checked."""
    from tpu_bfs_torch.ops._build import BUILD_DIR

    spec, src = obs_sources(scale)
    d = BUILD_DIR / "obs_cli"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    trace_path = d / "cli_trace.json"
    here = Path(__file__).resolve().parent
    prof_dir = d / "prof"
    argv = [sys.executable, "-m", "tpu_bfs_torch", str(src[0]), spec, "--multi-source",
            ",".join(map(str, src[1:])), "--engine", "hybrid", "--lanes", "4096",
            "--pull-gate", "--stats", "--trace-out", str(trace_path),
            "--profile-dir", str(prof_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=here,
                          env=dict(os.environ, PYTHONPATH=str(here)))
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    require("Output OK" in lines, "the traced CLI run did not validate")
    level_lines = [ln for ln in lines if ln.startswith('{"level"')]
    trace = [json.loads(ln[6:]) for ln in lines if ln.startswith("trace ")]
    require(len(trace) == 1 and trace[0]["levels"] == len(level_lines)
            and trace[0]["gated_tiles_total"] == sum(json.loads(ln)["gated_tiles"]
                                                    for ln in level_lines),
            f"trace line {trace} against {len(level_lines)} level lines")
    doc = json.loads(trace_path.read_text())
    rows = [e for e in doc["traceEvents"] if e.get("cat") == "engine.level"]
    require([e["args"]["level"] for e in rows] == list(range(trace[0]["levels"])),
            f"Perfetto level track: {len(rows)} rows for {trace[0]['levels']} levels")
    out = {"graph": spec, "engine": "hybrid", "lanes": 4096, "sources": len(src),
           "pull_gate": True, "seconds": cli_s, "trace": trace[0],
           "perfetto_level_rows": len(rows), "perfetto_events": len(doc["traceEvents"]),
           "profile": profile_kernels(prof_dir, ("ell_expand_kernel", "tile_spmm_kernel"))}
    shutil.rmtree(d)
    return out


def phase_obs(dev, k1, k2, ell, traversable, scale: int) -> None:
    """The operations surface (see the module docstring, phase 18); the
    traced CLI subprocess is a side arm (obs_cli)."""
    from tpu_bfs_torch import faults, obs
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.ops._build import BUILD_DIR
    from tpu_bfs_torch.utils.recovery import COUNTERS

    t_phase = time.perf_counter()
    d = BUILD_DIR / "obs"
    d.mkdir(parents=True, exist_ok=True)
    spec, src = obs_sources(scale)
    out = {"graph": spec}

    # A 256-lane gated wide batch on the flagship ELL, recorder disarmed and
    # armed in turns (an armed fetch copies the gate counters off the card).
    eng = WidePackedMsBfsEngine(ell, lanes=256, num_planes=5, pull_gate=True, device=dev)
    batch = np.random.default_rng(11).choice(traversable, 256, replace=False)
    eng.run(batch)
    reset_counts(k1, k2)
    turns = {"disarmed": [], "armed": []}
    for armed in (False, True, True, False, False, True):
        obs.arm() if armed else obs.disarm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(batch)
        torch.cuda.synchronize()
        turns["armed" if armed else "disarmed"].append((time.perf_counter() - t0) * 1e3)
    obs.disarm()
    launches = k1.ell_expand.launches
    require(launches > 0 and len(eng.last_run_trace) == res.num_levels + 1,
            f"armed batch: {launches} K1 launches, trace {len(eng.last_run_trace or ())} rows")
    med = {k: float(np.median(v)) for k, v in turns.items()}
    out["packed_overhead"] = {"lanes": 256, "pull_gate": True, "levels": res.num_levels,
                              "turns_ms": turns, "median_ms": med, "k1_launches": launches,
                              "armed_over_disarmed": med["armed"] / med["disarmed"] - 1}
    del eng, res

    # The CLI in process: a checkpointed batch under a fault schedule,
    # against the same batch unfaulted.
    base = [str(src[0]), spec, "--multi-source", ",".join(map(str, src[1:256])), "--engine",
            "wide", "--lanes", "256", "--skip-cpu"]
    COUNTERS.reset()
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    lines = run_cli(base + ["--ckpt", str(d / "ck.npz"), "--ckpt-every", "2", "--faults",
                            OBS_FAULTS, "--stats", "--save-dist", str(d / "faulted.npy")])
    faulted_s = time.perf_counter() - t0
    fired = faults.ACTIVE.counts()
    faults.disarm()
    launches = k1.ell_expand.launches
    run_cli(base + ["--save-dist", str(d / "clean.npy")])
    require(np.array_equal(np.load(d / "faulted.npy"), np.load(d / "clean.npy")),
            "the faulted checkpointed run's distances != the unfaulted run's")
    rec = [json.loads(ln)["recovery"] for ln in lines if ln.startswith('{"recovery"')]
    require(fired == {"transient": 1, "corrupt_ckpt": 1} and len(rec) == 1
            and rec[0]["transient_retries"] == 1 and rec[0]["engine_rebuilds"] == 1
            and rec[0]["faults_injected"] == 2 and launches > 0,
            f"fired {fired}, recovery {rec}, {launches} K1 launches")
    out["faulted_ckpt"] = {"spec": OBS_FAULTS, "lanes": 256, "every": 2, "seconds": faulted_s,
                           "fired": fired, "recovery": {k: v for k, v in rec[0].items() if v},
                           "recovery_log": [ln for ln in lines if ln.startswith("[recovery]")],
                           "k1_launches": launches, "distances_equal_unfaulted": True}
    shutil.rmtree(d)
    emit({"phase": "obs", **out, "seconds": time.perf_counter() - t_phase})


def _dijkstra_oracle(g, sources):
    """SciPy dijkstra over the weighted graph, duplicate slots min-folded
    (parallel edges hash to one weight, but keep the oracle honest). The
    CSR's rows, once column-sorted, hold each (row, col) run together, so
    the fold is one ``minimum.reduceat`` (the same matrix as a lexsort of
    the slots, at a third of the time)."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    m = g.to_scipy(weighted=True)
    m.sort_indices()
    m = m.tocoo()
    first = np.ones(m.nnz, bool)
    first[1:] = (m.row[1:] != m.row[:-1]) | (m.col[1:] != m.col[:-1])
    starts = np.flatnonzero(first)
    mm = sp.csr_matrix(
        (np.minimum.reduceat(m.data, starts), (m.row[starts], m.col[starts])),
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
    d = csgraph.dijkstra(oracle_matrix(g), unweighted=True, indices=sources[picks], limit=3.0)
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
    d = eng._extract_word(res._planes, res._vis, res._src_bits, eng._word(wi))
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


def k2_entry(k2, arrs, fw, prior, num_row_tiles: int, launches: int, ptxas, *, g, name: str,
             unit: str) -> dict:
    """A kernels-line entry of K2 over ``arrs``' dense tiles (built from
    graph ``g``, whose edge stream it names) against frontier
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
        "unit": unit, "ptxas": ptxas.get("tile_spmm.cu", []), "edge_stream": stream_of(g),
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
    entries = [k1_entry(k1, arrs, names, fw, "or", launches["ell_expand"], ptxas, g=g,
                        name="K1 or, mesh shard", unit="one level: every bucket of the "
                        "rank's residual shard (one rank)")]
    prior = meng._expand(arrs, fw).index_select(0, arrs["perm"])
    entries.append(k2_entry(k2, arrs, fw, prior, meng._nrt, launches["tile_spmm"], ptxas, g=g,
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
    return entries


def shared_card_rank(mesh, scale: int, lanes: int):
    """Rank entry of the shared-card check: DistHybridMsBfsEngine (dense
    exchange) at RMAT ``scale`` with the bench's hub sources; returns the
    reached counts, eccentricities and three lanes' distances."""
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine

    g = rmat(scale)
    eng = DistHybridMsBfsEngine(g, mesh, lanes=lanes)
    sources = np.random.default_rng(3).choice(np.flatnonzero(g.degrees > 0), size=lanes)
    res = eng.run(sources)
    picks = [0, lanes // 2, lanes - 1]
    return (sources, res.reached, res.ecc, [res.distances_int32(i) for i in picks],
            picks, mesh.backend, str(mesh.device))


def shared_card(dev, scale: int, ranks: int = 2) -> dict:
    """The mesh phase's side arm: several gloo ranks on the one card (NCCL
    takes one rank a device); their DistHybridMsBfsEngine run equals a
    single-device batch. Returns the phase line."""
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.parallel.mesh import start

    t0 = time.perf_counter()
    group = start(ranks, shared_card_rank, scale, 4096, device=f"cuda:{dev.index or 0}",
                  backend="gloo")
    eng = HybridMsBfsEngine(rmat(scale), lanes=4096, num_planes=5, device=dev)
    sources, reached, ecc, dists, picks, backend, where = group.result()
    mesh_s = time.perf_counter() - t0
    res = eng.run(sources)
    require(np.array_equal(reached, res.reached) and np.array_equal(ecc, res.ecc),
            "shared card: reached or ecc != single-device")
    require(all(np.array_equal(d, res.distances_int32(i)) for d, i in zip(dists, picks)),
            "shared card: distances != single-device")
    return {"phase": "mesh", "shared_card": True, "ranks": ranks, "backend": backend,
            "device": where, "scale": scale, "lanes": 4096, "seconds": mesh_s,
            "validated_lanes": picks}


def phase_sssp(dev, k1, k2, g, traversable, ptxas):
    """SSSP at 256 lanes on the flagship graph with edge_weights(seed=1,
    wmax=8) attached (the JAX bench's kinds graph): a warm batch with CUDA
    events around every K1 launch, then a timed batch; 2 lanes (3 before
    the adaptive phase) against
    SciPy's dijkstra. Returns the "K1 minplus, sssp w 256" kernels entry,
    K1 on the engine's own light-plane tables and the run's distances, and
    held bit for bit against its twin on the heavy close's plane too; and
    what the mesh_kinds phase reuses: the weighted graph, the sources, the
    engine, its batch, the checked lanes and SciPy's rows of them."""
    from tpu_bfs_torch.graph.generate import edge_weights
    from tpu_bfs_torch.workloads.sssp import INF_W, SsspEngine

    t0 = time.perf_counter()
    gw = tagged(dataclasses.replace(g, weights=edge_weights(*g.coo, seed=1, wmax=8)),
                stream_of(g))
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
    picks = [0, 255]
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
                     g=gw, wsuf="wl", name="K1 minplus, sssp w 256",
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
    nc, lbl = csgraph.connected_components(oracle_matrix(g), directed=False)
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
    depth = []
    for i in range(4):
        d = scipy_bfs(g, int(s[i]))
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
    from tpu_bfs_torch.graph.generate import edge_weights

    g = rmat(scale)
    gw = dataclasses.replace(g, weights=edge_weights(*g.coo, seed=1, wmax=8))
    src = np.random.default_rng(7).choice(np.flatnonzero(g.degrees > 0), size=256,
                                          replace=False)
    return g, gw, src


def phase_mesh_kinds(dev, k1, k2, g, sssp, flagship_sources, khop_reached, cc, p2p,
                     ptxas) -> dict:
    """Every workload kind on a one-rank NCCL group on cuda:0 at the
    flagship's full size (see the module docstring, phase 16; gloo ranks
    sharing the card are a side arm, shared_card_kinds). Returns the "K1
    minplus, mesh shard, w 256" kernels entry."""
    from tpu_bfs_torch.graph.ell import build_ell_sharded, build_ell_weights_sharded
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.parallel.mesh import close_mesh, make_mesh
    from tpu_bfs_torch.workloads.cc import connected_components
    from tpu_bfs_torch.workloads.khop import KhopServeEngine
    from tpu_bfs_torch.workloads.p2p import P2pServeEngine

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
                             ptxas, g=gw, wsuf="wl", name="K1 minplus, mesh shard, w 256",
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
          "validated": "sssp: every lane = SsspEngine's, 2 lanes = dijkstra; cc labels, khop "
                       "reached and p2p answers = the single-device phases'; every p2p path "
                       "walked", "seconds": time.perf_counter() - t_phase})
    return entry


def shared_card_kinds(dev, small_scale: int) -> dict:
    """The mesh_kinds phase's side arm: two gloo ranks sharing the card,
    correctness only (see the module docstring, phase 16). Returns the
    phase line."""
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.parallel.mesh import start
    from tpu_bfs_torch.workloads.khop import KhopServeEngine
    from tpu_bfs_torch.workloads.sssp import SsspEngine

    t0 = time.perf_counter()
    group = start(2, shared_card_kinds_rank, small_scale, device=f"cuda:{dev.index or 0}",
                  backend="gloo")
    g2, gw2, src2 = shared_kinds_inputs(small_scale)
    want = SsspEngine(gw2, lanes=64, device=dev).run(src2[:64])
    bfs = BfsEngine(g2, device=dev)
    kw = KhopServeEngine(WidePackedMsBfsEngine(g2, lanes=256, device=dev)).run(src2, k=3)
    dists, rounds, trees, reached, backend, where = group.result()
    mesh_s = time.perf_counter() - t0
    require(rounds == want.rounds and all(
        np.array_equal(d, want.distances_int32(i)) for i, d in enumerate(dists)),
        "shared card: DistSsspEngine != SsspEngine")
    for s0, (dist, parent) in trees.items():
        r = bfs.run(s0)
        require(np.array_equal(dist, r.distance) and np.array_equal(parent, r.parent),
                f"shared card: DistBfsEngine planner from {s0} != BfsEngine")
    require(np.array_equal(reached, kw.reached), "shared card: mesh khop != wide khop")
    return {"phase": "mesh_kinds", "shared_card": True, "ranks": 2, "backend": backend,
            "device": where, "scale": small_scale, "seconds": mesh_s,
            "equal_to": "SsspEngine (64 lanes), BfsEngine (3 sources, trees), "
                        "WidePackedMsBfsEngine k-hop (256 lanes)"}


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
    word = eng._extract_word(res._planes, res._vis, res._src_bits, eng._word(0))
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
    from tpu_bfs_torch.serve import BfsService

    picks = np.random.default_rng(7).choice(
        traversable, size=(SERVE_CLIENTS, SERVE_PER_CLIENT), replace=False)
    from tpu_bfs_torch import obs

    out, direct, aot_b = {}, None, None
    # The unpipelined loop in turns, eager, preheated, eager, on the same
    # picks: the preheated service against the eager one like for like.
    for key in ("pipelined", "unpipelined", "unpipelined_preheated", "unpipelined_again"):
        pipeline, preheated = key == "pipelined", key == "unpipelined_preheated"
        rows = picks if pipeline else picks[:, :SERVE_SHORT_PER_CLIENT]
        use_reg, preheat = reg, contextlib.nullcontext()
        if preheated:
            # The aot phase's (b): a fresh registry preheated from the
            # warmed one's exported rungs, with torch.export.export made to
            # raise.
            t_b = time.perf_counter()
            use_reg, store, root, fields = aot_serve_export(dev, reg)
            rec, preheat = obs.arm(capacity=4096), no_export_trace()
        t0 = time.perf_counter()
        try:
            with preheat:
                svc = BfsService(g, engine="wide", lanes=256, width_ladder="auto",
                                 pipeline=pipeline, linger_ms=2.0, queue_cap=1024,
                                 registry=use_reg, device=dev)
        finally:
            if preheated:
                spans = rec.counts_by_name()
                obs.disarm()
        up_s = time.perf_counter() - t0
        if preheated:
            aot_b = aot_serve_check(use_reg, store, spans, fields)
            aot_b["service_up_s"] = up_s
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts(k1, k2)
        flat, seconds = closed_loop(svc, rows)
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
        compared = same_as_direct(flat, direct, f"serve loop ({key})", sample=8)
        for r in [r for r in flat if r.distances is not None][:3]:
            require(np.array_equal(r.distances, scipy_bfs(g, r.source)),
                    f"serve loop ({key}): source {r.source} != SciPy")
        if preheated:
            aot_b.update(qps=len(flat) / seconds, queries=len(flat),
                         seconds=time.perf_counter() - t_b)
            del use_reg
            shutil.rmtree(root, ignore_errors=True)
        out[key] = {
            "service_up_s": up_s, "queries": len(flat), "seconds": seconds,
            "qps": len(flat) / seconds, "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
            "fill_ratio": snap["fill_ratio"], "routing": snap["routing"],
            "batches": snap["batches"], "extract_p50_ms": snap["extract_p50_ms"],
            "peak_above_start_gb": peak_gb, "launches": launches,
            "rows_equal_direct": compared, "rows_equal_scipy": 3,
        }
    eager_qps = [out[k]["qps"] for k in ("unpipelined", "unpipelined_again")]
    aot_b.update(qps_eager_unpipelined=eager_qps,
                 preheated_over_eager=aot_b["qps"] / (sum(eager_qps) / 2) - 1)
    out["audited"] = serve_audited(dev, k1, k2, g, reg, picks[:, :SERVE_SHORT_PER_CLIENT],
                                   direct, out["pipelined"])
    out["ladder"] = [32, 64, 256]
    out["rung_build_s"] = {str(s.lanes): reg.build_s[s] for s in reg.build_s if s.kind == "bfs"}
    out["rung_warm_s"] = {str(s.lanes): reg.warm_s[s] for s in reg.warm_s if s.kind == "bfs"}
    out["dispatch_host_reads"] = reads
    out["seed_host_reads"] = seed_reads
    out["dispatch_levels"] = levels
    # The level loop's reads: one a level body (levels + 1 bodies).
    out["host_reads_per_level"] = (reads - seed_reads) / (levels + 1)
    out["extract_split_one_word"] = split
    out["aot_b"] = aot_b
    return out, picks, direct


def serve_audited(dev, k1, k2, g, reg, picks, direct, plain) -> dict:
    """The integrity arm (a): the flagship closed loop once more, pipelined,
    with every audit knob on. Zero findings and audit errors, every answer
    equal to the direct batches; its QPS and p50 beside ``plain`` (the
    unaudited pipelined loop) and the structural audit's own time."""
    from tpu_bfs_torch.serve import BfsService

    t0 = time.perf_counter()
    svc = BfsService(g, engine="wide", lanes=256, width_ladder="auto", pipeline=True,
                     linger_ms=2.0, queue_cap=1024, registry=reg, device=dev,
                     audit_rate=0.1, audit_structural=True, audit_checksum=True)
    up_s = time.perf_counter() - t0
    # Time each structural audit inside the loop (host clock, on the
    # extraction worker) and note the stream it ran on: the worker's side
    # stream, never the default stream that dispatches the next batch.
    aud = svc._integrity._structural
    audit, in_loop = aud.audit, []

    def timed_audit(kind, r):
        side = torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev)
        t1 = time.perf_counter()
        try:
            return audit(kind, r)
        finally:
            in_loop.append(((time.perf_counter() - t1) * 1e3, side))

    aud.audit = timed_audit
    try:
        reset_counts(k1, k2)
        flat, seconds = closed_loop(svc, picks)
        launches = k1.ell_expand.launches
        require(svc.flush_audits(600), "the audits did not drain")
        snap = svc.statsz()
        aud.audit = audit
        require(in_loop and all(side for _, side in in_loop),
                f"structural audits off the extraction stream: {in_loop}")
        # The structural audit of one served answer alone, outside the loop
        # (host copy to the card, the checksum folds, the level check over
        # every edge slot).
        row = next(r for r in flat if r.distances is not None)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            aud.audit("bfs", row)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        dist = torch.from_numpy(row.distances).to(dev)
        check_ms = cuda_ms(lambda: aud.violations("bfs", dist), 3)
    finally:
        svc.close()
    require(launches > 0, "the audited loop launched no K1")
    require(snap["audits_run"] > 0 and snap["audit_failures"] == 0
            and snap["audit_errors"] == 0 and snap["quarantines"] == 0,
            f"clean audited loop: {snap}")
    require(snap["completed"] == len(flat) and snap["errors"] == 0, f"statsz {snap}")
    same_as_direct(flat, direct, "audited loop", sample=4)
    return {"audit_rate": 0.1, "structural": True, "checksum": True, "service_up_s": up_s,
            "queries": len(flat), "seconds": seconds, "qps": len(flat) / seconds,
            "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
            "unaudited_qps": plain["qps"], "unaudited_p50_ms": plain["p50_ms"],
            "audits_run": snap["audits_run"], "audit_failures": snap["audit_failures"],
            "audit_errors": snap["audit_errors"], "audit_dropped": snap["audit_dropped"],
            "audit_p50_lag_ms": snap["audit_p50_lag_ms"],
            "structural_audits_in_loop": len(in_loop),
            "structural_audit_in_loop_ms": sorted(round(t, 2) for t, _ in in_loop),
            "structural_audit_alone_ms": ms,
            "level_check_ms": check_ms, "edge_slots": int(g.num_edges), "k1_launches": launches}


def serve_corruption(dev, k1, k2, scale: int) -> dict:
    """The integrity arm (b) at RMAT ``scale``: corrupt_result caught by the
    shadow replay on the other rung (one finding, one quarantine, a flight
    dump naming the query, every later answer equal to SciPy's), then
    corrupt_wire caught by the checksum of the audited row's copy."""
    from tpu_bfs_torch import faults, obs
    from tpu_bfs_torch.ops._build import BUILD_DIR
    from tpu_bfs_torch.serve import BfsService, EngineRegistry

    g = rmat(scale)
    live = np.flatnonzero(g.degrees > 0)
    src = [int(x) for x in np.random.default_rng(5).choice(live, 10, replace=False)]
    reg = EngineRegistry(capacity=8, device=dev)
    dump = BUILD_DIR / "flight"
    shutil.rmtree(dump, ignore_errors=True)
    dump.mkdir(parents=True)
    out = {"scale": scale, "scale_cut": f"scale {scale}, not the flagship's 21: the clean "
                                        "audited loop runs at 21"}
    for name, spec, kw in (
            ("corrupt_result", "seed=5:corrupt_result:n=1", dict(audit_rate=1.0)),
            ("corrupt_wire", "seed=2:corrupt_wire:n=1",
             dict(audit_structural=True, audit_checksum=True))):
        logs = []
        t0 = time.perf_counter()
        rec = obs.arm(dump_dir=str(dump), window_s=120)
        svc = BfsService(g, engine="wide", lanes=256, width_ladder="auto", registry=reg,
                         device=dev, log=logs.append, **kw)
        try:
            faults.arm_from_spec(spec)
            reset_counts(k1, k2)
            first = svc.submit(src[0], id=f"{name}-0").result(600)
            require(svc.flush_audits(600), "the audits did not drain")
            fired = faults.ACTIVE.counts()
            faults.disarm()
            snap = svc.statsz()
            later = [svc.submit(s, id=f"{name}-{i}").result(600)
                     for i, s in enumerate(src[1:], 1)]
            require(svc.flush_audits(600), "the audits did not drain")
            after = svc.statsz()
        finally:
            faults.disarm()
            svc.close()
            obs.disarm()
        launches = k1.ell_expand.launches
        require(fired == {name: 1} and launches > 0, f"{name}: fired {fired}, {launches} K1")
        require(snap["audit_failures"] == 1 and snap["quarantines"] == 1 and snap["breaker_open"],
                f"{name}: {snap}")
        require(after["audit_failures"] == 1 and after["quarantines"] == 1,
                f"{name}: findings after the quarantine: {after}")
        for r in later:
            require(r.ok and np.array_equal(r.distances, scipy_bfs(g, r.source)),
                    f"{name}: a later answer ({r.source}) != SciPy")
        entry = {"spec": spec, **kw, "fired": fired, "audit_failures": snap["audit_failures"],
                 "quarantines": snap["quarantines"], "breaker_open": snap["breaker_open"],
                 "later_answers_equal_scipy": len(later), "audits_run": after["audits_run"],
                 "seconds": time.perf_counter() - t0}
        if name == "corrupt_result":
            require(not np.array_equal(first.distances, scipy_bfs(g, src[0])),
                    "the corrupted answer equals SciPy's")
            dumped = "\n".join(p.read_text() for p in sorted(dump.glob("*.jsonl")))
            require('"corruption"' in dumped and f'"{name}-0"' in dumped,
                    "no flight dump names the corrupted query")
            entry["flight_dumps"] = len(list(dump.glob("*.jsonl")))
        else:
            require(any("wire checksum mismatch" in m for m in logs),
                    "corrupt_wire: no checksum finding in the log")
            entry["finding"] = next(m for m in logs if "wire checksum mismatch" in m)[:200]
        out[name] = entry
        del rec
    shutil.rmtree(dump)
    return out


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
    entry = k1_entry(k1, eng.arrs, names, run._vis, "or", launches, ptxas, plain_reps=2, g=g,
                     name="K1 or, serve rung w 2",
                     unit="one level of the serve ladder's 64-lane rung: every bucket "
                          "of the full ELL, w 2, the batch's visited table")
    entry["launches_per"] = "one 48-query batch served at the 64-lane rung"
    return entry, {"batch_queries": 48, "routing": snap["routing"], "k1_launches": launches,
                   "levels": run.num_levels, "buckets": len(names)}


def serve_jsonl(dev) -> tuple[dict, dict]:
    """``python -m tpu_bfs_torch.serve`` on RMAT 16 as a subprocess, one
    256-lane rung (``--ladder off``), with ``--export-aot``: three queries
    (one distance-free), a malformed line and an out-of-range source; the
    lines equal the expected ones (the CPU parity test's forms) and the
    distances decode and equal the engine's. Then the aot phase's (d): a
    ``--preheat`` successor started through ``tools.warm_handoff``, READY
    with artifact hits and no fallback, after which the handoff SIGTERMs the
    first server, which drains with a final statsz line and exit code 0; the
    successor answers the same lines bit for bit and exits 0 at EOF. And
    (c), in process on a copy of that store. Returns (the serve line's
    fields, the aot line's)."""
    import threading

    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.cli import load_graph
    from tpu_bfs_torch.ops._build import BUILD_DIR
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
    xprof, store = BUILD_DIR / "serve_xprof", BUILD_DIR / "aot_jsonl"
    for d in (xprof, store):
        shutil.rmtree(d, ignore_errors=True)
    server = [sys.executable, "-m", "tpu_bfs_torch.serve", spec, "--lanes", "256",
              "--ladder", "off", "--device", str(dev), "--statsz-interval-s", "0"]
    popen = dict(stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                 text=True, cwd=here, env=dict(os.environ, PYTHONPATH=str(here)))
    t0 = time.perf_counter()
    proc = subprocess.Popen(server + ["--xprof-dir", str(xprof), "--export-aot", str(store)],
                            **popen)
    hand, hand_err, sigterm = None, [], threading.Event()

    def watch(stream):
        for line in stream:
            hand_err.append(line)
            if "SIGTERM -> old server" in line:
                sigterm.set()

    killers = [threading.Timer(420, proc.kill)]
    killers[0].start()
    fleet_pool, fleet_f = ThreadPoolExecutor(1), None
    try:
        proc.stdin.write("\n".join(lines) + "\n")
        proc.stdin.flush()
        got = [json.loads(proc.stdout.readline()) for _ in lines]
        answered_s = time.perf_counter() - t0
        # The fleet arm beside (d): both only read the store the first
        # server exported before it answered.
        fleet_f = fleet_pool.submit(serve_fleet, dev, eng, server, store,
                                    [dict(r) for r in got], lines)
        # (d) The warm handoff: the successor preheats from the first
        # server's store; the handoff drains the first server only once the
        # successor is READY.
        t_d = time.perf_counter()
        hand = subprocess.Popen(
            [sys.executable, "-m", "tpu_bfs_torch.tools.warm_handoff", "--old-pid",
             str(proc.pid), "--ready-timeout", "300", "--term-wait", "120", "--", *server,
             "--preheat", str(store)], **popen)
        killers.append(threading.Timer(420, hand.kill))
        killers[-1].start()
        watcher = threading.Thread(target=watch, args=(hand.stderr,), daemon=True)
        watcher.start()
        require(sigterm.wait(360), "the handoff never drained the first server: "
                + "".join(hand_err)[-2000:])
        _, err = proc.communicate(timeout=120)
        hand.stdin.write("\n".join(lines) + "\n")
        hand.stdin.flush()
        got2 = [json.loads(hand.stdout.readline()) for _ in lines]
        hand.stdin.close()
        tail = hand.stdout.read()
        hand.wait(timeout=120)
        watcher.join(timeout=30)
        handoff_s = time.perf_counter() - t_d
    finally:
        for k in killers:
            k.cancel()
        for p in (proc, hand):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        fleet_pool.shutdown(wait=True)  # the fleet closes its replicas itself
    require(proc.returncode == 0, f"serve subprocess exited {proc.returncode}: {err[-2000:]}")
    require("SIGTERM received: draining" in err, "no SIGTERM drain in the server's log")
    final = [ln for ln in err.splitlines() if ln.startswith("statsz ")]
    require(bool(final) and json.loads(final[-1][7:])["completed"] == 3, "final statsz line")
    exported = [ln for ln in err.splitlines() if "aot export -> " in ln]
    require(bool(exported) and "5 programs from 1 engines" in exported[0],
            f"the first server's export: {exported}")
    for r in got + got2:
        r.pop("latency_ms", None)
    by_id = {r.get("id"): r for r in got}
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
    require("torch.profiler trace stopped" in err, "the server did not stop its profiler")
    profile = profile_kernels(xprof, ("ell_expand_kernel",))
    shutil.rmtree(xprof)
    # (d)'s checks: the successor's READY, its answers, the handoff's record.
    hand_log = "".join(hand_err)
    ready = [ln.strip() for ln in hand_log.splitlines() if "READY engine=" in ln]
    m = re.search(r"aot_hits=(\d+) aot_fallbacks=(\d+)", ready[0]) if ready else None
    require(m is not None and int(m.group(1)) > 0 and int(m.group(2)) == 0,
            f"the successor's READY line: {ready}")
    require(got2 == got, "the preheated successor's answers != the first server's")
    record = json.loads(tail.strip().splitlines()[-1])
    require(hand.returncode == 0 and record["successor_rc"] == 0 and record["old_drained"],
            f"warm handoff rc {hand.returncode}: {record}")
    aot_d = {"arm": "d", "graph": spec, "ready_line": ready[0],
             "successor_ready_s": record["value"], "handoff_s": handoff_s,
             "answers_equal": len(got2), "old_server": "SIGTERM after READY, drained, exit 0"}
    aot_c = aot_corrupt_arm(dev, spec, store, want, (0, 5, 9))
    fleet = fleet_f.result()
    shutil.rmtree(store, ignore_errors=True)
    return ({"graph": spec, "V": v, "lines": len(lines), "answered_s": answered_s,
             "drain": "SIGTERM (the warm handoff), final statsz, exit 0", "xprof": profile},
            {"c": aot_c, "d": aot_d, "fleet": fleet})


def serve_fleet(dev, eng, server, store, one_shot, lines) -> dict:
    """The aot phase's fleet arm, on (d)'s graph and store:
    ``tools.fleet_supervisor`` over 2 ``--preheat`` replicas of the JSONL
    server on the card. FLEET_QUERIES queries, one replica SIGKILLed once
    half of them are submitted (its unanswered ones requeue onto the
    sibling): every query answered exactly once, the JSON lines among them
    equal to the first server's one-shot answers, the rest's reached and
    levels equal to the 32-lane engine's; one restart, the replacement
    READY-gated; each replica's seconds to READY."""
    from tpu_bfs_torch.tools.fleet_supervisor import FleetSupervisor

    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    queries = [json.loads(ln) for ln in lines if ln.startswith("{")]
    shown = {q["id"] for q in queries}
    rng = np.random.default_rng(17)
    extra = rng.choice(eng.ell.num_vertices, FLEET_QUERIES - len(queries), replace=False)
    queries += [{"id": f"x{i}", "source": int(s), "want_distances": False}
                for i, s in enumerate(extra)]
    direct = eng.run(extra)
    responses, logs = [], []
    fleet = FleetSupervisor(["env", f"PYTHONPATH={here}", *server, "--preheat", str(store)],
                            replicas=2, ready_timeout=300.0, term_wait=60.0,
                            emit=responses.append, log=logs.append)
    try:
        fleet.start()
        half = len(queries) // 2
        for q in queries[:half]:
            fleet.submit(q)
        first = list(fleet._replicas)
        victim = first[0]
        victim.proc.kill()  # SIGKILL, its queries in flight
        for q in queries[half:]:
            fleet.submit(q)
        require(fleet.wait_drained(300.0), "the fleet left queries unanswered: "
                + " | ".join(logs[-10:]))
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline and not (
                fleet.restarts == 1
                and sum(r.ready.is_set() and r.alive() for r in fleet._replicas) == 2):
            time.sleep(0.1)
        replacement = [r for r in fleet._replicas if r not in first and r.ready_s is not None]
        summary = fleet.summary()
    finally:
        fleet.close()
    require(summary["restarts"] == 1 and len(replacement) == 1,
            f"fleet restarts {summary}; " + " | ".join(logs[-10:]))
    ids = [r.get("id") for r in responses]
    require(len(ids) == len(queries) and len(set(map(str, ids))) == len(queries),
            f"fleet: {len(ids)} responses for {len(queries)} queries, not exactly once")
    require(summary["served"] == len(queries) and summary["failed"] == 0,
            f"fleet summary {summary}")
    by_id = {r["id"]: dict(r) for r in responses}
    for r in list(by_id.values()) + list(one_shot):
        for key in ("latency_ms", "batch_lanes"):  # the batch it rode in, not the answer
            r.pop(key, None)
    for r in one_shot:
        if r.get("id") in shown:
            require(by_id[r["id"]] == r, f"fleet answer {r['id']} != the one-shot answer")
    for i in range(len(extra)):
        r = by_id[f"x{i}"]
        require(r["status"] == "ok" and (r["reached"], r["levels"])
                == (int(direct.reached[i]), int(direct.ecc[i])),
                f"fleet query x{i}: {r} != the engine's")
    return {"replicas": 2, "queries": len(queries), "killed": "SIGKILL, queries in flight",
            "requeues": summary["requeues"], "restarts": summary["restarts"],
            "served": summary["served"], "failed": summary["failed"],
            "first_ready_s": sorted(r.ready_s for r in first), "replacement_ready_s": replacement[0].ready_s,
            "one_shot_equal": len(shown), "engine_equal": len(extra),
            "seconds": time.perf_counter() - t0}


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
    from tpu_bfs_torch.graph.generate import edge_weights
    from tpu_bfs_torch.serve import BfsService, EngineRegistry

    g = rmat(scale)
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
        eng = reg.get(svc._spec(widths.pop(), kind=kind))
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
    want = int(scipy_bfs(g, lm)[src[1]])
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


def phase_serve(dev, k1, k2, g, traversable, wide_scale: int, ptxas) -> tuple:
    """The serve tier in this process (see the module docstring, phase 17;
    its JSONL act is a side arm). Returns the "K1 or, serve rung w 2"
    kernels entry and the aot phase's (b)."""
    from tpu_bfs_torch.serve import EngineRegistry

    t_phase = time.perf_counter()
    reg = EngineRegistry(capacity=8, device=dev)
    loop, picks, direct = serve_flagship(dev, k1, k2, g, traversable, reg)
    aot_b = loop.pop("aot_b")
    entry, w2 = serve_w2_batch(dev, k1, k2, g, reg, picks, direct, ptxas)
    chaos = serve_chaos(dev, g, reg, picks, direct)
    del reg, direct
    gc.collect()
    torch.cuda.empty_cache()
    integrity = serve_corruption(dev, k1, k2, wide_scale)
    emit({"phase": "serve", "graph": "the flagship graph", "engine": "wide",
          "lanes": 256, "clients": SERVE_CLIENTS, "queries_per_client": SERVE_PER_CLIENT,
          **loop, "w2_batch": w2, "chaos": chaos, "integrity": integrity,
          "seconds": time.perf_counter() - t_phase})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kinds = serve_kinds(dev, k1, k2, wide_scale)
    kinds["seconds"] = time.perf_counter() - t0
    # The JSONL act (with the aot phase's (c), (d) and fleet arm) is a side arm.
    emit({"phase": "serve", "small": kinds, "phase_seconds": time.perf_counter() - t_phase})
    gc.collect()
    torch.cuda.empty_cache()
    return entry, aot_b


def phase_side(dev, wide_scale: int, kinds_scale: int) -> dict:
    """The side arms, each driving processes of its own (servers, a CLI,
    gloo ranks), run side by side in threads while this process's own
    phases wait, so no kernel timing of theirs overlaps them: the serve
    phase's JSONL act with the aot phase's (c), (d) and fleet arm
    (serve_jsonl), the obs phase's traced CLI (obs_cli), the mesh_serve
    phase's (d) (mesh_serve_jsonl) and the gloo ranks sharing the card of
    the mesh, mesh_single and mesh_kinds phases. One line each, in that
    order; the seconds of every arm run beside the others (their ready and
    answer times include the shared host). Returns the aot arms (c), (d) and
    fleet."""
    def yielding(fn):
        def run():
            # The JSONL act is the longest chain (three process starts one
            # after another): this arm's thread, and the processes it starts,
            # take the cores it leaves (Linux sets a thread's nice value).
            os.nice(10)
            return fn()
        return run

    t0 = time.perf_counter()
    arms = {
        "jsonl": lambda: serve_jsonl(dev),
        "obs_cli": yielding(lambda: obs_cli(wide_scale)),
        "mesh_serve_jsonl": yielding(lambda: mesh_serve_jsonl(dev)),
        "shared_card": yielding(lambda: shared_card(dev, wide_scale)),
        "shared_card_single": yielding(lambda: shared_card_single(dev, wide_scale)),
        "shared_card_kinds": yielding(lambda: shared_card_kinds(dev, kinds_scale)),
    }

    def timed(fn):
        t1 = time.perf_counter()
        return fn(), time.perf_counter() - t1

    with ThreadPoolExecutor(len(arms)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in arms.items()}
        # Every arm ends (its own timeouts bound it) before a failure is raised.
        done = {name: f.exception() or f.result() for name, f in futures.items()}
    failed = [(name, x) for name, x in done.items() if isinstance(x, BaseException)]
    if failed:
        raise failed[0][1]
    seconds = time.perf_counter() - t0
    side = {"arms_seconds": {name: x[1] for name, x in done.items()}, "seconds": seconds}
    (jsonl, aot_cd), _ = done["jsonl"]
    emit({"phase": "serve", "jsonl": {**jsonl, "seconds": done["jsonl"][1]}, "side": side})
    emit({"phase": "obs", "cli": done["obs_cli"][0], "side": side})
    emit({"phase": "mesh_serve", **done["mesh_serve_jsonl"][0], "side": side})
    for name in ("shared_card", "shared_card_single", "shared_card_kinds"):
        emit({**done[name][0], "side": side})
    return aot_cd


# --- the aot phase --------------------------------------------------------------


AOT_NAMES = ["core", "seed", "lane_stats", "extract_word", "lane_ecc"]


def no_export_trace():
    """A context in which ``torch.export.export`` raises: a preheated
    process must load its programs, never trace them."""

    @contextlib.contextmanager
    def ctx():
        real = torch.export.export

        def refuse(*a, **k):
            raise AssertionError("torch.export.export called on the preheated path")

        torch.export.export = refuse
        try:
            yield
        finally:
            torch.export.export = real

    return ctx()


def aot_flagship(dev, k1, k2, eng, sources, flagship_entries) -> tuple[dict, list]:
    """(a) The flagship's programs exported, adopted on the same engine (its
    own tables), then the adopted and the eager batch in turns (eager,
    adopted, adopted, eager): state equal on the device bit for bit, K1 and
    K2 launches equal, the adopted graph naming both kernel ops and no
    copy over a state table. Each export's seconds and artifact's bytes.
    Returns the phase line's fields and the "adopted flagship" kernels
    entries: K1 and K2 timed through the registered ops, the route the
    adopted graph takes, on the kernels phase's operands."""
    from tpu_bfs_torch.ops._build import BUILD_DIR
    from tpu_bfs_torch.utils import aot

    t_arm = time.perf_counter()
    root = BUILD_DIR / "aot_flagship"
    shutil.rmtree(root, ignore_errors=True)
    store = aot.ArtifactStore(root)
    spec = {"graph_key": "rmat:scale=21,ef=16,seed=1,impl=native", "engine": "hybrid",
            "lanes": eng.lanes, "planes": eng.num_planes}
    inventory = eng.export_programs()
    require([n for n, *_ in inventory] == AOT_NAMES, f"inventory {inventory}")
    export_s, nbytes = {}, {}
    for name, _attr, fn, args in inventory:
        t0 = time.perf_counter()
        path = store.put(spec, name, aot.serialize_program(aot.export_program(fn, args)),
                         layout=aot.layout_digest(eng))
        export_s[name] = time.perf_counter() - t0
        nbytes[name] = os.path.getsize(path)
    eager = {attr: getattr(eng, attr) for _, attr, _, _ in inventory}
    t0 = time.perf_counter()
    with no_export_trace():
        got = aot.adopt_engine_programs(eng, spec, store)
    adopt_s = time.perf_counter() - t0
    require(got == AOT_NAMES, f"adopted {got}")
    adopted = {attr: getattr(eng, attr) for _, attr, _, _ in inventory}
    targets = eng._step.graph_targets()
    require("tpu_bfs_torch.ell_expand.default" in targets
            and "tpu_bfs_torch.tile_spmm.default" in targets,
            f"the adopted core names {sorted(set(targets))}")
    require(not any("copy" in t for t in targets), "the adopted core copies a table")

    def use(progs):
        for attr, fn in progs.items():
            setattr(eng, attr, fn)

    turns = {"eager": [], "adopted": []}
    try:
        for which in ("eager", "adopted", "adopted", "eager"):
            use(eager if which == "eager" else adopted)
            turns[which].append(timed_batch(k1, k2, eng, sources))
            if len(turns[which]) > 1:
                del turns[which][-1]["res"]
        re_, ra = turns["eager"][0].pop("res"), turns["adopted"][0].pop("res")
        same_state(ra, re_, "adopted flagship against the eager one")
        require(ra.num_levels == re_.num_levels and np.array_equal(ra.reached, re_.reached)
                and np.array_equal(ra.ecc, re_.ecc), "adopted levels, reached or ecc differ")
        for t in turns["adopted"] + turns["eager"]:
            require((t["ell_expand"], t["tile_spmm"]) == (turns["eager"][0]["ell_expand"],
                                                           turns["eager"][0]["tile_spmm"]),
                    f"launches differ across turns: {turns}")
        step = adopted["_step"]
        require(step.calls >= 2 * (ra.num_levels + 1) and step.fallback_calls == 0,
                f"adopted core ran {step.calls} times, {step.fallback_calls} fell back")
        # K1 and K2 through the registered ops, the adopted graph's route.
        arrs, hg = eng.arrs, eng.hg
        names = (["virtual"] if hg.res_heavy else []) + [f"light{i}" for i in range(len(hg.res_light))]
        fw, prior = flagship_operands(eng, re_)
        saved = (k1.ell_expand.launches, k2.tile_spmm.launches)
        op1, op2 = torch.ops.tpu_bfs_torch.ell_expand, torch.ops.tpu_bfs_torch.tile_spmm

        def k1_level(fn):
            return [fn(arrs[f"{n}_need"], arrs[f"{n}_gt"], fw, None, "or") for n in names]

        got1 = k1_level(op1)
        want1 = [k1.ell_expand_plain(arrs[f"{n}_need"], arrs[f"{n}_gt"], fw) for n in names]
        buf = prior.clone()

        def k2_pass():
            op2(arrs["row_start"], arrs["col_tile"], arrs["a_masks"], fw, buf, hg.vt)

        k2_pass()
        want2 = prior | k2.tile_spmm_plain(arrs["row_start"], arrs["col_tile"], None, fw,
                                           num_row_tiles=hg.vt, masks=arrs["a_masks"])
        torch.cuda.synchronize()
        err1 = max(max_abs_err(a, b) for a, b in zip(got1, want1))
        err2 = max_abs_err(buf, want2)
        require(err1 == 0 and err2 == 0, f"registered ops != twins ({err1}, {err2})")
        del got1, want1, want2
        k1_ms, k2_ms = cuda_ms(lambda: k1_level(op1), 5), cuda_ms(k2_pass, 5)
        host = step_host_ms(eng, eager["_step"], adopted["_step"], sources)
        k1.ell_expand.launches, k2.tile_spmm.launches = saved  # comparisons do not count
        del fw, prior, buf, re_, ra
    finally:
        use(eager)
    gc.collect()
    torch.cuda.empty_cache()
    k1e, k2e = flagship_entries
    ad = turns["adopted"][0]
    entries = [
        dict(k1e, name=f"K1 or, adopted flagship (AOT core), w {eng.w}",
             launches=ad["ell_expand"], max_abs_err=err1, ms=k1_ms,
             unit=k1e["unit"] + ", through the registered op"),
        dict(k2e, name="K2, adopted flagship (AOT core)", launches=ad["tile_spmm"],
             max_abs_err=err2, ms=k2_ms, unit=k2e["unit"] + ", through the registered op"),
    ]
    out = {"arm": "a", "graph": "the flagship graph", "engine": "hybrid", "lanes": eng.lanes,
           "export_s": export_s, "artifact_bytes": nbytes, "adopt_s": adopt_s,
           "turns": turns,
           "adopted_over_eager": min(t["batch_ms"] for t in turns["adopted"])
           / min(t["batch_ms"] for t in turns["eager"]) - 1,
           "core_nodes": len(targets), "kernel_ops_ms": {"k1_level": k1_ms, "k2_launch": k2_ms},
           "step_host_ms": host,
           "seconds": time.perf_counter() - t_arm}
    shutil.rmtree(root, ignore_errors=True)
    return out, entries


def step_host_ms(eng, eager, adopted, sources, turns: int = 5) -> dict:
    """Host milliseconds of one level step's call (median of ``turns``, the
    card idle before each, so the call is its enqueue): the eager step, the
    adopted one, the loaded module with its own per-call input check
    (``ExportedProgram.module()`` as it comes), and the adopted call's
    signature check alone. Each call takes fresh state tables."""
    fw0 = eng._seed_dev(np.asarray(sources, dtype=np.int64))
    full = adopted._exported.module()

    def fresh():
        return (eng.arrs, fw0, fw0.clone(),
                tuple(torch.zeros_like(fw0) for _ in range(eng.num_planes)))

    def med(fn):
        ts = []
        for _ in range(turns):
            args = fresh()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            del args
        return float(np.median(ts)) * 1e3

    args = fresh()
    require(adopted._matches(args), "the adopted core refuses the engine's own tables")
    t0 = time.perf_counter()
    for _ in range(100):
        adopted._matches(args)
    match_ms = (time.perf_counter() - t0) * 10
    del args
    return {"eager": med(eager), "adopted": med(adopted), "module_with_input_check": med(full),
            "signature_check": match_ms}


def aot_serve_export(dev, reg) -> tuple:
    """(b), first half: the warmed flagship registry's rungs exported, and a
    fresh registry over the store (its rungs adopt as a service builds
    them). Returns (the fresh registry, its store, the store root, the
    export's fields)."""
    from tpu_bfs_torch.ops._build import BUILD_DIR
    from tpu_bfs_torch.serve import EngineRegistry
    from tpu_bfs_torch.utils import aot

    root = BUILD_DIR / "aot_serve"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    exported = reg.export_resident(aot.ArtifactStore(root))
    export_s = time.perf_counter() - t0
    rungs = sorted(s.lanes for s in exported)
    require(rungs == [32, 64, 256] and all(v == AOT_NAMES for v in exported.values()),
            f"exported {exported}")
    store = aot.ArtifactStore(root)
    preg = EngineRegistry(capacity=8, device=dev, aot_store=store)
    return preg, store, root, {
        "export_s": export_s, "rungs": rungs,
        "artifact_bytes": sum(p.stat().st_size for p in root.glob("*.aot")),
        "build_s": {str(s.lanes): reg.build_s[s] for s in reg.build_s if s.kind == "bfs"}}


def aot_serve_check(preg, store, spans: dict, fields: dict) -> dict:
    """(b), second half: every rung of the preheated service adopted
    (engine_adopt spans, no engine_build), 5 hits a rung, no fallback."""
    counts = store.counts()
    rungs = fields["rungs"]
    require(spans.get("engine_adopt", 0) >= len(rungs) and not spans.get("engine_build"),
            f"preheat spans {spans}")
    require(counts["aot_hits"] == 5 * len(rungs) and counts["aot_fallbacks"] == 0
            and preg.adoptions == len(rungs), f"preheat counts {counts}")
    return dict(fields, arm="b", counts=counts, engine_adopt_events=spans["engine_adopt"],
                table_build_s={str(s.lanes): preg.build_s[s] for s in preg.build_s},
                adopt_s={str(s.lanes): preg.adopt_s[s] for s in preg.adopt_s},
                warm_s={str(s.lanes): preg.warm_s[s] for s in preg.warm_s})


def aot_corrupt_arm(dev, spec: str, store_root: Path, want, sources) -> dict:
    """(c) A copy of the JSONL act's store under corrupt_aot:n=1: the
    in-process service on the same graph quarantines one artifact, falls
    back once, adopts the rest, and answers as the engine."""
    from tpu_bfs_torch import faults
    from tpu_bfs_torch.serve import BfsService

    t0 = time.perf_counter()
    root = store_root.with_name(store_root.name + "_corrupt")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(store_root, root)
    sched = faults.arm_from_spec("corrupt_aot:n=1")
    try:
        svc = BfsService(spec, lanes=256, width_ladder="off", device=dev, aot_dir=str(root))
        try:
            counts = svc.statsz()["aot"]
            got = [svc.query(int(s), timeout=300) for s in sources]
        finally:
            svc.close()
        events = [e["site"] for e in sched.events]
    finally:
        faults.disarm()
    quarantined = sorted(p.name for p in root.glob("*.corrupt"))
    require(events == ["aot_load"] and len(quarantined) == 1, f"corrupt arm {events} {quarantined}")
    require(counts["aot_fallbacks"] == 1 and counts["aot_hits"] == 4, f"corrupt arm {counts}")
    for i, r in enumerate(got):
        require(r.ok and (r.reached, r.levels) == (int(want.reached[i]), int(want.ecc[i]))
                and np.array_equal(r.distances, want.distances_int32(i)),
                f"corrupt arm: query {i} != the engine's")
    shutil.rmtree(root, ignore_errors=True)
    return {"arm": "c", "counts": counts, "quarantined": quarantined,
            "answers_equal": len(got), "seconds": time.perf_counter() - t0}


# --- the mesh_serve phase -------------------------------------------------------


def mesh_serve_tables(rank, eng, sources):
    """Rank entry (every rank of a serving-mesh rung runs it on its replica
    of the rung's engine): a batch from ``sources`` and the replicated
    frontier table of its visited rows, gathered over the rung; for the
    hybrid engine also the residual OR its K2 launch accumulates into.
    Returns this rank's tensors."""
    res = eng.run(sources)
    if hasattr(eng, "hd"):
        fw = eng._gather(res._vis, 0)
        return fw, eng._expand(eng.arrs, fw).index_select(0, eng.arrs["perm"])
    return (eng._exchange_rows(res._vis, 0),)


def mesh_serve_wide(dev, k1, k2, ctl, g, pool, ptxas):
    """(a) BfsService(devices=2) on the wide engine, 256 lanes, ladder
    auto (64/256 at 2 ranks): JAX's bench_serve closed loop over the first
    SERVE_PER_CLIENT sources of each ``pool`` row, every answer held to a
    single-device WidePackedMsBfsEngine batch of the whole pool; then a
    MESH_SERVE_BURST-query batch on the 256-lane rung and the "K1 or, mesh
    serve rung w 8 (shard)" entry on rank 0's own tables."""
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.serve import BfsService, EngineRegistry

    reg = EngineRegistry(capacity=8, device=dev)
    t0 = time.perf_counter()
    svc = BfsService(g, engine="wide", devices=2, lanes=256, width_ladder="auto",
                     linger_ms=2.0, queue_cap=1024, registry=reg, device=dev)
    up_s = time.perf_counter() - t0
    require(svc.width_ladder == [64, 256], f"mesh ladder {svc.width_ladder}")
    reset_counts(k1, k2)
    commands = ctl.commands
    flat, seconds = closed_loop(svc, pool[:, :SERVE_PER_CLIENT])
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    commands = ctl.commands - commands
    snap = svc.statsz()
    svc.close()
    require(launches["ell_expand"] > 0 and launches["tile_spmm"] == 0,
            f"mesh serve loop launches {launches}")
    require(snap["completed"] == len(flat) and snap["errors"] == 0 and snap["devices"] == 2,
            f"statsz {snap}")
    single = WidePackedMsBfsEngine(g, lanes=256, num_planes=8, device=dev)
    direct = direct_answers(single, pool.reshape(-1))
    compared = same_as_direct(flat, direct, "mesh serve loop", sample=8)
    for r in [r for r in flat if r.distances is not None][:3]:
        require(np.array_equal(r.distances, scipy_bfs(g, r.source)),
                f"mesh serve loop: source {r.source} != SciPy")
    for r in flat:
        _, _, res, i = direct[r.source]
        require(r.devices == 2 and r.edges == int(res.edges_traversed[i])
                and r.wire_bytes and r.wire_bytes > 0,
                f"mesh serve loop: traversal record of {r.source}: {r.devices} "
                f"{r.edges} {r.wire_bytes}")
    rec = [{"source": r.source, "devices": r.devices, "edges": r.edges, "gteps": r.gteps,
            "wire_bytes": r.wire_bytes} for r in flat[:3]]
    # The closed loop's batches fit the 64-lane rung: a MESH_SERVE_BURST-query
    # batch queued before start() takes the 256-lane rung (w 8), whose K1
    # launches on rank 0's shard give the kernels entry.
    burst = BfsService(g, engine="wide", devices=2, lanes=256, width_ladder="auto",
                       registry=reg, device=dev, autostart=False)
    batch = pool.reshape(-1)[:MESH_SERVE_BURST]
    require(len(batch) == MESH_SERVE_BURST, f"a {len(batch)}-query burst")
    pend = [burst.submit(int(s)) for s in batch]
    reset_counts(k1, k2)
    burst.start()
    wide_res = [p.result(600) for p in pend]
    w8_launches = k1.ell_expand.launches
    burst_routing = burst.statsz()["routing"]
    burst.close()
    require(burst_routing == {"256": 1}, f"the {len(batch)}-query batch routed {burst_routing}")
    same_as_direct(wide_res, direct, "mesh serve w 8 batch", sample=2)
    # K1 on rank 0's shard of the 256-lane rung, its frontier the batch's
    # replicated visited table.
    rung = reg.get(svc._spec(256))
    (fw,) = ctl.build(2, mesh_serve_tables, rung, batch)._local
    eng = rung._local
    names = (["virtual"] if eng.sell.virtual is not None else []) + [
        f"light{i}" for i in range(len(eng.sell.light))]
    require(eng.w == 8 and fw.shape[1] == 8, f"the 256-lane rung has w {eng.w}")
    require(w8_launches > 0 and w8_launches % len(names) == 0,
            f"w 8 batch: {w8_launches} K1 launches over {len(names)} buckets")
    entry = k1_entry(k1, eng.arrs, names, fw, "or", w8_launches, ptxas, g=g,
                     name="K1 or, mesh serve rung w 8 (shard)",
                     unit="one level of the 2-rank serve ladder's 256-lane rung: every "
                          "bucket of rank 0's shard, w 8, the batch's visited table")
    entry["launches_per"] = (f"one {len(batch)}-query batch at the 256-lane rung "
                             f"(rank 0's launches)")
    out = {"arm": "a", "engine": "wide", "devices": 2, "lanes": 256, "ladder": [64, 256],
           "service_up_s": up_s, "queries": len(flat), "seconds": seconds,
           "qps": len(flat) / seconds, "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
           "fill_ratio": snap["fill_ratio"], "routing": snap["routing"],
           "batches": snap["batches"], "extract_p50_ms": snap["extract_p50_ms"],
           "launches_rank0": launches, "mesh_commands": commands,
           "w8_batch": {"queries": len(batch), "routing": burst_routing,
                        "k1_launches_rank0": w8_launches},
           "rows_equal_direct": compared, "rows_equal_scipy": 3,
           "traversal_record_first3": rec,
           "rung_build_s": {str(k.lanes): v for k, v in reg.build_s.items()}}
    return entry, out, reg, direct


def mesh_serve_chaos(dev, ctl, g, reg, pool, direct) -> dict:
    """(b) The (a) service under device_lost@fetch@rank=1:n=1 armed after
    start, 16 clients on ``pool``'s first rows: it degrades 2 -> 1 with no
    failed query; a probe fault holds mesh_restore(2) at 1; cleared, the
    service returns to 2 ranks and 16 clients on the next rows."""
    from tpu_bfs_torch import faults
    from tpu_bfs_torch.serve import BfsService
    from tpu_bfs_torch.utils.recovery import COUNTERS

    svc = BfsService(g, engine="wide", devices=2, lanes=256, width_ladder="auto",
                     linger_ms=2.0, registry=reg, device=dev)
    COUNTERS.reset()
    try:
        faults.arm_from_spec("device_lost@fetch@rank=1:n=1")
        t0 = time.perf_counter()
        hit, hit_s = closed_loop(svc, pool[:16])
        snap1 = svc.statsz()
        require(snap1["devices"] == 1 and snap1["mesh_faults"] == 1
                and snap1["mesh_degrades"] == 1 and snap1["errors"] == 0,
                f"chaos statsz {snap1}")
        require(all(r.devices in (None, 1) for r in hit[-4:]), "answers after the degrade")
        faults.arm_from_spec("device_lost@probe:n=8")
        held = svc.mesh_restore(2)
        require(not held and svc.statsz()["devices"] == 1, "restore passed a dead probe")
        faults.disarm()
        restored = svc.mesh_restore(2)
        require(restored and svc.statsz()["devices"] == 2, "restore after the probe cleared")
        back, back_s = closed_loop(svc, pool[16:32])
        require(all(r.devices == 2 for r in back), "answers after the restore")
        snap2 = svc.statsz()
        chaos_s = time.perf_counter() - t0
    finally:
        faults.disarm()
        svc.close()
    same_as_direct(hit + back, direct, "mesh chaos", sample=4)
    c = COUNTERS.as_dict()
    return {"arm": "b", "spec": "device_lost@fetch@rank=1:n=1", "queries": len(hit) + len(back),
            "degraded_loop_s": hit_s, "restored_loop_s": back_s, "seconds": chaos_s,
            "devices_after_fault": snap1["devices"], "mesh_faults": snap1["mesh_faults"],
            "mesh_degrades": snap1["mesh_degrades"], "restore_held_by_probe": not held,
            "devices_after_restore": snap2["devices"], "errors": snap2["errors"],
            "counters": {k: v for k, v in c.items() if v}}


def mesh_serve_dist2d(dev, ctl, g, src: int, spool: Path) -> dict:
    """(c) BfsService(engine="dist2d", devices=4 as 2x2, lanes 32,
    resume_levels=2, --resume-dir spool) under device_lost@fetch@level=2:
    the query is answered from the degraded 1x2 mesh, equal to SciPy,
    resumed from its level-2 snapshot (recompute <= 2 levels); every
    snapshot written to the spool reloads through the CRC check."""
    from tpu_bfs_torch import faults
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.resilience import resume
    from tpu_bfs_torch.serve import BfsService
    from tpu_bfs_torch.utils.checkpoint import load_checkpoint

    shutil.rmtree(spool, ignore_errors=True)
    resume.set_default_dir(str(spool))
    spooled, starts = [], []
    put, advance = resume.ResumeCache.put, Dist2DBfsEngine.advance

    def checked_put(cache, source, ckpt):  # every spool file reloads through its CRC
        put(cache, source, ckpt)
        back = load_checkpoint(cache._path(source))
        spooled.append((int(source), int(back.level),
                        bool(np.array_equal(back.distance, ckpt.distance))))

    def logged_advance(eng, ckpt, levels=None):  # rank 0's chunk starts
        starts.append((eng.mesh.num_shards, int(ckpt.source), int(ckpt.level)))
        return advance(eng, ckpt, levels)

    resume.ResumeCache.put, Dist2DBfsEngine.advance = checked_put, logged_advance
    try:
        t0 = time.perf_counter()
        svc = BfsService(g, engine="dist2d", devices=4, lanes=32, width_ladder="off",
                         resume_levels=2, linger_ms=2.0, device=dev, autostart=False)
        svc.start()
        up_s = time.perf_counter() - t0
        faults.arm_from_spec("device_lost@fetch@level=2:n=1")
        t0 = time.perf_counter()
        r = svc.query(src, timeout=900)
        query_s = time.perf_counter() - t0
        faults.disarm()
        snap = svc.statsz()
        svc.close()
    finally:
        faults.disarm()
        resume.ResumeCache.put, Dist2DBfsEngine.advance = put, advance
        resume.set_default_dir(None)
    require(r.ok and r.devices == 2, f"dist2d resume query: {r.status} {r.error} {r.devices}")
    require(np.array_equal(r.distances, scipy_bfs(g, src)), "dist2d resume answer != SciPy")
    require(snap["devices"] == 2 and snap["mesh_degrades"] == 1 and snap["errors"] == 0
            and snap["query_resumes"] >= 1, f"dist2d statsz {snap}")
    # The faulted chunk began at level 2 on the 4-rank mesh; the degraded
    # mesh's first chunk must begin there too (from the level-2 snapshot),
    # so at most that chunk's K levels run twice.
    before = [lv for n, s, lv in starts if n == 4 and s == src]
    resumed = [lv for n, s, lv in starts if n == 2 and s == src]
    mine = [e for e in spooled if e[0] == src]
    require(bool(resumed) and before[-1] == 2 and resumed[0] == before[-1],
            f"chunk starts {starts}: the degraded mesh did not resume at level 2")
    require(bool(mine) and mine[0][1] == 2 and all(ok for _, _, ok in spooled),
            f"spool files {spooled}")
    require(not list(spool.glob("q*.npz")), "a finished query left its spool file")
    return {"arm": "c", "engine": "dist2d", "mesh": "2x2", "lanes": 32, "resume_levels": 2,
            "spec": "device_lost@fetch@level=2:n=1", "source": src, "service_up_s": up_s,
            "query_s": query_s, "devices_answered": r.devices, "levels": r.levels,
            "query_resumes": snap["query_resumes"], "resume_snapshots": snap["resume_snapshots"],
            "spool_files_crc_checked": mine, "chunk_starts": {
                "four_ranks": before, "two_ranks": resumed},
            "recompute_levels_at_most": 2}


def mesh_serve_hybrid(dev, k1, k2, ctl, g, pool, ptxas):
    """(e) BfsService(engine="hybrid", devices=2, lanes 4096, ladder auto):
    MESH_SERVE_BURST of ``pool``'s sources in 64-query batches, every answer
    held to a single-device HybridMsBfsEngine batch; then the "K2, mesh
    serve rung (shard)" entry on rank 0's row tiles."""
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.serve import BfsService, EngineRegistry

    reg = EngineRegistry(capacity=4, device=dev)
    t0 = time.perf_counter()
    svc = BfsService(g, engine="hybrid", devices=2, lanes=4096, width_ladder="auto",
                     linger_ms=2.0, registry=reg, device=dev)
    up_s = time.perf_counter() - t0
    require(svc.width_ladder == [4096], f"hybrid mesh ladder {svc.width_ladder}")
    srcs = pool.reshape(-1)[:MESH_SERVE_BURST]
    nbatch = -(-len(srcs) // 64)
    reset_counts(k1, k2)
    t0 = time.perf_counter()
    flat = []
    for lo in range(0, len(srcs), 64):
        pend = [svc.submit(int(s)) for s in srcs[lo:lo + 64]]
        flat += [p.result(900) for p in pend]
    seconds = time.perf_counter() - t0
    launches = {"ell_expand": k1.ell_expand.launches, "tile_spmm": k2.tile_spmm.launches}
    snap = svc.statsz()
    svc.close()
    require(all(r.ok and r.devices == 2 for r in flat), "hybrid mesh answers")
    require(launches["tile_spmm"] > 0, f"hybrid mesh serve launches {launches}")
    single = HybridMsBfsEngine(g, lanes=4096, num_planes=8, device=dev)
    direct = direct_answers(single, srcs)
    compared = same_as_direct(flat, direct, "hybrid mesh serve", sample=3)
    rung = reg.get(svc._spec(4096))
    fw, prior = ctl.build(2, mesh_serve_tables, rung, srcs)._local
    eng = rung._local
    entry = k2_entry(k2, eng.arrs, fw, prior, eng._nrt, launches["tile_spmm"], ptxas, g=g,
                     name="K2, mesh serve rung (shard)",
                     unit="one launch on rank 0's row tiles of the 2-rank serve ladder's "
                          "4096-lane hybrid rung, out= form")
    entry["launches_per"] = (f"{len(srcs)} queries in {nbatch} batches of the 2-rank hybrid "
                             f"service (rank 0's launches)")
    del fw, prior
    return entry, {"arm": "e", "engine": "hybrid", "devices": 2, "lanes": 4096,
                   "service_up_s": up_s, "queries": len(flat), "submitted_batches": nbatch,
                   "batches": snap["batches"],
                   "seconds": seconds, "launches_rank0": launches,
                   "rows_equal_direct": compared}


def mesh_serve_jsonl(dev) -> dict:
    """(d) ``python -m tpu_bfs_torch.serve rmat:scale=16 --devices 2`` as a
    subprocess (its own two gloo ranks on the card): three queries answered
    with ``devices`` 2, then SIGTERM drains it with exit code 0."""
    import threading

    spec = "rmat:scale=16"
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_bfs_torch.serve", spec, "--lanes", "256",
         "--devices", "2", "--device", str(dev), "--statsz-interval-s", "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=here, env=dict(os.environ, PYTHONPATH=str(here)))
    killer = threading.Timer(300, proc.kill)
    killer.start()
    try:
        proc.stdin.write("".join(json.dumps({"id": i, "source": s}) + "\n"
                                 for i, s in enumerate((0, 5, 9))))
        proc.stdin.flush()
        got = [json.loads(proc.stdout.readline()) for _ in range(3)]
        answered_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0, f"mesh serve subprocess exited {proc.returncode}: "
                                  f"{err[-2000:]}")
    require("SIGTERM received: draining" in err, "no SIGTERM drain in the server's log")
    require(all(r["status"] == "ok" and r["devices"] == 2 for r in got),
            f"mesh serve subprocess answers {got}")
    final = [ln for ln in err.splitlines() if ln.startswith("statsz ")]
    stat = json.loads(final[-1][7:]) if final else {}
    require(stat.get("completed") == 3 and stat.get("devices") == 2, f"final statsz {stat}")
    return {"arm": "d", "graph": spec, "devices": 2, "answered_s": answered_s,
            "seconds": time.perf_counter() - t0,
            "answers": [{k: r.get(k) for k in ("id", "levels", "reached", "devices", "edges",
                                               "wire_bytes")} for r in got],
            "drain": "SIGTERM, final statsz, exit 0"}


def phase_mesh_serve(dev, k1, k2, scale: int, ptxas) -> list:
    """The serve tier on a mesh (see the module docstring, phase 20).
    Returns the "K1 or, mesh serve rung w 8 (shard)" and "K2, mesh serve
    rung (shard)" kernels entries."""
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.ops._build import BUILD_DIR
    from tpu_bfs_torch.parallel.mesh import serve_mesh

    t_phase = time.perf_counter()
    g = rmat(scale)
    pilot = WidePackedMsBfsEngine(g, lanes=32, num_planes=8, device=dev)
    _, traversable = hub_component_sources(pilot, 32, seed=7, with_component=True)
    del pilot
    pool = np.random.default_rng(7).choice(
        traversable, size=(SERVE_CLIENTS, MESH_SERVE_PER_CLIENT), replace=False)
    t0 = time.perf_counter()
    ctl = serve_mesh(4, device=str(dev))
    mesh_up_s = time.perf_counter() - t0
    note = (f"gloo ranks sharing {dev} (NCCL takes one rank a card): this measures the "
            f"mesh serving machinery, not multi-card scaling")
    try:
        k1e, wide, reg, direct = mesh_serve_wide(dev, k1, k2, ctl, g, pool, ptxas)
        emit({"phase": "mesh_serve", "graph": f"RMAT {scale} (cut from the flagship's 21)",
              "ranks_started": 4, "backend": ctl.backend, "mesh_up_s": mesh_up_s,
              "note": note, **wide})
        chaos = mesh_serve_chaos(dev, ctl, g, reg, pool, direct)
        del reg, direct
        gc.collect()
        emit({"phase": "mesh_serve", **chaos})
        k2e, hyb = mesh_serve_hybrid(dev, k1, k2, ctl, g, pool, ptxas)
        emit({"phase": "mesh_serve", **hyb})
        gc.collect()
        # A drawn source, not vertex 0: the registry's warm-up batch runs
        # from vertex 0 (and would drop a snapshot of it).
        d2 = mesh_serve_dist2d(dev, ctl, g, int(pool[0, 0]), BUILD_DIR / "mesh_serve_spool")
        emit({"phase": "mesh_serve", **d2})
    finally:
        ctl.close()
    torch.cuda.empty_cache()
    # (d), the JSONL subprocess, is a side arm (mesh_serve_jsonl).
    emit({"phase": "mesh_serve", "phase_seconds": time.perf_counter() - t_phase})
    return [k1e, k2e]


# --- the dynamic phase ----------------------------------------------------------


def changed_lanes(eng, res_a, res_b) -> int:
    """Lanes whose distances differ between two results of ``eng``'s shape
    on the same sources (compared on the device, word by word)."""
    n, v, changed = len(res_a.sources), eng.num_vertices, 0
    for wi in range(-(-n // 32)):
        diff = word_distances(eng, res_a, wi, v) != word_distances(eng, res_b, wi, v)
        changed += int(diff.any(dim=0)[: min(32, n - 32 * wi)].sum())
    return changed


def timed_fold(fold_of, eng, fw, reps: int = 20) -> float:
    """ms of one overlay fold over ``eng``'s armed tables and the table
    ``fw``, on an expansion output of ``fw``'s shape (CUDA events)."""
    out = torch.zeros_like(fw)
    fold = fold_of(lambda arrs, f: out)
    return cuda_ms(lambda: fold(eng.arrs, fw), reps)


def mutable_vertices(g) -> np.ndarray:
    """Vertices an overlay row can carry whole (JAX's bench rule, bench.py
    1979-1995): degree >= 1 (a base table row exists) and <= kcap - 2."""
    return np.flatnonzero((g.degrees > 0) & (g.degrees <= DYN_CAP[1] - 2))


def base_edges_between(g, allowed: np.ndarray, n: int, seed: int, exclude=()) -> list:
    """``n`` base edges (u < v), both endpoints in ``allowed``, no endpoint
    twice or in ``exclude``, drawn with default_rng(seed)."""
    src, dst = g.coo
    ok = np.isin(src, allowed) & np.isin(dst, allowed) & (src < dst)
    idx = np.random.default_rng(seed).permutation(np.flatnonzero(ok))
    used, out = {int(x) for x in np.ravel(exclude)}, []
    for j in idx:
        u, v = int(src[j]), int(dst[j])
        if u in used or v in used:
            continue
        used |= {u, v}
        out.append((u, v))
        if len(out) == n:
            return out
    raise AssertionError(f"only {len(out)} base edges between mutable vertices")


def dynamic_wide(dev, k1, k2, g, ell, traversable, ptxas):
    """(a) The flagship graph, not cut: WidePackedMsBfsEngine(ell, lanes=256,
    overlay=DYN_CAP) over the packed phase's ELL; the empty overlay equals
    a plain 256-lane engine on every lane, then an add-only batch of 64
    edges and a batch of 16 removals (override rows), each followed by one
    batch from the mutated endpoints, 5 lanes against SciPy on
    materialize()."""
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.graph.dynamic import DynamicGraph, make_overlay_fold
    from tpu_bfs_torch.validate import check_distances

    t0 = time.perf_counter()
    eng = WidePackedMsBfsEngine(ell, lanes=256, overlay=DYN_CAP, device=dev)
    plain = WidePackedMsBfsEngine(ell, lanes=256, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dyn = DynamicGraph(g, capacity=DYN_CAP)
    dyn_s = time.perf_counter() - t0
    require(np.array_equal(dyn._rank, ell.rank) and dyn._act == ell.num_active,
            "DynamicGraph's ranking != the engine ELL's (overlay ids are ranks)")
    mutable = mutable_vertices(g)
    ends = np.random.default_rng(23).choice(mutable, size=(64, 2), replace=False)
    removals = base_edges_between(g, mutable, 16, 29, exclude=ends)
    draws = np.random.default_rng(7).choice(traversable, size=96, replace=False)
    src = np.concatenate([ends.ravel(), np.ravel(removals), draws])[:256]
    eng.run(src)  # warm
    base = eng.run(src, time_it=True)
    plain.run(src)
    plain_res = plain.run(src, time_it=True)
    lanes = same_lanes(eng, base, plain, plain_res, "dynamic: empty overlay vs plain")
    picks = [0, 64]  # an added edge's endpoint and a removed edge's
    out = {"engine_build_s": build_s, "dynamic_graph_s": dyn_s, "mutable": len(mutable),
           "empty_overlay_lanes_equal_plain": lanes,
           "plain_batch_ms": plain_res.elapsed_s * 1e3,
           "empty_overlay_batch_ms": base.elapsed_s * 1e3, "batches": []}
    prev, res, launches = base, None, 0
    names = bucket_names(ell)
    for label, batch in (("add 64", {"add": [tuple(map(int, e)) for e in ends]}),
                         ("remove 16", {"remove": removals})):
        t0 = time.perf_counter()
        tables, stats = dyn.apply(**batch)
        eng.set_overlay(tables)
        apply_s = time.perf_counter() - t0
        k1.ell_expand.timings = []
        eng.run(src)  # with CUDA events around each K1 launch
        torch.cuda.synchronize()
        k1_ev = sum(a.elapsed_time(b) for a, b in k1.ell_expand.timings)
        k1.ell_expand.timings = None
        reset_counts(k1, k2)
        res = eng.run(src, time_it=True)
        launches = k1.ell_expand.launches
        require(launches == len(names) * (res.num_levels + 1) and k2.tile_spmm.launches == 0,
                f"dynamic wide: {launches} K1 launches for {res.num_levels} levels")
        t0 = time.perf_counter()
        mat = dyn.materialize()
        mat_s = time.perf_counter() - t0
        for i in picks:
            check_distances(res.distances_int32(i), scipy_bfs(mat, int(src[i])))
        changed = changed_lanes(eng, prev, res)
        require(changed > 0, f"dynamic wide, {label}: no lane's distances changed")
        fold_ms = timed_fold(lambda e: make_overlay_fold(e, op="or"), eng, res._vis)
        out["batches"].append({
            "batch": label, "overlay_rows": stats["overlay_rows"],
            "override_rows": int(tables["ov_override"][:stats["overlay_rows"]].sum()),
            "apply_s": apply_s, "materialize_s": mat_s, "levels": res.num_levels,
            "batch_ms": res.elapsed_s * 1e3, "k1_launches": launches,
            "k1_ms_per_level": k1_ev / (res.num_levels + 1), "fold_ms_per_level": fold_ms,
            "lanes_changed": changed, "validated_lanes": picks})
        prev = res
    entry = k1_entry(k1, eng.arrs, names, res._vis, "or", launches, ptxas, plain_reps=2, g=g,
                     name="K1 or, dynamic wide w 8",
                     unit="one level of the overlay wide engine: every bucket of the full "
                          "ELL, w 8, before the plain-torch overlay fold")
    return out, entry


def dynamic_sssp(dev, k1, k2, sssp, ptxas):
    """(b) SsspEngine(overlay=DYN_CAP) on the sssp phase's weighted flagship
    graph and sources, 256 lanes: one batch after an add and re-weight
    batch (re-weights make override rows), 1 lane against Dijkstra on
    materialize()."""
    from tpu_bfs_torch.graph.dynamic import DynamicGraph, make_overlay_fold
    from tpu_bfs_torch.workloads.sssp import SsspEngine

    gw, src = sssp["graph"], sssp["sources"]
    t0 = time.perf_counter()
    eng = SsspEngine(gw, lanes=256, overlay=DYN_CAP, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dyn = DynamicGraph(gw, capacity=DYN_CAP)
    mutable = mutable_vertices(gw)
    ends = np.random.default_rng(31).choice(mutable, size=(48, 2), replace=False)
    adds = [(int(u), int(v), 1 + i % 8) for i, (u, v) in enumerate(ends)]
    reweights = []
    for u, v in base_edges_between(gw, mutable, 16, 37, exclude=ends):
        lo = int(gw.row_ptr[u])
        w = int(gw.weights[lo + int(np.flatnonzero(gw.col_idx[lo:gw.row_ptr[u + 1]] == v)[0])])
        reweights.append((u, v, 1 + w % 8))
    t0 = time.perf_counter()
    tables, stats = dyn.apply(add=adds + reweights)
    eng.set_overlay(tables)
    apply_s = time.perf_counter() - t0
    names = bucket_names(eng.ell)
    k1.ell_expand.timings = []
    eng.run(src)  # warm, with CUDA events around each K1 launch
    torch.cuda.synchronize()
    k1_ev, k1_n = sum(a.elapsed_time(b) for a, b in k1.ell_expand.timings), \
        len(k1.ell_expand.timings)
    k1.ell_expand.timings = None
    reset_counts(k1, k2)
    res = eng.run(src, time_it=True)
    launches = k1.ell_expand.launches
    bodies = res.rounds + eng.last_closes
    require(launches == len(names) * bodies == k1_n and k2.tile_spmm.launches == 0,
            f"dynamic sssp: {launches} K1 launches, not {len(names)} x {bodies}")
    t0 = time.perf_counter()
    mat = dyn.materialize()
    mat_s = time.perf_counter() - t0
    picks = [0]
    t0 = time.perf_counter()
    oracle = _dijkstra_oracle(mat, src[picks])
    for j, i in enumerate(picks):
        got = res.distances_int32(i).astype(float)
        got[got == np.iinfo(np.int32).max] = np.inf
        require(np.array_equal(got, oracle[j]), f"dynamic sssp lane {i} != dijkstra")
    validate_s = time.perf_counter() - t0
    changed = int((res._dist != sssp["result"]._dist).any(dim=0).sum())
    require(changed > 0, "dynamic sssp: no lane's distances changed")
    fold_ms = timed_fold(lambda e: make_overlay_fold(e, op="minplus", weights_key="ov_wl"),
                         eng, res._dist, reps=10)
    out = {"engine_build_s": build_s, "apply_s": apply_s, "materialize_s": mat_s,
           "overlay_rows": stats["overlay_rows"],
           "override_rows": int(tables["ov_override"][:stats["overlay_rows"]].sum()),
           "delta": eng.delta, "batch_ms": res.elapsed_s * 1e3, "rounds": res.rounds,
           "heavy_closes": eng.last_closes, "base_batch_ms": sssp["result"].elapsed_s * 1e3,
           "k1_launches": launches, "k1_ms_per_expansion": k1_ev / k1_n,
           "fold_ms_per_light_sweep": fold_ms, "lanes_changed": changed,
           "validated_lanes": picks, "validate_s": validate_s}
    entry = k1_entry(k1, eng.arrs, names, res._dist, "minplus", launches, ptxas, g=gw,
                     wsuf="wl", name="K1 minplus, dynamic sssp w 256",
                     unit="one light sweep of the overlay SsspEngine: every bucket of the "
                          "full ELL, w 256, before the plain-torch overlay fold")
    entry["heavy_close_max_abs_err"] = k1_check(
        k1, eng.arrs, names, res._dist, "minplus", "w", "K1 minplus, dynamic sssp close")
    return out, entry


def dynamic_serve(dev, k1, k2, scale: int) -> dict:
    """(c) At the wide phase's scale: BfsService(wide, 256 lanes, ladder auto,
    dynamic=DYN_CAP, kinds bfs/sssp/cc, audit_rate=0.1, staleness_bound=0).
    JAX's mutation soak (16 closed-loop clients, 32 one-edge flips 0.05 s
    apart): zero dropped, zero staleness findings (an answer audited after
    its generation left the auditor's ring must be exact for that
    generation), 8 answers equal to SciPy on their generation's graph; one
    forced compaction; then torn_flip (one
    finding, then healed), corrupt_overlay (restaged, no finding) and
    compaction_crash (rolled back, answers unchanged)."""
    import threading

    from tpu_bfs_torch import faults
    from tpu_bfs_torch.graph.csr import INF_DIST
    from tpu_bfs_torch.graph.generate import edge_weights
    from tpu_bfs_torch.serve import BfsService

    g = rmat(scale)
    g = dataclasses.replace(g, weights=edge_weights(*g.coo, seed=1, wmax=8))
    logs = []
    t0 = time.perf_counter()
    svc = BfsService(g, engine="wide", lanes=256, width_ladder="auto", dynamic=DYN_CAP,
                     kinds=("bfs", "sssp", "cc"), audit_rate=0.1, staleness_bound=0,
                     device=dev, log=logs.append)
    up_s = time.perf_counter() - t0
    out = {"scale": scale, "service_up_s": up_s, "ladder": svc.width_ladder}
    try:
        hub = int(np.argmax(g.degrees))
        traversable = np.flatnonzero(svc.query(hub, timeout=600).distances != INF_DIST)
        picks = np.random.default_rng(7).choice(traversable, size=(16, 64), replace=True)
        mutable = mutable_vertices(g)
        ends = np.random.default_rng(23).choice(mutable, size=(36, 2), replace=False)

        def exact(s, name):
            mat = svc._dynamic.materialize()
            r = svc.query(int(s), timeout=600)
            require(r.ok and np.array_equal(r.distances, scipy_bfs(mat, int(s))),
                    f"dynamic serve: {name}, source {s} != SciPy")
            return r

        stop, flat, errs = threading.Event(), [], []

        def client(ci):
            got, i = [], 0
            try:
                while not stop.is_set():
                    got.append(svc.query(int(picks[ci][i % 64]), timeout=600))
                    i += 1
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errs.append(exc)
            flat.extend(got)

        # The auditor's ring holds WINDOW generations: a sampled answer whose
        # audit runs more flips after its dispatch than that (the extraction
        # worker replays each sampled answer on the host, so it can lag the
        # flips) matches no ringed generation and counts as unmatched. Keep
        # every generation's host graph and each unmatched answer, so an
        # unmatched answer passes only if it is exact for its own stamp.
        aud = svc._staleness
        kept, unmatched, audit_lock = dict(aud._ring), [], threading.Lock()
        push_generation, audit_one = aud.push_generation, aud._audit_one

        def keep_generation(generation, graph):
            kept[int(generation)] = graph
            push_generation(generation, graph)

        def audit_keeping_unmatched(q, r, served_gen):
            with audit_lock:
                before = aud.stats()["unmatched"]
                audit_one(q, r, served_gen)
                if aud.stats()["unmatched"] > before:
                    unmatched.append((served_gen, r.kind, int(r.source),
                                      np.asarray(r.distances, np.int32).copy()))

        aud.push_generation, aud._audit_one = keep_generation, audit_keeping_unmatched
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        flip_ms, occupancy, checked = [], 0, 0
        reset_counts(k1, k2)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        try:
            for j, (u, v) in enumerate(ends[:32]):
                flip = svc.apply_edge_updates(add=[(int(u), int(v))])
                flip_ms.append(flip["flip_ms"])
                occupancy = max(occupancy, flip["overlay_rows"])
                if j % 4 == 3:  # this thread alone flips: the answer's generation is this one
                    exact(u, f"soak generation {flip['generation']}")
                    checked += 1
                time.sleep(0.05)
        finally:
            stop.set()
            for t in threads:
                t.join()
        soak_s = time.perf_counter() - t0
        if errs:
            raise errs[0]
        dropped = sum(1 for r in flat if not r.ok)
        require(dropped == 0, f"dynamic serve: {dropped} of {len(flat)} queries dropped")
        require(k1.ell_expand.launches > 0, "dynamic serve launched no K1")
        svc.flush_audits()
        snap = svc.statsz()
        with audit_lock:
            del aud.push_generation, aud._audit_one
        st = snap["dynamic"]["staleness"]
        require(st["stale"] == 0 and st["over_bound"] == 0 and st["errors"] == 0
                and st["unmatched"] == len(unmatched), f"dynamic serve soak: staleness {st}")
        for served_gen, kind, src, dist in unmatched:
            require(kind == "bfs" and served_gen in kept
                    and np.array_equal(dist, scipy_bfs(kept[served_gen], src)),
                    f"dynamic serve soak: a {kind} answer for source {src} stamped "
                    f"generation {served_gen} matches no ringed generation and is not "
                    f"exact for its own")
        kept.clear()
        require(snap["audit_failures"] == 0 and snap["errors"] == 0, "dynamic serve: findings")
        out["soak"] = {"flips": len(flip_ms), "flip_p50_ms": float(np.percentile(flip_ms, 50)),
                       "flip_max_ms": float(max(flip_ms)),
                       "occupancy": occupancy / DYN_CAP[0], "queries": len(flat),
                       "seconds": soak_s, "qps": len(flat) / soak_s, "dropped": dropped,
                       "answers_equal_scipy": checked, "staleness": st,
                       "late_audits_exact": len(unmatched),
                       "audits_run": snap["audits_run"], "audit_dropped": snap["audit_dropped"],
                       "k1_launches": k1.ell_expand.launches}
        # One forced compaction: answer-neutral.
        before = exact(ends[0][0], "before compaction")
        t0 = time.perf_counter()
        with svc._flip_lock:
            svc._compact_locked()
        out["compaction_s"] = time.perf_counter() - t0
        after = exact(ends[0][0], "after compaction")
        require(np.array_equal(before.distances, after.distances), "compaction changed answers")

        # torn_flip: one staleness finding, then healed.
        u, v = (int(x) for x in ends[32])
        faults.arm_from_spec("torn_flip@generation_flip:n=1")
        try:
            svc.apply_edge_updates(add=[(u, v)])
        finally:
            faults.disarm()
        truth = scipy_bfs(svc._dynamic.materialize(), u)
        torn, tries = 0, 0
        while svc.statsz()["dynamic"]["staleness"]["over_bound"] == 0 and tries < 200:
            r = svc.query(u, timeout=600)
            torn += int(not np.array_equal(r.distances, truth))
            tries += 1
            svc.flush_audits()
        st = svc.statsz()["dynamic"]["staleness"]
        require(st["over_bound"] == 1 and st["stale"] == 1 and torn >= 1,
                f"torn_flip: staleness {st} after {tries} queries ({torn} stale)")
        exact(u, "healed after torn_flip")
        out["torn_flip"] = {"queries_until_finding": tries, "stale_answers": torn,
                            "staleness": st}
        # corrupt_overlay: restaged from host truth, no finding.
        u, v = (int(x) for x in ends[33])
        faults.arm_from_spec("corrupt_overlay@generation_flip:n=1")
        try:
            svc.apply_edge_updates(add=[(u, v)])
        finally:
            faults.disarm()
        require(any("CRC re-check" in m for m in logs), "corrupt_overlay: no CRC re-check")
        for _ in range(8):
            exact(u, "after corrupt_overlay")
        svc.flush_audits()
        require(svc.statsz()["dynamic"]["staleness"]["over_bound"] == 1,
                "corrupt_overlay: a staleness finding")
        # compaction_crash: rolled back, answers unchanged.
        before = exact(u, "before compaction_crash")
        faults.arm_from_spec("compaction_crash@compact:n=1")
        try:
            with svc._flip_lock:
                try:
                    svc._compact_locked()
                    crashed = False
                except RuntimeError:
                    crashed = True
        finally:
            faults.disarm()
        orphans = [n for n in os.listdir(svc._gen_store.root) if n.endswith(".corrupt")]
        require(crashed and len(orphans) == 1, f"compaction_crash: {crashed} {orphans}")
        after = exact(u, "after compaction_crash")
        require(np.array_equal(before.distances, after.distances),
                "compaction_crash changed answers")
        svc.flush_audits()
        snap = svc.statsz()
        require(snap["audit_failures"] == 0 and snap["errors"] == 0
                and snap["dynamic"]["compactions"] == 1, f"dynamic serve: {snap['dynamic']}")
        out["chaos"] = {"orphans": orphans, "statsz_dynamic": snap["dynamic"],
                        "quarantines": snap["quarantines"]}
    finally:
        svc.close()
    return out


def phase_dynamic(dev, k1, k2, g, ell, traversable, sssp, wide_scale: int, ptxas) -> list:
    """Dynamic graphs: (a) the overlay wide engine at the flagship's full
    size, (b) the overlay SsspEngine on the sssp phase's graph, (c) the
    dynamic serve tier at the wide phase's scale. Returns the two K1
    entries of the kernels line."""
    t0 = time.perf_counter()
    wide, wide_entry = dynamic_wide(dev, k1, k2, g, ell, traversable, ptxas)
    gc.collect()
    torch.cuda.empty_cache()
    sssp_out, sssp_entry = dynamic_sssp(dev, k1, k2, sssp, ptxas)
    gc.collect()
    torch.cuda.empty_cache()
    serve = dynamic_serve(dev, k1, k2, wide_scale)
    emit({"phase": "dynamic", "capacity": list(DYN_CAP),
          "graph": "the flagship graph (a); with edge_weights(seed=1, wmax=8) (b)",
          "scale_cut": f"(c) at RMAT {wide_scale}: every flip materializes the graph for the "
                       f"staleness ring", "wide": wide, "sssp": sssp_out, "serve": serve,
          "seconds": time.perf_counter() - t0})
    return [wide_entry, sssp_entry]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21, help="flagship RMAT scale (21)")
    ap.add_argument("--lanes", type=int, default=8192, help="flagship lanes (8192)")
    # 16 (17 until the fleet arm, 18 before the aot phase), cut to pay for them.
    ap.add_argument("--wide-scale", type=int, default=16, help="wide-engine RMAT scale (16)")
    ap.add_argument("--graph500-scale", type=int, default=17,
                    help="RMAT scale of the graph500 phase (17; the flagship's is 21)")
    ap.add_argument("--graph500-small-scale", type=int, default=17,
                    help="RMAT scale of the graph500 single and batched runs (17)")
    ap.add_argument("--ckpt-every", type=int, default=4,
                    help="levels before the ckpt phase's checkpoint (4)")
    ap.add_argument("--mesh-kinds-small-scale", type=int, default=14,
                    help="RMAT scale of the mesh_kinds phase's shared-card ranks (14)")
    ap.add_argument("--parity-only", action="store_true",
                    help="stop after the build and the small-shape parity checks")
    ap.add_argument("--stack-sample", metavar="PATH",
                    help="sample the main thread's stack every 50 ms, the counts written to "
                         "PATH at exit (tpu_bfs_torch/tools/stack_sample.py)")
    args = ap.parse_args(argv)
    if args.stack_sample:
        from tpu_bfs_torch.tools import stack_sample

        stack_sample.start(args.stack_sample, script=Path(__file__).name)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import tpu_bfs_torch
    from tpu_bfs_torch.ops import _build
    from tpu_bfs_torch.ops import ell_expand as k1
    from tpu_bfs_torch.ops import tile_spmm as k2
    from tpu_bfs_torch.utils import native

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
    cuda_s = time.perf_counter() - t0
    # The native host library (the RMAT generator, the loader, the counting
    # sort), built afresh from tpu_bfs_torch/native: no NumPy fallback here.
    t0 = time.perf_counter()
    nlog = []
    native.library_path().unlink(missing_ok=True)
    native.ensure_built(log=nlog.append)
    require(native.has_rmat(), f"the native host library did not build: {nlog}")
    emit({"phase": "build", "seconds": cuda_s, "nvcc": _build.find_nvcc(), "ptxas": ptxas,
          "native_s": time.perf_counter() - t0,
          "native_library": str(native.library_path().relative_to(here))
          if native.library_path().is_relative_to(here) else str(native.library_path())})
    print("\n".join(log), file=sys.stderr, flush=True)

    phase_parity(dev, k1, k2)
    if args.parity_only:
        return 0
    wide = phase_wide(dev, k1, k2, args.wide_scale)
    g, eng, res, sources, picks, launches, traversable = phase_flagship(
        dev, k1, k2, args.scale, args.lanes)
    kernels = phase_kernels(g, eng, res, launches, k1, k2, ptxas)
    kernels.append(phase_parents(k1, k2, g, eng, res, sources, picks, ptxas))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_pullgate(dev, k1, k2, g, eng, sources, picks[:1], wide, ptxas))
    kernels += phase_adaptive(dev, k1, k2, g, eng, sources, picks[:1], wide, kernels[:2])
    gc.collect()
    torch.cuda.empty_cache()
    aot_a, entries = aot_flagship(dev, k1, k2, eng, sources, kernels[:2])
    kernels += entries
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
    phase_mesh_single(dev, k1, k2, g, dg, single_sources, golden, trees)
    phase_pullgate_tiled(dev, k1, k2, g, single_sources, golden, trees)
    entries, ell = phase_packed(dev, k1, k2, g, single_sources, golden, trees, traversable, ptxas)
    kernels += entries
    phase_ckpt(dev, k1, k2, hg, ell, dg, sources, single_sources[0], args.ckpt_every)
    phase_obs(dev, k1, k2, ell, traversable, args.wide_scale)
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
    gc.collect()
    torch.cuda.empty_cache()
    kernels += phase_dynamic(dev, k1, k2, g, ell, traversable, sssp, args.wide_scale, ptxas)
    del ell
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_mesh_kinds(dev, k1, k2, g, sssp, sources, khop_reached, cc, p2p,
                                    ptxas))
    del sssp, sources
    gc.collect()
    torch.cuda.empty_cache()
    entry, aot_b = phase_serve(dev, k1, k2, g, traversable, args.wide_scale, ptxas)
    kernels.append(entry)
    aot_cd = phase_side(dev, args.wide_scale, args.mesh_kinds_small_scale)
    # The aot phase's line: (a) ran after adaptive, (b) in the serve loop, (c),
    # (d) and the fleet with the serve phase's JSONL act, a side arm.
    aot_arms = {"a": aot_a, "b": aot_b, **aot_cd}
    emit({"phase": "aot", **aot_arms,
          "phase_seconds": aot_a["seconds"] + aot_arms["b"]["seconds"]
          + aot_arms["c"]["seconds"] + aot_arms["d"]["handoff_s"]
          + aot_arms["fleet"]["seconds"]})
    del g
    gc.collect()
    torch.cuda.empty_cache()
    kernels += phase_mesh_serve(dev, k1, k2, args.wide_scale, ptxas)
    gc.collect()
    torch.cuda.empty_cache()
    phase_graph500(dev, k1, k2, args.graph500_scale, args.graph500_small_scale)

    require(all(row.get("edge_stream") for row in kernels),
            "a kernels row does not name its graph's edge stream")
    emit({"phase": "script", "seconds": time.perf_counter() - T0, "edge_stream": STREAM})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
