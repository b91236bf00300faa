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
    the device, copied to the host and decoded there; the 5 validated lanes
    equal validate.min_parent_from_dist and pass certify_bfs; then the
    public parents_into(device="device") on a 256-lane batch. The K1 min
    entry of the kernels line is timed here, at the scan's shape;
 8. graph500: run_graph500(scale 20, ef 16, mode="hybrid", 64 searches,
    4 validated) on the card, its trees from the device scan through the
    default parents_int32 (the host scatter-min is made to raise while it
    runs): scale 20, not 21, keeps the whole script near
    8 minutes (--graph500-scale 21 adds some 100 s; the line states the cut).
The last line is {"ok": true, "device": {...}}. Any failed check raises and
the script exits non-zero; it also exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# Parent-scan passes whose 128 lanes are all decoded on the host (timed);
# the rest decode only the validated lanes (a whole pass takes seconds).
DECODE_PASSES = 2
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
    return g, eng, res, sources, picks, launches


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
    validate.certify_bfs."""
    from tpu_bfs_torch.validate import certify_bfs, min_parent_from_dist

    for i in lanes:
        s, d = int(sources[i]), res.distances_int32(i)
        require(np.array_equal(trees[i], min_parent_from_dist(g, s, d)),
                f"lane {i}: scanned tree != min_parent_from_dist")
        certify_bfs(g, s, d, trees[i])


def k1_min_entry(k1, scanner, keys, launches: int, ptxas) -> dict:
    """The kernels-line entry of K1 op=min at the parent scan's shape: one
    pass, every bucket of the full ELL, over a pass's real key table. The
    bound reads the key rows the indices name, each bucket's gate and index
    slab, and writes each output, once, over 3.35 TB/s; the model is
    ell_expand_hbm_bytes."""
    arrs, ell = scanner.arrs, scanner.ell
    lpp = keys.shape[1]
    names = (["virtual"] if ell.num_heavy else []) + [f"light{i}" for i in range(len(ell.light))]

    def k1_pass(fn):
        return [fn(arrs[f"{n}_need"], arrs[f"{n}_gt"], keys, op="min") for n in names]

    got, want = k1_pass(k1.ell_expand), k1_pass(k1.ell_expand_plain)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "ell_expand min != twin at the parent scan's shape")
    del got, want
    named = int(torch.unique(torch.cat([arrs[f"{n}_gt"].reshape(-1) for n in names])).numel())
    nbytes = named * lpp * 4 + sum(
        arrs[f"{n}_need"].nbytes + arrs[f"{n}_gt"].nbytes + arrs[f"{n}_gt"].shape[1] * lpp * 4
        for n in names)
    model = sum(k1.ell_expand_hbm_bytes(*arrs[f"{n}_gt"].shape, lpp) for n in names)
    return {
        "name": "ell_expand_min", "route": "cuda", "source": "tpu_bfs_torch/csrc/ell_expand.cu",
        "replaces": "tpu_bfs/ops/ell_expand.py:225", "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: k1_pass(k1.ell_expand), 5),
        "plain_ms": cuda_ms(lambda: k1_pass(k1.ell_expand_plain), 1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "model_ms": model / HBM_BYTES_PER_S * 1e3,
        "unit": f"one parent-scan pass: every bucket of the full ELL, w {lpp}",
        "ptxas": ptxas.get("ell_expand.cu", []),
    }


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
    buckets = (ell.num_heavy > 0) + len(ell.light)
    require(launches["ell_expand"] == len(pass_ms) * buckets,
            f"parent scan launched {launches['ell_expand']} K1, not {len(pass_ms)} x {buckets}")
    require(launches["tile_spmm"] == 0, "the parent scan launched tile_spmm")
    t0 = time.perf_counter()
    _check_trees(g, res, sources, picks, trees)
    validate_s = time.perf_counter() - t0
    entry = k1_min_entry(k1, scanner, scanner.keys(res._scan_cols(scanner, 0, lpp // 32, perm)),
                         launches["ell_expand"], ptxas)
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


def phase_graph500(dev, k1, k2, scale: int) -> None:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21, help="flagship RMAT scale (21)")
    ap.add_argument("--lanes", type=int, default=8192, help="flagship lanes (8192)")
    ap.add_argument("--wide-scale", type=int, default=18, help="wide-engine RMAT scale (18)")
    ap.add_argument("--graph500-scale", type=int, default=20,
                    help="RMAT scale of the graph500 phase (20; the flagship's is 21)")
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
    phase_wide(dev, k1, k2, args.wide_scale)
    g, eng, res, sources, picks, launches = phase_flagship(dev, k1, k2, args.scale, args.lanes)
    kernels = phase_kernels(eng, res, launches, k1, k2, ptxas)
    kernels.append(phase_parents(k1, k2, g, eng, res, sources, picks, ptxas))
    del g, eng, res  # free the flagship's device state before the next engine
    gc.collect()
    torch.cuda.empty_cache()
    phase_graph500(dev, k1, k2, args.graph500_scale)

    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
