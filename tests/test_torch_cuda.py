"""The port's CUDA kernels and engines on a card, against their CPU forms.

Every test needs a CUDA device (marker ``cuda``) and skips without one, as
the ``cuda`` fixture decides at run time: a CUDA kernel has no CPU mode.
This file imports neither jax nor tpu_bfs, so it also runs on a
machine without them. The mesh engines run as one-rank NCCL groups in
spawned ranks (their entry points in tests/torch_mesh_cases.py), each
against a one-rank gloo group on CPU tensors. There, skip the suite's conftest (it sets up JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph.generate import rmat_graph
from tpu_bfs_torch.ops import ell_expand as k1
from tpu_bfs_torch.ops import tile_spmm as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def i32(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary (the kernels' 4-byte-load path)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


# (w, k): scalar loads at w = 1, 33; one 32-word strip at w = 8, two at
# 64, eight at 256; k = 70 takes two slot passes (three for minplus).
@pytest.mark.parametrize("op", ["or", "min", "minplus"])
@pytest.mark.parametrize("w,k", [(8, 1), (256, 7), (33, 64), (1, 3), (64, 70), (256, 70)])
def test_ell_expand_kernel_equals_twin(cuda, op, w, k):
    rng = np.random.default_rng(k * 100 + w)
    nb, rows = 5, 1037
    need = (rng.random(nb) < 0.6).astype(np.int32)
    need[0], need[-1] = 1, 0
    gt = rng.integers(0, rows, size=(k, nb * 128)).astype(np.int32)
    fw = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    wt = None
    if op == "minplus":
        fw = (fw >> np.uint32(12)).view(np.int32)
        wt = i32(rng.integers(0, 9, size=(k, nb * 128)).astype(np.int32), cuda)
    args = (i32(need, cuda), i32(gt, cuda), i32(fw, cuda), wt)
    before = k1.ell_expand.launches
    got = k1.ell_expand(*args, op=op)
    torch.cuda.synchronize()
    assert k1.ell_expand.launches == before + 1
    assert torch.equal(got, k1.ell_expand_plain(*args, op=op))


def test_ell_expand_misaligned_fw_equals_twin(cuda):
    rng = np.random.default_rng(4)
    gt = i32(rng.integers(0, 300, size=(9, 256)).astype(np.int32), cuda)
    fw = misaligned(i32(rng.integers(0, 2**32, size=(300, 256), dtype=np.uint32), cuda))
    need = torch.ones(2, dtype=torch.int32, device=cuda)
    for op in ("or", "min"):
        got = k1.ell_expand(need, gt, fw, op=op)
        torch.cuda.synchronize()
        assert torch.equal(got, k1.ell_expand_plain(need, gt, fw, op=op))


def tile_inputs(rng, vt, w, dev):
    """Row tile 0 takes every column tile (> SEG at vt = 40: split over
    blocks, merged with atomicOr), row tile 2 none; the rest 1..vt."""
    row_start, col_tile = [0], []
    for j in range(vt):
        n = {0: vt, 2: 0}.get(j, int(rng.integers(1, vt + 1)))
        col_tile += sorted(int(c) for c in rng.choice(vt, size=n, replace=False))
        row_start.append(len(col_tile))
    a = rng.integers(0, 2**32, size=(len(col_tile), 4, 128), dtype=np.uint32)
    a &= rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
    a &= rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
    fw = rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32)
    return [i32(np.array(row_start, np.int32), dev), i32(np.array(col_tile, np.int32), dev),
            i32(a, dev), i32(fw, dev)]


@pytest.mark.parametrize("vt", [5, 40])  # at 40, row tiles of > SEG tiles span blocks
@pytest.mark.parametrize("w", [1, 8, 33, 64, 256])
def test_tile_spmm_kernel_equals_twin(cuda, w, vt):
    args = tile_inputs(np.random.default_rng(w + vt), vt, w, cuda)
    got = k2.tile_spmm(*args, num_row_tiles=vt)
    torch.cuda.synchronize()
    assert torch.equal(got, k2.tile_spmm_plain(*args, num_row_tiles=vt))
    assert not got[256:384].any()  # the empty row tile


@pytest.mark.parametrize("w", [1, 33, 64, 256])
def test_tile_spmm_accumulate_equals_twin(cuda, w):
    # out= with the row masks alone, as the hybrid engine keeps them: the
    # kernel ORs into the prior table and leaves the empty row tile alone.
    rng = np.random.default_rng(w * 7)
    vt = 40
    args = tile_inputs(rng, vt, w, cuda)
    prior = i32(rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32), cuda)
    prior &= i32(rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32), cuda)
    masks = k2.row_masks(args[2])
    out = prior.clone()
    before = k2.tile_spmm.launches
    res = k2.tile_spmm(args[0], args[1], None, args[3], num_row_tiles=vt, masks=masks, out=out)
    torch.cuda.synchronize()
    assert res is out and k2.tile_spmm.launches == before + 1
    assert torch.equal(out, prior | k2.tile_spmm_plain(*args, num_row_tiles=vt))
    assert torch.equal(out[256:384], prior[256:384])


def test_tile_spmm_misaligned_operands_equal_twin(cuda):
    vt, w = 6, 64
    args = tile_inputs(np.random.default_rng(9), vt, w, cuda)
    args[3] = misaligned(args[3])
    out = misaligned(torch.zeros((vt * 128, w), dtype=torch.int32, device=cuda))
    k2.tile_spmm(*args, num_row_tiles=vt, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, k2.tile_spmm_plain(*args, num_row_tiles=vt))


@pytest.mark.parametrize("engine", ["wide", "hybrid"])
def test_engine_on_cuda_equals_cpu(cuda, engine):
    g = rmat_graph(12, 16, seed=11)
    kw = dict(lanes=256, kcap=8, num_planes=5)
    if engine == "hybrid":
        kw["tile_thr"] = 4
    make = WidePackedMsBfsEngine if engine == "wide" else HybridMsBfsEngine
    src = np.random.default_rng(5).integers(0, g.num_vertices, size=256)
    want = make(g, device="cpu", **kw).run(src)
    before = (k1.ell_expand.launches, k2.tile_spmm.launches)
    res = make(g, device=cuda, **kw).run(src)
    assert k1.ell_expand.launches > before[0]
    assert (k2.tile_spmm.launches > before[1]) == (engine == "hybrid")
    assert res.num_levels == want.num_levels
    np.testing.assert_array_equal(res.reached, want.reached)
    np.testing.assert_array_equal(res.edges_traversed, want.edges_traversed)
    np.testing.assert_array_equal(res.ecc, want.ecc)
    for i in (0, 31, 32, 128, 255):
        np.testing.assert_array_equal(res.distances_int32(i), want.distances_int32(i))


def test_ell_expand_min_w128_high_bit_keys(cuda):
    # The parent scan's K1 shape: w = 128 words of uint32 keys, most with
    # bit 31 set, and an all-ones sentinel row that every pad slot gathers.
    rng = np.random.default_rng(12)
    rows, k, nb = 3001, 64, 9
    keys = rng.integers(0, 2**32, size=(rows, 128), dtype=np.uint32) | np.uint32(1 << 31)
    low = rng.random(rows) < 0.3
    keys[low] &= np.uint32(0x7FFFFFFF)
    keys[-1] = 0xFFFFFFFF
    gt = rng.integers(0, rows, size=(k, nb * 128)).astype(np.int32)
    gt[rng.random(gt.shape) < 0.2] = rows - 1
    need = np.ones(nb, np.int32)
    need[3] = 0
    args = (i32(need, cuda), i32(gt, cuda), i32(keys, cuda))
    got = k1.ell_expand(*args, op="min")
    torch.cuda.synchronize()
    assert torch.equal(got, k1.ell_expand_plain(*args, op="min"))
    want = keys[gt].min(axis=0)  # unsigned
    want[3 * 128:4 * 128] = 0xFFFFFFFF
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)


def _dist_cols(g, ell, sources):
    from tpu_bfs_torch.reference import bfs_scipy

    act = ell.num_active
    cols = np.full((act, 128), 255, np.uint8)
    dists = []
    for j, s in enumerate(sources):
        d = bfs_scipy(g, int(s))
        dists.append(d)
        cols[:, j] = np.where(d == np.iinfo(np.int32).max, 255, d)[ell.old_of_new[:act]]
    return cols, dists


@pytest.mark.parametrize("high_ids", [False, True])
def test_parent_scan_cuda_equals_twin_and_oracle(cuda, high_ids):
    import dataclasses

    from tpu_bfs_torch.algorithms.parent_scan import ParentScanner
    from tpu_bfs_torch.graph.ell import build_ell
    from tpu_bfs_torch.validate import min_parent_from_dist

    g = rmat_graph(12, 16, seed=11)
    ell = build_ell(g, kcap=16)
    sources = np.random.default_rng(2).choice(g.num_vertices, size=100, replace=False)
    cols, dists = _dist_cols(g, ell, sources)
    idmap = np.arange(g.num_vertices, dtype=np.int32)
    if high_ids:  # ids over [0, 2**24): keys of unreached rows set bit 31
        idmap = np.sort(np.random.default_rng(1).choice(1 << 24, size=g.num_vertices,
                                                        replace=False)).astype(np.int32)
        ell = dataclasses.replace(ell, num_vertices=1 << 24, old_of_new=idmap[ell.old_of_new])
    buckets = (ell.num_heavy > 0) + len(ell.light)
    before = k1.ell_expand.launches
    got = ParentScanner(ell, device=cuda).scan(torch.from_numpy(cols).to(cuda))
    torch.cuda.synchronize()
    assert k1.ell_expand.launches == before + buckets
    twin = ParentScanner(ell, device="cpu").scan(torch.from_numpy(cols))
    assert torch.equal(got.cpu(), twin)
    rows = ell.old_of_new[: ell.num_active]
    for j in (0, 1, 50, 99):
        tree = min_parent_from_dist(g, int(sources[j]), dists[j])
        want = np.where(tree >= 0, idmap[np.maximum(tree, 0)], -1)
        np.testing.assert_array_equal(got[:, j].cpu().numpy(), want[np.searchsorted(idmap, rows)])


@pytest.mark.parametrize("engine", ["wide", "hybrid"])
def test_parents_into_device_on_cuda(cuda, engine):
    from tpu_bfs_torch.validate import certify_bfs, min_parent_from_dist

    g = rmat_graph(12, 16, seed=11)
    kw = dict(lanes=256, kcap=8, num_planes=5)
    if engine == "hybrid":
        kw["tile_thr"] = 4
    make = WidePackedMsBfsEngine if engine == "wide" else HybridMsBfsEngine
    src = np.random.default_rng(5).integers(0, g.num_vertices, size=160)  # two passes
    want = np.empty((160, g.num_vertices), np.int32)
    make(g, device="cpu", **kw).run(src).parents_into(want, device="device")
    res = make(g, device=cuda, **kw).run(src)
    before = k1.ell_expand.launches
    out = np.empty_like(want)
    res.parents_into(out, device="device")
    assert k1.ell_expand.launches > before
    np.testing.assert_array_equal(out, want)
    for i in (0, 127, 128, 159):
        d = res.distances_int32(i)
        np.testing.assert_array_equal(out[i], min_parent_from_dist(g, int(src[i]), d))
        certify_bfs(g, int(src[i]), d, out[i])
    np.testing.assert_array_equal(res.parents_int32(3), want[3])


@pytest.mark.parametrize("engine", ["wide", "hybrid"])
def test_parents_int32_on_cuda_runs_the_scan(cuda, engine, monkeypatch):
    # A fresh result's single-lane trees and its default export come from K1
    # min on the card; the host scatter-min is never reached.
    from tpu_bfs_torch.algorithms import _packed_common as tpc
    from tpu_bfs_torch.validate import min_parent_from_dist

    g = rmat_graph(12, 16, seed=11)
    kw = dict(lanes=64, kcap=8, num_planes=5)
    if engine == "hybrid":
        kw["tile_thr"] = 4
    make = WidePackedMsBfsEngine if engine == "wide" else HybridMsBfsEngine
    src = np.random.default_rng(6).integers(0, g.num_vertices, size=40)
    res = make(g, device=cuda, **kw).run(src)

    def host(*args):
        raise AssertionError("the host scatter-min ran on the card")

    monkeypatch.setattr(tpc, "min_parents_lane", host)
    before = k1.ell_expand.launches
    for i in (0, 33):
        d = res.distances_int32(i)
        np.testing.assert_array_equal(res.parents_int32(i),
                                      min_parent_from_dist(g, int(src[i]), d))
    assert k1.ell_expand.launches > before
    out = np.empty((40, g.num_vertices), np.int32)
    res.parents_into(out)
    np.testing.assert_array_equal(out[33], res.parents_int32(33))


def _path_graph(n=200):
    from tpu_bfs_torch.graph.io import from_edges

    u = np.arange(n - 1)
    return from_edges(u, u + 1, num_vertices=n)


@pytest.mark.parametrize("backend", ["scan", "segment", "scatter", "delta", "dopt", "tiled"])
def test_single_source_on_cuda_equals_cpu(cuda, backend):
    # Each backend's level loop on the card against the same engine on CPU
    # tensors: RMAT 12 (hub and a seeded source) and the 200-vertex path.
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine

    def make(g, dev):
        if backend == "tiled":
            return TiledBfsEngine(g, tile_thr=4, device=dev)
        return BfsEngine(g, backend=backend, device=dev)

    for g, sources in ((rmat_graph(12, 16, seed=11), None), (_path_graph(), [0, 150])):
        if sources is None:
            sources = [int(np.argmax(g.degrees)), 7]
        on_card, on_cpu = make(g, cuda), make(g, "cpu")
        for s in sources:
            got, want = on_card.run(s, time_it=True), on_cpu.run(s)
            np.testing.assert_array_equal(got.distance, want.distance)
            np.testing.assert_array_equal(got.parent, want.parent)
            assert (got.num_levels, got.reached, got.edges_traversed) == (
                want.num_levels, want.reached, want.edges_traversed)
            assert got.elapsed_s > 0


@pytest.mark.parametrize("backend", ["scan", "segment", "scatter", "delta"])
def test_msbfs_on_cuda_equals_cpu(cuda, backend):
    from tpu_bfs_torch.algorithms.msbfs import MsBfsEngine

    g = rmat_graph(11, 16, seed=4)
    src = np.random.default_rng(3).integers(0, g.num_vertices, size=40)
    got = MsBfsEngine(g, backend=backend, device=cuda).run(src, with_parents=True)
    want = MsBfsEngine(g, backend=backend, device="cpu").run(src, with_parents=True)
    np.testing.assert_array_equal(got.distance, want.distance)
    np.testing.assert_array_equal(got.parent, want.parent)


@pytest.mark.parametrize("lanes", [32, 256])  # K1 at w = 1 and w = 8
def test_packed_engine_on_cuda_equals_cpu(cuda, lanes):
    from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine
    from tpu_bfs_torch.graph.ell import build_ell

    g = rmat_graph(12, 16, seed=11)
    ell = build_ell(g, kcap=8)
    src = np.random.default_rng(7).integers(0, g.num_vertices, size=lanes - 5)
    want = PackedMsBfsEngine(ell, lanes=lanes, device="cpu").run(src)
    eng = PackedMsBfsEngine(ell, lanes=lanes, device=cuda)
    buckets = (ell.num_heavy > 0) + len(ell.light)
    before = k1.ell_expand.launches
    got = eng.run(src)
    assert k1.ell_expand.launches - before == buckets * (got.num_levels + 1)
    np.testing.assert_array_equal(got.distance_u8, want.distance_u8)
    np.testing.assert_array_equal(got.reached, want.reached)
    np.testing.assert_array_equal(got.edges_traversed, want.edges_traversed)
    np.testing.assert_array_equal(got.ecc, want.ecc)
    out = np.empty((len(src), g.num_vertices), np.int32)
    ref = np.empty_like(out)
    np.testing.assert_array_equal(got.parents_into(out),
                                  want.parents_into(ref, device="device"))


@pytest.mark.parametrize("w", [1, 8, 256])
@pytest.mark.parametrize("density", [0.05, 0.3])
def test_ell_expand_sparse_gate_masks(cuda, w, density):
    # The pull gate's masks: most tiles gated out, in random runs; a gated-
    # out tile writes zeros and launches no gather.
    rng = np.random.default_rng(int(w / density))
    nb, rows, k = 40, 4001, 16
    need = (rng.random(nb) < density).astype(np.int32)
    need[rng.integers(0, nb)] = 1
    gt = rng.integers(0, rows, size=(k, nb * 128)).astype(np.int32)
    fw = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    args = (i32(need, cuda), i32(gt, cuda), i32(fw, cuda))
    before = k1.ell_expand.launches
    got = k1.ell_expand(*args)
    torch.cuda.synchronize()
    assert k1.ell_expand.launches == before + 1
    assert torch.equal(got, k1.ell_expand_plain(*args))
    off = np.repeat(need == 0, 128)
    assert not got[torch.from_numpy(off).to(cuda)].any()


@pytest.mark.parametrize("engine", ["wide", "hybrid"])
def test_gated_engine_on_cuda_equals_cpu(cuda, engine):
    # The gated loop on the card: raw state, skipped-block counts and host
    # reads equal the same engine's on CPU tensors, and the distances the
    # ungated engine's; K1 launches, never its twin.
    g = rmat_graph(12, 16, seed=11)
    kw = dict(lanes=256, kcap=8, num_planes=5, pull_gate=True)
    if engine == "hybrid":
        kw["tile_thr"] = 16
    make = WidePackedMsBfsEngine if engine == "wide" else HybridMsBfsEngine
    src = np.random.default_rng(5).choice(np.flatnonzero(g.degrees > 0), size=200,
                                          replace=False)
    cpu = make(g, device="cpu", **kw)
    want = cpu.run(src)
    eng = make(g, device=cuda, **kw)
    before = k1.ell_expand.launches
    res = eng.run(src)
    assert k1.ell_expand.launches > before
    assert torch.equal(res._vis.cpu(), want._vis)
    for p, q in zip(res._planes, want._planes):
        assert torch.equal(p.cpu(), q)
    assert torch.equal(eng.last_gate_level_counts.cpu(), cpu.last_gate_level_counts)
    assert eng.last_gate_level_counts.sum() > 0
    assert eng.last_host_syncs == cpu.last_host_syncs == res.num_levels + 1
    plain = make(g, device=cuda, **{**kw, "pull_gate": False}).run(src)
    np.testing.assert_array_equal(res.reached, plain.reached)
    np.testing.assert_array_equal(res.ecc, plain.ecc)
    for i in (0, 31, 32, 199):
        np.testing.assert_array_equal(res.distances_int32(i), plain.distances_int32(i))


@pytest.mark.parametrize("gate", [False, True])
def test_checkpoint_resume_on_cuda(cuda, gate, tmp_path):
    # Save, load and resume on the card: the chunked batch equals one run,
    # and its checkpoints equal those of the same engine on CPU tensors.
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.utils import checkpoint as ck

    g = rmat_graph(12, 16, seed=11)
    kw = dict(lanes=64, kcap=8, num_planes=5, tile_thr=16, pull_gate=gate)
    src = np.random.default_rng(4).integers(0, g.num_vertices, size=50)
    eng, cpu = HybridMsBfsEngine(g, device=cuda, **kw), HybridMsBfsEngine(g, device="cpu", **kw)
    st, cst = eng.start(src), cpu.start(src)
    path = str(tmp_path / "c.npz")
    while not st.done:
        st, cst = eng.advance(st, 2), cpu.advance(cst, 2)
        for name in ("frontier", "visited", "planes"):
            np.testing.assert_array_equal(getattr(st, name), getattr(cst, name))
        ck.save_packed_checkpoint(path, st)
        st = ck.load_packed_checkpoint(path)
    res, full = eng.finish(st), eng.run(src)
    np.testing.assert_array_equal(res.reached, full.reached)
    for i in (0, 33, 49):
        np.testing.assert_array_equal(res.distances_int32(i), full.distances_int32(i))
    single = BfsEngine(g, backend="scan", device=cuda)
    s = int(np.argmax(g.degrees))
    sst = single.advance(single.start(s), 2)
    ck.save_checkpoint(path, sst)
    out = single.finish(single.advance(ck.load_checkpoint(path)))
    np.testing.assert_array_equal(out.distance, single.run(s).distance)


def test_sssp_on_cuda_equals_cpu(cuda):
    # Both expansion halves through K1 minplus on the card: distances,
    # rounds, closes and host reads equal the same engine on CPU tensors.
    from tpu_bfs_torch.workloads.sssp import SsspEngine

    g = rmat_graph(12, 16, seed=11, weights=8)
    src = np.random.default_rng(5).integers(0, g.num_vertices, size=128)
    eng, cpu = SsspEngine(g, lanes=128, device=cuda), SsspEngine(g, lanes=128, device="cpu")
    assert eng.ell.num_heavy > 0
    before = k1.ell_expand.launches
    res, want = eng.run(src), cpu.run(src)
    buckets = 1 + len(eng.ell.light)
    assert k1.ell_expand.launches - before == buckets * (res.rounds + eng.last_closes)
    assert res.rounds == want.rounds and eng.last_closes == cpu.last_closes
    assert eng.last_host_reads == cpu.last_host_reads == res.rounds + eng.last_closes
    assert torch.equal(res._dist.cpu(), want._dist)
    np.testing.assert_array_equal(res.reached, want.reached)
    np.testing.assert_array_equal(res.ecc, want.ecc)
    for i in (0, 77, 127):
        np.testing.assert_array_equal(res.distances_int32(i), want.distances_int32(i))


def test_cc_and_p2p_on_cuda_equal_cpu(cuda):
    from tpu_bfs_torch.workloads.cc import connected_components
    from tpu_bfs_torch.workloads.p2p import P2pServeEngine

    g = rmat_graph(12, 2, seed=3)  # sparse: many components, several sweeps
    want = connected_components(WidePackedMsBfsEngine(g, lanes=256, device="cpu"))
    before = k1.ell_expand.launches
    got = connected_components(WidePackedMsBfsEngine(g, lanes=256, device=cuda))
    assert k1.ell_expand.launches > before
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] > 1
    g = rmat_graph(12, 16, seed=11)
    rng = np.random.default_rng(6)
    s, t = rng.integers(0, g.num_vertices, size=(2, 128))
    eng = P2pServeEngine(WidePackedMsBfsEngine(g, lanes=256, device=cuda))
    cpu = P2pServeEngine(WidePackedMsBfsEngine(g, lanes=256, device="cpu"))
    before = k1.ell_expand.launches
    got, want = eng.run(s, targets=t), cpu.run(s, targets=t)
    assert k1.ell_expand.launches > before
    np.testing.assert_array_equal(got.ecc, want.ecc)
    np.testing.assert_array_equal(got.reached, want.reached)
    assert [got.extras(i) for i in range(128)] == [want.extras(i) for i in range(128)]
    assert eng.last_host_reads == cpu.last_host_reads


@pytest.mark.parametrize("kind", ["hybrid", "wide"])
def test_mesh_engines_on_cuda_equal_cpu(cuda, kind):
    # DistHybridMsBfsEngine (gather dense, sparse gated, sliced gated, a
    # chained checkpoint) and DistWideMsBfsEngine (dense, sparse) on RMAT 12:
    # the one-rank NCCL group on the card equals the gloo rank on the CPU,
    # tables, counters and trees included.
    import torch_mesh_cases as cases
    from tpu_bfs_torch.parallel.mesh import start

    todo = cases.CARD_CASES if kind == "hybrid" else cases.CARD_WIDE_CASES
    on_cpu = start(1, cases.run_cases, kind, todo, device="cpu")
    got = start(1, cases.run_cases, kind, todo, device="cuda").result()
    want = on_cpu.result()
    for name, _g, _kw, _src, _mode in todo:
        cases.assert_same(got[name], want[name], name)


def test_mesh_refuses_more_ranks_than_cards(cuda):
    # One rank a card: asking for more raises before any rank starts, and
    # NCCL ranks never share a card; nothing moves to the CPU.
    import torch_mesh_cases as cases
    from tpu_bfs_torch.parallel.mesh import launch

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"requested {n} devices, only {n - 1} available"):
        launch(n, cases.fail_on_rank_one)
    with pytest.raises(ValueError, match="cannot share"):
        launch(2, cases.fail_on_rank_one, device="cuda:0", backend="nccl")


@pytest.mark.parametrize("shape,ranks,backend", [(1, 1, "nccl"), ((1, 1), 1, "nccl"),
                                                 (2, 2, "gloo"), ((1, 2), 2, "gloo")],
                         ids=["1d-nccl", "2d-nccl", "1d-gloo2", "2d-gloo2"])
def test_single_source_mesh_engines_on_cuda_equal_bfs_engine(cuda, shape, ranks, backend):
    # DistBfsEngine and Dist2DBfsEngine with the ring, allreduce and sparse
    # exchanges (and dopt) on RMAT 12, on a one-rank NCCL group and on two
    # gloo ranks sharing the card (NCCL takes one rank a card): every
    # distance array and tree equals BfsEngine's on the card, also after a
    # checkpointed traversal.
    import torch_mesh_cases as cases
    from tpu_bfs_torch.algorithms.bfs import BfsEngine
    from tpu_bfs_torch.parallel.mesh import launch

    g = rmat_graph(12, 16, seed=2)
    sources = [int(np.argmax(g.degrees)), 5, 1000]
    got = launch(ranks, cases.card_dist_rank, shape, sources,
                 device="cuda" if backend == "nccl" else "cuda:0", backend=backend)
    eng = BfsEngine(g, device=cuda)
    want = {s: eng.run(s) for s in sources}
    assert len(got) == len(cases.CARD_DIST_RUNS) * (len(sources) + 1)
    for (_run, s), (dist, parent) in got.items():
        ref = want[sources[0] if s == "ckpt" else s]
        np.testing.assert_array_equal(dist, ref.distance)
        np.testing.assert_array_equal(parent, ref.parent)


@pytest.mark.parametrize("ranks,backend", [(1, "nccl"), (2, "gloo")], ids=["nccl1", "gloo2"])
def test_dist_sssp_on_cuda_equals_sssp_engine(cuda, ranks, backend):
    # DistSsspEngine (ring, allreduce, sparse with delta ids and prediction)
    # on a one-rank NCCL group and on two gloo ranks sharing the card:
    # distances, rounds and closes equal SsspEngine's on the card; every
    # expansion is a K1 minplus launch a bucket, and K1 on the rank's shard
    # tables (light and full planes) equals its twin.
    import torch_mesh_cases as cases
    from tpu_bfs_torch.parallel.mesh import launch
    from tpu_bfs_torch.workloads.sssp import SsspEngine

    g = rmat_graph(12, 16, seed=11, weights=8)
    src = np.random.default_rng(5).integers(0, g.num_vertices, size=128)
    want = SsspEngine(g, lanes=128, device=cuda).run(src)
    got = launch(ranks, cases.card_sssp_rank, device="cuda" if backend == "nccl" else "cuda:0",
                 backend=backend)
    assert len(got) == len(cases.CARD_SSSP_RUNS)
    for i, rec in got.items():
        for j, lane in enumerate((0, 77, 127)):
            np.testing.assert_array_equal(rec["dists"][j], want.distances_int32(lane))
        assert rec["rounds"] == want.rounds
        assert rec["launches"] == rec["buckets"] * (rec["rounds"] + rec["closes"])
        assert rec["errs"] == [0, 0]
        assert rec["counts"].sum() == rec["rounds"]


def test_mesh_kinds_on_cuda_equal_cpu(cuda):
    # CC, k-hop and p2p over DistWideMsBfsEngine on a one-rank NCCL group
    # equal the same adapters over a gloo rank on the CPU.
    import torch_mesh_cases as cases
    from tpu_bfs_torch.parallel.mesh import start

    on_cpu = start(1, cases.mesh_kinds_rank, device="cpu")
    got = start(1, cases.mesh_kinds_rank, device="cuda").result()
    want = on_cpu.result()
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(got[key], dict):
            for f in got[key]:
                a, b = got[key][f], want[key][f]
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=f"{key} {f}")
                else:
                    assert a == b, (key, f)
        elif isinstance(got[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key], key


def _serve_stream(device, g, queries, **kw):
    from tpu_bfs_torch.serve import BfsService

    with BfsService(g, device=device, autostart=False, **kw) as svc:
        pend = [svc.submit(**q) for q in queries]
        svc.start()
        return [p.result(300) for p in pend], svc.statsz()


def test_serve_on_cuda_equals_cpu(cuda):
    # An RMAT 12 query stream (every kind, distance-free queries) through
    # BfsService on the card equals the same stream on the CPU.
    from dataclasses import replace

    from tpu_bfs_torch.graph.generate import edge_weights

    g = rmat_graph(12, 16, seed=4)
    g = replace(g, weights=edge_weights(*g.coo, seed=1, wmax=8))
    src = [int(s) for s in np.random.default_rng(2).choice(g.num_vertices, 300)]
    queries = ([{"source": s, "want_distances": i % 4 != 0} for i, s in enumerate(src[:200])]
               + [{"source": s, "kind": "sssp"} for s in src[200:240]]
               + [{"source": s, "kind": "khop", "k": 2} for s in src[240:260]]
               + [{"source": s, "kind": "cc"} for s in src[260:270]]
               + [{"source": s, "kind": "p2p", "target": t}
                  for s, t in zip(src[270:285], src[285:300])])
    kw = dict(lanes=256, width_ladder="auto", linger_ms=50.0)
    got, snap = _serve_stream("cuda", g, queries, **kw)
    want, _ = _serve_stream("cpu", g, queries, **kw)
    assert snap["errors"] == 0
    for a, b in zip(got, want):
        assert a.ok and b.ok, (a.error, b.error)
        assert (a.kind, a.levels, a.reached, a.extras, a.batch_lanes, a.dispatched_lanes) \
            == (b.kind, b.levels, b.reached, b.extras, b.batch_lanes, b.dispatched_lanes)
        assert (a.distances is None) == (b.distances is None)
        if a.distances is not None:
            np.testing.assert_array_equal(a.distances, b.distances)


def test_serve_extraction_stream_overlaps_next_dispatch(cuda):
    # The extraction worker copies on its own stream after the batch's
    # event: with a slow fetch, batch N+1 is dispatched while batch N is
    # still being extracted, and every answer equals a direct batch.
    from tpu_bfs_torch import faults, obs
    from tpu_bfs_torch.serve import BfsService

    g = rmat_graph(12, 16, seed=5)
    src = [int(s) for s in np.random.default_rng(3).choice(g.num_vertices, 512)]
    svc = BfsService(g, device="cuda", lanes=256, width_ladder="off",
                     single_flight=False)
    rec = obs.arm()
    faults.arm_from_spec("slow@fetch:ms=300:n=1")
    try:
        res = [p.result(300) for p in [svc.submit(s) for s in src]]
    finally:
        faults.disarm()
        obs.disarm()
        svc.close()
    t = {(e["name"], e["ph"], e["args"].get("batch")): e["t"] for e in rec.snapshot()
         if e["cat"] == "serve.batch" and e["name"] in ("dispatch", "extract")}
    b1, b2 = sorted({b for (_, _, b) in t})[:2]
    assert t[("dispatch", "b", b2)] < t[("extract", "e", b1)]
    eng = WidePackedMsBfsEngine(g, lanes=256, num_planes=8, device="cuda")
    for lo in (0, 256):
        direct = eng.run(np.asarray(src[lo:lo + 256]))
        for i in range(256):
            np.testing.assert_array_equal(res[lo + i].distances, direct.distances_int32(i))
