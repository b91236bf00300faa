"""The port's CUDA kernels and engines on a card, against their CPU forms.

Every test needs a CUDA device (marker ``cuda``) and skips without one, as
the ``cuda`` fixture decides at run time: a CUDA kernel has no CPU mode.
This file imports neither jax nor tpu_bfs, so it also runs on a
machine without them. There, skip the suite's conftest (it sets up JAX):

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
