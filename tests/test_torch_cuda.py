"""The port's CUDA kernels and engines on a card, against their CPU forms.

Every test needs a CUDA device and skips without one: a CUDA kernel has no
CPU mode. This file imports neither jax nor tpu_bfs, so it also runs on a
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
