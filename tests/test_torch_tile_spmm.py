"""Kernel K2 (tile_spmm) of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs its plain twin; the twin must equal the
Pallas kernel under interpret=True and its NumPy oracle bit for bit,
including empty row tiles and the accumulating form (``out=``). The CUDA
row masks, which the kernel and the twin read, must hold the JAX layout's
bits. The CUDA kernel itself is held against the twin in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from tpu_bfs.ops import tile_spmm as jk

from tpu_bfs_torch.ops import tile_spmm as tk

from torch_threads import cap_torch_threads

cap_torch_threads()


def make_inputs(vt, w, *, density, seed, empty_rows=()):
    """Random dense tiles over a vt x vt tile grid; ``empty_rows`` row tiles
    get none. Returns numpy (row_start, col_tile, a_tiles uint32, fw uint32)."""
    rng = np.random.default_rng(seed)
    row_start, col_tile = [0], []
    for j in range(vt):
        cols = [] if j in empty_rows else sorted(
            rng.choice(vt, size=rng.integers(1, vt + 1), replace=False))
        col_tile += [int(c) for c in cols]
        row_start.append(len(col_tile))
    nt = len(col_tile)
    dense = (rng.random((nt, 128, 128)) < density).astype(np.int8)
    a_tiles = jk.pack_a_tiles(dense)
    fw = rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32)
    fw &= rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32)
    fw &= rng.integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32)
    return (np.array(row_start, np.int32), np.array(col_tile, np.int32), a_tiles, fw)


def torch_of(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("w", [1, 8, 128])
@pytest.mark.parametrize("density", [0.004, 0.05])
def test_twin_equals_pallas_interpret_and_oracle(w, density):
    vt = 3
    rs, ct, a, fw = make_inputs(vt, w, density=density, seed=w, empty_rows=(1,))
    got = tk.tile_spmm(torch_of(rs), torch_of(ct), torch_of(a), torch_of(fw), num_row_tiles=vt)
    got = got.numpy().view(np.uint32)
    assert not got[128:256].any()  # the empty row tile writes zeros
    np.testing.assert_array_equal(
        got, jk.tile_spmm_reference(rs, ct, a, fw, num_row_tiles=vt, w=w)
    )
    pal = jk.tile_spmm(rs, ct, a, fw, num_row_tiles=vt, w=w, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("empty_rows", [(0,), (0, 1, 2, 3)])
def test_twin_empty_row_tiles(empty_rows):
    rs, ct, a, fw = make_inputs(4, 3, density=0.02, seed=1, empty_rows=empty_rows)
    got = tk.tile_spmm_plain(torch_of(rs), torch_of(ct), torch_of(a), torch_of(fw),
                             num_row_tiles=4).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, jk.tile_spmm_reference(rs, ct, a, fw,
                                                               num_row_tiles=4, w=3))


@pytest.mark.parametrize("w", [1, 8, 33])
def test_accumulate_into_out(w):
    # out= ORs into the caller's table in place: every prior bit stays, and
    # the result is prior | tile_spmm(...) | the Pallas kernel's hits.
    vt = 3
    rs, ct, a, fw = make_inputs(vt, w, density=0.01, seed=20 + w, empty_rows=(2,))
    prior = np.random.default_rng(w).integers(0, 2**32, size=(vt * 128, w), dtype=np.uint32)
    prior &= np.random.default_rng(w + 1).integers(0, 2**32, size=prior.shape, dtype=np.uint32)
    out = torch_of(prior).clone()
    args = (torch_of(rs), torch_of(ct), torch_of(a), torch_of(fw))
    res = tk.tile_spmm(*args, num_row_tiles=vt, out=out)
    assert res is out
    got = res.numpy().view(np.uint32)
    assert np.array_equal(got & prior, prior)
    fresh = tk.tile_spmm(*args, num_row_tiles=vt).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, prior | fresh)
    np.testing.assert_array_equal(got[256:], prior[256:])  # the empty row tile
    pal = np.asarray(jk.tile_spmm(rs, ct, a, fw, num_row_tiles=vt, w=w, interpret=True))
    np.testing.assert_array_equal(got, prior | pal)


@pytest.mark.parametrize("w", [1, 33])
def test_masks_in_place_of_a_tiles(w):
    # The row masks alone (a_tiles=None), as the hybrid engine keeps them,
    # give the Pallas kernel's hits, fresh and accumulating.
    vt = 3
    rs, ct, a, fw = make_inputs(vt, w, density=0.02, seed=40 + w, empty_rows=(0,))
    r, c, f = torch_of(rs), torch_of(ct), torch_of(fw)
    masks = tk.row_masks(torch_of(a))
    pal = np.asarray(jk.tile_spmm(rs, ct, a, fw, num_row_tiles=vt, w=w, interpret=True))
    got = tk.tile_spmm(r, c, None, f, num_row_tiles=vt, masks=masks)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), pal)
    twin = tk.tile_spmm_plain(r, c, None, f, num_row_tiles=vt, masks=masks)
    np.testing.assert_array_equal(twin.numpy().view(np.uint32), pal)
    prior = torch_of(np.random.default_rng(w).integers(0, 2**32, size=(vt * 128, w),
                                                       dtype=np.uint32))
    acc = tk.tile_spmm(r, c, None, f, num_row_tiles=vt, masks=masks, out=prior.clone())
    np.testing.assert_array_equal(acc.numpy().view(np.uint32),
                                  prior.numpy().view(np.uint32) | pal)


@pytest.mark.parametrize("density", [0.0, 0.02, 1.0])
def test_row_masks_match_jax_layout(density):
    # Word q of masks[t, r] holds A[r, 32q .. 32q+31], A from the JAX layout.
    rng = np.random.default_rng(int(density * 100))
    dense = (rng.random((5, 128, 128)) < density).astype(np.int8)
    packed = jk.pack_a_tiles(dense)
    masks = tk.row_masks(torch_of(packed), chunk=2).numpy().view(np.uint32)
    assert masks.shape == (5, 128, 4)
    bits = (masks[..., None] >> np.arange(32, dtype=np.uint32)) & 1  # [t, r, q, c % 32]
    for t in range(5):
        np.testing.assert_array_equal(bits[t].reshape(128, 128), jk.unpack_a_tile(packed[t]))
    np.testing.assert_array_equal(bits.reshape(5, 128, 128), dense)


def test_dense_entries_match_unpacked_tiles():
    rs, ct, a, _ = make_inputs(3, 1, density=0.01, seed=4)
    masks = tk.row_masks(torch_of(a))
    out_row, in_row = tk.dense_entries(torch_of(rs), torch_of(ct), masks, chunk=2)
    want = set()
    row_tile = np.repeat(np.arange(3), np.diff(rs))
    for t in range(len(ct)):
        r, c = np.nonzero(jk.unpack_a_tile(a[t]))
        want |= {(int(row_tile[t] * 128 + x), int(ct[t] * 128 + y)) for x, y in zip(r, c)}
    assert set(zip(out_row.tolist(), in_row.tolist())) == want


def test_pack_unpack_equal_jax():
    rng = np.random.default_rng(2)
    dense = (rng.random((3, 128, 128)) < 0.1).astype(np.int8)
    packed = tk.pack_a_tiles(dense)
    np.testing.assert_array_equal(packed, jk.pack_a_tiles(dense))
    for t in range(3):
        np.testing.assert_array_equal(tk.unpack_a_tile(packed[t]), dense[t])
        np.testing.assert_array_equal(tk.unpack_a_tile(packed[t]), jk.unpack_a_tile(packed[t]))


def test_wrapper_rejects_bad_operands():
    rs, ct, a, fw = make_inputs(2, 2, density=0.01, seed=0)
    r, c, at, f = torch_of(rs), torch_of(ct), torch_of(a), torch_of(fw)
    with pytest.raises(ValueError, match="row_start"):
        tk.tile_spmm(r, c, at, f, num_row_tiles=3)
    with pytest.raises(TypeError, match="int32"):
        tk.tile_spmm(r, c, at.long(), f, num_row_tiles=2)
    with pytest.raises(ValueError, match="a_tiles"):
        tk.tile_spmm(r, c, at[:, :2].contiguous(), f, num_row_tiles=2)
    with pytest.raises(ValueError, match="fw must be"):
        tk.tile_spmm(r, c, at, f[:100].contiguous(), num_row_tiles=2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.tile_spmm(r.to("meta"), c.to("meta"), at.to("meta"), f.to("meta"), num_row_tiles=2)
    with pytest.raises(ValueError, match="not both"):
        tk.tile_spmm(r, c, at, f, num_row_tiles=2, masks=tk.row_masks(at))
    with pytest.raises(ValueError, match="neither"):
        tk.tile_spmm(r, c, None, f, num_row_tiles=2)
    with pytest.raises(ValueError, match="masks"):
        tk.tile_spmm(r, c, None, f, num_row_tiles=2, masks=at)
    with pytest.raises(TypeError, match="out must be"):
        tk.tile_spmm(r, c, at, f, num_row_tiles=2, out=torch.zeros(256, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="out"):
        tk.tile_spmm(r, c, at, f, num_row_tiles=2, out=torch.zeros(256, 3, dtype=torch.int32))


def test_hbm_bytes_model():
    # NT * (2 KB bit tile + [128, w] slab) + the [vt*128, w] output write.
    assert tk.tile_spmm_hbm_bytes(10, 4, 256) == 10 * (2048 + 128 * 1024) + 4 * 128 * 1024
