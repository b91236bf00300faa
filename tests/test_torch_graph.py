"""Host graph layer of the PyTorch port against the JAX package.

Every array the port's builders make (CSR, ranks, ELL buckets, gate-block
tables, the hybrid split) must equal tpu_bfs's exactly, for the conftest
fixtures and a seeded RMAT scale-10 graph built independently by both.
"""

import dataclasses

import numpy as np
import pytest

from tpu_bfs.algorithms import _packed_common as jpc
from tpu_bfs.algorithms import msbfs_hybrid as jhy
from tpu_bfs.algorithms.msbfs_packed import ripple_increment as j_ripple
from tpu_bfs.graph import ell as jell
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.reference import cpu_bfs as jref

import torch

from tpu_bfs_torch import convert
from tpu_bfs_torch.algorithms import _packed_common as tpc
from tpu_bfs_torch.algorithms import msbfs_hybrid as thy
from tpu_bfs_torch.algorithms.msbfs_packed import ripple_increment_
from tpu_bfs_torch.graph import ell as tell
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.reference import bfs_python, bfs_scipy
from tpu_bfs_torch.validate import ValidationError, check_distances

from conftest import TOY_TEXT

from torch_threads import cap_torch_threads

cap_torch_threads()

# (name, JAX builder, port builder): the same seeded inputs on both sides.
GRAPHS = {
    "toy": (lambda: jio.read_edge_list_text(TOY_TEXT),
            lambda: tio.read_edge_list_text(TOY_TEXT)),
    "random_small": (lambda: jgen.random_graph(500, 2000, seed=12345),
                     lambda: tgen.random_graph(500, 2000, seed=12345)),
    "random_disconnected": (lambda: jgen.random_graph(300, 150, seed=7),
                            lambda: tgen.random_graph(300, 150, seed=7)),
    "rmat_small": (lambda: jgen.rmat_graph(10, 8, seed=3),
                   lambda: tgen.rmat_graph(10, 8, seed=3)),
    "rmat10": (lambda: jgen.rmat_graph(10, 16, seed=11),
               lambda: tgen.rmat_graph(10, 16, seed=11)),
    "line": (lambda: jio.from_edges(np.arange(63), np.arange(1, 64), num_vertices=64),
             lambda: tio.from_edges(np.arange(63), np.arange(1, 64), num_vertices=64)),
    "directed": (lambda: jgen.random_graph(200, 900, seed=5, directed=True),
                 lambda: tgen.random_graph(200, 900, seed=5, directed=True)),
}

_cache = {}


def pair(name):
    if name not in _cache:
        jb, tb = GRAPHS[name]
        _cache[name] = (jb(), tb())
    return _cache[name]


def assert_same(a, b, path="obj"):
    """Recursive exact equality of dataclass-like field trees."""
    if dataclasses.is_dataclass(a):
        a = dataclasses.asdict(a)
    if dataclasses.is_dataclass(b):
        b = dataclasses.asdict(b)
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_csr_equal(name):
    jg, tg = pair(name)
    assert_same(jg, tg)
    assert tg.num_vertices == jg.num_vertices and tg.num_edges == jg.num_edges
    np.testing.assert_array_equal(tg.degrees, jg.degrees)
    for a, b in zip(tg.coo, jg.coo):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_rank_vertices_equal(name):
    jg, tg = pair(name)
    src, dst = jg.coo
    for a, b in zip(tell.rank_vertices(src, dst, tg.num_vertices),
                    jell.rank_vertices(src, dst, jg.num_vertices)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kcap", [4, 64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_ell_equal(name, kcap):
    jg, tg = pair(name)
    assert_same(jell.build_ell(jg, kcap=kcap), tell.build_ell(tg, kcap=kcap))


@pytest.mark.parametrize("name", ["rmat_small", "rmat10", "random_small"])
def test_pad_gate_blocks_and_kernel_tables_equal(name):
    jg, tg = pair(name)
    je, te = jell.build_ell(jg, kcap=8), tell.build_ell(tg, kcap=8)
    for b in te.light:
        idx_t = np.ascontiguousarray(b.idx.T)
        np.testing.assert_array_equal(
            tell.pad_gate_blocks(idx_t, te.num_active),
            jell.pad_gate_blocks(idx_t, je.num_active),
        )
    assert_same(jpc.pallas_expand_arrays(je, je.num_active),
                tpc.pallas_expand_arrays(te, te.num_active))


@pytest.mark.parametrize("tile_thr,kcap", [(2, 8), (4, 64), (1, 4), (10**6, 64)])
@pytest.mark.parametrize("name", ["rmat_small", "rmat10", "random_small", "toy"])
def test_build_hybrid_equal(name, tile_thr, kcap):
    jg, tg = pair(name)
    jh = jhy.build_hybrid(jg, kcap=kcap, tile_thr=tile_thr)
    th = thy.build_hybrid(tg, kcap=kcap, tile_thr=tile_thr)
    assert_same(jh, th)
    assert_same(jpc.pallas_expand_arrays(jh, jh.vt * 128 - 1),
                tpc.pallas_expand_arrays(th, th.vt * 128 - 1))


def test_build_hybrid_budget_trims_like_jax():
    jg, tg = pair("rmat10")
    kw = dict(kcap=16, tile_thr=2, a_budget_bytes=10 * 2048)
    jh, th = jhy.build_hybrid(jg, **kw), thy.build_hybrid(tg, **kw)
    assert th.num_tiles == 10
    assert_same(jh, th)


@pytest.mark.parametrize("name", ["rmat10", "random_small"])
def test_convert_round_trips_jax_structures(name):
    jg, _ = pair(name)
    assert_same(convert.graph_from_numpy(dataclasses.asdict(jg)), jg)
    je = jell.build_ell(jg, kcap=8)
    assert_same(convert.ell_from_numpy(dataclasses.asdict(je)), je)
    jh = jhy.build_hybrid(jg, kcap=8, tile_thr=2)
    assert_same(convert.hybrid_from_numpy(dataclasses.asdict(jh)), jh)


def test_convert_rejects_wrong_fields():
    jg, _ = pair("toy")
    fields = dataclasses.asdict(jg)
    fields.pop("row_ptr")
    with pytest.raises(ValueError, match="missing"):
        convert.graph_from_numpy(fields)


@pytest.mark.parametrize("name", ["toy", "random_disconnected", "rmat_small", "directed"])
def test_oracles_equal(name):
    jg, tg = pair(name)
    for s in (0, 1, tg.num_vertices - 1):
        d, p = bfs_python(tg, s)
        jd, jp = jref.bfs_python(jg, s)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(bfs_scipy(tg, s), jref.bfs_scipy(jg, s))


def test_check_distances():
    check_distances(np.arange(4), np.arange(4))
    with pytest.raises(ValidationError, match="1 distance mismatches"):
        check_distances(np.array([0, 1, 3]), np.array([0, 1, 2]))


def test_npz_round_trip(tmp_path):
    _, tg = pair("rmat_small")
    path = tmp_path / "g.npz"
    tio.save_npz(str(path), tg)
    assert_same(tio.load_npz(str(path)), tg)


def test_ripple_increment_equal():
    rng = np.random.default_rng(0)
    planes = [rng.integers(0, 2**32, size=(8, 3), dtype=np.uint32) for _ in range(4)]
    carry = rng.integers(0, 2**32, size=(8, 3), dtype=np.uint32)
    want = j_ripple(tuple(planes), carry)
    tp = tuple(torch.from_numpy(p.view(np.int32).copy()) for p in planes)
    tc = torch.from_numpy(carry.view(np.int32).copy())
    ripple_increment_(tp, tc)
    for a, b in zip(want, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().view(np.uint32))


def test_seed_scatter_args_equal():
    ranks = np.array([5, 0, 99, 3, 1000, 7] * 7)
    rows, words, bits = jpc.seed_scatter_args(ranks, act=100)
    t_rows, t_words, t_bits = tpc.seed_scatter_args(ranks, act=100)
    np.testing.assert_array_equal(np.asarray(rows), t_rows)
    np.testing.assert_array_equal(np.asarray(words), t_words)
    np.testing.assert_array_equal(np.asarray(bits), t_bits.view(np.uint32))


def test_auto_lanes_fits_80gb_exactly():
    # No tile padding: a 2M-row, 5-plane table at 8192 lanes is 13 tables of
    # 1 KB rows, which fits the 64 GB budget; 200M rows do not.
    assert tpc.auto_lanes(2 << 20, 5, max_lanes=8192) == 8192
    assert tpc.auto_lanes(1 << 20, 5, max_lanes=8192, hbm_budget_bytes=10**9) == 512
    with pytest.raises(tpc.PackedStateDoesntFitError):
        tpc.auto_lanes(200 << 20, 8, max_lanes=64, hbm_budget_bytes=10**9, on_unfit="raise")
    assert tpc.auto_planes(2 << 20, max_lanes=8192) == 5
    assert tpc.floor_lanes(8191) == 4096
