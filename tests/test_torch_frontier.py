"""The port's edge-centric level primitives against tpu_bfs's, exactly.

``DeviceGraph``, each ``expand_or`` backend (one source and a batch of
lanes), each backend's ``level_step``, ``sparse_topdown`` at each rung of
the dopt ladder, ``active_bits_delta`` over zero-degree vertices, the
min-parent scatter and ``level_stats`` run on the same seeded inputs on both
sides (the JAX functions eagerly on the CPU, the port's on CPU tensors) and
must agree bit for bit. Two tests pin that repeated scatter indices
accumulate: a torch ``t[i] += x`` keeps one of them, JAX's ``.at[i].add``
all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bfs.algorithms import frontier as jf
from tpu_bfs.graph.csr import DeviceGraph as JDeviceGraph
from tpu_bfs.utils import stats as jstats

from tpu_bfs_torch.algorithms import frontier as tf
from tpu_bfs_torch.graph.csr import DeviceGraph
from tpu_bfs_torch.utils import stats as tstats
from tpu_bfs_torch.utils.timing import run_timed
from torch_bfs_cases import NAMES, graphs

from torch_threads import cap_torch_threads

cap_torch_threads()

_dgs = {}


def device_graphs(name):
    if name not in _dgs:
        jg, tg = graphs(name)
        _dgs[name] = (JDeviceGraph.from_graph(jg), DeviceGraph.from_graph(tg))
    return _dgs[name]


def dst_sm(dg):
    out = np.empty(dg.ep, dtype=np.int32)
    out[dg.perm_ds] = dg.dst
    return out


def edges(dg):
    """(JAX EdgeData, port EdgeData) with every optional array."""
    arrays = [dg.src, dg.dst, dg.in_row_ptr.astype(np.int32), dg.out_row_ptr.astype(np.int32),
              dg.perm_ds, dst_sm(dg)]
    return (jf.EdgeData(*[jnp.asarray(a) for a in arrays]),
            tf.EdgeData(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]))


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def assert_same(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_device_graph_equals_jax(name):
    jd, td = device_graphs(name)
    for f in ("src", "dst", "in_row_ptr", "out_row_ptr", "perm_ds"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f), err_msg=f)
    for f in ("num_vertices", "num_edges", "num_input_edges", "undirected", "vp", "ep"):
        assert getattr(td, f) == getattr(jd, f), f
    assert td.src.dtype == td.dst.dtype == td.perm_ds.dtype == np.int32


@pytest.mark.parametrize("k", [None, 5])
@pytest.mark.parametrize("backend", ["scan", "segment", "scatter"])
def test_expand_or_equals_jax(backend, k):
    _, dg = device_graphs("rmat10")
    rng = np.random.default_rng(1)
    shape = (dg.ep,) if k is None else (dg.ep, k)
    active = rng.random(shape) < 0.05
    ja, ta = both(active)
    rp = dg.in_row_ptr.astype(np.int32)
    want = jf.expand_or(ja, jnp.asarray(dg.dst), jnp.asarray(rp), dg.vp, backend=backend)
    got = tf.expand_or(ta, torch.from_numpy(dg.dst), torch.from_numpy(rp), dg.vp,
                       backend=backend)
    assert got.dtype == torch.bool and tuple(got.shape) == (dg.vp,) + shape[1:]
    assert_same(want, got)


def test_expand_segment_derives_row_pointer():
    _, dg = device_graphs("directed")
    active = np.random.default_rng(2).random(dg.ep) < 0.1
    dst = torch.from_numpy(dg.dst)
    got = tf.expand_or(torch.from_numpy(active), dst, None, dg.vp, backend="segment")
    want = tf.expand_or(torch.from_numpy(active), dst, torch.from_numpy(dg.in_row_ptr),
                        dg.vp, backend="scatter")
    assert torch.equal(got, want)
    with pytest.raises(KeyError, match="unknown expansion backend"):
        tf.expand_or(torch.from_numpy(active), dst, None, dg.vp, backend="pallas")


def frontier_pair(dg, n_front: int, seed: int):
    """A random frontier of ``n_front`` real vertices and a visited set
    holding it and a random third of the rest."""
    rng = np.random.default_rng(seed)
    f = np.zeros(dg.vp, bool)
    f[rng.choice(dg.num_vertices, size=n_front, replace=False)] = True
    vis = f.copy()
    vis[: dg.num_vertices] |= rng.random(dg.num_vertices) < 0.33
    return f, vis


@pytest.mark.parametrize("n_front", [3, 40, 1500])
@pytest.mark.parametrize("backend", ["scan", "segment", "scatter", "delta", "dopt"])
def test_level_step_equals_jax(backend, n_front):
    _, dg = device_graphs("rmat12")
    je, te = edges(dg)
    f, vis = frontier_pair(dg, n_front, n_front)
    caps = jf.default_dopt_caps(dg.ep)
    (jfr, tfr), (jvis, tvis) = both(f), both(vis)
    want = jf.level_step(je, jfr, jvis, backend=backend, caps=caps)
    got = tf.level_step(te, tfr, tvis, backend=backend, caps=caps)
    assert_same(want, got)


def test_dopt_rung_ladder_matches_the_cond_chain():
    # Each rung of rmat12's ladder, and the dense step, taken as JAX takes it.
    _, dg = device_graphs("rmat12")
    je, te = edges(dg)
    caps = tf.default_dopt_caps(dg.ep)
    assert caps == jf.default_dopt_caps(dg.ep) and len(caps) == 2
    out_deg = tf.out_degrees(te)
    taken = set()
    for n_front in (2, 200, 2000):
        f, vis = frontier_pair(dg, n_front, 7)
        nfront, fsum = tf.frontier_sums(torch.from_numpy(f), out_deg).tolist()
        assert nfront == n_front and fsum == int(np.diff(dg.out_row_ptr)[f].sum())
        taken.add(tf.dopt_rung(caps, nfront, fsum, dg.vp))
        want = jf.level_step_dopt(je, jnp.asarray(f), jnp.asarray(vis), caps=caps)
        got = tf.level_step_dopt(te, torch.from_numpy(f), torch.from_numpy(vis), caps=caps,
                                 nfront=nfront, fsum=fsum)
        assert_same(want, got)
    assert taken == set(caps) | {None}


@pytest.mark.parametrize("with_visited", [True, False])
@pytest.mark.parametrize("name,n_front,edge_cap,vert_cap", [
    ("rmat10", 4, 1024, 1024), ("rmat10", 30, 4096, 64), ("directed", 25, 1024, 32),
    # Zero-degree frontier vertices share their row start with the next one.
    ("isolated", 120, 1024, 128), ("path200", 1, 1024, 1024),
])
def test_sparse_topdown_equals_jax(name, n_front, edge_cap, vert_cap, with_visited):
    _, dg = device_graphs(name)
    je, te = edges(dg)
    f, vis = frontier_pair(dg, n_front, 11)
    want = jf.sparse_topdown(je, jnp.asarray(f), jnp.asarray(vis) if with_visited else None,
                             edge_cap=edge_cap, vert_cap=vert_cap)
    got = tf.sparse_topdown(te, torch.from_numpy(f),
                            torch.from_numpy(vis) if with_visited else None,
                            edge_cap=edge_cap, vert_cap=vert_cap)
    assert_same(want, got)
    # Against the definition: the out-neighbors of the frontier.
    sm_src = np.repeat(np.arange(dg.vp), np.diff(dg.out_row_ptr))
    truth = np.zeros(dg.vp, bool)
    truth[dst_sm(dg)[f[sm_src]]] = True
    if with_visited:
        truth &= ~vis
    np.testing.assert_array_equal(got.numpy(), truth)


def test_sparse_topdown_out_size_guard():
    # Neighbor ids at or past out_size are dropped, as JAX's mode="drop" does.
    _, dg = device_graphs("rmat10")
    je, te = edges(dg)
    f, _ = frontier_pair(dg, 6, 5)
    for out_size in (dg.vp, 300):
        want = jf.sparse_topdown(je, jnp.asarray(f), None, edge_cap=2048, vert_cap=64,
                                 out_size=out_size)
        got = tf.sparse_topdown(te, torch.from_numpy(f), None, edge_cap=2048, vert_cap=64,
                                out_size=out_size)
        assert got.shape == (out_size,)
        assert_same(want, got)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("name", ["isolated", "directed"])
def test_active_bits_delta_with_zero_degree_vertices(name, k):
    _, dg = device_graphs(name)
    assert (np.diff(dg.out_row_ptr)[: dg.num_vertices] == 0).any()
    rng = np.random.default_rng(4)
    f = np.zeros((dg.vp,) if k is None else (dg.vp, k), bool)
    f[: dg.num_vertices] = rng.random(f[: dg.num_vertices].shape) < 0.5
    want = jf.active_bits_delta(jnp.asarray(f), jnp.asarray(dg.out_row_ptr.astype(np.int32)),
                                dg.ep)
    got = tf.active_bits_delta(torch.from_numpy(f),
                               torch.from_numpy(dg.out_row_ptr.astype(np.int32)), dg.ep)
    assert_same(want, got)
    sm_src = np.repeat(np.arange(dg.vp), np.diff(dg.out_row_ptr))
    np.testing.assert_array_equal(got.numpy(), f[sm_src])


def test_active_bits_delta_accumulates_repeated_boundaries():
    # Vertices 0, 1 and 3 have no out-edges, so out_rp repeats 0 and 2: one
    # index receives up to three marks. Keeping one of them (t[i] += x)
    # would give [F, F, F] here.
    out_rp = torch.tensor([0, 0, 0, 2, 2, 3], dtype=torch.int32)
    f = torch.ones(5, dtype=torch.bool)
    got = tf.active_bits_delta(f, out_rp, 3)
    assert got.tolist() == [True, True, True]
    want = jf.active_bits_delta(jnp.ones(5, bool), jnp.asarray(out_rp.numpy()), 3)
    assert_same(want, got)


def test_nonzero_static_matches_jnp_nonzero():
    rng = np.random.default_rng(9)
    for n, size in ((50, 7), (1000, 1000)):
        m = rng.random(n) < 0.3
        want = jnp.nonzero(jnp.asarray(m), size=size, fill_value=0)[0]
        got = tf._nonzero_static(torch.from_numpy(m), size)
        assert got.dtype == torch.int32
        assert_same(want, got)


@pytest.mark.parametrize("name", ["rmat10", "directed", "isolated"])
def test_parents_equal_jax(name):
    _, dg = device_graphs(name)
    jg, tg = graphs(name)
    from tpu_bfs_torch.reference import bfs_scipy

    k = 4
    srcs = np.random.default_rng(0).integers(0, dg.num_vertices, size=k)
    dist = np.full((dg.vp, k), tf.INT32_MAX, np.int32)
    for j, s in enumerate(srcs):
        dist[: dg.num_vertices, j] = bfs_scipy(tg, int(s))
    (js, ts), (jd, td) = both(dg.src), both(dg.dst)
    assert_same(jf.min_parent_candidates(js, jd, jnp.asarray(dist)),
                tf.min_parent_candidates(ts, td, torch.from_numpy(dist)))
    for j, s in enumerate(srcs):
        col = np.ascontiguousarray(dist[:, j])
        assert_same(jf.extract_parents(js, jd, jnp.asarray(col), int(s)),
                    tf.extract_parents(ts, td, torch.from_numpy(col), int(s)))


def test_min_parent_keeps_the_least_of_repeated_targets():
    # Three candidate parents of vertex 3 in one scatter: the least wins.
    src = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    dst = torch.tensor([3, 3, 3, 1], dtype=torch.int32)
    dist = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    got = tf.min_parent_candidates(src, dst, dist)
    assert got.tolist() == [-1, 0, -1, 1]


@pytest.mark.parametrize("name", NAMES)
def test_level_stats_equal_jax(name):
    _, tg = graphs(name)
    from tpu_bfs_torch.reference import bfs_scipy

    for s in (0, tg.num_vertices - 1):
        d = bfs_scipy(tg, s)
        want = jstats.level_stats(d, tg.degrees)
        got = tstats.level_stats(d, tg.degrees)
        np.testing.assert_array_equal(got.frontier_size, want.frontier_size)
        np.testing.assert_array_equal(got.edges_scanned, want.edges_scanned)
        assert (got.reached, got.unreached, got.num_levels) == (
            want.reached, want.unreached, want.num_levels)
        assert got.json_lines() == want.json_lines()


def test_run_timed_warms_once_on_the_cpu():
    calls = []
    out, t = run_timed(lambda: calls.append(1) or len(calls), warm=True, device="cpu")
    assert out == 2 and len(calls) == 2 and t > 0
    out, t = run_timed(lambda: calls.append(1) or len(calls), warm=False, device="cpu")
    assert out == 3 and t > 0
