"""The port's level-adaptive push against the JAX package's.

With ``adaptive_push=(row_cap, deg_cap)`` the wide and hybrid engines send
light levels (few active rows, none of out-degree above ``deg_cap``)
through a push pass over those rows' out-edges. The port decides each
level from the plan it reads with ``alive`` and ORs with a sorted
segmented reduction (PyTorch has no bitwise-OR scatter); JAX decides with
``lax.cond`` and scatters row by row. Both must give the same raw state
(visited table and counter planes) bit for bit, hence the same distances,
parents, reached counts and levels, on the cases of
``tests/test_adaptive_push.py``: an undirected RMAT graph, a directed
graph, hub sources, a deep path (every level light), and a graph where
every level pushes and frontier rows share out-neighbours. The push
table, the refusals and the CLI flag, its guards and its warning are held
to JAX's too. JAX runs on the CPU, the port with device="cpu".
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bfs import cli as jcli
from tpu_bfs.algorithms import _packed_common as jpc
from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.algorithms.msbfs_hybrid import build_hybrid as jbuild_hybrid
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import ell as jell
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio

from tpu_bfs_torch import cli
from tpu_bfs_torch.algorithms import _packed_common as tpc
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine, build_hybrid, make_hit
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph import ell as tell
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.reference import bfs_scipy

from torch_threads import cap_torch_threads

cap_torch_threads()


def _directed():
    rng = np.random.default_rng(2)
    u, v = rng.integers(0, 300, size=900), rng.integers(0, 300, size=900)
    return (jio.from_edges(u, v, num_vertices=300, directed=True),
            tio.from_edges(u, v, num_vertices=300, directed=True))


def _path(n=200):
    u = np.arange(n - 1)
    return jio.from_edges(u, u + 1, num_vertices=n), tio.from_edges(u, u + 1, num_vertices=n)


def _max_out_degree(g):
    return int(np.bincount(g.coo[0], minlength=g.num_vertices).max())


GRAPHS = {
    "rmat": lambda: (jgen.rmat_graph(10, 8, seed=3), tgen.rmat_graph(10, 8, seed=3)),
    "directed": _directed,
    "path": _path,
}
_graphs = {}


def graphs(name):
    if name not in _graphs:
        _graphs[name] = GRAPHS[name]()
    return _graphs[name]


def _sources(case, g):
    if case in ("rmat", "share"):
        return np.flatnonzero(g.degrees > 0)[:40]
    if case == "hubs":  # above deg_cap: the ineligibility mask forces the pull
        return np.argsort(-g.degrees, kind="stable")[:16]
    return {"directed": np.array([0, 7, 200]), "path": np.array([0, 50, 199])}[case]


# case -> (graph, lanes, planes, caps); "share" pushes every level, its
# frontier rows sharing out-neighbours (a cap above every out-degree).
CASES = {
    "rmat": ("rmat", 64, 5, (128, 32)),
    "directed": ("directed", 32, 5, (64, 16)),
    "hubs": ("rmat", 32, 5, (64, 8)),
    "path": ("path", 32, 8, (64, 4)),
    "share": ("rmat", 64, 5, (4096, None)),
}


def _caps(case):
    name, _, _, (rows, deg) = CASES[case]
    return rows, deg if deg is not None else _max_out_degree(graphs(name)[1])


def _kw(case, engine):
    _, lanes, planes, _ = CASES[case]
    kw = dict(lanes=lanes if engine == "wide" else max(lanes, 64), num_planes=planes,
              adaptive_push=_caps(case))
    if engine == "hybrid":
        kw["tile_thr"] = 4
    return kw


_jax_runs = {}


def jax_run(case, engine):
    key = (case, engine)
    if key not in _jax_runs:
        jg = graphs(CASES[case][0])[0]
        make = JWide if engine == "wide" else JHybrid
        _jax_runs[key] = make(jg, interpret=True, **_kw(case, engine)).run(
            _sources(case, jg))
    return _jax_runs[key]


def u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("name", ["rmat", "directed", "path"])
def test_build_push_table_equals_jax(name):
    jg, tg = graphs(name)
    ell = tell.build_ell(tg, kcap=64)
    for deg_cap in (2, 8, 64):
        want = jpc.build_push_table(jg, ell.rank, ell.num_active, deg_cap)
        got = tpc.build_push_table(tg, ell.rank, ell.num_active, deg_cap)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_push_pass_equals_jax_and_pull_with_shared_destinations():
    # A dense frontier over a hybrid table: many active rows push into the
    # same out-neighbours. JAX's gated hit (light here) and the port's push
    # give the same bits, equal to the port's pull.
    jg, tg = graphs("rmat")
    deg = _max_out_degree(tg)
    eng = HybridMsBfsEngine(tg, lanes=64, tile_thr=4, adaptive_push=(4096, deg), device="cpu")
    push, act, rows = eng._push, eng._act, eng._table_rows
    rng = np.random.default_rng(8)
    fw = rng.integers(0, 2**32, size=(rows, eng.w), dtype=np.uint32)
    fw[rng.random(rows) < 0.5] = 0
    fw[act:] = 0
    t_fw = torch.from_numpy(fw.view(np.int32))
    active, stats = push.probe(eng.arrs, t_fw)
    plan = push.plan_of(stats.tolist())
    assert plan.light and plan.rows > 100 and plan.pairs > plan.rows
    assert plan == push.host_plan(np.flatnonzero(fw.any(axis=1)))
    got = push.hit(eng.arrs, t_fw, plan, active)
    np.testing.assert_array_equal(u32(got), u32(make_hit(eng.hg, eng.w)(eng.arrs, t_fw)))
    jarrs = {"push_t": jnp.asarray(eng.arrs["push_t"].numpy()),
             "push_inelig": jnp.asarray(eng.arrs["push_inelig"].numpy())}

    def no_pull(arrs, f):  # the push branch must be taken
        return jnp.zeros((rows, eng.w), jnp.uint32) + jnp.uint32(0xFFFFFFFF)

    want = jpc.make_adaptive_hit(no_pull, act, eng.w, rows, (4096, deg))(jarrs, jnp.asarray(fw))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", ["wide", "hybrid"])
def test_adaptive_engine_equals_jax(case, engine):
    want = jax_run(case, engine)
    tg = graphs(CASES[case][0])[1]
    src = _sources(case, tg)
    make = WidePackedMsBfsEngine if engine == "wide" else HybridMsBfsEngine
    eng = make(tg, device="cpu", **_kw(case, engine))
    res = eng.run(src)
    np.testing.assert_array_equal(u32(res._vis), np.asarray(want._vis))
    for p, q in zip(res._planes, want._planes, strict=True):
        np.testing.assert_array_equal(u32(p), np.asarray(q))
    assert res.num_levels == want.num_levels
    np.testing.assert_array_equal(res.reached, want.reached)
    np.testing.assert_array_equal(res.edges_traversed, want.edges_traversed)
    for i in range(len(src)):
        np.testing.assert_array_equal(res.distances_int32(i), want.distances_int32(i))
    for i in (0, len(src) - 1):
        np.testing.assert_array_equal(res.parents_int32(i), want.parents_int32(i))
    # One host read a level, and the light levels the case is built for.
    pushed = eng.last_push_levels
    assert eng.last_host_syncs == len(pushed) == res.num_levels + 1
    if case in ("path", "share"):
        assert all(pushed)
    elif case == "hubs":  # only the last, claim-free level is light
        assert pushed == [False] * res.num_levels + [True]
    else:
        assert any(pushed)


def test_adaptive_checkpoint_resume_equals_jax():
    # start / advance one level at a time / finish: each chunk's first plan
    # comes from the checkpoint's frontier on the host.
    tg = graphs("rmat")[1]
    src = _sources("rmat", tg)[:2]
    want = jax_run("rmat", "wide")  # lanes 0 and 1 hold the same sources
    eng = WidePackedMsBfsEngine(tg, device="cpu", **_kw("rmat", "wide"))
    st = eng.start(src)
    while not st.done:
        st = eng.advance(st, levels=1)
        assert len(eng.last_push_levels) == 1 and eng.last_host_syncs == 1
    res = eng.finish(st)
    full = eng.run(src)
    for i in range(2):
        np.testing.assert_array_equal(res.distances_int32(i), full.distances_int32(i))
        np.testing.assert_array_equal(res.distances_int32(i), want.distances_int32(i))
        np.testing.assert_array_equal(res.distances_int32(i), bfs_scipy(tg, int(src[i])))


def _message(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


def test_refusals_equal_jax():
    jg, tg = graphs("rmat")
    jh, th = jbuild_hybrid(jg, tile_thr=4), build_hybrid(tg, tile_thr=4)
    cases = [
        (lambda: JWide(jg, lanes=32, overlay=(8, 4), adaptive_push=(64, 8)),
         lambda: WidePackedMsBfsEngine(tg, lanes=32, overlay=(8, 4), adaptive_push=(64, 8),
                                       device="cpu")),
        (lambda: JWide(jg, lanes=32, pull_gate=True, adaptive_push=(64, 8)),
         lambda: WidePackedMsBfsEngine(tg, lanes=32, pull_gate=True, adaptive_push=(64, 8),
                                       device="cpu")),
        (lambda: JHybrid(jg, lanes=64, pull_gate=True, adaptive_push=(64, 8)),
         lambda: HybridMsBfsEngine(tg, lanes=64, pull_gate=True, adaptive_push=(64, 8),
                                   device="cpu")),
        (lambda: JWide(jell.build_ell(jg, kcap=64), lanes=32, adaptive_push=(64, 16)),
         lambda: WidePackedMsBfsEngine(tell.build_ell(tg, kcap=64), lanes=32,
                                       adaptive_push=(64, 16), device="cpu")),
        (lambda: JHybrid(jh, lanes=256, adaptive_push=(64, 16)),
         lambda: HybridMsBfsEngine(th, lanes=256, adaptive_push=(64, 16), device="cpu")),
    ]
    for jfn, tfn in cases:
        assert _message(tfn) == _message(jfn)


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue(), err.getvalue()


def _stable(text):
    return [ln for ln in text.splitlines() if ln.startswith(("source ", "Output", "Reached"))]


def test_cli_adaptive_push_equals_jax():
    argv = ["3", "random:n=300,m=1200,seed=5", "--multi-source", "7,9", "--engine", "wide",
            "--adaptive-push", "128,32"]
    rc, out, err = _cli(cli.main, argv + ["--device", "cpu"])
    jrc, jout, jerr = _cli(jcli.main, argv)
    assert rc == jrc == 0
    assert "Output OK" in out and _stable(out) == _stable(jout)
    # The warning's condition (1200 edges < 1e4) and advice, with no figure.
    for text in (err, jerr):
        assert "WARNING: --adaptive-push on a tiny graph (1200 edges < 1e4) usually LOSES" in text
    assert "measured" not in err


@pytest.mark.parametrize("argv", [
    ["0", "random:n=100,m=300,seed=1", "--adaptive-push", "4,4"],
    ["0", "random:n=100,m=300,seed=1", "--multi-source", "5", "--engine", "wide",
     "--adaptive-push", "0,4"],
    ["0", "random:n=100,m=300,seed=1", "--multi-source", "5", "--engine", "hybrid",
     "--adaptive-push", "4"],
    ["0", "random:n=100,m=300,seed=1", "--multi-source", "5", "--engine", "packed",
     "--adaptive-push", "4,4"],
    ["0", "random:n=100,m=300,seed=1", "--multi-source", "5", "--engine", "wide",
     "--devices", "2", "--adaptive-push", "4,4"],
    ["0", "random:n=100,m=300,seed=1", "--multi-source", "5", "--engine", "wide",
     "--pull-gate", "--adaptive-push", "4,4"],
])
def test_cli_adaptive_push_guards_equal_jax(argv):
    rc, _, err = _cli(cli.main, argv + ["--device", "cpu"])
    jrc, _, jerr = _cli(jcli.main, argv)
    assert rc == jrc == 2
    assert err.splitlines()[-1].split("error: ")[1] == jerr.splitlines()[-1].split("error: ")[1]


def test_cli_no_warning_on_big_graph():
    argv = ["0", "random:n=3000,m=12000,seed=3", "--multi-source", "1,2", "--engine", "wide",
            "--adaptive-push", "64,32", "--skip-cpu", "--no-parents"]
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        rc, _, err = _cli(main, argv + extra)
        assert rc == 0 and "usually LOSES" not in err
