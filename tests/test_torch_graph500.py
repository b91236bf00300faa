"""The port's Graph500 harness against tpu_bfs.graph500.

Search keys and the TEPS numerator must equal the JAX package's on the same
seeded graphs; the hybrid mode runs on device="cpu" and validates (oracle
and certificate); the modes whose engines are not ported raise instead of
running another engine.
"""

import numpy as np
import pytest

from tpu_bfs import graph500 as jg500
from tpu_bfs.graph import generate as jgen

from tpu_bfs_torch import graph500
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.reference import bfs_scipy


@pytest.mark.parametrize("scale,ef,n", [(9, 4, 16), (10, 8, 64), (6, 2, 100)])
def test_search_keys_and_traversed_edges_match_jax(scale, ef, n):
    jg, tg = jgen.rmat_graph(scale, ef, seed=1), tgen.rmat_graph(scale, ef, seed=1)
    keys = graph500.sample_search_keys(tg, n)
    np.testing.assert_array_equal(keys, jg500.sample_search_keys(jg, n))
    assert len(set(keys.tolist())) == len(keys) and np.all(tg.degrees[keys] > 0)
    for s in keys[:4]:
        d = bfs_scipy(tg, int(s))
        assert graph500.traversed_edges(tg, d) == jg500.traversed_edges(jg, d)


def test_traversed_edges_directed_matches_jax():
    jg = jgen.random_graph(300, 1200, seed=4, directed=True)
    tg = tgen.random_graph(300, 1200, seed=4, directed=True)
    d = bfs_scipy(tg, 3)
    assert graph500.traversed_edges(tg, d) == jg500.traversed_edges(jg, d)


@pytest.mark.parametrize("validate_mode,lanes", [("oracle", 32), ("certify", None)])
def test_run_graph500_hybrid_validates(validate_mode, lanes):
    # lanes=None: the engine's auto sizing, 8192 lanes for 6 searches.
    r = graph500.run_graph500(8, 4, num_searches=6, mode="hybrid", validate_searches=3,
                              validate_mode=validate_mode, lanes=lanes, device="cpu")
    assert r.validated and r.mode == "hybrid" and len(r.teps) == r.num_searches == 6
    assert r.harmonic_mean_teps > 0 and r.graph_s > 0 and r.engine_s > 0


def test_run_graph500_hybrid_lanes_and_engine_cls():
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine

    r = graph500.run_graph500(8, 4, num_searches=40, mode="hybrid", validate_searches=2,
                              lanes=64, device="cpu")
    assert r.validated and len(r.teps) == 40
    r = graph500.run_graph500(
        8, 4, num_searches=4, mode="hybrid", validate_searches=1, device="cpu",
        engine_cls=lambda g, device: WidePackedMsBfsEngine(g, lanes=32, device=device))
    assert r.validated


@pytest.mark.parametrize("kw,item", [
    ({"mode": "single"}, "item 8"),
    ({"mode": "batched"}, "item 8"),
    ({"mode": "hybrid", "devices": 2}, "item 10"),
    ({"mode": "single", "mesh2d": (2, 4)}, "item 10"),
])
def test_unported_modes_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        graph500.run_graph500(8, 4, num_searches=2, device="cpu", **kw)


@pytest.mark.parametrize("kw", [{"backend": "dopt"}, {"exchange": "ring"}, {"verbose": True}])
def test_unported_knobs_are_not_accepted(kw):
    # The single-source backend, the mesh exchange and the progress log come
    # with the runs that read them: no option is taken and then ignored.
    with pytest.raises(TypeError, match="unexpected keyword"):
        graph500.run_graph500(8, 4, mode="hybrid", device="cpu", **kw)


@pytest.mark.parametrize("flag", [["--backend", "dopt"], ["--exchange", "ring"]])
def test_main_rejects_unported_flags(flag, capsys):
    with pytest.raises(SystemExit):
        graph500.main(["--scale", "8", "--mode", "hybrid", "--device", "cpu"] + flag)
    assert "unrecognized arguments" in capsys.readouterr().err


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="validate_mode"):
        graph500.run_graph500(8, 4, mode="hybrid", validate_mode="x", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        graph500.run_graph500(8, 4, mode="x", device="cpu")


def test_main_hybrid_and_unported(capsys):
    rc = graph500.main(["--scale", "8", "--ef", "4", "--searches", "8", "--mode", "hybrid",
                        "--validate", "2", "--lanes", "32", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "mode=hybrid searches=8 validated=True harmonic_mean_GTEPS=" in out
    with pytest.raises(SystemExit, match="not ported"):
        graph500.main(["--scale", "8", "--device", "cpu"])  # the default mode: single
