"""The port's Graph500 harness against tpu_bfs.graph500.

Search keys and the TEPS numerator must equal the JAX package's on the same
seeded graphs; every mode runs on device="cpu" and validates (oracle and
certificate), and the single and batched modes find the JAX package's
distances for every search, on one device and on 1D and 2D meshes of
gloo ranks (the hybrid mode on a mesh: test_torch_mesh_cli.py).
"""

import numpy as np
import pytest

from tpu_bfs import graph500 as jg500
from tpu_bfs import validate as jval
from tpu_bfs.graph import generate as jgen

from tpu_bfs_torch import graph500
from tpu_bfs_torch import validate as tval
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.reference import bfs_scipy

from torch_threads import cap_torch_threads

cap_torch_threads()


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


def _searches(pkg, val, monkeypatch, **kw):
    """{key: distances} of every search a run_graph500 call validates,
    captured at its certify_bfs call."""
    seen = {}
    real = val.certify_bfs

    def spy(g, s, dist, parent):
        seen[int(s)] = np.array(dist)
        return real(g, s, dist, parent)

    monkeypatch.setattr(val, "certify_bfs", spy)
    r = pkg.run_graph500(10, 8, num_searches=12, validate_searches=12, **kw)
    monkeypatch.setattr(val, "certify_bfs", real)
    return r, seen


@pytest.mark.parametrize("mode,backend", [("single", "scan"), ("single", "dopt"),
                                          ("batched", "scan")])
def test_run_graph500_single_and_batched_equal_jax(mode, backend, monkeypatch):
    want_r, want = _searches(jg500, jval, monkeypatch, mode=mode, backend=backend)
    got_r, got = _searches(graph500, tval, monkeypatch, mode=mode, backend=backend,
                           device="cpu")
    assert got_r.validated and got_r.mode == mode and got_r.num_searches == 12
    assert len(got_r.teps) == 12 and got_r.harmonic_mean_teps > 0
    assert got.keys() == want.keys() and len(got) == 12
    for s in want:
        np.testing.assert_array_equal(got[s], want[s])


def test_run_graph500_backend_and_engine_cls():
    from tpu_bfs_torch.algorithms.bfs import BfsEngine

    for b in ("segment", "scatter", "delta"):
        assert graph500.run_graph500(8, 4, num_searches=3, backend=b, device="cpu").validated
    with pytest.raises(KeyError, match="unknown expansion backend"):
        graph500.run_graph500(8, 4, num_searches=3, backend="tiled", device="cpu")
    r = graph500.run_graph500(
        8, 4, num_searches=3, validate_searches=3, device="cpu",
        engine_cls=lambda g, device: BfsEngine(g, backend="dopt", device=device))
    assert r.validated and r.mode == "single"


@pytest.mark.parametrize("kw", [
    {"devices": 2},
    {"devices": 4, "exchange": "sparse"},
    {"mesh2d": (1, 2)},
    {"mesh2d": (2, 2), "backend": "dopt", "exchange": "allreduce"},
])
def test_single_mode_on_a_mesh_equals_jax(kw, monkeypatch):
    # mode='single' on a 1D or 2D mesh of gloo ranks: the searches are
    # JAX's, every one validated in the ranks against SciPy and the
    # certificate, and JAX's run on its virtual devices finds those
    # distances too.
    want_r, want = _searches(jg500, jval, monkeypatch, mode="single", **kw)
    got_r = graph500.run_graph500(10, 8, num_searches=12, validate_searches=12, mode="single",
                                  device="cpu", **kw)
    assert got_r.validated and got_r.mode == "single"
    assert got_r.num_searches == want_r.num_searches == len(got_r.teps) == 12
    tg = tgen.rmat_graph(10, 8, seed=1)
    assert sorted(want) == sorted(graph500.sample_search_keys(tg, 12).tolist())
    for s, d in want.items():
        np.testing.assert_array_equal(d, bfs_scipy(tg, s))


def test_batched_mode_refuses_a_2d_mesh_like_jax():
    for pkg, kw in ((jg500, {}), (graph500, {"device": "cpu"})):
        with pytest.raises(ValueError, match="mode='batched' is single-device"):
            pkg.run_graph500(8, 4, num_searches=2, mode="batched", mesh2d=(2, 2), **kw)


@pytest.mark.parametrize("kw,exc,match", [
    ({"exchange": "sliced"}, ValueError, "devices > 1"),
    ({"verbose": True}, TypeError, "unexpected keyword"),
])
def test_unported_knobs_are_not_accepted(kw, exc, match):
    # No option is taken and then ignored: the progress log is not ported,
    # and the exchange belongs to mesh runs.
    with pytest.raises(exc, match=match):
        graph500.run_graph500(8, 4, mode="hybrid", device="cpu", **kw)


@pytest.mark.parametrize("flag,msg", [(["--exchange", "ring"], "--devices N or --mesh RxC"),
                                      (["--exchange", "sliced"], "--devices N")])
def test_main_rejects_unported_flags(flag, msg, capsys):
    with pytest.raises(SystemExit):
        graph500.main(["--scale", "8", "--mode", "hybrid", "--device", "cpu"] + flag)
    assert msg in capsys.readouterr().err


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
    assert graph500.main(["--scale", "8", "--ef", "4", "--searches", "4", "--backend", "dopt",
                          "--device", "cpu"]) == 0  # the default mode: single
    assert "mode=single searches=4 validated=True" in capsys.readouterr().out
    assert graph500.main(["--scale", "8", "--ef", "4", "--searches", "4", "--mesh", "1x2",
                          "--exchange", "sparse", "--device", "cpu"]) == 0
    assert "mode=single searches=4 validated=True" in capsys.readouterr().out
