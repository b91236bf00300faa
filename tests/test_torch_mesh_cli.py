"""The mesh engines through the front doors: the CLI's --devices N
(single-source and --multi-source) and --mesh RxC, and Graph500's
mode='hybrid', devices=N, against the JAX package's on its virtual
devices, and their refusals.

Each run spawns its gloo ranks (``parallel.mesh.launch``); rank 0's output
is printed by the process that spawned them.
"""

import contextlib
import io

import numpy as np
import pytest

from tpu_bfs_torch import cli, graph500

from torch_threads import cap_torch_threads

cap_torch_threads()


def _run_cli(main, argv):
    """stdout lines of ``main(argv)``, which must return 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _lines(lines, *prefixes):
    return [ln for ln in lines if ln.startswith(prefixes)]


_MESH_ARGV = ["3", "rmat:scale=8,ef=8,seed=2", "--multi-source", "1,2,200,77", "--devices",
              "2", "--stats"]


@pytest.mark.parametrize("flags", [["--exchange", "sparse"],
                                   ["--exchange", "sliced", "--pull-gate"],
                                   ["--engine", "wide", "--exchange", "sparse"]])
def test_cli_devices_multi_source_equals_jax(flags):
    # --devices 2 --multi-source: two gloo ranks print what the JAX CLI
    # prints on two virtual devices (the hybrid unless --engine wide).
    from tpu_bfs import cli as jcli

    jlines = _run_cli(jcli.main, _MESH_ARGV + flags)
    lines = _run_cli(cli.main, _MESH_ARGV + flags + ["--device", "cpu"])
    assert "Output OK" in lines and "Output OK" in jlines
    assert _lines(lines, "source ") == _lines(jlines, "source ") and len(_lines(lines, "source ")) == 5
    assert _lines(lines, '{"level"') == _lines(jlines, '{"level"') and _lines(lines, '{"level"')
    assert ("--pull-gate" in flags) == all('"gated_tiles"' in ln for ln in _lines(lines, '{"level"'))


@pytest.mark.parametrize("flags", [["--engine", "packed"], ["--exchange", "allreduce"],
                                   ["--engine", "wide", "--exchange", "sliced"],
                                   ["--engine", "wide", "--pull-gate"]])
def test_cli_mesh_refusals_equal_jax(flags):
    from tpu_bfs import cli as jcli

    argv = _MESH_ARGV + flags + ["--skip-cpu"]
    with pytest.raises(SystemExit) as want:
        with contextlib.redirect_stdout(io.StringIO()):
            jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and "--" in str(got.value)


_PLANNER = ["--sparse-delta", "--sparse-sieve", "--sparse-predict"]


@pytest.mark.parametrize("argv", [
    ["3", "rmat:scale=8", "--devices", "2", "--wire-pack"],
    ["3", "rmat:scale=8", "--mesh", "2x2", "--exchange", "sparse", "--sparse-delta"],
    ["3", "rmat:scale=9,ef=8,seed=2", "--devices", "4", "--exchange", "sparse",
     "--wire-pack"] + _PLANNER,
    ["3", "rmat:scale=8", "--mesh", "1x2", "--exchange", "sparse", "--backend", "dopt"]
    + _PLANNER,
    _MESH_ARGV + ["--engine", "wide", "--exchange", "sparse", "--sparse-delta", "--wire-pack"],
])
def test_cli_planner_mesh_runs_equal_jax(argv, tmp_path):
    # The exchange planner's flags run and print what the JAX CLI prints.
    # On a mesh of several rows JAX's planner may deadlock on its virtual
    # devices when rows split (tests/test_torch_dist2d.py), so there the
    # JAX side runs the ring: the printed results do not depend on the
    # exchange.
    from tpu_bfs import cli as jcli

    jargv = list(argv)
    if "2x2" in argv:
        jargv = [a for a in argv if a not in _PLANNER + ["--exchange", "sparse"]]
    saves = ["--save-dist", str(tmp_path / "d.npy")]
    jlines = _run_cli(jcli.main, jargv + saves + ["--stats"])
    want = np.load(tmp_path / "d.npy")
    lines = _run_cli(cli.main, argv + saves + ["--stats", "--device", "cpu"])
    assert "Output OK" in lines and "Output OK" in jlines
    for prefix in ("Number of", "Reached ", '{"level"', "source "):
        assert _lines(lines, prefix) == _lines(jlines, prefix)
    assert _lines(lines, '{"level"')
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), want)


_SINGLE_ARGV = ["0", "rmat:scale=9,ef=8,seed=2", "--stats"]


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--devices", "4", "--exchange", "sparse"],
                                   ["--devices", "2", "--exchange", "allreduce", "--backend",
                                    "dopt"],
                                   ["--mesh", "1x2"],
                                   ["--mesh", "2x2", "--exchange", "sparse", "--backend",
                                    "dopt"]])
def test_cli_single_source_mesh_equals_jax(flags, tmp_path):
    # The reference's ./a.out src graph on a mesh: the port's gloo ranks
    # print what the JAX CLI prints on its virtual devices (the level
    # stats, the reached line, the checks), and save the same arrays.
    from tpu_bfs import cli as jcli

    saves = ["--save-dist", str(tmp_path / "d.npy"), "--save-parent", str(tmp_path / "p.npy")]
    jlines = _run_cli(jcli.main, _SINGLE_ARGV + flags + saves)
    want = [np.load(tmp_path / "d.npy"), np.load(tmp_path / "p.npy")]
    lines = _run_cli(cli.main, _SINGLE_ARGV + flags + saves + ["--device", "cpu"])
    assert "Output OK" in lines and "Output OK" in jlines
    for prefix in ("Number of", "Reached ", '{"level"'):
        assert _lines(lines, prefix) == _lines(jlines, prefix) and _lines(lines, prefix)
    assert _lines(lines, "Traversed edges: ")[0].split("GTEPS")[0] == (
        _lines(jlines, "Traversed edges: ")[0].split("GTEPS")[0])
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), want[0])
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), want[1])


@pytest.mark.parametrize("flags", [["--devices", "2", "--backend", "tiled"],
                                   ["--mesh", "2x2", "--backend", "delta"],
                                   ["--wire-pack"],
                                   ["--sparse-sieve"],
                                   ["--devices", "2", "--sparse-delta"],
                                   ["--mesh", "1x2", "--exchange", "allreduce",
                                    "--sparse-predict"],
                                   ["--multi-source", "1,2", "--devices", "2", "--exchange",
                                    "sparse", "--sparse-sieve"],
                                   ["--devices", "2", "--backend", "tiled", "--pull-gate"],
                                   ["--mesh", "2x2", "--exchange", "sliced"],
                                   ["--mesh", "2by2"]])
def test_cli_single_source_mesh_refusals_equal_jax(flags, capsys):
    # The JAX CLI's usage errors, word for word after the program name.
    from tpu_bfs import cli as jcli

    argv = ["3", "rmat:scale=8"] + flags + ["--skip-cpu"]
    with pytest.raises(SystemExit) as want, contextlib.redirect_stdout(io.StringIO()):
        jcli.main(argv)
    want_err = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    got_err = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert got.value.code == want.value.code == 2
    assert got_err == want_err and "--" in got_err


def test_mesh_modes_refused_like_jax():
    with pytest.raises(ValueError, match="single-device"):
        graph500.run_graph500(8, 4, mode="batched", devices=2, device="cpu")
    with pytest.raises(ValueError, match="shards 1D"):
        graph500.run_graph500(8, 4, mode="hybrid", mesh2d=(2, 2), device="cpu")


@pytest.mark.parametrize("exchange", [None, "sliced"])
def test_hybrid_mesh_equals_jax(exchange):
    # mode='hybrid', devices=2: the sharded engine on two gloo ranks
    # validates its searches, and every search reaches the vertices and
    # edges it reaches in JAX's run on two virtual devices.
    from tpu_bfs import graph500 as jg500

    kw = dict(num_searches=8, validate_searches=3, mode="hybrid", devices=2,
              exchange=exchange)
    got = graph500.run_graph500(9, 8, device="cpu", **kw)
    want = jg500.run_graph500(9, 8, **kw)
    assert got.validated and want.validated and got.mode == "hybrid"
    assert got.num_searches == want.num_searches == 8
    # One batch time shares out evenly, so TEPS ratios are traversed-edge ratios.
    np.testing.assert_allclose(np.divide(got.teps, got.teps[0]),
                               np.divide(want.teps, want.teps[0]), rtol=1e-12)
