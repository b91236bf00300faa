"""Front door and import purity of the PyTorch port.

The CLI runs the reference's single-source BFS with each backend, and a
--multi-source batch on the engine tpu_bfs's CLI would pick (packed for
512 sources or fewer, hybrid above). It validates the distances and BFS
tree against the CPU oracle (lane 0 of a batch), or certifies them with
--certify; its --save-dist / --save-parent arrays and --stats lines equal
those tpu_bfs's CLI writes. The port and chip_smoke.py import neither jax
nor anything of tpu_bfs: shown by a clean subprocess import and by an AST
scan of every source file.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tpu_bfs_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("engine", ["hybrid", "wide"])
def test_cli_multi_source_validates(engine, capsys):
    rc = cli.main(["3", "rmat:scale=8,ef=8,seed=2", "--multi-source", "1,2,200",
                   "--engine", engine, "--lanes", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Output OK" in out
    assert out.count("source ") == 4 and "Elapsed time in milliseconds (cpu)" in out


def test_cli_reads_edge_list_file(tmp_path, capsys):
    from conftest import TOY_TEXT

    path = tmp_path / "toy.txt"
    path.write_text(TOY_TEXT)
    assert cli.main(["2", str(path), "--multi-source", "5,9", "--device", "cpu"]) == 0
    assert "source 2: reached 16 vertices" in capsys.readouterr().out


_jax_cli_files = {}


def _jax_cli_npy(tmp_path_factory, spec, sources):
    """The .npy files tpu_bfs's CLI writes for ``spec`` and ``sources``."""
    key = (spec, sources)
    if key not in _jax_cli_files:
        from tpu_bfs import cli as jcli

        d = tmp_path_factory.mktemp("jax_cli")
        src, *rest = sources.split(",")
        assert jcli.main([src, spec, "--multi-source", ",".join(rest),
                          "--save-dist", str(d / "dist.npy"),
                          "--save-parent", str(d / "parent.npy")]) == 0
        _jax_cli_files[key] = (np.load(d / "dist.npy"), np.load(d / "parent.npy"))
    return _jax_cli_files[key]


@pytest.mark.parametrize("engine", ["hybrid", "wide", "packed"])
@pytest.mark.parametrize("spec,sources", [
    ("rmat:scale=8,ef=8,seed=2", "3,1,2,200,77,5"),
    ("random:n=300,m=150,seed=7", "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,"
     "21,22,23,24,25,26,27,28,29,30,31,32,33,34,35"),  # isolated sources, > 32 lanes
])
def test_cli_saved_arrays_equal_jax(engine, spec, sources, tmp_path, tmp_path_factory,
                                    capsys):
    jdist, jparent = _jax_cli_npy(tmp_path_factory, spec, sources)
    src, *rest = sources.split(",")
    rc = cli.main([src, spec, "--multi-source", ",".join(rest), "--engine", engine,
                   "--lanes", "64", "--device", "cpu", "--save-dist", str(tmp_path / "d.npy"),
                   "--save-parent", str(tmp_path / "p.npy")])
    assert rc == 0 and "Output OK" in capsys.readouterr().out
    dist, parent = np.load(tmp_path / "d.npy"), np.load(tmp_path / "p.npy")
    assert dist.dtype == parent.dtype == np.int32
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(parent, jparent)


def test_cli_checks_lane0_parents_unless_told_not_to(monkeypatch, capsys):
    from tpu_bfs_torch import validate

    calls = []
    real = validate.check_parents
    monkeypatch.setattr(validate, "check_parents",
                        lambda *a: calls.append(a[1]) or real(*a))
    argv = ["3", "rmat:scale=8,ef=8,seed=2", "--multi-source", "1,2", "--lanes", "32",
            "--device", "cpu"]
    assert cli.main(argv) == 0 and calls == [3]
    assert cli.main(argv + ["--no-parents"]) == 0 and calls == [3]
    assert capsys.readouterr().out.count("Output OK") == 2


def test_cli_certify_lane0(monkeypatch, capsys):
    from tpu_bfs_torch import reference

    monkeypatch.setattr(reference, "bfs_golden", None)  # no golden run at all
    rc = cli.main(["3", "rmat:scale=8,ef=8,seed=2", "--multi-source", "1,2,200",
                   "--engine", "wide", "--lanes", "32", "--device", "cpu", "--certify"])
    out = capsys.readouterr().out
    assert rc == 0 and "Output certified (oracle-free, lane 0 of 4)" in out
    assert "Output OK" not in out


def test_cli_without_multi_source_refuses():
    # The batch flags would be read by nothing in a single-source run.
    for flags in (["--engine", "wide"], ["--lanes", "64"], ["--planes", "8"]):
        with pytest.raises(SystemExit, match="apply to --multi-source batches"):
            cli.main(["0", "rmat:scale=6", "--device", "cpu"] + flags)


_jax_single = {}


def _jax_single_run(tmp_path_factory, backend, spec):
    """(stdout lines, dist, parent) of tpu_bfs's CLI, single-source."""
    key = (backend, spec)
    if key not in _jax_single:
        import contextlib
        import io

        from tpu_bfs import cli as jcli

        d = tmp_path_factory.mktemp("jax_single")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.main(["0", spec, "--backend", backend, "--stats",
                              "--save-dist", str(d / "dist.npy"),
                              "--save-parent", str(d / "parent.npy")]) == 0
        _jax_single[key] = (buf.getvalue().splitlines(), np.load(d / "dist.npy"),
                            np.load(d / "parent.npy"))
    return _jax_single[key]


def _stats_lines(lines):
    return [ln for ln in lines if ln.startswith('{"level"')]


@pytest.mark.parametrize("backend", ["scan", "segment", "scatter", "delta", "dopt", "tiled"])
def test_cli_single_source_equals_jax(backend, tmp_path, tmp_path_factory, capsys):
    spec = "rmat:scale=10"
    jlines, jdist, jparent = _jax_single_run(tmp_path_factory, backend, spec)
    rc = cli.main(["0", spec, "--backend", backend, "--device", "cpu", "--stats",
                   "--save-dist", str(tmp_path / "d.npy"),
                   "--save-parent", str(tmp_path / "p.npy")])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and "Output OK" in lines
    for prefix in ("Number of vertices", "Number of edges", "Reached ", "Traversed edges: "):
        mine = [ln for ln in lines if ln.startswith(prefix)]
        theirs = [ln for ln in jlines if ln.startswith(prefix)]
        assert len(mine) == 1 and len(theirs) == 1
        if prefix != "Traversed edges: ":  # then the GTEPS, a time
            assert mine == theirs
    assert any(ln.startswith("Elapsed time in milliseconds (cpu): ") for ln in lines)
    assert _stats_lines(lines) == _stats_lines(jlines) and len(_stats_lines(lines)) > 2
    dist, parent = np.load(tmp_path / "d.npy"), np.load(tmp_path / "p.npy")
    assert dist.dtype == parent.dtype == np.int32
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(parent, jparent)


def test_cli_single_source_flags(tmp_path, capsys):
    argv = ["2", "random:n=300,m=150,seed=7", "--device", "cpu"]
    assert cli.main(argv + ["--repeat", "3", "--backend", "dopt"]) == 0
    out = capsys.readouterr().out
    assert out.count("Elapsed time in milliseconds (cpu): ") == 3 and "Output OK" in out
    assert cli.main(argv + ["--skip-cpu", "--no-parents", "--save-parent",
                            str(tmp_path / "p.npy")]) == 0
    out = capsys.readouterr().out
    assert "Output OK" not in out and "(CPU)" not in out and not (tmp_path / "p.npy").exists()
    assert cli.main(argv + ["--certify", "--backend", "tiled"]) == 0
    out = capsys.readouterr().out
    assert "Output certified (oracle-free)" in out and "(CPU)" not in out
    from tpu_bfs_torch.validate import ValidationError

    # A cut run is checked against the full golden, so it fails.
    with pytest.raises(ValidationError):
        cli.main(["0", "random:n=50,m=300,seed=1", "--max-levels", "1", "--device", "cpu"])


def test_cli_isolated_single_source(capsys):
    # Vertex 5 has no edge here: no device run, no time, one vertex reached.
    assert cli.main(["5", "random:n=300,m=150,seed=7", "--backend", "tiled",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Reached 1 vertices in 0 levels" in out and "Output OK" in out
    assert "(cpu)" not in out


class _Recorder:
    """Stands in for an engine class: records (kind, lanes) of each build."""

    def __init__(self, kind, log):
        self.kind, self.log = kind, log

    def __call__(self, g, **kw):
        self.log.append((self.kind, kw.get("lanes")))
        return self


@pytest.mark.parametrize("pull_gate,ckpt", [(False, None), (True, None), (False, "c.npz")])
@pytest.mark.parametrize("n_sources", [3, 512, 513])
def test_cli_default_engine_rule_equals_jax(n_sources, pull_gate, ckpt, monkeypatch):
    import argparse

    from tpu_bfs import cli as jcli
    from tpu_bfs.algorithms import msbfs_hybrid as jhyb
    from tpu_bfs.algorithms import msbfs_packed as jpk
    from tpu_bfs.algorithms import msbfs_wide as jwide
    from tpu_bfs_torch.algorithms import msbfs_hybrid as thyb
    from tpu_bfs_torch.algorithms import msbfs_packed as tpk
    from tpu_bfs_torch.algorithms import msbfs_wide as twide

    jlog, tlog = [], []
    for mod, log in ((jpk, jlog), (tpk, tlog)):
        monkeypatch.setattr(mod, "PackedMsBfsEngine", _Recorder("packed", log))
    for mod, log in ((jhyb, jlog), (thyb, tlog)):
        monkeypatch.setattr(mod, "HybridMsBfsEngine", _Recorder("hybrid", log))
    for mod, log in ((jwide, jlog), (twide, tlog)):
        monkeypatch.setattr(mod, "WidePackedMsBfsEngine", _Recorder("wide", log))
    common = dict(engine=None, planes=None, lanes=None, pull_gate=pull_gate,
                  ckpt=ckpt, resume=None)
    jargs = argparse.Namespace(expand_impl="xla", devices=1, wire_pack=False,
                               sparse_delta=False, adaptive_push=None, **common)
    targs = argparse.Namespace(device="cpu", devices=1, adaptive_push=None, **common)
    jcli._make_ms_engine(jargs, None, n_sources)
    cli._make_ms_engine(targs, None, n_sources)
    assert tlog == jlog
    want_packed = n_sources <= 512
    want = "packed" if want_packed else "hybrid"
    if want_packed and ckpt:
        want = "wide"
    elif want_packed and pull_gate:
        want = "hybrid"
    assert tlog[0][0] == want
    if want == "packed":
        assert tlog[0][1] == max(32, -(-n_sources // 32) * 32)


def test_cli_packed_is_the_default_for_small_batches(monkeypatch, capsys):
    from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine

    built = []
    real_init = PackedMsBfsEngine.__init__
    monkeypatch.setattr(PackedMsBfsEngine, "__init__",
                        lambda self, *a, **kw: built.append(kw["lanes"]) or real_init(
                            self, *a, **kw))
    assert cli.main(["3", "rmat:scale=8,ef=8,seed=2", "--multi-source", "1,2,200",
                     "--stats", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert built == [32] and "Output OK" in out and '{"level": 0,' in out
    with pytest.raises(SystemExit, match="--planes applies to the wide and hybrid"):
        cli.main(["3", "rmat:scale=8", "--multi-source", "1", "--planes", "8",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="--backend picks the single-source engine"):
        cli.main(["3", "rmat:scale=8", "--multi-source", "1", "--backend", "dopt",
                  "--device", "cpu"])


def test_cli_rejects_out_of_range_source():
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(["0", "random:n=50,m=100", "--multi-source", "50", "--device", "cpu"])
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(["50", "random:n=50,m=100", "--device", "cpu"])


def test_port_imports_no_jax():
    # Every module of the port, imported in a clean interpreter.
    mods = sorted(
        ".".join(f.relative_to(ROOT).with_suffix("").parts)
        for f in (ROOT / "tpu_bfs_torch").rglob("*.py") if f.name != "__main__.py"
    )
    mods = [m.removesuffix(".__init__") for m in mods]
    assert {"tpu_bfs_torch.utils.checkpoint", "tpu_bfs_torch.algorithms._packed_common",
            "tpu_bfs_torch.algorithms.bfs_tiled", "tpu_bfs_torch.graph.ell",
            "tpu_bfs_torch.parallel.mesh", "tpu_bfs_torch.parallel.collectives",
            "tpu_bfs_torch.parallel.dist_msbfs_wide",
            "tpu_bfs_torch.parallel.dist_msbfs_hybrid",
            "tpu_bfs_torch.parallel.dist_sssp", "tpu_bfs_torch.graph.dynamic",
            "tpu_bfs_torch.integrity.staleness"} <= set(mods)
    code = (
        f"import importlib, sys; [importlib.import_module(m) for m in {mods!r}]; "
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tpu_bfs.')) "
        "or m == 'tpu_bfs' for m in sys.modules), "
        "sorted(m for m in sys.modules if 'jax' in m or m.startswith('tpu_bfs.'))"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_no_jax_or_tpu_bfs_imports():
    files = sorted((ROOT / "tpu_bfs_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "tpu_bfs")
    ]
    assert bad == []


def _run_cli(main, argv):
    """stdout lines of ``main(argv)``, which must return 0."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _lines(lines, *prefixes):
    return [ln for ln in lines if ln.startswith(prefixes)]


_jax_gate_runs = {}


@pytest.mark.parametrize("engine", ["hybrid", "wide"])
def test_cli_pull_gate_equals_jax(engine):
    from tpu_bfs import cli as jcli

    argv = ["3", "rmat:scale=10,ef=16,seed=2", "--multi-source",
            ",".join(str(x) for x in range(40, 100)), "--engine", engine, "--lanes", "64",
            "--pull-gate", "--stats"]
    if engine not in _jax_gate_runs:
        _jax_gate_runs[engine] = _run_cli(jcli.main, argv)
    jlines = _jax_gate_runs[engine]
    lines = _run_cli(cli.main, argv + ["--device", "cpu"])
    assert "Output OK" in lines
    assert _lines(lines, "source ") == _lines(jlines, "source ") and len(_lines(lines, "source ")) == 61
    stats = _lines(lines, '{"level"')
    assert stats == _lines(jlines, '{"level"') and all('"gated_tiles"' in ln for ln in stats)
    assert sum(json.loads(ln)["gated_tiles"] for ln in stats) > 0  # the gate skipped blocks
    plain = _run_cli(cli.main, [a for a in argv if a != "--pull-gate"] + ["--device", "cpu"])
    assert _lines(plain, "source ") == _lines(lines, "source ")
    assert all('"gated_tiles"' not in ln for ln in _lines(plain, '{"level"'))


def test_cli_pull_gate_rules():
    with pytest.raises(SystemExit, match="--pull-gate applies to the wide/hybrid engines"):
        cli.main(["3", "rmat:scale=8", "--multi-source", "1", "--engine", "packed",
                  "--pull-gate", "--device", "cpu"])
    with pytest.raises(SystemExit):  # single source: only the tiled backend has a tile pass
        cli.main(["3", "rmat:scale=8", "--pull-gate", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["3", "rmat:scale=8", "--multi-source", "1", "--engine", "packed",
                  "--ckpt", "c.npz", "--device", "cpu"])


def test_cli_tiled_pull_gate_equals_jax(tmp_path_factory):
    from tpu_bfs import cli as jcli

    argv = ["0", "rmat:scale=10", "--backend", "tiled", "--pull-gate", "--stats"]
    jlines = _run_cli(jcli.main, argv)
    lines = _run_cli(cli.main, argv + ["--device", "cpu"])
    for prefix in ("Reached ", "Pull gate skipped ", '{"level"'):
        assert _lines(lines, prefix) == _lines(jlines, prefix) and _lines(lines, prefix)
    assert "Output OK" in lines


def _ckpt_lines(lines, path):
    return [ln.replace(str(path), "PATH") for ln in
            _lines(lines, "checkpoint", "resumed ", "source ", "Reached ", '{"level"')]


@pytest.mark.parametrize("multi", [False, True])
def test_cli_checkpoint_and_resume_cross_jax(multi, tmp_path):
    from tpu_bfs import cli as jcli

    argv = ["3", "rmat:scale=10,ef=8,seed=2", "--stats"]
    if multi:
        argv += ["--multi-source", "1,2,200,77", "--engine", "wide", "--lanes", "32"]
    jpath, tpath = tmp_path / "j.npz", tmp_path / "t.npz"
    jlines = _run_cli(jcli.main, argv + ["--ckpt", str(jpath), "--ckpt-every", "2"])
    lines = _run_cli(cli.main, argv + ["--ckpt", str(tpath), "--ckpt-every", "2",
                                       "--device", "cpu"])
    assert "Output OK" in lines and "Output OK" in jlines
    assert _ckpt_lines(lines, tpath) == _ckpt_lines(jlines, jpath)
    assert len(_lines(lines, "checkpoint")) >= 3
    # Each package resumes the other's last checkpoint; a mid-run state too.
    for main, path, other in ((cli.main, jpath, jcli.main), (jcli.main, tpath, cli.main)):
        extra = ["--device", "cpu"] if main is cli.main else []
        a = _run_cli(main, argv + ["--resume", str(path)] + extra)
        b = _run_cli(other, argv + ["--resume", str(tpath if path == jpath else jpath)]
                     + (["--device", "cpu"] if other is cli.main else []))
        assert "Output OK" in a
        assert _ckpt_lines(a, path) == _ckpt_lines(b, path)
    mid = tmp_path / "mid.npz"
    _run_cli(jcli.main, argv + ["--ckpt", str(mid), "--ckpt-every", "2", "--max-levels", "2",
                                "--skip-cpu"])  # a cut run fails the full golden
    resumed = _run_cli(cli.main, argv + ["--resume", str(mid), "--device", "cpu"])
    assert "Output OK" in resumed and any(ln.startswith("resumed ") and "at level 2" in ln
                                          for ln in resumed)
    assert _lines(resumed, "source ", "Reached ") == _lines(jlines, "source ", "Reached ")


def _path_graph_file(tmp_path, n):
    path = tmp_path / f"path{n}.txt"
    path.write_text(f"{n} {n - 1}\n" + "".join(f"{i} {i + 1}\n" for i in range(n - 1)))
    return str(path)


@pytest.mark.parametrize("flags", [[], ["--engine", "wide", "--planes", "8"],
                                   ["--engine", "hybrid", "--planes", "8"]])
def test_cli_depth_hint_at_254_levels(tmp_path, flags):
    # A 300-vertex path is deeper than any 8-plane batch counts: the run
    # still refuses, and the hint names the limit, not the failed settings.
    path = _path_graph_file(tmp_path, 300)
    with pytest.raises(SystemExit) as exc:
        cli.main(["0", path, "--multi-source", "299", "--device", "cpu", "--skip-cpu"] + flags)
    msg = str(exc.value)
    assert "truncated at 254 levels" in msg and "num_planes=8" in msg
    assert "254 levels (8 planes) is the deepest a --multi-source batch counts" in msg
    assert "--planes 8" not in msg.split("hint:")[1]
    # Fewer planes still get the rerun hint.
    with pytest.raises(SystemExit, match=r"hint: rerun with --planes 8 \(depth 254\)"):
        cli.main(["0", path, "--multi-source", "299", "--engine", "wide", "--device", "cpu",
                  "--skip-cpu"])


@pytest.mark.parametrize("argv", [
    ["9", "random:n=7,m=10"],
    ["9", "random:n=7,m=10", "--multi-source", "1"],
    ["2", "random:n=7,m=10", "--multi-source", "1,9,-1,3"],
])
def test_cli_out_of_range_text_equals_jax(argv):
    from tpu_bfs import cli as jcli

    with pytest.raises(SystemExit) as want:
        jcli.main(argv + ["--skip-cpu"])
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--skip-cpu", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "out of range [0, 7)" in str(got.value)


@pytest.mark.parametrize("spec", ["rmat:scale=8,ef=8,weights=5",
                                  "random:n=300,m=900,seed=4,weights=7", "rmat:scale=7"])
def test_cli_graph_spec_weights_equal_jax(spec):
    from tpu_bfs import cli as jcli

    want, got = jcli.load_graph(spec), cli.load_graph(spec)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    if "weights" in spec:
        np.testing.assert_array_equal(got.weights, want.weights)
        assert got.weights.min() >= 1
    else:
        assert got.weights is None and want.weights is None

