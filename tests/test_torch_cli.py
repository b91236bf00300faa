"""Front door and import purity of the PyTorch port.

The CLI validates lane 0's distances and BFS tree against the CPU oracle
like tpu_bfs's --multi-source path (or certifies lane 0 with --certify), and
its --save-dist / --save-parent arrays equal those tpu_bfs's CLI writes;
without --multi-source it refuses. The port and
chip_smoke.py import neither jax nor anything of tpu_bfs: shown by a clean
subprocess import and by an AST scan of every source file.
"""

import ast
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


@pytest.mark.parametrize("engine", ["hybrid", "wide"])
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
    with pytest.raises(SystemExit, match="single-source backends are not ported yet"):
        cli.main(["0", "rmat:scale=6", "--device", "cpu"])


def test_cli_rejects_out_of_range_source():
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(["0", "random:n=50,m=100", "--multi-source", "50", "--device", "cpu"])


def test_port_imports_no_jax():
    code = (
        "import tpu_bfs_torch, tpu_bfs_torch.cli; import sys; "
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
