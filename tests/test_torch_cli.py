"""Front door and import purity of the PyTorch port.

The CLI validates lane 0 against the CPU oracle like tpu_bfs's
--multi-source path; without --multi-source it refuses. The port and
chip_smoke.py import neither jax nor anything of tpu_bfs: shown by a clean
subprocess import and by an AST scan of every source file.
"""

import ast
import pathlib
import subprocess
import sys

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
