"""The port's AST lints (tpu_bfs_torch/analysis: locks, lifecycle,
faultcov) against the JAX package's (tpu_bfs/analysis).

JAX's lint tests (tests/test_analysis.py) run here on the same fixture
sources, imported from that file: each finding's pass, location key
(which names the line's code) and message must equal JAX's. Then each
pass runs over the port itself and reads 0 findings, and so does
``python -m tpu_bfs_torch.analysis``.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import test_analysis as jt
from tpu_bfs.analysis import Finding as JFinding
from tpu_bfs.analysis import faultcov as jfaultcov
from tpu_bfs.analysis import lifecycle as jlifecycle
from tpu_bfs.analysis import locks as jlocks

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.analysis import PASSES, Finding, faultcov, lifecycle, locks, run_pass
from tpu_bfs_torch.analysis.__main__ import main as analysis_main

from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = Path(__file__).resolve().parent.parent


def _rows(findings, drop_note=False):
    rows = [(f.pass_name, f.where, f.message) for f in findings]
    if drop_note:
        # JAX's snapshot message carries a parenthetical history note the
        # port's copy leaves out; the rest of the text must be equal.
        rows = [(p, w, re.sub(r" \(the [^)]*review catch\)", "", m)) for p, w, m in rows]
    return rows


def _same(got, want, drop_note=False):
    assert _rows(got) == _rows(want, drop_note)
    return got


# --- lock lint ----------------------------------------------------------------

def test_lock_lint_clean_on_port():
    findings, info = locks.lint_tree(locks.repo_root())
    assert findings == [], [f.render() for f in findings]
    assert info["guarded_attrs"] >= 30
    assert ("BfsService._lock", "EngineRegistry._lock") in info["edges"]
    assert ("EngineRegistry._lock", "Recorder._lock") in info["edges"]
    assert all(m.startswith("tpu_bfs_torch/") for m in locks.DEFAULT_MODULES)
    assert len(locks.DEFAULT_MODULES) == len(jlocks.DEFAULT_MODULES)


def test_lock_lint_flags_unguarded_access():
    findings, _ = locks.lint_sources({"fix.py": jt._UNGUARDED_SRC})
    _same(findings, jlocks.lint_sources({"fix.py": jt._UNGUARDED_SRC})[0])
    assert len(findings) == 1
    f = findings[0]
    assert f.where == "fix.py:Box.items@bad"
    assert "guarded-by: _lock" in f.message and "items" in f.message


def test_lock_lint_flags_requires_lock_violation():
    findings, _ = locks.lint_sources({"fix.py": jt._REQUIRES_SRC})
    _same(findings, jlocks.lint_sources({"fix.py": jt._REQUIRES_SRC})[0])
    assert len(findings) == 1
    assert "requires-lock" in findings[0].message
    assert "@bad" in findings[0].where


def test_lock_lint_flags_order_cycle():
    findings, info = locks.lint_sources({"fix.py": jt._CYCLE_SRC})
    jfindings, jinfo = jlocks.lint_sources({"fix.py": jt._CYCLE_SRC})
    _same(findings, jfindings)
    assert info["edges"] == jinfo["edges"]
    cyc = [f for f in findings if f.where.startswith("lock-order:")]
    assert len(cyc) == 1
    assert "A._lock" in cyc[0].message and "B._lock" in cyc[0].message
    assert ("A._lock", "B._lock") in info["edges"]
    assert ("B._lock", "A._lock") in info["edges"]


def test_lock_lint_accepts_acquire_release_idiom_and_rlock():
    findings, _ = locks.lint_sources({"fix.py": jt._IDIOM_SRC})
    assert findings == [] == jlocks.lint_sources({"fix.py": jt._IDIOM_SRC})[0]


def test_lock_lint_nested_function_does_not_inherit_locks():
    findings, _ = locks.lint_sources({"fix.py": jt._NESTED_FN_SRC})
    _same(findings, jlocks.lint_sources({"fix.py": jt._NESTED_FN_SRC})[0])
    assert len(findings) == 1 and "@spawn" in findings[0].where


def test_find_cycles_simple():
    for edges in ({("a", "b"), ("b", "a")}, {("a", "b"), ("b", "c")},
                  {("a", "b"), ("b", "c"), ("c", "a"), ("c", "d")}):
        assert locks.find_cycles(edges) == jlocks.find_cycles(edges)
    assert locks.find_cycles({("a", "b"), ("b", "a")})
    assert not locks.find_cycles({("a", "b"), ("b", "c")})


def test_lock_lint_on_the_ports_annotated_methods():
    # The three accesses the port marks `# requires-lock: _lock` are
    # findings without the marks, as JAX's lint reads them.
    for rel, marked in (("tpu_bfs_torch/serve/registry.py", "def _warm_up("),
                        ("tpu_bfs_torch/serve/answercache.py", "def _key(")):
        src = (ROOT / rel).read_text()
        assert f"{marked}" in src
        line = next(ln for ln in src.splitlines() if marked in ln)
        assert line.endswith("# requires-lock: _lock")
        bare = src.replace(line, line.removesuffix("  # requires-lock: _lock"))
        got, _ = locks.lint_sources({rel: bare})
        want, _ = jlocks.lint_sources({rel: bare})
        _same(got, want)
        assert got and all(f"@{marked[4:-1]}" in f.where for f in got)
        assert locks.lint_sources({rel: src})[0] == []


def test_fingerprint_and_render_equal_jax():
    a = Finding("locks", "m.py:A.x@f", "one wording")
    b = Finding("locks", "m.py:A.x@f", "another wording")
    assert a.fingerprint == b.fingerprint == "locks:m.py:A.x@f"
    j = JFinding("locks", "m.py:A.x@f", "one wording")
    assert (a.fingerprint, a.render()) == (j.fingerprint, j.render())


# --- lifecycle ----------------------------------------------------------------

def _lifecycle(src):
    got, info = lifecycle.check_sources({"fix.py": src})
    want, jinfo = jlifecycle.check_sources({"fix.py": src})
    _same(got, want, drop_note=True)
    assert info == jinfo
    return got, info


def test_lifecycle_flags_dangling_span_across_raise():
    findings, _ = _lifecycle(jt._DANGLING_SPAN_SRC)
    assert len(findings) == 1
    assert findings[0].fingerprint == "lifecycle:fix.py:S.f@span:dispatch"
    assert "across a raise" in findings[0].message
    assert _lifecycle(jt._CLOSED_SPAN_SRC)[0] == []
    assert _lifecycle(jt._HANDLER_SPAN_SRC)[0] == []


def test_lifecycle_span_outlives_annotation_transfers_ownership():
    findings, info = _lifecycle(jt._OUTLIVES_SRC)
    assert findings == []
    assert info["span_outlives"] == 1


def test_lifecycle_flags_unreleased_lock_branch():
    findings, _ = _lifecycle(jt._LOCK_BRANCH_SRC)
    assert len(findings) == 1
    assert findings[0].fingerprint == "lifecycle:fix.py:S.f@lock:self._lock"
    assert _lifecycle(jt._LOCK_IDIOM_SRC)[0] == []


def test_lifecycle_flags_snapshot_without_drop():
    findings, _ = _lifecycle(jt._SNAPSHOT_LEAK_SRC)
    assert len(findings) == 1
    assert "snapshot" in findings[0].fingerprint
    assert "review catch" not in findings[0].message
    assert _lifecycle(jt._SNAPSHOT_OK_SRC)[0] == []


def test_lifecycle_break_path_skips_loop_else():
    leaky = (
        "class S:\n"
        "    def f(self, rec, items):\n"
        "        rec.begin(\"scan\", \"s1\")\n"
        "        for it in items:\n"
        "            if it:\n"
        "                break\n"
        "        else:\n"
        "            rec.end(\"scan\", \"s1\")\n"
    )
    findings, _ = _lifecycle(leaky)
    assert [f.fingerprint for f in findings] == ["lifecycle:fix.py:S.f@span:scan"]
    closed = leaky.replace("                break\n",
                           "                rec.end(\"scan\", \"s1\", early=True)\n"
                           "                break\n")
    assert _lifecycle(closed)[0] == []


def test_lifecycle_clean_on_port():
    findings, info = lifecycle.check_tree(locks.repo_root())
    assert findings == [], [f.render() for f in findings]
    assert info["span_outlives"] == 3  # query, batch, extract
    assert info["functions"] >= 150
    assert all(m.startswith("tpu_bfs_torch/") for m in lifecycle.DEFAULT_MODULES)
    assert len(lifecycle.DEFAULT_MODULES) == len(jlifecycle.DEFAULT_MODULES)


# --- faultcov -----------------------------------------------------------------

def _faultcov(prod, tests, sites):
    got, info = faultcov.check_sources(prod, tests, sites=sites)
    want, jinfo = jfaultcov.check_sources(prod, tests, sites=sites)
    _same(got, want)
    assert info == jinfo
    return got, info


def test_faultcov_flags_undeclared_consult():
    findings, _ = _faultcov({"m.py": 'ACTIVE.hit("nonexistent_site", lanes=4)\n'}, {},
                            ("dispatch",))
    assert any("undeclared:nonexistent_site" in f.fingerprint for f in findings)


def test_faultcov_flags_never_consulted_site():
    findings, _ = _faultcov({"m.py": 'ACTIVE.hit("dispatch")\n'},
                            {"t.py": '"transient@dispatch:n=1"\n'},
                            ("dispatch", "ghost_site"))
    assert [f.fingerprint for f in findings] == [
        "faultcov:faults.SITES@never-consulted:ghost_site"]


def test_faultcov_flags_uncovered_site():
    findings, info = _faultcov({"m.py": 'ACTIVE.hit("dispatch")\nACTIVE.hit("fetch")\n'},
                               {"t.py": 'spec = "transient@dispatch:n=1"\n'},
                               ("dispatch", "fetch"))
    assert [f.fingerprint for f in findings] == ["faultcov:tests@uncovered:fetch"]
    assert info["coverage"]["dispatch"] == ["transient"]


@pytest.mark.parametrize("src", [
    'SPEC = "seed=7:transient:p=0.05,corrupt_ckpt:n=1"\n',
    'x = "seed=7:transient@serve_batch:n=2,slow_extract:ms=50:n=4"\n',
    'FaultRule(kind="oom")\nFaultRule(kind="slow", site="fetch")\n',
    'sched.take("ckpt_load", "corrupt_ckpt")\n"not a spec"\n',
])
def test_faultcov_parses_spec_strings_with_default_sites(src):
    cov = faultcov.coverage_from_source(src)
    assert cov == jfaultcov.coverage_from_source(src)
    if "p=0.05" in src:
        assert cov["dispatch"] == {"transient"}
        assert cov["ckpt_save"] == {"corrupt_ckpt"}


def test_faultcov_clean_on_port():
    findings, info = faultcov.check_tree(locks.repo_root())
    assert findings == [], [f.render() for f in findings]
    assert set(info["sites"]) == set(tfaults.SITES)
    for site in tfaults.SITES:
        assert info["coverage"][site], f"site {site} has no coverage"
    assert all(loc.startswith("tpu_bfs_torch") for locs in info["sites"].values()
               for loc in locs)


# --- the runner ---------------------------------------------------------------

def test_runner_reads_zero_findings_over_the_port():
    # --fast: the passes that need no device (the full run exports the
    # programs on the card, or on the CPU with --device cpu:
    # tests/test_torch_analysis_programs.py).
    proc = subprocess.run([sys.executable, "-m", "tpu_bfs_torch.analysis", "--fast"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=subprocess_env(PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    for name in PASSES:
        assert f"# {name}: 0 finding(s)" in proc.stderr


def test_runner_exits_1_on_a_finding(tmp_path, capsys):
    shutil.copytree(ROOT / "tpu_bfs_torch", tmp_path / "tpu_bfs_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (tmp_path / "tests").mkdir()
    for p in list((ROOT / "tests").glob("test_torch_*.py")) + [ROOT / "chip_smoke.py"]:
        shutil.copy(p, tmp_path / p.relative_to(ROOT))
    reg = tmp_path / "tpu_bfs_torch/serve/registry.py"
    reg.write_text(reg.read_text().replace(
        "def _warm_up(self, spec: EngineSpec, eng) -> None:  # requires-lock: _lock",
        "def _warm_up(self, spec: EngineSpec, eng) -> None:"))
    assert analysis_main(["--root", str(tmp_path), "--pass", "locks"]) == 1
    out = capsys.readouterr().out
    assert "FINDING [locks] tpu_bfs_torch/serve/registry.py:EngineRegistry.warm_s@_warm_up" in out
    assert analysis_main(["--root", str(tmp_path), "--pass", "lifecycle",
                          "--pass", "faultcov"]) == 0
    with pytest.raises(ValueError, match="unknown pass"):
        run_pass("nonesuch", str(tmp_path))
