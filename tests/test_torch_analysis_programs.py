"""The port's program passes (tpu_bfs_torch/analysis: uniformity, transfer,
dtype, memory, the FX walk, configs and the CLI) against the JAX package's
(tpu_bfs/analysis).

Each of JAX's seeded-defect cases in tests/test_analysis.py has one
counterpart here, built from the port's own objects: host code for the
uniformity taint (JAX's taint reads the jaxpr; the port's branch choice
is host Python), ``torch.export`` programs for the dtype, host-op and
memory checks. JAX's own dtype and uniformity tests are red on jax 0.9.0,
so those cases hold the port to the defect, not to JAX's output. Then the
passes run over the port: ``--fast`` and the full CPU sweep read 0 new
findings, the ladder model stays strictly monotone for every registry
family, and the CLI keeps JAX's flags, JSON keys and exit codes.
"""

import json

import numpy as np
import pytest

from tpu_bfs.analysis import memory as jmemory

import torch

from tpu_bfs_torch.analysis import (
    PASSES,
    Finding,
    apply_baseline,
    load_baseline,
    memory,
    transfer,
    uniformity,
)
from tpu_bfs_torch.analysis import dtypes
from tpu_bfs_torch.analysis.cli import judged_baseline, main
from tpu_bfs_torch.analysis.graph import user_input_names, walk_program
from tpu_bfs_torch.utils.aot import ArgSpec, export_program

from torch_threads import cap_torch_threads

cap_torch_threads()


def _taint(src: str, name: str = "fix.py"):
    return uniformity.check_sources({name: src})


# --- uniformity: the AST taint, seeded ---------------------------------------------

_DIVERGENT = '''
def bad(x: torch.Tensor, mesh):
    m = x.max().item()  # per rank: not all-reduced
    if m > 3:
        return mesh.all_reduce_(x, "sum")
    return x * 2
'''

_REDUCED = '''
def good(x: torch.Tensor, mesh):
    m = mesh.all_reduce_(x.max().reshape(1), "max").item()
    if m > 3:
        return mesh.all_reduce_(x, "sum")
    return x * 2
'''

_COLLECTIVE_FREE = '''
def dopt_like(x: torch.Tensor, mesh):
    m = x.sum().item()  # per rank, but neither arm communicates
    if m > 3:
        return x * 2
    return x + 1
'''


def test_divergent_branch_scalar_flagged():
    rep = _taint(_DIVERGENT)
    assert len(rep.findings) == 1, rep.findings
    f = rep.findings[0]
    assert f.pass_name == "uniformity" and f.where == "fix.py:4 (bad)"
    assert "'mesh'" in f.message and "deadlock" in f.message


def test_all_reduced_branch_scalar_certified():
    rep = _taint(_REDUCED)
    assert rep.findings == [] and rep.certified_divergent_safe >= 1


def test_collective_free_divergence_is_safe():
    rep = _taint(_COLLECTIVE_FREE)
    assert rep.findings == [] and rep.certified_divergent_safe == 0


def test_axis_granular_uniformity_2d():
    ok = '''
def row_ok(x: torch.Tensor, mesh):
    m = mesh.c.all_reduce_(x.max().reshape(1), "max").item()  # uniform over 'c' only
    if m > 3:
        return mesh.c.all_reduce_(x, "sum")
    return x * 2
'''
    rep = _taint(ok)
    assert rep.findings == [] and rep.certified_divergent_safe >= 1
    rep = _taint(ok.replace("return mesh.c.all_reduce_(x", "return mesh.r.all_reduce_(x"))
    assert len(rep.findings) == 1 and "['r']" in rep.findings[0].message


def test_all_to_all_output_is_not_uniform():
    bad = '''
def bad(x: torch.Tensor, mesh):
    g = mesh.all_gather_rows(x)  # uniform
    recv = mesh.all_to_all(g.view(mesh.num_shards, -1))  # per rank
    m = recv.max().item()
    if m > 3:
        return mesh.all_reduce_(x, "sum")
    return x * 2
'''
    rep = _taint(bad)
    assert len(rep.findings) == 1, [f.render() for f in rep.findings]
    fixed = bad.replace("m = recv.max().item()",
                        'm = mesh.all_reduce_(recv.max().reshape(1), "max").item()')
    rep = _taint(fixed)
    assert rep.findings == [] and rep.certified_divergent_safe >= 1
    ring = bad.replace("mesh.all_to_all(g.view(mesh.num_shards, -1))", "mesh.ring_shift(g)")
    assert len(_taint(ring).findings) == 1  # a ring shift's output is per rank too


def test_divergent_while_with_collectives_flagged():
    rep = _taint('''
def bad_loop(st: torch.Tensor, mesh):
    while st.sum().item() < 100:  # per rank
        st = st + mesh.all_reduce_(st.clone(), "sum")
    return st
''')
    assert len(rep.findings) == 1 and "while" in rep.findings[0].message


def test_uniformity_through_loop_carried_state():
    rep = _taint('''
def carried(acc: torch.Tensor, mesh):
    u = mesh.all_reduce_(acc.max().reshape(1), "max").item()
    while u < 100:  # the carried uniform scalar drives the loop
        if u > 3:  # and selects the branch
            acc = mesh.all_reduce_(acc.clone(), "sum")
        else:
            acc = acc * 2
        u = u + mesh.all_reduce_(acc.max().reshape(1), "max").item()
    return acc
''')
    assert rep.findings == [], [f.render() for f in rep.findings]
    assert rep.certified_divergent_safe >= 2


def test_planner_measure_is_certified_and_its_removal_flagged():
    """The exchange planner's branch (the sieve, then the rung and its
    encoding) hangs on ``measure``'s all-reduced (count, gap) pair. The
    real module proves clean; a copy whose measure skips the all-reduce is
    flagged at the branch it feeds."""
    from pathlib import Path

    import tpu_bfs_torch.parallel.collectives as coll

    src = Path(coll.__file__).read_text()
    rep = uniformity.check_sources({"parallel/collectives.py": src})
    assert rep.findings == [] and rep.certified_divergent_safe >= 10
    old = 'return mesh.all_reduce_(pair, "max").tolist()  # the phase-1 read'
    assert old in src
    rep = uniformity.check_sources({"parallel/collectives.py": src.replace(
        old, "return pair.tolist()")})
    assert rep.findings, "a rank-local measure must be flagged"
    assert all("planned_sparse_exchange_or" in f.where for f in rep.findings)


def test_uniformity_tree_clean_and_annotation_counted():
    findings, info = uniformity.check_tree(str(_root()))
    assert findings == [], [f.render() for f in findings]
    assert info["modules"][0] == "parallel/collectives.py" and len(info["modules"]) == 6
    assert info["certified_divergent_safe"] >= 80
    line = next(i for i, ln in enumerate(
        (_root() / "tpu_bfs_torch/parallel/dist_sssp.py").read_text().splitlines(), 1)
        if "# uniform:" in ln)
    assert info["annotated_uniform"] == [f"parallel/dist_sssp.py:{line}"]


def _root():
    from pathlib import Path

    return Path(__file__).resolve().parent.parent


# --- dtype --------------------------------------------------------------------------


def _walk(fn, *args):
    return walk_program(export_program(fn, args))


def test_dtype_pass_flags_f64():
    findings = dtypes.check_walk("seeded-f64", _walk(lambda x: x * 2.0,
                                                     torch.ones(4, dtype=torch.float64)))
    assert findings and findings[0].pass_name == "dtype"
    assert "float64" in findings[0].message
    assert findings[0].fingerprint == "dtype:seeded-f64:aten.mul.Tensor"
    assert dtypes.check_walk("clean", _walk(lambda x: x * 2.0, torch.ones(4))) == []


def test_dtype_pass_flags_i64_widening():
    findings = dtypes.check_walk("seeded-i64", _walk(
        lambda x: torch.cumsum(x.to(torch.int64), 0), torch.arange(4, dtype=torch.int32)))
    assert findings and "int64" in findings[0].message
    assert dtypes.check_walk("clean", _walk(
        lambda x: torch.cumsum(x, 0, dtype=torch.int32), torch.arange(4, dtype=torch.int32))) == []


_TEST_LIB = torch.library.Library("tpu_bfs_torch_analysis_test", "DEF")
_TEST_LIB.define("widen(Tensor x) -> Tensor")
_TEST_LIB.impl("widen", lambda x: x.to(torch.int64), "CPU")
torch.library.register_fake("tpu_bfs_torch_analysis_test::widen",
                            lambda x: x.new_empty(x.shape, dtype=torch.int64), lib=_TEST_LIB)


def test_dtype_pass_reads_registered_op_nodes():
    """A registered op's outputs come from its fake kernel and schema: a
    seeded op widening to int64 is flagged like any other node, and K1's
    own node (int32 words) is clean."""
    from tpu_bfs_torch.ops.ell_expand import ell_expand_op

    seeded = _walk(lambda x: torch.ops.tpu_bfs_torch_analysis_test.widen(x) + 1,
                   torch.ones(4, dtype=torch.int32))
    findings = dtypes.check_walk("seeded-op", seeded)
    assert [f.where for f in findings][:1] == [
        "seeded-op:tpu_bfs_torch_analysis_test.widen.default"]
    need = torch.ones(1, dtype=torch.int32)
    gt = torch.zeros((2, 128), dtype=torch.int32)
    fw = torch.ones((129, 2), dtype=torch.int32)
    k1 = _walk(lambda n, g, f: ell_expand_op(n, g, f, None, "or"), need, gt, fw)
    assert any(n.target == "tpu_bfs_torch.ell_expand.default" for n in k1.nodes)
    assert dtypes.check_walk("k1", k1) == []


# --- transfer -----------------------------------------------------------------------


def test_host_item_in_a_program_flagged():
    leaky = _walk(lambda x: x * x.sum().item(), torch.ones(4))
    findings = transfer.check_host_ops("seeded-item", leaky)
    assert findings and findings[0].pass_name == "transfer"
    assert "host" in findings[0].message and findings[0].where == "seeded-item:aten.item.default"
    assert transfer.check_host_ops("clean", _walk(lambda x: x * x.sum(), torch.ones(4))) == []


def test_guard_drive_refuses_the_cpu():
    with pytest.raises(ValueError, match="card only"):
        transfer.check_guard_drive("cpu", lambda x: x, (torch.ones(2),))


@pytest.fixture(scope="module")
def adopted_wide():
    """A wide engine exported and adopted in a fresh store."""
    import tempfile

    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.analysis.configs import _graph
    from tpu_bfs_torch.utils.aot import (
        ArtifactStore,
        adopt_engine_programs,
        export_engine_programs,
    )

    eng = WidePackedMsBfsEngine(_graph(), lanes=64, device="cpu")
    spec = {"graph_key": "t", "engine": "wide", "lanes": 64, "planes": eng.num_planes}
    with tempfile.TemporaryDirectory() as root:
        store = ArtifactStore(root)
        export_engine_programs(eng, spec, store)
        adopted = adopt_engine_programs(eng, spec, store)
        yield eng, store, adopted


def test_retrace_sentinel_catches_a_retrace(adopted_wide):
    eng, store, adopted = adopted_wide
    assert "core" in adopted
    n = eng.num_vertices
    turn = {"i": 0}

    def same_shape(engine):
        turn["i"] += 1
        return engine.fetch(engine.dispatch((np.arange(engine.lanes) + turn["i"]) % n))

    assert transfer.check_adopted_retrace("toy", eng, same_shape, store) == []

    def varying(engine):  # the second drive passes an int64 word index
        res = same_shape(engine)
        idx = torch.tensor(0, dtype=torch.int64 if turn["i"] % 2 == 0 else torch.int32)
        engine._extract_word(res._planes, res._vis, res._src_bits, idx)
        return res

    turn["i"] = 0
    bad = transfer.check_adopted_retrace("toy", eng, varying, store)
    assert bad and bad[0].pass_name == "transfer/retrace"
    assert bad[0].where == "toy:aot_runtime_fallbacks"
    fresh = type(eng)(eng.g if hasattr(eng, "g") else _graph_of(), lanes=64, device="cpu")
    assert transfer.check_adopted_retrace("fresh", fresh, same_shape, store)[0].where == \
        "fresh:aot-adopt"


def _graph_of():
    from tpu_bfs_torch.analysis.configs import _graph

    return _graph()


def test_lazy_distance_contract(adopted_wide):
    eng = adopted_wide[0]
    assert transfer.check_lazy_distances("wide", eng, np.arange(eng.lanes) % 96) == []


# --- memory -------------------------------------------------------------------------


def test_walk_peak_and_in_place_writes():
    def fn(a, b):
        t = a + b  # 64 bytes
        u = t * 2  # 64 bytes, t dead after
        b.add_(1)  # in place: no new bytes
        return u.sum()

    ep = export_program(fn, (torch.ones(16), torch.ones(16)))
    walk = walk_program(ep)
    assert walk.input_bytes == 128
    assert walk.temp_peak_bytes == 128  # t and u live together; then u and the sum
    assert list(walk.mutated_inputs) == [user_input_names(ep)[1]]
    est = memory.estimate_walk("toy", walk)
    assert est["peak_bytes"] == 128 + 128 and est["source"] == "fx-walk"


def test_in_place_certificate_red_and_green():
    from tpu_bfs_torch.parallel.dist_bfs import claim_step

    vloc = 8
    flag = ArgSpec((vloc,), torch.bool, torch.device("cpu"))
    args = (flag, flag, ArgSpec((vloc,), torch.int32, torch.device("cpu")),
            ArgSpec((), torch.int32, torch.device("cpu")))
    ep = export_program(claim_step, args)
    walk = walk_program(ep)
    assert memory.documented_in_place(claim_step) == (1, 2)
    assert memory.check_in_place("claim", walk, (1, 2), user_input_names(ep)) == []

    def claim_step_copy(hit, visited, dist, level):  # returns fresh tables instead
        new = hit & ~visited
        return new, dist.masked_fill(new, level), visited | new

    ep = export_program(claim_step_copy, args)
    bad = memory.check_in_place("claim", walk_program(ep), (1, 2), user_input_names(ep))
    assert [f.where for f in bad] == ["claim:args_1", "claim:args_2"]
    assert all(f.pass_name == "memory/in-place" for f in bad)


def test_k2_out_mutation_comes_from_its_schema():
    from tpu_bfs_torch.ops.tile_spmm import tile_spmm_op

    row_start = torch.tensor([0, 1], dtype=torch.int32)
    col_tile = torch.zeros(1, dtype=torch.int32)
    masks = torch.zeros((1, 128, 4), dtype=torch.int32)
    fw = torch.zeros((128, 2), dtype=torch.int32)
    out = torch.zeros((128, 2), dtype=torch.int32)
    ep = export_program(lambda r, c, m, f, o: tile_spmm_op(r, c, m, f, o, 1),
                        (row_start, col_tile, masks, fw, out))
    walk = walk_program(ep)
    names = user_input_names(ep)
    assert walk.mutated_inputs == {names[4]: ["tpu_bfs_torch.tile_spmm.default"]}


def test_ladder_model_monotone_for_registry_families():
    findings, ladders = memory.check_registry_ladders(
        num_vertices=1 << 21, num_edges=1 << 25, device_count=8)
    assert findings == []
    jl = jmemory.registry_ladder_families(num_vertices=1 << 21, num_edges=1 << 25,
                                          device_count=8)
    assert set(ladders) == set(jl)
    for fam in ladders:
        assert [w for w, _ in ladders[fam]] == [w for w, _ in jl[fam]], fam
        assert all(b1 > b0 for (_, b0), (_, b1) in zip(ladders[fam], ladders[fam][1:]))


def test_ladder_bytes_against_jax_pinned():
    """The port prices the packed tables at their exact width with its own
    live-table count (``auto_lanes``: planes + 8 tables); JAX at
    TPU-physical width (every table under 128 words pads to 128) with
    planes + 6. Both pinned at the flagship's RMAT 21 on one device."""
    kw = dict(planes=8, devices=1, num_vertices=1 << 21, num_edges=1 << 25)
    rows = (1 << 21) + 1
    for lanes in (32, 4096):
        mine = memory.model_spec_peak_bytes("wide", lanes, **kw)
        theirs = jmemory.model_spec_peak_bytes("wide", lanes, **kw)
        w = lanes // 32
        assert mine["state_bytes"] == (8 + 8) * rows * w * 4
        assert theirs["state_bytes"] == (8 + 6) * rows * max(w, 128) * 4
        assert mine["lane_bytes"] == theirs["lane_bytes"]
        assert mine["fixed_bytes"] == theirs["fixed_bytes"]
    assert memory.model_spec_peak_bytes("wide", 32, **kw)["total_bytes"] == 402654400
    assert jmemory.model_spec_peak_bytes("wide", 32, **kw)["total_bytes"] == 15300829312


def test_non_monotone_two_rung_ladder_flagged():
    bad = memory.check_ladder_entries("toy", [(32, 100), (64, 100)])
    assert len(bad) == 1 and bad[0].pass_name == "memory/ladder"
    assert bad[0].where == "toy:w32->w64" and "strictly monotone" in bad[0].message
    dup = memory.check_ladder_entries("toy", [(32, 100), (32, 200)])
    assert dup[0].where == "toy:w32"
    assert memory.check_ladder_entries("toy", [(32, 100), (64, 101)]) == []


# --- baseline and CLI ---------------------------------------------------------------


def test_baseline_split_and_stale(tmp_path):
    base = tmp_path / "b.txt"
    base.write_text("# comment\nlocks:a.py:X.y@f\ndtype:p/core:aten.sum.default\n")
    fs = [Finding("locks", "a.py:X.y@f", "m1"), Finding("locks", "b.py:Z.w@g", "m2")]
    new, suppressed, stale = apply_baseline(fs, load_baseline(str(base)))
    assert [f.where for f in new] == ["b.py:Z.w@g"]
    assert [f.where for f in suppressed] == ["a.py:X.y@f"]
    assert stale == {"dtype:p/core:aten.sum.default"}
    assert load_baseline(str(tmp_path / "missing.txt")) == set()
    # A program entry is judged only where its program was analysed.
    judged = judged_baseline(load_baseline(str(base)), set(), ["q/core"])
    assert judged == {"locks:a.py:X.y@f"}
    assert judged_baseline(load_baseline(str(base)), {"locks"}, ["p/core"]) == {
        "dtype:p/core:aten.sum.default"}


def test_fingerprint_ignores_message():
    a, b = Finding("dtype", "p:x", "one"), Finding("dtype", "p:x", "two")
    assert a.fingerprint == b.fingerprint == "dtype:p:x"


def test_port_baseline_entries_have_reasons():
    from tpu_bfs_torch.analysis import DEFAULT_BASELINE

    lines = open(DEFAULT_BASELINE).read().splitlines()
    entries = [i for i, ln in enumerate(lines) if ln.strip() and not ln.startswith("#")]
    assert entries
    for i in entries:  # each entry sits under a reason comment, no blank line between
        j = i
        while j > 0 and lines[j - 1].strip() and not lines[j - 1].startswith("#"):
            j -= 1
        assert lines[j - 1].startswith("#"), lines[i]


def test_cli_json_report_shape(capsys):
    rc = main(["--fast", "--json"])
    out = capsys.readouterr().out
    report = json.loads(out)
    assert rc == 0 and report["ok"] is True
    assert set(report) == {"ok", "findings", "suppressed", "stale_baseline", "passes"}
    assert {"uniformity", "locks", "memory", "lifecycle", "faultcov"} <= set(report["passes"])
    assert report["passes"]["memory"]["ladders"]["wide-d1"][0]["lanes"] == 32


def test_cli_rejects_unknown_skip(capsys):
    assert main(["--fast", "--skip", "nonesuch"]) == 2
    assert "unknown pass" in capsys.readouterr().err


def test_cli_full_run_without_a_card_names_the_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the full run would use it")
    assert main(["--skip", "locks"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_fast_run_reads_zero_new_findings(capsys):
    assert main(["--fast"]) == 0
    err = capsys.readouterr().err
    for name in PASSES:
        assert f"# {name}: 0 finding(s)" in err
    assert "0 new, 0 stale" in err


def test_full_cpu_sweep_reads_zero_new_findings(capsys):
    """Every buildable config exported on 2 gloo CPU ranks: 0 new findings;
    the parked ones each under a reason in the port's baseline."""
    from tpu_bfs_torch.analysis.configs import ALL_CONFIGS, NOT_BUILT

    assert main(["--device", "cpu", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["findings"] == [] and report["stale_baseline"] == []
    programs = report["passes"]["dtype"]["programs"]
    assert {p.split("/")[0] for p in programs} == set(ALL_CONFIGS) - set(NOT_BUILT)
    assert {"1d-sparse-planner/claim", "1d-sparse-planner/level_expand",
            "2d-sparse-planner/dist_core", "hybrid-sliced/dist_settle",
            "serve-dist-sssp/dist_sssp_core", "serve-sssp/sssp_light"} <= set(programs)
    estimates = {e["program"]: e for e in report["passes"]["memory"]["program_estimates"]}
    assert len(estimates) == len(programs)
    assert all(e["peak_bytes"] >= e["argument_bytes"] > 0 for e in estimates.values())
    assert estimates["1d-sparse-planner/claim"]["in_place_inputs"] == ["args_1", "args_2"]
    sentinels = report["passes"]["transfer"]["sentinels"]
    assert "core" in sentinels["adopted"] and sentinels["aot_runtime_fallbacks"] == 0
    assert {f["pass"] for f in report["suppressed"]} == {"dtype"}
