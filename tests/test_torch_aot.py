"""The port's AOT artifacts and kernel build cache against the JAX package's
(``tpu_bfs_torch/utils/aot.py``, ``utils/compile_cache.py``).

The store plumbing runs the same sequence through both packages' stores
and compares what they count, keep and quarantine. The engines export once
a kind (one module-scoped store), and a fresh engine adopted from it must
answer as the un-adopted engine and as the JAX engine on the same graph
and sources. The serve, JSONL and CLI cases preheat from stores that a
first run of the same package exported, with ``torch.export.export`` made
to raise on the preheated side: a preheat never traces. Everything runs on
``device="cpu"``, the kernel ops' plain twins.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from tpu_bfs import faults as jfaults
from tpu_bfs.algorithms.msbfs_packed import PackedMsBfsEngine as JPacked
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.graph import generate as jgen
from tpu_bfs.utils import aot as jaot
from tpu_bfs.serve.registry import EngineSpec as JSpec

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch import obs as tobs
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph.csr import build_csr
from tpu_bfs_torch.reference.cpu_bfs import bfs_scipy
from tpu_bfs_torch.serve.registry import EngineRegistry, EngineSpec
from tpu_bfs_torch.utils import aot, compile_cache

from torch_threads import cap_torch_threads

cap_torch_threads()

SPEC = {"graph_key": "t", "engine": "wide", "lanes": 64, "planes": 4,
        "pull_gate": False, "devices": 1}
LANES = 64
SERVE_GRAPH = "rmat:scale=8,ef=8,seed=5"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for mod in (jfaults, tfaults, tobs):
        mod.disarm()


@pytest.fixture(scope="module")
def graphs():
    return jgen.rmat_graph(9, 8, seed=12), tgen.rmat_graph(9, 8, seed=12)


def sources_of(g):
    # Seeded picks over all vertices: isolated sources and repeats included.
    return np.random.default_rng(5).integers(0, g.num_vertices, size=LANES)


# kind -> (port engine, JAX engine, registry-style spec overrides)
ENGINES = {
    "wide": (lambda g: WidePackedMsBfsEngine(g, lanes=LANES, num_planes=4, device="cpu"),
             lambda g: JWide(g, lanes=LANES, num_planes=4), {}),
    "gated": (lambda g: WidePackedMsBfsEngine(g, lanes=LANES, num_planes=4, pull_gate=True,
                                              device="cpu"),
              lambda g: JWide(g, lanes=LANES, num_planes=4, pull_gate=True),
              {"pull_gate": True}),
    "hybrid": (lambda g: HybridMsBfsEngine(g, lanes=LANES, kcap=8, tile_thr=2, num_planes=4,
                                           device="cpu"),
               lambda g: JHybrid(g, lanes=LANES, kcap=8, tile_thr=2, num_planes=4),
               {"engine": "hybrid"}),
    "packed": (lambda g: PackedMsBfsEngine(g, lanes=LANES, device="cpu"),
               lambda g: JPacked(g, lanes=LANES), {"engine": "packed", "planes": 8}),
    "adaptive": (lambda g: WidePackedMsBfsEngine(g, lanes=LANES, num_planes=4,
                                                 adaptive_push=(16, 8), device="cpu"),
                 lambda g: JWide(g, lanes=LANES, num_planes=4, adaptive_push=(16, 8)), {}),
}

_exported: dict = {}


def distances(res, i):
    d = getattr(res, "distance_u8", None)
    if d is not None and not hasattr(res, "distances_int32"):
        return np.where(d[i] == 255, -1, d[i].astype(np.int32))
    return np.asarray(res.distances_int32(i))


def exported(kind, graphs, tmp_path_factory):
    """(store, spec, un-adopted port result, inventory names) of one kind,
    exported once for the module."""
    if kind not in _exported:
        make = ENGINES[kind][0]
        eng = make(graphs[1])
        spec = dict(SPEC, **ENGINES[kind][2])
        store = aot.ArtifactStore(tmp_path_factory.mktemp(f"aot_{kind}"))
        names = aot.export_engine_programs(eng, spec, store)
        _exported[kind] = (store, spec, eng.run(sources_of(graphs[1])), names)
    return _exported[kind]


# --- keys and the store against JAX ---------------------------------------


KEY_SPECS = [
    SPEC,
    dict(SPEC, pull_gate=True, planes=8, lanes=4096, engine="hybrid"),
    dict(SPEC, devices=8, exchange="sparse", wire_pack=True, delta_bits=(8, 16), sieve=True,
         predict=True, mesh_shape=(2, 4), engine="dist2d"),
    dict(SPEC, kind="sssp"),
    dict(SPEC, kind="bfs", overlay=(256, 32)),
    EngineSpec(graph_key="rmat:scale=16", engine="hybrid", lanes=8192, planes=5,
               pull_gate=True, devices=4, kind="khop", exchange="sliced", overlay=(8, 4),
               graph_generation=3, resume_levels=2),
]


@pytest.mark.parametrize("spec", KEY_SPECS)
def test_program_key_digest_and_file_name_equal_jax(spec, tmp_path):
    jspec = spec
    if isinstance(spec, EngineSpec):
        import dataclasses

        jspec = JSpec(**dataclasses.asdict(spec))
    key = aot.program_key(spec)
    assert key == jaot.program_key(jspec)
    assert aot._key_digest(key) == jaot._key_digest(key)
    tpath = aot.ArtifactStore(tmp_path / "t").path_for(spec, "core")
    jpath = jaot.ArtifactStore(tmp_path / "j").path_for(jspec, "core")
    assert os.path.basename(tpath) == os.path.basename(jpath)
    # The port has no expand_impl axis: JAX's default key is its key.
    assert aot.program_key(dict(jspec if isinstance(jspec, dict) else key,
                                expand_impl="pallas")) == jaot.program_key(
        dict(jspec if isinstance(jspec, dict) else key))


def _corrupt_last_bytes(path):
    with open(path, "r+b") as f:
        f.seek(-10, os.SEEK_END)
        byte = f.read(1)
        f.seek(-10, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))


def _scenario(mod, fmod, root, name, monkeypatch):
    """One store sequence of JAX's test_aot.py; returns what it observed."""
    store = mod.ArtifactStore(root)
    obs = {}
    if name == "missing":
        obs["get"] = store.get(SPEC, "core")
        obs["probe"] = store.probe(SPEC)
    else:
        path = store.put(SPEC, "core", b"payload-bytes" * 20)
        if name == "round_trip":
            obs["probe"] = store.probe(SPEC)
            obs["get"] = store.get(SPEC, "core")
        elif name == "stale":
            fp = dict(mod.env_fingerprint(), format=999)
            monkeypatch.setattr(mod, "env_fingerprint", lambda: fp)
            obs["get"], obs["probe"] = store.get(SPEC, "core"), store.probe(SPEC)
        elif name == "corrupt_payload":
            _corrupt_last_bytes(path)
            obs["probe"] = store.probe(SPEC)
            obs["get"] = store.get(SPEC, "core")
            obs["again"] = store.get(SPEC, "core")
        elif name == "corrupt_header":
            with open(path, "r+b") as f:
                f.write(b"NOTMAGIC")
            obs["probe"], obs["get"] = store.probe(SPEC), store.get(SPEC, "core")
        elif name == "corrupt_aot":
            sched = fmod.arm_from_spec("corrupt_aot:n=1")
            try:
                obs["get"] = store.get(SPEC, "core")
                obs["sites"] = [e["site"] for e in sched.events]
                obs["exhausted"] = sched.exhausted()
            finally:
                fmod.disarm()
            rt = fmod.FaultSchedule.from_spec("seed=3:corrupt_aot:n=2")
            obs["spec"] = (rt.to_spec(), rt.rules[0].site)
        obs["files"] = sorted(os.listdir(root))
    obs["counts"] = store.counts()
    return obs


@pytest.mark.parametrize("name", ["round_trip", "missing", "stale", "corrupt_payload",
                                  "corrupt_header", "corrupt_aot"])
def test_store_sequence_equals_jax(name, tmp_path, monkeypatch):
    got = _scenario(aot, tfaults, tmp_path / "t", name, monkeypatch)
    want = _scenario(jaot, jfaults, tmp_path / "j", name, monkeypatch)
    assert got == want
    assert got["counts"]["aot_hits"] == (name == "round_trip")


def test_jax_artifacts_are_stale_here_and_torn_ones_quarantine_in_both(tmp_path):
    root = tmp_path / "s"
    jstore = jaot.ArtifactStore(root)
    path = jstore.put(SPEC, "core", b"jax-program" * 8)
    store = aot.ArtifactStore(root)
    # Another fingerprint: a fallback, not a quarantine.
    assert not store.probe(SPEC) and store.get(SPEC, "core") is None
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt")
    assert store.counts()["aot_fallbacks"] == 1
    assert aot.env_fingerprint() != jaot.env_fingerprint()
    # A torn header is corrupt whoever wrote it.
    for st, name in ((store, "core"), (jstore, "seed")):
        p = jstore.put(SPEC, name, b"z" * 64)
        with open(p, "r+b") as f:
            f.truncate(12)
        assert st.get(SPEC, name) is None and os.path.exists(p + ".corrupt")


# --- engines exported and adopted -----------------------------------------


@pytest.mark.parametrize("kind", list(ENGINES))
def test_adopted_engine_answers_as_unadopted_and_jax(kind, graphs, tmp_path_factory):
    jg, tg = graphs
    store, spec, base, names = exported(kind, graphs, tmp_path_factory)
    make, jmake, _ = ENGINES[kind]
    jeng = jmake(jg)
    jnames = [n for n, *_ in jeng.export_programs()]
    assert names == jnames  # JAX's inventory names, all exported
    eng = make(tg)
    assert aot.adopt_engine_programs(eng, spec, store) == names
    assert eng._aot_adopted == tuple(names)
    src = sources_of(tg)
    res = eng.run(src)
    jres = jeng.run(src)
    for r in (base, jres):
        np.testing.assert_array_equal(res.reached, r.reached)
        np.testing.assert_array_equal(res.ecc, r.ecc)
        assert res.num_levels == r.num_levels
    np.testing.assert_array_equal(res.edges_traversed, base.edges_traversed)
    for i in (0, 7, 33, 63):
        np.testing.assert_array_equal(distances(res, i), distances(base, i))
        np.testing.assert_array_equal(distances(res, i), distances(jres, i))
    # The adopted core ran every level it covers, and nothing fell back.
    assert eng._step.calls >= 1 and eng._step.fallback_calls == 0
    assert store.counts()["aot_runtime_fallbacks"] == 0


def test_narrower_batch_is_a_runtime_fallback_with_equal_answers(graphs, tmp_path_factory):
    store, spec, base, names = exported("wide", graphs, tmp_path_factory)
    eng = ENGINES["wide"][0](graphs[1])
    aot.adopt_engine_programs(eng, spec, store)
    src = sources_of(graphs[1])
    before = store.counts()["aot_runtime_fallbacks"]
    narrow = eng.run(src[[5, 9, 11]])
    for lane, i in enumerate((5, 9, 11)):
        np.testing.assert_array_equal(narrow.distances_int32(lane), base.distances_int32(i))
    # The seed's arguments are 3 long, not the exported 64; the level step
    # (full tables) still runs the adopted program.
    assert eng._seed.fallback_calls >= 1 and eng._step.fallback_calls == 0
    assert store.counts()["aot_runtime_fallbacks"] > before


def test_artifacts_hold_no_table_and_name_the_kernel_ops(graphs, tmp_path_factory):
    store, spec, _base, names = exported("hybrid", graphs, tmp_path_factory)
    for name in names:
        path = store.path_for(spec, name)
        meta, off = store._read_header(path)
        assert meta["key"] == aot.program_key(spec) and meta["name"] == name
        assert meta["fingerprint"] == aot.env_fingerprint()
        assert "donate_argnums" not in meta
        with open(path, "rb") as f:
            f.seek(off)
            payload = f.read()
        assert meta["payload_crc32"] == aot._crc32(payload)
        ep = aot.load_program(payload)
        const = sum(t.numel() * t.element_size() for t in ep.constants.values()
                    if isinstance(t, torch.Tensor))
        assert const <= 256, (name, const)  # the 32 bit shifts at most
        targets = aot.AdoptedProgram(name, ep, None).graph_targets()
        assert not any("copy_" in t for t in targets)
        if name == "core":
            assert "tpu_bfs_torch.ell_expand.default" in targets
            assert "tpu_bfs_torch.tile_spmm.default" in targets


def test_registry_names_adopt_and_build_spans(graphs, tmp_path):
    store = aot.ArtifactStore(tmp_path / "store")
    spec = EngineSpec(graph_key="g", engine="wide", lanes=64, planes=4)
    rec = tobs.arm(capacity=512)
    cold = EngineRegistry(warm=False, aot_store=store, device="cpu")
    cold.add_graph("g", graphs[1])
    cold.get(spec)
    counts = rec.counts_by_name()
    assert counts.get("engine_build") and not counts.get("engine_adopt")
    assert cold.adoptions == 0
    cold.export_resident()
    assert store.counts()["aot_exports"] == 5
    rec = tobs.arm(capacity=512)
    warm = EngineRegistry(warm=False, aot_store=str(tmp_path / "store"), device="cpu")
    warm.add_graph("g", graphs[1])
    eng = warm.get(spec)
    counts = rec.counts_by_name()
    assert counts.get("engine_adopt") and not counts.get("engine_build")
    assert counts.get("aot_load", 0) >= 5
    assert warm.adoptions == 1 and len(eng._aot_adopted) == 5
    # A mesh spec refuses the store, naming where mesh AOT waits.
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 6 \(mesh AOT"):
        warm.get(EngineSpec(graph_key="g", engine="wide", lanes=64, planes=4, devices=2))


def test_a_rebuilt_graph_with_moved_buckets_does_not_adopt_the_old_programs(graphs, tmp_path):
    """A compaction drops a graph's engines and re-adds a new base under the
    same key. One added edge moves a vertex from the 1-slot to the 2-slot
    bucket: every table keeps its padded shape, but the programs slice each
    bucket at its old row count. The layout in the artifact's header makes
    them stale; the rebuilt engine runs eagerly and answers as SciPy, and
    its own export then serves a successor."""
    tg = graphs[1]
    s, d = tg.coo
    g2 = build_csr(np.concatenate([s, [261, 138]]), np.concatenate([d, [138, 261]]),
                   tg.num_vertices)
    store = aot.ArtifactStore(tmp_path / "store")
    spec = EngineSpec(graph_key="g", engine="wide", lanes=64, planes=4)
    reg = EngineRegistry(warm=False, aot_store=store, device="cpu")
    reg.add_graph("g", tg)
    old = reg.get(spec)
    reg.export_resident()
    reg.drop_graph_engines("g")
    reg.add_graph("g", g2)
    before = store.counts()
    rec = tobs.arm(capacity=512)
    new = reg.get(spec)

    def shapes(e):
        return {k: tuple(v.shape) for k, v in e.arrs.items()}

    assert shapes(new) == shapes(old) and new._table_rows == old._table_rows
    assert aot.layout_digest(new) != aot.layout_digest(old)
    assert new._aot_adopted == () and reg.adoptions == 0
    assert rec.counts_by_name().get("aot_adopt_failed") == 1
    after = store.counts()
    assert after["aot_fallbacks"] - before["aot_fallbacks"] == 5
    assert after["aot_hits"] == before["aot_hits"] == 0
    src = sources_of(g2)
    res = new.run(src)
    for i in (0, 7, 33, 63):
        np.testing.assert_array_equal(distances(res, i), bfs_scipy(g2, int(src[i])))
    # What the check prevents: the old programs forced onto the new tables.
    forced = WidePackedMsBfsEngine(g2, lanes=64, num_planes=4, device="cpu")
    forced.adopt_programs({
        name: aot.AdoptedProgram(name, aot.load_program(store.get(spec, name)), fn)
        for name, _attr, fn, _args in forced.export_programs()})
    bad = forced.run(src)
    assert any(not np.array_equal(distances(bad, i), bfs_scipy(g2, int(src[i])))
               for i in range(LANES))
    # The rebuilt engine's export replaces the artifacts: a successor adopts.
    reg.export_resident()
    succ = EngineRegistry(warm=False, aot_store=store, device="cpu")
    succ.add_graph("g", g2)
    eng = succ.get(spec)
    assert succ.adoptions == 1 and len(eng._aot_adopted) == 5
    np.testing.assert_array_equal(eng.run(src).distances_int32(7), res.distances_int32(7))


def test_shared_ell_is_checked_and_freed_with_the_last_engine(graphs):
    from tpu_bfs_torch.graph.ell import build_ell

    tg = graphs[1]
    with pytest.raises(ValueError, match="kcap=64, the engine asks 32"):
        WidePackedMsBfsEngine(tg, lanes=64, kcap=32, ell=build_ell(tg), device="cpu")
    reg = EngineRegistry(warm=False, capacity=1, device="cpu")
    reg.add_graph("a", tg)
    reg.add_graph("b", graphs[1])
    wide = EngineSpec(graph_key="a", engine="wide", lanes=64, planes=4)
    reg.get(wide)
    reg.get(EngineSpec(graph_key="a", engine="packed", lanes=32, planes=8))
    assert list(reg._ells) == ["a"]  # one rung of "a" still resident
    reg.get(EngineSpec(graph_key="b", engine="wide", lanes=64, planes=4))
    assert list(reg._ells) == ["b"]  # "a"'s last engine went, and its ELL
    assert reg.evict(EngineSpec(graph_key="b", engine="wide", lanes=64, planes=4))
    assert reg._ells == {}


def _no_trace(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a preheated process must not trace")

    monkeypatch.setattr(torch.export, "export", refuse)


def test_service_preheats_the_whole_ladder_without_tracing(graphs, tmp_path, monkeypatch):
    from tpu_bfs_torch.serve import BfsService

    tg = graphs[1]
    store_dir = str(tmp_path / "store")
    svc = BfsService(tg, lanes=64, width_ladder="32,64", linger_ms=1.0, device="cpu")
    try:
        base = {s: svc.query(s, timeout=120.0) for s in (0, 3, 5)}
        assert all(r.ok for r in base.values())
        assert svc.export_aot(store_dir) == {"programs": 10, "engines": 2}
    finally:
        svc.close()
    _no_trace(monkeypatch)
    rec = tobs.arm(capacity=2048)
    pre = BfsService(tg, lanes=64, width_ladder="32,64", linger_ms=1.0, aot_dir=store_dir,
                     device="cpu")
    try:
        counts = rec.counts_by_name()
        assert counts.get("engine_adopt", 0) >= 2 and not counts.get("engine_build")
        snap = pre.statsz()
        assert snap["aot"]["aot_hits"] == 10 and snap["aot"]["aot_fallbacks"] == 0
        for s, b in base.items():
            r = pre.query(s, timeout=120.0)
            assert r.ok and r.levels == b.levels and r.reached == b.reached
            np.testing.assert_array_equal(r.distances, b.distances)
    finally:
        pre.close()


def _serve_jsonl(extra, requests):
    from tpu_bfs_torch.serve import frontend

    argv = [SERVE_GRAPH, "--lanes", "64", "--ladder", "32,64", "--linger-ms", "5",
            "--statsz-interval-s", "0", "--device", "cpu", *extra]
    args = frontend.build_arg_parser().parse_args(argv)
    out, err = io.StringIO(), io.StringIO()
    assert frontend.run_server(args, stdin=io.StringIO(requests), stdout=out, stderr=err) == 0
    lines = sorted(json.dumps({k: v for k, v in json.loads(ln).items() if k != "latency_ms"},
                              sort_keys=True)
                   for ln in out.getvalue().splitlines() if ln.strip())
    ready = [ln for ln in err.getvalue().splitlines() if "READY" in ln]
    return lines, ready, err.getvalue()


def test_jsonl_export_then_preheat_prints_the_ready_extras(tmp_path, monkeypatch):
    store = str(tmp_path / "store")
    reqs = "".join(json.dumps({"id": i, "source": s}) + "\n" for i, s in enumerate((1, 4, 9)))
    first, ready1, err1 = _serve_jsonl(["--export-aot", store], reqs)
    assert "aot export -> " in err1 and "10 programs from 2 engines" in err1
    # JAX's READY line: no extras without a store of the service's own.
    assert len(ready1) == 1 and ready1[0].startswith("# READY engine=wide lanes=64 ladder=[32, 64]")
    assert "aot_" not in ready1[0]
    _no_trace(monkeypatch)
    second, ready2, _ = _serve_jsonl(["--preheat", store], reqs)
    assert ready2 == [ready1[0] + " aot_hits=10 aot_fallbacks=0"]
    assert second == first


def test_cli_aot_lines_equal_jax_and_the_refusal(tmp_path, capsys):
    from tpu_bfs import cli as jcli
    from tpu_bfs_torch import cli as tcli

    argv = ["0", "rmat:scale=8,ef=8,seed=5", "--multi-source", "1,2,3", "--skip-cpu"]

    jd, td = str(tmp_path / "jstore"), str(tmp_path / "tstore")

    def aot_lines(main, extra):
        assert main(argv + extra) in (0, None)
        err = capsys.readouterr().err
        return [ln.replace(jd, "DIR").replace(td, "DIR") for ln in err.splitlines()
                if ln.startswith("[aot]")]

    want = aot_lines(jcli.main, ["--aot", jd])
    got = aot_lines(tcli.main, ["--aot", td, "--device", "cpu"])
    assert got == want == ["[aot] no adoptable artifacts in DIR; running JIT (the store "
                           "is populated after this run)", "[aot] exported 4 programs -> DIR"]
    again = aot_lines(tcli.main, ["--aot", td, "--device", "cpu"])
    assert again[0].startswith("[aot] aot adopted ['core', 'extract', 'lane_stats', "
                               "'lane_ecc'] for PackedMsBfsEngine/w32")
    assert again[-1] == "[aot] exported 4 programs -> DIR"
    msgs = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit):
            main(["0", "rmat:scale=8", "--aot", td])
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert msgs[0] == msgs[1] and msgs[0].startswith("--aot pairs with --multi-source")


def test_op_dispatch_tool_times_every_layer_on_the_cpu():
    from tpu_bfs_torch.ops import ell_expand as k1
    from tpu_bfs_torch.tools import op_dispatch

    before = k1.ell_expand.launches
    out = op_dispatch.measure("cpu", 20)
    assert set(out["us_per_call"]) == {"wrapper", "op", "custom_op", "kernel"}
    assert all(v > 0 for v in out["us_per_call"].values())
    assert k1.ell_expand.launches == before


# --- the kernel build cache -------------------------------------------------


@pytest.fixture
def fresh_cache(monkeypatch):
    compile_cache.reset_resolution()
    for var in ("TPU_BFS_BENCH_XLA_CACHE", "TPU_BFS_BENCH_CACHE"):
        monkeypatch.delenv(var, raising=False)
    yield
    compile_cache.reset_resolution()


def test_cache_explicit_path_wins(fresh_cache, monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_BFS_BENCH_XLA_CACHE", str(tmp_path / "explicit"))
    monkeypatch.setenv("TPU_BFS_BENCH_CACHE", str(tmp_path / "derived"))
    msgs = []
    assert compile_cache.enable_compile_cache(log=msgs.append) == str(tmp_path / "explicit")
    assert os.path.isdir(tmp_path / "explicit") and not os.path.exists(tmp_path / "derived")
    assert any("kernel build cache" in m for m in msgs)


def test_cache_derived_under_bench_cache(fresh_cache, monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_BFS_BENCH_CACHE", str(tmp_path / "bc"))
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(str(tmp_path / "bc"), "xla_cache") and os.path.isdir(path)


def test_cache_default_is_the_package_build_directory(fresh_cache):
    from tpu_bfs_torch.ops import _build

    assert compile_cache.enable_compile_cache() == str(_build.BUILD_DIR)
    assert _build.kernel_dir() == _build.BUILD_DIR


def test_cache_empty_string_disables_into_a_private_directory(fresh_cache, monkeypatch,
                                                              tmp_path):
    from tpu_bfs_torch.ops import _build

    monkeypatch.setenv("TPU_BFS_BENCH_XLA_CACHE", "")
    monkeypatch.setenv("TPU_BFS_BENCH_CACHE", str(tmp_path / "unused"))
    msgs = []
    assert compile_cache.enable_compile_cache(log=msgs.append) is None
    assert msgs == [] and not os.path.exists(tmp_path / "unused")
    monkeypatch.setattr(_build, "_PRIVATE_DIR", None)
    private = _build.kernel_dir()
    assert private.is_dir() and private != _build.BUILD_DIR
    assert _build.kernel_dir() == private  # one a process


def test_cache_resolves_once_a_process(fresh_cache, monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_BFS_BENCH_XLA_CACHE", str(tmp_path / "once"))
    msgs = []
    first = compile_cache.enable_compile_cache(log=msgs.append)
    monkeypatch.setenv("TPU_BFS_BENCH_XLA_CACHE", str(tmp_path / "other"))
    assert compile_cache.enable_compile_cache(log=msgs.append) == first
    assert len(msgs) == 1 and not os.path.exists(tmp_path / "other")
    assert compile_cache.enable_compile_cache(force=True) == str(tmp_path / "other")


def test_cache_disabled_outcome_is_kept(fresh_cache, monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_BFS_BENCH_XLA_CACHE", "")
    assert compile_cache.enable_compile_cache() is None
    monkeypatch.setenv("TPU_BFS_BENCH_XLA_CACHE", str(tmp_path / "late"))
    assert compile_cache.enable_compile_cache() is None
    assert not os.path.exists(tmp_path / "late")


def test_cache_unmakeable_directory_degrades(fresh_cache, monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("TPU_BFS_BENCH_XLA_CACHE", str(blocker / "cache"))
    msgs = []
    assert compile_cache.enable_compile_cache(log=msgs.append) is None
    assert any("unavailable" in m for m in msgs)


# --- fault coverage ----------------------------------------------------------


def test_every_declared_fault_site_is_consulted_by_the_port():
    from pathlib import Path

    from tpu_bfs.analysis.faultcov import check_sources

    root = Path(__file__).resolve().parents[1]
    prod = {str(p.relative_to(root)): p.read_text()
            for p in (root / "tpu_bfs_torch").rglob("*.py")}
    tests = {str(p.relative_to(root)): p.read_text()
             for p in [*root.glob("tests/test_torch_*.py"), root / "chip_smoke.py"]}
    findings, _ = check_sources(prod, tests, sites=tfaults.SITES)
    wheres = [f.where for f in findings if "never-consulted" in f.where or "undeclared" in f.where]
    assert wheres == []
