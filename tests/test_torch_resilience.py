"""The port's ``resilience`` package against ``tpu_bfs.resilience``, in
process and without ranks: the failover ladder, the floor configs, the
resume policy's thresholds, the resume cache's spool files (read across the
packages both ways, a corrupt file quarantined by both), the per-graph
cache, the probe site of the heartbeat and the background prober's
promotion walk over a fake heartbeat.
"""

import numpy as np
import pytest

from tpu_bfs import faults as jfaults
from tpu_bfs.graph import generate as jgen
from tpu_bfs.resilience import failover as jfail
from tpu_bfs.resilience import probe as jprobe
from tpu_bfs.resilience import resume as jres
from tpu_bfs.utils import checkpoint as jckpt

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.resilience import failover as tfail
from tpu_bfs_torch.resilience import probe as tprobe
from tpu_bfs_torch.resilience import resume as tres
from tpu_bfs_torch.utils import checkpoint as tckpt
from tpu_bfs_torch.utils.recovery import COUNTERS


@pytest.fixture(autouse=True)
def _disarmed():
    for mod in (jfaults, tfaults):
        mod.disarm()
    yield
    for mod in (jfaults, tfaults):
        mod.disarm()


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("devices", [0, 1, 2, 3, 4, 6, 8, 16])
def test_degrade_ladder_and_next_rung_equal_jax(devices):
    assert _outcome(tfail.degrade_ladder, devices) == _outcome(jfail.degrade_ladder, devices)
    assert _outcome(tfail.next_mesh_rung, devices) == _outcome(jfail.next_mesh_rung, devices)


@pytest.mark.parametrize("engine", ["wide", "hybrid", "dist2d", "packed"])
@pytest.mark.parametrize("exchange", ["", "dense", "sparse", "sliced", "ring"])
def test_floor_config_equals_jax(engine, exchange):
    assert tfail.floor_config(engine, exchange) == jfail.floor_config(engine, exchange)


def test_resume_policy_thresholds_equal_jax():
    grid = [(k, ml, mw) for k in (1, 2, 4) for ml in (0, 3, 8) for mw in (0.0, 2.5)]
    for k, ml, mw in grid:
        tp = tres.ResumePolicy(every_levels=k, min_levels=ml, min_wall_s=mw)
        jp = jres.ResumePolicy(every_levels=k, min_levels=ml, min_wall_s=mw)
        for level in (0, 2, 3, 8, 100):
            for wall in (0.0, 1.0, 3.0):
                assert tp.should_snapshot(level, wall) == jp.should_snapshot(level, wall)
    for bad in (0, -1):
        assert _outcome(tres.ResumePolicy, every_levels=bad) == _outcome(
            jres.ResumePolicy, every_levels=bad)


def _ckpt_pair(n: int, source: int, level: int):
    """The same snapshot in both packages' checkpoint classes."""
    rng = np.random.default_rng(level)
    front = rng.random(n) < 0.3
    vis = front | (rng.random(n) < 0.4)
    dist = np.where(vis, rng.integers(0, level + 1, n), np.iinfo(np.int32).max).astype(np.int32)
    kw = dict(source=source, level=level, frontier=front, visited=vis, distance=dist,
              nonce=12345 + level)
    return tckpt.BfsCheckpoint(**kw), jckpt.BfsCheckpoint(**kw)


def _same(a, b):
    assert (a.source, a.level, a.nonce) == (b.source, b.level, b.nonce)
    for f in ("frontier", "visited", "distance"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_resume_spool_files_cross_the_packages(tmp_path):
    """A snapshot the port spools is JAX's ``q<source>.npz`` (and back): a
    fresh cache of the other package finds it on disk, the counts agree,
    and a completed query's drop removes the file."""
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tc, jc = _ckpt_pair(96, 5, 3)
    tcache, jcache = tres.ResumeCache(str(tdir)), jres.ResumeCache(str(jdir))
    tcache.put(5, tc)
    jcache.put(5, jc)
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir()) == [
        "q5.npz"]
    _same(jres.ResumeCache(str(tdir)).get(5), tc)
    _same(tres.ResumeCache(str(jdir)).get(5), jc)
    assert tcache.counts() == jcache.counts() == {"entries": 1, "snapshots": 1, "resumes": 0}
    before = COUNTERS.as_dict()["query_resumes"]
    tcache.mark_resumed(5)
    jcache.mark_resumed(5)
    assert COUNTERS.as_dict()["query_resumes"] == before + 1
    assert tcache.counts() == jcache.counts()
    tcache.drop(5)
    jcache.drop(5)
    assert not (tdir / "q5.npz").exists() and not (jdir / "q5.npz").exists()
    assert tcache.get(5) is None and jcache.get(5) is None


def test_corrupt_spool_file_is_quarantined_as_in_jax(tmp_path):
    """A flipped payload byte: both packages' loaders quarantine the file
    (``.corrupt``) and the cache answers None, never a poisoned resume."""
    outs = []
    for tag, res, (tc, jc) in (("t", tres, _ckpt_pair(64, 3, 4)),
                               ("j", jres, _ckpt_pair(64, 3, 4))):
        root = tmp_path / tag
        res.ResumeCache(str(root)).put(3, tc if tag == "t" else jc)
        path = root / "q3.npz"
        blob = bytearray(path.read_bytes())
        blob[tfaults.corruption_offset(str(path))] ^= 0xFF
        path.write_bytes(bytes(blob))
        outs.append((res.ResumeCache(str(root)).get(3), sorted(p.name for p in root.iterdir())))
    assert outs[0] == outs[1] == (None, ["q3.npz.corrupt"])


def test_cache_for_graph_is_one_cache_per_graph_object(tmp_path):
    """One cache per live graph object, created with the spool directory of
    the moment (``set_default_dir``), in both packages."""
    for res, gen in ((tres, tgen), (jres, jgen)):
        g1, g2 = gen.random_graph(32, 64, seed=1), gen.random_graph(32, 64, seed=1)
        res.set_default_dir(str(tmp_path / res.__name__))
        try:
            c1 = res.cache_for_graph(g1)
            assert res.cache_for_graph(g1) is c1
            assert res.cache_for_graph(g2) is not c1
            assert c1.root == str(tmp_path / res.__name__)
        finally:
            res.set_default_dir(None)
        assert res.cache_for_graph(gen.random_graph(8, 8, seed=2)).root is None


def test_heartbeat_probe_site_and_one_device_beat_equal_jax():
    """The probe site fires before any collective: a device_lost there
    raises JAX's DATA_LOSS text; with the budget spent the one-device
    heartbeat is healthy in both packages."""
    errs = []
    for faults, probe in ((tfaults, tprobe), (jfaults, jprobe)):
        faults.arm_from_spec("device_lost@probe:n=1")
        with pytest.raises(RuntimeError) as ei:
            probe.mesh_heartbeat(1)
        errs.append(str(ei.value).split(" [tpu_bfs")[0])
        assert probe.mesh_heartbeat(1) >= 0.0
        faults.disarm()
    assert errs[0] == errs[1] and errs[0].startswith("DATA_LOSS: injected device loss")


def test_heartbeat_wider_than_the_mesh_raises():
    """No serving mesh in this process: a heartbeat over 4 devices names
    the shortfall, as JAX's does over too few devices."""
    with pytest.raises(ValueError, match="heartbeat over 4 devices: only 1 attached"):
        tprobe.mesh_heartbeat(4)


@pytest.mark.parametrize("healthy", [(8,), (4,), (8, 4, 2), ()])
def test_probe_promotion_walk_equals_jax(monkeypatch, healthy):
    """``MeshHealthProbe.probe_once`` over a fake heartbeat: widest healthy
    rung first, one promotion a pass, none at full width."""
    walks = []
    for probe in (tprobe, jprobe):
        state = {"devices": 2, "beats": [], "promoted": []}

        def beat(d, state=state):
            state["beats"].append(d)
            if d not in healthy:
                raise RuntimeError(f"DATA_LOSS: rung {d} down")
            return 0.001

        def promote(d, state=state):
            state["promoted"].append(d)
            state["devices"] = d

        monkeypatch.setattr(probe, "mesh_heartbeat", beat)
        p = probe.MeshHealthProbe(8, interval_s=3600.0, current=lambda s=state: s["devices"],
                                  on_healthy=promote)
        walks.append((p.probe_once(), p.probe_once(), state["beats"], state["promoted"]))
    assert walks[0] == walks[1]
    with pytest.raises(ValueError):
        tprobe.MeshHealthProbe(8, interval_s=0.0, current=lambda: 1, on_healthy=print)
