"""The port's sharded checkpoint and result files against the JAX package's:
files written by either package load in the other, a corrupt shard falls
back to the previous generation the same way, and the fault sites
``ckpt_save``, ``ckpt_load`` and ``corrupt_ckpt`` fire as in JAX.
"""

import json
import os

import numpy as np
import pytest

from tpu_bfs import faults as jfaults
from tpu_bfs.algorithms.bfs import BfsEngine as JBfsEngine
from tpu_bfs.graph import generate as jgen
from tpu_bfs.utils import checkpoint as jck
from tpu_bfs.utils.recovery import COUNTERS as JCOUNTERS

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.algorithms.bfs import BfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.utils import checkpoint as tck
from tpu_bfs_torch.utils.recovery import COUNTERS as TCOUNTERS

PKGS = {"torch": tck, "jax": jck}


@pytest.fixture(autouse=True)
def _fresh():
    for f, c in ((jfaults, JCOUNTERS), (tfaults, TCOUNTERS)):
        f.disarm()
        c.reset()
    yield
    jfaults.disarm()
    tfaults.disarm()


@pytest.fixture(scope="module")
def states():
    """Three checkpoints of one traversal (levels 1, 2 and the end) and its
    result, from the port's engine."""
    g = tgen.rmat_graph(9, 8, seed=4)
    src = int(np.argmax(g.degrees))
    eng = BfsEngine(g, device="cpu")
    s1 = eng.advance(eng.start(src), levels=1)
    s2 = eng.advance(s1, levels=1)
    end = eng.advance(s2)
    return g, s1, s2, end, eng.finish(end)


def _same(a, b):
    assert (a.source, a.level, a.nonce) == (b.source, b.level, b.nonce)
    for f in ("frontier", "visited", "distance"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("shards,writer,reader", [
    (1, "torch", "jax"), (4, "torch", "jax"), (4, "jax", "torch"), (7, "jax", "torch"),
])
def test_sharded_files_cross_both_ways(states, tmp_path, shards, writer, reader):
    _, s1, s2, _, _ = states
    d = str(tmp_path / "ck")
    PKGS[writer].save_checkpoint_sharded(d, s1, num_shards=shards)
    PKGS[writer].save_checkpoint_sharded(d, s2, num_shards=shards)
    back = PKGS[reader].load_checkpoint_sharded(d)
    _same(back, s2)
    assert sorted(os.listdir(d)) == ["gen_a", "gen_b", "meta.json"]
    assert json.load(open(os.path.join(d, "meta.json")))["generation"] == "gen_b"


def test_sharded_resume_on_either_package_equals_the_unbroken_run(states, tmp_path):
    g, _, s2, _, res = states
    d = str(tmp_path / "ck")
    tck.save_checkpoint_sharded(d, s2, num_shards=4)
    t = BfsEngine(g, device="cpu")
    tres = t.finish(t.advance(tck.load_checkpoint_sharded(d)))
    jg = jgen.rmat_graph(9, 8, seed=4)
    j = JBfsEngine(jg)
    jres = j.finish(j.advance(jck.load_checkpoint_sharded(d)))
    for r in (tres, jres):
        np.testing.assert_array_equal(r.distance, res.distance)
        np.testing.assert_array_equal(r.parent, res.parent)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_corrupt_shard_falls_back_the_same_way(states, tmp_path, writer):
    # Each package reads the writer's files with a corrupt active shard.
    _, s1, s2, _, _ = states
    logs = {}
    for reader in ("torch", "jax"):
        d = str(tmp_path / reader)
        PKGS[writer].save_checkpoint_sharded(d, s1, num_shards=4)  # gen_a
        PKGS[writer].save_checkpoint_sharded(d, s2, num_shards=2)  # gen_b
        shard = os.path.join(d, "gen_b", "shard_00001.npz")
        raw = bytearray(open(shard, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
        msgs = []
        back = PKGS[reader].load_checkpoint_sharded(d, log=msgs.append)
        _same(back, s1)  # the previous generation, written on 4 shards
        assert os.path.exists(shard + ".corrupt")
        logs[reader] = [m.replace(d, "DIR") for m in msgs]
    assert logs["torch"] == logs["jax"] and len(logs["torch"]) == 1


def test_both_generations_corrupt_raise_the_same_error(states, tmp_path):
    _, s1, s2, _, _ = states
    texts = []
    for name, mod in PKGS.items():
        d = str(tmp_path / name)
        mod.save_checkpoint_sharded(d, s1, num_shards=2)
        mod.save_checkpoint_sharded(d, s2, num_shards=2)
        for gen in ("gen_a", "gen_b"):
            p = os.path.join(d, gen, "shard_00000.npz")
            open(p, "wb").write(b"not a zip")
        with pytest.raises(mod.CorruptCheckpointError) as exc:
            mod.load_checkpoint_sharded(d)
        texts.append(str(exc.value).replace(d, "DIR"))
    assert texts[0] == texts[1]


def test_torn_and_mismatched_shard_sets_equal_jax(states, tmp_path):
    _, s1, s2, _, _ = states
    texts = []
    for name, mod in PKGS.items():
        d = str(tmp_path / name)
        mod.save_checkpoint_sharded(d, s2, num_shards=2)
        # A shard of another level in the active generation: torn.
        other = str(tmp_path / f"{name}_other")
        mod.save_checkpoint_sharded(other, s1, num_shards=2)
        os.replace(os.path.join(other, "gen_a", "shard_00001.npz"),
                   os.path.join(d, "gen_a", "shard_00001.npz"))
        with pytest.raises(ValueError) as exc:
            mod.load_checkpoint_sharded(d)
        texts.append(str(exc.value))
        with pytest.raises(ValueError):
            mod.save_checkpoint_sharded(d, s1, num_shards=10**9)
    assert texts[0] == texts[1] and "torn sharded checkpoint" in texts[0]


@pytest.mark.parametrize("with_parent", [True, False])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_result_files_cross_both_ways(states, tmp_path, writer, reader, with_parent):
    import dataclasses

    res = states[4]
    if not with_parent:
        res = dataclasses.replace(res, parent=None)
    p = str(tmp_path / "r.npz")
    PKGS[writer].save_result(p, res)
    back = PKGS[reader].load_result(p)
    for f in ("source", "num_levels", "reached", "edges_traversed"):
        assert getattr(back, f) == getattr(res, f)
    np.testing.assert_array_equal(back.distance, res.distance)
    assert (back.parent is None) == (not with_parent)
    if with_parent:
        np.testing.assert_array_equal(back.parent, res.parent)
    assert type(back).__module__.startswith("tpu_bfs_torch" if reader == "torch" else "tpu_bfs.")


def test_checkpoint_fault_sites_fire_as_in_jax(states, tmp_path):
    """corrupt_ckpt flips a byte after a completed save, the next load
    quarantines the file; transient@ckpt_load and @ckpt_save raise."""
    _, s1, _, _, _ = states
    seen = []
    for name, mod, faults in (("torch", tck, tfaults), ("jax", jck, jfaults)):
        p = str(tmp_path / f"{name}.npz")
        faults.arm_from_spec("seed=1:corrupt_ckpt:n=1,transient@ckpt_load:n=1:skip=1")
        mod.save_checkpoint(p, s1)
        with pytest.raises(mod.CorruptCheckpointError):
            mod.load_checkpoint(p)
        mod.save_checkpoint(p, s1)
        with pytest.raises(RuntimeError, match="INTERNAL: injected transient"):
            mod.load_checkpoint(p)
        _same(mod.load_checkpoint(p), s1)
        counts = faults.ACTIVE.counts()
        faults.arm_from_spec("seed=1:transient@ckpt_save:n=1")
        with pytest.raises(RuntimeError, match="INTERNAL"):
            mod.save_result(str(tmp_path / f"{name}_r.npz"), states[4])
        seen.append((counts, sorted(os.listdir(tmp_path))))
        faults.disarm()
    assert seen[0][0] == seen[1][0] == {"corrupt_ckpt": 1, "transient": 1}
    assert TCOUNTERS.faults_injected == JCOUNTERS.faults_injected == 3
