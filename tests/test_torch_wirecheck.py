"""The port's wire audits and frame codec (tpu_bfs_torch/utils/wirecheck.py,
tpu_bfs_torch/integrity/wire.py) against the JAX package's.

JAX derives each exchange branch's bytes from its compiled HLO on 8
virtual devices; the port counts the bytes its own exchanges hand 8 gloo
ranks (the wire tap over parallel/mesh.Mesh), driving every branch. Each
audit's modeled bytes must equal JAX's modeled bytes and its counted bytes
JAX's HLO-derived bytes, entry for entry. One gloo launch runs every audit
and one JAX compile a configuration (module-scoped fixtures). The frame
codec is held bit for bit to JAX's: the folds, the frames, and the
checksummed ring with a clean and a corrupted wire.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from tpu_bfs.graph.generate import random_graph as jrandom_graph
from tpu_bfs.graph.generate import rmat_graph as jrmat_graph
from tpu_bfs.integrity import wire as jwire
from tpu_bfs.parallel.compat import shard_map
from tpu_bfs.utils import wirecheck as jw

import torch

from tpu_bfs_torch.analysis.graph import Collective, WireTap, wire_bytes
from tpu_bfs_torch.analysis.uniformity import check_rank_signatures
from tpu_bfs_torch.integrity import wire as twire
from tpu_bfs_torch.parallel.mesh import launch
from tpu_bfs_torch.utils.wirecheck import AUDITS, run_audits

from torch_mesh_cases import checksummed_ring_rank
from torch_threads import cap_torch_threads

cap_torch_threads()

P_RANKS = 8
RANDOM_SMALL = ("random", 500, 2000, 12345)
RMAT_SMALL = ("rmat", 10, 8, 3)
RANDOM_WEIGHTED = ("random", 96, 480, 3, 5)

#: (case id, audit, graph spec, port kwargs, the JAX call).
CASES = [
    ("wire_checksum", "check_wire_checksum", None, {"words": 64},
     lambda g: jw.check_wire_checksum(p=8, words=64)),
    ("1d_sparse", "check_1d_sparse", RANDOM_SMALL, {},
     lambda g: jw.check_1d_sparse(g["random_small"], p=8)),
    ("1d_sparse_packed", "check_1d_sparse", RANDOM_SMALL, {"wire_pack": True},
     lambda g: jw.check_1d_sparse(g["random_small"], p=8, wire_pack=True)),
    ("packed_exchange", "check_packed_exchange", RANDOM_SMALL, {},
     lambda g: jw.check_packed_exchange(g["random_small"], p=8)),
    ("planned_sparse", "check_planned_sparse", RANDOM_SMALL, {},
     lambda g: jw.check_planned_sparse(g["random_small"], p=8)),
    ("2d_ring", "check_2d", RANDOM_SMALL, {"rows": 2, "cols": 4, "exchange": "ring"},
     lambda g: jw.check_2d(g["random_small"], 2, 4, "ring")),
    ("2d_allreduce", "check_2d", RANDOM_SMALL, {"rows": 2, "cols": 4, "exchange": "allreduce"},
     lambda g: jw.check_2d(g["random_small"], 2, 4, "allreduce")),
    ("2d_ring_packed", "check_2d", RANDOM_SMALL,
     {"rows": 2, "cols": 4, "exchange": "ring", "wire_pack": True},
     lambda g: jw.check_2d(g["random_small"], 2, 4, "ring", wire_pack=True)),
    ("2d_allreduce_packed", "check_2d", RANDOM_SMALL,
     {"rows": 2, "cols": 4, "exchange": "allreduce", "wire_pack": True},
     lambda g: jw.check_2d(g["random_small"], 2, 4, "allreduce", wire_pack=True)),
    ("2d_dopt", "check_2d", RANDOM_SMALL,
     {"rows": 4, "cols": 2, "exchange": "ring", "backend": "dopt"},
     lambda g: jw.check_2d(g["random_small"], 4, 2, "ring", backend="dopt")),
    ("2d_sparse", "check_2d_sparse", RANDOM_SMALL, {"rows": 2, "cols": 4},
     lambda g: jw.check_2d_sparse(g["random_small"], 2, 4)),
    ("rows_sparse", "check_rows_sparse", RANDOM_SMALL, {"lanes": 64},
     lambda g: jw.check_rows_sparse(g["random_small"], p=8, lanes=64)),
    ("rows_delta", "check_rows_delta", RANDOM_SMALL, {"lanes": 64},
     lambda g: jw.check_rows_delta(g["random_small"], p=8, lanes=64)),
    ("minplus_exchange", "check_minplus_exchange", RANDOM_WEIGHTED, {"lanes": 32},
     lambda g: jw.check_minplus_exchange(g["random_weighted"], p=8, lanes=32)),
    ("sliced_hybrid", "check_sliced_hybrid", RMAT_SMALL, {},
     lambda g: jw.check_sliced_hybrid(g["rmat_small"], p=8)),
    ("gated_hybrid", "check_gated_hybrid", RMAT_SMALL, {},
     lambda g: jw.check_gated_hybrid(g["rmat_small"], p=8)),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def port_run():
    """Every audit in one gloo group of 8 CPU ranks."""
    out = run_audits(P_RANKS, [(audit, graph, kw) for _, audit, graph, kw, _ in CASES])
    return {"reports": dict(zip(IDS, out["reports"])), "signatures": out["signatures"]}


@pytest.fixture(scope="module")
def jax_reports():
    """JAX's audit of every case, one compile a configuration."""
    graphs = {"random_small": jrandom_graph(500, 2000, seed=12345),
              "rmat_small": jrmat_graph(10, 8, seed=3),
              "random_weighted": jrandom_graph(96, 480, seed=3, weights=5)}
    return {cid: jcall(graphs) for cid, _, _, _, jcall in CASES}


def test_every_jax_audit_has_a_counterpart():
    assert set(AUDITS) == {n for n in dir(jw) if n.startswith("check_")}
    assert {audit for _, audit, *_ in CASES} == set(AUDITS)


@pytest.mark.parametrize("cid", IDS)
def test_audit_agrees_and_equals_jax(cid, port_run, jax_reports):
    rep, jrep = port_run["reports"][cid], jax_reports[cid]
    assert rep["agree"], rep
    for mine, theirs in (("modeled_per_level", "modeled_per_level"),
                         ("counted_per_level", "hlo_per_level"),
                         ("modeled_packed_per_level", "modeled_packed_per_level"),
                         ("counted_packed_per_level", "hlo_packed_per_level")):
        if theirs in jrep:
            assert rep[mine] == jrep[theirs], (mine, rep[mine], jrep[theirs])
    assert rep["config"].split(",")[0] == jrep["config"].split(",")[0]


def test_planned_sparse_bytes_by_hand(port_run, jax_reports):
    """JAX's own planner audit is red on jax 0.9.0 (three s32[2] all-reduces
    in its HLO where it expects two), so the bytes are worked by hand here:
    P=8, vloc=1024 (32 packed words), caps (64, 512), delta widths 8 and 16."""
    rep, jrep = port_run["reports"]["planned_sparse"], jax_reports["planned_sparse"]
    assert not jrep["agree"] and jrep["pair_pmaxes"] == 3  # the known red
    p, nw, dense = 8, 32, 7 * 1024  # the unpacked ring: 7 chunks of 1024 bytes

    def delta_words(cap, b):
        return 1 + -(-cap * b // 32)

    sparse = []
    for cap in (64, 512):
        sparse += [(p - 1) * 4 * delta_words(cap, b) for b in (8, 16)] + [(p - 1) * 4 * cap]
    sieve = (p - 1) * 4 * nw
    by_hand = ([s + 8 for s in sparse] + [dense + 8] + [s + sieve + 16 for s in sparse]
               + [dense + sieve + 16] + [dense])
    assert rep["counted_per_level"] == [float(x) for x in by_hand]
    assert rep["modeled_per_level"] == [float(x) for x in by_hand]
    assert rep["pair_pmaxes"] == 2 and rep["sieve_allgathers"] == 1
    assert rep["ring_permutes"] == 7 and all(rep["branches_driven"])


def test_structural_counts_equal_jax(port_run, jax_reports):
    r, j = port_run["reports"], jax_reports
    assert r["wire_checksum"]["checksum_overhead_bytes"] == 4 * 7
    assert r["wire_checksum"]["checksum_overhead_bytes"] == j["wire_checksum"][
        "checksum_overhead_bytes"]
    for key in ("ring_reduction", "allreduce_operand_reduction", "ring_permute_result_bytes",
                "allreduce_operand_bytes", "vloc"):
        assert r["packed_exchange"][key] == j["packed_exchange"][key], key
    for cid in ("1d_sparse", "1d_sparse_packed", "2d_sparse", "sliced_hybrid"):
        assert r[cid]["ring_steps"] == j[cid]["ring_steps"], cid
    for cid in ("2d_ring", "2d_allreduce", "2d_ring_packed", "2d_allreduce_packed", "2d_dopt",
                "2d_sparse"):
        assert r[cid]["column_allgathers"] == j[cid]["column_allgathers"], cid
    assert r["minplus_exchange"]["pair_pmaxes"] == j["minplus_exchange"]["pair_pmaxes"] == 1
    ags = r["minplus_exchange"]["all_gathers"]
    assert ags["minplus_measured"] == ags["or_rows"]
    assert ags["minplus_planner"] == ags["minplus_measured"] + 1
    assert len(r["rows_delta"]["modeled_per_level"]) == 7
    assert len(r["planned_sparse"]["modeled_per_level"]) == 15
    # The gate's extra collectives are a batch's (the first level's flag
    # read and the skipped-block counters' sum), never a level's.
    assert [op for op, _shape, _dt in r["gated_hybrid"]["gated_batch_extra"]] == [
        "all-reduce", "all-reduce"]


def test_rank_signatures_agree_per_group(port_run):
    sigs = port_run["signatures"]
    assert len(sigs) == P_RANKS and all(sigs)
    assert check_rank_signatures("audits", sigs) == []
    bad = [list(s) for s in sigs]
    bad[3] = bad[3][:5] + bad[3][6:]  # rank 3 skipped a collective
    found = check_rank_signatures("audits", bad)
    assert found and found[0].pass_name == "uniformity/collective-signature"
    assert "[3]" in found[0].message


# --- the wire tap's conventions -------------------------------------------------


def test_wire_conventions_are_jax_s():
    assert wire_bytes("collective-permute", 8, 400, 100) == 400.0
    assert wire_bytes("all-to-all", 8, 8 * 64, 128) == 7 * 64.0
    assert wire_bytes("all-gather", 8, 64, 16) == 7 * 64.0
    assert wire_bytes("all-reduce", 8, 8, 2) == 8.0  # a control pair, flat
    assert wire_bytes("all-reduce", 4, 4 * 1024, 1024) == 2 * 3 * 4 * 1024 / 4
    for op in ("collective-permute", "all-to-all", "all-gather", "all-reduce"):
        assert wire_bytes(op, 1, 4096, 1024) == 0.0


def test_tap_is_off_by_default_and_nests():
    from tpu_bfs_torch.parallel import mesh as mesh_mod

    assert mesh_mod._TAP is None

    class One:
        num_shards, members = 2, None

    with WireTap() as outer:
        with WireTap() as inner:
            inner.record(One(), "all-reduce", torch.zeros(2, dtype=torch.int32))
        assert mesh_mod._TAP is outer
    assert mesh_mod._TAP is None
    assert inner.calls == outer.calls == [
        Collective("all-reduce", 8.0, 1, (0, 1), (2,), "int32")]


# --- the frame codec ---------------------------------------------------------------


def _i32(words_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32))


@pytest.mark.parametrize("n", [1, 7, 32, 129])
def test_words_checksum_equals_jax(n):
    words = np.random.default_rng(5 + n).integers(0, 2**32, size=n, dtype=np.uint32)
    mine = int(twire.make_words_checksum(n)(_i32(words))) & 0xFFFFFFFF
    assert mine == int(jwire.make_words_checksum(n)(words)) == twire.words_checksum_np(words)


def test_frame_equals_jax_and_flags_every_flip():
    words = np.random.default_rng(3).integers(0, 2**32, size=16, dtype=np.uint32)
    framed = twire.append_checksum(_i32(words))
    jframed = np.asarray(jwire.append_checksum(words))
    assert np.array_equal(framed.numpy().view(np.uint32), jframed)
    payload, ok = twire.split_verify(framed)
    assert bool(ok) and torch.equal(payload, _i32(words))
    for i in (0, 7, 15, 16):  # payload words and the checksum word itself
        bad = jframed.copy()
        bad[i] ^= np.uint32(1 << (i % 32))
        _, ok = twire.split_verify(_i32(bad))
        _, jok = jwire.split_verify(bad)
        assert not bool(ok) and not bool(jok), i


def _jax_ring(chunks: np.ndarray, wire_check: bool, corrupt=None):
    """JAX's checksummed ring on the 8 virtual devices; ``corrupt`` =
    ``(rank, hop, word, bit)`` flips that bit of what ``rank`` receives at
    ``hop`` (the ring's ``ppermute`` wrapped for the trace)."""
    p = chunks.shape[0]
    mesh = JMesh(np.array(jax.devices()[:p]), ("x",))
    real = jax.lax.ppermute
    calls = {"n": 0}

    def ppermute(x, axis_name, perm):
        out = real(x, axis_name, perm)
        if corrupt is not None and calls["n"] == corrupt[1]:
            mask = jnp.zeros(x.shape, jnp.uint32).at[corrupt[2]].set(jnp.uint32(1 << corrupt[3]))
            out = jnp.where(jax.lax.axis_index(axis_name) == corrupt[0], out ^ mask, out)
        calls["n"] += 1
        return out

    def body(c):
        out, bad = jwire.checksummed_ring_or(c[0], "x", wire_check=wire_check)
        return out[None], bad[None]

    jax.lax.ppermute = ppermute
    try:
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=(P("x"), P("x"))))
        out, bad = fn(jnp.asarray(chunks))
        return np.asarray(out), np.asarray(bad)
    finally:
        jax.lax.ppermute = real


@pytest.mark.parametrize("wire_check,corrupt", [
    (False, None), (True, None), (True, (5, 2, 3, 31)), (True, (0, 6, 16, 0)),
])
def test_checksummed_ring_equals_jax(wire_check, corrupt):
    """Clean: the exact reduce-scatter OR, no bad hop. Corrupted (a payload
    bit at rank 5, hop 2; the checksum word itself at rank 0, hop 6): the
    same rank flags the hop, and the corrupted OR equals JAX's bit for bit."""
    chunks = np.random.default_rng(0).integers(0, 2**32, size=(8, 8, 16), dtype=np.uint32)
    every, bads = launch(8, checksummed_ring_rank, chunks.view(np.int32), wire_check, corrupt,
                         device="cpu", backend="gloo")
    jout, jbad = _jax_ring(chunks, wire_check, corrupt)
    assert np.array_equal(every.view(np.uint32), jout)
    assert np.array_equal(bads, jbad.astype(np.int32))
    if corrupt is None:
        assert np.array_equal(jout, np.bitwise_or.reduce(chunks, axis=0))
        assert not bads.any()
    else:
        assert bads.tolist() == [int(r == corrupt[0]) for r in range(8)]


@pytest.mark.parametrize("p", [2, 4])
def test_engine_runs_count_their_modeled_bytes(p):
    """The engines' own batches on gloo ranks, every exchange call booked
    to its branch: counted bytes equal the levels times the model's, branch
    for branch, and every rank of a group issued the same collectives."""
    from torch_mesh_cases import engine_wire_rank

    reports, sigs = launch(p, engine_wire_rank, device="cpu", backend="gloo")
    for rep in reports:
        assert rep["agree"], rep
    assert [r["engine"] for r in reports] == [
        "DistHybridMsBfsEngine", "DistHybridMsBfsEngine", "DistWideMsBfsEngine",
        "DistBfsEngine", "DistSsspEngine"]
    assert sum(len(r["branches"]) for r in reports) >= 6
    assert check_rank_signatures("engines", sigs) == []
