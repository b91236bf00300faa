"""The port's exchange planner against the JAX package's, word for word:
the packed wire format, the delta id codec, the planner's branch layouts
and byte models, and the packed reduce-scatters and
``planned_sparse_exchange_or`` on gloo groups of 2, 4 and 8 ranks against
``shard_map`` over the conftest's virtual devices.

Packed words are int32 in the port and uint32 in JAX: they are compared as
uint32, bit for bit. A sieved level's ``hit`` equals the raw OR only where
the claim reads it (this rank's unvisited positions), so sieved hits are
compared through the claim ``hit & ~visited``; every other hit raw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from tpu_bfs.parallel import collectives as jcoll
from tpu_bfs.parallel.compat import shard_map
from tpu_bfs.parallel.dist_bfs import make_mesh

import torch
import torch_mesh_cases as cases
from tpu_bfs_torch.parallel import collectives as tcoll
from tpu_bfs_torch.parallel.mesh import start

from torch_threads import cap_torch_threads

cap_torch_threads()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# --- the pack and codec units ---------------------------------------------------


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000])
def test_pack_bits_equal_jax_word_for_word(n):
    rng = np.random.default_rng(n)
    x = rng.random((3, n)) < 0.5
    x[:, -1] = True  # the last vertex's bit: bit 31 of a full word at n % 32 == 0
    words = tcoll.pack_bits(torch.from_numpy(x))
    assert words.dtype == torch.int32 and words.shape == (3, tcoll.packed_words(n))
    np.testing.assert_array_equal(_u32(words), np.asarray(jcoll.pack_bits(jnp.asarray(x))))
    np.testing.assert_array_equal(tcoll.unpack_bits(words, n).numpy(), x)
    # The tail word's unused bits are zero (the identity of OR).
    if n % 32:
        assert (_u32(words)[:, -1] >> np.uint32(n % 32)).max() == 0
    assert tcoll.packed_words(n) == jcoll.packed_words(n)


def test_pack_bits_layout():
    x = torch.zeros(64, dtype=torch.bool)
    x[[0, 5, 31, 32, 63]] = True
    assert _u32(tcoll.pack_bits(x)).tolist() == [(1 << 0) | (1 << 5) | (1 << 31),
                                                 (1 << 0) | (1 << 31)]


def _chunks(rng, rows, cap, max_gap, fill):
    """[rows, cap] ascending id chunks with gaps up to ``max_gap`` (some
    exactly ``max_gap``), ``fill`` after a random length."""
    buf = np.full((rows, cap), fill, np.int32)
    for r in range(rows):
        k = int(rng.integers(0, cap + 1)) if r else cap
        gaps = rng.integers(1, max_gap + 1, size=k)
        if k:
            gaps[rng.integers(0, k)] = max_gap
        buf[r, :k] = np.cumsum(gaps) - 1
    return buf


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("cap", [1, 7, 33])
def test_delta_codec_equal_jax_word_for_word(bits, cap):
    # The boundary gaps (15, 255, 65535) fill each field; 16-bit fields
    # fill bits 16-31 of their words, where the int32 sign lives.
    rng = np.random.default_rng(bits * 100 + cap)
    sentinel = (1 << bits) * (cap + 1) + 1
    buf = _chunks(rng, 5, cap, (1 << bits) - 1, sentinel)
    buf[3] = sentinel  # an empty chunk
    words = tcoll.delta_encode_ids(torch.from_numpy(buf), sentinel, bits)
    jw = np.asarray(jcoll.delta_encode_ids(jnp.asarray(buf), sentinel, bits))
    assert words.shape[-1] == tcoll.delta_words(cap, bits) == jcoll.delta_words(cap, bits)
    np.testing.assert_array_equal(_u32(words), jw)
    ids, valid = tcoll.delta_decode_ids(words, cap, bits)
    jids, jvalid = jcoll.delta_decode_ids(jnp.asarray(jw), cap, bits)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    ok = valid.numpy() & (ids.numpy() < sentinel)
    np.testing.assert_array_equal(np.where(ok, ids.numpy(), sentinel), buf)


def test_max_id_gap_equal_jax():
    rng = np.random.default_rng(3)
    for shape, dens in (((4, 300), 0.05), ((1, 70), 0.5), ((3, 50), 0.0), ((2, 9), 0.12)):
        rem = rng.random(shape) < dens
        assert int(tcoll.max_id_gap(torch.from_numpy(rem))) == int(
            jcoll.max_id_gap(jnp.asarray(rem)))
    one = np.zeros((2, 40), bool)
    one[0, 39] = True  # a single set bit: no gap
    assert int(tcoll.max_id_gap(torch.from_numpy(one))) == 0


def test_delta_bits_and_default_caps_equal_jax():
    assert tcoll.DELTA_BITS_DEFAULT == jcoll.DELTA_BITS_DEFAULT
    assert tcoll.check_delta_bits([16, 8, 8]) == jcoll.check_delta_bits([16, 8, 8]) == (8, 16)
    with pytest.raises(ValueError) as want:
        jcoll.check_delta_bits((8, 12))
    with pytest.raises(ValueError) as got:
        tcoll.check_delta_bits((8, 12))
    assert str(got.value) == str(want.value)
    for vloc in (7, 300, 2048, 1 << 20):
        for wp in (False, True):
            for db in ((), (8, 16), (16,), (4, 8)):
                assert tcoll.default_sparse_caps(vloc, wire_pack=wp, delta_bits=db) == \
                    jcoll.default_sparse_caps(vloc, wire_pack=wp, delta_bits=db)
                assert tcoll.resolve_sparse_caps(None, vloc, wire_pack=wp, delta_bits=db) == \
                    jcoll.default_sparse_caps(vloc, wire_pack=wp, delta_bits=db)
        for w in (1, 2, 256):
            for db in ((), (8, 16), (4,)):
                assert tcoll.default_row_gather_caps(vloc, w, db) == \
                    jcoll.default_row_gather_caps(vloc, w, db)


@pytest.mark.parametrize("caps", [(4,), (64, 4, 64), (1, 8, 200)])
@pytest.mark.parametrize("delta_bits", [(), (8,), (8, 16), (4, 8, 16)])
def test_branch_layouts_equal_jax(caps, delta_bits):
    assert tcoll.planned_branch_count(caps, delta_bits) == jcoll.planned_branch_count(
        caps, delta_bits) == len(tcoll.planned_branch_labels(caps, delta_bits))
    assert tcoll.planned_branch_labels(caps, delta_bits) == jcoll.planned_branch_labels(
        caps, delta_bits)
    assert tcoll.rows_gather_branch_count(caps, delta_bits) == jcoll.rows_gather_branch_count(
        caps, delta_bits)
    assert tcoll.rows_gather_branch_labels(caps, delta_bits) == \
        jcoll.rows_gather_branch_labels(caps, delta_bits)
    for pr in (False, True):
        assert tcoll.minplus_rows_branch_count(caps, delta_bits, predict=pr) == \
            jcoll.minplus_rows_branch_count(caps, delta_bits, predict=pr)
        assert tcoll.minplus_rows_branch_labels(caps, delta_bits, predict=pr) == \
            jcoll.minplus_rows_branch_labels(caps, delta_bits, predict=pr)
    # The host's flat branch and its inverse walk the same layout.
    labels = tcoll.rows_gather_branch_labels(caps, delta_bits)
    for biggest in (0, 4, 9, 100, 10**6):
        for dmax in (0, 15, 255, 256, 70000):
            b = tcoll.rows_gather_branch(biggest, dmax, caps, delta_bits)
            rung = tcoll.branch_rung(b, caps, delta_bits)
            if rung is None:
                assert labels[b] == "dense"
            else:
                cap, bits = rung
                assert labels[b] == (f"sparse[{cap}]" if bits is None else f"delta{bits}[{cap}]")
                assert biggest <= cap and (bits is None or dmax < 1 << bits)


@pytest.mark.parametrize("p,n", [(1, 7), (2, 100), (4, 2048), (8, 1000)])
def test_byte_models_equal_jax(p, n):
    caps = (4, 64, 130)
    for wp in (False, True):
        for impl in ("ring", "allreduce"):
            assert tcoll.dense_or_wire_bytes(p, n, impl, wire_pack=wp) == \
                jcoll.dense_or_wire_bytes(p, n, impl, wire_pack=wp)
            assert tcoll.dense_2d_wire_bytes(p, 3, n, impl, wire_pack=wp) == \
                jcoll.dense_2d_wire_bytes(p, 3, n, impl, wire_pack=wp)
        assert tcoll.column_gather_wire_bytes(p, n, wire_pack=wp) == \
            jcoll.column_gather_wire_bytes(p, n, wire_pack=wp)
        assert tcoll.sparse_wire_bytes_per_level(p, n, caps, wire_pack=wp) == \
            jcoll.sparse_wire_bytes_per_level(p, n, caps, wire_pack=wp)
        for db in ((), (8, 16), (4,)):
            assert tcoll.planned_sparse_wire_bytes_per_level(p, n, caps, db, wire_pack=wp) == \
                jcoll.planned_sparse_wire_bytes_per_level(p, n, caps, db, wire_pack=wp)
    assert tcoll.sieve_wire_bytes(p, n) == jcoll.sieve_wire_bytes(p, n)
    for w in (1, 32):
        for db in ((), (8, 16)):
            assert tcoll.sparse_rows_wire_bytes_per_level(p, n, w, caps, db) == \
                jcoll.sparse_rows_wire_bytes_per_level(p, n, w, caps, db)
            for pr in (False, True):
                assert tcoll.minplus_rows_wire_bytes_per_level(p, n, w, caps, db, predict=pr) \
                    == jcoll.minplus_rows_wire_bytes_per_level(p, n, w, caps, db, predict=pr)
        assert tcoll.dense_min_wire_bytes(p, n, w) == jcoll.dense_min_wire_bytes(p, n, w)


def test_exchange_counts_chain_like_jax():
    # A resumed chain merges only within one branch space; a chain stamped
    # with another nonce (or none) restarts, as gate_and_stamp_chain does.
    class Eng:
        last_exchange_level_counts = np.array([1, 2, 0])

    for prev, counts, lvl in ((np.array([1, 2]), np.array([0, 1]), 3),
                              (np.array([1, 2, 0]), np.array([0, 1]), 3),
                              (np.array([2, 0]), np.array([1, 1]), 1)):
        np.testing.assert_array_equal(tcoll.merge_exchange_counts(prev, counts, lvl),
                                      jcoll.merge_exchange_counts(prev, counts, lvl))
    for lvl, nonce in ((3, "a"), (3, "b"), (0, None), (3, None)):
        a, b = Eng(), Eng()
        a._exchange_chain_nonce = b._exchange_chain_nonce = "a"
        got = tcoll.gate_and_stamp_chain(a, lvl, nonce)
        want = jcoll.gate_and_stamp_chain(b, lvl, nonce)
        assert (got is None) == (want is None) and a._exchange_chain_nonce == nonce


# --- the exchanges on gloo groups -------------------------------------------------


def _jax_planner(p, n, caps, seed):
    """JAX's results of ``cases.planner_rank`` on make_mesh(p), one
    shard_map program an exchange (XLA compiles one program of them all
    many times slower)."""
    contrib, vis = cases.planner_inputs(p, n, seed)
    mesh = make_mesh(p)

    def program(body, nout):
        fn = jax.jit(shard_map(lambda x, v: body(x[0], v[0]), mesh=mesh,
                               in_specs=(P("v", None), P("v", None)),
                               out_specs=(P("v"),) * nout, check_vma=False))
        return lambda x: [np.asarray(a) for a in fn(x, vis)]

    def planned(kw):
        kw = dict(kw)
        pb = jnp.int32(kw.pop("prev_biggest", -1))
        grow = jnp.bool_(kw.pop("growing", False))

        def body(x, v):
            total = lax.psum(jnp.sum(v.astype(jnp.int32)), "v")
            hit, br, big = jcoll.planned_sparse_exchange_or(
                x, "v", p, caps=caps, visited=v, visited_total=total, prev_biggest=pb,
                growing=grow, **kw)
            return hit, hit & ~v, jnp.int32(br)[None], jnp.int32(big)[None]
        return program(body, 4)

    def packed(x, v):
        hit, br = jcoll.sparse_exchange_or(x, "v", p, caps=caps, wire_pack=True)
        return (jcoll.reduce_scatter_or(x, "v", p, impl="ring", wire_pack=True),
                jcoll.reduce_scatter_or(x, "v", p, impl="allreduce", wire_pack=True),
                hit, br[None])

    fns = [(name, planned(kw)) for name, kw in cases.PLANNER_EXCHANGES]
    fn_packed = program(packed, 4)
    out = {}
    for d, x in contrib.items():
        ring, allr, hit, br = fn_packed(x)
        out[f"packed_ring_{d}"], out[f"packed_allreduce_{d}"] = ring, allr
        out[f"sparse_packed_{d}"] = (hit, int(br[0]))
        for name, fn in fns:
            hit, claim, br, big = fn(x)
            out[f"{name}_{d}"] = (hit, claim, int(br[0]), int(big[0]))
    return out


@pytest.mark.parametrize("p", [2, 4, 8])
def test_planner_exchanges_equal_jax(p):
    n, caps, seed = 300, (4, 64), 11
    group = start(p, cases.planner_rank, n, caps, seed, device="cpu")
    jax = _jax_planner(p, n, caps, seed)  # while the ranks run
    port = group.result()
    assert port.keys() == jax.keys()
    ncaps = len(caps)
    b = ncaps * 1
    branches = set()
    for key, want in jax.items():
        got = port[key]
        if not isinstance(want, tuple):
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        if len(want) == 2:  # the packed sparse exchange: hit, branch
            np.testing.assert_array_equal(got[0], want[0], err_msg=key)
            assert got[1] == want[1], key
            continue
        name = key.rsplit("_", 1)[0]
        kw = dict(cases.PLANNER_EXCHANGES)[name]
        b = ncaps * (len(kw.get("delta_bits", ())) + 1)
        assert got[2:] == want[2:], f"{key}: (branch, biggest) {got[2:]} != {want[2:]}"
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"{key} claim")
        if not b < got[2] <= 2 * b + 1:  # unsieved: the raw OR
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{key} hit")
        branches.add(tcoll.planned_branch_labels(caps, kw.get("delta_bits", ()))[got[2]])
    # The cases reach what they are there for: every encoding, the sieve on
    # a rung and dense, and the predicted dense.
    assert {"delta8[4]", "delta8[64]", "sparse[4]", "dense", "sieved-dense",
            "dense-predicted"} <= branches, branches
    assert any(s.startswith("sieved-delta") for s in branches), branches
