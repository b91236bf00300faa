"""Kernel K1 (ell_expand) of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs its plain twin; the twin must equal the
Pallas kernel under interpret=True and its NumPy oracle, bit for bit, for
all three ops, gated and ungated, at w in {1, 8, 33, 128, 256}.
The CUDA kernel itself is held against the twin in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from tpu_bfs.ops import ell_expand as jk

from tpu_bfs_torch.ops import ell_expand as tk

from torch_threads import cap_torch_threads

cap_torch_threads()


def make_inputs(op, w, k, n_rows, nb, *, gated, seed):
    rng = np.random.default_rng(seed)
    need = (rng.random(nb) < 0.6).astype(np.int32) if gated else np.ones(nb, np.int32)
    if gated:
        need[0] = 1
        if nb > 1:
            need[-1] = 0
    gt = rng.integers(0, n_rows, size=(k, nb * 128)).astype(np.int32)
    if op == "minplus":
        fw = rng.integers(0, 1 << 20, size=(n_rows, w)).astype(np.int32)
        fw[rng.random((n_rows, w)) < 0.3] = jk.MINPLUS_IDENT
        wt = rng.integers(0, 9, size=(k, nb * 128)).astype(np.int32)
    else:
        # Sparse bits for "or", full 32-bit keys (sign bit included) for "min".
        fw = rng.integers(0, 2**32, size=(n_rows, w), dtype=np.uint32)
        if op == "or":
            fw &= rng.integers(0, 2**32, size=(n_rows, w), dtype=np.uint32)
        wt = None
    return need, gt, fw, wt


def torch_of(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


CASES = [(op, w, gated) for op in ("or", "min", "minplus") for w in (1, 8, 128)
         for gated in (False, True)]


@pytest.mark.parametrize("op,w,gated", CASES)
def test_twin_equals_pallas_interpret_and_oracle(op, w, gated):
    k, n_rows, nb = 3, 300, 3
    need, gt, fw, wt = make_inputs(op, w, k, n_rows, nb, gated=gated, seed=w + 7 * gated)
    got = tk.ell_expand(torch_of(need), torch_of(gt), torch_of(fw), torch_of(wt), op=op)
    got = got.numpy().view(fw.dtype)
    ref = jk.ell_expand_reference(need, gt, fw, wt, w=w, op=op)
    np.testing.assert_array_equal(got, ref)
    pal = jk.ell_expand(need, gt, fw, wt, w=w, op=op, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("op", ["or", "min", "minplus"])
@pytest.mark.parametrize("w", [1, 33, 256])
def test_twin_equals_pallas_at_kernel_widths(op, w):
    # The CUDA kernel's paths: scalar loads (w = 1, 33) and 16-byte loads in
    # two strips of a row (w = 256); k = 5 leaves an odd slot at the end.
    need, gt, fw, wt = make_inputs(op, w, 5, 400, 2, gated=True, seed=300 + w)
    got = tk.ell_expand(torch_of(need), torch_of(gt), torch_of(fw), torch_of(wt), op=op)
    got = got.numpy().view(fw.dtype)
    np.testing.assert_array_equal(got, jk.ell_expand_reference(need, gt, fw, wt, w=w, op=op))
    pal = jk.ell_expand(need, gt, fw, wt, w=w, op=op, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("op", ["or", "min", "minplus"])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_twin_equals_oracle_wide_k(op, k):
    need, gt, fw, wt = make_inputs(op, 5, k, 700, 4, gated=True, seed=k)
    got = tk.ell_expand_plain(torch_of(need), torch_of(gt), torch_of(fw), torch_of(wt), op=op)
    np.testing.assert_array_equal(
        got.numpy().view(fw.dtype), jk.ell_expand_reference(need, gt, fw, wt, w=5, op=op)
    )


def test_min_compares_unsigned():
    fw = np.array([[0x7FFFFFFF], [0x80000000], [0xFFFFFFFE]], np.uint32)
    gt = np.zeros((3, 128), np.int32)
    gt[0], gt[1], gt[2] = 0, 1, 2
    out = tk.ell_expand(torch_of(np.ones(1, np.int32)), torch_of(gt), torch_of(fw), op="min")
    assert out.numpy().view(np.uint32)[0, 0] == 0x7FFFFFFF
    assert tk.umin(torch.tensor([-1], dtype=torch.int32),
                   torch.tensor([5], dtype=torch.int32)).item() == 5


def test_wrapper_rejects_bad_operands():
    need, gt, fw, _ = make_inputs("or", 4, 2, 50, 2, gated=False, seed=0)
    n, g, f = torch_of(need), torch_of(gt), torch_of(fw)
    with pytest.raises(ValueError, match="op must be"):
        tk.ell_expand(n, g, f, op="max")
    with pytest.raises(TypeError, match="int32"):
        tk.ell_expand(n, g.long(), f)
    with pytest.raises(ValueError, match="contiguous"):
        tk.ell_expand(n, g, f.t().contiguous().t())
    with pytest.raises(ValueError, match="pad_gate_blocks"):
        tk.ell_expand(n, g[:, :200].contiguous(), f)
    with pytest.raises(ValueError, match="minplus requires wt"):
        tk.ell_expand(n, g, f, op="minplus")
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.ell_expand(n.to("meta"), g.to("meta"), f.to("meta"))


def test_cpu_call_counts_no_launch():
    need, gt, fw, _ = make_inputs("or", 4, 2, 50, 2, gated=False, seed=0)
    before = tk.ell_expand.launches
    tk.ell_expand(torch_of(need), torch_of(gt), torch_of(fw))
    assert tk.ell_expand.launches == before


def test_hbm_bytes_equal_jax_model():
    for args, kw in [((64, 1000, 256), {}), ((8, 129, 1), {"active_tiles": 1}),
                     ((3, 300, 8), {"weighted": True})]:
        assert tk.ell_expand_hbm_bytes(*args, **kw) == jk.ell_expand_hbm_bytes(*args, **kw)
