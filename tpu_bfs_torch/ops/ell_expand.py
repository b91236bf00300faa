"""Kernel K1: gated gather-combine over one bucket's padded ELL table.

The port of ``tpu_bfs/ops/ell_expand.py:ell_expand`` (a Pallas TPU kernel).
``ell_expand`` launches the CUDA kernel in ``csrc/ell_expand.cu`` for CUDA
tensors and runs ``ell_expand_plain``, its plain PyTorch twin, for CPU
tensors; it raises for anything else.

Packed words travel as int32, never ``torch.uint32``: on the CPU that type
lacks ``~``, ``minimum``, ``>>`` and ``index_put``. So the ``min`` identity
0xFFFFFFFF is -1 here, and the twin's unsigned ``min`` flips the sign bit
before a signed compare. The kernel reads the same bits as uint32.

Ops (identity in brackets): ``or`` [0], ``min`` [0xFFFFFFFF, unsigned],
``minplus`` [MINPLUS_IDENT = 1 << 29, signed, with a weight slab ``wt``].
"""

from __future__ import annotations

import torch

TILE = 128  # output rows per gate block, as in the Pallas kernel
MINPLUS_IDENT = 1 << 29
SIGN_BIT = -(1 << 31)  # int32 0x80000000
MAX_W = 65535 * 32  # words: at least 32 per block along a grid's y axis (<= 65535)

#: op name -> (identity as int32, C op id)
KERNEL_OPS = {"or": (0, 0), "min": (-1, 1), "minplus": (MINPLUS_IDENT, 2)}


def aligned16(*tensors: torch.Tensor) -> bool:
    """True when every tensor's data starts on a 16-byte boundary (the
    kernels' vector loads need it; fresh allocations always do)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum of int32 tensors compared as uint32 (sign-bit flip)."""
    return torch.minimum(a ^ SIGN_BIT, b ^ SIGN_BIT) ^ SIGN_BIT


#: op name -> elementwise combine over int32 words
COMBINE = {"or": torch.bitwise_or, "min": umin, "minplus": torch.minimum}


def _check(need_blk, gt, fw, wt, op):
    if op not in KERNEL_OPS:
        raise ValueError(f"op must be one of {sorted(KERNEL_OPS)}, got {op!r}")
    if (op == "minplus") != (wt is not None):
        raise ValueError("minplus requires wt; or/min take none")
    named = {"need_blk": need_blk, "gt": gt, "fw": fw}
    if wt is not None:
        named["wt"] = wt
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"ell_expand: {name} must be an int32 tensor")
        if t.device != fw.device:
            raise ValueError(f"ell_expand: {name} is on {t.device}, fw on {fw.device}")
        if not t.is_contiguous():
            raise ValueError(f"ell_expand: {name} must be contiguous")
    if gt.dim() != 2 or fw.dim() != 2 or need_blk.dim() != 1:
        raise ValueError("ell_expand: need_blk [nb], gt [k, nb*128], fw [rows, w]")
    k, ncols = gt.shape
    if ncols % TILE or need_blk.shape[0] != ncols // TILE:
        raise ValueError(
            f"ell_expand: gt minor dim {ncols} must be {TILE} * len(need_blk) "
            f"= {TILE * need_blk.shape[0]} (use graph/ell.pad_gate_blocks)"
        )
    if k < 1 or fw.shape[0] < 1 or fw.shape[1] < 1:
        raise ValueError(f"ell_expand: empty operand gt {tuple(gt.shape)} fw {tuple(fw.shape)}")
    if wt is not None and wt.shape != gt.shape:
        raise ValueError(f"ell_expand: wt {tuple(wt.shape)} != gt {tuple(gt.shape)}")
    if max(k, ncols) >= 1 << 31 or fw.shape[1] > MAX_W:
        raise ValueError(f"ell_expand: k and nb*128 must be < 2**31 and w <= {MAX_W}")


def ell_expand(need_blk, gt, fw, wt=None, *, op: str = "or") -> torch.Tensor:
    """[nb*128, w] int32: row r is ``combine_kk fw[gt[kk, r]]`` (``+ wt[kk, r]``
    for minplus) in tiles where ``need_blk`` is nonzero, the identity elsewhere.

    ``need_blk`` [nb], ``gt`` [k, nb*128] (sentinel-padded rows of ``fw``),
    ``fw`` [rows, w] and ``wt`` [k, nb*128], all int32 and contiguous. Every
    index in ``gt`` must be a row of ``fw``. Each CUDA launch adds one to
    ``ell_expand.launches``; when ``ell_expand.timings`` is a list, the launch
    appends its (start, end) CUDA events to it."""
    _check(need_blk, gt, fw, wt, op)
    if fw.device.type == "cpu":
        return ell_expand_plain(need_blk, gt, fw, wt, op=op)
    if fw.device.type != "cuda":
        raise ValueError(f"ell_expand: no kernel for device {fw.device}")
    from tpu_bfs_torch.ops._build import check_launch, load_library

    lib = load_library()
    k, ncols = gt.shape
    w = fw.shape[1]
    out = torch.empty((ncols, w), dtype=torch.int32, device=fw.device)
    vec = w % 4 == 0 and aligned16(fw, out)
    stream = torch.cuda.current_stream(fw.device)
    timings = ell_expand.timings
    if timings is not None:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
    rc = lib.tpubfs_ell_expand(
        need_blk.data_ptr(), gt.data_ptr(), fw.data_ptr(),
        None if wt is None else wt.data_ptr(), out.data_ptr(),
        k, ncols, w, KERNEL_OPS[op][1], int(vec), stream.cuda_stream,
    )
    check_launch(rc, "ell_expand")
    ell_expand.launches += 1
    if timings is not None:
        ev[1].record(stream)
        timings.append(ev)
    return out


ell_expand.launches = 0
ell_expand.timings = None


def ell_expand_plain(need_blk, gt, fw, wt=None, *, op: str = "or") -> torch.Tensor:
    """Plain PyTorch twin of :func:`ell_expand` (same signature and result)."""
    ident = KERNEL_OPS[op][0]
    combine = COMBINE[op]
    k, ncols = gt.shape
    out = torch.full((ncols, fw.shape[1]), ident, dtype=torch.int32, device=fw.device)
    rows = torch.nonzero((need_blk != 0).repeat_interleave(TILE)).squeeze(1)
    if rows.numel():
        acc = torch.full((rows.numel(), fw.shape[1]), ident, dtype=torch.int32,
                         device=fw.device)
        for kk in range(k):
            v = fw.index_select(0, gt[kk].index_select(0, rows))
            if op == "minplus":
                v = v + wt[kk].index_select(0, rows)[:, None]
            acc = combine(acc, v)
        out[rows] = acc
    return out


def ell_expand_hbm_bytes(k: int, n: int, w: int, *, active_tiles: int | None = None,
                         weighted: bool = False) -> int:
    """Bytes one bucket's pass must move (``ell_expand_hbm_bytes`` of the JAX
    package): per computed tile its [k, 128] index slab, k*128 gathered rows
    of w words (+ the weight slab for minplus) and one [128, w] output write;
    a gated-out tile only its identity write."""
    nb = -(-n // TILE)
    at = nb if active_tiles is None else min(active_tiles, nb)
    per_tile = k * TILE * 4 + k * TILE * w * 4 + TILE * w * 4
    if weighted:
        per_tile += k * TILE * 4
    return at * per_tile + (nb - at) * TILE * w * 4
