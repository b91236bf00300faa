"""Kernel K2: dense-tile frontier expansion over bit-packed 128x128 tiles.

The port of ``tpu_bfs/ops/tile_spmm.py:tile_spmm`` (a Pallas TPU kernel).
``tile_spmm`` calls the registered op ``tpu_bfs_torch::tile_spmm``, which
launches the CUDA kernel in ``csrc/tile_spmm.cu`` for CUDA tensors and runs
``tile_spmm_plain``, its plain PyTorch twin, for CPU tensors; it raises for
anything else. The op is what a ``torch.export`` graph of an engine's
level step names (``utils/aot.py``).

For row tile j, output row r is the OR over the dense tiles b in
``[row_start[j], row_start[j+1])`` and the columns c with ``A_b[r, c] = 1``
of frontier row ``col_tile[b] * 128 + c``. The tiles come in the JAX
layout, ``a_tiles`` [NT, 4, 128] with A[r, c] at ``[t, r % 4, c]`` bit
``r // 4`` (``pack_a_tiles``), or as their row masks [NT, 128, 4]
(``row_masks``), the layout the kernel and the twin read, which a caller
that launches often keeps instead. Words travel as int32 (see
ops/ell_expand.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.ops.ell_expand import LIB, MAX_W, aligned16

TILE = 128
AW = TILE // 32  # u32 words per packed A row group
SEG = 32  # dense tiles per CUDA block at most (kSeg in csrc/tile_spmm.cu)
CHUNK = 128  # frontier words per CUDA block (kC in csrc/tile_spmm.cu)

#: int32 value of each single bit (bit 31 is the sign bit)
_BIT = [(1 << b) if b < 31 else -(1 << 31) for b in range(32)]


def _check(row_start, col_tile, a_tiles, masks, fw, num_row_tiles, out):
    if (a_tiles is None) == (masks is None):
        raise ValueError("tile_spmm: give a_tiles or masks, not both or neither")
    tiles, name, shape = ((a_tiles, "a_tiles", (AW, TILE)) if masks is None
                          else (masks, "masks", (TILE, AW)))
    named = {"row_start": row_start, "col_tile": col_tile, name: tiles, "fw": fw}
    if out is not None:
        named["out"] = out
    for key, t in named.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"tile_spmm: {key} must be an int32 tensor")
        if t.device != fw.device:
            raise ValueError(f"tile_spmm: {key} is on {t.device}, fw on {fw.device}")
        if not t.is_contiguous():
            raise ValueError(f"tile_spmm: {key} must be contiguous")
    nt = col_tile.shape[0] if col_tile.dim() == 1 else -1
    if row_start.shape != (num_row_tiles + 1,) or nt < 0:
        raise ValueError(
            f"tile_spmm: row_start must be [{num_row_tiles + 1}] and col_tile [NT]"
        )
    if tiles.shape != (nt, *shape):
        raise ValueError(f"tile_spmm: {name} {tuple(tiles.shape)} != {(nt, *shape)}")
    if fw.dim() != 2 or fw.shape[1] < 1 or fw.shape[0] % TILE:
        raise ValueError(f"tile_spmm: fw must be [vt*{TILE}, w], got {tuple(fw.shape)}")
    if out is not None and out.shape != (num_row_tiles * TILE, fw.shape[1]):
        raise ValueError(f"tile_spmm: out {tuple(out.shape)} != "
                         f"({num_row_tiles * TILE}, {fw.shape[1]})")
    blocks = (num_row_tiles + nt // SEG) * -(-fw.shape[1] // CHUNK)
    if blocks >= 1 << 31 or fw.shape[1] > MAX_W:
        raise ValueError(f"tile_spmm: too many tiles for one grid, or w > {MAX_W}")


def tile_spmm(row_start, col_tile, a_tiles, fw, *, num_row_tiles: int,
              masks=None, out=None) -> torch.Tensor:
    """[num_row_tiles*128, w] int32 hit words of all dense tiles.

    Every ``col_tile`` entry must name a 128-row slab of ``fw`` and
    ``row_start`` must be non-decreasing with ``row_start[-1] == NT``. The
    tiles come as ``a_tiles`` (JAX layout, turned into row masks on every
    call) or as ``masks`` = ``row_masks(a_tiles)`` with ``a_tiles=None``.
    With ``out`` the hits are ORed into it, in place, and ``out`` is
    returned; without, they land in a fresh zeroed table. The call goes
    through the registered op ``tpu_bfs_torch::tile_spmm``, which declares
    ``out`` mutated, so a ``torch.export`` trace of a caller keeps the
    accumulation in place and in order. Each CUDA launch adds one to
    ``tile_spmm.launches``; when ``tile_spmm.timings`` is a list, the launch
    appends its (start, end) CUDA events to it."""
    _check(row_start, col_tile, a_tiles, masks, fw, num_row_tiles, out)
    if masks is None:
        masks = row_masks(a_tiles)
    if fw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tile_spmm: no kernel for device {fw.device}")
    if out is None:
        out = torch.zeros((num_row_tiles * TILE, fw.shape[1]), dtype=torch.int32,
                          device=fw.device)
    tile_spmm_op(row_start, col_tile, masks, fw, out, num_row_tiles)
    return out


def _tile_spmm_cuda(row_start, col_tile, masks, fw, out, num_row_tiles):
    """The op's CUDA kernel (operands already checked, tiles as row masks):
    one launch of ``csrc/tile_spmm.cu`` on the current stream, ORing the
    hits into ``out``. The kernel library loads at the first call."""
    from tpu_bfs_torch.ops._build import check_launch, load_library

    lib = load_library()
    w = fw.shape[1]
    if not aligned16(masks):
        raise ValueError("tile_spmm: masks must start on a 16-byte boundary")
    # Segments of <= SEG tiles per row tile (none for a row tile without
    # tiles, which the kernel leaves untouched); their count is bounded by
    # vt + NT // SEG without reading the prefix sum back to the host.
    segs = (row_start[1:] - row_start[:-1] + SEG - 1) // SEG
    seg_end = torch.cumsum(segs, 0, dtype=torch.int32)
    vec = w % 4 == 0 and aligned16(fw, out)
    stream = torch.cuda.current_stream(fw.device)
    timings = tile_spmm.timings
    if timings is not None:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
    rc = lib.tpubfs_tile_spmm(
        row_start.data_ptr(), seg_end.data_ptr(), col_tile.data_ptr(),
        masks.data_ptr(), fw.data_ptr(), out.data_ptr(), num_row_tiles,
        num_row_tiles + col_tile.shape[0] // SEG, w, int(vec), stream.cuda_stream,
    )
    check_launch(rc, "tile_spmm")
    tile_spmm.launches += 1
    if timings is not None:
        ev[1].record(stream)
        timings.append(ev)


def _tile_spmm_cpu(row_start, col_tile, masks, fw, out, num_row_tiles):
    out |= tile_spmm_plain(row_start, col_tile, None, fw, num_row_tiles=num_row_tiles,
                           masks=masks)


def _tile_spmm_fake(row_start, col_tile, masks, fw, out, num_row_tiles):
    _check(row_start, col_tile, None, masks, fw, num_row_tiles, out)


# The registered op behind :func:`tile_spmm` (see ops/ell_expand.py's
# ``LIB``); ``out(a!)`` declares the in-place accumulation, so an exported
# graph keeps it in place and in order.
LIB.define("tile_spmm(Tensor row_start, Tensor col_tile, Tensor masks, Tensor fw, "
           "Tensor(a!) out, int num_row_tiles) -> ()")
LIB.impl("tile_spmm", _tile_spmm_cuda, "CUDA")
LIB.impl("tile_spmm", _tile_spmm_cpu, "CPU")
torch.library.register_fake("tpu_bfs_torch::tile_spmm", _tile_spmm_fake, lib=LIB)
tile_spmm_op = torch.ops.tpu_bfs_torch.tile_spmm.default


tile_spmm.launches = 0
tile_spmm.timings = None


def row_masks(a_tiles: torch.Tensor, *, chunk: int = 2048) -> torch.Tensor:
    """[NT, 128, 4] int32 row masks of JAX-layout tiles [NT, 4, 128]: bit
    ``c % 32`` of word ``c // 32`` of row r is A[r, c], which the JAX layout
    keeps at ``a_tiles[t, r % 4, c]`` bit ``r // 4``."""
    nt = a_tiles.shape[0]
    dev = a_tiles.device
    out = torch.empty((nt, TILE, AW), dtype=torch.int32, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    weights = torch.tensor(_BIT, dtype=torch.int64, device=dev)
    for t0 in range(0, nt, chunk):
        a = a_tiles[t0 : t0 + chunk]
        n = a.shape[0]
        # [n, aw, bit, c] -> rows r = bit * AW + aw -> [n, r, q, c % 32]
        bits = (a[:, :, None, :] >> shifts[:, None]) & 1
        bits = bits.permute(0, 2, 1, 3).reshape(n, TILE, AW, 32)
        # Distinct signed bit values: the int64 sum is the int32 word exactly.
        out[t0 : t0 + n] = (bits * weights).sum(-1).to(torch.int32)
    return out


def dense_entries(row_start, col_tile, masks, *, chunk: int = 2048):
    """(out_row, in_row) int64 coordinates of every set bit of the dense
    tiles' row masks: out_row = row_tile * 128 + r, in_row = col_tile * 128
    + c."""
    dev = masks.device
    nt = col_tile.shape[0]
    counts = (row_start[1:] - row_start[:-1]).long()
    row_tile = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    outs, ins = [], []
    for t0 in range(0, nt, chunk):
        m = masks[t0 : t0 + chunk]
        t, r, q, bit = torch.nonzero((m[..., None] >> shifts) & 1, as_tuple=True)
        outs.append(row_tile[t0 + t] * TILE + r)
        ins.append(col_tile[t0 + t].long() * TILE + q * 32 + bit)
    if not outs:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    return torch.cat(outs), torch.cat(ins)


def tile_spmm_plain(row_start, col_tile, a_tiles, fw, *, num_row_tiles: int,
                    masks=None) -> torch.Tensor:
    """Plain PyTorch twin of :func:`tile_spmm` (same tiles and result, no
    ``out``): per lane bit, a sparse 0/1 product over the set bits of the
    row masks, then ``count > 0``. Counts stay below 2**24, so float32 sums
    are exact."""
    if masks is None:
        masks = row_masks(a_tiles)
    rows = num_row_tiles * TILE
    out = torch.zeros((rows, fw.shape[1]), dtype=torch.int32, device=fw.device)
    out_row, in_row = dense_entries(row_start, col_tile, masks)
    if out_row.numel() == 0:
        return out
    a = torch.sparse_coo_tensor(
        torch.stack([out_row, in_row]),
        torch.ones(out_row.numel(), dtype=torch.float32, device=fw.device),
        (rows, fw.shape[0]),
        check_invariants=True,
    ).coalesce()
    for b in range(32):
        f_b = ((fw >> b) & 1).to(torch.float32)
        hit = torch.sparse.mm(a, f_b) > 0
        out |= hit.to(torch.int32) * _BIT[b]
    return out


def pack_a_tiles(a_dense: np.ndarray) -> np.ndarray:
    """[NT, 128, 128] 0/1 -> bit-packed [NT, AW, 128] uint32, A[t, r, c] at
    ``[t, r % AW, c]`` bit ``r // AW`` (the JAX package's layout)."""
    nt = a_dense.shape[0]
    out = np.zeros((nt, AW, TILE), np.uint32)
    for bit in range(32):
        out |= a_dense[:, bit * AW : (bit + 1) * AW, :].astype(np.uint32) << np.uint32(bit)
    return out


def unpack_a_tile(a_bits: np.ndarray) -> np.ndarray:
    """[AW, 128] uint32 -> [128, 128] 0/1 int8 (inverse of pack_a_tiles)."""
    return np.concatenate(
        [((a_bits >> np.uint32(bit)) & 1).astype(np.int8) for bit in range(32)], axis=0
    )


def tile_spmm_hbm_bytes(num_tiles: int, num_row_tiles: int, w: int) -> int:
    """Bytes one pass must move: each dense tile's 2 KB bit tile and its
    [128, w] frontier slab, and one [num_row_tiles*128, w] output write."""
    return num_tiles * (AW * TILE * 4 + TILE * w * 4) + num_row_tiles * TILE * w * 4
