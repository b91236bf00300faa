"""The yardstick of the kernel rooflines: the card's peaks and the least
bytes a K1 or K2 launch has to move, counted from the shapes the launch
was given (so the count is the same whatever implements the launch).

A roofline share is the least time (least bytes over the peak HBM rate)
over the measured kernel time. Both kernels only move words (no
arithmetic worth a bound), so bytes bound them.

Least bytes count each input once and each output once:

- K1 (``tpu_bfs_torch::ell_expand``: ``need_blk`` [nb], ``gt`` [k, ncols],
  ``fw`` [rows, w], an optional weight slab [k, ncols]; output [ncols, w]):
  the gate, the index slab (and weights) and the output of each launch,
  and the frontier rows the launches of one level may gather, once a
  level: ``min(rows, sum of k * ncols)`` rows of ``w`` words. The launches
  of one level are the consecutive launches on one frontier shape up to
  the first that repeats a (k, ncols) bucket shape of the level.
- K2 (``tpu_bfs_torch::tile_spmm``: ``row_start`` [vt+1], ``col_tile`` [NT],
  ``masks`` [NT, 128, 4], ``fw`` [rows, w], ``out`` [vt*128, w]): the tile
  index, the bit tiles, the frontier slabs its tiles name and the output
  row tiles they touch, written once. The shapes bound those two counts
  only by ``min(NT, vt)``, which on the Kronecker graph is 3.1 times the
  3,162 slabs its 97,656 tiles name; so the counts come with the tile
  table (:class:`K2Tiles`, keyed by the launch's (vt, NT)), read once
  from the engine's build-time split by the engine adapter.
"""

from __future__ import annotations

from typing import NamedTuple

WORD = 4  # bytes of an int32 word
TILE = 128

#: Published peaks by ``torch.cuda.get_device_name()``: HBM bytes/s (NVIDIA
#: H100 SXM data sheet, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_name: str) -> float | None:
    peak = PEAKS.get(device_name)
    return None if peak is None else peak["hbm_bytes_per_s"]


class K1Launch(NamedTuple):
    nb: int
    k: int
    ncols: int
    rows: int
    w: int
    weighted: bool = False


class K2Launch(NamedTuple):
    vt: int
    nt: int
    rows: int
    w: int


class K2Tiles(NamedTuple):
    """What a tile table names: distinct column slabs, non-empty row tiles."""

    slabs: int
    row_tiles: int


def k1_launch(dims: list) -> K1Launch:
    """A K1 launch from the op's recorded input shapes."""
    (nb,), (k, ncols), (rows, w) = dims[0], dims[1], dims[2]
    return K1Launch(nb, k, ncols, rows, w, bool(len(dims) > 3 and dims[3]))


def k2_launch(dims: list) -> K2Launch:
    """A K2 launch from the op's recorded input shapes."""
    (vt1,), (nt,), (rows, w) = dims[0], dims[1], dims[3]
    return K2Launch(vt1 - 1, nt, rows, w)


def k1_levels(launches: list[K1Launch]) -> list[list[K1Launch]]:
    """Split consecutive launches into levels (see the module docstring)."""
    levels, seen = [], set()
    for ln in launches:
        shape = (ln.k, ln.ncols)
        if not levels or shape in seen or (ln.rows, ln.w) != (levels[-1][0].rows, levels[-1][0].w):
            levels.append([])
            seen = set()
        levels[-1].append(ln)
        seen.add(shape)
    return levels


def k1_least_bytes(launches: list[K1Launch]) -> int:
    total = 0
    for level in k1_levels(launches):
        rows, w = level[0].rows, level[0].w
        total += WORD * w * min(rows, sum(ln.k * ln.ncols for ln in level))
        for ln in level:
            slab = WORD * ln.k * ln.ncols
            total += WORD * ln.nb + slab * (2 if ln.weighted else 1) + WORD * ln.ncols * ln.w
    return total


def k2_least_bytes(launches: list[K2Launch], tiles: dict) -> int:
    """``tiles`` maps a launch's (vt, NT) to its :class:`K2Tiles`."""
    total = 0
    for ln in launches:
        t = tiles[(ln.vt, ln.nt)]
        slab = WORD * TILE * ln.w
        total += (WORD * (ln.vt + 1) + WORD * ln.nt + ln.nt * TILE * TILE // 8
                  + slab * t.slabs + slab * t.row_tiles)
    return total
