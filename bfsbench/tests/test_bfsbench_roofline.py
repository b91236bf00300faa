"""The least-bytes functions, counted by hand on one small launch each."""

from __future__ import annotations

from bfsbench import roofline


def test_k1_one_level_by_hand():
    # One level, two buckets on a [1024, 8] frontier: k=2 over 256 rows
    # (nb 2) and k=1 over 128 rows (nb 1).
    a = roofline.k1_launch([[2], [2, 256], [1024, 8], [], []])
    b = roofline.k1_launch([[1], [1, 128], [1024, 8], [], []])
    # gate 2*4 + index 2*256*4 + out 256*8*4; gate 4 + index 128*4 + out 128*8*4;
    # frontier: min(1024, 512 + 128) = 640 rows of 8 words, once.
    want = (8 + 2048 + 8192) + (4 + 512 + 4096) + 640 * 32
    assert roofline.k1_least_bytes([a, b]) == want
    # the next level starts where a bucket shape repeats
    assert roofline.k1_levels([a, b, a, b]) == [[a, b], [a, b]]
    assert roofline.k1_least_bytes([a, b, a, b]) == 2 * want


def test_k1_frontier_capped_by_its_rows_and_weights_counted():
    ln = roofline.k1_launch([[1], [64, 128], [256, 2], [64, 128], []])
    assert ln.weighted
    # index and weights 2 * 64*128*4, gate 4, out 128*2*4, frontier 256 rows x 8 bytes
    assert roofline.k1_least_bytes([ln]) == 2 * 32768 + 4 + 1024 + 256 * 8


def test_k2_one_launch_by_hand():
    # vt 4 row tiles, 6 dense tiles naming 3 column slabs and 2 row tiles, a
    # [512, 2] frontier: row_start 5*4, col_tile 6*4, bit tiles 6*2048,
    # frontier slabs 3 * 128 * 2 * 4, output row tiles 2 * 128 * 2 * 4.
    ln = roofline.k2_launch([[5], [6], [6, 128, 4], [512, 2], [512, 2], []])
    assert ln == roofline.K2Launch(vt=4, nt=6, rows=512, w=2)
    tiles = {(4, 6): roofline.K2Tiles(slabs=3, row_tiles=2)}
    assert roofline.k2_least_bytes([ln], tiles) == 20 + 24 + 6 * 2048 + 3072 + 2048


def test_peak_table_names_the_card():
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("cpu") is None
