"""K2's share of its roofline over the traced window: the least time of
its launches (their least bytes, ``bfsbench/roofline.py``, with the slab
and row-tile counts of the engine's tile table, over the card's peak HBM
rate) over the measured time of its kernels."""

from bfsbench import roofline
from bfsbench.kernel_names import K2_KERNEL, K2_OP


def read(record):
    tw = record.trace
    peak = None if tw is None else roofline.hbm_bytes_per_s(tw.device_name)
    if peak is None:
        return None
    kernels, ops = tw.kernels(K2_KERNEL), tw.ops(K2_OP)
    tiles = record.facts.get("k2_tiles", {})
    launches = [roofline.k2_launch(op.dims) for op in ops]
    if not kernels or len(kernels) != len(ops) or any((ln.vt, ln.nt) not in tiles
                                                      for ln in launches):
        return None
    least_s = roofline.k2_least_bytes(launches, tiles) / peak
    return 100.0 * least_s / (sum(k.dur for k in kernels) / 1e6)
