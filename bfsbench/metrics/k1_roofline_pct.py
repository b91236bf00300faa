"""K1's share of its roofline over the traced window: the least time of
its launches (their least bytes, ``bfsbench/roofline.py``, over the card's
peak HBM rate) over the measured time of its kernels."""

from bfsbench import roofline
from bfsbench.kernel_names import K1_KERNEL, K1_OP


def read(record):
    tw = record.trace
    peak = None if tw is None else roofline.hbm_bytes_per_s(tw.device_name)
    if peak is None:
        return None
    kernels, ops = tw.kernels(K1_KERNEL), tw.ops(K1_OP)
    if not kernels or len(kernels) != len(ops):
        return None
    least_s = roofline.k1_least_bytes([roofline.k1_launch(op.dims) for op in ops]) / peak
    return 100.0 * least_s / (sum(k.dur for k in kernels) / 1e6)
