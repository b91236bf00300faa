"""Device kernel time outside K1's and K2's kernels (the plain-torch state
passes and the push pass), as a share of all device kernel time in the
traced window."""

from bfsbench.kernel_names import K1_KERNEL, K2_KERNEL


def read(record):
    tw = record.trace
    if tw is None:
        return None
    total = sum(k.dur for k in tw.kernels())
    if not total:
        return None
    ours = sum(k.dur for k in tw.kernels(K1_KERNEL, K2_KERNEL))
    return 100.0 * (total - ours) / total
