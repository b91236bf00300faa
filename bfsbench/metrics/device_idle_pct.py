"""The share of the traced window in which no operation runs on the
device: the window less the union of its kernel, copy and set intervals."""


def read(record):
    tw = record.trace
    if tw is None or not tw.kernels():
        return None
    return 100.0 * (1.0 - tw.busy_seconds() / tw.seconds)
