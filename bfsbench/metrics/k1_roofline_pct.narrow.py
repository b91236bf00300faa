"""``k1_roofline_pct`` of the narrow cells (64 keys a batch), which report
``gteps.narrow``: the same reading, split because those cells are
host-bound and their rate is held to a bound of its own."""

from bfsbench.metrics.k1_roofline_pct import read  # noqa: F401
