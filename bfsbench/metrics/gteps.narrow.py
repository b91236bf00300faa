"""``gteps`` of the narrow cells (64 keys a batch): the same count over the
same window, under a bound of its own, since these cells are host-bound
(a third of the window idle) and spread wider than the 8192-key cells."""

from bfsbench.metrics.gteps import read  # noqa: F401
