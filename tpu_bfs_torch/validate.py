"""Result validation (the port's copy of ``tpu_bfs/validate.check_distances``):
the reference's elementwise oracle compare (checkOutput, bfs.cu:374-384),
returning the mismatches instead of exiting."""

from __future__ import annotations

import numpy as np


class ValidationError(AssertionError):
    pass


def check_distances(dist: np.ndarray, expected: np.ndarray, *, max_report: int = 10) -> None:
    """Raise ValidationError naming the first mismatches, if any."""
    dist = np.asarray(dist)
    expected = np.asarray(expected)
    if dist.shape != expected.shape:
        raise ValidationError(f"shape mismatch: {dist.shape} vs {expected.shape}")
    bad = np.flatnonzero(dist != expected)
    if len(bad):
        lines = [f"  v={v}: got {dist[v]}, expected {expected[v]}" for v in bad[:max_report]]
        raise ValidationError(f"{len(bad)} distance mismatches:\n" + "\n".join(lines))
