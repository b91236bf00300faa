"""Graph500's search keys: drawn uniformly among the vertices of degree
> 0, without replacement inside a batch (the benchmark's copy of the
port's ``graph500.sample_search_keys``). Every batch draws fresh keys from
one stream of the run's seed."""

from __future__ import annotations

import numpy as np

#: Stream ids under one ``--seed``: the window's batches, the warm batch,
#: and the choice of the lanes whose distance rows are checked.
WINDOW, WARM, CHECK = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` under ``seed`` (any integer)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), stream]))


class Sampler:
    def __init__(self, candidates: np.ndarray, keys_per_batch: int, seed: int, stream: int):
        if len(candidates) < keys_per_batch:
            raise ValueError(f"{keys_per_batch} keys a batch, {len(candidates)} candidates")
        self.candidates = candidates
        self.n = int(keys_per_batch)
        self.rng = rng(seed, stream)

    def next(self) -> np.ndarray:
        return self.rng.choice(self.candidates, size=self.n, replace=False)
