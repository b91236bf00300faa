"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have, and for the control. The harness's look
for a card is skipped: the tiny cell runs on the CPU."""

from __future__ import annotations

import pytest
import torch

from bfsbench import control, harness
from bfsbench.tests.conftest import tiny_cell


def state_unchanged(session):
    """The level step returns its state unchanged: no level claims."""
    eng = session.engine

    def core(arrs, fw0, max_levels):
        planes = tuple(torch.zeros_like(fw0) for _ in range(eng.num_planes))
        return planes, fw0.clone(), 1, False, False

    eng._core = core


def half_batch(session):
    """Half of each batch's keys left out of the search."""
    eng = session.engine
    seed = eng._seed_dev
    eng._seed_dev = lambda sources: seed(sources[: len(sources) // 2])


def reached_altered(session):
    """One lane's reached count altered where the lane stats produce it."""
    eng = session.engine
    stats = eng._lane_stats

    def altered(vis, in_deg):
        r, d = stats(vis, in_deg)
        r = r.clone()
        r[0, 0] += 1
        return r, d

    eng._lane_stats = altered


def distance_altered(session):
    """One vertex's distance altered where a word's distances are decoded."""
    eng = session.engine
    extract = eng._extract_word

    def altered(planes, vis, src_bits, wi):
        out = extract(planes, vis, src_bits, wi).clone()
        out[-1, :] += 1
        return out

    eng._extract_word = altered


@pytest.mark.parametrize("plant", [state_unchanged, half_batch, reached_altered,
                                   distance_altered, control.depth_cut],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["g500-s21.keys8192", "urand-s21.keys8192"])
def test_a_broken_path_is_not_correct(plant, cell, cache_root):
    c = tiny_cell(cell, scale=9, lanes=64)
    sound = harness.run_cell(c, seed=2**31 + 3, seconds=0.2, trace=False, device="cpu",
                             cache_root=cache_root)
    assert sound["correct"], sound["checks"]
    broken = harness.run_cell(c, seed=2**31 + 3, seconds=0.2, trace=False, device="cpu",
                              cache_root=cache_root, plant=plant)
    assert not broken["correct"], broken["checks"]
