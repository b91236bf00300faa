"""Wire checksums, the checksum half of ``tpu_bfs/integrity/wire.py``: an
order-sensitive 32-bit fold over a row's words.

A multiply-accumulate fold with per-position odd multipliers
(splitmix-derived): position-dependent, so swapped words are caught, and
every multiplier is odd, so flipping any single bit of any word changes
the fold (odd x 2^b is never 0 mod 2^32). One definition, two
implementations that agree bit for bit: :func:`words_checksum_np` on the
host and :func:`make_i32_checksum`, the fold of an int32 row on the
row's device (plain PyTorch). The serve tier's ``audit_checksum`` flag
folds both sides of the audited distance row's host-to-device copy
(``integrity/structural.py``).

The exchange frame codec (``append_checksum``, ``split_verify``,
``checksummed_ring_or``) is not ported: its only readers are the
exchanges and ``utils/wirecheck.py`` (ROADMAP Queue 1 entry 6).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _mults_np(n: int) -> np.ndarray:
    """Per-position odd multipliers [n] uint32: a splitmix32-style hash of
    the word index, forced odd. Both folds use this table."""
    x = (np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B9)) & np.uint64(_MASK32)
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = ((x.astype(np.uint64) * np.uint64(0x85EBCA6B)) & np.uint64(_MASK32)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    return x | np.uint32(1)


def words_checksum_np(arr: np.ndarray) -> int:
    """Host fold: the 32-bit checksum of ``arr``'s bytes (any integer
    dtype; the flat byte view is zero-padded to whole 32-bit words)."""
    raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    pad = (-len(raw)) % 4
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    w = raw.view(np.uint32)
    m = _mults_np(len(w))
    return int((w.astype(np.uint64) * m.astype(np.uint64)).sum() & np.uint64(_MASK32))


def _fold(w: torch.Tensor, mults: torch.Tensor) -> torch.Tensor:
    """The fold of int64 words in [0, 2^32) against int64 multipliers, as an
    int64 scalar in [0, 2^32), without int64 overflow: each product splits
    into 16-bit halves (lo < 2^48; hi's bits past 16 fall outside 32 bits
    once shifted), each term is masked to 32 bits, and 2^21 terms below
    2^32 sum below 2^53."""
    lo = (w & 0xFFFF) * mults
    hi = ((w >> 16) * mults) & 0xFFFF
    terms = (lo + (hi << 16)) & _MASK32
    return terms.sum() & _MASK32


def make_i32_checksum(n: int, device=None):
    """The fold of an int32 ``[n]`` row (its bits read as uint32 words) on
    ``device``: a function of the row returning the checksum as an int,
    equal to ``words_checksum_np`` of the same row."""
    mults = torch.from_numpy(_mults_np(n).astype(np.int64)).to(device)

    def checksum(arr: torch.Tensor) -> int:
        if arr.shape != (n,):
            raise ValueError(f"checksum of a {tuple(arr.shape)} row, built for ({n},)")
        return int(_fold(arr.to(torch.int64) & _MASK32, mults))

    return checksum
