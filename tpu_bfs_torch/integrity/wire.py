"""Wire checksums, the port of ``tpu_bfs/integrity/wire.py``: an
order-sensitive 32-bit fold over a row's words, and the +1-word frame of
an exchange chunk.

A multiply-accumulate fold with per-position odd multipliers
(splitmix-derived): position-dependent, so swapped words are caught, and
every multiplier is odd, so flipping any single bit of any word changes
the fold (odd x 2^b is never 0 mod 2^32). One definition, two
implementations that agree bit for bit: :func:`words_checksum_np` on the
host and :func:`make_i32_checksum`, the fold of an int32 row on the
row's device (plain PyTorch). The serve tier's ``audit_checksum`` flag
folds both sides of the audited distance row's host-to-device copy
(``integrity/structural.py``).

The frame codec: :func:`make_words_checksum` (the fold of a flat word
array on its device), :func:`append_checksum` / :func:`split_verify` (the
sender appends the fold, the receiver strips and recomputes it: 4 bytes
a chunk a hop) and :func:`checksummed_ring_or`, the packed ring
reduce-scatter OR with every hop's chunk framed, over
``parallel/mesh.Mesh.ring_shift``. Words are int32 here, bit for bit
JAX's uint32 words; the fold's value travels as the int32 with the same
bits. ``utils/wirecheck.check_wire_checksum`` counts the frame's bytes on
the wire.
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


def _fold_i32(w: torch.Tensor, mults: torch.Tensor) -> torch.Tensor:
    """The fold of int32 words (their bits read as uint32) as a 0-d int32
    tensor with the fold's 32 bits, on the words' device, no host read."""
    x = _fold(w.to(torch.int64) & _MASK32, mults)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def make_words_checksum(n_words: int, device=None):
    """The device twin of :func:`words_checksum_np` over a flat int32
    ``[n_words]`` array: a function of the words returning a 0-d int32
    tensor whose bits are the uint32 fold (JAX's ``make_words_checksum``).
    Built a length at a time, so the multiplier table is made once."""
    mults = torch.from_numpy(_mults_np(n_words).astype(np.int64)).to(device)

    def checksum(words: torch.Tensor) -> torch.Tensor:
        if words.shape != (n_words,):
            raise ValueError(f"checksum of {tuple(words.shape)} words, built for ({n_words},)")
        return _fold_i32(words, mults.to(words.device))

    return checksum


def append_checksum(words: torch.Tensor) -> torch.Tensor:
    """Frame one exchange chunk: ``[n]`` int32 words -> ``[n + 1]`` with
    the fold in the last word. The +1 word is the whole wire cost (4
    bytes a chunk a hop)."""
    return torch.cat([words, make_words_checksum(words.shape[-1], words.device)(words)[None]])


def split_verify(framed: torch.Tensor):
    """Strip one frame: ``[n + 1] -> ([n] payload, ok)``, ``ok`` a 0-d bool
    tensor, False exactly when the wire changed any bit of the frame
    (payload or checksum word): the receiver refolds what it received."""
    payload = framed[:-1]
    return payload, make_words_checksum(payload.shape[-1], framed.device)(payload) == framed[-1]


def checksummed_ring_or(chunks: torch.Tensor, mesh, *, wire_check: bool = True):
    """Packed ring reduce-scatter OR with per-hop chunk checksums.

    ``chunks``: ``[P, words]`` int32, this rank's piece for every
    destination. Returns ``(own [words] int32, bad_hops 0-d int32)``:
    ``own`` is the OR over every rank of its piece for this rank,
    ``bad_hops`` the hops whose received frame failed verification (0 on
    a healthy wire). ``wire_check=False`` skips the frames: the plain
    packed ring, byte for byte.

    The ring is JAX's: the piece for destination ``d`` starts at rank
    ``d + 1`` and takes in each visited rank's piece over ``P - 1`` hops
    of :meth:`Mesh.ring_shift` (to rank + 1, from rank - 1). With
    checksums a rank sends ``(P - 1) * 4`` more bytes an exchange, one
    word a hop."""
    p, idx = chunks.shape[0], mesh.rank
    buf = chunks[(idx - 1) % p]
    bad = torch.zeros((), dtype=torch.int32, device=chunks.device)
    for k in range(p - 1):
        if wire_check:
            received, ok = split_verify(mesh.ring_shift(append_checksum(buf)))
            bad = bad + (~ok).to(torch.int32)
        else:
            received = mesh.ring_shift(buf)
        # The partial for destination idx - k - 2: fold in this rank's own
        # piece for it; at the last hop that destination is idx itself.
        buf = received | chunks[(idx - k - 2) % p]
    return buf, bad


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
