"""Scalar (NumPy) oracle for Hamming distance and Hamming search.

This module is the conformance oracle for the device paths: it
reproduces, step for step, the behavior of the reference's scalar
implementations — `hamming_naive` (src/hamming.rs:36-47),
`hamming_search_naive_with_opts` (src/hamming.rs:96-146), and the
word-wise variants `hamming_words_64/128` (src/hamming.rs:176-292).
Every differential test judges the JAX/Pallas paths against this module.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..types import BytesLike, Match, SearchType, to_bytes_array

__all__ = [
    "hamming_naive",
    "hamming_words_64",
    "hamming_words_128",
    "hamming_search_naive",
    "hamming_search_naive_with_opts",
    "default_hamming_k",
]


def default_hamming_k(needle_len: int) -> int:
    """Default k for hamming searches: ceil(needle_len / 2).

    Mirrors reference src/hamming.rs:71, 422-424.
    """
    return (needle_len >> 1) + (needle_len & 1)


def hamming_naive(a: BytesLike, b: BytesLike) -> int:
    """Mismatch count between equal-length strings (reference hamming.rs:36-47).

    >>> hamming_naive(b"abc", b"abd")
    1
    """
    a = to_bytes_array(a)
    b = to_bytes_array(b)
    if len(a) != len(b):
        raise ValueError("strings must have equal lengths for Hamming distance")
    return int(np.count_nonzero(a != b))


def _hamming_words(a: BytesLike, b: BytesLike, word_bytes: int) -> int:
    """Word-wise XOR + bit-fold + popcount mismatch count.

    Semantics of reference hamming.rs:176-219 (64-bit) / 249-292 (128-bit):
    bytes are compared in `word_bytes` chunks; the tail chunk is masked to
    the string length.  NumPy has no u128, so both variants fold in u64
    chunks — the result is identical because the fold is byte-local.
    """
    a = to_bytes_array(a)
    b = to_bytes_array(b)
    if len(a) != len(b):
        raise ValueError("strings must have equal lengths for Hamming distance")
    n = len(a)
    pad = (-n) % word_bytes
    ap = np.pad(a, (0, pad)).view(np.uint64)
    bp = np.pad(b, (0, pad)).view(np.uint64)
    r = ap ^ bp
    # fold each byte's bits down to bit 0: any mismatching bit -> bit 0 set
    r |= r >> np.uint64(4)
    r &= np.uint64(0x0F0F0F0F0F0F0F0F)
    r |= r >> np.uint64(2)
    r &= np.uint64(0x3333333333333333)
    r |= r >> np.uint64(1)
    r &= np.uint64(0x5555555555555555)
    return int(np.sum(np.bitwise_count(r)))


def hamming_words_64(a: BytesLike, b: BytesLike) -> int:
    """64-bit word-wise Hamming distance (reference hamming.rs:176-219).

    >>> hamming_words_64(b"abc", b"abd")
    1
    """
    return _hamming_words(a, b, 8)


def hamming_words_128(a: BytesLike, b: BytesLike) -> int:
    """128-bit word-wise Hamming distance (reference hamming.rs:249-292).

    >>> hamming_words_128(b"abc", b"abd")
    1
    """
    return _hamming_words(a, b, 16)


def hamming_search_naive_with_opts(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    search_type: SearchType = SearchType.Best,
) -> List[Match]:
    """Sliding-window Hamming search (reference hamming.rs:96-146).

    Returns matches in end-position order.  `Best` mode reproduces the
    reference's streaming semantics: the threshold `curr_k` shrinks to each
    new match's cost, all candidates are buffered, and the final list is
    filtered to `k == final curr_k` (hamming.rs:122-143).  Note: unlike
    Levenshtein search, hamming search Best mode performs NO overlap dedup.
    """
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    needle_len = len(needle)
    haystack_len = len(haystack)

    if needle_len > haystack_len:
        return []

    n_pos = haystack_len + 1 - needle_len
    if needle_len == 0:
        # reference: len = haystack_len + 1, every position matches with k=0
        counts = np.zeros(n_pos, dtype=np.int64)
    else:
        # vectorized equivalent of the scalar count-with-early-exit loop:
        # the early exit only skips work, never changes emitted matches.
        windows = np.lib.stride_tricks.sliding_window_view(haystack, needle_len)
        counts = np.count_nonzero(windows != needle[None, :], axis=1)

    res: List[Match] = []
    curr_k = k
    for i in range(n_pos):
        c = int(counts[i])
        if c <= curr_k:
            if search_type == SearchType.Best:
                curr_k = c
            res.append(Match(start=i, end=i + needle_len, k=c))

    if search_type == SearchType.Best:
        return [m for m in res if m.k == curr_k]
    return res


def hamming_search_naive(needle: BytesLike, haystack: BytesLike) -> List[Match]:
    """Default hamming search: k = ceil(len/2), Best (reference hamming.rs:70-72)."""
    needle = to_bytes_array(needle)
    return hamming_search_naive_with_opts(
        needle, haystack, default_hamming_k(len(needle)), SearchType.Best
    )
