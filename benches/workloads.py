"""Seeded workloads shared by chip_smoke.py and the benches.

Every generator is vectorized numpy, so building the full-size inputs
costs seconds, not minutes, and the same seed gives the same bytes on
every host.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "distance_pairs",
    "indel_pairs",
    "planted_haystack",
    "dictionary",
    "hamming_pairs",
]


def distance_pairs(rng, B: int, length: int, k: int):
    """B pairs of `length` printable bytes; b carries k//2..k substitutions
    by a space (the headline distance workload).  Returns two [B, length]
    uint8 arrays."""
    a = rng.integers(33, 127, (B, length), dtype=np.uint8)
    b = a.copy()
    n_sub = rng.integers(k // 2, k + 1, B)
    pos = rng.integers(0, length, (B, k))
    use = np.arange(k)[None, :] < n_sub[:, None]
    rows = np.repeat(np.arange(B), k).reshape(B, k)
    b[rows[use], pos[use]] = 32
    return a, b


def indel_pairs(rng, B: int, length: int, rate: float, alphabet: int = 4):
    """B pairs over a small alphabet: b is a copy of a with up to
    rate*length edits (each pair's own rate drawn from [rate/2, rate]),
    split evenly between substitutions, insertions and deletions.
    Returns two lists of uint8 arrays."""
    a_list, b_list = [], []
    for _ in range(B):
        a = rng.integers(0, alphabet, length).astype(np.uint8)
        n_ed = rng.binomial(length, rng.uniform(rate / 2, rate))
        ops = rng.integers(0, 3, n_ed)
        keep = np.ones(length, bool)
        keep[rng.choice(length, int((ops == 2).sum()), replace=False)] = False
        b = a.copy()
        subs = rng.choice(length, int((ops == 0).sum()), replace=False)
        b[subs] = (b[subs] + rng.integers(1, alphabet, subs.size)) % alphabet
        b = b[keep]
        n_ins = int((ops == 1).sum())
        at = np.sort(rng.integers(0, b.size + 1, n_ins))
        b = np.insert(b, at, rng.integers(0, alphabet, n_ins).astype(np.uint8))
        a_list.append(a)
        b_list.append(b.astype(np.uint8))
    return a_list, b_list


def planted_haystack(rng, n: int, needle_len: int, plants: int):
    """An n-byte haystack of uppercase letters with `plants` copies of a
    lowercase needle, each with up to 2 substitutions by 'a'.  Returns
    (needle, haystack, plant positions)."""
    needle = rng.integers(97, 123, needle_len).astype(np.uint8)
    hay = rng.integers(65, 91, n, dtype=np.uint8)
    pos = np.sort(rng.choice(n // needle_len - 1, plants, replace=False)
                  * needle_len)
    for p in pos:
        mut = needle.copy()
        mut[rng.integers(0, needle_len, 2)] = 97
        hay[p:p + needle_len] = mut
    return needle, hay, pos


def dictionary(rng, hay: np.ndarray, num: int, needle_len: int):
    """`num` needles of `needle_len`: half cut from the haystack with one
    substitution (they hit), half random lowercase (they mostly miss)."""
    out = []
    for i in range(num):
        if i % 2 == 0:
            p = int(rng.integers(0, hay.size - needle_len))
            nd = hay[p:p + needle_len].copy()
            nd[rng.integers(0, needle_len)] = 97
        else:
            nd = rng.integers(97, 123, needle_len).astype(np.uint8)
        out.append(nd)
    return out


def hamming_pairs(rng, B: int, length: int, max_sub: int):
    """B equal-length pairs with up to `max_sub` substitutions each."""
    a = rng.integers(65, 91, (B, length), dtype=np.uint8)
    b = a.copy()
    pos = rng.integers(0, length, (B, max_sub))
    use = rng.random((B, max_sub)) < 0.5
    rows = np.repeat(np.arange(B), max_sub).reshape(B, max_sub)
    b[rows[use], pos[use]] = 97
    return a, b
