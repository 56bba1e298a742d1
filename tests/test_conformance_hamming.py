"""Conformance corpus: Hamming — ported from reference tests/basic_tests.rs
(test_basic_hamming_* at lines 5-98) plus the doctest examples embedded in
src/hamming.rs.  Every assertion value is taken verbatim from the reference.
"""

import numpy as np
import pytest

from triple_accel_jax import Match, SearchType, alloc_str, fill_str
from triple_accel_jax.hamming import (
    hamming,
    hamming_batch,
    hamming_search,
    hamming_search_naive,
    hamming_search_naive_with_opts,
    hamming_search_simd,
    hamming_search_simd_with_opts,
    hamming_simd_movemask,
    hamming_simd_parallel,
)
from triple_accel_jax.oracle import (
    hamming_naive,
    hamming_words_64,
    hamming_words_128,
)

DIST_IMPLS = [
    hamming_naive,
    hamming_words_64,
    hamming_words_128,
    hamming_simd_movemask,
    hamming_simd_parallel,
    hamming,
]


@pytest.mark.parametrize("impl", DIST_IMPLS)
def test_basic_hamming(impl):
    # basic_tests.rs:5-16, 74-98
    assert impl(b"abc", b"abd") == 1
    assert impl(b"", b"") == 0
    assert (
        impl(
            b"abcaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
            b"abdaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
        )
        == 1
    )


def test_basic_hamming_words_alloc():
    # basic_tests.rs:44-72 — via alloc_str/fill_str buffers
    a = alloc_str(3)
    fill_str(a, b"abc")
    b = alloc_str(3)
    fill_str(b, b"abd")
    assert hamming_words_64(a, b) == 1
    assert hamming_words_128(a, b) == 1


@pytest.mark.parametrize("impl", DIST_IMPLS)
def test_hamming_doctest(impl):
    # doctests hamming.rs:29-35, 163-174, 237-247, 309-315, 347-352, 383-392
    assert impl(b"abc", b"abd") == 1


@pytest.mark.parametrize(
    "search_with_opts,search_default",
    [
        (hamming_search_naive_with_opts, hamming_search_naive),
        (hamming_search_simd_with_opts, hamming_search_simd),
    ],
)
def test_basic_hamming_search(search_with_opts, search_default):
    # basic_tests.rs:18-42
    a1 = b"abc"
    b1 = b"  abc  abb"
    res = search_with_opts(a1, b1, 1, SearchType.All)
    assert res == [Match(start=2, end=5, k=0), Match(start=7, end=10, k=1)]

    res = search_default(a1, b1)
    assert res == [Match(start=2, end=5, k=0)]

    # SIMD variant with the long tail (basic_tests.rs:32-42)
    b2 = b"  abc  abb aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa"
    res = search_with_opts(a1, b2, 1, SearchType.All)
    assert res == [Match(start=2, end=5, k=0), Match(start=7, end=10, k=1)]
    res = search_default(a1, b2)
    assert res == [Match(start=2, end=5, k=0)]


@pytest.mark.parametrize(
    "search_with_opts",
    [hamming_search_naive_with_opts, hamming_search_simd_with_opts],
)
def test_hamming_search_doctests(search_with_opts):
    # doctests hamming.rs:62-68, 88-94, 414-420, 446-452, 581-587
    assert search_with_opts(b"abc", b"  abd", 1, SearchType.All) == [
        Match(start=2, end=5, k=1)
    ]


def test_hamming_search_needle_longer_than_haystack():
    assert hamming_search_simd_with_opts(b"abcd", b"ab", 1, SearchType.All) == []
    assert hamming_search_naive_with_opts(b"abcd", b"ab", 1, SearchType.All) == []


def test_hamming_search_null_bytes_supported_on_device():
    # device deviation (documented): the device path masks by length instead of
    # zero-padding, so null bytes are allowed where the reference panics.
    res = hamming_search_simd_with_opts(b"a\0c", b"xxa\0cxx", 0, SearchType.All)
    assert res == [Match(start=2, end=5, k=0)]


def test_hamming_search_sparse_candidates():
    """One matching region in a large random haystack: the device path
    takes the sparse branch (gathered blocks only, no O(n) counts
    array) and must agree with the streaming oracle in both modes."""
    rng = np.random.default_rng(55)
    hay = rng.integers(0, 250, 60_000).astype(np.uint8)
    needle = np.full(24, 251, dtype=np.uint8)  # alphabet-disjoint
    mut = needle.copy()
    mut[5] = 0
    hay[30_000 : 30_024] = mut
    for st in (SearchType.All, SearchType.Best):
        ref = hamming_search_naive_with_opts(needle, hay, 3, st)
        got = hamming_search_simd_with_opts(needle, hay, 3, st)
        assert got == ref, st
        # the uniform needle also hits at +-2 shifts (k<=3); the planted
        # position is the k=1 hit and the Best-mode sole survivor
        assert Match(start=30_000, end=30_024, k=1) in got
        if st == SearchType.Best:
            assert got == [Match(start=30_000, end=30_024, k=1)]


def test_hamming_search_dense_best_gmin_fetch():
    """Best mode over low-complexity text with the blessed default
    k = ceil(m/2): every block is a candidate for All, but Best needs
    only the global-minimum blocks — results must still match the
    streaming oracle exactly (order, count, k)."""
    rng = np.random.default_rng(91)
    m = 16
    hay = rng.integers(65, 67, 50_000).astype(np.uint8)
    needle = rng.integers(65, 67, m).astype(np.uint8)
    hay[20_000 : 20_000 + m] = needle  # guarantee a k=0 global min
    k = (m + 1) // 2
    ref = hamming_search_naive_with_opts(needle, hay, k, SearchType.Best)
    got = hamming_search_simd_with_opts(needle, hay, k, SearchType.Best)
    assert got == ref
    assert all(h.k == 0 for h in got) and len(got) >= 1


def test_hamming_batch():
    a = np.array([[1, 2, 3, 0], [5, 5, 5, 5]], dtype=np.uint8)
    b = np.array([[1, 9, 3, 0], [5, 5, 0, 0]], dtype=np.uint8)
    lengths = np.array([4, 2])
    assert hamming_batch(a, b, lengths).tolist() == [1, 0]
    assert hamming_batch(a, b).tolist() == [1, 2]
