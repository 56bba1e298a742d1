"""Conformance corpus: Levenshtein search — ported from reference
tests/basic_tests.rs (test_basic_levenshtein_search_naive at 579-681 and
test_basic_levenshtein_search_simd at 683-815) plus doctests.  Assertion
values verbatim from the reference.
"""

import pytest

from triple_accel_jax import EditCosts, LEVENSHTEIN_COSTS, Match, RDAMERAU_COSTS, SearchType
from triple_accel_jax.levenshtein import (
    levenshtein_search_naive,
    levenshtein_search_naive_with_opts,
    levenshtein_search_simd,
    levenshtein_search_simd_with_opts,
)

E = EditCosts
All = SearchType.All


@pytest.mark.parametrize(
    "search,search_default",
    [
        (levenshtein_search_naive_with_opts, levenshtein_search_naive),
        (levenshtein_search_simd_with_opts, levenshtein_search_simd),
    ],
)
def test_basic_levenshtein_search(search, search_default):
    # shared cases of basic_tests.rs:579-681 / 683-815
    res = search(b"bcc", b"abcde", 1, All, LEVENSHTEIN_COSTS, False)
    assert res == [Match(1, 3, 1), Match(1, 4, 1)]

    assert search(b"", b"", 1, All, LEVENSHTEIN_COSTS, False) == []

    res = search(b"tast", b"testing 123 tating!", 1, All, LEVENSHTEIN_COSTS, False)
    assert res == [Match(0, 4, 1), Match(12, 15, 1)]

    res = search(b"tst", b"testing 123 tasting!", 1, All, LEVENSHTEIN_COSTS, False)
    assert res == [Match(0, 4, 1), Match(12, 16, 1)]

    res = search_default(b"tst", b"testing 123 tasting!")
    assert res == [Match(0, 4, 1), Match(12, 16, 1)]

    res = search(b"ab", b"ba", 1, All, E(1, 1, 0, 1), False)
    assert res == [Match(0, 1, 1), Match(0, 2, 1)]

    res = search(b"test", b"...tseting!", 1, All, E(1, 1, 0, 1), False)
    assert res == [Match(3, 7, 1)]

    res = search(b"test", b"...tssting!", 2, All, E(3, 1, 0, None), False)
    assert res == [Match(3, 5, 2), Match(3, 7, 2)]

    res = search(b"tst", b"testing 123 tasting", 1, All, LEVENSHTEIN_COSTS, False)
    assert res[0] == Match(0, 4, 1)

    res = search(b"test", b" testing 123 tasting", 1, All, LEVENSHTEIN_COSTS, True)
    assert res == [Match(1, 5, 1)]

    res = search(b"test", b" etsting 123 tasting", 2, All, RDAMERAU_COSTS, True)
    assert res == [Match(0, 3, 2), Match(0, 4, 2), Match(1, 5, 2)]

    res = search(b"test", b"etsting", 1, All, RDAMERAU_COSTS, True)
    assert res == [Match(0, 4, 1)]

    res = search(b"test", b"est", 3, All, E(1, 1, 2, None), True)
    assert res == [Match(0, 3, 3)]

    res = search(b"testing", b"   teing", 4, All, E(1, 1, 2, None), False)
    assert res == [Match(1, 8, 4)]

    res = search(b"testing", b"   teing", 4, All, E(2, 1, 2, None), False)
    assert res == [Match(3, 8, 4)]

    # empty haystack: the empty-prefix candidate (basic_tests.rs:670-674)
    res = search(b"abc", b"", 5, All, LEVENSHTEIN_COSTS, False)
    assert res == [Match(0, 0, 3)]

    # empty needle, anchored, All (basic_tests.rs:676-681)
    res = search(b"", b"abc", 2, All, LEVENSHTEIN_COSTS, True)
    assert res == [Match(0, 0, 0), Match(0, 1, 1), Match(0, 2, 2)]


@pytest.mark.parametrize(
    "search", [levenshtein_search_naive_with_opts, levenshtein_search_simd_with_opts]
)
def test_levenshtein_search_null_bytes(search):
    # basic_tests.rs:774-802 — null bytes allowed in levenshtein search
    res = search(b"\0b", b"b\0", 1, All, RDAMERAU_COSTS, True)
    assert res == [Match(0, 1, 1), Match(0, 2, 1)]

    res = search(b"\0\0", b"\0\0", 0, All, RDAMERAU_COSTS, True)
    assert res == [Match(0, 2, 0)]

    res = search(b"testing", b"   \0esting", 1, All, LEVENSHTEIN_COSTS, False)
    assert res == [Match(3, 10, 1)]

    res = search(b"\0\0\0", b"\0\0", 1, All, LEVENSHTEIN_COSTS, True)
    assert res == [Match(0, 2, 1)]

    res = search(b"\0\0", b"   \0\0", 0, All, RDAMERAU_COSTS, False)
    assert res == [Match(3, 5, 0)]


@pytest.mark.parametrize(
    "search", [levenshtein_search_naive_with_opts, levenshtein_search_simd_with_opts]
)
def test_search_doctests(search):
    # doctests levenshtein.rs:1542-1548, 1581-1588, 1858-1865, 1902-1910
    # and lib.rs:87-96
    res = search(b"abc", b"  acb", 1, All, RDAMERAU_COSTS, False)
    assert res == [Match(2, 4, 1), Match(2, 5, 1)]


@pytest.mark.parametrize(
    "search_default", [levenshtein_search_naive, levenshtein_search_simd]
)
def test_search_default_doctests(search_default):
    assert search_default(b"abc", b"  abd") == [Match(2, 5, 1)]
    # lib.rs:87-96 doctest
    assert search_default(b"helllo", b"hello world") == [Match(0, 5, 1)]


@pytest.mark.parametrize(
    "search", [levenshtein_search_naive_with_opts, levenshtein_search_simd_with_opts]
)
def test_search_best_mode(search):
    # Best semantics: curr_k shrinks, overlapped matches replaced, only the
    # best-k matches survive.
    res = search(b"abcd", b"xx abcd yy abd zz", 2, SearchType.Best,
                 LEVENSHTEIN_COSTS, False)
    assert res == [Match(3, 7, 0)]

    # two equally good hits both survive
    res = search(b"abc", b" abc abc ", 0, SearchType.Best,
                 LEVENSHTEIN_COSTS, False)
    assert res == [Match(1, 4, 0), Match(5, 8, 0)]


@pytest.mark.parametrize(
    "search", [levenshtein_search_naive_with_opts, levenshtein_search_simd_with_opts]
)
def test_search_empty_needle_unanchored(search):
    assert search(b"", b"abc", 5, All, LEVENSHTEIN_COSTS, False) == []
    assert search(b"", b"abc", 5, SearchType.Best, LEVENSHTEIN_COSTS, True) == [
        Match(0, 0, 0)
    ]
