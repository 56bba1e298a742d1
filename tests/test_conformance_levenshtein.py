"""Conformance corpus: Levenshtein distance — ported from reference
tests/basic_tests.rs (lines 100-577) plus the doctests of src/levenshtein.rs.
Every assertion value is verbatim from the reference.
"""

import pytest

from triple_accel_jax import Edit, EditCosts, EditType, LEVENSHTEIN_COSTS
from triple_accel_jax.levenshtein import (
    levenshtein,
    levenshtein_exp,
    levenshtein_exp_with_opts,
    levenshtein_naive,
    levenshtein_naive_k_with_opts,
    levenshtein_naive_with_opts,
    levenshtein_simd_k,
    levenshtein_simd_k_str,
    levenshtein_simd_k_with_opts,
    levenstein_naive_str,
    rdamerau,
    rdamerau_exp,
)

E = EditCosts


def test_basic_levenshtein_naive():
    # basic_tests.rs:100-161
    assert levenshtein_naive(b"abcde", b" ab cde") == 2
    assert levenshtein_naive(b"abcde", b"") == 5
    assert levenshtein_naive(b"abcde", b"abcdee") == 1
    assert levenshtein_naive(b"abcde", b"acde") == 1
    assert levenshtein_naive(b"abcde", b"abbde") == 1
    assert levenshtein_naive_with_opts(b"abcde", b"acbde", False, E(1, 1, 0, 1))[0] == 1
    assert levenshtein_naive_with_opts(b"ab", b"ba", False, E(1, 1, 0, 1))[0] == 1
    assert levenshtein_naive_with_opts(b"abc", b"aac", False, E(2, 3, 0, None))[0] == 2
    assert levenshtein_naive_with_opts(b"abc", b"aac", False, E(3, 1, 0, None))[0] == 2
    assert levenshtein_naive_with_opts(b"abc", b"ac", False, E(1, 1, 2, None))[0] == 3
    assert levenshtein_naive_with_opts(b"acde", b"abce", False, E(2, 1, 2, None))[0] == 4
    assert levenshtein_naive_with_opts(b"abcde", b"abe", False, E(1, 1, 2, None))[0] == 4


def test_trace_on_levenshtein_naive():
    # basic_tests.rs:163-195
    res = levenshtein_naive_with_opts(b"abcde", b" ab cde", True, LEVENSHTEIN_COSTS)
    assert res[0] == 2
    assert res[1] == [
        Edit(EditType.AGap, 1),
        Edit(EditType.Match, 2),
        Edit(EditType.AGap, 1),
        Edit(EditType.Match, 3),
    ]

    res = levenshtein_naive_with_opts(b"abcde", b"", True, LEVENSHTEIN_COSTS)
    assert res[0] == 5
    assert res[1] == [Edit(EditType.BGap, 5)]

    res = levenshtein_naive_with_opts(b"abcde", b"abcce", True, LEVENSHTEIN_COSTS)
    assert res[0] == 1
    assert res[1] == [
        Edit(EditType.Match, 3),
        Edit(EditType.Mismatch, 1),
        Edit(EditType.Match, 1),
    ]

    res = levenshtein_naive_with_opts(b"abcde", b"acbde", True, E(1, 1, 0, 1))
    assert res[0] == 1
    assert res[1] == [
        Edit(EditType.Match, 1),
        Edit(EditType.Transpose, 1),
        Edit(EditType.Match, 2),
    ]


def test_naive_doctests():
    # doctests levenshtein.rs:98-104, 116-122, 139-146, 335-341, 366-374
    assert levenshtein_naive(b"abc", b"ab") == 1
    assert levenstein_naive_str("abc", "ab") == 1
    res = levenshtein_naive_with_opts(b"abc", b"ab", True, LEVENSHTEIN_COSTS)
    assert res == (1, [Edit(EditType.Match, 2), Edit(EditType.BGap, 1)])
    res = levenshtein_naive_k_with_opts(b"abc", b"ab", 1, True, LEVENSHTEIN_COSTS)
    assert res == (1, [Edit(EditType.Match, 2), Edit(EditType.BGap, 1)])


@pytest.mark.parametrize(
    "impl",
    [
        lambda a, b: levenshtein(a, b),
        lambda a, b: levenshtein_exp(a, b),
    ],
)
def test_basic_levenshtein(impl):
    # basic_tests.rs:197-251
    assert impl(b"abcde", b" ab cde") == 2
    assert impl(b"abcde", b"") == 5
    assert impl(b"abcde", b"abcdee") == 1
    assert impl(b"abcde", b"acde") == 1
    assert impl(b"abcde", b"abbde") == 1


@pytest.mark.parametrize("impl", [rdamerau, rdamerau_exp])
def test_basic_rdamerau(impl):
    # basic_tests.rs:253-307
    assert impl(b"abcde", b" ab dce") == 3
    assert impl(b"abcde", b"") == 5
    assert impl(b"abcde", b"bacdee") == 2
    assert impl(b"abcde", b"acde") == 1
    assert impl(b"abcde", b"abbde") == 1


def _naive_k(a, b, k, trace, costs):
    return levenshtein_naive_k_with_opts(a, b, k, trace, costs)


def _simd_k(a, b, k, trace, costs):
    return levenshtein_simd_k_with_opts(a, b, k, trace, costs)


@pytest.mark.parametrize("impl", [_naive_k, _simd_k])
def test_basic_levenshtein_k_with_opts(impl):
    # basic_tests.rs:309-393 (naive_k) and 429-543 (simd_k) — shared cases
    assert impl(b"abcde", b" ab cde", 2, False, LEVENSHTEIN_COSTS)[0] == 2
    assert impl(b"abcde", b"", 10, False, LEVENSHTEIN_COSTS)[0] == 5
    assert impl(b"abcde", b"abcdee", 2, False, LEVENSHTEIN_COSTS)[0] == 1
    assert impl(b"abcde", b"acde", 2, False, LEVENSHTEIN_COSTS)[0] == 1
    assert impl(b"abcde", b"abbde", 2, False, LEVENSHTEIN_COSTS)[0] == 1
    assert impl(b"abcde", b"abbde", 1, False, LEVENSHTEIN_COSTS)[0] == 1
    assert impl(b"abcde", b"acbde", 1, False, E(1, 1, 0, 1))[0] == 1
    assert impl(b"ab", b"ba", 1, False, E(1, 1, 0, 1))[0] == 1
    assert impl(b"abc", b"aac", 5, False, E(2, 3, 0, None))[0] == 2
    assert impl(b"abc", b"aac", 5, False, E(3, 1, 0, None))[0] == 2
    assert impl(b"abc", b"ac", 5, False, E(1, 1, 2, None))[0] == 3
    assert impl(b"acde", b"abce", 5, False, E(2, 1, 2, None))[0] == 4
    assert impl(b"abcde", b"abe", 5, False, E(1, 1, 2, None))[0] == 4
    # over threshold -> None (basic_tests.rs:389-392, 539-542)
    assert impl(b"abcde", b"hello", 1, False, E(1, 1, 0, 1)) is None


def test_basic_levenshtein_simd_k_null_bytes():
    # basic_tests.rs:503-537 — null bytes ARE allowed in Levenshtein
    assert levenshtein_simd_k_with_opts(b"\0", b"", 2, False, LEVENSHTEIN_COSTS)[0] == 1
    assert levenshtein_simd_k_with_opts(b"ab\0de", b"a\0bde", 2, False, E(1, 1, 0, 1))[0] == 1
    assert levenshtein_simd_k_with_opts(b"\0b", b"b\0", 2, False, E(1, 1, 0, 1))[0] == 1
    assert levenshtein_simd_k_with_opts(b"\0", b"\0\0", 2, False, LEVENSHTEIN_COSTS)[0] == 1
    assert levenshtein_simd_k_with_opts(b"\0", b"\0", 2, False, E(1, 1, 0, 1))[0] == 0
    assert levenshtein_simd_k_with_opts(b"\0\0b\0", b"\0b\0\0", 2, False, E(1, 1, 0, 1))[0] == 1


@pytest.mark.parametrize("impl", [_naive_k, _simd_k])
def test_trace_on_levenshtein_k_with_opts(impl):
    # basic_tests.rs:396-427 (naive_k) and 546-577 (simd_k)
    res = impl(b"abcde", b" ab cde", 30, True, LEVENSHTEIN_COSTS)
    assert res[0] == 2
    assert res[1] == [
        Edit(EditType.AGap, 1),
        Edit(EditType.Match, 2),
        Edit(EditType.AGap, 1),
        Edit(EditType.Match, 3),
    ]

    res = impl(b"abcde", b"", 5, True, LEVENSHTEIN_COSTS)
    assert res[0] == 5
    assert res[1] == [Edit(EditType.BGap, 5)]

    res = impl(b"abcde", b"abcce", 1, True, LEVENSHTEIN_COSTS)
    assert res[0] == 1
    assert res[1] == [
        Edit(EditType.Match, 3),
        Edit(EditType.Mismatch, 1),
        Edit(EditType.Match, 1),
    ]

    res = impl(b"abcde", b"acbde", 2, True, E(1, 1, 0, 1))
    assert res[0] == 1
    assert res[1] == [
        Edit(EditType.Match, 1),
        Edit(EditType.Transpose, 1),
        Edit(EditType.Match, 2),
    ]


def test_both_empty():
    # levenshtein.rs:721-727 early return
    assert levenshtein_simd_k_with_opts(b"", b"", 0, False, LEVENSHTEIN_COSTS) == (0, None)
    assert levenshtein_simd_k_with_opts(b"", b"", 0, True, LEVENSHTEIN_COSTS) == (0, [])
    assert levenshtein(b"", b"") == 0


def test_simd_k_doctests():
    # doctests levenshtein.rs:634-640, 669-676, 705-712, 1390-1396, 1412-1418,
    # 1438-1444, 1471-1479, 1509-1515
    assert levenshtein_simd_k_str("abc", "ab", 1) == 1
    assert levenshtein_simd_k(b"abc", b"ab", 1) == 1
    res = levenshtein_simd_k_with_opts(b"abc", b"ab", 1, True, LEVENSHTEIN_COSTS)
    assert res == (1, [Edit(EditType.Match, 2), Edit(EditType.BGap, 1)])
    assert levenshtein(b"abc", b"ab") == 1
    assert rdamerau(b"abc", b"acb") == 1
    assert levenshtein_exp(b"abc", b"ab") == 1
    assert levenshtein_exp_with_opts(b"abc", b"ab", True, LEVENSHTEIN_COSTS) == (
        1,
        [Edit(EditType.Match, 2), Edit(EditType.BGap, 1)],
    )
    assert rdamerau_exp(b"abc", b"acb") == 1
    # lib.rs doctest: transpositions via simd_k_with_opts (lib.rs:100-111)
    assert levenshtein_simd_k_with_opts(b"abcd", b"abdc", 2, False, E(1, 1, 0, 1))[0] == 1


def test_unicode_str_helpers():
    assert levenshtein_simd_k_str("héllo", "hèllo", 2) == 1
    assert levenshtein_simd_k_str("abc", "abc", 0) == 0


def test_generic_alphabet_over_256_symbols():
    # the reference's levenshtein_naive is generic over T: PartialEq
    # (levenshtein.rs:148); >256 distinct symbols must work in the scalar
    # oracle and in levenstein_naive_str.
    import numpy as np

    # 300 distinct unicode chars, one substitution + one deletion
    chars = [chr(0x4E00 + i) for i in range(300)]
    a = "".join(chars)
    b = "".join(chars[:150] + ["X"] + chars[151:299])
    assert levenstein_naive_str(a, b) == 2
    assert levenstein_naive_str(a, a) == 0

    # int32 symbol arrays straight into the oracle
    a_sym = np.arange(1000, 1300, dtype=np.int32)
    b_sym = a_sym.copy()
    b_sym[7] = 5000
    assert levenshtein_naive(a_sym, b_sym) == 1
    res = levenshtein_naive_k_with_opts(a_sym, b_sym[:-2], 5, False)
    assert res is not None and res[0] == 3

    # translate_str keeps its reference contract: None above 256 distinct
    from triple_accel_jax.levenshtein import levenshtein_simd_k_str, translate_str

    shared = []
    assert translate_str(shared, a) is None
    assert levenshtein_simd_k_str(a, b, 10) is None
