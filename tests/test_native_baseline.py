"""The compiled CPU comparators (native/scalar_baseline.cpp) must agree
exactly with the Python oracle — they double as bench.py's honest
vs_baseline and as an extra differential witness for the device paths."""

import numpy as np
import pytest

from triple_accel_jax.oracle.levenshtein import levenshtein_naive_k_with_opts
from triple_accel_jax.types import (
    EditCosts,
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
)
from triple_accel_jax.utils.native import (
    myers_distance_batch_native,
    native_available,
    scalar_banded_batch_native,
)

pytestmark = pytest.mark.skipif(
    not native_available()
    or scalar_banded_batch_native([b"a"], [b"a"], 1, LEVENSHTEIN_COSTS)
    is None,
    reason="native library not built (make -C native)",
)


def _rand_batch(rng, n, max_len=60, alpha=5):
    a_list, b_list = [], []
    for _ in range(n):
        a_list.append(
            rng.integers(0, alpha, int(rng.integers(0, max_len))).astype(
                np.uint8
            )
        )
        b_list.append(
            rng.integers(0, alpha, int(rng.integers(0, max_len))).astype(
                np.uint8
            )
        )
    return a_list, b_list


@pytest.mark.parametrize(
    "costs",
    [
        LEVENSHTEIN_COSTS,
        RDAMERAU_COSTS,
        EditCosts(2, 1, 1, None),
        EditCosts(3, 2, 4, 2),
    ],
)
def test_scalar_banded_matches_oracle(costs):
    rng = np.random.default_rng(42)
    a_list, b_list = _rand_batch(rng, 120)
    for k in (0, 2, 7, 100):
        got = scalar_banded_batch_native(a_list, b_list, k, costs)
        for i in range(len(a_list)):
            ref = levenshtein_naive_k_with_opts(
                a_list[i], b_list[i], k, False, costs
            )
            exp = -1 if ref is None else ref[0]
            assert got[i] == exp, (i, k, costs)


def test_myers_cpu_matches_oracle():
    rng = np.random.default_rng(43)
    a_list, b_list = _rand_batch(rng, 120, max_len=200)
    for k in (0, 2, 7, 300):
        got = myers_distance_batch_native(a_list, b_list, k)
        for i in range(len(a_list)):
            ref = levenshtein_naive_k_with_opts(
                a_list[i], b_list[i], k, False, LEVENSHTEIN_COSTS
            )
            exp = -1 if ref is None else ref[0]
            assert got[i] == exp, (i, k)


def test_myers_cpu_multiword():
    # patterns crossing the 64-bit word boundary (W up to 4)
    rng = np.random.default_rng(44)
    for m in (63, 64, 65, 127, 128, 129, 200):
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a.copy()
        idx = rng.permutation(m)[:5]
        b[idx] = 4
        got = myers_distance_batch_native([a], [b], m)
        ref = levenshtein_naive_k_with_opts(a, b, m, False, LEVENSHTEIN_COSTS)
        assert got[0] == ref[0], m
