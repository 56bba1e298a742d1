"""Core type and dispatch-rule unit tests (SURVEY.md §7 step 2).

EditCosts validation mirrors reference levenshtein.rs:44-52, 67-71;
max_k/unit_k bucket rules mirror levenshtein.rs:399-426, 731-763.
"""

import numpy as np
import pytest

from triple_accel_jax import (
    EditCosts,
    LEVENSHTEIN_COSTS,
    Match,
    RDAMERAU_COSTS,
    alloc_str,
    check_no_null_bytes,
    fill_str,
    to_bytes_array,
)
from triple_accel_jax.dispatch import (
    compute_max_k,
    compute_unit_k,
    dispatch_unit_k,
    select_cost_bucket,
)


def test_edit_costs_validation():
    EditCosts(1, 1, 0, None)
    EditCosts(1, 1, 0, 1)
    EditCosts(2, 3, 5, None)
    with pytest.raises(ValueError):
        EditCosts(0, 1, 0, None)  # mismatch must be positive
    with pytest.raises(ValueError):
        EditCosts(1, 0, 0, None)  # gap must be positive
    with pytest.raises(ValueError):
        EditCosts(1, 1, 0, 0)  # transpose must be positive
    with pytest.raises(ValueError):
        EditCosts(1, 1, 0, 2)  # transpose/2 must be < mismatch
    with pytest.raises(ValueError):
        EditCosts(5, 1, 0, 2)  # transpose/2 must be < gap


def test_check_search():
    RDAMERAU_COSTS.check_search()
    # transpose_cost > start_gap + gap is rejected for searches
    c = EditCosts(5, 5, 0, 6)
    with pytest.raises(ValueError):
        c.check_search()


def test_presets():
    assert LEVENSHTEIN_COSTS == EditCosts(1, 1, 0, None)
    assert RDAMERAU_COSTS == EditCosts(1, 1, 0, 1)
    assert not LEVENSHTEIN_COSTS.allow_transpose
    assert RDAMERAU_COSTS.allow_transpose


def test_match_equality():
    assert Match(1, 3, 1) == Match(1, 3, 1)
    assert Match(1, 3, 1) != Match(1, 3, 2)


def test_alloc_fill_str():
    # reference lib.rs doctests (lib.rs:190-195, 218-227)
    s = alloc_str(10)
    assert len(s) == 10
    a = np.zeros(5, dtype=np.uint8)
    fill_str(a, bytes([1, 2, 3, 4]))
    assert a.tolist() == [1, 2, 3, 4, 0]


def test_check_no_null_bytes():
    check_no_null_bytes(b"abc")
    with pytest.raises(ValueError):
        check_no_null_bytes(b"a\0c")


def test_to_bytes_array():
    assert to_bytes_array(b"ab").tolist() == [97, 98]
    assert to_bytes_array([1, 2]).dtype == np.uint8
    assert to_bytes_array(np.array([7], dtype=np.int64)).dtype == np.uint8


def test_max_k_unit_k_rules():
    # unit costs: max_k capped by min_len ("mismatch everything")
    assert compute_max_k(3, 10, 1 << 31, LEVENSHTEIN_COSTS) == 3 + 7
    assert compute_max_k(3, 10, 2, LEVENSHTEIN_COSTS) == 2
    # both empty
    assert compute_max_k(0, 0, 5, LEVENSHTEIN_COSTS) == 0
    # affine: starting one gap is charged once
    c = EditCosts(1, 1, 2, None)
    assert compute_max_k(2, 2, 100, c) == min(2 * 1, 4 * 1 + 2 + 2)
    # unit_k: at least one gap must be started
    assert compute_unit_k(10, c) == (10 - 2) // 1
    assert compute_unit_k(1, c) == 0
    # dispatcher caps at max_len (levenshtein.rs:760-763)
    assert dispatch_unit_k(5, 5, 1 << 31, LEVENSHTEIN_COSTS) <= 5


def test_cost_buckets():
    assert select_cost_bucket(254) == "u8"
    assert select_cost_bucket(255) == "u16"
    assert select_cost_bucket(65534) == "u16"
    assert select_cost_bucket(65535) == "u32"
