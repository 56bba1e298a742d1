"""Doctest layer: every public blessed function carries a runnable example
(the analog of the reference's ~40 doctests, e.g. hamming.rs:29-35,
levenshtein.rs:98-104; the full assertion set is ported into the
conformance corpus, tests/test_conformance_*)."""

import doctest
import importlib

import pytest

import triple_accel_jax

# NOTE: triple_accel_jax.hamming / .levenshtein are FUNCTIONS at package
# level (reference re-export parity, lib.rs:126-127); fetch the modules
# through importlib.
MODULES = [
    "triple_accel_jax.hamming",
    "triple_accel_jax.levenshtein",
    "triple_accel_jax.oracle.hamming",
    "triple_accel_jax.oracle.levenshtein",
]


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests(name):
    mod = importlib.import_module(name)
    res = doctest.testmod(
        mod,
        extraglobs={
            "Match": triple_accel_jax.Match,
            "Edit": triple_accel_jax.Edit,
            "EditType": triple_accel_jax.EditType,
        },
        verbose=False,
    )
    assert res.failed == 0
    assert res.attempted > 0, f"{name} has no doctests"
