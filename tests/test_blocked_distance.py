"""Unbounded-band distances: pairs whose band passes the bit-parallel
kernel's word limit run the banded `lax.scan` wavefront
(ops/band_scan.py) with a band as wide as the longer string, which makes
it exact for any pair lengths.  These are the input cases of the removed
chunked blocked Myers kernel, re-pointed at the engine that now serves
them.  Conformance anchor: the scalar oracle / C++ comparators."""

import numpy as np
import pytest

from triple_accel_jax.ops.band_scan import band_scan_distance, prepare_band_inputs
from triple_accel_jax.oracle.levenshtein import levenshtein_naive_with_opts
from triple_accel_jax.types import LEVENSHTEIN_COSTS, RDAMERAU_COSTS


def _run(pairs, damerau):
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    swapped = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs]
    a_list = [p[0] for p in swapped]
    b_list = [p[1] for p in swapped]
    width = max(len(b) for b in b_list)
    max_m = -(-max(max(len(a) for a in a_list), 1) // 8) * 8
    a_pad, b_pad, m, n = prepare_band_inputs(a_list, b_list, width, max_m)
    out = np.asarray(band_scan_distance(
        a_pad, b_pad, m, n, unit_k=width, max_m=max_m,
        costs_t=(1, 1, 0, 1 if damerau else 0, damerau), trace_on=False,
    )[0])
    for p, (a, b) in enumerate(pairs):
        ref = levenshtein_naive_with_opts(a, b, False, costs)[0]
        assert int(out[p]) == ref, (p, len(a), len(b), int(out[p]), ref)


@pytest.mark.parametrize("damerau", [False, True])
def test_full_band_distance_mixed_batch(damerau):
    r = np.random.default_rng(11 + damerau)
    rnd = lambda n: r.integers(0, 4, n).astype(np.uint8)  # noqa: E731
    pairs = [
        (rnd(30), rnd(45)),
        (rnd(5), rnd(5)),
        (rnd(0), rnd(9)),       # empty a
        (rnd(12), rnd(12)),
        (rnd(19), rnd(100)),    # very different lengths
        (rnd(1), rnd(1)),
    ]
    _run(pairs, damerau)


@pytest.mark.parametrize("damerau", [False, True])
def test_full_band_distance_long_pairs(damerau):
    """1300- and 1100-char pairs, plus a planted near-identical pair."""
    r = np.random.default_rng(23 + damerau)
    rnd = lambda n: r.integers(0, 4, n).astype(np.uint8)  # noqa: E731
    a = rnd(1300)
    b = a.copy()
    b[100] ^= 1
    b[1200] ^= 2
    pairs = [(rnd(1300), rnd(1100)), (a, b)]
    _run(pairs, damerau)


def test_wide_band_routes_to_scan():
    """levenshtein_k_batch on a long dissimilar pair at an unbounded
    threshold (a band far past the kernel's word limit) dispatches to
    the scan even with the kernel arms on, and stays exact (C++
    bit-parallel comparator as the reference)."""
    import os

    from triple_accel_jax.dispatch import interpret_kernels, last_dispatch
    from triple_accel_jax.levenshtein import levenshtein_k_batch
    from triple_accel_jax.utils.native import myers_distance_batch_native

    r = np.random.default_rng(3)
    a = r.integers(0, 4, 4200).astype(np.uint8)
    b = r.integers(0, 4, 4300).astype(np.uint8)
    os.environ["TRIPLE_ACCEL_FORCE_PATH"] = "pallas"
    try:
        with interpret_kernels():
            out = levenshtein_k_batch([a], [b], (1 << 32) - 1)
    finally:
        del os.environ["TRIPLE_ACCEL_FORCE_PATH"]
    assert last_dispatch().path == "scan"
    ref = myers_distance_batch_native([a], [b], 1 << 31)
    if ref is not None:
        assert int(out[0]) == int(ref[0])
    else:  # native lib not built
        assert int(out[0]) > 0
