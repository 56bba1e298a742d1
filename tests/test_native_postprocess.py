"""Native C++ postprocessing must agree exactly with the NumPy fallback
(and both with the oracle's streaming semantics) on randomized inputs."""

import os
import subprocess

import numpy as np
import pytest

from triple_accel_jax import Match, SearchType
from triple_accel_jax.utils import native as native_mod


@pytest.fixture(scope="module", autouse=True)
def build_native():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run(["make", "-C", os.path.join(root, "native")], check=True,
                   capture_output=True)
    native_mod._load.cache_clear()
    yield


def _python_matches(dists, lengths, k, best):
    res = []
    curr_k = k
    for i in range(len(dists)):
        d = int(dists[i])
        if d > (curr_k if best else k):
            continue
        if best:
            curr_k = d
        m = Match(start=int(i - lengths[i]), end=int(i), k=d)
        if best and res and m.start <= res[-1].start:
            res[-1] = m
        else:
            res.append(m)
    if best:
        return [m for m in res if m.k == curr_k]
    return res


def test_native_loads():
    assert native_mod.native_available()


@pytest.mark.parametrize("best", [False, True])
def test_native_matches_python(best):
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(1, 500))
        dists = rng.integers(0, 8, n).astype(np.int64)
        dists[rng.random(n) < 0.7] = 1 << 40  # non-candidates
        lengths = rng.integers(0, 20, n).astype(np.int64)
        k = int(rng.integers(0, 6))
        got = native_mod.postprocess_matches_native(dists, lengths, k, best)
        assert got is not None
        assert got == _python_matches(dists, lengths, k, best), (trial, k, best)


@pytest.mark.parametrize("best", [False, True])
def test_native_hamming_matches_python(best):
    rng = np.random.default_rng(1)
    for trial in range(20):
        n = int(rng.integers(1, 500))
        counts = rng.integers(0, 10, n).astype(np.int64)
        k = int(rng.integers(0, 6))
        m = 7
        got = native_mod.postprocess_hamming_native(counts, m, k, best)
        assert got is not None
        # python reference
        res, curr_k = [], k
        for i in range(n):
            c = int(counts[i])
            if c <= curr_k:
                if best:
                    curr_k = c
                res.append(Match(start=i, end=i + m, k=c))
        if best:
            res = [x for x in res if x.k == curr_k]
        assert got == res


def test_search_intervals_matches_search_all():
    """One batched ta_search_intervals call == per-window ta_search_all."""
    from triple_accel_jax import LEVENSHTEIN_COSTS, RDAMERAU_COSTS

    rng = np.random.default_rng(7)
    for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS):
        for trial in range(10):
            m = int(rng.integers(1, 12))
            n = int(rng.integers(50, 800))
            needle = rng.integers(0, 4, m).astype(np.uint8)
            hay = rng.integers(0, 4, n).astype(np.uint8)
            k = int(rng.integers(0, m + 1))
            nint = int(rng.integers(1, 5))
            cuts = np.sort(rng.integers(0, n + 1, 2 * nint)).reshape(-1, 2)
            starts = cuts[:, 0].astype(np.int64)
            ends = cuts[:, 1].astype(np.int64)
            # make disjoint & strictly ascending
            for i in range(1, len(starts)):
                starts[i] = max(starts[i], ends[i - 1] + 1)
                ends[i] = max(ends[i], starts[i])
            got = native_mod.search_intervals_native(
                needle, hay, starts, ends, k, costs
            )
            assert got is not None
            ge, gk, gl = got
            exp_e, exp_k, exp_l = [], [], []
            for s, e in zip(starts.tolist(), ends.tolist()):
                sub = native_mod.search_all_native(
                    needle, hay[s:e], k, costs, False
                )
                assert sub is not None
                exp_e.extend((sub[0] + s).tolist())
                exp_k.extend(sub[1].tolist())
                exp_l.extend(sub[2].tolist())
            assert ge.tolist() == exp_e, (trial, costs)
            assert gk.tolist() == exp_k
            assert gl.tolist() == exp_l


def test_resolve_hits_batch_matches_oracle_fallback():
    """The batched resolver must give identical candidates with and
    without the native library (python-oracle interval fallback)."""
    from triple_accel_jax import LEVENSHTEIN_COSTS
    from triple_accel_jax.levenshtein import _resolve_hits_batch
    from triple_accel_jax.ops.search_scan import window_span

    rng = np.random.default_rng(8)
    needle = rng.integers(0, 3, 6).astype(np.uint8)
    hay = rng.integers(0, 3, 2000).astype(np.uint8)
    k = 2
    span = window_span(len(needle), k, 1, 0)
    # hit positions from the oracle (All mode) — a dense stream
    from triple_accel_jax.oracle import levenshtein_search_naive_with_opts

    oracle_all = levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    gpos = np.array(sorted({mt.end for mt in oracle_all}), dtype=np.int64)
    assert gpos.size > 50  # dense over this alphabet
    got_native = _resolve_hits_batch(needle, hay, gpos, k,
                                     LEVENSHTEIN_COSTS, span)
    os.environ["TRIPLE_ACCEL_NO_NATIVE"] = "1"
    native_mod._load.cache_clear()
    try:
        got_py = _resolve_hits_batch(needle, hay, gpos, k,
                                     LEVENSHTEIN_COSTS, span)
    finally:
        del os.environ["TRIPLE_ACCEL_NO_NATIVE"]
        native_mod._load.cache_clear()
    assert got_native == got_py
    # every oracle end is confirmed with the oracle's (dist, len)
    by_end = {mt.end: mt for mt in oracle_all}
    assert len(got_native) == gpos.size
    for p, d, ln in got_native:
        assert by_end[p].k == d and by_end[p].end - by_end[p].start == ln


def test_end_to_end_search_uses_native():
    """Search through the public API with native postprocessing built."""
    from triple_accel_jax import LEVENSHTEIN_COSTS
    from triple_accel_jax.levenshtein import (
        levenshtein_search_simd_with_opts,
    )
    from triple_accel_jax.oracle import levenshtein_search_naive_with_opts

    rng = np.random.default_rng(2)
    needle = rng.integers(33, 127, 10).astype(np.uint8)
    hay = rng.integers(33, 127, 3000).astype(np.uint8)
    hay[100:110] = needle
    hay[2000:2010] = needle
    for st in (SearchType.All, SearchType.Best):
        got = levenshtein_search_simd_with_opts(
            needle, hay, 2, st, LEVENSHTEIN_COSTS, False
        )
        ref = levenshtein_search_naive_with_opts(
            needle, hay, 2, st, LEVENSHTEIN_COSTS, False
        )
        assert got == ref
