"""Seeded randomized differential tests — the analog of the reference's
pre-bench asserts (benches/rand_benchmarks.rs:17-21, 45-46, 65-67, 88-90,
113-114): every device implementation must agree exactly with the scalar
oracle on randomized workloads, using the reference's mutation model
(substitute/insert/delete, benches:207-238) and needle-planted haystacks
(benches:126-152, 175-198).
"""

import contextlib
import os

import numpy as np
import pytest

from triple_accel_jax import EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType
from triple_accel_jax.hamming import (
    hamming_batch,
    hamming_search_simd_with_opts,
    hamming_simd_parallel,
)
from triple_accel_jax.levenshtein import (
    levenshtein,
    levenshtein_exp,
    levenshtein_k_batch,
    levenshtein_search_simd_with_opts,
    levenshtein_simd_k_with_opts,
)
from triple_accel_jax.oracle import (
    hamming_naive,
    hamming_search_naive_with_opts,
    levenshtein_naive_k_with_opts,
    levenshtein_naive_with_opts,
    levenshtein_search_naive_with_opts,
)

SEED = 1234


@contextlib.contextmanager
def _kernels_forced():
    """The kernel arms forced on, in Pallas interpret mode on the CPU."""
    from triple_accel_jax.dispatch import interpret_kernels

    os.environ["TRIPLE_ACCEL_FORCE_PATH"] = "pallas"
    try:
        with interpret_kernels():
            yield
    finally:
        del os.environ["TRIPLE_ACCEL_FORCE_PATH"]


def rand_str(rng, length):
    return rng.integers(33, 127, size=length).astype(np.uint8)


def rand_hamming_mutate(rng, a, k):
    b = a.copy()
    curr_k = int(rng.integers(k // 2, k + 1))
    idx = rng.permutation(len(a))[:curr_k]
    b[idx] = 32
    return b


def rand_levenshtein_mutate(rng, a, k):
    """Reference mutation model (benches/rand_benchmarks.rs:207-238)."""
    edits = np.zeros(len(a), dtype=np.int64)
    curr_k = int(rng.integers(k // 2, k + 1))
    idx = rng.permutation(len(a))[:curr_k]
    edits[idx] = rng.integers(1, 4, size=curr_k)
    out = []
    for i, e in enumerate(edits):
        if e == 0:
            out.append(a[i])
        elif e == 1:
            out.append(32)
        elif e == 2:
            out.append(int(rng.integers(33, 127)))
            out.append(a[i])
        # e == 3: delete
    return np.array(out, dtype=np.uint8)


def plant_needles(rng, needle, haystack_len, num_match, k, hamming=False):
    """Needle-planted haystack (benches/rand_benchmarks.rs:126-152, 175-198)."""
    insert = np.zeros(haystack_len, dtype=bool)
    insert[rng.permutation(haystack_len)[:num_match]] = True
    out = []
    for i in range(haystack_len):
        if insert[i]:
            if hamming:
                out.extend(rand_hamming_mutate(rng, needle, k)[: len(needle)])
            else:
                out.extend(rand_levenshtein_mutate(rng, needle, k))
        else:
            out.append(int(rng.integers(33, 127)))
    return np.array(out, dtype=np.uint8)


@pytest.mark.parametrize("str_len", [10, 100, 1000])
def test_rand_hamming(str_len):
    rng = np.random.default_rng(SEED + str_len)
    k = max(1, str_len // 10)
    a = rand_str(rng, str_len)
    b = rand_hamming_mutate(rng, a, k)
    expected = hamming_naive(a, b)
    assert hamming_simd_parallel(a, b) == expected


@pytest.mark.parametrize("str_len", [100, 1000])
def test_rand_hamming_search(str_len):
    rng = np.random.default_rng(SEED + str_len)
    needle_len = str_len // 10
    num = str_len // 20
    k = max(1, str_len // 100)
    needle = rand_str(rng, needle_len)
    haystack = plant_needles(rng, needle, str_len, num, k, hamming=True)
    ref = hamming_search_naive_with_opts(needle, haystack, k, SearchType.All)
    dev = hamming_search_simd_with_opts(needle, haystack, k, SearchType.All)
    assert dev == ref
    ref_b = hamming_search_naive_with_opts(needle, haystack, k, SearchType.Best)
    dev_b = hamming_search_simd_with_opts(needle, haystack, k, SearchType.Best)
    assert dev_b == ref_b


def test_dense_hamming_search_default_k():
    """Low-complexity text with the blessed default k = ceil(m/2): every
    block is a candidate — the dense regime must stay exact through the
    single streaming postprocess pass (native or numpy)."""
    from triple_accel_jax.oracle.hamming import default_hamming_k

    rng = np.random.default_rng(SEED + 77)
    needle = rng.integers(0, 2, 9).astype(np.uint8)
    haystack = rng.integers(0, 2, 6000).astype(np.uint8)
    k = default_hamming_k(len(needle))
    for st in (SearchType.All, SearchType.Best):
        ref = hamming_search_naive_with_opts(needle, haystack, k, st)
        dev = hamming_search_simd_with_opts(needle, haystack, k, st)
        assert dev == ref, st


@pytest.mark.parametrize("str_len", [10, 100, 300])
def test_rand_levenshtein(str_len):
    rng = np.random.default_rng(SEED + str_len)
    k = max(1, str_len // 10)
    a = rand_str(rng, str_len)
    b = rand_levenshtein_mutate(rng, a, k)
    expected = levenshtein_naive_with_opts(a, b, False, LEVENSHTEIN_COSTS)[0]
    assert levenshtein(a, b) == expected
    assert levenshtein_exp(a, b) == expected


@pytest.mark.parametrize("str_len", [10, 100, 300])
@pytest.mark.parametrize(
    "costs",
    [
        LEVENSHTEIN_COSTS,
        RDAMERAU_COSTS,
        EditCosts(2, 1, 2, None),
        EditCosts(3, 2, 1, 2),
    ],
)
def test_rand_levenshtein_k_with_opts(str_len, costs):
    rng = np.random.default_rng(SEED + str_len + costs.mismatch_cost * 1000)
    k = max(1, str_len // 10)
    for trial in range(3):
        a = rand_str(rng, str_len)
        b = rand_levenshtein_mutate(rng, a, k)
        ref = levenshtein_naive_k_with_opts(a, b, k * 3, True, costs)
        dev = levenshtein_simd_k_with_opts(a, b, k * 3, True, costs)
        if ref is None:
            assert dev is None
        else:
            assert dev is not None
            assert dev[0] == ref[0]
            assert dev[1] == ref[1]


@pytest.mark.parametrize("str_len", [100, 1000])
@pytest.mark.parametrize(
    "costs,anchored",
    [
        (LEVENSHTEIN_COSTS, False),
        (RDAMERAU_COSTS, False),
        (LEVENSHTEIN_COSTS, True),
        (EditCosts(2, 1, 1, None), False),
        (RDAMERAU_COSTS, True),
    ],
)
def test_rand_levenshtein_search(str_len, costs, anchored):
    rng = np.random.default_rng(SEED + str_len + (1 if anchored else 0))
    needle_len = str_len // 10
    num = str_len // 20
    k = max(1, str_len // 100)
    needle = rand_str(rng, needle_len)
    haystack = plant_needles(rng, needle, str_len, num, k)
    for st in (SearchType.All, SearchType.Best):
        ref = levenshtein_search_naive_with_opts(
            needle, haystack, k, st, costs, anchored
        )
        dev = levenshtein_search_simd_with_opts(
            needle, haystack, k, st, costs, anchored
        )
        assert dev == ref, f"{st} {costs} anchored={anchored}"


def test_rand_levenshtein_batch():
    rng = np.random.default_rng(SEED)
    k = 16
    a_list, b_list, expected = [], [], []
    for _ in range(64):
        ln = int(rng.integers(0, 120))
        a = rand_str(rng, ln)
        b = rand_levenshtein_mutate(rng, a, max(1, ln // 8))
        if rng.integers(0, 2):
            a, b = b, a
        a_list.append(a)
        b_list.append(b)
        ref = levenshtein_naive_k_with_opts(a, b, k, False, LEVENSHTEIN_COSTS)
        expected.append(-1 if ref is None else ref[0])
    got = levenshtein_k_batch(a_list, b_list, k)
    assert got.tolist() == expected


def test_rand_hamming_batch():
    rng = np.random.default_rng(SEED)
    B, L = 128, 256
    a = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    b = a.copy()
    flips = rng.random((B, L)) < 0.05
    b[flips] = b[flips] + np.uint8(1)  # uint8 wraparound intended
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    got = hamming_batch(a, b, lengths)
    for p in range(B):
        assert got[p] == hamming_naive(a[p, : lengths[p]], b[p, : lengths[p]])


def test_chunked_search_equals_unchunked():
    """Shard+halo property (SURVEY.md §7): chunked device search must equal
    the oracle on haystacks much longer than the chunk size."""
    rng = np.random.default_rng(SEED)
    needle = rand_str(rng, 24)
    haystack = plant_needles(rng, needle, 12000, 40, 4)
    ref = levenshtein_search_naive_with_opts(
        needle, haystack, 4, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    dev = levenshtein_search_simd_with_opts(
        needle, haystack, 4, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    assert dev == ref


def test_levenshtein_exp_batch_matches_oracle():
    """Batched exponential search resolves every pair exactly, including
    pairs whose distance exceeds the initial k=30 bucket."""
    from triple_accel_jax.levenshtein import levenshtein_exp_batch
    from triple_accel_jax.oracle import levenshtein_naive

    rng = np.random.default_rng(5)
    a_list, b_list = [], []
    for _ in range(24):
        la = int(rng.integers(0, 120))
        lb = int(rng.integers(0, 120))
        a_list.append(rng.integers(65, 70, la).astype(np.uint8))
        b_list.append(rng.integers(65, 70, lb).astype(np.uint8))
    # one pair guaranteed far apart (distance > 30)
    a_list.append(np.full(80, 65, dtype=np.uint8))
    b_list.append(np.full(80, 66, dtype=np.uint8))
    got = levenshtein_exp_batch(a_list, b_list)
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        assert int(got[i]) == levenshtein_naive(a, b), i


def test_rand_levenshtein_batch_mesh_engines():
    """Randomized mesh-vs-meshless differential over the per-device
    engine ladder: unit costs (sharded Myers kernel), rdamerau and affine
    (sharded scan) — with the kernel arms on, every pair also
    spot-checked against the oracle."""
    import os

    import jax

    from triple_accel_jax.parallel import make_mesh

    rng = np.random.default_rng(SEED + 7)
    mesh = make_mesh(jax.devices()[:4])
    k = 16
    a_list, b_list = [], []
    for _ in range(96):
        ln = int(rng.integers(0, 120))
        a = rand_str(rng, ln)
        b = rand_levenshtein_mutate(rng, a, max(1, ln // 8))
        if rng.integers(0, 2):
            a, b = b, a
        a_list.append(a)
        b_list.append(b)
    with _kernels_forced():
        for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS,
                      EditCosts(2, 1, 2, None)):
            got = levenshtein_k_batch(a_list, b_list, k, costs, mesh=mesh)
            ref = levenshtein_k_batch(a_list, b_list, k, costs)
            assert np.array_equal(got, ref), costs
            for p in range(0, 96, 11):
                r = levenshtein_naive_k_with_opts(a_list[p], b_list[p], k,
                                                  False, costs)
                assert int(got[p]) == (-1 if r is None else r[0]), (p, costs)


def test_rand_search_sharded_engines():
    """Randomized sharded-search differential over the per-device engine
    ladder: unit/rdamerau (sharded Myers kernel) and affine costs (sharded
    scan), both modes, planted mutated needles straddling shard
    boundaries — vs the oracle and the single-device search."""
    import os

    import jax

    from triple_accel_jax.levenshtein import levenshtein_search_sharded
    from triple_accel_jax.parallel import make_mesh

    rng = np.random.default_rng(SEED + 8)
    mesh = make_mesh(jax.devices()[:4])
    m, k, n = 16, 3, 1200
    needle = rand_str(rng, m)
    hay = plant_needles(rng, needle, n, 5, k)
    hay[300 - m // 2: 300 + m - m // 2] = needle  # shard 0/1 straddler
    with _kernels_forced():
        for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS,
                      EditCosts(2, 1, 2, None)):
            for st in (SearchType.All, SearchType.Best):
                got = levenshtein_search_sharded(needle, hay, k, mesh, st,
                                                 costs)
                ora = levenshtein_search_naive_with_opts(
                    needle, hay, k, st, costs, False
                )
                assert got == ora, (st, costs)
                dev = levenshtein_search_simd_with_opts(
                    needle, hay, k, st, costs, False
                )
                assert got == dev, (st, costs)
