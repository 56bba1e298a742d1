"""Criterion-equivalent randomized benchmark groups.

Mirrors the reference's benches/rand_benchmarks.rs: the same five groups,
the same size ladders, the same seed (1234), and — most importantly — the
same discipline of asserting cross-implementation equality on the random
workloads BEFORE timing anything (rand_benchmarks.rs:17-21, 45-46, 65-67,
88-90, 113-114: every bench run doubles as a differential test).

Run: python benches/rand_benchmarks.py  [--quick]
Prints one JSON line per group.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from triple_accel_jax import SearchType  # noqa: E402
from triple_accel_jax.hamming import (  # noqa: E402
    hamming_search_simd_with_opts,
    hamming_simd_parallel,
)
from triple_accel_jax.levenshtein import (  # noqa: E402
    levenshtein_k_batch,
    levenshtein_search_simd_with_opts,
    levenshtein_simd_k,
)
from triple_accel_jax.oracle import (  # noqa: E402
    hamming_naive,
    hamming_search_naive_with_opts,
    levenshtein_naive_k,
    levenshtein_search_naive_with_opts,
)

RNG = np.random.default_rng(1234)  # rand_benchmarks.rs:8


def rand_str(length):
    return RNG.integers(65, 91, length).astype(np.uint8)


def mutate(s, edits):
    """substitute/insert/delete mutations (rand_benchmarks.rs:207-238)."""
    out = list(s)
    for _ in range(edits):
        op = RNG.integers(0, 3)
        if op == 0 and out:
            out[RNG.integers(0, len(out))] = RNG.integers(65, 91)
        elif op == 1:
            out.insert(int(RNG.integers(0, len(out) + 1)),
                       int(RNG.integers(65, 91)))
        elif op == 2 and out:
            del out[RNG.integers(0, len(out))]
    return np.array(out, dtype=np.uint8)


def plant(haystack, needle, num):
    """plant `num` mutated needles (rand_benchmarks.rs:126-152)."""
    h = haystack.copy()
    for _ in range(num):
        nd = mutate(needle, max(1, len(needle) // 10))
        nd = nd[: len(needle)]
        pos = int(RNG.integers(0, len(h) - len(nd)))
        h[pos : pos + len(nd)] = nd
    return h


def timeit(fn, reps=3):
    fn()  # warm/compile
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t.append(time.perf_counter() - t0)
    return min(t)


def main():
    quick = "--quick" in sys.argv
    sizes = [10, 100, 1000]
    results = {}

    # group 1: hamming pairs (rand_benchmarks.rs:13-27)
    for L in sizes:
        a, b = rand_str(L), rand_str(L)
        b[RNG.integers(0, L, max(1, L // 10))] = 65
        assert hamming_simd_parallel(a, b) == hamming_naive(a, b)
        results[f"hamming_{L}"] = timeit(lambda: hamming_simd_parallel(a, b))

    # group 2: hamming search (rand_benchmarks.rs:39-50)
    for L in [100, 1000]:
        needle = rand_str(max(1, L // 10))
        hay = plant(rand_str(L), needle, 2)
        k = max(1, L // 100)
        got = hamming_search_simd_with_opts(needle, hay, k, SearchType.All)
        exp = hamming_search_naive_with_opts(needle, hay, k, SearchType.All)
        assert got == exp, (L, got[:3], exp[:3])
        results[f"hamming_search_{L}"] = timeit(
            lambda: hamming_search_simd_with_opts(needle, hay, k,
                                                  SearchType.All)
        )

    # group 2b: hamming search regimes on a big haystack — dense (the
    # blessed default k = ceil(m/2) on low-complexity text makes every
    # block a candidate; one native streaming pass) and sparse (one
    # planted match; gathered blocks only, no O(n) counts array)
    HN = (1 << 20) if quick else (1 << 22)
    m = 32
    hay = RNG.integers(65, 67, HN).astype(np.uint8)  # 2-symbol text
    needle_d = RNG.integers(65, 67, m).astype(np.uint8)
    kd = (m + 1) // 2  # default_hamming_k
    dt = timeit(lambda: hamming_search_simd_with_opts(
        needle_d, hay, kd, SearchType.All))
    results["hamming_search_dense_mb_per_sec"] = HN / dt / 1e6
    hay_s = RNG.integers(0, 250, HN).astype(np.uint8)
    needle_s = np.full(m, 251, dtype=np.uint8)
    hay_s[HN // 2 : HN // 2 + m] = needle_s
    got = hamming_search_simd_with_opts(needle_s, hay_s, 0, SearchType.All)
    assert [h.start for h in got] == [HN // 2], got[:3]
    dt = timeit(lambda: hamming_search_simd_with_opts(
        needle_s, hay_s, 0, SearchType.All))
    results["hamming_search_sparse_mb_per_sec"] = HN / dt / 1e6

    # groups 3+4: levenshtein distance, single + batched
    # (rand_benchmarks.rs:61-98)
    for L in sizes:
        k = max(1, L // 10)
        a = rand_str(L)
        b = mutate(a, max(1, k // 2))
        got = levenshtein_simd_k(a, b, k)
        exp = levenshtein_naive_k(a, b, k)
        assert got == exp, (L, got, exp)
        results[f"levenshtein_{L}"] = timeit(
            lambda: levenshtein_simd_k(a, b, k)
        )
    B = 64 if quick else 1024
    a_list = [rand_str(1000) for _ in range(B)]
    b_list = [mutate(a, 16) for a in a_list]
    for i in range(4):
        ref = levenshtein_naive_k(a_list[i], b_list[i], 100)
        got = int(levenshtein_k_batch(a_list[:8], b_list[:8], 100)[i])
        assert got == (ref if ref is not None else -1)
    dt = timeit(lambda: levenshtein_k_batch(a_list, b_list, 100))
    results["levenshtein_batch_pairs_per_sec"] = B / dt

    # group 5: levenshtein search (rand_benchmarks.rs:106-121)
    for L in [100, 1000]:
        needle = rand_str(max(1, L // 10))
        hay = plant(rand_str(L), needle, 2)
        k = max(1, L // 100)
        got = levenshtein_search_simd_with_opts(
            needle, hay, k, SearchType.All
        )
        exp = levenshtein_search_naive_with_opts(
            needle, hay, k, SearchType.All
        )
        assert got == exp, (L, got[:3], exp[:3])
        results[f"levenshtein_search_{L}"] = timeit(
            lambda: levenshtein_search_simd_with_opts(needle, hay, k,
                                                      SearchType.All)
        )

    # group 6 (beyond the reference): batched tracebacks in one program
    from triple_accel_jax.oracle import levenshtein_naive_k_with_opts

    TB = 32 if quick else 256
    dists_t, traces_t = levenshtein_k_batch(
        a_list[:TB], b_list[:TB], 100, trace_on=True
    )
    for i in range(2):
        ref = levenshtein_naive_k_with_opts(a_list[i], b_list[i], 100, True)
        assert dists_t[i] == ref[0] and traces_t[i] == ref[1], i
    dt = timeit(
        lambda: levenshtein_k_batch(a_list[:TB], b_list[:TB], 100,
                                    trace_on=True)
    )
    results["traced_batch_pairs_per_sec"] = TB / dt

    # group 7: mixed-length batch through per-bucket dispatch
    mixed_a = a_list[: B // 8] + [rand_str(64) for _ in range(B)]
    mixed_b = b_list[: B // 8] + [mutate(s, 3) for s in mixed_a[B // 8 :]]
    for i in (0, len(mixed_a) - 1):
        ref = levenshtein_naive_k(mixed_a[i], mixed_b[i], 100)
        got = int(levenshtein_k_batch([mixed_a[i]], [mixed_b[i]], 100)[0])
        assert got == (ref if ref is not None else -1)
    dt = timeit(lambda: levenshtein_k_batch(mixed_a, mixed_b, 100))
    results["mixed_batch_pairs_per_sec"] = len(mixed_a) / dt

    # group 8: dictionary search (same-length needles, one resident haystack)
    from triple_accel_jax.levenshtein import (
        PackedHaystack,
        levenshtein_search_many,
    )

    hay8 = rand_str(65536 if quick else 1 << 20)
    needles8 = [rand_str(24) for _ in range(8)]
    hay8 = plant(hay8, needles8[0], 2)
    many = levenshtein_search_many(needles8, hay8, 3, SearchType.All)
    for i in (0, 7):
        assert many[i] == levenshtein_search_simd_with_opts(
            needles8[i], hay8, 3, SearchType.All
        ), i
    dt = timeit(
        lambda: levenshtein_search_many(needles8, hay8, 3, SearchType.All)
    )
    results["dictionary_search_bytes_per_sec"] = len(hay8) * len(needles8) / dt

    # group 8b: the repeated-serving pattern — PackedHaystack keeps the
    # segmented layout resident on the device across calls
    packed = PackedHaystack(hay8)
    many_p = levenshtein_search_many(needles8, packed, 3, SearchType.All)
    assert many_p == many
    dt = timeit(
        lambda: levenshtein_search_many(needles8, packed, 3, SearchType.All)
    )
    results["dictionary_search_resident_bytes_per_sec"] = (
        len(hay8) * len(needles8) / dt
    )

    for name, v in results.items():
        unit = (
            "pairs/s" if name.endswith("pairs_per_sec")
            else "bytes/s" if name.endswith("bytes_per_sec")
            else "s"
        )
        print(json.dumps({"bench": name, "value": round(v, 6), "unit": unit}))
    print("# all differential asserts passed", file=sys.stderr)


if __name__ == "__main__":
    main()
