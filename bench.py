"""Headline benchmark: banded Levenshtein distance throughput on one GPU.

Workload: 196,608 pairs of 1000 printable bytes, each b carrying 16..32
substitutions of its a, threshold k = 32 (`benches/workloads.distance_pairs`,
seeded).  The batch goes through the public `levenshtein_k_batch`, so the
time is end to end: host packing, upload, the bit-parallel kernel, fetch.

    python bench.py          # needs a GPU; BENCH_BATCH overrides the batch

Prints the card's name and power limit and the comparator rates on stderr,
and ONE JSON line on stdout:

    {"metric": ..., "value": pairs/s, "unit": "pairs/s", "vs_baseline": ...}

vs_baseline is the speedup over a compiled (-O3 C++) scalar banded DP on one
CPU core, the analog of the reference's scalar core; vs_cpu_bitparallel is
over the compiled bit-parallel comparator.  Both are built by
`make -C native` (at first use when `make` is present).
"""

import json
import os
import sys
import time

import numpy as np


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from triple_accel_jax.utils.runtime import (
        gpu_info,
        require_gpu,
        setup_compile_cache,
    )

    setup_compile_cache()
    _, kind, _ = require_gpu()

    import triple_accel_jax as ta
    from benches.workloads import distance_pairs
    from triple_accel_jax.types import LEVENSHTEIN_COSTS
    from triple_accel_jax.utils.native import (
        myers_distance_batch_native,
        scalar_banded_batch_native,
    )

    L, K = 1000, 32
    B = int(os.environ.get("BENCH_BATCH", "196608"))
    a, b = distance_pairs(np.random.default_rng(1234), B, L, K)

    dist = ta.levenshtein_k_batch(a, b, K)  # warm-up: compiles
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        dist = ta.levenshtein_k_batch(a, b, K)
        best = min(best, time.perf_counter() - t0)
    pairs_per_sec = B / best

    comp_n = 256
    t0 = time.perf_counter()
    sc = scalar_banded_batch_native(a[:comp_n], b[:comp_n], K,
                                    LEVENSHTEIN_COSTS)
    scalar_rate = comp_n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    my = myers_distance_batch_native(a[:comp_n], b[:comp_n], K)
    myers_rate = comp_n / (time.perf_counter() - t0)
    if sc is None or my is None:
        raise SystemExit("native comparators missing: run make -C native")
    assert np.array_equal(dist[:comp_n], sc) and np.array_equal(sc, my), \
        "bench result differs from the C++ comparators"

    print(f"# {gpu_info()} ({kind}); batch={B} best={best:.4f}s; "
          f"C++ scalar banded {scalar_rate:.0f} pairs/s, C++ bit-parallel "
          f"{myers_rate:.0f} pairs/s (one core)", file=sys.stderr)
    print(json.dumps({
        "metric": "levenshtein_banded_k32_len1000_pairs_per_sec",
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / scalar_rate, 1),
        "vs_cpu_bitparallel": round(pairs_per_sec / myers_rate, 1),
        "device_kind": kind,
    }))


if __name__ == "__main__":
    main()
