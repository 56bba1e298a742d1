"""Search benchmark: approximate-search throughput in haystack bytes/s.

Workload: a seeded 128 MB haystack of uppercase letters with 64 planted
copies of a 24-char lowercase needle (up to 2 substitutions each), k = 3,
All mode (`benches/workloads.planted_haystack`).  The search goes through
the public `levenshtein_search_simd_with_opts`: upload, windowing and the
bit-parallel kernel on the GPU, the two-phase hit fetch and the C++ replay
of the hits on the host.

    python bench_search.py   # needs a GPU; BENCH_HAY_MB overrides the size

Prints the card's name and power limit on stderr and ONE JSON line on
stdout; vs_baseline is the speedup over the compiled C++ All-mode search
(native/scalar_baseline.cpp) on one CPU core.
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

    from benches.workloads import planted_haystack
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts
    from triple_accel_jax.types import LEVENSHTEIN_COSTS, SearchType
    from triple_accel_jax.utils.native import search_all_native

    M, K = 24, 3
    N = int(os.environ.get("BENCH_HAY_MB", "128")) << 20
    needle, hay, plants = planted_haystack(np.random.default_rng(1234), N, M,
                                           64)

    def run():
        return levenshtein_search_simd_with_opts(needle, hay, K,
                                                 SearchType.All)

    matches = run()  # warm-up: compiles
    ends = {mt.end for mt in matches}
    assert all(int(p) + M in ends for p in plants), "planted match lost"
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    rate = N / best

    sl = hay[: 8 << 20]
    t0 = time.perf_counter()
    res = search_all_native(needle, sl, K, LEVENSHTEIN_COSTS)
    cpu_rate = sl.size / (time.perf_counter() - t0)
    if res is None:
        raise SystemExit("native comparators missing: run make -C native")

    print(f"# {gpu_info()} ({kind}); haystack={N >> 20}MB best={best:.4f}s "
          f"matches={len(matches)}; C++ search {cpu_rate / 1e6:.1f} MB/s "
          f"(one core)", file=sys.stderr)
    print(json.dumps({
        "metric": "levenshtein_search_n24_k3_haystack_bytes_per_sec",
        "value": round(rate, 1),
        "unit": "bytes/s",
        "vs_baseline": round(rate / cpu_rate, 1),
        "device_kind": kind,
    }))


if __name__ == "__main__":
    main()
