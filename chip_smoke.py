"""Smoke run of the main paths on one GPU, through the public API.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: only the sharded paths,
                                  # each compared with its one-card result

Phases (one card), each checked against the NumPy oracle or the C++
comparators in native/, zero mismatches allowed:

1. device: JAX's default backend is a GPU, or the run stops here;
2. native: `make -C native` builds the C++ comparators from source;
3. levenshtein_k_batch: 196,608 pairs of 1000 bytes at k=32, every pair
   checked against the compiled bit-parallel comparator; then the same
   batch timed end to end on the Triton kernel and the scan wavefront, and
   on resident inputs the kernel against its plain-XLA twin;
4. affine costs EditCosts(2,1,2): 256 pairs of 4000 bytes at ~5%
   divergence, k=400, against the compiled scalar banded DP; then
   trace_on=True on 1024 pairs of 1000 bytes, traces sampled against the
   oracle;
5. levenshtein_search_simd_with_opts: needle 24, k=3 over a 128 MB
   haystack with 64 planted needles, Best and All (every plant found, a
   1 MB slice equal to the C++ oracle port), one rdamerau and one
   anchored search; then the kernel and the scan timed end to end, and
   the kernel against its plain-XLA twin on a resident segment pack;
6. levenshtein_search_many: 32 needles over a 4 MB PackedHaystack, twice,
   equal to the per-needle API;
7. hamming_batch (10,000 pairs of 64 bytes) and
   hamming_search_simd_with_opts at k=3 over the 128 MB haystack, a 1 MB
   slice against the oracle;
8. the card-only tests (`pytest -m gpu`), in this process.

Earlier lines carry per-phase wall and compile times, the kernel / plain /
scan times and the compiled kernels' memory analysis; the line before the
last is `nvidia-smi --query-gpu=name,power.limit`; the last line is one
JSON object {"ok": true, "device": {...}}.  Exits non-zero, with no such
line, when a phase fails or no GPU is present.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 1234
FOUR = "--four" in sys.argv[1:]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


class Engine:
    """Force one engine for the calls inside the block (the public API
    reads TRIPLE_ACCEL_FORCE_PATH on every call)."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.prev = os.environ.get("TRIPLE_ACCEL_FORCE_PATH")
        os.environ["TRIPLE_ACCEL_FORCE_PATH"] = self.path

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("TRIPLE_ACCEL_FORCE_PATH", None)
        else:
            os.environ["TRIPLE_ACCEL_FORCE_PATH"] = self.prev


def parallel_chunks(fn, a, b, *args, chunks: int = 16):
    """Run a single-threaded native comparator over chunks of a batch in
    threads (ctypes releases the GIL during the call)."""
    n = len(a)
    edges = np.linspace(0, n, chunks + 1).astype(int)
    with ThreadPoolExecutor(chunks) as ex:
        parts = list(ex.map(
            lambda i: fn(a[edges[i]:edges[i + 1]], b[edges[i]:edges[i + 1]],
                         *args),
            range(chunks)))
    return np.concatenate(parts)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def spread(xs) -> str:
    return (f"median {statistics.median(xs):.4f}s min {min(xs):.4f}s "
            f"max {max(xs):.4f}s n={len(xs)}")


def kernel_vs_scan(label: str, call, reps: int = 10, scan_reps: int = 3):
    """End-to-end wall time of `call()` on the Triton kernel and the scan
    wavefront: one warm-up call each, then rounds that time the engines in
    turn (interleaved, so drift hits both alike; the scan, slower by far,
    only in the first `scan_reps` rounds).
    Returns ({engine: median seconds}, {engine: result})."""
    engines = (("pallas", "triton"), ("scan", "scan"))
    times, results = {name: [] for _, name in engines}, {}
    for path, name in engines:
        with Engine(path):
            results[name], first = timed(call)
        log(f"  {label} engine={name}: first call {first:.3f}s")
    for r in range(reps):
        for path, name in engines:
            if name == "scan" and r >= scan_reps:
                continue
            with Engine(path):
                times[name].append(timed(call)[1])
    for name, xs in times.items():
        log(f"  {label} engine={name}: {spread(xs)}")
    return {name: statistics.median(xs) for name, xs in times.items()}, results


def kernel_vs_twin(label: str, fns, reps: int = 10):
    """Device time of the kernel and its plain-XLA twin on resident
    inputs: {name: median seconds} over `reps` calls after a warm-up."""
    import jax

    out = {}
    for name, fn in fns:
        jax.block_until_ready(fn())
        xs = [timed(lambda: jax.block_until_ready(fn()))[1]
              for _ in range(reps)]
        log(f"  device-only {label} engine={name}: {spread(xs)}")
        out[name] = statistics.median(xs)
    return out


def memory_analysis(fn, *args, **kwargs) -> None:
    """Lower and compile `fn` afresh (timed) and print its compiled memory
    analysis."""
    compiled, t = timed(lambda: fn.lower(*args, **kwargs).compile())
    log(f"  {fn.__name__}: compile {t:.3f}s, memory_analysis "
        f"{compiled.memory_analysis()}")


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------


def phase_native():
    res = subprocess.run(["make", "-C", "native", "--always-make"],
                         capture_output=True, text=True)
    log(res.stdout.strip()[-400:])
    expect(res.returncode == 0, f"make -C native failed: {res.stderr[-400:]}")
    from triple_accel_jax.utils.native import native_available

    expect(native_available(), "native library did not load")


def phase_distance(ctx):
    import jax

    import triple_accel_jax as ta
    from benches.workloads import distance_pairs
    from triple_accel_jax.ops.pallas import myers_distance as md
    from triple_accel_jax.utils.native import myers_distance_batch_native

    rng = np.random.default_rng(SEED)
    B, L, K = 196608, 1000, 32
    a, b = distance_pairs(rng, B, L, K)
    out, first = timed(ta.levenshtein_k_batch, a, b, K)
    log(f"  levenshtein_k_batch first call (compile included): {first:.3f}s "
        f"path={ta.dispatch.last_dispatch().path}")
    expect(ta.dispatch.last_dispatch().path == "myers", "kernel arm not taken")
    ref, t_ref = timed(parallel_chunks, myers_distance_batch_native, a, b, K)
    bad = int((out != ref).sum())
    log(f"  checked {B} pairs against the C++ bit-parallel comparator "
        f"({t_ref:.1f}s): {bad} mismatches")
    expect(bad == 0, f"{bad} distance mismatches")
    times, res = kernel_vs_scan("k_batch 196608x1000 k=32",
                                lambda: ta.levenshtein_k_batch(a, b, K))
    for name, r in res.items():
        expect(np.array_equal(r, ref), f"engine {name} disagrees")
    ctx["distance_e2e"] = times
    # where the kernel path's end-to-end time goes: host packing, upload,
    # device, fetch (the engines on resident inputs)
    host, t_prep = timed(md.prepare_myers_inputs, a, b, K, 1024)
    t0 = time.perf_counter()
    args = jax.block_until_ready([jax.device_put(x) for x in host])
    t_up = time.perf_counter() - t0
    out_d = md.myers_distance_triton(*args, k=K, max_m=1024)
    t_fetch = timed(lambda: np.asarray(out_d))[1]
    log(f"  breakdown: prepare_myers_inputs {t_prep:.4f}s, upload "
        f"{t_up:.4f}s, fetch {t_fetch:.4f}s")
    ctx["distance_device"] = kernel_vs_twin("distance", (
        ("triton", lambda: md.myers_distance_triton(*args, k=K, max_m=1024)),
        ("jnp", lambda: md.myers_distance_jnp(*args, k=K, max_m=1024))))
    memory_analysis(md.myers_distance_triton, *args, k=K, max_m=1024)


def phase_affine():
    import triple_accel_jax as ta
    from benches.workloads import distance_pairs, indel_pairs
    from triple_accel_jax.levenshtein import levenshtein_k_batch
    from triple_accel_jax.oracle.levenshtein import (
        levenshtein_naive_k_with_opts,
    )
    from triple_accel_jax.types import EditCosts, LEVENSHTEIN_COSTS
    from triple_accel_jax.utils.native import scalar_banded_batch_native

    rng = np.random.default_rng(SEED + 1)
    costs = EditCosts(2, 1, 2)
    a, b = indel_pairs(rng, 256, 4000, 0.05)
    out, t = timed(levenshtein_k_batch, a, b, 400, costs)
    log(f"  affine k_batch 256x4000 k=400: {t:.3f}s "
        f"path={ta.dispatch.last_dispatch().path}")
    ref = parallel_chunks(scalar_banded_batch_native, a, b, 400, costs)
    bad = int((out != ref).sum())
    within = int((ref >= 0).sum())
    log(f"  affine: {bad} mismatches vs the C++ scalar banded DP "
        f"({within} of 256 pairs within k)")
    expect(bad == 0, f"{bad} affine mismatches")
    expect(0 < within < 256, "affine pairs all on one side of k")

    a2, b2 = distance_pairs(rng, 1024, 1000, 32)
    (dist, traces), t = timed(levenshtein_k_batch, a2, b2, 32,
                              LEVENSHTEIN_COSTS, True)
    log(f"  trace_on k_batch 1024x1000 k=32: {t:.3f}s "
        f"path={ta.dispatch.last_dispatch().path}")
    for i in rng.choice(1024, 6, replace=False):
        exp = levenshtein_naive_k_with_opts(a2[i], b2[i], 32, True,
                                            LEVENSHTEIN_COSTS)
        got = None if dist[i] < 0 else (int(dist[i]), traces[i])
        expect(got == exp, f"trace mismatch at pair {i}")
    log("  traces: 6 sampled pairs equal the oracle")


def _matches_from_native(res):
    from triple_accel_jax.types import Match

    ends, ks, lens = res
    return [Match(start=int(e - ln), end=int(e), k=int(kk))
            for e, kk, ln in zip(ends, ks, lens)]


def phase_search(ctx):
    import jax

    import triple_accel_jax as ta
    from benches.workloads import planted_haystack
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts
    from triple_accel_jax.ops.pallas import myers_search as ms
    from triple_accel_jax.types import (
        LEVENSHTEIN_COSTS,
        RDAMERAU_COSTS,
        SearchType,
    )
    from triple_accel_jax.utils.native import search_all_native

    rng = np.random.default_rng(SEED + 2)
    n, m, K = 128 << 20, 24, 3
    needle, hay, plants = planted_haystack(rng, n, m, 64)
    ctx["needle"], ctx["hay"] = needle, hay
    best, first = timed(levenshtein_search_simd_with_opts, needle, hay, K,
                        SearchType.Best)
    log(f"  search Best first call (compile included): {first:.3f}s "
        f"path={ta.dispatch.last_dispatch().path} matches={len(best)}")
    expect(ta.dispatch.last_dispatch().path == "myers_search",
           "kernel arm not taken")
    allm, t = timed(levenshtein_search_simd_with_opts, needle, hay, K,
                    SearchType.All)
    ends = {mt.end for mt in allm}
    missing = [int(p) for p in plants if int(p) + m not in ends]
    log(f"  search All: {len(allm)} matches in {t:.3f}s; "
        f"{64 - len(missing)}/64 plants found")
    expect(not missing, f"plants not found: {missing[:5]}")
    kmin = min(mt.k for mt in allm)
    expect(best and all(mt.k == kmin for mt in best), "Best not at min cost")
    # the 1 MB slice around the first plant
    lo = max(0, int(plants[0]) - (1 << 19))
    sl = hay[lo: lo + (1 << 20)]
    ctx["slice"] = sl
    for costs, name in ((LEVENSHTEIN_COSTS, "unit"),
                        (RDAMERAU_COSTS, "rdamerau")):
        got = levenshtein_search_simd_with_opts(needle, sl, K, SearchType.All,
                                                costs)
        exp = _matches_from_native(search_all_native(needle, sl, K, costs))
        log(f"  1 MB slice {name} All: {len(got)} matches, "
            f"equal to the C++ oracle port: {got == exp}")
        expect(got == exp and got, f"1 MB slice {name} mismatch")
    rd = levenshtein_search_simd_with_opts(needle, hay, K, SearchType.All,
                                           RDAMERAU_COSTS)
    expect(len(rd) >= len(allm), "rdamerau found fewer than unit costs")
    head = hay[plants[0]: plants[0] + (1 << 16)]
    got = levenshtein_search_simd_with_opts(needle, head, K, SearchType.All,
                                            LEVENSHTEIN_COSTS, True)
    exp = _matches_from_native(search_all_native(needle, head, K,
                                                 LEVENSHTEIN_COSTS, True))
    log(f"  anchored All at a plant: {got} (oracle port equal: {got == exp})")
    expect(got == exp and got, "anchored mismatch")
    times, res = kernel_vs_scan(
        "search 128MB m=24 k=3 All",
        lambda: levenshtein_search_simd_with_opts(needle, hay, K,
                                                  SearchType.All),
    )
    for name, r in res.items():
        expect(r == allm, f"engine {name} disagrees")
    ctx["search_e2e"] = times
    halo = ms.search_halo(m + K, n)
    own = ms.search_own_len(n, halo)
    num = ms.seg_count(n, own)
    hd = jax.device_put(hay)
    peq = jax.device_put(ms.prepare_peq([needle], m))
    seg_t = ms.device_pack_segs(hd, halo=halo, own_len=own, num=num)
    kw = dict(needle_len=m, seg_len=halo + own)
    ctx["search_device"] = kernel_vs_twin("search", (
        ("triton", lambda: ms.myers_search(peq, seg_t, **kw)),
        ("jnp", lambda: ms.myers_search_jnp(peq, seg_t, **kw))))
    memory_analysis(ms.myers_search_block_mins_from_hay, hd, peq,
                    needle_len=m, halo=halo, own_len=own, num=num)


def phase_many(ctx):
    import triple_accel_jax as ta
    from benches.workloads import dictionary
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts
    from triple_accel_jax.types import SearchType

    rng = np.random.default_rng(SEED + 3)
    hay = ctx["hay"][: 4 << 20]
    needles = dictionary(rng, hay, 32, 20)
    packed = ta.PackedHaystack(hay)
    first, t1 = timed(ta.levenshtein_search_many, needles, packed, 2,
                      SearchType.All)
    second, t2 = timed(ta.levenshtein_search_many, needles, packed, 2,
                       SearchType.All)
    log(f"  search_many 32 needles x 4MB: first {t1:.3f}s second {t2:.3f}s "
        f"path={ta.dispatch.last_dispatch().path} "
        f"hits={sum(len(r) for r in first)}")
    expect(first == second, "repeat call differs")
    single = [levenshtein_search_simd_with_opts(nd, hay, 2, SearchType.All)
              for nd in needles]
    expect(first == single, "search_many differs from the per-needle API")
    log("  equal to the per-needle API")


def phase_hamming(ctx):
    import triple_accel_jax as ta
    from benches.workloads import hamming_pairs
    from triple_accel_jax.hamming import hamming_search_simd_with_opts
    from triple_accel_jax.oracle.hamming import (
        hamming_naive,
        hamming_search_naive_with_opts,
    )
    from triple_accel_jax.types import SearchType

    rng = np.random.default_rng(SEED + 4)
    a, b = hamming_pairs(rng, 10000, 64, 6)
    got, t = timed(ta.hamming_batch, a, b)
    exp = np.array([hamming_naive(x, y) for x, y in zip(a, b)])
    log(f"  hamming_batch 10000x64: {t:.3f}s, equal to the oracle: "
        f"{np.array_equal(got, exp)}")
    expect(np.array_equal(got, exp), "hamming_batch mismatch")
    needle, hay = ctx["needle"], ctx["hay"]
    allm, t = timed(hamming_search_simd_with_opts, needle, hay, 3,
                    SearchType.All)
    log(f"  hamming search 128MB k=3 All: {len(allm)} matches in {t:.3f}s")
    sl = ctx["slice"]
    got = hamming_search_simd_with_opts(needle, sl, 3, SearchType.All)
    exp = hamming_search_naive_with_opts(needle, sl, 3, SearchType.All)
    expect(got == exp and got, "hamming 1 MB slice mismatch")
    log(f"  1 MB slice equal to the oracle ({len(got)} matches)")


def phase_gpu_tests():
    import pytest

    os.environ["TRIPLE_ACCEL_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "--durations=5", "tests/"])
    expect(rc == 0, f"pytest -m gpu exited {rc}")


# --------------------------------------------------------------------------
# four-card phase
# --------------------------------------------------------------------------


def phase_four():
    import jax

    import triple_accel_jax as ta
    from benches.workloads import dictionary, distance_pairs, hamming_pairs
    from benches.workloads import planted_haystack
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts
    from triple_accel_jax.parallel import make_mesh
    from triple_accel_jax.types import SearchType

    expect(len(jax.devices()) >= 4, f"need 4 GPUs, have {jax.devices()}")
    mesh = make_mesh(jax.devices()[:4])
    rng = np.random.default_rng(SEED)
    a, b = distance_pairs(rng, 196608, 1000, 32)
    one = ta.levenshtein_k_batch(a, b, 32)
    four, t = timed(ta.levenshtein_k_batch, a, b, 32, mesh=mesh)
    log(f"  k_batch mesh=4: {t:.3f}s path={ta.dispatch.last_dispatch().path}"
        f" equal to one card: {np.array_equal(one, four)}")
    expect(np.array_equal(one, four), "sharded k_batch differs")

    needle, hay, _ = planted_haystack(np.random.default_rng(SEED + 2),
                                      128 << 20, 24, 64)
    for st in (SearchType.Best, SearchType.All):
        one = levenshtein_search_simd_with_opts(needle, hay, 3, st)
        four, t = timed(ta.levenshtein_search_sharded, needle, hay, 3, mesh,
                        st)
        log(f"  search_sharded {st.name}: {t:.3f}s "
            f"path={ta.dispatch.last_dispatch().path} matches={len(four)} "
            f"equal to one card: {one == four}")
        expect(one == four, f"sharded search {st.name} differs")

    small = hay[: 4 << 20]
    needles = dictionary(np.random.default_rng(SEED + 3), small, 32, 20)
    packed = ta.PackedHaystack(small)
    one = ta.levenshtein_search_many(needles, packed, 2, SearchType.All)
    for _ in range(2):
        four, t = timed(ta.levenshtein_search_many, needles, packed, 2,
                        SearchType.All, mesh=mesh)
        log(f"  search_many mesh=4: {t:.3f}s "
            f"path={ta.dispatch.last_dispatch().path} "
            f"equal to one card: {one == four}")
        expect(one == four, "sharded search_many differs")

    ha, hb = hamming_pairs(np.random.default_rng(SEED + 4), 10000, 64, 6)
    one = ta.hamming_batch(ha, hb)
    four = ta.hamming_batch(ha, hb, mesh=mesh)
    log(f"  hamming_batch mesh=4 equal to one card: "
        f"{np.array_equal(one, four)}")
    expect(np.array_equal(one, four), "sharded hamming_batch differs")
    from triple_accel_jax.hamming import hamming_search_simd_with_opts

    one = hamming_search_simd_with_opts(needle, hay, 3, SearchType.All)
    four, t = timed(ta.hamming_search_sharded, needle, hay, 3, mesh,
                    SearchType.All)
    log(f"  hamming_search_sharded: {t:.3f}s equal to one card: {one == four}")
    expect(one == four, "sharded hamming search differs")


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from triple_accel_jax.utils.runtime import (
        gpu_info,
        require_gpu,
        setup_compile_cache,
    )

    setup_compile_cache()
    platform, kind, count = require_gpu()
    log(f"device: platform={platform} kind={kind} count={count}")
    ctx: dict = {}
    if FOUR:
        phases = [("four", phase_four)]
    else:
        phases = [
            ("native", phase_native),
            ("distance", lambda: phase_distance(ctx)),
            ("affine_and_trace", phase_affine),
            ("search", lambda: phase_search(ctx)),
            ("search_many", lambda: phase_many(ctx)),
            ("hamming", lambda: phase_hamming(ctx)),
            ("gpu_tests", phase_gpu_tests),
        ]
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name} ok in {time.perf_counter() - t0:.1f}s")
        except Exception:
            traceback.print_exc()
            log(f"phase {name} FAILED after {time.perf_counter() - t0:.1f}s")
            failed.append(name)
    for key in ("distance_e2e", "distance_device", "search_e2e",
                "search_device"):
        if key in ctx:
            log(f"{key}: " + json.dumps({k: round(v, 6)
                                          for k, v in ctx[key].items()}))
    log(gpu_info())
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
