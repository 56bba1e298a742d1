"""Search through the public API with the bit-parallel kernel arms on
(Pallas interpret mode on the CPU) and through the scan wavefront that
serves every other cost model and needles past the word limit: both
must agree exactly with the scalar oracle, including length tie-breaks,
segment halos and the dense-hit resolution paths."""

import os

import numpy as np
import pytest

from triple_accel_jax import EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType
from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts
from triple_accel_jax.oracle import levenshtein_search_naive_with_opts


class _forced:
    """Force one engine for the block; "pallas" runs the kernels in
    interpret mode through the dispatcher's test switch."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        from triple_accel_jax.dispatch import interpret_kernels

        os.environ["TRIPLE_ACCEL_FORCE_PATH"] = self.path
        self.sw = interpret_kernels(self.path == "pallas")
        self.sw.__enter__()

    def __exit__(self, *exc):
        self.sw.__exit__(*exc)
        del os.environ["TRIPLE_ACCEL_FORCE_PATH"]


@pytest.mark.parametrize(
    "costs,anchored",
    [
        (LEVENSHTEIN_COSTS, False),
        (RDAMERAU_COSTS, False),
        (EditCosts(2, 1, 1, None), False),
        (LEVENSHTEIN_COSTS, True),
        (RDAMERAU_COSTS, True),
    ],
)
def test_pallas_search_matches_oracle(costs, anchored):
    rng = np.random.default_rng(99)
    m, k, n = 9, 2, 700
    needle = rng.integers(33, 127, m).astype(np.uint8)
    haystack = rng.integers(33, 127, n).astype(np.uint8)
    for pos in [0, 50, 511, 512, 640, n - m]:
        haystack[pos : pos + m] = needle
        if pos % 2:
            haystack[pos + 2] = 33
    for st in (SearchType.All, SearchType.Best):
        ref = levenshtein_search_naive_with_opts(
            needle, haystack, k, st, costs, anchored
        )
        with _forced("pallas"):
            got = levenshtein_search_simd_with_opts(
                needle, haystack, k, st, costs, anchored
            )
        assert got == ref, f"{st} {costs} anchored={anchored}"


def test_pallas_search_small_cases():
    # a couple of the reference corpus cases through the pallas path
    with _forced("pallas"):
        got = levenshtein_search_simd_with_opts(
            b"bcc", b"abcde", 1, SearchType.All, LEVENSHTEIN_COSTS, False
        )
    ref = levenshtein_search_naive_with_opts(
        b"bcc", b"abcde", 1, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    assert got == ref

    with _forced("pallas"):
        got = levenshtein_search_simd_with_opts(
            b"test", b"...tseting!", 1, SearchType.All, EditCosts(1, 1, 0, 1),
            False,
        )
    assert got == levenshtein_search_naive_with_opts(
        b"test", b"...tseting!", 1, SearchType.All, EditCosts(1, 1, 0, 1), False
    )

    with _forced("pallas"):
        got = levenshtein_search_simd_with_opts(
            b"abc", b"", 5, SearchType.All, LEVENSHTEIN_COSTS, False
        )
    assert got == levenshtein_search_naive_with_opts(
        b"abc", b"", 5, SearchType.All, LEVENSHTEIN_COSTS, False
    )


def test_pallas_search_nul_needle():
    # Needles containing 0x00 must not match chunk 0's synthetic zero-pad
    # halo (chunk_raw): hits are oracle-verified and artifacts dropped.
    from triple_accel_jax.levenshtein import levenshtein_search_many

    cases = [
        (b"\x00\x00a", b"abcabc", 0),
        (b"\x00\x00a", b"abcabc", 1),
        (b"a\x00b", b"a\x00b xyz a_b", 1),
        (b"\x00\x00\x00", b"\x00\x00\x00rest", 0),
    ]
    for needle, hay, k in cases:
        for st in (SearchType.All, SearchType.Best):
            ref = levenshtein_search_naive_with_opts(
                needle, hay, k, st, LEVENSHTEIN_COSTS, False
            )
            with _forced("pallas"):
                got = levenshtein_search_simd_with_opts(
                    needle, hay, k, st, LEVENSHTEIN_COSTS, False
                )
            assert got == ref, (needle, hay, k, st)
            with _forced("pallas"):
                got_many = levenshtein_search_many([needle], hay, k, st)
            assert got_many == [ref], (needle, hay, k, st)


def test_pallas_search_nul_differential():
    # random alphabet including 0x00, vs the oracle, both engines
    rng = np.random.default_rng(7)
    for trial in range(6):
        m = int(rng.integers(2, 12))
        n = int(rng.integers(20, 400))
        needle = rng.integers(0, 4, m).astype(np.uint8)
        haystack = rng.integers(0, 4, n).astype(np.uint8)
        k = int(rng.integers(0, 3))
        ref = levenshtein_search_naive_with_opts(
            needle, haystack, k, SearchType.All, LEVENSHTEIN_COSTS, False
        )
        with _forced("pallas"):
            got = levenshtein_search_simd_with_opts(
                needle, haystack, k, SearchType.All, LEVENSHTEIN_COSTS, False
            )
        assert got == ref, (trial, needle.tobytes(), k)


def test_dense_hit_regime():
    # low-complexity text with the blessed default
    # k = ceil(m/2) makes most positions hits; Best mode must use the
    # global-min filter (no per-hit loop), All mode must stay exact.
    rng = np.random.default_rng(17)
    hay = rng.integers(65, 67, 3000).astype(np.uint8)  # 2-char alphabet
    needle = rng.integers(65, 67, 8).astype(np.uint8)
    k = 4  # default_search_k(8)
    for st in (SearchType.Best, SearchType.All):
        ref = levenshtein_search_naive_with_opts(
            needle, hay, k, st, LEVENSHTEIN_COSTS, False
        )
        with _forced("pallas"):
            got = levenshtein_search_simd_with_opts(
                needle, hay, k, st, LEVENSHTEIN_COSTS, False
            )
        assert got == ref, st
    # same regime through the scan wavefront
    for st in (SearchType.Best, SearchType.All):
        ref = levenshtein_search_naive_with_opts(
            needle, hay, k, st, LEVENSHTEIN_COSTS, False
        )
        with _forced("scan"):
            got = levenshtein_search_simd_with_opts(
                needle, hay, k, st, LEVENSHTEIN_COSTS, False
            )
        assert got == ref, ("band", st)


def test_dense_all_mode_single_device_pass():
    """All-mode default-k over low-complexity text: EVERY position is a
    hit, and the whole stream must resolve through ONE device wavefront
    pass (the batched C++ interval replay) — no general-engine re-pass.
    Asserted via the dispatch history."""
    from triple_accel_jax.dispatch import dispatch_history

    rng = np.random.default_rng(29)
    hay = rng.integers(65, 67, 40_000).astype(np.uint8)
    needle = rng.integers(65, 67, 8).astype(np.uint8)
    k = 4  # default_search_k(8)
    ref = levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    dispatch_history(clear=True)
    with _forced("pallas"):
        got = levenshtein_search_simd_with_opts(
            needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
        )
    hist = dispatch_history()
    paths = [d.path for _, d in hist]
    assert paths == ["myers_search"], paths  # exactly one device pass
    assert got == ref
    assert len(got) > 30_000  # genuinely dense


def test_dense_over_budget_resolves_on_device():
    """When the merged replay intervals exceed _RESOLVE_CELLS_BUDGET, the
    hits must resolve through the scan wavefront over hit-bearing segments
    only (path `scan_resolve`) — the Myers pass is never discarded and no
    engine reruns over the whole haystack."""
    import importlib

    lev = importlib.import_module("triple_accel_jax.levenshtein")
    from triple_accel_jax.dispatch import dispatch_history

    rng = np.random.default_rng(31)
    hay = rng.integers(65, 67, 6_000).astype(np.uint8)
    needle = rng.integers(65, 67, 8).astype(np.uint8)
    k = 4
    ref = levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    saved = lev._RESOLVE_CELLS_BUDGET
    lev._RESOLVE_CELLS_BUDGET = 1  # force the degenerate-dense branch
    try:
        dispatch_history(clear=True)
        with _forced("pallas"):
            got = levenshtein_search_simd_with_opts(
                needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
            )
        paths = [d.path for _, d in dispatch_history()]
    finally:
        lev._RESOLVE_CELLS_BUDGET = saved
    assert paths == ["myers_search", "scan_resolve"], paths
    assert got == ref
    assert len(got) > 4_000  # genuinely dense


def test_dense_over_budget_resolves_on_device_search_many():
    """Same degenerate-dense guarantee for the dictionary path."""
    import importlib

    lev = importlib.import_module("triple_accel_jax.levenshtein")
    from triple_accel_jax.levenshtein import levenshtein_search_many

    rng = np.random.default_rng(33)
    hay = rng.integers(65, 67, 3_000).astype(np.uint8)
    needles = [rng.integers(65, 67, 8).astype(np.uint8) for _ in range(2)]
    k = 4
    saved = lev._RESOLVE_CELLS_BUDGET
    lev._RESOLVE_CELLS_BUDGET = 1
    try:
        with _forced("pallas"):
            got = levenshtein_search_many(needles, hay, k, SearchType.All)
    finally:
        lev._RESOLVE_CELLS_BUDGET = saved
    for i, nd in enumerate(needles):
        ref = levenshtein_search_naive_with_opts(
            nd, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
        )
        assert got[i] == ref, i


def test_scan_resolve_nul_needle_front_pad():
    """NUL bytes in the needle can match segment 0's synthetic zero-pad
    front halo: the on-device resolve path must oracle-correct positions
    <= halo exactly like the replay path does."""
    import importlib

    lev = importlib.import_module("triple_accel_jax.levenshtein")

    rng = np.random.default_rng(35)
    hay = rng.integers(0, 3, 3_000).astype(np.uint8)  # NULs in haystack
    needle = np.array([0, 0, 1, 0, 2, 0, 1, 0], dtype=np.uint8)
    k = 4
    ref = levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    saved = lev._RESOLVE_CELLS_BUDGET
    lev._RESOLVE_CELLS_BUDGET = 1
    try:
        with _forced("pallas"):
            got = levenshtein_search_simd_with_opts(
                needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
            )
    finally:
        lev._RESOLVE_CELLS_BUDGET = saved
    assert got == ref


def test_dense_best_exact_tie_positions():
    # multiple exact (k=0-cost) occurrences: Best must keep every
    # non-overlapped global-min match in stream order
    hay = b"xx_needle_yy_needle_zz_needle_"
    ref = levenshtein_search_naive_with_opts(
        b"needle", hay, 3, SearchType.Best, LEVENSHTEIN_COSTS, False
    )
    with _forced("pallas"):
        got = levenshtein_search_simd_with_opts(
            b"needle", hay, 3, SearchType.Best, LEVENSHTEIN_COSTS, False
        )
    assert got == ref and len(got) == 3


def test_rdamerau_myers_search():
    # RDAMERAU_COSTS routes to the bit-parallel Myers kernel with the
    # transposition-seed term; transposition-dense inputs vs the oracle
    rng = np.random.default_rng(41)
    for trial in range(8):
        m = int(rng.integers(2, 30))
        n = int(rng.integers(0, 400))
        needle = rng.integers(0, 4, m).astype(np.uint8)
        hay = rng.integers(0, 4, n).astype(np.uint8)
        k = int(rng.integers(0, m // 2 + 2))
        for st in (SearchType.All, SearchType.Best):
            ref = levenshtein_search_naive_with_opts(
                needle, hay, k, st, RDAMERAU_COSTS, False
            )
            with _forced("pallas"):
                got = levenshtein_search_simd_with_opts(
                    needle, hay, k, st, RDAMERAU_COSTS, False
                )
            assert got == ref, (trial, m, n, k, st)
    # explicit adjacent-swap cases
    for needle, hay in [(b"abcdef", b"xx abcedf yy bacdef"),
                        (b"ab", b"ba"), (b"abab", b"baba")]:
        ref = levenshtein_search_naive_with_opts(
            needle, hay, 2, SearchType.All, RDAMERAU_COSTS, False
        )
        with _forced("pallas"):
            got = levenshtein_search_simd_with_opts(
                needle, hay, 2, SearchType.All, RDAMERAU_COSTS, False
            )
        assert got == ref, needle


def test_anchored_myers_dispatch():
    """Anchored unit/rdamerau searches route through the Myers kernel as a
    single anchored segment: dispatch log proves the kernel path ran,
    results match the oracle — including k >= m (the end-0 empty-prefix
    candidate), NUL needle bytes, the word limit (256 chars) and
    needles past it (the scan wavefront)."""
    from triple_accel_jax.dispatch import dispatch_history

    rng = np.random.default_rng(53)
    cases = [
        # (m, k, n, costs, prefix) -> expected path prefix
        (12, 6, 300, LEVENSHTEIN_COSTS, "myers_search"),
        (12, 15, 300, LEVENSHTEIN_COSTS, "myers_search"),  # k >= m: end-0
        (12, 6, 300, RDAMERAU_COSTS, "myers_search_rdamerau"),
        (256, 40, 600, RDAMERAU_COSTS, "myers_search_rdamerau"),
        (1500, 400, 3000, LEVENSHTEIN_COSTS, "scan"),
        (2000, 2100, 4200, LEVENSHTEIN_COSTS, "scan"),
    ]
    for m, k, n, costs, path in cases:
        needle = rng.integers(0, 4, m).astype(np.uint8)
        hay = rng.integers(0, 4, n).astype(np.uint8)
        L = min(m, n)
        hay[:L] = needle[:L]
        for _ in range(min(4, k)):
            hay[rng.integers(0, L)] = rng.integers(0, 4)
        for st in (SearchType.All, SearchType.Best):
            ref = levenshtein_search_naive_with_opts(
                needle, hay, k, st, costs, True
            )
            dispatch_history(clear=True)
            with _forced("pallas"):
                got = levenshtein_search_simd_with_opts(
                    needle, hay, k, st, costs, True
                )
            paths = [d.path for _, d in dispatch_history()]
            assert paths == [path], (m, k, st, paths)
            assert got == ref, (m, k, n, st)
    # NUL bytes in needle and haystack stay exact (no front pad exists in
    # the anchored segment, so no artifact correction is involved)
    needle = np.array([0, 65, 0, 66, 0], dtype=np.uint8)
    hay = np.array([0, 65, 0, 67, 0, 0, 65] * 10, dtype=np.uint8)
    for st in (SearchType.All, SearchType.Best):
        ref = levenshtein_search_naive_with_opts(
            needle, hay, 3, st, LEVENSHTEIN_COSTS, True
        )
        with _forced("pallas"):
            got = levenshtein_search_simd_with_opts(
                needle, hay, 3, st, LEVENSHTEIN_COSTS, True
            )
        assert got == ref, st


def _oracle_end_dists(needle, hay, costs, anchored):
    """Per-end-position min search distance via the oracle (k = m covers
    every end: deleting the whole needle always costs <= m)."""
    m = len(needle)
    D = np.full(len(hay) + 1, 1 << 30, dtype=np.int64)
    for mt in levenshtein_search_naive_with_opts(
        needle, hay, m, SearchType.All, costs, anchored
    ):
        D[mt.end] = min(D[mt.end], mt.k)
    return D


@pytest.mark.parametrize(
    "m,damerau,anchored",
    [
        (1280, False, False),   # exactly one strip
        (1281, False, False),   # first cross-strip boundary
        (1500, False, False),
        (2600, False, False),   # 3 strips, partial top word (mtop=20? no)
        (1500, True, False),
        (2600, True, False),
        (1500, False, True),
        (1500, True, True),
    ],
)
def test_long_needle_scan_conformance(m, damerau, anchored):
    """Needles far past the word limit run the scan wavefront
    (ops/search_scan.py): its distances over one whole-haystack segment
    equal the oracle's, for rdamerau and anchored modes too."""
    from triple_accel_jax import RDAMERAU_COSTS as RD, LEVENSHTEIN_COSTS as LV
    from triple_accel_jax.ops.search_scan import chunk_haystack, search_scan

    rng = np.random.default_rng(m * 2 + damerau + 10 * anchored)
    n = 260
    needle = rng.integers(0, 4, m).astype(np.uint8)
    hay = rng.integers(0, 4, n).astype(np.uint8)
    hay[30:200] = needle[:170]  # correlated region
    costs = RD if damerau else LV
    seg_pad, seg_n, seg_off, _, seg_len = chunk_haystack(hay, m, 0, 512)
    dist, _ = search_scan(
        needle.astype(np.int32), seg_pad, seg_n, seg_off, needle_len=m,
        seg_len=seg_len,
        costs_t=(costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost,
                 costs.transpose_cost_or_zero, costs.allow_transpose),
        anchored=anchored,
    )
    out = np.asarray(dist)[0, : n + 1]
    ref = _oracle_end_dists(needle, hay, costs, anchored)
    # anchored oracle caps its column iteration at m + k; with k = m and
    # n << m no cap applies here
    assert np.array_equal(out.astype(np.int64), ref), (m, damerau, anchored)


def test_long_needle_dispatch():
    """A needle past the word limit routes to the scan wavefront even
    with the kernel arms on (dispatch-log checked) and matches the oracle
    through the public API, including halo chunking."""
    from triple_accel_jax.dispatch import last_dispatch

    rng = np.random.default_rng(4242)
    m = 1300
    needle = rng.integers(0, 8, m).astype(np.uint8)
    hay = rng.integers(0, 8, 400).astype(np.uint8)
    copy = needle[:300].copy()
    copy[50] = (copy[50] + 1) % 8
    hay[60:360] = copy
    k = 2
    ref = levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    with _forced("pallas"):
        got = levenshtein_search_simd_with_opts(
            needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
        )
    assert last_dispatch().path == "scan"
    assert got == ref


@pytest.mark.parametrize("damerau", [False, True])
def test_multi_segment_search_engine(damerau):
    """A haystack cut into many kernel segments (owned length shrunk so
    every segment boundary gets crossed): exact vs the oracle, a plant
    straddling a boundary included."""
    from unittest import mock

    import triple_accel_jax.ops.pallas.myers_search as sm
    from triple_accel_jax import RDAMERAU_COSTS
    from triple_accel_jax.dispatch import last_dispatch

    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    rng = np.random.default_rng(31 + damerau)
    m, n, k = 11, 1400, 3
    needle = rng.integers(0, 4, m).astype(np.uint8)
    hay = rng.integers(0, 4, n).astype(np.uint8)
    hay[600 : 600 + m] = needle
    hay[507 : 507 + m] = needle  # straddles the 512 boundary
    with mock.patch.object(sm, "TARGET_LANES", 16):
        assert sm.search_own_len(n, sm.search_halo(m + k, n)) == 128
        for st in (SearchType.All, SearchType.Best):
            ref = levenshtein_search_naive_with_opts(
                needle, hay, k, st, costs, False
            )
            with _forced("pallas"):
                got = levenshtein_search_simd_with_opts(
                    needle, hay, k, st, costs, False
                )
            assert last_dispatch().path.startswith("myers_search")
            assert last_dispatch().padded_n == 32 + 128
            assert got == ref, (st, damerau)


def test_scan_engine_general_costs():
    """The scan wavefront (general costs; the cases of the removed
    row-oriented search kernel) vs the oracle through the public API."""
    from triple_accel_jax.dispatch import last_dispatch

    rng = np.random.default_rng(55)
    cases = [
        (LEVENSHTEIN_COSTS, 9, 700, 2),
        (RDAMERAU_COSTS, 12, 500, 3),
        (EditCosts(2, 1, 1, None), 10, 800, 4),
        (EditCosts(1, 2, 0, None), 8, 600, 3),  # mc < gc pad corner
        (EditCosts(3, 2, 1, 3), 15, 900, 6),
    ]
    for costs, m, n, k in cases:
        needle = rng.integers(0, 4, m).astype(np.uint8)
        hay = rng.integers(0, 4, n).astype(np.uint8)
        p = int(rng.integers(0, n - m))
        hay[p : p + m] = needle
        for st in (SearchType.All, SearchType.Best):
            ref = levenshtein_search_naive_with_opts(
                needle, hay, k, st, costs, False
            )
            with _forced("scan"):
                got = levenshtein_search_simd_with_opts(
                    needle, hay, k, st, costs, False
                )
            assert last_dispatch().path == "scan"
            assert got == ref, (m, n, k, st, costs)


def test_long_needle_general_costs_route_to_scan():
    """A 1200-char needle with affine costs routes to the scan wavefront
    through the public API (kernel arms on) and matches the oracle."""
    from triple_accel_jax.dispatch import last_dispatch

    rng = np.random.default_rng(66)
    m = 1200
    costs = EditCosts(2, 1, 1, None)
    needle = rng.integers(0, 6, m).astype(np.uint8)
    hay = rng.integers(0, 6, 400).astype(np.uint8)
    copy = needle[:350].copy()
    copy[100] = (copy[100] + 1) % 6
    hay[20:370] = copy
    k = 3
    ref = levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, costs, False
    )
    with _forced("pallas"):
        got = levenshtein_search_simd_with_opts(
            needle, hay, k, SearchType.All, costs, False
        )
    assert last_dispatch().path == "scan"
    assert got == ref
