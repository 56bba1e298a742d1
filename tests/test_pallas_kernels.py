"""Distance engines that serve every cost model: the banded `lax.scan`
wavefront (ops/band_scan.py) must agree exactly with the scalar oracle
wherever the true distance fits the band, and the dispatcher must route
each batch to the right engine.  The input cases are those the removed
general-cost band kernels were tested on, re-pointed at the scan that now
serves them.
"""

import numpy as np
import pytest

from triple_accel_jax import EditCosts, LEVENSHTEIN_COSTS, RDAMERAU_COSTS
from triple_accel_jax.oracle import (
    levenshtein_naive_k_with_opts,
    levenshtein_naive_with_opts,
)
from triple_accel_jax.ops.band_scan import band_scan_distance, prepare_band_inputs

INF32 = 1 << 29


def _costs_t(c):
    return (c.mismatch_cost, c.gap_cost, c.start_gap_cost,
            c.transpose_cost_or_zero, c.allow_transpose)


def _scan(a_list, b_list, unit_k, max_m, ct):
    ap, bp, ma, na = prepare_band_inputs(a_list, b_list, unit_k, max_m)
    return np.asarray(band_scan_distance(
        ap, bp, ma, na, unit_k=unit_k, max_m=max_m, costs_t=ct,
        trace_on=False)[0])


@pytest.mark.parametrize(
    "costs",
    [LEVENSHTEIN_COSTS, RDAMERAU_COSTS, EditCosts(2, 1, 2, None),
     EditCosts(3, 2, 1, 2)],
)
def test_band_distance_matches_oracle(costs):
    rng = np.random.default_rng(42 + costs.mismatch_cost)
    unit_k, max_m = 8, 64
    a_list, b_list, expected = [], [], []
    for _ in range(40):
        ln = int(rng.integers(0, 60))
        a = rng.integers(33, 127, ln).astype(np.uint8)
        b = a.copy()
        if ln:
            b[rng.integers(0, ln, 3)] = 33
        if rng.integers(0, 2) and ln > 4:
            b = np.delete(b, rng.integers(0, len(b), 2))
        if len(a) > len(b):
            a, b = b, a
        # feasibility precheck the dispatcher would do
        if len(b) - len(a) > unit_k:
            continue
        a_list.append(a)
        b_list.append(b)
        ref = levenshtein_naive_k_with_opts(a, b, 10**9, False, costs)
        expected.append(ref[0])

    dist = _scan(a_list, b_list, unit_k, max_m, _costs_t(costs))
    for p, exp in enumerate(expected):
        got = int(dist[p])
        # the band may cap the distance above unit_k deviations; the oracle
        # with unlimited k reports the true distance — they must agree
        # whenever the true distance fits the band's threshold
        if exp <= unit_k:
            assert got == exp, f"pair {p}: {got} != {exp} ({costs})"
        else:
            assert got >= exp or got >= INF32


@pytest.mark.parametrize("unit_k", [4, 8, 16])
def test_band_distance_saturates_above_band(unit_k):
    """Narrow and wide bands (the widths the removed 8/16/32-bit band
    dtype ladder was tested at) must agree exactly with the oracle below
    the threshold and only over-estimate above it."""
    costs = RDAMERAU_COSTS
    rng = np.random.default_rng(3)
    max_m = 64
    a_list, b_list, expected = [], [], []
    for _ in range(50):
        ln = int(rng.integers(1, 60))
        a = rng.integers(33, 127, ln).astype(np.uint8)
        b = a.copy()
        b[rng.integers(0, ln, 2)] = 33
        if rng.integers(0, 2) and ln > 4:
            b = np.delete(b, rng.integers(0, len(b), 2))
        if len(a) > len(b):
            a, b = b, a
        if len(b) - len(a) > unit_k:
            continue
        a_list.append(a)
        b_list.append(b)
        expected.append(
            levenshtein_naive_k_with_opts(a, b, 10**9, False, costs)[0]
        )
    dist = _scan(a_list, b_list, unit_k, max_m, _costs_t(costs))
    for p, exp in enumerate(expected):
        got = int(dist[p])
        if exp <= unit_k:
            assert got == exp, f"pair {p}: {got} != {exp} (uk={unit_k})"
        else:
            assert got >= min(exp, unit_k + 1)


def test_select_cost_bucket_headroom_rules():
    from triple_accel_jax.dispatch import select_cost_bucket

    assert select_cost_bucket(0) == "u8"
    assert select_cost_bucket(254) == "u8"
    assert select_cost_bucket(255) == "u16"
    assert select_cost_bucket((1 << 16) - 2) == "u16"
    assert select_cost_bucket(1 << 16) == "u32"
    assert select_cost_bucket(1 << 40) == "u32"


def test_pallas_forced_dispatch_end_to_end():
    """levenshtein_k_batch with the kernel path forced: on a CPU backend it
    raises instead of interpreting; under the test switch (interpret mode)
    it must equal the scan path."""
    import os

    from triple_accel_jax.dispatch import interpret_kernels, last_dispatch
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(0)
    a_list = [rng.integers(33, 127, 50).astype(np.uint8) for _ in range(10)]
    b_list = []
    for a in a_list:
        b = a.copy()
        b[rng.integers(0, 50, 4)] = 33
        b_list.append(b)

    ref = levenshtein_k_batch(a_list, b_list, 16)
    assert last_dispatch().path == "scan"
    os.environ["TRIPLE_ACCEL_FORCE_PATH"] = "pallas"
    try:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            levenshtein_k_batch(a_list, b_list, 16)
        with interpret_kernels():
            got = levenshtein_k_batch(a_list, b_list, 16)
        assert last_dispatch().path == "myers"
    finally:
        del os.environ["TRIPLE_ACCEL_FORCE_PATH"]
    assert got.tolist() == ref.tolist()


@pytest.mark.parametrize("override,plain,switched", [
    (None, False, True),
    ("scan", False, False),
    ("oracle", False, False),
    ("pallas", RuntimeError, True),
    ("jnp", False, True),  # not an override: ignored
])
def test_use_kernels_choice(monkeypatch, override, plain, switched):
    """The one backend decision on a CPU backend, without and with the
    test switch, for every override value."""
    from triple_accel_jax.dispatch import interpret_kernels, use_kernels

    if override is None:
        monkeypatch.delenv("TRIPLE_ACCEL_FORCE_PATH", raising=False)
    else:
        monkeypatch.setenv("TRIPLE_ACCEL_FORCE_PATH", override)
    if plain is RuntimeError:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            use_kernels()
    else:
        assert use_kernels() is plain
    with interpret_kernels():
        assert use_kernels() is switched


def test_batched_traceback_matches_oracle():
    # trace_on on the batched path — device wavefront + device walk,
    # differential vs the banded oracle, all cost models, with the kernel
    # arms switched on (traced batches always run the scan walk).
    import os

    import numpy as np

    from triple_accel_jax.levenshtein import levenshtein_k_batch
    from triple_accel_jax.oracle.levenshtein import (
        levenshtein_naive_k_with_opts,
    )
    from triple_accel_jax.types import (
        EditCosts,
        LEVENSHTEIN_COSTS,
        RDAMERAU_COSTS,
    )

    rng = np.random.default_rng(21)
    a_list, b_list = [], []
    for _ in range(40):
        la = int(rng.integers(0, 40))
        lb = int(rng.integers(0, 40))
        a_list.append(rng.integers(0, 5, la).astype(np.uint8))
        b_list.append(rng.integers(0, 5, lb).astype(np.uint8))

    from triple_accel_jax.dispatch import interpret_kernels

    with interpret_kernels():
        for costs in (
            LEVENSHTEIN_COSTS,
            RDAMERAU_COSTS,
            EditCosts(2, 1, 1, None),
            EditCosts(3, 2, 4, 2),
        ):
            for k in (0, 3, 100):
                dists, traces = levenshtein_k_batch(
                    a_list, b_list, k, costs, trace_on=True
                )
                for i in range(len(a_list)):
                    ref = levenshtein_naive_k_with_opts(
                        a_list[i], b_list[i], k, True, costs
                    )
                    if ref is None:
                        assert dists[i] == -1 and traces[i] is None
                    else:
                        assert dists[i] == ref[0], (i, k, costs)
                        assert traces[i] == ref[1], (i, k, costs)


def test_long_band_scan_matches_oracle():
    # the long-string cases of the removed row-strip tiled band kernel,
    # re-pointed at the scan wavefront: alphabet includes char 0 to prove
    # the 0-pad safety argument
    from triple_accel_jax.types import EditCosts as EC

    rng = np.random.default_rng(7)
    for ct in [(1, 1, 0, 0, False), (1, 1, 0, 1, True), (3, 2, 4, 2, True)]:
        costs = EC(ct[0], ct[1], ct[2], ct[3] if ct[4] else None)
        a_list, b_list = [], []
        for _ in range(24):
            la = int(rng.integers(0, 70))
            a = rng.integers(0, 3, la).astype(np.uint8)
            lb = int(np.clip(la + rng.integers(-6, 7), 0, 80))
            b = rng.integers(0, 3, lb).astype(np.uint8)
            if la > lb:
                a, b = b, a
            if len(b) - len(a) > 8:
                continue
            a_list.append(a)
            b_list.append(b)
        uk = 8
        dist = _scan(a_list, b_list, uk, 128, ct)
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            ref = levenshtein_naive_k_with_opts(a, b, 10**9, False, costs)[0]
            if ref <= uk:
                assert dist[i] == ref, (i, ct)
            else:
                assert dist[i] >= min(ref, uk + 1), (i, ct)


def test_bucketed_batch_identical():
    # per-bucket dispatch on mixed-length batches must be
    # byte-identical to the single-launch result (and to the oracle).
    import importlib

    import numpy as np

    lev = importlib.import_module("triple_accel_jax.levenshtein")
    from triple_accel_jax.oracle.levenshtein import (
        levenshtein_naive_k_with_opts,
    )

    rng = np.random.default_rng(33)
    a_list, b_list = [], []
    for _ in range(400):
        L = int(rng.integers(4, 24))
        a = rng.integers(0, 5, L).astype(np.uint8)
        b = a.copy()
        b[rng.integers(0, L, 2)] = 5
        a_list.append(a)
        b_list.append(b)
    for _ in range(300):
        L = int(rng.integers(100, 200))
        a = rng.integers(0, 5, L).astype(np.uint8)
        b = a.copy()
        b[rng.permutation(L)[:4]] = 5
        a_list.append(a)
        b_list.append(b)

    out_b = lev.levenshtein_k_batch(a_list, b_list, 9)
    old = lev._MIN_BUCKET
    try:
        lev._MIN_BUCKET = 1 << 60  # force single launch
        out_s = lev.levenshtein_k_batch(a_list, b_list, 9)
    finally:
        lev._MIN_BUCKET = old
    assert (out_b == out_s).all()
    for i in rng.choice(len(a_list), 30, replace=False):
        ref = levenshtein_naive_k_with_opts(a_list[i], b_list[i], 9, False)
        exp = -1 if ref is None else ref[0]
        assert out_b[i] == exp, i


def test_batched_traceback_scan_path_matches_oracle():
    # the scan trace path (band_trace_batch + shared device walk) is the
    # default on the CPU and the wide-band fallback — it needs its own differential
    # coverage, not just the pallas trace variant's
    import os

    import numpy as np

    from triple_accel_jax.levenshtein import levenshtein_k_batch
    from triple_accel_jax.oracle.levenshtein import (
        levenshtein_naive_k_with_opts,
    )
    from triple_accel_jax.types import (
        EditCosts,
        LEVENSHTEIN_COSTS,
        RDAMERAU_COSTS,
    )

    rng = np.random.default_rng(23)
    a_list, b_list = [], []
    for _ in range(30):
        la = int(rng.integers(0, 40))
        lb = int(rng.integers(0, 40))
        a_list.append(rng.integers(0, 5, la).astype(np.uint8))
        b_list.append(rng.integers(0, 5, lb).astype(np.uint8))

    os.environ["TRIPLE_ACCEL_FORCE_PATH"] = "scan"
    try:
        for costs in (LEVENSHTEIN_COSTS, RDAMERAU_COSTS,
                      EditCosts(3, 2, 4, 2)):
            for k in (0, 3, 100):
                dists, traces = levenshtein_k_batch(
                    a_list, b_list, k, costs, trace_on=True
                )
                for i in range(len(a_list)):
                    ref = levenshtein_naive_k_with_opts(
                        a_list[i], b_list[i], k, True, costs
                    )
                    if ref is None:
                        assert dists[i] == -1 and traces[i] is None
                    else:
                        assert dists[i] == ref[0], (i, k, costs)
                        assert traces[i] == ref[1], (i, k, costs)
    finally:
        del os.environ["TRIPLE_ACCEL_FORCE_PATH"]


@pytest.mark.parametrize("costs", [
    LEVENSHTEIN_COSTS, RDAMERAU_COSTS,
    EditCosts(2, 1, 2, None), EditCosts(3, 2, 1, 2),
])
def test_full_band_scan_matches_oracle(costs):
    """A band as wide as the longest string makes the scan exact for any
    pair: every cost model at mixed lengths incl. empties (the cases of
    the removed full-matrix flat distance kernel)."""
    ct = _costs_t(costs)
    rng = np.random.default_rng(hash(ct) % 2**31)
    C, m_max, n_max = 128, 40, 90
    pairs = []
    for _ in range(C):
        la = int(rng.integers(0, m_max + 1))
        lb = int(rng.integers(0, n_max + 1))
        a = rng.integers(65, 70, la).astype(np.uint8)
        b = rng.integers(65, 70, lb).astype(np.uint8)
        pairs.append((a, b) if la <= lb else (b, a))
    d = _scan([p[0] for p in pairs], [p[1] for p in pairs], 128, 128, ct)
    for i, (a, b) in enumerate(pairs):
        ref = levenshtein_naive_with_opts(a, b, False, costs)[0]
        assert int(d[i]) == ref, (i, len(a), len(b), costs)


@pytest.mark.parametrize("costs", [LEVENSHTEIN_COSTS,
                                   EditCosts(2, 1, 2, None),
                                   EditCosts(1, 1, 0, 1)])
def test_banded_scan_long_pairs_matches_oracle(costs):
    """600-char pairs at unit_k=32 (the cases of the removed banded flat
    distance kernel): exact for every within-threshold pair, never below
    the truth for distant pairs."""
    ct = _costs_t(costs)
    rng = np.random.default_rng(hash(ct) % 2**31 + 5)
    uk = 32
    C, L = 128, 600
    pairs = []
    for i in range(C):
        la = int(rng.integers(L - 40, L - 10))  # headroom for insertions
        a = rng.integers(65, 70, la).astype(np.uint8)
        if i % 16 == 15:
            b = rng.integers(65, 70, la).astype(np.uint8)  # distant pair
        else:
            b = list(a)
            for _ in range(int(rng.integers(0, 11))):
                op = rng.integers(0, 3)
                if op == 0:
                    b[rng.integers(0, len(b))] = rng.integers(65, 70)
                elif op == 1 and len(b) > 1:
                    del b[rng.integers(0, len(b))]
                else:
                    b.insert(int(rng.integers(0, len(b) + 1)),
                             int(rng.integers(65, 70)))
            b = np.array(b, np.uint8)
        pairs.append((a, b) if len(a) <= len(b) else (b, a))
    d = _scan([p[0] for p in pairs], [p[1] for p in pairs], uk, 1024, ct)
    # a path within the band has at most uk gaps of either type
    thresh = uk * costs.gap_cost + costs.start_gap_cost
    checked_exact = checked_sat = 0
    for i, (a, b) in enumerate(pairs):
        ref = levenshtein_naive_with_opts(a, b, False, costs)[0]
        if ref <= thresh and len(b) - len(a) <= uk:
            assert int(d[i]) == ref, (i, costs)
            checked_exact += 1
        else:
            assert int(d[i]) >= ref, (i, costs)
            checked_sat += 1
    assert checked_exact >= 64 and checked_sat >= 4


@pytest.mark.parametrize("costs,k,length,path", [
    (EditCosts(2, 1, 2, None), 150, 60, "scan"),
    (RDAMERAU_COSTS, 20, 60, "scan"),
    (LEVENSHTEIN_COSTS, 300, 400, "scan"),
    (LEVENSHTEIN_COSTS, 20, 60, "myers"),
])
def test_kernel_dispatch_by_costs_and_band(costs, k, length, path):
    """With the kernel arms on, only unit costs whose band fits the
    word limit take the bit-parallel kernel; everything else runs the
    scan, and both stay exact."""
    from triple_accel_jax.dispatch import dispatch_history, interpret_kernels
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(12)
    a_list, b_list = [], []
    for _ in range(8):
        la = int(rng.integers(length - 60, length))
        a_list.append(rng.integers(65, 70, la).astype(np.uint8))
        b_list.append(rng.integers(65, 70,
                                   la + int(rng.integers(0, 10))).astype(np.uint8))
    with interpret_kernels():
        dispatch_history(clear=True)
        got = levenshtein_k_batch(a_list, b_list, k, costs)
        paths = [d.path for _, d in dispatch_history()]
    assert paths == [path], paths
    for i in range(8):
        ref = levenshtein_naive_k_with_opts(a_list[i], b_list[i], k,
                                            False, costs)
        exp = -1 if ref is None else ref[0]
        assert int(got[i]) == exp, i


def test_trace_batch_chunks_on_batch_axis():
    """Big traced batches must chunk the scan walk's codes buffer (at
    B=256/3000-char/k=1000 the un-chunked buffer hit 2.148e9 cells and the
    flat gather indices overflowed int32).  Shrinking the cap must produce
    identical results to one chunk."""
    import importlib

    lev = importlib.import_module("triple_accel_jax.levenshtein")
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(21)
    a_list, b_list = [], []
    for _ in range(12):
        ln = int(rng.integers(1, 40))
        a = rng.integers(65, 70, ln).astype(np.uint8)
        b = list(a)
        for _ in range(int(rng.integers(0, 4))):
            op = rng.integers(0, 3)
            if op == 0:
                b[rng.integers(0, len(b))] = rng.integers(65, 70)
            elif op == 1:
                b.insert(int(rng.integers(0, len(b) + 1)),
                         int(rng.integers(65, 70)))
            elif len(b) > 1:
                del b[rng.integers(0, len(b))]
        a_list.append(a)
        b_list.append(np.asarray(b, np.uint8))
    import os
    os.environ["TRIPLE_ACCEL_FORCE_PATH"] = "scan"
    try:
        ref = levenshtein_k_batch(a_list, b_list, 30, trace_on=True)
        saved = lev._TRACE_CELLS_CAP
        lev._TRACE_CELLS_CAP = 256  # force several batch chunks
        try:
            got = levenshtein_k_batch(a_list, b_list, 30, trace_on=True)
        finally:
            lev._TRACE_CELLS_CAP = saved
    finally:
        del os.environ["TRIPLE_ACCEL_FORCE_PATH"]
    assert np.array_equal(got[0], ref[0])
    assert got[1] == ref[1]
