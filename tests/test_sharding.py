"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4):
shard+halo results must equal single-device / oracle results exactly.
"""

import jax
import numpy as np
import pytest

from triple_accel_jax import LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType
from triple_accel_jax.levenshtein import postprocess_matches
from triple_accel_jax.oracle import (
    levenshtein_naive_k_with_opts,
    levenshtein_search_naive_with_opts,
)
from triple_accel_jax.ops.band_scan import prepare_band_inputs
from triple_accel_jax.ops.search_scan import window_span
from triple_accel_jax.parallel import (
    assemble_sharded_search,
    make_mesh,
    match_count_psum,
    sharded_distance_step,
    sharded_search_step,
)


def _costs_t(c):
    return (c.mismatch_cost, c.gap_cost, c.start_gap_cost,
            c.transpose_cost_or_zero, c.allow_transpose)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_distance_matches_oracle():
    rng = np.random.default_rng(7)
    mesh = make_mesh()
    B = 64  # divisible by 8
    a_list, b_list, expected = [], [], []
    k = 16
    for _ in range(B):
        ln = int(rng.integers(1, 100))
        a = rng.integers(33, 127, ln).astype(np.uint8)
        b = a.copy()
        muts = rng.integers(0, max(1, ln), 5)
        b[muts] = 33
        if len(a) > len(b):
            a, b = b, a
        a_list.append(a)
        b_list.append(b)
        ref = levenshtein_naive_k_with_opts(a, b, k, False, LEVENSHTEIN_COSTS)
        expected.append(-1 if ref is None else ref[0])

    unit_k, max_m = 16, 128
    a_pad, b_pad, m, n = prepare_band_inputs(a_list, b_list, unit_k, max_m)
    dist = sharded_distance_step(
        mesh, a_pad, b_pad, m, n,
        unit_k=unit_k, max_m=max_m, costs_t=_costs_t(LEVENSHTEIN_COSTS),
    )
    dist = np.asarray(dist)
    got = [int(d) if d <= k else -1 for d in dist]
    assert got == expected

    # psum histogram: global count of pairs within k
    cnt = int(match_count_psum(mesh, dist, k))
    assert cnt == sum(1 for e in expected if e >= 0)


@pytest.mark.parametrize("costs", [LEVENSHTEIN_COSTS, RDAMERAU_COSTS])
@pytest.mark.parametrize("n_total", [800, 1000])
def test_sharded_search_matches_oracle(costs, n_total):
    """The CP/ring-analog: haystack sharded across 8 devices with ppermute
    halo exchange must reproduce the oracle's matches exactly."""
    rng = np.random.default_rng(n_total)
    mesh = make_mesh()
    D = 8
    m, k = 12, 3
    needle = rng.integers(33, 127, m).astype(np.uint8)
    haystack = rng.integers(33, 127, n_total).astype(np.uint8)
    # plant needles, some straddling shard boundaries
    S = -(-n_total // D)
    for pos in [5, S - 4, S + 10, 3 * S - m // 2, 5 * S - 1, n_total - m - 1]:
        if 0 <= pos <= n_total - m:
            haystack[pos : pos + m] = needle
            if pos % 2:
                haystack[pos + m // 2] = 33  # one mismatch

    shards = np.full((D, S), -1, dtype=np.int32)
    shard_n = np.zeros(D, dtype=np.int32)
    for d in range(D):
        seg = haystack[d * S : (d + 1) * S]
        shards[d, : len(seg)] = seg
        shard_n[d] = len(seg)

    halo = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), S)
    dist, length = sharded_search_step(
        mesh, needle.astype(np.int32), shards, shard_n,
        needle_len=m, halo=halo, costs_t=_costs_t(costs),
    )
    gd, gl = assemble_sharded_search(
        np.asarray(dist), np.asarray(length), shard_n, S
    )
    for st in (SearchType.All, SearchType.Best):
        got = postprocess_matches(gd, gl, k, st)
        ref = levenshtein_search_naive_with_opts(
            needle, haystack, k, st, costs, False
        )
        assert got == ref, f"{st} {costs}"


def test_assert_mesh_consistent_single_process():
    # single process: a no-op that accepts any mesh
    import jax

    from triple_accel_jax.parallel import assert_mesh_consistent, make_mesh

    assert_mesh_consistent(make_mesh(jax.devices()[:2]))
    assert_mesh_consistent(make_mesh(jax.devices()))


# ---------------------------------------------------------------------------
# Native (Pallas/Myers) engines on the mesh — the production kernels must
# run per device and match the unsharded kernels / oracle exactly.
# ---------------------------------------------------------------------------


def test_sharded_myers_distance_matches_unsharded():
    """DP over the mesh with the bit-parallel distance kernel: sharding the
    pair axis must be bit-identical to the single-device kernel (and both
    exact vs the oracle)."""
    from triple_accel_jax.ops.pallas.myers_distance import (
        BLOCK,
        myers_distance_triton,
        prepare_myers_inputs,
    )
    from triple_accel_jax.parallel import sharded_myers_distance

    rng = np.random.default_rng(41)
    D, k, max_m = 4, 32, 32
    mesh = make_mesh(jax.devices()[:D])
    B = 1000  # pads to 1024: two kernel blocks per device
    a_list, b_list = [], []
    for _ in range(B):
        la = int(rng.integers(1, max_m))
        x = rng.integers(0, 256, la).astype(np.uint8)
        y = x.copy()
        if la > 3:
            y[rng.integers(0, la, min(3, k))] = 1
        a_list.append(x)
        b_list.append(y)
    args = prepare_myers_inputs(a_list, b_list, k, max_m, lanes=BLOCK * D)
    assert args[2].shape[0] == 1024
    d_sh = np.asarray(sharded_myers_distance(
        mesh, *args, k=k, max_m=max_m, interpret=True
    ))
    d_un = np.asarray(myers_distance_triton(
        *args, k=k, max_m=max_m, interpret=True
    ))
    assert np.array_equal(d_sh, d_un)
    for p in rng.integers(0, B, 16):
        ref = levenshtein_naive_k_with_opts(a_list[p], b_list[p], k)
        if ref is not None:
            assert int(d_sh[p]) == ref[0]
        else:
            assert int(d_sh[p]) > k


def test_levenshtein_k_batch_mesh_param():
    """The public batched API accepting a mesh: identical results to the
    meshless call for unit costs (Myers kernel path) AND a non-unit cost
    model (sharded scan fallback)."""
    from triple_accel_jax import EditCosts
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(42)
    mesh = make_mesh(jax.devices()[:4])
    B, k = 600, 12  # not divisible by 4: exercises the pad path
    a_list, b_list = [], []
    for _ in range(B):
        ln = int(rng.integers(0, 60))
        a = rng.integers(33, 127, ln).astype(np.uint8)
        b = a.copy()
        if ln > 2:
            b[rng.integers(0, ln, 4)] = 33
        a_list.append(a)
        b_list.append(b)
    for costs in (LEVENSHTEIN_COSTS, EditCosts(2, 1, 2, None)):
        got = levenshtein_k_batch(a_list, b_list, k, costs, mesh=mesh)
        ref = levenshtein_k_batch(a_list, b_list, k, costs)
        assert np.array_equal(got, ref), costs


def test_levenshtein_exp_batch_mesh_param():
    """exp_batch threads `mesh` into every k-doubling round: results must
    be identical to the meshless call and exact."""
    from triple_accel_jax.levenshtein import levenshtein_exp_batch
    from triple_accel_jax.oracle import levenshtein_naive_with_opts

    rng = np.random.default_rng(17)
    mesh = make_mesh(jax.devices()[:4])
    a_list, b_list = [], []
    for _ in range(64):
        ln = int(rng.integers(0, 80))
        a = rng.integers(33, 127, ln).astype(np.uint8)
        b = rng.integers(33, 127, int(rng.integers(0, 80))).astype(np.uint8)
        a_list.append(a)
        b_list.append(b)
    got = levenshtein_exp_batch(a_list, b_list, mesh=mesh)
    ref = levenshtein_exp_batch(a_list, b_list)
    assert np.array_equal(got, ref)
    for i in range(0, 64, 8):
        assert got[i] == levenshtein_naive_with_opts(
            a_list[i], b_list[i], False, LEVENSHTEIN_COSTS
        )[0]


@pytest.mark.parametrize("m,k,damerau", [(24, 5, False), (24, 5, True),
                                         (4, 4, False)])
def test_sharded_myers_search_matches_unsharded(m, k, damerau):
    """SP sharded-haystack search on the bit-parallel kernel: the (end
    position, distance) hit set must equal the unsharded kernel's,
    including matches straddling shard boundaries and the end-0 candidate
    (m <= k case)."""
    from triple_accel_jax.ops.pallas.myers_search import (
        collect_hits,
        fetch_candidate_blocks,
        myers_search_block_mins_from_hay,
        prepare_peq,
        seg_count,
    )
    from triple_accel_jax.parallel import (
        collect_sharded_hits,
        shard_haystack,
        sharded_myers_search_mins,
    )

    rng = np.random.default_rng(7 * m + k)
    D, own_len, halo = 4, 128, 32
    S = own_len * 2
    n = D * S - 37  # partial last shard
    needle = rng.integers(33, 127, m).astype(np.uint8)
    hay = rng.integers(33, 127, n).astype(np.uint8)
    # plant matches, several straddling shard boundaries
    for pos in [0, 5, S - m // 2, S - 1, 2 * S - m, 3 * S - 2, n - m]:
        if 0 <= pos <= n - m:
            hay[pos : pos + m] = needle
            if pos % 2 and m > 2:
                hay[pos + m // 2] = 33

    peq = prepare_peq([needle], m)
    shards, S2 = shard_haystack(hay, D, halo, own_len)
    assert S2 == S
    dist_d, mins_d = sharded_myers_search_mins(
        make_mesh(jax.devices()[:D]), shards, peq, needle_len=m, halo=halo,
        own_len=own_len, damerau=damerau, interpret=True,
    )
    _, gpos_s, d_s = collect_sharded_hits(
        dist_d, mins_d, D=D, k=k, halo=halo, own_len=own_len,
        shard_size=S, n_total=n,
    )

    # unsharded reference: same kernel, whole haystack
    C = seg_count(n, own_len)
    dist_u, mins_u = myers_search_block_mins_from_hay(
        hay, peq, needle_len=m, halo=halo, own_len=own_len, num=C,
        damerau=damerau, interpret=True,
    )
    blocks, rb, cols = fetch_candidate_blocks(dist_u, mins_u, k)
    assert rb.size
    _, gpos_u, d_u = collect_hits(
        blocks, rb, cols, k, OUT=halo + own_len + 1, C=C, halo=halo,
        own_len=own_len, limit_pos=n,
    )
    assert np.array_equal(gpos_s, gpos_u)
    assert np.array_equal(d_s, d_u)


@pytest.mark.parametrize("costs", [LEVENSHTEIN_COSTS, RDAMERAU_COSTS])
def test_levenshtein_search_sharded_matches_single_device(costs):
    """Public sharded search == single-device search == oracle, in both
    search modes, including a Best-mode tie across a shard boundary."""
    from triple_accel_jax.levenshtein import (
        levenshtein_search_sharded,
        levenshtein_search_simd_with_opts,
    )

    rng = np.random.default_rng(99)
    mesh = make_mesh(jax.devices()[:4])
    m, k = 16, 3
    needle = rng.integers(33, 127, m).astype(np.uint8)
    n = 4 * 700 + 13
    hay = rng.integers(33, 127, n).astype(np.uint8)
    # exact copies in shards 0 and 2 -> a Best-mode cost tie whose
    # candidates live on different devices; plus one boundary straddler
    S_approx = -(-n // 4)
    for pos in [10, S_approx - m // 2, 2 * S_approx + 50]:
        hay[pos : pos + m] = needle
    for st in (SearchType.All, SearchType.Best):
        got = levenshtein_search_sharded(needle, hay, k, mesh, st, costs)
        ref = levenshtein_search_simd_with_opts(needle, hay, k, st, costs)
        assert got == ref, st
        ora = levenshtein_search_naive_with_opts(
            needle, hay, k, st, costs, False
        )
        assert got == ora, st


def test_levenshtein_search_sharded_general_costs():
    """Non-unit costs route through the sharded scan wavefront and still
    match the oracle exactly."""
    from triple_accel_jax import EditCosts
    from triple_accel_jax.levenshtein import levenshtein_search_sharded

    rng = np.random.default_rng(3)
    mesh = make_mesh(jax.devices()[:4])
    costs = EditCosts(2, 1, 2, None)
    m, k = 10, 6
    needle = rng.integers(33, 127, m).astype(np.uint8)
    hay = rng.integers(33, 127, 1200).astype(np.uint8)
    hay[300 - m // 2 : 300 + m - m // 2] = needle  # straddles shard 0/1
    for st in (SearchType.All, SearchType.Best):
        got = levenshtein_search_sharded(needle, hay, k, mesh, st, costs)
        ora = levenshtein_search_naive_with_opts(
            needle, hay, k, st, costs, False
        )
        assert got == ora, st


def test_sharded_search_multi_mb_realistic_halo():
    """A multi-MB haystack over 8 devices with a realistic
    (512-char) halo — planted matches straddling every shard boundary
    must come back exactly once each (owner-by-end), equal to the
    single-device public search."""
    from triple_accel_jax.levenshtein import (
        levenshtein_search_sharded,
        levenshtein_search_simd_with_opts,
    )

    rng = np.random.default_rng(55)
    mesh = make_mesh(jax.devices())
    D = 8
    m, k = 100, 12
    n = 2 * 1024 * 1024 + 999  # ~2MB, partial last shard
    needle = rng.integers(65, 91, m).astype(np.uint8)
    hay = rng.integers(65, 91, n).astype(np.uint8)
    S_approx = -(-n // D)
    planted = []
    for d in range(1, D):  # straddle every internal boundary
        pos = d * S_approx - m // 2
        mut = needle.copy()
        mut[rng.integers(0, m, 3)] = 64
        hay[pos : pos + m] = mut
        planted.append(pos + m)
    got = levenshtein_search_sharded(needle, hay, k, mesh, SearchType.All)
    ref = levenshtein_search_simd_with_opts(needle, hay, k, SearchType.All)
    assert got == ref
    ends = [mt.end for mt in got]
    for pos_end in planted:
        near = [e for e in ends if abs(e - pos_end) <= k]
        assert near, f"boundary match near {pos_end} lost"
    assert len(ends) == len(set(ends)), "owner-by-end dedup failed"


# ---------------------------------------------------------------------------
# Mesh x engine matrix: every single-device engine must run per device
# through the public APIs, logged by name, exact vs oracle.
# ---------------------------------------------------------------------------


def _mesh_forced_pallas():
    """The kernel arms forced on (interpret mode on the CPU mesh)."""
    import contextlib
    import os

    from triple_accel_jax.dispatch import interpret_kernels

    @contextlib.contextmanager
    def cm():
        os.environ["TRIPLE_ACCEL_FORCE_PATH"] = "pallas"
        try:
            with interpret_kernels():
                yield
        finally:
            del os.environ["TRIPLE_ACCEL_FORCE_PATH"]
    return cm()


def test_k_batch_mesh_band_engine():
    """Non-unit-cost batches on a mesh run the banded scan wavefront per
    device even with the kernel arms on — mesh == meshless == oracle,
    dispatch logged."""
    from triple_accel_jax import EditCosts
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(21)
    mesh = make_mesh(jax.devices()[:4])
    costs = EditCosts(2, 1, 2, None)
    a_list = [rng.integers(65, 91, int(rng.integers(0, 60))).astype(np.uint8)
              for _ in range(50)]
    b_list = [rng.integers(65, 91, int(rng.integers(0, 60))).astype(np.uint8)
              for _ in range(50)]
    with _mesh_forced_pallas():
        dispatch_history(clear=True)
        got = levenshtein_k_batch(a_list, b_list, 20, costs, mesh=mesh)
        paths = [d.path for _, d in dispatch_history()]
        ref = levenshtein_k_batch(a_list, b_list, 20, costs)
    assert paths == ["scan_sharded"], paths
    assert np.array_equal(got, ref)
    for i in range(0, 50, 7):
        r = levenshtein_naive_k_with_opts(a_list[i], b_list[i], 20, False,
                                          costs)
        assert int(got[i]) == (-1 if r is None else r[0]), i


def test_k_batch_mesh_wide_band_scan():
    """Wide-band non-unit batches (the cases of the removed full-matrix
    distance kernel) run the scan wavefront per device and stay exact."""
    from triple_accel_jax import EditCosts
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(22)
    mesh = make_mesh(jax.devices()[:4])
    costs = EditCosts(2, 1, 2, None)
    a_list = [rng.integers(65, 70, int(rng.integers(0, 50))).astype(np.uint8)
              for _ in range(40)]
    b_list = [rng.integers(65, 70, int(rng.integers(0, 60))).astype(np.uint8)
              for _ in range(40)]
    with _mesh_forced_pallas():
        dispatch_history(clear=True)
        got = levenshtein_k_batch(a_list, b_list, 150, costs, mesh=mesh)
        paths = [d.path for _, d in dispatch_history()]
    assert paths == ["scan_sharded"], paths
    for i in range(40):
        r = levenshtein_naive_k_with_opts(a_list[i], b_list[i], 150, False,
                                          costs)
        assert int(got[i]) == (-1 if r is None else r[0]), i


def test_k_batch_mesh_past_register_limit():
    """Unit-cost batches whose k+1 band passes the word limit run the
    scan wavefront per device, including an m == 0 pair, and stay
    exact; within the limit the kernel runs per device."""
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(23)
    mesh = make_mesh(jax.devices()[:4])
    a_list = [rng.integers(65, 91, int(rng.integers(0, 400))).astype(np.uint8)
              for _ in range(40)]
    b_list = [rng.integers(65, 91, int(rng.integers(0, 400))).astype(np.uint8)
              for _ in range(40)]
    a_list[3] = np.empty(0, dtype=np.uint8)  # m == 0 pair
    for k, path in ((300, "scan_sharded"), (20, "myers_sharded")):
        with _mesh_forced_pallas():
            dispatch_history(clear=True)
            got = levenshtein_k_batch(a_list, b_list, k, LEVENSHTEIN_COSTS,
                                      mesh=mesh)
            paths = [d.path for _, d in dispatch_history()]
        assert paths == [path], paths
        for i in range(40):
            r = levenshtein_naive_k_with_opts(a_list[i], b_list[i], k, False,
                                              LEVENSHTEIN_COSTS)
            assert int(got[i]) == (-1 if r is None else r[0]), (k, i)


def test_search_sharded_flat_engine():
    """General-cost sharded search runs the scan wavefront per device with
    on-device lengths — both modes match the oracle and the single-device
    search, boundary straddler and device-0 front region included."""
    from triple_accel_jax import EditCosts
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import (
        levenshtein_search_sharded,
        levenshtein_search_simd_with_opts,
    )

    rng = np.random.default_rng(24)
    mesh = make_mesh(jax.devices()[:4])
    costs = EditCosts(2, 1, 2, None)
    m, k = 10, 6
    needle = rng.integers(65, 91, m).astype(np.uint8)
    hay = rng.integers(65, 91, 1200).astype(np.uint8)
    hay[300 - m // 2: 300 + m - m // 2] = needle
    hay[20: 20 + m] = needle  # device-0 front region (gpos <= halo replay)
    with _mesh_forced_pallas():
        dispatch_history(clear=True)
        for st in (SearchType.All, SearchType.Best):
            got = levenshtein_search_sharded(needle, hay, k, mesh, st, costs)
            ora = levenshtein_search_naive_with_opts(
                needle, hay, k, st, costs, False
            )
            assert got == ora, st
            ref = levenshtein_search_simd_with_opts(needle, hay, k, st,
                                                    costs)
            assert got == ref, st
        paths = [d.path for _, d in dispatch_history()]
    assert "scan_search_sharded" in paths, paths


def test_search_sharded_long_needle_blocked_engine():
    """A 1700-char unit-cost needle (past the word limit) on a mesh
    runs the sharded scan wavefront and equals the single-device
    search."""
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import (
        levenshtein_search_sharded,
        levenshtein_search_simd_with_opts,
    )

    rng = np.random.default_rng(25)
    mesh = make_mesh(jax.devices()[:4])
    m, k = 1700, 12
    needle = rng.integers(65, 91, m).astype(np.uint8)
    n = 4 * 2048 + 33
    hay = rng.integers(65, 91, n).astype(np.uint8)
    for pos in [40, 2048 - m // 2, n - m]:  # incl. a boundary straddler
        mut = needle.copy()
        mut[rng.integers(0, m, 5)] = 64
        hay[pos: pos + m] = mut
    with _mesh_forced_pallas():
        dispatch_history(clear=True)
        got = levenshtein_search_sharded(needle, hay, k, mesh,
                                         SearchType.All)
        paths = [d.path for _, d in dispatch_history()]
        ref = levenshtein_search_simd_with_opts(needle, hay, k,
                                                SearchType.All)
    assert paths == ["scan_search_sharded"], paths
    assert got == ref
    assert len(got) >= 3


def test_search_sharded_chunked_engine():
    """A 1400-char needle straddling a shard boundary, sharded: the scan
    wavefront per device stays exact under the owner-by-end rule."""
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import (
        levenshtein_search_sharded,
        levenshtein_search_simd_with_opts,
    )

    rng = np.random.default_rng(26)
    mesh = make_mesh(jax.devices()[:4])
    m, k = 1400, 10
    needle = rng.integers(65, 91, m).astype(np.uint8)
    n = 4 * 2048 + 17
    hay = rng.integers(65, 91, n).astype(np.uint8)
    hay[2048 - m // 2: 2048 - m // 2 + m] = needle
    with _mesh_forced_pallas():
        dispatch_history(clear=True)
        got = levenshtein_search_sharded(needle, hay, k, mesh,
                                         SearchType.All)
        paths = [d.path for _, d in dispatch_history()]
    assert paths == ["scan_search_sharded"], paths
    ref = levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, False
    )
    assert got == ref


def test_search_many_sharded_matches_meshless():
    """Sharded dictionary serving: levenshtein_search_many
    with a mesh — resident sharded pack, needles broadcast, one
    multi-needle launch per device — must equal the meshless call and the
    oracle, across mixed needle lengths (two launches) and both
    modes, with the PackedHaystack reused across calls."""
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import (
        PackedHaystack,
        levenshtein_search_many,
    )

    rng = np.random.default_rng(31)
    mesh = make_mesh(jax.devices()[:4])
    n = 4 * 1024 + 21
    hay = rng.integers(65, 91, n).astype(np.uint8)
    needles = [rng.integers(65, 91, ln).astype(np.uint8)
               for ln in (8, 8, 30, 30, 8)]
    # plant hits for several needles, one straddling a shard boundary
    hay[100: 108] = needles[0]
    hay[1024 - 4: 1024 + 4] = needles[1]
    hay[2000: 2030] = needles[2]
    k = 3
    packed = PackedHaystack(hay)
    with _mesh_forced_pallas():
        for st in (SearchType.All, SearchType.Best):
            dispatch_history(clear=True)
            got = levenshtein_search_many(needles, packed, k, st,
                                          mesh=mesh)
            paths = [d.path for _, d in dispatch_history()]
            assert "myers_search_many_sharded" in paths, paths
            ref = levenshtein_search_many(needles, hay, k, st)
            assert got == ref, st
            for i in (0, 2):
                ora = levenshtein_search_naive_with_opts(
                    needles[i], hay, k, st, LEVENSHTEIN_COSTS, False
                )
                assert got[i] == ora, (st, i)
        # second call on the same PackedHaystack: the sharded pack is
        # memoized (resident serving) and results stay identical
        got2 = levenshtein_search_many(needles, packed, k, SearchType.All,
                                       mesh=mesh)
        ref2 = levenshtein_search_many(needles, hay, k, SearchType.All)
        assert got2 == ref2


def test_hamming_batch_mesh_param():
    """hamming_batch(mesh=): batch-axis DP sharding must equal the
    meshless call exactly, including the non-divisible pad path."""
    from triple_accel_jax.hamming import hamming_batch

    rng = np.random.default_rng(61)
    mesh = make_mesh(jax.devices()[:4])
    B, L = 70, 33  # B not divisible by 4, L not a multiple of 8
    a = rng.integers(0, 256, (B, L)).astype(np.uint8)
    b = a.copy()
    b[:, 0] = 0
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    got = hamming_batch(a, b, lengths, mesh=mesh)
    ref = hamming_batch(a, b, lengths)
    assert got.shape == (B,)
    assert np.array_equal(got, ref)
    exp0 = int(np.sum(a[0, :lengths[0]] != b[0, :lengths[0]]))
    assert int(got[0]) == exp0


def test_hamming_search_sharded_matches_single_device():
    """SP Hamming search: fixed-length windows partition start positions
    exactly, so the sharded counts/minima share the single-device layout —
    results must match hamming_search_simd_with_opts and the oracle,
    including matches straddling shard boundaries, in both modes."""
    from triple_accel_jax.hamming import (
        hamming_search_sharded,
        hamming_search_simd_with_opts,
    )
    from triple_accel_jax.oracle import hamming_search_naive_with_opts

    rng = np.random.default_rng(77)
    mesh = make_mesh(jax.devices())
    m, k = 20, 4
    n = 8 * 1024 + 37
    needle = rng.integers(65, 91, m).astype(np.uint8)
    hay = rng.integers(65, 91, n).astype(np.uint8)
    S_approx = 1024  # BLOCK-sized shards
    for pos in [0, S_approx - m // 2, 3 * S_approx - 1, n - m]:
        mut = needle.copy()
        mut[rng.integers(0, m, 2)] = 64
        hay[pos : pos + m] = mut
    for st in (SearchType.All, SearchType.Best):
        got = hamming_search_sharded(needle, hay, k, mesh, st)
        ref = hamming_search_simd_with_opts(needle, hay, k, st)
        assert got == ref, st
        ora = hamming_search_naive_with_opts(needle, hay, k, st)
        assert got == ora, st


def test_search_many_sharded_fallback_routes_sharded():
    """Dictionary needles past the word limit must fall back to the
    SHARDED single-needle search (not the single-device one) when a mesh
    is given; the others still share one launch per device."""
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import levenshtein_search_many

    rng = np.random.default_rng(71)
    mesh = make_mesh(jax.devices()[:4])
    n = 4 * 1024 + 9
    hay = rng.integers(65, 91, n).astype(np.uint8)
    needles = [rng.integers(65, 91, 300).astype(np.uint8),
               rng.integers(65, 91, 12).astype(np.uint8)]
    hay[1024 - 150: 1024 + 150] = needles[0]  # boundary straddler
    hay[3000: 3012] = needles[1]
    with _mesh_forced_pallas():
        dispatch_history(clear=True)
        got = levenshtein_search_many(needles, hay, 2, SearchType.All,
                                      mesh=mesh)
        paths = [d.path for _, d in dispatch_history()]
    assert paths == ["scan_search_sharded", "myers_search_many_sharded"], \
        paths
    for i in range(2):
        ora = levenshtein_search_naive_with_opts(
            needles[i], hay, 2, SearchType.All, LEVENSHTEIN_COSTS, False
        )
        assert got[i] == ora and got[i], i
