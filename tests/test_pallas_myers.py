"""Bit-parallel Myers engines (ops/pallas/): the Triton kernels in Pallas
interpret mode and their plain-XLA twins, differentially against the
scalar oracle.

The distance kernel encodes the boundary conventions in the
ops/pallas/myers_distance.py docstring (asymmetric k+1 band, +1
shifted-in out-of-band deltas, forced virtual-column deltas, left-edge
anchor scoring); the search kernel the column recurrence, its rdamerau
seed term and the anchored row-0 boundary.  The cases cover one word and
the word limits, NUL bytes, multi-needle launches,
the device-side windowing and the dispatcher integration.
"""

import os

import numpy as np
import pytest

from triple_accel_jax.oracle import (
    levenshtein_naive_k_with_opts,
    levenshtein_search_naive_with_opts,
)
from triple_accel_jax.ops.pallas import words as W
from triple_accel_jax.ops.pallas.myers_distance import (
    distance_plan,
    myers_distance_jnp,
    myers_distance_triton,
    prepare_myers_inputs,
)
from triple_accel_jax.ops.pallas.myers_search import (
    BLOCK,
    MAX_WORDS,
    UNROLL,
    chunk_raw,
    device_pack_segs,
    device_windows,
    myers_search,
    myers_search_jnp,
    prepare_peq,
    search_halo,
    search_own_len,
    search_plan,
    seg_count,
)
from triple_accel_jax.types import LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType


def _kernel(*args, **kw):
    return np.asarray(myers_distance_triton(*args, interpret=True, **kw))


class _forced:
    """Force the kernel arms (interpret mode on the CPU) for the block."""

    def __init__(self, path="pallas"):
        self.path = path

    def __enter__(self):
        from triple_accel_jax.dispatch import interpret_kernels

        os.environ["TRIPLE_ACCEL_FORCE_PATH"] = self.path
        self.sw = interpret_kernels()
        self.sw.__enter__()

    def __exit__(self, *exc):
        self.sw.__exit__(*exc)
        del os.environ["TRIPLE_ACCEL_FORCE_PATH"]


def _mutated_corpus(rng, n_pairs, max_m, k, alphabet=(65, 70)):
    a_list, b_list, exp = [], [], []
    while len(a_list) < n_pairs:
        m = int(rng.integers(0, max_m))
        a = rng.integers(*alphabet, m).astype(np.uint8)
        b = list(a)
        for _ in range(int(rng.integers(0, 10))):
            op = rng.integers(0, 3)
            if op == 0 and b:
                b[rng.integers(0, len(b))] = rng.integers(*alphabet)
            elif op == 1 and len(b) < max_m - 1:
                b.insert(int(rng.integers(0, len(b) + 1)),
                         int(rng.integers(*alphabet)))
            elif op == 2 and b:
                del b[rng.integers(0, len(b))]
        b = np.array(b, dtype=np.uint8)
        if len(a) > len(b):
            a, b = b, a
        if len(b) - len(a) > k or len(a) > max_m:
            continue
        a_list.append(a)
        b_list.append(b)
        exp.append(levenshtein_naive_k_with_opts(a, b, 10**9, False)[0])
    return a_list, b_list, exp


@pytest.mark.parametrize(
    "k,max_m",
    [(4, 16), (16, 48), (31, 64), (32, 64), (96, 48), (127, 32)],
)
def test_myers_kernel_matches_oracle(k, max_m):
    """One word (k+1 <= 32), the first two-word band (k = 32), and the
    word limit (k = 127: four words)."""
    assert distance_plan(k) is not None
    rng = np.random.default_rng(100 + k)
    a_list, b_list, exp = _mutated_corpus(rng, 60, max_m, k)
    args = prepare_myers_inputs(a_list, b_list, k, max_m)
    dist = _kernel(*args, k=k, max_m=max_m)
    for p, e in enumerate(exp):
        got = int(dist[p])
        if e <= k:
            assert got == e, f"pair {p}: {got} != {e} (k={k})"
        else:
            assert got > k, f"pair {p}: false accept {got} <= {k} < {e}"


@pytest.mark.parametrize("k,max_m", [(8, 32), (32, 64), (120, 48)])
def test_myers_nul_bytes_engines_agree(k, max_m):
    """Strings full of NUL bytes (pads are 0 too, so a pad CAN equal a real
    char: the virtual-column Eq masking and the rightward-only
    contamination argument carry correctness): the kernel and the
    plain-XLA twin are bit-identical, and exact vs the oracle."""
    rng = np.random.default_rng(77 + k)
    a_list, b_list, exp = _mutated_corpus(rng, 40, max_m, k, alphabet=(0, 3))
    args = prepare_myers_inputs(a_list, b_list, k, max_m)
    d1 = _kernel(*args, k=k, max_m=max_m)
    d2 = np.asarray(myers_distance_jnp(*args, k=k, max_m=max_m))
    assert np.array_equal(d1, d2)
    for p, e in enumerate(exp):
        assert (int(d1[p]) == e) if e <= k else (int(d1[p]) > k), p


def test_myers_plan_limits():
    assert distance_plan(0) == (1, 1, 1)
    assert distance_plan(31) == (1, 32, 9)
    assert distance_plan(32) == (2, 33, 9)
    assert distance_plan(127) == (4, 128, 33)
    assert distance_plan(128) is None  # past the word limit: scan
    assert search_plan(0) is None
    assert search_plan(1) == 1
    assert search_plan(256) == MAX_WORDS == 8
    assert search_plan(257) is None


def test_myers_empty_and_edge_pairs():
    cases = [
        (b"", b""),
        (b"", b"abc"),
        (b"a", b"a"),
        (b"a", b"b"),
        (b"ab", b"ba"),
        (b"x" * 30, b"x" * 33),
    ]
    k, max_m = 8, 32
    a_list = [np.frombuffer(a, dtype=np.uint8) for a, _ in cases]
    b_list = [np.frombuffer(b, dtype=np.uint8) for _, b in cases]
    exp = [
        levenshtein_naive_k_with_opts(a, b, 10**9, False)[0]
        for a, b in zip(a_list, b_list)
    ]
    args = prepare_myers_inputs(a_list, b_list, k, max_m)
    dist = _kernel(*args, k=k, max_m=max_m)
    for p, e in enumerate(exp):
        assert int(dist[p]) == e, (cases[p], int(dist[p]), e)


@pytest.mark.parametrize("B,lanes", [(1, 128), (300, 128), (513, 512)])
def test_prepare_myers_inputs_padding(B, lanes):
    """A ragged batch pads with empty pairs to a multiple of `lanes`, each
    pair's b sitting ukL = (k - delta)//2 columns right in its buffer; a
    rectangular batch uploads its rows as they are, with the common ukL as
    b_shift.  Both layouts give the same distances."""
    rng = np.random.default_rng(B)
    k, max_m = 16, 32
    a_list = [rng.integers(1, 9, int(rng.integers(0, 20))).astype(np.uint8)
              for _ in range(B)]
    b_list = [np.concatenate([a, np.full(int(rng.integers(0, 5)), 9,
                                         np.uint8)]) for a in a_list]
    a_rows, b_rows, m, dlen, ukl, shift = prepare_myers_inputs(
        a_list, b_list, k, max_m, lanes=lanes)
    Bp = -(-B // lanes) * lanes
    assert m.shape == (Bp,) and b_rows.shape[0] == Bp
    assert np.all(m[B:] == 0) and np.all(a_rows[B:] == 0)
    if B > 1:  # ragged: full buffers
        assert shift == 0 and a_rows.shape == (Bp, max_m)
        assert b_rows.shape[1] % 4 == 0
    for p in range(B):
        d = len(b_list[p]) - len(a_list[p])
        assert m[p] == len(a_list[p]) and dlen[p] == d
        assert ukl[p] == (k - d) // 2
        # one pair is a rectangular batch: its b is uploaded unshifted
        u = 0 if B == 1 else int(ukl[p])
        assert B > 1 or shift == ukl[p]
        assert np.array_equal(b_rows[p, u:u + len(b_list[p])], b_list[p])
        assert not b_rows[p, :u].any()
    # rectangular: rows uploaded unpadded, b_shift carries the common ukL
    A = rng.integers(1, 9, (B, 24)).astype(np.uint8)
    Bm = A.copy()
    Bm[:, 5] = 0
    ra, rb, rm, rd, ru, rs = prepare_myers_inputs(A, Bm, k, max_m,
                                                  lanes=lanes)
    assert ra.shape == (Bp, 24) and rb.shape == (Bp, 24) and rs == k // 2
    assert np.array_equal(ra[:B], A) and np.array_equal(rb[:B], Bm)
    got = _kernel(ra, rb, rm, rd, ru, rs, k=k, max_m=max_m)
    for p in range(0, B, 37):
        assert got[p] == levenshtein_naive_k_with_opts(A[p], Bm[p], k)[0], p


@pytest.mark.parametrize("nw", [1, 3, 8])
def test_words_arithmetic_matches_bigints(nw):
    """The multi-word helpers against Python integers."""
    import jax.numpy as jnp

    rng = np.random.default_rng(nw)
    nb = nw * W.WORD
    mask = (1 << nb) - 1
    xs = [int(v) for v in rng.integers(0, 1 << 62, 6)]
    xs = [(v * 0x9E3779B97F4A7C15 ** nw) & mask for v in xs] + [mask, 0]
    ys = list(reversed(xs))

    def split(vals):
        return [jnp.asarray([(v >> (W.WORD * w)) & 0xFFFFFFFF for v in vals],
                            jnp.uint32) for w in range(nw)]

    def join(words):
        arr = [np.asarray(w).astype(object) for w in words]
        return [sum(int(arr[w][i]) << (W.WORD * w) for w in range(nw))
                for i in range(len(xs))]

    X, Y = split(xs), split(ys)
    assert join(W.add(X, Y)) == [(x + y) & mask for x, y in zip(xs, ys)]
    assert join(W.shl1(X, 1)) == [((x << 1) | 1) & mask for x in xs]
    assert join(W.shr1(X, 1)) == [(x >> 1) | (1 << (nb - 1)) for x in xs]
    assert np.asarray(W.popcount(X)).tolist() == [bin(x).count("1")
                                                  for x in xs]
    bits = jnp.asarray([0, 1, 31, 32, nb - 1, nb, nb + 5, 7], jnp.int32)
    assert join(W.low_mask(bits, nw)) == [
        (1 << min(int(b), nb)) - 1 for b in np.asarray(bits)]
    word = jnp.asarray([0x00FF0000, 0x01020304, 0, 0xFFFFFFFF, 0x00000100,
                        0x80008000, 0x7F7F7F7F, 0x01000001], jnp.uint32)
    exp = [sum(1 << s for s in range(4) if ((int(v) >> (8 * s)) & 0xFF) == 0)
           for v in np.asarray(word)]
    assert np.asarray(W.zero_byte_nibble(word)).tolist() == exp


def test_dispatch_myers_equals_scan():
    """levenshtein_k_batch: the myers path (unit costs with the kernel arms
    on) must equal the scan wavefront's result."""
    from triple_accel_jax.dispatch import last_dispatch
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(0)
    a_list, b_list = [], []
    for _ in range(40):
        ln = int(rng.integers(0, 60))
        a = rng.integers(33, 127, ln).astype(np.uint8)
        b = a.copy()
        if ln:
            b[rng.integers(0, ln, 3)] = 33
        if rng.integers(0, 2) and ln > 6:
            b = np.delete(b, rng.integers(0, len(b), 3))
        a_list.append(a)
        b_list.append(b)

    with _forced():
        got = levenshtein_k_batch(a_list, b_list, 12)
        assert last_dispatch().path == "myers"
    with _forced("scan"):
        ref = levenshtein_k_batch(a_list, b_list, 12)
        assert last_dispatch().path == "scan"
    assert got.tolist() == ref.tolist()


# ---------------------------------------------------------------------------
# Bit-parallel search kernel (ops/pallas/myers_search.py)
# ---------------------------------------------------------------------------

def _search_end_dists(needles, hay, k, *, anchored=False, damerau=False,
                      own=None):
    """Per-needle D[m][t] for every haystack end position t, stitched from
    the owned ranges of the kernel's segments."""
    from triple_accel_jax.ops.search_scan import window_span

    m, n = len(needles[0]), len(hay)
    if anchored:
        halo, own = 0, -(-max(n, 1) // 128) * 128
    else:
        halo = search_halo(min(window_span(m, k, 1, 0), n), n)
        own = own or search_own_len(n, halo)
    num = seg_count(n, own)
    seg_t = device_pack_segs(hay, halo=halo, own_len=own, num=num)
    out = np.asarray(myers_search(
        prepare_peq(needles, m), seg_t, needle_len=m, seg_len=halo + own,
        anchored=anchored, damerau=damerau, interpret=True,
    ))
    OUT = halo + own + 1
    res = []
    for i in range(len(needles)):
        d = np.empty(n + 1, np.int64)
        d[0] = out[i * OUT + halo, 0]
        for gpos in range(1, n + 1):
            c = (gpos - 1) // own
            d[gpos] = out[i * OUT + gpos - c * own + halo, c]
        res.append(d)
    return res


def _oracle_end_dists(needle, hay, k, costs=LEVENSHTEIN_COSTS,
                      anchored=False):
    by_end = {
        mt.end: mt.k
        for mt in levenshtein_search_naive_with_opts(
            needle, hay, k, SearchType.All, costs, anchored
        )
    }
    return by_end


@pytest.mark.parametrize("m_lo,m_hi", [(1, 20), (21, 64), (65, 256)])
def test_myers_search_distances_match_oracle(m_lo, m_hi):
    rng = np.random.default_rng(m_lo)
    for _ in range(4):
        m = int(rng.integers(m_lo, m_hi + 1))
        n = int(rng.integers(0, 300))
        needle = rng.integers(65, 69, m).astype(np.uint8)
        hay = rng.integers(65, 69, n).astype(np.uint8)
        k = m  # every end position emitted by the oracle
        dists = _search_end_dists([needle], hay, k, own=128)[0]
        for j, exp in _oracle_end_dists(needle, hay, k).items():
            assert dists[j] == exp, (m, n, j, dists[j], exp)


@pytest.mark.parametrize("search_type_name", ["Best", "All"])
def test_myers_search_public_api_matches_oracle(search_type_name):
    """levenshtein_search_simd_with_opts routed through the Myers search
    kernel must equal the oracle, including the maximize-length
    tie-break recovered per hit."""
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts

    st = SearchType[search_type_name]
    rng = np.random.default_rng(7)
    with _forced():
        for trial in range(12):
            m = int(rng.integers(1, 24))
            n = int(rng.integers(0, 220))
            needle = rng.integers(65, 70, m).astype(np.uint8)
            hay = rng.integers(65, 70, n).astype(np.uint8)
            if n > m and rng.integers(0, 2):
                pos = int(rng.integers(0, n - m))
                hay[pos : pos + m] = needle  # plant an exact match
            k = int(rng.integers(0, max(m // 2, 1) + 1))
            got = levenshtein_search_simd_with_opts(
                needle, hay, k, st, LEVENSHTEIN_COSTS, False
            )
            exp = levenshtein_search_naive_with_opts(
                needle, hay, k, st, LEVENSHTEIN_COSTS, False
            )
            assert got == exp, (trial, m, n, k, got[:5], exp[:5])


@pytest.mark.parametrize("damerau", [False, True])
@pytest.mark.parametrize("m", [9, 24, 50, 200])  # 1, 1, 2 and 7 words
def test_search_output_layout(m, damerau):
    """The raw output layout consumers rely on: row n*OUT + t, column c
    holds D[m][t] of needle n over segment c (t in [0, seg_len]), for a
    two-needle launch; the kernel and its plain-XLA twin agree bit for
    bit."""
    rng = np.random.default_rng(m)
    seg_len, C = 24, 3
    segs = rng.integers(65, 69, (C, seg_len)).astype(np.uint8)
    needles = [rng.integers(65, 69, m).astype(np.uint8) for _ in range(2)]
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    seg_t = np.zeros((seg_len, BLOCK), np.uint8)
    seg_t[:, :C] = segs.T
    peq = prepare_peq(needles, m)
    kw = dict(needle_len=m, seg_len=seg_len, damerau=damerau)
    out = np.asarray(myers_search(peq, seg_t, interpret=True, **kw))
    twin = np.asarray(myers_search_jnp(peq, seg_t, **kw))
    OUT = seg_len + 1
    assert out.shape == (2 * OUT, BLOCK)
    assert np.array_equal(out, twin)
    for i, nd in enumerate(needles):
        for c in range(C):
            ref = _oracle_end_dists(nd, segs[c], m + seg_len, costs)
            for t in range(OUT):
                assert out[i * OUT + t, c] == ref[t], (i, c, t)


@pytest.mark.parametrize("variant", ["plain", "damerau_anchored"])
@pytest.mark.parametrize("m", [9, 24, 200])
def test_search_multi_needle_grid_matches_single(m, variant):
    """A launch over three needles (the grid's needle axis) must equal
    three single-needle launches, and the oracle, on a multi-segment
    haystack."""
    damerau = anchored = variant == "damerau_anchored"
    rng = np.random.default_rng(m + anchored)
    needles = [rng.integers(0, 4, m).astype(np.uint8) for _ in range(3)]
    hay = rng.integers(1, 4, 700).astype(np.uint8)
    hay[300:300 + m] = needles[2][: 700 - 300]
    k = 4
    kw = dict(anchored=anchored, damerau=damerau, own=128)
    many = _search_end_dists(needles, hay, k, **kw)
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    for i, nd in enumerate(needles):
        one = _search_end_dists([nd], hay, k, **kw)[0]
        assert np.array_equal(many[i], one), i
        for j, exp in _oracle_end_dists(nd, hay, k, costs, anchored).items():
            assert many[i][j] == exp, (i, j)


@pytest.mark.parametrize(
    "n,halo,own",
    [
        (100_000, 352, 896),
        (5_000, 1_056, 128),  # halo > own: multi-block windows
        (1, 32, 128),
        (70_000, 2_944, 2_944),
        (9_999, 0, 4_096),  # anchored-style zero halo
    ],
)
def test_device_windows_match_chunk_raw(n, halo, own):
    """device_windows (the on-device windowing every search feeds the
    kernels from) is byte-exact with the host reference chunk_raw, and
    device_pack_segs lays one segment per lane, lanes padded to BLOCK."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n + halo)
    hay = rng.integers(0, 256, n).astype(np.uint8)
    segs, num = chunk_raw(hay, halo, own)
    assert num == seg_count(n, own)
    win = device_windows(jnp.asarray(hay), halo=halo, own_len=own, num=num)
    assert np.array_equal(np.asarray(win), np.asarray(segs))
    packed = np.asarray(device_pack_segs(hay, halo=halo, own_len=own,
                                         num=num))
    assert packed.shape == (halo + own, -(-num // BLOCK) * BLOCK)
    assert np.array_equal(packed[:, :num], np.asarray(segs).T)
    assert not packed[:, num:].any()


@pytest.mark.parametrize("n,span", [(1, 5), (3_000, 27), (1 << 20, 288),
                                    (1 << 27, 27)])
def test_search_segment_sizing(n, span):
    """Halo covers the window span in steps of 32; the owned length is a
    power of two >= 128 and >= 4 halos (unless the haystack is shorter),
    the segments cover the haystack, and the segment length is a whole
    number of UNROLL steps."""
    halo = search_halo(span, n)
    assert halo % 32 == 0 and halo >= min(span, n)
    own = search_own_len(n, halo)
    assert own >= 128 and own & (own - 1) == 0
    assert own >= min(4 * halo, n) or own >= n
    num = seg_count(n, own)
    assert num * own >= n and (num - 1) * own < max(n, 1)
    assert (halo + own) % UNROLL == 0
    if n >= 1 << 27:
        assert num >= 1 << 17  # enough lanes to fill the card


def test_long_strings_stay_on_kernel():
    """Long pairs at a small k run on the kernel (its buffers grow with the
    string, its registers only with k) and stay exact."""
    from triple_accel_jax.dispatch import last_dispatch
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(9)
    a = rng.integers(65, 91, 1600).astype(np.uint8)
    b = a.copy()
    b[rng.integers(0, 1600, 7)] = 65
    with _forced():
        out = levenshtein_k_batch([a], [b], 16)
        assert last_dispatch().path == "myers"
    ref = levenshtein_naive_k_with_opts(a, b, 16, False)
    exp = -1 if ref is None else ref[0]
    assert int(out[0]) == exp


def test_wide_band_routes_to_scan():
    """A threshold whose k+1 band passes the word limit runs the scan
    wavefront even with the kernel arms on, and stays exact."""
    from triple_accel_jax.dispatch import last_dispatch
    from triple_accel_jax.levenshtein import levenshtein_k_batch

    rng = np.random.default_rng(19)
    a = rng.integers(65, 70, 300).astype(np.uint8)
    b = rng.integers(65, 70, 310).astype(np.uint8)
    with _forced():
        out = levenshtein_k_batch([a], [b], 300)
        assert last_dispatch().path == "scan"
    assert int(out[0]) == levenshtein_naive_k_with_opts(a, b, 300, False)[0]


@pytest.mark.parametrize("search_type_name", ["Best", "All"])
def test_search_many_matches_per_needle_api(search_type_name):
    """Dictionary search: every needle's result must equal the per-needle
    API (mixed lengths -> multiple shared launches)."""
    from triple_accel_jax.levenshtein import (
        levenshtein_search_many,
        levenshtein_search_simd_with_opts,
    )

    st = SearchType[search_type_name]
    rng = np.random.default_rng(13)
    hay = rng.integers(65, 70, 400).astype(np.uint8)
    needles = []
    for ln in [5, 5, 9, 9, 9, 24, 3]:
        nd = rng.integers(65, 70, ln).astype(np.uint8)
        needles.append(nd)
    # plant two of them
    hay[50:55] = needles[0]
    hay[200:209] = needles[3]
    k = 2
    with _forced():
        many = levenshtein_search_many(needles, hay, k, st, LEVENSHTEIN_COSTS)
        singles = [
            levenshtein_search_simd_with_opts(
                nd, hay, k, st, LEVENSHTEIN_COSTS, False
            )
            for nd in needles
        ]
    for i, (g, e) in enumerate(zip(many, singles)):
        assert g == e, (i, g[:4], e[:4])


@pytest.mark.parametrize("m,path", [(161, "myers_search"),
                                    (256, "myers_search"),
                                    (300, "scan")])
def test_myers_long_needle_matches_oracle(m, path):
    """Needles up to the word limit (256 chars, eight words) run the
    kernel; longer ones the scan wavefront — both exact."""
    from triple_accel_jax.dispatch import last_dispatch
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts

    rng = np.random.default_rng(m)
    needle = rng.integers(60, 80, m).astype(np.uint8)
    hay = rng.integers(60, 80, 700).astype(np.uint8)
    mut = needle.copy()
    mut[rng.integers(0, m, 4)] = 60
    hay[200 : 200 + m] = mut
    with _forced():
        for st in (SearchType.All, SearchType.Best):
            ref = levenshtein_search_naive_with_opts(
                needle, hay, 6, st, LEVENSHTEIN_COSTS, False
            )
            got = levenshtein_search_simd_with_opts(
                needle, hay, 6, st, LEVENSHTEIN_COSTS, False
            )
            assert last_dispatch().path == path
            assert got == ref, (m, st)


def test_search_many_long_needles():
    # dictionary mode with multi-word needles: the (needles x segment
    # blocks) grid and the hit decode must agree with the oracle
    from triple_accel_jax.levenshtein import levenshtein_search_many

    rng = np.random.default_rng(99)
    m = 200
    needles = [rng.integers(60, 80, m).astype(np.uint8) for _ in range(3)]
    hay = rng.integers(60, 80, 900).astype(np.uint8)
    mut = needles[1].copy()
    mut[rng.integers(0, m, 3)] = 60
    hay[300 : 300 + m] = mut
    with _forced():
        res = levenshtein_search_many(needles, hay, 5, SearchType.All)
    for i, nd in enumerate(needles):
        ref = levenshtein_search_naive_with_opts(
            nd, hay, 5, SearchType.All, LEVENSHTEIN_COSTS, False
        )
        assert res[i] == ref, i


def test_search_many_mixed_lengths_share_one_pack():
    """Needle groups within the word limit share one segment pack
    (halo of the widest group: a larger overlap is still exact); a needle
    past the limit falls back to its own search.  All exact."""
    from triple_accel_jax.dispatch import dispatch_history
    from triple_accel_jax.levenshtein import levenshtein_search_many

    rng = np.random.default_rng(71)
    short = rng.integers(60, 80, 20).astype(np.uint8)
    mid = rng.integers(60, 80, 200).astype(np.uint8)
    long_nd = rng.integers(60, 80, 700).astype(np.uint8)
    hay = rng.integers(60, 80, 2000).astype(np.uint8)
    hay[100:120] = short
    hay[300:500] = mid
    mut = long_nd.copy()
    mut[rng.integers(0, 700, 2)] = 60
    hay[900:1600] = mut
    dispatch_history(clear=True)
    with _forced():
        res = levenshtein_search_many(
            [short, long_nd, mid], hay, 3, SearchType.All
        )
    logged = [(d.path, d.padded_m, d.unit_k) for _, d in dispatch_history()]
    many = {m: h for p, m, h in logged if p == "myers_search_many"}
    assert set(many) == {20, 200}, logged
    assert many[20] == many[200] == search_halo(203, 2000), logged
    assert ("scan", 700) in [(p, m) for p, m, _ in logged], logged
    for nd, got in zip([short, long_nd, mid], res):
        ref = levenshtein_search_naive_with_opts(
            nd, hay, 3, SearchType.All, LEVENSHTEIN_COSTS, False
        )
        assert got == ref, len(nd)


@pytest.mark.parametrize("case", ["distance_k8", "distance_k127",
                                  "search_rdamerau", "search_anchored"])
def test_kernels_lower_for_cuda(case):
    """The Triton kernels lower for CUDA on any host (the lowering is the
    GPU compile's front half): a Triton custom call appears in the
    StableHLO, so lowering errors show up before the card."""
    import jax

    from triple_accel_jax.ops.pallas import myers_search as ms

    if case.startswith("distance"):
        k = 8 if case == "distance_k8" else 127
        rng = np.random.default_rng(k)
        a = [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(3)]
        args = prepare_myers_inputs(a, a, k, 64)
        traced = myers_distance_triton.trace(*args, k=k, max_m=64)
    else:
        peq = prepare_peq([np.arange(24, dtype=np.uint8)] * 2, 24)
        seg_t = np.zeros((64, BLOCK), np.uint8)
        traced = ms.myers_search.trace(
            peq, seg_t, needle_len=24, seg_len=64,
            anchored=case == "search_anchored",
            damerau=case == "search_rdamerau", interpret=False)
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()
