"""Card-only tests: the Triton kernels compiled for the GPU (no interpret
mode) against their plain-XLA twins and the scalar oracle.  They skip
unless JAX's default backend is a GPU; `python chip_smoke.py` runs them
there (`pytest -m gpu`) inside its own process."""

import numpy as np
import pytest

from triple_accel_jax.oracle import (
    levenshtein_naive_k_with_opts,
    levenshtein_search_naive_with_opts,
)
from triple_accel_jax.types import LEVENSHTEIN_COSTS, RDAMERAU_COSTS, SearchType

pytestmark = pytest.mark.gpu


def _distances(a_list, b_list, k):
    """Banded distances (-1 over k): the C++ bit-parallel comparator when
    built, else the scalar oracle."""
    from triple_accel_jax.utils.native import myers_distance_batch_native

    ref = myers_distance_batch_native(a_list, b_list, k)
    if ref is not None:
        return ref
    return np.array([(lambda r: -1 if r is None else r[0])(
        levenshtein_naive_k_with_opts(a, b, k)) for a, b in zip(a_list, b_list)])


def _end_dists(needle, hay, k, costs, anchored):
    """{end: distance} of every All-mode candidate: the C++ oracle port
    when built, else the scalar oracle."""
    from triple_accel_jax.utils.native import search_all_native

    res = search_all_native(needle, hay, k, costs, anchored)
    if res is not None:
        ends, ks, _ = res
        return dict(zip(ends.tolist(), ks.tolist()))
    return {mt.end: mt.k for mt in levenshtein_search_naive_with_opts(
        needle, hay, k, SearchType.All, costs, anchored)}


def _pairs(rng, B, max_m, k):
    a_list, b_list = [], []
    for _ in range(B):
        la = int(rng.integers(0, max_m - k))
        a = rng.integers(0, 4, la).astype(np.uint8)  # NUL bytes included
        b = list(a)
        for _ in range(int(rng.integers(0, k + 3))):
            op = rng.integers(0, 3)
            if op == 0 and b:
                b[rng.integers(0, len(b))] = rng.integers(0, 4)
            elif op == 1:
                b.insert(int(rng.integers(0, len(b) + 1)), int(rng.integers(0, 4)))
            elif b:
                del b[rng.integers(0, len(b))]
        b = np.asarray(b, np.uint8)
        if len(a) > len(b):
            a, b = b, a
        if len(b) - len(a) > k:
            b = b[: len(a) + k]
        a_list.append(a)
        b_list.append(b)
    return a_list, b_list


@pytest.mark.parametrize("k,max_m", [(8, 64), (31, 128), (127, 256)])
def test_distance_kernel_compiled(gpu, k, max_m):
    """Compiled kernel == plain-XLA twin == oracle, at one word, at a word
    boundary and at the word limit."""
    from triple_accel_jax.ops.pallas import myers_distance as md

    rng = np.random.default_rng(k)
    a_list, b_list = _pairs(rng, 300, max_m, k)
    args = md.prepare_myers_inputs(a_list, b_list, k, max_m)
    got = np.asarray(md.myers_distance_triton(*args, k=k, max_m=max_m))
    twin = np.asarray(md.myers_distance_jnp(*args, k=k, max_m=max_m))
    assert np.array_equal(got, twin)
    ref = _distances(a_list, b_list, k)
    B = len(a_list)
    assert np.array_equal(np.where(got[:B] <= k, got[:B], -1), ref)


@pytest.mark.parametrize("m,damerau,anchored", [
    (5, False, False), (24, True, False), (24, False, True),
    (256, False, False), (256, True, True),
])
def test_search_kernel_compiled(gpu, m, damerau, anchored):
    """Compiled search kernel == plain-XLA twin, and end distances equal
    the oracle, for one and eight needle words."""
    from triple_accel_jax.ops.pallas import myers_search as ms

    rng = np.random.default_rng(m + 2 * damerau + anchored)
    n = 3000
    # no NUL bytes: segment 0's front halo is zero padding
    needles = [rng.integers(1, 5, m).astype(np.uint8) for _ in range(3)]
    hay = rng.integers(1, 5, n).astype(np.uint8)
    hay[700:700 + m] = needles[1]
    halo, own = (0, 3072) if anchored else (ms.search_halo(m + m, n), 512)
    num = ms.seg_count(n, own)
    seg_t = ms.device_pack_segs(hay, halo=halo, own_len=own, num=num)
    peq = ms.prepare_peq(needles, m)
    kw = dict(needle_len=m, seg_len=halo + own, anchored=anchored,
              damerau=damerau)
    got = np.asarray(ms.myers_search(peq, seg_t, **kw))
    twin = np.asarray(ms.myers_search_jnp(peq, seg_t, **kw))
    assert np.array_equal(got, twin)
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    OUT = halo + own + 1
    for i, nd in enumerate(needles):
        ref = _end_dists(nd, hay, m, costs, anchored)
        for gpos, d in list(ref.items())[:: max(1, len(ref) // 200)]:
            c = max(gpos - 1, 0) // own
            t = gpos - (c * own - halo)
            assert got[i * OUT + t, c] == d, (i, gpos)


def test_public_api_takes_kernels_on_gpu(gpu):
    """With no override the public API routes unit costs to the kernels
    on a GPU, and the results equal the oracle."""
    import triple_accel_jax as ta
    from triple_accel_jax.dispatch import last_dispatch
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts

    rng = np.random.default_rng(5)
    a_list, b_list = _pairs(rng, 200, 100, 16)
    got = ta.levenshtein_k_batch(a_list, b_list, 16)
    assert last_dispatch().path == "myers"
    assert np.array_equal(got, _distances(a_list, b_list, 16))
    needle = rng.integers(0, 4, 12).astype(np.uint8)
    hay = rng.integers(0, 4, 5000).astype(np.uint8)
    for st in (SearchType.Best, SearchType.All):
        got = levenshtein_search_simd_with_opts(needle, hay, 3, st)
        assert last_dispatch().path == "myers_search"
        assert got == levenshtein_search_naive_with_opts(
            needle, hay, 3, st, LEVENSHTEIN_COSTS, False)
