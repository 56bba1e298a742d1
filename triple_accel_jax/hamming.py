"""Public Hamming distance and Hamming search API.

Mirrors the reference's `triple_accel::hamming` module (src/hamming.rs):
the blessed functions `hamming` / `hamming_search` plus every named variant
(`hamming_naive`, `hamming_words_64/128`, `hamming_simd_parallel`,
`hamming_simd_movemask`, `hamming_search_naive[_with_opts]`,
`hamming_search_simd[_with_opts]`), with identical result semantics.

Deviations of the device path (documented per SURVEY.md §7):

* the device path supports null bytes — padding is masked by length, not
  zero-filled, so `check_no_null_bytes` is not required (reference
  hamming.rs:463 bans them);
* a batched-first API (`hamming_batch`) is the intended high-throughput
  entry point: one dispatch covers a whole [B, L] batch of pairs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .dispatch import DispatchDecision, forced_path, round_up_pow2
from .oracle.hamming import (
    default_hamming_k,
    hamming_naive,
    hamming_search_naive,
    hamming_search_naive_with_opts,
    hamming_words_64,
    hamming_words_128,
)
from .types import BytesLike, Match, SearchType, to_bytes_array

__all__ = [
    "hamming",
    "hamming_naive",
    "hamming_words_64",
    "hamming_words_128",
    "hamming_simd_parallel",
    "hamming_simd_movemask",
    "hamming_batch",
    "hamming_search",
    "hamming_search_naive",
    "hamming_search_naive_with_opts",
    "hamming_search_simd",
    "hamming_search_sharded",
    "hamming_search_simd_with_opts",
    "default_hamming_k",
]

_MAX_SEG = 1 << 20  # haystack positions per device dispatch for searches


def hamming_simd_parallel(a: BytesLike, b: BytesLike) -> int:
    """Device-accelerated mismatch count (reference hamming.rs:317-330).

    The name is kept for API parity; on the device this is a single fused XLA
    reduction rather than the reference's 255-block SIMD accumulate.

    >>> hamming_simd_parallel(b"abc", b"abd")
    1
    """
    a = to_bytes_array(a)
    b = to_bytes_array(b)
    if len(a) != len(b):
        raise ValueError("strings must have equal lengths for Hamming distance")
    if forced_path() == "oracle" or len(a) == 0:
        return hamming_naive(a, b)
    return int(hamming_batch(a[None, :], b[None, :], np.array([len(a)]))[0])


def hamming_simd_movemask(a: BytesLike, b: BytesLike) -> int:
    """API-parity alias (reference hamming.rs:354-367).

    The movemask-popcount trick is x86-specific; on the device both variants lower
    to the same fused reduction.
    """
    return hamming_simd_parallel(a, b)


def hamming(a: BytesLike, b: BytesLike) -> int:
    """Hamming distance via the best available path (reference hamming.rs:390).

    >>> hamming(b"abc", b"abd")
    1
    """
    return hamming_simd_parallel(a, b)


def hamming_batch(
    a: np.ndarray, b: np.ndarray, lengths: Optional[np.ndarray] = None,
    mesh=None,
) -> np.ndarray:
    """Batched Hamming distance: one device dispatch for [B, L] pairs.

    `lengths` masks each pair's valid prefix (defaults to the full width).
    This is the device unit of work (SURVEY.md §7 design stance).
    `mesh` shards the batch axis across devices (pairs are independent —
    pure data parallelism, XLA partitions the fused reduction with no
    communication); the batch pads to a mesh multiple and results are
    identical to the meshless call.
    """
    from .ops.hamming_ops import hamming_kernel

    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if a.shape != b.shape:
        raise ValueError("a and b batches must have the same shape")
    B0 = a.shape[0]
    if lengths is None:
        lengths = np.full(B0, a.shape[1], dtype=np.int32)
    L = round_up_pow2(a.shape[1], 8)
    pad = L - a.shape[1]
    if pad:
        a = np.pad(a, ((0, 0), (0, pad)))
        b = np.pad(b, ((0, 0), (0, pad)))
    DispatchDecision(
        path="xla_sharded" if mesh is not None else "xla",
        cost_bucket="u32", unit_k=0, max_k=0,
        padded_m=B0, padded_n=L,
    ).log("hamming_batch")
    a32 = a.astype(np.int32)
    b32 = b.astype(np.int32)
    l32 = np.asarray(lengths, dtype=np.int32)
    if mesh is not None:
        import jax

        from .parallel.mesh import batch_sharding

        D = int(mesh.devices.size)
        bpad = (-B0) % D
        if bpad:
            a32 = np.pad(a32, ((0, bpad), (0, 0)))
            b32 = np.pad(b32, ((0, bpad), (0, 0)))
            l32 = np.pad(l32, (0, bpad))
        sh = batch_sharding(mesh)
        a32, b32, l32 = (jax.device_put(x, sh) for x in (a32, b32, l32))
    out = hamming_kernel(a32, b32, l32)
    return np.asarray(out)[:B0]


def hamming_search_simd_with_opts(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    search_type: SearchType = SearchType.Best,
) -> List[Match]:
    """Device-accelerated Hamming search (reference hamming.rs:454-475).

    Device computes the mismatch count at every position in parallel; the
    host applies the reference's streaming threshold semantics (Best:
    curr_k shrinks per hit, final filter keeps k == final curr_k; no
    overlap dedup — unlike Levenshtein search).
    """
    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    if len(needle) > len(haystack) or len(needle) == 0:
        return []
    if forced_path() == "oracle":
        return hamming_search_naive_with_opts(needle, haystack, k, search_type)

    m = len(needle)
    n = len(haystack)
    # two-phase hit fetch: the device computes per-position counts and
    # per-block minima; the host fetches the tiny minima, then only the
    # blocks that can contain hits (the full count array is 4 bytes per
    # haystack byte — on slow host links that fetch dominates everything)
    from .ops.hamming_ops import (
        BLOCK,
        hamming_gather_blocks,
        hamming_search_block_mins,
    )

    P = round_up_pow2(n + 1, BLOCK)
    hay_pad = np.zeros(P, dtype=np.uint8)
    hay_pad[:n] = haystack
    counts_d, mins_d = hamming_search_block_mins(
        needle, hay_pad, np.int32(n), needle_len=m
    )
    return _resolve_counts_matches(counts_d, np.asarray(mins_d), m, n, k,
                                   search_type)


def _resolve_counts_matches(counts_d, mins, m, n, k, search_type):
    """Two-phase hit fetch + streaming postprocess over a device-resident
    per-position counts array (single-device or mesh-sharded — the layouts
    are identical: global start position p lives at counts[p], block b's
    minimum at mins[b])."""
    from .ops.hamming_ops import BLOCK, hamming_gather_blocks
    kk = min(k, m)
    best = search_type == SearchType.Best
    if best:
        # streaming Best keeps exactly the candidates at the final
        # curr_k == the global minimum count (no overlap dedup in
        # hamming search) — and the global minimum is already in the
        # fetched block mins, so only blocks AT the minimum need their
        # counts fetched; with the blessed default k = ceil(m/2) on
        # low-complexity text this shrinks the fetch from every block
        # to a handful
        gmin = int(mins.min())
        if gmin > kk:
            return []
        cand = np.flatnonzero(mins == gmin)
    else:
        cand = np.flatnonzero(mins <= kk)
    if cand.size == 0:
        return []

    # pad candidate count to a pow2 bucket to bound recompiles
    padded = np.empty(round_up_pow2(cand.size, 8), dtype=np.int32)
    padded[: cand.size] = cand
    padded[cand.size :] = cand[-1]
    blocks = np.asarray(hamming_gather_blocks(counts_d, padded))

    n_pos = n - m + 1
    bases = cand.astype(np.int64) * BLOCK
    blk = blocks[: cand.size].astype(np.int64)
    pos = bases[:, None] + np.arange(BLOCK, dtype=np.int64)[None, :]
    ok = pos < n_pos

    if best:
        # every hit is a position at exactly gmin (positions past n_pos
        # hold a sentinel far above m, so `ok` is belt-and-braces);
        # cand and the in-block offsets are both ascending, so the
        # matches come out in stream order
        sel = ok & (blk == gmin)
        return [
            Match(start=int(p), end=int(p) + m, k=gmin) for p in pos[sel]
        ]

    # All mode from here on (Best returned above)
    if cand.size * BLOCK < n_pos // 4:
        # sparse candidates: never materialize an O(n) counts array (8
        # bytes per haystack byte!) for a handful of blocks — the fetched
        # blocks already hold every position that can be a hit (every
        # unfetched position's count exceeds kk).  Positions come out
        # sorted: cand is ascending and blocks are disjoint.
        hpos, hcnt = pos[ok], blk[ok]
        keep = hcnt <= k
        hpos, hcnt = hpos[keep], hcnt[keep]
        return [
            Match(start=int(p), end=int(p) + m, k=int(c))
            for p, c in zip(hpos, hcnt)
        ]

    # dense candidates: scatter the fetched blocks into a full-counts
    # array (sentinel above k elsewhere — exact, see above) and run ONE
    # streaming pass over it: the native C++ pass (native/postprocess.cpp
    # ta_postprocess_hamming) when built, else vectorized numpy.  With
    # the blessed default k = ceil(m/2) on low-complexity text every
    # block is a candidate, and this used to be a per-position Python
    # loop (the reference's streaming iterator is compiled;
    # hamming.rs:477-554).
    sent = np.int64(max(min(k, m), m)) + 1  # every real count is < sent;
    # sentinel positions (count > kk) only survive the <=k test when
    # k < m, where sent = m+1 > k — when k >= m every block is a
    # candidate (block mins <= m always) so no sentinel remains
    counts_full = np.full(n_pos, sent, dtype=np.int64)
    counts_full[pos[ok]] = blk[ok]

    from .utils.native import postprocess_hamming_native

    native = postprocess_hamming_native(counts_full, m, k, best=False)
    if native is not None:
        return native
    hits = np.flatnonzero(counts_full <= k)
    return [
        Match(start=int(i), end=int(i) + m, k=int(counts_full[i]))
        for i in hits
    ]


def hamming_search_simd(needle: BytesLike, haystack: BytesLike) -> List[Match]:
    """Default device search: k = ceil(len/2), Best (reference hamming.rs:422-424)."""
    needle = to_bytes_array(needle)
    return hamming_search_simd_with_opts(
        needle, haystack, default_hamming_k(len(needle)), SearchType.Best
    )


def hamming_search(needle: BytesLike, haystack: BytesLike) -> List[Match]:
    """Blessed search entry point (reference hamming.rs:588-590).

    >>> hamming_search(b"abc", b"  abd") == [Match(start=2, end=5, k=1)]
    True
    """
    return hamming_search_simd(needle, haystack)


def hamming_search_sharded(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    mesh,
    search_type: SearchType = SearchType.Best,
) -> List[Match]:
    """Hamming search of ONE long haystack sharded across a device mesh —
    results are exactly `hamming_search_simd_with_opts`'s.

    Each device counts mismatches at its own start positions after a
    single `lax.ppermute` pulls the right neighbor's first needle_len-1
    chars (`parallel.sharded_hamming_search_mins`); fixed-length windows
    mean start positions partition exactly across shards (no dedup), and
    the assembled counts/minima share the single-device layout, so the
    same two-phase fetch + streaming postprocess resolves them.
    """
    from .ops.hamming_ops import BLOCK
    from .parallel.sharded import sharded_hamming_search_mins

    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    m, n = len(needle), len(haystack)
    if m > n or m == 0:
        return []
    D = int(mesh.devices.size)
    S = max(
        round_up_pow2(-(-(n + 1) // D), BLOCK),
        round_up_pow2(m, BLOCK),  # the halo must fit inside one shard
    )
    shards = np.zeros((D, S), dtype=np.uint8)
    shards.reshape(-1)[:n] = haystack
    counts_d, mins_d = sharded_hamming_search_mins(
        mesh, shards, needle, np.int32(n), needle_len=m
    )
    return _resolve_counts_matches(counts_d, np.asarray(mins_d), m, n, k,
                                   search_type)
