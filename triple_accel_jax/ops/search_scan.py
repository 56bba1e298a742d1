"""Approximate string search as a batched anti-diagonal `lax.scan`.

Accelerator re-design of the reference's SIMD search wavefront
(`create_levenshtein_search_simd_core!`, reference src/levenshtein.rs:
2157-2451).  The DP matrix is needle (rows, len m) x haystack (cols); row 0
is free for unanchored searches so matches may start anywhere; the cell
(m, i) yields a candidate match ending at haystack position i with cost
dist[i] and haystack span length[i] (match-length tie-break: maximize).

The wavefront iterates anti-diagonals t = i + j; on diagonal t, lane j holds
cell (j, i = t - j), so every predecessor is a lane shift of carried state:

    needle gap   (j,   i-1) -> same lane of diag t-1  (consumes haystack)
    haystack gap (j-1, i  ) -> lane j-1 of diag t-1   (consumes needle)
    substitution (j-1, i-1) -> lane j-1 of diag t-2
    transpose    (j-2, i-2) -> lane j-2 of diag t-4

No intra-step dependency exists — the reason the reference also sweeps
diagonals — so each step is pure elementwise work, vectorized across a batch of
haystack *chunks* (the leading axis).  Chunking is the device parallelization:
a match ending at i spans at most Lw = m + (k - start_gap)/gap haystack
characters, so chunks overlapping by an Lw-1 halo reproduce the unchunked
results exactly for every cell value <= k (owner-by-end-index dedup).

Length tie-break contract reproduced from the scalar search core
(reference levenshtein.rs:1723-1779), including its exact comparison order.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .band_scan import INF

__all__ = ["search_scan", "window_span", "chunk_haystack"]


def window_span(needle_len: int, k: int, gap_cost: int, start_gap_cost: int) -> int:
    """Max haystack chars a cost-<=k match can span: m + (k - sgc)/gc gap
    extensions (each needle-gap consumes one haystack char and costs at
    least one gap extension after the mandatory gap start)."""
    return needle_len + max(0, k - start_gap_cost) // gap_cost


def _shift_down(x: jnp.ndarray, fill) -> jnp.ndarray:
    """x[j] <- x[j-1] along the lane axis, `fill` into lane 0."""
    return jnp.concatenate(
        [jnp.full_like(x[:, :1], fill), x[:, :-1]], axis=1
    )


@partial(
    jax.jit,
    static_argnames=("needle_len", "seg_len", "costs_t", "anchored"),
)
def search_scan(
    needle_pad: jnp.ndarray,  # [needle_len] int32
    seg_pad: jnp.ndarray,  # [C, seg_len + needle_len + 2] int32, see below
    seg_n: jnp.ndarray,  # [C] int32: valid chars in each segment
    seg_off: jnp.ndarray,  # [C] int32: global offset of each segment start
    *,
    needle_len: int,
    seg_len: int,
    costs_t: Tuple[int, int, int, int, bool],
    anchored: bool,
):
    """Batched search wavefront over haystack segments.

    `seg_pad` is [C, seg_len + 2*needle_len + 2] with segment char q at
    column q + needle_len + 1 and sentinel -1 elsewhere (see
    `chunk_haystack`).
    Returns (dist [C, seg_len + 1], length [C, seg_len + 1]) int32 arrays:
    entry i is the DP result for the match ending after i segment chars
    (dist >= INF where out of range).
    """
    mc, gc, sgc, tc, allow_transpose = costs_t
    m = needle_len
    lanes = m + 1
    C = seg_pad.shape[0]
    j_arr = jnp.arange(lanes, dtype=jnp.int32)[None, :]  # [1, lanes]

    # needle chars per lane: nchar[j] = needle[j-1]; nprev[j] = needle[j-2]
    npad = jnp.concatenate(
        [jnp.full((2,), -1, jnp.int32), needle_pad.astype(jnp.int32)]
    )
    nchar = npad[1 : 1 + lanes][None, :]
    nprev = npad[0:lanes][None, :]

    n_col = seg_n[:, None]
    off_col = seg_off[:, None]

    dp1 = jnp.where(j_arr == 0, 0, INF) * jnp.ones((C, 1), jnp.int32)
    dp2 = jnp.full((C, lanes), INF, jnp.int32)
    dp3 = jnp.full((C, lanes), INF, jnp.int32)
    dp4 = jnp.full((C, lanes), INF, jnp.int32)
    len1 = jnp.zeros((C, lanes), jnp.int32)
    len2 = jnp.zeros((C, lanes), jnp.int32)
    len3 = jnp.zeros((C, lanes), jnp.int32)
    len4 = jnp.zeros((C, lanes), jnp.int32)
    ng = jnp.full((C, lanes), INF, jnp.int32)
    ngl = jnp.zeros((C, lanes), jnp.int32)
    hg = jnp.full((C, lanes), INF, jnp.int32)
    hgl = jnp.zeros((C, lanes), jnp.int32)

    def body(carry, t):
        dp1, dp2, dp3, dp4, len1, len2, len3, len4, ng, ngl, hg, hgl = carry

        # reversed haystack windows: w1[j] = seg[t-1-j], w2[j] = seg[t-2-j]
        w1 = lax.dynamic_slice_in_dim(seg_pad, t, lanes, axis=1)[:, ::-1]
        w2 = lax.dynamic_slice_in_dim(seg_pad, t - 1, lanes, axis=1)[:, ::-1]

        i_vec = t - j_arr  # [1, lanes] haystack position per lane
        valid = (i_vec >= 0) & (i_vec <= n_col)

        # needle gap (consume haystack char): same lane, diag t-1
        new_g = dp1 + (sgc + gc)
        cont_g = jnp.minimum(ng, INF) + gc
        ng2 = jnp.minimum(new_g, cont_g)
        ngl2 = jnp.where(
            new_g < cont_g,
            len1 + 1,
            jnp.where(new_g > cont_g, ngl + 1, jnp.maximum(len1, ngl) + 1),
        )

        # haystack gap (consume needle char): lane j-1, diag t-1
        dp1s = _shift_down(dp1, INF)
        hgs = _shift_down(hg, INF)
        len1s = _shift_down(len1, 0)
        hgls = _shift_down(hgl, 0)
        new_h = dp1s + (sgc + gc)
        cont_h = jnp.minimum(hgs, INF) + gc
        hg2 = jnp.minimum(new_h, cont_h)
        hgl2 = jnp.where(
            new_h < cont_h,
            len1s,
            jnp.where(new_h > cont_h, hgls, jnp.maximum(len1s, hgls)),
        )

        # substitution: lane j-1, diag t-2
        dp2s = _shift_down(dp2, INF)
        len2s = _shift_down(len2, 0)
        sub = dp2s + jnp.where(nchar == w1, 0, mc)
        lsub = len2s + 1

        # selection cascade — exact reference order (levenshtein.rs:1752-1779)
        dp = ng2
        ln = ngl2
        take_h = (hg2 < dp) | ((hg2 == dp) & (len1s > ln))
        dp = jnp.where(take_h, hg2, dp)
        ln = jnp.where(take_h, hgl2, ln)
        take_s = (sub < dp) | ((sub == dp) & (lsub > ln))
        dp = jnp.where(take_s, sub, dp)
        ln = jnp.where(take_s, lsub, ln)
        if allow_transpose:
            # transpose pred (j-2, i-2) is four diagonals back, two lanes
            # down (cf. reference levenshtein.rs:2351-2364: "dp0 is four
            # diagonals behind the current i")
            dp4ss = _shift_down(_shift_down(dp4, INF), INF)
            len4ss = _shift_down(_shift_down(len4, 0), 0)
            tcond = (
                (i_vec > 1) & (j_arr > 1) & (nchar == w2) & (nprev == w1)
            )
            trans = dp4ss + tc
            take_t = tcond & (trans <= dp)
            dp = jnp.where(take_t, trans, dp)
            ln = jnp.where(take_t, len4ss + 2, ln)

        dp = jnp.where(valid, jnp.minimum(dp, INF), INF)
        ln = jnp.where(valid, ln, 0)

        # boundary row j = 0: free (unanchored) or global-shift cost
        if anchored:
            boundary = (off_col + t) * gc + sgc
        else:
            boundary = jnp.zeros((C, 1), jnp.int32)
        b_valid = (t <= n_col) & (t >= 0)
        dp = dp.at[:, 0].set(jnp.where(b_valid, boundary, INF)[:, 0])
        ln = ln.at[:, 0].set(0)
        ng2 = ng2.at[:, 0].set(dp[:, 0])
        ngl2 = ngl2.at[:, 0].set(0)
        hg2 = hg2.at[:, 0].set(INF)
        hgl2 = hgl2.at[:, 0].set(0)

        out = (dp[:, m], ln[:, m])
        carry = (dp, dp1, dp2, dp3, ln, len1, len2, len3, ng2, ngl2, hg2, hgl2)
        return carry, out

    ts = jnp.arange(1, m + seg_len + 1, dtype=jnp.int32)
    carry0 = (dp1, dp2, dp3, dp4, len1, len2, len3, len4, ng, ngl, hg, hgl)
    _, (dists, lens) = lax.scan(body, carry0, ts)

    # cell (m, i) lives on diagonal t = m + i; ys row r is t = r + 1,
    # so position i is row m + i - 1.  i = 0 (the end=0 candidate) uses the
    # initial column, which the wavefront computes at t = m.
    dist_out = jnp.concatenate(
        [dists[m - 1 :, :], jnp.full((m, C), INF, jnp.int32)], axis=0
    )[: seg_len + 1].T
    len_out = jnp.concatenate(
        [lens[m - 1 :, :], jnp.zeros((m, C), jnp.int32)], axis=0
    )[: seg_len + 1].T
    return dist_out, len_out


def chunk_haystack(
    haystack: np.ndarray,
    needle_len: int,
    halo: int,
    own_len: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Split a haystack into overlapping segments for parallel search.

    Segment c owns global end positions (c*own_len, (c+1)*own_len] and its
    DP additionally sees `halo` characters to the left of its owned range,
    so every match whose window (<= halo + 1) ends in the owned range is
    computed exactly (owner-by-end-index dedup).

    Returns (seg_pad, seg_n, seg_off, own_start, seg_len) where seg_len =
    halo + own_len is the static per-segment capacity and seg_pad is
    [C, seg_len + 2*needle_len + 2] int32 with segment chars at offset
    needle_len + 1 and sentinel -1 elsewhere, as `search_scan` expects.
    """
    n = len(haystack)
    num = max(1, -(-n // own_len))
    seg_len = halo + own_len
    pad_l = needle_len + 1
    width = seg_len + 2 * needle_len + 2
    seg_pad = np.full((num, width), -1, dtype=np.int32)
    seg_n = np.zeros(num, dtype=np.int32)
    seg_off = np.zeros(num, dtype=np.int32)
    own_start = np.zeros(num, dtype=np.int32)
    for c in range(num):
        o = c * own_len
        s0 = max(0, o - halo)
        s1 = min(n, o + own_len)
        seg = haystack[s0:s1]
        seg_pad[c, pad_l : pad_l + len(seg)] = seg
        seg_n[c] = len(seg)
        seg_off[c] = s0
        own_start[c] = o
    return seg_pad, seg_n, seg_off, own_start, seg_len
