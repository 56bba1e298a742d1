"""Banded Levenshtein distance as a batched `lax.scan` over DP rows.

Accelerator re-design of the reference's anti-diagonal SIMD wavefront
(`create_levenshtein_simd_core!`, reference src/levenshtein.rs:829-1283).
The reference iterates anti-diagonals because x86 SIMD has no cheap
prefix-scan; on the device we instead scan *rows* of the shorter string and
resolve the within-row (horizontal, affine) gap chain with a single
`lax.cummin` — the classic min-plus prefix trick:

    E[c] = start_gap + c*gap + min_{c'<c} (D'[c'] - c'*gap)

which is exact for affine gaps because opening a gap out of a cell whose
value itself came from a horizontal gap is always dominated by extending.

Coordinates: DP cell (i, j) over a (rows, len m) x b (cols, len n), m <= n.
The band keeps |j - i| <= unit_k; band lane c in [0, W), W = 2*unit_k + 1,
holds j = i + c - unit_k.  In these coordinates:

    substitution  (i-1, j-1) -> same lane c of the previous row
    vertical gap  (i-1, j  ) -> lane c+1 of the previous row (consume a)
    horizontal    (i,   j-1) -> lane c-1 of the same row     (consume b)
    transpose     (i-2, j-2) -> same lane c two rows back

so everything except the horizontal chain is a lane shift of carried state,
and the whole batch of pairs is vectorized across the leading axis.

Numeric contract (must match the scalar oracle / reference exactly):
tie priority sub > horizontal(AGap) > vertical(BGap), transpose wins on <=
(reference levenshtein.rs:469-532); traceback codes {0: sub, 1: consume-b,
2: consume-a, 3: transpose}.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..types import Edit, EditType

__all__ = [
    "INF",
    "band_scan_distance",
    "band_trace_batch",
    "decode_walked_batch",
    "prepare_band_inputs",
    "fill_rows",
    "row_lengths",
    "decode_traceback",
]

INF = np.int32(1 << 30)  # +infinity sentinel; all real costs stay far below


def _shift_left(x: jnp.ndarray) -> jnp.ndarray:
    """x[c] <- x[c+1], INF shifted into the last lane."""
    return jnp.concatenate([x[:, 1:], jnp.full_like(x[:, :1], INF)], axis=1)


def _shift_right(x: jnp.ndarray) -> jnp.ndarray:
    """x[c] <- x[c-1], INF shifted into the first lane."""
    return jnp.concatenate([jnp.full_like(x[:, :1], INF), x[:, :-1]], axis=1)


@partial(
    jax.jit,
    static_argnames=("unit_k", "max_m", "costs_t", "trace_on"),
)
def band_scan_distance(
    a_pad: jnp.ndarray,  # [B, max_m] int32, sentinel -1 past each pair's m
    b_pad: jnp.ndarray,  # [B, max_m + W] int32, b at offset unit_k, sentinel -1
    m: jnp.ndarray,  # [B] int32, per-pair len(a) (m <= n required)
    n: jnp.ndarray,  # [B] int32, per-pair len(b)
    *,
    unit_k: int,
    max_m: int,
    costs_t: Tuple[int, int, int, int, bool],
    trace_on: bool,
):
    """Batched banded edit distance.

    Returns (dist [B] int32, codes [max_m, B, W] uint8 or None).
    dist is INF-flavored (>= INF) when the pair's final cell was never
    reached (caller turns values > max_k into None).
    """
    mc, gc, sgc, tc, allow_transpose = costs_t
    W = 2 * unit_k + 1
    B = a_pad.shape[0]
    c_arr = jnp.arange(W, dtype=jnp.int32)

    n_col = n[:, None]
    m_col = m[:, None]

    # row 0: D[0][j] = j*gap + (j>0)*start_gap for valid j, else INF
    j0 = c_arr[None, :] - unit_k
    dp1_init = jnp.where(
        (j0 >= 0) & (j0 <= n_col),
        j0 * gc + jnp.where(j0 > 0, sgc, 0),
        INF,
    ).astype(jnp.int32) * jnp.ones((B, 1), jnp.int32)

    # final cell of pair p lives at lane c_fin = n - m + unit_k
    c_fin = jnp.clip(n - m + unit_k, 0, W - 1)

    # pairs with m == 0 finish at row 0
    d0 = jnp.take_along_axis(dp1_init, c_fin[:, None], axis=1)[:, 0]
    result0 = jnp.where(m == 0, d0, INF)

    dp0_init = jnp.full((B, W), INF, jnp.int32)
    bgap_init = jnp.full((B, W), INF, jnp.int32)

    def body(carry, i):
        dp0, dp1, bgap, result = carry

        a_char = lax.dynamic_slice_in_dim(a_pad, i - 1, 1, axis=1)  # [B,1]
        bwin = lax.dynamic_slice_in_dim(b_pad, i - 1, W, axis=1)  # b[j-1]

        j = i + c_arr[None, :] - unit_k  # [1,W] broadcast
        valid = (j >= 0) & (j <= n_col)

        # substitution from (i-1, j-1): same lane of previous row
        sub = dp1 + jnp.where(a_char == bwin, 0, mc)

        # vertical gap (consume a) from lane c+1 of previous row
        bgap2 = jnp.minimum(
            _shift_left(dp1) + (sgc + gc), _shift_left(bgap) + gc
        )

        dprime = jnp.minimum(sub, bgap2)

        if allow_transpose:
            # b[j-2] / a[i-2] windows; offsets clamp at 0, gated by i > 1
            bwin2 = lax.dynamic_slice_in_dim(
                b_pad, jnp.maximum(i - 2, 0), W, axis=1
            )
            a_prev = lax.dynamic_slice_in_dim(
                a_pad, jnp.maximum(i - 2, 0), 1, axis=1
            )
            tcond = (
                (i > 1)
                & (j > 1)
                & (a_char == bwin2)
                & (a_prev == bwin)
            )
            trans = jnp.where(tcond, dp0 + tc, INF)
            dprime = jnp.minimum(dprime, trans)

        dprime = jnp.where(valid, jnp.minimum(dprime, INF), INF)

        # horizontal (consume b) affine chain: exclusive prefix min
        g = dprime - c_arr[None, :] * gc
        mins = _shift_right(lax.cummin(g, axis=1))
        e = jnp.minimum(sgc + c_arr[None, :] * gc + mins, INF)

        # selection cascade — must mirror the scalar banded core's order
        # (reference levenshtein.rs:493-532): sub default, horizontal on <,
        # vertical on <, transpose on <=.
        dp2 = sub
        code = jnp.zeros((B, W), jnp.uint8)
        take_e = e < dp2
        dp2 = jnp.where(take_e, e, dp2)
        code = jnp.where(take_e, jnp.uint8(1), code)
        take_b = bgap2 < dp2
        dp2 = jnp.where(take_b, bgap2, dp2)
        code = jnp.where(take_b, jnp.uint8(2), code)
        if allow_transpose:
            take_t = tcond & (trans <= dp2)
            dp2 = jnp.where(take_t, trans, dp2)
            code = jnp.where(take_t, jnp.uint8(3), code)

        dp2 = jnp.where(valid, jnp.minimum(dp2, INF), INF)

        d_at = jnp.take_along_axis(dp2, c_fin[:, None], axis=1)[:, 0]
        result = jnp.where(i == m_col[:, 0], d_at, result)

        new_carry = (dp1, dp2, bgap2, result)
        return new_carry, (code if trace_on else None)

    rows = jnp.arange(1, max_m + 1, dtype=jnp.int32)
    (_, _, _, result), codes = lax.scan(
        body, (dp0_init, dp1_init, bgap_init, result0), rows
    )
    return result, codes


def _walk_scan(code_at, a_at, b_at, m0, n0, *, unit_k: int, max_m: int):
    """Shared vectorized traceback walk (both code layouts route here so
    the step tables — the correctness contract with decode_traceback —
    exist exactly once).  `code_at(i, c) -> [B]` fetches the argmin code
    of cell (row i, band lane c); `a_at(i)` / `b_at(j)` fetch chars.
    Returns (seq [B, steps] int8 in REVERSE walk order: 0 Match,
    1 Mismatch, 2 consume-b, 3 consume-a, 4 Transpose, -1 done; steps).
    `steps = 2*max_m + unit_k + 1` bounds every walk since n <= m + unit_k.
    """
    W = 2 * unit_k + 1
    steps = 2 * max_m + unit_k + 1

    def body(carry, _):
        i, j = carry
        active = (i > 0) | (j > 0)
        at_top = i == 0  # row-0 cells are implicit consume-b steps
        c = jnp.clip(j - i + unit_k, 0, W - 1)
        code = jnp.where(at_top, 1, code_at(i, c))
        a_ch = a_at(i)
        b_ch = b_at(j)
        out = jnp.where(
            code == 0,
            jnp.where(a_ch == b_ch, 0, 1),
            code + 1,  # 1->2 consume-b, 2->3 consume-a, 3->4 transpose
        ).astype(jnp.int8)
        out = jnp.where(active, out, jnp.int8(-1))
        di = jnp.where(
            code == 0, 1, jnp.where(code == 2, 1, jnp.where(code == 3, 2, 0))
        )
        dj = jnp.where(
            code == 0, 1, jnp.where(code == 1, 1, jnp.where(code == 3, 2, 0))
        )
        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        return (i, j), out

    (_, _), seq = lax.scan(body, (m0, n0), None, length=steps)
    return seq.T, steps


@partial(
    jax.jit,
    static_argnames=("unit_k", "max_m", "costs_t"),
)
def band_trace_batch(
    a_pad: jnp.ndarray,  # [B, max_m] int32 (see band_scan_distance)
    b_pad: jnp.ndarray,  # [B, max_m + W] int32
    m: jnp.ndarray,  # [B] int32
    n: jnp.ndarray,  # [B] int32
    *,
    unit_k: int,
    max_m: int,
    costs_t: Tuple[int, int, int, int, bool],
):
    """Batched banded distance WITH device-side traceback walk.

    One XLA program: the row wavefront emits per-cell argmin codes (kept in
    device memory — [max_m, B, W] never crosses to the host), then a second
    scan walks every pair's traceback back from (m, n) simultaneously,
    vectorized across the batch.  This is the batched-first analog of the
    reference's in-core traceback (create_levenshtein_simd_core!,
    reference levenshtein.rs:1080-1089, 1197-1281): the walk is data
    movement the device does at memory speed, and the host receives only
    the compact [B, steps] edit streams.

    Returns (dist [B] int32, seq [B, steps] int8, steps):
    seq codes are in REVERSE walk order (from (m, n) back to (0, 0)):
    0 Match, 1 Mismatch, 2 consume-b, 3 consume-a, 4 Transpose, -1 done.
    `steps = 2*max_m + unit_k + 1` bounds every walk since n <= m + unit_k.
    """
    W = 2 * unit_k + 1
    B = a_pad.shape[0]
    dist, codes = band_scan_distance(
        a_pad, b_pad, m, n,
        unit_k=unit_k, max_m=max_m, costs_t=costs_t, trace_on=True,
    )
    p_arr = jnp.arange(B, dtype=jnp.int32)
    codes_flat = codes.astype(jnp.int32).reshape(-1)  # [max_m * B * W]
    a_flat = a_pad.reshape(-1)
    b_flat = b_pad.reshape(-1)
    bw = max_m + W

    seq, steps = _walk_scan(
        lambda i, c: codes_flat[(jnp.maximum(i - 1, 0) * B + p_arr) * W + c],
        lambda i: a_flat[p_arr * max_m + jnp.maximum(i - 1, 0)],
        lambda j: b_flat[p_arr * bw + jnp.clip(unit_k + j - 1, 0, bw - 1)],
        m.astype(jnp.int32), n.astype(jnp.int32),
        unit_k=unit_k, max_m=max_m,
    )
    return dist, seq, steps


def decode_walked_batch(
    seq: np.ndarray,  # [B, steps] int8, reverse walk order, -1 padded
    swaps: List[bool],
) -> List[List[Edit]]:
    """Batched RLE decode of device-walked edit streams: one numpy pass
    finds every run boundary across the whole batch (a separator column
    between rows prevents cross-pair runs), then Python touches only the
    runs (~a handful per pair) instead of every step."""
    B, steps = seq.shape
    fwd = seq[:, ::-1]  # forward order, -1 padding now at the front
    sep = np.full((B, 1), -3, dtype=fwd.dtype)
    flat = np.ascontiguousarray(np.hstack([sep, fwd])).reshape(-1)
    cuts = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate(([0], cuts))
    ends = np.concatenate((cuts, [flat.size]))
    codes = flat[starts]
    width = steps + 1
    out: List[List[Edit]] = [[] for _ in range(B)]
    for s, e, c in zip(starts, ends, codes):
        if c < 0:
            continue
        p = s // width
        swap = swaps[p]
        if c == 0:
            et = EditType.Match
        elif c == 1:
            et = EditType.Mismatch
        elif c == 2:
            et = EditType.BGap if swap else EditType.AGap
        elif c == 3:
            et = EditType.AGap if swap else EditType.BGap
        else:
            et = EditType.Transpose
        out[p].append(Edit(edit=et, count=int(e - s)))
    return out


def prepare_band_inputs(
    a_list: List[np.ndarray],
    b_list: List[np.ndarray],
    unit_k: int,
    max_m: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a batch of (a, b) byte arrays (each with len(a) <= len(b)) into the
    fixed-shape int32 buffers band_scan_distance expects."""
    W = 2 * unit_k + 1
    B = len(a_list)
    a_pad = np.full((B, max_m), -1, dtype=np.int32)
    b_pad = np.full((B, max_m + W), -1, dtype=np.int32)
    m = row_lengths(a_list).astype(np.int32)
    n = row_lengths(b_list).astype(np.int32)
    fill_rows(a_pad, a_list, m, np.zeros(B, np.int64))
    fill_rows(b_pad, b_list, n, np.full(B, unit_k, np.int64))
    return a_pad, b_pad, m, n


def row_lengths(rows) -> np.ndarray:
    """int64 lengths of a batch's strings (a 2-D array's rows all have its
    width)."""
    if isinstance(rows, np.ndarray) and rows.ndim == 2:
        return np.full(rows.shape[0], rows.shape[1], np.int64)
    return np.fromiter((len(x) for x in rows), np.int64, len(rows))


def fill_rows(dst: np.ndarray, rows, lens: np.ndarray, offs: np.ndarray):
    """dst[p, offs[p] : offs[p] + lens[p]] = rows[p] for every row: one
    stacked copy when all rows share their length and offset (the common
    batch), else a per-row copy."""
    if not len(rows):
        return
    if (lens == lens[0]).all() and (offs == offs[0]).all():
        o, n = int(offs[0]), int(lens[0])
        if n:
            dst[: len(rows), o:o + n] = np.stack(rows)
        return
    for p, (x, o) in enumerate(zip(rows, offs.tolist())):
        dst[p, o:o + len(x)] = x


def decode_traceback(
    codes: np.ndarray,  # [max_m, W] uint8 for ONE pair
    a: np.ndarray,
    b: np.ndarray,
    unit_k: int,
    swap: bool,
) -> List[Edit]:
    """Walk the banded traceback codes back from (m, n), RLE-encoding edits.

    Mirrors the scalar banded walk (reference levenshtein.rs:558-606):
    code 0 steps diagonally (Match/Mismatch), 1 consumes b (AGap unswapped),
    2 consumes a (BGap unswapped), 3 steps a transpose.  Rows at i == 0 are
    implicit consume-b steps (the init row, reference levenshtein.rs:450-456).
    """
    res: List[Edit] = []
    i, j = len(a), len(b)

    def push(e: EditType) -> None:
        if res and res[-1].edit == e:
            res[-1] = Edit(edit=e, count=res[-1].count + 1)
        else:
            res.append(Edit(edit=e, count=1))

    a_gap = EditType.BGap if swap else EditType.AGap  # consumes b
    b_gap = EditType.AGap if swap else EditType.BGap  # consumes a

    while i > 0 or j > 0:
        if i == 0:
            j -= 1
            push(a_gap)
            continue
        c = j - i + unit_k
        code = int(codes[i - 1, c])
        if code == 0:
            i -= 1
            j -= 1
            push(EditType.Match if a[i] == b[j] else EditType.Mismatch)
        elif code == 1:
            j -= 1
            push(a_gap)
        elif code == 2:
            i -= 1
            push(b_gap)
        else:
            i -= 2
            j -= 2
            push(EditType.Transpose)

    res.reverse()
    return res
