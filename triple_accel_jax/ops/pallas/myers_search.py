"""Bit-parallel approximate search (unit and rdamerau costs): a Pallas
kernel through Triton for the GPU, the same recurrence in plain XLA, and the
device-side haystack windowing both engines read.

The classical column-oriented Myers 1999 bit-vector search: the DP column
over the needle is NW uint32 words (`words.py`), Eq comes from a per-needle
Peq table (Peq[c] = bits i with needle[i] == c, 256 x NW words), and each
lane walks one haystack segment, so the column loop runs inside the kernel
with the whole column in registers.  The haystack is cut into overlapping
segments (halo = the longest window a cost-<=k match can span), so every
candidate is computed exactly by the segment that owns its end position.

This is the distance half of `levenshtein_search*` for LEVENSHTEIN_COSTS
and RDAMERAU_COSTS: `damerau=True` adds the transposition seed term to the
carry chain, and `anchored=True` turns on the +1 row-0 boundary (D[0][j] =
j), the only difference between substring and prefix-anchored search in
this representation.  It emits the end-position distances D[m][t]; the
reference's maximize-length tie-break is recovered afterwards only where
D <= k, by replaying the scalar oracle (see levenshtein.py).

Multi-needle ("dictionary") search runs same-length needles as one launch:
a grid axis over needles, each program reading its needle's Peq table.

Output layout: dist [num_needles * OUT, C_pad] int32 with OUT = seg_len + 1
— row n*OUT + t holds D[m][t] of needle n for segment (column) c; segment c
starts at global position c*own_len - halo and owns end positions
(c*own_len, c*own_len + own_len].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import words as W

__all__ = [
    "BLOCK",
    "MAX_WORDS",
    "ROW_BLOCK",
    "search_plan",
    "search_halo",
    "search_own_len",
    "seg_count",
    "chunk_raw",
    "device_windows",
    "device_pack_segs",
    "prepare_peq",
    "myers_search",
    "myers_search_jnp",
    "myers_search_block_mins",
    "myers_search_block_mins_from_hay",
    "myers_gather_blocks",
    "collect_hits",
]

BLOCK = 128  # segments per Triton program: one segment per thread at 4 warps
ROW_BLOCK = 512  # rows per candidate block in the two-phase hit fetch
UNROLL = 4  # haystack chars per loop step (loads issue ahead of the chain)
# segments per launch worth aiming for: 2^18 lanes = 2048 programs of 128,
# about 16 per SM of an H100's 132 — enough warps to hide the load latency
TARGET_LANES = 1 << 18
# words per needle (needles <= 256 chars); longer needles run the scan
# wavefront.  Registers do not bind: the compiled kernel holds 48 (unit
# costs) / 64 (rdamerau) registers at 8 words and 140 / 214 at 32, with no
# spills at any width.  The cold compile does, and every new needle length
# pays it (needle_len is static): the first call of a 16 MB search took
# 5.0 / 3.3 s at 8 words, 11.5 / 17.9 s at 16, 30.2 / 60.4 s at 24 and
# 67.6 / 131.1 s at 32, while the kernel stayed 11-47x ahead of the scan
# (NVIDIA H100 80GB HBM3, 700 W power limit).
MAX_WORDS = 8
_SENTINEL = 1 << 30


def search_plan(needle_len: int):
    """NW words for a needle of `needle_len` chars; None when empty or past
    the word limit (MAX_WORDS)."""
    if needle_len < 1:
        return None
    NW = W.n_words(needle_len)
    return NW if NW <= MAX_WORDS else None


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _pow2_at_least(x: int, minimum: int) -> int:
    v = max(x, minimum)
    return 1 << (v - 1).bit_length()


def search_halo(span: int, n: int) -> int:
    """Segment overlap for a window span: rounded up to 32 chars so the
    segment length (a static shape) is shared by nearby (m, k) and stays a
    multiple of UNROLL.  A larger overlap is still exact."""
    return _round_up(max(min(span, n), 0), 32)


def search_own_len(n: int, halo: int) -> int:
    """Owned chars per segment: enough segments to fill the card
    (TARGET_LANES), owned length >= 4*halo so the halo recompute stays
    under 25%, and never longer than the haystack needs."""
    own = _pow2_at_least(-(-n // TARGET_LANES), 128)
    own = max(own, _pow2_at_least(4 * halo, 128))
    return min(own, _pow2_at_least(max(n, 1), 128))


def seg_count(n: int, own_len: int) -> int:
    """Number of segments of an n-char haystack."""
    return max(1, -(-n // own_len))


def chunk_raw(hay: np.ndarray, halo: int, own_len: int):
    """Host reference of `device_windows`: ([num, halo+own_len] uint8
    strided view, num).  Row c = global positions [c*own_len - halo,
    c*own_len + own_len), zero padding outside the haystack.

    Pad-byte caveat: chunk 0's FRONT halo is synthetic zeros, so a needle
    containing 0x00 can match it and deflate distances at owned positions
    gpos <= halo; callers re-verify those hits against the oracle."""
    n = len(hay)
    num = seg_count(n, own_len)
    seg_len = halo + own_len
    padded = np.zeros(halo + num * own_len + seg_len, dtype=np.uint8)
    padded[halo: halo + n] = hay
    view = np.lib.stride_tricks.sliding_window_view(padded, seg_len)
    return view[::own_len][:num], num


def device_windows(hay: jnp.ndarray, *, halo: int, own_len: int, num: int,
                   front: jnp.ndarray | None = None):
    """`chunk_raw` on device: [num, halo+own_len] uint8 overlapping windows
    of the zero-padded haystack, built from ceil(seg_len/own_len) shifted
    contiguous reshapes (no gather).  The raw haystack is then the only
    host->device transfer a search needs.

    `front` optionally fills the first `halo` positions with real data
    instead of synthetic zeros — the sharded path passes the left
    neighbour's tail here."""
    seg_len = halo + own_len
    total = halo + num * own_len + seg_len
    padded = jnp.zeros((total,), jnp.uint8)
    if front is not None and halo > 0:
        padded = lax.dynamic_update_slice(padded, front.astype(jnp.uint8), (0,))
    padded = lax.dynamic_update_slice(padded, hay.astype(jnp.uint8), (halo,))
    nb = -(-seg_len // own_len)
    blocks = [
        lax.slice(padded, (i * own_len,), ((i + num) * own_len,))
        .reshape(num, own_len)
        for i in range(nb)
    ]
    win = blocks[0] if nb == 1 else jnp.concatenate(blocks, axis=1)
    return win[:, :seg_len]


def transpose_windows(win: jnp.ndarray) -> jnp.ndarray:
    """[num, seg_len] windows -> [seg_len, C_pad] (one segment per lane,
    lanes padded with empty segments to a multiple of BLOCK)."""
    num = win.shape[0]
    cp = _round_up(max(num, 1), BLOCK)
    return jnp.pad(win, ((0, cp - num), (0, 0))).T


@partial(jax.jit, static_argnames=("halo", "own_len", "num"))
def device_pack_segs(hay, *, halo: int, own_len: int, num: int):
    """Raw haystack in, [seg_len, C_pad] segment pack out, all on device
    (PackedHaystack's builder)."""
    return transpose_windows(
        device_windows(hay, halo=halo, own_len=own_len, num=num))


def prepare_peq(needles, needle_len: int) -> np.ndarray:
    """Peq tables of same-length needles: [num, NW*256] uint32, word w of
    Peq[c] at column w*256 + c."""
    NW = search_plan(needle_len)
    assert NW is not None
    out = np.zeros((len(needles), NW, 256), dtype=np.uint32)
    for n, nd in enumerate(needles):
        nd = np.asarray(nd, dtype=np.uint8)
        assert nd.size == needle_len
        for i, c in enumerate(nd.tolist()):
            out[n, i // W.WORD, c] |= np.uint32(1 << (i % W.WORD))
    return out.reshape(len(needles), NW * 256)


def _search_step(state, eq, *, m: int, anchored: bool, damerau: bool):
    """One haystack column.  state = (Pv, Mv, S[, EqP, D0P])."""
    if damerau:
        # restricted-Damerau extension (RDAMERAU_COSTS): a transposition
        # at (i, t) is a diagonal-zero SEED exactly when p[i]=txt[t-1],
        # p[i-1]=txt[t], and the previous column's diagonal delta at row
        # i-1 was +1 (NOT D0_prev) — then D[i][t] <= D[i-2][t-2]+1 =
        # D[i-1][t-1].  Seeds join the carry chain and the Pv/Mv update
        # switches to the full-D0 form.
        Pv, Mv, S, EqP, D0P = state
        tr = W.band(W.band(EqP, W.shl1(eq, 0)), W.shl1(W.bnot(D0P), 0))
        seeds = W.bor(eq, tr)
    else:
        Pv, Mv, S = state
        seeds = eq
    Xh = W.bor(W.bxor(W.add(W.band(seeds, Pv), Pv), Pv), seeds)
    Ph = W.bor(Mv, W.bnot(W.bor(Xh, Pv)))
    Mh = W.band(Pv, Xh)
    top, bit = (m - 1) // W.WORD, (m - 1) % W.WORD
    S = (S + ((Ph[top] >> bit) & 1).astype(jnp.int32)
         - ((Mh[top] >> bit) & 1).astype(jnp.int32))
    PhS = W.shl1(Ph, 1 if anchored else 0)
    MhS = W.shl1(Mh, 0)
    if damerau:
        D0 = W.bor(Xh, Mv)  # Mv still holds the previous column's
        Pv = W.bor(MhS, W.bnot(W.bor(D0, PhS)))
        Mv = W.band(PhS, D0)
        return (Pv, Mv, S, eq, D0)
    Xv = W.bor(eq, Mv)
    Pv = W.bor(MhS, W.bnot(W.bor(Xv, PhS)))
    Mv = W.band(PhS, Xv)
    return (Pv, Mv, S)


def _init_state(shape, m: int, NW: int, damerau: bool):
    ones = W.full(shape, W.ALL_ONES)
    zero = W.full(shape, 0)
    s0 = jnp.full(shape, m, jnp.int32)
    if damerau:
        return ([ones] * NW, [zero] * NW, s0, [zero] * NW, [zero] * NW)
    return ([ones] * NW, [zero] * NW, s0)


@partial(jax.jit, static_argnames=("needle_len", "seg_len", "anchored",
                                   "damerau"))
def myers_search_jnp(peq, seg_t, *, needle_len: int, seg_len: int,
                     anchored: bool = False, damerau: bool = False):
    """The kernel's recurrence in plain XLA, one `lax.scan` over haystack
    columns on [num_needles, C_pad] lane arrays, with `myers_search`'s
    inputs and output: the witness the tests and the chip smoke run
    compare the kernel with (the public API never calls it)."""
    m = needle_len
    NW = search_plan(m)
    num = peq.shape[0]
    cp = seg_t.shape[1]
    tables = [peq[:, w * 256:(w + 1) * 256] for w in range(NW)]

    def col(st, chars):
        c = chars.astype(jnp.int32)
        eq = [jnp.take(tb, c, axis=1) for tb in tables]
        st = _search_step(st, eq, m=m, anchored=anchored, damerau=damerau)
        return st, st[2]

    st0 = _init_state((num, cp), m, NW, damerau)
    _, ys = lax.scan(col, st0, seg_t[:seg_len])
    rows = jnp.concatenate([st0[2][None], ys], axis=0)  # [OUT, num, cp]
    return rows.transpose(1, 0, 2).reshape(num * (seg_len + 1), cp)


@partial(jax.jit, static_argnames=("needle_len", "seg_len", "anchored",
                                   "damerau", "interpret"))
def myers_search(peq, seg_t, *, needle_len: int, seg_len: int,
                 anchored: bool = False, damerau: bool = False,
                 interpret: bool = False):
    """D[m][t] for every (needle, segment, end position t in [0,
    seg_len]): [num_needles * (seg_len+1), C_pad] int32 (layout in the
    module docstring).  One Pallas kernel through Triton: grid (needles,
    segment blocks), the column loop inside the kernel, UNROLL columns per
    loop step.  seg_len must be a multiple of UNROLL."""
    assert seg_len % UNROLL == 0, seg_len
    m = needle_len
    NW = search_plan(m)
    num = peq.shape[0]
    cp = seg_t.shape[1]
    OUT = seg_len + 1

    def kernel(peq_ref, seg_ref, out_ref):
        st = _init_state((BLOCK,), m, NW, damerau)
        out_ref[0, :] = st[2]

        def body(tb, st):
            t0 = UNROLL * tb
            eqs = []
            for r in range(UNROLL):
                c = seg_ref[t0 + r, :].astype(jnp.int32)
                eqs.append([peq_ref[w * 256 + c] for w in range(NW)])
            for r in range(UNROLL):
                st = _search_step(st, eqs[r], m=m, anchored=anchored,
                                  damerau=damerau)
                out_ref[t0 + r + 1, :] = st[2]
            return st

        lax.fori_loop(0, seg_len // UNROLL, body, st)

    out = pl.pallas_call(
        kernel,
        grid=(num, cp // BLOCK),
        in_specs=[
            pl.BlockSpec((None, NW * 256), lambda n, g: (n, 0)),
            pl.BlockSpec((seg_len, BLOCK), lambda n, g: (0, g)),
        ],
        out_specs=pl.BlockSpec((None, OUT, BLOCK), lambda n, g: (n, 0, g)),
        out_shape=jax.ShapeDtypeStruct((num, OUT, cp), jnp.int32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="myers_search",
    )(peq, seg_t[:seg_len])
    return out.reshape(num * OUT, cp)


def _block_mins(dist):
    R = dist.shape[0]
    dp = jnp.pad(dist, ((0, (-R) % ROW_BLOCK), (0, 0)),
                 constant_values=_SENTINEL)
    return jnp.min(dp.reshape(-1, ROW_BLOCK, dist.shape[1]), axis=1)


@partial(jax.jit, static_argnames=("needle_len", "seg_len", "anchored",
                                   "damerau", "interpret"))
def myers_search_block_mins(peq, seg_t, *, needle_len: int, seg_len: int,
                            anchored: bool = False, damerau: bool = False,
                            interpret: bool = False):
    """Phase 1 of the two-phase hit fetch: run the search, keep the
    distances on device, return (dist, per-ROW_BLOCK column minima).  The
    host then fetches only the row blocks that can hold hits
    (`myers_gather_blocks`) — the full array is 4 bytes per haystack
    byte."""
    dist = myers_search(peq, seg_t, needle_len=needle_len, seg_len=seg_len,
                        anchored=anchored, damerau=damerau,
                        interpret=interpret)
    return dist, _block_mins(dist)


@partial(jax.jit, static_argnames=("needle_len", "halo", "own_len", "num",
                                   "anchored", "damerau", "interpret"))
def myers_search_block_mins_from_hay(hay, peq, *, needle_len: int, halo: int,
                                     own_len: int, num: int,
                                     anchored: bool = False,
                                     damerau: bool = False,
                                     interpret: bool = False):
    """`myers_search_block_mins` fed from the raw haystack: windowing and
    the transpose run on device inside the same jit."""
    seg_t = transpose_windows(
        device_windows(hay, halo=halo, own_len=own_len, num=num))
    return myers_search_block_mins(
        peq, seg_t, needle_len=needle_len, seg_len=halo + own_len,
        anchored=anchored, damerau=damerau, interpret=interpret)


@jax.jit
def myers_gather_blocks(dist: jnp.ndarray, row_block: jnp.ndarray,
                        col: jnp.ndarray):
    """Phase 2: fetch the ROW_BLOCK-row slices of selected (row block,
    column) cells only."""
    R = dist.shape[0]
    dp = jnp.pad(dist, ((0, (-R) % ROW_BLOCK), (0, 0)),
                 constant_values=_SENTINEL)
    return dp.reshape(-1, ROW_BLOCK, dist.shape[1])[row_block, :, col]


def fetch_candidate_blocks(dist, mins, k: int, col_lo: int = 0,
                           ncols: int | None = None):
    """Two-phase fetch on the host side: (blocks, rb, cols) of the row
    blocks whose minimum is <= k, within columns [col_lo, col_lo+ncols);
    cols are relative to col_lo.  The gather is padded to a power of two
    of blocks to bound recompiles."""
    mins = np.asarray(mins)
    if ncols is not None:
        mins = mins[:, col_lo:col_lo + ncols]
    rb, cols = np.nonzero(mins <= k)
    if rb.size == 0:
        return None, rb, cols
    pad_n = _pow2_at_least(rb.size, 8)
    rb_p = np.full(pad_n, rb[-1], np.int32)
    cols_p = np.full(pad_n, cols[-1] + col_lo, np.int32)
    rb_p[: rb.size] = rb
    cols_p[: cols.size] = cols + col_lo
    return np.asarray(myers_gather_blocks(dist, rb_p, cols_p)), rb, cols


def collect_hits(
    blocks: np.ndarray,  # [>=nb, ROW_BLOCK] gathered candidate blocks
    rb: np.ndarray,  # [nb] row-block index per gathered block
    cols: np.ndarray,  # [nb] segment (column) index per gathered block
    k: int,
    *,
    OUT: int,
    C: int,
    halo: int,
    own_len: int,
    limit_pos: int,
    num_needles: int = 1,
    own_pos0: bool = True,
):
    """Map gathered candidate blocks to owned global hit positions, as
    numpy array math.  Returns (ni, gpos, d) int64 arrays sorted by
    (needle, end position) for every in-bounds owned position with
    distance <= k.

    `own_pos0=False` drops segment 0's extra claim on end position 0 —
    used by the sharded-haystack path, where a shard's position 0 is the
    previous shard's last owned position (owner-by-end rule)."""
    z = np.empty(0, dtype=np.int64)
    if blocks is None:
        return z, z.copy(), z.copy()
    nb = rb.size
    blk = blocks[:nb]
    bi, off = np.nonzero(blk <= k)
    d = blk[bi, off].astype(np.int64)
    c = cols[bi].astype(np.int64)
    r = rb[bi].astype(np.int64) * ROW_BLOCK + off
    ni, t = r // OUT, r % OUT
    gpos = c * own_len - halo + t
    owned = (t > halo) & (t <= halo + own_len)
    if own_pos0:
        owned |= (c == 0) & (t == halo)
    ok = ((ni < num_needles) & (c < C) & owned & (gpos >= 0)
          & (gpos <= limit_pos))
    ni, gpos, d = ni[ok], gpos[ok], d[ok]
    order = np.lexsort((gpos, ni))
    return ni[order], gpos[order], d[order]
