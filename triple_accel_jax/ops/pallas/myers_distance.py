"""Bit-parallel banded Levenshtein distance (unit costs): a Pallas kernel
through Triton for the GPU, and the same recurrence in plain XLA.

The fast path behind `levenshtein_k_batch` and the `levenshtein*` calls for
LEVENSHTEIN_COSTS.  A Myers-1999-style bit-vector wavefront, row-oriented
and banded:

* one string pair per lane; the row loop runs inside the kernel, so the
  band state stays in registers for all max_m rows;
* the band of row i is a bit-vector of horizontal deltas D[i, j] -
  D[i, j-1] over the window j = i - ukL + p, p in [0, NW*32), held as NW
  uint32 words (`words.py`);
* **asymmetric k+1 band**: a path of cost <= k satisfies |j-i| +
  |delta-(j-i)| <= k, so the window needs j-i in [-ukL, k-ukL] with ukL =
  (k-delta)//2 — k+1 cells, not the symmetric 2k+1.  ukL varies per pair;
  the window offset is baked into the b buffer (b_buf[ukL + x] = b[x]), so
  every lane reads its row-i window at the same buffer offset i-1;
* Eq bits come from byte compares on packed words: 4 chars per uint32,
  one XOR against the row's char replicated 4 times, an exact SWAR
  zero-byte test, and a multiply that gathers the 4 flags into a nibble
  (`words.zero_byte_nibble`).  Rows run 4 per loop step so each row's
  byte phase is static;
* the score is anchored at the window's left edge (A_i = D[i, i-ukL-1])
  and D[m, n] adds the popcount of row m's deltas up to column n.

Boundary conventions: the window slides right one column per row;
shifted-in out-of-band deltas are +1 (never below the truth, so in-band
values are exact whenever the true distance <= k and never
under-estimates otherwise); virtual columns j <= 0 force both deltas to
+1, keeping the anchor chain consistent.  Eq bits past the k+1 cells the
band needs are zero (those cells compute as mismatches: again never below
the truth).  Pads carry no sentinel: a pad byte influences only rows i > m
(the result latches at i == m) or columns j > n, and every dependence
moves rightward in j, so it never reaches the read-out j <= n.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..band_scan import fill_rows, row_lengths
from . import words as W

__all__ = [
    "BLOCK",
    "distance_plan",
    "prepare_myers_inputs",
    "myers_device_pack",
    "myers_distance_jnp",
    "myers_distance_triton",
]

BLOCK = 128  # pairs per Triton program: one pair per thread at 4 warps
# words per band (k <= 127).  Set by compile time, not registers (39, 47
# and 80 registers at 1, 2 and 4 words, no spills; NVIDIA H100 80GB HBM3,
# 700 W power limit): the loop body unrolls 4 rows x MAX_WORDS words, and
# Triton's compile time grows superlinearly with it while run time grows
# linearly (H100 80GB HBM3 at a 400 W power limit, 196,608 pairs x 1000 B:
# 2.3 s / 2.8 ms at 1 word, 21 s / 6.0 ms at 4, 131 s / 12.3 ms at 8).
# Wider bands run the scan wavefront.
MAX_WORDS = 4


def distance_plan(k: int):
    """(NW words, weq Eq bits, n_pk packed b words per 4-row step) for
    threshold k; None past MAX_WORDS."""
    weq = k + 1
    NW = W.n_words(weq)
    if NW > MAX_WORDS:
        return None
    return NW, weq, -(-(3 + weq) // 4)


def _buffer_rows(k: int, max_m: int):
    """(a words, b words) per pair in the packed layouts."""
    NW, weq, n_pk = distance_plan(k)
    return max_m // 4, max_m // 4 + n_pk


def _row_eq(ac, bws, ph: int, NW: int, weq: int):
    """Eq words of one row: bit P set iff b_buf[s0 + P] == the row's char,
    where bws are the packed b words from s0 - ph on (ph = s0 % 4)."""
    rep = ac * jnp.uint32(0x01010101)
    need = -(-(ph + weq) // 4)
    nibs = [W.zero_byte_nibble(bw ^ rep) for bw in bws[:need]]
    eq = []
    for w in range(NW):
        lo = None
        for j in range(8):
            q = 8 * w + j
            if q < len(nibs):
                part = nibs[q] << (4 * j) if j else nibs[q]
                lo = part if lo is None else lo | part
        if lo is None:
            lo = jnp.zeros_like(ac)
        if ph:
            lo = lo >> ph
            if 8 * w + 8 < len(nibs):
                lo = lo | (nibs[8 * w + 8] << (32 - ph))
        eq.append(lo)
    top = weq - W.WORD * (NW - 1)
    if top < W.WORD:
        eq[-1] = eq[-1] & jnp.uint32((1 << top) - 1)
    return eq


def _dist_step(state, eq, i, m, ukl, virt: bool, NW: int):
    Ph, Mh, A, rP, rM, rA = state
    # anchor: A_i = D[i, i-ukL-1] = D[i-1, (i-1)-ukL] + 1
    A = A + (Ph[0] & 1).astype(jnp.int32) - (Mh[0] & 1).astype(jnp.int32) + 1
    PhI = W.shr1(Ph, 1)
    MhI = W.shr1(Mh, 0)
    if virt:
        # virtual columns j <= 0 are bits p <= ukL - i: clear spurious Eq
        # matches there first (a pad byte can equal a real NUL char), then
        # force both deltas to +1
        vmask = W.low_mask(ukl + 1 - i, NW)
        nv = W.bnot(vmask)
        eq = W.band(eq, nv)
    Xh = W.bor(eq, MhI)
    X = W.bor(W.bxor(W.add(W.band(eq, PhI), PhI), PhI), eq)
    Pv = W.bor(MhI, W.bnot(W.bor(X, PhI)))
    Mv = W.band(PhI, X)
    if virt:
        Pv = W.bor(Pv, vmask)
        Mv = W.band(Mv, nv)
    PvS = W.shl1(Pv, 1)
    MvS = W.shl1(Mv, 0)
    Ph = W.bor(MvS, W.bnot(W.bor(Xh, PvS)))
    Mh = W.band(PvS, Xh)
    if virt:
        Ph = W.bor(Ph, vmask)
        Mh = W.band(Mh, nv)
    at = i == m
    rP = [jnp.where(at, x, r) for x, r in zip(Ph, rP)]
    rM = [jnp.where(at, x, r) for x, r in zip(Mh, rM)]
    rA = jnp.where(at, A, rA)
    return (Ph, Mh, A, rP, rM, rA)


def _distance_rows(load_a, load_b, m, dlen, ukl, *, k: int, max_m: int):
    """The whole banded recurrence for a vector of lanes.  load_a(t) /
    load_b(t) return packed word row t of the a / b buffers."""
    NW, weq, n_pk = distance_plan(k)
    ones = W.full(m.shape, W.ALL_ONES)
    zero = W.full(m.shape, 0)
    A0 = -ukl - 1  # D[0, -ukL-1] on the virtual row D[0, j] = j
    # the latched read-out starts as row 0, which is the answer for m == 0
    state = ([ones] * NW, [zero] * NW, A0, [ones] * NW, [zero] * NW, A0)

    def body(t, st, virt):
        aw = load_a(t)
        bws = [load_b(t + j) for j in range(n_pk)]
        for ph in range(4):
            ac = (aw >> (8 * ph)) & 0xFF
            eq = _row_eq(ac, bws, ph, NW, weq)
            st = _dist_step(st, eq, 4 * t + ph + 1, m, ukl, virt, NW)
        return st

    # only rows i <= k//2 can touch virtual columns (ukL <= k//2)
    t_virt = min(-(-(k // 2 + 1) // 4), max_m // 4)
    state = lax.fori_loop(0, t_virt, partial(body, virt=True), state)
    state = lax.fori_loop(t_virt, max_m // 4, partial(body, virt=False),
                          state)
    _, _, _, rP, rM, rA = state
    # D[m, n] = A_m + sum of row m's deltas over bits p in [0, dlen + ukL]
    sel = W.low_mask(dlen + ukl + 1, NW)
    return rA + W.popcount(W.band(rP, sel)) - W.popcount(W.band(rM, sel))


def myers_device_pack(a_rows, b_rows, b_shift, *, k: int, max_m: int,
                      B: int):
    """Row-major uint8 uploads -> the packed transposed layouts
    [max_m/4, B] / [MB/4, B] uint32 (4 chars per word, little-endian),
    built on device (call inside a jit).  The uploads may be narrower than
    the buffers: a_rows lands at column 0, b_rows at column `b_shift` (an
    int32 scalar), and the rest is zero padding."""
    MP4, MB4 = _buffer_rows(k, max_m)
    a = lax.dynamic_update_slice(jnp.zeros((B, 4 * MP4), jnp.uint8),
                                 a_rows.astype(jnp.uint8), (0, 0))
    b = lax.dynamic_update_slice(jnp.zeros((B, 4 * MB4), jnp.uint8),
                                 b_rows.astype(jnp.uint8),
                                 (0, b_shift.astype(jnp.int32)))

    def pack(x, rows):
        x4 = x.reshape(B, rows, 4).astype(jnp.uint32)
        p = x4[..., 0] | (x4[..., 1] << 8) | (x4[..., 2] << 16) | (x4[..., 3] << 24)
        return p.T

    return pack(a, MP4), pack(b, MB4)


@partial(jax.jit, static_argnames=("k", "max_m"))
def myers_distance_jnp(a_rows, b_rows, m, dlen, ukl, b_shift, *, k: int,
                       max_m: int):
    """The recurrence in plain XLA: one `fori_loop` over 4-row steps on
    whole [B] lane vectors.  Takes `prepare_myers_inputs`' output; returns
    dist [B] int32."""
    a_p, b_p = myers_device_pack(a_rows, b_rows, b_shift, k=k, max_m=max_m,
                                 B=m.shape[0])
    return _distance_rows(
        lambda t: lax.dynamic_index_in_dim(a_p, t, 0, keepdims=False),
        lambda t: lax.dynamic_index_in_dim(b_p, t, 0, keepdims=False),
        m, dlen, ukl, k=k, max_m=max_m,
    )


@partial(jax.jit, static_argnames=("k", "max_m", "interpret"))
def myers_distance_triton(a_rows, b_rows, m, dlen, ukl, b_shift, *, k: int,
                          max_m: int, interpret: bool = False):
    """The recurrence as one Pallas kernel through Triton: a grid over
    blocks of BLOCK pairs, the row loop inside the kernel.  Takes
    `prepare_myers_inputs`' output (B a multiple of BLOCK); returns dist
    [B] int32."""
    B = m.shape[0]
    assert B % BLOCK == 0, B
    a_p, b_p = myers_device_pack(a_rows, b_rows, b_shift, k=k, max_m=max_m,
                                 B=B)
    MP4, MB4 = _buffer_rows(k, max_m)

    def kernel(a_ref, b_ref, m_ref, dl_ref, uk_ref, out_ref):
        out_ref[...] = _distance_rows(
            lambda t: a_ref[t, :], lambda t: b_ref[t, :],
            m_ref[...], dl_ref[...], uk_ref[...], k=k, max_m=max_m,
        )

    lane = pl.BlockSpec((BLOCK,), lambda g: (g,))
    return pl.pallas_call(
        kernel,
        grid=(B // BLOCK,),
        in_specs=[
            pl.BlockSpec((MP4, BLOCK), lambda g: (0, g)),
            pl.BlockSpec((MB4, BLOCK), lambda g: (0, g)),
            lane, lane, lane,
        ],
        out_specs=lane,
        out_shape=jax.ShapeDtypeStruct((B,), jnp.int32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="myers_distance",
    )(a_p, b_p, m, dlen, ukl)


def prepare_myers_inputs(a_list, b_list, k: int, max_m: int, ks=None,
                         lanes: int = BLOCK):
    """Pack a batch (len(a) <= len(b), len(b)-len(a) <= k_pair per pair)
    into the row-major uint8 uploads both engines take.

    `ks` optionally gives a per-pair threshold <= k (defaults to k); the
    pair's band is ukL = (k_pair - delta)//2 columns left of the diagonal
    and the rest of the window right of it, so b sits at column ukL of its
    buffer.  The batch is padded with empty pairs to a multiple of `lanes`
    (BLOCK, or BLOCK times the device count for a mesh).

    Returns (a_rows, b_rows, m, dlen, ukl, b_shift): [Bp, *] uint8 rows,
    [Bp] int32 lengths, deltas and left half-widths, and an int32 scalar.
    When every pair shares its lengths and ukL (a rectangular batch, e.g.
    rows of 2-D arrays) the rows are the strings themselves and b_shift is
    the common ukL: the device pads them to the buffers.  Otherwise the
    rows are the full [Bp, max_m] / [Bp, MB] buffers and b_shift is 0.
    """
    assert distance_plan(k) is not None, "k too large for the bit-parallel engine"
    assert max_m % 4 == 0
    MP4, MB4 = _buffer_rows(k, max_m)
    MB = 4 * MB4
    B = len(a_list)
    Bp = max(-(-B // lanes) * lanes, lanes)
    m = np.zeros(Bp, dtype=np.int32)
    dlen = np.zeros(Bp, dtype=np.int32)
    ukl = np.zeros(Bp, dtype=np.int32)
    if not B:
        return (np.zeros((Bp, max_m), np.uint8), np.zeros((Bp, MB), np.uint8),
                m, dlen, ukl, np.int32(0))
    la = row_lengths(a_list)
    lb = row_lengths(b_list)
    kp = (np.full(B, k, np.int64) if ks is None
          else np.minimum(np.asarray(ks, np.int64)[:B], k))
    delta = lb - la
    assert np.all((0 <= delta) & (delta <= kp) & (la <= max_m))
    uL = (kp - delta) // 2
    m[:B] = la
    dlen[:B] = delta
    ukl[:B] = uL
    if (la == la[0]).all() and (lb == lb[0]).all() and (uL == uL[0]).all():
        a_rows = _pad_batch(_as_2d(a_list, la[0]), Bp)
        b_rows = _pad_batch(_as_2d(b_list, lb[0]), Bp)
        return a_rows, b_rows, m, dlen, ukl, np.int32(uL[0])
    a_rows = np.zeros((Bp, max_m), dtype=np.uint8)
    b_rows = np.zeros((Bp, MB), dtype=np.uint8)
    fill_rows(a_rows, a_list, la, np.zeros(B, np.int64))
    fill_rows(b_rows, b_list, lb, uL)
    return a_rows, b_rows, m, dlen, ukl, np.int32(0)


def _as_2d(rows, width: int) -> np.ndarray:
    """Equal-length rows as one [B, width] uint8 array (no copy when they
    already are one)."""
    if isinstance(rows, np.ndarray) and rows.ndim == 2:
        return np.ascontiguousarray(rows, dtype=np.uint8)
    if width == 0:
        return np.zeros((len(rows), 0), np.uint8)
    return np.stack(rows).astype(np.uint8, copy=False)


def _pad_batch(rows: np.ndarray, Bp: int) -> np.ndarray:
    """Rows padded with zero rows to Bp (no copy when already Bp)."""
    if rows.shape[0] == Bp:
        return rows
    return np.pad(rows, ((0, Bp - rows.shape[0]), (0, 0)))
