"""Multi-word bit-vectors of uint32 words, shared by the bit-parallel engines.

A bit-vector of NW*32 bits is a Python list of NW uint32 arrays, word 0
holding the lowest bits.  The helpers are plain `jax.numpy` arithmetic, so
the same recurrence runs on whole [B] arrays in XLA and on one block of
lanes inside a Pallas kernel (through Triton on the GPU): the kernel and its
plain twin share every bit operation.  Each kernel states its own word
limit (`myers_distance.MAX_WORDS`, `myers_search.MAX_WORDS`).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

WORD = 32
ALL_ONES = 0xFFFFFFFF


def n_words(bits: int) -> int:
    """Words needed for `bits` bits."""
    return -(-max(bits, 1) // WORD)


def full(shape, value) -> jnp.ndarray:
    return jnp.full(shape, value, jnp.uint32)


def bnot(x):
    return [~w for w in x]


def band(x, y):
    return [a & b for a, b in zip(x, y)]


def bor(x, y):
    return [a | b for a, b in zip(x, y)]


def bxor(x, y):
    return [a ^ b for a, b in zip(x, y)]


def shl1(x, bit0):
    """x << 1 across words; `bit0` (0 or 1) fills bit 0."""
    out = []
    carry = jnp.uint32(bit0) if isinstance(bit0, int) else bit0
    for w in x:
        out.append((w << 1) | carry)
        carry = w >> 31
    return out


def shr1(x, top):
    """x >> 1 across words; `top` (0 or 1) fills the highest bit."""
    out = []
    for i, w in enumerate(x):
        if i + 1 < len(x):
            hi = x[i + 1] << 31
        elif isinstance(top, int):
            hi = jnp.uint32(top << 31)
        else:
            hi = top << 31
        out.append((w >> 1) | hi)
    return out


def add(x, y):
    """x + y across words (ripple carry; the carry out of the top word is
    dropped)."""
    out = []
    c = None
    for a, b in zip(x, y):
        s = a + b
        if c is None:
            c = (s < a).astype(jnp.uint32)
        else:
            s2 = s + c
            c = ((s < a) | (s2 < s)).astype(jnp.uint32)
            s = s2
        out.append(s)
    return out


def low_mask(nbits, nw: int):
    """Per-lane mask of the lowest `nbits` bits (int32 array, clipped to
    [0, nw*32]) as nw words."""
    out = []
    for w in range(nw):
        nb = jnp.clip(nbits - WORD * w, 0, WORD)
        part = (jnp.uint32(1) << jnp.minimum(nb, WORD - 1).astype(jnp.uint32)) - 1
        out.append(jnp.where(nb >= WORD, jnp.uint32(ALL_ONES), part))
    return out


def popcount(x) -> jnp.ndarray:
    """Total set bits across the words, as int32."""
    tot = None
    for w in x:
        # int32 popcount: Triton lowers it to __nv_popc, not the uint32 form
        c = lax.population_count(lax.bitcast_convert_type(w, jnp.int32))
        tot = c if tot is None else tot + c
    return tot


def zero_byte_nibble(x):
    """4-bit mask of the zero bytes of each uint32 (bit s set iff byte s of
    x is 0): the exact SWAR zero-byte test, then a multiply that gathers
    the four byte flags into consecutive bits."""
    t = ((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x
    z = ~(t | 0x7F7F7F7F)  # 0x80 in every zero byte
    return (((z >> 7) * 0x00204081) >> 21) & 0xF
