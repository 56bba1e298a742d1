"""Device (XLA) kernels for Hamming distance and Hamming search.

Device replacements for the reference's HammingJewel vector routines:

* `count_mismatches` (reference src/jewel.rs:2320-2365, the 255-block
  cmpeq/sub accumulate) becomes a single fused XLA reduction
  `sum(a != b)` — no accumulator-overflow choreography is needed because
  the device reduces in int32 natively.
* `vector_count_mismatches` sliding search (reference src/jewel.rs:
  2369-2408 + hamming.rs:477-554) becomes a shift-and-accumulate over the
  needle: for each of the m needle offsets, one vectorized compare of the
  whole haystack against a broadcast needle byte.  All positions are
  computed in parallel lanes — the reference's scalar tail loop
  (hamming.rs:516-536) disappears because padding is masked, not zero
  filled (hence no null-byte restriction on the device path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "hamming_kernel",
    "hamming_search_block_mins",
    "hamming_gather_blocks",
    "BLOCK",
]


@partial(jax.jit, static_argnames=())
def hamming_kernel(a: jnp.ndarray, b: jnp.ndarray, length: jnp.ndarray):
    """Batched mismatch count.

    a, b: [B, L] int32 (sentinel-padded identically is NOT required — only
    the first `length` positions count).  Returns [B] int32.
    """
    idx = jnp.arange(a.shape[1], dtype=jnp.int32)[None, :]
    mism = (a != b) & (idx < length[:, None])
    return jnp.sum(mism, axis=1, dtype=jnp.int32)


BLOCK = 512  # positions per candidate block in the two-phase hit fetch


@partial(jax.jit, static_argnames=("needle_len",))
def hamming_search_block_mins(
    needle: jnp.ndarray,  # [needle_len] uint8/int32
    haystack: jnp.ndarray,  # [P] same dtype, P % BLOCK == 0, padded past n
    n: jnp.ndarray,  # scalar int32: true haystack length
    *,
    needle_len: int,
):
    """Phase 1 of the two-phase hit fetch: per-position counts (left in
    device memory) plus per-BLOCK minima (tiny, fetched by the host to
    locate candidate blocks).  Fetching per-position counts costs 4 bytes
    per haystack byte — on slow host links that fetch, not the compute,
    dominates; device-side `nonzero` compaction lowers to a sort, hence
    block minima."""
    P = haystack.shape[0]
    m = needle_len
    hay_ext = jnp.concatenate(
        [haystack, jnp.zeros((m,), haystack.dtype)]
    )

    def body(j, acc):
        shifted = lax.dynamic_slice_in_dim(hay_ext, j, P)
        return acc + jnp.where(shifted != needle[j], 1, 0).astype(jnp.int32)

    counts = lax.fori_loop(0, m, body, jnp.zeros((P,), jnp.int32))
    idx = jnp.arange(P, dtype=jnp.int32)
    counts = jnp.where(idx <= n - m, counts, jnp.int32(m + 1 + (1 << 20)))
    mins = jnp.min(counts.reshape(-1, BLOCK), axis=1)
    return counts, mins


@partial(jax.jit, static_argnames=())
def hamming_gather_blocks(counts: jnp.ndarray, block_idx: jnp.ndarray):
    """Phase 2: fetch only the BLOCK-sized slices that contain hits."""
    return counts.reshape(-1, BLOCK)[block_idx]
