"""Multi-device execution: DP pair batches and SP sharded-haystack search.

The reference is single-threaded (SURVEY.md §2.5); these are new,
first-class components of the framework:

* ``sharded_distance_step``: the distance wavefront over a pair batch whose
  leading axis is sharded across the mesh — pure data parallelism, zero
  collectives on the hot path, one ``psum`` for the match-count histogram.
* ``sharded_search_step``: the ring/CP analog.  Each device owns a
  contiguous haystack shard; a single ``lax.ppermute`` passes the last
  ``halo`` characters to the right neighbor (the neighbour pattern ring
  attention uses), then every device runs the search wavefront on its own
  (halo + shard) window.  A match is owned by the shard containing its end
  index, so results equal the single-device run exactly for all costs <= k.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.band_scan import band_scan_distance
from ..ops.search_scan import search_scan
from .mesh import DATA_AXIS, batch_sharding

__all__ = [
    "sharded_distance_step",
    "match_count_psum",
    "sharded_search_step",
    "assemble_sharded_search",
    "sharded_myers_distance",
    "shard_haystack",
    "sharded_myers_search_mins",
    "sharded_hamming_search_mins",
    "sharded_pack_segs",
    "sharded_myers_search_mins_packed",
    "collect_sharded_hits",
]


def sharded_distance_step(
    mesh: Mesh,
    a_pad: jnp.ndarray,
    b_pad: jnp.ndarray,
    m: jnp.ndarray,
    n: jnp.ndarray,
    *,
    unit_k: int,
    max_m: int,
    costs_t: Tuple[int, int, int, int, bool],
):
    """Banded distance over a batch sharded on the mesh's data axis.

    The scan is elementwise across the batch, so XLA partitions it with no
    communication; this function only pins the shardings.
    """
    sh = batch_sharding(mesh)
    args = [jax.device_put(x, sh) for x in (a_pad, b_pad, m, n)]
    dist, _ = band_scan_distance(
        *args, unit_k=unit_k, max_m=max_m, costs_t=costs_t, trace_on=False
    )
    return dist


def match_count_psum(mesh: Mesh, dist: jnp.ndarray, k: int) -> jnp.ndarray:
    """Global count of pairs within threshold k — an explicit cross-device
    ``psum`` reduction (BASELINE.json config 5 analog)."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(DATA_AXIS),
        out_specs=P(),
    )
    def count(local):
        c = jnp.sum((local <= k).astype(jnp.int32))
        return lax.psum(c[None], DATA_AXIS)

    return count(dist)[0]


def sharded_search_step(
    mesh: Mesh,
    needle: jnp.ndarray,  # [m] int32
    shards: jnp.ndarray,  # [D, S] int32 haystack shards (sentinel padded)
    shard_n: jnp.ndarray,  # [D] int32 valid chars per shard
    *,
    needle_len: int,
    halo: int,
    costs_t: Tuple[int, int, int, int, bool],
):
    """Search a haystack that lives sharded across the mesh.

    Each device holds one [S] shard.  One ppermute sends each shard's last
    `halo` characters to its right neighbor; device d then scans
    [halo_from_left | own shard] and reports (dist, length) for its owned
    end positions plus its local within-threshold count via psum.

    Returns (dist [D, S+1], length [D, S+1], sharded by device).  Entry
    (d, i) is the result for global end position d*S + i; entry (0, 0) is
    the global empty-prefix candidate; entries (d, 0) for d > 0 are
    duplicates of their left neighbor's last owned position and must be
    skipped by the host (owner-by-end rule).
    """
    m = needle_len
    D, S = shards.shape
    if halo > S:
        raise ValueError(
            f"halo ({halo}) must be <= shard size ({S}); use bigger shards "
            "or a smaller k"
        )
    seg_len = halo + S

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
        check_vma=False,
    )
    def step(needle_local, shard_local, n_local):
        # shard_local: [1, S]; pass our tail to the right neighbor
        idx = lax.axis_index(DATA_AXIS)
        ndev = lax.axis_size(DATA_AXIS)
        tail = shard_local[:, S - halo :] if halo > 0 else shard_local[:, :0]
        left_halo = lax.ppermute(
            tail,
            DATA_AXIS,
            [(d, (d + 1) % ndev) for d in range(ndev)],
        )
        # device 0 has no left neighbor: mask its halo to sentinel
        left_halo = jnp.where(idx > 0, left_halo, jnp.int32(-1))
        halo_eff = jnp.where(idx > 0, halo, 0)

        # build the local segment [halo_eff + S] at offset m+1, sentinel
        # padded: device 0 has no halo, so its shard starts at m+1 directly
        # (requires halo <= S so the shard write fully covers the halo slot)
        width = seg_len + 2 * m + 2
        seg = jnp.full((1, width), -1, jnp.int32)
        seg = lax.dynamic_update_slice(seg, left_halo, (0, m + 1))
        seg = lax.dynamic_update_slice(seg, shard_local, (0, m + 1 + halo_eff))
        # chars seen by this device: full halo (when idx>0) + own valid n.
        # contract: every shard except the last is completely full, so the
        # left neighbor's tail is always real data when idx > 0.
        local_n = halo_eff + n_local
        seg_off = jnp.reshape(idx * S - halo_eff, (1,))

        dist, length = search_scan(
            needle_local,
            seg,
            local_n,
            seg_off,
            needle_len=m,
            seg_len=seg_len,
            costs_t=costs_t,
            anchored=False,
        )
        # owned end positions: local i in [halo_eff, halo_eff + S]
        own_dist = lax.dynamic_slice(dist, (0, halo_eff), (1, S + 1))
        own_len = lax.dynamic_slice(length, (0, halo_eff), (1, S + 1))
        return own_dist, own_len

    sh2 = NamedSharding(mesh, P(DATA_AXIS, None))
    sh1 = NamedSharding(mesh, P(DATA_AXIS))
    shards = jax.device_put(shards, sh2)
    shard_n = jax.device_put(shard_n, sh1)
    needle = jax.device_put(needle, NamedSharding(mesh, P()))
    return step(needle, shards, shard_n)


def assemble_sharded_search(
    dist: np.ndarray, length: np.ndarray, shard_n: np.ndarray, S: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Stitch per-device owned (dist, length) blocks into global arrays.

    Device d's block covers global end positions [d*S, d*S + S]; position
    d*S for d > 0 duplicates device d-1's last entry, so it is dropped.
    """
    D = dist.shape[0]
    n = int(shard_n.sum())
    out_d = np.full(n + 1, np.int64(1) << 40, dtype=np.int64)
    out_l = np.zeros(n + 1, dtype=np.int64)
    for d in range(D):
        start = d * S  # global position of local entry 0
        lo = 0 if d == 0 else 1
        hi = min(int(shard_n[: d + 1].sum()) - start, S)
        if hi < lo:
            continue
        out_d[start + lo : start + hi + 1] = dist[d, lo : hi + 1]
        out_l[start + lo : start + hi + 1] = length[d, lo : hi + 1]
    return out_d, out_l


# ---------------------------------------------------------------------------
# Bit-parallel engines on the mesh.  The steps above shard the lax.scan
# wavefronts; the functions below run the bit-parallel Myers kernels per
# device.
# ---------------------------------------------------------------------------


def sharded_myers_distance(
    mesh: Mesh,
    a_rows,  # [Bp, <= max_m] uint8 (prepare_myers_inputs)
    b_rows,  # [Bp, <= MB] uint8
    m,  # [Bp] int32
    dlen,  # [Bp] int32
    ukl,  # [Bp] int32
    b_shift,  # int32 scalar
    *,
    k: int,
    max_m: int,
    interpret: bool = False,
):
    """DP over the mesh with the bit-parallel distance engine: the pair
    axis splits across devices and each device runs the single-device
    engine on its block — zero collectives (pairs are independent).
    Prepare the batch with ``prepare_myers_inputs(..., lanes=BLOCK*D)`` so
    each device gets whole kernel blocks.  Returns dist [Bp] int32."""
    from ..ops.pallas.myers_distance import BLOCK, myers_distance_triton

    D = mesh.devices.size
    B = m.shape[0]
    if B % (D * BLOCK) != 0:
        raise ValueError(
            f"batch {B} must split into blocks of {BLOCK} pairs per device "
            f"(D={D}); pack with prepare_myers_inputs(lanes={BLOCK}*{D})"
        )
    rows = P(DATA_AXIS, None)
    vec = P(DATA_AXIS)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(rows, rows, vec, vec, vec, P()),
        out_specs=vec,
        check_vma=False,
    )
    def step(a_l, b_l, m_l, d_l, u_l, shift):
        return myers_distance_triton(a_l, b_l, m_l, d_l, u_l, shift, k=k,
                                     max_m=max_m, interpret=interpret)

    rows_sh = NamedSharding(mesh, rows)
    vec_sh = NamedSharding(mesh, vec)
    return step(
        jax.device_put(a_rows, rows_sh),
        jax.device_put(b_rows, rows_sh),
        jax.device_put(m, vec_sh),
        jax.device_put(dlen, vec_sh),
        jax.device_put(ukl, vec_sh),
        jax.device_put(jnp.asarray(b_shift, jnp.int32), NamedSharding(mesh, P())),
    )


def shard_haystack(haystack: np.ndarray, D: int, halo: int, own_len: int):
    """Equal [D, S] zero-padded shards of a haystack: S a multiple of
    own_len and >= halo (the ppermuted tail must fit inside one shard).
    Returns (shards, S); the tail padding is masked by the collect."""
    n = len(haystack)
    S = max(-(-(-(-n // D)) // own_len) * own_len,
            -(-halo // own_len) * own_len)
    hay_pad = np.zeros(D * S, dtype=np.uint8)
    hay_pad[:n] = haystack
    return hay_pad.reshape(D, S), S


def _left_halo_windows(shard_l, S: int, halo: int, own_len: int,
                       num_local: int):
    """Inside a shard_map step: one ``lax.ppermute`` hands this shard's
    last `halo` chars to the right neighbour, then the device windows
    (left halo | own shard) with chunk_raw semantics.  Device 0's front
    halo is synthetic zeros — byte-exact with the single-device
    convention (its hits at gpos <= halo are corrected downstream exactly
    as single-device segment 0's are)."""
    from ..ops.pallas.myers_search import device_windows

    idx = lax.axis_index(DATA_AXIS)
    ndev = lax.axis_size(DATA_AXIS)
    if halo > 0:
        tail = shard_l[:, S - halo:]
        left = lax.ppermute(
            tail, DATA_AXIS, [(d, (d + 1) % ndev) for d in range(ndev)]
        )
        left = jnp.where(idx > 0, left, 0).reshape(-1).astype(jnp.uint8)
    else:
        left = None
    return device_windows(
        shard_l.reshape(-1), halo=halo, own_len=own_len, num=num_local,
        front=left,
    )


def sharded_pack_segs(
    mesh: Mesh,
    shards,  # [D, S] uint8 haystack shards (zero-padded tail)
    *,
    halo: int,
    own_len: int,
):
    """Device-resident sharded segment pack (the mesh analog of
    `myers_search.device_pack_segs`): one ppermute halo ring + windows +
    transpose per device, output [seg_len, D*C_pad_local] lane-sharded
    and kept on device — repeated searches pay no re-pack and no
    re-upload."""
    from ..ops.pallas.myers_search import transpose_windows

    D, S = shards.shape
    if S % own_len != 0:
        raise ValueError(f"shard size {S} must be a multiple of {own_len}")
    if halo > S:
        raise ValueError(f"halo ({halo}) must be <= shard size ({S})")
    num_local = S // own_len

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None),),
        out_specs=P(None, DATA_AXIS),
        check_vma=False,
    )
    def build(shard_l):
        return transpose_windows(
            _left_halo_windows(shard_l, S, halo, own_len, num_local))

    shards = jax.device_put(
        jnp.asarray(shards, jnp.uint8), NamedSharding(mesh, P(DATA_AXIS, None))
    )
    return jax.jit(build)(shards)


def sharded_myers_search_mins_packed(
    mesh: Mesh,
    seg_t,  # [seg_len, D*C_pad_local] device-resident sharded pack
    peq,  # [num_needles, NW*256] Peq tables (prepare_peq)
    *,
    needle_len: int,
    seg_len: int,
    damerau: bool = False,
    interpret: bool = False,
):
    """Multi-needle bit-parallel search over a resident sharded pack
    (`sharded_pack_segs`): needles broadcast, each device searches its
    own shard's segments.  Returns (dist, mins) lane-sharded; decode with
    `collect_sharded_hits`."""
    from ..ops.pallas.myers_search import myers_search_block_mins

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS), P()),
        out_specs=(P(None, DATA_AXIS), P(None, DATA_AXIS)),
        check_vma=False,
    )
    def step(seg_l, peq_l):
        return myers_search_block_mins(
            peq_l, seg_l, needle_len=needle_len, seg_len=seg_len,
            damerau=damerau, interpret=interpret,
        )

    peq = jax.device_put(jnp.asarray(peq), NamedSharding(mesh, P()))
    return step(seg_t, peq)


def sharded_myers_search_mins(
    mesh: Mesh,
    shards,  # [D, S] uint8 haystack shards (shard_haystack)
    peq,  # [1, NW*256] Peq table (prepare_peq)
    *,
    needle_len: int,
    halo: int,
    own_len: int,
    damerau: bool = False,
    interpret: bool = False,
):
    """SP sharded-haystack search on the bit-parallel engine: each device
    owns one contiguous [S] shard, one ``lax.ppermute`` passes each
    shard's last `halo` chars to its right neighbour, and every device
    windows and searches its own shard.  Returns (dist, mins) with the
    lane axis device-sharded; decode with `collect_sharded_hits`."""
    seg_t = sharded_pack_segs(mesh, shards, halo=halo, own_len=own_len)
    return sharded_myers_search_mins_packed(
        mesh, seg_t, peq, needle_len=needle_len, seg_len=halo + own_len,
        damerau=damerau, interpret=interpret,
    )


def collect_sharded_hits(
    dist,  # [num_needles*(seg_len+1), D*C_pad_local] device-sharded
    mins,  # [RB, D*C_pad_local] per-ROW_BLOCK column minima
    *,
    D: int,
    k: int,
    halo: int,
    own_len: int,
    shard_size: int,
    n_total: int,
    num_needles: int = 1,
):
    """Owner-by-end assembly of the sharded search's hits.

    Per device: the two-phase fetch over that device's columns, then
    `collect_hits` with the device's local segment count and ``own_pos0``
    only on device 0 — a shard's position 0 is its left neighbour's last
    owned position.  Returns (ni, gpos, d) int64 arrays sorted by
    (needle, global end position)."""
    from ..ops.pallas.myers_search import collect_hits, fetch_candidate_blocks

    num_local = shard_size // own_len
    mins_h = np.asarray(mins)
    cp_l = mins_h.shape[1] // D
    parts = []
    for d in range(D):
        blocks, rb, cols = fetch_candidate_blocks(dist, mins_h, k,
                                                  col_lo=d * cp_l, ncols=cp_l)
        ni, gpos, d_arr = collect_hits(
            blocks, rb, cols, k,
            OUT=halo + own_len + 1, C=num_local, halo=halo, own_len=own_len,
            limit_pos=min(shard_size, n_total - d * shard_size),
            own_pos0=(d == 0), num_needles=num_needles,
        )
        parts.append((ni, gpos + d * shard_size, d_arr))
    ni = np.concatenate([p[0] for p in parts])
    gpos = np.concatenate([p[1] for p in parts])
    d_arr = np.concatenate([p[2] for p in parts])
    order = np.lexsort((gpos, ni))
    return ni[order], gpos[order], d_arr[order]


def sharded_hamming_search_mins(
    mesh: Mesh,
    shards,  # [D, S] uint8 haystack shards (zero-padded tail)
    needle,  # [m] uint8
    n_total,  # scalar int32: true haystack length
    *,
    needle_len: int,
):
    """SP Hamming search on the mesh: each device counts mismatches at its
    own start positions after ONE ppermute pulls the right neighbor's
    first needle_len chars (fixed-length windows partition start positions
    exactly across shards — no dedup rule needed).  Returns (counts, mins)
    with the lane layout of `ops.hamming_ops.hamming_search_block_mins`:
    global start p at counts[p], block b's minimum at mins[b] — so the
    single-device two-phase fetch + postprocess resolve them unchanged.
    """
    from ..ops.hamming_ops import BLOCK

    D, S = shards.shape
    m = needle_len
    if S % BLOCK != 0 or m > S:
        raise ValueError(f"shard size {S} must be a multiple of {BLOCK} "
                         f"and >= needle_len {m}")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(), P()),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    def step(shard_l, needle_l, n_l):
        idx = lax.axis_index(DATA_AXIS)
        ndev = lax.axis_size(DATA_AXIS)
        head = shard_l[:, :m]
        right = lax.ppermute(
            head, DATA_AXIS, [(d, d - 1) for d in range(1, ndev)]
        )
        # the last device has no right neighbor: zero halo (positions
        # whose window crosses n are sentinel-masked below anyway)
        right = jnp.where(idx < ndev - 1, right, 0).astype(jnp.uint8)
        local = jnp.concatenate(
            [shard_l.reshape(-1).astype(jnp.uint8), right.reshape(-1)]
        )

        def body(j, acc):
            shifted = lax.dynamic_slice_in_dim(local, j, S)
            return acc + jnp.where(
                shifted != needle_l[j], 1, 0
            ).astype(jnp.int32)

        counts = lax.fori_loop(0, m, body, jnp.zeros((S,), jnp.int32))
        g = idx * S + jnp.arange(S, dtype=jnp.int32)
        counts = jnp.where(
            g <= n_l - m, counts, jnp.int32(m + 1 + (1 << 20))
        )
        mins = jnp.min(counts.reshape(-1, BLOCK), axis=1)
        return counts, mins

    shards = jax.device_put(
        jnp.asarray(shards, jnp.uint8), NamedSharding(mesh, P(DATA_AXIS, None))
    )
    needle = jax.device_put(
        jnp.asarray(needle, jnp.uint8), NamedSharding(mesh, P())
    )
    n_total = jax.device_put(
        jnp.asarray(n_total, jnp.int32), NamedSharding(mesh, P())
    )
    return step(shards, needle, n_total)
