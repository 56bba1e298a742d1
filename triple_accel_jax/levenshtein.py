"""Public Levenshtein / restricted Damerau-Levenshtein API.

Mirrors the reference's `triple_accel::levenshtein` module
(src/levenshtein.rs): blessed functions `levenshtein`, `rdamerau`,
`levenshtein_exp`, `rdamerau_exp`, `levenshtein_search`, the lower-level
`levenshtein_simd_k[_with_opts]` / `levenshtein_search_simd[_with_opts]`
(device-accelerated) and their `*_naive*` scalar twins, with identical
result semantics: distances, None-above-threshold, RLE tracebacks, and
Match{start, end, k} lists with the reference's Best/All/overlap rules.

Structure: the "SIMD" names dispatch — at trace time, by (band bucket,
cost dtype, padded shape) — to the bit-parallel Myers engines for unit
and rdamerau costs (ops/pallas/: Pallas kernels through Triton on a GPU)
or to the banded `lax.scan` wavefronts for every cost model
(ops/band_scan.py, ops/search_scan.py); the exponential-search k-doubling
loop stays on the host exactly like the reference's
(levenshtein.rs:1445-1454).  A batched-first API (`levenshtein_k_batch`)
is the high-throughput entry point: one device dispatch per [B] pair batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .dispatch import (
    DispatchDecision,
    compute_max_k,
    compute_unit_k,
    forced_path,
    kernel_interpret,
    round_up_pow2,
    select_cost_bucket,
    use_kernels,
)
from .oracle.levenshtein import (
    default_search_k,
    levenshtein_naive,
    levenshtein_naive_k,
    levenshtein_naive_k_with_opts,
    levenshtein_naive_with_opts,
    levenshtein_search_naive,
    levenshtein_search_naive_with_opts,
)
from .types import (
    BytesLike,
    Edit,
    EditCosts,
    LEVENSHTEIN_COSTS,
    Match,
    RDAMERAU_COSTS,
    SearchType,
    to_bytes_array,
)

__all__ = [
    "levenshtein_naive",
    "levenshtein_naive_with_opts",
    "levenshtein_naive_k",
    "levenshtein_naive_k_with_opts",
    "levenstein_naive_str",
    "levenshtein_simd_k_str",
    "levenshtein_simd_k",
    "levenshtein_simd_k_with_opts",
    "levenshtein",
    "rdamerau",
    "levenshtein_exp",
    "levenshtein_exp_with_opts",
    "rdamerau_exp",
    "levenshtein_k_batch",
    "levenshtein_exp_batch",
    "levenshtein_search_naive",
    "levenshtein_search_naive_with_opts",
    "levenshtein_search_simd",
    "levenshtein_search_sharded",
    "levenshtein_search_many",
    "PackedHaystack",
    "levenshtein_search_simd_with_opts",
    "levenshtein_search",
    "translate_str",
    "LEVENSHTEIN_COSTS",
    "RDAMERAU_COSTS",
    "default_search_k",
]

U32_MAX = (1 << 32) - 1

# smallest pair group worth its own kernel launch in per-bucket dispatch
_MIN_BUCKET = 256

# scan-walk codes-buffer cap (cells): larger traced batches chunk on the
# batch axis; past 2^31 cells the walk's flat gather indices overflow int32
_TRACE_CELLS_CAP = 1 << 29

# ---------------------------------------------------------------------------
# Unicode helpers (reference levenshtein.rs:609-651, 123-127)
# ---------------------------------------------------------------------------

def translate_str(chars: List[str], s: str) -> Optional[np.ndarray]:
    """Map a unicode string onto a <=256-symbol u8 alphabet shared through
    `chars` (reference levenshtein.rs:609-624).  Returns None if the
    combined alphabet exceeds 256 symbols."""
    out = np.empty(len(s), dtype=np.uint8)
    lookup = {c: i for i, c in enumerate(chars)}
    for i, c in enumerate(s):
        idx = lookup.get(c)
        if idx is None:
            idx = len(chars)
            if idx >= 256:
                return None
            chars.append(c)
            lookup[c] = idx
        out[i] = idx
    return out


def levenstein_naive_str(a: str, b: str) -> int:
    """Unicode scalar distance (sic — typo preserved from the reference,
    levenshtein.rs:123-127).

    Works for ANY alphabet size: the reference's `levenshtein_naive` is
    generic over `T: PartialEq` (levenshtein.rs:148), so `>256` distinct
    characters are fine — the oracle DP compares unicode code points
    directly (`to_symbol_array`).

    >>> levenstein_naive_str("abc", "ab")
    1
    """
    return levenshtein_naive(a, b)


def levenshtein_simd_k_str(a: str, b: str, k: int) -> Optional[int]:
    """Unicode banded distance (reference levenshtein.rs:641-651).

    >>> levenshtein_simd_k_str("abc", "ab", 1)
    1
    """
    if a.isascii() and b.isascii():
        return levenshtein_simd_k(a.encode(), b.encode(), k)
    chars: List[str] = []
    a_t = translate_str(chars, a)
    if a_t is None:
        return None
    b_t = translate_str(chars, b)
    if b_t is None:
        return None
    return levenshtein_simd_k(a_t, b_t, k)


# ---------------------------------------------------------------------------
# Distance dispatcher
# ---------------------------------------------------------------------------

def _costs_tuple(costs: EditCosts) -> Tuple[int, int, int, int, bool]:
    return (
        costs.mismatch_cost,
        costs.gap_cost,
        costs.start_gap_cost,
        costs.transpose_cost_or_zero,
        costs.allow_transpose,
    )


def levenshtein_simd_k_with_opts(
    a: BytesLike,
    b: BytesLike,
    k: int,
    trace_on: bool = False,
    costs: EditCosts = LEVENSHTEIN_COSTS,
) -> Optional[Tuple[int, Optional[List[Edit]]]]:
    """Banded distance with options, device accelerated
    (reference levenshtein.rs:714-827).

    Returns None when the distance exceeds the (capped) threshold; with
    `trace_on`, additionally returns the RLE edit traceback.  The name is
    kept for API parity — per the SURVEY design stance the single-pair
    DISTANCE wrapper routes through the batched dispatcher at batch size
    1, so it reaches the same engines (bit-parallel Myers / scan
    wavefront) the batch API uses, chosen by the same rules.
    Single-pair tracebacks keep the direct wavefront + host decode: the
    batched device-walk program costs two compiles per fresh shape, which
    a one-off traced pair never amortizes (use levenshtein_k_batch with
    trace_on for bulk tracing).
    """
    a = to_bytes_array(a)
    b = to_bytes_array(b)
    if len(a) == 0 and len(b) == 0:
        return (0, [] if trace_on else None)

    if forced_path() == "oracle":
        return levenshtein_naive_k_with_opts(a, b, k, trace_on, costs)

    if not trace_on:
        dists = levenshtein_k_batch([a], [b], k, costs)
        if dists[0] < 0:
            return None
        return (int(dists[0]), None)

    from .ops.band_scan import (
        band_scan_distance,
        decode_traceback,
        prepare_band_inputs,
    )

    max_k = compute_max_k(len(a), len(b), k, costs)
    unit_k = min(compute_unit_k(max_k, costs), max(len(a), len(b)))

    swap = len(a) > len(b)
    a_new, b_new = (b, a) if swap else (a, b)
    m, n = len(a_new), len(b_new)
    if n - m > unit_k:
        return None

    uk_dev = round_up_pow2(unit_k, 4)
    max_m = round_up_pow2(m, 8)
    DispatchDecision(
        path="scan",
        cost_bucket=select_cost_bucket(max_k),
        unit_k=uk_dev,
        max_k=max_k,
        padded_m=max_m,
        padded_n=n,
    ).log("levenshtein_simd_k_with_opts")

    a_pad, b_pad, m_arr, n_arr = prepare_band_inputs(
        [a_new], [b_new], uk_dev, max_m
    )
    dist, codes = band_scan_distance(
        a_pad,
        b_pad,
        m_arr,
        n_arr,
        unit_k=uk_dev,
        max_m=max_m,
        costs_t=_costs_tuple(costs),
        trace_on=True,
    )
    d = int(np.asarray(dist)[0])
    if d > max_k:
        return None
    codes_np = np.asarray(codes)[:, 0, :]
    return (d, decode_traceback(codes_np, a_new, b_new, uk_dev, swap))


def levenshtein_simd_k(a: BytesLike, b: BytesLike, k: int) -> Optional[int]:
    """Banded distance (reference levenshtein.rs:677-684).

    >>> levenshtein_simd_k(b"abc", b"ab", 1)
    1
    >>> levenshtein_simd_k(b"abc", b"", 1) is None
    True
    """
    res = levenshtein_simd_k_with_opts(a, b, k, False, LEVENSHTEIN_COSTS)
    return None if res is None else res[0]


def levenshtein(a: BytesLike, b: BytesLike) -> int:
    """Exact Levenshtein distance (reference levenshtein.rs:1397-1399).

    >>> levenshtein(b"abc", b"ab")
    1
    """
    res = levenshtein_simd_k(a, b, U32_MAX)
    assert res is not None
    return res


def rdamerau(a: BytesLike, b: BytesLike) -> int:
    """Exact restricted Damerau-Levenshtein distance
    (reference levenshtein.rs:1419-1423).

    >>> rdamerau(b"abc", b"acb")
    1
    """
    res = levenshtein_simd_k_with_opts(a, b, U32_MAX, False, RDAMERAU_COSTS)
    assert res is not None
    return res[0]


def levenshtein_exp(a: BytesLike, b: BytesLike) -> int:
    """Distance via exponential threshold search — much faster when the
    edit count is small (reference levenshtein.rs:1445-1454).

    >>> levenshtein_exp(b"abc", b"ab")
    1
    """
    k = 30
    while True:
        res = levenshtein_simd_k(a, b, k)
        if res is not None:
            return res
        k *= 2


def levenshtein_exp_with_opts(
    a: BytesLike,
    b: BytesLike,
    trace_on: bool = False,
    costs: EditCosts = LEVENSHTEIN_COSTS,
) -> Tuple[int, Optional[List[Edit]]]:
    """Exponential-search distance with options (reference levenshtein.rs:
    1480-1494)."""
    k = 30
    while True:
        res = levenshtein_simd_k_with_opts(a, b, k, trace_on, costs)
        if res is not None:
            return res
        k *= 2


def rdamerau_exp(a: BytesLike, b: BytesLike) -> int:
    """Exponential-search rdamerau distance (reference levenshtein.rs:
    1516-1526).

    >>> rdamerau_exp(b"abc", b"acb")
    1
    """
    k = 30
    while True:
        res = levenshtein_simd_k_with_opts(a, b, k, False, RDAMERAU_COSTS)
        if res is not None:
            return res[0]
        k *= 2


def levenshtein_exp_batch(
    a_batch: Sequence[BytesLike],
    b_batch: Sequence[BytesLike],
    costs: EditCosts = LEVENSHTEIN_COSTS,
    mesh=None,
) -> np.ndarray:
    """Batched exponential-search exact distance — the batched-first analog
    of `levenshtein_exp` (reference levenshtein.rs:1445-1454): all pairs
    start at k = 30; unresolved pairs retry together with k doubled, so a
    batch dominated by similar pairs never pays for a wide band.

    `mesh` runs every per-k round data-parallel across devices (plumbed
    straight into `levenshtein_k_batch(mesh=)`); the host-side k-doubling
    control loop is unchanged.

    Returns int64 exact distances (always resolves; never -1).
    """
    a_list = [to_bytes_array(x) for x in a_batch]
    b_list = [to_bytes_array(x) for x in b_batch]
    B = len(a_list)
    res = np.full(B, -1, dtype=np.int64)
    pending = np.arange(B)
    k = 30
    while pending.size:
        out = levenshtein_k_batch(
            [a_list[i] for i in pending],
            [b_list[i] for i in pending],
            k,
            costs,
            mesh=mesh,
        )
        done = out >= 0
        res[pending[done]] = out[done]
        pending = pending[~done]
        k *= 2
    return res


_UNIT = (1, 1, 0, 0, False)
_RDAMERAU = (1, 1, 0, 1, True)


def _bitpar_k(max_ks: np.ndarray) -> int:
    """The bit-parallel distance engine's static threshold for a batch:
    the batch max rounded up to a multiple of 8 (bounded recompiles)."""
    return -(-max(int(max_ks.max(initial=0)), 4) // 8) * 8


def _myers_distance_arm(costs: EditCosts, k_stat: int) -> bool:
    """Whether a distance batch runs the bit-parallel kernel (else the
    scan wavefront): unit costs whose k+1 band fits the kernel's word
    limit."""
    from .ops.pallas.myers_distance import distance_plan

    return (_costs_tuple(costs) == _UNIT and distance_plan(k_stat) is not None
            and use_kernels())


def _k_batch_on_mesh(
    mesh, swapped_a, swapped_b, feasible, max_ks, costs, uk_dev, max_m,
):
    """Mesh execution of one levenshtein_k_batch bucket (DP over pairs):
    the single-device engine choice, each engine running per device via
    shard_map with the batch axis split.  Pairs are independent, so every
    path is zero-collective; `mesh=` never changes results, only
    placement.
    """
    from .parallel.sharded import sharded_distance_step, sharded_myers_distance

    B = len(swapped_a)
    D = mesh.devices.size
    max_k_int = int(max_ks.max(initial=0))

    def _log(path):
        DispatchDecision(
            path=path,
            cost_bucket=select_cost_bucket(max_k_int),
            unit_k=uk_dev,
            max_k=max_k_int,
            padded_m=max_m,
            padded_n=B,
        ).log("levenshtein_k_batch")

    k_stat = _bitpar_k(max_ks)
    if _myers_distance_arm(costs, k_stat):
        from .ops.pallas.myers_distance import BLOCK, prepare_myers_inputs

        _log("myers_sharded")
        args = prepare_myers_inputs(
            swapped_a, swapped_b, k_stat, max_m,
            ks=np.where(feasible, max_ks, k_stat), lanes=BLOCK * D,
        )
        dist = sharded_myers_distance(
            mesh, *args, k=k_stat, max_m=max_m, interpret=kernel_interpret(),
        )
        out = np.asarray(dist)[:B].astype(np.int64)
        return np.where(feasible & (out <= max_ks), out, -1)

    from .ops.band_scan import prepare_band_inputs

    # scan: pad the batch to a multiple of the mesh so the batch axis
    # shards evenly
    _log("scan_sharded")
    _empty = np.empty(0, dtype=np.uint8)
    pad = (-B) % D
    a_pad, b_pad, m_arr, n_arr = prepare_band_inputs(
        list(swapped_a) + [_empty] * pad,
        list(swapped_b) + [_empty] * pad,
        uk_dev, max_m,
    )
    dist = sharded_distance_step(
        mesh, a_pad, b_pad, m_arr, n_arr,
        unit_k=uk_dev, max_m=max_m, costs_t=_costs_tuple(costs),
    )
    out = np.asarray(dist)[:B].astype(np.int64)
    return np.where(feasible & (out <= max_ks), out, -1)


def _as_rows(batch):
    """A batch as a sequence of uint8 rows: a 2-D array stays one array
    (its rows are the strings), anything else becomes a list."""
    if isinstance(batch, np.ndarray) and batch.ndim == 2:
        return np.ascontiguousarray(batch, dtype=np.uint8)
    return [to_bytes_array(x) for x in batch]


def _bucket_groups(mq: np.ndarray, ukq: np.ndarray) -> List[List[int]]:
    """Pair indices grouped by ascending (padded m, unit_k) key, groups
    smaller than _MIN_BUCKET merged upward; [] when every pair shares one
    key."""
    if (mq == mq[0]).all() and (ukq == ukq[0]).all():
        return []
    keys, inv = np.unique(np.stack([mq, ukq], axis=1), axis=0,
                          return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    bounds = np.cumsum(np.bincount(inv, minlength=len(keys)))
    merged: List[List[int]] = []
    carry: List[int] = []
    for grp in np.split(order, bounds[:-1]):
        members = carry + grp.tolist()
        if len(members) < _MIN_BUCKET:
            carry = members
        else:
            merged.append(members)
            carry = []
    if carry:
        if merged:
            merged[-1].extend(carry)
        else:
            merged.append(carry)
    return merged


def _swap_pairs(a_list, b_list, feas_list, swaps, empty):
    """(shorter, longer) per pair; infeasible pairs become empty pairs."""
    B = len(a_list)
    swapped_a = [
        (empty if not feas_list[p]
         else (b_list[p] if swaps[p] else a_list[p]))
        for p in range(B)
    ]
    swapped_b = [
        (empty if not feas_list[p]
         else (a_list[p] if swaps[p] else b_list[p]))
        for p in range(B)
    ]
    return swapped_a, swapped_b


def levenshtein_k_batch(
    a_batch: Sequence[BytesLike],
    b_batch: Sequence[BytesLike],
    k: int,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    trace_on: bool = False,
    mesh=None,
):
    """Batched banded distance: the high-throughput unit of work.

    Computes the reference's `levenshtein_simd_k(a, b, k)` for every pair in
    one device dispatch.  Returns int64 distances with -1 where the pair's
    distance exceeds its (per-pair capped) threshold — the batched analog of
    the reference returning None.

    Engines: unit costs whose k+1 band fits 4 uint32 words (k up to 120)
    run the bit-parallel Myers recurrence — the Pallas kernel on a GPU
    (ops/pallas/myers_distance.py), one pair per lane with the row loop in
    registers; every other cost model and band runs the `lax.scan` row
    wavefront (ops/band_scan.py).

    With `trace_on`, returns (dists, traces): traces[p] is the RLE edit
    list (None where dists[p] == -1).  The batched analog of the
    reference's in-core SIMD traceback (levenshtein.rs:1080-1089,
    1197-1281): the wavefront emits argmin codes and a second device scan
    walks all B tracebacks simultaneously (ops/band_scan.band_trace_batch)
    — one XLA program, codes never fetched, only the compact edit streams.

    `mesh` (a 1-D `jax.sharding.Mesh`, see `parallel.make_mesh`) runs the
    batch data-parallel across devices: the same engine per device via
    `shard_map` (pairs are independent, zero collectives).  Traced batches
    ignore `mesh` and log `trace_mesh_ignored`.
    """
    from .ops.band_scan import (
        band_scan_distance,
        prepare_band_inputs,
        row_lengths,
    )

    a_list = _as_rows(a_batch)
    b_list = _as_rows(b_batch)
    if len(a_list) != len(b_list):
        raise ValueError("batch lengths differ")
    B = len(a_list)
    if B == 0:
        out0 = np.empty(0, dtype=np.int64)
        return (out0, []) if trace_on else out0

    # vectorized per-pair dispatch math (compute_max_k / compute_unit_k
    # element-for-element; the python loop cost ~40us/pair and dominated
    # large-batch e2e time)
    la = row_lengths(a_list)
    lb = row_lengths(b_list)
    swaps_arr = la > lb
    m_len = np.where(swaps_arr, lb, la)
    n_len = np.where(swaps_arr, la, lb)
    mc_, gc_, sgc_ = costs.mismatch_cost, costs.gap_cost, costs.start_gap_cost
    cap2 = (m_len << 1) * gc_ + np.where(
        m_len == 0, 0, sgc_ + np.where(n_len == m_len, sgc_, 0)
    )
    max_ks = np.minimum(m_len * mc_, cap2)
    max_ks = np.minimum(
        k, max_ks + (n_len - m_len) * gc_ + np.where(n_len == m_len, 0, sgc_)
    )
    uks = np.minimum(np.maximum(max_ks - sgc_, 0) // gc_, n_len)
    feasible = (n_len - m_len) <= uks
    uks = np.where(feasible, uks, 0)
    unit_k = int(uks.max(initial=0))
    swaps: List[bool] = swaps_arr.tolist()
    # infeasible pairs (length gap exceeds the band) are replaced with
    # empty pairs so they neither widen the batch's band/max_m nor
    # overflow the band buffer; masked to -1 at the end anyway
    _empty = np.empty(0, dtype=np.uint8)
    feas_list = feasible.tolist()
    if all(feas_list) and not swaps_arr.any():
        swapped_a, swapped_b = a_list, b_list
    else:
        swapped_a, swapped_b = _swap_pairs(a_list, b_list, feas_list,
                                           swaps, _empty)

    # --- per-bucket dispatch (the batched analog of the reference's
    # per-call Jewel-width dispatch, levenshtein.rs:766-823): one long or
    # distant outlier pair must not widen every pair's band and row count.
    # Pairs are grouped by their pow2-quantized (padded m, unit_k) key;
    # groups smaller than _MIN_BUCKET merge upward into the next key so
    # per-launch dispatch overhead stays amortized.
    if B > _MIN_BUCKET:
        def _rup2(v, minimum):
            vv = np.maximum(v, minimum)
            return (1 << np.ceil(np.log2(vv)).astype(np.int64))

        merged = _bucket_groups(
            _rup2(np.where(feasible, np.maximum(m_len, 1), 1), 8),
            _rup2(uks, 4),
        )
        if len(merged) > 1:
            out = np.empty(B, dtype=np.int64)
            traces_all: List[Optional[List[Edit]]] = [None] * B
            for members in merged:
                sub = levenshtein_k_batch(
                    [a_list[p] for p in members],
                    [b_list[p] for p in members],
                    k, costs, trace_on, mesh=mesh,
                )
                if trace_on:
                    sub, sub_traces = sub
                    for q, p in enumerate(members):
                        traces_all[p] = sub_traces[q]
                out[list(members)] = sub
            return (out, traces_all) if trace_on else out

    uk_dev = round_up_pow2(unit_k, 4)
    max_m = round_up_pow2(int(row_lengths(swapped_a).max(initial=1)), 8)
    max_k_int = int(max_ks.max(initial=0))

    def _log(path):
        DispatchDecision(
            path=path,
            cost_bucket=select_cost_bucket(max_k_int),
            unit_k=uk_dev,
            max_k=max_k_int,
            padded_m=max_m,
            padded_n=B,
        ).log("levenshtein_k_batch")

    if mesh is not None and not trace_on:
        return _k_batch_on_mesh(
            mesh, swapped_a, swapped_b, feasible, max_ks, costs, uk_dev,
            max_m,
        )
    if mesh is not None:
        # traced batches run single-device (the traceback walk is
        # host-decode dominated); say so in the dispatch log instead of
        # silently dropping the mesh
        _log("trace_mesh_ignored")

    if trace_on:
        from .ops.band_scan import band_trace_batch, decode_walked_batch

        _log("trace_batch")
        W_band = 2 * uk_dev + 1
        # cap the walk's codes buffer (max_m * B_sub * W int32 cells)
        # to ~2^29 elements: bigger traced batches chunk on the batch
        # axis — pairs walk independently, and past 2^31 cells the
        # flat gather indices overflow int32 outright (measured at
        # B=256, 3000-char pairs, k=1000: max_m pow2-rounds to 4096
        # and 4096*256*2049 = 2.148e9 raised OverflowError)
        b_cap = max(1, _TRACE_CELLS_CAP // max(max_m * W_band, 1))
        outs, seqs = [], []
        for lo in range(0, B, b_cap):
            hi = min(lo + b_cap, B)
            a_pad, b_pad, m_arr, n_arr = prepare_band_inputs(
                swapped_a[lo:hi], swapped_b[lo:hi], uk_dev, max_m
            )
            dist, seq, _steps = band_trace_batch(
                a_pad, b_pad, m_arr, n_arr,
                unit_k=uk_dev, max_m=max_m,
                costs_t=_costs_tuple(costs),
            )
            outs.append(np.asarray(dist).astype(np.int64))
            seqs.append(np.asarray(seq))
        out = np.concatenate(outs)
        seq_np = np.concatenate(seqs, axis=0)
        out = np.where(feasible & (out <= max_ks), out, -1)
        decoded = decode_walked_batch(seq_np, swaps)
        traces = [
            decoded[p] if out[p] >= 0 else None for p in range(B)
        ]
        return out, traces

    k_stat = _bitpar_k(max_ks)
    if _myers_distance_arm(costs, k_stat):
        from .ops.pallas.myers_distance import (
            myers_distance_triton,
            prepare_myers_inputs,
        )

        _log("myers")
        args = prepare_myers_inputs(
            swapped_a, swapped_b, k_stat, max_m,
            ks=np.where(feasible, max_ks, k_stat),
        )
        dist = myers_distance_triton(*args, k=k_stat, max_m=max_m,
                                     interpret=kernel_interpret())
        out = np.asarray(dist)[:B].astype(np.int64)
        return np.where(feasible & (out <= max_ks), out, -1)

    _log("scan")
    a_pad, b_pad, m_arr, n_arr = prepare_band_inputs(
        swapped_a, swapped_b, uk_dev, max_m
    )
    dist, _ = band_scan_distance(
        a_pad,
        b_pad,
        m_arr,
        n_arr,
        unit_k=uk_dev,
        max_m=max_m,
        costs_t=_costs_tuple(costs),
        trace_on=False,
    )
    out = np.asarray(dist).astype(np.int64)
    # both-empty pairs (the scan reports 0 there already) and threshold
    # misses
    return np.where(feasible & (out <= max_ks), out, -1)


# ---------------------------------------------------------------------------
# Search dispatcher
# ---------------------------------------------------------------------------

def postprocess_matches(
    dists: np.ndarray,
    lengths: np.ndarray,
    k: int,
    search_type: SearchType,
) -> List[Match]:
    """Turn per-end-position (distance, length) arrays into Match lists with
    the reference's streaming semantics (levenshtein.rs:1792-1835).

    `dists[i]` / `lengths[i]` describe the candidate ending after i haystack
    characters (i = 0 is the empty-prefix candidate).  Best mode: curr_k
    shrinks as candidates stream, a candidate replaces the previous one if
    it fully overlaps it (start <= previous start), and only k == final
    curr_k entries survive.  This two-pass form is behaviorally identical
    to the reference's lazy iterator (see SURVEY.md §7 hard parts).

    Uses the native C++ pass (native/postprocess.cpp) when built; falls
    back to NumPy.
    """
    from .utils.native import postprocess_matches_native

    native = postprocess_matches_native(
        np.asarray(dists), np.asarray(lengths), k,
        search_type == SearchType.Best,
    )
    if native is not None:
        return native

    res: List[Match] = []
    curr_k = k
    hits = np.flatnonzero(dists <= k)
    if search_type == SearchType.All:
        return [
            Match(start=int(i - lengths[i]), end=int(i), k=int(dists[i]))
            for i in hits
        ]
    for i in hits:
        d = int(dists[i])
        if d <= curr_k:
            curr_k = d
            m = Match(start=int(i - lengths[i]), end=int(i), k=d)
            if res and m.start <= res[-1].start:
                res[-1] = m
            else:
                res.append(m)
    return [m for m in res if m.k == curr_k]


def _empty_needle_matches(
    haystack_len: int, k: int, search_type: SearchType, costs: EditCosts,
    anchored: bool,
) -> List[Match]:
    """Empty-needle special cases (reference levenshtein.rs:1600-1644,
    1919-1963)."""
    if not anchored:
        return []
    if search_type == SearchType.Best:
        return [Match(start=0, end=0, k=0)]
    res = [Match(start=0, end=0, k=0)]
    cost = costs.start_gap_cost
    for i in range(1, haystack_len + 1):
        cost += costs.gap_cost
        if cost > k:
            break
        res.append(Match(start=0, end=i, k=cost))
    return res


def _merge_hit_windows(gpos: np.ndarray, span: int):
    """Merge the per-hit replay windows [p - span, p) of sorted hit end
    positions into disjoint char intervals [starts[i], ends[i]).  A
    cost-<=k candidate ending at p spans at most `span` chars, so an
    interval containing each hit's window replays it exactly."""
    gpos = np.asarray(gpos, dtype=np.int64)
    starts_all = np.maximum(gpos - span, 0)
    brk = np.flatnonzero(starts_all[1:] > gpos[:-1]) + 1
    gs = np.concatenate([[0], brk])
    ge = np.concatenate([brk, [gpos.size]])
    return starts_all[gs], gpos[ge - 1]


# host-time guard for the streaming replay: total DP cells (interval chars
# x needle len) the batched C++ resolution may burn before the dispatcher
# prefers the device general engine (whose DP tracks lengths inline)
_RESOLVE_CELLS_BUDGET = 300_000_000


def _resolve_hits_batch(
    needle: np.ndarray,
    haystack: np.ndarray,
    gpos: np.ndarray,
    k: int,
    costs: EditCosts,
    span: int,
) -> List[Tuple[int, int, int]]:
    """Resolve kernel hits (sorted end positions, device dist <= k) into
    authoritative (end, dist, length) candidates in ONE batched replay.

    The per-hit windows merge into disjoint intervals (dense hit streams
    collapse into a single streaming pass) and the C++ oracle port runs
    the All-mode search DP over all of them in one call
    (native/scalar_baseline.cpp ta_search_intervals); hits the replay
    doesn't confirm are artifacts (the one known source: NUL needle bytes
    matching chunk 0's synthetic zero-pad halo, see
    ops/pallas/myers_search.chunk_raw) and are dropped.  The replay is
    authoritative in both directions: pad contamination can only lower
    the kernel's value, never raise it, and the oracle IS the tie-break
    semantics (jewel.rs:364-417).  The Python oracle remains the fallback
    when the native library isn't built."""
    from .utils.native import search_intervals_native

    if gpos.size == 0:
        return []
    gpos = np.asarray(gpos, dtype=np.int64)
    istarts, iends = _merge_hit_windows(gpos, span)
    native = search_intervals_native(needle, haystack, istarts, iends, k,
                                     costs)
    if native is not None:
        ends, ks, lens = native
    else:
        e_l: List[int] = []
        k_l: List[int] = []
        l_l: List[int] = []
        for s, e in zip(istarts.tolist(), iends.tolist()):
            for mt in levenshtein_search_naive_with_opts(
                needle, haystack[s:e], k, SearchType.All, costs, False
            ):
                e_l.append(s + mt.end)
                k_l.append(mt.k)
                l_l.append(mt.end - mt.start)
        ends = np.asarray(e_l, dtype=np.int64)
        ks = np.asarray(k_l, dtype=np.int64)
        lens = np.asarray(l_l, dtype=np.int64)
    return _select_hit_candidates(ends, ks, lens, gpos)


def _select_hit_candidates(
    ends: np.ndarray, ks: np.ndarray, lens: np.ndarray, gpos: np.ndarray
) -> List[Tuple[int, int, int]]:
    """Keep only the replay candidates at the requested (unique, ascending)
    hit end positions; replay candidates have unique ascending ends."""
    if ends.size == 0:
        return []
    idx = np.searchsorted(ends, gpos)
    idx_c = np.minimum(idx, ends.size - 1)
    hit = ends[idx_c] == gpos
    sel = idx_c[hit]
    return list(zip(gpos[hit].tolist(), ks[sel].tolist(),
                    lens[sel].tolist()))


def _resolve_hits_anchored(
    needle: np.ndarray,
    haystack: np.ndarray,
    gpos: np.ndarray,
    k: int,
    costs: EditCosts,
) -> List[Tuple[int, int, int]]:
    """Resolve ANCHORED kernel hits into (end, dist, length) candidates.

    The anchored DP's row-0 boundary is the absolute haystack prefix cost
    (i+1)*gap + start_gap, so windowed replays don't apply — instead one
    All-mode anchored replay over the haystack recovers every candidate
    (the C++ port caps its own iteration at needle_len + (k - start_gap) /
    gap columns, native/scalar_baseline.cpp search_all_one, mirroring
    reference levenshtein.rs:1650-1661)."""
    from .utils.native import search_all_native

    if gpos.size == 0:
        return []
    gpos = np.asarray(gpos, dtype=np.int64)
    native = search_all_native(needle, haystack, k, costs, anchored=True)
    if native is not None:
        ends, ks, lens = native
    else:
        mts = levenshtein_search_naive_with_opts(
            needle, haystack, k, SearchType.All, costs, True
        )
        ends = np.asarray([mt.end for mt in mts], dtype=np.int64)
        ks = np.asarray([mt.k for mt in mts], dtype=np.int64)
        lens = np.asarray([mt.end - mt.start for mt in mts], dtype=np.int64)
    return _select_hit_candidates(ends, ks, lens, gpos)


def _resolve_cells(gpos: np.ndarray, span: int, m: int) -> int:
    """DP cells the batched replay would burn for these hits."""
    if gpos.size == 0:
        return 0
    istarts, iends = _merge_hit_windows(gpos, span)
    return int((iends - istarts).sum()) * max(m, 1)


def _resolve_hits_scan(
    needle: np.ndarray,
    haystack: np.ndarray,
    gpos: np.ndarray,
    k: int,
    costs: EditCosts,
    span: int,
    iter_len: int,
) -> List[Tuple[int, int, int]]:
    """Candidate resolution for degenerate-dense hit streams, ON DEVICE:
    the search wavefront (which tracks match lengths in its DP,
    ops/search_scan.py) reruns ONLY the segments containing hits — work
    proportional to the hit-bearing region, never a second full-haystack
    pass, and the C++ replay's host-time cost never applies.  Drop-in for
    _resolve_hits_batch when `_resolve_cells` exceeds the replay budget.
    Segments start at the real haystack (no synthetic pad), so the values
    are exact and no NUL correction applies."""
    from .ops.search_scan import search_scan

    if gpos.size == 0:
        return []
    m = len(needle)
    own_len = 4096
    gpos = np.asarray(gpos, np.int64)
    c_of = np.maximum(gpos - 1, 0) // own_len
    c_sel, seg_of = np.unique(c_of, return_inverse=True)
    seg_len = span + own_len
    n_seg = round_up_pow2(c_sel.size, 8)  # bounded recompile churn
    pad_l = m + 1
    seg_pad = np.full((n_seg, seg_len + 2 * m + 2), -1, dtype=np.int32)
    seg_n = np.zeros(n_seg, dtype=np.int32)
    seg_off = np.zeros(n_seg, dtype=np.int32)
    for i, c in enumerate(c_sel.tolist()):
        s0 = max(0, c * own_len - span)
        s1 = min(iter_len, (c + 1) * own_len)
        seg_pad[i, pad_l:pad_l + s1 - s0] = haystack[s0:s1]
        seg_n[i] = s1 - s0
        seg_off[i] = s0
    DispatchDecision(
        path="scan_resolve",
        cost_bucket=select_cost_bucket(k if k < U32_MAX else U32_MAX),
        unit_k=span,
        max_k=k,
        padded_m=m,
        padded_n=seg_len,
    ).log("_resolve_hits_scan")
    dist, length = search_scan(
        needle.astype(np.int32), seg_pad, seg_n, seg_off,
        needle_len=m, seg_len=seg_len, costs_t=_costs_tuple(costs),
        anchored=False,
    )
    local = gpos - seg_off[seg_of]
    dd = np.asarray(dist)[seg_of, local].astype(np.int64)
    ll = np.asarray(length)[seg_of, local].astype(np.int64)
    keep = dd <= k
    return list(zip(gpos[keep].tolist(), dd[keep].tolist(),
                    ll[keep].tolist()))


def _correct_chunk0_nul_hits(needle, haystack, gpos, d_arr, halo, k, costs,
                             span):
    """Chunk 0's synthetic zero-pad front halo can deflate kernel
    distances at gpos <= halo when the needle contains NUL bytes (see
    ops/pallas/myers_search.chunk_raw): oracle-correct those few
    positions before anything trusts d.  Returns filtered (gpos, d)."""
    if gpos.size == 0 or 0 not in needle:
        return gpos, d_arr
    fix = np.flatnonzero(gpos <= halo)
    if fix.size == 0:
        return gpos, d_arr
    resolved = _resolve_hits_batch(needle, haystack, gpos[fix], k, costs,
                                   span)
    by_end = {p: dd for p, dd, _ in resolved}
    keep = np.ones(gpos.size, dtype=bool)
    for fi in fix:
        dd = by_end.get(int(gpos[fi]))
        if dd is None:
            keep[fi] = False
        else:
            d_arr[fi] = dd
    return gpos[keep], d_arr[keep]


def _postprocess_sparse(
    cands: List[Tuple[int, int, int]],  # (end, dist, length), end-ascending
    k: int,
    search_type: SearchType,
) -> List[Match]:
    """postprocess_matches over a sparse candidate list (all dist <= k);
    behaviorally identical because the dense pass only inspects hits."""
    if search_type == SearchType.All:
        return [Match(start=p - l, end=p, k=d) for p, d, l in cands]
    res: List[Match] = []
    curr_k = k
    for p, d, l in cands:
        if d <= curr_k:
            curr_k = d
            mt = Match(start=p - l, end=p, k=d)
            if res and mt.start <= res[-1].start:
                res[-1] = mt
            else:
                res.append(mt)
    return [mt for mt in res if mt.k == curr_k]


def _resolve_hits(needle, haystack, gpos, k, costs, span, iter_len):
    """(end, dist, length) for unanchored hits: one batched C++ oracle
    replay, or — past the host-time budget — the search wavefront over
    only the hit-bearing segments."""
    from .utils.native import native_available

    budget = _RESOLVE_CELLS_BUDGET
    if not native_available():
        budget //= 100  # python-oracle fallback replay is ~100x slower
    if _resolve_cells(gpos, span, len(needle)) <= budget:
        return _resolve_hits_batch(needle, haystack, gpos, k, costs, span)
    return _resolve_hits_scan(needle, haystack, gpos, k, costs, span,
                              iter_len)


def _search_on_kernel(m: int, costs: EditCosts) -> bool:
    """Whether a search runs the bit-parallel kernel (else the scan
    wavefront): unit or rdamerau costs and a needle within the word
    limit."""
    from .ops.pallas.myers_search import search_plan

    return (_costs_tuple(costs) in (_UNIT, _RDAMERAU)
            and search_plan(m) is not None and use_kernels())


def _myers_search_dispatch(
    needle: np.ndarray,
    haystack: np.ndarray,
    k: int,
    search_type: SearchType,
    costs: EditCosts,
    anchored: bool,
    iter_len: int,
    span: int,
) -> List[Match]:
    """Unit / rdamerau search on the bit-parallel engine: distances for
    every end position on device, a two-phase fetch of the hit-bearing
    row blocks, then lengths from the oracle replay (the replay IS the
    tie-break semantics)."""
    import jax.numpy as jnp

    from .ops.pallas.myers_search import (
        collect_hits,
        fetch_candidate_blocks,
        myers_search_block_mins_from_hay,
        prepare_peq,
        search_halo,
        search_own_len,
        seg_count,
    )

    m = len(needle)
    damerau = _costs_tuple(costs) == _RDAMERAU
    if anchored:
        # anchored searches run as ONE segment starting at the anchor
        # (halo = 0; chunk boundaries would break the absolute row-0
        # cost D[0][j] = j); iter_len is capped at m + k columns
        halo = 0
        own_len = -(-max(iter_len, 1) // 128) * 128
    else:
        halo = search_halo(span, iter_len)
        own_len = search_own_len(iter_len, halo)
    num = seg_count(iter_len, own_len)
    path = "myers_search_rdamerau" if damerau else "myers_search"
    DispatchDecision(
        path=path,
        cost_bucket="u8",
        unit_k=halo,
        max_k=k,
        padded_m=m,
        padded_n=halo + own_len,
    ).log("levenshtein_search_simd_with_opts")
    dist_d, mins_d = myers_search_block_mins_from_hay(
        jnp.asarray(np.ascontiguousarray(haystack[:iter_len])),
        prepare_peq([needle], m),
        needle_len=m, halo=halo, own_len=own_len, num=num,
        anchored=anchored, damerau=damerau, interpret=kernel_interpret(),
    )
    blocks, rb, cols = fetch_candidate_blocks(dist_d, mins_d, k)
    _, gpos, d_arr = collect_hits(
        blocks, rb, cols, k, OUT=halo + own_len + 1, C=num, halo=halo,
        own_len=own_len, limit_pos=iter_len,
    )
    if not anchored:
        # anchored segments have no synthetic front pad (the segment
        # starts at the anchor itself), so kernel distances are exact
        # as-is and the NUL-pad correction does not apply
        gpos, d_arr = _correct_chunk0_nul_hits(
            needle, haystack, gpos, d_arr, halo, k, costs, span
        )
    if search_type == SearchType.Best and gpos.size:
        # Best-mode results only contain candidates at the global minimum
        # cost (the streaming pass keeps k == final curr_k, reference
        # levenshtein.rs:1812-1835) — only those need lengths
        gpos = gpos[d_arr == d_arr.min()]
    if anchored:
        # one anchored All-mode replay recovers every hit's length; it
        # costs the same O(m * iter_len) DP work the scan path would
        # spend on the whole anchored search, so no budget applies
        cands = _resolve_hits_anchored(needle, haystack, gpos, k, costs)
    else:
        cands = _resolve_hits(needle, haystack, gpos, k, costs, span,
                              iter_len)
    return _postprocess_sparse(cands, k, search_type)


def levenshtein_search_simd_with_opts(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    anchored: bool = False,
) -> List[Match]:
    """Device-accelerated approximate search (reference levenshtein.rs:
    1911-2155).

    The device computes the distance (and, on the scan path, the
    max-length) for every end position; the host applies threshold /
    Best / overlap-dedup streaming semantics.  Long haystacks are processed
    as parallel overlapping segments (halo = max window span), which is
    exact for every candidate with cost <= k — see ops/search_scan.py.
    Unit and rdamerau costs with needles up to 256 chars run the
    bit-parallel Myers engine (ops/pallas/myers_search.py); everything
    else runs the anti-diagonal search wavefront.
    """
    from .ops.search_scan import chunk_haystack, search_scan, window_span

    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    m, n = len(needle), len(haystack)

    if m == 0:
        return _empty_needle_matches(n, k, search_type, costs, anchored)

    costs.check_search()

    if forced_path() == "oracle":
        return levenshtein_search_naive_with_opts(
            needle, haystack, k, search_type, costs, anchored
        )

    if anchored:
        iter_len = min(
            m + max(0, k - costs.start_gap_cost) // costs.gap_cost, n
        )
    else:
        iter_len = n

    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
    if iter_len > 0 and _search_on_kernel(m, costs):
        return _myers_search_dispatch(
            needle, haystack, k, search_type, costs, anchored, iter_len,
            span,
        )

    halo = 0 if anchored else span
    # longer segments amortize halo overlap and host-side prep
    chunk_target = 4096
    if iter_len <= chunk_target or anchored:
        own_len = round_up_pow2(max(iter_len, 1), 16)
    else:
        own_len = chunk_target

    seg_pad, seg_n, seg_off, own_start, seg_len = chunk_haystack(
        haystack[:iter_len], m, halo, own_len
    )
    DispatchDecision(
        path="scan",
        cost_bucket=select_cost_bucket(k if k < U32_MAX else U32_MAX),
        unit_k=halo,
        max_k=k,
        padded_m=m,
        padded_n=seg_len,
    ).log("levenshtein_search_simd_with_opts")

    dist_seg, len_seg = search_scan(
        needle.astype(np.int32),
        seg_pad,
        seg_n,
        seg_off,
        needle_len=m,
        seg_len=seg_len,
        costs_t=_costs_tuple(costs),
        anchored=anchored,
    )
    dist_seg = np.asarray(dist_seg)
    len_seg = np.asarray(len_seg)

    # stitch owned ranges into global per-end-position arrays
    dists = np.full(iter_len + 1, np.int64(1) << 40, dtype=np.int64)
    lengths = np.zeros(iter_len + 1, dtype=np.int64)
    C = dist_seg.shape[0]
    for c in range(C):
        o = int(own_start[c])
        s0 = int(seg_off[c])
        lo_local = o - s0  # first owned end position, local
        hi_local = min(int(seg_n[c]), lo_local + own_len)
        if c == 0:
            # chunk 0 also owns global end position 0 (the empty prefix)
            dists[0] = dist_seg[0, 0]
            lengths[0] = len_seg[0, 0]
        g0 = s0 + lo_local + 1
        g1 = min(s0 + hi_local, iter_len)
        if g1 >= g0:
            dists[g0 : g1 + 1] = dist_seg[c, lo_local + 1 : lo_local + 1 + (g1 - g0 + 1)]
            lengths[g0 : g1 + 1] = len_seg[c, lo_local + 1 : lo_local + 1 + (g1 - g0 + 1)]

    return postprocess_matches(dists, lengths, k, search_type)


class PackedHaystack:
    """A haystack pre-packed for repeated dictionary searches.

    The serving pattern: build once, then call `levenshtein_search_many`
    with it many times — the raw haystack is uploaded once and the
    segmented device layout is built on device and held there, once per
    distinct (halo, owned length) (and per mesh, for sharded serving).
    The packs snapshot the haystack at construction; mutate the original
    array afterwards and the snapshot (deliberately) keeps answering for
    the old contents.
    """

    def __init__(self, haystack: BytesLike):
        self.haystack = np.ascontiguousarray(to_bytes_array(haystack))
        self._packs: dict = {}
        self._hay_dev = None

    def __len__(self) -> int:
        return len(self.haystack)

    def device_haystack(self):
        """The raw haystack as a device array (uploaded once, memoized)."""
        import jax.numpy as jnp

        if self._hay_dev is None:
            self._hay_dev = jnp.asarray(self.haystack)
        return self._hay_dev

    def pack(self, halo: int, own_len: int):
        """Device-resident [seg_len, C_pad] segment pack (memoized), built
        on device from the once-uploaded raw haystack.  Returns (seg_t,
        num_segments)."""
        from .ops.pallas.myers_search import device_pack_segs, seg_count

        key = (halo, own_len)
        hit = self._packs.get(key)
        if hit is None:
            num = seg_count(len(self.haystack), own_len)
            hit = (
                device_pack_segs(self.device_haystack(), halo=halo,
                                 own_len=own_len, num=num),
                num,
            )
            self._packs[key] = hit
        return hit

    def pack_sharded(self, mesh, halo: int, own_len: int):
        """Device-resident SHARDED segment pack (memoized per mesh and
        configuration): the haystack splits into equal [D, S] shards, one
        ppermute halo ring + windows + transpose run per device
        (`parallel.sharded_pack_segs`), and the lane-sharded pack stays on
        the mesh.  Returns (seg_t, shard_size, num_local)."""
        from .parallel.sharded import shard_haystack, sharded_pack_segs

        key = (tuple(d.id for d in mesh.devices.flat), halo, own_len)
        hit = self._packs.get(key)
        if hit is None:
            shards, S = shard_haystack(self.haystack, int(mesh.devices.size),
                                       halo, own_len)
            seg_t = sharded_pack_segs(mesh, shards, halo=halo,
                                      own_len=own_len)
            hit = (seg_t, S, S // own_len)
            self._packs[key] = hit
        return hit


def levenshtein_search_sharded(
    needle: BytesLike,
    haystack: BytesLike,
    k: int,
    mesh,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
) -> List[Match]:
    """Unanchored search of ONE long haystack sharded across a device mesh
    (the SP/ring strategy, SURVEY.md §2.5) — results are exactly
    `levenshtein_search_simd_with_opts`'s, only the placement differs.

    ANCHORED search is deliberately N/A here: an anchored match is pinned
    to the haystack head (row 0 costs are absolute prefix costs,
    reference levenshtein.rs:1710-1719), its iteration is capped at
    needle_len + (k - start_gap)/gap columns, and only shard 0 could ever
    own it.  Call `levenshtein_search_simd_with_opts(anchored=True)` on
    one device instead.

    Each device holds one contiguous shard; one `lax.ppermute` hands each
    shard's tail to its right neighbour as the halo, each device windows
    and searches its own shard, and hits assemble host-side under the
    owner-by-end rule (`parallel.collect_sharded_hits`).  Unit and
    rdamerau needles within the word limit run the bit-parallel Myers
    engine per device (`parallel.sharded_myers_search_mins`); everything
    else runs the sharded scan wavefront (`parallel.sharded_search_step`),
    which needs the window span to fit one shard.
    """
    from .ops.pallas.myers_search import search_halo, search_own_len
    from .ops.search_scan import window_span
    from .parallel.sharded import (
        assemble_sharded_search,
        collect_sharded_hits,
        shard_haystack,
        sharded_myers_search_mins,
        sharded_search_step,
    )

    needle = to_bytes_array(needle)
    haystack = to_bytes_array(haystack)
    m, n = len(needle), len(haystack)
    if m == 0:
        return _empty_needle_matches(n, k, search_type, costs, False)
    costs.check_search()
    D = int(mesh.devices.size)
    span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)

    if n > 0 and _search_on_kernel(m, costs):
        from .ops.pallas.myers_search import prepare_peq

        halo = search_halo(span, n)
        own_len = search_own_len(-(-n // D), halo)
        shards, S = shard_haystack(haystack, D, halo, own_len)
        DispatchDecision(
            path="myers_search_sharded",
            cost_bucket="u8",
            unit_k=halo,
            max_k=k,
            padded_m=m,
            padded_n=S,
        ).log("levenshtein_search_sharded")
        dist_d, mins_d = sharded_myers_search_mins(
            mesh, shards, prepare_peq([needle], m), needle_len=m, halo=halo,
            own_len=own_len, damerau=_costs_tuple(costs) == _RDAMERAU,
            interpret=kernel_interpret(),
        )
        _, gpos, d_arr = collect_sharded_hits(
            dist_d, mins_d, D=D, k=k, halo=halo, own_len=own_len,
            shard_size=S, n_total=n,
        )
        gpos, d_arr = _correct_chunk0_nul_hits(
            needle, haystack, gpos, d_arr, halo, k, costs, span
        )
        if search_type == SearchType.Best and gpos.size:
            gpos = gpos[d_arr == d_arr.min()]
        cands = _resolve_hits(needle, haystack, gpos, k, costs, span, n)
        return _postprocess_sparse(cands, k, search_type)

    S = -(-n // D)
    if min(span, n) > S:
        raise ValueError(
            f"window span {span} exceeds the {S}-char shards of a "
            f"{n}-char haystack over {D} devices; use fewer devices"
        )
    DispatchDecision(
        path="scan_search_sharded",
        cost_bucket=select_cost_bucket(k if k < U32_MAX else U32_MAX),
        unit_k=min(span, n),
        max_k=k,
        padded_m=m,
        padded_n=S,
    ).log("levenshtein_search_sharded")
    shards = np.full((D, S), -1, dtype=np.int32)
    shard_n = np.zeros(D, dtype=np.int32)
    for d in range(D):
        seg = haystack[d * S : (d + 1) * S]
        shards[d, : len(seg)] = seg
        shard_n[d] = len(seg)
    dist, length = sharded_search_step(
        mesh, needle.astype(np.int32), shards, shard_n,
        needle_len=m, halo=min(span, n, S), costs_t=_costs_tuple(costs),
    )
    gd, gl = assemble_sharded_search(
        np.asarray(dist), np.asarray(length), shard_n, S
    )
    return postprocess_matches(gd, gl, k, search_type)


def levenshtein_search_many(
    needles: Sequence[BytesLike],
    haystack,
    k: int,
    search_type: SearchType = SearchType.Best,
    costs: EditCosts = LEVENSHTEIN_COSTS,
    mesh=None,
) -> List[List[Match]]:
    """Dictionary search: every needle against one haystack, unanchored.

    Beyond the reference's scope (it searches one needle at a time): for
    unit and rdamerau costs, same-length needles share ONE kernel launch
    with a grid axis over needles — the haystack is uploaded, segmented
    and held on the device once, and each needle's recurrence sweeps it in
    parallel lanes.  Other cost models (and needles past the word
    limit) fall back to per-needle dispatch.  Returns one Match list per
    needle, each identical to
    `levenshtein_search_simd_with_opts(needle, ...)`.

    `haystack` may be a `PackedHaystack` to reuse the segmented device
    layout across calls (the repeated-serving fast path).

    `mesh` serves the dictionary SHARDED: each device holds its shard of
    the segment pack (`PackedHaystack.pack_sharded`, resident across
    calls), needles broadcast, and every same-length group still runs as
    one multi-needle launch per device; hits assemble per needle under
    the owner-by-end rule.  Results are identical to the meshless call.
    """
    from .ops.pallas.myers_search import (
        collect_hits,
        fetch_candidate_blocks,
        myers_search_block_mins,
        prepare_peq,
        search_halo,
        search_own_len,
    )
    from .ops.search_scan import window_span

    needles = [to_bytes_array(nd) for nd in needles]
    packed: Optional[PackedHaystack] = None
    if isinstance(haystack, PackedHaystack):
        packed = haystack
        haystack = packed.haystack
    else:
        haystack = to_bytes_array(haystack)
    n = len(haystack)
    costs.check_search()
    results: List[Optional[List[Match]]] = [None] * len(needles)
    damerau = _costs_tuple(costs) == _RDAMERAU

    def _single(i):
        if mesh is not None:
            return levenshtein_search_sharded(
                needles[i], haystack, k, mesh, search_type, costs
            )
        return levenshtein_search_simd_with_opts(
            needles[i], haystack, k, search_type, costs, False
        )

    # group same-length needles into shared launches
    by_len: dict = {}
    for i, nd in enumerate(needles):
        by_len.setdefault(len(nd), []).append(i)
    planned = []
    for m, idxs in sorted(by_len.items()):
        if not (n > 0 and _search_on_kernel(m, costs)):
            for i in idxs:
                results[i] = _single(i)
            continue
        planned.append((m, idxs))
    if not planned:
        return results  # type: ignore[return-value]

    # ONE pack serves every length group: the halo is the largest group's
    # (a larger overlap is still exact), so the raw haystack is uploaded
    # and segmented once per call (once per PackedHaystack across calls)
    D = 1 if mesh is None else int(mesh.devices.size)
    halo = max(search_halo(window_span(m, k, 1, 0), n) for m, _ in planned)
    own_len = search_own_len(-(-n // D), halo)
    seg_len = halo + own_len
    if packed is None:
        packed = PackedHaystack(haystack)
    if mesh is not None:
        seg_t, S_sh, C = packed.pack_sharded(mesh, halo, own_len)
    else:
        seg_t, C = packed.pack(halo, own_len)

    for m, idxs in planned:
        NUM = len(idxs)
        peq = prepare_peq([needles[i] for i in idxs], m)
        DispatchDecision(
            path=("myers_search_many_sharded" if mesh is not None
                  else "myers_search_many"),
            cost_bucket="u8",
            unit_k=halo,
            max_k=k,
            padded_m=m,
            padded_n=NUM,
        ).log("levenshtein_search_many")
        if mesh is not None:
            from .parallel.sharded import (
                collect_sharded_hits,
                sharded_myers_search_mins_packed,
            )

            dist_d, mins_d = sharded_myers_search_mins_packed(
                mesh, seg_t, peq, needle_len=m, seg_len=seg_len,
                damerau=damerau, interpret=kernel_interpret(),
            )
            ni_a, gpos_a, d_a = collect_sharded_hits(
                dist_d, mins_d, D=D, k=k, halo=halo, own_len=own_len,
                shard_size=S_sh, n_total=n, num_needles=NUM,
            )
        else:
            dist_d, mins_d = myers_search_block_mins(
                peq, seg_t, needle_len=m, seg_len=seg_len, damerau=damerau,
                interpret=kernel_interpret(),
            )
            blocks, rb, cols = fetch_candidate_blocks(dist_d, mins_d, k)
            ni_a, gpos_a, d_a = collect_hits(
                blocks, rb, cols, k, OUT=seg_len + 1, C=C, halo=halo,
                own_len=own_len, limit_pos=n, num_needles=NUM,
            )
        span = min(window_span(m, k, costs.gap_cost, costs.start_gap_cost), n)
        for slot, i in enumerate(idxs):
            sel = ni_a == slot
            gpos, d_arr = _correct_chunk0_nul_hits(
                needles[i], haystack, gpos_a[sel], d_a[sel], halo, k, costs,
                span,
            )
            if search_type == SearchType.Best and gpos.size:
                gpos = gpos[d_arr == d_arr.min()]
            cands = _resolve_hits(needles[i], haystack, gpos, k, costs, span,
                                  n)
            results[i] = _postprocess_sparse(cands, k, search_type)
    return results  # type: ignore[return-value]


def levenshtein_search_simd(needle: BytesLike, haystack: BytesLike) -> List[Match]:
    """Default device search: k = ceil(len/2), Best, unit costs, unanchored
    (reference levenshtein.rs:1866-1878)."""
    needle = to_bytes_array(needle)
    return levenshtein_search_simd_with_opts(
        needle,
        haystack,
        default_search_k(len(needle)),
        SearchType.Best,
        LEVENSHTEIN_COSTS,
        False,
    )


def levenshtein_search(needle: BytesLike, haystack: BytesLike) -> List[Match]:
    """Blessed search entry point (reference levenshtein.rs:2508-2510).

    >>> levenshtein_search(b"abc", b"  abd") == [Match(start=2, end=5, k=1)]
    True
    """
    return levenshtein_search_simd(needle, haystack)
