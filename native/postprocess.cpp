// Native host-side match post-processing for triple_accel_jax.
//
// The device wavefronts return per-end-position (distance, length) arrays;
// turning them into Match lists is an inherently order-dependent sequential
// pass (the Best threshold shrinks as candidates stream and overlapping
// matches replace each other — reference src/levenshtein.rs:1792-1835,
// src/hamming.rs:122-143).  For 100MB-scale haystacks this pass runs over
// ~1e8 entries, which is where NumPy-per-candidate Python costs bite; this
// C++ implementation is the production path, with a NumPy fallback kept in
// triple_accel_jax/levenshtein.py (postprocess_matches).
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstddef>

extern "C" {

// Streaming Best/All match semantics over per-position candidate arrays.
//
// dists/lengths: arrays of n_pos entries; entry i describes the candidate
//   ending after i haystack characters (i = 0 is the empty-prefix
//   candidate).  Entries with dist > k are non-candidates.
// best: 0 = All (emit every dist <= k), 1 = Best (curr_k shrinks per hit,
//   a later candidate replaces the previous buffered one when it fully
//   overlaps it (start <= previous start), and only k == final curr_k
//   survive).
// out_start/out_end/out_k: caller-allocated buffers of capacity cap.
//
// Returns the number of matches written (clamped to cap; if more matches
// exist than cap, the count still reflects only written entries — callers
// size cap = n_pos to make truncation impossible).
int64_t ta_postprocess_matches(
    const int64_t* dists,
    const int64_t* lengths,
    int64_t n_pos,
    int64_t k,
    int32_t best,
    int64_t cap,
    int64_t* out_start,
    int64_t* out_end,
    int64_t* out_k) {
  int64_t curr_k = k;
  int64_t count = 0;

  if (!best) {
    for (int64_t i = 0; i < n_pos; ++i) {
      const int64_t d = dists[i];
      if (d <= k && count < cap) {
        out_start[count] = i - lengths[i];
        out_end[count] = i;
        out_k[count] = d;
        ++count;
      }
    }
    return count;
  }

  // Best: streaming shrink + full-overlap replacement.
  for (int64_t i = 0; i < n_pos; ++i) {
    const int64_t d = dists[i];
    if (d > curr_k) continue;
    curr_k = d;
    const int64_t start = i - lengths[i];
    if (count > 0 && start <= out_start[count - 1]) {
      out_start[count - 1] = start;
      out_end[count - 1] = i;
      out_k[count - 1] = d;
    } else if (count < cap) {
      out_start[count] = start;
      out_end[count] = i;
      out_k[count] = d;
      ++count;
    }
  }

  // Keep only k == final curr_k, in place.
  int64_t w = 0;
  for (int64_t r = 0; r < count; ++r) {
    if (out_k[r] == curr_k) {
      out_start[w] = out_start[r];
      out_end[w] = out_end[r];
      out_k[w] = out_k[r];
      ++w;
    }
  }
  return w;
}

// Hamming-search Best/All postprocessing: same as above but with no
// overlap replacement (reference src/hamming.rs:122-143) and matches
// reported as [i, i + needle_len).
int64_t ta_postprocess_hamming(
    const int64_t* counts,
    int64_t n_pos,
    int64_t needle_len,
    int64_t k,
    int32_t best,
    int64_t cap,
    int64_t* out_start,
    int64_t* out_end,
    int64_t* out_k) {
  int64_t curr_k = k;
  int64_t count = 0;
  for (int64_t i = 0; i < n_pos; ++i) {
    const int64_t c = counts[i];
    if (c > curr_k) continue;
    if (best) curr_k = c;
    if (count < cap) {
      out_start[count] = i;
      out_end[count] = i + needle_len;
      out_k[count] = c;
      ++count;
    }
  }
  if (!best) return count;
  int64_t w = 0;
  for (int64_t r = 0; r < count; ++r) {
    if (out_k[r] == curr_k) {
      out_start[w] = out_start[r];
      out_end[w] = out_end[r];
      out_k[w] = out_k[r];
      ++w;
    }
  }
  return w;
}

}  // extern "C"
