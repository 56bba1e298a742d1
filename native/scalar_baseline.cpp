// Honest compiled-CPU comparators for bench.py's vs_baseline.
//
// The reference's published perf claim ("up to 20-30x", README.md:10) is
// its SIMD layer over its *scalar* cores; a fair vs_baseline for the device
// build therefore needs a compiled scalar core, not the pure-Python
// oracle.  Two single-threaded comparators, -O3:
//
//  * ta_scalar_banded_batch — banded scalar DP, a faithful C++ port of the
//    oracle's levenshtein_naive_k_with_opts (itself cell-exact with the
//    reference's scalar core, /root/reference/src/levenshtein.rs:376-607).
//    This is the baseline the reference's 20-30x claim is measured against.
//
//  * ta_myers_distance_batch — bit-parallel Myers 1999 distance with
//    64-bit words (unit costs), the strongest simple single-core CPU
//    algorithm for this workload; a stand-in for the reference's SIMD
//    class so the bench can report an honest "vs best-CPU" multiple too.
//
// Both agree exactly with the Python oracle (tests/test_native_baseline.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t INF = (int64_t(1) << 32) - 1;  // u32::MAX stand-in

inline int64_t sat_add(int64_t x, int64_t y) {
    int64_t s = x + y;
    return s > INF ? INF : s;
}

// mirrors oracle/levenshtein.py compute_max_k (reference levenshtein.rs:399-423)
int64_t compute_max_k(int64_t a_len, int64_t b_len, int64_t k, int64_t mc,
                      int64_t gc, int64_t sgc) {
    int64_t min_len = a_len < b_len ? a_len : b_len;
    int64_t max_len = a_len < b_len ? b_len : a_len;
    int64_t cap1 = min_len * mc;
    int64_t cap2 = (min_len << 1) * gc +
                   (min_len == 0 ? 0 : sgc + (max_len == min_len ? sgc : 0));
    int64_t max_k = cap1 < cap2 ? cap1 : cap2;
    int64_t withdiff =
        max_k + (max_len - min_len) * gc + (max_len == min_len ? 0 : sgc);
    return k < withdiff ? k : withdiff;
}

inline int64_t compute_unit_k(int64_t max_k, int64_t gc, int64_t sgc) {
    int64_t num = max_k - sgc;
    return num > 0 ? num / gc : 0;
}

// banded scalar DP for one pair; returns -1 when over the capped threshold.
// Faithful port of oracle/levenshtein.py:214-342 (distance only).
int64_t banded_one(const uint8_t* a0, int64_t a_len0, const uint8_t* b0,
                   int64_t b_len0, int64_t k, int64_t mc, int64_t gc,
                   int64_t sgc, int64_t tc, bool allow_transpose,
                   std::vector<int64_t>& buf) {
    const uint8_t* a = a0;
    const uint8_t* b = b0;
    int64_t a_len = a_len0, b_len = b_len0;
    if (a_len > b_len) {
        a = b0; b = a0;
        a_len = b_len0; b_len = a_len0;
    }
    int64_t max_k = compute_max_k(a_len, b_len, k, mc, gc, sgc);
    int64_t unit_k = compute_unit_k(max_k, gc, sgc);
    if (b_len - a_len > unit_k) return -1;

    int64_t hi = unit_k + 1 < b_len + 1 ? unit_k + 1 : b_len + 1;
    int64_t lo = 0, prev_lo1 = 0;
    int64_t k_len = (unit_k << 1) + 1 < b_len + 1 ? (unit_k << 1) + 1 : b_len + 1;
    buf.assign(5 * k_len, 0);
    int64_t* dp0 = buf.data();
    int64_t* dp1 = dp0 + k_len;
    int64_t* dp2 = dp1 + k_len;
    int64_t* a_gap = dp2 + k_len;
    int64_t* b_gap = a_gap + k_len;
    for (int64_t i = 0; i < k_len; ++i) { a_gap[i] = INF; b_gap[i] = INF; }
    for (int64_t i = 0; i < hi - lo; ++i)
        dp1[i] = i * gc + (i == 0 ? 0 : sgc);

    for (int64_t i = 1; i <= a_len; ++i) {
        int64_t prev_lo0 = prev_lo1;
        prev_lo1 = lo;
        int64_t prev_hi = hi;
        hi = hi + 1 < b_len + 1 ? hi + 1 : b_len + 1;
        if (i > unit_k) ++lo;

        for (int64_t j = 0; j < hi - lo; ++j) {
            int64_t idx = lo + j;
            int64_t sub = idx == 0
                              ? INF
                              : dp1[idx - 1 - prev_lo1] +
                                    (a[i - 1] != b[idx - 1] ? mc : 0);
            a_gap[j] = j == 0 ? INF
                              : (dp2[j - 1] + sgc + gc <
                                         sat_add(a_gap[j - 1], gc)
                                     ? dp2[j - 1] + sgc + gc
                                     : sat_add(a_gap[j - 1], gc));
            if (idx >= prev_hi) {
                b_gap[j] = INF;
            } else {
                int64_t ng = dp1[idx - prev_lo1] + sgc + gc;
                int64_t cg = sat_add(b_gap[idx - prev_lo1], gc);
                b_gap[j] = ng < cg ? ng : cg;
            }
            int64_t v = sub;
            if (a_gap[j] < v) v = a_gap[j];
            if (b_gap[j] < v) v = b_gap[j];
            if (allow_transpose && i > 1 && idx > 1 &&
                a[i - 1] == b[idx - 2] && a[i - 2] == b[idx - 1]) {
                int64_t trans = dp0[idx - prev_lo0 - 2] + tc;
                if (trans <= v) v = trans;
            }
            dp2[j] = v;
        }
        int64_t* t = dp0; dp0 = dp1; dp1 = dp2; dp2 = t;
    }
    int64_t dist = dp1[hi - lo - 1];
    return dist > max_k ? -1 : dist;
}

}  // namespace

extern "C" {

// Batched banded scalar distance, unit or general costs; out[i] = -1 where
// over the (capped) threshold, mirroring levenshtein_k_batch.
int64_t ta_scalar_banded_batch(const uint8_t* a, const int64_t* a_lens,
                               int64_t a_stride, const uint8_t* b,
                               const int64_t* b_lens, int64_t b_stride,
                               int64_t batch, int64_t k, int32_t mc,
                               int32_t gc, int32_t sgc, int32_t tc,
                               int32_t allow_transpose, int64_t* out) {
    std::vector<int64_t> buf;
    for (int64_t p = 0; p < batch; ++p) {
        out[p] = banded_one(a + p * a_stride, a_lens[p], b + p * b_stride,
                            b_lens[p], k, mc, gc, sgc, tc,
                            allow_transpose != 0, buf);
    }
    return batch;
}

// Batched bit-parallel Myers 1999 distance (unit costs, 64-bit words) —
// the strong single-core CPU comparator.  Pattern = shorter string.
int64_t ta_myers_distance_batch(const uint8_t* a, const int64_t* a_lens,
                                int64_t a_stride, const uint8_t* b,
                                const int64_t* b_lens, int64_t b_stride,
                                int64_t batch, int64_t k, int64_t* out) {
    std::vector<uint64_t> peq;
    for (int64_t p = 0; p < batch; ++p) {
        const uint8_t* pa = a + p * a_stride;
        const uint8_t* pb = b + p * b_stride;
        int64_t m = a_lens[p], n = b_lens[p];
        if (m > n) {
            const uint8_t* t = pa; pa = pb; pb = t;
            int64_t tl = m; m = n; n = tl;
        }
        if (m == 0) { out[p] = n <= k ? n : -1; continue; }
        int64_t W = (m + 63) / 64;
        peq.assign(size_t(W) * 256, 0);
        for (int64_t i = 0; i < m; ++i)
            peq[size_t(i / 64) * 256 + pa[i]] |= uint64_t(1) << (i % 64);
        std::vector<uint64_t> Pv(W, ~uint64_t(0)), Mv(W, 0);
        int64_t score = m;
        int last_bit = int((m - 1) % 64);
        for (int64_t j = 0; j < n; ++j) {
            int hin = 1;  // D[0][j] - D[0][j-1] = +1 (global alignment row 0)
            uint8_t c = pb[j];
            for (int64_t w = 0; w < W; ++w) {
                uint64_t Eq = peq[size_t(w) * 256 + c];
                uint64_t pv = Pv[w], mv = Mv[w];
                uint64_t Xv = Eq | mv;
                if (hin < 0) Eq |= 1;
                uint64_t Xh = (((Eq & pv) + pv) ^ pv) | Eq;
                uint64_t Ph = mv | ~(Xh | pv);
                uint64_t Mh = pv & Xh;
                if (w == W - 1)
                    score += int64_t((Ph >> last_bit) & 1) -
                             int64_t((Mh >> last_bit) & 1);
                int hout = int((Ph >> 63) & 1) - int((Mh >> 63) & 1);
                Ph = (Ph << 1) | uint64_t(hin > 0);
                Mh = (Mh << 1) | uint64_t(hin < 0);
                Pv[w] = Mh | ~(Xv | Ph);
                Mv[w] = Ph & Xv;
                hin = hout;
            }
        }
        out[p] = score <= k ? score : -1;
    }
    return batch;
}

}  // extern "C"

namespace {

// Search DP with match-length tracking — a faithful C++ port of the
// Python oracle's levenshtein_search_naive_with_opts inner loop
// (oracle/levenshtein.py:351-508; reference levenshtein.rs:1589-1838),
// All-mode: emits (end, dist, length) for every end position with
// dist <= k, including the exact maximize-length tie-break order.
int64_t search_all_one(const uint8_t* needle, int64_t m, const uint8_t* hay,
                       int64_t n, int64_t k, int64_t mc, int64_t gc,
                       int64_t sgc, int64_t tc, bool allow_transpose,
                       bool anchored, int64_t cap, int64_t* out_end,
                       int64_t* out_k, int64_t* out_len) {
    if (m == 0) return 0;  // callers handle the empty-needle special cases
    int64_t length = m + 1;
    std::vector<int64_t> dp0(length, 0), dp1(length, 0), dp2(length, 0);
    std::vector<int64_t> ng(length, INF), hg(length, INF);
    std::vector<int64_t> len0(length, 0), len1(length, 0), len2(length, 0);
    std::vector<int64_t> ngl(length, 0), hgl(length, 0);

    int64_t iter_len = n;
    if (anchored) {
        int64_t cap_cols = m + (k > sgc ? (k - sgc) / gc : 0);
        iter_len = cap_cols < n ? cap_cols : n;
    }
    int64_t cnt = 0;
    for (int64_t j = 0; j < length; ++j)
        dp1[j] = j * gc + (j == 0 ? 0 : sgc);
    if (dp1[m] <= k && cnt < cap) {
        out_end[cnt] = 0; out_k[cnt] = dp1[m]; out_len[cnt] = 0; ++cnt;
    }
    for (int64_t i = 0; i < iter_len; ++i) {
        int64_t boundary = anchored ? (i + 1) * gc + sgc : 0;
        ng[0] = boundary;
        dp2[0] = boundary;
        ngl[0] = 0;
        len2[0] = 0;
        for (int64_t j = 1; j < length; ++j) {
            int64_t sub =
                dp1[j - 1] + (needle[j - 1] != hay[i] ? mc : 0);

            int64_t new_gap = dp1[j] + sgc + gc;
            int64_t cont_gap = sat_add(ng[j], gc);
            if (new_gap < cont_gap) {
                ng[j] = new_gap; ngl[j] = len1[j] + 1;
            } else if (new_gap > cont_gap) {
                ng[j] = cont_gap; ngl[j] += 1;
            } else {
                ng[j] = cont_gap;
                ngl[j] = (len1[j] > ngl[j] ? len1[j] : ngl[j]) + 1;
            }

            new_gap = dp2[j - 1] + sgc + gc;
            cont_gap = sat_add(hg[j - 1], gc);
            if (new_gap < cont_gap) {
                hg[j] = new_gap; hgl[j] = len2[j - 1];
            } else if (new_gap > cont_gap) {
                hg[j] = cont_gap; hgl[j] = hgl[j - 1];
            } else {
                hg[j] = cont_gap;
                hgl[j] = len2[j - 1] > hgl[j - 1] ? len2[j - 1] : hgl[j - 1];
            }

            dp2[j] = ng[j];
            len2[j] = ngl[j];
            if (hg[j] < dp2[j] || (hg[j] == dp2[j] && len2[j - 1] > len2[j])) {
                dp2[j] = hg[j];
                len2[j] = hgl[j];
            }
            if (sub < dp2[j] ||
                (sub == dp2[j] && len1[j - 1] + 1 > len2[j])) {
                dp2[j] = sub;
                len2[j] = len1[j - 1] + 1;
            }
            if (allow_transpose && i > 0 && j > 1 &&
                needle[j - 1] == hay[i - 1] && needle[j - 2] == hay[i]) {
                int64_t transpose = dp0[j - 2] + tc;
                if (transpose <= dp2[j]) {
                    dp2[j] = transpose;
                    len2[j] = len0[j - 2] + 2;
                }
            }
        }
        int64_t final_res = dp2[m], final_len = len2[m];
        dp0.swap(dp1); dp1.swap(dp2);
        len0.swap(len1); len1.swap(len2);
        if (final_res <= k) {
            if (cnt >= cap) return -1;  // caller retries with a bigger cap
            out_end[cnt] = i + 1; out_k[cnt] = final_res;
            out_len[cnt] = final_len; ++cnt;
        }
    }
    return cnt;
}

}  // namespace

extern "C" {

// All-mode search candidates: every end position with dist <= k, with the
// oracle's exact maximize-length tie-break.  Returns the candidate count,
// or -1 if `cap` was too small.
int64_t ta_search_all(const uint8_t* needle, int64_t m, const uint8_t* hay,
                      int64_t n, int64_t k, int32_t mc, int32_t gc,
                      int32_t sgc, int32_t tc, int32_t allow_transpose,
                      int32_t anchored, int64_t cap, int64_t* out_end,
                      int64_t* out_k, int64_t* out_len) {
    return search_all_one(needle, m, hay, n, k, mc, gc, sgc, tc,
                          allow_transpose != 0, anchored != 0, cap, out_end,
                          out_k, out_len);
}

// Batched hit resolution: run the unanchored All-mode streaming search DP
// over a list of disjoint haystack intervals [starts[i], ends[i]) in one
// call, emitting every candidate with its GLOBAL end position (starts[i]
// + local end).  A candidate ending at global position p depends only on
// the window of chars [p - span, p), so replaying a merged interval that
// contains each hit's window is exact (see levenshtein._hit_resolve).
// One call replaces the former per-hit Python/ctypes loop; for dense hit
// streams the intervals merge into a single O(n*m) streaming pass.
// Returns the total candidate count, or -1 if `cap` was too small.
int64_t ta_search_intervals(const uint8_t* needle, int64_t m,
                            const uint8_t* hay, int64_t n,
                            const int64_t* starts, const int64_t* ends,
                            int64_t nint, int64_t k, int32_t mc, int32_t gc,
                            int32_t sgc, int32_t tc,
                            int32_t allow_transpose, int64_t cap,
                            int64_t* out_end, int64_t* out_k,
                            int64_t* out_len) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < nint; ++i) {
        int64_t s = starts[i];
        int64_t e = ends[i];
        if (s < 0) s = 0;
        if (e > n) e = n;
        if (e < s) continue;
        int64_t got = search_all_one(needle, m, hay + s, e - s, k, mc, gc,
                                     sgc, tc, allow_transpose != 0, false,
                                     cap - cnt, out_end + cnt, out_k + cnt,
                                     out_len + cnt);
        if (got < 0) return -1;
        for (int64_t q = 0; q < got; ++q) out_end[cnt + q] += s;
        cnt += got;
    }
    return cnt;
}

}  // extern "C"
