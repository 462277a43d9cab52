// agg_ranges: per query, the count of eligible rows in each of nb ranges
// where a row may lie in several (top-level ranges count every match), and
// for each metric sub-aggregation the per-range n / sum / sum of squares /
// min / max.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py compute_aggs (K17c), the range
// and geodist_range branch 396-423 (float bounds [lo, hi) on the value,
// or on _haversine's distance from an origin, executor.py:406-413), the
// key_range branch 324-343 and the geo_ip branch 344-371, both through
// _key_ranges_membership 77-104 (a doc is in a key interval when its
// [min, max] key pair overlaps it and, for a doc of >= 2 values, one of
// its first vmax per-value keys lies in it); geo_ip's one-hot product of
// interval hits by bucket (:364-366) is an OR over each bucket's
// intervals here. With their metric sub-aggregations _sub_stats_bucketed
// 107-155 (n, s, s2, min, max).
//
// A row r of query b, d = min(ids[b, r], n - 1), is in range j when
// eligible[b, r], present[d], and:
//   mode 0 range    lo_j <= fval[d] < hi_j
//   mode 1 geodist  lo_j <= haversine(fval[d], fval2[d] or 0, origin) < hi_j
//   mode 2 key      the key interval j holds one of the doc's values
//   mode 3 geo_ip   some interval i with assign[i] == j holds one
//
// Grid (G, B), 256 threads, one row a thread at a time, rows split in G
// ranges of about 256 rows (ops/kernels.py agg_ranges): counts in a shared-memory histogram (int atomics, order-free)
// added into the zeroed output; where subs (or agg_hist's hist2) need it,
// the row's membership of each range is written to member[b][r][j] (one
// byte). Subs: a second kernel, grid (G, B), one thread a range walks its
// block's rows in row order (member bytes of neighbouring ranges are
// neighbouring bytes; every lane gathers the same docid's value), so each
// range's float sums run in row order without float atomics; a third
// folds the G partials in order. Two runs give the same bits.
//
// Bound on the H100: one byte of eligible flags a row and, per eligible
// row, the value gather(s) (key modes: four key words, and vmax per-value
// keys for a doc of several values) and a test per range (per interval:
// geo_ip's nb x ncidr loop exits at a bucket's first hit); the member
// matrix, written and read once, where subs exist.
#include "common.cuh"

#define AR_THREADS 256
#define AR_MAXNB 4096

struct RangeSrc {
    int mode;
    const float* fval;
    const float* fval2;           // geodist: null reads a longitude of 0
    const unsigned char* present;
    long long n;                  // rows of the value columns
    const int* hi;                // key modes: the (min) key pair
    const int* lo;
    const int* max_hi;            // the max key pair
    const int* max_lo;
    const int* mv_off;            // per-value keys (null: none)
    const int* mv_len;
    const int* mv_hi;
    const int* mv_lo;
    long long nmv;                // rows of mv_hi / mv_lo
    int vmax;
    const float* fb;              // [B][nr][2] float bounds
    const int* kb;                // [B][nr][4] key bounds (hi, lo, hi, lo)
    const int* assign;            // [B][nr] geo_ip: interval -> bucket
    const float* origin;          // [B][2] geodist: lat, lon
    int nr;                       // ranges (geo_ip: intervals)
};

// _key_ranges_membership for one doc row dd and one interval k[4]
// (lex_ge / lex_le: common.cuh)
__device__ __forceinline__ bool key_in(const RangeSrc& s, long long dd,
                                       const int* k) {
    if (!(lex_ge(s.max_hi[dd], s.max_lo[dd], k[0], k[1]) &&
          lex_le(s.hi[dd], s.lo[dd], k[2], k[3])))
        return false;
    if (s.vmax <= 1 || s.mv_hi == nullptr) return true;
    const int cnt = s.mv_len[dd];
    if (cnt == 0) return true;
    const long long off = s.mv_off[dd];
    for (int v = 0; v < s.vmax && v < cnt; ++v) {
        long long i = off + v;
        if (i > s.nmv - 1) i = s.nmv - 1;
        const int h = s.mv_hi[i], l = s.mv_lo[i];
        if (lex_ge(h, l, k[0], k[1]) && lex_le(h, l, k[2], k[3]))
            return true;
    }
    return false;
}

// is row docid d of query b in bucket j (eligibility tested by the caller)
__device__ __forceinline__ bool in_bucket(const RangeSrc& s, int b, int d,
                                          int j, float v) {
    const long long dd = (long long)d < s.n - 1 ? d : s.n - 1;
    if (s.mode <= 1) {
        const float* f = s.fb + ((long long)b * s.nr + j) * 2;
        return v >= f[0] && v < f[1];
    }
    const int* kb = s.kb + (long long)b * s.nr * 4;
    if (s.mode == 2) return key_in(s, dd, kb + 4 * j);
    const int* as = s.assign + (long long)b * s.nr;
    for (int i = 0; i < s.nr; ++i)
        if (as[i] == j && key_in(s, dd, kb + 4 * i)) return true;
    return false;
}

// the value a float mode tests (range: fval; geodist: the distance)
__device__ __forceinline__ float row_value(const RangeSrc& s, int b,
                                           long long dd) {
    if (s.mode == 0) return s.fval[dd];
    if (s.mode == 1) {
        const float lon = s.fval2 != nullptr ? s.fval2[dd] : 0.0f;
        return haversine(s.fval[dd], lon, s.origin[2 * b],
                         s.origin[2 * b + 1]);
    }
    return 0.0f;
}

__global__ void __launch_bounds__(AR_THREADS) agg_ranges_count(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, int G, const RangeSrc src, int nb,
    int* __restrict__ counts, unsigned char* __restrict__ member) {
    __shared__ int hist[AR_MAXNB];
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const long long base = (long long)b * R;
    const long long r0 = R * g / G, r1 = R * (g + 1) / G;
    for (int c = t; c < nb; c += AR_THREADS) hist[c] = 0;
    __syncthreads();
    for (long long r = r0 + t; r < r1; r += AR_THREADS) {
        unsigned char* mrow = member != nullptr
            ? member + (base + r) * nb : nullptr;
        const int d = ids[base + r];
        const long long dd = (long long)d < src.n - 1 ? d : src.n - 1;
        if (!elig[base + r] || !src.present[dd]) {
            if (mrow != nullptr)
                for (int j = 0; j < nb; ++j) mrow[j] = 0;
            continue;
        }
        const float v = row_value(src, b, dd);
        for (int j = 0; j < nb; ++j) {
            const bool in = in_bucket(src, b, d, j, v);
            if (in) atomicAdd(&hist[j], 1);
            if (mrow != nullptr) mrow[j] = in;
        }
    }
    __syncthreads();
    for (int c = t; c < nb; c += AR_THREADS)
        if (hist[c]) atomicAdd(&counts[(long long)b * nb + c], hist[c]);
}

// one thread a (sub, range): its block's rows in row order
__global__ void __launch_bounds__(AR_THREADS) agg_ranges_subs(
    const int* __restrict__ ids, long long R, int G, int nb, int S,
    const long long* __restrict__ subs,
    const unsigned char* __restrict__ member, float* __restrict__ part) {
    const int g = blockIdx.x, b = blockIdx.y;
    const long long base = (long long)b * R;
    const long long r0 = R * g / G, r1 = R * (g + 1) / G;
    const float inf = __int_as_float(0x7f800000);
    for (int i = threadIdx.x; i < S * nb; i += AR_THREADS) {
        const int si = i / nb, c = i % nb;
        const float* fval = (const float*)subs[si * 3];
        const unsigned char* pres = (const unsigned char*)subs[si * 3 + 1];
        const long long nr = subs[si * 3 + 2];
        float n = 0.0f, sm = 0.0f, sq = 0.0f, mn = inf, mx = -inf;
        for (long long r = r0; r < r1; ++r) {
            if (!member[(base + r) * nb + c]) continue;
            if (fval == nullptr) {
                n += 1.0f;
                continue;
            }
            const long long d = ids[base + r];
            const long long dd = d < nr - 1 ? d : nr - 1;
            if (!pres[dd]) continue;
            const float x = fval[dd];
            n += 1.0f;
            sm += x;
            sq += x * x;
            mn = fminf(mn, x);
            mx = fmaxf(mx, x);
        }
        float* p = part + ((((long long)b * G + g) * S + si) * nb + c) * 5;
        p[0] = n;
        p[1] = sm;
        p[2] = sq;
        p[3] = mn;
        p[4] = mx;
    }
}

// grid (B): each (sub, range) folds its G partials in order into out
// [S][5][B][nb]
__global__ void __launch_bounds__(AR_THREADS) agg_ranges_fold(
    int B, int G, int S, int nb, const float* __restrict__ part,
    float* __restrict__ out) {
    const int b = blockIdx.x;
    for (int i = threadIdx.x; i < S * nb; i += AR_THREADS) {
        const int si = i / nb, c = i % nb;
        float a[5];
        for (int g = 0; g < G; ++g) {
            const float* p =
                part + ((((long long)b * G + g) * S + si) * nb + c) * 5;
            if (g == 0) {
                for (int st = 0; st < 5; ++st) a[st] = p[st];
            } else {
                a[0] += p[0];
                a[1] += p[1];
                a[2] += p[2];
                a[3] = fminf(a[3], p[3]);
                a[4] = fmaxf(a[4], p[4]);
            }
        }
        for (int st = 0; st < 5; ++st)
            out[(((long long)si * 5 + st) * B + b) * nb + c] = a[st];
    }
}

// cols: int64 [13] in host memory = fval, fval2, present, hi, lo, max_hi,
// max_lo, mv_off, mv_len, mv_hi, mv_lo (device pointers, 0 where absent),
// n, nmv; subs: int64
// [S][3] as agg_buckets'; counts i32[B][nb] zeroed by the wrapper; member
// u8[B][R][nb] or null (required when S > 0); part f32[B*G*S*nb*5]; out
// f32[S][5][B][nb].
extern "C" int xt_agg_ranges(const void* ids, const void* elig, int B,
                             long long R, int G, int mode,
                             const long long* cols, int vmax,
                             const void* fb, const void* kb,
                             const void* assign, const void* origin, int nr,
                             int nb, int S, const void* subs, void* counts,
                             void* member, void* part, void* out,
                             void* stream) {
    if (B == 0) return 0;
    if (nb < 1 || nb > AR_MAXNB || G < 1 || S < 0 || nr < 1 || mode < 0 ||
        mode > 3 || (S > 0 && member == nullptr))
        return (int)cudaErrorInvalidValue;
    RangeSrc src;
    src.mode = mode;
    src.fval = (const float*)cols[0];
    src.fval2 = (const float*)cols[1];
    src.present = (const unsigned char*)cols[2];
    src.hi = (const int*)cols[3];
    src.lo = (const int*)cols[4];
    src.max_hi = (const int*)cols[5];
    src.max_lo = (const int*)cols[6];
    src.mv_off = (const int*)cols[7];
    src.mv_len = (const int*)cols[8];
    src.mv_hi = (const int*)cols[9];
    src.mv_lo = (const int*)cols[10];
    src.n = cols[11];
    src.nmv = cols[12];
    src.vmax = vmax;
    src.fb = (const float*)fb;
    src.kb = (const int*)kb;
    src.assign = (const int*)assign;
    src.origin = (const float*)origin;
    src.nr = nr;
    cudaStream_t st = (cudaStream_t)stream;
    agg_ranges_count<<<dim3(G, B), AR_THREADS, 0, st>>>(
        (const int*)ids, (const unsigned char*)elig, R, G, src, nb,
        (int*)counts, (unsigned char*)member);
    int rc = (int)cudaGetLastError();
    if (rc || S == 0) return rc;
    agg_ranges_subs<<<dim3(G, B), AR_THREADS, 0, st>>>(
        (const int*)ids, R, G, nb, S, (const long long*)subs,
        (const unsigned char*)member, (float*)part);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    agg_ranges_fold<<<B, AR_THREADS, 0, st>>>(B, G, S, nb,
                                              (const float*)part,
                                              (float*)out);
    return (int)cudaGetLastError();
}
