// agg_buckets: per query, bucket counts of the eligible rows and, for each
// metric sub-aggregation, per-bucket n / sum / sum of squares / min / max,
// where every row falls in at most one bucket.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py compute_aggs, the terms branch
// 275-303 (facet counts over category codes) and the missing branch
// 239-248 (one bucket: the rows whose slot is absent) - K17a, PR 3 - and,
// K17c: the histogram branch 304-323, the filter bucket 199-215 (its
// posting lookups are agg_filter.cu; here the mask it gives is one
// bucket), each level of a nested chain 216-238 with _bucket_codes
// 163-186 (the mixed-radix composite code: terms, histogram, or the first
// matching range, one launch a level), and geo_trixels 372-395 (the HTM
// trixel of a doc's first range, looked up in the sorted trixel table) -
// with their metric sub-aggregations _sub_stats_bucketed 107-155 (n, s,
// s2, min, max; a median / mode sub's "hist2" is agg_hist.cu, fed by the
// codes this kernel writes).
//
// The code of a row (BucketSrc, mode):
//   0 terms      cats[d] (-1 when the segment has no cats table), valid in
//                [0, radix)
//   1 missing    0 when !present[d]
//   2 mask       0 where mask[b, r] (the filter bucket's rows)
//   3 histogram  floor((fval[d] - shift) / interval), a float32 division
//                as JAX's; valid when present[d] and in [0, radix)
//   4 range      the first j with lo_j <= fval[d] < hi_j (argmax, :184);
//                valid when present[d] and some range holds it
//   5 trixels    flat_start[min(doc_off[dd], nflat - 1)] >> shift with dd
//                = min(d, ndoc - 1), looked up in the query's ascending
//                table of radix trixels (lower_bound_i32); valid when
//                doc_len[dd] > 0 and the table holds it
// with d = min(ids[b, r], n - 1) for the column read. A nested level folds
// the previous level's composite code: comp = prev * radix + code, valid
// only where prev >= 0; counts are over `size` buckets (the product of the
// radices so far, <= 4096). codes_out (optional) receives each eligible
// row's composite code or -1 (prefilled with -1 by the wrapper). A sub
// reads the row's docid, clamped to sub_clamp - 1 first where sub_clamp >
// 0 (geo_trixels' subs read the clamped d, :393).
//
// A row r of query b counts when eligible[b, r] and its code is valid. A
// sub's rows are the bucket's rows whose present_sub[d] holds ("count"
// subs: all of them, s = s2 = 0, min +inf, max -inf).
//
// Grid (G, B), 256 threads: G blocks split one query's rows into ranges of
// 16-row groups; each thread reads one group's eligible flags with one
// 16-byte load and computes codes for the set bits only.
//   counts  a shared-memory histogram (int atomics, order-free), added
//           into the zeroed output with int atomics: size <= 4096 ints,
//           16 KB of shared memory at the widest spec;
//   subs    deterministic float sums without float atomics: per tile of
//           4096 rows the block packs its in-bucket rows, in row order,
//           into shared memory (docid, code: 24 KB; a block prefix sum
//           over the threads' counts); one warp then walks that list 32
//           rows at a time, gathers the sub's value per lane, groups the
//           lanes by code (__match_any_sync), sums each group in lane
//           order and adds it to the bucket's partial in the block's
//           scratch [B][G][S][size] x 5, so every bucket's sum runs in row
//           order however skewed the codes are (config 3's A queries
//           hold one category: a thread per bucket walks all of them
//           alone, 70 ms a launch at the widest group on an NVIDIA H100
//           80GB HBM3 at 700 W). A second kernel folds the G partials in
//           order. Two runs give the same bits; the float sums agree with
//           the plain version to float32 rounding (tests: rtol 1e-5).
// 41 KB of static shared memory in all, below the 48 KB static limit.
//
// Bound on the H100: the eligible flags (one byte a row), then one code
// computation per eligible row (one or two gathers; a range code scans the
// query's ranges, a trixel code binary-searches its table), and per sub
// one pass over the rows again with two gathers per in-bucket row, the
// sub's part by a single warp of each block (32 rows a step).
#include "common.cuh"

#define AB_THREADS 256
#define AB_MAXNB 4096
#define AB_TILE (AB_THREADS * 16)

struct BucketSrc {
    int mode;             // 0 terms, 1 missing, 2 mask, 3 histogram,
                          // 4 range, 5 trixels
    const void* p0;       // cats | present | mask | fval | fval | doc_off
    const void* p1;       // present (histogram, range) | doc_len
    const int* p2;        // flat_start (trixels)
    long long n0;         // rows of p0 / p1 (mask: R)
    long long n1;         // rows of flat_start
    const float* fpar;    // [B][fstride]: (interval, shift) | ranges
    const int* ipar;      // [B][radix]: the trixel tables
    int fstride;          // floats a query (range: 2 x the ranges)
    int radix;            // this level's buckets
    int shift;            // trixels: 2 x (13 - level)
    const int* prev;      // [B][R] the previous level's codes, or null
    long long sub_clamp;  // > 0: subs read min(d, sub_clamp - 1)
};

// the composite code of row (b, row) with docid d, or -1
__device__ __forceinline__ int row_code(const BucketSrc& s, int b,
                                        long long R, long long row, int d) {
    int code = -1;
    const long long n = s.n0;
    const long long dd = (long long)d < n - 1 ? d : n - 1;
    switch (s.mode) {
    case 0: {
        const int c = (s.p0 != nullptr && n > 0) ? ((const int*)s.p0)[dd]
                                                 : -1;
        code = (c >= 0 && c < s.radix) ? c : -1;
        break;
    }
    case 1:
        code = (s.p0 != nullptr && n > 0 &&
                ((const unsigned char*)s.p0)[dd]) ? -1 : 0;
        break;
    case 2:
        code = ((const unsigned char*)s.p0)[(long long)b * R + row] ? 0 : -1;
        break;
    case 3: {
        if (!((const unsigned char*)s.p1)[dd]) break;
        const float* fp = s.fpar + (long long)b * s.fstride;
        const float q = floorf(__fdiv_rn(((const float*)s.p0)[dd] - fp[1],
                                         fp[0]));
        code = (q >= 0.0f && q < (float)s.radix) ? (int)q : -1;
        break;
    }
    case 4: {
        if (!((const unsigned char*)s.p1)[dd]) break;
        const float v = ((const float*)s.p0)[dd];
        const float* fp = s.fpar + (long long)b * s.fstride;
        for (int j = 0; j < s.radix; ++j)
            if (v >= fp[2 * j] && v < fp[2 * j + 1]) { code = j; break; }
        break;
    }
    case 5: {
        const long long e = (long long)d < n - 1 ? d : n - 1;
        if (((const int*)s.p1)[e] <= 0) break;
        long long off = ((const int*)s.p0)[e];
        if (off > s.n1 - 1) off = s.n1 - 1;
        const int tri = s.p2[off] >> s.shift;
        const int* tab = s.ipar + (long long)b * s.radix;
        const int c = lower_bound_i32(tab, s.radix, tri);
        code = (c < s.radix && tab[c] == tri) ? c : -1;
        break;
    }
    }
    if (code < 0 || s.prev == nullptr) return code;
    const int pc = s.prev[(long long)b * R + row];
    return pc < 0 ? -1 : pc * s.radix + code;
}

// the docid a sub reads for row docid d
__device__ __forceinline__ long long sub_row(const BucketSrc& s, int d) {
    return (s.sub_clamp > 0 && d > s.sub_clamp - 1) ? s.sub_clamp - 1 : d;
}

__global__ void __launch_bounds__(AB_THREADS) agg_buckets_part(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, int G, const BucketSrc src, int nb, int S,
    const long long* __restrict__ subs, int* __restrict__ counts,
    int* __restrict__ codes_out, float* __restrict__ part) {
    __shared__ int hist[AB_MAXNB];
    __shared__ int ent_d[AB_TILE];
    __shared__ short ent_c[AB_TILE];
    __shared__ int scan[AB_THREADS];
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const long long base = (long long)b * R;
    const unsigned char* e = elig + base;
    const bool aligned = (reinterpret_cast<uintptr_t>(e) & 15) == 0;
    const long long ng = (R + 15) / 16;
    const long long g0 = ng * g / G, g1 = ng * (g + 1) / G;
    for (int c = t; c < nb; c += AB_THREADS) hist[c] = 0;
    __syncthreads();
    for (long long gi = g0 + t; gi < g1; gi += AB_THREADS) {
        unsigned msk = elig_mask16(e, R, gi, aligned);
        while (msk) {
            const int j = __ffs(msk) - 1;
            msk &= msk - 1;
            const long long row = gi * 16 + j;
            const int c = row_code(src, b, R, row, ids[base + row]);
            if (c >= 0 && c < nb) atomicAdd(&hist[c], 1);
            if (codes_out != nullptr)
                codes_out[base + row] = (c >= 0 && c < nb) ? c : -1;
        }
    }
    __syncthreads();
    for (int c = t; c < nb; c += AB_THREADS)
        if (hist[c]) atomicAdd(&counts[(long long)b * nb + c], hist[c]);

    const float inf = __int_as_float(0x7f800000);
    const int lane = t & 31;
    for (int si = 0; si < S; ++si) {
        const float* fval = (const float*)subs[si * 3];
        const unsigned char* pres = (const unsigned char*)subs[si * 3 + 1];
        const long long nr = subs[si * 3 + 2];
        // this block's partials for the sub, [nb][5], accumulated in place
        float* acc = part + (((long long)b * G + g) * S + si) * nb * 5;
        for (int i = t; i < nb * 5; i += AB_THREADS)
            acc[i] = (i % 5) == 3 ? inf : ((i % 5) == 4 ? -inf : 0.0f);
        __syncthreads();
        for (long long tg = g0; tg < g1; tg += AB_THREADS) {
            // pack this tile's in-bucket rows in row order
            const long long gi = tg + t;
            const unsigned msk0 = gi < g1 ? elig_mask16(e, R, gi, aligned)
                                          : 0u;
            int mine = 0;
            for (unsigned msk = msk0; msk; msk &= msk - 1) {
                const long long row = gi * 16 + __ffs(msk) - 1;
                const int c = row_code(src, b, R, row, ids[base + row]);
                mine += c >= 0 && c < nb;
            }
            scan[t] = mine;
            __syncthreads();
            for (int o = 1; o < AB_THREADS; o <<= 1) {
                const int x = t >= o ? scan[t - o] : 0;
                __syncthreads();
                scan[t] += x;
                __syncthreads();
            }
            const int total = scan[AB_THREADS - 1];
            int pos = scan[t] - mine;
            for (unsigned msk = msk0; msk; msk &= msk - 1) {
                const long long row = gi * 16 + __ffs(msk) - 1;
                const int d = ids[base + row];
                const int c = row_code(src, b, R, row, d);
                if (c >= 0 && c < nb) {
                    ent_d[pos] = (int)sub_row(src, d);
                    ent_c[pos] = (short)c;
                    ++pos;
                }
            }
            __syncthreads();
            // one warp walks the packed rows 32 at a time: lanes of one
            // code (__match_any_sync) are summed in lane order and the
            // group's lowest lane adds the sums to the bucket's partial
            if (t < 32) {
                for (int c0 = 0; c0 < total; c0 += 32) {
                    const int i = c0 + lane;
                    const int c = i < total ? ent_c[i] : -1;
                    float v = 0.0f;
                    bool use = c >= 0;
                    if (use && fval != nullptr) {
                        const long long d = ent_d[i];
                        const long long dd = d < nr - 1 ? d : nr - 1;
                        use = pres[dd] != 0;
                        v = use ? fval[dd] : 0.0f;
                    }
                    const unsigned act = __ballot_sync(0xffffffffu, use);
                    const unsigned peers =
                        __match_any_sync(0xffffffffu, use ? c : -1) & act;
                    float n = 0.0f, sm = 0.0f, sq = 0.0f, mn = inf, mx = -inf;
                    for (int src = 0; src < 32; ++src) {
                        const float x = __shfl_sync(0xffffffffu, v, src);
                        if ((peers >> src) & 1u) {
                            n += 1.0f;
                            if (fval != nullptr) {
                                sm += x;
                                sq += x * x;
                                mn = fminf(mn, x);
                                mx = fmaxf(mx, x);
                            }
                        }
                    }
                    if (use && lane == __ffs(peers) - 1) {
                        float* p = acc + (long long)c * 5;
                        p[0] += n;
                        p[1] += sm;
                        p[2] += sq;
                        p[3] = fminf(p[3], mn);
                        p[4] = fmaxf(p[4], mx);
                    }
                    __syncwarp();
                }
            }
            __syncthreads();
        }
    }
}

// grid (B), 256 threads: each (sub, bucket) folds its G partials in order
// into out [S][5][B][nb]
__global__ void __launch_bounds__(AB_THREADS) agg_buckets_fold(
    int B, int G, int S, int nb, const float* __restrict__ part,
    float* __restrict__ out) {
    const int b = blockIdx.x;
    for (int i = threadIdx.x; i < S * nb; i += AB_THREADS) {
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

// subs: int64 [S][3] = (fval pointer or 0 for a count sub, present
// pointer, rows); counts i32[B][nb] zeroed by the wrapper; codes_out
// i32[B][R] prefilled with -1, or null; part f32 [B*G*S*nb*5] scratch;
// out f32[S][5][B][nb]. nb is the count width (`size`), radix the level's
// buckets (both the spec's buckets outside a nested chain).
extern "C" int xt_agg_buckets(const void* ids, const void* elig, int B,
                              long long R, int G, int mode, const void* p0,
                              const void* p1, const void* p2, long long n0,
                              long long n1, const void* fpar,
                              const void* ipar, int fstride, int radix,
                              int shift, const void* prev,
                              long long sub_clamp, int nb, int S,
                              const void* subs, void* counts,
                              void* codes_out, void* part, void* out,
                              void* stream) {
    if (B == 0) return 0;
    if (nb < 1 || nb > AB_MAXNB || G < 1 || S < 0 || radix < 1 ||
        mode < 0 || mode > 5)
        return (int)cudaErrorInvalidValue;
    BucketSrc src;
    src.mode = mode;
    src.p0 = p0;
    src.p1 = p1;
    src.p2 = (const int*)p2;
    src.n0 = n0;
    src.n1 = n1;
    src.fpar = (const float*)fpar;
    src.ipar = (const int*)ipar;
    src.fstride = fstride;
    src.radix = radix;
    src.shift = shift;
    src.prev = (const int*)prev;
    src.sub_clamp = sub_clamp;
    cudaStream_t st = (cudaStream_t)stream;
    agg_buckets_part<<<dim3(G, B), AB_THREADS, 0, st>>>(
        (const int*)ids, (const unsigned char*)elig, R, G, src, nb, S,
        (const long long*)subs, (int*)counts, (int*)codes_out,
        (float*)part);
    int rc = (int)cudaGetLastError();
    if (rc || S == 0) return rc;
    agg_buckets_fold<<<B, AB_THREADS, 0, st>>>(B, G, S, nb,
                                               (const float*)part,
                                               (float*)out);
    return (int)cudaGetLastError();
}
