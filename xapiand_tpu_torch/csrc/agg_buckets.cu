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
//                [0, radix); on the mesh a code >= 0 is first mapped
//                through the shard's cat_remap row (ops/aggs.py:287-291)
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
// row's composite code, -1 elsewhere (every row written here). A sub
// reads the row's docid, clamped to sub_clamp - 1 first where sub_clamp >
// 0 (geo_trixels' subs read the clamped d, :393).
//
// A row r of query b counts when eligible[b, r] and its code is valid. A
// sub's rows are the bucket's rows whose present_sub[d] holds ("count"
// subs: all of them, s = s2 = 0, min +inf, max -inf).
//
// One launch, grid (G, B), 256 threads, one kernel a mode (a template
// argument): G blocks split one query's rows into ranges of 16-row groups.
// Warp w of a block takes, at each step, 32 groups (a lane a group: its
// eligible flags one 16-byte load, the next step's loaded ahead), writes
// -1 as the code of each row whose flag is off (so codes_out needs no
// prefill) and queues its eligible rows, in row order, in shared memory
// (a warp prefix sum of the lanes' counts). Whenever 32 rows or more wait,
// the warp drains them 32 at a time, 4 batches a lane at once (their
// docids, then their codes, loaded together): a row in every lane, so the
// gathers of a sparse query do not wait on empty groups. G comes from
// kernels.bucket_plan: blocks of a few thousand rows, so that a query whose
// eligible rows crowd one stretch spreads them over many blocks.
//   counts  a shared-memory histogram, an int atomic a row (grouping a
//           batch's lanes by code first, __match_any_sync, cost more than
//           the conflicts of config 3's one-category A queries);
//   subs    deterministic float sums without float atomics: per batch
//           each sub's value is gathered per lane, the lanes of one code
//           summed in lane order and added by one lane to the warp's own
//           partial of the bucket; after the rows, a thread a (sub,
//           bucket) adds the 8 warps' partials in warp order into the
//           block's partial [B][G][S][size] x 5. The warps' partials sit
//           in shared memory up to 12,288 floats (8 warps x S x size x 5),
//           else in a device-memory scratch of the wrapper's (a wide
//           spec: the trixels' 4,096 buckets). Every bucket's sum runs in
//           a fixed order - batches in a warp's row order, lanes, warps,
//           blocks - so two runs give the same bits; the float sums agree
//           with the float64 plain version to float32 rounding (tests:
//           rtol 1e-5, or 1e-5 of the sum of |value| where values of both
//           signs cancel).
//   fold    each block writes its counts to device memory and takes a
//           ticket (a counter a query, after __threadfence); the last
//           block of the query adds the G blocks' counts and statistics
//           in block order into the outputs and resets the counter. The
//           counters (i32[B], zeros) are the wrapper's, kept from call to
//           call, so nothing is cleared before a launch.
//
// Bound on the H100: the eligible flags (one byte a row), then one code
// computation per eligible row (one or two gathers; a range code scans the
// query's ranges, a trixel code binary-searches its table), the codes
// written (4 bytes a row) where asked, and per sub two gathers per
// in-bucket row, the sub's walk spread over every warp of the block.
#include "common.cuh"

#define AB_THREADS 256
#define AB_WARPS (AB_THREADS / 32)
#define AB_MAXNB 4096
#define AB_FULL 0xffffffffu

struct BucketSrc {
    int mode;             // 0 terms, 1 missing, 2 mask, 3 histogram,
                          // 4 range, 5 trixels
    const void* p0;       // cats | present | mask | fval | fval | doc_off
    const void* p1;       // present (histogram, range) | doc_len |
                          // terms: the mesh's cat_remap row (or null)
    const int* p2;        // flat_start (trixels)
    long long n0;         // rows of p0 / p1 (mask: R)
    long long n1;         // rows of flat_start | of the cat_remap row
    const float* fpar;    // [B][fstride]: (interval, shift) | ranges
    const int* ipar;      // [B][radix]: the trixel tables
    int fstride;          // floats a query (range: 2 x the ranges)
    int radix;            // this level's buckets
    int shift;            // trixels: 2 x (13 - level)
    const int* prev;      // [B][R] the previous level's codes, or null
    long long sub_clamp;  // > 0: subs read min(d, sub_clamp - 1)
};

// the composite code of row (b, row) with docid d, or -1; the mode is the
// kernel's template argument, so each launch runs one mode's code
template <int MODE>
__device__ __forceinline__ int row_code(const BucketSrc& s, int b,
                                        long long R, long long row, int d) {
    int code = -1;
    const long long n = s.n0;
    const long long dd = (long long)d < n - 1 ? d : n - 1;
    switch (MODE) {
    case 0: {
        int c = (s.p0 != nullptr && n > 0) ? ((const int*)s.p0)[dd] : -1;
        if (s.p1 != nullptr && c >= 0)   // the mesh's cat_remap row
            c = ((const int*)s.p1)[c < s.n1 - 1 ? c : s.n1 - 1];
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

// the warps' sub partials [warps][S][nb][5] sit in shared memory up to
// this many floats, else in a device-memory scratch of the wrapper's
#define AB_WP_SMEM (12 * 1024)
#define AB_QCAP 544           // a warp's queue: 16 rows x 32 lanes, and 32
#ifndef AB_U
#define AB_U 4                // queued rows a lane, their loads together
#endif

__host__ __device__ inline bool ab_wp_shared(int nb, int S) {
    return (long long)AB_WARPS * S * nb * 5 <= AB_WP_SMEM;
}

// the shared memory of a launch: hist[nb], the warps' queues, and the
// warps' sub partials where they fit
__host__ __device__ inline int ab_smem(int nb, int S) {
    return 4 * nb + 4 * AB_WARPS * AB_QCAP +
           (S > 0 && ab_wp_shared(nb, S) ? 4 * AB_WARPS * S * nb * 5 : 0);
}

template <int MODE>
__global__ void __launch_bounds__(AB_THREADS) agg_buckets_kernel(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, int G, const BucketSrc src, int nb, int S,
    const long long* __restrict__ subs, int* __restrict__ counts,
    int* __restrict__ codes_out, float* __restrict__ part,
    int* __restrict__ pcount, int* __restrict__ ctr,
    float* __restrict__ out, float* __restrict__ wpg) {
    extern __shared__ int ab_sm[];
    int* hist = ab_sm;                                        // [nb]
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    int* queue = hist + nb + warp * AB_QCAP;          // this warp's rows
    const long long wstride = (long long)S * nb * 5;
    float* wp = ab_wp_shared(nb, S)
                    ? (float*)(hist + nb + AB_WARPS * AB_QCAP) + warp * wstride
                    : wpg + (((long long)b * G + g) * AB_WARPS + warp) *
                                wstride;
    __shared__ bool last;
    const long long base = (long long)b * R;
    const unsigned char* e = elig + base;
    const bool aligned = (reinterpret_cast<uintptr_t>(e) & 15) == 0;
    const long long ng = (R + 15) / 16;
    const long long g0 = ng * g / G, g1 = ng * (g + 1) / G;
    const float inf = __int_as_float(0x7f800000);
    for (int c = t; c < nb; c += AB_THREADS) hist[c] = 0;
    for (long long i = lane; i < wstride; i += 32)
        wp[i] = (i % 5) == 3 ? inf : ((i % 5) == 4 ? -inf : 0.0f);
    __syncthreads();
    // a batch of 32 queued rows, AB_U batches at once (each lane's rows'
    // docids, then their codes, loaded together); counts, codes written,
    // each sub's values of a code summed in lane order and added to the
    // warp's partial, batch after batch
    auto drain = [&](int n) {
        for (int i0 = 0; i0 < n; i0 += 32 * AB_U) {
            int row[AB_U], d[AB_U], c[AB_U];
#pragma unroll
            for (int u = 0; u < AB_U; ++u) {
                const int i = i0 + u * 32 + lane;
                row[u] = i < n ? queue[i] : -1;
                d[u] = row[u] >= 0 ? __ldg(ids + base + row[u]) : 0;
            }
#pragma unroll
            for (int u = 0; u < AB_U; ++u) {
                const int k = row[u] >= 0
                                  ? row_code<MODE>(src, b, R, row[u], d[u])
                                  : -1;
                c[u] = k >= 0 && k < nb ? k : -1;
            }
#pragma unroll
            for (int u = 0; u < AB_U; ++u) {
                if (i0 + u * 32 >= n) break;
                if (c[u] >= 0) atomicAdd(&hist[c[u]], 1);
                if (codes_out != nullptr && row[u] >= 0)
                    codes_out[base + row[u]] = c[u];
                for (int si = 0; si < S; ++si) {
                    const float* fval = (const float*)subs[si * 3];
                    const unsigned char* pres =
                        (const unsigned char*)subs[si * 3 + 1];
                    const long long nr = subs[si * 3 + 2];
                    bool use = c[u] >= 0;
                    float v = 0.0f;
                    if (use && fval != nullptr) {
                        const long long dr = sub_row(src, d[u]);
                        const long long dd = dr < nr - 1 ? dr : nr - 1;
                        use = pres[dd] != 0;
                        v = use ? fval[dd] : 0.0f;
                    }
                    const unsigned act = __ballot_sync(AB_FULL, use);
                    const unsigned peers =
                        __match_any_sync(AB_FULL, use ? c[u] : -1) & act;
                    float n_ = 0.0f, sm = 0.0f, sq = 0.0f, mn = inf,
                          mx = -inf;
                    for (int sl = 0; sl < 32; ++sl) {
                        const float x = __shfl_sync(AB_FULL, v, sl);
                        if ((peers >> sl) & 1u) {
                            n_ += 1.0f;
                            if (fval != nullptr) {
                                sm += x;
                                sq += x * x;
                                mn = fminf(mn, x);
                                mx = fmaxf(mx, x);
                            }
                        }
                    }
                    if (use && lane == __ffs(peers) - 1) {
                        float* q = wp + ((long long)si * nb + c[u]) * 5;
                        q[0] += n_;
                        q[1] += sm;
                        q[2] += sq;
                        q[3] = fminf(q[3], mn);
                        q[4] = fmaxf(q[4], mx);
                    }
                    __syncwarp();
                }
            }
        }
    };
    // warp w takes the 32 groups g0 + (8 k + w) * 32 .. + 31 of each step
    // k; a lane a group: its flags one 16-byte load (the next step's
    // loaded ahead), its eligible rows queued in row order, -1 written for
    // its other rows' codes
    int qn = 0;
    const long long wfirst = g0 + warp * 32 + lane;
    unsigned next = wfirst < g1 ? elig_mask16(e, R, wfirst, aligned) : 0u;
    for (long long gs = g0 + warp * 32; gs < g1; gs += AB_WARPS * 32) {
        const long long gi = gs + lane;
        const unsigned msk = next;
        const long long gn = gi + AB_WARPS * 32;
        next = gn < g1 ? elig_mask16(e, R, gn, aligned) : 0u;
        if (codes_out != nullptr && gi < g1)
            for (int j = 0; j < 16 && gi * 16 + j < R; ++j)
                if (!((msk >> j) & 1u)) codes_out[base + gi * 16 + j] = -1;
        const int k = __popc(msk);
        int incl = k;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(AB_FULL, incl, o);
            if (lane >= o) incl += x;
        }
        const int total = __shfl_sync(AB_FULL, incl, 31);
        int pos = qn + incl - k;
        for (unsigned m = msk; m; m &= m - 1)
            queue[pos++] = (int)(gi * 16 + __ffs(m) - 1);
        qn += total;
        __syncwarp();
        if (qn >= 32) {
            const int full = qn & ~31;
            drain(full);
            const int rest = qn - full;
            const int moved = lane < rest ? queue[full + lane] : 0;
            __syncwarp();
            if (lane < rest) queue[lane] = moved;
            qn = rest;
            __syncwarp();
        }
    }
    drain(qn);
    __syncthreads();
    // the warps' partials in warp order onto the block's [S][nb][5], its
    // counts, then the last block of the query folds
    float* acc = part + ((long long)b * G + g) * wstride;
    const float* wp0 = ab_wp_shared(nb, S)
                           ? (const float*)(hist + nb + AB_WARPS * AB_QCAP)
                           : wpg + ((long long)b * G + g) * AB_WARPS *
                                       wstride;
    for (long long i = t; i < (long long)S * nb; i += AB_THREADS) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = inf, a4 = -inf;
        for (int w = 0; w < AB_WARPS; ++w) {
            const float* q = wp0 + w * wstride + i * 5;
            a0 += q[0];
            a1 += q[1];
            a2 += q[2];
            a3 = fminf(a3, q[3]);
            a4 = fmaxf(a4, q[4]);
        }
        float* o = acc + i * 5;
        o[0] = a0;
        o[1] = a1;
        o[2] = a2;
        o[3] = a3;
        o[4] = a4;
    }
    int* pc = pcount + ((long long)b * G + g) * nb;
    for (int c = t; c < nb; c += AB_THREADS) pc[c] = hist[c];
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&ctr[b], 1) == G - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int* pcq = pcount + (long long)b * G * nb;
    for (int c = t; c < nb; c += AB_THREADS) {
        int n = 0;
        for (int q = 0; q < G; ++q) n += __ldcg(pcq + (long long)q * nb + c);
        counts[(long long)b * nb + c] = n;
    }
    const int B = gridDim.y;
    const float* pq = part + (long long)b * G * wstride;
    for (int i = t; i < S * nb; i += AB_THREADS) {
        const int si = i / nb, c = i % nb;
        float a[5];
        for (int q = 0; q < G; ++q) {
            const float* p = pq + (((long long)q * S + si) * nb + c) * 5;
            if (q == 0) {
                for (int st = 0; st < 5; ++st) a[st] = __ldcg(p + st);
            } else {
                a[0] += __ldcg(p);
                a[1] += __ldcg(p + 1);
                a[2] += __ldcg(p + 2);
                a[3] = fminf(a[3], __ldcg(p + 3));
                a[4] = fmaxf(a[4], __ldcg(p + 4));
            }
        }
        for (int st = 0; st < 5; ++st)
            out[(((long long)si * 5 + st) * B + b) * nb + c] = a[st];
    }
    if (t == 0) ctr[b] = 0;
}

// subs: int64 [S][3] = (fval pointer or 0 for a count sub, present
// pointer, rows); counts i32[B][nb] and codes_out i32[B][R] (or null),
// written whole; part f32 [B*G*S*nb*5] and pcount i32[B*G*nb] scratch; ctr
// i32[>= B] zeros, left zeros; out f32[S][5][B][nb]. nb is the count width
// (`size`), radix the level's buckets (both the spec's buckets outside a
// nested chain).
extern "C" int xt_agg_buckets(const void* ids, const void* elig, int B,
                              long long R, int G, int mode, const void* p0,
                              const void* p1, const void* p2, long long n0,
                              long long n1, const void* fpar,
                              const void* ipar, int fstride, int radix,
                              int shift, const void* prev,
                              long long sub_clamp, int nb, int S,
                              const void* subs, void* counts,
                              void* codes_out, void* part, void* pcount,
                              void* ctr, void* out, void* wpg,
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
    using Kernel = void (*)(const int*, const unsigned char*, long long, int,
                           const BucketSrc, int, int, const long long*,
                           int*, int*, float*, int*, int*, float*, float*);
    if (S > 0 && !ab_wp_shared(nb, S) && wpg == nullptr)
        return (int)cudaErrorInvalidValue;
    static const Kernel kernels[6] = {
        agg_buckets_kernel<0>, agg_buckets_kernel<1>, agg_buckets_kernel<2>,
        agg_buckets_kernel<3>, agg_buckets_kernel<4>, agg_buckets_kernel<5>};
    static bool attrs = false;
    if (!attrs) {
        for (int m = 0; m < 6; ++m) {
            const int rc = (int)cudaFuncSetAttribute(
                kernels[m], cudaFuncAttributeMaxDynamicSharedMemorySize,
                4 * AB_MAXNB + 4 * AB_WARPS * AB_QCAP + 4 * AB_WP_SMEM);
            if (rc) return rc;
        }
        attrs = true;
    }
    kernels[mode]<<<dim3(G, B), AB_THREADS, ab_smem(nb, S),
                    (cudaStream_t)stream>>>(
        (const int*)ids, (const unsigned char*)elig, R, G, src, nb, S,
        (const long long*)subs, (int*)counts, (int*)codes_out,
        (float*)part, (int*)pcount, (int*)ctr, (float*)out, (float*)wpg);
    return (int)cudaGetLastError();
}
