// sort_topk: the first k rows of each query in multi-key sort order.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _rank_and_topk multi-key
// branch 487-574 (the key construction per sort spec, then one full
// lax.sort of every row by the keys and a final docid tiebreak, of which
// the first k are kept), with _haversine 406-413 for geodist keys.
//
// Each row's key is built in the kernel exactly as 487-559 builds it, as
// a list of 32-bit words whose unsigned order is lax.sort's order:
//   value      (hi, lo), both complemented when descending; then hi :=
//              INT32_MAX where the value is absent, lo left as it is;
//   score      +-score;
//   dist       |fval - target|, +inf where absent, negated when descending;
//   geodist    _haversine(lat, lon, target), same rules;
//   strmetric  the query's table at the doc's category code, +inf without
//              a code, negated when descending;
//   docid      the docid (unweighted plans with no sort);
// every key of an ineligible row is INT32_MAX or +inf; then the masked
// docid (SENTINEL when ineligible). Int words are x ^ 0x80000000; float
// words follow lax.sort's total order (-0.0 equals +0.0, NaN after +inf).
// A last word, the row index, makes every key unique: the rows lax.sort
// may leave in any order are ineligible rows with equal keys, whose
// payloads (SENTINEL, -inf) are equal too, so the result is the same.
//
// Grid (B): one block of 256 threads per query. Each thread keeps a
// sorted list of its best k keys over a strided share of the rows (the
// multi-word form of topk_rows); then k rounds of a block-wide minimum
// over the list heads pop the winners in order, and the winner's row
// gives the payload (docid, score), masked when ineligible.
//
// Bound on the H100: the per-row gathers of the sort columns by docid and
// the key compares; at cap width (<= 131072 rows a query after
// compaction) most rows are rejected by one compare against the list's
// last key. The lists live in local memory (dynamic indexing); one block
// per query leaves SMs idle when B < 132.
#include "common.cuh"

#define ST_VALUE 0
#define ST_SCORE 1
#define ST_DIST 2
#define ST_GEODIST 3
#define ST_STRMETRIC 4
#define ST_DOCID 5
// column table, int64 per spec: hi, lo, present, fval, fval2, cats,
// strtab (device pointers, 0 when absent), n_rows (0: the segment lacks
// the slot)
#define ST_COLS 8
#define ST_THREADS 256

__device__ __forceinline__ unsigned ikey(int x) {
    return (unsigned)x ^ 0x80000000u;
}

__device__ __forceinline__ unsigned fkey(float x) {
    if (x != x) return 0xffc00000u;    // canonical NaN, after +inf
    if (x == 0.0f) x = 0.0f;            // -0.0 sorts equal to +0.0
    const unsigned u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// _haversine (executor.py:406-413), in its float32 operation order
__device__ __forceinline__ float haversine(float lat, float lon, float lat0,
                                           float lon0) {
    const float r = 0.017453292519943295f;   // jnp.pi / 180.0
    const float dlat = (lat - lat0) * r * 0.5f;
    const float dlon = (lon - lon0) * r * 0.5f;
    const float s1 = sinf(dlat), s2 = sinf(dlon);
    const float a = s1 * s1 + (cosf(lat * r) * cosf(lat0 * r)) * (s2 * s2);
    return 12742017.6f * asinf(sqrtf(fminf(fmaxf(a, 0.0f), 1.0f)));
}

template <int NK>
__device__ __forceinline__ bool key_lt(const unsigned* a, const unsigned* b) {
#pragma unroll
    for (int i = 0; i < NK; ++i)
        if (a[i] != b[i]) return a[i] < b[i];
    return false;
}

template <int NK>
__device__ __forceinline__ void row_key(
    int r, long long base, int b, const int* __restrict__ ids,
    const float* __restrict__ sums, const unsigned char* __restrict__ elig,
    int S, const int* __restrict__ spec, const long long* __restrict__ cols,
    const float* __restrict__ targets, unsigned* key) {
    const int d = ids[base + r];
    const bool el = elig[base + r] != 0;
    const float sc = sums[base + r];
    const float inf = __int_as_float(0x7f800000);
    int pos = 0;
    for (int s = 0; s < S; ++s) {
        const int kind = spec[s * 4], desc = spec[s * 4 + 1];
        const int nb = spec[s * 4 + 2];
        const long long* c = cols + s * ST_COLS;
        const long long n = c[7];
        const long long dd = n > 0 ? ((long long)d < n - 1 ? (long long)d
                                                           : n - 1) : 0;
        if (kind == ST_VALUE) {
            int h = XT_I32MAX, l = XT_I32MAX;
            bool pr = false;
            if (n > 0) {
                h = ((const int*)c[0])[dd];
                l = ((const int*)c[1])[dd];
                pr = ((const unsigned char*)c[2])[dd] != 0;
            }
            if (desc) {
                h = ~h;
                l = ~l;
            }
            if (!pr) h = XT_I32MAX;
            key[pos++] = ikey(el ? h : XT_I32MAX);
            key[pos++] = ikey(el ? l : XT_I32MAX);
        } else if (kind == ST_DOCID) {
            key[pos++] = ikey(el ? d : XT_SENTINEL);
        } else {
            float kf;
            if (kind == ST_SCORE) {
                kf = desc ? -sc : sc;
            } else if (kind == ST_STRMETRIC) {
                const int code = (n > 0 && c[5]) ? ((const int*)c[5])[dd]
                                                 : -1;
                const float* tab = (const float*)c[6] + (long long)b * nb;
                kf = tab[code < 0 ? 0 : (code > nb - 1 ? nb - 1 : code)];
                if (code < 0) kf = inf;
                if (desc) kf = -kf;
            } else {
                const bool pr = n > 0 &&
                                ((const unsigned char*)c[2])[dd] != 0;
                const float* tg = targets + ((long long)b * S + s) * 2;
                const float v = n > 0 ? ((const float*)c[3])[dd] : 0.0f;
                if (kind == ST_DIST) {
                    kf = fabsf(v - tg[0]);
                } else {
                    const float lon = (n > 0 && c[4])
                        ? ((const float*)c[4])[dd] : 0.0f;
                    kf = haversine(v, lon, tg[0], tg[1]);
                }
                if (!pr) kf = inf;
                if (desc) kf = -kf;
            }
            key[pos++] = fkey(el ? kf : inf);
        }
    }
    key[pos++] = ikey(el ? d : XT_SENTINEL);
    key[pos] = (unsigned)r;
}

template <int KMAX, int NK>
__global__ void __launch_bounds__(ST_THREADS) sort_topk_kernel(
    const int* __restrict__ ids, const float* __restrict__ sums,
    const unsigned char* __restrict__ elig, int C, int k, int S,
    const int* __restrict__ spec, const long long* __restrict__ cols,
    const float* __restrict__ targets, int* __restrict__ out_d,
    float* __restrict__ out_s) {
    __shared__ unsigned wbest[ST_THREADS / 32][NK];
    const int b = blockIdx.x;
    const long long base = (long long)b * C;
    unsigned top[KMAX][NK];
    unsigned key[NK];
    int n = 0;
    for (int r = threadIdx.x; r < C; r += ST_THREADS) {
        row_key<NK>(r, base, b, ids, sums, elig, S, spec, cols, targets, key);
        if (n == k && !key_lt<NK>(key, top[k - 1])) continue;
        int i = n < k ? n++ : k - 1;
        while (i > 0 && key_lt<NK>(key, top[i - 1])) {
#pragma unroll
            for (int w = 0; w < NK; ++w) top[i][w] = top[i - 1][w];
            --i;
        }
#pragma unroll
        for (int w = 0; w < NK; ++w) top[i][w] = key[w];
    }
    int head = 0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j = 0; j < k; ++j) {
        unsigned m[NK];
#pragma unroll
        for (int w = 0; w < NK; ++w) m[w] = head < n ? top[head][w] : ~0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            unsigned x[NK];
#pragma unroll
            for (int w = 0; w < NK; ++w)
                x[w] = __shfl_xor_sync(0xffffffffu, m[w], o);
            if (key_lt<NK>(x, m)) {
#pragma unroll
                for (int w = 0; w < NK; ++w) m[w] = x[w];
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int w = 0; w < NK; ++w) wbest[warp][w] = m[w];
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < NK; ++w) m[w] = wbest[0][w];
        for (int q = 1; q < ST_THREADS / 32; ++q) {
            if (key_lt<NK>(wbest[q], m)) {
#pragma unroll
                for (int w = 0; w < NK; ++w) m[w] = wbest[q][w];
            }
        }
        __syncthreads();
        // keys are unique (row index word): one thread owns the winner
        if (head < n && !key_lt<NK>(top[head], m) && !key_lt<NK>(m, top[head]))
            ++head;
        if (threadIdx.x == 0) {
            const long long o = (long long)b * k + j;
            if (m[NK - 1] == ~0u) {   // fewer than k rows
                out_d[o] = XT_SENTINEL;
                out_s[o] = __int_as_float(0xff800000);
            } else {
                const long long row = base + (long long)m[NK - 1];
                const bool el = elig[row] != 0;
                out_d[o] = el ? ids[row] : XT_SENTINEL;
                out_s[o] = el ? sums[row] : __int_as_float(0xff800000);
            }
        }
    }
}

template <int KMAX>
static int launch_nk(int NK, int B, cudaStream_t st, const int* ids,
                     const float* sums, const unsigned char* elig, int C,
                     int k, int S, const int* spec, const long long* cols,
                     const float* targets, int* out_d, float* out_s) {
#define ST_CASE(N)                                                          \
    case N:                                                                 \
        sort_topk_kernel<KMAX, N><<<B, ST_THREADS, 0, st>>>(                \
            ids, sums, elig, C, k, S, spec, cols, targets, out_d, out_s);   \
        break;
    switch (NK) {
        ST_CASE(3)
        ST_CASE(4)
        ST_CASE(5)
        ST_CASE(6)
        ST_CASE(7)
        ST_CASE(8)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef ST_CASE
    return (int)cudaGetLastError();
}

extern "C" int xt_sort_topk(const void* ids, const void* sums,
                            const void* elig, int B, int C, int k, int S,
                            int NK, const void* spec, const void* cols,
                            const void* targets, void* out_d, void* out_s,
                            void* stream) {
    if (B == 0 || k == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (k <= 16)
        return launch_nk<16>(NK, B, st, (const int*)ids, (const float*)sums,
                             (const unsigned char*)elig, C, k, S,
                             (const int*)spec, (const long long*)cols,
                             (const float*)targets, (int*)out_d,
                             (float*)out_s);
    if (k <= 64)
        return launch_nk<64>(NK, B, st, (const int*)ids, (const float*)sums,
                             (const unsigned char*)elig, C, k, S,
                             (const int*)spec, (const long long*)cols,
                             (const float*)targets, (int*)out_d,
                             (float*)out_s);
    return (int)cudaErrorInvalidValue;
}
