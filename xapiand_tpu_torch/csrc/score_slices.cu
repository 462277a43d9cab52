// score_slices: slice each (query, term) posting span and weigh it with the
// query's scheme.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 691-742 (the
// per-term lax.dynamic_slice + scheme.sumpart, models/weights.py 126-575,
// with uniqterms gathered by docid for the schemes that read it, 716-721)
// and the prefix-mode unread-tail bound (698-705).
//
// tconst is f32[B, T, C] (C = the scheme's n_constants). BM25 launches the
// GENERIC = false instances, BM25's inline formula as before the other
// schemes; every other scheme the instances that switch on the spec's id
// (common.cuh scheme_sumpart). uniq (f32[ND+1], nullptr when the scheme
// reads none) is read at min(docid, ND) for in-length rows only, as JAX
// reads it at SENTINEL-masked docids.
//
// Every row r of a query's R rows belongs to the term t with row_off[t] <=
// r < row_off[t + 1]; row i = r - row_off[t] of it is the docid (SENTINEL
// at or past lens[t]) and weight * scoring[t] (0 there) of posting
// start + i, start being lax.dynamic_slice's clamped offset.
//
// Two kernels, launched by one call where a group holds both kinds of term
// (the [trace] lines count kernels, kernels.launches counts calls):
//
// - Row tiles (score_tiles_kernel), grid (tiles, B): a block of SS_THREADS
//   threads takes SS_RPT consecutive runs of SS_THREADS rows of one query,
//   every term's rows alike, so the card is full at any B and T (a block a
//   (term, query) left 128 of 132 SMs idle at B = 1). A thread finds its
//   row's term by a binary search over a shared copy of row_off, skips
//   the rows of prefix terms, and reads nothing for rows past lens (their
//   outputs are constants). Tile 0 of a query writes the tail 0 of its
//   non-prefix terms.
// - Prefix blocks (score_prefix_kernel), grid (prefix terms, B), 1024
//   threads: prefix-mode terms read the first `width` rows of the
//   impact-ordered mirror (imp.*), in descending-impact order; the block
//   sorts them by docid in shared memory (bitonic, padded to a power of
//   two) so that every term block leaves the call docid-ascending, which
//   merge_docs relies on, and writes the term's tail bound.
//
// Bound on the H100: device-memory bytes (12 B read per in-length row, 8 B
// written per row, plus 4 B of uniqterms where read); the arithmetic is a
// handful of flops per row for BM25 and up to six logarithms for BB2.
// Consecutive threads take consecutive rows, hence consecutive postings.
// BM25 and the other schemes are separate instances: the register cap the
// latter's formulas need leaves BM25's code uncapped. The prefix sort
// stays in shared memory (width <= 16384 rows, 128 KB); a wider prefix (an
// index's prefix_cap may be any power of two from 128, as the JAX server
// admits) sorts the same way in a device-memory scratch the wrapper gives
// (a block's global writes are visible to its threads after
// __syncthreads).
#include "common.cuh"

#ifndef SS_THREADS
#define SS_THREADS 256
#endif
#ifndef SS_RPT
#define SS_RPT 4            // rows a thread: a tile is SS_THREADS * SS_RPT
#endif

#define SCORE_SLICES_PARAMS                                                 \
    const int* __restrict__ post_docids, const float* __restrict__ post_wdf, \
    const float* __restrict__ post_doclen, long long n_post,                \
    const int* __restrict__ imp_docids, const float* __restrict__ imp_wdf,  \
    const float* __restrict__ imp_doclen, long long n_imp,                  \
    const int* __restrict__ offsets, const int* __restrict__ lens,          \
    const float* __restrict__ tconst, const float* __restrict__ scoring,    \
    const int* __restrict__ widths, const int* __restrict__ is_prefix,      \
    const int* __restrict__ row_off, int T, int R, SchemeSpec sp, int C,    \
    const float* __restrict__ uniq, int nd1, int* __restrict__ out_ids,     \
    float* __restrict__ out_w, float* __restrict__ out_tail,                \
    int* __restrict__ scratch, int n2max
#define SCORE_SLICES_ARGS                                                   \
    post_docids, post_wdf, post_doclen, n_post, imp_docids, imp_wdf,        \
    imp_doclen, n_imp, offsets, lens, tconst, scoring, widths, is_prefix,   \
    row_off, T, R, sp, C, uniq, nd1, out_ids, out_w, out_tail, scratch,     \
    n2max

// the term's constants (C <= 2; BM25's is one)
template <bool GENERIC>
__device__ __forceinline__ void term_constants(const float* tconst,
                                               long long bt, int C,
                                               float* tc) {
    const long long tci = bt * (GENERIC ? C : 1);
    tc[0] = tconst[tci];
    tc[1] = GENERIC && C > 1 ? tconst[tci + 1] : 0.0f;
}

// lax.dynamic_slice clamps the start so the slice stays in bounds
__device__ __forceinline__ long long clamped_start(int off, long long n_src,
                                                   int W) {
    long long start = (long long)off;
    if (start > n_src - W) start = n_src - W;
    if (start < 0) start = 0;
    return start;
}

// the non-prefix rows of a query, in tiles of SS_THREADS * SS_RPT rows
template <bool GENERIC>
__device__ __forceinline__ void score_tiles_block(SCORE_SLICES_PARAMS) {
    extern __shared__ int s_ro[];          // row_off[0..T], then is_prefix
    int* s_pref = s_ro + T + 1;
    for (int t = threadIdx.x; t <= T; t += SS_THREADS) {
        s_ro[t] = row_off[t];
        if (t < T) s_pref[t] = is_prefix[t];
    }
    __syncthreads();
    const int b = blockIdx.y;
    if (blockIdx.x == 0)
        for (int t = threadIdx.x; t < T; t += SS_THREADS)
            if (!s_pref[t]) out_tail[(long long)b * T + t] = 0.0f;
    const bool gather_uniq = GENERIC && uniq != nullptr;
    const long long r0 = (long long)blockIdx.x * (SS_THREADS * SS_RPT);
    int tprev = -1, off = 0, len = 0, W = 0, pref = 0;
    float tc[2] = {0.0f, 0.0f}, sc = 0.0f;
    long long start = 0;
#pragma unroll
    for (int j = 0; j < SS_RPT; ++j) {
        const long long rl = r0 + (long long)j * SS_THREADS + threadIdx.x;
        if (rl >= R) break;
        const int r = (int)rl;
        // the last t with row_off[t] <= r (a term of width 0 is passed)
        int lo = 0, hi = T - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_ro[mid] <= r) lo = mid; else hi = mid - 1;
        }
        const int t = lo;
        if (t != tprev) {
            tprev = t;
            pref = s_pref[t];
            const long long bt = (long long)b * T + t;
            off = offsets[bt];
            len = lens[bt];
            W = s_ro[t + 1] - s_ro[t];
            term_constants<GENERIC>(tconst, bt, C, tc);
            sc = scoring[bt];
            start = clamped_start(off, n_post, W);
        }
        if (pref) continue;
        const int i = r - s_ro[t];
        int d = XT_SENTINEL;
        float w = 0.0f;
        if (i < len) {
            const long long s = start + i;
            d = post_docids[s];
            const float u = gather_uniq ? uniq[min(d, nd1 - 1)] : 1.0f;
            w = scored<GENERIC>(
                scheme_sumpart<GENERIC>(sp, post_wdf[s], post_doclen[s], tc,
                                        u), sc);
        }
        out_ids[(long long)b * R + r] = d;
        out_w[(long long)b * R + r] = w;
    }
}

// one (prefix term, query) block: the term is blockIdx.x-th prefix term
template <bool GENERIC>
__device__ __forceinline__ void score_prefix_block(SCORE_SLICES_PARAMS) {
    extern __shared__ unsigned char smem[];
    int t = 0;
    for (int n = blockIdx.x; t < T; ++t)
        if (is_prefix[t] && n-- == 0) break;
    const int b = blockIdx.y;
    const int W = widths[t];
    const long long bt = (long long)b * T + t;
    const int off = offsets[bt], len = lens[bt];
    float tc[2];
    term_constants<GENERIC>(tconst, bt, C, tc);
    const float sc = scoring[bt];
    const bool gather_uniq = GENERIC && uniq != nullptr;
    const long long start = clamped_start(off, n_imp, W);
    int* ids_out = out_ids + (long long)b * R + row_off[t];
    float* w_out = out_w + (long long)b * R + row_off[t];

    int n2 = 1;
    while (n2 < W) n2 <<= 1;
    // shared memory, or past MAX_PREFIX_ROWS the block's region of the
    // device scratch (2 * n2max words a (query, term))
    int* keys = scratch != nullptr ? scratch + bt * 2 * n2max
                                   : reinterpret_cast<int*>(smem);
    float* vals = reinterpret_cast<float*>(keys + n2);
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
        int key = XT_SENTINEL;
        float w = 0.0f;
        if (i < W && i < len) {
            const long long s = start + i;
            key = imp_docids[s];
            const float u = gather_uniq ? uniq[min(key, nd1 - 1)] : 1.0f;
            w = scored<GENERIC>(
                scheme_sumpart<GENERIC>(sp, imp_wdf[s], imp_doclen[s], tc,
                                        u), sc);
        }
        keys[i] = key;
        vals[i] = w;
    }
    __syncthreads();
    // bitonic sort ascending by docid; docids are unique within a term,
    // and the SENTINEL rows all carry weight 0, so the order is unique
    for (int k = 2; k <= n2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n2; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const bool up = (i & k) == 0;
                    const int a = keys[i], c = keys[ixj];
                    if ((a > c) == up) {
                        keys[i] = c;
                        keys[ixj] = a;
                        const float v = vals[i];
                        vals[i] = vals[ixj];
                        vals[ixj] = v;
                    }
                }
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        ids_out[i] = keys[i];
        w_out[i] = vals[i];
    }
    if (threadIdx.x == 0) {
        // weight at the boundary row bounds every unread posting
        long long bpos = (long long)off + W;
        if (bpos > n_imp - 1) bpos = n_imp - 1;
        // (JAX passes no uniqterms here, executor.py:702)
        const float gb = scheme_sumpart<GENERIC>(sp, imp_wdf[bpos],
                                                 imp_doclen[bpos], tc, 1.0f);
        out_tail[bt] = len > W ? fmaxf(scored<GENERIC>(gb, sc), 0.0f) : 0.0f;
    }
}

// BM25: no register cap (its formula needs few)
__global__ void __launch_bounds__(SS_THREADS)
score_tiles_kernel(SCORE_SLICES_PARAMS) {
    score_tiles_block<false>(SCORE_SLICES_ARGS);
}

__global__ void score_prefix_kernel(SCORE_SLICES_PARAMS) {
    score_prefix_block<false>(SCORE_SLICES_ARGS);
}

// every other scheme: its formulas' registers capped at 64, four tiles an
// SM at least; the prefix blocks at the 64 that 1024 threads allow
__global__ void __launch_bounds__(SS_THREADS, 4)
score_tiles_generic_kernel(SCORE_SLICES_PARAMS) {
    score_tiles_block<true>(SCORE_SLICES_ARGS);
}

__global__ void __launch_bounds__(1024)
score_prefix_generic_kernel(SCORE_SLICES_PARAMS) {
    score_prefix_block<true>(SCORE_SLICES_ARGS);
}

// n_pref: the number of prefix terms (is_prefix's nonzero entries)
extern "C" int xt_score_slices(
    const void* post_docids, const void* post_wdf, const void* post_doclen,
    long long n_post, const void* imp_docids, const void* imp_wdf,
    const void* imp_doclen, long long n_imp, const void* offsets,
    const void* lens, const void* tconst, const void* scoring,
    const void* widths, const void* is_prefix, const void* row_off, int B,
    int T, int R, int n_pref, int smem_bytes, int scheme,
    const float* params, int C, const void* uniq, int nd1, void* out_ids,
    void* out_w, void* out_tail, void* scratch, int n2max, void* stream) {
    if (B == 0 || T == 0) return 0;
    const SchemeSpec sp = make_spec(scheme, params);
    const bool bm25 = scheme == XT_SCHEME_BM25;
    cudaStream_t st = (cudaStream_t)stream;
#define SS_LAUNCH_ARGS                                                      \
    (const int*)post_docids, (const float*)post_wdf,                        \
        (const float*)post_doclen, n_post, (const int*)imp_docids,          \
        (const float*)imp_wdf, (const float*)imp_doclen, n_imp,             \
        (const int*)offsets, (const int*)lens, (const float*)tconst,        \
        (const float*)scoring, (const int*)widths, (const int*)is_prefix,   \
        (const int*)row_off, T, R, sp, C, (const float*)uniq, nd1,          \
        (int*)out_ids, (float*)out_w, (float*)out_tail, (int*)scratch, n2max
    if (n_pref < T) {
        const long long tile = (long long)SS_THREADS * SS_RPT;
        const long long tiles = R > 0 ? (R + tile - 1) / tile : 1;
        const int smem = (2 * T + 1) * (int)sizeof(int);
        auto kernel = bm25 ? score_tiles_kernel : score_tiles_generic_kernel;
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        kernel<<<dim3((unsigned)tiles, B), SS_THREADS, smem, st>>>(
            SS_LAUNCH_ARGS);
        const int rc = (int)cudaGetLastError();
        if (rc) return rc;
    }
    if (n_pref > 0) {
        auto kernel = bm25 ? score_prefix_kernel : score_prefix_generic_kernel;
        if (smem_bytes > 0)
            cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes);
        kernel<<<dim3(n_pref, B), 1024, smem_bytes, st>>>(SS_LAUNCH_ARGS);
    }
#undef SS_LAUNCH_ARGS
    return (int)cudaGetLastError();
}
