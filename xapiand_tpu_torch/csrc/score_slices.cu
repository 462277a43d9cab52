// score_slices: slice each (query, term) posting span and weigh it with the
// query's scheme.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 691-742 (the
// per-term lax.dynamic_slice + scheme.sumpart, models/weights.py 126-575,
// with uniqterms gathered by docid for the schemes that read it, 716-721)
// and the prefix-mode unread-tail bound (698-705).
//
// tconst is f32[B, T, C] (C = the scheme's n_constants). BM25 launches the
// GENERIC = false instance, BM25's inline formula as before the other
// schemes; every other scheme the instance that switches on the spec's id
// (common.cuh scheme_sumpart). uniq (f32[ND+1], nullptr when the scheme
// reads none) is read at min(docid, ND) for in-length rows only, as JAX
// reads it at SENTINEL-masked docids.
//
// Grid (T, B): one block per (term, query). A block writes the term's
// `width` rows at its row offset: docid (SENTINEL at or past lens[t]) and
// weight * scoring[t] (0 there). Prefix-mode terms read the first
// `width` rows of the impact-ordered mirror (imp.*), whose rows are in
// descending-impact order, not docid order; the block sorts them by docid
// in shared memory (bitonic, padded to a power of two) so that every term
// block leaves the kernel docid-ascending, which merge_docs' binary
// searches rely on. Such a block also writes the term's tail bound.
//
// Bound on the H100: device-memory bytes (12 B read + 8 B written per
// row, no reuse, plus 4 B of uniqterms where read); the arithmetic is a
// handful of flops per row for BM25 and up to six logarithms for BB2. The
// design reads each span with consecutive threads on consecutive addresses;
// BM25 and the other schemes run as two kernels of one block function, so
// that the launch bound the latter's registers need leaves BM25's code
// as it was (the bound on both slowed BM25's prefix blocks 10.6%). The
// prefix sort is the only extra cost, and it stays in shared memory
// (width <= 16384 rows, 128 KB).
#include "common.cuh"

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
    float* __restrict__ out_w, float* __restrict__ out_tail
#define SCORE_SLICES_ARGS                                                   \
    post_docids, post_wdf, post_doclen, n_post, imp_docids, imp_wdf,        \
    imp_doclen, n_imp, offsets, lens, tconst, scoring, widths, is_prefix,   \
    row_off, T, R, sp, C, uniq, nd1, out_ids, out_w, out_tail

// one (term, query) block of either kernel below
template <bool GENERIC>
__device__ __forceinline__ void score_slices_block(SCORE_SLICES_PARAMS) {
    extern __shared__ unsigned char smem[];
    const int t = blockIdx.x, b = blockIdx.y;
    const int W = widths[t];
    const int bt = b * T + t;
    const int off = offsets[bt], len = lens[bt];
    // the term's constants in registers (C <= 2; BM25's is one)
    const long long tci = (long long)bt * (GENERIC ? C : 1);
    const float tc[2] = {tconst[tci],
                         GENERIC && C > 1 ? tconst[tci + 1] : 0.0f};
    const float sc = scoring[bt];
    const bool gather_uniq = GENERIC && uniq != nullptr;
    const bool pref = is_prefix[t] != 0;
    const int* src_d = pref ? imp_docids : post_docids;
    const float* src_w = pref ? imp_wdf : post_wdf;
    const float* src_l = pref ? imp_doclen : post_doclen;
    const long long n_src = pref ? n_imp : n_post;
    // lax.dynamic_slice clamps the start so the slice stays in bounds
    long long start = (long long)off;
    if (start > n_src - W) start = n_src - W;
    if (start < 0) start = 0;
    int* ids_out = out_ids + (long long)b * R + row_off[t];
    float* w_out = out_w + (long long)b * R + row_off[t];

    if (!pref) {
        for (int i = threadIdx.x; i < W; i += blockDim.x) {
            const bool in = i < len;
            const long long s = start + i;
            const float u = (gather_uniq && in) ? uniq[min(src_d[s], nd1 - 1)]
                                                : 1.0f;
            float w = scored<GENERIC>(
                scheme_sumpart<GENERIC>(sp, src_w[s], src_l[s], tc, u), sc);
            ids_out[i] = in ? src_d[s] : XT_SENTINEL;
            w_out[i] = in ? w : 0.0f;
        }
        if (threadIdx.x == 0) out_tail[bt] = 0.0f;
        return;
    }

    int n2 = 1;
    while (n2 < W) n2 <<= 1;
    int* keys = reinterpret_cast<int*>(smem);
    float* vals = reinterpret_cast<float*>(keys + n2);
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
        int key = XT_SENTINEL;
        float w = 0.0f;
        if (i < W && i < len) {
            const long long s = start + i;
            key = src_d[s];
            const float u = gather_uniq ? uniq[min(key, nd1 - 1)] : 1.0f;
            w = scored<GENERIC>(
                scheme_sumpart<GENERIC>(sp, src_w[s], src_l[s], tc, u), sc);
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

// BM25: the kernel as it was before the other schemes
__global__ void score_slices_kernel(SCORE_SLICES_PARAMS) {
    score_slices_block<false>(SCORE_SLICES_ARGS);
}

// every other scheme: its formulas' registers capped at the 64 that 1024
// threads a block allow (a block a (term, query): threads are its width)
__global__ void __launch_bounds__(1024)
score_slices_generic_kernel(SCORE_SLICES_PARAMS) {
    score_slices_block<true>(SCORE_SLICES_ARGS);
}

extern "C" int xt_score_slices(
    const void* post_docids, const void* post_wdf, const void* post_doclen,
    long long n_post, const void* imp_docids, const void* imp_wdf,
    const void* imp_doclen, long long n_imp, const void* offsets,
    const void* lens, const void* tconst, const void* scoring,
    const void* widths, const void* is_prefix, const void* row_off, int B,
    int T, int R, int smem_bytes, int scheme, const float* params, int C,
    const void* uniq, int nd1, void* out_ids, void* out_w, void* out_tail,
    void* stream) {
    if (B == 0 || T == 0) return 0;
    const SchemeSpec sp = make_spec(scheme, params);
    auto kernel = scheme == XT_SCHEME_BM25 ? score_slices_kernel
                                           : score_slices_generic_kernel;
    if (smem_bytes > 0)
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    dim3 grid(T, B);
    kernel<<<grid, 1024, smem_bytes, (cudaStream_t)stream>>>(
        (const int*)post_docids, (const float*)post_wdf,
        (const float*)post_doclen, n_post, (const int*)imp_docids,
        (const float*)imp_wdf, (const float*)imp_doclen, n_imp,
        (const int*)offsets, (const int*)lens, (const float*)tconst,
        (const float*)scoring, (const int*)widths, (const int*)is_prefix,
        (const int*)row_off, T, R, sp, C, (const float*)uniq, nd1,
        (int*)out_ids, (float*)out_w, (float*)out_tail);
    return (int)cudaGetLastError();
}
