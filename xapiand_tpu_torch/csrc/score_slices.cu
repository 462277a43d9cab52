// score_slices: slice each (query, term) posting span and score it with BM25.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 691-742 (the
// per-term lax.dynamic_slice + BM25.sumpart, models/weights.py 126-131)
// and the prefix-mode unread-tail bound (698-705).
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
// row, no reuse); the arithmetic is a handful of flops per row. The design
// reads each span with consecutive threads on consecutive addresses. The
// prefix sort is the only extra cost, and it stays in shared memory
// (width <= 16384 rows, 128 KB).
#include "common.cuh"

__global__ void score_slices_kernel(
    const int* __restrict__ post_docids, const float* __restrict__ post_wdf,
    const float* __restrict__ post_doclen, long long n_post,
    const int* __restrict__ imp_docids, const float* __restrict__ imp_wdf,
    const float* __restrict__ imp_doclen, long long n_imp,
    const int* __restrict__ offsets, const int* __restrict__ lens,
    const float* __restrict__ tconst, const float* __restrict__ scoring,
    const int* __restrict__ widths, const int* __restrict__ is_prefix,
    const int* __restrict__ row_off, int T, int R, Bm25Params p,
    int* __restrict__ out_ids, float* __restrict__ out_w,
    float* __restrict__ out_tail) {
    extern __shared__ unsigned char smem[];
    const int t = blockIdx.x, b = blockIdx.y;
    const int W = widths[t];
    const int bt = b * T + t;
    const int off = offsets[bt], len = lens[bt];
    const float tc = tconst[bt], sc = scoring[bt];
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
            float w = bm25_sumpart(src_w[s], src_l[s], tc, p) * sc;
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
            w = bm25_sumpart(src_w[s], src_l[s], tc, p) * sc;
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
        const float gb = bm25_sumpart(imp_wdf[bpos], imp_doclen[bpos], tc, p);
        out_tail[bt] = len > W ? fmaxf(gb * sc, 0.0f) : 0.0f;
    }
}

extern "C" int xt_score_slices(
    const void* post_docids, const void* post_wdf, const void* post_doclen,
    long long n_post, const void* imp_docids, const void* imp_wdf,
    const void* imp_doclen, long long n_imp, const void* offsets,
    const void* lens, const void* tconst, const void* scoring,
    const void* widths, const void* is_prefix, const void* row_off, int B,
    int T, int R, int smem_bytes, float lf, float k1, float b,
    float one_minus_b, float min_normlen, void* out_ids, void* out_w,
    void* out_tail, void* stream) {
    if (B == 0 || T == 0) return 0;
    if (smem_bytes > 0)
        cudaFuncSetAttribute(score_slices_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    Bm25Params p{lf, k1, b, one_minus_b, min_normlen};
    dim3 grid(T, B);
    score_slices_kernel<<<grid, 1024, smem_bytes, (cudaStream_t)stream>>>(
        (const int*)post_docids, (const float*)post_wdf,
        (const float*)post_doclen, n_post, (const int*)imp_docids,
        (const float*)imp_wdf, (const float*)imp_doclen, n_imp,
        (const int*)offsets, (const int*)lens, (const float*)tconst,
        (const float*)scoring, (const int*)widths, (const int*)is_prefix,
        (const int*)row_off, T, R, p, (int*)out_ids, (float*)out_w,
        (float*)out_tail);
    return (int)cudaGetLastError();
}
