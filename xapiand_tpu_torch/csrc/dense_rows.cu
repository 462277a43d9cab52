// dense_rows: the rows of the dense match-all path, one per (query, doc).
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _execute_dense 1242-1274 and
// the masks group_leaf 1276-1280 reads: d = arange(ND+1), live = not
// deleted and not the pad doc, and per term a scatter of its posting block
// over the doc axis (.at[idt].max for the group mask, .at[idt].add for the
// scheme's weight, 1262-1271), the pad doc's score set to 0.
//
// The weight is the query's scheme (common.cuh scheme_sumpart; BM25 the
// GENERIC = false instance, as before the other schemes), tconst
// f32[B, T, C], with uniq[d] (f32[ND+1], nullptr when the scheme reads
// none) for DiceCoeff and LM absolute discount.
//
// The TPU scattered because each term block is a contiguous slice; on the
// H100 a float scatter-add means float atomics, whose order is not fixed.
// This kernel gathers instead: one thread per (query, doc) looks the doc up
// in every term's docid-ascending posting block by binary search
// (lower_bound_i32) and adds the hits' weights in term order t = 0..T-1,
// with score_slices' float32 arithmetic (-fmad=false), so the sum is the
// scatter's (each term holds a doc once) and the same bits on every launch.
// The term block is the slice the TPU reads: classes[t] rows from the
// clamped start, of which the first min(lens, classes[t]) count.
//
// Outputs per query: ids = the docid of each row (the row index), scores,
// orbits (bit g where a term of group g holds the doc; the pad doc 0) and
// live, the mask every later kernel takes as its base. A plan with no real
// term (_match_all alone: every lens 0) searches nothing and writes zeros.
//
// Grid (doc tiles of 256, B). Bound on the H100: the function's outputs are
// 8 bytes a row (scores, orbits) and one live flag a doc; this kernel writes
// 13 bytes a row - the docid and the live flag of every row of every query
// too, because the kernels after it read ids and a base mask as [B, R]
// arrays - so it runs at 13/8 of its byte bound at best, plus the latency
// of T binary searches per row into posting blocks that stay in L2.
#include "common.cuh"

template <bool GENERIC>
__global__ void dense_rows_kernel(
    const int* __restrict__ post_docids, const float* __restrict__ post_wdf,
    const float* __restrict__ post_doclen, long long n_post,
    const int* __restrict__ offsets, const int* __restrict__ lens,
    const float* __restrict__ tconst, const float* __restrict__ scoring,
    const int* __restrict__ bits, const int* __restrict__ classes, int T,
    const unsigned char* __restrict__ deleted, int ND1, SchemeSpec sp, int C,
    const float* __restrict__ uniq, int* __restrict__ ids,
    float* __restrict__ scores, int* __restrict__ orbits,
    unsigned char* __restrict__ live) {
    const int b = blockIdx.y;
    const int d = blockIdx.x * blockDim.x + threadIdx.x;
    if (d >= ND1) return;
    float s = 0.0f;
    unsigned ob = 0;
    const bool real = d < ND1 - 1;
    if (real) {
        const float u = (GENERIC && uniq != nullptr) ? uniq[d] : 1.0f;
        for (int t = 0; t < T; ++t) {
            const int bt = b * T + t;
            const int W = classes[t];
            int ln = lens[bt];
            if (ln > W) ln = W;
            if (ln <= 0) continue;
            long long start = (long long)offsets[bt];
            if (start > n_post - W) start = n_post - W;
            if (start < 0) start = 0;
            const int* blk = post_docids + start;
            const int pos = lower_bound_i32(blk, ln, d);
            if (pos < ln && blk[pos] == d) {
                const float* tc = tconst + (long long)bt * (GENERIC ? C : 1);
                const float w = scored<GENERIC>(
                    scheme_sumpart<GENERIC>(sp, post_wdf[start + pos],
                                            post_doclen[start + pos], tc, u),
                    scoring[bt]);
                s = s + w;
                ob |= (unsigned)bits[bt];
            }
        }
    }
    const long long o = (long long)b * ND1 + d;
    ids[o] = d;
    scores[o] = s;
    orbits[o] = (int)ob;
    live[o] = (unsigned char)(real && !deleted[d]);
}

extern "C" int xt_dense_rows(
    const void* post_docids, const void* post_wdf, const void* post_doclen,
    long long n_post, const void* offsets, const void* lens,
    const void* tconst, const void* scoring, const void* bits,
    const void* classes, int B, int T, const void* deleted, int ND1,
    int scheme, const float* params, int C, const void* uniq, void* ids,
    void* scores, void* orbits, void* live, void* stream) {
    if (B == 0 || ND1 == 0) return 0;
    const SchemeSpec sp = make_spec(scheme, params);
    auto kernel = scheme == XT_SCHEME_BM25 ? dense_rows_kernel<false>
                                           : dense_rows_kernel<true>;
    dim3 grid((ND1 + 255) / 256, B);
    kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int*)post_docids, (const float*)post_wdf,
        (const float*)post_doclen, n_post, (const int*)offsets,
        (const int*)lens, (const float*)tconst, (const float*)scoring,
        (const int*)bits, (const int*)classes, T,
        (const unsigned char*)deleted, ND1, sp, C, (const float*)uniq,
        (int*)ids, (float*)scores, (int*)orbits, (unsigned char*)live);
    return (int)cudaGetLastError();
}
