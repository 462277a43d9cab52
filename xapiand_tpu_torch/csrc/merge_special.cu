// merge_special: the per-doc sums of a plan with OP_MAX or OP_SYNONYM.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 746-756 (the base
// weights without the OP_MAX branches' terms) and 787-812 (per max spec
// the best branch sum; per synonym group the summed wdf scored once), each
// a _merge_runs segmented scan over the docid-sorted rows.
//
// It runs after merge_docs on the same rows (term blocks, each docid-
// ascending) and rewrites `sums` on every real row, from scratch, in one
// stated float32 order:
//   1. the base: the doc's weights in term order t = 0..T-1, leaving out
//      every term whose group bit lies in a branch mask of a max spec;
//   2. per max spec, in order: per branch mask the doc's weights of the
//      terms whose bit lies in the mask, in term order; the maximum over
//      the branches is added;
//   3. per synonym group i, in order: ssum = the raw wdf of the doc's
//      postings of the terms whose bit lies in syn_groups[i], in term
//      order; where ssum > 0, sumpart(ssum, dl, syn_tconst[b, i]) is added,
//      dl the doc's length (1 where it is 0), in the query's scheme
//      (common.cuh scheme_sumpart; BM25 the GENERIC = false instance, as
//      before the other schemes), syn_tconst f32[B, NS, C], with the doc's
//      uniqterms (uniq[min(d, ND)], 807-811) where the scheme reads it.
// A row finds its doc in another term's block by binary search, as
// merge_docs does; the hit's position is also the posting's index past the
// block's clamped start, where post_wdf and post_doclen are read (the rows
// carry no wdf). Synonym terms are bound non-scoring, so their weight is 0
// in the base already.
//
// Table `spec` (int32): n_max, then per max spec its branch count and its
// branch masks; then n_syn and the synonym masks.
//
// Grid (row tiles of 256, B). Bound on the H100: the latency of the binary
// searches, (1 + branches + synonym groups) passes over the T terms per
// row, all L2 hits.
#include "common.cuh"

struct SpecialRow {
    const int* ids;
    const float* w;
    const int* widths;
    const int* row_off;
    long long base;
    int T, t, r, d;

    // the row of the doc in term u's block, or -1
    __device__ __forceinline__ int find(int u) const {
        if (u == t) return r - row_off[t];
        const int* blk = ids + base + row_off[u];
        const int pos = lower_bound_i32(blk, widths[u], d);
        return (pos < widths[u] && blk[pos] == d) ? pos : -1;
    }
};

template <bool GENERIC>
__global__ void merge_special_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ bits, const int* __restrict__ offsets,
    const float* __restrict__ post_wdf, const float* __restrict__ post_doclen,
    long long n_post, const int* __restrict__ spec,
    const float* __restrict__ syn_tconst, int NS, SchemeSpec sp, int C,
    const float* __restrict__ uniq, int nd1, float* __restrict__ sums) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    SpecialRow row;
    row.ids = ids;
    row.w = w;
    row.widths = widths;
    row.row_off = row_off;
    row.base = (long long)b * R;
    row.T = T;
    row.r = r;
    row.d = ids[row.base + r];
    if (row.d == XT_SENTINEL) {
        sums[row.base + r] = 0.0f;
        return;
    }
    int lo = 0, hi = T - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (row_off[mid] <= r) lo = mid; else hi = mid - 1;
    }
    row.t = lo;
    const int* qbits = bits + (long long)b * T;
    const int n_max = spec[0];
    unsigned excl = 0;
    int at = 1;
    for (int i = 0; i < n_max; ++i) {
        const int nb = spec[at++];
        for (int j = 0; j < nb; ++j) excl |= (unsigned)spec[at++];
    }
    const int syn_at = at;
    float s = 0.0f;
    for (int u = 0; u < T; ++u) {
        if ((unsigned)qbits[u] & excl) continue;
        const int pos = row.find(u);
        if (pos >= 0) s = s + w[row.base + row_off[u] + pos];
    }
    at = 1;
    for (int i = 0; i < n_max; ++i) {
        const int nb = spec[at++];
        float best = 0.0f;
        for (int j = 0; j < nb; ++j) {
            const unsigned m = (unsigned)spec[at++];
            float bs = 0.0f;
            for (int u = 0; u < T; ++u) {
                if (!((unsigned)qbits[u] & m)) continue;
                const int pos = row.find(u);
                if (pos >= 0) bs = bs + w[row.base + row_off[u] + pos];
            }
            best = j == 0 ? bs : fmaxf(best, bs);
        }
        if (nb > 0) s = s + best;
    }
    const int n_syn = spec[syn_at];
    if (n_syn > 0) {
        // the doc's length, read at the row's own posting
        long long st = (long long)offsets[(long long)b * T + row.t];
        if (st > n_post - widths[row.t]) st = n_post - widths[row.t];
        if (st < 0) st = 0;
        float dl = post_doclen[st + (r - row_off[row.t])];
        if (!(dl > 0.0f)) dl = 1.0f;
        const float u = (GENERIC && uniq != nullptr)
                            ? uniq[min(row.d, nd1 - 1)] : 1.0f;
        for (int i = 0; i < n_syn; ++i) {
            const unsigned m = (unsigned)spec[syn_at + 1 + i];
            float ssum = 0.0f;
            for (int u = 0; u < T; ++u) {
                if (!((unsigned)qbits[u] & m)) continue;
                const int pos = row.find(u);
                if (pos < 0) continue;
                long long su = (long long)offsets[(long long)b * T + u];
                if (su > n_post - widths[u]) su = n_post - widths[u];
                if (su < 0) su = 0;
                ssum = ssum + post_wdf[su + pos];
            }
            if (ssum > 0.0f)
                s = s + scheme_sumpart<GENERIC>(
                    sp, ssum, dl,
                    syn_tconst + ((long long)b * NS + i) * (GENERIC ? C : 1),
                    u);
        }
    }
    sums[row.base + r] = s;
}

extern "C" int xt_merge_special(
    const void* ids, const void* w, const void* widths, const void* row_off,
    int B, int T, int R, const void* bits, const void* offsets,
    const void* post_wdf, const void* post_doclen, long long n_post,
    const void* spec, const void* syn_tconst, int NS, int scheme,
    const float* params, int C, const void* uniq, int nd1, void* sums,
    void* stream) {
    if (B == 0 || R == 0) return 0;
    const SchemeSpec sp = make_spec(scheme, params);
    auto kernel = scheme == XT_SCHEME_BM25 ? merge_special_kernel<false>
                                           : merge_special_kernel<true>;
    dim3 grid((R + 255) / 256, B);
    kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const float*)w, (const int*)widths,
        (const int*)row_off, T, R, (const int*)bits, (const int*)offsets,
        (const float*)post_wdf, (const float*)post_doclen, n_post,
        (const int*)spec, (const float*)syn_tconst, NS, sp, C,
        (const float*)uniq, nd1, (float*)sums);
    return (int)cudaGetLastError();
}
