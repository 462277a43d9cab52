// merge_docs: per-doc score sums, OR of group bits, the eligible mask and
// per-query counts.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 743-783 (the
// lax.sort of all rows by docid), _merge_runs 158-189 (run sums and the
// OR of group bits over equal docids), the tail/first/deletes epilogue
// 784-828, the boolean tree _eval_tree 249-282 (or its superset rewrite
// _upper_tree 285-310) over the bits 858-880, and the count 881.
//
// The TPU sorted all R rows of a query because its gathers serialise
// (executor.py:20-25). This kernel computes the same per-doc sums with no
// sort, by the join formulation of _execute_join 1102-1128: every term
// block is docid-ascending (score_slices guarantees it), so a row finds
// its doc in every other term's block by binary search. Its sum adds the
// hit weights in term order t = 0..T-1, its bits OR the group bits of
// every term holding the doc, and the row owns its doc only when no
// lower-numbered term holds the doc. Every row of one doc therefore holds
// the same sum and bits, and exactly one of them is the owner.
//
// The epilogue (K6) writes mask = owner & !deleted[doc] & tree(bits),
// where the tree is a postfix program (common.cuh eval_tree): the full
// tree when the plan has no value filters, the upper tree (F leaves ALL or
// NONE by polarity) before compaction, or ALL when filter_leaves applies
// the tree later. Null bits, deleted or program leave that part out.
//
// Grid (row tiles of 256, B). An exact re-run has ~150k rows per query and
// a faceted AND ~1.3M, so a per-query shared-memory design would not fit.
//
// Bound on the H100: latency of the dependent loads of T-1 binary searches
// (log2 of the block width each) per row. The blocks of one query are
// small enough to stay in the 50 MB L2, so the probes are L2 hits; one
// block reduction and one integer atomic per tile give `count`
// deterministically. The tree costs a few register ops per row.
#include "common.cuh"

__global__ void merge_docs_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ bits,
    const unsigned char* __restrict__ deleted, long long n_deleted,
    const int* __restrict__ prog, int prog_len, float* __restrict__ sums,
    unsigned char* __restrict__ mask, int* __restrict__ count,
    int* __restrict__ orbits) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    int m = 0;
    if (r < R) {
        const long long base = (long long)b * R;
        const int d = ids[base + r];
        // the term this row belongs to: last t with row_off[t] <= r
        int lo = 0, hi = T - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (row_off[mid] <= r) lo = mid; else hi = mid - 1;
        }
        const int t = lo;
        const int* qbits = bits ? bits + (long long)b * T : nullptr;
        float s = 0.0f;
        unsigned ob = 0;
        if (d != XT_SENTINEL) {
            m = 1;
            for (int u = 0; u < T; ++u) {
                if (u == t) {
                    s = s + w[base + r];
                    if (qbits) ob |= (unsigned)qbits[u];
                    continue;
                }
                const int* blk = ids + base + row_off[u];
                const int pos = lower_bound_i32(blk, widths[u], d);
                if (pos < widths[u] && blk[pos] == d) {
                    s = s + w[base + row_off[u] + pos];
                    if (qbits) ob |= (unsigned)qbits[u];
                    if (u < t) m = 0;
                }
            }
            if (m && deleted) {
                const long long dd = (long long)d < n_deleted - 1
                    ? (long long)d : n_deleted - 1;
                m = deleted[dd] ? 0 : 1;
            }
            if (m && prog) m = eval_tree(prog, prog_len, ob, 0u, 0u, 0u);
        }
        sums[base + r] = s;
        mask[base + r] = (unsigned char)m;
        if (orbits) orbits[base + r] = (int)ob;
    }
    const int n = __syncthreads_count(m);
    if (threadIdx.x == 0 && n) atomicAdd(count + b, n);
}

extern "C" int xt_merge_docs(const void* ids, const void* w,
                             const void* widths, const void* row_off, int B,
                             int T, int R, const void* bits,
                             const void* deleted, long long n_deleted,
                             const void* prog, int prog_len, void* sums,
                             void* mask, void* count, void* orbits,
                             void* stream) {
    if (B == 0 || R == 0) return 0;
    dim3 grid((R + 255) / 256, B);
    merge_docs_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const float*)w, (const int*)widths,
        (const int*)row_off, T, R, (const int*)bits,
        (const unsigned char*)deleted, n_deleted, (const int*)prog, prog_len,
        (float*)sums, (unsigned char*)mask, (int*)count, (int*)orbits);
    return (int)cudaGetLastError();
}
