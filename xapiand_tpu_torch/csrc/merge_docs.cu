// merge_docs: per-doc score sums, owner rows and per-query match counts.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 743-783 (the
// lax.sort of all rows by docid), _merge_runs 158-189 (run sums over
// equal docids) and the tail/first/count epilogue 784-828, 881.
//
// The TPU sorted all R rows of a query because its gathers serialise
// (executor.py:20-25). This kernel computes the same per-doc sums with no
// sort, by the join formulation of _execute_join 1102-1128: every term
// block is docid-ascending (score_slices guarantees it), so a row finds
// its doc in every other term's block by binary search. Its sum adds the
// hit weights in term order t = 0..T-1, and the row owns its doc only when
// no lower-numbered term holds the doc. Every row of one doc therefore
// holds the same sum, and exactly one of them is the owner.
//
// Grid (row tiles of 256, B). An exact re-run has ~150k rows per query,
// so a per-query shared-memory design would not fit.
//
// Bound on the H100: latency of the dependent loads of T-1 binary searches
// (log2 of the block width each) per row. The blocks of one query are
// small enough to stay in the 50 MB L2, so the probes are L2 hits; one
// block reduction and one integer atomic per tile give `count`
// deterministically.
#include "common.cuh"

__global__ void merge_docs_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, float* __restrict__ sums, unsigned char* __restrict__ owner,
    int* __restrict__ count) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    int own = 0;
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
        float s = 0.0f;
        if (d != XT_SENTINEL) {
            own = 1;
            for (int u = 0; u < T; ++u) {
                if (u == t) {
                    s = s + w[base + r];
                    continue;
                }
                const int* blk = ids + base + row_off[u];
                const int pos = lower_bound_i32(blk, widths[u], d);
                if (pos < widths[u] && blk[pos] == d) {
                    s = s + w[base + row_off[u] + pos];
                    if (u < t) own = 0;
                }
            }
        }
        sums[base + r] = s;
        owner[base + r] = (unsigned char)own;
    }
    const int n = __syncthreads_count(own);
    if (threadIdx.x == 0 && n) atomicAdd(count + b, n);
}

extern "C" int xt_merge_docs(const void* ids, const void* w,
                             const void* widths, const void* row_off, int B,
                             int T, int R, void* sums, void* owner,
                             void* count, void* stream) {
    if (B == 0 || R == 0) return 0;
    dim3 grid((R + 255) / 256, B);
    merge_docs_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const float*)w, (const int*)widths,
        (const int*)row_off, T, R, (float*)sums, (unsigned char*)owner,
        (int*)count);
    return (int)cudaGetLastError();
}
