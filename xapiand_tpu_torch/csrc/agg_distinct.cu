// agg_distinct: the cardinality aggregation - the exact number of distinct
// value keys among a query's matched docs, and its HyperLogLog registers.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py compute_aggs' cardinality branch
// 424-472 (a lax.sort of the masked (hi, lo) keys and a count of the run
// heads; then the registers as a sort-based segment maximum) with _hash32
// 40-49. The TPU sorted because its scatters serialise.
//
// Here a row is on the mask when it is eligible and its doc has the value.
// The column's distinct keys are fixed at upload (models/segment.py
// value_arrays): each doc carries a dense code, the rank of its key among
// the column's K distinct keys (-1 where it has no value), and each code
// its register index and rho (code_hll). So a query's distinct keys are
// the population of a K-bit set, and its registers the maximum of rho over
// the set's codes a register: the scratch is B x ceil(K / 32) words,
// whatever the rows.
//
//   set:  grid (G, B): G blocks split a query's rows. A thread reads the
//         flags of 16 rows at a time (common.cuh flat_mask16), then the
//         docid and code of each set bit (an id past n - 1 reads row
//         n - 1), and sets the code's bit: in a shared-memory copy of the
//         set where its K bits fit (AD_SMEM_WORDS), which the block ORs
//         into the query's words at its end; past that in the query's
//         words with atomicOr. A bit already set is not set again (a
//         stale read only costs the atomic it would skip).
//   fold: a second kernel, grid (G2, B), a thread a word of the query's
//         set: the count is the population of the words, leaving out the
//         code of the key (INT32_MAX, INT32_MAX), which the TPU version
//         masks with and leaves out too; the registers are the maximum of
//         each set code's rho at its index (the word's codes read
//         together, then shared int atomics, then atomicMax into the
//         query's registers: an integer maximum has no order).
//
// Bound on the H100 (chip_smoke.py work_distinct): the flag byte of every
// row; an eligible row's docid and its key (9 bytes, the column read at
// most once); the count and 1024 registers a query.
#include "common.cuh"

#define AD_THREADS 256
#define AD_REGS 1024
#define AD_SMEM_WORDS 2048    // the shared-memory set: 65,536 codes
#define AD_SKIP (1 << 15)     // code_hll: the key left out of the count

__global__ void __launch_bounds__(AD_THREADS) agg_distinct_set(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, const int* __restrict__ codes, long long n_col, int W,
    unsigned* __restrict__ words, int aligned) {
    extern __shared__ unsigned ad_set[];
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int G = gridDim.x;
    const bool local = W <= AD_SMEM_WORDS;
    unsigned* qw = words + (long long)b * W;
    unsigned* set = local ? ad_set : qw;
    if (local)
        for (int i = t; i < W; i += AD_THREADS) ad_set[i] = 0u;
    __syncthreads();
    const long long lo = (long long)b * R, hi = lo + R;
    const long long ga = lo >> 4, ng = ((hi + 15) >> 4) - ga;
    const long long g0 = ga + ng * g / G, g1 = ga + ng * (g + 1) / G;
    for (long long gi = g0 + t; gi < g1; gi += AD_THREADS) {
        unsigned m = flat_mask16(elig, lo, hi, gi,
                                 flat_full(gi, lo, hi, aligned != 0));
        while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            const long long d = __ldg(ids + gi * 16 + j);
            const int c = __ldg(codes + (d < n_col - 1 ? d : n_col - 1));
            if (c < 0) continue;    // the doc has no value
            const unsigned bit = 1u << (c & 31);
            unsigned* w = set + (c >> 5);
            if (!(*(volatile unsigned*)w & bit)) atomicOr(w, bit);
        }
    }
    if (!local) return;
    __syncthreads();
    for (int i = t; i < W; i += AD_THREADS)
        if (ad_set[i]) atomicOr(qw + i, ad_set[i]);
}

__global__ void __launch_bounds__(AD_THREADS) agg_distinct_fold(
    const unsigned* __restrict__ words, int W, const int* __restrict__ hll,
    int* __restrict__ count, int* __restrict__ regs) {
    __shared__ int sregs[AD_REGS];
    __shared__ int wsum[AD_THREADS / 32];
    const int b = blockIdx.y, t = threadIdx.x;
    for (int i = t; i < AD_REGS; i += AD_THREADS) sregs[i] = 0;
    __syncthreads();
    const unsigned* qw = words + (long long)b * W;
    int n = 0;
    for (int i = blockIdx.x * AD_THREADS + t; i < W;
         i += gridDim.x * AD_THREADS) {
        const unsigned x = qw[i];
        if (!x) continue;
        int h[32];
#pragma unroll
        for (int j = 0; j < 32; ++j)
            h[j] = (x >> j) & 1u ? __ldg(hll + i * 32 + j) : 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            if (!((x >> j) & 1u)) continue;
            if (!(h[j] & AD_SKIP)) ++n;
            const int idx = (h[j] >> 5) & (AD_REGS - 1), rho = h[j] & 31;
            if (sregs[idx] < rho) atomicMax(sregs + idx, rho);
        }
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if ((t & 31) == 0) wsum[t >> 5] = n;
    __syncthreads();
    if (t == 0) {
        n = 0;
        for (int w = 0; w < AD_THREADS / 32; ++w) n += wsum[w];
        if (n) atomicAdd(count + b, n);
    }
    for (int i = t; i < AD_REGS; i += AD_THREADS)
        if (sregs[i]) atomicMax(regs + (long long)b * AD_REGS + i, sregs[i]);
}

// words: B * W u32 of scratch (W = ceil(K / 32), at least 1); count i32[B]
// and regs i32[B, 1024] are written whole (all three zeroed here first).
// G blocks a query set the bits, G2 blocks a query fold the words.
// aligned: ids and elig are 16-byte aligned.
extern "C" int xt_agg_distinct(const void* ids, const void* elig, int B,
                               long long R, int G, const void* codes,
                               long long n_col, const void* hll, int W,
                               int G2, void* words, void* count, void* regs,
                               int aligned, void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    cudaMemsetAsync(words, 0, sizeof(unsigned) * (size_t)B * W, st);
    cudaMemsetAsync(count, 0, sizeof(int) * (size_t)B, st);
    cudaMemsetAsync(regs, 0, sizeof(int) * (size_t)B * AD_REGS, st);
    const size_t smem = W <= AD_SMEM_WORDS ? sizeof(unsigned) * W : 0;
    agg_distinct_set<<<dim3(G, B), AD_THREADS, smem, st>>>(
        (const int*)ids, (const unsigned char*)elig, R, (const int*)codes,
        n_col, W, (unsigned*)words, aligned);
    agg_distinct_fold<<<dim3(G2, B), AD_THREADS, 0, st>>>(
        (const unsigned*)words, W, (const int*)hll, (int*)count, (int*)regs);
    return (int)cudaGetLastError();
}
