// agg_distinct: the cardinality aggregation - the exact number of distinct
// value keys among a query's matched docs, and its HyperLogLog registers.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py compute_aggs' cardinality branch
// 424-472 (a lax.sort of the masked (hi, lo) keys and a count of the run
// heads; then the registers as a sort-based segment maximum) with _hash32
// 40-49. The TPU sorted because its scatters serialise.
//
// Here a row is on the mask when it is eligible and its doc has the value.
//   exact count: each query owns an open-addressed hash set of 64-bit keys
//     in a global scratch (a power of two >= 2 R slots, so it never fills);
//     a row inserts its key with atomicCAS and the insert that found the
//     slot empty counts. Which row wins is not fixed, how many win is: the
//     count is exact and the same on every launch. The key (INT32_MAX,
//     INT32_MAX) marks an empty slot and is not counted - the TPU version
//     masks with that key and leaves it out too.
//   registers: _hash32 in uint32 arithmetic, idx = h >> 22, rest = h << 10,
//     rho = 23 where rest is 0, else clz(rest) + 1; atomicMax on int32 in
//     1024 shared-memory registers a block, then atomicMax into the
//     query's registers. An integer maximum has no order.
//
// Grid (G, B): G blocks split a query's rows (ops/kernels.py _split).
// Bound on the H100: 5 bytes read per row, 9 of the value column per
// eligible row, and one atomicCAS per masked row into the 16 R-byte set
// (L2 while it fits).
#include "common.cuh"

#define AD_THREADS 256
#define AD_REGS 1024
#define AD_EMPTY 0x7fffffff7fffffffull

__device__ __forceinline__ unsigned hash32(unsigned hi, unsigned lo) {
    unsigned h = hi ^ (lo * 0x9E3779B9u);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

__global__ void fill_empty_kernel(unsigned long long* __restrict__ t,
                                  long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        t[i] = AD_EMPTY;
}

__global__ void __launch_bounds__(AD_THREADS) agg_distinct_kernel(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, const int* __restrict__ col_hi,
    const int* __restrict__ col_lo,
    const unsigned char* __restrict__ col_present, long long n_col,
    unsigned long long* __restrict__ table, long long cap,
    int* __restrict__ count, int* __restrict__ regs) {
    __shared__ int sregs[AD_REGS];
    const int b = blockIdx.y;
    const long long base = (long long)b * R;
    unsigned long long* tab = table + (long long)b * cap;
    for (int i = threadIdx.x; i < AD_REGS; i += AD_THREADS) sregs[i] = 0;
    __syncthreads();
    int won = 0;
    const long long per = (R + gridDim.x - 1) / gridDim.x;
    const long long r0 = per * blockIdx.x;
    const long long r1 = r0 + per < R ? r0 + per : R;
    for (long long r = r0 + threadIdx.x; r < r1; r += AD_THREADS) {
        if (!elig[base + r]) continue;
        const long long d = ids[base + r];
        const long long dd = d < n_col - 1 ? d : n_col - 1;
        if (!col_present[dd]) continue;
        const unsigned hi = (unsigned)col_hi[dd], lo = (unsigned)col_lo[dd];
        const unsigned h = hash32(hi, lo);
        const unsigned rest = h << 10;
        const int rho = rest == 0 ? 23 : __clz((int)rest) + 1;
        // few distinct keys meet in few registers and slots: look before
        // the atomic (a stale read only costs the atomic it would skip)
        if (*(volatile int*)&sregs[h >> 22] < rho)
            atomicMax(&sregs[h >> 22], rho);
        const unsigned long long key = ((unsigned long long)hi << 32) | lo;
        if (key == AD_EMPTY) continue;
        // the probe loop stays in this body: as a device function shared
        // with collapse_rows.cu the kernel ran 2.2x slower at B = 256,
        // R = 1,000,001 on the H100 (8.67 against 3.91 ms a launch)
        long long s = (long long)(mix64(key) & (unsigned long long)(cap - 1));
        for (;;) {
            unsigned long long prev = *(volatile unsigned long long*)&tab[s];
            if (prev == AD_EMPTY) prev = atomicCAS(&tab[s], AD_EMPTY, key);
            if (prev == AD_EMPTY) {
                ++won;
                break;
            }
            if (prev == key) break;
            s = (s + 1) & (cap - 1);
        }
    }
    __syncthreads();
    for (int o = 16; o > 0; o >>= 1) won += __shfl_xor_sync(0xffffffffu, won, o);
    if ((threadIdx.x & 31) == 0 && won) atomicAdd(count + b, won);
    for (int i = threadIdx.x; i < AD_REGS; i += AD_THREADS)
        if (sregs[i]) atomicMax(regs + (long long)b * AD_REGS + i, sregs[i]);
}

// table: B * cap uint64 of scratch; count i32[B] and regs i32[B, 1024] are
// written whole.
extern "C" int xt_agg_distinct(const void* ids, const void* elig, int B,
                               long long R, int G, const void* col_hi,
                               const void* col_lo, const void* col_present,
                               long long n_col, void* table, long long cap,
                               void* count, void* regs, void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    cudaMemsetAsync(count, 0, sizeof(int) * B, st);
    cudaMemsetAsync(regs, 0, sizeof(int) * (size_t)B * AD_REGS, st);
    fill_empty_kernel<<<1024, 256, 0, st>>>((unsigned long long*)table,
                                            (long long)B * cap);
    dim3 grid(G, B);
    agg_distinct_kernel<<<grid, AD_THREADS, 0, st>>>(
        (const int*)ids, (const unsigned char*)elig, R, (const int*)col_hi,
        (const int*)col_lo, (const unsigned char*)col_present, n_col,
        (unsigned long long*)table, cap, (int*)count, (int*)regs);
    return (int)cudaGetLastError();
}
