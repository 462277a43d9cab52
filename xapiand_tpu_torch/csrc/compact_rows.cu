// compact_rows: pack each query's masked rows into a [B, cap] table.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 836-857 (the
// lax.sort that packs the upper-tree rows, with their bits, before the
// filter leaves) and 893-911 (the lax.sort that packs the eligible rows
// before the value-sort gathers).
//
// The TPU packed rows with a full-width sort by (mask key, docid) because
// that is what streams there. Here it is a stream compaction: rows whose
// mask is set keep their relative order and go to the front, docid, sum and
// (optionally) bits; slots past the count get SENTINEL, 0 and 0. The rows
// come out of merge_docs grouped by term, not by docid, so the packed
// order is not the JAX one; nothing downstream depends on it (filter
// leaves are per row, and topk_rows and sort_topk break ties by docid).
// `cap` is the plan's compact_cap, a proven bound on the masked count
// (query/plan.py _required_groups, BatchSearcher.plan's tightening); the
// kernel writes only the first cap rows and reports the full count in
// `n`, so a caller can check the bound.
//
// Grid (B): one block of 1024 threads per query walks the rows in chunks of
// 8192 (8 consecutive rows a thread), with a block-wide exclusive prefix
// sum (warp shuffles, then one warp over the 32 warp totals) per chunk and
// a running offset between chunks. Deterministic and stable.
//
// Bound on the H100: device-memory bytes, one byte per row read for the
// mask and 12 B read and written per packed row; at a faceted group's
// 1.3M rows and B = 64 that is ~85 MB. One block per query leaves SMs idle
// when B < 132; a multi-block decoupled scan is later work.
#include "common.cuh"

#define CR_THREADS 1024
#define CR_ITEMS 8

__global__ void __launch_bounds__(CR_THREADS) compact_rows_kernel(
    const unsigned char* __restrict__ mask, const int* __restrict__ ids,
    const float* __restrict__ sums, const int* __restrict__ orbits, int R,
    int cap, int* __restrict__ out_d, float* __restrict__ out_s,
    int* __restrict__ out_ob, int* __restrict__ out_n) {
    __shared__ int warp_incl[32];
    __shared__ int running;
    const int b = blockIdx.x;
    const long long base = (long long)b * R;
    const long long obase = (long long)b * cap;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) running = 0;
    __syncthreads();
    for (int c0 = 0; c0 < R; c0 += CR_THREADS * CR_ITEMS) {
        const int r0 = c0 + threadIdx.x * CR_ITEMS;
        unsigned char f[CR_ITEMS];
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < CR_ITEMS; ++i) {
            f[i] = (r0 + i < R) ? mask[base + r0 + i] : 0;
            cnt += f[i] ? 1 : 0;
        }
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
        }
        if (lane == 31) warp_incl[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            int v = warp_incl[lane];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(0xffffffffu, v, o);
                if (lane >= o) v += u;
            }
            warp_incl[lane] = v;
        }
        __syncthreads();
        int pos = running + (warp ? warp_incl[warp - 1] : 0) + incl - cnt;
#pragma unroll
        for (int i = 0; i < CR_ITEMS; ++i) {
            if (f[i]) {
                if (pos < cap) {
                    const long long src = base + r0 + i;
                    out_d[obase + pos] = ids[src];
                    out_s[obase + pos] = sums[src];
                    if (out_ob) out_ob[obase + pos] = orbits[src];
                }
                ++pos;
            }
        }
        __syncthreads();
        if (threadIdx.x == CR_THREADS - 1) running = pos;
        __syncthreads();
    }
    const int n = running;
    if (threadIdx.x == 0) out_n[b] = n;
    for (int j = (n < cap ? n : cap) + threadIdx.x; j < cap; j += CR_THREADS) {
        out_d[obase + j] = XT_SENTINEL;
        out_s[obase + j] = 0.0f;
        if (out_ob) out_ob[obase + j] = 0;
    }
}

extern "C" int xt_compact_rows(const void* mask, const void* ids,
                               const void* sums, const void* orbits, int B,
                               int R, int cap, void* out_d, void* out_s,
                               void* out_ob, void* out_n, void* stream) {
    if (B == 0 || cap == 0) return 0;
    compact_rows_kernel<<<B, CR_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)mask, (const int*)ids, (const float*)sums,
        (const int*)orbits, R, cap, (int*)out_d, (float*)out_s, (int*)out_ob,
        (int*)out_n);
    return (int)cudaGetLastError();
}
