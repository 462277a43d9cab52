// agg_metrics: per query, the count of eligible rows and, for each metric
// spec, masked n / sum / sum of squares / min / max of a value column.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py compute_aggs, the count 196-198
// and the metric branch 249-274 (sum, avg, min, max, variance,
// std_deviation, stats, extended_stats, through _slot_vals 62-74).
//
// For query b and metric spec m, over the rows r with eligible[b, r] and
// d = min(ids[b, r], n_m - 1):
//   count  the number of such rows (int32);
//   n      those with present_m[d]; s, s2 the sums of fval_m[d] and of
//          fval_m[d] * fval_m[d] over them; min, max (+inf / -inf when
//          n is 0), all float32 as in JAX.
//
// One launch, grid (G, B), 256 threads, a kernel a channel width MT (1, 2,
// 4, 8: M rounded up, so one channel keeps 5 partials a lane, not 40; 0:
// the count alone). G comes from kernels.row_plan: blocks of a few
// thousand rows, so that a query whose eligible rows crowd one stretch
// spreads them over many blocks, and where the queries are few (B x G
// short of kernels.AGG_FILL) blocks of fewer rows, gpw 16-row groups a warp
// a step (gpw < 32), so that the card is filled. The rows of block g are
// walked by common.cuh warp_row_queue: a lane a 16-row group a step, its
// flags one
// 16-byte load (the next step's in flight), the count from __popc of the
// flags (no docid read), the eligible rows queued in row order in shared
// memory; the queue is drained 32 rows at a time, a row a lane, AM_U
// batches in flight: a lane issues its rows' docid gathers, then every
// channel's present and fval gathers together.
//
// The fold is fixed, with no float atomics, so two runs give the same
// bits: each lane sums its rows in queue order; the lanes by an xor
// shuffle tree; the warps in order; the G blocks by the last block of the
// query, a warp an output (lane l takes blocks l, l + 32, ... in order,
// then an xor tree: common.cuh fold_blocks), which knows it is last from a
// ticket on a counter a query (after __threadfence, as agg_buckets.cu) and
// sets the counter back to 0 (the counters are the wrapper's, kept zero
// from call to call). The
// order of the float additions is not torch.sum's, so the sums agree with
// the plain version to float32 rounding (tests: rtol 1e-5).
//
// Bound on the H100: the eligible flags, one byte a row (84 MB at config
// 3's widest fullwidth launch, B 64 x R 1,310,720), then for each
// eligible row its docid and one 4-byte and one 1-byte random gather per
// channel (a 1M-doc column is 5 MB and stays in L2). At faceted A's 0.5%
// eligible rows the flags are the launch; the queue keeps every lane of a
// warp on a row however the eligible rows cluster.
#include "common.cuh"

#define AM_THREADS 256
#define AM_WARPS (AM_THREADS / 32)
#define AM_MAXM 8
#ifndef AM_U
#define AM_U 4                // queued rows a lane in flight (MT <= 2)
#endif

struct MetricCols {
    const float* f[AM_MAXM];
    const unsigned char* p[AM_MAXM];
    long long n[AM_MAXM];
};

template <int MT>
__global__ void __launch_bounds__(AM_THREADS) agg_metrics_kernel(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, int G, int gpw, int M, const MetricCols cols,
    float* __restrict__ part, int* __restrict__ cpart,
    int* __restrict__ ctr, int* __restrict__ count,
    float* __restrict__ out) {
    constexpr int U = MT >= 4 ? 2 : AM_U;
    constexpr int W = MT > 0 ? MT : 1;
    __shared__ int queues[MT > 0 ? AM_WARPS * RQ_CAP : 1];
    __shared__ float red[AM_WARPS][W * 5];
    __shared__ int cred[AM_WARPS];
    __shared__ bool last;
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5, B = gridDim.y;
    const long long base = (long long)b * R;
    const float inf = __int_as_float(0x7f800000);
    float cn[W], cs[W], cs2[W], cmn[W], cmx[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
        cn[q] = cs[q] = cs2[q] = 0.0f;
        cmn[q] = inf;
        cmx[q] = -inf;
    }
    int* queue = queues + (MT > 0 ? warp * RQ_CAP : 0);
    // U batches of 32 queued rows a round: the docids, then every
    // channel's present and fval, then the sums in queue order
    auto drain = [&](int n) {
        for (int i0 = 0; i0 < n; i0 += 32 * U) {
            int row[U], d[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u * 32 + lane;
                row[u] = i < n ? queue[i] : -1;
                d[u] = row[u] >= 0 ? __ldg(ids + base + row[u]) : 0;
            }
            unsigned char pr[U][W];
            float v[U][W];
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int q = 0; q < W; ++q) {
                    pr[u][q] = 0;
                    v[u][q] = 0.0f;
                    if (q < M && row[u] >= 0) {
                        const long long nr = cols.n[q];
                        const long long dd = d[u] < nr - 1 ? d[u] : nr - 1;
                        pr[u][q] = __ldg(cols.p[q] + dd);
                        v[u][q] = __ldg(cols.f[q] + dd);
                    }
                }
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int q = 0; q < W; ++q)
                    if (pr[u][q]) {
                        const float x = v[u][q];
                        cn[q] += 1.0f;
                        cs[q] += x;
                        cs2[q] += x * x;
                        cmn[q] = fminf(cmn[q], x);
                        cmx[q] = fmaxf(cmx[q], x);
                    }
        }
    };
    long long q0, q1;
    row_share(R, b, g, G, q0, q1);
    int cnt = warp_row_queue<AM_WARPS, (MT > 0)>(
        elig, base, base + R, q0, q1, gpw, warp, lane,
        wrq_first(elig, base, base + R, q0, q1, gpw, warp, lane), queue,
        [](long long, unsigned) {}, drain);
    // lanes (xor tree), then warps in order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
#pragma unroll
        for (int q = 0; q < MT; ++q) {
            cn[q] += __shfl_xor_sync(0xffffffffu, cn[q], o);
            cs[q] += __shfl_xor_sync(0xffffffffu, cs[q], o);
            cs2[q] += __shfl_xor_sync(0xffffffffu, cs2[q], o);
            cmn[q] = fminf(cmn[q], __shfl_xor_sync(0xffffffffu, cmn[q], o));
            cmx[q] = fmaxf(cmx[q], __shfl_xor_sync(0xffffffffu, cmx[q], o));
        }
    }
    if (lane == 0) {
        cred[warp] = cnt;
#pragma unroll
        for (int q = 0; q < MT; ++q) {
            red[warp][q * 5 + 0] = cn[q];
            red[warp][q * 5 + 1] = cs[q];
            red[warp][q * 5 + 2] = cs2[q];
            red[warp][q * 5 + 3] = cmn[q];
            red[warp][q * 5 + 4] = cmx[q];
        }
    }
    __syncthreads();
    // thread i < 5 M: stat i % 5 of channel i / 5; the last thread the count
    const bool stat = t < M * 5, counter = t == AM_THREADS - 1;
    const int st = t % 5;
    float a = 0.0f;
    int c = 0;
    if (stat) {
        a = red[0][t];
        for (int w = 1; w < AM_WARPS; ++w) {
            const float x = red[w][t];
            a = st < 3 ? a + x : (st == 3 ? fminf(a, x) : fmaxf(a, x));
        }
    } else if (counter) {
        for (int w = 0; w < AM_WARPS; ++w) c += cred[w];
    }
    // out: [5][M][B]
    if (G == 1) {
        if (stat) out[((long long)st * M + t / 5) * B + b] = a;
        if (counter) count[b] = c;
        return;
    }
    const long long pb = (long long)b * G + g;
    if (stat) part[pb * M * 5 + t] = a;
    if (counter) cpart[pb] = c;
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&ctr[b], 1) == G - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // warp w folds outputs w, w + 8, ... (5 M statistics, then the count)
    for (int e = warp; e <= M * 5; e += AM_WARPS) {
        if (e < M * 5) {
            const float v = fold_blocks(part + (long long)b * G * M * 5 + e,
                                        M * 5, G, e % 5 < 3 ? 0 : e % 5 - 2,
                                        32, lane);
            if (lane == 0) out[((long long)(e % 5) * M + e / 5) * B + b] = v;
        } else {
            const int v = fold_counts(cpart + (long long)b * G, 1, G, 32,
                                      lane);
            if (lane == 0) {
                count[b] = v;
                ctr[b] = 0;
            }
        }
    }
}

// cols: int64 [M][3] in host memory = (fval pointer, present pointer,
// rows); part f32[B*G*M*5] and cpart i32[B*G] the wrapper's scratch (read
// only where G > 1); ctr i32[>= B] zeros, left zeros; count i32[B], out
// f32[5][M][B].
extern "C" int xt_agg_metrics(const void* ids, const void* elig, int B,
                              long long R, int G, int gpw, int M,
                              const long long* cols, void* part, void* cpart,
                              void* ctr, void* count, void* out,
                              void* stream) {
    if (B == 0) return 0;
    if (M < 0 || M > AM_MAXM || G < 1 || gpw < 1 || gpw > 32 ||
        (G > 1 && ctr == nullptr))
        return (int)cudaErrorInvalidValue;
    MetricCols mc;
    for (int q = 0; q < AM_MAXM; ++q) {
        mc.f[q] = q < M ? (const float*)cols[q * 3] : nullptr;
        mc.p[q] = q < M ? (const unsigned char*)cols[q * 3 + 1] : nullptr;
        mc.n[q] = q < M ? cols[q * 3 + 2] : 1;
    }
    using Kernel = void (*)(const int*, const unsigned char*, long long, int,
                           int, int, const MetricCols, float*, int*, int*,
                           int*, float*);
    // the channel width MT of the kernel: M rounded up to 0, 1, 2, 4, 8
    static const Kernel kernels[AM_MAXM + 1] = {
        agg_metrics_kernel<0>, agg_metrics_kernel<1>, agg_metrics_kernel<2>,
        agg_metrics_kernel<4>, agg_metrics_kernel<4>, agg_metrics_kernel<8>,
        agg_metrics_kernel<8>, agg_metrics_kernel<8>, agg_metrics_kernel<8>};
    const Kernel k = kernels[M];
    k<<<dim3(G, B), AM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const unsigned char*)elig, R, G, gpw, M, mc,
        (float*)part, (int*)cpart, (int*)ctr, (int*)count, (float*)out);
    return (int)cudaGetLastError();
}
