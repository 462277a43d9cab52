// agg_hist: fixed-grid order-statistic histograms, per query and bucket.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py (K17c) _value_hist 52-59 - the
// top-level median / mode (262-274) and percentiles (490-500) histogram,
// one-hot rows summed over the row axis - and the "hist2" of a median /
// mode sub-aggregation in _sub_stats_bucketed 141-153, the einsum
// "rb,rk->bk" of the bucket membership by the value's one-hot bin: a
// product inside the TPU kernel's body, written here as a count.
//
// A row r of query b, d = min(ids[b, r], n - 1), counts when eligible[b,
// r] and present[d], in bin clip(floor((fval[d] - lo) * scale), 0,
// nbins - 1) (float32, JAX's operation order; a NaN value in bin 0), of
// every bucket it is in:
//   mode 0  one bucket (the top level)
//   mode 1  bucket codes[b, r] when in [0, nb) (agg_buckets.cu's
//           codes_out: a row is in at most one bucket)
//   mode 2  every bucket j with member[b, r, j] (agg_ranges.cu's member
//           matrix: geo_ip's buckets may overlap)
// The counts are integers, exact whatever the order of their atomics, and
// are returned as float32, as JAX returns them.
//
// One launch a call, grid (G, B), 256 threads. G and gpw come from
// kernels.row_plan (at kernels.HIST_FILL or HIST2_FILL: the Database
// path's launches are B 1, a chain of dependent steps more than a matter
// of rows). The rows of block g are walked by common.cuh warp_row_queue:
// a lane a 16-row group's flags a step (one 16-byte load), the eligible
// rows queued in row order a warp and drained 32 at a time, a row a lane,
// AH_U batches in flight (a lane issues its rows' docid gathers, then
// their present, fval and code gathers together).
//   mode 0     a shared-memory histogram of nbins ints (8 KB at 2,048
//              bins), an int atomic a row; one block (G 1) writes the
//              float32 output from it; else each block adds its nonzero
//              bins by int atomics into a scratch of nbins ints a query
//              that stays zero between calls (the wrapper's, kept as
//              kernels._tickets keeps its counters), takes a ticket on a
//              counter a query (after __threadfence), and the last block
//              writes the output from the scratch and zeroes it and the
//              counter back. No memset, no second kernel.
//   modes 1-2  up to 4,096 x 2,048 counters a query (hist2: 144 x 2,048
//              on the Database path, 1.18 MB), past shared memory:
//              int atomics into the zero-kept scratch [B][nb][nbins], a
//              cooperative launch (every block resident), a grid barrier,
//              then every block converts its share of the scratch to the
//              float32 output and zeroes it; or (flout) float atomics of
//              1.0 into the output the wrapper zeroed, exact and
//              independent of order while every count stays below 2^24,
//              which the wrapper makes sure of (R < 2^24).
//
// Bound on the H100: one byte of eligible flags a row, the docid and two
// gathers (present, fval) per eligible row, its code or member bytes, one
// int atomic per (row, bucket); the output, [nb x nbins] floats a query,
// written.
#include <cooperative_groups.h>

#include "common.cuh"

#define AH_THREADS 256
#define AH_WARPS (AH_THREADS / 32)
#define AH_MAXBINS 2048
#ifndef AH_U
#define AH_U 4                // queued rows a lane in flight
#endif

__device__ __forceinline__ int value_bin(float v, float lo, float scale,
                                         int nbins) {
    const float f = floorf((v - lo) * scale);
    if (!(f > 0.0f)) return 0;
    if (f > (float)(nbins - 1)) return nbins - 1;
    return (int)f;
}

// MODE 0: the top level; 1: codes or member (mode 1 or 2 at run time).
// scr: the zero-kept int scratch (mode 0: nbins a query, read where G > 1;
// modes 1-2: nb x nbins a query, null with flout); ctr: a counter a query
// (mode 0, G > 1); out: f32[B][nb][nbins].
template <int MODE>
__global__ void __launch_bounds__(AH_THREADS) agg_hist_kernel(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, int G, int gpw, const float* __restrict__ fval,
    const unsigned char* __restrict__ present, long long n,
    const float* __restrict__ params, int mode,
    const int* __restrict__ codes, const unsigned char* __restrict__ member,
    int nb, int nbins, int* __restrict__ scr, int* __restrict__ ctr,
    float* __restrict__ out, int flout) {
    __shared__ int queues[AH_WARPS * RQ_CAP];
    __shared__ int hist[MODE == 0 ? AH_MAXBINS : 1];
    __shared__ bool last;
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const long long base = (long long)b * R;
    long long q0, q1;
    row_share(R, b, g, G, q0, q1);
    const uint4 first = wrq_first(elig, base, base + R, q0, q1, gpw, warp,
                                  lane);
    const float lo = params[2 * b], scale = params[2 * b + 1];
    const long long qsize = (long long)nb * nbins;
    if (MODE == 0) {
        for (int c = t; c < nbins; c += AH_THREADS) hist[c] = 0;
        __syncthreads();
    }
    int* queue = queues + warp * RQ_CAP;
    int* sb = MODE == 0 ? nullptr : (scr != nullptr ? scr + b * qsize
                                                    : nullptr);
    float* ob = out + b * qsize;
    auto drain = [&](int cnt) {
        for (int i0 = 0; i0 < cnt; i0 += 32 * AH_U) {
            int row[AH_U], d[AH_U];
#pragma unroll
            for (int u = 0; u < AH_U; ++u) {
                const int i = i0 + u * 32 + lane;
                row[u] = i < cnt ? queue[i] : -1;
                d[u] = row[u] >= 0 ? __ldg(ids + base + row[u]) : 0;
            }
            unsigned char pr[AH_U];
            float v[AH_U];
            int c[AH_U];
#pragma unroll
            for (int u = 0; u < AH_U; ++u) {
                pr[u] = 0;
                v[u] = 0.0f;
                c[u] = 0;
                if (row[u] >= 0) {
                    const long long dd = d[u] < n - 1 ? d[u] : n - 1;
                    pr[u] = __ldg(present + dd);
                    v[u] = __ldg(fval + dd);
                    if (MODE == 1 && mode == 1)
                        c[u] = __ldg(codes + base + row[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < AH_U; ++u) {
                if (!pr[u]) continue;
                const int bin = value_bin(v[u], lo, scale, nbins);
                if (MODE == 0) {
                    atomicAdd(&hist[bin], 1);
                } else if (mode == 1) {
                    if (c[u] < 0 || c[u] >= nb) continue;
                    const long long o = (long long)c[u] * nbins + bin;
                    if (flout) atomicAdd(ob + o, 1.0f);
                    else atomicAdd(sb + o, 1);
                } else {
                    const unsigned char* m =
                        member + (base + row[u]) * nb;
                    for (int j = 0; j < nb; ++j) {
                        if (!__ldg(m + j)) continue;
                        const long long o = (long long)j * nbins + bin;
                        if (flout) atomicAdd(ob + o, 1.0f);
                        else atomicAdd(sb + o, 1);
                    }
                }
            }
        }
    };
    warp_row_queue<AH_WARPS, true>(elig, base, base + R, q0, q1, gpw, warp,
                                   lane, first, queue,
                                   [](long long, unsigned) {}, drain);
    if constexpr (MODE == 0) {
        __syncthreads();
        if (G == 1) {
            for (int c = t; c < nbins; c += AH_THREADS)
                ob[c] = (float)hist[c];
            return;
        }
        int* sq = scr + (long long)b * nbins;
        for (int c = t; c < nbins; c += AH_THREADS)
            if (hist[c]) atomicAdd(sq + c, hist[c]);
        __threadfence();
        __syncthreads();
        if (t == 0) last = atomicAdd(&ctr[b], 1) == G - 1;
        __syncthreads();
        if (!last) return;
        __threadfence();
        for (int c = t; c < nbins; c += AH_THREADS) {
            ob[c] = (float)__ldcg(sq + c);
            sq[c] = 0;
        }
        if (t == 0) ctr[b] = 0;
    } else if (!flout) {
        // every block's atomics done, then each block converts a share
        cooperative_groups::this_grid().sync();
        const long long total = (long long)gridDim.y * qsize;
        const long long stride = (long long)gridDim.x * gridDim.y *
                                 AH_THREADS;
        for (long long i = ((long long)b * G + g) * AH_THREADS + t;
             i < total; i += stride) {
            out[i] = (float)__ldcg(scr + i);
            scr[i] = 0;
        }
    }
}

// The most blocks of agg_hist_kernel<1> resident at once (the cooperative
// launch's limit), per device.
static int resident_blocks() {
    static int cached[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (cached[dev] == 0) {
        int per_sm = 0, sms = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, agg_hist_kernel<1>, AH_THREADS, 0) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess)
            return 0;
        cached[dev] = per_sm * sms;
    }
    return cached[dev];
}

// params f32[B][2] = (lo, scale); G blocks a query of gpw groups a warp a
// step (kernels.row_plan); scr the zero-kept int scratch, left zero (mode
// 0: B x nbins, read where G > 1; modes 1-2 without flout: B x nb x
// nbins); ctr i32[>= B] zeros, left zeros (mode 0, G > 1); out
// f32[B][nb][nbins], zeroed by the wrapper with flout (modes 1-2: float
// atomics, R < 2^24).
extern "C" int xt_agg_hist(const void* ids, const void* elig, int B,
                           long long R, int G, int gpw, const void* fval,
                           const void* present, long long n,
                           const void* params, int mode, const void* codes,
                           const void* member, int nb, int nbins, void* scr,
                           void* ctr, void* out, int flout, void* stream) {
    if (B == 0) return 0;
    if (G < 1 || gpw < 1 || gpw > 32 || nb < 1 || nbins < 1 ||
        nbins > AH_MAXBINS || mode < 0 || mode > 2 ||
        (mode == 0 && nb != 1) || (mode == 1 && codes == nullptr) ||
        (mode == 2 && member == nullptr) ||
        (mode == 0 && G > 1 && (scr == nullptr || ctr == nullptr)) ||
        (mode > 0 && !flout && scr == nullptr) ||
        (mode > 0 && flout && R >= (1LL << 24)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int* pi = (const int*)ids;
    const unsigned char* pe = (const unsigned char*)elig;
    const float* pf = (const float*)fval;
    const unsigned char* pp = (const unsigned char*)present;
    const float* pa = (const float*)params;
    const int* pc = (const int*)codes;
    const unsigned char* pm = (const unsigned char*)member;
    int* ps = (int*)scr;
    int* pt = (int*)ctr;
    float* po = (float*)out;
    if (mode == 0) {
        agg_hist_kernel<0><<<dim3(G, B), AH_THREADS, 0, st>>>(
            pi, pe, R, G, gpw, pf, pp, n, pa, mode, pc, pm, nb, nbins, ps,
            pt, po, flout);
        return (int)cudaGetLastError();
    }
    if (flout) {
        agg_hist_kernel<1><<<dim3(G, B), AH_THREADS, 0, st>>>(
            pi, pe, R, G, gpw, pf, pp, n, pa, mode, pc, pm, nb, nbins, ps,
            pt, po, flout);
        return (int)cudaGetLastError();
    }
    // cooperative launches of at most the resident blocks, queries in
    // runs of bq (each launch its own grid barrier)
    const int cap = resident_blocks();
    if (cap < 1) return (int)cudaErrorInvalidValue;
    if (G > cap) G = cap;
    const int bq = cap / G;
    const long long qsize = (long long)nb * nbins;
    for (int b0 = 0; b0 < B; b0 += bq) {
        const int nq = B - b0 < bq ? B - b0 : bq;
        const int* qi = pi + (long long)b0 * R;
        const unsigned char* qe = pe + (long long)b0 * R;
        const float* qa = pa + 2LL * b0;
        const int* qc = pc != nullptr ? pc + (long long)b0 * R : nullptr;
        const unsigned char* qm =
            pm != nullptr ? pm + (long long)b0 * R * nb : nullptr;
        int* qs = ps + b0 * qsize;
        float* qo = po + b0 * qsize;
        void* args[] = {&qi, &qe, &R, &G, &gpw, &pf, &pp, &n, &qa, &mode,
                        &qc, &qm, &nb, &nbins, &qs, &pt, &qo, &flout};
        const cudaError_t e = cudaLaunchCooperativeKernel(
            (const void*)agg_hist_kernel<1>, dim3(G, nq), dim3(AH_THREADS),
            args, 0, st);
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
