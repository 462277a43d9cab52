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
// nbins - 1) (float32, JAX's operation order), of every bucket it is in:
//   mode 0  one bucket (the top level)
//   mode 1  bucket codes[b, r] when >= 0 (agg_buckets.cu's codes_out: a
//           row is in at most one bucket)
//   mode 2  every bucket j with member[b, r, j] (agg_ranges.cu's member
//           matrix: geo_ip's buckets may overlap)
// The counts are integers (int atomics, exact whatever their order) and
// are returned as float32, as JAX returns them.
//
// Grid (G, B), 256 threads, one row a thread at a time. Mode 0 counts in a
// shared-memory histogram of nbins ints (8 KB at 2048 bins) added into the
// output with int atomics; modes 1 and 2 add into the output [B][nb][nbins]
// (up to 4096 x 2048 ints a query) directly. A second kernel converts to
// float32.
//
// Bound on the H100: one byte of eligible flags a row, two gathers
// (present, fval) per eligible row and one int atomic per (row, bucket);
// the output, [nb x nbins] ints a query, zeroed, written and converted.
#include "common.cuh"

#define AH_THREADS 256
#define AH_MAXBINS 2048

__device__ __forceinline__ int value_bin(float v, float lo, float scale,
                                         int nbins) {
    const float f = floorf((v - lo) * scale);
    if (!(f > 0.0f)) return 0;
    if (f > (float)(nbins - 1)) return nbins - 1;
    return (int)f;
}

__global__ void __launch_bounds__(AH_THREADS) agg_hist_count(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, int G, const float* __restrict__ fval,
    const unsigned char* __restrict__ present, long long n,
    const float* __restrict__ params, int mode,
    const int* __restrict__ codes, const unsigned char* __restrict__ member,
    int nb, int nbins, int* __restrict__ out) {
    __shared__ int hist[AH_MAXBINS];
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const long long base = (long long)b * R;
    const long long r0 = R * g / G, r1 = R * (g + 1) / G;
    const float lo = params[2 * b], scale = params[2 * b + 1];
    int* ob = out + (long long)b * nb * nbins;
    if (mode == 0) {
        for (int c = t; c < nbins; c += AH_THREADS) hist[c] = 0;
        __syncthreads();
    }
    for (long long r = r0 + t; r < r1; r += AH_THREADS) {
        if (!elig[base + r]) continue;
        const long long d = ids[base + r];
        const long long dd = d < n - 1 ? d : n - 1;
        if (!present[dd]) continue;
        const int bin = value_bin(fval[dd], lo, scale, nbins);
        if (mode == 0) {
            atomicAdd(&hist[bin], 1);
        } else if (mode == 1) {
            const int c = codes[base + r];
            if (c >= 0 && c < nb) atomicAdd(&ob[(long long)c * nbins + bin], 1);
        } else {
            const unsigned char* m = member + (base + r) * nb;
            for (int c = 0; c < nb; ++c)
                if (m[c]) atomicAdd(&ob[(long long)c * nbins + bin], 1);
        }
    }
    if (mode == 0) {
        __syncthreads();
        for (int c = t; c < nbins; c += AH_THREADS)
            if (hist[c]) atomicAdd(&ob[c], hist[c]);
    }
}

__global__ void agg_hist_float(long long total, const int* __restrict__ in,
                               float* __restrict__ out) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x)
        out[i] = (float)in[i];
}

// params f32[B][2] = (lo, scale); counts i32[B][nb][nbins] zeroed by the
// wrapper; out f32[B][nb][nbins].
extern "C" int xt_agg_hist(const void* ids, const void* elig, int B,
                           long long R, int G, const void* fval,
                           const void* present, long long n,
                           const void* params, int mode, const void* codes,
                           const void* member, int nb, int nbins,
                           void* counts, void* out, void* stream) {
    if (B == 0) return 0;
    if (G < 1 || nb < 1 || nbins < 1 || nbins > AH_MAXBINS || mode < 0 ||
        mode > 2 || (mode == 0 && nb != 1) ||
        (mode == 1 && codes == nullptr) || (mode == 2 && member == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    agg_hist_count<<<dim3(G, B), AH_THREADS, 0, st>>>(
        (const int*)ids, (const unsigned char*)elig, R, G,
        (const float*)fval, (const unsigned char*)present, n,
        (const float*)params, mode, (const int*)codes,
        (const unsigned char*)member, nb, nbins, (int*)counts);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    const long long total = (long long)B * nb * nbins;
    long long blocks = (total + 255) / 256;
    if (blocks > 65535) blocks = 65535;
    agg_hist_float<<<(int)blocks, 256, 0, st>>>(total, (const int*)counts,
                                                (float*)out);
    return (int)cudaGetLastError();
}
