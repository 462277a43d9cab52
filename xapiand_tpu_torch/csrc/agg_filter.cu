// agg_filter: the rows of a _filter bucket - each eligible row whose docid
// is in the postings of every one of the filter's terms.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py compute_aggs (K17c), the filter
// branch 199-215: per term a window of Lf postings (lax.dynamic_slice of
// post_docids at the span's offset, its entries past the span's length
// read as INT32_MAX), the branchless lower_bound of executor.py:192 over
// the window, and a hit where the entry found is the docid; the bucket is
// the AND of the hits, and a term of empty span matches nothing. The
// bucket's count and subs are agg_buckets.cu's one-bucket mask mode, fed
// by the mask this kernel writes.
//
// dynamic_slice clamps its start so that the window fits the array:
// start = min(offset, P - Lf). Where that moves the window (a span near
// the end of the postings whose Lf exceeds the guard pad), JAX reads the
// wrong postings; the kernel reads the same window with the same search,
// so it gives JAX's answer there too.
//
// Grid over the B x R rows, 256 threads, one row a thread: per term
// log2(Lf) probes of the window.
//
// Bound on the H100: one byte of eligible flags and one docid a row read,
// one flag written; per eligible row and term log2(Lf) dependent 4-byte
// gathers in the term's posting span (L2-resident at a filter's widths).
#include "common.cuh"

#define AF_THREADS 256

// the leftmost i in [0, L) with a[i] >= x, JAX's lower_bound (bit by bit
// from the top) over the window post[start, start + L), whose entries
// past len read as INT32_MAX
__device__ __forceinline__ int window_lower_bound(const int* post,
                                                  long long start, int len,
                                                  int L, int bits, int x) {
    int pos = 0;
    for (int sbit = bits - 1; sbit >= 0; --sbit) {
        const int cand = pos + (1 << sbit);
        int i = cand - 1 < L - 1 ? cand - 1 : L - 1;
        const int probe = i < len ? post[start + i] : 0x7fffffff;
        if (cand <= L && probe < x) pos = cand;
    }
    return pos;
}

__global__ void __launch_bounds__(AF_THREADS) agg_filter_rows(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long BR, long long R, const int* __restrict__ post, long long P,
    const int* __restrict__ spans, int nt, int L, int bits,
    unsigned char* __restrict__ mask) {
    const long long i = blockIdx.x * (long long)AF_THREADS + threadIdx.x;
    if (i >= BR) return;
    bool m = elig[i] != 0;
    if (m) {
        const int b = (int)(i / R);
        const int d = ids[i];
        const int* sp = spans + (long long)b * nt * 2;
        for (int t = 0; t < nt && m; ++t) {
            const long long off = sp[2 * t];
            const int len = sp[2 * t + 1];
            long long start = off < P - L ? off : P - L;
            if (start < 0) start = 0;
            const int pos = window_lower_bound(post, start, len, L, bits, d);
            const int at = pos < L - 1 ? pos : L - 1;
            const int got = at < len ? post[start + at] : 0x7fffffff;
            m = got == d && len > 0;
        }
    }
    mask[i] = m;
}

// spans i32[B][nt][2] = (offset, length); mask u8[B][R] out
extern "C" int xt_agg_filter(const void* ids, const void* elig, int B,
                             long long R, const void* post, long long P,
                             const void* spans, int nt, int L, void* mask,
                             void* stream) {
    const long long BR = (long long)B * R;
    if (BR == 0) return 0;
    if (nt < 1 || L < 1 || P < L) return (int)cudaErrorInvalidValue;
    int bits = 0;                     // max((L - 1).bit_length(), 1)
    for (int x = L - 1; x; x >>= 1) ++bits;
    if (bits < 1) bits = 1;
    cudaStream_t st = (cudaStream_t)stream;
    const long long blocks = (BR + AF_THREADS - 1) / AF_THREADS;
    agg_filter_rows<<<(unsigned)blocks, AF_THREADS, 0, st>>>(
        (const int*)ids, (const unsigned char*)elig, BR, R, (const int*)post,
        P, (const int*)spans, nt, L, bits, (unsigned char*)mask);
    return (int)cudaGetLastError();
}
