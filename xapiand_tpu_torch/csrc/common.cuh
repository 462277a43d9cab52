// Shared definitions of the slice-1 kernels (BM25 top-k batch search).
//
// Built with nvcc for sm_90a into one shared library with a plain C
// interface (ops/kernels.py loads it with ctypes). Every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// The library is compiled with -fmad=false: every float expression below
// rounds after each operation, in the order the JAX package and the plain
// PyTorch versions evaluate it, so kernel and plain results agree bit for
// bit wherever the summation order is the same.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define XT_SENTINEL 2147483647

// BM25 per-posting weight (bm25weight.cc:171-181; xapiand_tpu/models/
// weights.py BM25.sumpart): tconst * wdf / max(k1*(max(dl*lf, mnl)*b +
// (1-b)) + wdf, 1e-9).
struct Bm25Params {
    float lf, k1, b, one_minus_b, min_normlen;
};

__device__ __forceinline__ float bm25_sumpart(float wdf, float doclen,
                                              float tconst,
                                              const Bm25Params& p) {
    float normlen = fmaxf(doclen * p.lf, p.min_normlen);
    float denom = p.k1 * (normlen * p.b + p.one_minus_b) + wdf;
    return tconst * (wdf / fmaxf(denom, 1e-9f));
}

// leftmost i in [0, n) with a[i] >= x (a ascending)
__device__ __forceinline__ int lower_bound_i32(const int* a, int n, int x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}
