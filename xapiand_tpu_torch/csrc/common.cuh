// Shared definitions of the port's kernels.
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
#define XT_I32MAX 2147483647

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

// K6: the static boolean tree (xapiand_tpu/ops/executor.py _eval_tree
// 249-282) compiled on the host into a postfix program of int32
// instructions, op | arg << 8 (ops/kernels.py tree_program). It runs per
// row on a stack of bits held in one register (depth <= 32, checked on the
// host): G pushes bit `arg` of the row's OR of group bits, F bit `arg` of
// the row's filter results.
#define XT_OP_G 0
#define XT_OP_F 1
#define XT_OP_ALL 2
#define XT_OP_NONE 3
#define XT_OP_AND 4
#define XT_OP_OR 5
#define XT_OP_XOR 6
#define XT_OP_ANDNOT 7

__device__ __forceinline__ int eval_tree(const int* __restrict__ prog, int n,
                                         unsigned orbits, unsigned fbits) {
    unsigned st = 0;
    for (int i = 0; i < n; ++i) {
        const int ins = __ldg(prog + i);
        const int op = ins & 0xff, arg = ins >> 8;
        if (op == XT_OP_G) {
            st = (st << 1) | ((orbits >> arg) & 1u);
        } else if (op == XT_OP_F) {
            st = (st << 1) | ((fbits >> arg) & 1u);
        } else if (op == XT_OP_ALL) {
            st = (st << 1) | 1u;
        } else if (op == XT_OP_NONE) {
            st = st << 1;
        } else {
            const unsigned b = st & 1u, a = (st >> 1) & 1u;
            unsigned r;
            if (op == XT_OP_AND) r = a & b;
            else if (op == XT_OP_OR) r = a | b;
            else if (op == XT_OP_XOR) r = a ^ b;
            else r = a & (b ^ 1u);
            st = ((st >> 2) << 1) | r;
        }
    }
    return (int)(st & 1u);
}

// (ah, al) >= (bh, bl) and <=, lexicographic on signed int32 pairs
// (executor.py _lex_ge / _lex_le 144-150). split_key XORs the sign bit of
// both words, so this order is the order of the u64 sortable keys.
__device__ __forceinline__ bool lex_ge(int ah, int al, int bh, int bl) {
    return ah > bh || (ah == bh && al >= bl);
}

__device__ __forceinline__ bool lex_le(int ah, int al, int bh, int bl) {
    return ah < bh || (ah == bh && al <= bl);
}
