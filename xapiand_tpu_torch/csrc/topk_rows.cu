// topk_rows: exact top-k of the owner rows by (score desc, docid asc).
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _rank_and_topk relevance
// branch 470-486 (lax.top_k over docid-sorted rows), and the top-(K+1)
// of _prefix_topk 958-959.
//
// The rows come out of merge_docs grouped by term, not sorted by docid, so
// a tie cannot be broken by row index. Each row is packed into one 64-bit
// key that orders exactly as (score desc, docid asc): the high word is the
// float's bits made monotone, the low word the complemented docid. Owner
// docids are unique within a query, so keys are unique and the top-k is
// one fixed answer whatever the order of the rows.
//
// Grid (B): one block of 256 threads per query. Each thread keeps a
// sorted list of its best k keys over a strided share of the rows; then k
// rounds of a block-wide max over the list heads pop the winners in
// order. Slots beyond the owner count get SENTINEL / -inf.
//
// Bound on the H100: reading 9 bytes per row once (scores, docids, owner
// flag); the inserts are rare once a thread's list is full. One block per
// query leaves SMs idle when B < 132 - a two-pass split over row tiles is
// later work.
#include "common.cuh"

__device__ __forceinline__ unsigned long long make_key(float s, int d) {
    unsigned int u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32) | (unsigned long long)(~(unsigned)d);
}

template <int KMAX>
__global__ void topk_rows_kernel(const float* __restrict__ scores,
                                 const int* __restrict__ ids,
                                 const unsigned char* __restrict__ owner,
                                 int R, int k, int* __restrict__ out_d,
                                 float* __restrict__ out_s) {
    __shared__ unsigned long long warp_best[32];
    const int b = blockIdx.x;
    const long long base = (long long)b * R;
    unsigned long long top[KMAX];
    int n = 0;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
        if (!owner[base + r]) continue;
        const unsigned long long key = make_key(scores[base + r], ids[base + r]);
        if (n == k && key <= top[k - 1]) continue;
        int i = n < k ? n++ : k - 1;
        while (i > 0 && top[i - 1] < key) {
            top[i] = top[i - 1];
            --i;
        }
        top[i] = key;
    }
    int head = 0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int j = 0; j < k; ++j) {
        const unsigned long long mine = head < n ? top[head] : 0ull;
        unsigned long long m = mine;
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long x = __shfl_xor_sync(0xffffffffu, m, o);
            m = x > m ? x : m;
        }
        if (lane == 0) warp_best[warp] = m;
        __syncthreads();
        m = 0ull;
        for (int q = 0; q < nwarps; ++q) m = warp_best[q] > m ? warp_best[q] : m;
        __syncthreads();
        if (m != 0ull && mine == m) ++head;   // keys are unique
        if (threadIdx.x == 0) {
            if (m == 0ull) {
                out_d[b * k + j] = XT_SENTINEL;
                out_s[b * k + j] = __int_as_float(0xff800000);   // -inf
            } else {
                const unsigned int hi = (unsigned int)(m >> 32);
                const unsigned int bits =
                    (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
                out_d[b * k + j] = (int)(~(unsigned int)(m & 0xffffffffu));
                out_s[b * k + j] = __uint_as_float(bits);
            }
        }
    }
}

extern "C" int xt_topk_rows(const void* scores, const void* ids,
                            const void* owner, int B, int R, int k,
                            void* out_d, void* out_s, void* stream) {
    if (B == 0 || k == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (k <= 64)
        topk_rows_kernel<64><<<B, 256, 0, st>>>(
            (const float*)scores, (const int*)ids,
            (const unsigned char*)owner, R, k, (int*)out_d, (float*)out_s);
    else
        topk_rows_kernel<256><<<B, 256, 0, st>>>(
            (const float*)scores, (const int*)ids,
            (const unsigned char*)owner, R, k, (int*)out_d, (float*)out_s);
    return (int)cudaGetLastError();
}
