// geo_leaves: the exact HTM range test of each geo leaf, one verdict bit a
// leaf per row.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _gather_geo_leaves 367-399
// (K16), with the two rank_count sort-joins inside it (227-246, K15).
//
// A row is live when base[i] is set (owner & not deleted), or, without
// base (packed rows after compact_rows), when its docid is not SENTINEL; a
// row that is not live gets 0, and the tree (filter_leaves.cu) never reads
// it. For a live row and each geo leaf g the thread reads its doc's span
// of level-13 HTM ranges (doc_off, doc_len, at min(docid, nd1 - 1), as
// JAX's jnp.minimum(docids, nd1 - 1): a SENTINEL row reads the pad doc,
// whose span is empty), takes the first min(doc_len, RMAX) ranges (the
// static RMAX of the plan: a doc with more ranges is tested on its first
// RMAX only, as JAX's [C, RMAX] gather is; each range index clamps to
// GR - 1), and sets bit g iff one range [rs, re] satisfies
// #(qs <= re) > #(qe < rs) over the query's cover, whose ranges are
// sorted, merged and disjoint (htm.cover) and padded with INT32_MAX rows,
// which neither count ever counts.
//
// The TPU counted with two streaming sort-joins because its gathers
// serialise; here each count is a binary search over the cover:
// upper_bound_i32 over the range starts, lower_bound_i32 over the range
// ends (common.cuh), the first hit ends the doc's scan.
//
// One block per (query, tile of 256 rows); the block loops over the geo
// leaves, staging each leaf's cover for its query in shared memory (QR <=
// 1024 starts and ends, 8 KB) for every thread's searches. A block with no
// live row writes zeros and returns.
//
// Column table, int64 per geo leaf: doc_off, doc_len, flat_start,
// flat_end (device pointers), nd1 (doc_off rows), GR (flat rows), QR,
// RMAX, the cover (device pointer to i32[B, QR, 2]).
//
// Bound on the H100: latency. Per live row the bytes are few (its span,
// 8 bytes, and 8 bytes a range) and the cover is read from shared memory,
// but each range is two dependent 10-step searches and each row a
// dependent chain of three loads; one row a thread keeps the loads of 256
// rows in flight per block. A warp-cooperative search and a TMA-staged
// cover are later work.
#include "common.cuh"

#define GL_COLS 9
#define GL_THREADS 256

__global__ void geo_leaves_kernel(const int* __restrict__ docids,
                                  const unsigned char* __restrict__ base,
                                  const long long* __restrict__ cols, int C,
                                  int G, int qr_max,
                                  int* __restrict__ geobits) {
    extern __shared__ int cover[];   // qs[qr_max], then qe[qr_max]
    int* qs = cover;
    int* qe = cover + qr_max;
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    const long long i = (long long)b * C + r;
    int d = 0;
    bool live = false;
    if (r < C) {
        d = docids[i];
        live = base ? base[i] != 0 : d != XT_SENTINEL;
    }
    if (!__syncthreads_or(live)) {
        if (r < C) geobits[i] = 0;
        return;
    }
    unsigned bits = 0;
    for (int g = 0; g < G; ++g) {
        const long long* c = cols + g * GL_COLS;
        const int QR = (int)c[6];
        const int* q = (const int*)c[8] + (long long)b * QR * 2;
        __syncthreads();   // every thread is done with the last cover
        for (int j = threadIdx.x; j < QR; j += blockDim.x) {
            qs[j] = q[2 * j];
            qe[j] = q[2 * j + 1];
        }
        __syncthreads();
        if (!live) continue;
        const long long nd1 = c[4], GR = c[5];
        const int RMAX = (int)c[7];
        const long long dd = (long long)d < nd1 - 1 ? (long long)d : nd1 - 1;
        const long long off = ((const int*)c[0])[dd];
        const int cnt = ((const int*)c[1])[dd];
        const int n = cnt < RMAX ? cnt : RMAX;
        const int* fs = (const int*)c[2];
        const int* fe = (const int*)c[3];
        for (int j = 0; j < n; ++j) {
            const long long ri = off + j < GR - 1 ? off + j : GR - 1;
            const int rs = fs[ri], re = fe[ri];
            if (upper_bound_i32(qs, QR, re) > lower_bound_i32(qe, QR, rs)) {
                bits |= 1u << g;
                break;
            }
        }
    }
    if (r < C) geobits[i] = (int)bits;
}

extern "C" int xt_geo_leaves(const void* docids, const void* base,
                             const void* cols, int B, int C, int G,
                             int qr_max, void* geobits, void* stream) {
    if (B == 0 || C == 0) return 0;
    dim3 grid((C + GL_THREADS - 1) / GL_THREADS, B);
    geo_leaves_kernel<<<grid, GL_THREADS, 2 * qr_max * sizeof(int),
                        (cudaStream_t)stream>>>(
        (const int*)docids, (const unsigned char*)base,
        (const long long*)cols, C, G, qr_max, (int*)geobits);
    return (int)cudaGetLastError();
}
