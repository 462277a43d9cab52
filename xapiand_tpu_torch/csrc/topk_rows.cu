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
// later work. A row whose score is NaN (a non-scoring term under a scheme
// that is NaN at constants of 0, common.cuh scored) is left out, as the
// JAX package's compiled execute ranks it below every other row (held by
// tests/test_torch_schemes.py). The test sits on the insert path, after
// the comparison with the list's last key, which every NaN key passes or
// fails as a whole (a NaN's monotone word is above +inf or below -inf), so
// the rows that do not enter a thread's list - nearly all - pay nothing
// for it (a select in make() cost the tie ranks' B1 R2101376 launch 22% on an H100,
// tools/topk_pairs.py). A returned score that is not finite comes with
// SENTINEL for its docid, as JAX's where(isfinite(vals), ...).
//
// After a collapse (collapse_rows.cu) a tie is broken by the row's tie rank
// first and its docid second, the order lax.top_k finds the collapsed rows
// in: the same kernel over the 96-bit key (score, ~tie, ~docid), held as a
// 64-bit and a 32-bit word. The kernel is a template on the key type; the
// relevance path's instantiation is the one-word key.
#include "common.cuh"

// the score's bits made monotone, in the high word; never 0 for a real row
__device__ __forceinline__ unsigned long long score_word(float s) {
    unsigned int u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (unsigned long long)u << 32;
}

// A key type: make(score, docid, tie rank), a strict order lt, eq, the
// lane exchange shfl, and docid() back out; a zeroed key is "no row".
struct RowKey {   // (score desc, docid asc)
    unsigned long long a;
    __device__ static RowKey make(float s, int d, int) {
        return {score_word(s) | (unsigned long long)(~(unsigned)d)};
    }
    __device__ bool lt(const RowKey& y) const { return a < y.a; }
    __device__ bool eq(const RowKey& y) const { return a == y.a; }
    __device__ RowKey shfl(int o) const {
        return {__shfl_xor_sync(0xffffffffu, a, o)};
    }
    __device__ int docid() const { return (int)(~(unsigned)(a & 0xffffffffu)); }
};

struct TieKey {   // (score desc, tie asc, docid asc)
    unsigned long long a;   // score (monotone) << 32 | ~tie
    unsigned int b;         // ~docid
    __device__ static TieKey make(float s, int d, int tie) {
        return {score_word(s) | (unsigned long long)(~(unsigned)tie),
                ~(unsigned)d};
    }
    __device__ bool lt(const TieKey& y) const {
        return a != y.a ? a < y.a : b < y.b;
    }
    __device__ bool eq(const TieKey& y) const { return a == y.a && b == y.b; }
    __device__ TieKey shfl(int o) const {
        return {__shfl_xor_sync(0xffffffffu, a, o),
                __shfl_xor_sync(0xffffffffu, b, o)};
    }
    __device__ int docid() const { return (int)(~b); }
};

// tie: the rows' tie ranks (read by TieKey only; nullptr for RowKey)
template <class Key, int KMAX>
__global__ void topk_rows_kernel(const float* __restrict__ scores,
                                 const int* __restrict__ ids,
                                 const unsigned char* __restrict__ owner,
                                 const int* __restrict__ tie, int R, int k,
                                 int* __restrict__ out_d,
                                 float* __restrict__ out_s) {
    __shared__ Key warp_best[32];
    const int b = blockIdx.x;
    const long long base = (long long)b * R;
    Key top[KMAX];
    int n = 0;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
        if (!owner[base + r]) continue;
        const float s = scores[base + r];
        const Key key = Key::make(s, ids[base + r], tie ? tie[base + r] : 0);
        if (n == k && !top[k - 1].lt(key)) continue;
        if (isnan(s)) continue;
        int i = n < k ? n++ : k - 1;
        while (i > 0 && top[i - 1].lt(key)) {
            top[i] = top[i - 1];
            --i;
        }
        top[i] = key;
    }
    int head = 0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    const Key none = {};
    for (int j = 0; j < k; ++j) {
        const Key mine = head < n ? top[head] : none;
        Key m = mine;
        for (int o = 16; o > 0; o >>= 1) {
            const Key x = m.shfl(o);
            if (m.lt(x)) m = x;
        }
        if (lane == 0) warp_best[warp] = m;
        __syncthreads();
        m = none;
        for (int q = 0; q < nwarps; ++q)
            if (m.lt(warp_best[q])) m = warp_best[q];
        __syncthreads();
        // a real key's high word is never 0; owner docids are unique, so
        // no two rows share a key
        const bool any = m.a != 0ull;
        if (any && mine.eq(m)) ++head;
        if (threadIdx.x == 0) {
            if (!any) {
                out_d[b * k + j] = XT_SENTINEL;
                out_s[b * k + j] = __int_as_float(0xff800000);   // -inf
            } else {
                const unsigned int hi = (unsigned int)(m.a >> 32);
                const unsigned int bits =
                    (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
                const float s = __uint_as_float(bits);
                // a score that is not finite reports no docid, as JAX's
                // where(isfinite(vals), docids[idx], SENTINEL)
                out_d[b * k + j] = isfinite(s) ? m.docid() : XT_SENTINEL;
                out_s[b * k + j] = s;
            }
        }
    }
}

template <class Key>
static int launch_topk(const void* scores, const void* ids, const void* owner,
                       const void* tie, int B, int R, int k, void* out_d,
                       void* out_s, void* stream) {
    if (B == 0 || k == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (k <= 64)
        topk_rows_kernel<Key, 64><<<B, 256, 0, st>>>(
            (const float*)scores, (const int*)ids,
            (const unsigned char*)owner, (const int*)tie, R, k, (int*)out_d,
            (float*)out_s);
    else
        topk_rows_kernel<Key, 256><<<B, 256, 0, st>>>(
            (const float*)scores, (const int*)ids,
            (const unsigned char*)owner, (const int*)tie, R, k, (int*)out_d,
            (float*)out_s);
    return (int)cudaGetLastError();
}

extern "C" int xt_topk_rows_tie(const void* scores, const void* ids,
                                const void* owner, const void* tie, int B,
                                int R, int k, void* out_d, void* out_s,
                                void* stream) {
    return launch_topk<TieKey>(scores, ids, owner, tie, B, R, k, out_d, out_s,
                               stream);
}

extern "C" int xt_topk_rows(const void* scores, const void* ids,
                            const void* owner, int B, int R, int k,
                            void* out_d, void* out_s, void* stream) {
    return launch_topk<RowKey>(scores, ids, owner, nullptr, B, R, k, out_d,
                               out_s, stream);
}
