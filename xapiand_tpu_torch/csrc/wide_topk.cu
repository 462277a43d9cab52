// wide_topk: the top-k of topk_rows and sort_topk for any k, and for sort
// keys of any number of words - the wide mode the two kernels hand off to
// when k exceeds their per-thread lists (64 / 256 keys) or a sort key
// exceeds 8 words.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _rank_and_topk 470-575 at
// widths the per-thread lists cannot hold: lax.top_k and lax.sort take any
// k, so the JAX package answers a page of any width (a relevance page with
// _limit 250 and _aggs, a sorted page of 65, four sort keys, a collapse on
// an 8-shard mesh that runs each shard at k x 8).
//
// Select, then sort. Each candidate row's key is a list of 32-bit words
// whose unsigned order is the answer's order, smallest first:
//   topk_rows  (~monotone(score), [tie rank,] docid): score desc, then the
//              tie rank, then docid asc; the owner rows whose score is not
//              NaN are the candidates (topk_rows.cu's rules);
//   sort_topk  row_key's words (common.cuh): the sort keys, the masked
//              docid, the row index; every row is a candidate.
// Keys are unique (owner docids are unique in a query; the row index is),
// so exactly k candidates are at or before the k-th key. A block per query
// finds that key by radix passes, 8 bits a pass, most significant word
// first: a 256-bin shared histogram of the candidates that match the
// digits fixed so far, then the bin where the running count reaches k. A
// bin that holds exactly the count still wanted ends the search early (its
// remaining digits are all ones). The block then gathers the rows at or
// before that key (an atomic slot each) and bitonic-sorts them: in shared
// memory when the k keys fit, else in a device-memory scratch the wrapper
// gives (a block's global writes are visible to its threads after
// __syncthreads). A sort key of more than WT_MAXW words (15 value keys and
// more: lax.sort takes any number) does not fit a thread's registers: the
// block first writes each row's words once to a device-memory table the
// wrapper gives, and the passes, the gather and the sort read them there;
// the fixed digits then live in device memory too.
//
// Bound on the H100: reading each row once (9-13 bytes for topk_rows, the
// key's columns for sort_topk); the passes re-read the rows up to 4 x the
// key words times and the gathers dominate - simple and exact, for a path
// the REST surface reaches with wide pages. One block per query.
#include "common.cuh"

#define WT_THREADS 1024
#define WT_MAXW 32   // key words

struct RowSrc {   // topk_rows' rows
    static constexpr bool SORT = false;
    const float* scores;
    const int* ids;
    const unsigned char* owner;
    const int* tie;
    int nw;
    unsigned* table = nullptr;
    __device__ const unsigned* key(long long base, int r, int,
                                   unsigned* w) const {
        if (!owner[base + r]) return nullptr;
        const float s = scores[base + r];
        if (isnan(s)) return nullptr;
        unsigned u = __float_as_uint(s);
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        w[0] = ~u;
        int p = 1;
        if (tie != nullptr) w[p++] = (unsigned)tie[base + r];
        w[p] = (unsigned)ids[base + r];
        return w;
    }
    __device__ void fill(long long, int, int) const {}
};

struct SortSrc {   // sort_topk's rows
    static constexpr bool SORT = true;
    const int* ids;
    const float* sums;
    const unsigned char* elig;
    int S;
    const int* spec;
    const long long* cols;
    const float* targets;
    int nw;
    unsigned* table;   // [B, R, nw] past WT_MAXW words, else null
    __device__ const unsigned* key(long long base, int r, int b,
                                   unsigned* w) const {
        if (table != nullptr) return table + (base + r) * nw;
        row_key<WT_MAXW>(r, base, b, ids, sums, elig, S, spec, cols, targets,
                         w);
        return w;
    }
    __device__ void fill(long long base, int R, int b) const {
        for (int r = threadIdx.x; r < R; r += WT_THREADS)
            row_key<WT_MAXW>(r, base, b, ids, sums, elig, S, spec, cols,
                             targets, table + (base + r) * nw);
    }
};

__device__ __forceinline__ bool words_lt(const unsigned* a, const unsigned* b,
                                         int nw) {
    for (int i = 0; i < nw; ++i)
        if (a[i] != b[i]) return a[i] < b[i];
    return false;
}

// topk_rows: out_d / out_s from the key words; sort_topk: from the row
// index (the last word), and the sort key words to out_k. thr_g: the
// fixed digits of each block (nw words a query) when the keys live in
// src.table.
template <class Src>
__global__ void __launch_bounds__(WT_THREADS) wide_topk_kernel(
    Src src, int R, int k, int P, unsigned* __restrict__ scratch,
    int* __restrict__ out_d, float* __restrict__ out_s,
    unsigned* __restrict__ out_k, int nu, unsigned* __restrict__ thr_g) {
    extern __shared__ unsigned dyn[];
    __shared__ unsigned hist[256];
    __shared__ unsigned thr_s[WT_MAXW];
    __shared__ int s_want, s_done, s_n;
    const int b = blockIdx.x;
    const long long base = (long long)b * R;
    const int nw = src.nw;
    unsigned* buf = scratch != nullptr ? scratch + (long long)b * P * nw
                                       : dyn;
    unsigned* thr = src.table != nullptr ? thr_g + (long long)b * nw : thr_s;
    unsigned key[WT_MAXW];
    if (src.table != nullptr) src.fill(base, R, b);
    for (int i = threadIdx.x; i < nw; i += WT_THREADS) thr[i] = 0u;
    if (threadIdx.x == 0) {
        s_want = k;
        s_done = 0;
        s_n = 0;
    }
    __syncthreads();
    bool first = true;
    for (int w = 0; w < nw; ++w) {
        for (int shift = 24; shift >= 0; shift -= 8) {
            if (s_done) break;
            for (int i = threadIdx.x; i < 256; i += WT_THREADS) hist[i] = 0u;
            __syncthreads();
            // the digits above this one are fixed in thr[]
            const unsigned hi_mask = shift == 24 ? 0u
                                                 : ~((1u << (shift + 8)) - 1u);
            for (int r = threadIdx.x; r < R; r += WT_THREADS) {
                const unsigned* kp = src.key(base, r, b, key);
                if (kp == nullptr) continue;
                bool match = (kp[w] & hi_mask) == (thr[w] & hi_mask);
                for (int i = 0; match && i < w; ++i) match = kp[i] == thr[i];
                if (match) atomicAdd(&hist[(kp[w] >> shift) & 255u], 1u);
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                if (first) {
                    unsigned total = 0;
                    for (int i = 0; i < 256; ++i) total += hist[i];
                    if ((int)total <= k) {   // every candidate is in
                        for (int i = 0; i < nw; ++i) thr[i] = ~0u;
                        s_done = 1;
                    }
                }
                if (!s_done) {
                    int want = s_want;
                    unsigned cum = 0;
                    int d = 0;
                    for (; d < 256; ++d) {
                        if ((int)(cum + hist[d]) >= want) break;
                        cum += hist[d];
                    }
                    want -= (int)cum;
                    thr[w] |= (unsigned)d << shift;
                    if ((int)hist[d] == want) {   // the whole bin is in
                        thr[w] |= (shift == 0) ? 0u : ((1u << shift) - 1u);
                        for (int i = w + 1; i < nw; ++i) thr[i] = ~0u;
                        s_done = 1;
                    }
                    s_want = want;
                }
            }
            first = false;
            __syncthreads();
        }
    }
    // gather the rows at or before the k-th key
    for (int r = threadIdx.x; r < R; r += WT_THREADS) {
        const unsigned* kp = src.key(base, r, b, key);
        if (kp == nullptr) continue;
        if (words_lt(thr, kp, nw)) continue;
        const int slot = atomicAdd(&s_n, 1);
        for (int i = 0; i < nw; ++i) buf[(long long)slot * nw + i] = kp[i];
    }
    __syncthreads();
    const int n = s_n;
    for (int j = n + threadIdx.x; j < P; j += WT_THREADS)
        for (int i = 0; i < nw; ++i) buf[(long long)j * nw + i] = ~0u;
    __syncthreads();
    // bitonic sort, ascending, of the P keys
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < P; i += WT_THREADS) {
                const int j = i ^ stride;
                if (j <= i) continue;
                unsigned* a = buf + (long long)i * nw;
                unsigned* c = buf + (long long)j * nw;
                const bool up = (i & size) == 0;
                if (up ? words_lt(c, a, nw) : words_lt(a, c, nw)) {
                    for (int q = 0; q < nw; ++q) {
                        const unsigned t = a[q];
                        a[q] = c[q];
                        c[q] = t;
                    }
                }
            }
            __syncthreads();
        }
    }
    for (int j = threadIdx.x; j < k; j += WT_THREADS) {
        const long long o = (long long)b * k + j;
        const unsigned* m = buf + (long long)j * nw;
        if constexpr (!Src::SORT) {
            if (j >= n) {
                out_d[o] = XT_SENTINEL;
                out_s[o] = __int_as_float(0xff800000);
            } else {
                const unsigned mono = ~m[0];
                const unsigned bits =
                    (mono & 0x80000000u) ? (mono & 0x7fffffffu) : ~mono;
                const float s = __uint_as_float(bits);
                out_d[o] = isfinite(s) ? (int)m[nw - 1] : XT_SENTINEL;
                out_s[o] = s;
            }
        } else {
            if (j >= n) {
                out_d[o] = XT_SENTINEL;
                out_s[o] = __int_as_float(0xff800000);
            } else {
                const long long row = base + (long long)m[nw - 1];
                const bool el = src.elig[row] != 0;
                out_d[o] = el ? src.ids[row] : XT_SENTINEL;
                out_s[o] = el ? src.sums[row] : __int_as_float(0xff800000);
            }
            if (out_k != nullptr)
                for (int q = 0; q < nu; ++q)
                    out_k[o * nu + q] = j < n ? m[q] : ~0u;
        }
    }
}

template <class Src>
static int launch_wide(const Src& src, int B, int R, int k, int P,
                       void* scratch, void* out_d, void* out_s, void* out_k,
                       int nu, void* thr_g, void* stream) {
    if (B == 0 || k == 0) return 0;
    if (src.nw < 1 || (src.nw > WT_MAXW && src.table == nullptr) || P < k ||
        (P & (P - 1)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = scratch != nullptr
        ? 0 : (size_t)P * src.nw * sizeof(unsigned);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            wide_topk_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    wide_topk_kernel<Src><<<B, WT_THREADS, smem, (cudaStream_t)stream>>>(
        src, R, k, P, (unsigned*)scratch, (int*)out_d, (float*)out_s,
        (unsigned*)out_k, nu, (unsigned*)thr_g);
    return (int)cudaGetLastError();
}

extern "C" int xt_wide_topk_rows(const void* scores, const void* ids,
                                 const void* owner, const void* tie, int B,
                                 int R, int k, int P, void* scratch,
                                 void* out_d, void* out_s, void* stream) {
    RowSrc src{(const float*)scores, (const int*)ids,
               (const unsigned char*)owner, (const int*)tie,
               tie != nullptr ? 3 : 2};
    return launch_wide(src, B, R, k, P, scratch, out_d, out_s, nullptr, 0,
                       nullptr, stream);
}

extern "C" int xt_wide_sort_topk(const void* ids, const void* sums,
                                 const void* elig, int B, int C, int k,
                                 int S, int NW, const void* spec,
                                 const void* cols, const void* targets,
                                 int P, void* scratch, void* out_d,
                                 void* out_s, void* out_k, void* table,
                                 void* stream) {
    // table: [B, C, NW] key words, then [B, NW] fixed digits (NW > WT_MAXW)
    SortSrc src{(const int*)ids, (const float*)sums,
                (const unsigned char*)elig, S, (const int*)spec,
                (const long long*)cols, (const float*)targets, NW,
                (unsigned*)table};
    void* thr_g = table != nullptr
        ? (void*)((unsigned*)table + (long long)B * C * NW) : nullptr;
    return launch_wide(src, B, C, k, P, scratch, out_d, out_s, out_k, NW - 2,
                       thr_g, stream);
}
