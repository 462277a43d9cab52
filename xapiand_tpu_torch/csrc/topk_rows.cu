// topk_rows: exact top-k of the owner rows by (score desc, docid asc).
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _rank_and_topk relevance
// branch 462-486 (lax.top_k over docid-sorted rows at :475, the tie
// window's at :483), and the top-(K+1) of _prefix_topk at :958.
//
// The rows come out of merge_docs grouped by term, not sorted by docid, so
// a tie cannot be broken by row index. Each row is packed into one 64-bit
// key that orders exactly as (score desc, docid asc): the high word is the
// float's bits made monotone, the low word the complemented docid. Owner
// docids are unique within a query, so keys are unique and the top-k is
// one fixed answer whatever the order in which blocks find the rows.
//
// After a collapse (collapse_rows.cu) a tie is broken by the row's tie rank
// first and its docid second, the order lax.top_k finds the collapsed rows
// in; the tie window of the join path passes the row index as the tie.
// The same kernels over the 96-bit key (score, ~tie, ~docid), held as a
// 64-bit and a 32-bit word; the relevance path's instantiation is the
// one-word key.
//
// Bound on the H100: reading 9 bytes a row once (score, docid, owner
// flag), 13 with the tie, plus 8 k bytes a query written.
//
// Design. The first version ran one block of 256 threads a query over the
// whole row range, with a per-thread sorted list of k keys indexed at run
// time: B blocks left most of the 132 SMs idle below B ~ 132 (61 GB/s at
// B16 R4194304), and every insert into the list went to local memory (4 KB
// a thread for the TieKey k-256 instance), 30x torch.topk at the tie
// window. Now:
//   stage 1, grid (tiles, B): tk_plan cuts each query's rows into as many
//     tiles as B x tiles <= TK_BLOCKS allows (4 blocks an SM; a last
//     partial wave of blocks costs a whole one), but at most ceil(R /
//     TK_TILE_MIN): R up to TK_TILE_MIN is one tile and one launch. A
//     block streams its tile four rows a thread (16-byte loads of scores,
//     docids and ties, a 4-byte load of the owner flags; the row base b R
//     is 16-byte aligned only when R is a multiple of 4, so the up to 3
//     rows before the first aligned row and after the last are read one
//     by one). A row enters the block's shared candidate buffer only if
//     its key beats the threshold, the k-th best key the block has kept so
//     far: a warp ballot and one shared atomic a warp. When the buffer
//     holds 2k keys (and TK_FLUSH_MIN), or the next round could overflow
//     it, the block sorts it (bitonic, in shared memory), keeps the best k
//     and raises the threshold; once it is set, nearly every row costs one
//     compare. The early flush keeps the sorts short: the first flush of a
//     tile then sorts some 512 keys, not 2048. The block's k best keys go
//     to a scratch [B, tiles, k] (zero keys past its count), or, with one
//     tile, straight to the outputs.
//   stage 2, grid (B): the same filter over the query's tiles' lists, rank
//     by rank, the best key of every list first; it stops at the first
//     rank row none of whose keys beats the threshold.
// The flush's fixed cost (a sort of about 2k keys, some 32 k to 64 k
// compares) is paid once a tile: tiles of at least TK_TILE_MIN rows keep
// it small beside the rows at k 80 (the tie window), while TK_BLOCKS
// keeps every SM streaming at the browse and mesh shapes. Per-warp
// candidate lists (no block barrier a round) paid the sort once a warp,
// eight times a block's, and lost at k 80; prefetching the next round's
// rows across the barriers gained nothing. The scratch is taken with
// cudaMallocAsync / cudaFreeAsync on the stream, so the C interface is
// the first version's.
//
// A row whose score is NaN (a non-scoring term under a scheme that is NaN
// at constants of 0, common.cuh scored) is left out, as the JAX package's
// compiled execute ranks it below every other row (held by
// tests/test_torch_schemes.py). A returned score that is not finite comes
// with SENTINEL for its docid, as JAX's where(isfinite(vals), ...); slots
// beyond the owner count get SENTINEL / -inf.
#include "common.cuh"

#define TK_TILE_MIN 16384           // at most ceil(R / this) tiles
#define TK_FLUSH_MIN 128            // no flush of fewer keys but the last
#define TK_BLOCKS 528               // stage 1's blocks at most (4 an SM)
#define TK_THREADS 256
#define TK_ROUND (4 * TK_THREADS)   // rows a block reads in one round
#define TK_CAP (2 * TK_ROUND)       // the shared candidate buffer's keys
#define TK_FULL 0xffffffffu

// the score's bits made monotone, in the high word; never 0 for a real row
__device__ __forceinline__ unsigned long long score_word(float s) {
    unsigned int u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (unsigned long long)u << 32;
}

// A key type: make(score, docid, tie rank), a strict order lt, the docid
// back out; a zeroed key is "no row" and below every real key.
struct RowKey {   // (score desc, docid asc)
    unsigned long long a;
    __device__ static RowKey make(float s, int d, int) {
        return {score_word(s) | (unsigned long long)(~(unsigned)d)};
    }
    __device__ bool lt(const RowKey& y) const { return a < y.a; }
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
    __device__ int docid() const { return (int)(~b); }
};

template <class Key>
__device__ __forceinline__ float key_score(const Key& k) {
    const unsigned int hi = (unsigned int)(k.a >> 32);
    return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

// The tiling of one launch, the same for every query: tiles of gper groups
// of 4 aligned rows. ops/kernels.py topk_plan mirrors it.
static void tk_plan(int B, int R, int* tiles, long long* gper) {
    const long long ng = (long long)R / 4 + 1;   // a query's groups, at most
    long long t = TK_BLOCKS / B;   // a last partial wave costs a whole one
    const long long tmax = ((long long)R + TK_TILE_MIN - 1) / TK_TILE_MIN;
    if (t > tmax) t = tmax;
    if (t < 1) t = 1;
    *gper = (ng + t - 1) / t;
    *tiles = (int)((ng + *gper - 1) / *gper);
}

// The block's candidate buffer in shared memory: keys, their count, and
// the threshold every new candidate must beat.
template <class Key>
struct TkBlock {
    Key buf[TK_CAP];
    Key thr;
    int count;
};

// Append each lane's key where pass; every lane of the warp calls it.
template <class Key>
__device__ __forceinline__ void tk_append(TkBlock<Key>& sb, bool pass,
                                          const Key& key) {
    const unsigned m = __ballot_sync(TK_FULL, pass);
    if (m == 0u) return;
    const int lane = threadIdx.x & 31, lead = __ffs(m) - 1;
    int base = 0;
    if (lane == lead) base = atomicAdd(&sb.count, __popc(m));
    base = __shfl_sync(TK_FULL, base, lead);
    if (pass) sb.buf[base + __popc(m & ((1u << lane) - 1u))] = key;
}

// Sort the n buffered keys best first (bitonic over the next power of two,
// the fill zero keys), keep min(n, k) of them and, with k kept, set the
// threshold to the k-th. Every thread calls it, after a barrier that
// followed the last append and with n read by all.
template <class Key>
__device__ void tk_flush(TkBlock<Key>& sb, int n, int k) {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int i = n + threadIdx.x; i < n2; i += blockDim.x) sb.buf[i] = Key{};
    __syncthreads();
    for (int s = 2; s <= n2; s <<= 1) {
        for (int j = s >> 1; j > 0; j >>= 1) {
            for (int p = threadIdx.x; p < (n2 >> 1); p += blockDim.x) {
                // pair p: its lower index has bit j clear
                const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
                const Key x = sb.buf[i], y = sb.buf[i | j];
                // descending where (i & s) == 0, so the whole ends so
                if ((i & s) == 0 ? x.lt(y) : y.lt(x)) {
                    sb.buf[i] = y;
                    sb.buf[i | j] = x;
                }
            }
            __syncthreads();
        }
    }
    if (threadIdx.x == 0) {
        sb.count = n < k ? n : k;
        if (n >= k) sb.thr = sb.buf[k - 1];
    }
    __syncthreads();
}

// End of a round: flush if the next round (at most `next` keys) could
// overflow the buffer, or, early while the sort is short, once it holds
// 2k keys and TK_FLUSH_MIN, so the threshold rises before most rows are
// read.
template <class Key>
__device__ __forceinline__ void tk_round_end(TkBlock<Key>& sb, int k,
                                             int next) {
    __syncthreads();
    const int n = sb.count;
    if (n > TK_CAP - next || (n >= TK_FLUSH_MIN && n >= 2 * k))
        tk_flush(sb, n, k);
    else
        __syncthreads();   // every thread has read n before new appends
}

// The block's final list: buf[0, count) best first.
template <class Key>
__device__ void tk_write_out(const TkBlock<Key>& sb, int k, int* out_d,
                             float* out_s) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
        if (j < sb.count) {
            const Key m = sb.buf[j];
            const float s = key_score(m);
            // a score that is not finite reports no docid, as JAX's
            // where(isfinite(vals), docids[idx], SENTINEL)
            out_d[j] = isfinite(s) ? m.docid() : XT_SENTINEL;
            out_s[j] = s;
        } else {
            out_d[j] = XT_SENTINEL;
            out_s[j] = __int_as_float(0xff800000);   // -inf
        }
    }
}

// stage 1: tile blockIdx.x of query blockIdx.y. vec: every pointer allows
// the 16-byte (owner: 4-byte) loads.
template <class Key>
__global__ void __launch_bounds__(TK_THREADS)
topk_tiles_kernel(const float* __restrict__ scores,
                  const int* __restrict__ ids,
                  const unsigned char* __restrict__ owner,
                  const int* __restrict__ tie, int R, int k, long long gper,
                  int vec, Key* __restrict__ scratch,
                  int* __restrict__ out_d, float* __restrict__ out_s) {
    __shared__ TkBlock<Key> sb;
    const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
    const long long first = (long long)b * R, last = first + R;
    long long a0 = (first + 3) & ~3ll;
    if (a0 > last) a0 = last;
    long long a1 = last & ~3ll;
    if (a1 < a0) a1 = a0;
    const long long ng = (a1 - a0) >> 2;
    const long long g0 = (long long)tile * gper;
    const long long g1 = g0 + gper < ng ? g0 + gper : ng;
    if (threadIdx.x == 0) {
        sb.count = 0;
        sb.thr = Key{};
    }
    __syncthreads();
    if (tile == 0 && threadIdx.x < 32) {
        // the rows before the first aligned one and after the last
        const int lane = threadIdx.x;
        long long r = -1;
        if (lane < a0 - first) r = first + lane;
        else if (lane >= 4 && lane - 4 < last - a1) r = a1 + lane - 4;
        Key key{};
        bool pass = false;
        if (r >= 0 && owner[r]) {
            const float s = scores[r];
            key = Key::make(s, ids[r], tie ? tie[r] : 0);
            pass = !isnan(s);
        }
        tk_append(sb, pass, key);
    }
    Key thr = Key{};
    for (long long gb = g0; gb < g1; gb += TK_THREADS) {
        const long long g = gb + threadIdx.x;
        Key key[4] = {};
        bool pass[4] = {false, false, false, false};
        if (g < g1) {
            const long long r = a0 + 4 * g;
            unsigned own;
            float s[4];
            int d[4], t[4] = {0, 0, 0, 0};
            if (vec) {
                own = __ldg(reinterpret_cast<const unsigned*>(owner + r));
                const float4 sv = __ldg(reinterpret_cast<const float4*>(
                    scores + r));
                const int4 dv = __ldg(reinterpret_cast<const int4*>(ids + r));
                s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
                d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
                if (tie) {
                    const int4 tv = __ldg(reinterpret_cast<const int4*>(
                        tie + r));
                    t[0] = tv.x; t[1] = tv.y; t[2] = tv.z; t[3] = tv.w;
                }
            } else {
                own = 0u;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    own |= (unsigned)owner[r + i] << (8 * i);
                    s[i] = scores[r + i];
                    d[i] = ids[r + i];
                    if (tie) t[i] = tie[r + i];
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                key[i] = Key::make(s[i], d[i], t[i]);
                pass[i] = ((own >> (8 * i)) & 0xffu) != 0u &&
                          thr.lt(key[i]) && !isnan(s[i]);
            }
        }
        if (__any_sync(TK_FULL, pass[0] | pass[1] | pass[2] | pass[3])) {
#pragma unroll
            for (int i = 0; i < 4; ++i) tk_append(sb, pass[i], key[i]);
        }
        tk_round_end(sb, k, TK_ROUND);
        thr = sb.thr;
    }
    __syncthreads();
    tk_flush(sb, sb.count, k);
    if (tiles == 1) {
        tk_write_out(sb, k, out_d + (long long)b * k,
                     out_s + (long long)b * k);
        return;
    }
    Key* dst = scratch + ((long long)b * tiles + tile) * k;
    for (int j = threadIdx.x; j < k; j += blockDim.x)
        dst[j] = j < sb.count ? sb.buf[j] : Key{};
}

// stage 2: query blockIdx.x's tiles lists of k keys (each best first, zero
// keys past its count), read rank by rank: round r takes flat keys r x 256
// .. r x 256 + 255 of the order (rank, list), so the best keys of every
// list come first. Once a whole rank row has gone by without a key that
// beats the threshold, the merge ends: every later key of a list is below
// its key in that row, and the threshold only rises.
template <class Key>
__global__ void __launch_bounds__(TK_THREADS)
topk_merge_kernel(const Key* __restrict__ scratch, int tiles, int k,
                  int* __restrict__ out_d, float* __restrict__ out_s) {
    __shared__ TkBlock<Key> sb;
    const int b = blockIdx.x;
    const Key* src = scratch + (long long)b * tiles * k;
    const int n = tiles * k;
    if (threadIdx.x == 0) {
        sb.count = 0;
        sb.thr = Key{};
    }
    __syncthreads();
    Key thr = Key{};
    int win = 0;   // no key from flat key win on has passed
    for (int base = 0; base < n; base += TK_THREADS) {
        const int f = base + threadIdx.x;
        Key key{};
        if (f < n) {
            const int rank = f / tiles;
            key = src[(long long)(f - rank * tiles) * k + rank];
        }
        // a zero key (a short list's fill) never beats the threshold
        const bool pass = thr.lt(key);
        tk_append(sb, pass, key);
        if (__syncthreads_or(pass)) {
            win = base + TK_THREADS;
        } else {
            const int row = (win + tiles - 1) / tiles;
            if ((row + 1) * tiles <= base + TK_THREADS) break;
        }
        tk_round_end(sb, k, TK_THREADS);
        thr = sb.thr;
    }
    __syncthreads();
    tk_flush(sb, sb.count, k);
    tk_write_out(sb, k, out_d + (long long)b * k, out_s + (long long)b * k);
}

static bool tk_aligned(const void* p, unsigned a) {
    return ((unsigned long long)p & (a - 1)) == 0;
}

template <class Key>
static int launch_topk(const void* scores, const void* ids, const void* owner,
                       const void* tie, int B, int R, int k, void* out_d,
                       void* out_s, void* stream) {
    if (B == 0 || k == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int tiles;
    long long gper;
    tk_plan(B, R, &tiles, &gper);
    const int vec = tk_aligned(scores, 16) && tk_aligned(ids, 16) &&
                    tk_aligned(owner, 4) &&
                    (tie == nullptr || tk_aligned(tie, 16));
    Key* scratch = nullptr;
    if (tiles > 1) {
        keep_stream_pool();
        const cudaError_t e = cudaMallocAsync(
            (void**)&scratch, sizeof(Key) * (size_t)B * tiles * k, st);
        if (e != cudaSuccess) return (int)e;
    }
    topk_tiles_kernel<Key><<<dim3(tiles, B), TK_THREADS, 0, st>>>(
        (const float*)scores, (const int*)ids, (const unsigned char*)owner,
        (const int*)tie, R, k, gper, vec, scratch, (int*)out_d,
        (float*)out_s);
    if (tiles > 1) {
        topk_merge_kernel<Key><<<B, TK_THREADS, 0, st>>>(
            scratch, tiles, k, (int*)out_d, (float*)out_s);
        const cudaError_t e = cudaFreeAsync(scratch, st);
        if (e != cudaSuccess) return (int)e;
    }
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
