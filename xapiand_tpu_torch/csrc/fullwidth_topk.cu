// fullwidth_topk: the sort-free top-k of one sort key at full row width,
// with its exactness certificate.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _fullwidth_topk 431-459:
// one lax.top_k of kk = min(k + 64, R) rows by the float32 image of the
// single sort key (the smallest images first: float(hi) of the (hi, lo)
// value key rounded to nearest, or the float key itself for dist,
// geodist and strmetric, the kinds query/plan.py fullwidth_ok admits), an
// exact sort of those kk finalists by (key, docid), and certified =
// img[kk-1] > img[k-1] over the images of all R rows in ascending order
// (JAX's vals[kk-1] < vals[k-1] on the negated image). The certificate
// depends on the multiset of images alone, so it is JAX's bit for bit.
//
// The key words are sort_topk's (spec_word in common.cuh, S = 1): the
// spec's words, the masked docid, the row. The image is monotone, not
// strictly, in the exact key, so the kk rows first in the exact key order
// are a set of kk rows with the smallest images (ties among equal images
// broken by the exact key) - the window JAX's top_k picks up to its
// choice among equal images, which only an uncertified query can see
// (those re-run on the exact path). The kernel therefore selects by the
// exact key. The window of all R rows is sort_topk's order: the eligible
// rows' keys, then the ineligible rows (a constant prefix - INT32_MAX or
// +inf, then SENTINEL - in row order; payload SENTINEL, -inf; image the
// plateau, float(INT32_MAX) = 2^31 or +inf), then the eligible rows whose
// float key is NaN (fkey puts NaN after +inf). So only the eligible rows
// are walked: the kernel keeps the kk best eligible keys and counts the
// eligible rows, and the answer places the R - n_elig ineligible rows
// between the keys below the plateau and the NaN keys. Fewer than k
// eligible rows never certify (both positions are on the plateau).
//
// Design (grid (G, B) then (B), 8 warps a block; G and gpw from
// ops/kernels.py fullwidth_plan). Pass 1: query b's flat 16-row groups go
// in steps of 8 gpw groups to its G blocks in turn (a run of eligible rows,
// a query's owner rows, is spread over all of them), and block g walks its
// steps by common.cuh warp_row_queue - a lane a group a step, its 16 flags
// one 16-byte load, the next step's in flight - and each warp queues its
// eligible rows in row order in shared memory and drains them 128 at a
// time, four rows a lane in flight: their docids, then their first key
// words (the spec and column table staged in shared memory), each compared
// with the warp's threshold, the block's bound and the query's bound on
// first 64-bit words; only a row that may pass gathers its other word and
// is compared in full. A key is two 64-bit words compared without a
// branch. The survivors are appended to the warp's candidate buffer of
// FW_CAP keys in shared memory (a ballot's slots), in no order. When the
// buffer would overflow, the warp selects its kk best (warp_select: the
// kk-th key found bit by bit by warp sums over the keys' first words in
// registers, the keys at or below it moved to the front; no sort), and its
// threshold tightens to the kk-th, whose first 64-bit word lowers the
// block's bound and the query's (atomicMin; the query's in global memory,
// read again at each drained batch): a row above either has kk better
// keys in some warp. No per-thread list, no block-wide rounds, no barrier
// during the walk. At the walk's end a warp with more than kk keys selects
// once more; a block whose warps hold more than 2 kk keys keeps its kk
// best and their ties on the first 64-bit word (block_select: that word
// found bit by bit by block sums, a barrier a bit), which lowers the
// query's bound; each warp appends its keys to the query's candidates in
// device memory (one atomic a warp), its eligible count to the query's.
// Pass 2, a block a query: its warps take the candidates 32 a lane-run,
// four runs in flight, into their buffers the same way, behind the
// query's bound; the block keeps its kk best the same way, ranks each by
// counting the keys below it in the 8 buffers (broadcast reads), and
// writes the answer and the certificate.
//
// Bound on the H100: the eligible flags, one byte a row (84 MB at config
// 3's widest sorted fullwidth launch, B 64 x R 1,310,720), then per
// eligible row its docid and the sort column gathers (hi, lo, present: 9
// bytes; 0.5% of rows there, but a query of common terms matches far
// more, its rows crowding its owner rows: the steps dealt in turn spread
// them over the G blocks); the k winners' docid and score. The walk is
// agg_metrics.cu's; a drained row's cost is its gathers' latency, so four
// are in flight.
#include "common.cuh"

#define FW_WARPS 8
#define FW_THREADS (FW_WARPS * 32)
#define FW_MIN_BLOCKS 3    // an SM's blocks at least (85 registers a thread)
#define FW_KMAX 128        // ops/kernels.py MAX_FULLWIDTH_KK
#define FW_U 4             // queued rows a lane in flight
#define FW_CAP 256         // a warp's candidate buffer (kk <= FW_KMAX kept)
#define FW_FULL 0xffffffffu

// -DFW_PHASES (tools/fullwidth_phases.py): the blocks of one query (its
// index fw_query) of the part kernel add up, in fw_phase[g], their warps'
// cycles in the walk, their rows drained (in 32s), their selections and
// the cycles of those, the cycles of the drained rows' keys, and the
// block's end (its selection, the appends)
#ifdef FW_PHASES
__device__ unsigned long long fw_phase[64][6];
__device__ int fw_query;
#define FW_ADD(i, v)                                                      \
    do {                                                                  \
        if (gridDim.y > 1 && blockIdx.y == fw_query && blockIdx.x < 64 && \
            (threadIdx.x & 31) == 0)                                      \
            atomicAdd(&fw_phase[blockIdx.x][i], (unsigned long long)(v)); \
    } while (0)
extern "C" int xt_fullwidth_phases(void* out, int reset, int query) {
    if (reset) {
        static const unsigned long long zero[64][6] = {};
        cudaError_t e = cudaMemcpyToSymbol(fw_query, &query, sizeof(int));
        if (e != cudaSuccess) return (int)e;
        return (int)cudaMemcpyToSymbol(fw_phase, zero, sizeof(zero));
    }
    return (int)cudaMemcpyFromSymbol(out, fw_phase, sizeof(fw_phase));
}
#else
#define FW_ADD(i, v) do {} while (0)
#endif

struct FwArgs {
    const int* ids;
    const float* sums;
    const unsigned char* elig;
    long long R;
    int G, gpw, k, kk;
    const int* spec;          // sort_topk's spec table, one spec
    const long long* cols;    // its ST_COLS column words
    const float* targets;     // [B][1][2] or null
    unsigned long long* cand; // [B][8 G kk][2] each query's candidates
    unsigned long long* qs;   // [3][B], zeroed: each query's candidates,
                              // eligible rows, and ~ its bound
    int* out_d;
    float* out_s;
    unsigned char* cert;
};

// A key, its words in order: a = (w0 << 32) | w1, b = (w2 << 32) | w3 of
// a value key (hi, lo, docid, row); a = (w0 << 32) | docid, b = row of a
// float key. The row makes it unique.
struct Key {
    unsigned long long a, b;
};

__device__ __forceinline__ bool klt(const Key& x, const Key& y) {
    return x.a < y.a || (x.a == y.a && x.b < y.b);
}

__device__ __forceinline__ unsigned kw0(const Key& x) {
    return (unsigned)(x.a >> 32);
}

__device__ __forceinline__ Key key_of(unsigned w0, unsigned w1, unsigned d,
                                      unsigned r, bool value) {
    Key x;
    if (value) {
        x.a = ((unsigned long long)w0 << 32) | w1;
        x.b = ((unsigned long long)d << 32) | r;
    } else {
        x.a = ((unsigned long long)w0 << 32) | d;
        x.b = r;
    }
    return x;
}

// the dynamic shared memory of a block: the warps' row queues (the merge's
// kk best keys at its end), then a warp's candidate buffer
__host__ __device__ inline int fw_smem() {
    return (int)(sizeof(int) * FW_WARPS * RQ_CAP +
                 sizeof(Key) * FW_WARPS * FW_CAP);
}

// A warp's candidates: buf[0 .. n) of FW_CAP keys, in no order; thr the
// kk-th key at the last selection (all ones until there was one), with
// every key kept since below it.
struct WarpList {
    Key* buf;
    int n;
    Key thr;
};

__device__ __forceinline__ void list_init(WarpList& L, Key* lists,
                                          int warp) {
    L.buf = lists + warp * FW_CAP;
    L.n = 0;
    L.thr.a = L.thr.b = ~0ull;
}

// A warp's keys at or below K moved to the front of buf[0 .. n), 32 at a
// time (a key moves to a place at or before its own, read before any lane
// writes). -> how many. Every lane of the warp calls it.
__device__ __forceinline__ int warp_keep(Key* buf, int n, const Key& K) {
    const int lane = threadIdx.x & 31;
    int base = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        Key x;
        bool in = false;
        if (i < n) {
            x = buf[i];
            in = !klt(K, x);
        }
        const unsigned msk = __ballot_sync(FW_FULL, in);
        __syncwarp();
        if (in) buf[base + __popc(msk & ((1u << lane) - 1u))] = x;
        base += __popc(msk);
        __syncwarp();
    }
    return base;
}

// The kk best of a warp's n > kk keys buf[0 .. n) moved to buf[0 .. kk) in
// no order; -> the kk-th of them. Its first word a is the largest X with
// fewer than kk keys' a below X, found bit by bit below the highest bit in
// which the keys' a differ (a warp sum a bit, the a words in registers);
// where several keys share that a, the same search over their b picks the
// kk-th among them. Keys are unique, so exactly kk keys are at or below
// it. Every lane of the warp calls it.
__device__ __noinline__ Key warp_select(Key* buf, int n, int kk) {
    const int lane = threadIdx.x & 31;
    unsigned long long av[FW_CAP / 32];
    unsigned long long lo = ~0ull, hi = 0;
#pragma unroll
    for (int q = 0; q < FW_CAP / 32; ++q) {
        const int i = q * 32 + lane;
        av[q] = i < n ? buf[i].a : ~0ull;   // never below a candidate X
        if (i < n) {
            lo = av[q] < lo ? av[q] : lo;
            hi = av[q] > hi ? av[q] : hi;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long l = __shfl_xor_sync(FW_FULL, lo, o);
        const unsigned long long h = __shfl_xor_sync(FW_FULL, hi, o);
        lo = l < lo ? l : lo;
        hi = h > hi ? h : hi;
    }
    unsigned long long A = lo;
    if (lo != hi) {
        // the answer lies in [lo, hi]: the bits above the highest in which
        // they differ are theirs
        const int top = 63 - __clzll((long long)(lo ^ hi));
        A = lo & ~((2ull << top) - 1ull);
        for (int bit = top; bit >= 0; --bit) {
            const unsigned long long X = A | (1ull << bit);
            int c = 0;
#pragma unroll
            for (int q = 0; q < FW_CAP / 32; ++q) c += av[q] < X;
            if (__reduce_add_sync(FW_FULL, c) < kk) A = X;
        }
    }
    int below = 0, tie = 0;
#pragma unroll
    for (int q = 0; q < FW_CAP / 32; ++q) {
        below += av[q] < A;
        tie += av[q] == A && q * 32 + lane < n;
    }
    below = __reduce_add_sync(FW_FULL, below);
    tie = __reduce_add_sync(FW_FULL, tie);
    const int m = kk - below;   // the kk-th is the m-th key on A by b
    unsigned long long B = 0;
    if (m == tie) {
        // the largest b on A
#pragma unroll
        for (int q = 0; q < FW_CAP / 32; ++q) {
            const int i = q * 32 + lane;
            if (i < n && av[q] == A && buf[i].b > B) B = buf[i].b;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long x = __shfl_xor_sync(FW_FULL, B, o);
            B = x > B ? x : B;
        }
    } else {
        for (int bit = 63; bit >= 0; --bit) {
            const unsigned long long X = B | (1ull << bit);
            int c = 0;
#pragma unroll
            for (int q = 0; q < FW_CAP / 32; ++q) {
                const int i = q * 32 + lane;
                c += i < n && av[q] == A && buf[i].b < X;
            }
            if (__reduce_add_sync(FW_FULL, c) < m) B = X;
        }
    }
    Key K;
    K.a = A;
    K.b = B;
    warp_keep(buf, n, K);
    return K;
}

// Shared words of block_select, set before the block's first barrier.
struct BlockSel {
    unsigned long long lo, hi;
    unsigned c[3];
};

__device__ __forceinline__ void bsel_init(BlockSel& S) {
    S.lo = ~0ull;
    S.hi = 0;
    S.c[0] = S.c[1] = S.c[2] = 0;
}

// The first word A of the kk-th of the block's keys (the 8 lists of
// block_best's, wn their counts, more than kk keys in all): the largest A
// with fewer than kk keys' first word below it, bit by bit below the
// highest bit in which the keys' first words differ, a block sum a bit
// (warp sums added into one of three shared counters in turn: one barrier
// a bit). Every thread calls it, after a barrier that followed wn.
__device__ unsigned long long block_select(const Key* lists, const int* wn,
                                           int kk, BlockSel& S) {
    const int lane = threadIdx.x & 31;
    constexpr int J = FW_KMAX * FW_WARPS / FW_THREADS;
    unsigned long long av[J];
    unsigned long long lo = ~0ull, hi = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int f = threadIdx.x + j * FW_THREADS;
        const int w = f / kk, i = f - w * kk;
        av[j] = ~0ull;   // never below a candidate X
        if (f < FW_WARPS * kk && i < wn[w]) {
            av[j] = lists[w * FW_CAP + i].a;
            lo = av[j] < lo ? av[j] : lo;
            hi = av[j] > hi ? av[j] : hi;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long l = __shfl_xor_sync(FW_FULL, lo, o);
        const unsigned long long h = __shfl_xor_sync(FW_FULL, hi, o);
        lo = l < lo ? l : lo;
        hi = h > hi ? h : hi;
    }
    if (lane == 0) {
        atomicMin(&S.lo, lo);
        atomicMax(&S.hi, hi);
    }
    __syncthreads();
    lo = S.lo;
    hi = S.hi;
    unsigned long long A = lo;
    if (lo != hi) {
        const int top = 63 - __clzll((long long)(lo ^ hi));
        A = lo & ~((2ull << top) - 1ull);
        int it = 0;
        for (int bit = top; bit >= 0; --bit, ++it) {
            const unsigned long long X = A | (1ull << bit);
            int c = 0;
#pragma unroll
            for (int j = 0; j < J; ++j) c += av[j] < X;
            c = __reduce_add_sync(FW_FULL, c);
            if (lane == 0 && c) atomicAdd(&S.c[it % 3], (unsigned)c);
            __syncthreads();
            const unsigned total = *(volatile unsigned*)&S.c[it % 3];
            // the counter of two bits on: read by every thread before
            // this barrier, added to after the next
            if (threadIdx.x == 0) S.c[(it + 2) % 3] = 0;
            if (total < (unsigned)kk) A = X;
        }
    }
    return A;
}

// The warp's kk best kept (n > kk), the threshold set to the kk-th, whose
// first 64-bit word lowers the block's bound blk and, where gb is given,
// the query's (held complemented, gb zeroed at the launch). Every lane
// calls it.
__device__ __forceinline__ void list_flush(WarpList& L, int kk,
                                           unsigned long long* blk,
                                           unsigned long long* gb) {
#ifdef FW_PHASES
    const long long t0 = clock64();
#endif
    L.thr = warp_select(L.buf, L.n, kk);
    L.n = kk;
    if ((threadIdx.x & 31) == 0) {
        atomicMin(blk, L.thr.a);
        if (gb) atomicMax(gb, ~L.thr.a);
    }
    FW_ADD(2, 1);
    FW_ADD(3, clock64() - t0);
}

// A lane's key appended where pass (a warp's slots by a ballot), the
// buffer's kk best selected first where it would overflow (and the keys
// compared again with the threshold that set). Every lane of the warp
// calls it.
__device__ __forceinline__ void list_add(WarpList& L, int kk, bool pass,
                                         const Key& key,
                                         unsigned long long* blk,
                                         unsigned long long* gb) {
    unsigned m = __ballot_sync(FW_FULL, pass);
    if (m == 0u) return;
    if (L.n + __popc(m) > FW_CAP) {   // uniform; then L.n > kk
        list_flush(L, kk, blk, gb);
        m = __ballot_sync(FW_FULL, pass && klt(key, L.thr));
    }
    const int lane = threadIdx.x & 31;
    if ((m >> lane) & 1u)
        L.buf[L.n + __popc(m & ((1u << lane) - 1u))] = key;
    L.n += __popc(m);
    __syncwarp();
}

// The block's kk best keys into F, in order, from its warps' lists (every
// thread calls it, after a barrier that followed the warps' last
// selection; wn the warps' counts, at most kk each): each key ranked by
// counting the keys below it in every list (a warp's lanes read the same
// key: one broadcast). -> how many there are (min(kk, all keys)).
__device__ int block_best(Key* F, const Key* lists, int kk, const int* wn) {
    int all = 0;
#pragma unroll
    for (int v = 0; v < FW_WARPS; ++v) all += wn[v];
    for (int f0 = 0; f0 < FW_WARPS * kk; f0 += FW_THREADS) {
        const int f = f0 + threadIdx.x;
        const int w = f / kk, i = f - w * kk;
        const bool own = f < FW_WARPS * kk && i < wn[w];
        Key key;
        key.a = key.b = 0;
        if (own) key = lists[w * FW_CAP + i];
        if (!__any_sync(FW_FULL, own)) continue;
        int at = 0;
#pragma unroll 1
        for (int v = 0; v < FW_WARPS; ++v) {
            const Key* Lv = lists + v * FW_CAP;
            const int nv = wn[v];
#pragma unroll 4
            for (int j = 0; j < nv; ++j) at += klt(Lv[j], key);
        }
        if (own && at < kk) F[at] = key;
    }
    __syncthreads();
    return all < kk ? all : kk;
}

// the float32 image of a key's first word: float(hi) of a value key, the
// float key itself otherwise (fkey inverted; -0.0 comes back as +0.0,
// equal under the certificate's IEEE compare)
__device__ __forceinline__ float key_image(unsigned m0, bool value) {
    if (value) return __int2float_rn((int)(m0 ^ 0x80000000u));
    return __uint_as_float((m0 & 0x80000000u) ? (m0 & 0x7fffffffu) : ~m0);
}

// The answer of query b from F, the nF best eligible keys (best first),
// and the query's eligible count: position j is F[j] below the plateau,
// then the R - n_elig ineligible rows, then F's NaN keys. Every thread
// calls it.
__device__ void fw_write(const Key* F, int nF, long long n_elig,
                         const FwArgs& a, int b, bool value) {
    // an ineligible row's first word: INT32_MAX (value) or +inf
    const unsigned c0 = value ? 0xffffffffu : 0xff800000u;
    const int nb = __syncthreads_count(threadIdx.x < nF &&
                                       kw0(F[threadIdx.x]) <= c0);
    const long long n_inel = a.R - n_elig;
    const long long base = (long long)b * a.R;
    for (int j = threadIdx.x; j < a.k; j += FW_THREADS) {
        const long long o = (long long)b * a.k + j;
        const long long s = j < nb ? j : (j - nb < n_inel ? -1 : j - n_inel);
        if (s < 0) {
            a.out_d[o] = XT_SENTINEL;
            a.out_s[o] = __int_as_float(0xff800000);
        } else {
            const long long row = base + (unsigned)F[s].b;
            a.out_d[o] = a.ids[row];
            a.out_s[o] = a.sums[row];
        }
    }
    if (threadIdx.x == 0) {
        const float plateau = value ? 2147483648.0f
                                    : __int_as_float(0x7f800000);
        float img[2];
        const int pos[2] = {a.kk - 1, a.k - 1};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int j = pos[i];
            const long long s =
                j < nb ? j : (j - nb < n_inel ? -1 : j - n_inel);
            img[i] = s < 0 ? plateau : key_image(kw0(F[s]), value);
        }
        a.cert[b] = img[0] > img[1];
    }
}

// KIND: the spec's kind, so that a kernel carries the code of its own
// key's words alone (a value key's words hi and lo, the others' one)
template <int KIND>
__global__ void __launch_bounds__(FW_THREADS, FW_MIN_BLOCKS)
fullwidth_part(FwArgs a) {
    constexpr bool value = KIND == ST_VALUE;
    extern __shared__ unsigned long long sm_fw[];
    __shared__ unsigned long long blk;
    __shared__ int wn[FW_WARPS];
    __shared__ BlockSel S;
    __shared__ int s_spec[4];
    __shared__ long long s_cols[ST_COLS];
    const int g = blockIdx.x, b = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long lo = (long long)b * a.R, hi = lo + a.R;
    // the query's steps of FW_WARPS x gpw groups dealt to its G blocks in
    // turn: a run of eligible rows (a query's owner rows) is spread over
    // all of them
    const long long q0 =
        (long long)b * a.R / 16 + (long long)g * FW_WARPS * a.gpw;
    const long long q1 = ((long long)b * a.R + a.R + 15) / 16;
    const uint4 first = wrq_first(a.elig, lo, hi, q0, q1, a.gpw, warp, lane);
    const int kk = a.kk;
    const int B = gridDim.y;
    unsigned long long* gb = a.qs + 2 * B + b;   // ~ the query's bound
    int* queue = reinterpret_cast<int*>(sm_fw) + warp * RQ_CAP;
    Key* lists = reinterpret_cast<Key*>(
        reinterpret_cast<int*>(sm_fw) + FW_WARPS * RQ_CAP);
    if (threadIdx.x < 4) s_spec[threadIdx.x] = a.spec[threadIdx.x];
    if (threadIdx.x < ST_COLS) s_cols[threadIdx.x] = a.cols[threadIdx.x];
    if (threadIdx.x == 0) {
        blk = ~0ull;
        bsel_init(S);
    }
    WarpList L;
    list_init(L, lists, warp);
    __syncthreads();
#ifdef FW_PHASES
    const long long t_walk = clock64();
#endif
    auto word = [&](int d, long long row, int half) {
        return spec_word<KIND>(s_spec, s_cols, a.targets, 1, 0, b, d,
                               a.sums + row, half);
    };
    auto drain = [&](int n) {
        for (int i0 = 0; i0 < n; i0 += 32 * FW_U) {
#ifdef FW_PHASES
            const long long t_key = clock64();
#endif
            // the query's bound, which other blocks' warps may have set
            const unsigned long long qb = ~*(volatile unsigned long long*)gb;
            int r[FW_U], d[FW_U];
            unsigned w0[FW_U], w1[FW_U];
#pragma unroll
            for (int u = 0; u < FW_U; ++u) {
                const int i = i0 + u * 32 + lane;
                r[u] = i < n ? queue[i] : -1;
                d[u] = r[u] >= 0 ? __ldg(a.ids + lo + r[u]) : 0;
            }
            const unsigned long long bound =
                *(volatile unsigned long long*)&blk;
            unsigned long long lim = L.thr.a < bound ? L.thr.a : bound;
            lim = qb < lim ? qb : lim;
            const unsigned lim0 = (unsigned)(lim >> 32);
#pragma unroll
            for (int u = 0; u < FW_U; ++u)
                w0[u] = r[u] >= 0 ? word(d[u], lo + r[u], 0) : FW_FULL;
#pragma unroll
            for (int u = 0; u < FW_U; ++u)
                w1[u] = value && w0[u] <= lim0 && r[u] >= 0
                            ? word(d[u], lo + r[u], 1) : 0u;
            FW_ADD(1, FW_U);
            FW_ADD(4, clock64() - t_key);
#pragma unroll
            for (int u = 0; u < FW_U; ++u) {
                const Key key = key_of(w0[u], w1[u], ikey(d[u]),
                                       (unsigned)r[u], value);
                const bool pass = r[u] >= 0 && key.a <= lim &&
                                  klt(key, L.thr);
                list_add(L, kk, pass, key, &blk, gb);
            }
        }
    };
    int c = warp_row_queue<FW_WARPS, true>(
        a.elig, lo, hi, q0, q1, a.gpw, warp, lane, first, queue,
        [](long long, unsigned) {}, drain, a.G);
    if (L.n > kk) list_flush(L, kk, &blk, gb);
    FW_ADD(0, clock64() - t_walk);
#ifdef FW_PHASES
    const long long t_end = clock64();
#endif
    if (lane == 0) wn[warp] = L.n;
    __syncthreads();
    int tot = 0;
#pragma unroll
    for (int v = 0; v < FW_WARPS; ++v) tot += wn[v];
    if (tot > 2 * kk) {   // uniform: the block's kk best (and ties) alone
        Key K;
        K.a = block_select(lists, wn, kk, S);
        K.b = ~0ull;
        L.n = warp_keep(L.buf, L.n, K);
        if (threadIdx.x == 0) atomicMax(gb, ~K.a);
    }
    // the warp's keys appended to the query's candidates, its eligible
    // rows to the query's count: no ranking in the block
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FW_FULL, c, o);
    unsigned long long pos = 0;
    if (lane == 0) {
        if (L.n) pos = atomicAdd(a.qs + b, (unsigned long long)L.n);
        if (c) atomicAdd(a.qs + B + b, (unsigned long long)c);
    }
    pos = __shfl_sync(FW_FULL, pos, 0);
    const long long cap = (long long)FW_WARPS * a.G * kk;
    unsigned long long* out = a.cand + ((long long)b * cap + (long long)pos) * 2;
    for (int i = lane; i < L.n; i += 32) {
        out[2 * i] = L.buf[i].a;
        out[2 * i + 1] = L.buf[i].b;
    }
    FW_ADD(5, clock64() - t_end);
}

#define FW_MQ 4   // the merge's candidates a lane in flight

__global__ void __launch_bounds__(FW_THREADS) fullwidth_merge(FwArgs a,
                                                             bool value) {
    extern __shared__ unsigned long long sm_fw[];
    __shared__ unsigned long long blk;
    __shared__ int wn[FW_WARPS];
    __shared__ BlockSel S;
    const int b = blockIdx.x, B = gridDim.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kk = a.kk;
    Key* lists = reinterpret_cast<Key*>(
        reinterpret_cast<int*>(sm_fw) + FW_WARPS * RQ_CAP);
    const long long n = (long long)a.qs[b];
    const long long n_elig = (long long)a.qs[B + b];
    if (threadIdx.x == 0) {
        blk = ~a.qs[2 * B + b];   // the walk's bound
        bsel_init(S);
    }
    WarpList L;
    list_init(L, lists, warp);
    __syncthreads();
    const long long cap = (long long)FW_WARPS * a.G * kk;
    const unsigned long long* cand = a.cand + (long long)b * cap * 2;
    // the query's candidates, FW_MQ runs of 32 a warp at a time (warp w
    // the runs w, w + 8, ...), into the warps' buffers as the walk's
    for (long long c0 = (long long)warp * 32 * FW_MQ; c0 < n;
         c0 += 32LL * FW_MQ * FW_WARPS) {
        Key keys[FW_MQ];
#pragma unroll
        for (int q = 0; q < FW_MQ; ++q) {
            const long long j = c0 + q * 32 + lane;
            keys[q].a = keys[q].b = ~0ull;   // never below a threshold
            if (j < n) {
                keys[q].a = __ldcg(cand + 2 * j);
                keys[q].b = __ldcg(cand + 2 * j + 1);
            }
        }
#pragma unroll
        for (int q = 0; q < FW_MQ; ++q) {
            const unsigned long long bound =
                *(volatile unsigned long long*)&blk;
            const bool pass = keys[q].a <= bound && klt(keys[q], L.thr);
            list_add(L, kk, pass, keys[q], &blk, nullptr);
        }
    }
    if (L.n > kk) list_flush(L, kk, &blk, nullptr);
    if (lane == 0) wn[warp] = L.n;
    __syncthreads();
    int tot = 0;
#pragma unroll
    for (int v = 0; v < FW_WARPS; ++v) tot += wn[v];
    if (tot > kk) {   // uniform: the kk best (and ties) alone
        Key K;
        K.a = block_select(lists, wn, kk, S);
        K.b = ~0ull;
        L.n = warp_keep(L.buf, L.n, K);
        __syncthreads();   // wn read by all
        if (lane == 0) wn[warp] = L.n;
        __syncthreads();
    }
    Key* F = reinterpret_cast<Key*>(sm_fw);
    const int nF = block_best(F, lists, kk, wn);
    fw_write(F, nF, n_elig, a, b, value);
}

template <int KIND>
static int fw_launch(const FwArgs& a, int B, cudaStream_t st) {
    const int smem = fw_smem();
    fullwidth_part<KIND><<<dim3(a.G, B), FW_THREADS, smem, st>>>(a);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    fullwidth_merge<<<B, FW_THREADS, smem, st>>>(a, KIND == ST_VALUE);
    return (int)cudaGetLastError();
}

// the kernels' dynamic shared memory past 48 KB (kk 128), once a
// device
static int fw_attributes() {
    static bool done[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < 64 && done[dev]) return 0;
    const int sz = fw_smem();
    const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
    e = cudaFuncSetAttribute(fullwidth_part<ST_VALUE>, at, sz);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fullwidth_part<ST_DIST>, at, sz);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fullwidth_part<ST_GEODIST>, at, sz);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fullwidth_part<ST_STRMETRIC>, at, sz);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(fullwidth_merge, at, sz);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < 64) done[dev] = true;
    return 0;
}

// spec / cols: sort_topk's spec and column tables for the one sort key,
// of kind `kind` (ST_*: value, its key words hi, lo, docid, row; dist,
// geodist or strmetric, a float key, docid, row); G blocks a query walking
// gpw 16-row groups a warp a step; scratch cand u64[B * 8 G kk * 2] and qs
// u64[3 B], qs zeroed
extern "C" int xt_fullwidth_topk(const void* ids, const void* sums,
                                 const void* elig, int B, long long R,
                                 int G, int gpw, int k, int kk, int kind,
                                 const void* spec, const void* cols,
                                 const void* targets, void* cand, void* qs,
                                 void* out_d, void* out_s, void* cert,
                                 void* stream) {
    if (B == 0) return 0;
    if (!(0 < k && k < kk && kk <= FW_KMAX && kk <= R) || G < 1 ||
        G > 65535 || B > 65535 || gpw < 1 || gpw > 32 || !cand || !qs)
        return (int)cudaErrorInvalidValue;
    int rc = fw_attributes();
    if (rc) return rc;
    const FwArgs a = {(const int*)ids, (const float*)sums,
                      (const unsigned char*)elig, R, G, gpw, k, kk,
                      (const int*)spec, (const long long*)cols,
                      (const float*)targets, (unsigned long long*)cand,
                      (unsigned long long*)qs, (int*)out_d, (float*)out_s,
                      (unsigned char*)cert};
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case ST_VALUE: return fw_launch<ST_VALUE>(a, B, st);
        case ST_DIST: return fw_launch<ST_DIST>(a, B, st);
        case ST_GEODIST: return fw_launch<ST_GEODIST>(a, B, st);
        case ST_STRMETRIC: return fw_launch<ST_STRMETRIC>(a, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
