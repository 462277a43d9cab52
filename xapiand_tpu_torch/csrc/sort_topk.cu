// sort_topk: the first k rows of each query in multi-key sort order.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _rank_and_topk multi-key
// branch 487-574 (the key construction per sort spec, then one full
// lax.sort of every row by the keys and a final docid tiebreak, of which
// the first k are kept), with _haversine 406-413 for geodist keys.
//
// Each row's key is a list of NK 32-bit words whose unsigned order is
// lax.sort's order (spec_word and its rules in common.cuh, shared with
// fullwidth_topk.cu and wide_topk.cu): the sort specs' words, the masked
// docid, the row index. The row index makes every key unique, so the top
// k is one fixed answer whatever order the blocks find it in.
//
// Bound on the H100: one eligibility byte a row; for an eligible row its
// docid, the sort columns' bytes at that docid (the score only under a
// score key); k payloads written a query.
//
// Design. The first version ran one block of 256 threads a query, each
// thread with a sorted list of k keys indexed at run time (local memory,
// 2 KB a thread at k 64 and 8 words), built every row's whole key (every
// column gathered, eligible or not) before its first compare, and popped
// the winners in k rounds of a block-wide minimum: one SM busy at B1,
// 800x its bound at browse C. Now, as topk_rows.cu:
//   stage 1, grid (tiles, B): sk_plan (ops/kernels.py sort_plan mirrors
//     it) cuts each query's rows into tiles of at least SK_TILE_MIN rows,
//     B x tiles <= SK_BLOCKS. A block streams its tile four rows a thread
//     (a 4-byte load of the flags; the flags of the next two rounds and
//     the docids of the next in flight). A row enters the block's shared
//     candidate buffer only if its key is below the threshold, the k-th
//     best key kept so far: a warp ballot and one shared atomic a warp.
//     When the buffer holds 2k keys (and SK_FLUSH_MIN), or the next round
//     could overflow it, a bitonic sort in shared memory keeps the best k
//     and lowers the threshold. The buffer is NK word planes of SK_CAP
//     keys in dynamic shared memory (64 KB at NK 8).
//   The key is built lazily. An ineligible row's words are constants
//     (spec_const; the masked docid INT32_MAX) but its row index, so it
//     costs its flag byte (and its docid where the 16-byte load of a
//     group of 4 with an eligible row reads it: sk_ids, SK_IDS_VEC; the
//     bound does not count it) and one compare against the threshold
//     (sb.inel, the constant words against the threshold's, found at each
//     flush);
//     within a warp only the first k ineligible rows that pass are kept,
//     the rest having k better keys beside them. An eligible row reads its
//     docid and builds its words one at a time while they equal the
//     threshold's (a tie goes on to the next word): a value key reads hi
//     and present first, lo only on a tie. Its whole key is built only when
//     it enters the buffer.
//   stage 2, grid (B): the tiles' lists (scratch [B][NK][k][tiles], taken
//     with cudaMallocAsync on the stream) merged rank by rank, the best key
//     of every list first, through the same buffer; it stops at the first
//     rank row none of whose keys is below the threshold. It (or stage 1
//     with one tile) writes the payloads: the docid and score, SENTINEL and
//     -inf where the row is ineligible or past C; with out_k, the NK - 2
//     words that are not the docid's or the row's (the mesh's emitted sort
//     keys, executor.py:569-573; all ones past C), which the shard merge
//     (shard_merge.cu) re-sorts by.
// Variants, timed by tools/sort_pairs.py on the H100 on the paths' own
// launches (chip_smoke.py --capture), device-only ms, this design first:
// tiles of 16384 rows (SK_TILE_MIN) geo B8 R184448 0.0625 against 0.0666
// (too few blocks at small B), equal elsewhere; 8 blocks an SM (SK_BLOCKS
// 1056) browse M B256 R1000001 1.3924 against 1.4943, N B64 0.2646
// against 0.3009; each eligible docid read alone (SK_IDS_VEC 0) M 1.4303,
// N B64 0.2751, within 1% at geo and faceted (2-3% eligible). Taken on
// made-up traffic only (their code is gone): the next round's loads
// issued before a round's compares, or the docids two rounds ahead, were
// slower at a made-up M (1.76, 1.99 ms against 1.40). A round that
// appends nothing ends on one barrier.
//
// An eligible row whose float word is NaN sorts after every ineligible
// row (fkey: NaN after +inf), so ineligible rows are never skipped: they
// stay candidates with their constant words. A k beyond MAX_SORT_TOPK, or
// more than 8 key words, goes to wide_topk.cu.
#include "common.cuh"

// SK_TILE_MIN, SK_BLOCKS and SK_IDS_VEC may be set with -D (the variants
// tools/sort_pairs.py times); ops/kernels.py sort_plan mirrors the first two
#ifndef SK_TILE_MIN
#define SK_TILE_MIN 8192            // at most ceil(C / this) tiles
#endif
#ifndef SK_BLOCKS
#define SK_BLOCKS 528               // stage 1's blocks at most (4 an SM)
#endif
#ifndef SK_IDS_VEC
#define SK_IDS_VEC 1                // 0: no 16-byte docid load (sk_ids)
#endif
#define SK_FLUSH_MIN 128            // no flush of fewer keys but the last
#define SK_THREADS 256
#define SK_ROUND (4 * SK_THREADS)   // rows a block reads in one round
#define SK_CAP (2 * SK_ROUND)       // the candidate buffer's keys
#define SK_MAXW 8                   // key words (MAX_SORT_WORDS)
#define SK_FULL 0xffffffffu

struct SkArgs {
    const int* ids;
    const float* sums;
    const unsigned char* elig;
    int C, k, S;
    const int* spec;          // [S][4] (kind, desc, nb, 0)
    const long long* cols;    // [S][ST_COLS]
    const float* targets;     // [B][S][2] or null
    int* out_d;
    float* out_s;
    unsigned* out_k;          // [B][k][NK - 2] or null
};

// The block's state beside the buffer: the threshold (all ones: not set),
// an ineligible row's words, how an ineligible row compares with the
// threshold, the buffer's count, and each user word's spec and half.
struct SkState {
    unsigned thr[SK_MAXW];
    unsigned ckey[SK_MAXW];
    int inel;   // -1: every ineligible row is below thr; 0: those whose row
                // index is below thr's; 1: none
    int count;
    int wspec[SK_MAXW];
    int whalf[SK_MAXW];
    // the first word's kind where it has a gather-only form (SF_*), and
    // its column: a value key's hi and present, or the score's sign
    int first;
    int desc0;
    const int* hi0;
    const unsigned char* pr0;
    long long n0;
    int vec0;   // hi0 16-byte and pr0 4-byte aligned
};

#define SF_GENERIC 0   // spec_word
#define SF_VALUE 1     // a value key on a present column: hi, present
#define SF_DOCID 2     // the docid
#define SF_SCORE 3     // the score

// The tiling of one launch, the same for every query: tiles of gper groups
// of 4 aligned rows. ops/kernels.py sort_plan mirrors it.
static void sk_plan(int B, int C, int* tiles, long long* gper) {
    const long long ng = (long long)C / 4 + 1;   // a query's groups, at most
    long long t = SK_BLOCKS / B;   // a last partial wave costs a whole one
    const long long tmax = ((long long)C + SK_TILE_MIN - 1) / SK_TILE_MIN;
    if (t > tmax) t = tmax;
    if (t < 1) t = 1;
    *gper = (ng + t - 1) / t;
    *tiles = (int)((ng + *gper - 1) / *gper);
}

// -1, 0, 1 as the first n words of a compare with those of b
__device__ __forceinline__ int words_cmp(const unsigned* a, const unsigned* b,
                                         int n) {
    for (int i = 0; i < n; ++i)
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    return 0;
}

template <int NK>
__device__ void sk_init(SkState& sb, const SkArgs& a) {
    if (threadIdx.x == 0) {
        int j = 0;
        for (int s = 0; s < a.S; ++s) {
            const int kind = a.spec[s * 4];
            for (int h = 0; h < (kind == ST_VALUE ? 2 : 1); ++h, ++j) {
                sb.wspec[j] = s;
                sb.whalf[j] = h;
                sb.ckey[j] = spec_const(kind);
            }
        }
        const int kind0 = a.spec[0];
        const long long* c0 = a.cols;
        sb.desc0 = a.spec[1];
        sb.first = kind0 == ST_DOCID ? SF_DOCID
                 : kind0 == ST_SCORE ? SF_SCORE
                 : (kind0 == ST_VALUE && c0[7] > 0) ? SF_VALUE : SF_GENERIC;
        sb.hi0 = (const int*)c0[0];
        sb.pr0 = (const unsigned char*)c0[2];
        sb.n0 = c0[7];
        sb.vec0 = (c0[0] & 15) == 0 && (c0[2] & 3) == 0;
        sb.ckey[NK - 2] = 0xffffffffu;   // ikey(SENTINEL)
        sb.ckey[NK - 1] = 0u;
        for (int w = 0; w < NK; ++w) sb.thr[w] = ~0u;
        sb.inel = words_cmp(sb.ckey, sb.thr, NK - 1);
        sb.count = 0;
    }
    __syncthreads();
}

// user word j of an eligible row (global row index row, docid d)
__device__ __forceinline__ unsigned user_word(const SkState& sb,
                                              const SkArgs& a, int j, int b,
                                              long long row, int d) {
    const int s = sb.wspec[j];
    return spec_word(a.spec + s * 4, a.cols + s * ST_COLS, a.targets, a.S, s,
                     b, d, a.sums + row, sb.whalf[j]);
}

// an eligible row's key < the threshold, its words from j0 on built one
// at a time while they equal the threshold's
template <int NK>
__device__ bool elig_below(const SkState& sb, const SkArgs& a, int b,
                           long long row, int r, int d, int j0) {
#pragma unroll 1
    for (int j = j0; j < NK - 2; ++j) {
        const unsigned w = user_word(sb, a, j, b, row, d);
        if (w != sb.thr[j]) return w < sb.thr[j];
    }
    const unsigned w = ikey(d);
    if (w != sb.thr[NK - 2]) return w < sb.thr[NK - 2];
    return (unsigned)r < sb.thr[NK - 1];
}

// Each lane's row (r >= 0, query-relative; elig its flag, d its docid)
// that passes enters the buffer, its whole key written to its slot. Every
// lane of the warp calls it.
template <int NK>
__device__ __forceinline__ void sk_append(SkState& sb, unsigned* buf,
                                          const SkArgs& a, int b, bool pass,
                                          int r, bool el, int d) {
    const unsigned m = __ballot_sync(SK_FULL, pass);
    if (m == 0u) return;
    const int lane = threadIdx.x & 31, lead = __ffs(m) - 1;
    int base = 0;
    if (lane == lead) base = atomicAdd(&sb.count, __popc(m));
    base = __shfl_sync(SK_FULL, base, lead);
    if (!pass) return;
    const int slot = base + __popc(m & ((1u << lane) - 1u));
    const long long row = (long long)b * a.C + r;
#pragma unroll 1
    for (int j = 0; j < NK - 2; ++j)
        buf[j * SK_CAP + slot] = el ? user_word(sb, a, j, b, row, d)
                                    : sb.ckey[j];
    buf[(NK - 2) * SK_CAP + slot] = el ? ikey(d) : 0xffffffffu;
    buf[(NK - 1) * SK_CAP + slot] = (unsigned)r;
}

// NR rows a lane, the warp's lanes in row order (r[i] < 0: none; el[i]
// its flag, d[i] its docid where eligible). Every lane of the warp calls
// it.
template <int NK, int NR>
__device__ __forceinline__ bool sk_rows(SkState& sb, unsigned* buf,
                                        const SkArgs& a, int b,
                                        const int (&r)[NR],
                                        const bool (&el)[NR],
                                        const int (&d)[NR]) {
    const long long first = (long long)b * a.C;
    bool pass[NR];
    // the first word of every row at once, its gathers all in flight
    unsigned w0[NR];
    const int f0 = sb.first;
    if (f0 == SF_VALUE) {
        const long long nm1 = sb.n0 - 1;
        int h[NR];
        unsigned pr = 0u;   // byte i: row i's present
        bool run = false;
        if constexpr (NR == 4) {
            // the docids of a dense row run: one load each column
            run = sb.vec0 && (d[0] & 3) == 0 && (long long)d[0] + 3 <= nm1 &&
                  d[1] == d[0] + 1 && d[2] == d[0] + 2 && d[3] == d[0] + 3;
            if (run) {
                const int4 v = __ldg(reinterpret_cast<const int4*>(
                    sb.hi0 + d[0]));
                h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
                pr = __ldg(reinterpret_cast<const unsigned*>(sb.pr0 + d[0]));
            }
        }
        if (!run) {
#pragma unroll
            for (int i = 0; i < NR; ++i) {
                h[i] = 0;
                if (el[i]) {
                    const long long dd = (long long)d[i] < nm1 ? d[i] : nm1;
                    h[i] = __ldg(sb.hi0 + dd);
                    pr |= (unsigned)__ldg(sb.pr0 + dd) << (8 * i);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const int hv = sb.desc0 ? ~h[i] : h[i];
            w0[i] = ikey(((pr >> (8 * i)) & 0xffu) ? hv : XT_I32MAX);
        }
    } else if (f0 == SF_SCORE) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const float sc = el[i] ? __ldg(a.sums + first + r[i]) : 0.0f;
            w0[i] = fkey(sb.desc0 ? -sc : sc);
        }
    } else {
#pragma unroll
        for (int i = 0; i < NR; ++i) w0[i] = ikey(d[i]);
    }
    const unsigned thr0 = sb.thr[0];
    const int inel = sb.inel;
    const unsigned thr_row = sb.thr[NK - 1];
    int nin = 0;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
        if (el[i]) {
            if (f0 == SF_GENERIC)
                pass[i] = elig_below<NK>(sb, a, b, first + r[i], r[i], d[i],
                                         0);
            else if (w0[i] != thr0)
                pass[i] = w0[i] < thr0;
            else   // a tie goes on to the next word
                pass[i] = elig_below<NK>(sb, a, b, first + r[i], r[i], d[i],
                                         1);
        } else {
            pass[i] = r[i] >= 0 &&
                      (inel < 0 || (inel == 0 && (unsigned)r[i] < thr_row));
            nin += pass[i];
        }
    }
    // ineligible rows tie but for the row index: past the warp's first k
    // that pass, a row has k better keys beside it
    if (__any_sync(SK_FULL, nin > 0)) {
        const int lane = threadIdx.x & 31;
        int incl = nin;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(SK_FULL, incl, o);
            if (lane >= o) incl += t;
        }
        int rank = incl - nin;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            if (!el[i] && pass[i]) {
                pass[i] = rank < a.k;
                ++rank;
            }
        }
    }
    bool any = false;
#pragma unroll
    for (int i = 0; i < NR; ++i) any |= pass[i];
    if (__any_sync(SK_FULL, any)) {
#pragma unroll
        for (int i = 0; i < NR; ++i)
            sk_append<NK>(sb, buf, a, b, pass[i], r[i], el[i], d[i]);
    }
    return any;
}

// key x < key y of the buffer
template <int NK>
__device__ __forceinline__ bool buf_lt(const unsigned* buf, int x, int y) {
#pragma unroll
    for (int w = 0; w < NK; ++w) {
        const unsigned u = buf[w * SK_CAP + x], v = buf[w * SK_CAP + y];
        if (u != v) return u < v;
    }
    return false;
}

// Sort the n buffered keys best (least) first (bitonic over the next power
// of two, the fill all ones), keep min(n, k) of them and, with k kept, set
// the threshold to the k-th. Every thread calls it, after a barrier that
// followed the last append and with n read by all.
template <int NK>
__device__ void sk_flush(SkState& sb, unsigned* buf, int n, int k) {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int i = n + threadIdx.x; i < n2; i += blockDim.x) {
#pragma unroll
        for (int w = 0; w < NK; ++w) buf[w * SK_CAP + i] = ~0u;
    }
    __syncthreads();
    for (int s = 2; s <= n2; s <<= 1) {
        for (int j = s >> 1; j > 0; j >>= 1) {
            for (int p = threadIdx.x; p < (n2 >> 1); p += blockDim.x) {
                // pair p: its lower index has bit j clear
                const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
                const int m = i | j;
                // ascending where (i & s) == 0, so the whole ends so
                if ((i & s) == 0 ? buf_lt<NK>(buf, m, i)
                                 : buf_lt<NK>(buf, i, m)) {
#pragma unroll
                    for (int w = 0; w < NK; ++w) {
                        const unsigned t = buf[w * SK_CAP + i];
                        buf[w * SK_CAP + i] = buf[w * SK_CAP + m];
                        buf[w * SK_CAP + m] = t;
                    }
                }
            }
            __syncthreads();
        }
    }
    if (threadIdx.x == 0) {
        sb.count = n < k ? n : k;
        if (n >= k) {
            for (int w = 0; w < NK; ++w) sb.thr[w] = buf[w * SK_CAP + k - 1];
            sb.inel = words_cmp(sb.ckey, sb.thr, NK - 1);
        }
    }
    __syncthreads();
}

// End of a round (appended: this thread put a key in the buffer in it):
// flush if the next round (at most `next` keys) could overflow the
// buffer, or, early while the sort is short, once it holds 2k keys and
// SK_FLUSH_MIN, so the threshold falls before most rows are read. A round
// in which no key entered leaves the buffer as the last end found it
// (with no flush due), and costs one barrier.
template <int NK>
__device__ __forceinline__ void sk_round_end(SkState& sb, unsigned* buf,
                                             int k, int next,
                                             bool appended) {
    if (!__syncthreads_or(appended)) return;
    const int n = sb.count;
    if (n > SK_CAP - next || (n >= SK_FLUSH_MIN && n >= 2 * k))
        sk_flush<NK>(sb, buf, n, k);
    else
        __syncthreads();   // every thread has read n before new appends
}

// The query's answer from the buffer's first count keys (best first).
template <int NK>
__device__ void sk_write_out(const unsigned* buf, int count, const SkArgs& a,
                             int b) {
    for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
        const long long o = (long long)b * a.k + j;
        int d = XT_SENTINEL;
        float s = __int_as_float(0xff800000);   // -inf
        if (j < count) {
            const long long row = (long long)b * a.C +
                                  buf[(NK - 1) * SK_CAP + j];
            if (a.elig[row]) {
                d = a.ids[row];
                s = a.sums[row];
            }
        }
        a.out_d[o] = d;
        a.out_s[o] = s;
        if (a.out_k != nullptr) {
            for (int w = 0; w < NK - 2; ++w)
                a.out_k[o * (NK - 2) + w] = j < count ? buf[w * SK_CAP + j]
                                                      : ~0u;
        }
    }
}

// The flags of the 4 rows from row (4-byte aligned where vec & 1).
__device__ __forceinline__ unsigned sk_flags(const SkArgs& a, long long row,
                                             int vec) {
    if (vec & 1)
        return __ldg(reinterpret_cast<const unsigned*>(a.elig + row));
    unsigned own = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        own |= (unsigned)a.elig[row + i] << (8 * i);
    return own;
}

// The docids of the eligible rows of the 4 from row, SENTINEL for the
// others: one 16-byte load where vec & 2, which reads the ineligible rows'
// docids beside the eligible ones' (a group with no eligible row reads
// none), else one load an eligible row.
__device__ __forceinline__ void sk_ids(const SkArgs& a, long long row,
                                       unsigned own, int vec, int (&d)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = XT_SENTINEL;
    if (own == 0u) return;
    if (vec & 2) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(a.ids + row));
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if ((own >> (8 * i)) & 0xffu) d[i] = __ldg(a.ids + row + i);
    }
}

// stage 1: tile blockIdx.x of query blockIdx.y. vec: bit 0, the flags
// allow the 4-byte loads; bit 1, the docids the 16-byte loads.
template <int NK>
__global__ void __launch_bounds__(SK_THREADS)
sort_tiles_kernel(SkArgs a, long long gper, int vec,
                  unsigned* __restrict__ scratch) {
    extern __shared__ unsigned buf[];   // [NK][SK_CAP]
    __shared__ SkState sb;
    const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
    const long long first = (long long)b * a.C, last = first + a.C;
    long long a0 = (first + 3) & ~3ll;
    if (a0 > last) a0 = last;
    long long a1 = last & ~3ll;
    if (a1 < a0) a1 = a0;
    const long long ng = (a1 - a0) >> 2;
    const long long g0 = (long long)tile * gper;
    const long long g1 = g0 + gper < ng ? g0 + gper : ng;
    sk_init<NK>(sb, a);
    bool appended = false;   // by this thread, since the last round's end
    if (tile == 0 && threadIdx.x < 32) {
        // the rows before the first aligned one and after the last
        const int lane = threadIdx.x;
        int r[1] = {-1};
        if (lane < a0 - first) r[0] = lane;
        else if (lane >= 4 && lane - 4 < last - a1)
            r[0] = (int)(a1 - first) + lane - 4;
        const bool el[1] = {r[0] >= 0 && a.elig[first + r[0]] != 0};
        const int d[1] = {el[0] ? a.ids[first + r[0]] : XT_SENTINEL};
        appended = sk_rows<NK, 1>(sb, buf, a, b, r, el, d);
    }
    // Each thread's group of 4 rows a round. Once a round is compared, the
    // flags of the round after next and the docids of the next are asked
    // for, so they arrive across the round's barriers and the next round
    // waits on its key gathers alone.
    const long long gt = g0 + threadIdx.x;
    unsigned own = gt < g1 ? sk_flags(a, a0 + 4 * gt, vec) : 0u;
    int d[4];
    sk_ids(a, a0 + 4 * gt, own, vec, d);
    unsigned own_n = gt + SK_THREADS < g1
        ? sk_flags(a, a0 + 4 * (gt + SK_THREADS), vec) : 0u;
    for (long long gb = g0; gb < g1; gb += SK_THREADS) {
        const long long g = gb + threadIdx.x;
        int r[4];
        bool el[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            r[i] = g < g1 ? (int)(a0 + 4 * g - first) + i : -1;
            el[i] = ((own >> (8 * i)) & 0xffu) != 0u;
        }
        appended |= sk_rows<NK, 4>(sb, buf, a, b, r, el, d);
        const long long gnn = g + 2 * SK_THREADS;
        own = own_n;
        own_n = gnn < g1 ? sk_flags(a, a0 + 4 * gnn, vec) : 0u;
        sk_ids(a, a0 + 4 * (g + SK_THREADS), own, vec, d);
        sk_round_end<NK>(sb, buf, a.k, SK_ROUND, appended);
        appended = false;
    }
    __syncthreads();
    sk_flush<NK>(sb, buf, sb.count, a.k);
    if (tiles == 1) {
        sk_write_out<NK>(buf, sb.count, a, b);
        return;
    }
    // the list: word w of rank j at [b][w][j][tile], all ones past count
    for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
        for (int w = 0; w < NK; ++w)
            scratch[(((long long)b * NK + w) * a.k + j) * tiles + tile] =
                j < sb.count ? buf[w * SK_CAP + j] : ~0u;
    }
}

// stage 2: query blockIdx.x's tiles lists of k keys (each best first, all
// ones past its count), read rank by rank: flat key f = rank x tiles +
// list, so the best keys of every list come first. Once a whole rank row
// has gone by without a key below the threshold, the merge ends: every
// later key of a list is above its key in that row, and the threshold
// only falls.
template <int NK>
__global__ void __launch_bounds__(SK_THREADS)
sort_merge_kernel(SkArgs a, const unsigned* __restrict__ scratch,
                  int tiles) {
    extern __shared__ unsigned buf[];   // [NK][SK_CAP]
    __shared__ SkState sb;
    const int b = blockIdx.x;
    const int n = tiles * a.k;
    const unsigned* src = scratch + (long long)b * NK * n;
    sk_init<NK>(sb, a);
    int win = 0;   // no key from flat key win on has passed
    for (int base = 0; base < n; base += SK_THREADS) {
        const int f = base + threadIdx.x;
        unsigned key[NK];
        bool pass = false;
        if (f < n) {
#pragma unroll
            for (int w = 0; w < NK; ++w) key[w] = src[(long long)w * n + f];
            // a fill key (all ones) is never below the threshold
            pass = words_cmp(key, sb.thr, NK) < 0;
        }
        const unsigned m = __ballot_sync(SK_FULL, pass);
        if (m != 0u) {
            const int lane = threadIdx.x & 31, lead = __ffs(m) - 1;
            int at = 0;
            if (lane == lead) at = atomicAdd(&sb.count, __popc(m));
            at = __shfl_sync(SK_FULL, at, lead);
            if (pass) {
                const int slot = at + __popc(m & ((1u << lane) - 1u));
#pragma unroll
                for (int w = 0; w < NK; ++w) buf[w * SK_CAP + slot] = key[w];
            }
        }
        if (__syncthreads_or(pass)) {
            win = base + SK_THREADS;
        } else {
            const int row = (win + tiles - 1) / tiles;
            if ((row + 1) * tiles <= base + SK_THREADS) break;
        }
        sk_round_end<NK>(sb, buf, a.k, SK_THREADS, pass);
    }
    __syncthreads();
    sk_flush<NK>(sb, buf, sb.count, a.k);
    sk_write_out<NK>(buf, sb.count, a, b);
}

template <int NK>
static int sk_launch(const SkArgs& a, int B, cudaStream_t st) {
    int tiles;
    long long gper;
    sk_plan(B, a.C, &tiles, &gper);
    const int vec = (((unsigned long long)a.elig & 3ull) == 0) |
                    ((SK_IDS_VEC &&
                      ((unsigned long long)a.ids & 15ull) == 0) << 1);
    const int smem = NK * SK_CAP * (int)sizeof(unsigned);
    static bool attr[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64 || !attr[dev]) {
        e = cudaFuncSetAttribute(sort_tiles_kernel<NK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                sort_merge_kernel<NK>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        if (dev >= 0 && dev < 64) attr[dev] = true;
    }
    unsigned* scratch = nullptr;
    if (tiles > 1) {
        keep_stream_pool();
        e = cudaMallocAsync((void**)&scratch,
                            sizeof(unsigned) * (size_t)B * tiles * a.k * NK,
                            st);
        if (e != cudaSuccess) return (int)e;
    }
    sort_tiles_kernel<NK><<<dim3(tiles, B), SK_THREADS, smem, st>>>(
        a, gper, vec, scratch);
    if (tiles > 1) {
        sort_merge_kernel<NK><<<B, SK_THREADS, smem, st>>>(a, scratch, tiles);
        e = cudaFreeAsync(scratch, st);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

extern "C" int xt_sort_topk(const void* ids, const void* sums,
                            const void* elig, int B, int C, int k, int S,
                            int NK, const void* spec, const void* cols,
                            const void* targets, void* out_d, void* out_s,
                            void* out_k, void* stream) {
    if (B == 0 || k == 0) return 0;
    if (k > 64 || S < 1 || S > SK_MAXW - 2) return (int)cudaErrorInvalidValue;
    const SkArgs a = {(const int*)ids, (const float*)sums,
                      (const unsigned char*)elig, C, k, S,
                      (const int*)spec, (const long long*)cols,
                      (const float*)targets, (int*)out_d, (float*)out_s,
                      (unsigned*)out_k};
    cudaStream_t st = (cudaStream_t)stream;
    switch (NK) {
        case 3: return sk_launch<3>(a, B, st);
        case 4: return sk_launch<4>(a, B, st);
        case 5: return sk_launch<5>(a, B, st);
        case 6: return sk_launch<6>(a, B, st);
        case 7: return sk_launch<7>(a, B, st);
        case 8: return sk_launch<8>(a, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
