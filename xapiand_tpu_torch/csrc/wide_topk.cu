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
// Each candidate row's key is a list of 32-bit words whose unsigned order
// is the answer's order, smallest first:
//   topk_rows  (~monotone(score), [tie rank,] docid): score desc, then the
//              tie rank, then docid asc; the owner rows whose score is not
//              NaN are the candidates (topk_rows.cu's rules);
//   sort_topk  sort_topk.cu's words (common.cuh spec_word): the sort
//              keys, the masked docid, the row index; every row is a
//              candidate.
// Keys are unique (owner docids are unique in a query; the row index is),
// so exactly min(k, candidates) rows are at or before the k-th key.
//
// Two kernels a call, the rows spread over the card:
//   wide_tile   grid (T, B), 1,024 threads: each block a tile of TR rows of
//               a query (kernels.wide_plan). It reads its rows once (a
//               lane's U rows' loads in flight together), writing each
//               candidate's row index and first key word to a list, and
//               histograms the word's four 8-bit digits (a warp's rows that
//               share a digit by one atomic, found by a warp AND and OR,
//               else an atomic a row). Then radix passes
//               over the list of the rows still tied: one warp finds the
//               highest digit position the tied rows do not all share (the
//               others are skipped: a word all of them share costs one
//               pass) and, by a scan of its 256 bins, the digit where the
//               running count reaches the number still wanted; one sweep
//               moves the rows below that digit to the tile's "in" list,
//               drops those above, and compacts the rows of that digit
//               into the other list, histogramming their next digits -
//               where a word is decided, computing the next word of each
//               (one column gather a sort spec), so that a row's word is
//               read once, in the pass that needs it. The passes end when
//               the tied rows are exactly the number still wanted. The
//               in-rows (min(k, candidates)) get their whole key words (a
//               thread a row's word) and are sorted: up to 512 in runs of
//               32 a warp (a bitonic network of shuffles), each key ranked
//               by binary searches in the other runs; past that a bitonic
//               sort in memory. With one tile they are
//               the answer, else the tile's sorted list;
//   wide_merge  grid (M, B): the tiles' sorted lists staged in each block's
//               shared memory (the plan keeps them within it), a candidate
//               a thread, ranked by binary searches in the
//               other lists (keys are unique: a rank each), written at its
//               rank when below k: the answer's order, as topk_rows.cu's
//               merge keeps it.
// The lists, the in-list and the sort live in shared memory where they
// fit (kernels.wide_plan), else in the wrapper's device scratch; no table
// of every row's key words.
//
// Bound on the H100: reading each row once (9-13 bytes for topk_rows; the
// flag, the docid and the first key's column for sort_topk), the tied
// rows' next words (a gather each), the k (docid, score) written; the
// passes run over the tied rows alone.
#include "common.cuh"

#define WT_THREADS 1024
#define WT_RANK 512     // in-rows at most sorted in runs (else bitonic)
#define WM_THREADS 512   // a merge block: a candidate a thread
#define WT_MAXT 1024    // tiles a query at most (the merge's counts)
#define WT_FULL 0xffffffffu
// the wrapper's flags: the tied lists, the in-list or the sort buffer in
// device memory (else shared memory)
#define WT_GLISTS 1
#define WT_GIN 2
#define WT_GSORT 4
// a pass's decision
#define WT_ALL 0        // every tied row is in: done
#define WT_CLASSIFY 1   // below the digit in, above out, on it tied
#define WT_CLASSALL 2   // as WT_CLASSIFY, and the digit's rows all in: done
#define WT_NEXT 3       // the tied rows share their word: the next word

struct RowSrc {   // topk_rows' rows
    static constexpr bool SORT = false;
    static constexpr int U = 4;   // rows a lane in flight in the first read
    const float* scores;
    const int* ids;
    const unsigned char* owner;
    const int* tie;
    int nw;
    __device__ bool cand(long long base, int r) const {
        return (owner[base + r] != 0) & !isnan(scores[base + r]);
    }
    __device__ void pos(int, int& s, int& half) const { s = half = 0; }
    __device__ unsigned word(long long base, int r, int, int w, int,
                             int) const {
        if (w == 0) {
            unsigned u = __float_as_uint(scores[base + r]);
            u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
            return ~u;
        }
        if (w == 1 && tie != nullptr) return (unsigned)tie[base + r];
        return (unsigned)ids[base + r];
    }
    __device__ void key(long long base, int r, int b, unsigned* dst) const {
        for (int w = 0; w < nw; ++w) dst[w] = word(base, r, b, w, 0, 0);
    }
};

struct SortSrc {   // sort_topk's rows
    static constexpr bool SORT = true;
    static constexpr int U = 2;
    const int* ids;
    const float* sums;
    const unsigned char* elig;
    int S;
    const int* spec;
    const long long* cols;
    const float* targets;
    int nw;
    __device__ bool cand(long long, int) const { return true; }
    // the sort spec s and half of key word w (w < nw - 2)
    __device__ void pos(int w, int& s, int& half) const {
        int p = 0;
        s = half = 0;
        for (int i = 0; i < S; ++i) {
            const int n = spec[i * 4] == ST_VALUE ? 2 : 1;
            if (w < p + n) {
                s = i;
                half = w - p;
                return;
            }
            p += n;
        }
    }
    __device__ unsigned word(long long base, int r, int b, int w, int s,
                             int half) const {
        if (w == nw - 1) return (unsigned)r;
        const int d = ids[base + r];
        const bool el = elig[base + r] != 0;
        if (w == nw - 2) return el ? ikey(d) : 0xffffffffu;
        if (!el) return spec_const(spec[s * 4]);
        return spec_word(spec + s * 4, cols + s * ST_COLS, targets, S, s, b,
                         d, sums + base + r, half);
    }
    __device__ void key(long long base, int r, int b, unsigned* dst) const {
        const int d = ids[base + r];
        const bool el = elig[base + r] != 0;
        int p = 0;
        for (int s = 0; s < S; ++s) {
            const int kind = spec[s * 4];
            for (int h = 0; h < (kind == ST_VALUE ? 2 : 1); ++h)
                dst[p++] = el ? spec_word(spec + s * 4, cols + s * ST_COLS,
                                          targets, S, s, b, d,
                                          sums + base + r, h)
                              : spec_const(kind);
        }
        dst[p++] = el ? ikey(d) : 0xffffffffu;
        dst[p] = (unsigned)r;
    }
};

__device__ __forceinline__ bool words_lt(const unsigned* a, const unsigned* b,
                                         int nw) {
    for (int i = 0; i < nw; ++i)
        if (a[i] != b[i]) return a[i] < b[i];
    return false;
}

// (a, ai) < (b, bi): keys of the in-rows ai, bi (>= n: a pad, after every
// key) by their first two words a, b, then their words 2 .. nw - 1 in
// m (n keys of nw words)
__device__ __forceinline__ bool run_lt(unsigned long long a, int ai,
                                       unsigned long long b, int bi, int n,
                                       const unsigned* m, int nw) {
    if ((ai >= n) != (bi >= n)) return bi >= n;
    if (ai >= n) return ai < bi;
    if (a != b) return a < b;
    return nw > 2 && words_lt(m + (long long)ai * nw + 2,
                              m + (long long)bi * nw + 2, nw - 2);
}

// the digits q = top .. 0 of x counted in h[q][*] (ok: the lane holds a
// row): where the warp's rows share the digit (the high digits of close
// keys), one atomic for them all, found by a warp AND and OR; else an
// atomic a lane
__device__ __forceinline__ void hist_digits(unsigned (*h)[256], unsigned x,
                                            bool ok, int top, int lane) {
    const unsigned bal = __ballot_sync(WT_FULL, ok);
    if (!bal) return;
    for (int q = top; q >= 0; --q) {
        const unsigned dig = (x >> (8 * q)) & 255u;
        const unsigned a = __reduce_and_sync(WT_FULL, ok ? dig : 255u);
        const unsigned o = __reduce_or_sync(WT_FULL, ok ? dig : 0u);
        if (a == o) {
            if (lane == __ffs(bal) - 1)
                atomicAdd(&h[q][a], (unsigned)__popc(bal));
        } else if (ok) {
            atomicAdd(&h[q][dig], 1u);
        }
    }
}

// -DWT_PHASES (tools/wide_phases.py): block (0, 0) of the last wide_tile
// launch records clock64() at its phases, and its passes, in wt_clock
#ifdef WT_PHASES
__device__ long long wt_clock[8];
#define WT_MARK(i, v)                                                     \
    do {                                                                  \
        __syncthreads();                                                  \
        if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)       \
            wt_clock[i] = (v);                                            \
    } while (0)
extern "C" int xt_wide_phases(void* out) {
    return (int)cudaMemcpyFromSymbol(out, wt_clock, sizeof(wt_clock));
}
#else
#define WT_MARK(i, v) do {} while (0)
#endif

// the lanes with ok get consecutive slots of *cnt (a warp's one atomic)
__device__ __forceinline__ int warp_slot(int* cnt, bool ok, int lane) {
    const unsigned bal = __ballot_sync(WT_FULL, ok);
    int at = 0;
    if (bal) {
        if (lane == 0) at = atomicAdd(cnt, __popc(bal));
        at = __shfl_sync(WT_FULL, at, 0);
    }
    return at + __popc(bal & ((1u << lane) - 1u));
}

// an answer's row j < k of query b from its key words m (n: the rows the
// query has at or before the k-th key; past them SENTINEL, -inf, ~0)
template <class Src>
__device__ __forceinline__ void write_out(const Src& src, long long base,
                                          int b, int k, int j, int n,
                                          const unsigned* m, int* out_d,
                                          float* out_s, unsigned* out_k,
                                          int nu) {
    const long long o = (long long)b * k + j;
    const int nw = src.nw;
    if (j >= n) {
        out_d[o] = XT_SENTINEL;
        out_s[o] = __int_as_float(0xff800000);
    } else if constexpr (!Src::SORT) {
        const unsigned mono = ~m[0];
        const unsigned bits =
            (mono & 0x80000000u) ? (mono & 0x7fffffffu) : ~mono;
        const float s = __uint_as_float(bits);
        out_d[o] = isfinite(s) ? (int)m[nw - 1] : XT_SENTINEL;
        out_s[o] = s;
    } else {
        const long long row = base + (long long)m[nw - 1];
        const bool el = src.elig[row] != 0;
        out_d[o] = el ? src.ids[row] : XT_SENTINEL;
        out_s[o] = el ? src.sums[row] : __int_as_float(0xff800000);
    }
    if (out_k != nullptr)
        for (int q = 0; q < nu; ++q) out_k[o * nu + q] = j < n ? m[q] : ~0u;
}

template <class Src>
__global__ void __launch_bounds__(WT_THREADS) wide_tile(
    Src src, int R, int T, int TR, int k, int kk, int flags,
    unsigned* __restrict__ gscr, long long per_block,
    unsigned* __restrict__ tkeys, int* __restrict__ tn,
    int* __restrict__ out_d, float* __restrict__ out_s,
    unsigned* __restrict__ out_k, int nu) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ unsigned H[2][4][256];
    __shared__ int s_cnt[2], s_in, s_want, s_act, s_p, s_d, s_s, s_half;
    __shared__ unsigned long long run_k[WT_RANK];   // the sorted runs
    __shared__ int run_i[WT_RANK];
    const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const long long base = (long long)b * R;
    const int r0 = t * TR, r1 = min(R, r0 + TR);
    const int nw = src.nw;
    unsigned* g = gscr != nullptr
        ? gscr + ((long long)b * T + t) * per_block : nullptr;
    unsigned char* p = dyn;
    uint2 *L[2];
    if (flags & WT_GLISTS) {
        L[0] = reinterpret_cast<uint2*>(g);
        g += 4LL * TR;
    } else {
        L[0] = reinterpret_cast<uint2*>(p);
        p += 16LL * TR;
    }
    L[1] = L[0] + TR;
    int* inl;
    if (flags & WT_GIN) {
        inl = reinterpret_cast<int*>(g);
        g += kk;
    } else {
        inl = reinterpret_cast<int*>(p);
    }
    unsigned* sbuf = (flags & WT_GSORT) ? g
                                        : reinterpret_cast<unsigned*>(dyn);
    WT_MARK(0, clock64());
    for (int i = tid; i < 2 * 4 * 256; i += WT_THREADS) (&H[0][0][0])[i] = 0u;
    if (tid == 0) {
        s_cnt[0] = s_cnt[1] = s_in = 0;
        s_want = k;
    }
    __syncthreads();
    {
        // the tile's rows, once: each candidate's first word to list 0, a
        // lane's U rows' loads in flight together
        constexpr int U = Src::U;
        int s0, h0;
        src.pos(0, s0, h0);
        for (int rw = r0 + warp * 32 * U; rw < r1; rw += WT_THREADS * U) {
            int rr[U];
            bool ok[U];
            unsigned x[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int r = rw + u * 32 + lane;
                rr[u] = r < r1 ? r : r1 - 1;
                ok[u] = (r < r1) & src.cand(base, rr[u]);
                x[u] = src.word(base, rr[u], b, 0, s0, h0);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                hist_digits(H[0], x[u], ok[u], 3, lane);
                const int at = warp_slot(&s_cnt[0], ok[u], lane);
                if (ok[u]) L[0][at] = make_uint2((unsigned)rr[u], x[u]);
            }
        }
    }
    __syncthreads();
    WT_MARK(1, clock64());
    // the tied rows' word w, its digits top .. 0 not yet fixed (the same in
    // every thread)
    int w = 0, top = 3, j = 0;
    for (;; ++j) {
        const int cur = j & 1, nxt = cur ^ 1;
        if (warp == 0) {
            // the decision: the digit position and digit, or the next word
            const int ns = s_cnt[cur];
            int want = s_want, act = WT_NEXT, pq = 0, d = 0;
            if (ns <= want) {
                act = WT_ALL;
            } else {
                int q = -1;
                for (int qq = top; qq >= 0 && q < 0; --qq) {
                    bool one = false;
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        one |= H[cur][qq][lane * 8 + e] == (unsigned)ns;
                    if (!__any_sync(WT_FULL, one)) q = qq;
                }
                if (q >= 0) {
                    unsigned v[8], sum = 0;
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        v[e] = H[cur][q][lane * 8 + e];
                        sum += v[e];
                    }
                    unsigned inc = sum;
#pragma unroll
                    for (int o = 1; o < 32; o <<= 1) {
                        const unsigned x = __shfl_up_sync(WT_FULL, inc, o);
                        if (lane >= o) inc += x;
                    }
                    const unsigned exc = inc - sum;
                    const unsigned bal = __ballot_sync(
                        WT_FULL, exc < (unsigned)want && (unsigned)want <= inc);
                    const int at = __ffs(bal) - 1;
                    unsigned c = exc, hd = 0;
                    int e = 0;
                    for (; e < 8; ++e) {
                        if (c + v[e] >= (unsigned)want) break;
                        c += v[e];
                    }
                    if (e < 8) hd = v[e];
                    d = __shfl_sync(WT_FULL, lane * 8 + e, at);
                    c = __shfl_sync(WT_FULL, c, at);
                    hd = __shfl_sync(WT_FULL, hd, at);
                    want -= (int)c;
                    act = (int)hd == want ? WT_CLASSALL : WT_CLASSIFY;
                    pq = 8 * q;
                }
                if ((act == WT_NEXT || (act == WT_CLASSIFY && pq == 0)) &&
                    w + 1 >= nw)
                    act = WT_ALL;   // unreachable: the keys are unique
            }
            if (lane == 0) {
                s_act = act;
                s_p = pq;
                s_d = d;
                s_want = want;
                src.pos(w + 1, s_s, s_half);
            }
        } else {
            for (int i = tid - 32; i < 4 * 256; i += WT_THREADS - 32)
                (&H[nxt][0][0])[i] = 0u;
            if (tid == 32) s_cnt[nxt] = 0;
        }
        __syncthreads();
        const int ns = s_cnt[cur], act = s_act, pq = s_p;
        const unsigned d = (unsigned)s_d;
        // the survivors' next word, or the same word's lower digits
        const bool nword = act == WT_NEXT || (act == WT_CLASSIFY && pq == 0);
        const int w1 = w + 1, sp = s_s, hf = s_half;
        const int top1 = nword ? 3 : pq / 8 - 1;
        for (int i0 = warp * 32; i0 < ns; i0 += WT_THREADS) {
            const int i = i0 + lane;
            uint2 e = make_uint2(0u, 0u);
            bool in = false, keep = false;
            if (i < ns) {
                e = L[cur][i];
                if (act == WT_ALL) {
                    in = true;
                } else if (act == WT_NEXT) {
                    keep = true;
                } else {
                    const unsigned dig = (e.y >> pq) & 255u;
                    in = dig < d || (dig == d && act == WT_CLASSALL);
                    keep = dig == d && act == WT_CLASSIFY;
                }
            }
            const int ai = warp_slot(&s_in, in, lane);
            if (in) inl[ai] = (int)e.x;
            if (act == WT_ALL || act == WT_CLASSALL) continue;
            if (keep && nword) e.y = src.word(base, (int)e.x, b, w1, sp, hf);
            hist_digits(H[nxt], e.y, keep, top1, lane);
            const int at = warp_slot(&s_cnt[nxt], keep, lane);
            if (keep) L[nxt][at] = e;
        }
        __syncthreads();
        if (act == WT_ALL || act == WT_CLASSALL) break;
        if (nword) w = w1;
        top = top1;
    }
    // the in-rows' whole keys, sorted: up to WT_RANK each ranked by
    // counting the keys below it (unique keys: a rank each), written at its
    // rank; past that a bitonic sort (P a power of two >= n)
    WT_MARK(2, clock64());
    WT_MARK(6, j);
    const int n = s_in;
    unsigned* tk = T == 1 ? nullptr
                          : tkeys + ((long long)b * T + t) * kk * nw;
    if (tid == 0 && T > 1) tn[b * T + t] = n;
    if (n <= WT_RANK) {
        // a thread a (row, word): each word's gathers in flight together
        for (int e = tid; e < n * nw; e += WT_THREADS) {
            const int i = e / nw, w2 = e - i * nw;
            int sp, hf;
            src.pos(w2, sp, hf);
            sbuf[e] = src.word(base, inl[i], b, w2, sp, hf);
        }
        __syncthreads();
        WT_MARK(3, clock64());
        // sorted runs of 32: warp w sorts keys 32 w .. 32 w + 31 by a
        // bitonic network of shuffles on their first two words (deeper words
        // from shared memory only where those tie), writes the run; then
        // each key's rank is its place in its run plus, in every other run,
        // the keys below it (a binary search of 5 steps); inl, no longer
        // read, holds the ranks
        const int nb = (n + 31) / 32;
        if (warp < nb) {
            const int i = warp * 32 + lane;
            const bool pad = i >= n;
            const unsigned* mi = sbuf + (long long)min(i, n - 1) * nw;
            unsigned long long kv = pad ? ~0ull
                : (unsigned long long)mi[0] << 32 | mi[1];
            int ki = i;
            for (int size = 2; size <= 32; size <<= 1) {
                for (int stride = size >> 1; stride > 0; stride >>= 1) {
                    const unsigned long long ov =
                        __shfl_xor_sync(WT_FULL, kv, stride);
                    const int oi = __shfl_xor_sync(WT_FULL, ki, stride);
                    const bool olt = run_lt(ov, oi, kv, ki, n, sbuf, nw);
                    const bool up = (lane & size) == 0;
                    const bool lower = (lane & stride) == 0;
                    if (up == lower ? olt : !olt) {
                        kv = ov;
                        ki = oi;
                    }
                }
            }
            run_k[i] = kv;
            run_i[i] = ki;
        }
        __syncthreads();
        if (warp < nb) {
            const int p0 = warp * 32 + lane;
            const int ki = run_i[p0];
            if (ki < n) {
                const unsigned long long kv = run_k[p0];
                int rank = lane;
                for (int r = 0; r < nb; ++r) {
                    if (r == warp) continue;
                    int lo = r * 32, hi = min(n, r * 32 + 32);
                    while (lo < hi) {
                        const int mid = (lo + hi) >> 1;
                        if (run_lt(run_k[mid], run_i[mid], kv, ki, n, sbuf,
                                   nw))
                            lo = mid + 1;
                        else
                            hi = mid;
                    }
                    rank += lo - r * 32;
                }
                inl[ki] = rank;
            }
        }
        __syncthreads();
        WT_MARK(7, clock64());
        for (int i = tid; i < n; i += WT_THREADS) {
            const unsigned* mi = sbuf + (long long)i * nw;
            const int rank = inl[i];
            if (T == 1) {
                write_out(src, base, b, k, rank, n, mi, out_d, out_s, out_k,
                          nu);
            } else {
                for (int q = 0; q < nw; ++q)
                    tk[(long long)rank * nw + q] = mi[q];
            }
        }
        if (T == 1)
            for (int jj = n + tid; jj < k; jj += WT_THREADS)
                write_out(src, base, b, k, jj, n, nullptr, out_d, out_s,
                          out_k, nu);
        WT_MARK(4, clock64());
        return;
    }
    int P = 1;
    while (P < n) P <<= 1;
    for (int i = tid; i < P; i += WT_THREADS) {
        unsigned* m = sbuf + (long long)i * nw;
        if (i < n) {
            src.key(base, inl[i], b, m);
        } else {
            for (int q = 0; q < nw; ++q) m[q] = ~0u;
        }
    }
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = tid; i < P; i += WT_THREADS) {
                const int jj = i ^ stride;
                if (jj <= i) continue;
                unsigned* a = sbuf + (long long)i * nw;
                unsigned* c = sbuf + (long long)jj * nw;
                const bool up = (i & size) == 0;
                if (up ? words_lt(c, a, nw) : words_lt(a, c, nw)) {
                    for (int q = 0; q < nw; ++q) {
                        const unsigned x = a[q];
                        a[q] = c[q];
                        c[q] = x;
                    }
                }
            }
            __syncthreads();
        }
    }
    if (T == 1) {
        for (int jj = tid; jj < k; jj += WT_THREADS)
            write_out(src, base, b, k, jj, n, sbuf + (long long)jj * nw,
                      out_d, out_s, out_k, nu);
        return;
    }
    for (long long i = tid; i < (long long)n * nw; i += WT_THREADS)
        tk[i] = sbuf[i];
}

// keys of the sorted list a (n of nw >= 2 words) below key, whose first
// two words are kk (each step's two loads together, deeper words only on
// a tie)
__device__ __forceinline__ int count_lt(const unsigned* a, int n,
                                        const unsigned* key,
                                        unsigned long long kk, int nw) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const unsigned* am = a + (long long)mid * nw;
        const unsigned long long x = (unsigned long long)am[0] << 32 | am[1];
        if (x < kk || (x == kk && nw > 2 && words_lt(am + 2, key + 2, nw - 2)))
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

template <class Src>
__global__ void __launch_bounds__(WM_THREADS) wide_merge(
    Src src, int R, int T, int kk, int k, const unsigned* __restrict__ tkeys, const int* __restrict__ tn,
    int* __restrict__ out_d, float* __restrict__ out_s,
    unsigned* __restrict__ out_k, int nu) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ int cnt[WT_MAXT];
    __shared__ int s_total;
    const int m = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int nw = src.nw;
    const long long base = (long long)b * R;
    const long long lw = (long long)kk * nw;   // a tile's list, in words
    const unsigned* q = tkeys + (long long)b * T * lw;
    for (int t = tid; t < T; t += WM_THREADS) cnt[t] = tn[b * T + t];
    if (tid == 0) s_total = 0;
    __syncthreads();
    if (tid == 0) {
        int s = 0;
        for (int t = 0; t < T; ++t) s += cnt[t];
        s_total = s;
    }
    // every list's words in one loop, the loads independent (the plan keeps
    // T x kk x nw words within shared memory)
    unsigned* K = reinterpret_cast<unsigned*>(dyn);
    const int tw = T * (int)lw;
#pragma unroll 4
    for (int e = tid; e < tw; e += WM_THREADS) {
        const int t = e / (int)lw;
        if (e - t * (int)lw < cnt[t] * nw) K[e] = __ldg(q + e);
    }
    __syncthreads();
    for (long long c = (long long)m * WM_THREADS + tid; c < (long long)T * kk;
         c += (long long)gridDim.x * WM_THREADS) {
        const int t = (int)(c / kk), i = (int)(c % kk);
        if (i >= cnt[t]) continue;
        const unsigned* key = K + t * lw + (long long)i * nw;
        const unsigned long long kk2 =
            (unsigned long long)key[0] << 32 | key[1];
        long long rank = i;
        for (int t2 = 0; t2 < T && rank < k; ++t2)
            if (t2 != t)
                rank += count_lt(K + t2 * lw, cnt[t2], key, kk2, nw);
        if (rank < k)
            write_out(src, base, b, k, (int)rank, k, key, out_d, out_s,
                      out_k, nu);
    }
    const int total = s_total;
    if (m == 0)
        for (int j = total + tid; j < k; j += WM_THREADS)
            write_out(src, base, b, k, j, total, nullptr, out_d, out_s,
                      out_k, nu);
}

// kernels.wide_plan's tiling: T tiles of TR rows a query, kk = min(k, TR)
// in-rows a tile at most (the tiles' lists, T x kk x nw words, within the
// merge's shared memory); flags WT_G*; scratch: per_block words a block
// (the lists 4 TR, the in-list kk, the sort buffer P x nw, each where its
// flag puts it in device memory; P the power of two >= kk), tkeys [B][T]
// [kk][nw] and tn [B][T] where T > 1.
template <class Src>
static int launch_wide(const Src& src, int B, int R, int k, int T, int TR,
                       int kk, int flags, void* scratch, void* tkeys,
                       void* tn, void* out_d, void* out_s, void* out_k,
                       int nu, void* stream) {
    if (B == 0 || k == 0) return 0;
    const int nw = src.nw;
    if (nw < 2 || T < 1 || T > WT_MAXT || TR < 1 ||
        (long long)T * TR < R || kk < 1 || kk > TR ||
        (T > 1 && (tkeys == nullptr || tn == nullptr)))
        return (int)cudaErrorInvalidValue;
    long long P = 1;
    while (P < kk) P <<= 1;
    long long per_block = ((flags & WT_GLISTS) ? 4LL * TR : 0) +
                          ((flags & WT_GIN) ? kk : 0) +
                          ((flags & WT_GSORT) ? P * nw : 0);
    per_block += per_block & 1;   // the lists' 8-byte entries aligned
    if (per_block > 0 && scratch == nullptr)
        return (int)cudaErrorInvalidValue;
    const size_t smem = ((flags & WT_GLISTS) ? 0 : 16 * (size_t)TR) +
                        ((flags & WT_GIN) ? 0 : 4 * (size_t)kk);
    if (!(flags & WT_GSORT) &&
        ((flags & WT_GLISTS) || (size_t)P * nw * 4 > 16 * (size_t)TR))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    // past 48 KB with the static shared memory (wide_tile's 15 KB,
    // wide_merge's 4 KB) the dynamic size is opted into
    if (smem > 32 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            wide_tile<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    wide_tile<Src><<<dim3(T, B), WT_THREADS, smem, st>>>(
        src, R, T, TR, k, kk, flags, (unsigned*)scratch, per_block,
        (unsigned*)tkeys, (int*)tn, (int*)out_d, (float*)out_s,
        (unsigned*)out_k, nu);
    int rc = (int)cudaGetLastError();
    if (rc || T == 1) return rc;
    const size_t msmem = (size_t)T * kk * nw * sizeof(unsigned);
    if (msmem > 40 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            wide_merge<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)msmem);
        if (e != cudaSuccess) return (int)e;
    }
    // the candidates a query over blocks of WM_THREADS, each block staging
    // every list
    const int mb = (int)(((long long)T * kk + WM_THREADS - 1) / WM_THREADS);
    wide_merge<Src><<<dim3(mb, B), WM_THREADS, msmem, st>>>(
        src, R, T, kk, k, (const unsigned*)tkeys, (const int*)tn,
        (int*)out_d, (float*)out_s, (unsigned*)out_k, nu);
    return (int)cudaGetLastError();
}

extern "C" int xt_wide_topk_rows(const void* scores, const void* ids,
                                 const void* owner, const void* tie, int B,
                                 int R, int k, int T, int TR, int kk,
                                 int flags, void* scratch, void* tkeys,
                                 void* tn, void* out_d, void* out_s,
                                 void* stream) {
    RowSrc src{(const float*)scores, (const int*)ids,
               (const unsigned char*)owner, (const int*)tie,
               tie != nullptr ? 3 : 2};
    return launch_wide(src, B, R, k, T, TR, kk, flags, scratch, tkeys, tn,
                       out_d, out_s, nullptr, 0, stream);
}

extern "C" int xt_wide_sort_topk(const void* ids, const void* sums,
                                 const void* elig, int B, int C, int k,
                                 int S, int NW, const void* spec,
                                 const void* cols, const void* targets,
                                 int T, int TR, int kk, int flags,
                                 void* scratch, void* tkeys, void* tn,
                                 void* out_d, void* out_s, void* out_k,
                                 void* stream) {
    SortSrc src{(const int*)ids, (const float*)sums,
                (const unsigned char*)elig, S, (const int*)spec,
                (const long long*)cols, (const float*)targets, NW};
    return launch_wide(src, B, C, k, T, TR, kk, flags, scratch, tkeys, tn,
                       out_d, out_s, out_k, NW - 2, stream);
}
