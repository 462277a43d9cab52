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

// K18: the per-posting formulas of every weight scheme (xapiand_tpu/
// models/weights.py 164-575), one id each (xapiand_tpu_torch/models/
// weights.py S_*; IneB2 shares IfB2's formula, LM has one per smoothing).
// p holds the scheme's float32 parameters as models/weights.py kernel_spec
// folds them; tc points at the term's n_constants floats; uniq is the
// doc's distinct-term count (1 where the scheme reads none). Every
// expression is the JAX package's, in its order, each operation rounded
// (-fmad=false), so the plain version (weights.py scheme_sumpart) gives
// the same bits; log2f / logf are CUDA's full-precision functions, the
// ones torch.log2 / torch.log call on the card.
enum : int {
    XT_SCHEME_BM25 = 0, XT_SCHEME_BM25PLUS, XT_SCHEME_TFIDF, XT_SCHEME_TRAD,
    XT_SCHEME_BOOL, XT_SCHEME_COORD, XT_SCHEME_DICE, XT_SCHEME_INL2,
    XT_SCHEME_IFB2, XT_SCHEME_BB2, XT_SCHEME_PL2, XT_SCHEME_PL2PLUS,
    XT_SCHEME_DLH, XT_SCHEME_DPH, XT_SCHEME_LM_TWO_STAGE, XT_SCHEME_LM_JM,
    XT_SCHEME_LM_DIRICHLET, XT_SCHEME_LM_DIRICHLET_PLUS, XT_SCHEME_LM_ABS
};
#define XT_SCHEME_PARAMS 8

struct SchemeSpec {
    int id;
    float p[XT_SCHEME_PARAMS];
};

// the launch's spec from the C entry point's (id, host parameter array)
static inline SchemeSpec make_spec(int id, const float* params) {
    SchemeSpec s;
    s.id = id;
    for (int i = 0; i < XT_SCHEME_PARAMS; ++i) s.p[i] = params[i];
    return s;
}

// DFR normalisation 2: wdf * log2(1 + c*avg / max(len, 1))
__device__ __forceinline__ float dfr_wdfn(float wdf, float dl, float cavg) {
    return wdf * log2f(1.0f + cavg / fmaxf(dl, 1.0f));
}

// PL2's P(wdfn): P1 + (wdfn + 0.5) log2(wdfn) - P2 wdfn, mean = F / N
__device__ __forceinline__ float pl2_p(float wdfn, float F, const float* p) {
    const float mean = F / p[1];
    const float P1 = mean / p[2] + p[3];
    const float P2 = log2f(mean) + p[4];
    return P1 + (wdfn + 0.5f) * log2f(fmaxf(wdfn, 1e-9f)) - P2 * wdfn;
}

// BB2's Stirling value (y + 0.5)(c - log2 y) + d c
__device__ __forceinline__ float bb2_stirling(float d, float y, float c) {
    return (y + 0.5f) * (c - log2f(fmaxf(y, 1e-9f))) + d * c;
}

__device__ __forceinline__ float scheme_sumpart_generic(
    const SchemeSpec& s, float wdf, float dl, const float* tc, float uniq) {
    const float* p = s.p;
    const float tc0 = tc[0];
    switch (s.id) {
    case XT_SCHEME_BM25PLUS: {
        const float normlen = fmaxf(dl * p[0], p[4]);
        const float denom = p[1] * (normlen * p[2] + p[3]) + wdf;
        const float part = wdf / fmaxf(denom, 1e-9f) + p[5];
        return wdf > 0.0f ? tc0 * part : 0.0f;
    }
    case XT_SCHEME_TFIDF:
        return tc0 * wdf;
    case XT_SCHEME_TRAD: {
        if (p[0] == 0.0f) return tc0 * 1.0f;
        const float normlen = dl / p[1];
        const float denom = p[0] * normlen + wdf;
        return tc0 * (wdf / fmaxf(denom, 1e-9f));
    }
    case XT_SCHEME_BOOL:
        return 0.0f;
    case XT_SCHEME_COORD:
        return tc0 * 1.0f;
    case XT_SCHEME_DICE:
        return wdf > 0.0f ? tc0 * 2.0f / (p[0] + uniq) : 0.0f;
    case XT_SCHEME_INL2: {
        const float wdfn = dfr_wdfn(wdf, dl, p[0]);
        return wdf > 0.0f ? tc0 * wdfn / (wdfn + 1.0f) : 0.0f;
    }
    case XT_SCHEME_IFB2: {
        const float wdfn = dfr_wdfn(wdf, dl, p[0]);
        const float w = tc0 * wdfn * tc[1] / (wdfn + 1.0f);
        return wdf > 0.0f ? w : 0.0f;
    }
    case XT_SCHEME_BB2: {
        const float F = tc[1];
        const float wdfn = fminf(dfr_wdfn(wdf, dl, p[0]), F - 1.0f);
        const float N = p[1];
        const float wt = p[2] - log2f(N - 1.0f);
        const float sc1 = log2f(N + F - 1.0f);
        const float sc2 = log2f(F);
        const float y2 = F - wdfn;
        const float y1 = (N - 2.0f) + y2;
        const float st = bb2_stirling(wdfn + 1.0f, y1, sc1) -
                         bb2_stirling(wdfn, y2, sc2);
        const float w = tc0 / (wdfn + 1.0f) * (wt + st);
        return (wdf > 0.0f && w > 0.0f) ? w : 0.0f;
    }
    case XT_SCHEME_PL2: {
        const float wdfn = dfr_wdfn(wdf, dl, p[0]);
        const float P = pl2_p(wdfn, tc[1], p);
        const float w = tc0 * P / (wdfn + 1.0f);
        return (wdf > 0.0f && P > 0.0f) ? w : 0.0f;
    }
    case XT_SCHEME_PL2PLUS: {
        const float F = tc[1];
        const float mean = F / p[1];
        const float wdfn = dfr_wdfn(wdf, dl, p[0]);
        const float P = pl2_p(wdfn, F, p);
        const float dw = pl2_p(p[5], F, p) / p[6];
        const float wt = P / (wdfn + 1.0f) + dw;
        const float w = tc0 * wt;
        return (wdf > 0.0f && mean >= 1.0f && wt > 0.0f) ? w : 0.0f;
    }
    case XT_SCHEME_DLH:
    case XT_SCHEME_DPH: {
        const float log_const = p[0] / tc[1];
        const float len = fmaxf(dl, 1.0f);
        const float f = wdf / len;
        const float omf = fminf(fmaxf(1.0f - f, 1e-9f), 1.0f);
        const float wdfs = fmaxf(wdf, 1e-9f);
        const float a = wdf * log2f(fmaxf(f * log_const, 1e-30f));
        const float c = 0.5f * log2f(p[1] * wdfs * omf);
        float wt, w;
        if (s.id == XT_SCHEME_DLH) {
            wt = a + (len - wdf) * log2f(omf) + c;
            w = tc0 * wt / (wdfs + 0.5f);
        } else {
            const float norm = omf * omf / (wdf + 1.0f);
            wt = norm * (a + c);
            w = tc0 * wt;
        }
        return (wdf > 0.0f && wdf < len && wt > 0.0f) ? w : 0.0f;
    }
    case XT_SCHEME_LM_TWO_STAGE:
    case XT_SCHEME_LM_JM:
    case XT_SCHEME_LM_DIRICHLET:
    case XT_SCHEME_LM_DIRICHLET_PLUS:
    case XT_SCHEME_LM_ABS: {
        // LM: p = (s1, s2, 1 - s1, param_log or doclen_upper)
        const float wc = tc[1];
        const float s1 = p[0], s2 = p[1], oms1 = p[2];
        const float ln = fmaxf(dl, 1.0f);
        float ws;
        if (s.id == XT_SCHEME_LM_JM) {
            ws = s1 * wc + oms1 * wdf / ln;
        } else if (s.id == XT_SCHEME_LM_DIRICHLET) {
            ws = (wdf + s1 * wc) / (ln + s1);
        } else if (s.id == XT_SCHEME_LM_DIRICHLET_PLUS) {
            const float sw = s1 * wc;
            ws = (1.0f + wdf / sw) * (1.0f + s2 / sw);
        } else if (s.id == XT_SCHEME_LM_ABS) {
            ws = fmaxf(wdf - s1, 0.0f) / ln + (s1 * wc * uniq) / ln;
        } else {     // two_stage
            ws = oms1 * (wdf + s2 * wc) / (ln + s2) + s1 * wc;
        }
        const float product = ws * p[3];
        return (wdf > 0.0f && product > 1.0f)
                   ? tc0 * logf(fmaxf(product, 1.0f)) : 0.0f;
    }
    default:     // BM25 takes scheme_sumpart's other instance
        return 0.0f;
    }
}

// A term's weight times its scoring flag (executor.py:722). A non-scoring
// term (scoring 0: OP_SYNONYM's members, filter terms) has constants of 0,
// where PL2, PL2Plus, DLH, DPH, BB2 and LM dirichlet_plus are NaN; JAX
// multiplies that by 0 and keeps the NaN in the doc's sum, and so does the
// port (ROADMAP queue 3, reference faults mirrored). One operation for
// both instances: BM25 is finite there.
template <bool GENERIC>
__device__ __forceinline__ float scored(float w, float sc) {
    return w * sc;
}

// The kernels' one entry to a scheme: GENERIC false is BM25 inline, the
// code of every BM25 launch as it was before the other schemes; true
// switches on the launch-uniform id.
template <bool GENERIC>
__device__ __forceinline__ float scheme_sumpart(const SchemeSpec& s,
                                                float wdf, float dl,
                                                const float* tc, float uniq) {
    if (!GENERIC)
        return bm25_sumpart(wdf, dl, tc[0], Bm25Params{s.p[0], s.p[1], s.p[2],
                                                       s.p[3], s.p[4]});
    return scheme_sumpart_generic(s, wdf, dl, tc, uniq);
}

// leftmost i in [0, n) with a[i] >= x (a ascending): K15, xapiand_tpu/ops/
// executor.py lower_bound 192-205 and lower_bound_sorted 208-224. The TPU
// sort-joined an ascending query vector because its gathers serialise; on
// the H100 each probe is one L2-resident load, so a plain binary search
// per query element computes the same index.
__device__ __forceinline__ int lower_bound_i32(const int* a, int n, int x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// the number of elements <= x in a[0, n) (a ascending): K15 rank_count
// with count_equal (executor.py 227-246), as lower_bound_i32 gives the
// count of elements < x. The TPU counted by a sort-join for the same
// reason as above.
__device__ __forceinline__ int upper_bound_i32(const int* a, int n, int x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (a[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// lower_bound_i32 by the 32 lanes of a warp (every lane gets the
// answer): each round the lanes read 32 pivots that cut [lo, hi) in 33
// and keep the part that holds the answer, so a search is ~log33 n
// dependent loads, not log2 n
__device__ __forceinline__ int warp_lower_bound(const int* a, int n, int x,
                                                int lane) {
    int lo = 0, hi = n;   // the answer lies in [lo, hi]
    while (hi - lo > 32) {
        const long long span = hi - lo;
        const int pos = lo + (int)(span * (lane + 1) / 33);
        const unsigned below = __ballot_sync(0xffffffffu, a[pos] < x);
        const int c = __popc(below);    // pivots below x: lanes 0..c-1
        const int nlo = c ? lo + (int)(span * c / 33) + 1 : lo;
        hi = c < 32 ? lo + (int)(span * (c + 1) / 33) : hi;
        lo = nlo;
    }
    const bool in = lane < hi - lo && a[lo + lane] < x;
    return lo + __popc(__ballot_sync(0xffffffffu, in));
}

// the last u in [0, n) with a[u] <= k (a ascending, a[0] = 0 <= k)
__device__ __forceinline__ int last_le(const int* a, int n, long long k) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a[mid] <= k) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// Doc tiles (merge_docs.cu, merge_special.cu): the bracket of each of
// one query's term blocks (docid-ascending, SENTINEL rows last) in the
// docid range [lo, lo + tile), lo = j * tile, of tile j of nt. 3T
// searches: the first SENTINEL row, the first row at or past lo (row 0 in
// the first tile, which also takes the rows below its range) and past
// lo + tile (the first SENTINEL in the last tile, which takes every real
// row above its range: the probes' rows). A search is a chain of
// dependent loads, the tile's fixed cost: a warp a search (33-ary,
// ~log33 W loads) where the warps take them in two rounds or fewer, else a
// thread a search. Then one warp scans the counts. Out, in shared memory:
// a0[u] the bracket's first row, pr[0..T] the prefix of the brackets'
// rows (the tile's N = pr[T] rows: row k lies in term last_le(pr, T + 1,
// k), at row_off[u] + a0[u] + k - pr[u]), z0[u] where term u's SENTINEL
// rows start, ps[0..T] the prefix of their counts. Every thread of the
// block, NTH threads, calls it; it ends with a barrier. clear(), the
// caller's clearing of its tile's slots, runs between the searches and
// the barrier after them, so its stores overlap the searches' loads.
template <int NTH, class Clear>
__device__ __forceinline__ void tile_brackets(
    const int* __restrict__ ids, long long base,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int j, int nt, int tile, int* a0, int* pr, int* z0, int* ps,
    Clear clear) {
    const long long lo = (long long)j * tile;
    const bool by_warp = 3 * T <= 2 * (NTH / 32);
    const int lane = threadIdx.x & 31;
    for (int i = by_warp ? threadIdx.x >> 5 : threadIdx.x; i < 3 * T;
         i += by_warp ? NTH / 32 : NTH) {
        const int u = i % T, which = i / T;
        const int* blk = ids + base + row_off[u];
        const int W = widths[u];
        if (which == 1 && j == 0) {
            if (lane == 0 || !by_warp) a0[u] = 0;
            continue;
        }
        if (which == 2 && j == nt - 1) continue;
        const int x = which == 0 ? XT_SENTINEL
                                 : (int)(which == 1 ? lo : lo + tile);
        const int pos = by_warp ? warp_lower_bound(blk, W, x, lane)
                                : lower_bound_i32(blk, W, x);
        if (by_warp && lane) continue;
        if (which == 0) {
            z0[u] = pos;
            ps[u + 1] = W - pos;
        } else if (which == 1) {
            a0[u] = pos;
        } else {
            pr[u + 1] = pos;
        }
    }
    clear();
    __syncthreads();
    if (threadIdx.x < 32) {
        const unsigned full = 0xffffffffu;
        int c1 = 0, c2 = 0;
        for (int v0 = 0; v0 < T; v0 += 32) {
            const int u = v0 + lane;
            int x = 0, y = 0;
            if (u < T) {
                x = (j == nt - 1 ? z0[u] : pr[u + 1]) - a0[u];
                y = ps[u + 1];
            }
            for (int o = 1; o < 32; o <<= 1) {
                const int xs = __shfl_up_sync(full, x, o);
                const int ys = __shfl_up_sync(full, y, o);
                if (lane >= o) {
                    x += xs;
                    y += ys;
                }
            }
            if (u < T) {
                pr[u + 1] = x + c1;
                ps[u + 1] = y + c2;
            }
            c1 += __shfl_sync(full, x, 31);
            c2 += __shfl_sync(full, y, 31);
        }
        if (lane == 0) {
            pr[0] = 0;
            ps[0] = 0;
        }
    }
    __syncthreads();
}

// K6: the static boolean tree (xapiand_tpu/ops/executor.py _eval_tree
// 249-282) compiled on the host into a postfix program of int32
// instructions, op | arg << 8 (ops/kernels.py tree_program). It runs per
// row on a stack of bits held in one 64-bit register: tree_program emits
// each node's deepest child first (NOTAND is AND_NOT with its operands
// swapped on the stack), so a tree of L leaves needs at most
// floor(log2 L) + 1 bits, whatever its depth. G pushes bit `arg` of the row's OR of group bits, F the
// row's result of filter leaf `arg` (fleaf(arg): filter_leaves.cu computes
// it where the program reads it, so a plan may hold any number of
// filters), PH bit `arg` of the row's phrase verdicts (phrase_leaves.cu),
// GEO bit `arg` of the row's geo verdicts (geo_leaves.cu).
#define XT_OP_G 0
#define XT_OP_F 1
#define XT_OP_ALL 2
#define XT_OP_NONE 3
#define XT_OP_AND 4
#define XT_OP_OR 5
#define XT_OP_XOR 6
#define XT_OP_ANDNOT 7
#define XT_OP_PH 8
#define XT_OP_GEO 9
#define XT_OP_NOTAND 10

// The program's instruction i is ins(i): an __ldg of a program in global
// memory (eval_tree), or a read of one staged in shared memory
// (eval_tree_staged, filter_leaves.cu).
template <class Ins, class FLeaf>
__device__ __forceinline__ int eval_program(const Ins& ins_at, int n,
                                            unsigned orbits,
                                            const FLeaf& fleaf,
                                            unsigned phbits,
                                            unsigned geobits) {
    unsigned long long st = 0;
    for (int i = 0; i < n; ++i) {
        const int ins = ins_at(i);
        const int op = ins & 0xff, arg = ins >> 8;
        if (op == XT_OP_G) {
            st = (st << 1) | ((orbits >> arg) & 1u);
        } else if (op == XT_OP_F) {
            st = (st << 1) | (fleaf(arg) ? 1ull : 0ull);
        } else if (op == XT_OP_PH) {
            st = (st << 1) | ((phbits >> arg) & 1u);
        } else if (op == XT_OP_GEO) {
            st = (st << 1) | ((geobits >> arg) & 1u);
        } else if (op == XT_OP_ALL) {
            st = (st << 1) | 1ull;
        } else if (op == XT_OP_NONE) {
            st = st << 1;
        } else {
            const unsigned long long b = st & 1ull, a = (st >> 1) & 1ull;
            unsigned long long r;
            if (op == XT_OP_AND) r = a & b;
            else if (op == XT_OP_OR) r = a | b;
            else if (op == XT_OP_XOR) r = a ^ b;
            else if (op == XT_OP_ANDNOT) r = a & (b ^ 1ull);
            else r = b & (a ^ 1ull);
            st = ((st >> 2) << 1) | r;
        }
    }
    return (int)(st & 1ull);
}

template <class FLeaf>
__device__ __forceinline__ int eval_tree(const int* __restrict__ prog, int n,
                                         unsigned orbits, const FLeaf& fleaf,
                                         unsigned phbits, unsigned geobits) {
    return eval_program([prog](int i) { return __ldg(prog + i); }, n,
                        orbits, fleaf, phbits, geobits);
}

template <class FLeaf>
__device__ __forceinline__ int eval_tree_staged(const int* prog, int n,
                                                unsigned orbits,
                                                const FLeaf& fleaf,
                                                unsigned phbits,
                                                unsigned geobits) {
    return eval_program([prog](int i) { return prog[i]; }, n, orbits, fleaf,
                        phbits, geobits);
}

// a program without F leaves (merge_docs, dense_rows): the filter word 0
struct NoFilters {
    __device__ bool operator()(int) const { return false; }
};

__device__ __forceinline__ int eval_tree(const int* __restrict__ prog, int n,
                                         unsigned orbits, unsigned,
                                         unsigned phbits, unsigned geobits) {
    return eval_tree(prog, n, orbits, NoFilters{}, phbits, geobits);
}

// The slot hash of the open-addressed sets of 64-bit keys (collapse_rows.cu,
// agg_distinct.cu): murmur3's 64-bit finalizer.
__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ull;
    x ^= x >> 33;
    return x;
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

// the 16 flags of a 16-byte load, bit j byte j's
__device__ __forceinline__ unsigned mask16_of(uint4 w) {
    const unsigned x[4] = {w.x, w.y, w.z, w.w};
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        m |= (((x[i] & 0x01010101u) * 0x01020408u) >> 24) << (4 * i);
    return m;
}

// Rows of one query that are eligible, 16 at a time: bit j of the result
// is row 16 * g + j's flag (torch bool bytes are 0 or 1). Aligned rows
// are one 16-byte load; a misaligned row start or the ragged end reads
// byte by byte. agg_buckets.cu tests these masks first and gathers value
// columns for the set bits only.
__device__ __forceinline__ unsigned elig_mask16(const unsigned char* e,
                                                long long R, long long g,
                                                bool aligned) {
    const long long r0 = g * 16;
    if (aligned && r0 + 16 <= R)
        return mask16_of(__ldg(reinterpret_cast<const uint4*>(e + r0)));
    unsigned m = 0;
    for (int j = 0; j < 16 && r0 + j < R; ++j)
        if (e[r0 + j]) m |= 1u << j;
    return m;
}

// Flags of a [B, R] bool array on the flat row index, 16 at a time: group
// g holds flat rows 16 g .. 16 g + 15, and query b owns the flat rows
// [lo, hi) = [b R, b R + R). Bit j of the result is flat row 16 g + j's
// flag where that row lies in [lo, hi). Whatever R is, every group that
// lies inside its query is one aligned 16-byte load (``full``: the array
// is 16-byte aligned and the group inside [lo, hi)); the group a query
// shares with its neighbour reads its own bytes one by one.
__device__ __forceinline__ bool flat_full(long long g, long long lo,
                                          long long hi, bool aligned) {
    return aligned && g * 16 >= lo && g * 16 + 16 <= hi;
}

__device__ __forceinline__ unsigned flat_mask16(const unsigned char* e,
                                                long long lo, long long hi,
                                                long long g, bool full) {
    const long long r0 = g * 16;
    if (full)
        return mask16_of(__ldg(reinterpret_cast<const uint4*>(e + r0)));
    unsigned m = 0;
    for (int j = 0; j < 16; ++j) {
        const long long r = r0 + j;
        if (r >= lo && r < hi && e[r]) m |= 1u << j;
    }
    return m;
}

// flat_mask16's bytes before their mask (mask16_of), so that the load of
// a group can be issued a step before its flags are read: the 16-byte
// load where the group lies inside [lo, hi), else the group's bytes one
// by one (those outside [lo, hi) as 0)
__device__ __forceinline__ uint4 flat_load16(const unsigned char* e,
                                             long long lo, long long hi,
                                             long long g, bool aligned) {
    const long long r0 = g * 16;
    if (flat_full(g, lo, hi, aligned))
        return __ldg(reinterpret_cast<const uint4*>(e + r0));
    unsigned x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const long long r = r0 + j;
        if (r >= lo && r < hi && e[r]) x[j >> 2] |= 1u << (8 * (j & 3));
    }
    return make_uint4(x[0], x[1], x[2], x[3]);
}

// Warp row queues (agg_metrics.cu, agg_ranges.cu, agg_hist.cu,
// fullwidth_topk.cu). Query b's rows are the
// flat rows [lo, hi) = [b R, b R + R) of the [B, R] eligible flags; a
// block walks the flat 16-row groups [q0, q1) of its share, and each of
// its NW warps takes gpw groups a step (1 <= gpw <= 32: a block of few
// rows still gives every warp some), a lane l < gpw a group: its flags one
// 16-byte load (flat_load16; the next step's issued before this step's
// are read), their count (__popc) added to the lane's, and, with QUEUE,
// the step's eligible rows (row numbers within the query) pushed in row
// order onto the warp's queue in shared memory (a warp prefix sum of the
// lanes' counts). Whenever 32 rows or more wait, drain(n) takes the first
// n, a multiple of 32, and the others move to the front; after the last
// step drain(n) takes what is left (n < 32, maybe 0). each(gi, msk) sees
// every lane's group (gi >= q1, with msk 0, for a lane without one). The
// first step's flags are wrq_first's, which a kernel issues before its
// block's set-up. span > 1 interleaves span blocks a query: the block whose
// share starts at q0 = f0 + g NW gpw walks every span-th step of the
// query's groups [f0, q1) (fullwidth_topk.cu). -> the lane's count of
// eligible rows.
#define RQ_CAP 544   // a warp's queue: 31 rows left over and a step's 512

__device__ __forceinline__ uint4 wrq_first(const unsigned char* e,
                                           long long lo, long long hi,
                                           long long q0, long long q1,
                                           int gpw, int warp, int lane) {
    const long long gi = lane < gpw ? q0 + warp * gpw + lane : q1;
    return gi < q1 ? flat_load16(e, lo, hi, gi,
                                 (reinterpret_cast<uintptr_t>(e) & 15) == 0)
                   : make_uint4(0u, 0u, 0u, 0u);
}

template <int NW, bool QUEUE, class Each, class Drain>
__device__ __forceinline__ int warp_row_queue(
    const unsigned char* __restrict__ e, long long lo, long long hi,
    long long q0, long long q1, int gpw, int warp, int lane, uint4 next,
    int* queue, Each&& each, Drain&& drain, long long span = 1) {
    const bool aligned = (reinterpret_cast<uintptr_t>(e) & 15) == 0;
    int cnt = 0, qn = 0;
    const long long stride = (long long)NW * gpw * span;
    long long gi = lane < gpw ? q0 + warp * gpw + lane : q1;
    for (long long gs = q0 + warp * gpw; gs < q1; gs += stride) {
        const unsigned msk = mask16_of(next);
        const long long gn = lane < gpw ? gi + stride : q1;
        next = gn < q1 ? flat_load16(e, lo, hi, gn, aligned)
                       : make_uint4(0u, 0u, 0u, 0u);
        const int k = __popc(msk);
        cnt += k;
        each(gi, msk);
        if constexpr (QUEUE) {
            int incl = k;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += x;
            }
            const int total = __shfl_sync(0xffffffffu, incl, 31);
            int pos = qn + incl - k;
            for (unsigned m = msk; m; m &= m - 1)
                queue[pos++] = (int)(gi * 16 + __ffs(m) - 1 - lo);
            qn += total;
            __syncwarp();
            if (qn >= 32) {
                const int full = qn & ~31;
                drain(full);
                const int rest = qn - full;
                const int moved = lane < rest ? queue[full + lane] : 0;
                __syncwarp();
                if (lane < rest) queue[lane] = moved;
                qn = rest;
                __syncwarp();
            }
        }
        gi = gn;
    }
    if constexpr (QUEUE) drain(qn);
    return cnt;
}

// The G blocks' partials p[k * stride] (k < G) of one output of a query,
// folded by the last block in a fixed order. Few outputs (lanes 32): a
// warp an output, lane l taking blocks l, l + 32, ... in order from the
// identity, then an xor shuffle tree; many (lanes 1): a thread an output,
// the blocks in order. op: 0 sum, 1 min, 2 max. -> the fold (every lane).
__device__ __forceinline__ float fold_blocks(const float* p, long long stride,
                                             int G, int op, int lanes,
                                             int lane) {
    const float inf = __int_as_float(0x7f800000);
    float a = op == 0 ? 0.0f : (op == 1 ? inf : -inf);
#pragma unroll 4
    for (int k = lanes == 32 ? lane : 0; k < G; k += lanes) {
        const float x = __ldcg(p + k * stride);
        a = op == 0 ? a + x : (op == 1 ? fminf(a, x) : fmaxf(a, x));
    }
    if (lanes == 32) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float x = __shfl_xor_sync(0xffffffffu, a, o);
            a = op == 0 ? a + x : (op == 1 ? fminf(a, x) : fmaxf(a, x));
        }
    }
    return a;
}

__device__ __forceinline__ int fold_counts(const int* p, long long stride,
                                           int G, int lanes, int lane) {
    int a = 0;
#pragma unroll 4
    for (int k = lanes == 32 ? lane : 0; k < G; k += lanes)
        a += __ldcg(p + k * stride);
    if (lanes == 32) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, o);
    }
    return a;
}

// the lanes an output of the last block's fold: a warp an output where a
// query has at most FOLD_WARP_OUTS of them, else a thread
#define FOLD_WARP_OUTS 64
__host__ __device__ inline int fold_lanes(long long outputs) {
    return outputs <= FOLD_WARP_OUTS ? 32 : 1;
}

// the share [q0, q1) of block g of G of query b's flat 16-row groups
__device__ __forceinline__ void row_share(long long R, int b, int g, int G,
                                          long long& q0, long long& q1) {
    const long long f0 = (long long)b * R / 16;
    const long long f1 = ((long long)b * R + R + 15) / 16;
    q0 = f0 + (f1 - f0) * g / G;
    q1 = f0 + (f1 - f0) * (g + 1) / G;
}

// ---------------------------------------------------------------------
// Sort keys (K8 sort_topk, K9 fullwidth_topk): xapiand_tpu/ops/
// executor.py _rank_and_topk 487-559 builds one key per sort spec; here
// each row's key is a list of 32-bit words whose unsigned order is
// lax.sort's order:
//   value      (hi, lo), both complemented when descending; then hi :=
//              INT32_MAX where the value is absent, lo left as it is;
//   score      +-score;
//   dist       |fval - target|, +inf where absent, negated when descending;
//   geodist    _haversine(lat, lon, target), same rules;
//   strmetric  the query's table at the doc's category code, +inf without
//              a code, negated when descending; on the mesh the code is
//              first mapped through the shard's sort_cat_remap row
//              (executor.py:549-553);
//   docid      the docid (unweighted plans with no sort);
// every key of an ineligible row is INT32_MAX or +inf; then the masked
// docid (SENTINEL when ineligible). Int words are x ^ 0x80000000; float
// words follow lax.sort's total order (-0.0 equals +0.0, NaN after +inf).
// A last word, the row index, makes every key unique: the rows lax.sort
// may leave in any order are ineligible rows with equal keys, whose
// payloads (SENTINEL, -inf) are equal too, so the result is the same.
#define ST_VALUE 0
#define ST_SCORE 1
#define ST_DIST 2
#define ST_GEODIST 3
#define ST_STRMETRIC 4
#define ST_DOCID 5
// column table, int64 per spec: hi, lo, present, fval, fval2, cats,
// strtab (device pointers, 0 when absent), n_rows (0: the segment lacks
// the slot), the strmetric code remap (a device pointer, 0 without one)
// and its length
#define ST_COLS 10

__device__ __forceinline__ unsigned ikey(int x) {
    return (unsigned)x ^ 0x80000000u;
}

__device__ __forceinline__ unsigned fkey(float x) {
    if (x != x) return 0xffc00000u;    // canonical NaN, after +inf
    if (x == 0.0f) x = 0.0f;            // -0.0 sorts equal to +0.0
    const unsigned u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// _haversine (executor.py:406-413), in its float32 operation order
__device__ __forceinline__ float haversine(float lat, float lon, float lat0,
                                           float lon0) {
    const float r = 0.017453292519943295f;   // jnp.pi / 180.0
    const float dlat = (lat - lat0) * r * 0.5f;
    const float dlon = (lon - lon0) * r * 0.5f;
    const float s1 = sinf(dlat), s2 = sinf(dlon);
    const float a = s1 * s1 + (cosf(lat * r) * cosf(lat0 * r)) * (s2 * s2);
    return 12742017.6f * asinf(sqrtf(fminf(fmaxf(a, 0.0f), 1.0f)));
}

// a < b over NK key words
template <int NK>
__device__ __forceinline__ bool key_lt(const unsigned* a, const unsigned* b) {
#pragma unroll
    for (int i = 0; i < NK; ++i)
        if (a[i] != b[i]) return a[i] < b[i];
    return false;
}

// An ineligible row's word for a spec of this kind: INT32_MAX (value,
// docid) or +inf (the float kinds), as ikey / fkey give them.
__device__ __forceinline__ unsigned spec_const(int kind) {
    return (kind == ST_VALUE || kind == ST_DOCID) ? 0xffffffffu : 0xff800000u;
}

// Word `half` (1: a value spec's lo word, else 0) of sort spec s for an
// eligible row of docid d in query b. spec holds (kind, desc, nb, 0), c
// the spec's ST_COLS column words; sc points at the row's score and is
// read by a score key only; targets f32[B][S][2] by dist and geodist.
// KIND: the spec's kind where the caller knows it (the other kinds' code
// then drops out), else -1 (read from spec).
template <int KIND = -1>
__device__ __forceinline__ unsigned spec_word(
    const int* spec, const long long* c, const float* targets, int S,
    int s, int b, int d, const float* sc, int half) {
    const int kind = KIND >= 0 ? KIND : spec[0];
    const int desc = spec[1], nb = spec[2];
    const float inf = __int_as_float(0x7f800000);
    const long long n = c[7];
    const long long dd = n > 0 ? ((long long)d < n - 1 ? (long long)d
                                                       : n - 1) : 0;
    if (kind == ST_VALUE) {
        if (half) {
            const int l = n > 0 ? ((const int*)c[1])[dd] : XT_I32MAX;
            return ikey(desc ? ~l : l);
        }
        int h = XT_I32MAX;
        bool pr = false;
        if (n > 0) {
            h = ((const int*)c[0])[dd];
            pr = ((const unsigned char*)c[2])[dd] != 0;
        }
        if (desc) h = ~h;
        return ikey(pr ? h : XT_I32MAX);
    }
    if (kind == ST_DOCID) return ikey(d);
    float kf;
    if (kind == ST_SCORE) {
        kf = desc ? -*sc : *sc;
    } else if (kind == ST_STRMETRIC) {
        int code = (n > 0 && c[5]) ? ((const int*)c[5])[dd] : -1;
        if (c[8] && code >= 0) {
            const long long m = c[9];
            code = ((const int*)c[8])[code < m - 1 ? code : m - 1];
        }
        const float* tab = (const float*)c[6] + (long long)b * nb;
        kf = tab[code < 0 ? 0 : (code > nb - 1 ? nb - 1 : code)];
        if (code < 0) kf = inf;
        if (desc) kf = -kf;
    } else {
        const bool pr = n > 0 && ((const unsigned char*)c[2])[dd] != 0;
        const float* tg = targets + ((long long)b * S + s) * 2;
        const float v = n > 0 ? ((const float*)c[3])[dd] : 0.0f;
        if (kind == ST_DIST) {
            kf = fabsf(v - tg[0]);
        } else {
            const float lon = (n > 0 && c[4]) ? ((const float*)c[4])[dd]
                                              : 0.0f;
            kf = haversine(v, lon, tg[0], tg[1]);
        }
        if (!pr) kf = inf;
        if (desc) kf = -kf;
    }
    return fkey(kf);
}

// Keep the stream-ordered pool's memory between calls (the scratch of the
// two-stage top-k kernels, cudaMallocAsync on the stream): by default the
// pool hands it back at every synchronisation, and the next call would map
// it anew. The scratch is a few MB; nothing else of the port allocates
// from this pool.
static inline void keep_stream_pool() {
    static bool done[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64 ||
        done[dev])
        return;
    cudaMemPool_t pool;
    if (cudaDeviceGetDefaultMemPool(&pool, dev) == cudaSuccess) {
        unsigned long long keep = 64ull << 20;
        cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
    }
    done[dev] = true;
}
