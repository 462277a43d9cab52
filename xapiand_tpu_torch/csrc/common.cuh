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

// K6: the static boolean tree (xapiand_tpu/ops/executor.py _eval_tree
// 249-282) compiled on the host into a postfix program of int32
// instructions, op | arg << 8 (ops/kernels.py tree_program). It runs per
// row on a stack of bits held in one register (depth <= 32, checked on the
// host): G pushes bit `arg` of the row's OR of group bits, F bit `arg` of
// the row's filter results, PH bit `arg` of the row's phrase verdicts
// (phrase_leaves.cu), GEO bit `arg` of the row's geo verdicts
// (geo_leaves.cu).
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

__device__ __forceinline__ int eval_tree(const int* __restrict__ prog, int n,
                                         unsigned orbits, unsigned fbits,
                                         unsigned phbits, unsigned geobits) {
    unsigned st = 0;
    for (int i = 0; i < n; ++i) {
        const int ins = __ldg(prog + i);
        const int op = ins & 0xff, arg = ins >> 8;
        if (op == XT_OP_G) {
            st = (st << 1) | ((orbits >> arg) & 1u);
        } else if (op == XT_OP_F) {
            st = (st << 1) | ((fbits >> arg) & 1u);
        } else if (op == XT_OP_PH) {
            st = (st << 1) | ((phbits >> arg) & 1u);
        } else if (op == XT_OP_GEO) {
            st = (st << 1) | ((geobits >> arg) & 1u);
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

// Rows of one query that are eligible, 16 at a time: bit j of the result
// is row 16 * g + j's flag (torch bool bytes are 0 or 1). Aligned rows
// are one 16-byte load; a misaligned row start or the ragged end reads
// byte by byte. The aggregation and fullwidth kernels test these masks
// first and gather value columns for the set bits only.
__device__ __forceinline__ unsigned elig_mask16(const unsigned char* e,
                                                long long R, long long g,
                                                bool aligned) {
    const long long r0 = g * 16;
    if (aligned && r0 + 16 <= R) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(e + r0));
        const unsigned x[4] = {w.x, w.y, w.z, w.w};
        unsigned m = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            m |= (((x[i] & 0x01010101u) * 0x01020408u) >> 24) << (4 * i);
        return m;
    }
    unsigned m = 0;
    for (int j = 0; j < 16 && r0 + j < R; ++j)
        if (e[r0 + j]) m |= 1u << j;
    return m;
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
//              a code, negated when descending;
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
// the slot)
#define ST_COLS 8
#define ST_THREADS 256

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

// the key words of row r (of the query whose rows start at base) for the
// S sort specs, then the masked docid, then r
template <int NK>
__device__ __forceinline__ void row_key(
    int r, long long base, int b, const int* __restrict__ ids,
    const float* __restrict__ sums, const unsigned char* __restrict__ elig,
    int S, const int* __restrict__ spec, const long long* __restrict__ cols,
    const float* __restrict__ targets, unsigned* key) {
    const int d = ids[base + r];
    const bool el = elig[base + r] != 0;
    const float sc = sums[base + r];
    const float inf = __int_as_float(0x7f800000);
    int pos = 0;
    for (int s = 0; s < S; ++s) {
        const int kind = spec[s * 4], desc = spec[s * 4 + 1];
        const int nb = spec[s * 4 + 2];
        const long long* c = cols + s * ST_COLS;
        const long long n = c[7];
        const long long dd = n > 0 ? ((long long)d < n - 1 ? (long long)d
                                                           : n - 1) : 0;
        if (kind == ST_VALUE) {
            int h = XT_I32MAX, l = XT_I32MAX;
            bool pr = false;
            if (n > 0) {
                h = ((const int*)c[0])[dd];
                l = ((const int*)c[1])[dd];
                pr = ((const unsigned char*)c[2])[dd] != 0;
            }
            if (desc) {
                h = ~h;
                l = ~l;
            }
            if (!pr) h = XT_I32MAX;
            key[pos++] = ikey(el ? h : XT_I32MAX);
            key[pos++] = ikey(el ? l : XT_I32MAX);
        } else if (kind == ST_DOCID) {
            key[pos++] = ikey(el ? d : XT_SENTINEL);
        } else {
            float kf;
            if (kind == ST_SCORE) {
                kf = desc ? -sc : sc;
            } else if (kind == ST_STRMETRIC) {
                const int code = (n > 0 && c[5]) ? ((const int*)c[5])[dd]
                                                 : -1;
                const float* tab = (const float*)c[6] + (long long)b * nb;
                kf = tab[code < 0 ? 0 : (code > nb - 1 ? nb - 1 : code)];
                if (code < 0) kf = inf;
                if (desc) kf = -kf;
            } else {
                const bool pr = n > 0 &&
                                ((const unsigned char*)c[2])[dd] != 0;
                const float* tg = targets + ((long long)b * S + s) * 2;
                const float v = n > 0 ? ((const float*)c[3])[dd] : 0.0f;
                if (kind == ST_DIST) {
                    kf = fabsf(v - tg[0]);
                } else {
                    const float lon = (n > 0 && c[4])
                        ? ((const float*)c[4])[dd] : 0.0f;
                    kf = haversine(v, lon, tg[0], tg[1]);
                }
                if (!pr) kf = inf;
                if (desc) kf = -kf;
            }
            key[pos++] = fkey(el ? kf : inf);
        }
    }
    key[pos++] = ikey(el ? d : XT_SENTINEL);
    key[pos] = (unsigned)r;
}

