// agg_ranges: per query, the count of eligible rows in each of nb ranges
// where a row may lie in several (top-level ranges count every match), and
// for each metric sub-aggregation the per-range n / sum / sum of squares /
// min / max.
//
// Replaces (TPU): xapiand_tpu/ops/aggs.py compute_aggs (K17c), the range
// and geodist_range branch 396-423 (float bounds [lo, hi) on the value,
// or on _haversine's distance from an origin, executor.py:406-413), the
// key_range branch 324-343 and the geo_ip branch 344-371, both through
// _key_ranges_membership 77-104 (a doc is in a key interval when its
// [min, max] key pair overlaps it and, for a doc of >= 2 values, one of
// its first vmax per-value keys lies in it); geo_ip's one-hot product of
// interval hits by bucket (:364-366) is an OR over each bucket's
// intervals here. With their metric sub-aggregations _sub_stats_bucketed
// 107-155 (n, s, s2, min, max).
//
// A row r of query b, d = min(ids[b, r], n - 1), is in range j when
// eligible[b, r], present[d], and:
//   mode 0 range    lo_j <= fval[d] < hi_j
//   mode 1 geodist  lo_j <= haversine(fval[d], fval2[d] or 0, origin) < hi_j
//   mode 2 key      the key interval j holds one of the doc's values
//   mode 3 geo_ip   some interval i with assign[i] == j holds one
// The key modes read the doc's four key words as one 16-byte gather of
// the column's packed keys (models/segment.py value_arrays: present iff
// min <= max, an absent doc the empty interval).
//
// One launch, grid (G, B), 256 threads, a kernel a mode. G and gpw come
// from kernels.ranges_plan (blocks of a few thousand rows; where the
// queries are few, blocks of fewer, gpw 16-row groups a warp a step, so
// that the card is filled: the Database path's launches are B 1). Each
// block stages
// the query's ranges in shared memory (geo_ip: its intervals grouped by
// bucket, a counting sort by assign, so that a bucket stops at its first
// hit); the rows are walked by common.cuh warp_row_queue (the flags first,
// a 16-byte load a lane, the eligible rows queued in row order) and
// drained 32 at a time, a row a lane, AR_U batches in flight: a lane
// gathers its row's docid, then its value (fval, fval and fval2, or the
// key words and the doc's first AR_VMAX per-value keys) and each sub's
// value once, and tests it against every range.
//   counts  a shared-memory histogram, an int atomic a (row, range);
//   subs    for each batch and range, the member lanes' values summed in
//           lane order and added by lane 0 to the warp's partial of the
//           range (in shared memory up to AR_WP_SMEM floats, else a device
//           scratch of the wrapper's); after the rows, the warps in order;
//   fold    the block's counts and partials to device memory, a ticket on a
//           counter a query (after __threadfence); the last block folds
//           the G blocks' into the outputs (common.cuh fold_blocks: a warp
//           an output, lane l taking blocks l, l + 32, ... in order, then
//           an xor tree, where a query has at most 64 outputs; else a
//           thread an output, the blocks in order) and sets the counter
//           back to 0 (one block: straight to the outputs). Every sum runs
//           in a fixed order, so two runs give the same bits; no float
//           atomics.
//   member  with want_member only (agg_hist's hist2 of a geo_ip median):
//           a byte a (row, range), 0 for the rows that are not eligible.
//
// Bound on the H100: one byte of eligible flags a row and, per eligible
// row, its docid and value (key modes: 16 bytes, and vmax per-value keys
// for a doc of several values), each sub's value, and a test per range
// (geo_ip: per interval, up to a bucket's first hit).
#include "common.cuh"

#define AR_THREADS 256
#define AR_WARPS (AR_THREADS / 32)
#define AR_MAXNB 4096
#define AR_FULL 0xffffffffu
#define AR_WP_SMEM (12 * 1024)   // as agg_buckets.cu's AB_WP_SMEM
#define AR_SUBS 4                // subs whose values a lane gathers ahead
#define AR_VMAX 4                // per-value keys a lane gathers ahead
#ifndef AR_U
#define AR_U 2                   // queued rows a lane in flight
#endif

struct RangeSrc {
    const float* fval;
    const float* fval2;           // geodist: null reads a longitude of 0
    const unsigned char* present;
    const int4* keys;             // key modes: (hi, lo, max_hi, max_lo)
    const int* mv_off;            // per-value keys (null: none)
    const int* mv_len;
    const int* mv_hi;
    const int* mv_lo;
    long long n;                  // rows of the value columns
    long long nmv;                // rows of mv_hi / mv_lo
    int vmax;
    const float* fb;              // [B][nr][2] float bounds
    const int* kb;                // [B][nr][4] key bounds (hi, lo, hi, lo)
    const int* assign;            // [B][nr] geo_ip: interval -> bucket
    const float* origin;          // [B][2] geodist: lat, lon
    int nr;                       // ranges (geo_ip: intervals)
};

__host__ __device__ inline bool ar_wp_shared(int nb, int S) {
    return (long long)AR_WARPS * S * nb * 5 <= AR_WP_SMEM;
}

// the ints of the staged ranges: float bounds, or key bounds and, for
// geo_ip, each bucket's first interval (nb + 1)
__host__ __device__ inline int ar_bound_ints(int mode, int nr, int nb) {
    return mode <= 1 ? 2 * nr : 4 * nr + (mode == 3 ? nb + 1 : 0);
}

// the shared memory of a launch: the staged ranges (first, 16-byte
// aligned), the counts, the warps' queues, the warps' sub partials where
// they fit
__host__ __device__ inline int ar_smem(int mode, int nr, int nb, int S) {
    const int bi = (ar_bound_ints(mode, nr, nb) + 3) & ~3;
    return 4 * bi + 4 * nb + 4 * AR_WARPS * RQ_CAP +
           (S > 0 && ar_wp_shared(nb, S) ? 4 * AR_WARPS * S * nb * 5 : 0);
}

// _key_ranges_membership of a doc (its key words w; mvc per-value keys,
// the first AR_VMAX of them in mh / ml, the rest from mvo on) in the
// interval k (hi, lo, hi, lo)
__device__ __forceinline__ bool key_in(const RangeSrc& s, int4 w, int mvo,
                                       int mvc, const int* mh, const int* ml,
                                       int4 k) {
    if (!(lex_ge(w.z, w.w, k.x, k.y) && lex_le(w.x, w.y, k.z, k.w)))
        return false;
    if (mvc == 0) return true;
#pragma unroll
    for (int v = 0; v < AR_VMAX; ++v)
        if (v < s.vmax && v < mvc && lex_ge(mh[v], ml[v], k.x, k.y) &&
            lex_le(mh[v], ml[v], k.z, k.w))
            return true;
    for (int v = AR_VMAX; v < s.vmax && v < mvc; ++v) {
        long long i = (long long)mvo + v;
        if (i > s.nmv - 1) i = s.nmv - 1;
        const int h = __ldg(s.mv_hi + i), l = __ldg(s.mv_lo + i);
        if (lex_ge(h, l, k.x, k.y) && lex_le(h, l, k.z, k.w)) return true;
    }
    return false;
}

// bstart[0..nb] = the exclusive prefix sums of cnt[0..nb) (every thread
// of the block calls it)
__device__ void ar_scan(const int* cnt, int* bstart, int nb) {
    __shared__ int wsum[AR_WARPS];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int per = (nb + AR_THREADS - 1) / AR_THREADS;
    const int j0 = min(t * per, nb), j1 = min(j0 + per, nb);
    int s = 0;
    for (int j = j0; j < j1; ++j) s += cnt[j];
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(AR_FULL, incl, o);
        if (lane >= o) incl += x;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int run = incl - s;
    for (int w = 0; w < warp; ++w) run += wsum[w];
    for (int j = j0; j < j1; ++j) {
        bstart[j] = run;
        run += cnt[j];
    }
    if (t == AR_THREADS - 1) bstart[nb] = run;
    __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(AR_THREADS) agg_ranges_kernel(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    long long R, int G, int gpw, const RangeSrc src, int nb, int S,
    const long long* __restrict__ subs, int* __restrict__ counts,
    unsigned char* __restrict__ member, float* __restrict__ part,
    int* __restrict__ pcount, int* __restrict__ ctr, float* __restrict__ out,
    float* __restrict__ wpg) {
    extern __shared__ int4 ar_sm4[];
    int* sm = reinterpret_cast<int*>(ar_sm4);
    const int nr = src.nr;
    const int bi = (ar_bound_ints(MODE, nr, nb) + 3) & ~3;
    float* fbs = reinterpret_cast<float*>(sm);        // [nr][2]
    int4* kbs = ar_sm4;                               // [nr]
    int* bstart = sm + 4 * nr;                        // [nb + 1] (geo_ip)
    int* hist = sm + bi;                              // [nb]
    const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5, B = gridDim.y;
    int* queue = hist + nb + warp * RQ_CAP;
    const long long wstride = (long long)S * nb * 5;
    const bool wsh = ar_wp_shared(nb, S);
    float* wp = wsh ? reinterpret_cast<float*>(hist + nb + AR_WARPS * RQ_CAP)
                          + warp * wstride
                    : wpg + (((long long)b * G + g) * AR_WARPS + warp) *
                                wstride;
    __shared__ bool last;
    const long long base = (long long)b * R;
    const float inf = __int_as_float(0x7f800000);
    // the first step's flags in flight while the block stages its ranges
    long long q0, q1;
    row_share(R, b, g, G, q0, q1);
    const uint4 first = wrq_first(elig, base, base + R, q0, q1, gpw, warp,
                                  lane);
    // the query's ranges
    if (MODE <= 1) {
        const float* f = src.fb + (long long)b * nr * 2;
        for (int i = t; i < 2 * nr; i += AR_THREADS) fbs[i] = f[i];
    } else if (MODE == 2) {
        const int* k = src.kb + (long long)b * nr * 4;
        for (int i = t; i < nr; i += AR_THREADS)
            kbs[i] = make_int4(k[4 * i], k[4 * i + 1], k[4 * i + 2],
                               k[4 * i + 3]);
    } else {
        // geo_ip: the intervals grouped by bucket (a counting sort by
        // assign; an interval of no bucket dropped)
        const int* as = src.assign + (long long)b * nr;
        const int* k = src.kb + (long long)b * nr * 4;
        for (int c = t; c < nb; c += AR_THREADS) hist[c] = 0;
        __syncthreads();
        for (int i = t; i < nr; i += AR_THREADS) {
            const int a = as[i];
            if (a >= 0 && a < nb) atomicAdd(&hist[a], 1);
        }
        __syncthreads();
        ar_scan(hist, bstart, nb);
        for (int c = t; c < nb; c += AR_THREADS) hist[c] = bstart[c];
        __syncthreads();
        for (int i = t; i < nr; i += AR_THREADS) {
            const int a = as[i];
            if (a >= 0 && a < nb)
                kbs[atomicAdd(&hist[a], 1)] =
                    make_int4(k[4 * i], k[4 * i + 1], k[4 * i + 2],
                              k[4 * i + 3]);
        }
        __syncthreads();
    }
    for (int c = t; c < nb; c += AR_THREADS) hist[c] = 0;
    for (long long i = lane; i < wstride; i += 32)
        wp[i] = (i % 5) == 3 ? inf : ((i % 5) == 4 ? -inf : 0.0f);
    const float o0 = MODE == 1 ? src.origin[2 * b] : 0.0f;
    const float o1 = MODE == 1 ? src.origin[2 * b + 1] : 0.0f;
    const bool mv = MODE >= 2 && src.vmax > 1 && src.mv_hi != nullptr;
    __syncthreads();
    // one row of a batch (every lane of the warp together): its ranges,
    // counted; each sub's values of the range's member lanes summed in
    // lane order onto the warp's partial
    auto range_loop = [&](int row, int d, bool ok, float v, int4 w, int mvo,
                          int mvc, const int* mh, const int* ml,
                          const float* sv, const bool* sp) {
        unsigned char* mrow = member != nullptr && row >= 0
            ? member + (base + row) * nb : nullptr;
        for (int j = 0; j < nb; ++j) {
            bool in = false;
            if (ok) {
                if (MODE <= 1) {
                    in = v >= fbs[2 * j] && v < fbs[2 * j + 1];
                } else if (MODE == 2) {
                    in = key_in(src, w, mvo, mvc, mh, ml, kbs[j]);
                } else {
                    for (int i = bstart[j]; i < bstart[j + 1]; ++i)
                        if (key_in(src, w, mvo, mvc, mh, ml, kbs[i])) {
                            in = true;
                            break;
                        }
                }
            }
            if (in) atomicAdd(&hist[j], 1);
            if (mrow != nullptr) mrow[j] = in;
            if (S == 0 || !__ballot_sync(AR_FULL, in)) continue;
            for (int si = 0; si < S; ++si) {
                const float* fv = (const float*)__ldg(subs + si * 3);
                bool use = in;
                float x = 0.0f;
#pragma unroll
                for (int k = 0; k < AR_SUBS; ++k)
                    if (k == si) {
                        use = in && sp[k];
                        x = sv[k];
                    }
                if (si >= AR_SUBS && in && fv != nullptr) {
                    // past AR_SUBS: the sub's value gathered here
                    const unsigned char* pv =
                        (const unsigned char*)__ldg(subs + si * 3 + 1);
                    const long long nv = __ldg(subs + si * 3 + 2);
                    const long long ds = d < nv - 1 ? d : nv - 1;
                    use = __ldg(pv + ds) != 0;
                    x = __ldg(fv + ds);
                }
                const unsigned m = __ballot_sync(AR_FULL, use);
                float n_ = 0.0f, sm_ = 0.0f, sq = 0.0f, mn = inf, mx = -inf;
                for (unsigned mm = m; mm; mm &= mm - 1) {
                    const float y = __shfl_sync(AR_FULL, x, __ffs(mm) - 1);
                    n_ += 1.0f;
                    if (fv != nullptr) {
                        sm_ += y;
                        sq += y * y;
                        mn = fminf(mn, y);
                        mx = fmaxf(mx, y);
                    }
                }
                if (m && lane == 0) {
                    float* q = wp + ((long long)si * nb + j) * 5;
                    q[0] += n_;
                    q[1] += sm_;
                    q[2] += sq;
                    q[3] = fminf(q[3], mn);
                    q[4] = fmaxf(q[4], mx);
                }
                __syncwarp();
            }
        }
    };
    // U batches of 32 queued rows a round: the docids, then the values
    // (a doc's first AR_VMAX per-value keys among them) and the subs'
    // values, then each batch's ranges in turn
    auto drain = [&](int n) {
        for (int i0 = 0; i0 < n; i0 += 32 * AR_U) {
            int row[AR_U], d[AR_U];
#pragma unroll
            for (int u = 0; u < AR_U; ++u) {
                const int i = i0 + u * 32 + lane;
                row[u] = i < n ? queue[i] : -1;
                d[u] = row[u] >= 0 ? __ldg(ids + base + row[u]) : 0;
            }
            bool ok[AR_U];
            float v[AR_U], v2[AR_U];
            int4 w[AR_U];
            int mvo[AR_U], mvc[AR_U];
            int mh[AR_U][AR_VMAX], ml[AR_U][AR_VMAX];
            float sv[AR_U][AR_SUBS];
            bool sp[AR_U][AR_SUBS];
#pragma unroll
            for (int u = 0; u < AR_U; ++u) {
                const long long dd = d[u] < src.n - 1 ? d[u] : src.n - 1;
                ok[u] = false;
                v[u] = v2[u] = 0.0f;
                w[u] = make_int4(0, 0, 0, 0);
                mvo[u] = mvc[u] = 0;
                if (row[u] >= 0) {
                    if (MODE <= 1) {
                        ok[u] = __ldg(src.present + dd) != 0;
                        v[u] = __ldg(src.fval + dd);
                        if (MODE == 1 && src.fval2 != nullptr)
                            v2[u] = __ldg(src.fval2 + dd);
                    } else {
                        w[u] = __ldg(src.keys + dd);
                        if (mv) {
                            mvo[u] = __ldg(src.mv_off + dd);
                            mvc[u] = __ldg(src.mv_len + dd);
                        }
                    }
                }
#pragma unroll
                for (int si = 0; si < AR_SUBS; ++si) {
                    sv[u][si] = 0.0f;
                    sp[u][si] = false;
                    if (si < S && row[u] >= 0) {
                        const float* fv = (const float*)__ldg(subs + si * 3);
                        if (fv == nullptr) {
                            sp[u][si] = true;
                        } else {
                            const unsigned char* pv = (const unsigned char*)
                                __ldg(subs + si * 3 + 1);
                            const long long nv = __ldg(subs + si * 3 + 2);
                            const long long ds = d[u] < nv - 1 ? d[u]
                                                               : nv - 1;
                            sp[u][si] = __ldg(pv + ds) != 0;
                            sv[u][si] = __ldg(fv + ds);
                        }
                    }
                }
            }
            // the per-value keys of the docs of several values
#pragma unroll
            for (int u = 0; u < AR_U; ++u)
#pragma unroll
                for (int k = 0; k < AR_VMAX; ++k) {
                    mh[u][k] = ml[u][k] = 0;
                    if (k < src.vmax && k < mvc[u]) {
                        long long i = (long long)mvo[u] + k;
                        if (i > src.nmv - 1) i = src.nmv - 1;
                        mh[u][k] = __ldg(src.mv_hi + i);
                        ml[u][k] = __ldg(src.mv_lo + i);
                    }
                }
#pragma unroll
            for (int u = 0; u < AR_U; ++u) {
                if (i0 + u * 32 < n) {
                    if (MODE >= 2)
                        ok[u] = row[u] >= 0 &&
                                lex_le(w[u].x, w[u].y, w[u].z, w[u].w);
                    if (MODE == 1 && ok[u])
                        v[u] = haversine(v[u], v2[u], o0, o1);
                    range_loop(row[u], d[u], ok[u], v[u], w[u], mvo[u],
                               mvc[u], mh[u], ml[u], sv[u], sp[u]);
                }
            }
        }
    };
    // with the member matrix: its rows that are not eligible, zeros
    auto each = [&](long long gi, unsigned msk) {
        if (member == nullptr || gi >= q1) return;
        for (int j = 0; j < 16; ++j) {
            const long long r = gi * 16 + j - base;
            if (r < 0 || r >= R || ((msk >> j) & 1u)) continue;
            unsigned char* mrow = member + (base + r) * nb;
            for (int c = 0; c < nb; ++c) mrow[c] = 0;
        }
    };
    warp_row_queue<AR_WARPS, true>(elig, base, base + R, q0, q1, gpw, warp,
                                   lane, first, queue, each, drain);
    __syncthreads();
    // the warps' partials in warp order: the block's [S][nb][5] (one
    // block: the outputs [S][5][B][nb]), then its counts
    const float* wp0 = wsh ? reinterpret_cast<const float*>(
                                 hist + nb + AR_WARPS * RQ_CAP)
                           : wpg + ((long long)b * G + g) * AR_WARPS *
                                       wstride;
    float* acc = G > 1 ? part + ((long long)b * G + g) * wstride : nullptr;
    for (long long i = t; i < (long long)S * nb; i += AR_THREADS) {
        float a[5] = {0.0f, 0.0f, 0.0f, inf, -inf};
        for (int k = 0; k < AR_WARPS; ++k) {
            const float* q = wp0 + k * wstride + i * 5;
            a[0] += q[0];
            a[1] += q[1];
            a[2] += q[2];
            a[3] = fminf(a[3], q[3]);
            a[4] = fmaxf(a[4], q[4]);
        }
        const long long si = i / nb, c = i % nb;
        for (int st = 0; st < 5; ++st) {
            if (G > 1)
                acc[i * 5 + st] = a[st];
            else
                out[((si * 5 + st) * B + b) * nb + c] = a[st];
        }
    }
    if (G == 1) {
        for (int c = t; c < nb; c += AR_THREADS)
            counts[(long long)b * nb + c] = hist[c];
        return;
    }
    int* pc = pcount + ((long long)b * G + g) * nb;
    for (int c = t; c < nb; c += AR_THREADS) pc[c] = hist[c];
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&ctr[b], 1) == G - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the outputs of the query: nb counts, then S x nb x 5 statistics
    // ([S][nb][5] as the blocks' partials), a warp or a thread each
    const long long nout = (long long)nb * (1 + 5 * S);
    const int lanes = fold_lanes(nout);
    const int e0 = lanes == 32 ? warp : t;
    const int step = lanes == 32 ? AR_WARPS : AR_THREADS;
    for (long long e = e0; e < nout; e += step) {
        if (e < nb) {
            const int v = fold_counts(pcount + (long long)b * G * nb + e, nb,
                                      G, lanes, lane);
            if (lanes == 1 || lane == 0) counts[(long long)b * nb + e] = v;
        } else {
            const long long f = e - nb, st = f % 5, c = (f / 5) % nb,
                            si = f / 5 / nb;
            const float v = fold_blocks(part + (long long)b * G * wstride + f,
                                        wstride, G, st < 3 ? 0 : st - 2,
                                        lanes, lane);
            if (lanes == 1 || lane == 0)
                out[((si * 5 + st) * B + b) * nb + c] = v;
        }
    }
    if (t == 0) ctr[b] = 0;
}

// cols: int64 [10] in host memory = fval, fval2, present, keys, mv_off,
// mv_len, mv_hi, mv_lo (device pointers, 0 where absent), n, nmv; subs:
// int64 [S][3] as agg_buckets'; counts i32[B][nb] written whole; member
// u8[B][R][nb] or null, written whole; part f32[B*G*S*nb*5] and pcount
// i32[B*G*nb] scratch (read where G > 1); ctr i32[>= B] zeros, left
// zeros; out f32[S][5][B][nb]; wpg the warps' sub partials past shared
// memory, f32[B*G*8*S*nb*5] (null where they fit).
extern "C" int xt_agg_ranges(const void* ids, const void* elig, int B,
                             long long R, int G, int gpw, int mode,
                             const long long* cols, int vmax,
                             const void* fb, const void* kb,
                             const void* assign, const void* origin, int nr,
                             int nb, int S, const void* subs, void* counts,
                             void* member, void* part, void* pcount,
                             void* ctr, void* out, void* wpg, void* stream) {
    if (B == 0) return 0;
    if (nb < 1 || nb > AR_MAXNB || nr > AR_MAXNB || G < 1 || gpw < 1 ||
        gpw > 32 || S < 0 ||
        nr < 1 || mode < 0 || mode > 3 || (mode >= 2 && cols[3] == 0) ||
        (S > 0 && !ar_wp_shared(nb, S) && wpg == nullptr))
        return (int)cudaErrorInvalidValue;
    RangeSrc src;
    src.fval = (const float*)cols[0];
    src.fval2 = (const float*)cols[1];
    src.present = (const unsigned char*)cols[2];
    src.keys = (const int4*)cols[3];
    src.mv_off = (const int*)cols[4];
    src.mv_len = (const int*)cols[5];
    src.mv_hi = (const int*)cols[6];
    src.mv_lo = (const int*)cols[7];
    src.n = cols[8];
    src.nmv = cols[9];
    src.vmax = vmax;
    src.fb = (const float*)fb;
    src.kb = (const int*)kb;
    src.assign = (const int*)assign;
    src.origin = (const float*)origin;
    src.nr = nr;
    using Kernel = void (*)(const int*, const unsigned char*, long long, int,
                           int, const RangeSrc, int, int, const long long*,
                           int*,
                           unsigned char*, float*, int*, int*, float*,
                           float*);
    static const Kernel kernels[4] = {
        agg_ranges_kernel<0>, agg_ranges_kernel<1>, agg_ranges_kernel<2>,
        agg_ranges_kernel<3>};
    static bool attrs = false;
    if (!attrs) {
        for (int m = 0; m < 4; ++m) {
            const int rc = (int)cudaFuncSetAttribute(
                kernels[m], cudaFuncAttributeMaxDynamicSharedMemorySize,
                4 * ((5 * AR_MAXNB + 4) & ~3) + 4 * AR_MAXNB +
                    4 * AR_WARPS * RQ_CAP + 4 * AR_WP_SMEM);
            if (rc) return rc;
        }
        attrs = true;
    }
    kernels[mode]<<<dim3(G, B), AR_THREADS, ar_smem(mode, nr, nb, S),
                    (cudaStream_t)stream>>>(
        (const int*)ids, (const unsigned char*)elig, R, G, gpw, src, nb, S,
        (const long long*)subs, (int*)counts, (unsigned char*)member,
        (float*)part, (int*)pcount, (int*)ctr, (float*)out, (float*)wpg);
    return (int)cudaGetLastError();
}
