// merge_special: the per-doc sums of a plan with OP_MAX or OP_SYNONYM.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 746-756 (the base
// weights without the OP_MAX branches' terms) and 787-812 (per max spec
// the best branch sum; per synonym group the summed wdf scored once), each
// a _merge_runs segmented scan over the docid-sorted rows.
//
// It runs after merge_docs on the same rows (term blocks, each docid-
// ascending, SENTINEL rows last) and rewrites `sums` on every real row,
// from scratch, in one stated float32 order:
//   1. the base: the doc's weights in term order t = 0..T-1, leaving out
//      every term whose group bit lies in a branch mask of a max spec;
//   2. per max spec, in order: per branch mask the doc's weights of the
//      terms whose bit lies in the mask, in term order; the maximum over
//      the branches is added (the first branch, then nan_max: a NaN
//      branch wins, as in torch.maximum and JAX's jnp.maximum; fmaxf, the
//      first design's, dropped it);
//   3. per synonym group i, in order: ssum = the raw wdf of the doc's
//      postings of the terms whose bit lies in syn_groups[i], in term
//      order; where ssum > 0, sumpart(ssum, dl, syn_tconst[b, i]) is added,
//      dl the doc's length read at the row's own posting (1 where it is
//      0), in the query's scheme (common.cuh scheme_sumpart; BM25 the
//      GENERIC = false instance, as before the other schemes), syn_tconst
//      f32[B, NS, C], with the doc's uniqterms (uniq[min(d, ND)], 807-811)
//      where the scheme reads it.
// Every sum starts at +0.0 and adds in term order, as the plain version
// does (a term without the doc adds nothing there but +0.0, which changes
// no sum that starts at +0.0). Synonym terms are bound non-scoring, so
// their weight is 0 in the base already (NaN under the schemes whose
// non-scoring weight is NaN, as in JAX).
//
// Table `spec` (int32): n_max, then per max spec its branch count and its
// branch masks; then n_syn and the synonym masks. Its channels: 0 the
// base, then one a branch of each max spec in order, then one a synonym
// group: P = 1 + branches + synonym groups.
//
// Two designs, the wrapper's choice (kernels.special_plan):
// - Doc tiles (merge_special_tiles), grid (tiles, B), merge_docs' design:
//   a block takes one query's docids [j * tile, (j + 1) * tile), brackets
//   each term block's rows in that range (common.cuh tile_brackets), and
//   goes through the terms in order, adding each of its rows' weight into
//   the doc's slot of every weight channel the term feeds (the base, its
//   branches) and its posting's wdf (the row's position past the block's
//   clamped start) into the slot of every synonym channel; P float slots
//   a doc in shared memory, one barrier between terms (the rows of one
//   term are distinct docs, so no two touch a slot between barriers, and
//   every channel adds in term order). Then each bracketed row writes its
//   doc's sum from the slots, and the block its share of the SENTINEL
//   rows 0. A docid outside the fixed tiles (none where n_docs is right)
//   is computed by the probes in the first or last tile, as in
//   merge_docs, so the answer never depends on n_docs. Rows are taken in
//   chunks of MS_THREADS * MS_RPT, a barrier a term a chunk; a tile of at
//   most 32 * MS_RPT rows is added by one warp.
// - Probes (merge_special_kernel), grid (row tiles of 256, B): a row finds
//   its doc in another term's block by binary search, (1 + branches +
//   synonym groups) passes over the T terms, each a search of log2 W
//   dependent L2 loads. It stays for sparse queries, small segments and
//   plans of more than 32 channels or whose slots exceed shared memory.
//
// Bound on the H100: the real rows' docid and weight read, every row's sum
// written, the wdf and doclen of each real row of a plan with synonyms,
// each term's bits and offsets; one add a (real row, channel). The tiles
// read a chunk's docids twice (the second time from L2) and make one
// shared-memory add a (row, channel the term feeds).
#include "common.cuh"

#ifndef MS_THREADS
#define MS_THREADS 256
#endif
#ifndef MS_RPT
#define MS_RPT 8            // rows a thread a chunk
#endif
#define MS_MAX_CHANNELS 32  // channel words: one bit a channel

// the maximum of two branch sums as torch.maximum and jnp.maximum take
// it: a NaN (a non-scoring term's weight in the branch) wins
__device__ __forceinline__ float nan_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// the clamped start of term u's block in the postings (lax.dynamic_slice)
__device__ __forceinline__ long long block_start(const int* offsets_b, int u,
                                                 const int* widths,
                                                 long long n_post) {
    long long st = (long long)offsets_b[u];
    if (st > n_post - widths[u]) st = n_post - widths[u];
    if (st < 0) st = 0;
    return st;
}

struct SpecialRow {
    const int* ids;
    const float* w;
    const int* widths;
    const int* row_off;
    long long base;
    int T, t, r, d;

    // the row of the doc in term u's block, or -1
    __device__ __forceinline__ int find(int u) const {
        if (u == t) return r - row_off[t];
        const int* blk = ids + base + row_off[u];
        const int pos = lower_bound_i32(blk, widths[u], d);
        return (pos < widths[u] && blk[pos] == d) ? pos : -1;
    }
};

// the sum of one real row r of term t (docid d) by the probes
template <bool GENERIC>
__device__ float probe_special(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    long long base, int r, int d, int t, const int* qbits,
    const int* offsets_b, const float* __restrict__ post_wdf,
    const float* __restrict__ post_doclen, long long n_post,
    const int* __restrict__ spec, const float* syn_b, const SchemeSpec& sp,
    int C, const float* __restrict__ uniq, int nd1) {
    SpecialRow row;
    row.ids = ids;
    row.w = w;
    row.widths = widths;
    row.row_off = row_off;
    row.base = base;
    row.T = T;
    row.t = t;
    row.r = r;
    row.d = d;
    const int n_max = spec[0];
    unsigned excl = 0;
    int at = 1;
    for (int i = 0; i < n_max; ++i) {
        const int nb = spec[at++];
        for (int j = 0; j < nb; ++j) excl |= (unsigned)spec[at++];
    }
    const int syn_at = at;
    float s = 0.0f;
    for (int u = 0; u < T; ++u) {
        if ((unsigned)qbits[u] & excl) continue;
        const int pos = row.find(u);
        if (pos >= 0) s = s + w[base + row_off[u] + pos];
    }
    at = 1;
    for (int i = 0; i < n_max; ++i) {
        const int nb = spec[at++];
        float best = 0.0f;
        for (int j = 0; j < nb; ++j) {
            const unsigned m = (unsigned)spec[at++];
            float bs = 0.0f;
            for (int u = 0; u < T; ++u) {
                if (!((unsigned)qbits[u] & m)) continue;
                const int pos = row.find(u);
                if (pos >= 0) bs = bs + w[base + row_off[u] + pos];
            }
            best = j == 0 ? bs : nan_max(best, bs);
        }
        if (nb > 0) s = s + best;
    }
    const int n_syn = spec[syn_at];
    if (n_syn > 0) {
        // the doc's length, read at the row's own posting
        float dl = post_doclen[block_start(offsets_b, t, widths, n_post) +
                               (r - row_off[t])];
        if (!(dl > 0.0f)) dl = 1.0f;
        const float un = (GENERIC && uniq != nullptr)
                             ? uniq[min(d, nd1 - 1)] : 1.0f;
        for (int i = 0; i < n_syn; ++i) {
            const unsigned m = (unsigned)spec[syn_at + 1 + i];
            float ssum = 0.0f;
            for (int u = 0; u < T; ++u) {
                if (!((unsigned)qbits[u] & m)) continue;
                const int pos = row.find(u);
                if (pos < 0) continue;
                ssum = ssum + post_wdf[block_start(offsets_b, u, widths,
                                                   n_post) + pos];
            }
            if (ssum > 0.0f)
                s = s + scheme_sumpart<GENERIC>(
                    sp, ssum, dl, syn_b + (long long)i * (GENERIC ? C : 1),
                    un);
        }
    }
    return s;
}

// the term a row belongs to: the last t with row_off[t] <= r
__device__ __forceinline__ int term_of(const int* row_off, int T, int r) {
    int lo = 0, hi = T - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (row_off[mid] <= r) lo = mid; else hi = mid - 1;
    }
    return lo;
}

template <bool GENERIC>
__global__ void merge_special_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ bits, const int* __restrict__ offsets,
    const float* __restrict__ post_wdf, const float* __restrict__ post_doclen,
    long long n_post, const int* __restrict__ spec,
    const float* __restrict__ syn_tconst, int NS, SchemeSpec sp, int C,
    const float* __restrict__ uniq, int nd1, float* __restrict__ sums) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const long long base = (long long)b * R;
    const int d = ids[base + r];
    if (d == XT_SENTINEL) {
        sums[base + r] = 0.0f;
        return;
    }
    sums[base + r] = probe_special<GENERIC>(
        ids, w, widths, row_off, T, base, r, d, term_of(row_off, T, r),
        bits + (long long)b * T, offsets + (long long)b * T, post_wdf,
        post_doclen, n_post, spec,
        syn_tconst + (long long)b * NS * (GENERIC ? C : 1), sp, C, uniq,
        nd1);
}

template <bool GENERIC>
__global__ void __launch_bounds__(MS_THREADS) merge_special_tiles(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ bits, const int* __restrict__ offsets,
    const float* __restrict__ post_wdf, const float* __restrict__ post_doclen,
    long long n_post, const int* __restrict__ spec,
    const float* __restrict__ syn_tconst, int NS, SchemeSpec sp, int C,
    const float* __restrict__ uniq, int nd1, float* __restrict__ sums,
    int tile) {
    extern __shared__ long long ms_smem[];
    // per term: its clamped posting start, the channels it feeds (its
    // weight: cw, its wdf: cy), its bracket (tile_brackets)
    long long* pst = ms_smem;                             // [T]
    int* cw = reinterpret_cast<int*>(pst + T);            // [T]
    int* cy = cw + T;                                     // [T]
    int* a0 = cy + T;                                     // [T]
    int* pr = a0 + T;                                     // [T + 1]
    int* z0 = pr + T + 1;                                 // [T]
    int* ps = z0 + T;                                     // [T + 1]
    float* acc = reinterpret_cast<float*>(ps + T + 1);    // [P][tile]

    const int b = blockIdx.y, j = blockIdx.x, nt = gridDim.x;
    const long long base = (long long)b * R;
    const int* qbits = bits + (long long)b * T;
    const int* qoff = offsets + (long long)b * T;
    const float* syn_b = syn_tconst + (long long)b * NS * (GENERIC ? C : 1);
    const long long lo = (long long)j * tile;
    const int n_max = spec[0];
    int P = 1, at = 1;
    for (int i = 0; i < n_max; ++i) {
        const int nb = spec[at];
        P += nb;
        at += 1 + nb;
    }
    const int syn_at = at, n_syn = spec[syn_at];
    P += n_syn;
    for (int u = threadIdx.x; u < T; u += MS_THREADS) {
        const unsigned qb = (unsigned)qbits[u];
        unsigned excl = 0, mw = 0, my = 0;
        int ch = 1, a = 1;
        for (int i = 0; i < n_max; ++i) {
            const int nb = spec[a++];
            for (int k = 0; k < nb; ++k, ++ch) {
                const unsigned m = (unsigned)spec[a++];
                excl |= m;
                if (qb & m) mw |= 1u << ch;
            }
        }
        if (!(qb & excl)) mw |= 1u;
        for (int i = 0; i < n_syn; ++i, ++ch)
            if (qb & (unsigned)spec[syn_at + 1 + i]) my |= 1u << ch;
        cw[u] = (int)mw;
        cy[u] = (int)my;
        pst[u] = block_start(qoff, u, widths, n_post);
    }
    tile_brackets<MS_THREADS>(ids, base, widths, row_off, T, j, nt, tile, a0,
                              pr, z0, ps, [&] {
        for (int i = threadIdx.x; i < P * tile; i += MS_THREADS)
            acc[i] = 0.0f;
    });
    const int N = pr[T];

    // 1. the terms in order: each chunk's rows in registers, a barrier
    // after each term the chunk holds that feeds a channel; a tile of a
    // few rows is added by warp 0 alone, a warp barrier after each term
    const bool small = N <= 32 * MS_RPT;
    const int nth = small ? 32 : MS_THREADS;
    const int CH = nth * MS_RPT;
    for (int c0 = 0; c0 < N && (!small || threadIdx.x < 32); c0 += CH) {
        const int c1 = min(N, c0 + CH);
        int slot[MS_RPT], term[MS_RPT];
        float wv[MS_RPT], fv[MS_RPT];
#pragma unroll
        for (int q = 0; q < MS_RPT; ++q) {
            const int k = c0 + q * nth + threadIdx.x;
            term[q] = -1;
            if (k < c1) {
                const int u = last_le(pr, T + 1, k);
                const int pos = a0[u] + (k - pr[u]);
                const int r = row_off[u] + pos;
                const long long s = (long long)ids[base + r] - lo;
                if (s >= 0 && s < tile) {
                    term[q] = u;
                    slot[q] = (int)s;
                    wv[q] = cw[u] ? w[base + r] : 0.0f;
                    fv[q] = cy[u] ? post_wdf[pst[u] + pos] : 0.0f;
                }
            }
        }
        const int u0 = last_le(pr, T + 1, c0);
        const int u1 = last_le(pr, T + 1, c1 - 1);
        for (int u = u0; u <= u1; ++u) {
            const unsigned mw = (unsigned)cw[u], my = (unsigned)cy[u];
            if (pr[u + 1] == pr[u] || !(mw | my)) continue;  // no barrier
#pragma unroll
            for (int q = 0; q < MS_RPT; ++q) {
                if (term[q] == u) {
                    float* a = acc + slot[q];
                    for (unsigned m = mw; m; m &= m - 1) {
                        const int ch = __ffs(m) - 1;
                        a[ch * tile] = a[ch * tile] + wv[q];
                    }
                    for (unsigned m = my; m; m &= m - 1) {
                        const int ch = __ffs(m) - 1;
                        a[ch * tile] = a[ch * tile] + fv[q];
                    }
                }
            }
            if (small)
                __syncwarp();
            else
                __syncthreads();
        }
    }
    __syncthreads();

    // 2. every bracketed row's sum at its own position
    for (int k = threadIdx.x; k < N; k += MS_THREADS) {
        const int u = last_le(pr, T + 1, k);
        const int pos = a0[u] + (k - pr[u]);
        const int r = row_off[u] + pos;
        const int d = ids[base + r];
        const long long sl = (long long)d - lo;
        float s;
        if (sl >= 0 && sl < tile) {
            const float* a = acc + sl;
            s = a[0];
            int ch = 1, a2 = 1;
            for (int i = 0; i < n_max; ++i) {
                const int nb = spec[a2];
                a2 += 1 + nb;
                float best = 0.0f;
                for (int jj = 0; jj < nb; ++jj, ++ch)
                    best = jj == 0 ? a[ch * tile]
                                   : nan_max(best, a[ch * tile]);
                if (nb > 0) s = s + best;
            }
            if (n_syn > 0) {
                float dl = post_doclen[pst[u] + pos];
                if (!(dl > 0.0f)) dl = 1.0f;
                const float un = (GENERIC && uniq != nullptr)
                                     ? uniq[min(d, nd1 - 1)] : 1.0f;
                for (int i = 0; i < n_syn; ++i, ++ch) {
                    const float ssum = a[ch * tile];
                    if (ssum > 0.0f)
                        s = s + scheme_sumpart<GENERIC>(
                            sp, ssum, dl,
                            syn_b + (long long)i * (GENERIC ? C : 1), un);
                }
            }
        } else {
            s = probe_special<GENERIC>(ids, w, widths, row_off, T, base, r,
                                       d, u, qbits, qoff, post_wdf,
                                       post_doclen, n_post, spec, syn_b, sp,
                                       C, uniq, nd1);
        }
        sums[base + r] = s;
    }
    // 3. this block's share of the SENTINEL rows
    const int S = ps[T];
    const int e0 = (int)((long long)S * j / nt);
    const int e1 = (int)((long long)S * (j + 1) / nt);
    for (int e = e0 + threadIdx.x; e < e1; e += MS_THREADS) {
        const int u = last_le(ps, T + 1, e);
        sums[base + row_off[u] + z0[u] + (e - ps[u])] = 0.0f;
    }
}

// tiles: 0, the probes; else the doc tiles' count, `tile` docids each
extern "C" int xt_merge_special(
    const void* ids, const void* w, const void* widths, const void* row_off,
    int B, int T, int R, const void* bits, const void* offsets,
    const void* post_wdf, const void* post_doclen, long long n_post,
    const void* spec, const void* syn_tconst, int NS, int scheme,
    const float* params, int C, const void* uniq, int nd1, int channels,
    int tiles, int tile, void* sums, void* stream) {
    if (B == 0 || R == 0) return 0;
    const SchemeSpec sp = make_spec(scheme, params);
    cudaStream_t st = (cudaStream_t)stream;
    if (tiles > 0) {
        if (channels < 1 || channels > MS_MAX_CHANNELS || tile <= 0)
            return (int)cudaErrorInvalidValue;
        auto kernel = scheme == XT_SCHEME_BM25 ? merge_special_tiles<false>
                                               : merge_special_tiles<true>;
        const int smem = 8 * T + (6 * T + 2) * (int)sizeof(int) +
                         channels * tile * (int)sizeof(float);
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        kernel<<<dim3(tiles, B), MS_THREADS, smem, st>>>(
            (const int*)ids, (const float*)w, (const int*)widths,
            (const int*)row_off, T, R, (const int*)bits, (const int*)offsets,
            (const float*)post_wdf, (const float*)post_doclen, n_post,
            (const int*)spec, (const float*)syn_tconst, NS, sp, C,
            (const float*)uniq, nd1, (float*)sums, tile);
        return (int)cudaGetLastError();
    }
    auto kernel = scheme == XT_SCHEME_BM25 ? merge_special_kernel<false>
                                           : merge_special_kernel<true>;
    dim3 grid((R + 255) / 256, B);
    kernel<<<grid, 256, 0, st>>>(
        (const int*)ids, (const float*)w, (const int*)widths,
        (const int*)row_off, T, R, (const int*)bits, (const int*)offsets,
        (const float*)post_wdf, (const float*)post_doclen, n_post,
        (const int*)spec, (const float*)syn_tconst, NS, sp, C,
        (const float*)uniq, nd1, (float*)sums);
    return (int)cudaGetLastError();
}
