// merge_docs: per-doc score sums, OR of group bits, the eligible mask and
// per-query counts.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py execute() 743-783 (the
// lax.sort of all rows by docid), _merge_runs 158-189 (run sums and the
// OR of group bits over equal docids), the tail/first/deletes epilogue
// 784-828, the boolean tree _eval_tree 249-282 (or its superset rewrite
// _upper_tree 285-310) over the bits 858-880, and the count 881.
//
// The TPU sorted all R rows of a query because its gathers serialise
// (executor.py:20-25). This kernel computes the same per-doc sums with no
// sort: every term block is docid-ascending (score_slices guarantees it,
// SENTINEL rows last), a doc appears at most once a term, and a doc's sum
// adds the weights of the terms holding it in term order u = 0..T-1 from
// +0.0, its bits OR their group bits, and its owner row is that of the
// lowest term holding it. Every row of one doc holds the same sum and
// bits; exactly one of them is the owner. Two designs compute that:
//
// - Doc tiles (merge_tiles_kernel), grid (tiles, B): a block takes one
//   query's docids [j * tile, (j + 1) * tile) (tile: the wrapper's, by
//   kernels.merge_plan). It brackets each term block's rows in that range
//   (common.cuh tile_brackets: three binary searches a term a block, not
//   T - 1 a row; one warp scans the counts), then goes through the
//   terms in order, adding each term's rows into a shared accumulator
//   indexed by docid - j * tile, OR-ing its bits and marking the first
//   term of each doc; one barrier between terms keeps the float sum in
//   term order (no two rows of one term share a slot). Then it writes each
//   row's outputs at the row's own position. The rows are taken in chunks
//   of MD_THREADS * MD_RPT, each row's docid and weight in registers, so a
//   chunk costs one barrier per term with rows in it; a tile of at most
//   32 * MD_RPT rows (geo's aggregation run: ~100 rows over 128 terms) is
//   added by one warp, a warp barrier a term. The tiles are fixed
//   docid ranges over the segment's n_docs (the callers' deleted flags'
//   rows):
//   splitters from the rows would need a pass over them first, and
//   kernels.merge_plan sends the sparse queries, where most fixed tiles
//   would be empty, to the other design. A docid outside the tiles (none
//   where n_docs is right) is computed by the probes in the first or last
//   tile, so the answer never depends on n_docs. Each block also writes
//   0 / 0 / 0 on its share of the query's SENTINEL rows (the third search
//   finds where they start).
// - Probes (merge_docs_kernel), grid (row tiles of 256, B): a row finds
//   its doc in every other term's block by binary search (the join
//   formulation of _execute_join 1102-1128): R * (T - 1) searches of
//   log2 W dependent loads. It stays for the sparse queries (a relevance
//   OR of a few hundred rows) and the small segments (fewer than
//   kernels.MERGE_MIN_TILES tiles a query).
//
// The epilogue (K6) writes mask = owner & !deleted[doc] & tree(bits),
// where the tree is a postfix program (common.cuh eval_tree): the full
// tree when the plan has no value filters, the upper tree (F leaves ALL or
// NONE by polarity) before compaction, or ALL when filter_leaves applies
// the tree later. Null bits, deleted or program leave that part out. The
// count is an integer: a warp sum, one shared atomic a warp and one
// device atomic a block.
//
// Bound on the H100: the real rows' docids and weights read (a term
// block's SENTINEL rows need no read), every row's sum, mask and orbits
// written, and the owners' deleted flags. The doc tiles read a
// chunk's docids twice (the second time from L2) and add one shared-memory
// update a row; the probes add (T - 1) * log2 W dependent loads a row,
// L2 hits, which at T = 128 (geo) set the time.
#include "common.cuh"

#ifndef MD_THREADS
#define MD_THREADS 256
#endif
#ifndef MD_RPT
#define MD_RPT 8            // rows a thread a chunk
#endif
#define MD_NONE 0xffff      // no term holds the slot's doc yet

// mask of one real row r of term t (docid d): sum over the terms in term
// order, OR of bits, owner; deleted and the tree where given
__device__ __forceinline__ int probe_row(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    long long base, int r, int d, int t, const int* qbits, float& s,
    unsigned& ob) {
    int m = 1;
    s = 0.0f;
    ob = 0;
    for (int u = 0; u < T; ++u) {
        if (u == t) {
            s = s + w[base + r];
            if (qbits) ob |= (unsigned)qbits[u];
            continue;
        }
        const int* blk = ids + base + row_off[u];
        const int pos = lower_bound_i32(blk, widths[u], d);
        if (pos < widths[u] && blk[pos] == d) {
            s = s + w[base + row_off[u] + pos];
            if (qbits) ob |= (unsigned)qbits[u];
            if (u < t) m = 0;
        }
    }
    return m;
}

__device__ __forceinline__ int epilogue(
    int m, int d, unsigned ob, const unsigned char* __restrict__ deleted,
    long long n_deleted, const int* __restrict__ prog, int prog_len) {
    if (m && deleted) {
        const long long dd = (long long)d < n_deleted - 1 ? (long long)d
                                                          : n_deleted - 1;
        m = deleted[dd] ? 0 : 1;
    }
    if (m && prog) m = eval_tree(prog, prog_len, ob, 0u, 0u, 0u);
    return m;
}

__global__ void merge_docs_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ bits,
    const unsigned char* __restrict__ deleted, long long n_deleted,
    const int* __restrict__ prog, int prog_len, float* __restrict__ sums,
    unsigned char* __restrict__ mask, int* __restrict__ count,
    int* __restrict__ orbits) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    int m = 0;
    if (r < R) {
        const long long base = (long long)b * R;
        const int d = ids[base + r];
        // the term this row belongs to: last t with row_off[t] <= r
        int lo = 0, hi = T - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (row_off[mid] <= r) lo = mid; else hi = mid - 1;
        }
        const int* qbits = bits ? bits + (long long)b * T : nullptr;
        float s = 0.0f;
        unsigned ob = 0;
        if (d != XT_SENTINEL) {
            m = probe_row(ids, w, widths, row_off, T, base, r, d, lo, qbits,
                          s, ob);
            m = epilogue(m, d, ob, deleted, n_deleted, prog, prog_len);
        }
        sums[base + r] = s;
        mask[base + r] = (unsigned char)m;
        if (orbits) orbits[base + r] = (int)ob;
    }
    const int n = __syncthreads_count(m);
    if (threadIdx.x == 0 && n) atomicAdd(count + b, n);
}

__global__ void __launch_bounds__(MD_THREADS) merge_tiles_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ bits,
    const unsigned char* __restrict__ deleted, long long n_deleted,
    const int* __restrict__ prog, int prog_len, float* __restrict__ sums,
    unsigned char* __restrict__ mask, int* __restrict__ count,
    int* __restrict__ orbits, int tile) {
    extern __shared__ int md_smem[];
    // per term: the bracket's first row, the prefix of the bracket's rows,
    // where its SENTINEL rows start and the prefix of their counts
    int* a0 = md_smem;                    // [T]
    int* pr = a0 + T;                     // [T + 1]
    int* z0 = pr + T + 1;                 // [T]
    int* ps = z0 + T;                     // [T + 1]
    int* s_cnt = ps + T + 1;              // [1]
    float* acc = reinterpret_cast<float*>(s_cnt + 1);        // [tile]
    unsigned* sob = reinterpret_cast<unsigned*>(acc + tile); // [tile]
    unsigned short* first =
        reinterpret_cast<unsigned short*>(sob + tile);       // [tile]

    const int b = blockIdx.y, j = blockIdx.x, nt = gridDim.x;
    const long long base = (long long)b * R;
    const int* qbits = bits ? bits + (long long)b * T : nullptr;
    const long long lo = (long long)j * tile;
    tile_brackets<MD_THREADS>(ids, base, widths, row_off, T, j, nt, tile, a0,
                              pr, z0, ps, [&] {
        for (int i = threadIdx.x; i < tile; i += MD_THREADS) {
            acc[i] = 0.0f;
            sob[i] = 0u;
            first[i] = MD_NONE;
        }
        if (threadIdx.x == 0) *s_cnt = 0;
    });
    const int N = pr[T];

    // 1. the terms in order: each chunk's rows in registers, a barrier
    // after each term the chunk holds; a tile of a few rows is added by
    // warp 0 alone, a warp barrier after each term
    const bool small = N <= 32 * MD_RPT;
    const int nth = small ? 32 : MD_THREADS;
    const int CH = nth * MD_RPT;
    for (int c0 = 0; c0 < N && (!small || threadIdx.x < 32); c0 += CH) {
        const int c1 = min(N, c0 + CH);
        int slot[MD_RPT], term[MD_RPT];
        float wv[MD_RPT];
#pragma unroll
        for (int q = 0; q < MD_RPT; ++q) {
            const int k = c0 + q * nth + threadIdx.x;
            term[q] = -1;
            if (k < c1) {
                const int u = last_le(pr, T + 1, k);
                const int r = row_off[u] + a0[u] + (k - pr[u]);
                const long long s = (long long)ids[base + r] - lo;
                if (s >= 0 && s < tile) {
                    term[q] = u;
                    slot[q] = (int)s;
                    wv[q] = w[base + r];
                }
            }
        }
        const int u0 = last_le(pr, T + 1, c0);
        const int u1 = last_le(pr, T + 1, c1 - 1);
        for (int u = u0; u <= u1; ++u) {
            if (pr[u + 1] == pr[u]) continue;   // no row: no barrier
            const unsigned bu = qbits ? (unsigned)qbits[u] : 0u;
#pragma unroll
            for (int q = 0; q < MD_RPT; ++q) {
                if (term[q] == u) {
                    const int s = slot[q];
                    acc[s] = acc[s] + wv[q];
                    sob[s] |= bu;
                    if (first[s] == MD_NONE) first[s] = (unsigned short)u;
                }
            }
            if (small)
                __syncwarp();
            else
                __syncthreads();
        }
    }
    if (small) __syncthreads();

    // 2. every bracketed row's outputs at its own position
    int cnt = 0;
    for (int k = threadIdx.x; k < N; k += MD_THREADS) {
        const int u = last_le(pr, T + 1, k);
        const int r = row_off[u] + a0[u] + (k - pr[u]);
        const int d = ids[base + r];
        const long long sl = (long long)d - lo;
        float s;
        unsigned ob;
        int m;
        if (sl >= 0 && sl < tile) {
            s = acc[sl];
            ob = sob[sl];
            m = first[sl] == u;
        } else {
            m = probe_row(ids, w, widths, row_off, T, base, r, d, u, qbits,
                          s, ob);
        }
        m = epilogue(m, d, ob, deleted, n_deleted, prog, prog_len);
        sums[base + r] = s;
        mask[base + r] = (unsigned char)m;
        if (orbits) orbits[base + r] = (int)ob;
        cnt += m;
    }
    // 3. this block's share of the SENTINEL rows
    const int S = ps[T];
    const int e0 = (int)((long long)S * j / nt);
    const int e1 = (int)((long long)S * (j + 1) / nt);
    for (int e = e0 + threadIdx.x; e < e1; e += MD_THREADS) {
        const int u = last_le(ps, T + 1, e);
        const int r = row_off[u] + z0[u] + (e - ps[u]);
        sums[base + r] = 0.0f;
        mask[base + r] = 0;
        if (orbits) orbits[base + r] = 0;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(s_cnt, cnt);
    __syncthreads();
    if (threadIdx.x == 0 && *s_cnt) atomicAdd(count + b, *s_cnt);
}

// tiles: 0, the probes; else the doc tiles' count, `tile` docids each
extern "C" int xt_merge_docs(const void* ids, const void* w,
                             const void* widths, const void* row_off, int B,
                             int T, int R, const void* bits,
                             const void* deleted, long long n_deleted,
                             const void* prog, int prog_len, void* sums,
                             void* mask, void* count, void* orbits,
                             int tiles, int tile, void* stream) {
    if (B == 0 || R == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (tiles > 0) {
        if (T >= MD_NONE || tile <= 0) return (int)cudaErrorInvalidValue;
        const int smem = (4 * T + 3) * (int)sizeof(int) + tile * 10;
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(merge_tiles_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        merge_tiles_kernel<<<dim3(tiles, B), MD_THREADS, smem, st>>>(
            (const int*)ids, (const float*)w, (const int*)widths,
            (const int*)row_off, T, R, (const int*)bits,
            (const unsigned char*)deleted, n_deleted, (const int*)prog,
            prog_len, (float*)sums, (unsigned char*)mask, (int*)count,
            (int*)orbits, tile);
        return (int)cudaGetLastError();
    }
    dim3 grid((R + 255) / 256, B);
    merge_docs_kernel<<<grid, 256, 0, st>>>(
        (const int*)ids, (const float*)w, (const int*)widths,
        (const int*)row_off, T, R, (const int*)bits,
        (const unsigned char*)deleted, n_deleted, (const int*)prog, prog_len,
        (float*)sums, (unsigned char*)mask, (int*)count, (int*)orbits);
    return (int)cudaGetLastError();
}
