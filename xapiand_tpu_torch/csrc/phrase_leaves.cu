// phrase_leaves: the PHRASE / NEAR verdict of every phrase leaf, as one
// word of verdict bits per row.
//
// Replaces (TPU): xapiand_tpu/ops/phrase.py phrase_leaves 28-116 (K14),
// with the lookups of xapiand_tpu/ops/executor.py lower_bound 192-205 and
// lower_bound_sorted 208-224 inside it (K15), and the phrase carry of
// execute() 685-823 that exists only to skip those lookups.
//
// What it computes, for each query and phrase leaf (term indices t0..tn-1,
// exact phrase or NEAR with a window):
//   - the candidates: the owner rows (merge_docs' owner: the doc's row in
//     the lowest-numbered term holding it) of docs that are not deleted
//     and carry every phrase group bit, in ascending docid order; only the
//     first cand_cap are verified and the rest are false (the documented
//     cap of ops/phrase.py 14-16, reproduced exactly: it decides counts
//     and ranks);
//   - each term's positions: the first min(poslen, pmax) entries of the
//     (term, doc) block of `positions`, which the segment builders keep
//     sorted (xapiand_tpu/models/builder.py 393, native.cpp 1434);
//   - PHRASE: some p0 of t0 has p0 + i among the positions of ti, every i;
//     NEAR: some p0 of t0 has, for every i, a position q of ti with
//     |q - p0| < window;
//   - the verdict is set at the owner row, bit p of the row's word for
//     phrase leaf p; filter_leaves reads the word (PH leaves of the tree
//     program).
//
// What the design relies on. The planner gives every phrase term a group
// of its own (query/plan.py _walk, phrase / near: one _new_group a term),
// and merge_docs writes `orbits`, the OR of the group bits of the terms
// holding the doc, on EVERY row of the doc, not only the owner. So at any
// row of doc d, (orbits & allbits) == allbits (allbits: the leaf's group
// bits) says that d holds every phrase term, and the rows of one phrase
// term's block (docid-ascending, a doc at most once) enumerate every
// candidate exactly once, in docid order. The walk takes the phrase term
// with the fewest postings for the query (rows(t) = min(lens, widths)).
// Candidacy is then the orbits test and the doc's deleted flag (`first`
// at the owner is owner & !deleted: merge_docs' epilogue, with the same
// deleted flags, which the caller passes) - no search. tests/
// test_torch_leaves_design.py pins the planner fact and this emulation.
//
// The TPU compacted candidates with a full-width docid sort, found each
// candidate's posting by a two-sort join per term and compared [C, pmax,
// pmax] position windows by broadcast. Here three kernels in one call,
// spread over the card:
//   1. count: grid (tiles, leaves, queries), a block a tile of PH_TILE
//      walked rows (PH_RPT consecutive rows a thread): the candidates of
//      the tile, by the orbits test and the deleted flag; each block also
//      writes its share of the first half of the verdict words' zero fill
//      (16-byte stores), which runs at the memory's rate beside the
//      count's dependent loads instead of before them;
//   2. compact: the same grid; a block sums the counts of the tiles before
//      its own (the prefix) and exits if the prefix reaches cand_cap or
//      the tile is past the walked rows; otherwise it numbers its
//      candidates in row order (a block scan) and writes each numbered
//      below cand_cap into the leaf's candidate list at its number; the
//      tile-0 block writes ncand = min(all counts, cand_cap); the blocks
//      zero the second half of the verdict words;
//   3. verify: grid (cand_cap / PH_VTHREADS, leaves, queries), one
//      candidate a thread, every thread of a block busy but those past
//      ncand: the posting slot of each other phrase term by binary search
//      of its block (K15), the owner by the terms in order - a term whose
//      group bit the doc lacks is skipped without a search, a phrase term
//      reuses its slot - then for each of t0's positions a binary search
//      in each other sorted list (PHRASE: p0 + i; NEAR: the first q >= p0
//      - window + 1, which must be < p0 + window); a true verdict ORs bit
//      p into the owner row's word (atomicOr: leaves of one query run in
//      other blocks).
// Positions past a list's end are never read (the TPU read pmax entries
// and masked them; the 128-zero guard of `positions` kept that in bounds).
//
// Phrase table, int32 per leaf, `cols` words a row: n_terms, exact (1
// PHRASE, 0 NEAR), window, allbits, then the n term indices. A thread keeps
// the posting slots of a candidate's first PH_MAX_TERMS terms; a longer
// phrase (JAX takes any length, xapiand_tpu/ops/phrase.py:28) finds each
// further term's slot again by binary search where verify reads it.
//
// Bound on the H100: the verdict words written (the zero fill, 4 bytes a
// row) and the walked rows' docids and orbits read; then per kept
// candidate the latency of a few dependent searches and position loads:
// a verify launch of B = 64 is ~0.02-0.035 ms whatever was tried (the
// first 4 terms' searches in lockstep, 32 registers a thread for one
// wave, the lists prefetched: each within 10%). The count and compact
// passes read each walked row up to the cap's tile once from device
// memory and again from L2; a decoupled look-back that numbers the tiles
// in one pass, and warp-shared brackets for the verify searches, are
// later work.
#include "common.cuh"

#define PH_THREADS 256
#define PH_RPT 4                          // walked rows a thread
#define PH_TILE (PH_THREADS * PH_RPT)     // walked rows a tile: 1,024
                                          // (ops/phrase.py PHRASE_TILE)
#define PH_VTHREADS 256                   // candidates a verify block
#define PH_MAX_TERMS 16                   // posting slots a thread keeps

// x in the sorted list a[0, n)
__device__ __forceinline__ bool holds(const int* a, int n, int x) {
    const int i = lower_bound_i32(a, n, x);
    return i < n && a[i] == x;
}

// the verdict of one candidate: list(i, &po, &pl) gives term i's
// position list (offset and length)
template <class List>
__device__ bool verify(const int* __restrict__ positions, const List& list,
                       int n, int exact, int window) {
    int po0, pl0;
    list(0, po0, pl0);
    const int* l0 = positions + po0;
    for (int a = 0; a < pl0; ++a) {
        const int p0 = l0[a];
        bool ok = true;
        for (int i = 1; i < n && ok; ++i) {
            int poi, pli;
            list(i, poi, pli);
            const int* li = positions + poi;
            if (exact) {
                ok = holds(li, pli, p0 + i);
            } else {
                // the first q with q > p0 - window, then q < p0 + window
                const long long lo = (long long)p0 - window + 1;
                const int x = lo < -2147483647LL ? -2147483647 - 1 : (int)lo;
                const int k = lower_bound_i32(li, pli, x);
                ok = k < pli && (long long)li[k] < (long long)p0 + window;
            }
        }
        if (ok) return true;
    }
    return false;
}

// one (leaf, query) walk: its table row, the walked term and its rows
struct Walk {
    const int* tab;
    int n, allbits, tw, nw;
    long long base;
};

__device__ __forceinline__ Walk walk_of(const int* __restrict__ table,
                                        int cols, int p, int b, int T,
                                        int R, const int* __restrict__ lens,
                                        const int* __restrict__ widths) {
    Walk w;
    w.tab = table + p * cols;
    w.n = w.tab[0];
    w.allbits = w.tab[3];
    w.base = (long long)b * R;
    const int* qlen = lens + (long long)b * T;
    int tw = w.tab[4], nw = min(qlen[tw], widths[tw]);
    for (int i = 1; i < w.n; ++i) {
        const int t = w.tab[4 + i];
        const int r = min(qlen[t], widths[t]);
        if (r < nw) {
            nw = r;
            tw = t;
        }
    }
    w.tw = tw;
    w.nw = nw;
    return w;
}

// walked row j a candidate: every phrase group bit, not deleted
__device__ __forceinline__ bool candidate(
    const Walk& w, const int* __restrict__ row, const int* __restrict__ ob,
    int j, const unsigned char* __restrict__ deleted, long long n_deleted) {
    if ((ob[j] & w.allbits) != w.allbits) return false;
    if (!deleted) return true;
    const int d = row[j];
    const long long dd = (long long)d < n_deleted - 1 ? (long long)d
                                                      : n_deleted - 1;
    return deleted[dd] == 0;
}

// the block's sum of v (every thread gets it)
__device__ __forceinline__ int block_sum(int v, int* red) {
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int i = 0; i < PH_THREADS / 32; ++i) s += red[i];
    return s;
}

// this block's share of zeroing words [lo, hi) of the verdict words, the
// grid's blocks taking equal shares (a multiple of 4 words, 16-byte
// stores; lo a multiple of 4)
__device__ __forceinline__ void fill_share(int* __restrict__ phbits,
                                           long long lo, long long hi) {
    const long long nblk = (long long)gridDim.x * gridDim.y * gridDim.z;
    const long long chunk = ((hi - lo + nblk - 1) / nblk + 3) & ~3LL;
    const long long lid = blockIdx.x + (long long)gridDim.x *
        (blockIdx.y + (long long)gridDim.y * blockIdx.z);
    const long long s0 = lo + lid * chunk;
    const long long s1 = s0 + chunk < hi ? s0 + chunk : hi;
    if (s0 >= s1) return;
    const long long n4 = (s1 - s0) >> 2;
    int4* q = (int4*)(phbits + s0);
    for (long long i = threadIdx.x; i < n4; i += blockDim.x)
        q[i] = make_int4(0, 0, 0, 0);
    for (long long i = s0 + 4 * n4 + threadIdx.x; i < s1; i += blockDim.x)
        phbits[i] = 0;
}

__global__ void __launch_bounds__(PH_THREADS) ph_count_kernel(
    const int* __restrict__ ids, const int* __restrict__ orbits,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ lens,
    const unsigned char* __restrict__ deleted, long long n_deleted,
    const int* __restrict__ table, int cols, int NP, int tiles,
    int* __restrict__ counts, int* __restrict__ phbits) {
    __shared__ int red[PH_THREADS / 32];
    const int x = blockIdx.x, p = blockIdx.y, b = blockIdx.z;
    // the first half of the verdict words' zero fill, beside the count's
    // latency-bound loads
    fill_share(phbits, 0, (((long long)gridDim.z * R) >> 3) << 2);
    const Walk w = walk_of(table, cols, p, b, T, R, lens, widths);
    const long long chain = (long long)b * NP + p;
    const int j0 = x * PH_TILE;
    if (j0 >= w.nw) {
        if (threadIdx.x == 0) counts[chain * tiles + x] = 0;
        return;
    }
    const int* row = ids + w.base + row_off[w.tw];
    const int* ob = orbits + w.base + row_off[w.tw];
    int c = 0;
    const int jt = j0 + threadIdx.x * PH_RPT;
#pragma unroll
    for (int k = 0; k < PH_RPT; ++k)
        if (jt + k < w.nw)
            c += candidate(w, row, ob, jt + k, deleted, n_deleted);
    c = block_sum(c, red);
    if (threadIdx.x == 0) counts[chain * tiles + x] = c;
}

__global__ void __launch_bounds__(PH_THREADS) ph_compact_kernel(
    const int* __restrict__ ids, const int* __restrict__ orbits,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ lens,
    const unsigned char* __restrict__ deleted, long long n_deleted,
    const int* __restrict__ table, int cols, int NP, int tiles,
    int cand_cap, const int* __restrict__ counts, int* __restrict__ cand,
    int* __restrict__ ncand, int* __restrict__ phbits) {
    __shared__ int red[PH_THREADS / 32];
    __shared__ int wsum[PH_THREADS / 32];
    const int x = blockIdx.x, p = blockIdx.y, b = blockIdx.z;
    // the second half of the zero fill, beside the numbering
    fill_share(phbits, (((long long)gridDim.z * R) >> 3) << 2,
               (long long)gridDim.z * R);
    const Walk w = walk_of(table, cols, p, b, T, R, lens, widths);
    const long long chain = (long long)b * NP + p;
    const int* cnt = counts + chain * tiles;
    const int used = (w.nw + PH_TILE - 1) / PH_TILE;   // tiles walked
    if (x == 0) {
        int s = 0;
        for (int i = threadIdx.x; i < used; i += PH_THREADS) s += cnt[i];
        s = block_sum(s, red);
        if (threadIdx.x == 0) ncand[chain] = s < cand_cap ? s : cand_cap;
    }
    if (x >= used) return;
    int pre = 0;
    for (int i = threadIdx.x; i < x; i += PH_THREADS) pre += cnt[i];
    pre = block_sum(pre, red);
    if (pre >= cand_cap) return;
    const int* row = ids + w.base + row_off[w.tw];
    const int* ob = orbits + w.base + row_off[w.tw];
    const int jt = x * PH_TILE + threadIdx.x * PH_RPT;
    unsigned flags = 0;
    int c = 0;
#pragma unroll
    for (int k = 0; k < PH_RPT; ++k)
        if (jt + k < w.nw && candidate(w, row, ob, jt + k, deleted,
                                       n_deleted)) {
            flags |= 1u << k;
            ++c;
        }
    // exclusive scan of the threads' counts in thread (= row) order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = c;
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int idx = pre + inc - c;
    for (int i = 0; i < warp; ++i) idx += wsum[i];
    int* list = cand + chain * cand_cap;
#pragma unroll
    for (int k = 0; k < PH_RPT; ++k)
        if ((flags >> k) & 1u) {
            if (idx < cand_cap) list[idx] = row_off[w.tw] + jt + k;
            ++idx;
        }
}

__global__ void __launch_bounds__(PH_VTHREADS) ph_verify_kernel(
    const int* __restrict__ ids, const int* __restrict__ orbits,
    const int* __restrict__ widths, const int* __restrict__ row_off, int T,
    int R, const int* __restrict__ offsets, const int* __restrict__ lens,
    const int* __restrict__ bits, const int* __restrict__ posoff,
    const int* __restrict__ poslen, const int* __restrict__ positions,
    const int* __restrict__ table, int cols, int NP, int cand_cap, int pmax,
    const int* __restrict__ cand, const int* __restrict__ ncand,
    int* __restrict__ phbits) {
    const int p = blockIdx.y, b = blockIdx.z;
    const long long chain = (long long)b * NP + p;
    const int i0 = blockIdx.x * PH_VTHREADS + threadIdx.x;
    if (i0 >= ncand[chain]) return;
    const Walk w = walk_of(table, cols, p, b, T, R, lens, widths);
    const int* qoff = offsets + (long long)b * T;
    const int* qlen = lens + (long long)b * T;
    const int r0 = cand[chain * cand_cap + i0];
    const int d = ids[w.base + r0];
    const int ob = orbits[w.base + r0];
    auto rows = [&](int t) { return min(qlen[t], widths[t]); };
    // term t's row of doc d (within its block), or -1
    auto pos_of = [&](int t) -> int {
        if (t == w.tw) return r0 - row_off[t];
        const int* blk = ids + w.base + row_off[t];
        const int pos = lower_bound_i32(blk, rows(t), d);
        return pos < rows(t) && blk[pos] == d ? pos : -1;
    };
    int pos[PH_MAX_TERMS], po[PH_MAX_TERMS], pl[PH_MAX_TERMS];
    const int n = w.n;
    for (int i = 0; i < n && i < PH_MAX_TERMS; ++i) {
        const int t = w.tab[4 + i];
        pos[i] = pos_of(t);   // found: the doc holds every phrase term
        if (pos[i] < 0) return;
        const long long slot = (long long)qoff[t] + pos[i];
        po[i] = posoff[slot];
        pl[i] = min(poslen[slot], pmax);
    }
    // the owner: the lowest-numbered term holding d
    int owner = r0;
    for (int u = 0; u < T; ++u) {
        if (!(ob & bits[(long long)b * T + u])) continue;
        int q = -2;
        for (int i = 0; i < n && i < PH_MAX_TERMS; ++i)
            if (w.tab[4 + i] == u) q = pos[i];
        if (q == -2) q = pos_of(u);
        if (q >= 0) {
            owner = row_off[u] + q;
            break;
        }
    }
    auto list = [&](int i, int& o, int& l) {
        if (i < PH_MAX_TERMS) {
            o = po[i];
            l = pl[i];
        } else {
            const int t = w.tab[4 + i];
            const long long slot = (long long)qoff[t] + pos_of(t);
            o = posoff[slot];
            l = min(poslen[slot], pmax);
        }
    };
    if (verify(positions, list, n, w.tab[1], w.tab[2]))
        atomicOr(phbits + w.base + owner, (int)(1u << p));
}

extern "C" int xt_phrase_leaves(
    const void* ids, const void* widths, const void* row_off, int B, int T,
    int R, const void* offsets, const void* lens, const void* orbits,
    const void* deleted, long long n_deleted, const void* bits,
    const void* posoff, const void* poslen, const void* positions,
    const void* table, int cols, int NP, int cand_cap, int pmax, int tiles,
    void* counts, void* cand, void* phbits, void* ncand, void* stream) {
    if (B == 0 || NP == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(tiles, NP, B);
    ph_count_kernel<<<grid, PH_THREADS, 0, st>>>(
        (const int*)ids, (const int*)orbits, (const int*)widths,
        (const int*)row_off, T, R, (const int*)lens,
        (const unsigned char*)deleted, n_deleted, (const int*)table, cols, NP,
        tiles, (int*)counts, (int*)phbits);
    ph_compact_kernel<<<grid, PH_THREADS, 0, st>>>(
        (const int*)ids, (const int*)orbits, (const int*)widths,
        (const int*)row_off, T, R, (const int*)lens,
        (const unsigned char*)deleted, n_deleted, (const int*)table, cols, NP,
        tiles, cand_cap, (const int*)counts, (int*)cand, (int*)ncand,
        (int*)phbits);
    const dim3 vgrid(max(1, (cand_cap + PH_VTHREADS - 1) / PH_VTHREADS), NP,
                     B);
    ph_verify_kernel<<<vgrid, PH_VTHREADS, 0, st>>>(
        (const int*)ids, (const int*)orbits, (const int*)widths,
        (const int*)row_off, T, R, (const int*)offsets, (const int*)lens,
        (const int*)bits, (const int*)posoff, (const int*)poslen,
        (const int*)positions, (const int*)table, cols, NP, cand_cap, pmax,
        (const int*)cand, (const int*)ncand, (int*)phbits);
    return (int)cudaGetLastError();
}
