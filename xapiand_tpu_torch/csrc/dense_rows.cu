// dense_rows: the rows of the dense match-all path, one per (query, doc).
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _execute_dense 1237-1280:
// d = arange(ND+1), live = not deleted and not the pad doc, and per term a
// scatter of its posting block over the doc axis (.at[idt].max for the
// group mask, .at[idt].add for the scheme's weight, 1262-1271), the pad
// doc's score set to 0; the masks group_leaf 1276-1280 reads.
//
// The weight is the query's scheme (common.cuh scheme_sumpart; BM25 the
// GENERIC = false instance, as before the other schemes), tconst
// f32[B, T, C], with uniq[d] (f32[ND+1], nullptr when the scheme reads
// none) for DiceCoeff and LM absolute discount.
//
// Outputs per query: ids = the docid of each row (the row index), scores,
// orbits (bit g where a term of group g holds the doc; the pad doc 0) and
// live, the mask every later kernel takes as its base. A plan with no real
// term (_match_all alone: every lens 0) reads no posting and writes zeros.
//
// Bound on the H100: the function reads each term block's postings once
// (12 bytes each) and writes 8 bytes a row (scores, orbits) and one live
// flag a doc; this kernel writes 13 bytes a row - the docid and the live
// flag of every row of every query too, because the kernels after it read
// ids and a base mask as [B, R] arrays - so it runs at 13/8 of its byte
// bound at best.
//
// Design. The TPU scattered because each term block is a contiguous slice;
// on the H100 a float scatter-add means float atomics, whose order is not
// fixed. The first version gathered instead, one thread per (query, doc)
// binary-searching the doc in every term's block: B x ND x T searches of
// ~18 dependent L2 loads each, 6-8x its bound where terms are real. Now
// grid (runs, B): a block takes a run of `per` consecutive doc tiles of
// DR_TILE docs (ops/kernels.py dense_per: B x runs within one wave of
// blocks where a term's slice is long; one tile a block where every slice
// is short and a search costs little, as at browse M). It finds
// each term's first posting of the run once, by binary search in the
// slice the TPU reads (classes[t] rows from the clamped start, of which
// the first min(lens, classes[t]) count), and carries that cursor from
// tile to tile: a tile's postings of a term are the 256-wide chunks from
// the cursor on whose docids fall in the tile (the first chunk that is
// not all in it ends the range, __syncthreads_count), read coalesced. Each
// weight is added into the tile's shared scores and each term's bit ORed
// into its shared orbits, term by term (t = 0..T-1; a term holds a doc
// once, so no two threads touch one slot within a term and no atomic is
// needed). The per-doc sum is s = s + w in term order with score_slices'
// float32 arithmetic (-fmad=false), the scatter's and the plain
// version's, the same bits on every launch. Then the tile is written
// once, four rows a thread with 16-byte stores (the live flags 4 bytes;
// the row base b (ND+1) is aligned only at multiples of 4, so the up to 3
// rows at either end of a tile go one by one). A plan without postings
// skips the shared sums and writes zeros. The searches fall from B x ND x
// T to B x runs x T, and each posting is read once (a chunk's tail past a
// tile again from L2).
#include "common.cuh"

#define DR_THREADS 256
#define DR_TILE 4096    // docs a tile: 36 KB of shared sums, bits, flags

// one row's outputs from the tile's shared sums, bits and deleted flags
// (none: a plan without postings, zeros); the pad doc (ND1 - 1) has score
// and bits 0 and is not live
__device__ __forceinline__ void dr_row(
    long long o, long long row0, int d0, int ND1, const float* s_sc,
    const unsigned* s_ob, bool none, const unsigned char* s_del,
    int& id, float& s, int& ob, unsigned char& lv) {
    const int d = (int)(o - row0);
    const bool real = d < ND1 - 1;
    id = d;
    s = (real && !none) ? s_sc[d - d0] : 0.0f;
    ob = (real && !none) ? (int)s_ob[d - d0] : 0;
    lv = (unsigned char)(real && !s_del[d - d0]);
}

__device__ __forceinline__ void dr_store1(
    long long o, long long row0, int d0, int ND1, const float* s_sc,
    const unsigned* s_ob, bool none, const unsigned char* s_del, int* ids,
    float* scores, int* orbits, unsigned char* live) {
    int id, ob;
    float sc;
    unsigned char lv;
    dr_row(o, row0, d0, ND1, s_sc, s_ob, none, s_del, id, sc, ob, lv);
    ids[o] = id;
    scores[o] = sc;
    orbits[o] = ob;
    live[o] = lv;
}

// grid (runs, B): block (j, b) takes doc tiles j x per .. j x per + per - 1
// of query b. Dynamic shared memory: each term's slice start (i64), its
// counted rows and its cursor (i32 each).
template <bool GENERIC>
__global__ void __launch_bounds__(DR_THREADS) dense_rows_kernel(
    const int* __restrict__ post_docids, const float* __restrict__ post_wdf,
    const float* __restrict__ post_doclen, long long n_post,
    const int* __restrict__ offsets, const int* __restrict__ lens,
    const float* __restrict__ tconst, const float* __restrict__ scoring,
    const int* __restrict__ bits, const int* __restrict__ classes, int T,
    const unsigned char* __restrict__ deleted, int ND1, SchemeSpec sp, int C,
    const float* __restrict__ uniq, int per, int vec, int* __restrict__ ids,
    float* __restrict__ scores, int* __restrict__ orbits,
    unsigned char* __restrict__ live) {
    __shared__ float s_sc[DR_TILE];
    __shared__ unsigned s_ob[DR_TILE];
    __shared__ __align__(16) unsigned char s_del[DR_TILE];
    __shared__ int s_any;
    extern __shared__ long long dr_terms[];
    long long* s_start = dr_terms;
    int* s_ln = reinterpret_cast<int*>(dr_terms + T);
    int* s_cur = s_ln + T;
    const int b = blockIdx.y;
    const int first = blockIdx.x * per * DR_TILE;
    if (threadIdx.x == 0) s_any = 0;
    __syncthreads();
    // each term's slice (classes[t] rows from the clamped start, the first
    // min(lens, classes[t]) counting) and its cursor at the run's first doc
    for (int t = threadIdx.x; t < T; t += DR_THREADS) {
        const int bt = b * T + t;
        const int W = classes[t];
        int ln = lens[bt];
        if (ln > W) ln = W;
        if (ln < 0) ln = 0;
        long long start = (long long)offsets[bt];
        if (start > n_post - W) start = n_post - W;
        if (start < 0) start = 0;
        s_start[t] = start;
        s_ln[t] = ln;
        s_cur[t] = ln > 0 ? lower_bound_i32(post_docids + start, ln, first)
                          : 0;
        if (ln > 0) s_any = 1;
    }
    __syncthreads();
    const bool none = s_any == 0;
    const long long row0 = (long long)b * ND1;
    for (int tl = 0; tl < per; ++tl) {
        const int d0 = first + tl * DR_TILE;
        if (d0 >= ND1) break;
        const int d1 = d0 + DR_TILE < ND1 ? d0 + DR_TILE : ND1;
        // the tile's deleted flags, one 16-byte load a thread (the last
        // tile's tail byte by byte): the writes below read them from here
        for (int i = 16 * threadIdx.x; i < DR_TILE; i += 16 * DR_THREADS) {
            if (vec && d0 + i + 16 <= d1) {
                *reinterpret_cast<uint4*>(s_del + i) =
                    __ldg(reinterpret_cast<const uint4*>(deleted + d0 + i));
            } else {
                for (int j = i; j < i + 16 && d0 + j < d1; ++j)
                    s_del[j] = deleted[d0 + j];
            }
        }
        if (none) __syncthreads();
        if (!none) {
            for (int i = threadIdx.x; i < DR_TILE; i += DR_THREADS) {
                s_sc[i] = 0.0f;
                s_ob[i] = 0u;
            }
            __syncthreads();
            // term by term: the postings from the cursor on that fall in
            // the tile, 256 at a time; the first chunk not all in the tile
            // ends the term's range, and the cursor moves past it
            for (int t = 0; t < T; ++t) {
                const int ln = s_ln[t];
                const int* blk = post_docids + s_start[t];
                const int bt = b * T + t;
                int c = s_cur[t];
                while (c < ln) {
                    const int p = c + threadIdx.x;
                    const int d = p < ln ? blk[p] : ND1;
                    const bool in = d < d1;
                    if (in) {
                        const long long q = s_start[t] + p;
                        const float* tc =
                            tconst + (long long)bt * (GENERIC ? C : 1);
                        const float u = (GENERIC && uniq != nullptr)
                                            ? uniq[d] : 1.0f;
                        const float w = scored<GENERIC>(
                            scheme_sumpart<GENERIC>(sp, post_wdf[q],
                                                    post_doclen[q], tc, u),
                            scoring[bt]);
                        s_sc[d - d0] = s_sc[d - d0] + w;
                        s_ob[d - d0] |= (unsigned)bits[bt];
                    }
                    const int n_in = __syncthreads_count(in);
                    c += n_in;
                    if (n_in < DR_THREADS) break;
                }
                if (threadIdx.x == 0) s_cur[t] = c;
            }
            __syncthreads();
        }
        const long long o0 = row0 + d0, o1 = row0 + d1;
        long long v0 = (o0 + 3) & ~3ll;
        if (v0 > o1 || !vec) v0 = o1;
        long long v1 = o1 & ~3ll;
        if (v1 < v0) v1 = v0;
        // one by one: the rows before the first aligned one (all of them
        // without vec) and after the last
        for (long long o = o0 + threadIdx.x; o < v0; o += DR_THREADS)
            dr_store1(o, row0, d0, ND1, s_sc, s_ob, none, s_del, ids,
                      scores, orbits, live);
        for (long long o = v1 + threadIdx.x; o < o1; o += DR_THREADS)
            dr_store1(o, row0, d0, ND1, s_sc, s_ob, none, s_del, ids,
                      scores, orbits, live);
        for (long long o = v0 + 4 * threadIdx.x; o < v1;
             o += 4 * DR_THREADS) {
            int id[4], ob[4];
            float sc[4];
            unsigned char lv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                dr_row(o + i, row0, d0, ND1, s_sc, s_ob, none, s_del,
                       id[i], sc[i], ob[i], lv[i]);
            *reinterpret_cast<int4*>(ids + o) =
                make_int4(id[0], id[1], id[2], id[3]);
            *reinterpret_cast<float4*>(scores + o) =
                make_float4(sc[0], sc[1], sc[2], sc[3]);
            *reinterpret_cast<int4*>(orbits + o) =
                make_int4(ob[0], ob[1], ob[2], ob[3]);
            *reinterpret_cast<unsigned*>(live + o) =
                (unsigned)lv[0] | ((unsigned)lv[1] << 8) |
                ((unsigned)lv[2] << 16) | ((unsigned)lv[3] << 24);
        }
        __syncthreads();   // the tile's sums are read before the next's
    }
}

static bool dr_aligned(const void* p, unsigned a) {
    return ((unsigned long long)p & (a - 1)) == 0;
}

extern "C" int xt_dense_rows(
    const void* post_docids, const void* post_wdf, const void* post_doclen,
    long long n_post, const void* offsets, const void* lens,
    const void* tconst, const void* scoring, const void* bits,
    const void* classes, int B, int T, const void* deleted, int ND1,
    int scheme, const float* params, int C, const void* uniq, int per,
    void* ids, void* scores, void* orbits, void* live, void* stream) {
    if (B == 0 || ND1 == 0) return 0;
    if (per < 1) per = 1;
    const SchemeSpec sp = make_spec(scheme, params);
    auto kernel = scheme == XT_SCHEME_BM25 ? dense_rows_kernel<false>
                                           : dense_rows_kernel<true>;
    const int vec = dr_aligned(ids, 16) && dr_aligned(scores, 16) &&
                    dr_aligned(orbits, 16) && dr_aligned(live, 4) &&
                    dr_aligned(deleted, 16);
    const long long tiles = (ND1 + DR_TILE - 1) / DR_TILE;
    const size_t dyn = (size_t)T * (sizeof(long long) + 2 * sizeof(int));
    if (dyn > 12 * 1024)
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
    dim3 grid((unsigned)((tiles + per - 1) / per), B);
    kernel<<<grid, DR_THREADS, dyn, (cudaStream_t)stream>>>(
        (const int*)post_docids, (const float*)post_wdf,
        (const float*)post_doclen, n_post, (const int*)offsets,
        (const int*)lens, (const float*)tconst, (const float*)scoring,
        (const int*)bits, (const int*)classes, T,
        (const unsigned char*)deleted, ND1, sp, C, (const float*)uniq, per,
        vec, (int*)ids, (float*)scores, (int*)orbits, (unsigned char*)live);
    return (int)cudaGetLastError();
}
