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
//   - the candidates: the docs holding every phrase term that are not
//     deleted, in ascending docid order; only the first cand_cap are
//     verified and the rest are false (the documented cap of ops/phrase.py
//     14-16, reproduced exactly: it decides counts and ranks);
//   - each term's positions: the first min(poslen, pmax) entries of the
//     (term, doc) block of `positions`, which the segment builders keep
//     sorted (xapiand_tpu/models/builder.py 393, native.cpp 1434);
//   - PHRASE: some p0 of t0 has p0 + i among the positions of ti, every i;
//     NEAR: some p0 of t0 has, for every i, a position q of ti with
//     |q - p0| < window;
//   - the verdict is set at the doc's owner row (merge_docs' owner: the
//     doc's row in the lowest-numbered term holding it), bit p of the row's
//     word for phrase leaf p; filter_leaves reads the word (PH leaves of the
//     tree program).
//
// The TPU compacted candidates with a full-width docid sort, found each
// candidate's posting by a two-sort join per term and compared [C, pmax,
// pmax] position windows by broadcast. The port's rows are grouped by term
// (docid-ascending within each term block), and its gathers do not
// serialise, so one block per (phrase leaf, query) walks the block of the
// phrase term with the fewest postings in docid order - every candidate is
// in it - 256 rows at a time:
//   1. each thread binary-searches its doc in the other phrase terms'
//      blocks (K15, common.cuh lower_bound_i32), which gives the posting
//      slot and hence posoff / poslen, then finds the doc's owner row the
//      same way and reads `first` there (owner & not deleted);
//   2. the block numbers its candidates in docid order with a ballot and a
//      prefix sum over the 8 warps' counts, as compact_rows.cu numbers rows,
//      keeping a running count across chunks;
//   3. a candidate numbered below cand_cap is verified by its thread:
//      for each of t0's positions, a binary search in each other sorted
//      list (PHRASE: p0 + i; NEAR: the first q >= p0 - window + 1, which
//      must be < p0 + window), and a true verdict ORs bit p into the owner
//      row's word (atomicOr: leaves of one query run in other blocks);
//   4. the walk stops once cand_cap candidates are numbered.
// Positions past a list's end are never read (the TPU read pmax entries
// and masked them; the 128-zero guard of `positions` kept that in bounds).
//
// Phrase table, int32 per leaf: n_terms, exact (1 PHRASE, 0 NEAR),
// window, 0, then the n term indices (up to PH_MAX_TERMS).
//
// Bound on the H100: the latency of dependent loads - a binary search per
// walked row and term (L2-resident term blocks), then per candidate a few
// position loads and searches - and, at config 2's shapes, the B x NP
// blocks: 64 per launch group on 132 SMs. A wider grid (several blocks per
// leaf, a decoupled scan for the numbering) is later work.
#include "common.cuh"

#define PH_THREADS 256
#define PH_WARPS (PH_THREADS / 32)
#define PH_MAX_TERMS 16
#define PH_COLS (4 + PH_MAX_TERMS)

// x in the sorted list a[0, n)
__device__ __forceinline__ bool holds(const int* a, int n, int x) {
    const int i = lower_bound_i32(a, n, x);
    return i < n && a[i] == x;
}

// the verdict of one candidate: po / pl its lists' offsets and lengths
__device__ bool verify(const int* __restrict__ positions, const int* po,
                       const int* pl, int n, int exact, int window) {
    const int* l0 = positions + po[0];
    for (int a = 0; a < pl[0]; ++a) {
        const int p0 = l0[a];
        bool ok = true;
        for (int i = 1; i < n && ok; ++i) {
            const int* li = positions + po[i];
            if (exact) {
                ok = holds(li, pl[i], p0 + i);
            } else {
                // the first q with q > p0 - window, then q < p0 + window
                const long long lo = (long long)p0 - window + 1;
                const int x = lo < -2147483647LL ? -2147483647 - 1 : (int)lo;
                const int k = lower_bound_i32(li, pl[i], x);
                ok = k < pl[i] && (long long)li[k] < (long long)p0 + window;
            }
        }
        if (ok) return true;
    }
    return false;
}

__global__ void __launch_bounds__(PH_THREADS) phrase_leaves_kernel(
    const int* __restrict__ ids, const int* __restrict__ widths,
    const int* __restrict__ row_off, int T, int R,
    const int* __restrict__ offsets, const int* __restrict__ lens,
    const unsigned char* __restrict__ first,
    const int* __restrict__ posoff, const int* __restrict__ poslen,
    const int* __restrict__ positions, const int* __restrict__ table,
    int NP, int cand_cap, int pmax, int* __restrict__ phbits,
    int* __restrict__ ncand) {
    __shared__ int warp_n[PH_WARPS];
    __shared__ int running;
    const int p = blockIdx.x, b = blockIdx.y;
    const int* tab = table + p * PH_COLS;
    const int n = tab[0], exact = tab[1], window = tab[2];
    const long long base = (long long)b * R;
    const int* qoff = offsets + (long long)b * T;
    const int* qlen = lens + (long long)b * T;
    // rows of term t that hold postings
    auto rows = [&](int t) { return qlen[t] < widths[t] ? qlen[t]
                                                         : widths[t]; };
    int tw = tab[4], nw = rows(tab[4]);
    for (int i = 1; i < n; ++i) {
        const int t = tab[4 + i];
        if (rows(t) < nw) {
            nw = rows(t);
            tw = t;
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) running = 0;
    __syncthreads();
    for (int c0 = 0; c0 < nw; c0 += PH_THREADS) {
        const int j = c0 + threadIdx.x;
        int po[PH_MAX_TERMS], pl[PH_MAX_TERMS];
        int owner = 0;
        bool cand = j < nw;
        if (cand) {
            const int d = ids[base + row_off[tw] + j];
            for (int i = 0; i < n && cand; ++i) {
                const int t = tab[4 + i];
                int pos = j;
                if (t != tw) {
                    pos = lower_bound_i32(ids + base + row_off[t], rows(t), d);
                    cand = pos < rows(t) && ids[base + row_off[t] + pos] == d;
                }
                if (cand) {
                    const long long slot = (long long)qoff[t] + pos;
                    po[i] = posoff[slot];
                    const int l = poslen[slot];
                    pl[i] = l < pmax ? l : pmax;
                }
            }
            if (cand) {
                int u = 0;
                for (; u < T; ++u) {
                    const int* blk = ids + base + row_off[u];
                    const int pos = lower_bound_i32(blk, rows(u), d);
                    if (pos < rows(u) && blk[pos] == d) {
                        owner = row_off[u] + pos;
                        break;
                    }
                }
                cand = u < T && first[base + owner] != 0;
            }
        }
        // number the candidates of this chunk in row (= docid) order
        const unsigned bal = __ballot_sync(0xffffffffu, cand);
        if (lane == 0) warp_n[warp] = __popc(bal);
        __syncthreads();
        int idx = running + __popc(bal & ((1u << lane) - 1u));
        int total = 0;
#pragma unroll
        for (int w = 0; w < PH_WARPS; ++w) {
            if (w < warp) idx += warp_n[w];
            total += warp_n[w];
        }
        if (cand && idx < cand_cap &&
            verify(positions, po, pl, n, exact, window))
            atomicOr(phbits + base + owner, (int)(1u << p));
        __syncthreads();
        if (threadIdx.x == 0) running += total;
        __syncthreads();
        if (running >= cand_cap) break;
    }
    if (threadIdx.x == 0)
        ncand[(long long)b * NP + p] = running < cand_cap ? running
                                                          : cand_cap;
}

extern "C" int xt_phrase_leaves(const void* ids, const void* widths,
                                const void* row_off, int B, int T, int R,
                                const void* offsets, const void* lens,
                                const void* first, const void* posoff,
                                const void* poslen, const void* positions,
                                const void* table, int NP, int cand_cap,
                                int pmax, void* phbits, void* ncand,
                                void* stream) {
    if (B == 0 || NP == 0) return 0;
    dim3 grid(NP, B);
    phrase_leaves_kernel<<<grid, PH_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)widths, (const int*)row_off, T, R,
        (const int*)offsets, (const int*)lens, (const unsigned char*)first,
        (const int*)posoff, (const int*)poslen, (const int*)positions,
        (const int*)table, NP, cand_cap, pmax, (int*)phbits, (int*)ncand);
    return (int)cudaGetLastError();
}
