// collapse_rows: the survivors of a collapse - per collapse key the best
// min(collapse_max, 8) eligible rows by score - and each row's tie rank.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _collapse 577-617: one stable
// lax.sort of every row by (solo flag, key hi, key lo or docid, -score),
// the group heads, and the head-shift loop that keeps the rows whose rank
// within their group is below the maximum. The TPU sorted because its
// gathers and scatters serialise; nothing downstream of this kernel needs
// the permuted layout (the port reads value columns by docid), so the rows
// stay where they are and the kernel writes two per-row words instead:
//   keep  the row is eligible and either its doc has no value in the slot
//         (`solo`: all of these survive) or fewer than cmax eligible rows
//         of the same (hi, lo) key precede it in the order (score
//         descending, then the stable sort's order): docid ascending for
//         rows that enter docid-ascending (the sort and relevance paths),
//         row index ascending with row_order (the join path's term-grouped
//         rows, whose stable sort keeps row order);
//   tie   where the row lands among survivors of equal score: for a
//         grouped row rank * cmax + j, rank the rank of its key among the
//         query's distinct keys ((hi, lo) ascending) and j its place among
//         its key's survivors (cmax - 1 past them); INT32_MAX for a solo
//         row. lax.top_k takes the lower position of equal scores in the
//         collapsed order, which is (tie, docid) ascending: equal-score
//         survivors of one key come in their j order, which is the
//         stable sort's; topk_rows orders ties by this word.
// A row's order is one packed word (cr_pack: score key, then ~docid or
// ~row; larger is better, never 0), and the rows of a query have distinct
// words, so a key's survivors are its cmax largest words.
//
// Two designs; kernels.collapse_plan picks one per call from the column's
// distinct keys (counted once a column), never inside a kernel.
//
// Tiles (xt_collapse_tiles; the column has few distinct keys, a
// categorical facet: browse C's 40 categories), scratch sized by the keys:
//   1. tile: grid (G, B), 1024 threads;
//      block g takes the chunks g, g + G, ... of 4096 rows of query b and
//      keeps, in shared memory, an open-addressed table of TS slots (a
//      power of two >= 2 D, D the column's distinct keys; the all-ones key
//      in the reserved slot TS) with each key's best cmax words so far. A
//      chunk: each thread's 4 rows' loads are issued together (flag,
//      docid, score; then the column's flag; then the key), the rows' keys
//      are inserted, then cmax rounds, round j admitting only words below
//      round j - 1's winner of their key, over the chunk's rows and the
//      key's words from the earlier chunks. A round takes the high 32
//      bits' maximum, then the low 32 bits' among the candidates that
//      reach it: 32-bit shared atomicMax, one a row that still beats the
//      slot's word when it looks. The earlier chunks' words enter a round
//      first (a plain store: one thread a slot), so after a block's first
//      chunk the rows of a hot key mostly look and pass; a row below its
//      key's cmax-th earlier word takes no part. (Grouping a warp's lanes
//      by slot first, __match_any_sync and one atomic a slot, did not pay
//      on the H100: a warp holds ~20 of browse C's 40 keys.) The
//      block writes its keys and words as a list: B x G x (TS + 1) x
//      (1 + cmax) words of scratch at most, nothing cleared. (Merging
//      clusters of 8 blocks' tables through distributed shared memory
//      first was slower at 5 of the 7 launches the paths make.)
//   2. merge: one block a query builds the query's table from the G
//      lists by the same rounds (a list's best word below the limit is its
//      first one), sorts the query's distinct keys (bitonic, shared
//      memory) and writes each slot's key, cmax words and rank.
//   3. out: grid (row tiles, B) re-reads the rows: keep = the row's word
//      >= its key's cmax-th word (0 where the key has fewer rows), j = the
//      key's words above it (cut at cmax - 1), tie = rank * cmax + j.
// A table that overflows (a stale distinct count) traps: it raises at the
// wrapper's next synchronisation, never a silent answer.
//
// Global (xt_collapse_rows; many distinct keys: a docid-like column), five
// steps, each a launch over (row tiles, B), on per-query scratch:
//   1. insert: every grouped row (eligible, value present) puts its 64-bit
//      key into the query's open-addressed table (a power of two >= 2 R
//      slots) with atomicCAS and remembers its slot. All-ones marks an
//      empty slot; a key of all ones takes the reserved slot `cap`.
//   2. round 0: atomicMax of the row's packed (score, ~docid or ~row) word
//      into its slot: the key's best row.
//   3. list + sort: the occupied slots' keys, order-mapped (sign bits
//      flipped), are appended to the query's list and sorted by one block
//      (bitonic, in global memory); a key's rank is its index there.
//   4. rounds 1 .. cmax-1: each round's atomicMax admits only rows below
//      the previous round's winner of their slot, so round j leaves the
//      key's (j+1)-th best row (0 when the key has fewer rows); round j
//      marks the previous round's winner with j - 1 in tie.
//   5. final: keep = packed >= the last round's word of the slot; tie by
//      binary search of the key in the sorted list, times cmax, plus the
//      mark.
// Integer maxima and the set of inserted keys depend on no scheduling
// order, so keep and tie are the same bits on every launch, in both
// designs.
//
// Bound on the H100: the rows are read once (9 bytes, and 9 of the value
// column per eligible row), keep and tie written (5 bytes); cmax table
// operations per grouped row. The tiles read the rows twice (the tile and
// the out pass; the column's rows come from L2 the second time) and make
// 3 launches; the global design reads them 3 + cmax times, clears 3 + 1
// tables of 2 R slots per query and sorts the key list with one block -
// slow when R is large, and the only choice when D nears R.
#include "common.cuh"

#define CR_EMPTY 0xffffffffffffffffull
#define CR_THREADS 256

// (score desc, docid or row asc) as one ascending-is-better word, never 0;
// a NaN score is the worst (lax.sort puts NaN last)
__device__ __forceinline__ unsigned long long cr_pack(float s, int d) {
    const unsigned hi = (s != s) ? 0u : fkey(s);
    return ((unsigned long long)hi << 32) | (unsigned long long)(~(unsigned)d);
}

struct CollapseCol {
    const int* hi;
    const int* lo;
    const unsigned char* present;
    long long n;
};

__global__ void collapse_insert_kernel(
    const int* __restrict__ ids, const unsigned char* __restrict__ elig,
    int R, CollapseCol col, unsigned long long* __restrict__ table,
    long long cap, int* __restrict__ slot, int cmax, int* __restrict__ tie) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const long long o = (long long)b * R + r;
    int s = -1;
    if (elig[o]) {
        const long long d = ids[o];
        const long long dd = d < col.n - 1 ? d : col.n - 1;
        if (col.present[dd]) {
            const unsigned long long key =
                ((unsigned long long)(unsigned)col.hi[dd] << 32) |
                (unsigned)col.lo[dd];
            unsigned long long* tab = table + (long long)b * (cap + 1);
            if (key == CR_EMPTY) {
                s = (int)cap;
            } else {
                long long h = (long long)(mix64(key) &
                                          (unsigned long long)(cap - 1));
                for (;;) {
                    // look before the atomic: a categorical key's rows
                    // meet in few slots
                    unsigned long long prev =
                        *(volatile unsigned long long*)&tab[h];
                    if (prev == CR_EMPTY)
                        prev = atomicCAS(&tab[h], CR_EMPTY, key);
                    if (prev == CR_EMPTY || prev == key) break;
                    h = (h + 1) & (cap - 1);
                }
                s = (int)h;
            }
        }
    }
    slot[o] = s;
    tie[o] = cmax - 1;   // the mark of a row no round before the last wins
}

__global__ void collapse_round_kernel(
    const int* __restrict__ ids, const float* __restrict__ sums, int R,
    int row_order, const int* __restrict__ slot, long long cap,
    const unsigned long long* __restrict__ prev,
    unsigned long long* __restrict__ cur, int round,
    int* __restrict__ tie) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const long long o = (long long)b * R + r;
    const int s = slot[o];
    if (s < 0) return;
    const unsigned long long p = cr_pack(sums[o], row_order ? r : ids[o]);
    const long long at = (long long)b * (cap + 1) + s;
    if (prev != nullptr && p == prev[at]) tie[o] = round - 1;
    if ((prev == nullptr || p < prev[at]) &&
        *(volatile unsigned long long*)&cur[at] < p)
        atomicMax(&cur[at], p);
}

__global__ void collapse_list_kernel(
    const unsigned long long* __restrict__ table,
    const unsigned long long* __restrict__ best0, long long cap,
    unsigned long long* __restrict__ list, long long lcap,
    int* __restrict__ nkeys) {
    const int b = blockIdx.y;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i > cap) return;
    const long long at = (long long)b * (cap + 1) + i;
    // the reserved slot holds the all-ones key when round 0 reached it
    const bool used = i < cap ? table[at] != CR_EMPTY : best0[at] != 0ull;
    if (!used) return;
    const unsigned long long key = i < cap ? table[at] : CR_EMPTY;
    const int pos = atomicAdd(nkeys + b, 1);
    list[(long long)b * lcap + pos] = key ^ 0x8000000080000000ull;
}

__global__ void collapse_sort_kernel(unsigned long long* __restrict__ list,
                                     long long lcap,
                                     const int* __restrict__ nkeys) {
    const int b = blockIdx.x;
    unsigned long long* a = list + (long long)b * lcap;
    const int n = nkeys[b];
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    // slots past n hold all ones (the fill), the maximum: they sort last
    for (int k = 2; k <= n2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n2; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const bool up = (i & k) == 0;
                    const unsigned long long x = a[i], y = a[ixj];
                    if ((x > y) == up) {
                        a[i] = y;
                        a[ixj] = x;
                    }
                }
            }
            __syncthreads();
        }
    }
}

__global__ void collapse_final_kernel(
    const int* __restrict__ ids, const float* __restrict__ sums,
    const unsigned char* __restrict__ elig, int R, int row_order, int cmax,
    const int* __restrict__ slot, const unsigned long long* __restrict__ table,
    long long cap, const unsigned long long* __restrict__ last,
    const unsigned long long* __restrict__ list, long long lcap,
    const int* __restrict__ nkeys, unsigned char* __restrict__ keep,
    int* __restrict__ tie) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const long long o = (long long)b * R + r;
    const int s = slot[o];
    unsigned char kp = elig[o];
    int tr = XT_I32MAX;
    if (s >= 0) {
        const long long at = (long long)b * (cap + 1) + s;
        kp = cr_pack(sums[o], row_order ? r : ids[o]) >= last[at];
        const unsigned long long key =
            (s < cap ? table[at] : CR_EMPTY) ^ 0x8000000080000000ull;
        const unsigned long long* a = list + (long long)b * lcap;
        int lo = 0, hi = nkeys[b];
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (a[mid] < key) lo = mid + 1; else hi = mid;
        }
        tr = lo * cmax + tie[o];
    }
    keep[o] = kp;
    tie[o] = tr;
}

// Scratch, all written here: table and the two round buffers u64[B, cap+1],
// slot i32[B, R], list u64[B, lcap] (lcap a power of two >= R), nkeys
// i32[B]. cmax >= 1 (the caller caps it at 8); row_order 1 ranks equal
// scores of a key by row index, 0 by docid.
extern "C" int xt_collapse_rows(
    const void* ids, const void* sums, const void* elig, int B, int R,
    const void* col_hi, const void* col_lo, const void* col_present,
    long long n_col, int cmax, int row_order, void* table, long long cap,
    void* round_a, void* round_b, void* slot, void* list, long long lcap,
    void* nkeys, void* keep, void* tie, void* stream) {
    if (B == 0 || R == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t tab_bytes = sizeof(unsigned long long) * (size_t)B * (cap + 1);
    cudaMemsetAsync(table, 0xff, tab_bytes, st);
    cudaMemsetAsync(list, 0xff, sizeof(unsigned long long) * (size_t)B * lcap,
                    st);
    cudaMemsetAsync(nkeys, 0, sizeof(int) * B, st);
    cudaMemsetAsync(round_a, 0, tab_bytes, st);
    CollapseCol col{(const int*)col_hi, (const int*)col_lo,
                    (const unsigned char*)col_present, n_col};
    dim3 grid((R + CR_THREADS - 1) / CR_THREADS, B);
    collapse_insert_kernel<<<grid, CR_THREADS, 0, st>>>(
        (const int*)ids, (const unsigned char*)elig, R, col,
        (unsigned long long*)table, cap, (int*)slot, cmax, (int*)tie);
    unsigned long long* cur = (unsigned long long*)round_a;
    unsigned long long* other = (unsigned long long*)round_b;
    collapse_round_kernel<<<grid, CR_THREADS, 0, st>>>(
        (const int*)ids, (const float*)sums, R, row_order, (const int*)slot,
        cap, nullptr, cur, 0, (int*)tie);
    dim3 lgrid((unsigned)((cap + 1 + CR_THREADS - 1) / CR_THREADS), B);
    collapse_list_kernel<<<lgrid, CR_THREADS, 0, st>>>(
        (const unsigned long long*)table, cur, cap,
        (unsigned long long*)list, lcap, (int*)nkeys);
    collapse_sort_kernel<<<B, 1024, 0, st>>>((unsigned long long*)list, lcap,
                                             (const int*)nkeys);
    for (int j = 1; j < cmax; ++j) {
        cudaMemsetAsync(other, 0, tab_bytes, st);
        collapse_round_kernel<<<grid, CR_THREADS, 0, st>>>(
            (const int*)ids, (const float*)sums, R, row_order,
            (const int*)slot, cap, cur, other, j, (int*)tie);
        unsigned long long* t = cur;
        cur = other;
        other = t;
    }
    collapse_final_kernel<<<grid, CR_THREADS, 0, st>>>(
        (const int*)ids, (const float*)sums, (const unsigned char*)elig, R,
        row_order, cmax, (const int*)slot,
        (const unsigned long long*)table, cap, cur,
        (const unsigned long long*)list, lcap, (const int*)nkeys,
        (unsigned char*)keep, (int*)tie);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The tiles design: per-block tables in shared memory, a merge sized by
// the keys, an out pass.

#define CT_THREADS 1024
#define CT_RPT 4
#define CT_CHUNK (CT_THREADS * CT_RPT)   // kernels.COLLAPSE_CHUNK
#define CT_MAX_TS 1024                   // kernels.COLLAPSE_TABLE
#define CT_MAX_CMAX 8
#define CM_THREADS 1024
#define CF_THREADS 256
#define CF_RPT 4
#define CR_FULL 0xffffffffu
#define CR_ORDER 0x8000000080000000ull

// the slot of key in a table of TS slots (the all-ones key: TS), inserted
// if absent; a full table traps
__device__ __forceinline__ int ct_insert(unsigned long long* keys, int TS,
                                         unsigned long long key) {
    if (key == CR_EMPTY) return TS;
    int h = (int)(mix64(key) & (unsigned long long)(TS - 1));
    for (int i = 0; i < TS; ++i) {
        unsigned long long prev = *(volatile unsigned long long*)&keys[h];
        if (prev == CR_EMPTY) prev = atomicCAS(&keys[h], CR_EMPTY, key);
        if (prev == CR_EMPTY || prev == key) return h;
        h = (h + 1) & (TS - 1);
    }
    __trap();
    return -1;
}

// the slot of a key the table holds; an absent key traps
__device__ __forceinline__ int ct_find(const unsigned long long* keys,
                                       int TS, unsigned long long key) {
    if (key == CR_EMPTY) return TS;
    int h = (int)(mix64(key) & (unsigned long long)(TS - 1));
    for (int i = 0; i < TS; ++i) {
        const unsigned long long k = keys[h];
        if (k == key) return h;
        if (k == CR_EMPTY) break;
        h = (h + 1) & (TS - 1);
    }
    __trap();
    return -1;
}

// the largest of list's cmax descending words below lim, or 0
__device__ __forceinline__ unsigned long long ct_below(
    const unsigned long long* list, int cmax, unsigned long long lim) {
    for (int q = 0; q < cmax; ++q)
        if (list[q] < lim) return list[q];
    return 0ull;
}

// N rows of one thread (r0, r0 + stride, ...), their loads issued
// together: has, and each grouped row's key and packed word (0 elsewhere)
template <int N>
__device__ __forceinline__ void ct_rows(
    const int* __restrict__ ids, const float* __restrict__ sums,
    const unsigned char* __restrict__ elig, long long base, int R,
    int row_order, const CollapseCol& col, int r0, int stride,
    unsigned long long (&key)[N], unsigned long long (&p)[N],
    bool (&has)[N]) {
    unsigned char e[N];
    int d[N];
    float sc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int r = r0 + i * stride;
        const bool in = r < R;
        e[i] = in ? elig[base + r] : 0;
        d[i] = in ? ids[base + r] : 0;
        sc[i] = in ? sums[base + r] : 0.0f;
    }
    long long dd[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        dd[i] = d[i] < col.n - 1 ? d[i] : col.n - 1;
        has[i] = e[i] && col.present[dd[i]];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
        key[i] = has[i] ? ((unsigned long long)(unsigned)col.hi[dd[i]] << 32) |
                              (unsigned)col.lo[dd[i]]
                        : 0ull;
        p[i] = has[i] ? cr_pack(sc[i], row_order ? r0 + i * stride : d[i])
                      : 0ull;
    }
}

// word i of a table kept as its two 32-bit halves
__device__ __forceinline__ unsigned long long ct_word(const unsigned* hi,
                                                      const unsigned* lo,
                                                      int i) {
    return ((unsigned long long)hi[i] << 32) | lo[i];
}

__global__ void __launch_bounds__(CT_THREADS, 1) collapse_tile_kernel(
    const int* __restrict__ ids, const float* __restrict__ sums,
    const unsigned char* __restrict__ elig, int R, int row_order,
    CollapseCol col, int TS, int cmax, int G, int* __restrict__ ent_n,
    unsigned long long* __restrict__ ent) {
    extern __shared__ unsigned long long ct_sm[];
    const int nw = (TS + 1) * cmax;
    unsigned long long* keys = ct_sm;                 // [TS]
    unsigned long long* O = ct_sm + TS;               // [TS + 1][cmax]: the
                                                      // earlier chunks'
    // the table's words [TS + 1][cmax], as their two halves: each round
    // takes the high half's maximum, then the low half's among the rows
    // that reach it, with 32-bit shared atomics (a 64-bit one is a loop
    // of compare-and-swaps, which the rows of a few keys keep failing)
    unsigned* Whi = (unsigned*)(O + nw);
    unsigned* Wlo = Whi + nw;
    __shared__ int cnt;
    const int b = blockIdx.y, g = blockIdx.x, t = threadIdx.x;
    for (int i = t; i < TS; i += CT_THREADS) keys[i] = CR_EMPTY;
    for (int i = t; i < nw; i += CT_THREADS) Whi[i] = Wlo[i] = 0u;
    if (t == 0) cnt = 0;
    const long long base = (long long)b * R;
    const int nchunks = (R + CT_CHUNK - 1) / CT_CHUNK;
    for (int c = g; c < nchunks; c += G) {
        __syncthreads();
        for (int i = t; i < nw; i += CT_THREADS) {
            O[i] = ct_word(Whi, Wlo, i);
            Whi[i] = Wlo[i] = 0u;
        }
        unsigned long long key[CT_RPT], p[CT_RPT];
        bool has[CT_RPT];
        ct_rows(ids, sums, elig, base, R, row_order, col, c * CT_CHUNK + t,
                CT_THREADS, key, p, has);
        int slot[CT_RPT];
#pragma unroll
        for (int i = 0; i < CT_RPT; ++i)
            slot[i] = has[i] ? ct_insert(keys, TS, key[i]) : -1;
        __syncthreads();
        // a row below its key's cmax-th word of the earlier chunks can
        // win no round
#pragma unroll
        for (int i = 0; i < CT_RPT; ++i)
            if (slot[i] >= 0 && p[i] < O[slot[i] * cmax + cmax - 1])
                slot[i] = -1;
        for (int j = 0; j < cmax; ++j) {
            for (int half = 0; half < 2; ++half) {
                unsigned* Wh = half ? Wlo : Whi;
                // the earlier chunks' words of each slot first: the rows
                // then look against them, and most need no atomic
                for (int s = t; s <= TS; s += CT_THREADS) {
                    const int at = s * cmax + j;
                    const unsigned long long x = ct_below(
                        O + s * cmax, cmax,
                        j ? ct_word(Whi, Wlo, at - 1) : ~0ull);
                    if (x == 0ull) continue;
                    if (!half)
                        Whi[at] = (unsigned)(x >> 32);
                    else if ((unsigned)(x >> 32) == Whi[at])
                        Wlo[at] = (unsigned)x;
                }
                __syncthreads();
#pragma unroll
                for (int i = 0; i < CT_RPT; ++i) {
                    const int s = slot[i];
                    const int at = s * cmax + j;
                    const unsigned h = (unsigned)(p[i] >> 32);
                    const unsigned v = half ? (unsigned)p[i] : h;
                    // admitted below round j - 1's word; the low half
                    // among the rows whose high half is the maximum; an
                    // atomic only where the row still beats the word
                    if (s >= 0 &&
                        (j == 0 || p[i] < ct_word(Whi, Wlo, at - 1)) &&
                        (!half || h == Whi[at]) && v > Wh[at])
                        atomicMax(&Wh[at], v);
                }
                __syncthreads();
            }
        }
    }
    // the block's keys and words as its list
    __syncthreads();
    unsigned long long* out =
        ent + ((long long)b * G + g) * (long long)(TS + 1) * (1 + cmax);
    for (int s = t; s <= TS; s += CT_THREADS) {
        const bool used = s < TS ? keys[s] != CR_EMPTY
                                 : ct_word(Whi, Wlo, TS * cmax) != 0ull;
        if (!used) continue;
        unsigned long long* e =
            out + (long long)atomicAdd(&cnt, 1) * (1 + cmax);
        e[0] = s < TS ? keys[s] : CR_EMPTY;
        for (int q = 0; q < cmax; ++q)
            e[1 + q] = ct_word(Whi, Wlo, s * cmax + q);
    }
    __syncthreads();
    if (t == 0) ent_n[(long long)b * G + g] = cnt;
}

__global__ void __launch_bounds__(CM_THREADS) collapse_merge_kernel(
    int G, int TS, int cmax, const int* __restrict__ ent_n,
    const unsigned long long* __restrict__ ent,
    unsigned long long* __restrict__ mkeys,
    unsigned long long* __restrict__ mwords, int* __restrict__ mrank) {
    extern __shared__ unsigned long long cm_sm[];
    unsigned long long* keys = cm_sm;                  // [TS]
    unsigned long long* W = cm_sm + TS;                // [TS + 1][cmax]
    unsigned long long* skey = W + (TS + 1) * cmax;    // [TS]
    int* sslot = (int*)(skey + TS);                    // [TS]
    __shared__ int nk;
    const int b = blockIdx.x, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int nw = (TS + 1) * cmax, E = 1 + cmax;
    for (int i = t; i < TS; i += CM_THREADS) keys[i] = CR_EMPTY;
    for (int i = t; i < nw; i += CM_THREADS) W[i] = 0ull;
    if (t == 0) nk = 0;
    __syncthreads();
    const long long stride = (long long)(TS + 1) * E;
    const unsigned long long* eb = ent + (long long)b * G * stride;
    for (int j = 0; j < cmax; ++j) {
        // a warp a list; round 0 inserts the keys
        for (int g = warp; g < G; g += CM_THREADS / 32) {
            const int n = ent_n[(long long)b * G + g];
            const unsigned long long* e0 = eb + g * stride;
            for (int i = lane; i < n; i += 32) {
                const unsigned long long* e = e0 + (long long)i * E;
                const int s = j == 0 ? ct_insert(keys, TS, e[0])
                                     : ct_find(keys, TS, e[0]);
                unsigned long long* w = W + s * cmax;
                const unsigned long long x =
                    ct_below(e + 1, cmax, j ? w[j - 1] : ~0ull);
                if (x > w[j]) atomicMax(&w[j], x);
            }
        }
        __syncthreads();
    }
    // the query's distinct keys, order-mapped, sorted with their slots
    for (int s = t; s <= TS; s += CM_THREADS) {
        const bool used = s < TS ? keys[s] != CR_EMPTY : W[TS * cmax] != 0ull;
        if (!used) continue;
        const int at = atomicAdd(&nk, 1);
        if (at >= TS) __trap();
        skey[at] = (s < TS ? keys[s] : CR_EMPTY) ^ CR_ORDER;
        sslot[at] = s;
    }
    __syncthreads();
    const int n = nk;
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    if (n2 > TS) __trap();
    for (int i = n + t; i < n2; i += CM_THREADS) {
        skey[i] = ~0ull;
        sslot[i] = -1;
    }
    __syncthreads();
    for (int k = 2; k <= n2; k <<= 1) {
        for (int jj = k >> 1; jj > 0; jj >>= 1) {
            for (int i = t; i < n2; i += CM_THREADS) {
                const int ixj = i ^ jj;
                if (ixj > i) {
                    const bool up = (i & k) == 0;
                    const unsigned long long x = skey[i], y = skey[ixj];
                    if ((x > y) == up) {
                        skey[i] = y;
                        skey[ixj] = x;
                        const int z = sslot[i];
                        sslot[i] = sslot[ixj];
                        sslot[ixj] = z;
                    }
                }
            }
            __syncthreads();
        }
    }
    unsigned long long* mk = mkeys + (long long)b * TS;
    unsigned long long* mw = mwords + (long long)b * nw;
    int* mr = mrank + (long long)b * (TS + 1);
    for (int i = t; i < TS; i += CM_THREADS) mk[i] = keys[i];
    for (int i = t; i < nw; i += CM_THREADS) mw[i] = W[i];
    for (int i = t; i < n; i += CM_THREADS) mr[sslot[i]] = i;
}

__global__ void __launch_bounds__(CF_THREADS) collapse_out_kernel(
    const int* __restrict__ ids, const float* __restrict__ sums,
    const unsigned char* __restrict__ elig, int R, int row_order,
    CollapseCol col, int TS, int cmax,
    const unsigned long long* __restrict__ mkeys,
    const unsigned long long* __restrict__ mwords,
    const int* __restrict__ mrank, unsigned char* __restrict__ keep,
    int* __restrict__ tie) {
    extern __shared__ unsigned long long cf_sm[];
    unsigned long long* keys = cf_sm;                  // [TS]
    int* rank = (int*)(cf_sm + TS);                    // [TS + 1]
    const int b = blockIdx.y, t = threadIdx.x;
    for (int i = t; i < TS; i += CF_THREADS)
        keys[i] = mkeys[(long long)b * TS + i];
    for (int i = t; i <= TS; i += CF_THREADS)
        rank[i] = mrank[(long long)b * (TS + 1) + i];
    __syncthreads();
    const unsigned long long* mw = mwords + (long long)b * (TS + 1) * cmax;
    const long long base = (long long)b * R;
    const int r0 = blockIdx.x * CF_RPT * CF_THREADS + t;
    unsigned long long key[CF_RPT], p[CF_RPT];
    bool has[CF_RPT];
    ct_rows(ids, sums, elig, base, R, row_order, col, r0, CF_THREADS, key,
            p, has);
#pragma unroll
    for (int i = 0; i < CF_RPT; ++i) {
        const int r = r0 + i * CF_THREADS;
        if (r >= R) break;
        unsigned char kp = elig[base + r];
        int tr = XT_I32MAX;
        if (has[i]) {
            const int s = ct_find(keys, TS, key[i]);
            const unsigned long long* w = mw + s * cmax;
            int j = 0;
            for (int q = 0; q < cmax; ++q) j += __ldg(w + q) > p[i];
            kp = p[i] >= __ldg(w + cmax - 1);
            tr = rank[s] * cmax + (j < cmax - 1 ? j : cmax - 1);
        }
        keep[base + r] = kp;
        tie[base + r] = tr;
    }
}

// The tiles design. TS: a power of two in [16, CT_MAX_TS], at least twice
// the column's distinct keys; G tile blocks a query (a block past the
// query's chunks holds no key); scratch: ent_n i32[B][G],
// ent u64[B][G][TS + 1][1 + cmax], mkeys u64[B][TS],
// mwords u64[B][TS + 1][cmax], mrank i32[B][TS + 1], nothing cleared.
extern "C" int xt_collapse_tiles(
    const void* ids, const void* sums, const void* elig, int B, int R,
    const void* col_hi, const void* col_lo, const void* col_present,
    long long n_col, int cmax, int row_order, int TS, int G, void* ent_n,
    void* ent, void* mkeys, void* mwords, void* mrank, void* keep, void* tie,
    void* stream) {
    if (B == 0 || R == 0) return 0;
    if (TS < 16 || TS > CT_MAX_TS || (TS & (TS - 1)) || cmax < 1 ||
        cmax > CT_MAX_CMAX || G < 1)
        return (int)cudaErrorInvalidValue;
    static bool attrs = false;
    if (!attrs) {
        const int tmax =
            8 * (CT_MAX_TS + 2 * (CT_MAX_TS + 1) * CT_MAX_CMAX);
        const int mmax = 8 * (2 * CT_MAX_TS + (CT_MAX_TS + 1) * CT_MAX_CMAX) +
                         4 * CT_MAX_TS;
        int rc = (int)cudaFuncSetAttribute(
            collapse_tile_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, tmax);
        if (!rc)
            rc = (int)cudaFuncSetAttribute(
                collapse_merge_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, mmax);
        if (rc) return rc;
        attrs = true;
    }
    cudaStream_t st = (cudaStream_t)stream;
    CollapseCol col{(const int*)col_hi, (const int*)col_lo,
                    (const unsigned char*)col_present, n_col};
    const int tsm = 8 * (TS + 2 * (TS + 1) * cmax);
    collapse_tile_kernel<<<dim3(G, B), CT_THREADS, tsm, st>>>(
        (const int*)ids, (const float*)sums, (const unsigned char*)elig, R,
        row_order, col, TS, cmax, G, (int*)ent_n,
        (unsigned long long*)ent);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int msm = 8 * (2 * TS + (TS + 1) * cmax) + 4 * TS;
    collapse_merge_kernel<<<B, CM_THREADS, msm, st>>>(
        G, TS, cmax, (const int*)ent_n, (const unsigned long long*)ent,
        (unsigned long long*)mkeys, (unsigned long long*)mwords,
        (int*)mrank);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int fsm = 8 * TS + 4 * (TS + 1);
    const int tiles = (R + CF_THREADS * CF_RPT - 1) / (CF_THREADS * CF_RPT);
    collapse_out_kernel<<<dim3(tiles, B), CF_THREADS, fsm, st>>>(
        (const int*)ids, (const float*)sums, (const unsigned char*)elig, R,
        row_order, col, TS, cmax, (const unsigned long long*)mkeys,
        (const unsigned long long*)mwords, (const int*)mrank,
        (unsigned char*)keep, (int*)tie);
    return (int)cudaGetLastError();
}
