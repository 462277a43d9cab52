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
//
// Five steps, each a launch over (row tiles, B), on per-query scratch:
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
// order, so keep and tie are the same bits on every launch.
//
// Bound on the H100: the rows are read once per step (13 bytes, and 9 of
// the value column per eligible row); cmax rounds of one 64-bit atomic per
// grouped row; the sort is O(D log^2 D) over the D distinct keys by one
// block a query - slow when D nears R, fast for a categorical key.
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
