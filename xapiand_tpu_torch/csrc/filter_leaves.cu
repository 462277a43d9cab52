// filter_leaves: value-range filter leaves, then the boolean tree.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _gather_filter_leaves
// 328-364 (with _get_value_col 313-325 for a slot the segment lacks) and
// the full tree over group bits and filter results, _eval_tree 249-282 as
// execute() applies it at 858-881, with the count.
//
// The rows are the packed rows after compact_rows, or every row of
// merge_docs / dense_rows when the plan has no compaction; a row is
// "first" where `base` (owner & !deleted) is set, or, for packed rows
// (base null), where its docid is not SENTINEL. For each filter leaf a
// first row reads its doc's min (hi, lo) and max (max_hi, max_lo)
// sort-key words and `present` flag and tests present & max >= lo & min
// <= hi on signed int32 pairs (split_key XORs the sign bits, so signed
// lexicographic order is u64 order; utils/serialise.py). Where the slot
// keeps per-value keys (mv_*, docs with >= 2 values) and the plan's static
// width vmax > 1, a doc with mv_len > 0 also needs a real value inside
// [lo, hi], scanning up to vmax values from mv_off
// (MultipleValueRange::insideRange). A slot the segment lacks (n_rows 0 in
// the column table) matches nothing. The tree program (common.cuh
// eval_program) runs over the row's group bits, its filter leaves'
// results and, for a plan with phrases, its word of phrase verdicts
// (phrase_leaves.cu, one bit per PH leaf), for a plan with geo leaves its
// word of geo verdicts (geo_leaves.cu, one bit per GEO leaf). A phrase
// plan has no precompaction (execute 836-837), so here its rows are every
// owner row and F may be 0: this kernel is where the tree of a phrase or a
// geo plan runs, as execute() runs it after every leaf at 875.
//
// Design: row tiles, flags first. A thread takes a group of 16 rows on the
// flat [B, C] index (common.cuh flat_mask16: a query's rows need not start
// on 16) and reads their flags as one 16-byte load of `base`; a warp's 32
// groups are a window of 512 rows, a block 4 warps of one query. Lane l
// then works the window's rows 32 k + l, k = 0..15, so that a warp's loads
// are neighbours (coalesced; the dense path's key gathers too): the flags
// from the groups' masks (a shuffle), or for packed rows (base null) the
// docids, which are the flags, read while the block stages its tables;
// the first rows' docids, orbits and verdict words sent to L2, each read
// only where the tree reads it. The tree runs once a lane over its 16 rows:
// each leaf a 16-bit mask, the stack FL_STACK masks in two registers; a G,
// PH or GEO leaf reads its word's bit for the lane's first rows; an F leaf
// is one 16-byte gather a row of the column's packed keys (`keys` i32[n,
// 4]: hi, lo, max_hi, max_lo, an absent doc stored as an empty interval;
// models/segment.py value_arrays), the lane's 16 gathers in flight at once
// by cp.async into shared memory, then tested (and scanned for a
// multi-value doc). The paths give first rows in runs (geo's term blocks:
// a 512-row window all first or none), so a lane's 16 rows each take one
// round of loads a leaf, not a chain each, and the tree's instructions
// run once for 16 rows. A program deeper than FL_STACK runs row by row.
// The verdicts go back to their groups by 16 warp ballots; `eligible` is
// written as one 16-byte store a group, the count as one atomic a block.
// The block stages the column table, the query's leaf parameters and the
// tree program in shared memory once.
//
// Column table, int64 per filter (FL_COLS): keys, mv_hi, mv_lo, mv_off,
// mv_len (device pointers, mv_* 0 when absent), n_rows, mv_rows, vmax.
//
// Bound on the H100 (chip_smoke.py work_filter): the flag byte and the
// eligible byte of every row; a first row's docid, its orbits where the
// tree reads a group bit, its verdict words, and 17 bytes a leaf of its
// doc's column (the column read at most once); for packed rows the docid
// of every row.
#include "common.cuh"

#define FL_COLS 8
#define FL_THREADS 128
#define FL_STACK 8      // the masks the tree's stack holds

// A doc's packed keys pass leaf p's range: a present doc (min <= max:
// value_arrays stores an absent doc as the empty interval (INT32_MAX,
// INT32_MAX) > (INT32_MIN, INT32_MIN)) whose max >= lo and min <= hi.
__device__ __forceinline__ bool fl_keys(int4 k, const int* p) {
    return lex_le(k.x, k.y, k.z, k.w) && lex_ge(k.z, k.w, p[0], p[1]) &&
           lex_le(k.x, k.y, p[2], p[3]);
}

// the multi-value test of a doc whose packed keys passed: a value of its
// first vmax inside [lo, hi] where it keeps per-value keys
__device__ __forceinline__ bool fl_mv(const long long* c, const int* p,
                                      long long dd) {
    const int vmax = (int)c[7];
    if (vmax <= 1 || !c[1]) return true;
    const int cnt = __ldg((const int*)c[4] + dd);
    if (cnt <= 0) return true;
    const long long off = __ldg((const int*)c[3] + dd);
    const long long mvn = c[6];
    bool hit = false;
    for (int j = 0; j < vmax && j < cnt; ++j) {
        const long long vi = off + j < mvn - 1 ? off + j : mvn - 1;
        const int vh = __ldg((const int*)c[1] + vi);
        const int vl = __ldg((const int*)c[2] + vi);
        hit = hit ||
              (lex_ge(vh, vl, p[0], p[1]) && lex_le(vh, vl, p[2], p[3]));
    }
    return hit;
}

// leaf f of one row, gathered where a row-by-row tree reads it
__device__ __forceinline__ bool fl_leaf(const long long* c, const int* p,
                                        int d) {
    const long long n = c[5];
    if (n == 0) return false;   // absent slot: no leaf matches
    const long long dd = (long long)d < n - 1 ? (long long)d : n - 1;
    return fl_keys(__ldg((const int4*)c[0] + dd), p) && fl_mv(c, p, dd);
}

__device__ __forceinline__ void fl_prefetch(const int* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// 16 bytes from device memory into shared memory without a register
// (cp.async), visible to the thread after fl_wait
__device__ __forceinline__ void fl_copy16(int4* smem, const int4* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void fl_wait() {
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// A lane's 16 rows, row0 + 32 k + lane for k = 0..15: the mask over k of
// a word's bit `arg` (a G, PH or GEO leaf), the word read for the first
// rows (lm) only
__device__ __forceinline__ unsigned fl_word_mask(const int* w, long long row0,
                                                 int lane, unsigned lm,
                                                 int arg) {
    unsigned x = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
        if ((lm >> k) & 1u)
            x |= ((unsigned)(__ldg(w + row0 + 32 * k + lane) >> arg) & 1u)
                 << k;
    return x;
}

__global__ void __launch_bounds__(FL_THREADS, 6) filter_leaves_kernel(
    const int* __restrict__ docids, const unsigned char* __restrict__ base,
    const int* __restrict__ orbits, const int* __restrict__ fparams,
    const long long* __restrict__ cols, int F, long long C,
    const int* __restrict__ prog, int prog_len, int need,
    const int* __restrict__ phbits, const int* __restrict__ geobits,
    unsigned char* __restrict__ eligible, int* __restrict__ count,
    int aligned) {
    extern __shared__ long long fl_smem[];
    long long* scol = fl_smem;
    int* spar = (int*)(scol + F * FL_COLS);
    int* sprog = spar + F * 4;
    // the landing slots of a lane's 16 key gathers: slot k of thread t at
    // k * FL_THREADS + t
    __shared__ int4 skeys[16 * FL_THREADS];
    __shared__ int wsum[FL_THREADS / 32];
    const int b = blockIdx.y, t = threadIdx.x, lane = t & 31;
    const long long lo = (long long)b * C, hi = lo + C;
    // the warp's window: 32 groups of 16 rows, the thread's one of them
    const long long gw =
        (lo >> 4) + (long long)blockIdx.x * FL_THREADS + (t & ~31);
    const long long g = gw + lane, row0 = gw * 16;
    const bool full = flat_full(g, lo, hi, aligned != 0);
    // 1. the flags, in flight while the block stages its tables: the
    // group's as one 16-byte load (base), or the docids of the lane's rows
    // row0 + 32 k + lane (packed rows: a docid is its row's flag)
    unsigned m = 0, lm = 0;
    uint4 fw = make_uint4(0u, 0u, 0u, 0u);
    if (base) {
        if (full)
            fw = __ldg(reinterpret_cast<const uint4*>(base + g * 16));
        else if (g * 16 < hi)
            m = flat_mask16(base, lo, hi, g, false);
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const long long r = row0 + 32 * k + lane;
            lm |= (unsigned)(r >= lo && r < hi &&
                             __ldg(docids + r) != XT_SENTINEL) << k;
        }
    }
    for (int i = t; i < F * FL_COLS; i += FL_THREADS) scol[i] = cols[i];
    for (int i = t; i < F * 4; i += FL_THREADS)
        spar[i] = fparams[(long long)b * F * 4 + i];
    for (int i = t; i < prog_len; i += FL_THREADS) sprog[i] = prog[i];
    if (base && full) m = mask16_of(fw);
    __syncthreads();
    // 2. the lane's rows (neighbours across the warp: coalesced): their
    // flags from the groups' masks (a shuffle), the first rows' docids and
    // other words sent to L2, read where the tree reads them
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const long long r = row0 + 32 * k + lane;
        if (base) {
            const unsigned mk = __shfl_sync(0xffffffffu, m,
                                            2 * k + (lane >> 4));
            lm |= ((mk >> (lane & 15)) & 1u) << k;
        }
        if ((lm >> k) & 1u) {
            if (F && base) fl_prefetch(docids + r);
            if (orbits) fl_prefetch(orbits + r);
            if (phbits) fl_prefetch(phbits + r);
            if (geobits) fl_prefetch(geobits + r);
        }
    }
    // 3. the tree once over the lane's 16 rows: each leaf a 16-bit mask
    // over k, a stack of up to FL_STACK masks in two words (top in the
    // low bits); an F leaf's 16 gathers of the packed keys in flight at
    // once (cp.async into shared memory), then tested. A deeper program
    // runs row by row.
    unsigned res = 0;
    if (lm && need <= FL_STACK) {
        unsigned long long s0 = 0, s1 = 0;
        for (int i = 0; i < prog_len; ++i) {
            const int ins = sprog[i];
            const int op = ins & 0xff, arg = ins >> 8;
            unsigned x;
            if (op == XT_OP_F) {
                const long long* c = scol + arg * FL_COLS;
                const long long n = c[5];
                x = 0;
                if (n) {   // absent slot: no leaf matches
                    const int* p = spar + arg * 4;
                    const int4* keys = (const int4*)c[0];
#pragma unroll
                    for (int k = 0; k < 16; ++k)
                        if ((lm >> k) & 1u) {
                            const long long d =
                                __ldg(docids + row0 + 32 * k + lane);
                            fl_copy16(skeys + k * FL_THREADS + t,
                                      keys + (d < n - 1 ? d : n - 1));
                        }
                    fl_wait();
#pragma unroll
                    for (int k = 0; k < 16; ++k)
                        if (((lm >> k) & 1u) &&
                            fl_keys(skeys[k * FL_THREADS + t], p))
                            x |= 1u << k;
                    // a multi-value doc also needs a value inside the range
                    if (c[7] > 1 && c[1])
#pragma unroll
                        for (int k = 0; k < 16; ++k)
                            if ((x >> k) & 1u) {
                                const long long d =
                                    __ldg(docids + row0 + 32 * k + lane);
                                if (!fl_mv(c, p, d < n - 1 ? d : n - 1))
                                    x &= ~(1u << k);
                            }
                }
            } else if (op == XT_OP_G) {
                x = fl_word_mask(orbits, row0, lane, lm, arg);
            } else if (op == XT_OP_PH) {
                x = fl_word_mask(phbits, row0, lane, lm, arg);
            } else if (op == XT_OP_GEO) {
                x = fl_word_mask(geobits, row0, lane, lm, arg);
            } else if (op == XT_OP_ALL || op == XT_OP_NONE) {
                x = op == XT_OP_ALL ? 0xffffu : 0u;
            } else {
                const unsigned bb = (unsigned)(s0 & 0xffffu);
                const unsigned a = (unsigned)((s0 >> 16) & 0xffffu);
                x = op == XT_OP_AND      ? a & bb
                    : op == XT_OP_OR     ? a | bb
                    : op == XT_OP_XOR    ? a ^ bb
                    : op == XT_OP_ANDNOT ? a & ~bb & 0xffffu
                                         : bb & ~a & 0xffffu;
                s0 = (s0 >> 32) | (s1 << 32);
                s1 >>= 32;
            }
            s1 = (s1 << 16) | (s0 >> 48);
            s0 = (s0 << 16) | x;
        }
        res = (unsigned)(s0 & 0xffffu) & lm;
    } else if (lm) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if (!((lm >> k) & 1u)) continue;
            const long long r = row0 + 32 * k + lane;
            const int dk = __ldg(docids + r);
            const int e = eval_tree_staged(
                sprog, prog_len, orbits ? (unsigned)__ldg(orbits + r) : 0u,
                [&](int f) {
                    return fl_leaf(scol + f * FL_COLS, spar + f * 4, dk);
                },
                phbits ? (unsigned)__ldg(phbits + r) : 0u,
                geobits ? (unsigned)__ldg(geobits + r) : 0u);
            res |= (unsigned)e << k;
        }
    }
    // 4. back to the groups: the warp's verdicts 32 rows at a time
    // (ballots), the thread's 16 rows of them, the count
    unsigned mine = 0;
    int n = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const unsigned bal = __ballot_sync(0xffffffffu, (res >> k) & 1u);
        n += __popc(bal);
        if ((lane >> 1) == k) mine = (bal >> (16 * (lane & 1))) & 0xffffu;
    }
    // 5. the group's eligible bytes, one 16-byte store
    if (g * 16 < hi) {
        if (full) {
            uint4 w;
            unsigned x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const unsigned nib = (mine >> (4 * i)) & 15u;
                x[i] = (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
                       ((nib & 8u) << 21);
            }
            w.x = x[0];
            w.y = x[1];
            w.z = x[2];
            w.w = x[3];
            *reinterpret_cast<uint4*>(eligible + g * 16) = w;
        } else {
            for (int j = 0; j < 16; ++j) {
                const long long r = g * 16 + j;
                if (r >= lo && r < hi)
                    eligible[r] = (unsigned char)((mine >> j) & 1u);
            }
        }
    }
    // one count atomic a block: the warps' sums, then thread 0
    if (lane == 0) wsum[t >> 5] = n;
    __syncthreads();
    if (t == 0) {
        n = 0;
        for (int w = 0; w < FL_THREADS / 32; ++w) n += wsum[w];
        if (n) atomicAdd(count + b, n);
    }
}

// The staged table's bytes: the column table, a query's leaf parameters,
// the program.
static size_t fl_smem_bytes(int F, int prog_len) {
    return (size_t)F * FL_COLS * 8 + (size_t)F * 16 + (size_t)prog_len * 4;
}

// eligible u8[B, C] and count i32[B] (zeroed by the caller). aligned: every
// [B, C] array given is 16-byte aligned. Returns cudaErrorInvalidValue
// where the staged table passes the shared memory a block may have.
extern "C" int xt_filter_leaves(const void* docids, const void* base,
                                const void* orbits, const void* fparams,
                                const void* cols, int B, int F, long long C,
                                const void* prog, int prog_len, int need,
                                const void* phbits, const void* geobits,
                                void* eligible, void* count, int aligned,
                                void* stream) {
    if (B == 0 || C == 0) return 0;
    // past 16 KB the staged table and the 32 KB of landing slots pass the
    // 48 KB a block has without asking
    const size_t smem = fl_smem_bytes(F, prog_len);
    if (smem > 16 * 1024) {
        if (smem > 190 * 1024) return (int)cudaErrorInvalidValue;
        cudaFuncSetAttribute(filter_leaves_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    }
    // the groups a query touches: ceil(C / 16), one more where its rows
    // do not start on a group
    const long long groups = (C + 15) / 16 + 1;
    dim3 grid((unsigned)((groups + FL_THREADS - 1) / FL_THREADS), B);
    filter_leaves_kernel<<<grid, FL_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)docids, (const unsigned char*)base, (const int*)orbits,
        (const int*)fparams, (const long long*)cols, F, C, (const int*)prog,
        prog_len, need, (const int*)phbits, (const int*)geobits,
        (unsigned char*)eligible, (int*)count, aligned);
    return (int)cudaGetLastError();
}
