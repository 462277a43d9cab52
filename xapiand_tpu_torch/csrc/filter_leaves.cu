// filter_leaves: value-range filter leaves, then the boolean tree.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _gather_filter_leaves
// 328-364 (with _get_value_col 313-325 for a slot the segment lacks) and
// the full tree over group bits and filter results, _eval_tree 249-282 as
// execute() applies it at 858-881, with the count.
//
// One thread per (query, row). The rows are the packed rows after
// compact_rows, or every row of merge_docs when the plan has no
// compaction; `base` is the row's "first" mask (owner & !deleted), or
// docid != SENTINEL for packed rows. For each filter leaf the thread reads
// the doc's min (hi, lo) and max (max_hi, max_lo) sort-key words and
// `present` flag, and tests present & max >= lo & min <= hi on signed
// int32 pairs (split_key XORs the sign bits, so signed lexicographic order
// is u64 order; utils/serialise.py). Where the slot keeps per-value keys
// (mv_*, docs with >= 2 values) and the plan's static width vmax > 1, a
// doc with mv_len > 0 also needs a real value inside [lo, hi], scanning
// up to vmax values from mv_off (MultipleValueRange::insideRange). A slot
// the segment lacks (n_rows 0 in the column table) matches nothing. The
// leaf results form a bit mask; the tree program (common.cuh eval_tree)
// runs over the row's group bits and that mask.
//
// Column table, int64 per filter: hi, lo, max_hi, max_lo, present, mv_hi,
// mv_lo, mv_off, mv_len (device pointers, mv_* 0 when absent), n_rows,
// mv_rows, vmax.
//
// Bound on the H100: latency of the per-row gathers by docid (5 words per
// leaf, more on the multi-value branch); at cap width (<= 131072 rows a
// query after compaction) they are few. The design keeps every leaf result
// in a register and writes one byte per row.
#include "common.cuh"

#define FL_COLS 12

__global__ void filter_leaves_kernel(
    const int* __restrict__ docids, const unsigned char* __restrict__ base,
    const int* __restrict__ orbits, const int* __restrict__ fparams,
    const long long* __restrict__ cols, int F, int C,
    const int* __restrict__ prog, int prog_len,
    unsigned char* __restrict__ eligible, int* __restrict__ count) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    int e = 0;
    if (r < C) {
        const long long i = (long long)b * C + r;
        const int d = docids[i];
        const int first = base ? (int)base[i] : (d != XT_SENTINEL);
        if (first) {
            unsigned fb = 0;
            for (int f = 0; f < F; ++f) {
                const long long* c = cols + f * FL_COLS;
                const long long n = c[9];
                if (n == 0) continue;   // absent slot: no leaf matches
                const long long dd = (long long)d < n - 1 ? (long long)d
                                                          : n - 1;
                const int* p = fparams + ((long long)b * F + f) * 4;
                const int lo_h = p[0], lo_l = p[1], hi_h = p[2], hi_l = p[3];
                const int vmin_h = ((const int*)c[0])[dd];
                const int vmin_l = ((const int*)c[1])[dd];
                const int vmax_h = ((const int*)c[2])[dd];
                const int vmax_l = ((const int*)c[3])[dd];
                const bool present = ((const unsigned char*)c[4])[dd] != 0;
                bool ok = present && lex_ge(vmax_h, vmax_l, lo_h, lo_l) &&
                          lex_le(vmin_h, vmin_l, hi_h, hi_l);
                const int vmax = (int)c[11];
                if (ok && vmax > 1 && c[5]) {
                    const int cnt = ((const int*)c[8])[dd];
                    if (cnt > 0) {
                        const long long off = ((const int*)c[7])[dd];
                        const long long mvn = c[10];
                        bool hit = false;
                        for (int j = 0; j < vmax && j < cnt; ++j) {
                            const long long vi = off + j < mvn - 1 ? off + j
                                                                   : mvn - 1;
                            const int vh = ((const int*)c[5])[vi];
                            const int vl = ((const int*)c[6])[vi];
                            hit = hit || (lex_ge(vh, vl, lo_h, lo_l) &&
                                          lex_le(vh, vl, hi_h, hi_l));
                        }
                        ok = hit;
                    }
                }
                if (ok) fb |= 1u << f;
            }
            e = eval_tree(prog, prog_len, (unsigned)orbits[i], fb);
        }
        eligible[i] = (unsigned char)e;
    }
    const int n = __syncthreads_count(e);
    if (threadIdx.x == 0 && n) atomicAdd(count + b, n);
}

extern "C" int xt_filter_leaves(const void* docids, const void* base,
                                const void* orbits, const void* fparams,
                                const void* cols, int B, int F, int C,
                                const void* prog, int prog_len,
                                void* eligible, void* count, void* stream) {
    if (B == 0 || C == 0) return 0;
    dim3 grid((C + 255) / 256, B);
    filter_leaves_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int*)docids, (const unsigned char*)base, (const int*)orbits,
        (const int*)fparams, (const long long*)cols, F, C, (const int*)prog,
        prog_len, (unsigned char*)eligible, (int*)count);
    return (int)cudaGetLastError();
}
