// semijoin_rows: the rows of an asymmetric AND - the driving term's
// postings are the only candidates, and every other term is probed by a
// binary search of its posting block.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _execute_semijoin 1172-1234
// (the rows it hands to _finish_rows 1132-1169): the drive term's S =
// classes[drive] postings (lax.dynamic_slice, its start clamped into the
// postings), each weighed by the scheme; then for every other term u, in
// ascending order, bit_length(classes[u]) rounds of a lower-bound search
// over post_docids[offsets[u], offsets[u] + lens[u]), the probe's wdf
// weighed with the DRIVE row's doclen and uniqterms (the same doc), times
// scoring[u], added to the row's sum when the probe hits; the OR of the
// group bits of the terms that hit.
//
// A thread per (query, drive row). The rounds, the clamps and the order of
// the additions are JAX's: the drive term's weight first, then u
// ascending, each probe adding its weight or 0.0 (-fmad=false, so the
// plain version gives the same bits). Output i32 ids (SENTINEL past the
// drive term's length), f32 sums, i32 orbits (when group bits are given),
// first = real & not deleted, and each query's count of first rows (one
// atomic add a warp).
//
// Bound on the H100: the drive rows' 12 bytes read and 13 written, and
// per probe a binary search: log2(classes[u]) + 1 dependent loads, whose
// upper levels stay in L1 / L2 when many rows search the same block. The
// sort pipeline reads every leg in full; the semijoin reads the drive leg
// and about log2(L) lines of each other leg a row.
#include "common.cuh"

#define SJ_THREADS 256

// one drive row: writes its outputs, returns its first flag
template <bool GENERIC>
__device__ __forceinline__ bool semijoin_row(
    const int* __restrict__ post_docids, const float* __restrict__ post_wdf,
    const float* __restrict__ post_doclen, long long n_post,
    const int* __restrict__ offsets, const int* __restrict__ lens,
    const float* __restrict__ tconst, const float* __restrict__ scoring,
    const int* __restrict__ bits, const int* __restrict__ classes, int T,
    int drive, int S, SchemeSpec sp, int C, const float* __restrict__ uniq,
    int nd1, const unsigned char* __restrict__ deleted, long long n_deleted,
    int* __restrict__ out_ids, float* __restrict__ out_sums,
    int* __restrict__ out_orbits, unsigned char* __restrict__ out_first,
    int b, int i) {
    const long long bt = (long long)b * T + drive;
    const int len = lens[bt];
    long long start = offsets[bt];
    if (start > n_post - S) start = n_post - S;
    if (start < 0) start = 0;
    const long long s = start + i;
    const bool real = i < len && post_docids[s] != XT_SENTINEL;
    const int d = i < len ? post_docids[s] : XT_SENTINEL;
    const float dl = post_doclen[s];
    const float u = (GENERIC && uniq != nullptr && real)
        ? uniq[min(d, nd1 - 1)] : 1.0f;
    const long long tcd = bt * (GENERIC ? C : 1);
    const float tc0[2] = {tconst[tcd],
                          GENERIC && C > 1 ? tconst[tcd + 1] : 0.0f};
    const float w = scored<GENERIC>(
        scheme_sumpart<GENERIC>(sp, post_wdf[s], dl, tc0, u), scoring[bt]);
    float sum = real ? w : 0.0f;
    int orb = (real && bits != nullptr) ? bits[bt] : 0;
    for (int t = 0; t < T; ++t) {
        if (t == drive) continue;
        const long long bu = (long long)b * T + t;
        const long long base = offsets[bu];
        const int n = lens[bu];
        const int nm1 = n > 1 ? n - 1 : 0;
        // bit_length(classes[t]) rounds (executor.py:1216)
        int bl = 0;
        for (int c = classes[t]; c > 0; c >>= 1) ++bl;
        const int rounds = (bl - 1 > 1 ? bl - 1 : 1) + 1;
        int lo = 0, hi = n;
        for (int r = 0; r < rounds; ++r) {
            const int mid = (lo + hi) >> 1;
            long long p = base + (mid < nm1 ? mid : nm1);
            p = p < 0 ? 0 : (p > n_post - 1 ? n_post - 1 : p);
            const bool right = post_docids[p] < d;
            lo = right ? mid + 1 : lo;
            hi = right ? hi : mid;
        }
        long long p = base + (lo < nm1 ? lo : nm1);
        p = p < 0 ? 0 : (p > n_post - 1 ? n_post - 1 : p);
        const bool hit = real && lo < n && post_docids[p] == d;
        const long long tcu = bu * (GENERIC ? C : 1);
        const float tcx[2] = {tconst[tcu],
                              GENERIC && C > 1 ? tconst[tcu + 1] : 0.0f};
        const float wu = scored<GENERIC>(
            scheme_sumpart<GENERIC>(sp, post_wdf[p], dl, tcx, u),
            scoring[bu]);
        sum = sum + (hit ? wu : 0.0f);
        if (hit && bits != nullptr) orb |= bits[bu];
    }
    bool first = real;
    if (first && deleted != nullptr) {
        const long long dd = (long long)d < n_deleted - 1 ? (long long)d
                                                          : n_deleted - 1;
        first = deleted[dd] == 0;
    }
    const long long o = (long long)b * S + i;
    out_ids[o] = d;
    out_sums[o] = sum;
    if (out_orbits != nullptr) out_orbits[o] = orb;
    out_first[o] = first ? 1 : 0;
    return first;
}

template <bool GENERIC>
__global__ void __launch_bounds__(SJ_THREADS) semijoin_rows_kernel(
    const int* __restrict__ post_docids, const float* __restrict__ post_wdf,
    const float* __restrict__ post_doclen, long long n_post,
    const int* __restrict__ offsets, const int* __restrict__ lens,
    const float* __restrict__ tconst, const float* __restrict__ scoring,
    const int* __restrict__ bits, const int* __restrict__ classes, int T,
    int drive, int S, SchemeSpec sp, int C, const float* __restrict__ uniq,
    int nd1, const unsigned char* __restrict__ deleted, long long n_deleted,
    int* __restrict__ out_ids, float* __restrict__ out_sums,
    int* __restrict__ out_orbits, unsigned char* __restrict__ out_first,
    int* __restrict__ out_count) {
    const int b = blockIdx.y;
    const int i = blockIdx.x * SJ_THREADS + threadIdx.x;
    const bool first = i < S && semijoin_row<GENERIC>(
        post_docids, post_wdf, post_doclen, n_post, offsets, lens, tconst,
        scoring, bits, classes, T, drive, S, sp, C, uniq, nd1, deleted,
        n_deleted, out_ids, out_sums, out_orbits, out_first, b, i);
    const unsigned m = __ballot_sync(0xffffffffu, first);
    if ((threadIdx.x & 31) == 0 && m) atomicAdd(out_count + b, __popc(m));
}

extern "C" int xt_semijoin_rows(
    const void* post_docids, const void* post_wdf, const void* post_doclen,
    long long n_post, const void* offsets, const void* lens,
    const void* tconst, const void* scoring, const void* bits,
    const void* classes, int B, int T, int drive, int S, int scheme,
    const float* params, int C, const void* uniq, int nd1,
    const void* deleted, long long n_deleted, void* out_ids, void* out_sums,
    void* out_orbits, void* out_first, void* out_count, void* stream) {
    if (B == 0 || S == 0) return 0;
    if (drive < 0 || drive >= T) return (int)cudaErrorInvalidValue;
    const SchemeSpec sp = make_spec(scheme, params);
    auto kernel = scheme == XT_SCHEME_BM25 ? semijoin_rows_kernel<false>
                                           : semijoin_rows_kernel<true>;
    dim3 grid((S + SJ_THREADS - 1) / SJ_THREADS, B);
    kernel<<<grid, SJ_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)post_docids, (const float*)post_wdf,
        (const float*)post_doclen, n_post, (const int*)offsets,
        (const int*)lens, (const float*)tconst, (const float*)scoring,
        (const int*)bits, (const int*)classes, T, drive, S, sp, C,
        (const float*)uniq, nd1, (const unsigned char*)deleted, n_deleted,
        (int*)out_ids, (float*)out_sums, (int*)out_orbits,
        (unsigned char*)out_first, (int*)out_count);
    return (int)cudaGetLastError();
}
