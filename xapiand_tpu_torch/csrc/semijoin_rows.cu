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
// The order of the additions is JAX's: the drive term's weight first, then
// u ascending, each probe adding its weight or 0.0 (-fmad=false, so the
// plain version gives the same bits). Output i32 ids (SENTINEL past the
// drive term's length), f32 sums, i32 orbits (when group bits are given),
// first = real & not deleted, and each query's count of first rows (one
// atomic add a block).
//
// Bound on the H100: the drive rows' 12 bytes read and the 13 bytes of
// every output row written; per real row and probed term the posting it
// lands on (docid and wdf) found by a search.
//
// Design. The first version ran JAX's whole search for every (query,
// drive row): bit_length(classes[u]) dependent global loads a probe, also
// for the rows past the drive term's length (SENTINEL, never a hit), which
// are most of a padded drive class. Now a block of SJ_BLOCK consecutive
// drive rows (SJ_ROWS a thread):
//   - writes a row past the length (SENTINEL, 0.0, no bits, not first)
//     without a search, and ends there where no row is real;
//   - finds its real rows' least and greatest docid (the drive window is
//     docid-sorted but where its start was clamped, so both are reduced)
//     and, per probed term, their lower bounds L0 and L1 in the term's
//     block, each by one warp in 32-ary rounds (log32 of the block's
//     length dependent loads): every real row's lower bound lies in
//     [L0, L1]. The bracket's postings are staged in shared memory (up to
//     SJ_STAGE of them, else searched where they lie) and each row
//     searches there.
// This gives JAX's search's answer where that search ends at the lower
// bound: a block of n ascending postings (the segment's order) inside the
// postings array, searched by at least bit_length(n) rounds (n < 2^rounds;
// the rounds JAX runs past that leave a found lower bound where it is).
// Any other term (a length past its class) takes JAX's rounds as they are.
#include "common.cuh"

#define SJ_THREADS 256
#define SJ_ROWS 4                          // drive rows a thread
#define SJ_BLOCK (SJ_THREADS * SJ_ROWS)    // drive rows a block
#define SJ_STAGE 2048                      // bracket postings staged
#define SJ_FULL 0xffffffffu

// JAX's rounds of lower-bound search for d in the block post[base, base+n)
// (executor.py:1216-1226), its probes clamped into the postings: the final
// lo
__device__ __forceinline__ int jax_rounds(const int* __restrict__ post,
                                          long long n_post, long long base,
                                          int n, int rounds, int d) {
    const int nm1 = n > 1 ? n - 1 : 0;
    int lo = 0, hi = n;
    for (int r = 0; r < rounds; ++r) {
        const int mid = (lo + hi) >> 1;
        long long p = base + (mid < nm1 ? mid : nm1);
        p = p < 0 ? 0 : (p > n_post - 1 ? n_post - 1 : p);
        const bool right = post[p] < d;
        lo = right ? mid + 1 : lo;
        hi = right ? hi : mid;
    }
    return lo;
}

// the least x in [lo, hi) with a[x] >= d, hi if none (a ascending)
__device__ __forceinline__ int lower_in(const int* a, int lo, int hi, int d) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < d) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// The least x in [0, n] with a[x] >= v (n if none; a ascending), found by
// one warp: each round its 32 lanes probe the ends of 32 equal parts of
// the range, and the ballot of the probes below v picks the part. Every
// lane of the warp calls it and gets the answer.
__device__ int warp_lower(const int* __restrict__ a, int n, int v) {
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = n;   // the answer lies in [lo, hi]
    while (hi - lo > 32) {
        const int step = (hi - lo + 31) / 32;
        const int q = lo + (lane + 1) * step - 1;
        const bool below = q < hi && __ldg(a + q) < v;
        const int c = __popc(__ballot_sync(SJ_FULL, below));
        const int top = lo + (c + 1) * step - 1;   // lane c's probe, >= v
        lo += c * step;
        hi = top < hi ? top : hi;
    }
    const int q = lo + lane;
    return lo + __popc(__ballot_sync(SJ_FULL, q < hi && __ldg(a + q) < v));
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
    __shared__ int stage[SJ_STAGE];
    __shared__ int wmin[SJ_THREADS / 32], wmax[SJ_THREADS / 32];
    __shared__ int bracket[2];
    __shared__ int n_first;
    const int b = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long bt = (long long)b * T + drive;
    const int len = lens[bt];
    long long start = offsets[bt];
    if (start > n_post - S) start = n_post - S;
    if (start < 0) start = 0;
    // this thread's rows: i[j] = the block's first + j x SJ_THREADS + tid
    int i[SJ_ROWS], d[SJ_ROWS];
    bool real[SJ_ROWS];
    bool any = false;
    int lo_d = XT_I32MAX, hi_d = -1;
#pragma unroll
    for (int j = 0; j < SJ_ROWS; ++j) {
        i[j] = blockIdx.x * SJ_BLOCK + j * SJ_THREADS + threadIdx.x;
        d[j] = (i[j] < S && i[j] < len) ? post_docids[start + i[j]]
                                        : XT_SENTINEL;
        real[j] = d[j] != XT_SENTINEL;
        any |= real[j];
        if (real[j]) {
            lo_d = min(lo_d, d[j]);
            hi_d = max(hi_d, d[j]);
        }
    }
    // the block's real docids' least and greatest
    lo_d = __reduce_min_sync(SJ_FULL, lo_d);
    hi_d = __reduce_max_sync(SJ_FULL, hi_d);
    if (lane == 0) {
        wmin[warp] = lo_d;
        wmax[warp] = hi_d;
    }
    if (threadIdx.x == 0) n_first = 0;
    if (!__syncthreads_or(any)) {   // no real row: nothing to search
#pragma unroll
        for (int j = 0; j < SJ_ROWS; ++j) {
            if (i[j] >= S) continue;
            const long long o = (long long)b * S + i[j];
            out_ids[o] = d[j];
            out_sums[o] = 0.0f;
            if (out_orbits != nullptr) out_orbits[o] = 0;
            out_first[o] = 0;
        }
        return;
    }
    lo_d = wmin[0];
    hi_d = wmax[0];
    for (int w = 1; w < SJ_THREADS / 32; ++w) {
        lo_d = min(lo_d, wmin[w]);
        hi_d = max(hi_d, wmax[w]);
    }
    float dl[SJ_ROWS], u[SJ_ROWS], sum[SJ_ROWS];
    int orb[SJ_ROWS];
    const long long tcd = bt * (GENERIC ? C : 1);
    const float tc0[2] = {tconst[tcd],
                          GENERIC && C > 1 ? tconst[tcd + 1] : 0.0f};
#pragma unroll
    for (int j = 0; j < SJ_ROWS; ++j) {
        dl[j] = 0.0f;
        u[j] = 1.0f;
        sum[j] = 0.0f;
        orb[j] = 0;
        if (real[j]) {
            const long long s = start + i[j];
            dl[j] = post_doclen[s];
            if (GENERIC && uniq != nullptr) u[j] = uniq[min(d[j], nd1 - 1)];
            sum[j] = scored<GENERIC>(
                scheme_sumpart<GENERIC>(sp, post_wdf[s], dl[j], tc0, u[j]),
                scoring[bt]);
            if (bits != nullptr) orb[j] = bits[bt];
        }
    }
    for (int t = 0; t < T; ++t) {
        if (t == drive) continue;
        const long long bu = (long long)b * T + t;
        const long long base = offsets[bu];
        const int n = lens[bu];
        // bit_length(classes[t]) rounds (executor.py:1216)
        int bl = 0;
        for (int c = classes[t]; c > 0; c >>= 1) ++bl;
        const int rounds = (bl - 1 > 1 ? bl - 1 : 1) + 1;
        const bool exact = n > 0 && base >= 0 && base + n <= n_post &&
                           (rounds >= 31 || n < (1 << rounds));
        const int* blk = post_docids + base;
        int L0 = 0, cnt = 0;
        if (exact) {
            __syncthreads();   // the last term's stage is read
            if (warp == 0) {
                const int x = warp_lower(blk, n, lo_d);
                if (lane == 0) bracket[0] = x;
            } else if (warp == 1) {
                const int x = warp_lower(blk, n, hi_d);
                if (lane == 0) bracket[1] = x;
            }
            __syncthreads();
            L0 = bracket[0];
            const int L1 = bracket[1] < n ? bracket[1] : n - 1;
            cnt = L1 - L0 + 1;   // postings [L0, L1], may be none
            if (cnt <= SJ_STAGE) {
                for (int j = threadIdx.x; j < cnt; j += SJ_THREADS)
                    stage[j] = __ldg(blk + L0 + j);
                __syncthreads();
            }
        }
        const long long tcu = bu * (GENERIC ? C : 1);
#pragma unroll
        for (int j = 0; j < SJ_ROWS; ++j) {
            if (!real[j]) continue;
            int x;   // the posting the probe lands on, where it hits
            bool hit;
            if (!exact) {   // JAX's rounds as they are
                x = jax_rounds(post_docids, n_post, base, n, rounds, d[j]);
                const int nm1 = n > 1 ? n - 1 : 0;
                long long p = base + (x < nm1 ? x : nm1);
                p = p < 0 ? 0 : (p > n_post - 1 ? n_post - 1 : p);
                hit = x < n && post_docids[p] == d[j];
                x = (int)(p - base);
            } else if (cnt <= SJ_STAGE) {
                const int y = cnt > 0 ? lower_in(stage, 0, cnt, d[j]) : 0;
                hit = y < cnt && stage[y] == d[j];
                x = L0 + y;
            } else {
                x = lower_in(blk, L0, L0 + cnt, d[j]);
                hit = x < n && blk[x] == d[j];
            }
            float wu = 0.0f;
            if (hit) {
                const float tcx[2] = {tconst[tcu], GENERIC && C > 1
                                                       ? tconst[tcu + 1]
                                                       : 0.0f};
                wu = scored<GENERIC>(
                    scheme_sumpart<GENERIC>(sp, post_wdf[base + x], dl[j],
                                            tcx, u[j]),
                    scoring[bu]);
                if (bits != nullptr) orb[j] |= bits[bu];
            }
            sum[j] = sum[j] + (hit ? wu : 0.0f);
        }
    }
#pragma unroll
    for (int j = 0; j < SJ_ROWS; ++j) {
        bool first = real[j];
        if (first && deleted != nullptr) {
            const long long dd = (long long)d[j] < n_deleted - 1
                ? (long long)d[j] : n_deleted - 1;
            first = deleted[dd] == 0;
        }
        if (i[j] < S) {
            const long long o = (long long)b * S + i[j];
            out_ids[o] = d[j];
            out_sums[o] = sum[j];
            if (out_orbits != nullptr) out_orbits[o] = orb[j];
            out_first[o] = first ? 1 : 0;
        }
        const unsigned m = __ballot_sync(SJ_FULL, first);
        if (lane == 0 && m) atomicAdd(&n_first, __popc(m));
    }
    // one atomic a block on the query's count: a warp's each contended for
    // one address with every other block of the query
    __syncthreads();
    if (threadIdx.x == 0 && n_first) atomicAdd(out_count + b, n_first);
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
    dim3 grid((S + SJ_BLOCK - 1) / SJ_BLOCK, B);
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
