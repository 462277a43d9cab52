// prefix_certify: exact rescore of the prefix-mode candidates + certificate.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _prefix_topk 959-997.
//
// The rescore weighs each hit with the query's scheme (common.cuh
// scheme_sumpart; BM25 the GENERIC = false instance, as before the other
// schemes). Only impact-separable schemes reach prefix mode (BM25 and
// BM25Plus, whose impact order is BM25's); uniq, read at min(docid, ND)
// as JAX reads it (975-978), is nullptr for them.
//
// Input: the top K+1 owner rows of each query (topk_rows), read from the
// impact prefixes. Each of the first K candidates is rescored exactly: a
// binary search for its docid in every term's full docid-ordered postings
// (post_*, clamped to ln = min(lens[t], classes[t])), with the hit weights
// summed in term order as executor.py:962-985 does. The K are then
// re-sorted by (score desc, docid asc) and the first k written. The
// certificate is JAX's rule with eps = 1e-5*|s_k| + 1e-6:
//   certified = U == 0 or (s_k finite and s_k > U + eps and
//               (vals[K] not finite or s_k > vals[K] + U + eps)),
// U = the summed unread-tail bounds of score_slices.
//
// Grid (B): one block per query, one thread per candidate (K <= 256); the
// re-sort ranks each candidate by counting the ones ahead of it.
//
// Bound on the H100: the latency of T dependent binary-search chains per
// candidate into the full postings (log2 of up to 2^20 rows each); the
// work is tiny, so the kernel is one short launch.
#include "common.cuh"

template <bool GENERIC>
__global__ void prefix_certify_kernel(
    const int* __restrict__ post_docids, const float* __restrict__ post_wdf,
    const float* __restrict__ post_doclen, long long n_post,
    const int* __restrict__ offsets, const int* __restrict__ lens,
    const float* __restrict__ tconst, const float* __restrict__ scoring,
    const int* __restrict__ classes, const float* __restrict__ tail, int T,
    const int* __restrict__ cand_d, const float* __restrict__ cand_v, int K,
    int k, SchemeSpec sp, int C, const float* __restrict__ uniq, int nd1,
    int* __restrict__ out_d, float* __restrict__ out_s,
    unsigned char* __restrict__ certified) {
    __shared__ float s_neg[256];
    __shared__ int s_d[256];
    __shared__ float s_sorted[256];
    const int b = blockIdx.x, i = threadIdx.x;
    const int K1 = K + 1;
    int d = XT_SENTINEL;
    float exact = 0.0f;
    if (i < K) {
        d = cand_d[b * K1 + i];
        const float u = (GENERIC && uniq != nullptr) ? uniq[min(d, nd1 - 1)]
                                                     : 1.0f;
        for (int t = 0; t < T; ++t) {
            const int bt = b * T + t;
            const int ln = min(lens[bt], classes[t]);
            const long long off = offsets[bt];
            // leftmost pos in [0, ln) with post_docids[off + pos] >= d
            int lo = 0, hi = ln;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (post_docids[off + mid] < d) lo = mid + 1; else hi = mid;
            }
            long long pp = off + lo;
            if (pp > n_post - 1) pp = n_post - 1;
            if (lo < ln && post_docids[pp] == d) {
                const float w = scheme_sumpart<GENERIC>(
                    sp, post_wdf[pp], post_doclen[pp],
                    tconst + (long long)bt * (GENERIC ? C : 1), u);
                exact = exact + scored<GENERIC>(w, scoring[bt]);
            }
        }
        if (d == XT_SENTINEL) exact = __int_as_float(0xff800000);   // -inf
        s_neg[i] = -exact;
        s_d[i] = d;
    }
    __syncthreads();
    if (i < K) {
        // rank by (-score asc, docid asc); equal pairs (SENTINEL padding,
        // all -inf) fall back to the slot index
        const float ni = s_neg[i];
        int rank = 0;
        for (int j = 0; j < K; ++j) {
            const float nj = s_neg[j];
            const int dj = s_d[j];
            rank += (nj < ni) || (nj == ni && (dj < d || (dj == d && j < i)));
        }
        s_sorted[rank] = exact;
        if (rank < k) {
            out_d[b * k + rank] = d;
            out_s[b * k + rank] = exact;
        }
    }
    __syncthreads();
    if (i == 0) {
        float U = 0.0f;
        for (int t = 0; t < T; ++t) U = U + tail[b * T + t];
        const float sk = s_sorted[k - 1];
        const float vK = cand_v[b * K1 + K];
        const float eps = 1e-5f * fabsf(sk) + 1e-6f;
        const bool outsider_ok = !isfinite(vK) || (sk > vK + U + eps);
        certified[b] = (unsigned char)(
            (U == 0.0f) || (isfinite(sk) && (sk > U + eps) && outsider_ok));
    }
}

extern "C" int xt_prefix_certify(
    const void* post_docids, const void* post_wdf, const void* post_doclen,
    long long n_post, const void* offsets, const void* lens,
    const void* tconst, const void* scoring, const void* classes,
    const void* tail, int B, int T, const void* cand_d, const void* cand_v,
    int K, int k, int scheme, const float* params, int C, const void* uniq,
    int nd1, void* out_d, void* out_s, void* certified, void* stream) {
    if (B == 0) return 0;
    const SchemeSpec sp = make_spec(scheme, params);
    auto kernel = scheme == XT_SCHEME_BM25 ? prefix_certify_kernel<false>
                                           : prefix_certify_kernel<true>;
    const int threads = ((K + 31) / 32) * 32;
    kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
        (const int*)post_docids, (const float*)post_wdf,
        (const float*)post_doclen, n_post, (const int*)offsets,
        (const int*)lens, (const float*)tconst, (const float*)scoring,
        (const int*)classes, (const float*)tail, T, (const int*)cand_d,
        (const float*)cand_v, K, k, sp, C, (const float*)uniq, nd1,
        (int*)out_d, (float*)out_s, (unsigned char*)certified);
    return (int)cudaGetLastError();
}
