// shard_merge: the mesh plane's collectives on one card - the global top-k
// of S shards' top-k lists, and the psum / pmin / pmax of their counts and
// packed aggregation statistics.
//
// Replaces (TPU): xapiand_tpu/parallel/sharded.py make_sharded_step
// 341-465, the part after each shard's execute (394-445): docid striping
// (gdoc = did * S + shard), the all_gather of every shard's top-k over the
// 'shard' axis, the re-sort of the gathered [Q, S*k] by lax.sort, and the
// psum / pmin / pmax of the counts and of pack_agg_parts' three vectors.
// On the H100 the S shards of a mesh are stacked on the one card, so the
// all_gather is a read of the stacked per-shard outputs [S, Q, k].
//
// Merge (xt_shard_merge): a block per query. Each of the S*k candidates
// gets its merge key, as 32-bit words whose unsigned order is lax.sort's:
//   relevance  (-score, okey)                              (sharded.py:438)
//   value      (the shard's emitted sort key words, okey)  (sharded.py:425)
// where okey is the shard's insertion-order key of the doc (ShardedDatabase
// stacks one) or else gdoc, and a row whose score is -inf gets gdoc = okey
// = INT32_MAX. lax.sort is stable, so ties keep the gathered position
// (shard-major), the key's last word. The block writes the keys to a
// device scratch, then ranks each candidate by counting the candidates
// before it in the total order, and writes the ones ranked below k (the
// per-shard k, as JAX takes the first cfg.k of the gathered S*k). It
// does not rely on each shard's list being sorted: simple and exact. Float
// words follow lax.sort's order (fkey, common.cuh: -0.0 equals +0.0, NaN
// after +inf).
//
// The chunk merge (stripe = 0) is the same block over the n_chunks
// docid-range chunks of one query instead of S shards: xapiand_tpu/ops/
// executor.py _execute_chunked 1058-1063, lax.sort((-v, d, v),
// num_keys=2) of the chunks' top-k finalists, chunk-major - the relevance
// key with okey = the docid itself (no striping; the chunks partition the
// docids) and the finalist's position last, lax.sort being stable.
//
// Reduce (xt_shard_reduce): a thread per (query, column), the S shards
// folded in shard order - a sum (int32 counts, exact; float32 packs), or a
// min / max that returns NaN if either side is NaN, as XLA's min / max; a
// NaN result is written as the one quiet NaN 0x7fc00000.
//
// Bound on the H100: the merge reads S*Q*k candidates (docid, score, and
// okey or the sort key words) once and writes Q*k; the ranking is
// (S*k)^2 key compares a query, from L1 - at the mesh path's S*k = 80 it
// is launch-bound. The reduce reads S*Q*W once and writes Q*W.
#include "common.cuh"

#define SM_THREADS 256

__global__ void __launch_bounds__(SM_THREADS) shard_merge_kernel(
    const int* __restrict__ docids, const float* __restrict__ scores,
    const int* __restrict__ okeys, long long n_okeys,
    const unsigned* __restrict__ skeys, int nu, int S, int Q, int k,
    int stripe, unsigned* __restrict__ scratch, int* __restrict__ out_d,
    float* __restrict__ out_s) {
    const int q = blockIdx.x;
    const int M = S * k;
    const int nw = (skeys != nullptr ? nu : 1) + 2;   // + okey, position
    unsigned* key = scratch + (long long)q * M * nw;
    for (int i = threadIdx.x; i < M; i += SM_THREADS) {
        const int s = i / k, j = i % k;
        const long long o = ((long long)s * Q + q) * k + j;
        const int d = docids[o];
        const float sc = scores[o];
        const bool invalid = isinf(sc) && sc < 0.0f;
        // int32 arithmetic wraps, as jnp's
        const int gdoc = invalid ? XT_I32MAX
                                 : stripe ? (int)((unsigned)d * (unsigned)S + s)
                                          : d;
        int okey = gdoc;
        if (okeys != nullptr) {
            const long long dd = d < 0 ? 0 : (d < n_okeys ? d : n_okeys - 1);
            okey = invalid ? XT_I32MAX : okeys[(long long)s * n_okeys + dd];
        }
        unsigned* w = key + (long long)i * nw;
        int p = 0;
        if (skeys != nullptr) {
            for (int u = 0; u < nu; ++u) w[p++] = skeys[o * nu + u];
        } else {
            w[p++] = fkey(-sc);
        }
        w[p++] = ikey(okey);
        w[p] = (unsigned)i;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M; i += SM_THREADS) {
        const unsigned* a = key + (long long)i * nw;
        int rank = 0;
        for (int j = 0; j < M; ++j) {
            const unsigned* c = key + (long long)j * nw;
            for (int u = 0; u < nw; ++u) {
                if (c[u] != a[u]) {
                    rank += c[u] < a[u];
                    break;
                }
            }
        }
        if (rank < k) {
            const int s = i / k, j = i % k;
            const long long o = ((long long)s * Q + q) * k + j;
            const float sc = scores[o];
            const bool invalid = isinf(sc) && sc < 0.0f;
            out_d[(long long)q * k + rank] =
                invalid ? XT_I32MAX
                : stripe ? (int)((unsigned)docids[o] * (unsigned)S + s)
                         : docids[o];
            out_s[(long long)q * k + rank] = sc;
        }
    }
}

extern "C" int xt_shard_merge(const void* docids, const void* scores,
                              const void* okeys, long long n_okeys,
                              const void* skeys, int nu, int S, int Q, int k,
                              int stripe, void* scratch, void* out_d,
                              void* out_s, void* stream) {
    if (Q == 0 || k == 0) return 0;
    if (S < 1) return (int)cudaErrorInvalidValue;
    shard_merge_kernel<<<Q, SM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)docids, (const float*)scores, (const int*)okeys, n_okeys,
        (const unsigned*)skeys, nu, S, Q, k, stripe, (unsigned*)scratch,
        (int*)out_d, (float*)out_s);
    return (int)cudaGetLastError();
}

// mode: 0 sum f32, 1 min f32, 2 max f32, 3 sum i32
__global__ void shard_reduce_kernel(const void* __restrict__ x, int S,
                                    long long n, int mode,
                                    void* __restrict__ out) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    if (mode == 3) {
        const int* xi = (const int*)x;
        int acc = xi[e];
        for (int s = 1; s < S; ++s)
            acc = (int)((unsigned)acc + (unsigned)xi[(long long)s * n + e]);
        ((int*)out)[e] = acc;
        return;
    }
    const float* xf = (const float*)x;
    float acc = xf[e];
    for (int s = 1; s < S; ++s) {
        const float v = xf[(long long)s * n + e];
        if (mode == 0) {
            acc = __fadd_rn(acc, v);
        } else if (isnan(acc) || isnan(v)) {
            acc = __int_as_float(0x7fc00000);
        } else if (mode == 1) {
            acc = v < acc ? v : acc;
        } else {
            acc = v > acc ? v : acc;
        }
    }
    // one NaN: the card's arithmetic NaN and the CPU's differ in bits
    ((float*)out)[e] = isnan(acc) ? __int_as_float(0x7fc00000) : acc;
}

extern "C" int xt_shard_reduce(const void* x, int S, long long n, int mode,
                               void* out, void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    shard_reduce_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(x, S, n, mode, out);
    return (int)cudaGetLastError();
}
