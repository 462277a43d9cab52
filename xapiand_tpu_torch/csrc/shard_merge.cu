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
// Merge (xt_shard_merge): a block per query. Each of the M = S*k
// candidates gets its merge key, as 32-bit words whose unsigned order is
// lax.sort's:
//   relevance  (-score, okey)                              (sharded.py:438)
//   value      (the shard's emitted sort key words, okey)  (sharded.py:425)
// where okey is the shard's insertion-order key of the doc (ShardedDatabase
// stacks one) or else gdoc, and a row whose score is -inf gets gdoc = okey
// = INT32_MAX. lax.sort is stable, so ties keep the gathered position
// (shard-major), the key's last word. It does not rely on each shard's
// list being sorted (a shard orders its ties by its local docid, the
// merge by okey). Float words follow lax.sort's order (fkey, common.cuh:
// -0.0 equals +0.0, NaN after +inf).
//
// The chunk merge (stripe = 0) is the same block over the n_chunks
// docid-range chunks of one query instead of S shards: xapiand_tpu/ops/
// executor.py _execute_chunked 1058-1063, lax.sort((-v, d, v),
// num_keys=2) of the chunks' top-k finalists, chunk-major - the relevance
// key with okey = the docid itself (no striping; the chunks partition the
// docids) and the finalist's position last, lax.sort being stable.
//
// Design. The block stages the M keys in shared memory as planes of word
// pairs (64 bits, the first word high; pair u of candidate i at u * M +
// i; then the gdoc and score planes), a thread a candidate; then each
// thread ranks its candidates by counting the candidates before them in
// the total order, four first pairs in flight, the other pairs read only
// where the first pairs tie, and stops counting at k (a candidate with k
// before it is not written): the ranking is a chain of shared-memory
// loads, not of device-memory ones, and the first pair (the score's word
// and the okey) decides nearly every compare. The candidates ranked below
// k are written at their rank, gdoc and score from the planes. 128
// threads a block where M <= 128 (the mesh's M = 80), else 256. Where the
// planes pass SM_SMEM_MAX (a merge of very wide pages) they live in a
// device scratch instead, read the same way. The first design wrote the
// keys to device memory and counted over all M keys from there: a chain
// of M dependent L2 loads a candidate (0.0153 ms device-only at the
// mesh's S8 Q36 k10 on an H100, 700 W).
//
// Reduce (xt_shard_reduce): a thread per (query, column), the S shards
// folded in shard order - a sum (int32 counts, exact; float32 packs), or a
// min / max that returns NaN if either side is NaN, as XLA's min / max; a
// NaN result is written as the one quiet NaN 0x7fc00000.
//
// Bound on the H100: the merge reads S*Q*k candidates (docid, score, and
// okey or the sort key words) once and writes Q*k; a comparison sort's
// M log2 M compares a query - at the mesh path's M = 80 the launch is its
// latency: the loads, the okey gathers, the ranking's shared-memory chain.
// The reduce reads S*Q*W once and writes Q*W.
#include "common.cuh"

#define SM_THREADS 256
#define SM_SMEM_MAX (160 * 1024)   // ops/kernels.py SHARD_MERGE_SMEM

// whether candidate j's key pairs 1 .. P - 1 are below candidate i's
// (their first pairs equal)
__device__ __forceinline__ int sm_tail_lt(const unsigned long long* kp,
                                          int M, int P, int j, int i) {
    for (int u = 1; u < P; ++u) {
        const unsigned long long x = kp[u * M + j], y = kp[u * M + i];
        if (x != y) return x < y ? 1 : 0;
    }
    return 0;
}

// candidate i's rank (the candidates before it), counted until it reaches
// k: past k it is not written
__device__ __forceinline__ int sm_rank(const unsigned long long* kp, int M,
                                       int P, int i, int k) {
    const unsigned long long a0 = kp[i];
    int rank = 0, j = 0;
    for (; j + 4 <= M && rank < k; j += 4) {
        unsigned long long c[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) c[t] = kp[j + t];
#pragma unroll
        for (int t = 0; t < 4; ++t)
            rank += c[t] != a0 ? (c[t] < a0 ? 1 : 0)
                               : sm_tail_lt(kp, M, P, j + t, i);
    }
    for (; j < M && rank < k; ++j) {
        const unsigned long long c = kp[j];
        rank += c != a0 ? (c < a0 ? 1 : 0) : sm_tail_lt(kp, M, P, j, i);
    }
    return rank;
}

// the planes of M candidates with key words nw: P = ceil(nw / 2) 64-bit
// planes of word pairs (the first word high), then the gdoc and score
// planes (32 bits); bytes
__host__ __device__ inline long long sm_plane_bytes(long long M, int nw) {
    return M * (8ll * ((nw + 1) / 2) + 8);
}

template <bool SHARED>
__global__ void __launch_bounds__(SM_THREADS) shard_merge_kernel(
    const int* __restrict__ docids, const float* __restrict__ scores,
    const int* __restrict__ okeys, long long n_okeys,
    const unsigned* __restrict__ skeys, int nu, int S, int Q, int k,
    int stripe, unsigned long long* __restrict__ scratch,
    int* __restrict__ out_d, float* __restrict__ out_s) {
    extern __shared__ unsigned long long sm_planes[];
    const int q = blockIdx.x;
    const int M = S * k;
    const int nw = (skeys != nullptr ? nu : 1) + 2;   // + okey, position
    const int P = (nw + 1) / 2;
    unsigned long long* kp =
        SHARED ? sm_planes
               : scratch + (long long)q * (sm_plane_bytes(M, nw) / 8);
    unsigned* gd = reinterpret_cast<unsigned*>(kp + (long long)P * M);
    unsigned* gs = gd + M;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
        const int s = i / k, j = i % k;
        const long long o = ((long long)s * Q + q) * k + j;
        const int d = __ldg(docids + o);
        const float sc = __ldg(scores + o);
        const bool invalid = isinf(sc) && sc < 0.0f;
        // int32 arithmetic wraps, as jnp's
        const int gdoc = invalid ? XT_I32MAX
                                 : stripe ? (int)((unsigned)d * (unsigned)S + s)
                                          : d;
        int okey = gdoc;
        if (okeys != nullptr) {
            const long long dd = d < 0 ? 0 : (d < n_okeys ? d : n_okeys - 1);
            okey = invalid ? XT_I32MAX
                           : __ldg(okeys + (long long)s * n_okeys + dd);
        }
        // word w of the key: the sort words or the negated score's, the
        // okey, the position; pairs of them high word first
        unsigned long long pair = 0;
        for (int w = 0; w < nw; ++w) {
            const unsigned x =
                w < nw - 2 ? (skeys != nullptr ? __ldg(skeys + o * nu + w)
                                               : fkey(-sc))
                           : w == nw - 2 ? ikey(okey) : (unsigned)i;
            if ((w & 1) == 0) {
                pair = (unsigned long long)x << 32;
                if (w == nw - 1) kp[(w >> 1) * M + i] = pair;
            } else {
                kp[(w >> 1) * M + i] = pair | x;
            }
        }
        gd[i] = (unsigned)gdoc;
        gs[i] = __float_as_uint(sc);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
        const int rank = sm_rank(kp, M, P, i, k);
        if (rank < k) {
            out_d[(long long)q * k + rank] = (int)gd[i];
            out_s[(long long)q * k + rank] = __uint_as_float(gs[i]);
        }
    }
}

// scratch: u64[Q * sm_plane_bytes(S * k, nw) / 8], nw = (nu or 1) + 2,
// where the planes pass SM_SMEM_MAX (else unused)
extern "C" int xt_shard_merge(const void* docids, const void* scores,
                              const void* okeys, long long n_okeys,
                              const void* skeys, int nu, int S, int Q, int k,
                              int stripe, void* scratch, void* out_d,
                              void* out_s, void* stream) {
    if (Q == 0 || k == 0) return 0;
    if (S < 1) return (int)cudaErrorInvalidValue;
    const long long M = (long long)S * k;
    const long long bytes =
        sm_plane_bytes(M, (skeys != nullptr ? nu : 1) + 2);
    const int threads = M <= 128 ? 128 : SM_THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (bytes > SM_SMEM_MAX) {
        if (scratch == nullptr) return (int)cudaErrorInvalidValue;
        shard_merge_kernel<false><<<Q, threads, 0, st>>>(
            (const int*)docids, (const float*)scores, (const int*)okeys,
            n_okeys, (const unsigned*)skeys, nu, S, Q, k, stripe,
            (unsigned long long*)scratch, (int*)out_d, (float*)out_s);
        return (int)cudaGetLastError();
    }
    static bool attr[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64 || !attr[dev]) {
        e = cudaFuncSetAttribute(shard_merge_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SM_SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        if (dev >= 0 && dev < 64) attr[dev] = true;
    }
    shard_merge_kernel<true><<<Q, threads, (size_t)bytes, st>>>(
        (const int*)docids, (const float*)scores, (const int*)okeys,
        n_okeys, (const unsigned*)skeys, nu, S, Q, k, stripe, nullptr,
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
