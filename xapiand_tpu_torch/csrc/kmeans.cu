// kmeans: a whole kmeans_cosine call, `iters` steps of spherical k-means
// over the L2-normalised rows of X and then, if asked, the last
// assignment, in one launch.
//
// Replaces (TPU): xapiand_tpu/ops/cluster.py kmeans_cosine (K20), one
// jitted function: its lax.fori_loop (73) of `step` (63-71: sims = X·Cᵀ
// on the MXU, labels = the first argmax of each row, new C = one-hotᵀ·X,
// each row divided by its norm, where(norm > 1e-6, c / max(norm, 1e-6),
// the old c)) and its last assignment (74-75).
//
// G thread-block clusters of S blocks each (S <= 16, G <= 16 and no more
// than fit the card at once; kernels.kmeans_plan's choice from the work;
// launched with cudaLaunchKernelEx and the cluster dimension attribute).
// Cluster g takes the rows [g·n/G, (g+1)·n/G). Its block b owns the
// columns [b·V/S, (b+1)·V/S): its slice of C (transposed,
// [column][centroid]) and of the new sums stay in its shared memory for
// the whole call. A step goes over the cluster's rows in chunks of RC rows
// (RC from k: a block's 256 threads each hold a 4-row x 4-centroid tile of
// the products):
//  1. the chunk's slice of X is staged in shared memory, transposed, 16
//     rows' loads of a thread in flight (once a call where one chunk holds
//     the cluster's rows, n / G <= RC: the REST path's n 10 and n 256);
//  2. each block writes its partial dot products [chunk x k] over its
//     columns (FP32 FMAs, fmaf; a few rows split the columns of a tile
//     over up to 64 threads, their partials then added in part order)
//     into its own shared memory; cluster.sync;
//  3. block b reduces its share of the chunk's rows: each (row, centroid)
//     adds every block's partials through distributed shared memory
//     (map_shared_rank) in block order 0..S-1, so the sum does not depend
//     on which block computes it, and takes the first maximum on a tie, as
//     jnp.argmax; it writes the label to every block's shared memory, the
//     output and the history; cluster.sync;
//  4. in an update step, each block adds the chunk's rows of each label
//     into its column slice: the chunk's labels counting-sorted (stable,
//     the warps' counts scanned), a thread a column adds a label's rows in
//     row order (where the block has fewer columns than half its threads,
//     groups of threads share the labels of a column), then the chunk's
//     sum onto the label's running sum, chunk after chunk.
// Where G > 1, after the last chunk of an update step each block writes
// its running sums to a device buffer (two, by the step's parity), the
// blocks of one column slice meet at a barrier of their own (a counter in
// device memory; all G clusters are resident, and a wait past ~4 s traps
// rather than hangs), and each adds the G clusters' sums of its columns
// in cluster order 0..G-1, so every cluster holds the same sums.
// Then each block reduces the squared
// norms of its columns per centroid (a warp a centroid, a fixed butterfly)
// and, after a cluster.sync, adds every block's in block order; then
// writes where(norm > 1e-6, s / max(norm, 1e-6), old c) into its C.
//
// Exactness: a dot product is a sum over the column slices in block order
// (FMAs inside a slice), not the order of the plain version's matmul, so
// labels are held by the margin rule (ops/cluster.py label_margin_bound:
// any float32 evaluation of a length-V dot product of unit vectors lies
// within gamma_V of the exact one) and centroids within rtol 1e-5 of the
// float64 update of the kernel's own labels; every sum is in a fixed order,
// so two runs at the same G give the same bits (G is the plan's, cut to
// the clusters the card holds at once). TF32 tensor cores (a 10-bit
// mantissa) would break the margin, so the products are FP32 FMAs on the
// SIMT cores.
//
// Bound on the H100: X, C and the outputs once, (n·V + 2·k·V + n)·4
// bytes, and iters·(2·n·V·k + n·V + 3·k·V) + 2·n·V·k float operations with
// the last assignment: ~0.087 ms at n 4096, V 2048, k 16, 20 steps (67
// TFLOP/s).
// A cluster is at most 16 of the 132 SMs, each at ~1/132 of that rate,
// and every step pays its phases' latencies (two cluster barriers a chunk,
// the reductions, the sort, the norms): latency-bound at small n. Where
// the rows take several chunks a step, each step restages them on S SMs,
// so G clusters split the rows and each restages 1/G of them (n 4096: 8
// clusters of 16 blocks, 2 chunks a step each, not 16).
//
// Where a plan's buffers exceed shared memory (k·V large), they live in a
// device-memory workspace the wrapper passes, with one block (S = 1).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define KM_THREADS 256
#define KM_MAX_CLUSTER 16
#define KM_MAX_GRID 16      // clusters a launch at most
#define KM_SMEM 232448      // the H100's shared memory a block, bytes
#define KM_PARTS 64         // column parts of a tile at most
#define KM_WARPS (KM_THREADS / 32)
#define KM_BATCH 16         // staging loads of a thread in flight

// a block's buffers, in 4-byte words (kernels.py _km_words mirrors it)
struct KmLayout {
    int w, kp, RCp, own;
    long long cs, xt, ss, p, q, lab, list, cnt, nrm, nfin, total;
};

__host__ __device__ inline long long km_round4(long long x) {
    return (x + 3) & ~3LL;
}

__host__ __device__ inline KmLayout km_layout(int V, int k, int S, int RC) {
    KmLayout L;
    L.w = (V + S - 1) / S;            // a block's columns at most
    L.kp = (k + 3) / 4 * 4;           // centroids padded to 4
    // X's staged column stride, 4 mod 8 floats: a column's rows 16-byte
    // aligned, neighbouring columns on 8 distinct 4-bank groups
    L.RCp = RC % 8 ? RC : RC + 4;
    L.own = (RC + S - 1) / S;         // rows a block reduces at most
    long long at = 0;
    L.cs = at;                        // C [w][kp]
    at += km_round4((long long)L.w * L.kp);
    L.xt = at;                        // X chunk [w][RCp]
    at += km_round4((long long)L.w * L.RCp);
    L.ss = at;                        // sums [kp][w]
    at += km_round4((long long)L.kp * L.w);
    L.p = at;                         // partials [parts][rows][kp]
    const long long pn = (long long)RC * L.kp;
    at += km_round4(pn > 4096 ? pn : 4096);
    L.q = at;                         // reduced sums [own][kp], or
    const long long qn = (long long)L.own * L.kp;   // the warps' places
    at += km_round4(qn > KM_WARPS * L.kp ? qn : KM_WARPS * L.kp);
    L.lab = at;                       // the chunk's labels [RC]
    at += RC;
    L.list = at;                      // its rows by label [RC], then
    at += RC + KM_WARPS * (long long)L.kp;  // each warp's counts [8][kp]
    L.cnt = at;                       // each label's rows and start [2][kp]
    at += km_round4(2LL * L.kp);
    L.nrm = at;                       // squared norms [kp]
    at += L.kp;
    L.nfin = at;                      // the cluster's norms [kp]
    at += L.kp;
    L.total = at;
    return L;
}

__device__ __forceinline__ void km_sync(cg::cluster_group& cl, int S) {
    if (S > 1)
        cl.sync();
    else
        __syncthreads();
}

__device__ __forceinline__ float* km_peer(cg::cluster_group& cl, float* p,
                                          int S, int rank) {
    return S > 1 ? cl.map_shared_rank(p, (unsigned)rank) : p;
}

// the G blocks of one column slice (one a cluster) meet: each adds one to
// the slice's counter and waits for target (G a barrier so far); a wait
// past ~2^33 cycles traps, so a launch whose clusters were not all
// resident fails rather than hangs
__device__ __forceinline__ void km_grid_sync(int* bar, int target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(bar, 1);
        const long long t0 = clock64();
        while (*reinterpret_cast<volatile int*>(bar) < target) {
            __nanosleep(32);
            if (clock64() - t0 > (1LL << 33)) __trap();
        }
        __threadfence();
    }
    __syncthreads();
}

// rows [r0, r0 + rc) of X's columns [col0, col0 + w) into Xt [w][RCp],
// transposed, and zero rows up to rc4: a lane a column (coalesced loads),
// the warps over the rows, KM_BATCH rows' loads of a thread in flight
// before their stores
__device__ __forceinline__ void km_stage(const float* __restrict__ X,
                                         float* Xt, int V, int col0, int w,
                                         int RCp, int r0, int rc, int rc4) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = lane; j < w; j += 32) {
        const float* xj = X + (long long)r0 * V + col0 + j;
        float* dst = Xt + j * RCp;
        for (int rl0 = warp; rl0 < rc4; rl0 += KM_WARPS * KM_BATCH) {
            float v[KM_BATCH];
#pragma unroll
            for (int u = 0; u < KM_BATCH; ++u) {
                const int rl = rl0 + u * KM_WARPS;
                v[u] = rl < rc ? __ldg(xj + (long long)rl * V) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < KM_BATCH; ++u) {
                const int rl = rl0 + u * KM_WARPS;
                if (rl < rc4) dst[rl] = v[u];
            }
        }
    }
    __syncthreads();
}

// WS: the buffers in the device workspace `work` (one block), else in
// shared memory (every pointer derived from the shared array, so the
// compiler issues shared-memory loads)
template <bool WS>
__global__ void __launch_bounds__(KM_THREADS) kmeans_loop_kernel(
    const float* __restrict__ X, const float* __restrict__ C0, int n, int V,
    int k, int iters, int assign_last, int RC, float* __restrict__ work,
    float* __restrict__ part, int* __restrict__ bar,
    int* __restrict__ labels, float* __restrict__ Cout,
    int* __restrict__ hist_l, float* __restrict__ hist_c) {
    extern __shared__ float4 km_smem[];
    cg::cluster_group cl = cg::this_cluster();
    const int S = WS ? 1 : (int)cl.num_blocks();
    const int b = WS ? 0 : (int)cl.block_rank();
    const int G = (int)gridDim.x / S, g = (int)blockIdx.x / S;
    // this cluster's rows
    const int rs = (int)((long long)g * n / G);
    const int re = (int)((long long)(g + 1) * n / G);
    const KmLayout L = km_layout(V, k, S, RC);
    float* base = WS ? work : reinterpret_cast<float*>(km_smem);
    float* Cs = base + L.cs;
    float* Xt = base + L.xt;
    float* Ss = base + L.ss;
    float* P = base + L.p;
    float* Q = base + L.q;
    int* lab = reinterpret_cast<int*>(base + L.lab);
    int* list = reinterpret_cast<int*>(base + L.list);
    int* cnt = reinterpret_cast<int*>(base + L.cnt);
    int* start = cnt + L.kp;
    float* nrm = base + L.nrm;
    float* nfin = base + L.nfin;
    const int kp = L.kp, RCp = L.RCp, ws = L.w;
    const int col0 = (int)((long long)b * V / S);
    const int w = (int)((long long)(b + 1) * V / S) - col0;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned full = 0xffffffffu;

    for (int j = tid; j < ws; j += KM_THREADS)
        for (int c = 0; c < kp; ++c)
            Cs[j * kp + c] =
                (j < w && c < k) ? C0[(long long)c * V + col0 + j] : 0.0f;
    for (int i = tid; i < kp * ws; i += KM_THREADS) Ss[i] = 0.0f;
    // one chunk holds the cluster's rows: its X stays staged for the call
    const bool resident = re - rs <= RC;
    if (resident)
        km_stage(X, Xt, V, col0, w, RCp, rs, re - rs, (re - rs + 3) & ~3);
    __syncthreads();

    const int steps = iters + (assign_last ? 1 : 0);
    for (int t = 0; t < steps; ++t) {
        const bool upd = t < iters;
        if (upd && hist_c && g == 0)
            for (int j = tid; j < w; j += KM_THREADS)
                for (int c = 0; c < k; ++c)
                    hist_c[((long long)t * k + c) * V + col0 + j] =
                        Cs[j * kp + c];
        for (int r0 = rs; r0 < re; r0 += RC) {
            const int rc = min(RC, re - r0), rc4 = (rc + 3) & ~3;
            // 1. the chunk's columns of X, transposed (staged once where
            // one chunk holds every row)
            __syncthreads();
            if (!resident) km_stage(X, Xt, V, col0, w, RCp, r0, rc, rc4);
            // 2. the partial products: 4x4 tiles of (rows, centroids), the
            // columns of a tile over CP threads where the tiles are few
            const int nrg = rc4 / 4, tiles = nrg * (kp / 4);
            int CP = 1;
            while (CP < KM_PARTS && tiles * CP * 2 <= KM_THREADS) CP *= 2;
            const int cp = tid % CP;
            for (int it = tid / CP; it < tiles; it += KM_THREADS / CP) {
                const int rg = it % nrg, g = it / nrg;
                float acc[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
#pragma unroll 4
                for (int j = cp; j < w; j += CP) {
                    const float4 x4 = *reinterpret_cast<const float4*>(
                        Xt + j * RCp + 4 * rg);
                    const float4 c4 = *reinterpret_cast<const float4*>(
                        Cs + j * kp + 4 * g);
                    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
                    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            acc[i][q] = fmaf(xv[i], cv[q], acc[i][q]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        P[(cp * rc4 + 4 * rg + i) * kp + 4 * g + q] =
                            acc[i][q];
            }
            if (CP > 1) {
                // the column parts of each (row, centroid), in part order,
                // into part 0
                __syncthreads();
                for (int p = tid; p < rc * kp; p += KM_THREADS) {
                    float s = P[p];
#pragma unroll 8
                    for (int q = 1; q < CP; ++q) s = s + P[q * rc4 * kp + p];
                    P[p] = s;
                }
            }
            km_sync(cl, S);
            // 3. this block's rows of the chunk: every block's partials in
            // block order (every load in flight at once, then the adds),
            // the first maximum, the label to every block
            const int lo = (int)((long long)b * rc / S);
            const int no = (int)((long long)(b + 1) * rc / S) - lo;
            for (int p = tid; p < no * k; p += KM_THREADS) {
                const int rl = lo + p / k, c = p % k;
                float v[KM_MAX_CLUSTER];
#pragma unroll
                for (int sb = 0; sb < KM_MAX_CLUSTER; ++sb)
                    if (sb < S) v[sb] = km_peer(cl, P, S, sb)[rl * kp + c];
                float s = 0.0f;
#pragma unroll
                for (int sb = 0; sb < KM_MAX_CLUSTER; ++sb)
                    if (sb < S) s = s + v[sb];
                Q[(p / k) * kp + c] = s;
            }
            __syncthreads();
            for (int i = tid; i < no; i += KM_THREADS) {
                float best = -INFINITY;
                int bi = 0;
                for (int c = 0; c < k; ++c) {
                    const float v = Q[i * kp + c];
                    if (v > best) {     // the first maximum wins
                        best = v;
                        bi = c;
                    }
                }
                const int row = r0 + lo + i;
                labels[row] = bi;
                if (upd) {
                    if (hist_l) hist_l[(long long)t * n + row] = bi;
                    for (int sb = 0; sb < S; ++sb)
                        reinterpret_cast<int*>(km_peer(
                            cl, reinterpret_cast<float*>(lab), S,
                            sb))[lo + i] = bi;
                }
            }
            km_sync(cl, S);
            if (!upd) continue;
            // 4. the chunk's rows by label (stable): each warp counts its
            // share of the rows per label, the counts are scanned label by
            // label and warp by warp, and each warp places its rows
            const int per = (rc + KM_WARPS - 1) / KM_WARPS;
            const int w0 = min(rc, warp * per), w1 = min(rc, w0 + per);
            int* wcnt = list + RC;              // [KM_WARPS][kp]
            for (int c = lane; c < k; c += 32) wcnt[warp * kp + c] = 0;
            __syncwarp();
            for (int r = w0; r < w1; r += 32) {
                const int l = r + lane < w1 ? lab[r + lane] : -1;
                const unsigned same = __match_any_sync(full, l);
                if (l >= 0 && lane == 31 - __clz(same))
                    wcnt[warp * kp + l] += __popc(same);
                __syncwarp();
            }
            __syncthreads();
            if (warp == 0) {
                // start[c]: where label c's rows start; cnt[c]: how many
                int carry = 0;
                for (int c0 = 0; c0 < k; c0 += 32) {
                    const int c = c0 + lane;
                    int x = 0;
                    if (c < k)
                        for (int v = 0; v < KM_WARPS; ++v)
                            x += wcnt[v * kp + c];
                    const int own = x;
                    for (int o = 1; o < 32; o <<= 1) {
                        const int y = __shfl_up_sync(full, x, o);
                        if (lane >= o) x += y;
                    }
                    if (c < k) {
                        cnt[c] = own;
                        start[c] = carry + x - own;
                    }
                    carry += __shfl_sync(full, x, 31);
                }
            }
            __syncthreads();
            {
                // this warp's place in each label: after the warps before
                int* at = reinterpret_cast<int*>(Q) + warp * kp;
                for (int c = lane; c < k; c += 32) {
                    int x = start[c];
                    for (int v = 0; v < warp; ++v) x += wcnt[v * kp + c];
                    at[c] = x;
                }
                __syncwarp();
                for (int r = w0; r < w1; r += 32) {
                    const int l = r + lane < w1 ? lab[r + lane] : -1;
                    const unsigned same = __match_any_sync(full, l);
                    if (l >= 0)
                        list[at[l] + __popc(same & ((1u << lane) - 1))] =
                            r + lane;
                    __syncwarp();
                    if (l >= 0 && lane == 31 - __clz(same))
                        at[l] += __popc(same);
                    __syncwarp();
                }
            }
            __syncthreads();
            // each label's rows in row order (four rows' loads in flight)
            // onto its running sum: a thread a column, and where the block
            // has fewer columns than half its threads, G groups of threads
            // a column each, group g the labels c = g mod G
            const int G = 2 * w > KM_THREADS || w == 0 ? 1 : KM_THREADS / w;
            const int grp = G > 1 ? tid / w : 0;
            for (int j = G > 1 ? tid - grp * w : tid; j < w && grp < G;
                 j += KM_THREADS) {
                const float* xj = Xt + j * RCp;
                for (int c = grp; c < k; c += G) {
                    const int a = start[c], e = a + cnt[c];
                    if (a == e) continue;
                    float s = 0.0f;
                    int i = a;
                    for (; i + 4 <= e; i += 4) {
                        const int r0 = list[i], r1 = list[i + 1],
                                  r2 = list[i + 2], r3 = list[i + 3];
                        const float v0 = xj[r0], v1 = xj[r1], v2 = xj[r2],
                                    v3 = xj[r3];
                        s = s + v0;
                        s = s + v1;
                        s = s + v2;
                        s = s + v3;
                    }
                    for (; i < e; ++i) s = s + xj[list[i]];
                    Ss[c * ws + j] = Ss[c * ws + j] + s;
                }
            }
        }
        if (!upd) continue;
        if (G > 1) {
            // every cluster's sums of this block's columns, in cluster
            // order (a buffer by the step's parity: a block writes it
            // again only after every block passed the next barrier)
            float* pb = part + (long long)(t & 1) * G * k * V;
            __syncthreads();
            for (int i = tid; i < k * w; i += KM_THREADS) {
                const int c = i / w, j = i - c * w;
                __stcg(pb + ((long long)g * k + c) * V + col0 + j,
                       Ss[c * ws + j]);
            }
            km_grid_sync(bar + b, G * (t + 1));
            for (int i = tid; i < k * w; i += KM_THREADS) {
                const int c = i / w, j = i - c * w;
                const float* src = pb + (long long)c * V + col0 + j;
                float v[KM_MAX_GRID];
#pragma unroll
                for (int q = 0; q < KM_MAX_GRID; ++q)
                    if (q < G) v[q] = __ldcg(src + (long long)q * k * V);
                float s = v[0];
#pragma unroll
                for (int q = 1; q < KM_MAX_GRID; ++q)
                    if (q < G) s = s + v[q];
                Ss[c * ws + j] = s;
            }
        }
        // the norms: a block's squared norms, then every block's in order
        __syncthreads();
        for (int c = warp; c < k; c += KM_WARPS) {
            float q = 0.0f;
#pragma unroll 4
            for (int j = lane; j < w; j += 32) {
                const float v = Ss[c * ws + j];
                q = q + v * v;
            }
            // a butterfly: every lane holds the same sum
            for (int o = 16; o; o >>= 1) q = q + __shfl_xor_sync(full, q, o);
            if (lane == 0) nrm[c] = q;
        }
        km_sync(cl, S);
        for (int c = tid; c < k; c += KM_THREADS) {
            float v[KM_MAX_CLUSTER];
#pragma unroll
            for (int sb = 0; sb < KM_MAX_CLUSTER; ++sb)
                if (sb < S) v[sb] = km_peer(cl, nrm, S, sb)[c];
            float q = 0.0f;
#pragma unroll
            for (int sb = 0; sb < KM_MAX_CLUSTER; ++sb)
                if (sb < S) q = q + v[sb];
            nfin[c] = sqrtf(q);
        }
        __syncthreads();
        // the new centroids, the sums cleared for the next step
        for (int j = tid; j < w; j += KM_THREADS)
            for (int c = 0; c < k; ++c) {
                const float v = Ss[c * ws + j], norm = nfin[c];
                Ss[c * ws + j] = 0.0f;
                if (norm > 1e-6f) Cs[j * kp + c] = v / fmaxf(norm, 1e-6f);
            }
        __syncthreads();
    }
    if (g == 0)
        for (int j = tid; j < w; j += KM_THREADS)
            for (int c = 0; c < k; ++c)
                Cout[(long long)c * V + col0 + j] = Cs[j * kp + c];
    // no block leaves while another may read its shared memory
    if (S > 1) cl.sync();
}

// X f32[n][V], C0 f32[k][V] (rows of unit norm, or kept old centroids);
// S blocks a cluster, RC rows a chunk and G clusters at most
// (kernels.kmeans_plan; G is cut to the clusters the card holds at once);
// work, a device workspace of km_layout(V, k, 1, RC).total floats where
// the buffers exceed shared memory (S = 1, G = 1), else null; where G > 1,
// part f32[2][G][k][V] and bar i32[S], zeros; labels i32[n], C f32[k]
// [V] out; hist_l i32[iters][n] and hist_c f32[iters][k][V] (each step's
// labels and input centroids) or null
extern "C" int xt_kmeans_loop(const void* X, const void* C0, int n, int V,
                              int k, int iters, int assign_last, int S,
                              int RC, int G, void* work, void* part,
                              void* bar, void* labels, void* C,
                              void* hist_l, void* hist_c, void* stream) {
    if (n <= 0 || k <= 0 || k > n || V < 0 || iters < 0 ||
        (iters == 0 && !assign_last) || S < 1 || S > KM_MAX_CLUSTER ||
        RC < 4 || RC % 4 || G < 1 || G > KM_MAX_GRID || G > n ||
        (work && (S != 1 || G != 1)) || (G > 1 && (!part || !bar)))
        return (int)cudaErrorInvalidValue;
    const KmLayout L = km_layout(V, k, S, RC);
    const long long smem = work ? 0 : 4 * L.total;
    if (smem > KM_SMEM) return (int)cudaErrorInvalidValue;
    auto kernel = work ? kmeans_loop_kernel<true>
                       : kmeans_loop_kernel<false>;
    static bool attrs = false;
    if (!attrs) {
        int rc = (int)cudaFuncSetAttribute(
            kmeans_loop_kernel<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, KM_SMEM);
        if (!rc)
            rc = (int)cudaFuncSetAttribute(
                kmeans_loop_kernel<false>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (rc) return rc;
        attrs = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)S, 1, 1);
    cfg.blockDim = dim3(KM_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a cluster of this size and shared memory must fit the card, and the
    // G clusters must be resident at once (their barriers wait on each
    // other): the clusters it holds, asked once a shape; none raises in
    // the wrapper, there is no fallback
    static long long fits[64][2];
    static int n_fits = 0;
    const long long key = (smem * 32 + S) * 2 + (work ? 1 : 0);
    int clusters = 0;
    for (int i = 0; i < n_fits; ++i)
        if (fits[i][0] == key) clusters = (int)fits[i][1];
    if (!clusters) {
        const int rc = (int)cudaOccupancyMaxActiveClusters(
            &clusters, kernel, &cfg);
        if (rc) return rc;
        if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
        if (n_fits < 64) {
            fits[n_fits][0] = key;
            fits[n_fits++][1] = clusters;
        }
    }
    if (G > clusters) G = clusters;
    cfg.gridDim = dim3((unsigned)(G * S), 1, 1);
    const int rc = (int)cudaLaunchKernelEx(
        &cfg, kernel, (const float*)X, (const float*)C0, n, V, k,
        iters, assign_last, RC, (float*)work, (float*)part, (int*)bar,
        (int*)labels, (float*)C, (int*)hist_l, (float*)hist_c);
    if (rc) return rc;
    return (int)cudaGetLastError();
}
