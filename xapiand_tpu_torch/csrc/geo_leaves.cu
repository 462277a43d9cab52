// geo_leaves: the exact HTM range test of each geo leaf, one verdict bit a
// leaf per row.
//
// Replaces (TPU): xapiand_tpu/ops/executor.py _gather_geo_leaves 367-399
// (K16), with the two rank_count sort-joins inside it (227-246, K15).
//
// A row is live when base[i] is set (owner & not deleted), or, without
// base (packed rows after compact_rows), when its docid is not SENTINEL; a
// row that is not live gets 0, and the tree (filter_leaves.cu) never reads
// it. For a live row and each geo leaf g the thread reads its doc's span
// of level-13 HTM ranges (doc_off, doc_len, at min(docid, nd1 - 1), as
// JAX's jnp.minimum(docids, nd1 - 1): a SENTINEL row reads the pad doc,
// whose span is empty), takes the first min(doc_len, RMAX) ranges (the
// static RMAX of the plan: a doc with more ranges is tested on its first
// RMAX only, as JAX's [C, RMAX] gather is; each range index clamps to
// GR - 1), and sets bit g iff one range [rs, re] satisfies
// #(qs <= re) > #(qe < rs) over the query's cover, whose ranges are
// sorted, merged and disjoint (htm.cover) and padded with INT32_MAX rows.
//
// One search a range. The cover's starts qs and ends qe are both
// ascending (pads included), so with k = #(qe < rs) (lower_bound of rs in
// qe), #(qs <= re) > k holds exactly when k < QR and qs[k] <= re: the
// (k+1)-th smallest start is at most re. That holds for any ascending qs,
// so the verdict is JAX's bit for bit, pads and re = INT32_MAX included.
// The TPU counted with two streaming sort-joins because its gathers
// serialise.
//
// Fewer steps. Each block stages its query's cover in shared memory
// (QR <= 1024 starts and ends, 8 KB) and builds a table over it: GL_NB
// buckets of 2^s ids from lo = qe[0], s the least shift that puts the
// last real end (below INT32_MAX) in the table, tab[h] = #(qe < lo +
// (h << s)). A range start rs in bucket h (h = 0 below lo, GL_NB - 1
// past the table) has its k in [tab[h], tab[h + 1]] (QR for the last
// bucket), so the search is a binary search of that bracket, most often a
// step or two, and exact whatever the bracket's size.
//
// One block a tile of GL_THREADS rows of one query (256), a row a
// thread. The launch is bound by the latency of each row's chain of
// gathers (docid, span, range), so what counts is the rows in flight:
// 2,048 threads an SM, 32 registers a thread at most. More state a thread
// lost more than it hid: 8 rows a thread took 1.4x the parent's time at
// geo's shapes, and a row's 8 ranges gathered at once (58 registers)
// 1.2x a range at a time. Staging the cover once a 1,024 rows (blocks of
// 1,024) was 3-4% slower than once a 256 at geo's launches and 10% at
// the geo aggregations' in the final design: a bigger block waits longer
// at its barriers for its slowest row. A block with no live row writes
// zeros and returns.
//
// Column table, int64 per geo leaf: span (i32[nd1, 2], each doc's doc_off
// and doc_len) and flat (i32[GR, 2], each range's start and end), device
// pointers to the column's int2 pairs, which the segment uploads beside
// its four channels (models/segment.py geo_arrays); nd1, GR, QR, RMAX,
// the cover (device pointer to i32[B, QR, 2]).
//
// Bound on the H100: bytes - per row the docid and flag read and the word
// written, per live row its span and ranges, 8 bytes each. The launch
// takes ~4x that: it waits on each row's chain of gathers. Reading the
// span and a range as one int2 each (two 32-byte sectors a live row where
// the four int32 arrays took four) saved ~15%. Against one search of the
// whole cover, the bracket table saves 6-8% at geo's launches (B8,
// R184448 and R312960) and costs 5% at the geo aggregations' (B64
// R25728), in this kernel's blocks of 256 rows (in blocks of 1,024 it
// saved 10-18% and 4-9%); it is kept for geo, whose launches are the many
// (161 a run against the aggregations' 4).
#include "common.cuh"

#define GL_COLS 7
#define GL_THREADS 256           // rows a block, a row a thread
#define GL_NB_LOG 9
#define GL_NB (1 << GL_NB_LOG)   // bucket table entries: 512

// #(a[i] < x) over the ascending a[0, n), x 64-bit
__device__ __forceinline__ int count_below(const int* a, int n, long long x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((long long)a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(GL_THREADS, 2048 / GL_THREADS)
geo_leaves_kernel(
    const int* __restrict__ docids, const unsigned char* __restrict__ base,
    const long long* __restrict__ cols, int C, int G, int qr_max,
    int* __restrict__ geobits) {
    extern __shared__ int smem[];     // qs[qr_max], qe[qr_max], tab[NB + 1]
    int* qs = smem;
    int* qe = smem + qr_max;
    int* tab = smem + 2 * qr_max;
    __shared__ int shift;
    const int b = blockIdx.y;
    const int r = blockIdx.x * GL_THREADS + threadIdx.x;
    const long long i = (long long)b * C + r;
    int d = 0;
    bool live = false;
    if (r < C) {
        d = docids[i];
        live = base ? base[i] != 0 : d != XT_SENTINEL;
    }
    unsigned bits = 0;
    if (__syncthreads_or(live)) {
        for (int g = 0; g < G; ++g) {
            const long long* c = cols + g * GL_COLS;
            const int2* span = (const int2*)c[0];
            const int2* flat = (const int2*)c[1];
            const long long nd1 = c[2], GR = c[3];
            const int QR = (int)c[4], RMAX = (int)c[5];
            const int* q = (const int*)c[6] + (long long)b * QR * 2;
            __syncthreads();   // every thread is done with the last cover
            if (threadIdx.x == 0) shift = 0;
            for (int j = threadIdx.x; j < QR; j += GL_THREADS) {
                qs[j] = q[2 * j];
                qe[j] = q[2 * j + 1];
            }
            __syncthreads();
            const long long lo = qe[0];
            // the thread holding the last end below INT32_MAX (the pads
            // are INT32_MAX) sets the shift: the least s with
            // (end - lo) >> s < GL_NB
            for (int j = threadIdx.x; j < QR; j += GL_THREADS)
                if (qe[j] != 2147483647 &&
                    (j + 1 == QR || qe[j + 1] == 2147483647)) {
                    const long long span_ids = (long long)qe[j] - lo;
                    const int bits_ = 64 - __clzll(span_ids);
                    shift = bits_ > GL_NB_LOG ? bits_ - GL_NB_LOG : 0;
                }
            __syncthreads();
            const int s = shift;
            for (int h = threadIdx.x; h < GL_NB; h += GL_THREADS)
                tab[h] = count_below(qe, QR, lo + ((long long)h << s));
            if (threadIdx.x == 0) tab[GL_NB] = QR;
            __syncthreads();
            if (!live) continue;
            const int2 sp = span[(long long)d < nd1 - 1 ? (long long)d
                                                        : nd1 - 1];
            const int n = min(sp.y, RMAX);
            for (int j = 0; j < n; ++j) {
                const long long ri = (long long)sp.x + j;
                const int2 fr = flat[ri < GR - 1 ? ri : GR - 1];
                const long long x = fr.x;
                const int h = x < lo ? 0
                    : (int)min((x - lo) >> s, (long long)GL_NB - 1);
                const int a = tab[h], e = tab[h + 1];
                const int k = a + lower_bound_i32(qe + a, e - a, fr.x);
                if (k < QR && qs[k] <= fr.y) {
                    bits |= 1u << g;
                    break;
                }
            }
        }
    }
    if (r < C) geobits[i] = (int)bits;
}

extern "C" int xt_geo_leaves(const void* docids, const void* base,
                             const void* cols, int B, int C, int G,
                             int qr_max, void* geobits, void* stream) {
    if (B == 0 || C == 0) return 0;
    // qr_max <= 1024 (kernels.MAX_GEO_QR): at most 10 KB
    const int smem = (2 * qr_max + GL_NB + 1) * (int)sizeof(int);
    dim3 grid((C + GL_THREADS - 1) / GL_THREADS, B);
    geo_leaves_kernel<<<grid, GL_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)docids, (const unsigned char*)base,
        (const long long*)cols, C, G, qr_max, (int*)geobits);
    return (int)cudaGetLastError();
}
