"""The port's device kernels: ctypes-bound CUDA launchers, their plain
PyTorch versions, and launch counters.

Twenty-five kernels carry search, clustering and the mesh merge (sources
in ``../csrc``; each file's header names the TPU function it replaces,
what bounds it on the H100 and what its design does about that):

  score_slices    K1     per-(query, term) posting slice + the scheme's
                  +K18   weight (BM25 or any of the other 15 schemes): row
                         tiles over every term, a block a prefix term
  merge_docs      K2+K3  per-doc sums and OR of group bits: doc tiles
                  +K6    summed in term order, or a binary-search join;
                         owner & not deleted & boolean tree; count
  topk_rows       K4     exact top-k by (score desc, docid asc): row
                         tiles' top-k, then their merge
  prefix_certify  K5     exact rescore of prefix candidates + certificate
  filter_leaves   K7+K6  value-range filter leaves, then the boolean tree:
                         row tiles of 16 flags first, a leaf's four key
                         words in one gather of the column's packed keys
  sort_topk       K8     top-k in multi-key sort order (value, score, dist,
                         geodist, strmetric, docid), docid tiebreak: row
                         tiles' top-k behind a threshold, each key built
                         word by word, then their merge
  compact_rows    K11    stream compaction of the masked rows to a cap
  fullwidth_topk  K9     sort-free top-k of one sort key at full width,
                         with the exactness certificate: each warp's
                         eligible rows kept behind a threshold in a
                         buffer whose kk best it selects when it fills,
                         then each query's candidates selected again
  agg_metrics     K17a   count, masked n / sum / sum of squares / min /
                         max of value columns, in one launch: the flags
                         first, each warp's eligible rows queued and
                         drained a row a lane, the last block of a query
                         folds the others' partials
  agg_buckets     K17a   terms / missing bucket counts with per-bucket
                         metric sub-aggregations, in one launch: every
                         warp walks the subs' rows, the last block of a
                         query folds the others' partials
  phrase_leaves   K14    PHRASE / NEAR verdicts of the first cand_cap
                  +K15   candidates of each phrase leaf, found by binary
                         search (wrapper and plain version: ops/phrase.py)
  geo_leaves      K16    the exact HTM range test of each geo leaf, one
                  +K15   bit a leaf, its two rank counts binary searches
                         over the query's cover (rank_count's)

  collapse_rows   K10    the survivors of a collapse (per key the best
                         min(collapse_max, 8) rows by score) and each
                         row's tie rank, which topk_rows then orders by:
                         per-block key tables in shared memory merged by
                         one block a query, or a global table a query for
                         a column of many keys (collapse_plan)
  dense_rows      K12    the dense match-all path's rows, one per (query,
                         doc): scores, group bits and the live mask, each
                         doc tile's postings walked term by term
  merge_special   K13    the per-doc sums of OP_MAX (best branch) and
                         OP_SYNONYM (summed wdf scored once) plans: doc
                         tiles with a shared slot a (doc, channel), or a
                         binary-search join (special_plan)
  agg_distinct    K17b   cardinality: the exact distinct count of value
                         keys and 1024 HyperLogLog registers: a bit set
                         of the column's dense codes a query, then its
                         fold (geo_stats, K17b's other half, is two
                         columns of agg_metrics)

  agg_buckets     K17c   (the same kernel) the single-code bucket kinds
                         that read plan arrays: histogram, each level of a
                         nested chain, geo_trixels, the filter bucket;
                         and each row's bucket code for agg_hist
  agg_ranges      K17c   range, geodist_range, key_range and geo_ip: the
                         ranges a row lies in (several at once), their
                         counts and metric subs, in one launch of
                         agg_metrics' row queues and last-block fold
  agg_hist        K17c   the fixed-grid order-statistic histograms of
                         median, mode, percentiles and median / mode subs,
                         in one launch of agg_metrics' row queues: the
                         top level's last block converts a zero-kept
                         scratch, the subs' hist2 by float atomics
  agg_filter      K17c   the filter bucket's rows: each docid looked up in
                         each filter term's posting window

  kmeans          K20    a kmeans_cosine call (ops/cluster.py): its steps
                         of spherical k-means and the last assignment in
                         one launch of a thread-block cluster that splits
                         the columns (kmeans_loop; kmeans, one step)

  wide_topk       K4+K8  topk_rows and sort_topk at any k and any number
                         of sort key words (their wide mode, past MAX_TOPK
                         and sort_topk's per-thread lists): row tiles that
                         select their k best by radix passes over the rows
                         still tied, then a merge of the tiles' sorted
                         lists by ranks
  shard_merge     K19    the mesh merge: each query's global top-k of S
                         shards' top-k lists, striped docids, by score or
                         by the shards' emitted sort keys, insertion-order
                         ties (parallel/sharded.py): the keys staged in
                         shared memory, each ranked by counting up to k
  shard_reduce    K19    the psum of the counts and the psum / pmin / pmax
                         of the packed aggregation statistics over S shards

  semijoin_rows   K21    a semijoin plan's rows: the drive term's postings,
                         every other term probed by binary search inside
                         the bracket of a block of drive rows' docids
  chunk_merge     K21    docid-chunked execution's finalists ranked by
                         (score desc, docid asc): shard_merge.cu's
                         relevance mode over the chunks, unstriped

The boolean tree (K6) is compiled on the host into a short postfix
program (``tree_program``) that merge_docs and filter_leaves evaluate per
row; filter_leaves also reads each row's words of phrase and geo
verdicts.

Dispatch: a wrapper given CUDA tensors launches its kernel (on the current
stream) or raises; given CPU tensors it runs the plain version. Nothing
falls back from one to the other. ``launches[name]`` counts kernel
launches only.

The CUDA sources are compiled with nvcc for sm_90a, one nvcc per source,
all started together, and linked into one shared library with a plain C
interface, at first use, into ``xapiand_tpu_torch/_build/`` keyed by a
hash of the sources and flags. Importing this module builds nothing and
needs no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

import torch

from xapiand_tpu_torch.models.weights import (SCHEME_PARAMS, SchemeSpec,
                                              scheme_sumpart)

SENTINEL = 2**31 - 1
I32MAX = 2**31 - 1
MAX_PREFIX_ROWS = 16384   # score_slices sorts a prefix block in 128 KB smem
                          # (wider: in a device-memory scratch)
MERGE_TILE = 4096         # merge_docs: docids a doc tile (shared memory)
MERGE_MIN_TILES = 8       # merge_plan: fewer tiles a query leave SMs idle
MERGE_ROW_COST = 3        # merge_plan: a row's cost in the doc tiles, and
MERGE_TILE_COST = 75000   # a tile's and a (tile, term)'s, in units of the
MERGE_TERM_COST = 100     # probes' cost, one a row's search step
MAX_TOPK = 256            # topk_rows keeps k of its shared buffer's 2048
                          # keys; beyond: wide_topk
TOPK_BLOCKS = 528         # topk_rows: B x tiles at most (4 blocks an SM)
TOPK_TILE_MIN = 16384     # topk_rows: at most ceil(R / this) tiles
DENSE_TILE = 4096         # dense_rows: docs a tile (csrc DR_TILE)
DENSE_BLOCKS = 792        # dense_rows: B x runs at most (6 blocks an SM)
DENSE_SHORT = 1024        # dense_rows: slices this short, one tile a block
MAX_SORT_TOPK = 64        # sort_topk keeps k of its shared buffer's 2048
                          # keys; beyond: wide_topk
MAX_SORT_WORDS = 8        # sort_topk key words (row index included; 64 KB
                          # of shared buffer); beyond: wide_topk
SORT_BLOCKS = 528         # sort_topk: B x tiles at most (4 blocks an SM)
SORT_TILE_MIN = 8192      # sort_topk: at most ceil(C / this) tiles
WIDE_TILE_MIN = 2048      # wide_topk: at most ceil(R / this) tiles a query
WIDE_BLOCKS = 264         # wide_topk: B x tiles at most (2 blocks an SM)
WIDE_MERGE = 2560         # wide_topk: T x k candidates a query at most
WIDE_IN_MAX = 4096        # wide_topk: a tile's in-list in shared memory
WIDE_SMEM = 196 * 1024    # wide_topk: dynamic shared memory a block at most
MAX_TREE_DEPTH = 64       # the tree program's bit stack, one register;
                          # tree_program's order needs log2(leaves) + 1 at
                          # most, and it checks the need against this
FULLWIDTH_WINDOW = 64     # K9's tie window (executor.py:428)
MAX_FULLWIDTH_KK = 128    # fullwidth_topk's warp lists (k + window) at most
FULLWIDTH_WARPS = 8       # fullwidth_topk: warps a block (csrc FW_WARPS)
FULLWIDTH_ROWS = 16384    # fullwidth_plan: rows a block at least
FULLWIDTH_BLOCKS = 1056   # fullwidth_plan: B x G at most (8 an SM)
SHARD_MERGE_SMEM = 163840  # shard_merge: its word planes in shared
                          # memory up to these bytes (csrc SM_SMEM_MAX)
MAX_AGG_METRICS = 8       # agg_metrics channels a launch (csrc AM_MAXM)
MAX_AGG_BUCKETS = 4096    # agg_buckets / agg_ranges shared-memory histogram
AGG_WARPS = 8             # agg_buckets, agg_ranges: warps a block (csrc
                          # AB_WARPS, AR_WARPS)
AGG_WP_SMEM = 12 * 1024   # agg_buckets, agg_ranges: the warps' sub partials
                          # in shared memory up to this many floats (csrc
                          # AB_WP_SMEM, AR_WP_SMEM)
AGG_ROWS = 4096           # bucket_plan, row_plan: rows a block at least
                          # (row_plan: at gpw 32)
AGG_FILL = 66             # row_plan: blocks a launch it fills, agg_metrics
                          # (half an SM: more, smaller blocks lost at B 1)
RANGES_FILL = 132         # agg_ranges' (its rows' tests take longer)
AGG_BLOCKS = 4096         # bucket_plan: blocks a launch at most
AGG_FOLD = 65536          # bucket_plan: a query's G x size partials, which
                          # its last block folds, at most
AGG_WIDE = 1 << 22        # bucket_plan: the warps' sub partials in device
                          # memory (past AGG_WP_SMEM), floats at most
MAX_HIST_BINS = 2048      # agg_hist's shared histogram (ORDER_STAT_BINS)
HIST_FILL = 66            # row_plan's fill for agg_hist's top level, and
HIST2_FILL = 132          # for its hist2 (codes, member)
HIST2_FLOAT = True        # hist2 by float atomics into a zeroed output
MAX_PHRASES = 32          # phrase_leaves: the verdicts of a row, one word
MAX_CAND_CAP = 4096       # query/plan.py DEFAULT_CAND_CAP
MAX_PMAX = 128            # query/plan.py DEFAULT_PMAX (the positions guard)
MAX_GEO = 32              # geo_leaves: the verdicts of a row, one word
MAX_GEO_QR = 1024         # query/plan.py QR_BUCKETS: the cover in 8 KB smem
MAX_GEO_RMAX = 256        # query/plan.py's RMAX cap
MAX_COLLAPSE = 8          # _collapse keeps min(collapse_max, 8) rows a key
MAX_COLLAPSE_ROWS = 2**28  # collapse_rows: slots of the key table fit int32
COLLAPSE_CHUNK = 4096     # collapse_rows' tiles: rows a chunk (csrc CT_CHUNK)
COLLAPSE_TABLE = 1024     # collapse_rows' tiles: a shared table's slots at
                          # most, twice the column's distinct keys or more
COLLAPSE_BLOCKS = 132     # collapse_rows' tiles: tile blocks of a call (one
                          # an SM)
MAX_SPECIAL = 32          # merge_special: max specs / branches / synonyms
HLL_REGS = 1024           # ops/aggs.py _HLL_M (p = 10)
DISTINCT_BLOCKS = 2112    # agg_distinct: B x G ~ 16 blocks of 256 an SM
DISTINCT_ROWS = 4096      # agg_distinct: rows a setting block at least
DISTINCT_FOLD = 64        # agg_distinct: folding blocks a query at most
SPECIAL_CHANNELS = 32     # merge_special's doc tiles: channels at most
SPECIAL_MIN_TILE = 1024   # special_plan halves the tile down to this
KMEANS_THREADS = 256      # kmeans: threads a block (csrc KM_THREADS)
KMEANS_CLUSTER = 16       # kmeans: blocks a cluster at most (non-portable)
KMEANS_WORK = 1 << 18     # kmeans: products a block a step, the cluster size
KMEANS_SMEM = 232448      # kmeans: shared memory a block (csrc KM_SMEM)
KMEANS_GRID = 16          # kmeans: clusters a launch at most (KM_MAX_GRID)
KMEANS_SMS = 132          # kmeans: the H100's SMs, the clusters' blocks

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("common.cuh", "score_slices.cu", "merge_docs.cu", "topk_rows.cu",
           "prefix_certify.cu", "compact_rows.cu", "filter_leaves.cu",
           "sort_topk.cu", "fullwidth_topk.cu", "agg_metrics.cu",
           "agg_buckets.cu", "phrase_leaves.cu", "geo_leaves.cu",
           "collapse_rows.cu", "dense_rows.cu", "merge_special.cu",
           "agg_distinct.cu", "agg_ranges.cu", "agg_hist.cu",
           "agg_filter.cu", "kmeans.cu", "wide_topk.cu", "shard_merge.cu",
           "semijoin_rows.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

launches = {"score_slices": 0, "merge_docs": 0, "topk_rows": 0,
            "prefix_certify": 0, "compact_rows": 0, "filter_leaves": 0,
            "sort_topk": 0, "fullwidth_topk": 0, "agg_metrics": 0,
            "agg_buckets": 0, "phrase_leaves": 0, "geo_leaves": 0,
            "collapse_rows": 0, "dense_rows": 0, "merge_special": 0,
            "agg_distinct": 0, "agg_ranges": 0, "agg_hist": 0,
            "agg_filter": 0, "kmeans": 0, "wide_topk": 0, "shard_merge": 0,
            "shard_reduce": 0, "semijoin_rows": 0, "chunk_merge": 0}
build_info: dict = {}

_lib = None
_lib_lock = threading.Lock()
_small_cache: dict = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


# --------------------------------------------------------------------------
# build + bind
# --------------------------------------------------------------------------

def find_nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of xapiand_tpu_torch are built from csrc/ at first use")


def build() -> Path:
    """Compile csrc/*.cu into _build/<hash>/libxt_kernels.so (once per
    source hash) and return its path: one nvcc process per source, all
    running at once, then one link. nvcc's output, including the
    -Xptxas -v register/shared-memory report, lands in build.log beside
    it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    so = out_dir / "libxt_kernels.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    t0 = time.time()
    cmds, procs = [], []
    for n in SOURCES:
        if n.endswith(".cu"):
            obj = out_dir / f"{n[:-3]}.{tag}.o"
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                         str(CSRC / n)])
            procs.append(subprocess.Popen(
                cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs = [p.communicate()[0] for p in procs]
    tmp = out_dir / f"libxt_kernels.{tag}.tmp.so"
    link = [nvcc, "-shared", "-o", str(tmp)] + [c[-2] for c in cmds]
    failed = [(c, lg) for c, lg, p in zip(cmds, logs, procs) if p.returncode]
    lr = None
    if not failed:
        lr = subprocess.run(link, capture_output=True, text=True,
                            check=False)
    secs = time.time() - t0
    text = "".join(" ".join(c) + "\n" + lg for c, lg in zip(cmds, logs))
    if lr is not None:
        text += " ".join(link) + "\n" + lr.stdout + lr.stderr
    (out_dir / "build.log").write_text(text)
    for c in cmds:
        Path(c[-2]).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{c[-1]}:\n{lg}" for c, lg in failed))
    if lr.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({lr.returncode}):\n"
                           f"{lr.stderr}")
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=secs, cached=False,
                      log=str(out_dir / "build.log"))
    return so


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# a scheme: its id, its SCHEME_PARAMS floats (host memory), its C constants
# a term, the uniqterms column (0: none) and its rows
_SPEC = [_I, ctypes.POINTER(ctypes.c_float), _I, _P]
_SIGNATURES = {
    "xt_score_slices": [_P, _P, _P, _LL, _P, _P, _P, _LL, _P, _P, _P, _P,
                        _P, _P, _P, _I, _I, _I, _I, _I, *_SPEC, _I, _P, _P,
                        _P, _P, _I, _P],
    "xt_merge_docs": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _LL, _P, _I, _P,
                      _P, _P, _P, _I, _I, _P],
    "xt_topk_rows": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "xt_prefix_certify": [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I,
                          _P, _P, _I, _I, *_SPEC, _I, _P, _P, _P, _P],
    "xt_compact_rows": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "xt_filter_leaves": [_P, _P, _P, _P, _P, _I, _I, _LL, _P, _I, _I, _P,
                         _P, _P, _P, _I, _P],
    "xt_sort_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P, _P],
    "xt_fullwidth_topk": [_P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P],
    "xt_agg_metrics": [_P, _P, _I, _LL, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P],
    "xt_agg_buckets": [_P, _P, _I, _LL, _I, _I, _P, _P, _P, _LL, _LL, _P,
                       _P, _I, _I, _I, _P, _LL, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P],
    "xt_agg_ranges": [_P, _P, _I, _LL, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                      _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "xt_agg_hist": [_P, _P, _I, _LL, _I, _I, _P, _P, _LL, _P, _I, _P, _P,
                    _I, _I, _P, _P, _P, _I, _P],
    "xt_agg_filter": [_P, _P, _I, _LL, _P, _LL, _P, _I, _I, _P, _P],
    "xt_phrase_leaves": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _LL, _P,
                         _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P],
    "xt_geo_leaves": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "xt_topk_rows_tie": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "xt_collapse_rows": [_P, _P, _P, _I, _I, _P, _P, _P, _LL, _I, _I, _P,
                         _LL, _P, _P, _P, _P, _LL, _P, _P, _P, _P],
    "xt_collapse_tiles": [_P, _P, _P, _I, _I, _P, _P, _P, _LL, _I, _I, _I,
                          _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "xt_dense_rows": [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                      _I, *_SPEC, _I, _P, _P, _P, _P, _P],
    "xt_merge_special": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _LL,
                         _P, _P, _I, *_SPEC, _I, _I, _I, _I, _P, _P],
    "xt_agg_distinct": [_P, _P, _I, _LL, _I, _P, _LL, _P, _I, _I, _P, _P,
                        _P, _I, _P],
    "xt_kmeans_loop": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                       _P, _P, _P, _P, _P],
    "xt_wide_topk_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                          _P, _P, _P, _P, _P],
    "xt_wide_sort_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                          _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "xt_shard_merge": [_P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                       _P],
    "xt_semijoin_rows": [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, *_SPEC, _I, _P, _LL, _P, _P, _P, _P, _P, _P],
    "xt_shard_reduce": [_P, _I, _LL, _I, _P, _P],
}


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so = build()
            handle = ctypes.CDLL(str(so))
            for fn, argtypes in _SIGNATURES.items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _lib = handle
        return _lib


def _launch(name: str, fn: str, *args):
    rc = getattr(_lib or lib(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError {rc}")
    launches[name] += 1


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _on_cuda(name: str, *tensors) -> bool:
    """True for all-CUDA inputs (launch), False for all-CPU (plain version);
    raises on mixed or other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on several devices "
                             f"{ {t.device for t in tensors} }")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {dev}")


def _check(name: str, t: torch.Tensor, dtype, shape=None):
    if t.dtype != dtype or not t.is_contiguous() or \
            (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _ints(vals: tuple, device, dtype=torch.int32) -> torch.Tensor:
    """Small per-config int table on ``device`` (cached by its values)."""
    key = (vals, str(device), dtype)
    t = _small_cache.get(key)
    if t is None:
        t = _small_cache[key] = torch.tensor(vals, dtype=dtype,
                                             device=device)
    return t


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _spec_args(spec: SchemeSpec, C: int, uniq) -> tuple:
    """A scheme's arguments of a C entry point (``_SPEC``)."""
    if len(spec.params) > SCHEME_PARAMS:
        raise ValueError(f"scheme {spec.sid}: more than {SCHEME_PARAMS} "
                         "parameters")
    params = (ctypes.c_float * SCHEME_PARAMS)(*spec.params)
    return spec.sid, params, C, _ptr(uniq)


def _constants(name: str, tconst, lead: tuple) -> int:
    """Check a term-constant array: f32[*lead] (one constant a term) or
    f32[*lead, C] with C in (1, 2). -> C."""
    C = tconst.shape[-1] if tconst.dim() == len(lead) + 1 else 1
    _check(name, tconst, torch.float32, lead + ((C,) if tconst.dim() ==
                                                len(lead) + 1 else ()))
    if C not in (1, 2):
        raise ValueError(f"{name}: {C} constants a term (at most 2)")
    return C


def _check_uniq(name: str, spec: SchemeSpec, uniq):
    """uniqterms f32[ND+1] where the scheme reads it, else None."""
    if not spec.needs_uniq:
        return None
    if uniq is None:
        raise ValueError(f"{name}: scheme {spec.sid} reads uniqterms")
    _check(f"{name}.uniq", uniq, torch.float32)
    return uniq


def _scored(w, scoring):
    """w * scoring (csrc/common.cuh scored): NaN where a non-scoring term's
    weight is NaN at constants of 0, as JAX keeps it (executor.py:722)."""
    return w * scoring


def _tc(tconst, t):
    """Term t's constants, each [B, 1] (tconst [B, T] or [B, T, C]): the
    tc tuple of scheme_sumpart."""
    if tconst.dim() == 2:
        return (tconst[:, t:t + 1],)
    return tuple(tconst[:, t:t + 1, c] for c in range(tconst.shape[2]))


def absent_column(device) -> dict:
    """The 1-row column of a slot the segment lacks (executor.py
    _get_value_col 313-325): every read clamps to row 0, where no value is
    present. Cached per device."""
    return {"fval": _ints((0.0,), device, torch.float32),
            "hi": _ints((0,), device), "lo": _ints((0,), device),
            "max_hi": _ints((I32MAX,), device),
            "max_lo": _ints((I32MAX,), device),
            "present": _ints((False,), device, torch.bool),
            # models/segment.py value_arrays of that row: no code
            "keys": _ints(((I32MAX, I32MAX, -2**31, -2**31),), device),
            "codes": _ints((-1,), device), "code_hll": _ints((), device)}


# --------------------------------------------------------------------------
# K6: the boolean tree as a postfix program
# --------------------------------------------------------------------------

OP_G, OP_F, OP_ALL, OP_NONE, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_PH, \
    OP_GEO, OP_NOTAND = range(11)
_LEAF_OPS = {"G": OP_G, "F": OP_F, "PH": OP_PH, "GEO": OP_GEO}


def tree_program(tree: tuple) -> tuple:
    """The static boolean tree (xapiand_tpu/ops/executor.py _eval_tree
    249-282) as postfix int32 instructions ``op | arg << 8`` for the
    kernels' bit-stack evaluator (csrc/common.cuh eval_tree). n-ary
    AND/FILTER/OR fold left; AND_MAYBE is its first child alone.

    Each node emits the child that needs the deepest stack first
    (Sethi-Ullman order): AND, FILTER, OR and XOR commute on bools, and an
    AND_NOT whose right operand is the deeper one emits it first under
    OP_NOTAND (``~below & top``). A tree of L leaves then needs at most
    floor(log2 L) + 1 stack bits, so the 64-bit stack (MAX_TREE_DEPTH)
    holds any tree of fewer than 2**63 leaves, at any depth; the need is
    checked against it all the same, as the kernels do not."""

    def gen(node):   # -> (stack need, instructions)
        op = node[0]
        if op in _LEAF_OPS:
            return 1, [_LEAF_OPS[op] | int(node[1]) << 8]
        if op in ("ALL", "NONE"):
            return 1, [OP_ALL if op == "ALL" else OP_NONE]
        if op == "AND_MAYBE":
            return gen(node[1])
        if op == "AND_NOT":
            (na, ca), (nb, cb) = gen(node[1]), gen(node[2])
            if nb > na:
                return nb, cb + ca + [OP_NOTAND]
            return max(na, nb + 1), ca + cb + [OP_ANDNOT]
        if op in ("AND", "FILTER", "OR", "XOR"):
            kids = node[1:3] if op == "XOR" else node[1:]
            subs = sorted((gen(c) for c in kids), key=lambda x: -x[0])
            code = OP_XOR if op == "XOR" else OP_OR if op == "OR" else OP_AND
            need, out = subs[0][0], list(subs[0][1])
            for n, c in subs[1:]:
                need = max(need, n + 1)
                out += c + [code]
            return need, out
        raise ValueError(f"tree op {op!r} has no kernel leaf")

    need, code = gen(tree)
    if need > MAX_TREE_DEPTH:
        raise ValueError(f"tree_program: a stack of {need} bits, past the "
                         f"kernels' {MAX_TREE_DEPTH}")
    return tuple(code)


def tree_need(prog) -> int:
    """The most entries a tree program's stack holds (filter_leaves.cu runs
    a program of at most FL_STACK = 8 as 16-row masks, a deeper one row by
    row)."""
    depth = need = 0
    for ins in prog:
        depth += 1 if ins & 0xff in (OP_G, OP_F, OP_PH, OP_GEO, OP_ALL,
                                     OP_NONE) else -1
        need = max(need, depth)
    return need


def _eval_program_plain(prog, orbits, fres, shape, device, phbits=None,
                        geobits=None):
    """The program on bool tensors: orbits i32 (None when the program has
    no G leaf), fres a list of bool tensors, one per F leaf, phbits i32
    (None when the program has no PH leaf): bit i is phrase leaf i;
    geobits i32 likewise for GEO leaves."""
    st: list = []
    for ins in prog:
        op, arg = ins & 0xff, ins >> 8
        if op == OP_G:
            st.append((orbits & (1 << arg)) != 0)
        elif op == OP_F:
            st.append(fres[arg])
        elif op == OP_PH:
            st.append((phbits & (1 << arg)) != 0)
        elif op == OP_GEO:
            st.append((geobits & (1 << arg)) != 0)
        elif op in (OP_ALL, OP_NONE):
            st.append(torch.full(shape, op == OP_ALL, dtype=torch.bool,
                                 device=device))
        else:
            b = st.pop()
            a = st.pop()
            st.append(a & b if op == OP_AND else a | b if op == OP_OR
                      else a ^ b if op == OP_XOR else a & ~b
                      if op == OP_ANDNOT else b & ~a)
    return st.pop()


def row_offsets(widths) -> tuple:
    ro = [0]
    for w in widths:
        ro.append(ro[-1] + int(w))
    return tuple(ro)


# --------------------------------------------------------------------------
# K1: score_slices
# --------------------------------------------------------------------------

def score_slices(post, imp, offsets, lens, tconst, scoring, widths,
                 is_prefix, spec, uniq=None):
    """Slice + weigh every (query, term) posting span.

    post / imp: (docids i32[P], wdf f32[P], doclen f32[P]); imp may be None
    when no term is in prefix mode. offsets/lens i32[B,T], scoring f32[B,T],
    tconst f32[B,T] or f32[B,T,C]. widths[t] rows are read for term t - the
    first widths[t] impact-ordered rows when is_prefix[t]. spec: the
    scheme's SchemeSpec (models/weights.py kernel_spec); uniq: uniqterms
    f32[ND+1], read where the scheme needs it.
    -> ids i32[B,R] (each term block docid-ascending, SENTINEL-padded),
       w f32[B,R], tail f32[B,T] (unread-tail bound, 0 off prefix)."""
    B, T = offsets.shape
    widths = tuple(int(w) for w in widths)
    is_prefix = tuple(bool(p) for p in is_prefix)
    if len(widths) != T or len(is_prefix) != T:
        raise ValueError(f"score_slices: {T} terms, widths {widths}, "
                         f"is_prefix {is_prefix}")
    if any(is_prefix) and imp is None:
        raise ValueError("score_slices: prefix terms need the imp.* arrays")
    pw = max((w for w, p in zip(widths, is_prefix) if p), default=0)
    for name, t, dt in (("offsets", offsets, torch.int32),
                        ("lens", lens, torch.int32),
                        ("scoring", scoring, torch.float32)):
        _check(f"score_slices.{name}", t, dt, (B, T))
    C = _constants("score_slices.tconst", tconst, (B, T))
    uniq = _check_uniq("score_slices", spec, uniq)
    src = list(post) + (list(imp) if imp is not None else [])
    for t, dt in zip(src, (torch.int32, torch.float32, torch.float32) * 2):
        _check("score_slices.postings", t, dt)
    opt = [uniq] if uniq is not None else []
    if not _on_cuda("score_slices", offsets, lens, tconst, scoring, *src,
                    *opt):
        return _score_slices_plain(post, imp, offsets, lens, tconst, scoring,
                                   widths, is_prefix, spec, uniq)
    dev = offsets.device
    ro = row_offsets(widths)
    R = ro[-1]
    ids = torch.empty((B, R), dtype=torch.int32, device=dev)
    w = torch.empty((B, R), dtype=torch.float32, device=dev)
    tail = torch.empty((B, T), dtype=torch.float32, device=dev)
    n2 = 1
    while n2 < pw:
        n2 *= 2
    smem = 8 * n2 if pw else 0
    scratch = None
    if pw > MAX_PREFIX_ROWS:   # the prefix sort in device memory
        smem = 0
        scratch = torch.empty(B * T * 2 * n2, dtype=torch.int32, device=dev)
    ib = imp if imp is not None else post
    _launch("score_slices", "xt_score_slices",
            post[0].data_ptr(), post[1].data_ptr(), post[2].data_ptr(),
            post[0].shape[0], ib[0].data_ptr(), ib[1].data_ptr(),
            ib[2].data_ptr(), ib[0].shape[0] if imp is not None else 0,
            offsets.data_ptr(), lens.data_ptr(), tconst.data_ptr(),
            scoring.data_ptr(), _ints(widths, dev).data_ptr(),
            _ints(tuple(int(p) for p in is_prefix), dev).data_ptr(),
            _ints(ro, dev).data_ptr(), B, T, R, sum(is_prefix), smem,
            *_spec_args(spec, C, uniq), _nd1(uniq), ids.data_ptr(),
            w.data_ptr(), tail.data_ptr(), _ptr(scratch), n2, _stream())
    return ids, w, tail


def _nd1(uniq) -> int:
    return 0 if uniq is None else uniq.shape[0]


def _score_slices_plain(post, imp, offsets, lens, tconst, scoring, widths,
                        is_prefix, spec, uniq=None):
    B, T = offsets.shape
    dev = offsets.device
    ids_parts, w_parts, tails = [], [], []
    for t in range(T):
        W, pref = widths[t], is_prefix[t]
        src = imp if pref else post
        n = src[0].shape[0]
        off = offsets[:, t].long()
        # lax.dynamic_slice clamps the start so the slice stays in bounds
        start = off.clamp(max=n - W).clamp(min=0)
        # rows past lens are masked out, so a pool shorter than W (no
        # guard rows) gathers them from its last row, as the kernel reads
        # nothing past lens
        idx = (start[:, None] + torch.arange(W, device=dev)).clamp(
            max=max(n - 1, 0))
        inl = torch.arange(W, device=dev)[None, :] < lens[:, t:t + 1]
        d = torch.where(inl, src[0][idx], SENTINEL)
        # the doc's uniqterms at min(docid, ND) (executor.py:716-721)
        u = uniq[d.clamp(max=uniq.shape[0] - 1)] if uniq is not None \
            else None
        w = _scored(scheme_sumpart(spec, src[1][idx], src[2][idx],
                                   _tc(tconst, t), u), scoring[:, t:t + 1])
        w = torch.where(inl, w, 0.0)
        tail = torch.zeros(B, dtype=torch.float32, device=dev)
        if pref:
            d, order = torch.sort(d, dim=1, stable=True)
            w = torch.gather(w, 1, order)
            bpos = (off + W).clamp(max=n - 1)
            gb = scheme_sumpart(spec, imp[1][bpos][:, None],
                                imp[2][bpos][:, None], _tc(tconst, t))[:, 0]
            tail = torch.where(lens[:, t] > W, torch.clamp_min(
                _scored(gb, scoring[:, t]), 0.0), 0.0)
        ids_parts.append(d)
        w_parts.append(w)
        tails.append(tail)
    return (torch.cat(ids_parts, 1), torch.cat(w_parts, 1),
            torch.stack(tails, 1))


# --------------------------------------------------------------------------
# K2+K3: merge_docs
# --------------------------------------------------------------------------

def merge_docs(ids, w, widths, bits=None, deleted=None, prog=None,
               want_orbits=False, *, n_docs):
    """Per-doc score sums and OR of group bits without a sort (doc tiles
    summed in term order, or a binary-search join, over the docid-ascending
    term blocks of score_slices: merge_plan), and the K6 epilogue.

    bits i32[B,T] (the plan's group_bits; None: no bits), deleted bool[ND+1]
    (None: no deletes), prog a tree_program (None: no tree), n_docs the
    segment's docid bound (its deleted flags' rows).
    -> sums f32[B,R] (the doc's total, summed in term order, on every row
       of the doc; 0 on SENTINEL rows), mask bool[B,R] (one row per real
       doc, its lowest-numbered term's, & not deleted & tree(bits)),
       count i32[B] (mask rows per query), orbits i32[B,R] (the doc's OR
       of group bits on every row of the doc) or None unless want_orbits."""
    widths = tuple(int(x) for x in widths)
    B, R = ids.shape
    T = len(widths)
    _check("merge_docs.ids", ids, torch.int32, (B, sum(widths)))
    _check("merge_docs.w", w, torch.float32, (B, R))
    opt = [t for t in (bits, deleted) if t is not None]
    if bits is not None:
        _check("merge_docs.bits", bits, torch.int32, (B, T))
    elif prog is not None and any(i & 0xff == OP_G for i in prog):
        raise ValueError("merge_docs: a tree with G leaves needs bits")
    if prog is not None and any(i & 0xff in (OP_F, OP_PH, OP_GEO)
                                for i in prog):
        raise ValueError("merge_docs: F, PH and GEO leaves are "
                         "filter_leaves' (merge_docs runs the upper tree or "
                         "none)")
    if want_orbits and bits is None:
        raise ValueError("merge_docs: orbits need bits")
    if deleted is not None:
        _check("merge_docs.deleted", deleted, torch.bool)
    if not _on_cuda("merge_docs", ids, w, *opt):
        return _merge_docs_plain(ids, w, widths, bits, deleted, prog,
                                 want_orbits)
    dev = ids.device
    sums = torch.empty((B, R), dtype=torch.float32, device=dev)
    mask = torch.empty((B, R), dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    orbits = torch.empty((B, R), dtype=torch.int32, device=dev) \
        if want_orbits else None
    _launch("merge_docs", "xt_merge_docs", ids.data_ptr(), w.data_ptr(),
            _ints(widths, dev).data_ptr(),
            _ints(row_offsets(widths), dev).data_ptr(), B, T, R,
            _ptr(bits), _ptr(deleted),
            deleted.shape[0] if deleted is not None else 0,
            _ptr(_ints(prog, dev) if prog else None),
            len(prog) if prog else 0, sums.data_ptr(), mask.data_ptr(),
            count.data_ptr(), _ptr(orbits),
            merge_plan(widths, n_docs), MERGE_TILE, _stream())
    return sums, mask, count, orbits


def merge_plan(widths, n_docs) -> int:
    """merge_docs' design for one query's term blocks: the number of doc
    tiles of MERGE_TILE docids over [0, n_docs), or 0 for the probes. The
    probes cost each row (T - 1) binary searches of log2 W dependent loads;
    the tiles cost each row a little, each term of each tile its bracket
    and a barrier, and each tile its accumulator, whether or not it holds
    a row. So the tiles take the dense queries and the many-term ones
    (geo's T = 128), the probes the sparse ones (a relevance OR's few
    hundred rows over a million docs) and the small segments (a few tiles
    a query leave the card idle). The costs are fitted to the paths' own
    launches (chip_smoke.py --capture, tools/sort_pairs.py's md_probes
    and md_tiles), where the rule takes the faster design at each."""
    T, R = len(widths), sum(widths)
    if T < 1 or 16 * T + 10 * MERGE_TILE > 200 * 1024:
        return 0   # (the kernel's shared memory: 16 B a term, 10 a docid)
    tiles = -(-int(n_docs) // MERGE_TILE)
    if tiles < MERGE_MIN_TILES:
        return 0
    probe = R * (T - 1) * sum(log2c(x) for x in widths) / T
    tile = MERGE_ROW_COST * R + tiles * (MERGE_TILE_COST +
                                         MERGE_TERM_COST * T)
    return tiles if tile < probe else 0


def log2c(n: int) -> int:
    """ceil(log2(n)), at least 1: a binary search's loads over n rows."""
    return max(int(n) - 1, 1).bit_length()


def _merge_docs_plain(ids, w, widths, bits=None, deleted=None, prog=None,
                      want_orbits=False):
    ro = row_offsets(widths)
    real = ids != SENTINEL
    owner = real.clone()
    term_of_row = torch.repeat_interleave(
        torch.arange(len(widths), device=ids.device),
        torch.tensor(widths, device=ids.device))
    sums = torch.zeros_like(w)
    orbits = torch.zeros_like(ids) if bits is not None else None
    for u, W in enumerate(widths):
        blk = ids[:, ro[u]:ro[u + 1]].contiguous()
        pos = torch.searchsorted(blk, ids).clamp(max=W - 1)
        hit = real & (torch.gather(blk, 1, pos) == ids)
        sums = sums + torch.where(
            hit, torch.gather(w[:, ro[u]:ro[u + 1]], 1, pos), 0.0)
        if bits is not None:
            orbits = orbits | torch.where(hit, bits[:, u:u + 1], 0)
        owner &= ~(hit & (term_of_row > u)[None, :])
    mask = owner
    if deleted is not None:
        mask = mask & ~deleted[ids.clamp(max=deleted.shape[0] - 1).long()]
    if prog:
        mask = mask & _eval_program_plain(prog, orbits, [], ids.shape,
                                          ids.device)
    return (sums, mask, mask.sum(1, dtype=torch.int32),
            orbits if want_orbits else None)


# --------------------------------------------------------------------------
# K4: topk_rows
# --------------------------------------------------------------------------

def topk_rows(scores, ids, owner, k: int, tie=None):
    """Top-k owner rows per query by (score desc, docid asc); with tie
    i32[B,R] (collapse_rows' tie ranks, >= 0) by (score desc, tie asc,
    docid asc). A row whose score is NaN is left out, as the JAX package's
    compiled execute ranks it below every other row. A k beyond MAX_TOPK
    goes to the wide mode (wide_topk.cu), as lax.top_k takes any k.
    -> docids i32[B,k] (SENTINEL past the owner count), scores f32[B,k]
    (-inf there)."""
    B, R = scores.shape
    _check("topk_rows.scores", scores, torch.float32, (B, R))
    _check("topk_rows.ids", ids, torch.int32, (B, R))
    _check("topk_rows.owner", owner, torch.bool, (B, R))
    opt = []
    if tie is not None:
        _check("topk_rows.tie", tie, torch.int32, (B, R))
        opt.append(tie)
    if k < 1:
        raise ValueError(f"topk_rows: k={k} below 1")
    if not _on_cuda("topk_rows", scores, ids, owner, *opt):
        return _topk_rows_plain(scores, ids, owner, k, tie)
    dev = scores.device
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    if k > MAX_TOPK:
        plan, bufs = _wide_buffers(B, R, k, 3 if tie is not None else 2,
                                   dev)
        _launch("wide_topk", "xt_wide_topk_rows", scores.data_ptr(),
                ids.data_ptr(), owner.data_ptr(), _ptr(tie), B, R, k,
                *plan[:4], *(_ptr(x) for x in bufs), out_d.data_ptr(),
                out_s.data_ptr(), _stream())
        return out_d, out_s
    if tie is not None:
        _launch("topk_rows", "xt_topk_rows_tie", scores.data_ptr(),
                ids.data_ptr(), owner.data_ptr(), tie.data_ptr(), B, R, k,
                out_d.data_ptr(), out_s.data_ptr(), _stream())
        return out_d, out_s
    _launch("topk_rows", "xt_topk_rows", scores.data_ptr(), ids.data_ptr(),
            owner.data_ptr(), B, R, k, out_d.data_ptr(), out_s.data_ptr(),
            _stream())
    return out_d, out_s


def topk_plan(B: int, R: int) -> tuple:
    """topk_rows' tiling of a launch (csrc/topk_rows.cu tk_plan, the same
    arithmetic): each query's rows in tiles of gper groups of 4 rows,
    counted from the query's first 16-byte-aligned row, as many tiles as
    B x tiles <= TOPK_BLOCKS allows (a last partial wave of blocks costs a
    whole one), but at most ceil(R / TOPK_TILE_MIN). ->
    (tiles, gper); one tile is one launch, more add the merge of the
    tiles' k best and a scratch of B x tiles x k keys."""
    return _tile_plan(B, R, TOPK_BLOCKS, TOPK_TILE_MIN)


def _tile_plan(B: int, R: int, blocks: int, tile_min: int) -> tuple:
    ng = R // 4 + 1
    t = max(1, min(blocks // B, -(-R // tile_min)))
    gper = -(-ng // t)
    return -(-ng // gper), gper


def wide_plan(B: int, R: int, k: int, nw: int) -> tuple:
    """wide_topk's tiling of a launch (csrc/wide_topk.cu): T tiles of TR
    rows a query, as many as B x T <= WIDE_BLOCKS allows, but at most
    ceil(R / WIDE_TILE_MIN), at most WIDE_MERGE // k (the merge ranks T x
    k candidates a query) and no more than the merge's shared memory holds
    of the tiles' sorted lists (T x kk x nw words); kk = min(k, TR) rows a
    tile's in-list at most. flags: the tied lists (16 TR bytes), the
    in-list (4 kk) and the sort buffer (P x nw words, P the power of two
    >= kk, in the lists' room) in device memory where shared memory lacks
    the room. -> (T, TR, kk, flags, per_block): per_block the device
    scratch a block, in 4-byte words."""
    B = max(B, 1)
    T = max(1, min(-(-R // WIDE_TILE_MIN), WIDE_BLOCKS // B,
                   WIDE_MERGE // max(1, min(k, R))))
    while T > 1 and T * min(k, -(-R // T)) * nw * 4 > WIDE_SMEM:
        T -= 1
    TR = max(1, -(-R // T))
    kk = min(k, TR)
    gin = kk > WIDE_IN_MAX
    glists = 16 * TR + (0 if gin else 4 * kk) > WIDE_SMEM
    P = 1 << (kk - 1).bit_length()
    gsort = glists or P * nw * 4 > 16 * TR
    per_block = (4 * TR if glists else 0) + (kk if gin else 0) + \
        (P * nw if gsort else 0)
    per_block += per_block & 1
    return T, TR, kk, glists | gin << 1 | gsort << 2, per_block


def _wide_buffers(B: int, R: int, k: int, nw: int, dev):
    """wide_plan's (T, TR, kk, flags) and the device buffers of a launch:
    the scratch, the tiles' sorted lists and their counts (None where the
    plan needs none)."""
    T, TR, kk, flags, per_block = wide_plan(B, R, k, nw)
    scratch = torch.empty(B * T * per_block, dtype=torch.int32,
                          device=dev) if per_block else None
    tkeys = torch.empty(B * T * kk * nw, dtype=torch.int32, device=dev) \
        if T > 1 else None
    tn = torch.empty(B * T, dtype=torch.int32, device=dev) if T > 1 \
        else None
    return (T, TR, kk, flags), (scratch, tkeys, tn)


def _topk_rows_plain(scores, ids, owner, k, tie=None):
    owner = owner & ~scores.isnan()   # a NaN score ranks below every row
    masked = torch.where(owner, scores, float("-inf"))
    d = torch.where(owner, ids, SENTINEL)
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    m_sorted = torch.gather(masked, 1, order)
    if tie is not None:
        # stable sorts, least significant key first: docid, tie, score
        o1 = torch.sort(torch.gather(torch.where(owner, tie, I32MAX), 1,
                                     order), dim=1, stable=True)[1]
        d_sorted = torch.gather(d_sorted, 1, o1)
        m_sorted = torch.gather(m_sorted, 1, o1)
    vals, o2 = torch.sort(m_sorted, dim=1, descending=True, stable=True)
    vals = vals[:, :k].contiguous()
    dd = torch.gather(d_sorted, 1, o2[:, :k])
    if vals.shape[1] < k:   # fewer rows than k: pad as the kernel does
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        dd = torch.nn.functional.pad(dd, (0, pad), value=SENTINEL)
    return torch.where(torch.isfinite(vals), dd, SENTINEL), vals


# --------------------------------------------------------------------------
# K5: prefix_certify
# --------------------------------------------------------------------------

def prefix_certify(post, offsets, lens, tconst, scoring, classes, tail,
                   cand_d, cand_v, k: int, spec, uniq=None):
    """Exact rescore of the top K of K+1 prefix candidates (cand_d/cand_v
    i32/f32[B,K+1] from topk_rows) by binary search in every term's full
    postings (ln = min(lens, classes[t])), re-sort, certificate.
    tconst f32[B,T] or f32[B,T,C]; spec and uniq as score_slices takes
    them.
    -> docids i32[B,kk], scores f32[B,kk], certified bool[B]; kk =
    min(k, K)."""
    B, T = offsets.shape
    K = cand_d.shape[1] - 1
    kk = min(k, K)
    classes = tuple(int(c) for c in classes)
    for name, t, dt, shp in (("offsets", offsets, torch.int32, (B, T)),
                             ("lens", lens, torch.int32, (B, T)),
                             ("scoring", scoring, torch.float32, (B, T)),
                             ("tail", tail, torch.float32, (B, T)),
                             ("cand_d", cand_d, torch.int32, (B, K + 1)),
                             ("cand_v", cand_v, torch.float32, (B, K + 1))):
        _check(f"prefix_certify.{name}", t, dt, shp)
    C = _constants("prefix_certify.tconst", tconst, (B, T))
    uniq = _check_uniq("prefix_certify", spec, uniq)
    for t, dt in zip(post, (torch.int32, torch.float32, torch.float32)):
        _check("prefix_certify.postings", t, dt)
    if len(classes) != T:
        raise ValueError(f"prefix_certify: {T} terms, classes {classes}")
    if not (0 < kk and K <= MAX_TOPK):
        raise ValueError(f"prefix_certify: K={K}, k={k} unsupported")
    opt = [uniq] if uniq is not None else []
    if not _on_cuda("prefix_certify", offsets, lens, tconst, scoring, tail,
                    cand_d, cand_v, *post, *opt):
        return _prefix_certify_plain(post, offsets, lens, tconst, scoring,
                                     classes, tail, cand_d, cand_v, kk,
                                     spec, uniq)
    dev = offsets.device
    out_d = torch.empty((B, kk), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, kk), dtype=torch.float32, device=dev)
    cert = torch.empty(B, dtype=torch.bool, device=dev)
    _launch("prefix_certify", "xt_prefix_certify",
            post[0].data_ptr(), post[1].data_ptr(), post[2].data_ptr(),
            post[0].shape[0], offsets.data_ptr(), lens.data_ptr(),
            tconst.data_ptr(), scoring.data_ptr(),
            _ints(classes, dev).data_ptr(), tail.data_ptr(), B, T,
            cand_d.data_ptr(), cand_v.data_ptr(), K, kk,
            *_spec_args(spec, C, uniq), _nd1(uniq), out_d.data_ptr(),
            out_s.data_ptr(), cert.data_ptr(), _stream())
    return out_d, out_s, cert


def _prefix_certify_plain(post, offsets, lens, tconst, scoring, classes,
                          tail, cand_d, cand_v, kk, spec, uniq=None):
    B, T = offsets.shape
    K = cand_d.shape[1] - 1
    cd = cand_d[:, :K]
    n = post[0].shape[0]
    exact = torch.zeros(cd.shape, dtype=torch.float32, device=cd.device)
    u = uniq[cd.clamp(max=uniq.shape[0] - 1)] if uniq is not None else None
    for t in range(T):
        Lc = classes[t]
        ln = torch.clamp_max(lens[:, t:t + 1], Lc)
        off = offsets[:, t:t + 1].long()
        pos = torch.zeros(cd.shape, dtype=torch.long, device=cd.device)
        for sbit in reversed(range(max((Lc - 1).bit_length(), 1))):
            c2 = pos + (1 << sbit)
            probe = post[0][(off + c2 - 1).clamp(max=n - 1)]
            pos = torch.where((c2 <= ln) & (probe < cd), c2, pos)
        ppos = (off + pos).clamp(max=n - 1)
        found = (pos < ln) & (post[0][ppos] == cd)
        w = scheme_sumpart(spec, post[1][ppos], post[2][ppos],
                           _tc(tconst, t), u)
        exact = exact + torch.where(found, _scored(w, scoring[:, t:t + 1]),
                                    0.0)
    exact = torch.where(cd != SENTINEL, exact, float("-inf"))
    cd_s, o1 = torch.sort(cd, dim=1, stable=True)
    ex_s = torch.gather(exact, 1, o1)
    _, o2 = torch.sort(-ex_s, dim=1, stable=True)
    dd = torch.gather(cd_s, 1, o2)
    vv = torch.gather(ex_s, 1, o2)
    U = torch.zeros(B, dtype=torch.float32, device=cd.device)
    for t in range(T):
        U = U + tail[:, t]
    sk = vv[:, kk - 1]
    vK = cand_v[:, K]
    # margin: rescored sums and row sums differ at float-reorder scale; a
    # boundary tie must fail closed, never certify on FP noise
    eps = 1e-5 * sk.abs() + 1e-6
    outsider_ok = ~torch.isfinite(vK) | (sk > vK + U + eps)
    cert = (U == 0.0) | (torch.isfinite(sk) & (sk > U + eps) & outsider_ok)
    return dd[:, :kk], vv[:, :kk], cert


# --------------------------------------------------------------------------
# K11: compact_rows
# --------------------------------------------------------------------------

def compact_rows(mask, ids, sums, orbits, cap: int):
    """Pack each query's masked rows, in row order, into [B, cap].

    mask bool[B,R], ids i32[B,R], sums f32[B,R], orbits i32[B,R] or None.
    -> docids i32[B,cap] (SENTINEL past the count), sums f32[B,cap] (0
       there), orbits i32[B,cap] (0 there; None without orbits), n i32[B]
       (the masked count; the plan's cap bounds it: the plain version
       asserts so, the kernel writes the first cap rows only)."""
    B, R = ids.shape
    _check("compact_rows.mask", mask, torch.bool, (B, R))
    _check("compact_rows.ids", ids, torch.int32, (B, R))
    _check("compact_rows.sums", sums, torch.float32, (B, R))
    opt = []
    if orbits is not None:
        _check("compact_rows.orbits", orbits, torch.int32, (B, R))
        opt.append(orbits)
    if cap <= 0:
        raise ValueError(f"compact_rows: cap {cap}")
    if not _on_cuda("compact_rows", mask, ids, sums, *opt):
        return _compact_rows_plain(mask, ids, sums, orbits, cap)
    dev = ids.device
    out_d = torch.empty((B, cap), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, cap), dtype=torch.float32, device=dev)
    out_ob = torch.empty((B, cap), dtype=torch.int32, device=dev) \
        if orbits is not None else None
    n = torch.empty(B, dtype=torch.int32, device=dev)
    _launch("compact_rows", "xt_compact_rows", mask.data_ptr(),
            ids.data_ptr(), sums.data_ptr(), _ptr(orbits), B, R, cap,
            out_d.data_ptr(), out_s.data_ptr(), _ptr(out_ob), n.data_ptr(),
            _stream())
    return out_d, out_s, out_ob, n


def _compact_rows_plain(mask, ids, sums, orbits, cap):
    n = mask.sum(1, dtype=torch.int32)
    if int(n.max()) > cap:
        raise AssertionError(f"compact_rows: {int(n.max())} masked rows "
                             f"exceed the cap {cap}")
    order = torch.sort((~mask).to(torch.int8), dim=1, stable=True)[1]
    order = order[:, :cap]
    keep = torch.arange(order.shape[1], device=ids.device)[None, :] < \
        n[:, None]
    pad = cap - order.shape[1]

    def take(x, fill):
        out = torch.where(keep, torch.gather(x, 1, order), fill)
        return torch.nn.functional.pad(out, (0, pad), value=fill) \
            if pad > 0 else out

    return (take(ids, SENTINEL), take(sums, 0.0),
            take(orbits, 0) if orbits is not None else None, n)


# --------------------------------------------------------------------------
# K7 (+K6): filter_leaves
# --------------------------------------------------------------------------

_FILTER_CH = ("hi", "lo", "max_hi", "max_lo", "present", "mv_hi", "mv_lo",
              "mv_off", "mv_len")


def filter_leaves(values: dict, slots, vmax, fparams, docids, base, orbits,
                  prog, phbits=None, geobits=None):
    """Value-range filter leaves per row, then the boolean tree.

    values: the segment's value columns (arrays_pytree()["values"]; on
    the card each with its packed keys, keys i32[n,4], models/segment.py
    value_arrays: a column without them is refused); slots and vmax: per
    filter leaf (ExecConfig filter_slots / filter_vmax);
    fparams i32[B,F,4] (lo hi, lo lo, hi hi, hi lo per leaf; F may be 0);
    docids i32[B,C]; base bool[B,C] (owner & not deleted) or None (docid
    != SENTINEL: packed rows); orbits i32[B,C]; prog a tree_program;
    phbits i32[B,C] (phrase_leaves' verdict words, None without PH
    leaves); geobits i32[B,C] (geo_leaves' verdict words, None without
    GEO leaves).
    -> eligible bool[B,C], count i32[B]."""
    B, C = docids.shape
    F = len(slots)
    vmax = tuple(int(vmax[i]) if i < len(vmax) else 1 for i in range(F))
    _check("filter_leaves.docids", docids, torch.int32, (B, C))
    _check("filter_leaves.orbits", orbits, torch.int32, (B, C))
    _check("filter_leaves.fparams", fparams, torch.int32, (B, F, 4))
    opt = []
    if base is not None:
        _check("filter_leaves.base", base, torch.bool, (B, C))
        opt.append(base)
    if phbits is not None:
        _check("filter_leaves.phbits", phbits, torch.int32, (B, C))
        opt.append(phbits)
    elif any(i & 0xff == OP_PH for i in prog):
        raise ValueError("filter_leaves: a tree with PH leaves needs phbits")
    if geobits is not None:
        _check("filter_leaves.geobits", geobits, torch.int32, (B, C))
        opt.append(geobits)
    elif any(i & 0xff == OP_GEO for i in prog):
        raise ValueError("filter_leaves: a tree with GEO leaves needs "
                         "geobits")
    cols = [values.get(s) for s in slots]
    for col in cols:
        for ch in _FILTER_CH:
            if col is not None and ch in col:
                _check(f"filter_leaves.{ch}", col[ch],
                       torch.bool if ch == "present" else torch.int32)
                opt.append(col[ch])
    if not _on_cuda("filter_leaves", docids, orbits, fparams, *opt):
        return _filter_leaves_plain(cols, vmax, fparams, docids, base,
                                    orbits, prog, phbits, geobits)
    dev = docids.device
    table = []
    for slot, col, vm in zip(slots, cols, vmax):
        if col is None:
            table += [0] * 8
            continue
        n = col["hi"].shape[0]
        if "keys" not in col:
            raise ValueError(f"filter_leaves: the value column of slot "
                             f"{slot} has no packed keys "
                             "(models/segment.py value_arrays)")
        _check(f"filter_leaves.keys of slot {slot}", col["keys"],
               torch.int32, (n, 4))
        if col["keys"].data_ptr() % 16:
            raise ValueError(f"filter_leaves: the packed keys of slot {slot}"
                             " are not 16-byte aligned")
        table += [col["keys"].data_ptr()]
        table += [_ptr(col.get(ch)) for ch in _FILTER_CH[5:]]
        table += [n, col["mv_hi"].shape[0] if "mv_hi" in col else 0, vm]
    # the group bits are read only where the tree has a G leaf
    ob = orbits if any(i & 0xff == OP_G for i in prog) else None
    eligible = torch.empty((B, C), dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in
                  (docids, base, ob, phbits, geobits, eligible)
                  if t is not None)
    _launch("filter_leaves", "xt_filter_leaves", docids.data_ptr(),
            _ptr(base), _ptr(ob), fparams.data_ptr(),
            _ptr(_ints(tuple(table), dev, torch.int64) if table else None),
            B, F, C, _ints(prog, dev).data_ptr(), len(prog),
            tree_need(prog), _ptr(phbits), _ptr(geobits),
            eligible.data_ptr(), count.data_ptr(), int(aligned), _stream())
    return eligible, count


def _lex_ge(ah, al, bh, bl):
    return (ah > bh) | ((ah == bh) & (al >= bl))


def _lex_le(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al <= bl))


def _filter_leaves_plain(cols, vmax, fparams, docids, base, orbits, prog,
                         phbits=None, geobits=None):
    first = base if base is not None else docids != SENTINEL
    fres = []
    for i, (col, vm) in enumerate(zip(cols, vmax)):
        if col is None:   # a slot the segment lacks: no doc has a value
            fres.append(torch.zeros_like(first))
            continue
        d = docids.clamp(max=col["hi"].shape[0] - 1).long()
        lo_h, lo_l, hi_h, hi_l = (fparams[:, i, j:j + 1] for j in range(4))
        ok = (col["present"][d]
              & _lex_ge(col["max_hi"][d], col["max_lo"][d], lo_h, lo_l)
              & _lex_le(col["hi"][d], col["lo"][d], hi_h, hi_l))
        if vm > 1 and "mv_hi" in col:
            cnt = col["mv_len"][d]
            j = torch.arange(vm, device=docids.device)
            vi = (col["mv_off"][d].long()[..., None] + j).clamp(
                max=col["mv_hi"].shape[0] - 1)
            vh, vl = col["mv_hi"][vi], col["mv_lo"][vi]
            inr = (_lex_ge(vh, vl, lo_h[..., None], lo_l[..., None])
                   & _lex_le(vh, vl, hi_h[..., None], hi_l[..., None])
                   & (j < cnt[..., None]))
            ok = ok & ((cnt == 0) | inr.any(-1))
        fres.append(ok)
    eligible = first & _eval_program_plain(prog, orbits, fres, docids.shape,
                                           docids.device, phbits, geobits)
    return eligible, eligible.sum(1, dtype=torch.int32)


# --------------------------------------------------------------------------
# K15 rank_count + K16: geo_leaves
# --------------------------------------------------------------------------

def rank_count(a, x, count_equal: bool):
    """For every x (any order): the number of elements of the ascending a
    below x (count_equal False) or at most x (True), int32
    (xapiand_tpu/ops/executor.py rank_count 227-246). a [..., L] and x
    [..., C] share their leading dimensions."""
    return torch.searchsorted(a, x, right=bool(count_equal)).to(torch.int32)


_GEO_CH = ("doc_off", "doc_len", "flat_start", "flat_end")


def geo_leaves(cols, specs, queries, docids, base):
    """The exact HTM range test of each geo leaf per row (executor.py
    _gather_geo_leaves 367-399): bit g of a row's word is set iff the row
    is live and one of its doc's first min(doc_len, RMAX) level-13 ranges
    [rs, re] overlaps the query's cover, #(qs <= re) > #(qe < rs).

    cols: per leaf the segment's geo column {doc_off, doc_len i32[ND+1],
    flat_start, flat_end i32[GR], and the kernel's int2 pairs span
    i32[ND+1,2], flat i32[GR,2] (models/segment.py geo_arrays; read on
    the card only)}; specs: ExecConfig.geo_specs (slot, QR,
    RMAX); queries: per leaf the batch's cover i32[B,QR,2], each query's
    ranges sorted, disjoint, padded with INT32_MAX rows; docids i32[B,C]
    (a docid past the pad doc clamps to it, as SENTINEL rows do); base
    bool[B,C] (owner & not deleted) or None (docid != SENTINEL: packed
    rows). Rows that are not live get 0.
    -> geobits i32[B,C]."""
    B, C = docids.shape
    G = len(specs)
    if not 0 < G <= MAX_GEO or len(cols) != G or len(queries) != G:
        raise ValueError(f"geo_leaves: {G} leaves (1..{MAX_GEO}), "
                         f"{len(cols)} columns, {len(queries)} covers")
    _check("geo_leaves.docids", docids, torch.int32, (B, C))
    opt = []
    if base is not None:
        _check("geo_leaves.base", base, torch.bool, (B, C))
        opt.append(base)
    for col, (_slot, QR, RMAX), q in zip(cols, specs, queries):
        if not (0 < QR <= MAX_GEO_QR and 0 < RMAX <= MAX_GEO_RMAX):
            raise ValueError(f"geo_leaves: QR {QR}, RMAX {RMAX}")
        _check("geo_leaves.cover", q, torch.int32, (B, QR, 2))
        nd1 = col["doc_off"].shape[0]
        for ch in _GEO_CH:
            _check(f"geo_leaves.{ch}", col[ch], torch.int32)
        if col["doc_len"].shape[0] != nd1 or \
                col["flat_end"].shape[0] != col["flat_start"].shape[0]:
            raise ValueError("geo_leaves: ragged geo column")
        opt += [q] + [col[ch] for ch in _GEO_CH]
    if not _on_cuda("geo_leaves", docids, *opt):
        return _geo_leaves_plain(cols, specs, queries, docids, base)
    dev = docids.device
    table = []
    for col, (_slot, QR, RMAX), q in zip(cols, specs, queries):
        if "span" not in col or "flat" not in col:
            raise ValueError("geo_leaves: a geo column without its int2 "
                             "pairs (models/segment.py geo_arrays)")
        span, flat = col["span"], col["flat"]
        _check("geo_leaves.span", span, torch.int32,
               (col["doc_off"].shape[0], 2))
        _check("geo_leaves.flat", flat, torch.int32,
               (col["flat_start"].shape[0], 2))
        table += [span.data_ptr(), flat.data_ptr(), span.shape[0],
                  flat.shape[0], QR, RMAX, q.data_ptr()]
    geobits = torch.empty((B, C), dtype=torch.int32, device=dev)
    _launch("geo_leaves", "xt_geo_leaves", docids.data_ptr(), _ptr(base),
            torch.tensor(table, dtype=torch.int64, device=dev).data_ptr(),
            B, C, G, max(s[1] for s in specs), geobits.data_ptr(),
            _stream())
    return geobits


def _geo_leaves_plain(cols, specs, queries, docids, base):
    live = base if base is not None else docids != SENTINEL
    B, C = docids.shape
    out = torch.zeros_like(docids)
    for g, (col, (_slot, _QR, RMAX), q) in enumerate(zip(cols, specs,
                                                         queries)):
        d = docids.clamp(max=col["doc_off"].shape[0] - 1).long()
        cnt = col["doc_len"][d]
        j = torch.arange(RMAX, device=docids.device)
        ridx = (col["doc_off"][d].long()[..., None] + j).clamp(
            max=col["flat_start"].shape[0] - 1)
        rs, re = col["flat_start"][ridx], col["flat_end"][ridx]
        qs, qe = q[..., 0].contiguous(), q[..., 1].contiguous()
        n_le = rank_count(qs, re.reshape(B, -1), True).view(rs.shape)
        n_lt = rank_count(qe, rs.reshape(B, -1), False).view(rs.shape)
        hit = ((n_le > n_lt) & (j < cnt[..., None])).any(-1) & live
        out |= hit.to(torch.int32) << g
    return out


# --------------------------------------------------------------------------
# K8: sort_topk
# --------------------------------------------------------------------------

SORT_KINDS = {"value": 0, "score": 1, "dist": 2, "geodist": 3,
              "strmetric": 4, "docid": 5}
_SORT_CH = ("hi", "lo", "present", "fval", "fval2", "cats")


def sort_topk(specs, ids, sums, eligible, k: int, values: dict,
              targets=None, strtabs=None, remaps=None, emit: bool = False):
    """The first k rows of each query in multi-key order, docid tiebreak
    (executor.py _rank_and_topk 487-574).

    specs: ExecConfig.sort entries (kind, slot, desc[, nb]), or
    (("docid", None, False),) for an unweighted plan; ids i32[B,C], sums
    f32[B,C], eligible bool[B,C]; values: the segment's value columns;
    targets f32[B,S,2] (the plan's sort_targets; dist / geodist);
    strtabs {spec index: f32[B,nb]} (strmetric); remaps {spec index:
    i32[n]}: the mesh's sort_cat_remap row of a strmetric spec, a doc's
    category code mapped through it before the table (executor.py
    549-553). A k beyond MAX_SORT_TOPK, or keys beyond MAX_SORT_WORDS
    words, go to the wide mode (wide_topk.cu, ``wide_plan``), as lax.sort
    takes any k and any number of keys.
    -> docids i32[B,k] (SENTINEL for ineligible rows), scores f32[B,k]
    (-inf there); with emit, also each row's sort key words i32[B,k,NU]
    (the unsigned words of lax.sort's order, all but the docid; all ones
    past the rows), which the mesh merges by (executor.py:569-573).

    The kernel (csrc/sort_topk.cu) keeps each row tile's k best keys
    (``sort_plan``) behind a threshold, reading an ineligible row's flag
    alone and an eligible row's key word by word, then merges the tiles'
    lists."""
    B, C = ids.shape
    S = len(specs)
    # key words: 2 per value spec, 1 per other, the docid, the row index
    n_words = sum(2 if s[0] == "value" else 1 for s in specs) + 2
    if S < 1:
        raise ValueError("sort_topk: no sort key")
    if k < 1:
        raise ValueError(f"sort_topk: k={k} below 1")
    _check("sort_topk.ids", ids, torch.int32, (B, C))
    _check("sort_topk.sums", sums, torch.float32, (B, C))
    _check("sort_topk.eligible", eligible, torch.bool, (B, C))
    strtabs = strtabs or {}
    remaps = remaps or {}
    opt = []
    for si, spec in enumerate(specs):
        if spec[0] not in SORT_KINDS:
            raise ValueError(f"sort_topk: unknown sort kind {spec[0]!r}")
        if spec[0] in ("dist", "geodist") and targets is None:
            raise ValueError(f"sort_topk: {spec[0]} needs targets")
        if spec[0] == "strmetric":
            _check("sort_topk.strtab", strtabs[si], torch.float32,
                   (B, spec[3]))
            opt.append(strtabs[si])
            if si in remaps:
                _check("sort_topk.remap", remaps[si], torch.int32)
                opt.append(remaps[si])
    if targets is not None:
        _check("sort_topk.targets", targets, torch.float32, (B, S, 2))
        opt.append(targets)
    cols = _sort_cols(specs, values, opt)
    if not _on_cuda("sort_topk", ids, sums, eligible, *opt):
        return _sort_topk_plain(specs, cols, ids, sums, eligible, k, targets,
                                strtabs, remaps, emit)
    dev = ids.device
    spec_tab, tab = _sort_tables(specs, cols, strtabs, dev, remaps)
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_k = torch.empty((B, k, n_words - 2), dtype=torch.int32,
                        device=dev) if emit else None
    if k > MAX_SORT_TOPK or n_words > MAX_SORT_WORDS:
        plan, bufs = _wide_buffers(B, C, k, n_words, dev)
        _launch("wide_topk", "xt_wide_sort_topk", ids.data_ptr(),
                sums.data_ptr(), eligible.data_ptr(), B, C, k, S, n_words,
                spec_tab.data_ptr(), tab.data_ptr(), _ptr(targets),
                *plan, *(_ptr(x) for x in bufs), out_d.data_ptr(),
                out_s.data_ptr(), _ptr(out_k), _stream())
    else:
        _launch("sort_topk", "xt_sort_topk", ids.data_ptr(), sums.data_ptr(),
                eligible.data_ptr(), B, C, k, S, n_words, spec_tab.data_ptr(),
                tab.data_ptr(), _ptr(targets), out_d.data_ptr(),
                out_s.data_ptr(), _ptr(out_k), _stream())
    return (out_d, out_s, out_k) if emit else (out_d, out_s)


def sort_plan(B: int, C: int) -> tuple:
    """sort_topk's tiling of a launch (csrc/sort_topk.cu sk_plan, the same
    arithmetic as topk_plan with SORT_BLOCKS and SORT_TILE_MIN): each
    query's rows in tiles of gper groups of 4 rows, C up to SORT_TILE_MIN
    one tile and one launch. -> (tiles, gper)."""
    return _tile_plan(B, C, SORT_BLOCKS, SORT_TILE_MIN)


def _sort_cols(specs, values, opt):
    """The value column of each spec (None for score / docid); appends the
    tensors the kernel reads to ``opt`` (for the device check)."""
    cols = [values.get(s[1]) if s[0] not in ("score", "docid") else None
            for s in specs]
    for col in cols:
        opt.extend(col[ch] for ch in _SORT_CH if col is not None and ch in col)
    return cols


def _sort_tables(specs, cols, strtabs, dev, remaps=None):
    """sort_topk's spec table (kind, desc, nb, 0 per spec) and column table
    (common.cuh ST_COLS int64 words per spec) on ``dev``."""
    remaps = remaps or {}
    spec_tab, table = [], []
    for si, (spec, col) in enumerate(zip(specs, cols)):
        spec_tab += [SORT_KINDS[spec[0]], int(bool(spec[2])),
                     int(spec[3]) if spec[0] == "strmetric" else 0, 0]
        table += [_ptr(col.get(ch)) if col is not None else 0
                  for ch in _SORT_CH]
        rm = remaps.get(si)
        table += [_ptr(strtabs.get(si)),
                  col["hi"].shape[0] if col is not None else 0,
                  _ptr(rm), rm.shape[0] if rm is not None else 0]
    # the table holds per-batch pointers when a strmetric table rides it:
    # those are not cached
    tab = _ints(tuple(table), dev, torch.int64) if not strtabs else \
        torch.tensor(table, dtype=torch.int64, device=dev)
    return _ints(tuple(spec_tab), dev), tab


def _ikey(x):
    """int32 -> int64 in [0, 2**32): the order of x ^ 0x80000000."""
    return x.long() + 2**31


def _fkey(x):
    """float32 -> int64 in [0, 2**32) in lax.sort's order: -0.0 equal to
    +0.0, every NaN equal and after +inf."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    u = x.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 2**31, u ^ 0xFFFFFFFF, u | 2**31)


def haversine(lat, lon, lat0, lon0):
    """_haversine (executor.py:406-413) on float32 tensors, in its
    operation order."""
    r = 0.017453292519943295   # jnp.pi / 180.0
    dlat = (lat - lat0) * r * 0.5
    dlon = (lon - lon0) * r * 0.5
    s1, s2 = torch.sin(dlat), torch.sin(dlon)
    a = s1 * s1 + (torch.cos(lat * r) * torch.cos(lat0 * r)) * (s2 * s2)
    return 12742017.6 * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _masked_key(si, spec, col, ids, sums, eligible, targets, strtabs,
                remaps=None):
    """Sort spec si's key as _rank_and_topk builds it (487-559), masked to
    the eligible rows: (hi, lo) int32 for a value key, (docid,) for the
    docid key, (key,) float32 for the others."""
    kind, desc = spec[0], bool(spec[2])
    inf = float("inf")
    if col is not None:
        d = ids.clamp(max=col["hi"].shape[0] - 1).long()
    if kind == "value":
        if col is None:
            h = l = torch.full_like(ids, I32MAX)
            present = torch.zeros_like(eligible)
        else:
            h, l, present = col["hi"][d], col["lo"][d], col["present"][d]
        if desc:
            h, l = ~h, ~l
        h = torch.where(present, h, I32MAX)
        return (torch.where(eligible, h, I32MAX),
                torch.where(eligible, l, I32MAX))
    if kind == "docid":
        return (torch.where(eligible, ids, SENTINEL),)
    if kind == "score":
        kf = -sums if desc else sums
    elif kind == "strmetric":
        code = col["cats"][d] if col is not None and "cats" in col \
            else torch.full_like(ids, -1)
        rm = (remaps or {}).get(si)
        if rm is not None:   # the mesh: local codes -> the global table
            code = torch.where(code >= 0, rm[code.clamp(
                0, rm.shape[0] - 1).long()], -1)
        tab = strtabs[si]
        kf = torch.gather(tab, 1, code.clamp(0, tab.shape[1] - 1).long())
        kf = torch.where(code >= 0, kf, inf)
        if desc:
            kf = -kf
    else:
        if col is None:
            v = torch.zeros_like(sums)
            present = torch.zeros_like(eligible)
        else:
            v, present = col["fval"][d], col["present"][d]
        t0 = targets[:, si, 0:1]
        if kind == "dist":
            kf = torch.abs(v - t0)
        else:
            lon = col["fval2"][d] if col is not None and "fval2" in col \
                else torch.zeros_like(v)
            kf = haversine(v, lon, t0, targets[:, si, 1:2])
        kf = torch.where(present, kf, inf)
        if desc:
            kf = -kf
    return (torch.where(eligible, kf, inf),)


def _lex_order(keys):
    """Row order of [B, C] int64 key tensors, most significant first; ties
    keep row order."""
    B, C = keys[0].shape
    order = torch.arange(C, device=keys[0].device).expand(B, C)
    for key in reversed(keys):   # least significant first, stable
        o = torch.sort(torch.gather(key, 1, order), dim=1, stable=True)[1]
        order = torch.gather(order, 1, o)
    return order


def sort_words(specs, cols, ids, sums, eligible, targets, strtabs,
               remaps=None):
    """Each row's sort key words as csrc/sort_topk.cu orders them, int64
    [B, C] tensors in [0, 2**32), most significant first: the specs'
    words, then the masked docid (the row index, the kernel's last word,
    is the position)."""
    keys = []
    for si, (spec, col) in enumerate(zip(specs, cols)):
        mk = _masked_key(si, spec, col, ids, sums, eligible, targets, strtabs,
                         remaps)
        keys += [_ikey(x) for x in mk] if spec[0] in ("value", "docid") \
            else [_fkey(mk[0])]
    keys.append(_ikey(torch.where(eligible, ids, SENTINEL)))
    return keys


def _sort_topk_plain(specs, cols, ids, sums, eligible, k, targets, strtabs,
                     remaps=None, emit=False):
    B, C = ids.shape
    keys = sort_words(specs, cols, ids, sums, eligible, targets, strtabs,
                      remaps)
    n_user = len(keys) - 1
    order = _lex_order(keys)[:, :k]
    dd = torch.gather(torch.where(eligible, ids, SENTINEL), 1, order)
    ss = torch.gather(torch.where(eligible, sums, float("-inf")), 1, order)
    if C < k:
        dd = torch.nn.functional.pad(dd, (0, k - C), value=SENTINEL)
        ss = torch.nn.functional.pad(ss, (0, k - C), value=float("-inf"))
    if not emit:
        return dd, ss
    kw = torch.stack([torch.gather(x, 1, order) for x in keys[:n_user]], 2)
    if C < k:
        kw = torch.nn.functional.pad(kw, (0, 0, 0, k - C),
                                     value=2**32 - 1)
    return dd, ss, torch.where(kw >= 2**31, kw - 2**32, kw).to(torch.int32)


# --------------------------------------------------------------------------
# K9: fullwidth_topk
# --------------------------------------------------------------------------

FULLWIDTH_KINDS = ("value", "dist", "geodist", "strmetric")


def fullwidth_topk(spec, ids, sums, eligible, k: int, values: dict,
                   targets=None, strtabs=None):
    """The sort-free top-k of one sort key over every row (executor.py
    _fullwidth_topk 431-459): a window of kk = min(k + 64, R) rows with the
    smallest float32 images of the key (float(hi) of a value key, the key
    itself otherwise), ordered exactly by (key, docid), and the strict
    certificate img[kk-1] > img[k-1] over all R rows' images.

    spec: one ExecConfig.sort entry; ids i32[B,R], sums f32[B,R],
    eligible bool[B,R]; values, targets f32[B,1,2], strtabs as sort_topk.
    -> docids i32[B,k] (SENTINEL past the eligible rows), scores f32[B,k]
    (-inf there), certified bool[B]. The window is the first kk rows in
    the exact key order, which is a window of smallest images (the image
    is monotone in the key); JAX's top_k may break ties among equal images
    otherwise, which changes the result of uncertified queries only.

    The kernel (csrc/fullwidth_topk.cu) walks each query's rows in G
    blocks (``fullwidth_plan``), each warp queueing its eligible rows and
    keeping those below its threshold in a buffer in shared memory, whose
    kk best it selects when it fills; each warp appends its candidates to
    the query's, and a second kernel selects and orders their kk best."""
    B, R = ids.shape
    kk = min(k + FULLWIDTH_WINDOW, R)
    if not 0 < k < kk <= MAX_FULLWIDTH_KK:
        raise ValueError(f"fullwidth_topk: k={k}, window {kk} (1 <= k < "
                         f"window <= {MAX_FULLWIDTH_KK})")
    if spec[0] not in FULLWIDTH_KINDS:
        raise ValueError(f"fullwidth_topk: sort kind {spec[0]!r}")
    _check("fullwidth_topk.ids", ids, torch.int32, (B, R))
    _check("fullwidth_topk.sums", sums, torch.float32, (B, R))
    _check("fullwidth_topk.eligible", eligible, torch.bool, (B, R))
    strtabs = strtabs or {}
    opt = []
    if spec[0] in ("dist", "geodist"):
        if targets is None:
            raise ValueError(f"fullwidth_topk: {spec[0]} needs targets")
        _check("fullwidth_topk.targets", targets, torch.float32, (B, 1, 2))
        opt.append(targets)
    if spec[0] == "strmetric":
        _check("fullwidth_topk.strtab", strtabs[0], torch.float32,
               (B, spec[3]))
        opt.append(strtabs[0])
    cols = _sort_cols((spec,), values, opt)
    if not _on_cuda("fullwidth_topk", ids, sums, eligible, *opt):
        return _fullwidth_topk_plain(spec, cols[0], ids, sums, eligible, k,
                                     targets, strtabs)
    dev = ids.device
    spec_tab, tab = _sort_tables((spec,), cols, strtabs, dev)
    G, gpw = fullwidth_plan(B, R)
    # each query's candidates (at most kk a warp, two 64-bit words each);
    # each query's count of them, its eligible rows and its bound, zeroed
    cand = torch.empty(B * FULLWIDTH_WARPS * G * kk * 2, dtype=torch.int64,
                       device=dev)
    qs = torch.zeros(3 * B, dtype=torch.int64, device=dev)
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    cert = torch.empty(B, dtype=torch.bool, device=dev)
    _launch("fullwidth_topk", "xt_fullwidth_topk", ids.data_ptr(),
            sums.data_ptr(), eligible.data_ptr(), B, R, G, gpw, k, kk,
            SORT_KINDS[spec[0]],
            spec_tab.data_ptr(), tab.data_ptr(), _ptr(targets),
            cand.data_ptr(), qs.data_ptr(), out_d.data_ptr(),
            out_s.data_ptr(), cert.data_ptr(), _stream())
    return out_d, out_s, cert


def fullwidth_plan(B: int, R: int) -> tuple:
    """(G, gpw) of fullwidth_topk: G blocks a query, each at least
    FULLWIDTH_ROWS rows, B x G at most FULLWIDTH_BLOCKS; its
    FULLWIDTH_WARPS warps take gpw 16-row groups a step each, gpw halved
    (down to 1) while a block's groups would leave a warp without a
    step."""
    B = max(B, 1)
    G = max(1, min(FULLWIDTH_BLOCKS // B, -(-R // FULLWIDTH_ROWS)))
    groups = -(-(-(-R // 16)) // G)
    gpw = 32
    while gpw > 1 and groups < FULLWIDTH_WARPS * gpw:
        gpw //= 2
    return G, gpw


def _fullwidth_topk_plain(spec, col, ids, sums, eligible, k, targets,
                          strtabs):
    R = ids.shape[1]
    kk = min(k + FULLWIDTH_WINDOW, R)
    mk = _masked_key(0, spec, col, ids, sums, eligible, targets, strtabs)
    if spec[0] == "value":
        img = mk[0].to(torch.float32)    # int32 -> f32, round to nearest
        keys = [_ikey(mk[0]), _ikey(mk[1])]
    else:
        img = mk[0]
        keys = [_fkey(mk[0])]
    keys.append(_ikey(torch.where(eligible, ids, SENTINEL)))
    order = _lex_order(keys)[:, :kk]
    wimg = torch.gather(img, 1, order)
    cert = wimg[:, kk - 1] > wimg[:, k - 1]
    order = order[:, :k]
    dd = torch.gather(torch.where(eligible, ids, SENTINEL), 1, order)
    ss = torch.gather(torch.where(eligible, sums, float("-inf")), 1, order)
    return dd, ss, cert


# --------------------------------------------------------------------------
# K17a: agg_metrics, agg_buckets
# --------------------------------------------------------------------------

def _check_cols(name, cols):
    out = []
    for fval, present in cols:
        _check(f"{name}.fval", fval, torch.float32)
        _check(f"{name}.present", present, torch.bool, fval.shape)
        if fval.dim() != 1 or fval.shape[0] < 1:
            raise ValueError(f"{name}: a value column is f32[rows >= 1]")
        out += [fval, present]
    return out


def agg_metrics(ids, eligible, cols):
    """Per query the count of eligible rows and, for each value column, the
    masked sufficient statistics of compute_aggs' metric branch
    (ops/aggs.py 196-198, 249-274).

    ids i32[B,R], eligible bool[B,R]; cols: [(fval f32[n], present
    bool[n])], read at d = min(id, n - 1).
    -> count i32[B], and n, s, s2, min, max f32[M,B] (min +inf and max
    -inf where n is 0)."""
    B, R = ids.shape
    M = len(cols)
    if M > MAX_AGG_METRICS:
        raise ValueError(f"agg_metrics: {M} columns (max {MAX_AGG_METRICS})")
    _check("agg_metrics.ids", ids, torch.int32, (B, R))
    _check("agg_metrics.eligible", eligible, torch.bool, (B, R))
    opt = _check_cols("agg_metrics", cols)
    if not _on_cuda("agg_metrics", ids, eligible, *opt):
        return _agg_metrics_plain(ids, eligible, cols)
    dev = ids.device
    G, gpw = row_plan(B, R)
    # read by the C entry on the host, which passes the columns by value
    table = torch.tensor([x for f, p in cols
                          for x in (f.data_ptr(), p.data_ptr(), f.shape[0])]
                         or [0], dtype=torch.int64)
    part = torch.empty(B * G * M * 5, dtype=torch.float32, device=dev) \
        if G > 1 and M else None
    cpart = torch.empty(B * G, dtype=torch.int32, device=dev) \
        if G > 1 else None
    count = torch.empty(B, dtype=torch.int32, device=dev)
    out = torch.empty((5, M, B), dtype=torch.float32, device=dev)
    _launch("agg_metrics", "xt_agg_metrics", ids.data_ptr(),
            eligible.data_ptr(), B, R, G, gpw, M, table.data_ptr(),
            _ptr(part),
            _ptr(cpart), _tickets(B, dev).data_ptr(), count.data_ptr(),
            out.data_ptr(), _stream())
    return (count,) + tuple(out)


def row_plan(B: int, R: int, cap: int = AGG_BLOCKS,
             fill: int = AGG_FILL) -> tuple:
    """(G, gpw) of the kernels that walk a query's rows by warp row queues
    (csrc/common.cuh warp_row_queue): G blocks a query of 8 warps taking
    gpw 16-row groups a step each, a block AGG_ROWS rows at gpw 32; where
    B x G falls short of ``fill`` blocks (few queries: the Database path's
    B 1), gpw halves, down to 1, and the blocks shrink with it, so that
    the card is filled (not past cap); G at most AGG_BLOCKS over the
    queries and cap."""
    B = max(B, 1)
    cap = min(cap, AGG_BLOCKS // B)
    gpw = 32
    while gpw > 1 and B * -(-R // (AGG_ROWS * gpw // 32)) < fill and \
            -(-R // (AGG_ROWS * gpw // 32)) < cap:
        gpw //= 2
    return max(1, min(-(-R // (AGG_ROWS * gpw // 32)), cap)), gpw


def _agg_metrics_plain(ids, eligible, cols):
    B = ids.shape[0]
    outs = []
    for fval, present in cols:
        d = ids.clamp(max=fval.shape[0] - 1).long()
        v = fval[d]
        m = eligible & present[d]
        fm = m.to(torch.float32)
        outs.append((fm.sum(1), (v * fm).sum(1), (v * v * fm).sum(1),
                     torch.where(m, v, float("inf")).amin(1),
                     torch.where(m, v, float("-inf")).amax(1)))
    count = eligible.sum(1, dtype=torch.int32)
    if not outs:
        return (count,) + (torch.zeros((0, B), dtype=torch.float32,
                                       device=ids.device),) * 5
    return (count,) + tuple(torch.stack(x) for x in zip(*outs))


BUCKET_MODES = {"terms": 0, "missing": 1, "mask": 2, "histogram": 3,
                "range": 4, "trixels": 5}


def agg_buckets(ids, eligible, mode: str, codes, nb: int, subs=(), *,
                prev=None, size=None, want_codes=False, sub_clamp=0,
                remap=None):
    """Per query the bucket counts of one single-code bucket aggregation of
    compute_aggs, and per metric sub-aggregation the per-bucket sufficient
    statistics of _sub_stats_bucketed (ops/aggs.py 107-155, without
    hist2: agg_hist). Every row is in at most one bucket; its code by mode:

      "terms"      codes = the slot's cats i32[n] (None: every row -1),
                   valid in [0, nb) (275-303; a nested terms level); on
                   the mesh a code >= 0 is first mapped through ``remap``
                   i32[m], the shard's cat_remap row (287-291)
      "missing"    codes = the slot's present bool[n]; bucket 0 where it
                   is False; nb must be 1 (239-248)
      "mask"       codes = a row mask bool[B,R] (agg_filter's); bucket 0
                   where it is True; nb must be 1 (199-215)
      "histogram"  codes = {fval f32[n], present bool[n], params f32[B,2]
                   (interval, shift)}: floor((v - shift) / interval),
                   valid when present and in [0, nb) (304-323, 172-178)
      "range"      codes = {fval, present, bounds f32[B,nb,2]}: the first
                   range with lo <= v < hi (a nested range level, 179-185)
      "trixels"    codes = {doc_off, doc_len i32[n], flat_start i32[m],
                   table i32[B,nb], shift}: the doc's first range >> shift
                   looked up in the ascending table (372-395)

    read at d = min(id, n - 1). A nested level passes ``prev`` i32[B,R],
    the previous level's composite codes (-1: not in a bucket), and
    ``size``, the count width: the code is prev * nb + code (216-238).
    ``want_codes`` also returns each row's (composite) code or -1, i32
    [B,R]. A sub reads min(id, sub_clamp - 1) where sub_clamp > 0
    (geo_trixels' subs read the clamped doc, :393). subs: per sub
    (fval f32[n], present bool[n]) or None for a count sub.
    -> counts i32[B,size], per sub n, s, s2, min, max f32[S,B,size] (None
    without subs)[, codes]."""
    B, R = ids.shape
    S = len(subs)
    size = nb if size is None else size
    if mode not in BUCKET_MODES or \
            (mode in ("missing", "mask") and (codes is None or nb != 1)):
        raise ValueError(f"agg_buckets: mode {mode!r}, nb {nb}")
    if not 0 < size <= MAX_AGG_BUCKETS or nb < 1:
        raise ValueError(f"agg_buckets: {size} buckets "
                         f"(1..{MAX_AGG_BUCKETS})")
    _check("agg_buckets.ids", ids, torch.int32, (B, R))
    _check("agg_buckets.eligible", eligible, torch.bool, (B, R))
    opt = _check_cols("agg_buckets", [c for c in subs if c is not None])
    src = _bucket_src("agg_buckets", mode, codes, B, R, nb, remap)
    opt += [t for t in src if isinstance(t, torch.Tensor)]
    if prev is not None:
        _check("agg_buckets.prev", prev, torch.int32, (B, R))
        opt.append(prev)
    if not _on_cuda("agg_buckets", ids, eligible, *opt):
        return _agg_buckets_plain(ids, eligible, mode, codes, nb, subs,
                                  prev, size, want_codes, sub_clamp, remap)
    dev = ids.device
    G = bucket_plan(B, R, size, S)
    table = _ints(tuple(x for c in subs
                        for x in ((c[0].data_ptr(), c[1].data_ptr(),
                                   c[0].shape[0]) if c is not None
                                  else (0, 0, 0))),
                  dev, torch.int64) if subs else None
    counts = torch.empty((B, size), dtype=torch.int32, device=dev)
    out_codes = torch.empty((B, R), dtype=torch.int32, device=dev) \
        if want_codes else None
    part = torch.empty(max(B * G * S * size * 5, 1), dtype=torch.float32,
                       device=dev)
    pcount = torch.empty(B * G * size, dtype=torch.int32, device=dev)
    out = torch.empty((S, 5, B, size), dtype=torch.float32, device=dev)
    # the warps' sub partials past shared memory (csrc AB_WP_SMEM floats)
    wide = AGG_WARPS * S * size * 5 > AGG_WP_SMEM
    wpg = torch.empty(B * G * AGG_WARPS * S * size * 5, dtype=torch.float32,
                      device=dev) if wide else None
    p0, p1, p2, n0, n1, fpar, ipar, fstride, shift = src
    _launch("agg_buckets", "xt_agg_buckets", ids.data_ptr(),
            eligible.data_ptr(), B, R, G, BUCKET_MODES[mode], _ptr(p0),
            _ptr(p1), _ptr(p2), n0, n1, _ptr(fpar), _ptr(ipar), fstride, nb,
            shift, _ptr(prev), sub_clamp, size, S, _ptr(table),
            counts.data_ptr(), _ptr(out_codes), part.data_ptr(),
            pcount.data_ptr(), _tickets(B, dev).data_ptr(), out.data_ptr(),
            _ptr(wpg), _stream())
    res = (counts, tuple(out.transpose(0, 1)) if S else None)
    return res + (out_codes,) if want_codes else res


_KEPT: dict = {}


def _kept_zeros(what: str, n: int, device) -> torch.Tensor:
    """i32 zeros, n or more, kept on the device from call to call for
    ``what``: the kernels that use them leave them zero."""
    key = (what, device.type, device.index)
    t = _KEPT.get(key)
    if t is None or t.shape[0] < n:
        t = _KEPT[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                     device=device)
    return t


def _tickets(n: int, device) -> torch.Tensor:
    """The counters a query of a kernel whose last block folds the others'
    partials (agg_buckets, agg_metrics, agg_ranges, agg_hist), which that
    block sets back to 0."""
    return _kept_zeros("tickets", n, device)


def bucket_plan(B: int, R: int, size: int, S: int = 0) -> int:
    """agg_buckets' blocks a query (G): one a AGG_ROWS rows, so that a
    query whose eligible rows crowd one stretch spreads them over many
    blocks; at most AGG_BLOCKS over the queries and fold_cap's (its last
    block folds the G blocks' counts and statistics)."""
    G = min(-(-R // AGG_ROWS), AGG_BLOCKS // max(B, 1),
            fold_cap(B, size, S))
    return max(1, G)


def fold_cap(B: int, size: int, S: int) -> int:
    """The blocks a query at most of a kernel whose last block folds the
    blocks' size counts and S subs' statistics (agg_buckets, agg_ranges):
    AGG_FOLD // size and, where the warps' sub partials pass shared
    memory, AGG_WIDE floats of them."""
    cap = AGG_FOLD // size
    wp = AGG_WARPS * S * size * 5
    if wp > AGG_WP_SMEM:
        cap = min(cap, AGG_WIDE // (max(B, 1) * wp))
    return cap


def _bucket_src(name, mode, codes, B, R, nb, remap=None) -> tuple:
    """(p0, p1, p2, n0, n1, fpar, ipar, fstride, shift) of a bucket mode,
    checked: the kernel's BucketSrc."""
    if remap is not None and mode != "terms":
        raise ValueError(f"{name}: a category remap in mode {mode!r}")
    if mode == "terms":
        if codes is None:
            return None, None, None, 0, 0, None, None, 0, 0
        _check(f"{name}.cats", codes, torch.int32)
        if remap is not None:
            _check(f"{name}.remap", remap, torch.int32)
            if remap.shape[0] < 1:
                raise ValueError(f"{name}: an empty category remap")
        return (codes, remap, None, codes.shape[0],
                0 if remap is None else remap.shape[0], None, None, 0, 0)
    if mode == "missing":
        _check(f"{name}.present", codes, torch.bool)
        return codes, None, None, codes.shape[0], 0, None, None, 0, 0
    if mode == "mask":
        _check(f"{name}.mask", codes, torch.bool, (B, R))
        return codes, None, None, R, 0, None, None, 0, 0
    if mode in ("histogram", "range"):
        fval, present = codes["fval"], codes["present"]
        _check(f"{name}.fval", fval, torch.float32)
        _check(f"{name}.present", present, torch.bool, fval.shape)
        key = "params" if mode == "histogram" else "bounds"
        fp = codes[key]
        _check(f"{name}.{key}", fp, torch.float32,
               (B, 2) if mode == "histogram" else (B, nb, 2))
        return (fval, present, None, fval.shape[0], 0, fp, None,
                2 if mode == "histogram" else 2 * nb, 0)
    off, ln, fs, tab = (codes["doc_off"], codes["doc_len"],
                        codes["flat_start"], codes["table"])
    _check(f"{name}.doc_off", off, torch.int32)
    _check(f"{name}.doc_len", ln, torch.int32, off.shape)
    _check(f"{name}.flat_start", fs, torch.int32)
    _check(f"{name}.table", tab, torch.int32, (B, nb))
    if fs.shape[0] < 1:
        raise ValueError(f"{name}: an empty flat_start")
    return (off, ln, fs, off.shape[0], fs.shape[0], None, tab, 0,
            int(codes["shift"]))


def _bucket_code_plain(mode, codes, ids, nb, remap=None):
    """(code i64[B,R], valid bool[B,R]) of a bucket mode, eligibility not
    applied (ops/aggs.py _bucket_codes 163-186 and the top-level kinds)."""
    if mode == "mask":
        return torch.zeros_like(ids, dtype=torch.int64), codes
    if mode == "terms":
        if codes is None:
            c = torch.full_like(ids, -1)
        else:
            c = codes[ids.clamp(max=codes.shape[0] - 1).long()]
        if remap is not None:
            c = torch.where(c >= 0, remap[c.clamp(
                0, remap.shape[0] - 1).long()], -1)
        return c.clamp(0, nb - 1).long(), (c >= 0) & (c < nb)
    if mode == "missing":
        pres = codes[ids.clamp(max=codes.shape[0] - 1).long()]
        return torch.zeros_like(ids, dtype=torch.int64), ~pres
    if mode in ("histogram", "range"):
        fval = codes["fval"]
        d = ids.clamp(max=fval.shape[0] - 1).long()
        v, pres = fval[d], codes["present"][d]
        if mode == "histogram":
            prm = codes["params"]
            # a float32 division by a tensor, as jnp's (a Python scalar
            # divisor would become a reciprocal multiply)
            b = torch.floor((v - prm[:, 1:2]) / prm[:, 0:1])
            valid = pres & (b >= 0) & (b < nb)
            return b.clamp(0, nb - 1).long(), valid
        bnd = codes["bounds"]
        inr = (v[:, :, None] >= bnd[:, None, :, 0]) & \
            (v[:, :, None] < bnd[:, None, :, 1])
        return inr.to(torch.int8).argmax(2), pres & inr.any(2)
    off, ln, fs, tab = (codes["doc_off"], codes["doc_len"],
                        codes["flat_start"], codes["table"])
    dd = ids.clamp(max=off.shape[0] - 1).long()
    o = off[dd].clamp(max=fs.shape[0] - 1).long()
    tri = fs[o] >> int(codes["shift"])
    code = torch.searchsorted(tab, tri.contiguous())
    hit = tab.gather(1, code.clamp(max=nb - 1)) == tri
    return code, (ln[dd] > 0) & hit & (code < nb)


def _agg_buckets_plain(ids, eligible, mode, codes, nb, subs, prev=None,
                       size=None, want_codes=False, sub_clamp=0, remap=None):
    B, R = ids.shape
    dev = ids.device
    size = nb if size is None else size
    code, valid = _bucket_code_plain(mode, codes, ids, nb, remap)
    if prev is not None:
        valid = valid & (prev >= 0)
        code = prev.long() * nb + code
    m = eligible & valid
    bi, ri = m.nonzero(as_tuple=True)
    flat = bi * size + code[bi, ri]
    counts = torch.zeros(B * size, dtype=torch.int32, device=dev).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)).view(B, size)
    out_codes = torch.where(m, code, -1).to(torch.int32)
    stats = None
    if subs:
        sub_ids = ids[bi, ri]
        if sub_clamp > 0:
            sub_ids = sub_ids.clamp(max=sub_clamp - 1)
        stats = _sub_stats_plain(sub_ids, flat, B * size, counts.view(-1),
                                 subs, (B, size))
    return (counts, stats, out_codes) if want_codes else (counts, stats)


def _sub_stats_plain(sub_ids, flat, nflat, counts, subs, shape):
    """Per sub the n, s, s2, min, max of the (row, bucket) pairs (sub_ids,
    flat) stacked to [S, *shape]: n, s, s2 add in float64 and round once
    (index_add_ adds in no fixed order, atomics on the card, and a float32
    chain over a 100k-row bucket drifts past 1e-5 of the sum)."""
    dev = sub_ids.device
    inf = float("inf")
    outs = []
    for sub in subs:
        n = torch.zeros(nflat, dtype=torch.float64, device=dev)
        s, s2 = torch.zeros_like(n), torch.zeros_like(n)
        mn = torch.full((nflat,), inf, dtype=torch.float32, device=dev)
        mx = torch.full_like(mn, -inf)
        if sub is None:   # a count sub: the bucket's rows
            n = counts
        else:
            fval, present = sub
            d = sub_ids.clamp(max=fval.shape[0] - 1).long()
            keep = present[d]
            f, v = flat[keep], fval[d][keep]
            n.index_add_(0, f, torch.ones_like(v, dtype=torch.float64))
            s.index_add_(0, f, v.double())
            s2.index_add_(0, f, (v * v).double())
            mn.scatter_reduce_(0, f, v, "amin")
            mx.scatter_reduce_(0, f, v, "amax")
        outs.append(tuple(x.to(torch.float32).view(shape)
                          for x in (n, s, s2, mn, mx)))
    return tuple(torch.stack(x) for x in zip(*outs))


# --------------------------------------------------------------------------
# K17c: agg_ranges, agg_hist, agg_filter
# --------------------------------------------------------------------------

RANGE_MODES = {"range": 0, "geodist": 1, "key": 2, "geo_ip": 3}
_KEY_CH = ("hi", "lo", "max_hi", "max_lo", "present")
_MV_CH = ("mv_off", "mv_len", "mv_hi", "mv_lo")


def agg_ranges(ids, eligible, mode: str, col: dict, bounds, nb: int,
               subs=(), *, vmax=1, assign=None, origin=None,
               want_member=False):
    """Per query the counts of compute_aggs' multi-match range kinds and
    per metric sub-aggregation the per-range sufficient statistics
    (_sub_stats_bucketed 107-155, without hist2). A row may lie in several
    ranges (ops/aggs.py 324-423):

      "range"    col {fval, present}, bounds f32[B,nb,2]: lo <= v < hi
      "geodist"  col {fval, present[, fval2]}, origin f32[B,2] (lat, lon),
                 bounds f32[B,nb,2] on the _haversine distance
      "key"      col {hi, lo, max_hi, max_lo, present[, mv_*]}, bounds
                 i32[B,nb,4]: _key_ranges_membership at vmax
      "geo_ip"   as "key" over nr = bounds.shape[1] intervals, assign
                 i32[B,nr] each interval's bucket: a row is in bucket j when
                 an interval of j holds it

    ids i32[B,R], eligible bool[B,R]; columns read at min(id, n - 1); a row
    counts when eligible and present. subs as agg_buckets'.
    -> counts i32[B,nb], per sub n, s, s2, min, max f32[S,B,nb] (None
    without subs)[, member bool[B,R,nb] with want_member]."""
    B, R = ids.shape
    S = len(subs)
    if mode not in RANGE_MODES or not 0 < nb <= MAX_AGG_BUCKETS:
        raise ValueError(f"agg_ranges: mode {mode!r}, nb {nb}")
    _check("agg_ranges.ids", ids, torch.int32, (B, R))
    _check("agg_ranges.eligible", eligible, torch.bool, (B, R))
    opt = _check_cols("agg_ranges", [c for c in subs if c is not None])
    keyed = mode in ("key", "geo_ip")
    nr = bounds.shape[1] if bounds.dim() == 3 else 0
    _check("agg_ranges.bounds", bounds,
           torch.int32 if keyed else torch.float32,
           (B, nr, 4 if keyed else 2))
    if nr < 1 or (mode != "geo_ip" and nr != nb):
        raise ValueError(f"agg_ranges: {nr} ranges for {nb} buckets")
    opt.append(bounds)
    chans = (_KEY_CH + (_MV_CH if vmax > 1 and "mv_hi" in col else ())) \
        if keyed else ("fval", "present") + \
        (("fval2",) if mode == "geodist" and "fval2" in col else ())
    n = col["present"].shape[0]
    for ch in chans:
        if ch in ("mv_hi", "mv_lo"):
            _check(f"agg_ranges.{ch}", col[ch], torch.int32)
        else:
            _check(f"agg_ranges.{ch}", col[ch],
                   torch.bool if ch == "present" else
                   (torch.float32 if ch.startswith("fval") else torch.int32),
                   (n,))
        opt.append(col[ch])
    if mode == "geo_ip":
        _check("agg_ranges.assign", assign, torch.int32, (B, nr))
        opt.append(assign)
    if mode == "geodist":
        _check("agg_ranges.origin", origin, torch.float32, (B, 2))
        opt.append(origin)
    if not _on_cuda("agg_ranges", ids, eligible, *opt):
        return _agg_ranges_plain(ids, eligible, mode, col, bounds, nb, subs,
                                 vmax, assign, origin, want_member)
    dev = ids.device
    if keyed:
        # the key words of a doc, one 16-byte gather (models/segment.py
        # value_arrays; present iff min <= max)
        if "keys" not in col:
            raise ValueError("agg_ranges: a key column without its packed "
                             "keys (models/segment.py value_arrays)")
        _check("agg_ranges.keys", col["keys"], torch.int32, (n, 4))
        if col["keys"].data_ptr() % 16:
            raise ValueError("agg_ranges: the packed keys are not 16-byte "
                             "aligned")
    G, gpw = ranges_plan(B, R, nb, S)
    ptrs = tuple(_ptr(col[ch]) if ch in chans or (ch == "keys" and keyed)
                 else 0
                 for ch in ("fval", "fval2", "present", "keys") + _MV_CH)
    nmv = col["mv_hi"].shape[0] if "mv_hi" in chans else 0
    # read by the C entry on the host, which builds the kernel's RangeSrc
    cols = torch.tensor(ptrs + (n, nmv), dtype=torch.int64)
    table = _ints(tuple(x for c in subs
                        for x in ((c[0].data_ptr(), c[1].data_ptr(),
                                   c[0].shape[0]) if c is not None
                                  else (0, 0, 0))),
                  dev, torch.int64) if subs else None
    counts = torch.empty((B, nb), dtype=torch.int32, device=dev)
    member = torch.empty((B, R, nb), dtype=torch.bool, device=dev) \
        if want_member else None
    part = torch.empty(B * G * S * nb * 5, dtype=torch.float32,
                       device=dev) if G > 1 and S else None
    pcount = torch.empty(B * G * nb, dtype=torch.int32, device=dev) \
        if G > 1 else None
    out = torch.empty((S, 5, B, nb), dtype=torch.float32, device=dev)
    # the warps' sub partials past shared memory (csrc AR_WP_SMEM floats)
    wide = AGG_WARPS * S * nb * 5 > AGG_WP_SMEM
    wpg = torch.empty(B * G * AGG_WARPS * S * nb * 5, dtype=torch.float32,
                      device=dev) if wide else None
    _launch("agg_ranges", "xt_agg_ranges", ids.data_ptr(),
            eligible.data_ptr(), B, R, G, gpw, RANGE_MODES[mode],
            cols.data_ptr(), vmax if "mv_hi" in chans else 1,
            _ptr(bounds) if not keyed else 0, _ptr(bounds) if keyed else 0,
            _ptr(assign), _ptr(origin), nr, nb, S, _ptr(table),
            counts.data_ptr(), _ptr(member), _ptr(part), _ptr(pcount),
            _tickets(B, dev).data_ptr(), out.data_ptr(), _ptr(wpg),
            _stream())
    res = (counts, tuple(out.transpose(0, 1)) if S else None)
    return res + (member,) if want_member else res


def ranges_plan(B: int, R: int, nb: int, S: int) -> tuple:
    """agg_ranges' (G, gpw): row_plan's to RANGES_FILL blocks, G at most
    fold_cap's."""
    return row_plan(B, R, max(1, fold_cap(B, nb, S)), RANGES_FILL)


def _agg_ranges_plain(ids, eligible, mode, col, bounds, nb, subs, vmax=1,
                      assign=None, origin=None, want_member=False):
    B, R = ids.shape
    n = col["present"].shape[0]
    d = ids.clamp(max=n - 1).long()
    m = eligible & col["present"][d]
    if mode in ("range", "geodist"):
        if mode == "range":
            v = col["fval"][d]
        else:
            lon = col["fval2"][d] if "fval2" in col else \
                torch.zeros_like(col["fval"][d])
            v = haversine(col["fval"][d], lon, origin[:, 0:1],
                          origin[:, 1:2])
        inr = (v[:, :, None] >= bounds[:, None, :, 0]) & \
            (v[:, :, None] < bounds[:, None, :, 1])
    else:
        inr = _key_membership_plain(col, d, bounds, vmax)    # [B,R,nr]
        if mode == "geo_ip":
            onehot = assign[:, :, None] == torch.arange(
                nb, device=ids.device)[None, None, :]         # [B,nr,nb]
            inr = (inr[:, :, :, None] & onehot[:, None]).any(2)
    inr = inr & m[:, :, None]
    counts = inr.sum(1, dtype=torch.int32)
    stats = None
    if subs:
        bi, ri, ji = inr.nonzero(as_tuple=True)
        stats = _sub_stats_plain(ids[bi, ri], bi * nb + ji, B * nb,
                                 counts.view(-1), subs, (B, nb))
    return (counts, stats, inr) if want_member else (counts, stats)


def _key_membership_plain(col, d, b, vmax):
    """_key_ranges_membership (ops/aggs.py 77-104) of rows d [B,R] against
    each query's key intervals b i32[B,nr,4] -> bool[B,R,nr]."""
    bh0, bl0 = b[:, None, :, 0], b[:, None, :, 1]
    bh1, bl1 = b[:, None, :, 2], b[:, None, :, 3]
    inr = _lex_ge(col["max_hi"][d][:, :, None], col["max_lo"][d][:, :, None],
                  bh0, bl0) & \
        _lex_le(col["hi"][d][:, :, None], col["lo"][d][:, :, None], bh1, bl1)
    if vmax > 1 and "mv_hi" in col:
        off, cnt = col["mv_off"][d], col["mv_len"][d]
        ar = torch.arange(vmax, device=d.device)
        vidx = (off[:, :, None] + ar).clamp(max=col["mv_hi"].shape[0] - 1)
        vh = col["mv_hi"][vidx.long()][..., None]           # [B,R,vmax,1]
        vl = col["mv_lo"][vidx.long()][..., None]
        valid = (ar < cnt[:, :, None])[..., None]
        hit = (_lex_ge(vh, vl, bh0[:, :, None], bl0[:, :, None])
               & _lex_le(vh, vl, bh1[:, :, None], bl1[:, :, None]) & valid)
        inr = inr & ((cnt == 0)[:, :, None] | hit.any(2))
    return inr


def agg_hist(ids, eligible, fval, present, params, nbins: int, *,
             codes=None, member=None, nb=1):
    """Fixed-grid order-statistic histograms (ops/aggs.py _value_hist
    52-59 and the subs' hist2 141-153): a row counts when eligible and
    present, in bin clip(floor((v - lo) * scale), 0, nbins - 1), in its
    bucket codes[b, r] (>= 0; agg_buckets' codes) or every bucket of
    member[b, r] (agg_ranges' member matrix), or in the one bucket when
    neither is given.

    ids i32[B,R], eligible bool[B,R]; fval f32[n], present bool[n], read at
    min(id, n - 1); params f32[B,2] = (lo, scale).
    -> f32[B,nb,nbins] (integer counts)."""
    B, R = ids.shape
    if codes is not None and member is not None:
        raise ValueError("agg_hist: codes or member, not both")
    if member is not None:
        nb = member.shape[2]
    _check("agg_hist.ids", ids, torch.int32, (B, R))
    _check("agg_hist.eligible", eligible, torch.bool, (B, R))
    opt = _check_cols("agg_hist", [(fval, present)])
    _check("agg_hist.params", params, torch.float32, (B, 2))
    opt.append(params)
    if codes is not None:
        _check("agg_hist.codes", codes, torch.int32, (B, R))
        opt.append(codes)
    if member is not None:
        _check("agg_hist.member", member, torch.bool, (B, R, nb))
        opt.append(member)
    if not 0 < nbins <= MAX_HIST_BINS or nb < 1 or \
            (codes is None and member is None and nb != 1):
        raise ValueError(f"agg_hist: {nb} buckets of {nbins} bins")
    if not _on_cuda("agg_hist", ids, eligible, *opt):
        return _agg_hist_plain(ids, eligible, fval, present, params, nbins,
                               codes, member, nb)
    dev = ids.device
    mode = 0 if codes is None and member is None else \
        (1 if codes is not None else 2)
    G, gpw = row_plan(B, R, fill=HIST_FILL if mode == 0 else HIST2_FILL)
    # modes 1-2: float atomics into a zeroed output where every count
    # stays below 2^24, else the zero-kept int scratch and a grid barrier
    flout = mode > 0 and HIST2_FLOAT and R < 2**24
    out = (torch.zeros if flout else torch.empty)(
        (B, nb, nbins), dtype=torch.float32, device=dev)
    scr = None
    if (mode == 0 and G > 1) or (mode > 0 and not flout):
        scr = _kept_zeros("agg_hist", B * nb * nbins, dev)
    _launch("agg_hist", "xt_agg_hist", ids.data_ptr(), eligible.data_ptr(),
            B, R, G, gpw, fval.data_ptr(), present.data_ptr(),
            fval.shape[0], params.data_ptr(), mode, _ptr(codes),
            _ptr(member), nb, nbins, _ptr(scr),
            _tickets(B, dev).data_ptr(), out.data_ptr(), int(flout),
            _stream())
    return out


def value_bins(v, params, nbins: int):
    """clip(floor((v - lo) * scale), 0, nbins - 1) (ops/aggs.py 56) of
    v f32[B,R] under params f32[B,2] -> i64[B,R]; a NaN in bin 0, as
    JAX's conversion to int32 gives it."""
    f = torch.floor((v - params[:, 0:1]) * params[:, 1:2])
    f = torch.where(f.isnan(), torch.zeros_like(f), f)
    return f.clamp(0, nbins - 1).long()


def _agg_hist_plain(ids, eligible, fval, present, params, nbins,
                    codes=None, member=None, nb=1):
    B, R = ids.shape
    d = ids.clamp(max=fval.shape[0] - 1).long()
    m = eligible & present[d]
    vb = value_bins(fval[d], params, nbins)
    if member is not None:
        bi, ri, ji = (member & m[:, :, None]).nonzero(as_tuple=True)
    else:
        c = torch.zeros_like(vb) if codes is None else codes.long()
        bi, ri = (m & (c >= 0) & (c < nb)).nonzero(as_tuple=True)
        ji = c[bi, ri]
    flat = (bi * nb + ji) * nbins + vb[bi, ri]
    out = torch.zeros(B * nb * nbins, dtype=torch.int32, device=ids.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.view(B, nb, nbins).to(torch.float32)


def agg_filter(ids, eligible, post_docids, spans, Lf: int):
    """The rows of a _filter bucket (ops/aggs.py 199-215): eligible rows
    whose docid JAX's lower_bound finds in each term's window of Lf
    postings (dynamic_slice's start, clamped to fit the array; entries past
    the span's length read as INT32_MAX), every span non-empty.

    ids i32[B,R], eligible bool[B,R], post_docids i32[P], spans
    i32[B,n_terms,2] (offset, length). -> mask bool[B,R]."""
    B, R = ids.shape
    P = post_docids.shape[0]
    _check("agg_filter.ids", ids, torch.int32, (B, R))
    _check("agg_filter.eligible", eligible, torch.bool, (B, R))
    _check("agg_filter.post_docids", post_docids, torch.int32)
    nt = spans.shape[1] if spans.dim() == 3 else 0
    _check("agg_filter.spans", spans, torch.int32, (B, nt, 2))
    if nt < 1 or Lf < 1 or P < Lf:
        # dynamic_slice refuses a window wider than the array (JAX raises)
        raise ValueError(f"agg_filter: {nt} terms, a window of {Lf} in "
                         f"{P} postings")
    if not _on_cuda("agg_filter", ids, eligible, post_docids, spans):
        return _agg_filter_plain(ids, eligible, post_docids, spans, Lf)
    mask = torch.empty_like(eligible)
    _launch("agg_filter", "xt_agg_filter", ids.data_ptr(),
            eligible.data_ptr(), B, R, post_docids.data_ptr(), P,
            spans.data_ptr(), nt, Lf, mask.data_ptr(), _stream())
    return mask


def _agg_filter_plain(ids, eligible, post_docids, spans, Lf):
    B, R = ids.shape
    P = post_docids.shape[0]
    ar = torch.arange(Lf, device=ids.device)
    bits = max((Lf - 1).bit_length(), 1)
    m = eligible.clone()
    for t in range(spans.shape[1]):
        off, ln = spans[:, t, 0].long(), spans[:, t, 1].long()
        start = off.clamp(max=P - Lf).clamp(min=0)
        win = post_docids[(start[:, None] + ar).long()]          # [B, Lf]
        win = torch.where(ar[None, :] < ln[:, None], win, I32MAX)
        pos = torch.zeros_like(ids, dtype=torch.int64)
        for sbit in reversed(range(bits)):
            cand = pos + (1 << sbit)
            probe = win.gather(1, (cand - 1).clamp(max=Lf - 1))
            pos = torch.where((cand <= Lf) & (probe < ids), cand, pos)
        found = win.gather(1, pos.clamp(max=Lf - 1)) == ids
        m = m & found & (ln > 0)[:, None]
    return m


# --------------------------------------------------------------------------
# K10: collapse_rows
# --------------------------------------------------------------------------

_COLLAPSE_CH = ("hi", "lo", "present")


def _pow2_cover(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def collapse_rows(ids, sums, eligible, col, collapse_max: int,
                  row_order: bool = False):
    """The survivors of a collapse (executor.py _collapse 577-617) and each
    row's tie rank, without permuting the rows.

    ids i32[B,R], sums f32[B,R], eligible bool[B,R] (eligible rows hold
    distinct docids); col: the collapse slot's value column {hi, lo i32[n],
    present bool[n]} read at min(id, n - 1), or None for a slot the
    segment lacks; collapse_max >= 1, capped at MAX_COLLAPSE as JAX caps it;
    row_order: equal scores of a key rank by row index, as _collapse's
    stable sort leaves rows that are not docid-ascending (the join path's),
    else by docid.
    -> keep bool[B,R]: the row is eligible and either its doc has no value
       (solo) or fewer than the cap of the eligible rows with its (hi, lo)
       key precede it by (score desc, docid or row asc);
       tie i32[B,R]: for an eligible row with a value rank * cap + j, rank
       the rank of its key among the query's distinct keys, (hi, lo)
       ascending, and j its place in that order among its key's rows (cap
       - 1 past the survivors); INT32_MAX otherwise. Among survivors of
       equal score the collapsed order is (tie, docid) ascending."""
    B, R = ids.shape
    if collapse_max < 1:
        raise ValueError(f"collapse_rows: collapse_max {collapse_max}")
    cmax = min(int(collapse_max), MAX_COLLAPSE)
    _check("collapse_rows.ids", ids, torch.int32, (B, R))
    _check("collapse_rows.sums", sums, torch.float32, (B, R))
    _check("collapse_rows.eligible", eligible, torch.bool, (B, R))
    if col is None:
        # a slot the segment lacks: no doc has a value, every row is solo
        col = absent_column(ids.device)
    n = col["hi"].shape[0]
    for ch in _COLLAPSE_CH:
        _check(f"collapse_rows.{ch}", col[ch],
               torch.bool if ch == "present" else torch.int32, (n,))
    if not _on_cuda("collapse_rows", ids, sums, eligible,
                    *(col[ch] for ch in _COLLAPSE_CH)):
        return _collapse_rows_plain(ids, sums, eligible, col, cmax,
                                    row_order)
    if R > MAX_COLLAPSE_ROWS:
        raise ValueError(f"collapse_rows: {R} rows a query exceed "
                         f"{MAX_COLLAPSE_ROWS} (the key table's slots are "
                         "int32)")
    dev = ids.device
    keep = torch.empty((B, R), dtype=torch.bool, device=dev)
    tie = torch.empty((B, R), dtype=torch.int32, device=dev)
    ts, G = collapse_plan(B, R, collapse_keys(col))
    if ts:
        i64 = dict(dtype=torch.int64, device=dev)
        lists = B * G
        ent_n = torch.empty(lists, dtype=torch.int32, device=dev)
        ent = torch.empty(lists * (ts + 1) * (1 + cmax), **i64)
        mkeys = torch.empty(B * ts, **i64)
        mwords = torch.empty(B * (ts + 1) * cmax, **i64)
        mrank = torch.empty(B * (ts + 1), dtype=torch.int32, device=dev)
        _launch("collapse_rows", "xt_collapse_tiles", ids.data_ptr(),
                sums.data_ptr(), eligible.data_ptr(), B, R,
                col["hi"].data_ptr(), col["lo"].data_ptr(),
                col["present"].data_ptr(), n, cmax, int(row_order), ts, G,
                ent_n.data_ptr(), ent.data_ptr(), mkeys.data_ptr(),
                mwords.data_ptr(), mrank.data_ptr(), keep.data_ptr(),
                tie.data_ptr(), _stream())
        return keep, tie
    cap = _pow2_cover(2 * max(R, 1))
    lcap = _pow2_cover(max(R, 1))
    table = torch.empty((3, B, cap + 1), dtype=torch.int64, device=dev)
    slot = torch.empty((B, R), dtype=torch.int32, device=dev)
    lst = torch.empty((B, lcap), dtype=torch.int64, device=dev)
    nkeys = torch.empty(B, dtype=torch.int32, device=dev)
    _launch("collapse_rows", "xt_collapse_rows", ids.data_ptr(),
            sums.data_ptr(), eligible.data_ptr(), B, R, col["hi"].data_ptr(),
            col["lo"].data_ptr(), col["present"].data_ptr(), n, cmax,
            int(row_order), table[0].data_ptr(), cap, table[1].data_ptr(),
            table[2].data_ptr(), slot.data_ptr(), lst.data_ptr(), lcap,
            nkeys.data_ptr(), keep.data_ptr(), tie.data_ptr(), _stream())
    return keep, tie


def collapse_plan(B: int, R: int, n_keys: int) -> tuple:
    """collapse_rows' design for B queries of R rows over a column of
    n_keys distinct keys: (TS, G), the tiles' shared table of TS slots (a
    power of two, at least 16 and twice the keys) and G tile blocks a
    query (one a chunk of COLLAPSE_CHUNK rows, up to COLLAPSE_BLOCKS over
    the queries), or (0, 0), the global design, where the table would pass
    COLLAPSE_TABLE slots."""
    ts = 16
    while ts < 2 * n_keys:
        ts *= 2
    if ts > COLLAPSE_TABLE:
        return 0, 0
    cap = max(1, COLLAPSE_BLOCKS // max(B, 1))
    return ts, max(1, min(-(-R // COLLAPSE_CHUNK), cap))


_KEY_COUNTS: dict = {}


def _tensor_tag(t):
    """(the tensor whose storage t views, a key of t's place and contents
    there): a view (a shard of the mesh's stacked columns, made anew each
    call) shares its base's version counter."""
    base = t._base if t._base is not None else t
    return base, (id(base), base._version, t.storage_offset(),
                  tuple(t.shape), tuple(t.stride()))


def collapse_keys(col) -> int:
    """The distinct (hi, lo) keys of a value column's present rows: a
    bound on any query's keys, counted once a column (one torch.unique and
    a read back) and cached while its tensors live unchanged."""
    tags = [_tensor_tag(col[ch]) for ch in _COLLAPSE_CH]
    key = tuple(k for _b, k in tags)
    hit = _KEY_COUNTS.get(key)
    if hit is not None and all(r() is b for r, (b, _k) in zip(hit[0], tags)):
        return hit[1]
    hi, lo, present = (col[ch] for ch in _COLLAPSE_CH)
    packed = ((hi.long() << 32) | (lo.long() & 0xFFFFFFFF))[present]
    n = int(torch.unique(packed).numel())
    for k in [k for k, (refs, _n) in _KEY_COUNTS.items()
              if any(r() is None for r in refs)]:
        del _KEY_COUNTS[k]
    _KEY_COUNTS[key] = ([weakref.ref(b) for b, _k in tags], n)
    return n


def _collapse_rows_plain(ids, sums, eligible, col, cmax, row_order=False):
    """_collapse as the JAX package runs it: one stable sort by (solo
    flag, key hi, key lo or docid, -score) - with the docid (or the row
    index, row_order) as the last key, the order its rows enter in - then
    the rank within each run of equal keys, scattered back to the rows."""
    B, R = ids.shape
    dev = ids.device
    d = ids.clamp(max=col["hi"].shape[0] - 1).long()
    kh, kl, present = col["hi"][d], col["lo"][d], col["present"][d]
    grouped = present & eligible
    last = torch.arange(R, dtype=torch.int32, device=dev).expand(B, R) \
        if row_order else ids
    keys = [(~grouped).long(), _ikey(torch.where(grouped, kh, 0)),
            _ikey(torch.where(grouped, kl, ids)), _fkey(-sums), _ikey(last)]
    order = _lex_order(keys)
    og, o1, o2 = (torch.gather(x, 1, order) for x in keys[:3])
    head = torch.ones((B, R), dtype=torch.bool, device=dev)
    head[:, 1:] = (og[:, 1:] != og[:, :-1]) | (o1[:, 1:] != o1[:, :-1]) | \
        (o2[:, 1:] != o2[:, :-1])
    pos = torch.arange(R, device=dev).expand(B, R)
    start = torch.cummax(torch.where(head, pos, 0), 1)[0]
    keep_s = ((pos - start) < cmax) | (og > 0)
    tie_s = ((torch.cumsum(head.long(), 1) - 1) * cmax +
             (pos - start).clamp(max=cmax - 1)).to(torch.int32)
    keep = torch.zeros_like(eligible).scatter_(1, order, keep_s) & eligible
    tie = torch.zeros_like(ids).scatter_(1, order, tie_s)
    return keep, torch.where(grouped, tie, I32MAX)


# --------------------------------------------------------------------------
# K12: dense_rows
# --------------------------------------------------------------------------

def dense_rows(post, offsets, lens, tconst, scoring, bits, classes, deleted,
               spec, uniq=None):
    """The rows of the dense match-all path (executor.py _execute_dense
    1242-1280): one per (query, doc) over all ND+1 docs.

    post: (docids i32[P], wdf f32[P], doclen f32[P]); offsets / lens /
    bits i32[B,T], scoring f32[B,T], tconst f32[B,T] or f32[B,T,C];
    classes[t]: the rows of term t's slice, of which the first min(lens,
    classes[t]) count (a plan without terms has every lens 0); deleted
    bool[ND+1], the last doc the pad doc; spec and uniq (read at the doc)
    as score_slices takes them.
    -> ids i32[B,ND+1] (the row index), scores f32[B,ND+1] (the doc's
       weights added in term order; the pad doc 0), orbits i32[B,ND+1]
       (the OR of the group bits of the terms holding the doc), live
       bool[B,ND+1] (not deleted and not the pad doc, the same for every
       query: the base mask of the kernels that follow)."""
    B, T = offsets.shape
    classes = tuple(int(c) for c in classes)
    if len(classes) != T:
        raise ValueError(f"dense_rows: {T} terms, classes {classes}")
    for name, t, dt in (("offsets", offsets, torch.int32),
                        ("lens", lens, torch.int32),
                        ("bits", bits, torch.int32),
                        ("scoring", scoring, torch.float32)):
        _check(f"dense_rows.{name}", t, dt, (B, T))
    C = _constants("dense_rows.tconst", tconst, (B, T))
    uniq = _check_uniq("dense_rows", spec, uniq)
    for t, dt in zip(post, (torch.int32, torch.float32, torch.float32)):
        _check("dense_rows.postings", t, dt)
    _check("dense_rows.deleted", deleted, torch.bool)
    nd1 = deleted.shape[0]
    if uniq is not None and uniq.shape[0] != nd1:
        raise ValueError(f"dense_rows: uniq has {uniq.shape[0]} rows, not "
                         f"{nd1}")
    opt = [uniq] if uniq is not None else []
    if not _on_cuda("dense_rows", offsets, lens, tconst, scoring, bits,
                    deleted, *post, *opt):
        return _dense_rows_plain(post, offsets, lens, tconst, scoring, bits,
                                 classes, deleted, spec, uniq)
    dev = offsets.device
    ids = torch.empty((B, nd1), dtype=torch.int32, device=dev)
    scores = torch.empty((B, nd1), dtype=torch.float32, device=dev)
    orbits = torch.empty((B, nd1), dtype=torch.int32, device=dev)
    live = torch.empty((B, nd1), dtype=torch.bool, device=dev)
    _launch("dense_rows", "xt_dense_rows", post[0].data_ptr(),
            post[1].data_ptr(), post[2].data_ptr(), post[0].shape[0],
            offsets.data_ptr(), lens.data_ptr(), tconst.data_ptr(),
            scoring.data_ptr(), bits.data_ptr(),
            _ints(classes, dev).data_ptr(), B, T, deleted.data_ptr(), nd1,
            *_spec_args(spec, C, uniq), dense_per(B, nd1, classes),
            ids.data_ptr(), scores.data_ptr(), orbits.data_ptr(),
            live.data_ptr(), _stream())
    return ids, scores, orbits, live


def dense_per(B: int, nd1: int, classes) -> int:
    """dense_rows' run length: the doc tiles of DENSE_TILE docs a block
    walks with one binary search a term. Where some term's slice is long
    (a class past DENSE_SHORT), runs as long as B x runs within
    DENSE_BLOCKS (one wave) allows; else one tile a block, as a search in
    a short slice costs little and long runs of tiles write slower (browse
    M, whose slices are 128 rows; PERF.md section 6)."""
    if max(classes, default=0) <= DENSE_SHORT:
        return 1
    tiles = -(-nd1 // DENSE_TILE)
    return -(-tiles // max(1, DENSE_BLOCKS // B))


def _dense_rows_plain(post, offsets, lens, tconst, scoring, bits, classes,
                      deleted, spec, uniq=None):
    """_execute_dense's scatters: per term the slice's docids (the pad doc
    past lens) scatter the weight into the scores and the group bit into
    the masks; each term holds a doc once, so the adds of one doc follow
    term order."""
    B, T = offsets.shape
    dev = offsets.device
    nd1 = deleted.shape[0]
    n = post[0].shape[0]
    scores = torch.zeros((B, nd1), dtype=torch.float32, device=dev)
    orbits = torch.zeros((B, nd1), dtype=torch.int32, device=dev)
    for t in range(T):
        W = classes[t]
        start = offsets[:, t].long().clamp(max=n - W).clamp(min=0)
        idx = start[:, None] + torch.arange(W, device=dev)
        inl = torch.arange(W, device=dev)[None, :] < lens[:, t:t + 1]
        d = torch.where(inl, post[0][idx], nd1 - 1).long()
        # the doc's uniqterms (executor.py:1266-1269)
        u = uniq[d] if uniq is not None else None
        w = _scored(scheme_sumpart(spec, post[1][idx], post[2][idx],
                                   _tc(tconst, t), u), scoring[:, t:t + 1])
        scores.scatter_add_(1, d, torch.where(inl, w, 0.0))
        hit = torch.zeros_like(orbits).scatter_reduce_(
            1, d, inl.to(torch.int32), "amax")
        orbits |= hit * bits[:, t:t + 1]
    scores[:, nd1 - 1] = 0.0
    orbits[:, nd1 - 1] = 0
    live = ~deleted
    live[nd1 - 1] = False
    ids = torch.arange(nd1, dtype=torch.int32, device=dev)
    return (ids.expand(B, nd1).contiguous(), scores, orbits,
            live.expand(B, nd1).contiguous())


# --------------------------------------------------------------------------
# K13: merge_special
# --------------------------------------------------------------------------

def merge_special(ids, w, widths, bits, offsets, post_wdf, post_doclen,
                  max_specs, syn_groups, syn_tconst, spec, uniq=None, *,
                  n_docs):
    """The per-doc sums of a plan with OP_MAX or OP_SYNONYM (executor.py
    execute 746-756, 787-812), on merge_docs' rows: doc tiles with one
    shared slot a (doc, channel), each channel added in term order, or a
    binary-search join, as special_plan chooses.

    ids i32[B,R] / w f32[B,R]: score_slices' rows (no prefix block);
    widths per term; bits / offsets i32[B,T]; post_wdf / post_doclen
    f32[P]; max_specs: ExecConfig.max_specs (per spec its branch masks
    over group bits); syn_groups: ExecConfig.syn_groups (one mask each);
    syn_tconst f32[B,NS] or f32[B,NS,C], NS >= len(syn_groups) (None
    without synonyms); spec and uniq (read at the row's doc) as
    score_slices takes them; n_docs the segment's docid bound (its deleted
    flags' rows), as merge_docs takes it.
    -> sums f32[B,R], on every real row of a doc, 0 on SENTINEL rows: the
       doc's weights in term order without the terms of any branch mask;
       plus per max spec the maximum over its branches of the branch
       terms' weights, summed in term order; plus per synonym group, where
       the doc's summed wdf over the group's terms is > 0, sumpart(that
       sum, the doc's length or 1 where it is 0, syn_tconst[b, i])."""
    widths = tuple(int(x) for x in widths)
    B, R = ids.shape
    T = len(widths)
    max_specs = tuple(tuple(int(m) for m in br) for br in max_specs)
    syn_groups = tuple(int(m) for m in syn_groups)
    if len(max_specs) > MAX_SPECIAL or len(syn_groups) > MAX_SPECIAL or \
            any(len(br) > MAX_SPECIAL for br in max_specs):
        raise ValueError(f"merge_special: more than {MAX_SPECIAL} max "
                         "specs, branches or synonym groups")
    _check("merge_special.ids", ids, torch.int32, (B, sum(widths)))
    _check("merge_special.w", w, torch.float32, (B, R))
    _check("merge_special.bits", bits, torch.int32, (B, T))
    _check("merge_special.offsets", offsets, torch.int32, (B, T))
    _check("merge_special.post_wdf", post_wdf, torch.float32)
    _check("merge_special.post_doclen", post_doclen, torch.float32,
           post_wdf.shape)
    opt = []
    NS = C = 0
    uniq_used = None
    if syn_groups:
        if syn_tconst is None or syn_tconst.dim() not in (2, 3) or \
                syn_tconst.shape[1] < len(syn_groups):
            raise ValueError("merge_special: synonym groups need syn_tconst "
                             f"f32[B, >= {len(syn_groups)}(, C)]")
        NS = syn_tconst.shape[1]
        C = _constants("merge_special.syn_tconst", syn_tconst, (B, NS))
        opt.append(syn_tconst)
        uniq_used = _check_uniq("merge_special", spec, uniq)
        if uniq_used is not None:
            opt.append(uniq_used)
    if not _on_cuda("merge_special", ids, w, bits, offsets, post_wdf,
                    post_doclen, *opt):
        return _merge_special_plain(ids, w, widths, bits, offsets, post_wdf,
                                    post_doclen, max_specs, syn_groups,
                                    syn_tconst, spec, uniq_used)
    dev = ids.device
    table = [len(max_specs)]
    for br in max_specs:
        table += [len(br), *(_i32(m) for m in br)]
    table += [len(syn_groups), *(_i32(m) for m in syn_groups)]
    P = special_channels(max_specs, syn_groups)
    tiles, tile = special_plan(widths, n_docs, P)
    sums = torch.empty((B, R), dtype=torch.float32, device=dev)
    _launch("merge_special", "xt_merge_special", ids.data_ptr(),
            w.data_ptr(), _ints(widths, dev).data_ptr(),
            _ints(row_offsets(widths), dev).data_ptr(), B, T, R,
            bits.data_ptr(), offsets.data_ptr(), post_wdf.data_ptr(),
            post_doclen.data_ptr(), post_wdf.shape[0],
            _ints(tuple(table), dev).data_ptr(),
            _ptr(syn_tconst if syn_groups else None), NS,
            *_spec_args(spec, C, uniq_used), _nd1(uniq_used), P, tiles,
            tile, sums.data_ptr(), _stream())
    return sums


def special_channels(max_specs, syn_groups) -> int:
    """merge_special's sums a doc: the base, one a branch of each max
    spec, one a synonym group."""
    return 1 + sum(len(br) for br in max_specs) + len(syn_groups)


def special_tile(T: int, channels: int) -> int:
    """merge_special's doc tile for a plan of ``channels`` float slots a
    docid over T term blocks: the widest, from MERGE_TILE halved down to
    SPECIAL_MIN_TILE, whose 4 * channels * tile bytes and the terms' 32
    bytes fit merge_plan's 200 KB of shared memory; 0 where none fits or
    past SPECIAL_CHANNELS channels (the tiles' channel word)."""
    if T < 1 or not 1 <= channels <= SPECIAL_CHANNELS:
        return 0
    tile = MERGE_TILE
    while 4 * channels * tile + 32 * T + 8 > 200 * 1024:
        if tile <= SPECIAL_MIN_TILE:
            return 0
        tile //= 2
    return tile


def special_plan(widths, n_docs, channels) -> tuple:
    """merge_special's design for one query's term blocks: (tiles, tile),
    the number of doc tiles of ``tile`` docids (special_tile) over
    [0, n_docs), or (0, 0) for the probes, which take a plan whose slots
    do not fit. The costs are merge_plan's, the probes' search passes
    times the channels (the base, each branch and each synonym group
    search every term block), the tiles' row cost plus one add a
    channel. On the card (tools/synth_captures.py's S and X launches, B16,
    four blocks of W rows over a million docids) the rule took the faster
    design at each W: the probes at 1024 and 8192, the tiles at 65,536 and
    262,144, where merge_plan's own rule would still take the probes at
    65,536; the paths' launches (browse S and X, the schemes') take the
    tiles."""
    T, R = len(widths), sum(widths)
    tile = special_tile(T, channels)
    if not tile:
        return 0, 0
    tiles = -(-int(n_docs) // tile)
    if tiles < MERGE_MIN_TILES:
        return 0, 0
    probe = channels * R * (T - 1) * sum(log2c(x) for x in widths) / T
    cost = (MERGE_ROW_COST + channels) * R + tiles * (
        MERGE_TILE_COST * tile / MERGE_TILE + MERGE_TERM_COST * T)
    return (tiles, tile) if cost < probe else (0, 0)


def _i32(m: int) -> int:
    """A group-bit mask as the int32 that holds its bits (bit 31 set:
    negative)."""
    m &= 0xFFFFFFFF
    return m - 2**32 if m >= 2**31 else m


def _merge_special_plain(ids, w, widths, bits, offsets, post_wdf,
                         post_doclen, max_specs, syn_groups, syn_tconst,
                         spec, uniq=None):
    B, R = ids.shape
    dev = ids.device
    ro = row_offsets(widths)
    n = post_wdf.shape[0]
    real = ids != SENTINEL
    wt, wdft, dl_parts = [], [], []
    for u, W in enumerate(widths):
        blk = ids[:, ro[u]:ro[u + 1]].contiguous()
        pos = torch.searchsorted(blk, ids).clamp(max=W - 1)
        hit = real & (torch.gather(blk, 1, pos) == ids)
        start = offsets[:, u].long().clamp(max=n - W).clamp(min=0)
        wt.append(torch.where(
            hit, torch.gather(w[:, ro[u]:ro[u + 1]], 1, pos), 0.0))
        wdft.append(torch.where(hit, post_wdf[start[:, None] + pos], 0.0))
        dl_parts.append(post_doclen[start[:, None] +
                                    torch.arange(W, device=dev)])
    excl = 0
    for br in max_specs:
        for m in br:
            excl |= m

    def masked_sum(parts, mask, invert=False):
        s = torch.zeros((B, R), dtype=torch.float32, device=dev)
        for u in range(len(widths)):
            on = (bits[:, u:u + 1] & _i32(mask)) != 0
            s = s + torch.where(on != invert, parts[u], 0.0)
        return s

    sums = masked_sum(wt, excl, invert=True)
    for br in max_specs:
        best = None
        for m in br:
            bs = masked_sum(wt, m)
            best = bs if best is None else torch.maximum(best, bs)
        if best is not None:
            sums = sums + best
    if syn_groups:
        dl = torch.cat(dl_parts, 1)
        dl = torch.where(dl > 0, dl, 1.0)
        # the doc's uniqterms at min(docid, ND) (executor.py:807-811)
        u = uniq[ids.clamp(max=uniq.shape[0] - 1)] if uniq is not None \
            else None
        for i, m in enumerate(syn_groups):
            ssum = masked_sum(wdft, m)
            sw = scheme_sumpart(spec, ssum, dl, _tc(syn_tconst, i), u)
            sums = sums + torch.where(ssum > 0, sw, 0.0)
    return torch.where(real, sums, 0.0)


# --------------------------------------------------------------------------
# K17b: agg_distinct (cardinality)
# --------------------------------------------------------------------------

def agg_distinct(ids, eligible, col):
    """The cardinality aggregation of one value column over a launch
    group's rows (ops/aggs.py compute_aggs 424-472).

    ids i32[B,R], eligible bool[B,R]; col: {hi, lo i32[n], present
    bool[n]}, read at min(id, n - 1) (the column's one key a doc: the
    smallest value of a multi-value doc), and, read on the card only, its
    codes i32[n] and code_hll i32[K] (models/segment.py value_arrays); a
    row counts where it is eligible and its doc has the value.
    -> n i32[B]: the distinct (hi, lo) keys among those rows, the key
       (INT32_MAX, INT32_MAX) left out as JAX leaves it out; regs
       i32[B,1024]: the HyperLogLog registers (p = 10) of _hash32 of the
       keys, 0 where no row fell."""
    B, R = ids.shape
    _check("agg_distinct.ids", ids, torch.int32, (B, R))
    _check("agg_distinct.eligible", eligible, torch.bool, (B, R))
    n = col["hi"].shape[0]
    for ch in _COLLAPSE_CH:
        _check(f"agg_distinct.{ch}", col[ch],
               torch.bool if ch == "present" else torch.int32, (n,))
    if not _on_cuda("agg_distinct", ids, eligible,
                    *(col[ch] for ch in _COLLAPSE_CH)):
        return _agg_distinct_plain(ids, eligible, col)
    if "codes" not in col or "code_hll" not in col:
        raise ValueError("agg_distinct: a value column without its codes "
                         "(codes, code_hll: models/segment.py value_arrays)")
    _check("agg_distinct.codes", col["codes"], torch.int32, (n,))
    _check("agg_distinct.code_hll", col["code_hll"], torch.int32)
    dev = ids.device
    W = distinct_words(col["code_hll"].shape[0])
    words = torch.empty(B * W, dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    regs = torch.empty((B, HLL_REGS), dtype=torch.int32, device=dev)
    G, G2 = distinct_plan(B, R, W)
    aligned = ids.data_ptr() % 16 == 0 and eligible.data_ptr() % 16 == 0
    _launch("agg_distinct", "xt_agg_distinct", ids.data_ptr(),
            eligible.data_ptr(), B, R, G, col["codes"].data_ptr(), n,
            _ptr(col["code_hll"]), W, G2, words.data_ptr(),
            count.data_ptr(), regs.data_ptr(), int(aligned), _stream())
    return count, regs


def distinct_words(K: int) -> int:
    """agg_distinct's 32-bit words a query of its set of K codes (at least
    one): its scratch is B of them, whatever the rows."""
    return max(1, -(-int(K) // 32))


def distinct_plan(B: int, R: int, W: int) -> tuple:
    """agg_distinct's blocks a query: G set the bits (at least DISTINCT_ROWS
    rows a block, B x G about DISTINCT_BLOCKS), G2 fold the W words (a
    thread a word, at most DISTINCT_FOLD blocks)."""
    G = max(1, min(-(-DISTINCT_BLOCKS // max(B, 1)),
                   -(-max(R, 1) // DISTINCT_ROWS)))
    return G, max(1, min(-(-W // 256), DISTINCT_FOLD))


def hash32(hi, lo):
    """_hash32 (ops/aggs.py 40-49) of int32 tensors: murmur3 fmix32 of
    hi ^ lo * 0x9E3779B9 in uint32 arithmetic, as int64 in [0, 2**32)."""
    M = 0xFFFFFFFF
    h = (hi.long() & M) ^ (((lo.long() & M) * 0x9E3779B9) & M)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M
    return h ^ (h >> 16)


def _agg_distinct_plain(ids, eligible, col):
    B, R = ids.shape
    d = ids.clamp(max=col["hi"].shape[0] - 1).long()
    m = eligible & col["present"][d]
    kh, kl = col["hi"][d], col["lo"][d]
    h = torch.where(m, kh, I32MAX)
    lo = torch.where(m, kl, I32MAX)
    key = torch.sort(h.long() * 2**32 + _ikey(lo), dim=1)[0]
    head = torch.ones_like(m)
    head[:, 1:] = key[:, 1:] != key[:, :-1]
    valid = key != I32MAX * 2**32 + I32MAX + 2**31
    exact = (head & valid).sum(1, dtype=torch.int32)
    hh = hash32(kh, kl)
    idx = hh >> 22
    rest = (hh << 10) & 0xFFFFFFFF
    # clz of a uint32: 32 - bit length; log2 of an int64 < 2**32 is exact
    # in float64
    clz = 31 - torch.floor(torch.log2(rest.clamp(min=1).double())).long()
    rho = torch.where(rest == 0, 23, clz + 1)
    rho = torch.where(m, rho, 0).to(torch.int32)
    regs = torch.zeros((B, HLL_REGS), dtype=torch.int32, device=ids.device)
    regs.scatter_reduce_(1, idx, rho, "amax")
    return exact, regs


# --------------------------------------------------------------------------
# K20: kmeans
# --------------------------------------------------------------------------

def kmeans(X, C, update: bool = True):
    """One step of spherical k-means (ops/cluster.py kmeans_cosine's loop
    body, K20): each row's label, the first centroid of the greatest dot
    product, and with ``update`` the new centroids: the sum of each
    label's rows, divided by its norm where that exceeds 1e-6, else the
    old centroid. A kmeans_loop of one step (or of the assignment alone).

    X f32[n,V] (L2-normalised rows), C f32[k,V]. -> (labels i32[n], new C
    f32[k,V] or None)."""
    if update:
        return kmeans_loop(X, C, 1, assign_last=False)
    return kmeans_loop(X, C, 0)[0], None


def kmeans_loop(X, C0, iters: int, assign_last: bool = True,
                history: bool = False):
    """A kmeans_cosine call (ops/cluster.py, K20) in one launch: ``iters``
    steps from the centroids C0, then with ``assign_last`` the assignment
    to the last centroids alone. Each step is ``kmeans``'s: the labels
    under its input centroids, then the renormalised sums.

    X f32[n,V] (L2-normalised rows), C0 f32[k,V], 1 <= k <= n.
    -> (labels i32[n]: the last assignment's, or the last step's without
    it; C f32[k,V], the centroids after the last step) and with
    ``history`` a third item (labels i32[iters,n], C f32[iters,k,V]): each
    step's labels and input centroids."""
    n, V = X.shape
    k = C0.shape[0]
    iters = int(iters)
    _check("kmeans.X", X, torch.float32, (n, V))
    _check("kmeans.C", C0, torch.float32, (k, V))
    if k < 1 or k > n:
        raise ValueError(f"kmeans: {k} centroids for {n} rows")
    if iters < 0 or (iters == 0 and not assign_last):
        raise ValueError(f"kmeans: {iters} steps and no last assignment")
    if not _on_cuda("kmeans", X, C0):
        return kmeans_loop_plain(X, C0, iters, assign_last, history)
    dev = X.device
    S, RC, glob, G = kmeans_plan(n, V, k)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    C = torch.empty((k, V), dtype=torch.float32, device=dev)
    work = torch.empty(_km_words(V, k, 1, RC), dtype=torch.float32,
                       device=dev) if glob else None
    # G clusters: each one's sums by the step's parity, a barrier counter
    # a column slice
    part = torch.empty(2 * G * k * V, dtype=torch.float32, device=dev) \
        if G > 1 else None
    bar = torch.zeros(S, dtype=torch.int32, device=dev) if G > 1 else None
    hist = (torch.empty((iters, n), dtype=torch.int32, device=dev),
            torch.empty((iters, k, V), dtype=torch.float32, device=dev)) \
        if history else (None, None)
    _launch("kmeans", "xt_kmeans_loop", X.data_ptr(), C0.data_ptr(), n, V,
            k, iters, int(bool(assign_last)), S, RC, G, _ptr(work),
            _ptr(part), _ptr(bar), labels.data_ptr(), C.data_ptr(),
            _ptr(hist[0]), _ptr(hist[1]), _stream())
    return (labels, C, hist) if history else (labels, C)


def _km_words(V: int, k: int, S: int, RC: int) -> int:
    """csrc/kmeans.cu km_layout's total: a block's buffers in 4-byte
    words (C and sums slices, the staged X chunk, the partials, the
    reduced sums or the warps' places, the chunk's labels, its rows by
    label and each warp's counts, each label's count and start, norms)."""
    def r4(x):
        return (x + 3) // 4 * 4

    w = -(-V // S)
    kp = r4(k)
    RCp = RC if RC % 8 else RC + 4
    return (r4(w * kp) + r4(w * RCp) + r4(kp * w) +
            r4(max(RC * kp, 4096)) + r4(max(-(-RC // S) * kp, 8 * kp)) +
            2 * RC + 8 * kp + r4(2 * kp) + 2 * kp)


def kmeans_plan(n: int, V: int, k: int) -> tuple:
    """kmeans_loop's launch: (S blocks a cluster, RC rows a chunk, global,
    G clusters) for csrc/kmeans.cu. RC from k: each of KMEANS_THREADS
    threads holds a 4-row x 4-centroid tile of a chunk's products, so a
    chunk is 4 * floor(256 / ceil(k / 4)) rows (at least 4, at most n
    rounded up to 4); S the blocks the products need, one a KMEANS_WORK
    products of a step (at most KMEANS_CLUSTER, each at least 32
    columns). Where a block's buffers do not fit KMEANS_SMEM, first more
    blocks, then fewer rows a chunk; where nothing fits (k * V large), one
    block with its buffers in a device workspace (global True). G
    clusters split the rows where one would take more than one chunk a
    step (and restage its rows every step on S SMs): a cluster a chunk, at
    most KMEANS_GRID and KMEANS_SMS blocks in all (the kernel cuts G to
    the clusters the card holds at once)."""
    ncg = -(-k // 4)
    RC0 = min(4 * max(1, KMEANS_THREADS // ncg), -(-n // 4) * 4)
    cap = max(1, min(KMEANS_CLUSTER, V // 32))
    S0 = max(1, min(cap, -(-n * k * V // KMEANS_WORK)))
    for S in range(S0, max(cap, S0) + 1):
        RC = RC0
        while True:
            if 4 * _km_words(V, k, S, RC) <= KMEANS_SMEM:
                G = min(-(-n // RC), KMEANS_GRID, max(1, KMEANS_SMS // S))
                return S, RC, False, G
            if RC <= 4:
                break
            RC = max(4, RC // 8 * 4)
    return 1, RC0, True, 1


def kmeans_loop_plain(X, C0, iters: int, assign_last: bool = True,
                      history: bool = False):
    """kmeans_loop in PyTorch ops: kmeans_step_plain ``iters`` times, then
    the assignment alone."""
    n, V = X.shape
    C, hl, hc = C0, [], []
    labels = None
    for _ in range(iters):
        labels, new_c = kmeans_step_plain(X, C)
        hl.append(labels)
        hc.append(C)
        C = new_c
    if assign_last:
        labels, _ = kmeans_step_plain(X, C, update=False)
    C = C.clone() if iters == 0 else C
    if not history:
        return labels, C
    k = C0.shape[0]
    hist = (torch.stack(hl) if hl else torch.empty(
                (0, n), dtype=torch.int32, device=X.device),
            torch.stack(hc) if hc else torch.empty(
                (0, k, V), dtype=torch.float32, device=X.device))
    return labels, C, hist


def kmeans_step_plain(X, C, update: bool = True):
    """kmeans in PyTorch ops, JAX's expressions in its order."""
    k = C.shape[0]
    sims = X @ C.T
    labels = sims.argmax(dim=1).to(torch.int32)   # the first maximum
    if not update:
        return labels, None
    onehot = (labels[:, None] == torch.arange(k, device=X.device)[None, :]
              ).to(torch.float32)
    new_c = onehot.T @ X
    norms = torch.linalg.norm(new_c, dim=1, keepdim=True)
    new_c = torch.where(norms > 1e-6, new_c / norms.clamp(min=1e-6), C)
    return labels, new_c


# --------------------------------------------------------------------------
# K19: shard_merge, shard_reduce
# --------------------------------------------------------------------------

def _wrap32(x):
    """int64 -> int32 as jnp's int32 arithmetic wraps."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def shard_merge(docids, scores, orderkey=None, sort_keys=None):
    """The mesh merge of make_sharded_step (parallel/sharded.py 394-441):
    per query the first k of the S shards' top-k lists in lax.sort's
    order of the gathered [Q, S*k].

    docids i32[S,Q,k], scores f32[S,Q,k]: each shard's execute output;
    orderkey i32[S,n] (a ShardedDatabase generation's insertion-order keys,
    read at each shard's docid) or None (the tie key is the striped
    docid); sort_keys i32[S,Q,k,NU]: each shard's emitted sort key words
    (a value-ordered merge) or None (by score desc).
    -> the global docids i32[Q,k] (did * S + shard; INT32_MAX where the
    score is -inf), scores f32[Q,k]."""
    S, Q, k = docids.shape
    _check("shard_merge.docids", docids, torch.int32, (S, Q, k))
    _check("shard_merge.scores", scores, torch.float32, (S, Q, k))
    opt = []
    if orderkey is not None:
        _check("shard_merge.orderkey", orderkey, torch.int32)
        if orderkey.dim() != 2 or orderkey.shape[0] != S or \
                orderkey.shape[1] < 1:
            raise ValueError("shard_merge: orderkey must be [S, n >= 1]")
        opt.append(orderkey)
    nu = 0
    if sort_keys is not None:
        nu = sort_keys.shape[-1]
        _check("shard_merge.sort_keys", sort_keys, torch.int32,
               (S, Q, k, nu))
        opt.append(sort_keys)
    if not _on_cuda("shard_merge", docids, scores, *opt):
        return _shard_merge_plain(docids, scores, orderkey, sort_keys)
    dev = docids.device
    scratch = _merge_scratch(S * k, Q, (nu if sort_keys is not None else 1)
                             + 2, dev)
    out_d = torch.empty((Q, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    _launch("shard_merge", "xt_shard_merge", docids.data_ptr(),
            scores.data_ptr(), _ptr(orderkey),
            orderkey.shape[1] if orderkey is not None else 0,
            _ptr(sort_keys), nu, S, Q, k, 1, _ptr(scratch),
            out_d.data_ptr(), out_s.data_ptr(), _stream())
    return out_d, out_s


def merge_plane_bytes(M: int, nw: int) -> int:
    """The bytes of shard_merge.cu's planes of a query's M candidates with
    nw key words: ceil(nw / 2) planes of 64-bit word pairs, the gdoc and
    score planes (csrc sm_plane_bytes)."""
    return M * (8 * ((nw + 1) // 2) + 8)


def _merge_scratch(M: int, Q: int, nw: int, dev):
    """shard_merge.cu's device scratch: each query's planes where they pass
    SHARD_MERGE_SMEM, else None (they are staged in shared memory)."""
    n = merge_plane_bytes(M, nw)
    if n <= SHARD_MERGE_SMEM:
        return None
    return torch.empty(Q * n // 8, dtype=torch.int64, device=dev)


def _shard_merge_plain(docids, scores, orderkey=None, sort_keys=None,
                       stripe=True):
    S, Q, k = docids.shape
    dev = docids.device
    shard = torch.arange(S, device=dev).view(S, 1, 1)
    invalid = torch.isinf(scores) & (scores < 0)
    gdoc = torch.where(invalid, I32MAX, _wrap32(docids.long() * S + shard)
                       if stripe else docids)
    if orderkey is not None:
        n = orderkey.shape[1]
        okey = torch.gather(orderkey, 1, docids.clamp(0, n - 1).long().view(
            S, Q * k)).view(S, Q, k)
        okey = torch.where(invalid, I32MAX, okey)
    else:
        okey = gdoc

    def gather(x):   # all_gather(tiled=True, axis=1): [S,Q,k] -> [Q, S*k]
        return x.permute(1, 0, *range(2, x.dim())).reshape(Q, S * k,
                                                           *x.shape[3:])
    if sort_keys is not None:
        kw = gather(sort_keys).long() & 0xFFFFFFFF
        keys = [kw[:, :, u] for u in range(kw.shape[2])]
    else:
        keys = [_fkey(-gather(scores))]
    keys.append(_ikey(gather(okey)))
    order = _lex_order(keys)[:, :k]   # stable: ties keep gathered order
    return (torch.gather(gather(gdoc), 1, order),
            torch.gather(gather(scores), 1, order))


REDUCE_MODES = {"sum": 0, "min": 1, "max": 2}


def shard_reduce(x, rule: str):
    """psum / pmin / pmax over the shard axis (make_sharded_step's counts
    and pack_agg_parts' vectors, sharded.py:430-445): x [S, ...] int32
    (counts; "sum" only) or float32, folded in shard order; a float min /
    max is NaN where either side is; a NaN is written as 0x7fc00000.
    -> x[0]'s shape."""
    if rule not in REDUCE_MODES or (x.dtype == torch.int32 and rule != "sum"):
        raise ValueError(f"shard_reduce: rule {rule!r} over {x.dtype}")
    if x.dtype not in (torch.int32, torch.float32) or not x.is_contiguous() \
            or x.dim() < 1 or x.shape[0] < 1:
        raise ValueError(f"shard_reduce: want contiguous int32 / float32 "
                         f"[S, ...], got {x.dtype} {tuple(x.shape)}")
    if not _on_cuda("shard_reduce", x):
        return _shard_reduce_plain(x, rule)
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    mode = 3 if x.dtype == torch.int32 else REDUCE_MODES[rule]
    _launch("shard_reduce", "xt_shard_reduce", x.data_ptr(), x.shape[0],
            out.numel(), mode, out.data_ptr(), _stream())
    return out


def _shard_reduce_plain(x, rule):
    acc = x[0].clone()
    for s in range(1, x.shape[0]):
        v = x[s]
        if rule == "sum":
            acc = _wrap32(acc.long() + v.long()) \
                if x.dtype == torch.int32 else acc + v
            continue
        pick = v < acc if rule == "min" else v > acc
        acc = torch.where(acc.isnan() | v.isnan(),
                          torch.full_like(acc, float("nan")),
                          torch.where(pick, v, acc))
    if acc.dtype == torch.float32:   # one NaN, whatever its payload
        acc = torch.where(acc.isnan(), torch.full_like(acc, float("nan")),
                          acc)
    return acc


# --------------------------------------------------------------------------
# K21: chunk_merge, semijoin_rows
# --------------------------------------------------------------------------

def chunk_merge(docids, scores):
    """The finalists' ranking of docid-chunked execution (executor.py
    _execute_chunked 1058-1063): per query the first k of its n_chunks
    chunks' top-k lists in the order of lax.sort((-v, d, v), num_keys=2)
    over the chunk-major [n_chunks * k] finalists - shard_merge.cu's
    relevance mode with the docid as its tie key and no striping.

    docids i32[NC,Q,k], scores f32[NC,Q,k] (each chunk's topk_rows: a
    score of -inf comes with SENTINEL). -> docids i32[Q,k] (SENTINEL where
    the score is -inf), scores f32[Q,k]."""
    NC, Q, k = docids.shape
    _check("chunk_merge.docids", docids, torch.int32, (NC, Q, k))
    _check("chunk_merge.scores", scores, torch.float32, (NC, Q, k))
    if not _on_cuda("chunk_merge", docids, scores):
        return _shard_merge_plain(docids, scores, stripe=False)
    dev = docids.device
    scratch = _merge_scratch(NC * k, Q, 3, dev)
    out_d = torch.empty((Q, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    _launch("chunk_merge", "xt_shard_merge", docids.data_ptr(),
            scores.data_ptr(), 0, 0, 0, 0, NC, Q, k, 0, _ptr(scratch),
            out_d.data_ptr(), out_s.data_ptr(), _stream())
    return out_d, out_s


def semijoin_rows(post, offsets, lens, tconst, scoring, bits, classes,
                  drive: int, deleted, spec, uniq=None):
    """The candidate rows of a semijoin plan (executor.py _execute_semijoin
    1172-1234): the drive term's S = classes[drive] postings, every other
    term probed by JAX's bit_length(classes[u])-round binary search of its
    block, its weight from the drive row's doclen and uniqterms.

    post: (docids i32[P], wdf f32[P], doclen f32[P]); offsets / lens
    i32[B,T], scoring f32[B,T], tconst f32[B,T] or f32[B,T,C]; bits
    i32[B,T] (the plan's group_bits) or None; deleted bool[ND+1] or None;
    spec / uniq as score_slices takes them.
    -> ids i32[B,S] (SENTINEL past the drive term's length), sums f32[B,S]
       (the drive term's weight, then each other term's in ascending
       order), orbits i32[B,S] (None without bits), first bool[B,S] (real
       and not deleted), count i32[B] (first rows a query)."""
    B, T = offsets.shape
    classes = tuple(int(c) for c in classes)
    if len(classes) != T or not 0 <= drive < T:
        raise ValueError(f"semijoin_rows: {T} terms, classes {classes}, "
                         f"drive {drive}")
    S = classes[drive]
    for name, t, dt in (("offsets", offsets, torch.int32),
                        ("lens", lens, torch.int32),
                        ("scoring", scoring, torch.float32)):
        _check(f"semijoin_rows.{name}", t, dt, (B, T))
    C = _constants("semijoin_rows.tconst", tconst, (B, T))
    uniq = _check_uniq("semijoin_rows", spec, uniq)
    for t, dt in zip(post, (torch.int32, torch.float32, torch.float32)):
        _check("semijoin_rows.postings", t, dt)
    opt = [x for x in (bits, deleted, uniq) if x is not None]
    if bits is not None:
        _check("semijoin_rows.bits", bits, torch.int32, (B, T))
    if deleted is not None:
        _check("semijoin_rows.deleted", deleted, torch.bool)
    if not _on_cuda("semijoin_rows", offsets, lens, tconst, scoring, *post,
                    *opt):
        return _semijoin_rows_plain(post, offsets, lens, tconst, scoring,
                                    bits, classes, drive, deleted, spec, uniq)
    dev = offsets.device
    ids = torch.empty((B, S), dtype=torch.int32, device=dev)
    sums = torch.empty((B, S), dtype=torch.float32, device=dev)
    orbits = torch.empty((B, S), dtype=torch.int32, device=dev) \
        if bits is not None else None
    first = torch.empty((B, S), dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    _launch("semijoin_rows", "xt_semijoin_rows", post[0].data_ptr(),
            post[1].data_ptr(), post[2].data_ptr(), post[0].shape[0],
            offsets.data_ptr(), lens.data_ptr(), tconst.data_ptr(),
            scoring.data_ptr(), _ptr(bits), _ints(classes, dev).data_ptr(),
            B, T, drive, S, *_spec_args(spec, C, uniq), _nd1(uniq),
            _ptr(deleted), deleted.shape[0] if deleted is not None else 0,
            ids.data_ptr(), sums.data_ptr(), _ptr(orbits), first.data_ptr(),
            count.data_ptr(), _stream())
    return ids, sums, orbits, first, count


def _semijoin_rows_plain(post, offsets, lens, tconst, scoring, bits, classes,
                         drive, deleted, spec, uniq=None):
    B, T = offsets.shape
    dev = offsets.device
    S = classes[drive]
    n = post[0].shape[0]
    start = offsets[:, drive].long().clamp(max=n - S).clamp(min=0)
    idx = start[:, None] + torch.arange(S, device=dev)
    inl = torch.arange(S, device=dev)[None, :] < lens[:, drive:drive + 1]
    d = torch.where(inl, post[0][idx], SENTINEL)
    real = d != SENTINEL
    dl = post[2][idx]
    u = uniq[d.clamp(max=uniq.shape[0] - 1)] if uniq is not None else None
    w = _scored(scheme_sumpart(spec, post[1][idx], dl, _tc(tconst, drive),
                               u), scoring[:, drive:drive + 1])
    sums = torch.where(real, w, 0.0)
    orbits = torch.where(real, bits[:, drive:drive + 1], 0) \
        if bits is not None else None
    for t in range(T):
        if t == drive:
            continue
        base = offsets[:, t:t + 1].long()
        nn = lens[:, t:t + 1].long()
        nm1 = (nn - 1).clamp(min=0)
        lo = torch.zeros((B, S), dtype=torch.long, device=dev)
        hi = nn.expand(B, S)
        for _ in range(max(classes[t].bit_length() - 1, 1) + 1):
            mid = (lo + hi) // 2
            v = post[0][(base + torch.minimum(mid, nm1)).clamp(0, n - 1)]
            right = v < d
            lo = torch.where(right, mid + 1, lo)
            hi = torch.where(right, hi, mid)
        p = (base + torch.minimum(lo, nm1)).clamp(0, n - 1)
        hit = real & (lo < nn) & (post[0][p] == d)
        wu = _scored(scheme_sumpart(spec, post[1][p], dl, _tc(tconst, t), u),
                     scoring[:, t:t + 1])
        sums = sums + torch.where(hit, wu, 0.0)
        if bits is not None:
            orbits = orbits | torch.where(hit, bits[:, t:t + 1], 0)
    first = real
    if deleted is not None:
        first = first & ~deleted[d.clamp(max=deleted.shape[0] - 1).long()]
    return d, sums, orbits, first, first.sum(1, dtype=torch.int32)
