"""The port's device kernels: ctypes-bound CUDA launchers, their plain
PyTorch versions, and launch counters.

Nineteen kernels carry search (sources in ``../csrc``; each file's
header names the TPU function it replaces, what bounds it on the H100 and
what its design does about that):

  score_slices    K1     per-(query, term) posting slice + the scheme's
                  +K18   weight (BM25 or any of the other 15 schemes)
  merge_docs      K2+K3  per-doc sums and OR of group bits by binary-search
                  +K6    join; owner & not deleted & boolean tree; count
  topk_rows       K4     exact top-k by (score desc, docid asc)
  prefix_certify  K5     exact rescore of prefix candidates + certificate
  filter_leaves   K7+K6  value-range filter leaves, then the boolean tree
  sort_topk       K8     top-k in multi-key sort order (value, score, dist,
                         geodist, strmetric, docid), docid tiebreak
  compact_rows    K11    stream compaction of the masked rows to a cap
  fullwidth_topk  K9     sort-free top-k of one sort key at full width,
                         with the exactness certificate
  agg_metrics     K17a   count, masked n / sum / sum of squares / min /
                         max of value columns
  agg_buckets     K17a   terms / missing bucket counts with per-bucket
                         metric sub-aggregations
  phrase_leaves   K14    PHRASE / NEAR verdicts of the first cand_cap
                  +K15   candidates of each phrase leaf, found by binary
                         search (wrapper and plain version: ops/phrase.py)
  geo_leaves      K16    the exact HTM range test of each geo leaf, one
                  +K15   bit a leaf, its two rank counts binary searches
                         over the query's cover (rank_count's)

  collapse_rows   K10    the survivors of a collapse (per key the best
                         min(collapse_max, 8) rows by score) and each
                         row's tie rank, which topk_rows then orders by
  dense_rows      K12    the dense match-all path's rows, one per (query,
                         doc): scores, group bits and the live mask by
                         binary search in every term's postings
  merge_special   K13    the per-doc sums of OP_MAX (best branch) and
                         OP_SYNONYM (summed wdf scored once) plans
  agg_distinct    K17b   cardinality: the exact distinct count of value
                         keys and 1024 HyperLogLog registers (geo_stats,
                         K17b's other half, is two columns of agg_metrics)

  agg_buckets     K17c   (the same kernel) the single-code bucket kinds
                         that read plan arrays: histogram, each level of a
                         nested chain, geo_trixels, the filter bucket;
                         and each row's bucket code for agg_hist
  agg_ranges      K17c   range, geodist_range, key_range and geo_ip: the
                         ranges a row lies in (several at once), their
                         counts and metric subs
  agg_hist        K17c   the fixed-grid order-statistic histograms of
                         median, mode, percentiles and median / mode subs
  agg_filter      K17c   the filter bucket's rows: each docid looked up in
                         each filter term's posting window

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
from pathlib import Path

import torch

from xapiand_tpu_torch.models.weights import (SCHEME_PARAMS, SchemeSpec,
                                              scheme_sumpart)

SENTINEL = 2**31 - 1
I32MAX = 2**31 - 1
MAX_PREFIX_ROWS = 16384   # score_slices sorts a prefix block in 128 KB smem
MAX_TOPK = 256            # topk_rows per-thread lists; prefix_certify block
MAX_SORT_TOPK = 64        # sort_topk per-thread lists
MAX_SORT_KEYS = 3         # sort_topk keys of <= 8 words (row index included)
MAX_FILTERS = 32          # filter_leaves keeps the leaf results in one word
MAX_TREE_DEPTH = 32       # the tree program's bit stack is one register
FULLWIDTH_WINDOW = 64     # K9's tie window (executor.py:428)
MAX_FULLWIDTH_KK = 128    # fullwidth_topk per-thread lists (k + window)
MAX_AGG_METRICS = 8       # agg_metrics per-thread partials per launch
MAX_AGG_BUCKETS = 4096    # agg_buckets / agg_ranges shared-memory histogram
MAX_HIST_BINS = 2048      # agg_hist's shared histogram (ORDER_STAT_BINS)
SPLIT_BLOCKS = 528        # split-row kernels: B x G ~ 4 blocks an SM
MAX_PHRASES = 32          # phrase_leaves: the verdicts of a row, one word
MAX_PHRASE_TERMS = 16     # phrase_leaves: per-thread position-list table
MAX_CAND_CAP = 4096       # query/plan.py DEFAULT_CAND_CAP
MAX_PMAX = 128            # query/plan.py DEFAULT_PMAX (the positions guard)
MAX_GEO = 32              # geo_leaves: the verdicts of a row, one word
MAX_GEO_QR = 1024         # query/plan.py QR_BUCKETS: the cover in 8 KB smem
MAX_GEO_RMAX = 256        # query/plan.py's RMAX cap
MAX_COLLAPSE = 8          # _collapse keeps min(collapse_max, 8) rows a key
MAX_COLLAPSE_ROWS = 2**28  # collapse_rows: slots of the key table fit int32
MAX_SPECIAL = 32          # merge_special: max specs / branches / synonyms
HLL_REGS = 1024           # ops/aggs.py _HLL_M (p = 10)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("common.cuh", "score_slices.cu", "merge_docs.cu", "topk_rows.cu",
           "prefix_certify.cu", "compact_rows.cu", "filter_leaves.cu",
           "sort_topk.cu", "fullwidth_topk.cu", "agg_metrics.cu",
           "agg_buckets.cu", "phrase_leaves.cu", "geo_leaves.cu",
           "collapse_rows.cu", "dense_rows.cu", "merge_special.cu",
           "agg_distinct.cu", "agg_ranges.cu", "agg_hist.cu",
           "agg_filter.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

launches = {"score_slices": 0, "merge_docs": 0, "topk_rows": 0,
            "prefix_certify": 0, "compact_rows": 0, "filter_leaves": 0,
            "sort_topk": 0, "fullwidth_topk": 0, "agg_metrics": 0,
            "agg_buckets": 0, "phrase_leaves": 0, "geo_leaves": 0,
            "collapse_rows": 0, "dense_rows": 0, "merge_special": 0,
            "agg_distinct": 0, "agg_ranges": 0, "agg_hist": 0,
            "agg_filter": 0}
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
                        _P, _P, _P, _I, _I, _I, _I, *_SPEC, _I, _P, _P, _P,
                        _P],
    "xt_merge_docs": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _LL, _P, _I, _P,
                      _P, _P, _P, _P],
    "xt_topk_rows": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "xt_prefix_certify": [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I,
                          _P, _P, _I, _I, *_SPEC, _I, _P, _P, _P, _P],
    "xt_compact_rows": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "xt_filter_leaves": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P,
                         _P, _P, _P],
    "xt_sort_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P],
    "xt_fullwidth_topk": [_P, _P, _P, _I, _LL, _I, _I, _I, _I, _P, _P, _P,
                          _P, _P, _P, _P, _P],
    "xt_agg_metrics": [_P, _P, _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P],
    "xt_agg_buckets": [_P, _P, _I, _LL, _I, _I, _P, _P, _P, _LL, _LL, _P,
                       _P, _I, _I, _I, _P, _LL, _I, _I, _P, _P, _P, _P, _P,
                       _P],
    "xt_agg_ranges": [_P, _P, _I, _LL, _I, _I, _P, _I, _P, _P, _P, _P, _I,
                      _I, _I, _P, _P, _P, _P, _P, _P],
    "xt_agg_hist": [_P, _P, _I, _LL, _I, _P, _P, _LL, _P, _I, _P, _P, _I,
                    _I, _P, _P, _P],
    "xt_agg_filter": [_P, _P, _I, _LL, _P, _LL, _P, _I, _I, _P, _P],
    "xt_phrase_leaves": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _P, _P, _P],
    "xt_geo_leaves": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "xt_topk_rows_tie": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "xt_collapse_rows": [_P, _P, _P, _I, _I, _P, _P, _P, _LL, _I, _P, _LL,
                         _P, _P, _P, _P, _LL, _P, _P, _P, _P],
    "xt_dense_rows": [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                      _I, *_SPEC, _P, _P, _P, _P, _P],
    "xt_merge_special": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _LL,
                         _P, _P, _I, *_SPEC, _I, _P, _P],
    "xt_agg_distinct": [_P, _P, _I, _LL, _I, _P, _P, _P, _LL, _P, _LL, _P,
                        _P, _P],
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
    rc = getattr(lib(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError {rc}")
    launches[name] += 1


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _on_cuda(name: str, *tensors) -> bool:
    """True for all-CUDA inputs (launch), False for all-CPU (plain version);
    raises on mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {devs}")
    dev = devs.pop()
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
            "present": _ints((False,), device, torch.bool)}


# --------------------------------------------------------------------------
# K6: the boolean tree as a postfix program
# --------------------------------------------------------------------------

OP_G, OP_F, OP_ALL, OP_NONE, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_PH, \
    OP_GEO = range(10)
_LEAF_OPS = {"G": OP_G, "F": OP_F, "PH": OP_PH, "GEO": OP_GEO}


def tree_program(tree: tuple) -> tuple:
    """The static boolean tree (xapiand_tpu/ops/executor.py _eval_tree
    249-282) as postfix int32 instructions ``op | arg << 8`` for the
    kernels' bit-stack evaluator (csrc/common.cuh eval_tree). n-ary
    AND/FILTER/OR fold left; AND_MAYBE is its first child alone."""
    out: list = []

    def emit(node, depth):
        op = node[0]
        if depth > MAX_TREE_DEPTH:
            raise ValueError(f"boolean tree deeper than {MAX_TREE_DEPTH}")
        if op in _LEAF_OPS:
            out.append(_LEAF_OPS[op] | int(node[1]) << 8)
        elif op in ("ALL", "NONE"):
            out.append(OP_ALL if op == "ALL" else OP_NONE)
        elif op in ("AND", "FILTER", "OR"):
            emit(node[1], depth)
            for c in node[2:]:
                emit(c, depth + 1)
                out.append(OP_OR if op == "OR" else OP_AND)
        elif op in ("AND_NOT", "XOR"):
            emit(node[1], depth)
            emit(node[2], depth + 1)
            out.append(OP_ANDNOT if op == "AND_NOT" else OP_XOR)
        elif op == "AND_MAYBE":
            emit(node[1], depth)
        else:
            raise ValueError(f"tree op {op!r} has no kernel leaf")

    emit(tree, 1)
    return tuple(out)


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
                      else a ^ b if op == OP_XOR else a & ~b)
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
    if pw > MAX_PREFIX_ROWS:
        raise ValueError(f"score_slices: prefix width {pw} exceeds "
                         f"{MAX_PREFIX_ROWS} rows (one block's shared memory)")
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
    ib = imp if imp is not None else post
    _launch("score_slices", "xt_score_slices",
            post[0].data_ptr(), post[1].data_ptr(), post[2].data_ptr(),
            post[0].shape[0], ib[0].data_ptr(), ib[1].data_ptr(),
            ib[2].data_ptr(), ib[0].shape[0] if imp is not None else 0,
            offsets.data_ptr(), lens.data_ptr(), tconst.data_ptr(),
            scoring.data_ptr(), _ints(widths, dev).data_ptr(),
            _ints(tuple(int(p) for p in is_prefix), dev).data_ptr(),
            _ints(ro, dev).data_ptr(), B, T, R, smem,
            *_spec_args(spec, C, uniq), _nd1(uniq), ids.data_ptr(),
            w.data_ptr(), tail.data_ptr(), _stream())
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
        idx = start[:, None] + torch.arange(W, device=dev)
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
               want_orbits=False):
    """Per-doc score sums and OR of group bits without a sort (binary-
    search join over the docid-ascending term blocks of score_slices), and
    the K6 epilogue.

    bits i32[B,T] (the plan's group_bits; None: no bits), deleted bool[ND+1]
    (None: no deletes), prog a tree_program (None: no tree).
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
            count.data_ptr(), _ptr(orbits), _stream())
    return sums, mask, count, orbits


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
    compiled execute ranks it below every other row.
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
    if not 0 < k <= MAX_TOPK:
        raise ValueError(f"topk_rows: k={k} outside 1..{MAX_TOPK}")
    if not _on_cuda("topk_rows", scores, ids, owner, *opt):
        return _topk_rows_plain(scores, ids, owner, k, tie)
    dev = scores.device
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    if tie is not None:
        _launch("topk_rows", "xt_topk_rows_tie", scores.data_ptr(),
                ids.data_ptr(), owner.data_ptr(), tie.data_ptr(), B, R, k,
                out_d.data_ptr(), out_s.data_ptr(), _stream())
        return out_d, out_s
    _launch("topk_rows", "xt_topk_rows", scores.data_ptr(), ids.data_ptr(),
            owner.data_ptr(), B, R, k, out_d.data_ptr(), out_s.data_ptr(),
            _stream())
    return out_d, out_s


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

    values: the segment's value columns (arrays_pytree()["values"]); slots
    and vmax: per filter leaf (ExecConfig filter_slots / filter_vmax);
    fparams i32[B,F,4] (lo hi, lo lo, hi hi, hi lo per leaf; F may be 0);
    docids i32[B,C]; base bool[B,C] (owner & not deleted) or None (docid
    != SENTINEL: packed rows); orbits i32[B,C]; prog a tree_program;
    phbits i32[B,C] (phrase_leaves' verdict words, None without PH
    leaves); geobits i32[B,C] (geo_leaves' verdict words, None without
    GEO leaves).
    -> eligible bool[B,C], count i32[B]."""
    B, C = docids.shape
    F = len(slots)
    if F > MAX_FILTERS:
        raise ValueError(f"filter_leaves: {F} filters (max {MAX_FILTERS})")
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
    for col, vm in zip(cols, vmax):
        if col is None:
            table += [0] * 12
            continue
        table += [_ptr(col.get(ch)) for ch in _FILTER_CH]
        table += [col["hi"].shape[0],
                  col["mv_hi"].shape[0] if "mv_hi" in col else 0, vm]
    eligible = torch.empty((B, C), dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    _launch("filter_leaves", "xt_filter_leaves", docids.data_ptr(),
            _ptr(base), orbits.data_ptr(), fparams.data_ptr(),
            _ptr(_ints(tuple(table), dev, torch.int64) if table else None),
            B, F, C, _ints(prog, dev).data_ptr(), len(prog), _ptr(phbits),
            _ptr(geobits), eligible.data_ptr(), count.data_ptr(), _stream())
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
    flat_start, flat_end i32[GR]}; specs: ExecConfig.geo_specs (slot, QR,
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
        table += [_ptr(col[ch]) for ch in _GEO_CH]
        table += [col["doc_off"].shape[0], col["flat_start"].shape[0], QR,
                  RMAX, q.data_ptr()]
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
              targets=None, strtabs=None):
    """The first k rows of each query in multi-key order, docid tiebreak
    (executor.py _rank_and_topk 487-574).

    specs: ExecConfig.sort entries (kind, slot, desc[, nb]), or
    (("docid", None, False),) for an unweighted plan; ids i32[B,C], sums
    f32[B,C], eligible bool[B,C]; values: the segment's value columns;
    targets f32[B,S,2] (the plan's sort_targets; dist / geodist);
    strtabs {spec index: f32[B,nb]} (strmetric).
    -> docids i32[B,k] (SENTINEL for ineligible rows), scores f32[B,k]
    (-inf there)."""
    B, C = ids.shape
    S = len(specs)
    if not 0 < S <= MAX_SORT_KEYS:
        raise ValueError(f"sort_topk: {S} sort keys (1..{MAX_SORT_KEYS})")
    if not 0 < k <= MAX_SORT_TOPK:
        raise ValueError(f"sort_topk: k={k} outside 1..{MAX_SORT_TOPK}")
    _check("sort_topk.ids", ids, torch.int32, (B, C))
    _check("sort_topk.sums", sums, torch.float32, (B, C))
    _check("sort_topk.eligible", eligible, torch.bool, (B, C))
    strtabs = strtabs or {}
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
    if targets is not None:
        _check("sort_topk.targets", targets, torch.float32, (B, S, 2))
        opt.append(targets)
    cols = _sort_cols(specs, values, opt)
    if not _on_cuda("sort_topk", ids, sums, eligible, *opt):
        return _sort_topk_plain(specs, cols, ids, sums, eligible, k, targets,
                                strtabs)
    dev = ids.device
    spec_tab, tab = _sort_tables(specs, cols, strtabs, dev)
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    # key words: 2 per value spec, 1 per other, the docid, the row index
    n_words = sum(2 if s[0] == "value" else 1 for s in specs) + 2
    _launch("sort_topk", "xt_sort_topk", ids.data_ptr(), sums.data_ptr(),
            eligible.data_ptr(), B, C, k, S, n_words, spec_tab.data_ptr(),
            tab.data_ptr(), _ptr(targets), out_d.data_ptr(),
            out_s.data_ptr(), _stream())
    return out_d, out_s


def _sort_cols(specs, values, opt):
    """The value column of each spec (None for score / docid); appends the
    tensors the kernel reads to ``opt`` (for the device check)."""
    cols = [values.get(s[1]) if s[0] not in ("score", "docid") else None
            for s in specs]
    for col in cols:
        opt.extend(col[ch] for ch in _SORT_CH if col is not None and ch in col)
    return cols


def _sort_tables(specs, cols, strtabs, dev):
    """sort_topk's spec table (kind, desc, nb, 0 per spec) and column table
    (common.cuh ST_COLS int64 words per spec) on ``dev``."""
    spec_tab, table = [], []
    for si, (spec, col) in enumerate(zip(specs, cols)):
        spec_tab += [SORT_KINDS[spec[0]], int(bool(spec[2])),
                     int(spec[3]) if spec[0] == "strmetric" else 0, 0]
        table += [_ptr(col.get(ch)) if col is not None else 0
                  for ch in _SORT_CH]
        table += [_ptr(strtabs.get(si)),
                  col["hi"].shape[0] if col is not None else 0]
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


def _masked_key(si, spec, col, ids, sums, eligible, targets, strtabs):
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


def _sort_topk_plain(specs, cols, ids, sums, eligible, k, targets, strtabs):
    B, C = ids.shape
    keys = []
    for si, (spec, col) in enumerate(zip(specs, cols)):
        mk = _masked_key(si, spec, col, ids, sums, eligible, targets, strtabs)
        keys += [_ikey(x) for x in mk] if spec[0] in ("value", "docid") \
            else [_fkey(mk[0])]
    keys.append(_ikey(torch.where(eligible, ids, SENTINEL)))
    order = _lex_order(keys)[:, :k]
    dd = torch.gather(torch.where(eligible, ids, SENTINEL), 1, order)
    ss = torch.gather(torch.where(eligible, sums, float("-inf")), 1, order)
    if C < k:
        dd = torch.nn.functional.pad(dd, (0, k - C), value=SENTINEL)
        ss = torch.nn.functional.pad(ss, (0, k - C), value=float("-inf"))
    return dd, ss


def _split(B: int, R: int) -> int:
    """Blocks per query for the kernels that split a query's rows: enough
    for B x G to fill the card, each block at least 256 16-row groups."""
    return max(1, min(SPLIT_BLOCKS // max(B, 1), -(-R // 16) // 256))


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
    otherwise, which changes the result of uncertified queries only."""
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
    G = _split(B, R)
    nk = 4 if spec[0] == "value" else 3
    cand = torch.empty(B * G * kk * nk, dtype=torch.int32, device=dev)
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    cert = torch.empty(B, dtype=torch.bool, device=dev)
    _launch("fullwidth_topk", "xt_fullwidth_topk", ids.data_ptr(),
            sums.data_ptr(), eligible.data_ptr(), B, R, G, k, kk, nk,
            spec_tab.data_ptr(), tab.data_ptr(), _ptr(targets),
            cand.data_ptr(), out_d.data_ptr(), out_s.data_ptr(),
            cert.data_ptr(), _stream())
    return out_d, out_s, cert


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
    G = _split(B, R)
    table = _ints(tuple(x for f, p in cols
                        for x in (f.data_ptr(), p.data_ptr(), f.shape[0])),
                  dev, torch.int64) if cols else None
    part = torch.empty(max(B * G * M * 5, 1), dtype=torch.float32, device=dev)
    cpart = torch.empty(B * G, dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    out = torch.empty((5, M, B), dtype=torch.float32, device=dev)
    _launch("agg_metrics", "xt_agg_metrics", ids.data_ptr(),
            eligible.data_ptr(), B, R, G, M, _ptr(table), part.data_ptr(),
            cpart.data_ptr(), count.data_ptr(), out.data_ptr(), _stream())
    return (count,) + tuple(out)


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
                prev=None, size=None, want_codes=False, sub_clamp=0):
    """Per query the bucket counts of one single-code bucket aggregation of
    compute_aggs, and per metric sub-aggregation the per-bucket sufficient
    statistics of _sub_stats_bucketed (ops/aggs.py 107-155, without
    hist2: agg_hist). Every row is in at most one bucket; its code by mode:

      "terms"      codes = the slot's cats i32[n] (None: every row -1),
                   valid in [0, nb) (275-303; a nested terms level)
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
    src = _bucket_src("agg_buckets", mode, codes, B, R, nb)
    opt += [t for t in src if isinstance(t, torch.Tensor)]
    if prev is not None:
        _check("agg_buckets.prev", prev, torch.int32, (B, R))
        opt.append(prev)
    if not _on_cuda("agg_buckets", ids, eligible, *opt):
        return _agg_buckets_plain(ids, eligible, mode, codes, nb, subs,
                                  prev, size, want_codes, sub_clamp)
    dev = ids.device
    G = _split(B, R)
    table = _ints(tuple(x for c in subs
                        for x in ((c[0].data_ptr(), c[1].data_ptr(),
                                   c[0].shape[0]) if c is not None
                                  else (0, 0, 0))),
                  dev, torch.int64) if subs else None
    counts = torch.zeros((B, size), dtype=torch.int32, device=dev)
    out_codes = torch.full((B, R), -1, dtype=torch.int32, device=dev) \
        if want_codes else None
    part = torch.empty(max(B * G * S * size * 5, 1), dtype=torch.float32,
                       device=dev)
    out = torch.empty((S, 5, B, size), dtype=torch.float32, device=dev)
    p0, p1, p2, n0, n1, fpar, ipar, fstride, shift = src
    _launch("agg_buckets", "xt_agg_buckets", ids.data_ptr(),
            eligible.data_ptr(), B, R, G, BUCKET_MODES[mode], _ptr(p0),
            _ptr(p1), _ptr(p2), n0, n1, _ptr(fpar), _ptr(ipar), fstride, nb,
            shift, _ptr(prev), sub_clamp, size, S, _ptr(table),
            counts.data_ptr(), _ptr(out_codes), part.data_ptr(),
            out.data_ptr(), _stream())
    res = (counts, tuple(out.transpose(0, 1)) if S else None)
    return res + (out_codes,) if want_codes else res


def _bucket_src(name, mode, codes, B, R, nb) -> tuple:
    """(p0, p1, p2, n0, n1, fpar, ipar, fstride, shift) of a bucket mode,
    checked: the kernel's BucketSrc."""
    if mode == "terms":
        if codes is None:
            return None, None, None, 0, 0, None, None, 0, 0
        _check(f"{name}.cats", codes, torch.int32)
        return codes, None, None, codes.shape[0], 0, None, None, 0, 0
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


def _bucket_code_plain(mode, codes, ids, nb):
    """(code i64[B,R], valid bool[B,R]) of a bucket mode, eligibility not
    applied (ops/aggs.py _bucket_codes 163-186 and the top-level kinds)."""
    if mode == "mask":
        return torch.zeros_like(ids, dtype=torch.int64), codes
    if mode == "terms":
        if codes is None:
            c = torch.full_like(ids, -1)
        else:
            c = codes[ids.clamp(max=codes.shape[0] - 1).long()]
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
                       size=None, want_codes=False, sub_clamp=0):
    B, R = ids.shape
    dev = ids.device
    size = nb if size is None else size
    code, valid = _bucket_code_plain(mode, codes, ids, nb)
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
    # blocks of 256 rows: the subs kernel walks a block's rows with one
    # thread a (sub, range), so its parallelism is G x S x nb
    G = max(1, min(SPLIT_BLOCKS // max(B, 1), -(-R // 256)))
    ptrs = tuple(_ptr(col[ch]) if ch in chans else 0
                 for ch in ("fval", "fval2", "present", "hi", "lo",
                            "max_hi", "max_lo") + _MV_CH)
    nmv = col["mv_hi"].shape[0] if "mv_hi" in chans else 0
    # read by the C entry on the host, which builds the kernel's RangeSrc
    cols = torch.tensor(ptrs + (n, nmv), dtype=torch.int64)
    table = _ints(tuple(x for c in subs
                        for x in ((c[0].data_ptr(), c[1].data_ptr(),
                                   c[0].shape[0]) if c is not None
                                  else (0, 0, 0))),
                  dev, torch.int64) if subs else None
    counts = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    member = torch.empty((B, R, nb), dtype=torch.bool, device=dev) \
        if (S or want_member) else None
    part = torch.empty(max(B * G * S * nb * 5, 1), dtype=torch.float32,
                       device=dev)
    out = torch.empty((S, 5, B, nb), dtype=torch.float32, device=dev)
    _launch("agg_ranges", "xt_agg_ranges", ids.data_ptr(),
            eligible.data_ptr(), B, R, G, RANGE_MODES[mode],
            cols.data_ptr(), vmax if "mv_hi" in chans else 1,
            _ptr(bounds) if not keyed else 0, _ptr(bounds) if keyed else 0,
            _ptr(assign), _ptr(origin), nr, nb, S, _ptr(table),
            counts.data_ptr(), _ptr(member), part.data_ptr(),
            out.data_ptr(), _stream())
    res = (counts, tuple(out.transpose(0, 1)) if S else None)
    return res + (member,) if want_member else res


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
    counts = torch.zeros((B, nb, nbins), dtype=torch.int32, device=dev)
    out = torch.empty((B, nb, nbins), dtype=torch.float32, device=dev)
    _launch("agg_hist", "xt_agg_hist", ids.data_ptr(), eligible.data_ptr(),
            B, R, _split(B, R), fval.data_ptr(), present.data_ptr(),
            fval.shape[0], params.data_ptr(), mode, _ptr(codes),
            _ptr(member), nb, nbins, counts.data_ptr(), out.data_ptr(),
            _stream())
    return out


def value_bins(v, params, nbins: int):
    """clip(floor((v - lo) * scale), 0, nbins - 1) (ops/aggs.py 56) of
    v f32[B,R] under params f32[B,2] -> i64[B,R]."""
    f = torch.floor((v - params[:, 0:1]) * params[:, 1:2])
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
    mask = torch.empty((B, R), dtype=torch.bool, device=ids.device)
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


def collapse_rows(ids, sums, eligible, col, collapse_max: int):
    """The survivors of a collapse (executor.py _collapse 577-617) and each
    row's tie rank, without permuting the rows.

    ids i32[B,R], sums f32[B,R], eligible bool[B,R] (eligible rows hold
    distinct docids); col: the collapse slot's value column {hi, lo i32[n],
    present bool[n]} read at min(id, n - 1), or None for a slot the
    segment lacks; collapse_max >= 1, capped at MAX_COLLAPSE as JAX caps it.
    -> keep bool[B,R]: the row is eligible and either its doc has no value
       (solo) or fewer than the cap of the eligible rows with its (hi, lo)
       key precede it by (score desc, docid asc);
       tie i32[B,R]: the rank of the row's key among the query's distinct
       keys, (hi, lo) ascending, for an eligible row with a value;
       INT32_MAX otherwise. Among survivors of equal score the collapsed
       order is (tie, docid) ascending."""
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
        return _collapse_rows_plain(ids, sums, eligible, col, cmax)
    if R > MAX_COLLAPSE_ROWS:
        raise ValueError(f"collapse_rows: {R} rows a query exceed "
                         f"{MAX_COLLAPSE_ROWS} (the key table's slots are "
                         "int32)")
    dev = ids.device
    cap = _pow2_cover(2 * max(R, 1))
    lcap = _pow2_cover(max(R, 1))
    table = torch.empty((3, B, cap + 1), dtype=torch.int64, device=dev)
    slot = torch.empty((B, R), dtype=torch.int32, device=dev)
    lst = torch.empty((B, lcap), dtype=torch.int64, device=dev)
    nkeys = torch.empty(B, dtype=torch.int32, device=dev)
    keep = torch.empty((B, R), dtype=torch.bool, device=dev)
    tie = torch.empty((B, R), dtype=torch.int32, device=dev)
    _launch("collapse_rows", "xt_collapse_rows", ids.data_ptr(),
            sums.data_ptr(), eligible.data_ptr(), B, R, col["hi"].data_ptr(),
            col["lo"].data_ptr(), col["present"].data_ptr(), n, cmax,
            table[0].data_ptr(), cap, table[1].data_ptr(),
            table[2].data_ptr(), slot.data_ptr(), lst.data_ptr(), lcap,
            nkeys.data_ptr(), keep.data_ptr(), tie.data_ptr(), _stream())
    return keep, tie


def _collapse_rows_plain(ids, sums, eligible, col, cmax):
    """_collapse as the JAX package runs it: one stable sort by (solo
    flag, key hi, key lo or docid, -score) - with the docid as the last
    key, the order its docid-ascending rows enter in - then the rank within
    each run of equal keys, scattered back to the rows."""
    B, R = ids.shape
    dev = ids.device
    d = ids.clamp(max=col["hi"].shape[0] - 1).long()
    kh, kl, present = col["hi"][d], col["lo"][d], col["present"][d]
    grouped = present & eligible
    keys = [(~grouped).long(), _ikey(torch.where(grouped, kh, 0)),
            _ikey(torch.where(grouped, kl, ids)), _fkey(-sums), _ikey(ids)]
    order = _lex_order(keys)
    og, o1, o2 = (torch.gather(x, 1, order) for x in keys[:3])
    head = torch.ones((B, R), dtype=torch.bool, device=dev)
    head[:, 1:] = (og[:, 1:] != og[:, :-1]) | (o1[:, 1:] != o1[:, :-1]) | \
        (o2[:, 1:] != o2[:, :-1])
    pos = torch.arange(R, device=dev).expand(B, R)
    start = torch.cummax(torch.where(head, pos, 0), 1)[0]
    keep_s = ((pos - start) < cmax) | (og > 0)
    rank_s = (torch.cumsum(head.long(), 1) - 1).to(torch.int32)
    keep = torch.zeros_like(eligible).scatter_(1, order, keep_s) & eligible
    rank = torch.zeros_like(ids).scatter_(1, order, rank_s)
    return keep, torch.where(grouped, rank, I32MAX)


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
            *_spec_args(spec, C, uniq), ids.data_ptr(), scores.data_ptr(),
            orbits.data_ptr(), live.data_ptr(), _stream())
    return ids, scores, orbits, live


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
                  max_specs, syn_groups, syn_tconst, spec, uniq=None):
    """The per-doc sums of a plan with OP_MAX or OP_SYNONYM (executor.py
    execute 746-756, 787-812), on merge_docs' rows.

    ids i32[B,R] / w f32[B,R]: score_slices' rows (no prefix block);
    widths per term; bits / offsets i32[B,T]; post_wdf / post_doclen
    f32[P]; max_specs: ExecConfig.max_specs (per spec its branch masks
    over group bits); syn_groups: ExecConfig.syn_groups (one mask each);
    syn_tconst f32[B,NS] or f32[B,NS,C], NS >= len(syn_groups) (None
    without synonyms); spec and uniq (read at the row's doc) as
    score_slices takes them.
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
    sums = torch.empty((B, R), dtype=torch.float32, device=dev)
    _launch("merge_special", "xt_merge_special", ids.data_ptr(),
            w.data_ptr(), _ints(widths, dev).data_ptr(),
            _ints(row_offsets(widths), dev).data_ptr(), B, T, R,
            bits.data_ptr(), offsets.data_ptr(), post_wdf.data_ptr(),
            post_doclen.data_ptr(), post_wdf.shape[0],
            _ints(tuple(table), dev).data_ptr(),
            _ptr(syn_tconst if syn_groups else None), NS,
            *_spec_args(spec, C, uniq_used), _nd1(uniq_used),
            sums.data_ptr(), _stream())
    return sums


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
    smallest value of a multi-value doc); a row counts where it is
    eligible and its doc has the value.
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
    dev = ids.device
    cap = _pow2_cover(2 * max(R, 1))
    table = torch.empty((B, cap), dtype=torch.int64, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    regs = torch.empty((B, HLL_REGS), dtype=torch.int32, device=dev)
    _launch("agg_distinct", "xt_agg_distinct", ids.data_ptr(),
            eligible.data_ptr(), B, R, _split(B, R), col["hi"].data_ptr(),
            col["lo"].data_ptr(), col["present"].data_ptr(), n,
            table.data_ptr(), cap, count.data_ptr(), regs.data_ptr(),
            _stream())
    return count, regs


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
