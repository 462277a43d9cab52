"""The port's device kernels: ctypes-bound CUDA launchers, their plain
PyTorch versions, and launch counters.

Seven kernels carry batch search (sources in ``../csrc``; each file's
header names the TPU function it replaces, what bounds it on the H100 and
what its design does about that):

  score_slices    K1     per-(query, term) posting slice + BM25 score
  merge_docs      K2+K3  per-doc sums and OR of group bits by binary-search
                  +K6    join; owner & not deleted & boolean tree; count
  topk_rows       K4     exact top-k by (score desc, docid asc)
  prefix_certify  K5     exact rescore of prefix candidates + certificate
  filter_leaves   K7+K6  value-range filter leaves, then the boolean tree
  sort_topk       K8     top-k in multi-key sort order (value, score, dist,
                         geodist, strmetric, docid), docid tiebreak
  compact_rows    K11    stream compaction of the masked rows to a cap

The boolean tree (K6) is compiled on the host into a short postfix
program (``tree_program``) that merge_docs and filter_leaves evaluate per
row.

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

from xapiand_tpu_torch.models.weights import bm25_sumpart

SENTINEL = 2**31 - 1
I32MAX = 2**31 - 1
MAX_PREFIX_ROWS = 16384   # score_slices sorts a prefix block in 128 KB smem
MAX_TOPK = 256            # topk_rows per-thread lists; prefix_certify block
MAX_SORT_TOPK = 64        # sort_topk per-thread lists
MAX_SORT_KEYS = 3         # sort_topk keys of <= 8 words (row index included)
MAX_FILTERS = 32          # filter_leaves keeps the leaf results in one word
MAX_TREE_DEPTH = 32       # the tree program's bit stack is one register

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("common.cuh", "score_slices.cu", "merge_docs.cu", "topk_rows.cu",
           "prefix_certify.cu", "compact_rows.cu", "filter_leaves.cu",
           "sort_topk.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

launches = {"score_slices": 0, "merge_docs": 0, "topk_rows": 0,
            "prefix_certify": 0, "compact_rows": 0, "filter_leaves": 0,
            "sort_topk": 0}
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


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "xt_score_slices": [_P, _P, _P, _LL, _P, _P, _P, _LL, _P, _P, _P, _P,
                        _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                        _P, _P, _P, _P],
    "xt_merge_docs": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _LL, _P, _I, _P,
                      _P, _P, _P, _P],
    "xt_topk_rows": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "xt_prefix_certify": [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I,
                          _P, _P, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P,
                          _P],
    "xt_compact_rows": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "xt_filter_leaves": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P,
                         _P],
    "xt_sort_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P],
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


# --------------------------------------------------------------------------
# K6: the boolean tree as a postfix program
# --------------------------------------------------------------------------

OP_G, OP_F, OP_ALL, OP_NONE, OP_AND, OP_OR, OP_XOR, OP_ANDNOT = range(8)


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
        if op in ("G", "F"):
            out.append((OP_G if op == "G" else OP_F) | int(node[1]) << 8)
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


def _eval_program_plain(prog, orbits, fres, shape, device):
    """The program on bool tensors: orbits i32 (None when the program has
    no G leaf), fres a list of bool tensors, one per F leaf."""
    st: list = []
    for ins in prog:
        op, arg = ins & 0xff, ins >> 8
        if op == OP_G:
            st.append((orbits & (1 << arg)) != 0)
        elif op == OP_F:
            st.append(fres[arg])
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
                 is_prefix, params):
    """Slice + score every (query, term) posting span.

    post / imp: (docids i32[P], wdf f32[P], doclen f32[P]); imp may be None
    when no term is in prefix mode. offsets/lens i32[B,T], tconst/scoring
    f32[B,T]. widths[t] rows are read for term t - the first widths[t]
    impact-ordered rows when is_prefix[t]. params = BM25.kernel_params.
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
                        ("tconst", tconst, torch.float32),
                        ("scoring", scoring, torch.float32)):
        _check(f"score_slices.{name}", t, dt, (B, T))
    src = list(post) + (list(imp) if imp is not None else [])
    for t, dt in zip(src, (torch.int32, torch.float32, torch.float32) * 2):
        _check("score_slices.postings", t, dt)
    if not _on_cuda("score_slices", offsets, lens, tconst, scoring, *src):
        return _score_slices_plain(post, imp, offsets, lens, tconst, scoring,
                                   widths, is_prefix, params)
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
            _ints(ro, dev).data_ptr(), B, T, R, smem, *params,
            ids.data_ptr(), w.data_ptr(), tail.data_ptr(), _stream())
    return ids, w, tail


def _score_slices_plain(post, imp, offsets, lens, tconst, scoring, widths,
                        is_prefix, params):
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
        w = bm25_sumpart(src[1][idx], src[2][idx], tconst[:, t:t + 1],
                         params) * scoring[:, t:t + 1]
        w = torch.where(inl, w, 0.0)
        tail = torch.zeros(B, dtype=torch.float32, device=dev)
        if pref:
            d, order = torch.sort(d, dim=1, stable=True)
            w = torch.gather(w, 1, order)
            bpos = (off + W).clamp(max=n - 1)
            gb = bm25_sumpart(imp[1][bpos], imp[2][bpos], tconst[:, t],
                              params)
            tail = torch.where(lens[:, t] > W,
                               torch.clamp_min(gb * scoring[:, t], 0.0), 0.0)
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

def topk_rows(scores, ids, owner, k: int):
    """Top-k owner rows per query by (score desc, docid asc).
    -> docids i32[B,k] (SENTINEL past the owner count), scores f32[B,k]
    (-inf there)."""
    B, R = scores.shape
    _check("topk_rows.scores", scores, torch.float32, (B, R))
    _check("topk_rows.ids", ids, torch.int32, (B, R))
    _check("topk_rows.owner", owner, torch.bool, (B, R))
    if not 0 < k <= MAX_TOPK:
        raise ValueError(f"topk_rows: k={k} outside 1..{MAX_TOPK}")
    if not _on_cuda("topk_rows", scores, ids, owner):
        return _topk_rows_plain(scores, ids, owner, k)
    dev = scores.device
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    _launch("topk_rows", "xt_topk_rows", scores.data_ptr(), ids.data_ptr(),
            owner.data_ptr(), B, R, k, out_d.data_ptr(), out_s.data_ptr(),
            _stream())
    return out_d, out_s


def _topk_rows_plain(scores, ids, owner, k):
    masked = torch.where(owner, scores, float("-inf"))
    d = torch.where(owner, ids, SENTINEL)
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    m_sorted = torch.gather(masked, 1, order)
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
                   cand_d, cand_v, k: int, params):
    """Exact rescore of the top K of K+1 prefix candidates (cand_d/cand_v
    i32/f32[B,K+1] from topk_rows) by binary search in every term's full
    postings (ln = min(lens, classes[t])), re-sort, certificate.
    -> docids i32[B,kk], scores f32[B,kk], certified bool[B]; kk =
    min(k, K)."""
    B, T = offsets.shape
    K = cand_d.shape[1] - 1
    kk = min(k, K)
    classes = tuple(int(c) for c in classes)
    for name, t, dt, shp in (("offsets", offsets, torch.int32, (B, T)),
                             ("lens", lens, torch.int32, (B, T)),
                             ("tconst", tconst, torch.float32, (B, T)),
                             ("scoring", scoring, torch.float32, (B, T)),
                             ("tail", tail, torch.float32, (B, T)),
                             ("cand_d", cand_d, torch.int32, (B, K + 1)),
                             ("cand_v", cand_v, torch.float32, (B, K + 1))):
        _check(f"prefix_certify.{name}", t, dt, shp)
    for t, dt in zip(post, (torch.int32, torch.float32, torch.float32)):
        _check("prefix_certify.postings", t, dt)
    if len(classes) != T:
        raise ValueError(f"prefix_certify: {T} terms, classes {classes}")
    if not (0 < kk and K <= MAX_TOPK):
        raise ValueError(f"prefix_certify: K={K}, k={k} unsupported")
    if not _on_cuda("prefix_certify", offsets, lens, tconst, scoring, tail,
                    cand_d, cand_v, *post):
        return _prefix_certify_plain(post, offsets, lens, tconst, scoring,
                                     classes, tail, cand_d, cand_v, kk,
                                     params)
    dev = offsets.device
    out_d = torch.empty((B, kk), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, kk), dtype=torch.float32, device=dev)
    cert = torch.empty(B, dtype=torch.bool, device=dev)
    _launch("prefix_certify", "xt_prefix_certify",
            post[0].data_ptr(), post[1].data_ptr(), post[2].data_ptr(),
            post[0].shape[0], offsets.data_ptr(), lens.data_ptr(),
            tconst.data_ptr(), scoring.data_ptr(),
            _ints(classes, dev).data_ptr(), tail.data_ptr(), B, T,
            cand_d.data_ptr(), cand_v.data_ptr(), K, kk, *params,
            out_d.data_ptr(), out_s.data_ptr(), cert.data_ptr(), _stream())
    return out_d, out_s, cert


def _prefix_certify_plain(post, offsets, lens, tconst, scoring, classes,
                          tail, cand_d, cand_v, kk, params):
    B, T = offsets.shape
    K = cand_d.shape[1] - 1
    cd = cand_d[:, :K]
    n = post[0].shape[0]
    exact = torch.zeros(cd.shape, dtype=torch.float32, device=cd.device)
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
        w = bm25_sumpart(post[1][ppos], post[2][ppos], tconst[:, t:t + 1],
                         params)
        exact = exact + torch.where(found, w * scoring[:, t:t + 1], 0.0)
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
                  prog):
    """Value-range filter leaves per row, then the boolean tree.

    values: the segment's value columns (arrays_pytree()["values"]); slots
    and vmax: per filter leaf (ExecConfig filter_slots / filter_vmax);
    fparams i32[B,F,4] (lo hi, lo lo, hi hi, hi lo per leaf); docids
    i32[B,C]; base bool[B,C] (owner & not deleted) or None (docid !=
    SENTINEL: packed rows); orbits i32[B,C]; prog a tree_program.
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
    cols = [values.get(s) for s in slots]
    for col in cols:
        for ch in _FILTER_CH:
            if col is not None and ch in col:
                _check(f"filter_leaves.{ch}", col[ch],
                       torch.bool if ch == "present" else torch.int32)
                opt.append(col[ch])
    if not _on_cuda("filter_leaves", docids, orbits, fparams, *opt):
        return _filter_leaves_plain(cols, vmax, fparams, docids, base,
                                    orbits, prog)
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
            B, F, C, _ints(prog, dev).data_ptr(), len(prog),
            eligible.data_ptr(), count.data_ptr(), _stream())
    return eligible, count


def _lex_ge(ah, al, bh, bl):
    return (ah > bh) | ((ah == bh) & (al >= bl))


def _lex_le(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al <= bl))


def _filter_leaves_plain(cols, vmax, fparams, docids, base, orbits, prog):
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
                                           docids.device)
    return eligible, eligible.sum(1, dtype=torch.int32)


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
    cols = [values.get(s[1]) if s[0] not in ("score", "docid") else None
            for s in specs]
    for col in cols:
        opt.extend(col[ch] for ch in _SORT_CH if col is not None and ch in col)
    if not _on_cuda("sort_topk", ids, sums, eligible, *opt):
        return _sort_topk_plain(specs, cols, ids, sums, eligible, k, targets,
                                strtabs)
    dev = ids.device
    spec_tab, table = [], []
    for si, (spec, col) in enumerate(zip(specs, cols)):
        spec_tab += [SORT_KINDS[spec[0]], int(bool(spec[2])),
                     int(spec[3]) if spec[0] == "strmetric" else 0, 0]
        table += [_ptr(col.get(ch)) if col is not None else 0
                  for ch in _SORT_CH]
        table += [_ptr(strtabs.get(si)),
                  col["hi"].shape[0] if col is not None else 0]
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    # the table holds per-batch pointers when a strmetric table rides it:
    # those are not cached
    tab = _ints(tuple(table), dev, torch.int64) if not strtabs else \
        torch.tensor(table, dtype=torch.int64, device=dev)
    # key words: 2 per value spec, 1 per other, the docid, the row index
    n_words = sum(2 if s[0] == "value" else 1 for s in specs) + 2
    _launch("sort_topk", "xt_sort_topk", ids.data_ptr(), sums.data_ptr(),
            eligible.data_ptr(), B, C, k, S, n_words,
            _ints(tuple(spec_tab), dev).data_ptr(), tab.data_ptr(),
            _ptr(targets), out_d.data_ptr(), out_s.data_ptr(), _stream())
    return out_d, out_s


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


def _sort_topk_plain(specs, cols, ids, sums, eligible, k, targets, strtabs):
    B, C = ids.shape
    inf = float("inf")
    keys = []
    for si, (spec, col) in enumerate(zip(specs, cols)):
        kind, desc = spec[0], bool(spec[2])
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
            keys += [_ikey(torch.where(eligible, h, I32MAX)),
                     _ikey(torch.where(eligible, l, I32MAX))]
            continue
        if kind == "docid":
            keys.append(_ikey(torch.where(eligible, ids, SENTINEL)))
            continue
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
        keys.append(_fkey(torch.where(eligible, kf, inf)))
    keys.append(_ikey(torch.where(eligible, ids, SENTINEL)))
    # least significant key first, stable: ties keep row order
    order = torch.arange(C, device=ids.device).expand(B, C)
    for key in reversed(keys):
        o = torch.sort(torch.gather(key, 1, order), dim=1, stable=True)[1]
        order = torch.gather(order, 1, o)
    order = order[:, :k]
    dd = torch.gather(torch.where(eligible, ids, SENTINEL), 1, order)
    ss = torch.gather(torch.where(eligible, sums, float("-inf")), 1, order)
    if C < k:
        dd = torch.nn.functional.pad(dd, (0, k - C), value=SENTINEL)
        ss = torch.nn.functional.pad(ss, (0, k - C), value=float("-inf"))
    return dd, ss
