"""The slice-1 device kernels: ctypes-bound CUDA launchers, their plain
PyTorch versions, and launch counters.

Four kernels carry BM25 top-k batch search (sources in ``../csrc``; each
file's header names the TPU function it replaces, what bounds it on the
H100 and what its design does about that):

  score_slices    K1     per-(query, term) posting slice + BM25 score
  merge_docs      K2+K3  per-doc sums by binary-search join, owner rows, count
  topk_rows       K4     exact top-k by (score desc, docid asc)
  prefix_certify  K5     exact rescore of prefix candidates + certificate

Dispatch: a wrapper given CUDA tensors launches its kernel (on the current
stream) or raises; given CPU tensors it runs the plain version. Nothing
falls back from one to the other. ``launches[name]`` counts kernel
launches only.

The CUDA sources are compiled with nvcc for sm_90a into one shared library
with a plain C interface, at first use, into ``xapiand_tpu_torch/_build/``
keyed by a hash of the sources and flags. Importing this module builds
nothing and needs no nvcc.
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
MAX_PREFIX_ROWS = 16384   # score_slices sorts a prefix block in 128 KB smem
MAX_TOPK = 256            # topk_rows per-thread lists; prefix_certify block

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("common.cuh", "score_slices.cu", "merge_docs.cu", "topk_rows.cu",
           "prefix_certify.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

launches = {"score_slices": 0, "merge_docs": 0, "topk_rows": 0,
            "prefix_certify": 0}
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
    source hash) and return its path. nvcc's output, including the
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
    tmp = out_dir / f"libxt_kernels.{os.getpid()}.tmp.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp)] + \
        [str(CSRC / n) for n in SOURCES if n.endswith(".cu")]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, check=False)
    secs = time.time() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
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
    "xt_merge_docs": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "xt_topk_rows": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "xt_prefix_certify": [_P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I,
                          _P, _P, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P,
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


def _ints(vals: tuple, device) -> torch.Tensor:
    """Small per-config int32 table on ``device`` (cached)."""
    key = (vals, str(device))
    t = _small_cache.get(key)
    if t is None:
        t = _small_cache[key] = torch.tensor(vals, dtype=torch.int32,
                                             device=device)
    return t


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

def merge_docs(ids, w, widths):
    """Per-doc score sums without a sort (binary-search join over the
    docid-ascending term blocks of score_slices).

    -> sums f32[B,R] (the doc's total, summed in term order, on every row
       of the doc; 0 on SENTINEL rows), owner bool[B,R] (one row per real
       doc: its lowest-numbered term's), count i32[B] (owners per query)."""
    widths = tuple(int(x) for x in widths)
    B, R = ids.shape
    _check("merge_docs.ids", ids, torch.int32, (B, sum(widths)))
    _check("merge_docs.w", w, torch.float32, (B, R))
    if not _on_cuda("merge_docs", ids, w):
        return _merge_docs_plain(ids, w, widths)
    dev = ids.device
    sums = torch.empty((B, R), dtype=torch.float32, device=dev)
    owner = torch.empty((B, R), dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    _launch("merge_docs", "xt_merge_docs", ids.data_ptr(), w.data_ptr(),
            _ints(widths, dev).data_ptr(),
            _ints(row_offsets(widths), dev).data_ptr(), B, len(widths), R,
            sums.data_ptr(), owner.data_ptr(), count.data_ptr(), _stream())
    return sums, owner, count


def _merge_docs_plain(ids, w, widths):
    ro = row_offsets(widths)
    real = ids != SENTINEL
    owner = real.clone()
    term_of_row = torch.repeat_interleave(
        torch.arange(len(widths), device=ids.device),
        torch.tensor(widths, device=ids.device))
    sums = torch.zeros_like(w)
    for u, W in enumerate(widths):
        blk = ids[:, ro[u]:ro[u + 1]].contiguous()
        pos = torch.searchsorted(blk, ids).clamp(max=W - 1)
        hit = real & (torch.gather(blk, 1, pos) == ids)
        sums = sums + torch.where(
            hit, torch.gather(w[:, ro[u]:ro[u + 1]], 1, pos), 0.0)
        owner &= ~(hit & (term_of_row > u)[None, :])
    return sums, owner, owner.sum(1, dtype=torch.int32)


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
