"""Immutable index segment: flat posting arrays + dense per-doc columns.

This is the TPU-native replacement for the glass backend's B-tree tables
(src/xapian/backends/glass/glass_postlist.cc, glass_values.cc,
glass_positionlist.cc). Instead of chunked copy-on-write trees decoded by
iterators, a segment is a set of flat, statically-shaped arrays resident in
HBM; the host keeps the term dictionary (term string -> posting span):

  post_docids : int32[P]   docids, grouped by term, sorted within each term
  post_wdf    : float32[P] within-document frequency per posting
  post_doclen : float32[P] document length per posting (denormalised copy of
                           doclen[docid]: BM25 normlen comes from a contiguous
                           dynamic_slice instead of a random gather - TPU
                           gathers serialise, slices stream)
  post_posoff : int32[P]   span start into `positions` (positional terms)
  post_poslen : int32[P]   span length into `positions`
  positions   : int32[PP]  term positions, flat
  doclen      : float32[ND+1]  document length per docid (+ dump row)
  deleted     : bool[ND+1]     delete bitmap (delta deletes on immutable data)
  value slots : per slot, dense int32 sort-key pairs + float32 aggregates
  geo slots   : flat HTM level-13 ranges with per-doc spans

Query-time access is gather-only (lax.dynamic_slice on posting spans), so a
query compiles to a static XLA dataflow - no data-dependent control flow.
All arrays carry a guard pad at the end so a dynamic_slice of any size class
starting at any real span stays in bounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

DUMP = -1  # symbolic; actual dump row index is num_docs (last row)

# posting-gather size classes (static shapes for XLA; pick smallest >= len).
# x2 growth: every extra class doubles potential jit-cache entries but
# halves worst-case padding - the global docid sort is the hot cost and
# scales with padded rows, so tighter classes win (measured on v5e)
SIZE_CLASSES = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                65536, 131072, 262144, 524288, 1048576, 2097152)


def size_class(n: int) -> int:
    for c in SIZE_CLASSES:
        if n <= c:
            return c
    raise ValueError(f"posting list too long for size classes: {n}")


@dataclass(frozen=True)
class TermInfo:
    tid: int
    offset: int      # start into post_* arrays
    length: int      # termfreq within this segment (#docs carrying the term)
    collfreq: int    # total wdf
    max_wdf: float
    max_poslen: int = 0   # longest position list (0 = none/unknown)


class TermTable(dict):
    """term -> TermInfo, materialized lazily from raw tuples or columns.

    A commit exports every term's stats, but queries only ever touch a
    handful - building 100k+ TermInfo dataclasses eagerly was ~40% of
    segment-finalize time, and even raw 6-tuples cost ~2s/1M terms to
    allocate. Stored values may be TermInfo, a raw 6-tuple, or an int
    tid indexing the packed stat columns in `self.cols`
    (offsets[nt+1] i64, collfreq i64, maxwdf f32, maxpos i64 - the
    native exporter's arrays, shared not copied). Accessors convert+
    cache on first touch; raw_items() (merge/snapshot bulk paths)
    resolves without building TermInfo objects."""

    __slots__ = ("cols", "src")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.cols = None
        # (buf, starts, lens): the native exporter's NUL-separated sorted
        # term buffer + per-term byte offsets/lengths. While set, the
        # dict holds only a CACHE of touched terms; lookups bisect the
        # buffer (memcmp order == Python bytes order), so a commit does
        # ZERO per-term Python work. Bulk accessors materialize first.
        self.src = None

    def _mk(self, tid: int) -> TermInfo:
        offs, cf, mw, mp = self.cols
        return TermInfo(tid, int(offs[tid]),
                        int(offs[tid + 1]) - int(offs[tid]),
                        int(cf[tid]), float(mw[tid]), int(mp[tid]))

    def _bisect(self, key: str) -> int:
        """tid of key in the sorted export buffer, or -1."""
        buf, starts, lens = self.src
        tb = key.encode("utf-8")
        lo, hi = 0, len(lens)
        while lo < hi:
            mid = (lo + hi) >> 1
            s = starts[mid]
            cur = buf[s: s + lens[mid]]
            if cur < tb:
                lo = mid + 1
            elif cur > tb:
                hi = mid
            else:
                return mid
        return -1

    def _ensure_full(self):
        """Materialize every key into the dict (bulk iteration paths)."""
        if self.src is None:
            return
        buf, starts, lens = self.src
        nt = len(lens)
        # NB: dict(self) would call back into self.keys() — use the raw
        # dict iterator for the already-cached entries
        cached = ({k: v for k, v in dict.items(self)}
                  if dict.__len__(self) else None)
        parts = buf.decode("utf-8").split("\0")
        if len(parts) == nt + 1 and not parts[-1]:
            dict.update(self, zip(parts, range(nt)))
        else:  # embedded NUL in a term: slice per term
            for tid in range(nt):
                s = int(starts[tid])
                term = buf[s: s + int(lens[tid])].decode("utf-8")
                dict.__setitem__(self, term, tid)
        if cached:
            dict.update(self, cached)
        self.src = None

    def __getitem__(self, k):
        try:
            v = dict.__getitem__(self, k)
        except KeyError:
            if self.src is not None:
                tid = self._bisect(k)
                if tid >= 0:
                    v = self._mk(tid)
                    dict.__setitem__(self, k, v)
                    return v
            raise
        t = type(v)
        if t is tuple:
            v = TermInfo(*v)
            dict.__setitem__(self, k, v)
        elif t is int:
            v = self._mk(v)
            dict.__setitem__(self, k, v)
        return v

    def get(self, k, default=None):
        try:
            v = dict.__getitem__(self, k)
        except (KeyError, TypeError):
            if self.src is not None and isinstance(k, str):
                tid = self._bisect(k)
                if tid >= 0:
                    v = self._mk(tid)
                    dict.__setitem__(self, k, v)
                    return v
            return default
        t = type(v)
        if t is tuple:
            v = TermInfo(*v)
            dict.__setitem__(self, k, v)
        elif t is int:
            v = self._mk(v)
            dict.__setitem__(self, k, v)
        return v

    def __contains__(self, k):
        if dict.__contains__(self, k):
            return True
        return (self.src is not None and isinstance(k, str)
                and self._bisect(k) >= 0)

    def __len__(self):
        if self.src is not None:
            return len(self.src[2])
        return dict.__len__(self)

    def __iter__(self):
        self._ensure_full()
        return dict.__iter__(self)

    def keys(self):
        self._ensure_full()
        return dict.keys(self)

    def items(self):
        self._ensure_full()
        for k in dict.keys(self):
            yield k, self[k]

    def values(self):
        self._ensure_full()
        for k in dict.keys(self):
            yield self[k]

    def raw_items(self):
        """(term, (tid, offset, length, collfreq, max_wdf, max_poslen))
        without materializing TermInfo objects - the bulk export used by
        merge_segments_data and snapshots."""
        self._ensure_full()
        if self.cols is not None:
            offs, cf, mw, mp = self.cols
            offl = offs.tolist()
            cfl = cf.tolist()
            mwl = mw.tolist()
            mpl = mp.tolist()
            for k, v in dict.items(self):
                if type(v) is int:
                    yield k, (v, offl[v], offl[v + 1] - offl[v],
                              cfl[v], mwl[v], mpl[v])
                elif type(v) is tuple:
                    yield k, v
                else:
                    yield k, (v.tid, v.offset, v.length, v.collfreq,
                              v.max_wdf, v.max_poslen)
        else:
            for k, v in dict.items(self):
                if type(v) is tuple:
                    yield k, v
                else:
                    yield k, (v.tid, v.offset, v.length, v.collfreq,
                              v.max_wdf, v.max_poslen)


@dataclass
class ValueColumn:
    """Dense per-doc column for one value slot."""

    kind: str                      # 'numeric' | 'string' | 'bool' | 'geo'
    hi: np.ndarray                 # int32[ND+1] sort key high word (of min val)
    lo: np.ndarray                 # int32[ND+1] sort key low word
    max_hi: np.ndarray             # int32[ND+1] sort key of max value
    max_lo: np.ndarray
    fval: np.ndarray               # float32[ND+1] numeric value (aggregations)
    present: np.ndarray            # bool[ND+1]
    cats: Optional[np.ndarray] = None       # int32[ND+1] facet code or -1
    cat_names: Optional[list] = None         # code -> string
    raw: Optional[list] = None               # docid -> first raw value (host)
    fval2: Optional[np.ndarray] = None       # f32[ND+1] geo centroid lon
                                             # (fval holds lat)
    # multi-value slots only (max_vals > 1): flat per-value key words, doc-
    # major, each doc's values ascending - the exact per-value containment
    # arrays behind MultipleValueRange::insideRange (multivalue/range.cc:
    # 352-366), which unpacks the StringList and requires a REAL value in
    # the range, not [min,max] interval overlap. Single-value columns skip
    # these (min == max == the value, so the interval test is exact).
    mv_hi: Optional[np.ndarray] = None       # int32[VR+guard]
    mv_lo: Optional[np.ndarray] = None
    mv_off: Optional[np.ndarray] = None      # int32[ND+1]
    mv_len: Optional[np.ndarray] = None      # int32[ND+1]
    max_vals: int = 1                        # max values in any one doc


@dataclass
class GeoColumn:
    """Per-doc HTM level-13 range spans (exact device intersection)."""

    flat_start: np.ndarray   # int32[GR]
    flat_end: np.ndarray     # int32[GR]
    doc_off: np.ndarray      # int32[ND+1]
    doc_len: np.ndarray      # int32[ND+1]
    max_doc_ranges: int


@dataclass
class Segment:
    """One immutable index generation (host arrays + term dictionary)."""

    num_docs: int                      # rows (docids 0..num_docs-1)
    total_doclen: float
    post_docids: np.ndarray
    post_wdf: np.ndarray
    post_doclen: np.ndarray
    post_posoff: np.ndarray
    post_poslen: np.ndarray
    positions: np.ndarray
    doclen: np.ndarray
    deleted: np.ndarray
    terms: dict                        # term str -> TermInfo
    values: dict                       # slot -> ValueColumn
    geo: dict                          # slot -> GeoColumn
    doc_keys: list                     # docid -> external doc id (str)
    guard: int = 128
    uniqterms: Optional[np.ndarray] = None  # f32[ND+1] distinct terms/doc
                                            # (Xapian UNIQUE_TERMS stat)

    @property
    def doc_count(self) -> int:
        return self.num_docs - int(self.deleted[:self.num_docs].sum())

    @property
    def avg_doclen(self) -> float:
        n = self.doc_count
        return (self.total_doclen / n) if n else 0.0

    def get_term(self, term: str) -> Optional[TermInfo]:
        return self.terms.get(term)

    def max_posting_len(self) -> int:
        return max((t.length for t in self.terms.values()), default=0)

    def impact_arrays(self, scheme, stats):
        """Impact-permuted posting mirror for maxweight-style pruning
        (≙ matcher.cc:415 max_weight recalc + bm25weight.cc get_maxpart).

        Returns (docids, wdf, doclen) shaped like the post_* arrays, where
        each term's block holds ITS OWN postings reordered by descending
        per-posting impact g = sumpart(wdf, dl, tconst=1) (docid-ascending
        on ties, so ordering is deterministic). Because the order is
        g-descending by construction, g at any position upper-bounds the
        whole tail from that position - the executor's prefix mode reads
        that boundary value as the unseen-mass bound. Valid only for the
        (scheme key, avg_doclen) it was built with; cached per segment."""
        key = (scheme.key(), round(float(stats.avg_doclen), 6))
        cache = getattr(self, "_impact_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        g = scheme.impact_np(self.post_wdf, self.post_doclen, stats)
        if g is None:
            return None
        n = len(self.post_docids)
        offs = np.fromiter((t.offset for t in self.terms.values()),
                           np.int64, len(self.terms))
        lens = np.fromiter((t.length for t in self.terms.values()),
                           np.int64, len(self.terms))
        tid = np.full(n, len(self.terms), np.int64)
        if len(offs):
            order = np.argsort(offs, kind="stable")
            offs, lens = offs[order], lens[order]
            starts = np.repeat(offs, lens)
            tids_r = np.repeat(np.arange(len(offs), dtype=np.int64), lens)
            pos_in = np.arange(len(starts), dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens)
            rows = starts + pos_in
            tid[rows] = tids_r
        # stable sort: primary term block, secondary -g; stability keeps
        # equal-impact postings docid-ascending (post arrays are)
        perm = np.lexsort((-g, tid))
        grouped_tid = tid[perm]
        covered = grouped_tid < len(self.terms)
        perm = perm[covered]
        grouped_tid = grouped_tid[covered]
        # destination = term offset + rank within the term's group
        group_start = np.searchsorted(grouped_tid, np.arange(len(offs)))
        rank = np.arange(len(perm), dtype=np.int64) - \
            group_start[grouped_tid]
        dest = offs[grouped_tid] + rank
        imp_d = self.post_docids.copy()
        imp_w = self.post_wdf.copy()
        imp_l = self.post_doclen.copy()
        imp_d[dest] = self.post_docids[perm]
        imp_w[dest] = self.post_wdf[perm]
        imp_l[dest] = self.post_doclen[perm]
        out = (imp_d, imp_w, imp_l)
        self._impact_cache = (key, out)
        return out

    def nbytes(self) -> int:
        total = 0
        for arr in (self.post_docids, self.post_wdf, self.post_doclen,
                    self.post_posoff,
                    self.post_poslen, self.positions, self.doclen,
                    self.deleted):
            total += arr.nbytes
        for col in self.values.values():
            for arr in (col.hi, col.lo, col.max_hi, col.max_lo, col.fval,
                        col.present):
                total += arr.nbytes
            if col.cats is not None:
                total += col.cats.nbytes
            if col.mv_hi is not None:
                total += (col.mv_hi.nbytes + col.mv_lo.nbytes +
                          col.mv_off.nbytes + col.mv_len.nbytes)
        for g in self.geo.values():
            total += (g.flat_start.nbytes + g.flat_end.nbytes +
                      g.doc_off.nbytes + g.doc_len.nbytes)
        return total


# ---------------------------------------------------------------------------
# Everything above is the JAX package's host segment, copied as it is (a test
# holds the two texts equal). Below is the port's own device mirror: the same
# arrays, dtypes and arrays_pytree() key names as the JAX DeviceSegment
# (xapiand_tpu/models/segment.py:386-532), as torch tensors on one device, so
# a tree exported from either side feeds the other (device_segment_from_numpy),
# plus each geo column's int2 pairs (geo_arrays), which only geo_leaves reads
# on the card, and each value column's packed keys and codes (value_arrays),
# which only filter_leaves and agg_distinct read on the card: a JAX tree
# feeds the port's plain versions as it is.

import dataclasses  # noqa: E402
import threading  # noqa: E402

import torch  # noqa: E402

_VALUE_DTYPES = {"hi": np.int32, "lo": np.int32, "max_hi": np.int32,
                 "max_lo": np.int32, "fval": np.float32, "present": np.bool_,
                 "cats": np.int32, "fval2": np.float32, "mv_hi": np.int32,
                 "mv_lo": np.int32, "mv_off": np.int32, "mv_len": np.int32}


def geo_arrays(g: GeoColumn) -> dict:
    """A geo column's device arrays: the four int32 channels the JAX
    package uploads, and the int2 pairs csrc/geo_leaves.cu reads - span
    i32[ND+1, 2] (each doc's doc_off, doc_len) and flat i32[GR, 2] (each
    range's flat_start, flat_end) - so that a doc's span and a range are
    one 8-byte gather each."""
    out = {ch: np.asarray(getattr(g, ch), np.int32)
           for ch in ("flat_start", "flat_end", "doc_off", "doc_len")}
    out["span"] = np.stack((out["doc_off"], out["doc_len"]), 1)
    out["flat"] = np.stack((out["flat_start"], out["flat_end"]), 1)
    return out


_I32MAX = 2**31 - 1


def _hash32_np(hi, lo):
    """ops/aggs.py _hash32 (40-49) in uint32 numpy arithmetic."""
    M = 0xFFFFFFFF
    h = (hi.astype(np.int64) & M) ^ (((lo.astype(np.int64) & M) *
                                       0x9E3779B9) & M)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    return h ^ (h >> 16)


def _lex64(hi, lo):
    """int32 key pairs as int64 in the kernels' order (csrc/common.cuh
    lex_le: signed, lexicographic)."""
    return (hi.astype(np.int64) << 32) + lo.astype(np.int64) + 2**31


def value_arrays(col: dict) -> dict:
    """A value column's device arrays past the JAX package's channels
    (numpy channels in, numpy out), read on the card only:

    keys i32[n, 4]: each present doc's hi, lo, max_hi, max_lo, an absent
      doc's the empty interval (INT32_MAX, INT32_MAX, INT32_MIN,
      INT32_MIN), so that a filter leaf's test is one 16-byte gather
      (csrc/filter_leaves.cu: present iff min <= max; a present doc whose
      min passes its max is refused);
    codes i32[n]: the rank of each present doc's (hi, lo) key (in that
      order) among the column's distinct keys of present docs, -1 where
      the doc has no
      value; code_hll i32[K], K the distinct keys: each code's _hash32
      HyperLogLog register index << 5 | its rho, | 1 << 15 for the key
      (INT32_MAX, INT32_MAX), which feeds the registers but not the exact
      count (csrc/agg_distinct.cu)."""
    hi, lo = np.asarray(col["hi"], np.int32), np.asarray(col["lo"], np.int32)
    present = np.asarray(col["present"], bool)
    keys = np.stack((hi, lo, np.asarray(col["max_hi"], np.int32),
                     np.asarray(col["max_lo"], np.int32)), 1)
    k64 = _lex64(hi, lo)
    if (present & (k64 > _lex64(keys[:, 2], keys[:, 3]))).any():
        raise ValueError("value_arrays: a present doc whose smallest key "
                         "passes its largest")
    keys[~present] = (_I32MAX, _I32MAX, -2**31, -2**31)
    uniq, inv = np.unique(k64[present], return_inverse=True)
    codes = np.full(hi.shape, -1, np.int32)
    codes[present] = inv.reshape(-1)
    uh = (uniq >> 32).astype(np.int32)
    ul = ((uniq & 0xFFFFFFFF) - 2**31).astype(np.int32)
    h = _hash32_np(uh, ul)
    rest = (h << 10) & 0xFFFFFFFF
    # clz of a uint32: 31 - floor(log2); exact in float64 below 2**32
    clz = 31 - np.floor(np.log2(np.maximum(rest, 1).astype(np.float64)))
    rho = np.where(rest == 0, 23, clz.astype(np.int64) + 1)
    skip = (uh == _I32MAX) & (ul == _I32MAX)
    hll = ((h >> 22) << 5) | rho | (skip.astype(np.int64) << 15)
    return {"keys": np.ascontiguousarray(keys), "codes": codes,
            "code_hll": hll.astype(np.int32)}


def _host_tree(seg: Segment) -> dict:
    """The numpy arrays a DeviceSegment uploads, keyed as arrays_pytree()."""
    uniq = seg.uniqterms if seg.uniqterms is not None \
        else np.ones_like(seg.doclen)
    values = {}
    for slot, col in seg.values.items():
        values[slot] = {ch: np.asarray(getattr(col, ch), dt)
                        for ch, dt in _VALUE_DTYPES.items()
                        if getattr(col, ch) is not None}
        values[slot].update(value_arrays(values[slot]))
    geo = {slot: geo_arrays(g) for slot, g in seg.geo.items()}
    return {
        "post_docids": np.asarray(seg.post_docids, np.int32),
        "post_wdf": np.asarray(seg.post_wdf, np.float32),
        "post_doclen": np.asarray(seg.post_doclen, np.float32),
        "post_posoff": np.asarray(seg.post_posoff, np.int32),
        "post_poslen": np.asarray(seg.post_poslen, np.int32),
        "positions": np.asarray(seg.positions, np.int32),
        "doclen": np.asarray(seg.doclen, np.float32),
        "deleted": np.asarray(seg.deleted, np.bool_),
        "uniqterms": np.asarray(uniq, np.float32),
        "values": values,
        "geo": geo,
    }


def terms_from(table) -> dict:
    """term -> TermInfo of another package's term table: a TermTable of raw
    tuples (the native inverter builds one) or a dict of term records (the
    pure-Python inverter's, where the native library did not load)."""
    if hasattr(table, "raw_items"):
        return {t: TermInfo(*raw) for t, raw in table.raw_items()}
    names = [f.name for f in dataclasses.fields(TermInfo)]
    return {t: TermInfo(*(getattr(ti, n) for n in names))
            for t, ti in table.items()}


def device_segment_from_numpy(tree: dict, device: torch.device) -> dict:
    """A segment tree of numpy arrays (e.g. the JAX package's
    ``arrays_pytree()`` mapped through ``np.asarray``) -> the same tree of
    torch tensors on ``device``, dtypes kept. Always a copy, on the CPU
    too: later edits of the host arrays do not reach the device mirror."""
    if isinstance(tree, dict):
        return {k: device_segment_from_numpy(v, device)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


class DeviceSegment:
    """Device mirror of a Segment: the numeric arrays query execution
    reads, as torch tensors on one device."""

    def __init__(self, seg: Segment, device: torch.device):
        self.host = seg
        self.device = device
        self.num_docs = seg.num_docs
        self.arrays = device_segment_from_numpy(_host_tree(seg), device)
        self.impact: dict = {}
        self._impact_key = None
        self._lock = threading.Lock()

    def ensure_impact(self, scheme, stats) -> bool:
        """Upload the impact-permuted posting mirror (Segment.impact_arrays)
        for the executor's prefix mode. Rebuilt when the (scheme,
        avg_doclen) key changes; False when the scheme isn't
        impact-separable."""
        key = (scheme.key(), round(float(stats.avg_doclen), 6))
        with self._lock:
            if self._impact_key == key and self.impact:
                return True
            arrs = self.host.impact_arrays(scheme, stats)
            if arrs is None:
                return False
            self.impact = device_segment_from_numpy(
                {"imp.docids": np.asarray(arrs[0], np.int32),
                 "imp.wdf": np.asarray(arrs[1], np.float32),
                 "imp.doclen": np.asarray(arrs[2], np.float32)},
                self.device)
            self._impact_key = key
            return True

    def arrays_pytree(self) -> dict:
        """All device arrays, keyed as the JAX package's arrays_pytree()
        (and each geo column's int2 pairs, geo_arrays, and each value
        column's packed keys and codes, value_arrays)."""
        return {**self.arrays, **self.impact}
