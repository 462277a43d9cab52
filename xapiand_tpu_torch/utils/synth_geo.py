"""Geo + time corpus and queries, straight to a Segment.

The counterpart of ``scripts/config_bench.py:244-275`` (BASELINE.json
config 4, "Geo + time workload: HTM trie geospatial queries and datetime
range filters over 1M geotagged docs") built without the analysis chain,
as ``utils/synth_positional.py`` builds config 2:

  - the docs are ``build_corpus4(n, seed=7)`` draw for draw: Python's
    ``random.Random(7)``, 12 body tokens from 2,000 words ``w{i}`` with
    weights 1/(i+1)^1.07 (``choices`` with the cumulative weights computed
    once, which draws what ``weights=`` draws), then a point's longitude in
    [-120, -70] and latitude in [25, 48], then a naive timestamp
    ``2024-MM-DDTHH:00:00`` (month 1-12, day 1-28, hour 0-23);
  - ``loc`` (slot LOC_SLOT, field prefix LOC_PREFIX): the JAX ``Database``'s
    geo field. A point is a tiny cap (``ewkt._point_radius``) covered at
    level 11 (``geospatial.extract`` at the schema's error 0.3) through the
    native cap cover, packed as ``xapiand_tpu/models/builder.py``
    ``_pack_geo_column`` (704-725) packs a GeoColumn, so ``max_doc_ranges``
    and the plan's RMAX come from the data; the geo value column (builder.py
    642-666: the key of the centroid's latitude, ``fval`` the latitude,
    ``fval2`` the longitude); and the accuracy terms ``geo_terms(ranges,
    GEO_LEVELS, LOC_PREFIX)``, the ancestor trixels at levels 3, 5, 8, 10,
    12 and 13, computed in numpy;
  - ``ts`` (slot TS_SLOT, prefix TS_PREFIX): ``dtutils.parse_datetime`` of
    the string, as the schema parses it, for the value column (one float a
    doc: builder.py's first fast path) and its ``date_terms`` at the hour,
    day, month, year, decade and century;
  - the body: one term a word, wdf its occurrences, document length 12.

Departures from the JAX ``Database`` (none changes a config 4 answer, whose
plans score nothing): the body has no field-prefixed or stemmed copies and
no positions, and document lengths count one namespace; the global
namespace copies of the geo and date terms and the exact-value date term
are left out (no query reads them); no string value column of the body and
no ``_id`` column. The slots and prefixes are the JAX schema's for these
field names (``tests/test_torch_geo.py`` holds them equal).

The term table is ``GeoTerms``: the body and date terms in a dict, the
geo terms (about 25 a doc, most of them at levels 12 and 13 and each with
few postings) as sorted trixel ids per level, looked up by binary search,
so a 1M-doc build makes no Python object per geo term.

``queries4`` draws two families, built as IR exactly as ``query/dsl.py``
builds ``{"_and": [{"loc": {"_circle": ...}}, {"ts": {"_from", "_to"}}]}``
(the circle through ``geospatial.extract`` and ``geo_range_cover`` with
``GEO_COVER_MAX_TERMS``, the range through ``date_range_terms``):

  P   ``config_bench.queries4(n, seed=11)``'s draws: a circle of radius
      100-400 km centred in lon [-115, -75], lat [28, 45], and a 3-month
      window starting on the first of month 1-9 (the published run used
      the first 96);
  T   ``random.Random(12)``: circles drawn as in P, and a window of 1-3
      whole days starting on a random day of 2024 (month 1-12, day 1-26).
      Its hour cover (25-73 terms of ~125 postings at 1M docs) is cheaper
      than the geo cover, so compile_ir lets the time leg drive, AND(GEO0,
      AND(G0, F0)): a dispatcher's or an event feed's "what happened near
      here in the last days". Batched with P (one IR signature), a T
      query shares P's launch groups and runs under the group's first
      member's tree and class maxima (query/plan.py unify_cfgs), a
      conjunction of the same three leaves.

``oracle_answers`` answers every query in numpy from the segment's geo
ranges and the drawn timestamps, independently of the executor: a doc
matches iff it is not deleted, its ts key lies in [lo, hi] and one of its
first RMAX ranges overlaps one of the query's cover ranges (HTM cover
semantics, GeoSpatialRange::insideRanges). It also holds config_bench's
haversine bounds (300-341) on every answer: every doc truly inside the
circle matches, and nothing further out than the radius plus 15 km does.
With ``aggs=True`` it also answers ``GEO_AGGS`` (the bounding box of the
matched points, ``_geo_bounds`` of loc, and how many distinct hours they
fall on, ``_cardinality`` of ts; ``SCHEMA`` names the two fields for
``aggregations.compile_for_segment``) over each query's matches.
"""

from __future__ import annotations

import hashlib
import itertools
import random
import time
from collections.abc import Mapping
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np

from xapiand_tpu_torch import native
from xapiand_tpu_torch.analysis import accuracy
from xapiand_tpu_torch.geo import ewkt, geospatial, htm
from xapiand_tpu_torch.models.segment import (GeoColumn, Segment, TermInfo,
                                              ValueColumn, size_class)
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.utils import dtutils
from xapiand_tpu_torch.utils import serialise as ser
from xapiand_tpu_torch.utils.synth_browse import hll_registers

N_WORDS, BODY_LEN, ZIPF_S = 2000, 12, 1.07
# the JAX schema's slots and prefixes for the fields loc, ts
LOC_SLOT, TS_SLOT = 101, 102
LOC_PREFIX, TS_PREFIX = "F1daf5afd.", "Fb56ac770."
GEO_ERROR = 0.3                      # the schema's default geo error
POINT_LEVEL = 11                     # geospatial.extract's level at 0.3
POINT_RADIUS = ewkt._point_radius()  # a point's cap
GEO_LEVELS = accuracy.DEF_ACC_GEO    # the schema's default accuracies
DATE_UNITS = accuracy.DEF_ACC_DATE
HAVERSINE_SLACK_M = 15_000           # config_bench's boundary allowance
_I32MAX = 2**31 - 1
# the aggregation run over the T queries: the bounding box of the matched
# points and how many distinct hours they fall on
GEO_AGGS = {"bounds": {"_geo_bounds": {"_field": "loc"}},
            "hours": {"_cardinality": {"_field": "ts"}}}


class GeoSchema:
    """The corpus's fields, as far as ``aggregations.compile_for_segment``
    reads a schema: ``get_field(name).slot``."""

    SLOTS = {"loc": LOC_SLOT, "ts": TS_SLOT}

    def get_field(self, name: str) -> SimpleNamespace:
        return SimpleNamespace(slot=self.SLOTS[name])


SCHEMA = GeoSchema()


@dataclass
class GeoCorpus:
    seg: Segment
    lat: np.ndarray        # f64[N]
    lon: np.ndarray        # f64[N]
    ts: np.ndarray         # f64[N] POSIX seconds
    ts_key: np.ndarray     # u64[N] sortable keys of ts
    build_s: float = 0.0


class GeoTerms(Mapping):
    """term -> TermInfo: ``words`` a dict, each geo level its ascending
    trixel ids with their posting offsets (ids[i]'s postings are
    offs[i]:offs[i + 1]). Boolean terms: collfreq and max_wdf 0."""

    def __init__(self, words: dict, levels: dict):
        self.words = words
        self.levels = levels     # f"{LOC_PREFIX}#G{level}:" -> (ids, offs, tid0)

    def get(self, term, default=None):
        ti = self.words.get(term)
        if ti is not None:
            return ti
        head, sep, num = term.rpartition(":") if isinstance(term, str) \
            else ("", "", "")
        lv = self.levels.get(head + sep)
        if lv is None or not num.isdigit() or str(int(num)) != num:
            return default
        ids, offs, tid0 = lv
        v = int(num)
        i = int(np.searchsorted(ids, v))
        if i == len(ids) or ids[i] != v:
            return default
        return TermInfo(tid=tid0 + i, offset=int(offs[i]),
                        length=int(offs[i + 1] - offs[i]), collfreq=0,
                        max_wdf=0.0)

    def __getitem__(self, term):
        ti = self.get(term)
        if ti is None:
            raise KeyError(term)
        return ti

    def __contains__(self, term):
        return self.get(term) is not None

    def __iter__(self):
        yield from self.words
        for head, (ids, _o, _t) in self.levels.items():
            for v in ids.tolist():
                yield f"{head}{v}"

    def __len__(self):
        return len(self.words) + sum(len(ids) for ids, _o, _t in
                                     self.levels.values())


def draw_docs(n_docs: int, seed: int = 7):
    """config_bench.build_corpus4's draws: word indices i32[n, 12], lon and
    lat f64[n], month, day, hour i32[n]."""
    rng = random.Random(seed)
    cum = list(itertools.accumulate(1.0 / (i + 1) ** ZIPF_S
                                    for i in range(N_WORDS)))
    pop = range(N_WORDS)
    words = np.empty((n_docs, BODY_LEN), np.int32)
    f = np.empty((n_docs, 2), np.float64)
    mdh = np.empty((n_docs, 3), np.int32)
    choices, uniform, randint = rng.choices, rng.uniform, rng.randint
    for i in range(n_docs):
        words[i] = choices(pop, cum_weights=cum, k=BODY_LEN)
        f[i, 0] = uniform(-120.0, -70.0)
        f[i, 1] = uniform(25.0, 48.0)
        mdh[i] = (randint(1, 12), randint(1, 28), randint(0, 23))
    return words, f[:, 0], f[:, 1], mdh[:, 0], mdh[:, 1], mdh[:, 2]


def ts_string(month, day, hour=0) -> str:
    return f"2024-{int(month):02d}-{int(day):02d}T{int(hour):02d}:00:00"


def point_ranges(lat: float, lon: float) -> list:
    """A point's level-13 ranges, as geospatial.extract covers a _point."""
    return htm.cover(htm.Cap(lat, lon, POINT_RADIUS), level=POINT_LEVEL)


def _point_covers(lat: list, lon: list) -> list:
    """point_ranges of every point: htm.cover sends a Cap to the native
    cap cover, and that call is made here directly (without the native
    library, htm.cover's Python cover)."""
    lib = native.lib
    if lib is None:
        return [point_ranges(a, b) for a, b in zip(lat, lon)]
    cov = lib.htm_cap_cover
    return [cov(a, b, POINT_RADIUS, POINT_LEVEL) for a, b in zip(lat, lon)]


def _expand(a, b):
    """Every integer of each [a_i, b_i] -> (values, index i of each)."""
    ln = b - a + 1
    rep = np.repeat(np.arange(len(a)), ln)
    start = np.repeat(np.cumsum(ln) - ln, ln)
    return a[rep] + (np.arange(len(rep)) - start), rep


def _blocks(tid, doc, N1):
    """(term id, doc) pairs -> the unique pairs sorted by (term, doc): the
    term ids, their offsets into the docs, the docs, and how often each
    pair occurred."""
    key, counts = np.unique(tid.astype(np.int64) * N1 + doc,
                            return_counts=True)
    t, d = key // N1, (key % N1).astype(np.int32)
    ids, starts = np.unique(t, return_index=True)
    return ids, np.append(starts, len(t)), d, counts


def _value_column(keys, fval, fval2=None, kind="numeric") -> ValueColumn:
    """One value a doc: builder.py _pack_value_column's layout."""
    nd = len(keys)
    h, lo = ser.split_keys_np(keys)
    col = {}
    for ch, fill in (("hi", _I32MAX), ("lo", _I32MAX), ("max_hi", -2**31),
                     ("max_lo", -2**31)):
        col[ch] = np.full(nd + 1, fill, np.int32)
    col["hi"][:nd] = col["max_hi"][:nd] = h
    col["lo"][:nd] = col["max_lo"][:nd] = lo
    present = np.zeros(nd + 1, bool)
    present[:nd] = True
    f1 = np.zeros(nd + 1, np.float32)
    f1[:nd] = fval
    f2 = None
    if fval2 is not None:
        f2 = np.zeros(nd + 1, np.float32)
        f2[:nd] = fval2
    return ValueColumn(kind=kind, fval=f1, present=present, fval2=f2,
                       max_vals=1, **col)


def build_corpus4(n_docs: int = 1_000_000, seed: int = 7) -> GeoCorpus:
    t0 = time.time()
    words, lon, lat, month, day, hour = draw_docs(n_docs, seed)
    N, N1 = n_docs, n_docs + 1
    docs = np.arange(N, dtype=np.int64)

    # ts: parse every (month, day, hour) string once
    combo = ((month - 1) * 28 + (day - 1)) * 24 + hour
    table = [dtutils.parse_datetime(ts_string(m, d, h))
             for m in range(1, 13) for d in range(1, 29) for h in range(24)]
    ts = np.asarray(table, np.float64)[combo]
    ts_key = ser.sortable_keys_u64_np(ts)

    # loc: the geo column
    per_doc = _point_covers(lat.tolist(), lon.tolist())
    doc_len = np.zeros(N1, np.int32)
    doc_len[:N] = [len(r) for r in per_doc]
    flat = np.array([x for r in per_doc for x in r], np.int64).reshape(-1, 2)
    del per_doc
    doc_off = np.zeros(N1, np.int32)   # the pad doc's offset stays 0
    doc_off[:N] = np.cumsum(doc_len[:N]) - doc_len[:N]
    off = len(flat)
    flat_start = np.full(off + 64, _I32MAX, np.int32)
    flat_end = np.full(off + 64, -1, np.int32)
    flat_start[:off], flat_end[:off] = flat[:, 0], flat[:, 1]
    geo = GeoColumn(flat_start=flat_start, flat_end=flat_end, doc_off=doc_off,
                    doc_len=doc_len, max_doc_ranges=int(doc_len.max(
                        initial=0)))
    rdoc = np.repeat(docs, doc_len[:N])

    # postings: body words, then date terms by unit, then geo terms by level
    ids_b, offs_b, d_b, wdf_b = _blocks(words.ravel(),
                                        np.repeat(docs, BODY_LEN), N1)
    blocks = [(d_b, wdf_b.astype(np.float32))]
    terms: dict = {}
    pos = 0
    tid = 0
    for t, a, b in zip(ids_b.tolist(), offs_b[:-1].tolist(),
                       offs_b[1:].tolist()):
        w = wdf_b[a:b]
        terms[f"w{t}"] = TermInfo(tid=tid, offset=pos + a, length=b - a,
                                  collfreq=int(w.sum()),
                                  max_wdf=float(w.max()))
        tid += 1
    pos += len(d_b)
    uniq_combo = np.unique(combo)
    for unit in DATE_UNITS:
        trunc = np.zeros(12 * 28 * 24, np.int64)
        trunc[uniq_combo] = [int(dtutils.truncate_to(table[c], unit))
                             for c in uniq_combo.tolist()]
        ids, offs, d, _c = _blocks(trunc[combo], docs, N1)
        blocks.append((d, np.zeros(len(d), np.float32)))
        for v, a, b in zip(ids.tolist(), offs[:-1].tolist(),
                           offs[1:].tolist()):
            terms[f"{TS_PREFIX}#D{unit}:{v}"] = TermInfo(
                tid=tid, offset=pos + a, length=b - a, collfreq=0,
                max_wdf=0.0)
            tid += 1
        pos += len(d)
    levels = {}
    for level in GEO_LEVELS:
        shift = 2 * (htm.MAX_LEVEL - min(level, htm.MAX_LEVEL))
        a, b = flat[:, 0] >> shift, flat[:, 1] >> shift
        b = np.minimum(b, a + 4096)   # ancestors_of_ranges' cap
        tids, ri = _expand(a, b)
        ids, offs, d, _c = _blocks(tids, rdoc[ri], N1)
        blocks.append((d, np.zeros(len(d), np.float32)))
        levels[f"{LOC_PREFIX}#G{level}:"] = (ids, offs + pos, tid)
        tid += len(ids)
        pos += len(d)
    max_len = max([ti.length for ti in terms.values()] +
                  [int(np.diff(o).max(initial=0)) for _i, o, _t in
                   levels.values()])
    guard = size_class(max(max_len, 1))
    post_docids = np.full(pos + guard, N, np.int32)
    post_docids[:pos] = np.concatenate([d for d, _w in blocks])
    post_wdf = np.zeros(pos + guard, np.float32)
    post_wdf[:pos] = np.concatenate([w for _d, w in blocks])
    doclen = np.zeros(N1, np.float32)
    doclen[:N] = BODY_LEN
    seg = Segment(
        num_docs=N, total_doclen=float(N * BODY_LEN),
        post_docids=post_docids, post_wdf=post_wdf,
        post_doclen=doclen[np.minimum(post_docids, N)],
        post_posoff=np.zeros(1, np.int32), post_poslen=np.zeros(1, np.int32),
        positions=np.zeros(128, np.int32), doclen=doclen,
        deleted=np.zeros(N1, bool), terms=GeoTerms(terms, levels),
        values={LOC_SLOT: _value_column(ser.sortable_keys_u64_np(lat),
                                        lat.astype(np.float32),
                                        lon.astype(np.float32), "geo"),
                TS_SLOT: _value_column(ts_key, ts.astype(np.float32))},
        geo={LOC_SLOT: geo}, doc_keys=[], guard=guard)
    return GeoCorpus(seg=seg, lat=lat, lon=lon, ts=ts, ts_key=ts_key,
                     build_s=time.time() - t0)


def fingerprint(corpus: GeoCorpus) -> dict:
    """A hash of the arrays (``sha256``), the posting count, the geo
    ranges and ``max_doc_ranges``."""
    seg = corpus.seg
    g = seg.geo[LOC_SLOT]
    h = hashlib.sha256()
    for arr in (seg.post_docids, seg.post_wdf, g.flat_start, g.flat_end,
                g.doc_off, g.doc_len, corpus.ts_key,
                seg.values[LOC_SLOT].hi, seg.values[LOC_SLOT].lo):
        h.update(np.ascontiguousarray(arr).tobytes())
    return {"sha256": h.hexdigest()[:16],
            "postings": int(len(seg.post_docids) - seg.guard),
            "terms": len(seg.terms), "geo_ranges": int(g.doc_len.sum()),
            "max_doc_ranges": g.max_doc_ranges}


def geo_query(lon: float, lat: float, radius: float) -> Q:
    """{"loc": {"_circle": ...}} as query/dsl.py _geo_query builds it."""
    ranges, _ = geospatial.extract(
        {"_circle": {"_longitude": lon, "_latitude": lat, "_radius": radius}},
        error=GEO_ERROR)
    cover = accuracy.geo_range_cover(ranges, GEO_LEVELS, LOC_PREFIX,
                                     max_terms=accuracy.GEO_COVER_MAX_TERMS)
    return Q.geo(LOC_SLOT, ranges, cover_terms=cover)


def ts_query(lo: str, hi: str) -> Q:
    """{"ts": {"_from": lo, "_to": hi}} as query/dsl.py _range_query builds
    it."""
    lo_v, hi_v = dtutils.parse_datetime(lo), dtutils.parse_datetime(hi)
    cover = accuracy.date_range_terms(lo_v, hi_v, DATE_UNITS, TS_PREFIX)
    return Q.value_range(TS_SLOT, ser.sortable_key_u64(lo_v),
                         ser.sortable_key_u64(hi_v), cover_terms=cover)


def _circle(rng):
    return (rng.uniform(-115.0, -75.0), rng.uniform(28.0, 45.0),
            rng.uniform(100_000, 400_000))


def queries4(n_p: int = 1024, n_t: int = 256, seed_p: int = 11,
             seed_t: int = 12) -> list:
    """[(family, Q, params)], P then T; params: lon, lat, radius (m) and
    the window's strings lo, hi."""
    out = []
    rng = random.Random(seed_p)
    for _ in range(n_p):
        lon, lat, radius = _circle(rng)
        m0 = rng.randint(1, 9)
        out.append(("P", lon, lat, radius, ts_string(m0, 1),
                    ts_string(m0 + 3, 1)))
    rng = random.Random(seed_t)
    for _ in range(n_t):
        lon, lat, radius = _circle(rng)
        m, d, n = rng.randint(1, 12), rng.randint(1, 26), rng.randint(1, 3)
        out.append(("T", lon, lat, radius, ts_string(m, d),
                    ts_string(m, d + n)))
    return [(fam, Q.and_(geo_query(lon, lat, r), ts_query(lo, hi)),
             {"lon": lon, "lat": lat, "radius": r, "lo": lo, "hi": hi})
            for fam, lon, lat, r, lo, hi in out]


def query_dsl(params: dict) -> dict:
    """The query as config_bench writes it for the JAX QueryDSL."""
    return {"_and": [
        {"loc": {"_circle": {"_longitude": params["lon"],
                             "_latitude": params["lat"],
                             "_radius": params["radius"]}}},
        {"ts": {"_from": params["lo"], "_to": params["hi"]}}]}


def haversine_m(lat1, lon1, lat2, lon2):
    """config_bench's hav_m, on numpy arrays."""
    p1, p2 = np.radians(lat1), np.radians(lat2)
    a = np.sin((p2 - p1) / 2) ** 2 + \
        np.cos(p1) * np.cos(p2) * np.sin(np.radians(lon2 - lon1) / 2) ** 2
    return 2 * 6371008.8 * np.arcsin(np.sqrt(a))


def oracle_answers(corpus: GeoCorpus, queries: list, rmax: int,
                   k: int = 10, aggs: bool = False) -> list:
    """Per query {"count", "docids": the first k matches ascending,
    "inside", "near": how many live docs in the window lie inside the
    circle and inside radius + 15 km, "bounds_ok": every inside doc
    matches and every match is near}. rmax: the plan's RMAX (a doc is
    tested on its first rmax ranges). With aggs, also "aggs": GEO_AGGS over
    the matches - "n", the float32 "minlat" / "maxlat" / "minlon" /
    "maxlon" of the docs' centroids (+inf / -inf when nothing matched),
    the float64 sums "slat" / "slon", "ts_distinct" the number of distinct
    timestamps and "hll" their 1024 HyperLogLog registers."""
    seg = corpus.seg
    g = seg.geo[LOC_SLOT]
    N = seg.num_docs
    n = g.doc_len[:N].astype(np.int64)
    doc = np.repeat(np.arange(N), n)
    j = np.arange(len(doc)) - np.repeat(np.cumsum(n) - n, n)
    keep = j < rmax
    rs = g.flat_start[:len(doc)][keep].astype(np.int64)
    re = g.flat_end[:len(doc)][keep].astype(np.int64)
    doc = doc[keep]
    order = np.argsort(rs, kind="stable")
    rs, re, doc = rs[order], re[order], doc[order]
    span = int((re - rs).max(initial=0))
    live = ~seg.deleted[:N]
    by_ts = np.argsort(corpus.ts_key, kind="stable")
    ts_sorted = corpus.ts_key[by_ts]
    out = []
    for _fam, q, p in queries:
        geo_q, ts_q = q.children
        cov = np.asarray(geo_q.geo_ranges, np.int64).reshape(-1, 2)
        lo_i = np.searchsorted(rs, cov[:, 0] - span, "left")
        hi_i = np.searchsorted(rs, cov[:, 1], "right")
        ln = np.maximum(hi_i - lo_i, 0)
        idx, ci = _expand(lo_i, lo_i + ln - 1) if ln.sum() else \
            (np.zeros(0, np.int64), np.zeros(0, np.int64))
        hit = re[idx] >= cov[ci, 0]            # and rs <= qe by the slice
        cand = np.unique(doc[idx[hit]])
        lo_k, hi_k = np.uint64(ts_q.lo_key), np.uint64(ts_q.hi_key)
        match = cand[live[cand] & (corpus.ts_key[cand] >= lo_k) &
                     (corpus.ts_key[cand] <= hi_k)]
        # config_bench's haversine bounds over the window's live docs
        a = np.searchsorted(ts_sorted, lo_k, "left")
        b = np.searchsorted(ts_sorted, hi_k, "right")
        win = by_ts[a:b]
        win = win[live[win]]
        dist = haversine_m(corpus.lat[win], corpus.lon[win], p["lat"],
                           p["lon"])
        inside = win[dist <= p["radius"]]
        near = win[dist <= p["radius"] + HAVERSINE_SLACK_M]
        ok = bool(np.isin(inside, match).all() and
                  np.isin(match, near).all())
        out.append({"count": int(len(match)), "docids": match[:k].tolist(),
                    "inside": int(len(inside)), "near": int(len(near)),
                    "bounds_ok": ok})
        if aggs:
            loc, tcol = seg.values[LOC_SLOT], seg.values[TS_SLOT]
            lat32, lon32 = loc.fval[match], loc.fval2[match]
            out[-1]["aggs"] = {
                "n": len(match),
                "minlat": lat32.min(initial=np.inf),
                "maxlat": lat32.max(initial=-np.inf),
                "minlon": lon32.min(initial=np.inf),
                "maxlon": lon32.max(initial=-np.inf),
                "slat": float(corpus.lat[match].sum()),
                "slon": float(corpus.lon[match].sum()),
                "ts_distinct": len(np.unique(corpus.ts_key[match])),
                "hll": hll_registers(tcol.hi[match], tcol.lo[match])}
    return out
