"""A bank / netlog document corpus for the port's ``Database``, its
traffic, and its float64 numpy oracle.

Documents are shaped like ``docs/EXAMPLES.md``'s ``/bank`` and
``/netlog`` requests (:335-420), one document holding both:
``accountNumber``, ``balance``, ``age``, ``gender``, ``favoriteFruit``,
``eyeColor``, ``employer``, an ``about`` text of 30-80 English words
drawn Zipf-like from inflected forms (so stemming merges them),
``registered`` (a datetime over ten years), ``addr`` (``_type`` ip: IPv4
from 64 /16 networks of skewed weight, 5% IPv6; 10% of the docs hold 2-3
addresses, so key ranges read per-value keys), ``bytes`` and ``loc`` (a
point scattered round one of 50 cities). Everything is drawn from one
seed.

``queries`` gives the traffic: 8 families of aggregated searches (H, R,
F, N, I, G, M, P; see its docstring) and plain term queries.

The oracle (``oracle_search``) answers a ``Database.search`` call in
float64 numpy, with none of the port's device code, from the corpus's
documents and its indexing history (``Truth``, which holds the
database's id map to that history): the live rows and every field value,
medians' and
percentiles' bin grids, histogram buckets, range, IP range and network
members (from the generated addresses and the request's CIDRs) and filter
matches are the generator's and the request's (value bins, histogram
buckets and float ranges in float32 arithmetic, in JAX's operation order,
so every edge falls where the device puts it; sums in float64). It shares
with the port's host code, and so cannot check: the query parse and
BM25's postings and statistics (the hits are BM25 over the segments' host
postings with the database's global statistics, every matching live doc
ranked by score then (segment, docid)); the specs' structure,
the category names and the geo_trixels table of ``compile_for_segment``
and each doc's trixel; the merge and the shaping
(``aggregations.merge_and_shape``). ``compare_aggs`` holds two shaped
responses to each other: integers exact, floats within float32 tolerance
(medians and percentiles come off the same bin grid, so equal).
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import math

import numpy as np

FRUITS = ("apple", "banana", "strawberry", "cherry", "grape", "mango")
EYES = ("brown", "blue", "green", "hazel", "grey")
GENDERS = ("male", "female")
_STEMS = (
    "connect develop manag report analys design market support train "
    "consult account engineer research plan build test deploy operat "
    "maintain improv creat lead organ communic negoti present sell "
    "purchas deliver schedul process review document measur monitor "
    "optim secur integr migrat configur automat launch fund invest "
    "learn teach mentor volunteer travel cook paint garden read writ "
    "run swim climb hik cycl danc sing play photograph fish camp "
    "collect restor repair renov decor knit sew bak brew"
).split()
_SUFFIXES = ("", "s", "ed", "ing", "er", "ers", "ment", "ments", "ion",
             "ions", "ly", "ness", "ive", "ation")
_FILLER = ("the and with for from into over about after before their "
           "team project client city company product service people "
           "customer market year quality system data network").split()
EPOCH0 = _dt.datetime(2014, 1, 1, tzinfo=_dt.timezone.utc).timestamp()
SPAN = 10 * 365.25 * 86400.0


def _vocab():
    words = [s + x for s in _STEMS for x in _SUFFIXES]
    return words + list(_FILLER)


class Corpus:
    """The generated documents and the raw fields the oracle reads."""

    def __init__(self, n_docs: int, seed: int):
        rng = np.random.Generator(np.random.PCG64(seed))
        self.n = n_docs
        vocab = _vocab()
        self.vocab = vocab
        zipf = 1.0 / np.arange(1, len(vocab) + 1) ** 0.9
        perm = rng.permutation(len(vocab))
        self.word_p = zipf[np.argsort(perm)] / zipf.sum()
        crng = np.random.Generator(np.random.PCG64(1234))
        self.cities = np.stack([crng.uniform(-40.0, 60.0, 50),
                                crng.uniform(-120.0, 140.0, 50)], 1)
        nets = crng.integers(1, 223, (64, 2))
        self.nets16 = [f"{a}.{b}.0.0/16" for a, b in nets]
        net_w = 1.0 / np.arange(1, 65) ** 1.2
        net_w /= net_w.sum()
        self.balance = np.round(rng.uniform(0.0, 100000.0, n_docs), 2)
        self.age = rng.integers(18, 81, n_docs)
        self.gender = rng.integers(0, 2, n_docs)
        self.fruit = rng.integers(0, len(FRUITS), n_docs)
        self.eye = rng.integers(0, len(EYES), n_docs)
        self.employer = rng.integers(0, 400, n_docs)
        self.registered = np.floor(EPOCH0 + rng.uniform(0.0, SPAN, n_docs))
        self.bytes = np.floor(rng.lognormal(8.0, 1.5, n_docs)).astype(np.int64)
        city = rng.integers(0, 50, n_docs)
        self.lat = np.clip(self.cities[city, 0] + rng.normal(0, 0.3, n_docs),
                           -89.9, 89.9)
        self.lon = np.clip(self.cities[city, 1] + rng.normal(0, 0.3, n_docs),
                           -179.9, 179.9)
        n_addr = np.where(rng.random(n_docs) < 0.1,
                          rng.integers(2, 4, n_docs), 1)
        lens = rng.integers(30, 81, n_docs)
        words = rng.choice(len(vocab), int(lens.sum()), p=self.word_p)
        self.about = np.split(words, np.cumsum(lens)[:-1])
        self.addrs = []
        for i in range(n_docs):
            out = []
            for _ in range(int(n_addr[i])):
                if rng.random() < 0.05:
                    out.append(str(ipaddress.IPv6Address(
                        (0x20010db8 << 96) | (int(rng.integers(0, 8)) << 80)
                        | int(rng.integers(0, 2**40)))))
                else:
                    net = ipaddress.ip_network(
                        self.nets16[int(rng.choice(64, p=net_w))])
                    out.append(str(net.network_address +
                                   int(rng.integers(1, 65535))))
            self.addrs.append(out)

    def doc(self, i: int) -> dict:
        """Document i as JSON (the REST body of a /bank + /netlog PUT)."""
        ts = _dt.datetime.fromtimestamp(float(self.registered[i]),
                                        _dt.timezone.utc)
        addr = self.addrs[i]
        return {
            "accountNumber": i,
            "balance": float(self.balance[i]),
            "age": int(self.age[i]),
            "gender": GENDERS[self.gender[i]],
            "favoriteFruit": FRUITS[self.fruit[i]],
            "eyeColor": EYES[self.eye[i]],
            "employer": f"employer{self.employer[i]}",
            "about": " ".join(self.vocab[w] for w in self.about[i]),
            "registered": ts.strftime("%Y-%m-%dT%H:%M:%SZ"),
            "addr": {"_type": "ip",
                     "_value": addr if len(addr) > 1 else addr[0]},
            "bytes": int(self.bytes[i]),
            "loc": {"_point": {"_latitude": float(self.lat[i]),
                               "_longitude": float(self.lon[i])}},
        }


def build_corpus(n_docs: int, seed: int = 7) -> Corpus:
    return Corpus(n_docs, seed)


# -- traffic ------------------------------------------------------------------

FAMILIES = "HRFNIGMP"


def _text_query(rng, corpus: Corpus):
    """A 2-3-word OR of inflected words of middling frequency."""
    order = np.argsort(-corpus.word_p)
    mid = order[20:400]
    n = int(rng.integers(2, 4))
    return " ".join(corpus.vocab[w] for w in rng.choice(mid, n,
                                                        replace=False))


def _bundle(fam: str, rng, corpus: Corpus) -> dict:
    if fam == "H":
        return {"by_balance": {"_histogram": {"_field": "balance",
                                              "_interval": 5000},
                               "_aggs": {"avg_age": {"_avg": {
                                   "_field": "age"}}}},
                "by_month": {"_date_histogram": {"_field": "registered",
                                                 "_interval": "month"}}}
    if fam == "R":
        lo = float(rng.integers(0, 20)) * 1000.0
        ranges = [{"_key": f"r{j}", "_from": lo + 15000.0 * j,
                   "_to": lo + 15000.0 * j + 25000.0} for j in range(5)]
        return {"balance_ranges": {"_range": {"_field": "balance",
                                              "_ranges": ranges},
                                   "_aggs": {"age_stats": {"_stats": {
                                       "_field": "age"}}}},
                "median_age": {"_median": {"_field": "age"}}}
    if fam == "F":
        term = {"gender": GENDERS[int(rng.integers(0, 2))]} \
            if rng.random() < 0.5 else \
            {"favoriteFruit": FRUITS[int(rng.integers(0, len(FRUITS)))]}
        return {"picked": {"_filter": {"_term": term},
                           "_aggs": {"avg_balance": {"_avg": {
                               "_field": "balance"}},
                               "max_age": {"_max": {"_field": "age"}}}},
                "balance_pcts": {"_percentiles": {
                    "_field": "balance",
                    "_percentiles": [1, 5, 25, 50, 75, 95, 99]}}}
    if fam == "N":
        return {"fruits": {"_terms": {"_field": "favoriteFruit"},
                           "_aggs": {"ages": {
                               "_histogram": {"_field": "age",
                                              "_interval": 10,
                                              "_buckets": 9},
                               "_aggs": {"median_balance": {"_median": {
                                   "_field": "balance"}}}}}}}
    if fam == "I":
        nets = [int(x) for x in rng.choice(64, 16, replace=False)]
        ranges = [{"_key": f"net{j}", "_cidr": corpus.nets16[n]}
                  for j, n in enumerate(nets[:6])]
        ranges.append({"_key": "low", "_from": "0.0.0.0",
                       "_to": "100.0.0.0"})
        ranges.append({"_key": "v6", "_cidr": "2001:db8::/32"})
        networks = [{"_key": f"loc{j}",
                     "_cidrs": [corpus.nets16[nets[j]],
                                corpus.nets16[nets[(j + 5) % 16]]]}
                    for j in range(16)]
        return {"nets": {"_ip_range": {"_field": "addr", "_ranges": ranges},
                         "_aggs": {"total": {"_sum": {"_field": "bytes"}}}},
                "locs": {"_geo_ip": {"_field": "addr",
                                     "_networks": networks}}}
    if fam == "G":
        c = corpus.cities[int(rng.integers(0, 50))]
        return {"tiles": {"_geo_trixels": {"_field": "loc",
                                           "_level": int(rng.integers(4, 9))}},
                "near": {"_geo_distance": {
                    "_field": "loc", "_origin": [float(c[0]), float(c[1])],
                    "_ranges": [{"_to": 10000.0},
                                {"_from": 5000.0, "_to": 30000.0},
                                {"_from": 30000.0, "_to": 100000.0},
                                {"_from": 100000.0}]}}}
    if fam == "P":
        return {"mode_age": {"_mode": {"_field": "age"}},
                "median_bytes": {"_median": {"_field": "bytes"}},
                "median_age": {"_median": {"_field": "age"}}}
    raise ValueError(fam)


def queries(corpus: Corpus, n_each: int = 64, n_terms: int = 256,
            seed: int = 11) -> tuple:
    """-> (searches, terms). searches: per family (in FAMILIES order)
    n_each (family, query, aggs, count_only): H, R, F, N, I, G and P a
    2-3-word OR over ``about`` with k = 10 and the family's bundle (H
    histograms of balance with an _avg sub and of registered by month; R
    five overlapping balance ranges with a _stats sub and a _median; F a
    _filter bucket with subs and _percentiles; N terms > histogram >
    _median, the hist2 path; I _ip_range with a _sum sub and _geo_ip; G
    _geo_trixels and _geo_distance ranges; P _mode and _medians of integer
    fields), M a match-all count-only search carrying three or four of
    the other bundles (every row aggregated: the dense path). terms:
    n_terms one-word queries over ``about``, which the native host
    scorer answers."""
    rng = np.random.Generator(np.random.PCG64(seed))
    out = []
    for fam in FAMILIES:
        for _ in range(n_each):
            if fam == "M":
                picked = rng.choice(list("HRFNIGP"), int(rng.integers(3, 5)),
                                    replace=False)
                aggs = {}
                for f in picked:
                    aggs.update(_bundle(str(f), rng, corpus))
                out.append((fam, {"_match_all": {}}, aggs, True))
            else:
                out.append((fam, {"about": _text_query(rng, corpus)},
                            _bundle(fam, rng, corpus), False))
    order = np.argsort(-corpus.word_p)
    terms = [{"about": corpus.vocab[int(w)]}
             for w in rng.choice(order[5:300], n_terms)]
    return out, terms


# -- the oracle ---------------------------------------------------------------

NUMERIC = ("accountNumber", "balance", "age", "registered", "bytes")
CATEGORICAL = ("gender", "favoriteFruit", "eyeColor", "employer")
ORDER_STAT_BINS = 2048
_DAY = 86400.0
_INTERVALS = {"second": 1.0, "minute": 60.0, "hour": 3600.0, "day": _DAY,
              "week": 7 * _DAY, "month": _DAY, "year": _DAY}


def _ip_float(a: str) -> float:
    """An address as the ip field stores it: the float of its integer."""
    return float(int(ipaddress.ip_address(a)))


class Truth:
    """What the oracle knows of a database built from a corpus: the
    documents' field values as the generator drew them (numbers as
    float32, the width of a value column), and which document each
    segment row holds, from the indexing history: ``commits`` the corpus
    documents indexed before each commit, in order (document i as id
    ``str(i)``; a replacement re-indexes the same document), ``deleted``
    the documents deleted and not indexed again. A commit's documents take
    its segment's rows in order, and a document is live in its last row.
    The database's id map must say the same (checked here)."""

    def __init__(self, corpus: Corpus, db, commits, deleted=()):
        c = corpus
        self.corpus = c
        self.f32 = {"accountNumber": np.arange(c.n), "balance": c.balance,
                    "age": c.age, "registered": c.registered,
                    "bytes": c.bytes}
        self.f32 = {f: np.asarray(v, np.float64).astype(np.float32)
                    for f, v in self.f32.items()}
        self.f32["loc"] = c.lat.astype(np.float32)
        self.lon = c.lon.astype(np.float32)
        self.cats = {
            "gender": np.asarray(GENDERS)[c.gender],
            "favoriteFruit": np.asarray(FRUITS)[c.fruit],
            "eyeColor": np.asarray(EYES)[c.eye],
            "employer": np.asarray([f"employer{e}" for e in c.employer])}
        n_addr = np.asarray([len(a) for a in c.addrs])
        self.addr_doc = np.repeat(np.arange(c.n), n_addr)
        self.addr_val = np.asarray([_ip_float(a) for out in c.addrs
                                    for a in out])
        self.field_of = {db.schema.get_field(f).slot: f
                         for f in NUMERIC + CATEGORICAL + ("addr", "loc")}
        # every row's document, and the live rows
        self.rows = [np.asarray(cm, np.int64) for cm in commits]
        self.indexed = np.unique(np.concatenate(self.rows))
        where = {}
        for si, docs in enumerate(self.rows):
            for row, d in enumerate(docs.tolist()):
                where[d] = (si, row)
        for d in deleted:
            where.pop(int(d), None)
        self.doc_of = [np.full(len(docs), -1, np.int64) for docs in self.rows]
        for d, (si, row) in where.items():
            self.doc_of[si][row] = d
        self.live = [np.flatnonzero(d >= 0) for d in self.doc_of]
        got = {k: tuple(v) for k, v in db._locate.items()}
        if [s.segment.num_docs for s in db._searchers] != \
                [len(r) for r in self.rows] or \
                got != {str(d): w for d, w in where.items()}:
            raise AssertionError("the database's segments or id map differ "
                                 "from its indexing history")

    def grid(self, field: str) -> tuple:
        """The order-statistic bin grid (lo, scale) of a numeric field:
        its range over every document indexed (a deleted row keeps its
        values in its segment), a power-of-two scale that fits it in
        ORDER_STAT_BINS bins."""
        v = self.f32[field][self.indexed]
        lo, hi = float(v.min()), float(v.max())
        span = hi - lo
        scale = 1.0 if span <= 0 else \
            2.0 ** math.floor(math.log2((ORDER_STAT_BINS - 1) / span))
        return lo, scale

    def day_anchor(self, si: int, field: str, interval: float) -> float:
        """A date histogram's first bucket in segment si: the day (or
        interval) of the least value of the documents its rows hold."""
        v = float(self.f32[field][self.rows[si]].min())
        return math.floor(v / interval) * interval


def _field(spec_slot, args, truth: Truth) -> str:
    """The request's field, which must be the one the compile chose."""
    f = args["_field"] if isinstance(args, dict) else args
    if spec_slot is not None and spec_slot >= 0 and \
            truth.field_of.get(spec_slot) != f:
        raise AssertionError(f"spec slot {spec_slot} is not field {f!r}")
    return f


def _bm25_weights(db, truth, cq, stats):
    """Per segment (docids, float64 score) of the OR of cq's terms under
    the database's BM25, with its float32 constants, over the segments'
    postings, and the docs' score tolerance
    (synth_schemes.doc_tolerance)."""
    from xapiand_tpu_torch.utils import synth_schemes as ss

    scheme = db.scheme
    out = []
    for si, s in enumerate(db._searchers):
        seg = s.segment
        N = seg.num_docs
        acc, acc_s, acc_a = (np.zeros(N) for _ in range(3))
        hit = np.zeros(N, bool)
        n_parts = 0
        for pt in cq.terms:
            ti = seg.get_term(pt.term)
            if ti is None:
                continue
            n_parts += 1
            tf = db.global_termfreq(pt.term)
            cf = db.global_collfreq(pt.term)
            tc = scheme.term_constant(stats, tf, pt.wqf, pt.factor,
                                      collfreq=cf)
            tc = np.asarray(tc, np.float32).astype(np.float64).reshape(-1)
            sl = slice(ti.offset, ti.offset + ti.length)
            ids = np.asarray(seg.post_docids[sl])
            w, S = ss.sumpart64(scheme, np.asarray(seg.post_wdf[sl],
                                                   np.float64),
                                np.asarray(seg.post_doclen[sl], np.float64),
                                tuple(tc), stats)
            w = w * (1.0 if pt.scoring else 0.0)
            acc[ids] += w
            acc_s[ids] += S
            acc_a[ids] += np.abs(w)
            hit[ids] = True
        ids = np.flatnonzero(hit & (truth.doc_of[si] >= 0))
        out.append((ids, acc[ids],
                    ss.doc_tolerance(acc_s[ids], acc_a[ids], n_parts)))
    return out


def _stats_np(v, m, codes=None, nb=1):
    """n, s, s2, min, max per bucket (float64 sums of the float32 values;
    v*v in float32 as the device squares) over the rows where m, bucket
    codes (or bucket 0)."""
    codes = np.zeros(len(v), np.int64) if codes is None else codes
    c, x = codes[m], v[m]
    n = np.bincount(c, minlength=nb).astype(np.float64)
    s = np.bincount(c, x.astype(np.float64), minlength=nb)
    s2 = np.bincount(c, (x * x).astype(np.float64), minlength=nb)
    mn = np.full(nb, np.inf)
    mx = np.full(nb, -np.inf)
    if len(c):
        order = np.argsort(c, kind="stable")
        cs, xs = c[order], x[order].astype(np.float64)
        starts = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
        mn[cs[starts]] = np.minimum.reduceat(xs, starts)
        mx[cs[starts]] = np.maximum.reduceat(xs, starts)
    return {"n": n, "s": s, "s2": s2, "min": mn, "max": mx}


def _value_bins(v, lo, scale, nbins):
    f = np.floor((v - np.float32(lo)) * np.float32(scale))
    return np.clip(f, 0, nbins - 1).astype(np.int64)


def _metric_subs(body) -> list:
    """A bucket's metric sub-aggregations in request order: (kind key,
    args); nested bucket subs are levels of their own."""
    sub = body.get("_aggs", body.get("_aggregations")) or {}
    return [next(iter(b.items())) for b in sub.values()
            if next(iter(b)) not in _NESTABLE]


_NESTABLE = ("_terms", "_values", "_value", "_histogram", "_range")


def _sub_np(truth, docs, subs, sub_args, r_idx, b_idx, nb):
    """The bucket subs over the (row, bucket) pairs (r_idx, b_idx) of nb
    buckets; docs: each row's corpus document."""
    out = []
    for sub, (key, args) in zip(subs, sub_args):
        if sub[0] == "count" or key == "_count":
            n = np.bincount(b_idx, minlength=nb).astype(np.float64)
            z = np.zeros(nb)
            out.append({"n": n, "s": z, "s2": z, "min": np.full(nb, np.inf),
                        "max": np.full(nb, -np.inf)})
            continue
        f = _field(sub[1], args, truth)
        v = truth.f32[f][docs[r_idx]]
        keep = np.ones(len(r_idx), bool)
        res = _stats_np(v, keep, b_idx, nb)
        if key in ("_median", "_mode"):
            lo, scale = truth.grid(f)
            vb = _value_bins(v, lo, scale, ORDER_STAT_BINS)
            res["hist2"] = np.bincount(b_idx * ORDER_STAT_BINS + vb,
                                       minlength=nb * ORDER_STAT_BINS) \
                .reshape(nb, ORDER_STAT_BINS).astype(np.float64)
        out.append(res)
    return out


def _ip_interval(r: dict) -> tuple:
    """An _ip_range range or a CIDR as the [lo, hi) float interval of
    addresses, with the field's rule for an interval that rounds empty
    (it holds its one end)."""
    if isinstance(r, str) or "_cidr" in r:
        net = ipaddress.ip_network(r if isinstance(r, str) else r["_cidr"],
                                   strict=False)
        lo = int(net.network_address)
        return float(lo), float(lo + net.num_addresses)
    return (_ip_float(r["_from"]) if "_from" in r else -math.inf,
            _ip_float(r["_to"]) if "_to" in r else math.inf)


def _ip_members(truth, docs, intervals) -> np.ndarray:
    """bool[rows, n]: does one of the row's addresses lie in interval j."""
    pos = {int(d): i for i, d in enumerate(docs)}
    keep = np.isin(truth.addr_doc, docs)
    rows = np.asarray([pos[int(d)] for d in truth.addr_doc[keep]], np.int64)
    a = truth.addr_val[keep]
    out = np.zeros((len(docs), len(intervals)), bool)
    for j, (lo, hi) in enumerate(intervals):
        hit = (a >= lo) & ((a < hi) | (hi == math.inf)) if hi > lo \
            else a == lo
        out[rows[hit], j] = True
    return out


def _haversine32(lat, lon, lat0, lon0):
    f = np.float32
    r = f(0.017453292519943295)
    dlat = (lat - f(lat0)) * r * f(0.5)
    dlon = (lon - f(lon0)) * r * f(0.5)
    s1, s2 = np.sin(dlat), np.sin(dlon)
    a = s1 * s1 + (np.cos(lat * r) * np.cos(f(lat0) * r)) * (s2 * s2)
    return f(12742017.6) * np.arcsin(np.sqrt(np.clip(a, f(0.0), f(1.0))))


def _bounds32(rs, lo0=-math.inf):
    return np.asarray([(float(r.get("_from", lo0)),
                        float(r.get("_to", math.inf))) for r in rs],
                      np.float32)


def _codes(truth, si, seg, docs, spec_slot, nb, key, args):
    """One bucket code a row and its validity: terms by the segment's
    category names (a segment-local code), a histogram bucket (float32
    division, as the device divides), a nested range's first match."""
    f = _field(spec_slot, args, truth)
    if key in ("_terms", "_values", "_value"):
        names = seg.values[spec_slot].cat_names or []
        code = {n: j for j, n in enumerate(names)}
        c = np.asarray([code.get(str(x), -1) for x in truth.cats[f][docs]],
                       np.int64)
        return np.clip(c, 0, nb - 1), (c >= 0) & (c < nb)
    v = truth.f32[f][docs]
    if key in ("_histogram", "_date_histogram"):
        if key == "_histogram":
            iv, sh = float(args["_interval"]), float(args.get("_shift", 0.0))
        else:
            iv = args["_interval"]
            iv = float(iv) if isinstance(iv, (int, float)) else \
                _INTERVALS[str(iv).lower()]
            # anchored per segment, at the segment's own least value; the
            # merge shapes every segment's buckets from the last one's
            # anchor (a fault of the JAX package, mirrored: ROADMAP queue 3)
            sh = truth.day_anchor(si, f, iv)
        b = np.floor((v - np.float32(sh)) / np.float32(iv))
        return np.clip(b, 0, nb - 1).astype(np.int64), (b >= 0) & (b < nb)
    if key == "_range":
        bounds = _bounds32(args["_ranges"])
        inr = (v[:, None] >= bounds[None, :, 0]) & \
            (v[:, None] < bounds[None, :, 1])
        return inr.argmax(1), inr.any(1)
    raise ValueError(f"the oracle does not bucket by {key!r}")


def segment_aggs(truth, si, seg, specs, aggs, arrays, ids) -> tuple:
    """``ops/aggs.py compute_aggs`` of segment si in float64 numpy over
    its matched live rows ids (ascending), from the request ``aggs`` and
    the corpus's documents; of the compile's output it reads the specs'
    structure (kinds, bucket counts) and the geo_trixels table."""
    docs = truth.doc_of[si][ids]
    out = []
    for i, (spec, (_name, body)) in enumerate(zip(specs, aggs.items())):
        kind = spec[0]
        key = next(k for k in body if k not in ("_aggs", "_aggregations",
                                                "_meta"))
        args = body[key]
        if kind == "count":
            out.append(np.int64(len(ids)))
            continue
        if kind in ("median", "mode", "percentiles") or len(spec) == 2 and \
                kind not in ("cardinality", "geo_stats"):
            f = _field(spec[1], args, truth)
            v = truth.f32[f][docs]
            st = {k: x[0] for k, x in _stats_np(
                v, np.ones(len(v), bool)).items()}
            if kind in ("median", "mode", "percentiles"):
                lo, scale = truth.grid(f)
                h = np.bincount(_value_bins(v, lo, scale, ORDER_STAT_BINS),
                                minlength=ORDER_STAT_BINS).astype(np.float64)
                if kind == "percentiles":
                    st = {"n": st["n"], "min": st["min"], "max": st["max"]}
                st["hist"] = h
            out.append(st)
            continue
        nb = spec[2]
        sub_args = _metric_subs(body)
        if kind in ("terms", "histogram"):
            c, ok = _codes(truth, si, seg, docs, spec[1], nb, key, args)
            r_idx = np.flatnonzero(ok)
            b_idx = c[r_idx]
        elif kind == "geo_trixels":
            nb, shift = spec[2], spec[3]
            g = seg.geo[spec[1]]
            off = np.minimum(np.asarray(g.doc_off)[ids],
                             len(g.flat_start) - 1)
            tri = np.asarray(g.flat_start)[off] >> shift
            table = arrays["agg_params"][str(i)]
            c = np.searchsorted(table, tri)
            ok = (np.asarray(g.doc_len)[ids] > 0) & (c < nb) & \
                (table[np.minimum(c, nb - 1)] == tri)
            r_idx = np.flatnonzero(ok)
            b_idx = c[r_idx]
        elif kind in ("range", "geodist_range"):
            f = _field(spec[1], args, truth)
            v = truth.f32[f][docs]
            if kind == "geodist_range":
                lat0, lon0 = (np.float32(x) for x in args["_origin"])
                v = _haversine32(v, truth.lon[docs], lat0, lon0)
                b = _bounds32(args["_ranges"], 0.0)
            else:
                b = _bounds32(args["_ranges"])
            r_idx, b_idx = np.nonzero((v[:, None] >= b[None, :, 0])
                                      & (v[:, None] < b[None, :, 1]))
        elif kind in ("key_range", "geo_ip"):
            _field(spec[1], args, truth)
            if kind == "key_range":
                inr = _ip_members(truth, docs, [_ip_interval(r) for r in
                                                args["_ranges"]])
            else:
                nets = args["_networks"]
                inr = _ip_members(truth, docs, [_ip_interval(c) for n in nets
                                                for c in n["_cidrs"]])
                assign = np.repeat(np.arange(len(nets)),
                                   [len(n["_cidrs"]) for n in nets])
                inr = np.stack([inr[:, assign == j].any(1)
                                for j in range(nb)], 1)
            r_idx, b_idx = np.nonzero(inr)
        elif kind in ("filter", "missing"):
            if kind == "filter":
                m = np.ones(len(ids), bool)
                for f, val in args["_term"].items():
                    m &= truth.cats[f][docs] == val if f in truth.cats \
                        else truth.f32[f][docs] == np.float32(val)
            else:
                m = np.zeros(len(ids), bool) \
                    if args["_field"] in truth.field_of.values() \
                    else np.ones(len(ids), bool)
            res = {"count": np.int64(m.sum())}
            subs = spec[3] if kind == "filter" else spec[2]
            if subs:
                r_idx = np.flatnonzero(m)
                res["subs"] = _sub_np(truth, docs, subs, sub_args, r_idx,
                                      np.zeros(len(r_idx), np.int64), 1)
            out.append(res)
            continue
        elif kind == "nested":
            chain = [(key, args, sub_args)]
            cur = body
            while True:
                sub = cur.get("_aggs", cur.get("_aggregations")) or {}
                nxt = [b for b in sub.values() if next(iter(b)) in _NESTABLE]
                if not nxt:
                    break
                cur = nxt[0]
                ck = next(k for k in cur if k not in ("_aggs",
                                                      "_aggregations"))
                chain.append((ck, cur[ck], _metric_subs(cur)))
            counts, subs_out = [], []
            comp = np.zeros(len(ids), np.int64)
            valid = np.ones(len(ids), bool)
            size = 1
            for lvl, (desc, (lkey, largs, lsub)) in enumerate(
                    zip(spec[1], chain)):
                c, ok = _codes(truth, si, seg, docs, desc[1], desc[2],
                               lkey, largs)
                comp = comp * desc[2] + c
                valid &= ok
                size *= desc[2]
                r_idx = np.flatnonzero(valid)
                b_idx = comp[r_idx]
                counts.append(np.bincount(b_idx, minlength=size))
                subs_out.append(_sub_np(truth, docs, spec[2][lvl], lsub,
                                        r_idx, b_idx, size)
                                if spec[2][lvl] else None)
            out.append({"counts": tuple(counts), "subs": tuple(subs_out)})
            continue
        else:
            raise ValueError(f"the oracle does not answer {kind!r}")
        subs = spec[4] if kind in ("geo_ip", "geo_trixels") else spec[3]
        counts = np.bincount(b_idx, minlength=nb)
        out.append({"counts": counts,
                    "subs": _sub_np(truth, docs, subs, sub_args, r_idx,
                                    b_idx, nb)}
                   if subs else counts)
    return tuple(out)


def oracle_search(db, truth: Truth, query, aggs=None, k: int = 10,
                  count_only=False):
    """What db.search(query, k=k, aggs=aggs, count_only=count_only) must
    return: {"total", "ranked" (segment index, docid, score, tol arrays of
    every match in rank order; not with count_only), "aggregations"}.

    Computed from the corpus's documents (``Truth``): the live rows, every
    field value, the bin grids of medians, modes and percentiles, the
    histogram buckets and their date anchor, float and geo-distance range
    members, IP range and network members (from the generated addresses
    and the request's CIDRs), filter matches and category codes (by the
    segment's category names). What it shares with the port's host code,
    and so cannot check: the query parse (``QueryDSL``, ``compile_ir``)
    and BM25's postings, term frequencies and constants, read from the
    segments; the specs' structure and the geo_trixels table
    from ``compile_for_segment`` and each doc's trixel from its segment;
    the merge and the shaping (``merge_and_shape``)."""
    from xapiand_tpu_torch import aggregations as agg_mod
    from xapiand_tpu_torch.query.dsl import QueryDSL
    from xapiand_tpu_torch.query.plan import compile_ir, resolve_special

    stats = db.stats()
    if isinstance(query, dict) and "_match_all" in query:
        per_seg = [(ids, np.zeros(len(ids)), np.zeros(len(ids)))
                   for ids in truth.live]
    else:
        ir = QueryDSL(db.schema, term_expander=db.expand_prefix).parse(query)
        cq = compile_ir(resolve_special(ir, db.scheme, stats,
                                        db.global_termfreq,
                                        db.global_collfreq),
                        cost_fn=db.global_termfreq)
        if cq.tree[0] not in ("G", "OR"):
            raise ValueError(f"the oracle answers ORs of terms: {cq.tree}")
        per_seg = _bm25_weights(db, truth, cq, stats)
    total = sum(len(ids) for ids, _s, _t in per_seg)
    out = {"total": total}
    if not count_only:
        seg_of = np.concatenate([np.full(len(ids), si) for si, (ids, _s, _t)
                                 in enumerate(per_seg)])
        did = np.concatenate([ids for ids, _s, _t in per_seg])
        sc = np.concatenate([s for _i, s, _t in per_seg])
        tol = np.concatenate([t for _i, _s, t in per_seg])
        order = np.lexsort((did, seg_of, -sc))
        out["ranked"] = (seg_of[order], did[order], sc[order], tol[order])
    if aggs:
        segs = [s.segment for s in db._searchers]
        slot_ranges = agg_mod.slot_ranges_of(segs)
        parts, cats = [], []
        names = metas = None
        for si, (seg, (ids, _s, _t)) in enumerate(zip(segs, per_seg)):
            names, specs, arrays, metas = agg_mod.compile_for_segment(
                db.schema, seg, aggs, slot_ranges=slot_ranges)
            parts.append(segment_aggs(truth, si, seg, specs, aggs, arrays,
                                      ids))
            cats_j: dict = {}
            for j, spec in enumerate(specs):
                if spec[0] == "terms" and spec[1] in seg.values:
                    cats_j[j] = seg.values[spec[1]].cat_names or []
                elif spec[0] == "geo_trixels":
                    cats_j[j] = metas[j]["cat_names"]
                elif spec[0] == "nested":
                    for lvl, d in enumerate(spec[1]):
                        if d[0] == "terms" and d[1] in seg.values:
                            cats_j[(j, lvl)] = \
                                seg.values[d[1]].cat_names or []
            cats.append(cats_j)
        out["aggregations"] = agg_mod.merge_and_shape(names, metas, parts,
                                                      cats)
    return out


def check_hits(db, result, want, k: int = 10):
    """A SearchResult against the oracle: the total; the hits the first k
    matches by (score desc, (segment, docid) asc), each score within its
    doc's float32 tolerance of the float64 score, a doc whose oracle score
    ties another's within tolerance accepted in the other's place (ties
    as groups). -> None, or what differs."""
    if result.total != want["total"]:
        return f"total {result.total} != {want['total']}"
    seg_of, did, sc, tol = want["ranked"]
    if len(result.hits) != min(k, len(did)):
        return f"{len(result.hits)} hits of {len(did)} matches"
    rows = [db._locate.get(h.id) for h in result.hits]
    if None in rows or len(set(rows)) != len(rows):
        return "a hit that is not a live doc, or twice"
    if any(a.score < b.score for a, b in zip(result.hits, result.hits[1:])):
        return "hits not in descending score order"
    key = seg_of.astype(np.int64) * 2**32 + did
    pos = {int(x): j for j, x in enumerate(key)}
    got = []
    for h, (si, d) in zip(result.hits, rows):
        j = pos.get(int(si) * 2**32 + int(d))
        if j is None:
            return f"hit {h.id} does not match"
        if abs(h.score - sc[j]) > tol[j] + 1e-5 * abs(sc[j]):
            return f"hit {h.id}: score {h.score} vs oracle {sc[j]}"
        got.append(j)
    if len(did) > len(rows):
        last = min(h.score for h in result.hits)
        rest = np.ones(len(did), bool)
        rest[got] = False
        above = rest & (sc - tol > last + 1e-5 * abs(last))
        if above.any():
            j = int(np.flatnonzero(above)[0])
            return (f"doc {(int(seg_of[j]), int(did[j]))} scores {sc[j]}, "
                    f"above the last hit {last}")
    return None


# float32 tolerance of a shaped value made from device sums: a bucket's
# sum adds up to one block's rows in a chain (R / G <= 4096 rows at the
# single-query path's widths), so its relative error is below 4096 float32
# roundings of the sum of magnitudes, 2.4e-4 worst case, and a variance
# (s2 / n - (s / n)^2) loses the digits its two terms share, up to a factor
# 10 on these fields; every other float (counts, minima, maxima, bucket
# keys, medians and percentiles off the bin grid) is exact
SUM_RTOL = {"_sum": 3e-4, "_avg": 3e-4, "_variance": 3e-3,
            "_std_deviation": 3e-3, "_sum_of_squares": 3e-4,
            "_upper": 3e-3, "_lower": 3e-3}


def compare_aggs(got, want, where="aggs"):
    """Two shaped aggregation responses: the same keys and lists, integers
    equal, floats equal but those made from float sums (SUM_RTOL, named by
    their key). -> None, or where they differ."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return f"{where}: keys {sorted(got) if isinstance(got, dict) else got} != {sorted(want)}"
        for key in want:
            err = compare_aggs(got[key], want[key], f"{where}.{key}")
            if err:
                return err
        return None
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return f"{where}: {len(got) if isinstance(got, (list, tuple)) else got} items != {len(want)}"
        for j, (g, w) in enumerate(zip(got, want)):
            err = compare_aggs(g, w, f"{where}[{j}]")
            if err:
                return err
        return None
    if isinstance(want, bool) or isinstance(want, (int, np.integer)) and \
            not isinstance(want, float):
        return None if got == want else f"{where}: {got} != {want}"
    if isinstance(want, (float, np.floating)):
        if got is None:
            return f"{where}: None != {want}"
        g, w = float(got), float(want)
        if math.isnan(w) and math.isnan(g) or g == w:
            return None
        leaf = where.rsplit(".", 1)[-1].split("[")[0]
        rtol = SUM_RTOL.get(leaf, 1e-6)
        if abs(g - w) <= rtol * abs(w):
            return None
        return f"{where}: {g} != {w}"
    return None if got == want else f"{where}: {got!r} != {want!r}"
