"""Faceted search corpus and queries, straight to Segment arrays.

The counterpart of ``scripts/config_bench.py:153-179`` (BASELINE.json
config 3, "1M docs faceted search: term filters + multivalue sort +
stats/terms aggregations") built without the analysis chain, as
``utils/synth.py`` builds the relevance corpus:

  - body: 12 tokens a doc from a 3,000-word Zipf(1.07) vocabulary ``w{i}``;
  - one category term of 40, ``cat{i}``, weights 1/(i+1)^0.8;
  - ``price`` (slot PRICE_SLOT): one value a doc, uniform in [1.00,
    1000.00] to the cent;
  - ``size`` (slot SIZE_SLOT): 1-3 distinct integers in [35, 48] a doc,
    the multi-value slot that drives exact per-value containment;
  - about 1% of docids marked deleted: a committed segment whose deletes
    wait for a merge.

Each term is indexed once (the JAX ``Database`` also indexes a field-
prefixed copy of every term, which doubles every document length alike
and leaves BM25 unchanged). Document length is 13 (12 body tokens and the
category term); ``total_doclen`` counts live documents. Value columns are
packed as ``xapiand_tpu/models/builder.py`` ``_pack_value_column`` packs
them (555-702), with ``max_vals`` set; the host-only ``raw`` values are
left out. Every draw maps ``np.random.Generator(np.random.PCG64(seed))
.random()`` through cumulative weights with ``searchsorted``, so the
corpus does not change between numpy releases.

``faceted_queries`` draws the four query families of the faceted path and
``oracle_answers`` answers them in float64 numpy from the raw values,
independently of the executor.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from xapiand_tpu_torch.models.segment import (Segment, TermInfo, ValueColumn,
                                              size_class)
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.utils import serialise as ser

PRICE_SLOT, SIZE_SLOT = 1, 2
N_WORDS, N_CATS, BODY_LEN = 3000, 40, 12
SIZE_LO, SIZE_N = 35, 14          # sizes 35..48
DELETED_FRAC = 0.01
_I32MAX = 2**31 - 1


@dataclass
class FacetedCorpus:
    seg: Segment
    price: np.ndarray      # f64[N]
    sizes: np.ndarray      # i32[N, 3], -1 past each doc's count
    deleted: np.ndarray    # bool[N]


def _pick(u, weights):
    cum = np.cumsum(np.asarray(weights, np.float64))
    return np.minimum(np.searchsorted(cum, u * cum[-1], side="right"),
                      len(cum) - 1)


def _single_column(x: np.ndarray) -> ValueColumn:
    """One float64 value a doc: _pack_value_column's first fast path."""
    nd = len(x)
    h, lo = ser.split_keys_np(ser.sortable_keys_u64_np(x))
    hi = np.full(nd + 1, _I32MAX, np.int32)
    low = np.full(nd + 1, _I32MAX, np.int32)
    fval = np.zeros(nd + 1, np.float32)
    present = np.zeros(nd + 1, bool)
    hi[:nd], low[:nd], present[:nd] = h, lo, True
    fval[:nd] = x.astype(np.float32)
    return ValueColumn(kind="numeric", hi=hi, lo=low, max_hi=hi.copy(),
                       max_lo=low.copy(), fval=fval, present=present,
                       max_vals=1)


def _multi_column(vals: np.ndarray) -> ValueColumn:
    """vals f64[N, V] in each doc's own order, NaN past its count (every
    doc has one value at least): _pack_value_column's general path."""
    nd, V = vals.shape
    cnt = (~np.isnan(vals)).sum(1)
    srt = np.sort(vals, axis=1)                # NaN last
    keys = ser.sortable_keys_u64_np(np.nan_to_num(srt))
    kmin = keys[:, 0]
    kmax = keys[np.arange(nd), cnt - 1]
    hi = np.full(nd + 1, _I32MAX, np.int32)
    lo = np.full(nd + 1, _I32MAX, np.int32)
    max_hi = np.full(nd + 1, -(2**31), np.int32)
    max_lo = np.full(nd + 1, -(2**31), np.int32)
    hi[:nd], lo[:nd] = ser.split_keys_np(kmin)
    max_hi[:nd], max_lo[:nd] = ser.split_keys_np(kmax)
    present = np.zeros(nd + 1, bool)
    present[:nd] = True
    fval = np.zeros(nd + 1, np.float32)
    fval[:nd] = vals[:, 0].astype(np.float32)    # the doc's first value
    multi = cnt > 1
    mv_len = np.zeros(nd + 1, np.int32)
    mv_len[:nd] = np.where(multi, cnt, 0)
    mv_off = np.zeros(nd + 1, np.int32)
    mv_off[:nd] = np.where(multi, np.cumsum(mv_len[:nd]) - mv_len[:nd], 0)
    flat = keys[multi][np.arange(V)[None, :] < cnt[multi][:, None]]
    mv_hi = np.full(len(flat) + 8, _I32MAX, np.int32)
    mv_lo = np.full(len(flat) + 8, _I32MAX, np.int32)
    mv_hi[:len(flat)], mv_lo[:len(flat)] = ser.split_keys_np(flat)
    return ValueColumn(kind="numeric", hi=hi, lo=lo, max_hi=max_hi,
                       max_lo=max_lo, fval=fval, present=present,
                       mv_hi=mv_hi, mv_lo=mv_lo, mv_off=mv_off,
                       mv_len=mv_len, max_vals=int(cnt.max()))


def build_faceted_corpus(n_docs: int = 1_000_000,
                         seed: int = 7) -> FacetedCorpus:
    rng = np.random.Generator(np.random.PCG64(seed))
    N = n_docs
    body = _pick(rng.random(N * BODY_LEN),
                 [1.0 / (i + 1) ** 1.07 for i in range(N_WORDS)])
    cat = _pick(rng.random(N), [1.0 / (i + 1) ** 0.8 for i in range(N_CATS)])
    cents = 100 + np.minimum((rng.random(N) * 99901).astype(np.int64), 99900)
    price = cents / 100.0
    n_sizes = 1 + np.minimum((rng.random(N) * 3).astype(np.int64), 2)
    u = rng.random((N, 3))
    v1 = np.minimum((u[:, 0] * SIZE_N).astype(np.int64), SIZE_N - 1)
    r2 = np.minimum((u[:, 1] * (SIZE_N - 1)).astype(np.int64), SIZE_N - 2)
    v2 = r2 + (r2 >= v1)
    a, b = np.minimum(v1, v2), np.maximum(v1, v2)
    v3 = np.minimum((u[:, 2] * (SIZE_N - 2)).astype(np.int64), SIZE_N - 3)
    v3 = v3 + (v3 >= a)
    v3 = v3 + (v3 >= b)
    sizes = np.stack([v1, v2, v3], 1) + SIZE_LO
    sizes = np.where(np.arange(3)[None, :] < n_sizes[:, None], sizes, -1)
    deleted = rng.random(N) < DELETED_FRAC

    # postings: (term, doc) -> wdf; body word ids first, then categories
    docs = np.arange(N, dtype=np.int64)
    key = np.concatenate([body * N + np.repeat(docs, BODY_LEN),
                          (N_WORDS + cat) * N + docs])
    uniq, counts = np.unique(key, return_counts=True)
    u_tid, u_doc = uniq // N, (uniq % N).astype(np.int32)
    term_ids, starts = np.unique(u_tid, return_index=True)
    lens = np.diff(np.append(starts, len(u_tid)))
    guard = size_class(int(lens.max()))
    P = len(u_tid) + guard
    post_docids = np.full(P, N, np.int32)
    post_docids[:len(u_doc)] = u_doc
    post_wdf = np.zeros(P, np.float32)
    post_wdf[:len(u_doc)] = counts
    doclen = np.zeros(N + 1, np.float32)
    doclen[:N] = BODY_LEN + 1
    post_doclen = doclen[np.minimum(post_docids, N)]
    wsum = np.add.reduceat(post_wdf[:len(u_doc)], starts)
    wmax = np.maximum.reduceat(post_wdf[:len(u_doc)], starts)
    terms = {}
    for tid, off, ln, cf, mw in zip(term_ids.tolist(), starts.tolist(),
                                    lens.tolist(), wsum.tolist(),
                                    wmax.tolist()):
        name = f"w{tid}" if tid < N_WORDS else f"cat{tid - N_WORDS}"
        terms[name] = TermInfo(tid=tid, offset=off, length=ln,
                               collfreq=int(cf), max_wdf=float(mw))
    dele = np.zeros(N + 1, bool)
    dele[:N] = deleted
    seg = Segment(
        num_docs=N,
        total_doclen=float(doclen[:N][~deleted].sum()),
        post_docids=post_docids, post_wdf=post_wdf, post_doclen=post_doclen,
        post_posoff=np.zeros(1, np.int32), post_poslen=np.zeros(1, np.int32),
        positions=np.zeros(128, np.int32), doclen=doclen, deleted=dele,
        terms=terms,
        values={PRICE_SLOT: _single_column(price),
                SIZE_SLOT: _multi_column(np.where(sizes >= 0, sizes,
                                                  np.nan))},
        geo={}, doc_keys=[], guard=guard)
    return FacetedCorpus(seg=seg, price=price, sizes=sizes.astype(np.int32),
                         deleted=deleted)


def fingerprint(corpus: FacetedCorpus) -> dict:
    """numpy version, a hash of the arrays, and posting and value counts."""
    seg = corpus.seg
    h = hashlib.sha256()
    for arr in (seg.post_docids, seg.post_wdf, seg.doclen, seg.deleted):
        h.update(np.ascontiguousarray(arr).tobytes())
    for slot in sorted(seg.values):
        col = seg.values[slot]
        for ch in ("hi", "lo", "max_hi", "max_lo", "fval", "present",
                   "mv_hi", "mv_lo", "mv_off", "mv_len"):
            if getattr(col, ch) is not None:
                h.update(np.ascontiguousarray(getattr(col, ch)).tobytes())
    return {"numpy": np.__version__, "sha256": h.hexdigest()[:16],
            "postings": int(sum(t.length for t in seg.terms.values())),
            "values": int(len(corpus.price) + (corpus.sizes >= 0).sum()),
            "deleted": int(corpus.deleted.sum())}


def _range_keys(lo: float, hi: float):
    return ser.sortable_key_u64(float(lo)), ser.sortable_key_u64(float(hi))


def faceted_queries(n_per_family: int = 256, seed: int = 11) -> list:
    """[(family, Q, params)] in family order A, B, C, D:

      A  AND(cat{0..19}, w{0..200}), sorted by price desc (config 3);
      B  A and price in [p, p+100], p an integer in [1, 900], same sort;
      C  AND(w{0..200}, size in [s, s+1]), s in [35, 47], by relevance;
      D  AND_NOT(OR(w_a, w_b), cat{0..19}), a != b, by relevance."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def ints(n, hi):   # n integers uniform in [0, hi)
        return np.minimum((rng.random(n) * hi).astype(np.int64), hi - 1)

    n = n_per_family
    out = []
    for c, w in zip(ints(n, 20), ints(n, 201)):
        out.append(("A", Q.and_(Q.term(f"cat{c}"), Q.term(f"w{w}")),
                    {"cat": int(c), "w": int(w)}))
    for c, w, p in zip(ints(n, 20), ints(n, 201), 1 + ints(n, 900)):
        lo, hi = _range_keys(p, p + 100)
        out.append(("B", Q.and_(Q.term(f"cat{c}"), Q.term(f"w{w}"),
                                Q.value_range(PRICE_SLOT, lo, hi)),
                    {"cat": int(c), "w": int(w), "p": int(p)}))
    for w, s in zip(ints(n, 201), SIZE_LO + ints(n, 13)):
        lo, hi = _range_keys(s, s + 1)
        out.append(("C", Q.and_(Q.term(f"w{w}"),
                                Q.value_range(SIZE_SLOT, lo, hi)),
                    {"w": int(w), "s": int(s)}))
    for a, b, j in zip(ints(n, 201), ints(n, 200), ints(n, 20)):
        b = b + (b >= a)
        out.append(("D", Q.and_not(Q.or_(Q.term(f"w{a}"), Q.term(f"w{b}")),
                                   Q.term(f"cat{j}")),
                    {"a": int(a), "b": int(b), "cat": int(j)}))
    return out


def oracle_answers(corpus: FacetedCorpus, queries: list, k: int = 10,
                   rtol: float = 1e-5) -> list:
    """float64 answers from the raw values: set algebra over the postings
    minus deleted docs, value tests on the raw values, BM25 in float64.
    -> per query {"count", "ranked": [(docid, score)]}: A and B by (price
    desc, docid asc), the first k; C and D by (score desc, docid asc),
    every doc scoring within rtol of the k-th score or above it (their
    tie groups)."""
    seg = corpus.seg
    N = seg.num_docs
    live = ~corpus.deleted
    avg = seg.avg_doclen
    nd = int(seg.doc_count)
    cache: dict = {}

    def post(t):
        """(docids ascending, float64 BM25 of each) of term t."""
        if t not in cache:
            ti = seg.terms[t]
            sl = slice(ti.offset, ti.offset + ti.length)
            n = ti.length
            tw = (nd - n + 0.5) / (n + 0.5)
            if tw < 2.0:
                tw = tw * 0.5 + 1.0
            tc = np.log(tw) * 2.0     # BM25 k1 = k3 = 1, wqf 1
            wdf = seg.post_wdf[sl].astype(np.float64)
            nl = np.maximum(seg.post_doclen[sl].astype(np.float64) / avg,
                            0.5)
            cache[t] = (seg.post_docids[sl].astype(np.int64),
                        tc * wdf / (nl * 0.5 + 0.5 + wdf))
        return cache[t]

    def has(t):
        m = np.zeros(N, bool)
        m[post(t)[0]] = True
        return m

    def score(t, docs):
        d, s = post(t)
        i = np.minimum(np.searchsorted(d, docs), len(d) - 1)
        return np.where(d[i] == docs, s[i], 0.0)

    out = []
    for fam, _q, p in queries:
        if fam in ("A", "B"):
            tc, tw = f"cat{p['cat']}", f"w{p['w']}"
            m = has(tc) & has(tw) & live
            if fam == "B":
                m &= (corpus.price >= p["p"]) & (corpus.price <= p["p"] + 100)
            idx = np.flatnonzero(m)
            top = idx[np.lexsort((idx, -corpus.price[idx]))][:k]
            sc = score(tc, top) + score(tw, top)
            out.append({"count": len(idx),
                        "ranked": list(zip(top.tolist(), sc.tolist()))})
            continue
        if fam == "C":
            inr = ((corpus.sizes >= p["s"]) & (corpus.sizes <= p["s"] + 1)
                   ).any(1)
            idx = np.flatnonzero(has(f"w{p['w']}") & live & inr)
            sc = score(f"w{p['w']}", idx)
        else:
            ta, tb = f"w{p['a']}", f"w{p['b']}"
            idx = np.flatnonzero((has(ta) | has(tb)) & ~has(f"cat{p['cat']}")
                                 & live)
            sc = score(ta, idx) + score(tb, idx)
        order = np.lexsort((idx, -sc))
        idx, sc = idx[order], sc[order]
        if len(idx) > k:
            keep = sc >= sc[k - 1] * (1 - 2 * rtol)
            idx, sc = idx[keep], sc[keep]
        out.append({"count": int(len(order)),
                    "ranked": list(zip(idx.tolist(), sc.tolist()))})
    return out


SORT_TEST_SLOT, MISSING_SLOT = 90, 91
SORT_TEST_SPECS = (   # every sort_topk key kind, ascending and descending
    (("value", SORT_TEST_SLOT, False),),
    (("value", SORT_TEST_SLOT, True), ("score", None, True)),
    (("score", None, False), ("value", MISSING_SLOT, True)),
    (("dist", SORT_TEST_SLOT, False),),
    (("dist", SORT_TEST_SLOT, True), ("value", PRICE_SLOT, False)),
    (("geodist", SORT_TEST_SLOT, False),),
    (("geodist", SORT_TEST_SLOT, True),),
    (("strmetric", SORT_TEST_SLOT, False, 64),),
    (("strmetric", SORT_TEST_SLOT, True, 64),),
    (("docid", None, False),),
)


def sort_test_inputs(n_docs: int, batch: int, seed: int = 5):
    """Synthetic inputs for the sort key kinds the faceted queries do not
    drive: a value column for SORT_TEST_SLOT (hi/lo words, a tenth of the
    docs absent, fval for dist, fval/fval2 as lat/lon for geodist, category
    codes -1..39 for strmetric), per-query targets f32[batch, 2, 2] and a
    strmetric table f32[batch, 64] (inf past 40 codes). numpy arrays."""
    rng = np.random.Generator(np.random.PCG64(seed))
    n = n_docs + 1
    col = {
        "hi": (rng.random(n) * 64).astype(np.int32) - 32,
        "lo": ((rng.random(n) - 0.5) * 2**32).astype(np.int64)
        .astype(np.int32),
        "present": rng.random(n) >= 0.1,
        "fval": (rng.random(n) * 180 - 90).astype(np.float32),
        "fval2": (rng.random(n) * 360 - 180).astype(np.float32),
        "cats": (rng.random(n) * 41).astype(np.int32) - 1,
    }
    col["max_hi"], col["max_lo"] = col["hi"].copy(), col["lo"].copy()
    targets = np.stack([rng.random((batch, 2)) * 180 - 90,
                        rng.random((batch, 2)) * 360 - 180], 2) \
        .astype(np.float32)
    strtab = np.full((batch, 64), np.inf, np.float32)
    strtab[:, :40] = rng.random((batch, 40))
    return col, targets, strtab
