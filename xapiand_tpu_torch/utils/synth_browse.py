"""Browse traffic over the faceted corpus, and its float64 oracle.

The queries a shop or a catalogue sends besides its keyword searches, over
``utils/synth_faceted.py``'s corpus (3,000 words, 40 categories as a string
column, a price, a multi-value size, 1% deleted). Five families, each a
documented request shape:

  M  ``match_all AND price in [p, p+100]``, sorted by price descending, with
     config 3's aggregations and the cardinality of ``size`` (``BROWSE_AGGS``):
     a category page with its facets and "n distinct sizes". Dense, no term.
  N  ``AND_NOT(match_all, OR(w, w))``: "everything but". Dense with term
     masks; docid order, the scores returned (0: no match holds a term).
  S  ``OR(synonym(w1, w2, w3), w4)`` by relevance: a search with synonym
     expansion. The three words act as one term: their wdf summed per doc
     and scored once, with the term frequency min(sum of the three, N).
  X  ``max_(w1, w2, AND(w3, w4))`` by relevance: dis-max over alternative
     fields or spellings. A doc's score is the largest of its branch sums.
  C  one query a call through ``SegmentSearcher.execute`` with
     ``collapse_slot`` the category: "the best offer per category". The
     first half ``OR(w, w, w)`` by relevance with ``collapse_max`` 1 or 3;
     the second half dense and sorted by price descending: ``match_all``
     alone with ``collapse_max`` 1..8, then ``match_all AND price range``
     with ``collapse_max`` 1 or 3.

Words are drawn Zipf(1.07)-weighted from the corpus vocabulary, distinct
within a query, the way ``faceted_queries`` draws: ``Generator(PCG64(seed))
.random()`` mapped through cumulative weights, so the queries do not change
between numpy releases.

``oracle_answers`` answers them in float64 numpy from the raw values and the
postings, independently of the executor. The rules it holds the system to
are the JAX package's:

  - a branch sum of ``max_`` adds the weights of the branch's terms the doc
    holds, whether or not the branch itself matches (executor.py 787-797);
  - a collapse keeps per category the best ``min(collapse_max, 8)`` matches
    by (score descending, docid ascending) - under a value sort too, where
    every score of a plan without terms is 0, so the lowest docids stay -
    and the count is taken before it;
  - the cardinality of a multi-value column counts each doc's one key, its
    smallest value (the column's ``hi`` / ``lo``).

``hash32_np`` and ``hll_registers`` replicate ``_hash32`` and the 1024
HyperLogLog registers (p = 10) of the cardinality aggregation in numpy.
"""

from __future__ import annotations

import numpy as np

from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.utils import serialise as ser
from xapiand_tpu_torch.utils import synth_faceted as sf

BROWSE_AGGS = {**sf.CFG3_AGGS,
               "sizes": {"_cardinality": {"_field": "size"}}}
HLL_P, HLL_M = 10, 1024
COLLAPSE_CAP = 8


def hash32_np(hi, lo) -> np.ndarray:
    """_hash32 (xapiand_tpu/ops/aggs.py 40-49) of int32 arrays: murmur3
    fmix32 of hi ^ lo * 0x9E3779B9 in uint32 arithmetic -> uint32."""
    M = np.uint64(0xFFFFFFFF)
    hi = np.asarray(hi).astype(np.int64).astype(np.uint64) & M
    lo = np.asarray(lo).astype(np.int64).astype(np.uint64) & M
    h = hi ^ ((lo * np.uint64(0x9E3779B9)) & M)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & M
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & M
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32)


def hll_registers(hi, lo) -> np.ndarray:
    """The 1024 registers of the keys (hi, lo): register h >> 22 holds the
    largest rho, rho = 23 where the low 22 bits are 0, else the count of
    leading zeros of h << 10, plus 1. -> int32[1024]."""
    h = hash32_np(hi, lo).astype(np.uint64)
    rest = (h << np.uint64(HLL_P)) & np.uint64(0xFFFFFFFF)
    # clz of a uint32 = 32 - bit length; frexp's exponent is the bit length
    blen = np.frexp(rest.astype(np.float64))[1]
    rho = np.where(rest == 0, 32 - HLL_P + 1, 32 - blen + 1).astype(np.int32)
    regs = np.zeros(HLL_M, np.int32)
    np.maximum.at(regs, (h >> np.uint64(32 - HLL_P)).astype(np.int64), rho)
    return regs


def browse_queries(n_m: int = 256, n_n: int = 128, n_s: int = 256,
                   n_x: int = 256, n_c: int = 128, seed: int = 11) -> list:
    """[(family, Q, params)] in family order M, N, S, X, C. params holds
    the drawn words (``w``: vocabulary indices), the price range's ``p``,
    and for C ``collapse_max`` and ``sorted`` (the dense, price-sorted
    half)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    weights = [1.0 / (i + 1) ** 1.07 for i in range(sf.N_WORDS)]

    def words(n, each):
        """n draws of ``each`` distinct words."""
        out = []
        for row in sf._pick(rng.random((n, 4 * each)), weights).tolist():
            seen = list(dict.fromkeys(row))[:each]
            if len(seen) < each:
                raise ValueError("fewer distinct words than a query needs")
            out.append(seen)
        return out

    def prices(n):
        return (1 + np.minimum((rng.random(n) * 900).astype(np.int64),
                               899)).tolist()

    def price_range(p):
        return Q.value_range(sf.PRICE_SLOT, ser.sortable_key_u64(float(p)),
                             ser.sortable_key_u64(float(p + 100)))

    def t(i):
        return Q.term(f"w{i}")

    out = []
    for p in prices(n_m):
        out.append(("M", Q.and_(Q.match_all(), price_range(p)), {"p": p}))
    for w in words(n_n, 2):
        out.append(("N", Q.and_not(Q.match_all(), Q.or_(t(w[0]), t(w[1]))),
                    {"w": w}))
    for w in words(n_s, 4):
        out.append(("S", Q.or_(Q.synonym([f"w{i}" for i in w[:3]]), t(w[3])),
                    {"w": w}))
    for w in words(n_x, 4):
        out.append(("X", Q.max_(t(w[0]), t(w[1]), Q.and_(t(w[2]), t(w[3]))),
                    {"w": w}))
    half = n_c // 2
    for i, w in enumerate(words(half, 3)):
        out.append(("C", Q.or_terms([f"w{j}" for j in w]),
                    {"w": w, "collapse_max": 1 if i % 2 == 0 else 3,
                     "sorted": False}))
    for i, p in enumerate(prices(n_c - half)):
        if i < COLLAPSE_CAP:
            out.append(("C", Q.match_all(),
                        {"p": None, "collapse_max": i + 1, "sorted": True}))
        else:
            out.append(("C", Q.and_(Q.match_all(), price_range(p)),
                        {"p": p, "collapse_max": 1 if i % 2 == 0 else 3,
                         "sorted": True}))
    return out


def oracle_answers(corpus: sf.FacetedCorpus, queries: list, k: int = 10,
                   rtol: float = 1e-5) -> list:
    """Per query {"count", "ranked": [(docid, score)], ...}:

      M, sorted C   "ranked" the first k by (price desc, docid asc), scores 0
      N             "ranked" the first k docids ascending, scores 0
      S, X          "ranked" by (score desc, docid asc), every doc scoring
                    within rtol of the k-th score or above it
      relevance C   "ranked" the collapse's survivors likewise, and "maybe":
                    {docid: score} of every match that survives when scores
                    within rtol count as tied (a superset of the survivors)
      M             also "aggs": "cats" and "price" as synth_faceted's
                    oracle has them, "sizes" the number of distinct smallest
                    sizes of the matched docs, and "hll" their registers.

    "count" is the number of matches, before any collapse."""
    seg = corpus.seg
    N = seg.num_docs
    live = ~corpus.deleted
    avg = seg.avg_doclen
    nd = int(seg.doc_count)
    ncats = len(corpus.cat_names)
    size_col = seg.values[sf.SIZE_SLOT]
    min_size = np.where(corpus.sizes >= 0, corpus.sizes, 2**31 - 1).min(1)
    doclen = seg.doclen[:N].astype(np.float64)
    cache: dict = {}

    def tconst(n):
        tw = (nd - n + 0.5) / (n + 0.5)
        if tw < 2.0:
            tw = tw * 0.5 + 1.0
        return np.log(tw) * 2.0          # BM25 k1 = k3 = 1, wqf 1

    def bm25(wdf, doclen, tc):
        nl = np.maximum(doclen / avg, 0.5)
        return tc * wdf / (nl * 0.5 + 0.5 + wdf)

    def post(i):
        """(docids ascending, wdf) of word i."""
        ti = seg.terms[f"w{i}"]
        sl = slice(ti.offset, ti.offset + ti.length)
        return seg.post_docids[sl], seg.post_wdf[sl]

    def wdf(i):
        """float64[N]: word i's wdf in every doc, 0 where it is absent."""
        if i not in cache:
            if len(cache) >= 64:           # the frequent words recur
                cache.pop(next(iter(cache)))
            out_ = np.zeros(N, np.float64)
            d, w = post(i)
            out_[d] = w
            cache[i] = out_
        return cache[i]

    def has(i):
        return wdf(i) > 0

    def score(i, docs):
        return bm25(wdf(i)[docs], doclen[docs], tconst(len(post(i)[0])))

    def in_range(p):
        return (corpus.price >= p) & (corpus.price <= p + 100)

    def by_price(idx):
        return idx[np.lexsort((idx, -corpus.price[idx]))]

    def tie_cut(idx, sc):
        order = np.lexsort((idx, -sc))
        idx, sc = idx[order], sc[order]
        if len(idx) > k:
            keep = sc >= sc[k - 1] * (1 - 2 * rtol)
            idx, sc = idx[keep], sc[keep]
        return list(zip(idx.tolist(), sc.tolist()))

    def zeros(idx):
        return [(int(d), 0.0) for d in idx[:k]]

    out = []
    for fam, _q, p in queries:
        if fam == "M":
            idx = np.flatnonzero(live & in_range(p["p"]))
            pr = corpus.price[idx]
            out.append({
                "count": len(idx), "ranked": zeros(by_price(idx)),
                "aggs": {
                    "cats": np.bincount(corpus.cat_codes[idx],
                                        minlength=ncats),
                    "price": (float(len(idx)), float(pr.sum()),
                              float((pr * pr).sum()),
                              float(pr.min()) if len(idx) else np.inf,
                              float(pr.max()) if len(idx) else -np.inf),
                    "sizes": len(np.unique(min_size[idx])),
                    "hll": hll_registers(size_col.hi[idx], size_col.lo[idx])}})
        elif fam == "N":
            a, b = p["w"]
            idx = np.flatnonzero(live & ~(has(a) | has(b)))
            out.append({"count": len(idx), "ranked": zeros(idx)})
        elif fam == "S":
            w1, w2, w3, w4 = p["w"]
            idx = np.flatnonzero(live & (has(w1) | has(w2) | has(w3) |
                                         has(w4)))
            ssum = wdf(w1)[idx] + wdf(w2)[idx] + wdf(w3)[idx]
            tf = min(sum(len(post(i)[0]) for i in (w1, w2, w3)), max(nd, 1))
            dl = doclen[idx]
            syn = np.where(ssum > 0,
                           bm25(ssum, np.where(dl > 0, dl, 1.0), tconst(tf)),
                           0.0)
            out.append({"count": len(idx),
                        "ranked": tie_cut(idx, syn + score(w4, idx))})
        elif fam == "X":
            w1, w2, w3, w4 = p["w"]
            idx = np.flatnonzero(live & (has(w1) | has(w2) |
                                         (has(w3) & has(w4))))
            sc = np.maximum(np.maximum(score(w1, idx), score(w2, idx)),
                            score(w3, idx) + score(w4, idx))
            out.append({"count": len(idx), "ranked": tie_cut(idx, sc)})
        elif p["sorted"]:
            m = live if p["p"] is None else live & in_range(p["p"])
            idx = np.flatnonzero(m)
            # every score is 0: per category the lowest docids stay
            cat = corpus.cat_codes[idx]
            order = np.argsort(cat, kind="stable")
            start = np.searchsorted(cat[order], np.arange(ncats))
            rank = np.empty(len(idx), np.int64)
            rank[order] = np.arange(len(idx)) - start[cat[order]]
            keep = idx[rank < min(p["collapse_max"], COLLAPSE_CAP)]
            out.append({"count": len(idx), "ranked": zeros(by_price(keep))})
        else:
            a, b, c = p["w"]
            idx = np.flatnonzero(live & (has(a) | has(b) | has(c)))
            sc = score(a, idx) + score(b, idx) + score(c, idx)
            cmax = min(p["collapse_max"], COLLAPSE_CAP)
            cat = corpus.cat_codes[idx]
            order = np.lexsort((idx, -sc, cat))
            cs, ss = cat[order], sc[order]
            start = np.searchsorted(cs, np.arange(ncats))
            pos = np.arange(len(idx)) - start[cs]
            keep = pos < cmax
            # a match may survive if fewer than cmax of its category beat
            # it by more than rtol: compare with the category's cmax-th
            # best score
            nth = np.full(ncats, -np.inf)
            at = start + cmax - 1
            end = np.append(start[1:], len(idx))
            full = at < end
            nth[full] = ss[at[full]]
            maybe = ss >= nth[cs] * (1 - 2 * rtol)
            out.append({
                "count": len(idx),
                "ranked": tie_cut(idx[order][keep], ss[keep]),
                "maybe": dict(zip(idx[order][maybe].tolist(),
                                  ss[maybe].tolist()))})
    return out
