"""Every weight scheme over the port's synthetic corpora, and its float64
oracle.

``SCHEME_CONFIGS`` are the 20 configurations the schemes path runs: the 15
schemes besides BM25 at the JAX package's defaults, LM's four other
smoothings, and BM25 as the control. ``CATALOGUE_SCHEMES`` are the four
the catalogue (``utils/synth_browse.py``'s families) runs under: TfIdf (one
constant a term), PL2 (two), DiceCoeff (uniqterms and the query length)
and LM absolute discount (two constants and uniqterms).

``real_stats``, ``uniqterms`` and ``real_collfreq`` give a corpus the
statistics the schemes read, as a deployment has them: ``doclen_upper``
the largest live doclen, ``total_len`` the collection's length, per doc
its distinct terms, per term the sum of its wdf. Without them
``doclen_upper`` is 1, so every LM score is 0, every ``uniqterms`` is 1,
and on utils/synth.py's corpus every collection frequency is the term's
document frequency.

``sumpart64`` is the JAX formulas (``xapiand_tpu/models/weights.py``
164-575) in float64 numpy from the scheme's public parameters, with the
error scale S of each posting: a float32 evaluation in JAX's operation
order lies within ``ERR_ULPS * 2**-24 * S`` of the float64 value. S is
each formula's condition, derived from its terms:

  BM25, BM25Plus, TfIdf, Trad, Coord, DiceCoeff: |w|, sums and products
      of positive terms - a relative error of a few roundings;
  the DFR normalisation wdfn = wdf log2(1 + c avg / len): 1 + x rounds to
      one ulp of 1, so wdfn is uncertain by e = 1.5 wdf ulps however small
      x is (a long doc in a collection of short ones); InL2, IfB2, IneB2:
      |w| + |t| e / (wdfn + 1)^2, t = tc0 (InL2) or tc0 tc1;
  PL2 (PL2Plus adds its delta term alike): |tc0| / (wdfn + 1) times
      |P1| + |(wdfn + .5) log2 wdfn| + |P2 wdfn| + 2 wdfn + (|dP/dwdfn| +
      |P| / (wdfn + 1)) e (P's three terms and wdfn's error);
  DLH: |tc0| / (wdf + .5) times |A| + |B| + |C| + 2 wdf + 2 len, and DPH
      |tc0| (norm (|A| + |C| + 2 wdf + 2 len) + |wt| 2 / (1 - f)): the
      three log2 terms, and 1 - f, whose rounding (one ulp of 1) moves
      (len - wdf) log2(1 - f) by up to len / ln 2 ulps;
  LM: |tc0| (1 + |log(product)|): the product's relative error is the log's
      absolute error;
  BB2: |tc0| / (wdfn + 1) times (y1 + .5)(|sc1| + |log2 y1|) + (wdfn + 1)
      |sc1| + (y2 + .5)(|sc2| + |log2 y2|) + wdfn |sc2| + |wt|. Its
      Stirling terms subtract two logarithms near log2 N = 20 (one ulp,
      1.9e-6) and multiply the difference by y1 ~ N: a float32 BB2 weight
      is uncertain by units, in JAX as in the port (ROADMAP queue 3).

A threshold (wdf > 0 exact; P > 0, w > 0, wt > 0, product > 1) that
flips between two evaluations moves the weight by at most the error of
the value it tests, which the same S bounds. A doc's score adds its
postings' weights in float32, so its tolerance is the sum of their
bounds plus (T + 1) roundings of the sum of their magnitudes
(``doc_tolerance``).

``relevance_answers`` and ``catalogue_answers`` answer the relevance ORs
and the browse families N, S, X and relevance C under any scheme;
``match_ranked`` and ``match_collapsed`` hold a result to them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme

U32 = 2.0 ** -24          # float32 unit roundoff
ERR_ULPS = 8              # K of the per-posting bound K * U32 * S (3.2 seen)
SENTINEL = 2**31 - 1

SCHEME_CONFIGS = (
    ("bm25", "bm25", {}),
    ("bm25plus", "bm25plus", {}),
    ("tfidf", "tfidf", {}),
    ("trad", "trad", {}),
    ("bool", "bool", {}),
    ("coord", "coord", {}),
    ("dicecoeff", "dicecoeff", {}),
    ("inl2", "inl2", {}),
    ("ifb2", "ifb2", {}),
    ("ineb2", "ineb2", {}),
    ("bb2", "bb2", {}),
    ("pl2", "pl2", {}),
    ("pl2plus", "pl2plus", {}),
    ("dlh", "dlh", {}),
    ("dph", "dph", {}),
    ("lm", "lm", {}),
    ("lm-jelinek_mercer", "lm", {"smoothing": "jelinek_mercer"}),
    ("lm-dirichlet", "lm", {"smoothing": "dirichlet"}),
    ("lm-dirichlet_plus", "lm", {"smoothing": "dirichlet_plus"}),
    ("lm-absolute_discount", "lm", {"smoothing": "absolute_discount"}),
)
CATALOGUE_SCHEMES = (
    ("tfidf", "tfidf", {}),
    ("pl2", "pl2", {}),
    ("dicecoeff", "dicecoeff", {}),
    ("lm-absolute_discount", "lm", {"smoothing": "absolute_discount"}),
)


def make(config) -> object:
    """The port's scheme of a (label, name, params) configuration."""
    _label, name, params = config
    return get_scheme(name, **params)


def uniqterms(seg) -> np.ndarray:
    """f32[ND+1]: each doc's distinct terms (each posting row of a real doc
    is one term of it), 1 at the pad row."""
    nd = seg.num_docs
    ids = np.asarray(seg.post_docids)
    out = np.bincount(ids[ids < nd], minlength=nd + 1).astype(np.float32)
    out[nd] = 1.0
    return out


def real_collfreq(seg) -> None:
    """Set each term's collection frequency to the sum of its wdf, in
    place (utils/synth.py sets it to the term's document frequency, which
    keeps every F / N below 1: PL2Plus would score nothing)."""
    wdf = np.asarray(seg.post_wdf, np.float64)
    csum = np.concatenate([[0.0], np.cumsum(wdf)])
    for name, ti in list(seg.terms.items()):
        cf = int(round(csum[ti.offset + ti.length] - csum[ti.offset]))
        seg.terms[name] = dataclasses.replace(ti, collfreq=cf)


def real_stats(seg) -> CollectionStats:
    """The segment's statistics, doclen_upper and total_len included."""
    live = ~np.asarray(seg.deleted[:seg.num_docs])
    dl = np.asarray(seg.doclen[:seg.num_docs])
    return CollectionStats(
        doc_count=seg.doc_count, avg_doclen=seg.avg_doclen,
        doclen_lower=1.0,
        doclen_upper=float(dl[live].max()) if live.any() else 1.0,
        total_len=float(seg.total_doclen))


def stats_dict(st: CollectionStats) -> dict:
    """The stats dict SegmentSearcher.execute takes."""
    return {"N": float(st.doc_count), "avg_doclen": float(st.avg_doclen),
            "doclen_lower": float(st.doclen_lower),
            "doclen_upper": float(st.doclen_upper),
            "total_len": float(st.total_len)}


def _log2(x):
    return np.log2(np.maximum(x, 1e-300))


def sumpart64(scheme, wdf, dl, tc, stats: CollectionStats, uniq=None):
    """(w, S) float64[L]: the JAX formula of ``scheme`` per posting and its
    error scale. wdf, dl float64[L]; tc a tuple of n_constants float64
    arrays (or scalars): the plan's float32 constants; uniq float64[L] or
    None (1)."""
    wdf = np.asarray(wdf, np.float64)
    dl = np.asarray(dl, np.float64)
    tc0 = np.asarray(tc[0], np.float64)
    N = float(stats.doc_count)
    avg = float(stats.avg_doclen)
    name = scheme.name
    zero = np.zeros_like(wdf)
    if name in ("bm25", "bm25plus"):
        lf = 0.0 if (scheme.k2 == 0 and (scheme.b == 0 or scheme.k1 == 0)) \
            or not avg > 0 else 1.0 / avg
        normlen = np.maximum(dl * lf, scheme.min_normlen)
        denom = scheme.k1 * (normlen * scheme.b + (1.0 - scheme.b)) + wdf
        part = wdf / np.maximum(denom, 1e-9)
        if name == "bm25":
            w = tc0 * part
        else:
            w = np.where(wdf > 0, tc0 * (part + scheme.delta /
                                         (scheme.k1 + 1.0)), 0.0)
        return w, np.abs(w)
    if name == "tfidf":
        w = tc0 * wdf
        return w, np.abs(w)
    if name == "trad":
        if scheme.k == 0:
            w = tc0 * np.ones_like(wdf)
        else:
            denom = scheme.k * dl / max(avg, 1e-9) + wdf
            w = tc0 * (wdf / np.maximum(denom, 1e-9))
        return w, np.abs(w)
    if name == "bool":
        return zero, zero
    if name == "coord":
        w = tc0 * np.ones_like(wdf)
        return w, np.abs(w)
    if name == "dicecoeff":
        u = np.ones_like(wdf) if uniq is None else np.asarray(uniq,
                                                                np.float64)
        w = np.where(wdf > 0, tc0 * 2.0 / (float(stats.query_length) + u),
                     0.0)
        return w, np.abs(w)
    if name == "lm":
        wc = np.asarray(tc[1], np.float64)
        s1, s2 = scheme.s1, scheme.s2
        ln = np.maximum(dl, 1.0)
        sm = scheme.smoothing
        if sm == "jelinek_mercer":
            ws = s1 * wc + (1.0 - s1) * wdf / ln
        elif sm == "dirichlet":
            ws = (wdf + s1 * wc) / (ln + s1)
        elif sm == "dirichlet_plus":
            ws = (1.0 + wdf / (s1 * wc)) * (1.0 + s2 / (s1 * wc))
        elif sm == "absolute_discount":
            u = np.ones_like(wdf) if uniq is None else np.asarray(
                uniq, np.float64)
            ws = np.maximum(wdf - s1, 0.0) / ln + (s1 * wc * u) / ln
        else:
            ws = (1.0 - s1) * (wdf + s2 * wc) / (ln + s2) + s1 * wc
        pl = scheme.param_log if scheme.param_log > 0 else \
            float(stats.doclen_upper)
        product = ws * pl
        lg = np.log(np.maximum(product, 1.0))
        w = np.where((wdf > 0) & (product > 1.0), tc0 * lg, 0.0)
        return w, np.abs(tc0) * (1.0 + np.abs(np.log(np.maximum(product,
                                                                1e-300))))
    # the DFR family; wdfn's error scale: 1 + c*avg/len rounds to one ulp
    # of 1, which moves log2 by 1/ln 2 ulps whatever its size
    if name in ("inl2", "ifb2", "ineb2", "bb2", "pl2", "pl2plus"):
        wdfn = wdf * np.log2(1.0 + scheme.c * avg / np.maximum(dl, 1.0))
        ew = 1.5 * wdf
    if name in ("inl2", "ifb2", "ineb2"):
        t = tc0 if name == "inl2" else tc0 * np.asarray(tc[1], np.float64)
        w = np.where(wdf > 0, t * wdfn / (wdfn + 1.0), 0.0)
        return w, np.abs(w) + np.abs(t) * ew / (wdfn + 1.0) ** 2
    F = np.asarray(tc[1], np.float64)
    if name == "bb2":
        wdfn = np.minimum(wdfn, F - 1.0)
        Nb = max(N, 2.0)
        wt = -1.0 / math.log(2.0) - math.log2(Nb - 1.0)
        sc1 = _log2(Nb + F - 1.0)
        sc2 = _log2(F)
        y2 = F - wdfn
        y1 = (Nb - 2.0) + y2
        l1, l2 = _log2(np.maximum(y1, 1e-9)), _log2(np.maximum(y2, 1e-9))
        st = ((y1 + 0.5) * (sc1 - l1) + (wdfn + 1.0) * sc1) - \
            ((y2 + 0.5) * (sc2 - l2) + wdfn * sc2)
        w = tc0 / (wdfn + 1.0) * (wt + st)
        # d(wt + st)/dwdfn, for wdfn's own error
        dst = -(sc1 - l1) + (y1 + 0.5) / (y1 * math.log(2.0)) + sc1 + \
            (sc2 - l2) - (y2 + 0.5) / (np.maximum(y2, 1e-9) * math.log(2.0)) \
            - sc2
        S = np.abs(tc0) / (wdfn + 1.0) * (
            (y1 + 0.5) * (np.abs(sc1) + np.abs(l1)) + (wdfn + 1.0) *
            np.abs(sc1) + (y2 + 0.5) * (np.abs(sc2) + np.abs(l2)) +
            wdfn * np.abs(sc2) + abs(wt) +
            (np.abs(dst) + np.abs(wt + st) / (wdfn + 1.0)) * ew)
        return np.where((wdf > 0) & (w > 0), w, 0.0), S
    if name in ("pl2", "pl2plus"):
        mean = F / max(N, 1.0)
        P1 = mean / math.log(2.0) + 0.5 * math.log2(2.0 * math.pi)
        P2 = _log2(mean) + 1.0 / math.log(2.0)

        def terms(x):
            a = (x + 0.5) * _log2(np.maximum(x, 1e-9))
            return P1 + a - P2 * x, np.abs(P1) + np.abs(a) + np.abs(P2 * x)

        P, sP = terms(wdfn)
        x = np.maximum(wdfn, 1e-9)
        dP = _log2(x) + (wdfn + 0.5) / (x * math.log(2.0)) - P2
        S = np.abs(tc0) * (sP + 2.0 * wdfn + (np.abs(dP) + np.abs(P) /
                                              (wdfn + 1.0)) * ew) / \
            (wdfn + 1.0)
        if name == "pl2":
            w = tc0 * P / (wdfn + 1.0)
            return np.where((wdf > 0) & (P > 0), w, 0.0), S
        d = scheme.delta
        Pd, sPd = terms(np.full_like(wdfn, d))
        wt = P / (wdfn + 1.0) + Pd / (d + 1.0)
        S = S + np.abs(tc0) * sPd / (d + 1.0)
        return np.where((wdf > 0) & (mean >= 1.0) & (wt > 0), tc0 * wt,
                        0.0), S
    if name in ("dlh", "dph"):
        log_const = avg * N / F
        ln = np.maximum(dl, 1.0)
        f = wdf / ln
        omf = np.clip(1.0 - f, 1e-9, 1.0)
        wdfs = np.maximum(wdf, 1e-9)
        A = wdf * _log2(np.maximum(f * log_const, 1e-30))
        C = 0.5 * _log2(2.0 * math.pi * wdfs * omf)
        ok = (wdf > 0) & (wdf < ln)
        if name == "dlh":
            B = (ln - wdf) * _log2(omf)
            wt = A + B + C
            w = tc0 * wt / (wdfs + 0.5)
            S = np.abs(tc0) / (wdfs + 0.5) * (np.abs(A) + np.abs(B) +
                                              np.abs(C) + 2 * wdf + 2 * ln)
        else:
            norm = omf * omf / (wdf + 1.0)
            wt = norm * (A + C)
            w = tc0 * wt
            S = np.abs(tc0) * (norm * (np.abs(A) + np.abs(C) + 2 * wdf +
                                       2 * ln) + np.abs(wt) * 2.0 / omf)
        return np.where(ok & (wt > 0), w, 0.0), S
    raise ValueError(f"no float64 formula for scheme {name!r}")


def nan_when_not_scoring(scheme, stats) -> bool:
    """Whether the scheme's float32 weight is NaN at a non-scoring term's
    constants of 0 (PL2, PL2Plus, DLH, DPH, BB2, LM dirichlet_plus): JAX
    multiplies it by the scoring flag 0 and keeps the NaN in the doc's sum
    (executor.py:722), and so does the port (csrc/common.cuh scored)."""
    zero = (0.0,) * scheme.n_constants if scheme.n_constants > 1 else 0.0
    w = scheme.sumpart(np.float32(2.0), np.float32(20.0), zero, stats,
                       uniq=np.float32(4.0) if scheme.needs_uniqterms
                       else None)
    return bool(np.isnan(float(w) * 0.0))


def doc_tolerance(S_sum, abs_sum, n_terms):
    """A doc's float32 score tolerance from its postings' summed error
    scales and magnitudes."""
    return ERR_ULPS * U32 * S_sum + (n_terms + 1) * U32 * abs_sum


def _tconst(scheme, stats, tf, cf):
    """The plan's float32 constants of a term (query/plan.py bind), as
    float64 values."""
    tc = scheme.term_constant(stats, tf, 1, 1.0, collfreq=cf) if tf > 0 \
        else ((0.0,) * scheme.n_constants if scheme.n_constants > 1 else 0.0)
    tc = np.asarray(tc, np.float32).astype(np.float64).reshape(-1)
    return tuple(tc)


class TermWeights:
    """Per-term float64 weights of one scheme over a segment: (docids,
    w, S) of a term, cached; ``syn`` scores a synonym group."""

    def __init__(self, seg, scheme, stats, uniq, query_length=1):
        self.seg, self.scheme, self.uniq = seg, scheme, uniq
        self.stats = CollectionStats(
            doc_count=stats.doc_count, avg_doclen=stats.avg_doclen,
            doclen_lower=stats.doclen_lower, doclen_upper=stats.doclen_upper,
            total_len=stats.total_len, query_length=query_length)
        self.cache: dict = {}

    def postings(self, term):
        ti = self.seg.terms[term]
        sl = slice(ti.offset, ti.offset + ti.length)
        return (np.asarray(self.seg.post_docids[sl]),
                np.asarray(self.seg.post_wdf[sl], np.float64),
                np.asarray(self.seg.post_doclen[sl], np.float64))

    def __call__(self, term):
        if term not in self.cache:
            if len(self.cache) >= 64:
                self.cache.pop(next(iter(self.cache)))
            ids, wdf, dl = self.postings(term)
            ti = self.seg.terms[term]
            tc = _tconst(self.scheme, self.stats, ti.length, ti.collfreq)
            u = self.uniq[ids].astype(np.float64) if self.uniq is not None \
                else None
            w, S = sumpart64(self.scheme, wdf, dl, tc, self.stats, u)
            self.cache[term] = (ids, w, S)
        return self.cache[term]

    def nonscoring(self, term):
        """(docids, w, S) of a term that does not score (a synonym's
        member): w NaN under a scheme that is NaN at constants of 0
        (nan_when_not_scoring), else 0."""
        ids = self.postings(term)[0]
        nan = nan_when_not_scoring(self.scheme, self.stats)
        return ids, np.full(len(ids), np.nan if nan else 0.0), \
            np.zeros(len(ids))

    def syn(self, terms, doclen):
        """OP_SYNONYM's pseudo-term (query/plan.py bind): (docids, w, S)
        of every doc holding one of terms - the summed wdf scored once,
        with termfreq min(sum, N) and the summed collection frequency."""
        parts = [self.postings(t) for t in terms]
        ssum = np.zeros(self.seg.num_docs + 1)
        for pid, pw, _dl in parts:
            ssum[pid] += pw
        ids = np.flatnonzero(ssum > 0)
        ssum = ssum[ids]
        tf = min(sum(len(p[0]) for p in parts),
                 max(int(self.stats.doc_count), 1))
        cf = sum(self.seg.terms[t].collfreq for t in terms)
        tc = _tconst(self.scheme, self.stats, tf, cf)
        dl = doclen[ids].astype(np.float64)
        dl = np.where(dl > 0, dl, 1.0)
        u = self.uniq[ids].astype(np.float64) if self.uniq is not None \
            else None
        w, S = sumpart64(self.scheme, ssum, dl, tc, self.stats, u)
        return ids, w, S


class Scores:
    """A query's float64 scores over its matched docs: ids (unique,
    ascending), score, tol."""

    def __init__(self, ids, score, tol):
        self.ids, self.score, self.tol = ids, score, tol

    def at(self, docs):
        pos = np.searchsorted(self.ids, docs)
        pos = np.minimum(pos, max(len(self.ids) - 1, 0))
        ok = (len(self.ids) > 0) & (self.ids[pos] == docs)
        return ok, self.score[pos], self.tol[pos]


def or_scores(parts, n_docs, live=None, ids=None) -> Scores:
    """The sum over parts [(docids, w, S)] per doc (each part holds a doc
    once), with its tolerance, at ids (default: every doc a part holds,
    only the live ones where live is given). Dense accumulators over the
    n_docs docs."""
    acc, acc_s, acc_a = (np.zeros(n_docs) for _ in range(3))
    hit = np.zeros(n_docs, bool) if ids is None else None
    for pid, w, S in parts:
        acc[pid] += w
        acc_s[pid] += S
        acc_a[pid] += np.abs(w)
        if hit is not None:
            hit[pid] = True
    if ids is None:
        ids = np.flatnonzero(hit & live if live is not None else hit)
    return Scores(ids, acc[ids], doc_tolerance(acc_s[ids], acc_a[ids],
                                               len(parts)))


def relevance_answers(seg, queries, scheme, stats, uniq) -> list:
    """Scores of each OR of terms (a list of term names) under scheme."""
    tw = TermWeights(seg, scheme, stats, uniq)
    return [or_scores([tw(t) for t in q if t in seg.terms], seg.num_docs)
            for q in queries]


def prefix_count(seg, imp_docids, q, prefix) -> int:
    """The count an impact-prefix launch reports for the OR q (executor.py
    _prefix_topk: the docs of the rows read): per term the first
    min(len, prefix[t]) rows of its impact-ordered block where prefix[t],
    else its block."""
    docs = []
    for t, p in zip(q, prefix):
        ti = seg.terms.get(t)
        if ti is None:
            continue
        n = min(ti.length, p) if p else ti.length
        docs.append(np.asarray(imp_docids[ti.offset:ti.offset + n]))
    return len(np.unique(np.concatenate(docs))) if docs else 0


def match_ranked(docids, scores, count, want: Scores, k, want_count=None):
    """A ranked result (docids i32[k], scores f32[k], count) against the
    oracle: the count (want_count, default the number of matches), the
    real rows min(k, matches), distinct matched docs, each score within its
    doc's tolerance, scores non-increasing, and no other match whose
    oracle score less its tolerance lies above the last score returned.
    Matches whose oracle score is NaN (a non-scoring term under a scheme
    that is NaN there) count but rank below every other match, as the JAX
    package ranks them: they are never returned.
    -> None, or what differs."""
    n = len(want.ids)
    if count != (n if want_count is None else want_count):
        return f"count {count} != {n if want_count is None else want_count}"
    keep = ~np.isnan(want.score)
    if not keep.all():
        return match_ranked(docids, scores, int(keep.sum()),
                            Scores(want.ids[keep], want.score[keep],
                                   want.tol[keep]), k)
    real = np.asarray(docids) != SENTINEL
    d = np.asarray(docids)[real].astype(np.int64)
    s = np.asarray(scores)[real].astype(np.float64)
    if len(d) != min(k, n) or len(set(d.tolist())) != len(d):
        return f"{len(d)} docs returned of {n} matches"
    ok, o, tol = want.at(d)
    if not ok.all():
        return f"docs {d[~ok].tolist()} do not match"
    bad = np.abs(s - o) > tol
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        return (f"doc {int(d[i])}: score {s[i]} vs oracle {o[i]} "
                f"(tolerance {tol[i]})")
    if (np.diff(s) > 0).any():
        return "scores not in descending order"
    if len(d) and n > len(d):
        rest = ~np.isin(want.ids, d)
        worst = float((want.score[rest] - want.tol[rest]).max())
        if worst > s[-1]:
            return (f"a match scoring {worst} (less its tolerance) beats "
                    f"the last returned {s[-1]}")
    return None


def match_docid_order(docids, scores, count, want: Scores, k):
    """A dense plan without a sort (JAX ranks it unweighted: executor.py
    _execute_dense) against the oracle: the first k matches by docid, each
    score within its doc's tolerance, the count. -> None, or what
    differs."""
    d = np.asarray(docids)
    real = d != SENTINEL
    if d[real].tolist() != want.ids[:k].tolist():
        return "not the first matches by docid"
    _ok, o, tol = want.at(d[real])
    if (np.abs(np.asarray(scores, np.float64)[real] - o) > tol).any():
        return "a score differs from the oracle's"
    return None if int(count) == len(want.ids) else "count differs"


def match_collapsed(docids, scores, count, want: Scores, cat, cmax, k):
    """A relevance result collapsed on cat (at most cmax a category) against
    the oracle: the count (before the collapse), distinct matched docs,
    scores within tolerance and descending, at most cmax a category; each
    doc one that may survive (fewer than cmax of its category surely beat
    it); and no doc that surely survives (fewer than cmax others of its
    category may beat it, ties included) and surely beats the last one
    returned left out. Only each category's cmax + 64 best by upper bound
    can survive surely; the rest are not looked at."""
    real = np.asarray(docids) != SENTINEL
    d = np.asarray(docids)[real].astype(np.int64)
    s = np.asarray(scores)[real].astype(np.float64)
    if count != len(want.ids):
        return f"count {count} != {len(want.ids)}"
    if len(set(d.tolist())) != len(d) or len(d) > k:
        return "duplicate docs"
    ok, o, tol = want.at(d)
    if not ok.all() or (np.abs(s - o) > tol).any() or (np.diff(s) > 0).any():
        return "a returned score differs from the oracle's"
    c = cat[want.ids]
    lo, hi = want.score - want.tol, want.score + want.tol
    order = np.argsort(c, kind="stable")
    codes, starts = np.unique(c[order], return_index=True)
    ends = np.append(starts[1:], len(order))
    members = {int(code): order[a:b]
               for code, a, b in zip(codes, starts, ends)}
    for x, cx, sx, tx in zip(d, cat[d], o, tol):
        m = members[int(cx)]
        if int(np.count_nonzero(lo[m] > sx + tx)) >= cmax:
            return f"doc {int(x)} cannot survive the collapse"
        if int(np.count_nonzero(cat[d] == cx)) > cmax:
            return "more than collapse_max docs of a category"
    missing = -np.inf
    for m in members.values():
        top = m[np.argsort(-hi[m], kind="stable")[:cmax + 64]]
        floor = hi[top[-1]] if len(top) < len(m) else -np.inf
        # others of the category that may beat each top doc
        hs = np.sort(hi[top])
        maybe = len(top) - np.searchsorted(hs, lo[top], side="left") - 1
        sure = (maybe < cmax) & (lo[top] > floor)
        sure &= ~np.isin(want.ids[top], d)
        if sure.any():
            missing = max(missing, float(lo[top][sure].max()))
    if missing > -np.inf and (len(d) < k or missing > s[-1]):
        return "a doc that surely survives above the last returned is missing"
    return None


def catalogue_answers(corpus, queries, scheme, stats, uniq) -> list:
    """Per browse query of families N, S, X and relevance C
    (utils/synth_browse.py), and D, ``AND_MAYBE(match_all, OR(w, w))`` on
    N's words (dense and scored), under scheme: N {"count", "docids"} (the
    first docids ascending; every score 0); D, S, X and C a Scores of the
    matches (D every live doc, scored by the words it holds; C before its
    collapse; its query length the OR's three terms, the bound plan's
    qlen: the batch path's is 1)."""
    seg = corpus.seg
    N = seg.num_docs
    live = ~np.asarray(corpus.deleted[:N])
    tw = TermWeights(seg, scheme, stats, uniq)
    tw_c = TermWeights(seg, scheme, stats, uniq, query_length=3)
    doclen = np.asarray(seg.doclen)
    out = []
    for fam, _q, p in queries:
        words = [f"w{i}" for i in p.get("w", ())]
        if fam == "N":
            has = np.zeros(N, bool)
            for t in words:
                has[tw.postings(t)[0]] = True
            idx = np.flatnonzero(live & ~has)
            out.append({"count": len(idx), "docids": idx})
        elif fam == "D":
            out.append(or_scores([tw(t) for t in words], N,
                                 ids=np.flatnonzero(live)))
        elif fam == "S":
            out.append(or_scores([tw.syn(words[:3], doclen), tw(words[3])]
                                 + [tw.nonscoring(t) for t in words[:3]],
                                 N, live))
        elif fam == "X":
            # the max of the branch sums; a branch sums the weights of its
            # terms the doc holds, matched or not (executor.py 787-797)
            a, b, c, e = (tw(t) for t in words)
            has = np.zeros((4, N), bool)
            for row, x in enumerate((a, b, c, e)):
                has[row, x[0]] = True
            ids = np.flatnonzero((has[0] | has[1] | (has[2] & has[3])) &
                                 live)
            best = np.zeros(len(ids))
            tol = np.zeros(len(ids))
            for br in ([a], [b], [c, e]):
                sc = or_scores(br, N, ids=ids)
                best = np.maximum(best, sc.score)
                tol = tol + sc.tol
            out.append(Scores(ids, best, tol))
        elif fam == "C" and not p["sorted"]:
            out.append(or_scores([tw_c(t) for t in words], N, live))
        else:
            raise ValueError(f"family {fam} is not scored here")
    return out
