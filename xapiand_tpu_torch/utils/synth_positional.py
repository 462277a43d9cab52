"""Phrase + boolean corpus and queries, straight to a positional Segment.

The counterpart of ``scripts/config_bench.py:35-76`` (BASELINE.json
config 2, "100k docs with positional postings: phrase + boolean
(AND/OR/NOT) queries through query_dsl") built without the analysis
chain, as ``utils/synth_faceted.py`` builds config 3:

  - the text is ``build_corpus2(n, seed=7)`` draw for draw: Python's
    ``random.Random(7)``, 40 tokens a doc from 5,000 words ``w{i}`` with
    weights 1/(i+1)^1.07 (``choices`` with the cumulative weights computed
    once, which draws what ``weights=`` draws);
  - one term a word (the JAX ``Database`` also indexes a field-prefixed
    copy, which changes no phrase and no BM25 order); postings
    docid-ascending, wdf the word's occurrences, document length 40;
  - positions are token indices laid out as
    ``xapiand_tpu/models/builder.py`` 386-398 and 424-436 lay them out:
    each (term, doc) list sorted, at ``post_posoff`` / ``post_poslen`` in
    one flat ``positions`` array followed by a guard of 128 zeros;
    ``TermInfo.max_poslen`` set, so the plan sizes ``pmax`` from the data
    (query/plan.py 502-522); no doc is deleted.

``queries2`` draws the published queries of ``config_bench.queries2``
(``random.Random(11)``): 2-word phrases of adjacent tokens and AND / OR /
AND_NOT booleans of three words, in the IR shapes ``dsl_for`` parses them
into (the port has no DSL), then, from the same generator, 3-word phrases
and NEAR pairs at window 4 drawn as ``tests/test_phrase_carry.py:44-50``
draws them. ``oracle_answers`` answers every query in float64 numpy from
the token lists, independently of the executor, with the JAX package's
documented phrase rules (ops/phrase.py 9-16): the first ``cand_cap``
candidates by docid, the first ``pmax`` positions, NEAR's anchor.
"""

from __future__ import annotations

import hashlib
import itertools
import random
from dataclasses import dataclass

import numpy as np

from xapiand_tpu_torch.models.segment import Segment, TermInfo, size_class
from xapiand_tpu_torch.query.ir import Q

N_WORDS, DOC_LEN, ZIPF_S = 5000, 40, 1.07
NEAR_WINDOW = 4


@dataclass
class PositionalCorpus:
    seg: Segment
    tokens: np.ndarray     # i32[N, DOC_LEN]: word index at each position


def word(i) -> str:
    return f"w{int(i)}"


def draw_tokens(n_docs: int, seed: int = 7) -> np.ndarray:
    """config_bench.build_corpus2's draws as word indices, i32[n, 40]."""
    rng = random.Random(seed)
    cum = list(itertools.accumulate(1.0 / (i + 1) ** ZIPF_S
                                    for i in range(N_WORDS)))
    pop = range(N_WORDS)
    flat = itertools.chain.from_iterable(
        rng.choices(pop, cum_weights=cum, k=DOC_LEN) for _ in range(n_docs))
    return np.fromiter(flat, np.int32, n_docs * DOC_LEN).reshape(
        n_docs, DOC_LEN)


def build_corpus2(n_docs: int = 100_000, seed: int = 7) -> PositionalCorpus:
    tok = draw_tokens(n_docs, seed)
    N = n_docs
    doc = np.repeat(np.arange(N, dtype=np.int64), DOC_LEN)
    pos = np.tile(np.arange(DOC_LEN, dtype=np.int32), N)
    key = tok.ravel().astype(np.int64) * N + doc
    order = np.argsort(key, kind="stable")     # (term, doc, position)
    skey = key[order]
    uniq, starts, counts = np.unique(skey, return_index=True,
                                     return_counts=True)
    u_tid, u_doc = uniq // N, (uniq % N).astype(np.int32)
    term_ids, tstarts = np.unique(u_tid, return_index=True)
    lens = np.diff(np.append(tstarts, len(u_tid)))
    guard = size_class(int(lens.max()))
    n_post = len(uniq)
    P = n_post + guard
    post_docids = np.full(P, N, np.int32)
    post_docids[:n_post] = u_doc
    post_wdf = np.zeros(P, np.float32)
    post_wdf[:n_post] = counts
    post_posoff = np.zeros(P, np.int32)
    post_posoff[:n_post] = starts
    post_poslen = np.zeros(P, np.int32)
    post_poslen[:n_post] = counts
    positions = np.concatenate([pos[order], np.zeros(128, np.int32)])
    doclen = np.zeros(N + 1, np.float32)
    doclen[:N] = DOC_LEN
    post_doclen = doclen[np.minimum(post_docids, N)]
    wsum = np.add.reduceat(counts, tstarts)
    wmax = np.maximum.reduceat(counts, tstarts)
    terms = {word(t): TermInfo(tid=int(t), offset=int(o), length=int(n),
                               collfreq=int(cf), max_wdf=float(mw),
                               max_poslen=int(mw))
             for t, o, n, cf, mw in zip(term_ids.tolist(), tstarts.tolist(),
                                        lens.tolist(), wsum.tolist(),
                                        wmax.tolist())}
    seg = Segment(
        num_docs=N, total_doclen=float(N * DOC_LEN),
        post_docids=post_docids, post_wdf=post_wdf, post_doclen=post_doclen,
        post_posoff=post_posoff, post_poslen=post_poslen,
        positions=positions, doclen=doclen,
        deleted=np.zeros(N + 1, bool), terms=terms, values={}, geo={},
        doc_keys=[], guard=guard)
    return PositionalCorpus(seg=seg, tokens=tok)


def fingerprint(corpus: PositionalCorpus) -> dict:
    """A hash of the arrays (``sha256``) and the posting and position
    counts."""
    seg = corpus.seg
    h = hashlib.sha256()
    for arr in (corpus.tokens, seg.post_docids, seg.post_wdf,
                seg.post_posoff, seg.post_poslen, seg.positions):
        h.update(np.ascontiguousarray(arr).tobytes())
    n_post = int(sum(t.length for t in seg.terms.values()))
    return {"sha256": h.hexdigest()[:16], "postings": n_post,
            "positions": int(seg.post_poslen[:n_post].sum()),
            "terms": len(seg.terms)}


def _leaf(t):
    return Q.or_terms([t])     # the DSL's leaf: {"body": t}


def queries2(corpus: PositionalCorpus, n_each: int = 512, n_three: int = 128,
             seed: int = 11) -> list:
    """[(family, Q, words)] in family order P2, B, P3, N:

      P2  config_bench.queries2's phrases: 2 adjacent tokens of a random
          doc, distinct words, no pair twice;
      B   its booleans: ("and" | "or" | "not", 3 words of the first 2,000
          docs' vocabulary), as dsl_for shapes them: AND(a, b, c), OR(a,
          b, c), AND_NOT(OR(a, b), c);
      P3  3 adjacent tokens of a random doc;
      N   NEAR(toks[i], toks[i + 2]) at window 4 from the same draw."""
    rng = random.Random(seed)
    tok = corpus.tokens
    n_docs = len(tok)
    out = []
    seen: set = set()
    while len(out) < n_each:
        toks = tok[rng.randrange(n_docs)]
        i = rng.randrange(DOC_LEN - 1)
        p = (word(toks[i]), word(toks[i + 1]))
        if p[0] != p[1] and p not in seen:
            seen.add(p)
            out.append(("P2", Q.phrase(p), p))
    vocab = sorted({word(t) for t in np.unique(tok[:2000])})
    for _ in range(n_each):
        kind = rng.choice(("and", "or", "not"))
        ts = tuple(rng.sample(vocab, 3))
        if kind == "and":
            q = Q.and_(*(_leaf(t) for t in ts))
        elif kind == "or":
            q = Q.or_(*(_leaf(t) for t in ts))
        else:
            q = Q.and_not(Q.or_(_leaf(ts[0]), _leaf(ts[1])), _leaf(ts[2]))
        out.append(("B", q, (kind,) + ts))
    near = []
    for _ in range(n_three):
        toks = tok[rng.randrange(n_docs)]
        i = rng.randrange(DOC_LEN - 2)
        ts = tuple(word(t) for t in toks[i:i + 3])
        out.append(("P3", Q.phrase(ts), ts))
        near.append(("N", Q.near((ts[0], ts[2]), window=NEAR_WINDOW),
                     (ts[0], ts[2])))
    return out + near


def oracle_answers(corpus: PositionalCorpus, queries: list, cand_caps: list,
                   pmaxes: list, k: int = 10, rtol: float = 1e-5) -> list:
    """float64 answers from the token lists: set algebra over the words'
    docs, phrase and NEAR tests on the tokens of the first cand_caps[qi]
    candidates (ascending docids) with each word's first pmaxes[qi]
    occurrences, BM25 in float64 over the scoring words (both phrase
    words; AND_NOT's right side scores nothing, query/plan.py 240-243).
    -> per query {"count", "ranked": [(docid, score)]}, by (score desc,
    docid asc), every doc scoring within rtol of the k-th score or above
    it (the tie groups)."""
    tok = corpus.tokens
    seg = corpus.seg
    N = len(tok)
    avg = seg.avg_doclen
    nd = int(seg.doc_count)
    cache: dict = {}

    def post(t):
        """(docids ascending, float64 BM25 of each) of word t."""
        if t not in cache:
            ti = seg.terms.get(t)
            if ti is None:
                cache[t] = (np.zeros(0, np.int64), np.zeros(0))
            else:
                sl = slice(ti.offset, ti.offset + ti.length)
                n = ti.length
                tw = (nd - n + 0.5) / (n + 0.5)
                if tw < 2.0:
                    tw = tw * 0.5 + 1.0
                tc = np.log(tw) * 2.0      # BM25 k1 = k3 = 1, wqf 1
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
        if not len(d):
            return np.zeros(len(docs))
        i = np.minimum(np.searchsorted(d, docs), len(d) - 1)
        return np.where(d[i] == docs, s[i], 0.0)

    def occ(docs, t, pmax):
        """bool[C, 40]: the first pmax occurrences of word t in docs."""
        m = tok[docs] == int(t[1:])
        return m & (np.cumsum(m, axis=1) <= pmax)

    out = []
    for (fam, _q, ws), cap, pmax in zip(queries, cand_caps, pmaxes):
        if fam == "B":
            kind, ts = ws[0], ws[1:]
            if kind == "and":
                m = has(ts[0]) & has(ts[1]) & has(ts[2])
            elif kind == "or":
                m = has(ts[0]) | has(ts[1]) | has(ts[2])
            else:
                m = (has(ts[0]) | has(ts[1])) & ~has(ts[2])
            idx = np.flatnonzero(m)
            scoring = ts if kind != "not" else ts[:2]
        else:
            m = np.ones(N, bool)
            for t in ws:
                m &= has(t)
            cand = np.flatnonzero(m)[:cap]
            if fam in ("P2", "P3"):
                hit = np.zeros((len(cand), DOC_LEN), bool)
                hit[:, :DOC_LEN - len(ws) + 1] = True
                for i, t in enumerate(ws):
                    o = occ(cand, t, pmax)
                    hit[:, :DOC_LEN - i] &= o[:, i:]
                ok = hit.any(1)
            else:
                a, b = occ(cand, ws[0], pmax), occ(cand, ws[1], pmax)
                near = np.zeros_like(a)
                for s in range(-NEAR_WINDOW + 1, NEAR_WINDOW):
                    if s >= 0:
                        near[:, :DOC_LEN - s] |= b[:, s:]
                    else:
                        near[:, -s:] |= b[:, :s]
                ok = (a & near).any(1)
            idx = cand[ok]
            scoring = ws
        sc = np.zeros(len(idx))
        for t in scoring:
            sc = sc + score(t, idx)
        order = np.lexsort((idx, -sc))
        idx, sc = idx[order], sc[order]
        count = len(idx)
        if count > k:
            keep = sc >= sc[k - 1] * (1 - 2 * rtol)
            idx, sc = idx[keep], sc[keep]
        out.append({"count": count,
                    "ranked": list(zip(idx.tolist(), sc.tolist()))})
    return out
