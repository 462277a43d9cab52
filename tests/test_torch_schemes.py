"""The other 15 weight schemes (K18) through the port's serving paths,
against the JAX package on the CPU: the same numpy-seeded segment, stats
and IRs through both.

  BatchSearcher.run         every scheme configuration of
                            utils/synth_schemes.py (the 15, LM's four other
                            smoothings, BM25) on the exact path, over
                            three-term ORs (T = 4: each query has a padded
                            term row; four of them hold a frequent term)
                            and a group mixing one-, two- and three-term
                            ORs
  impact-prefix mode        BM25Plus (BM25's impact order, BM25Plus's tail
                            bound): the certified flags of every launch
                            equal to JAX's, and the answers after the
                            exact re-run
  SegmentSearcher.execute   every scheme on one OR of three terms (the
                            bound plan's qlen, 3, is DiceCoeff's query
                            length)
  dense_rows, merge_special one dense, one OP_SYNONYM and one OP_MAX plan
                            under PL2 (two constants a term) and DiceCoeff
                            (uniqterms), through BatchSearcher.run; the
                            repair of JAX's NaN for non-scoring terms
  the batched query length  JAX stacks no qlen in a batch (search.py
                            346-349), so a batched DiceCoeff scores with
                            query length 1 and a single execute with the
                            plan's: the port mirrors both

The segment is utils/synth.py's (4,000 docs of 5-60 Zipf tokens over 600
terms, seed 7) in each package, with real uniqterms (each doc's distinct
terms) and real stats (doclen_upper the longest doc, total_len the
collection's length).

Tolerances: counts equal; each side's every returned score within the
float64 oracle's per-doc bound (utils/synth_schemes.py: ERR_ULPS ulps of
each posting's error scale, plus the float32 sum's), no match left out
that beats the last one returned by more than its bound (ranks as tie
groups at that tolerance), and the two sides' scores of a doc both return
within twice the bound. BB2's bound is units (ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.models.weights import get_scheme as jget
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu.utils.synth import build_synthetic_segment as jbuild
from xapiand_tpu_torch.models.weights import get_scheme
from xapiand_tpu_torch.query import plan as pplan
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_schemes as ss
from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                           sample_queries)

import xapiand_tpu.query.plan as jplan

CPU = torch.device("cpu")
K = 10
N_DOCS, VOCAB = 4000, 600
CONFIGS = {c[0]: c for c in ss.SCHEME_CONFIGS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


class World:
    def __init__(self):
        kw = dict(min_len=5, max_len=60, seed=7)
        self.pseg = build_synthetic_segment(N_DOCS, VOCAB, **kw)
        self.jseg = jbuild(N_DOCS, VOCAB, **kw)
        # collection frequencies as a deployment has them (utils/synth.py
        # sets each term's to its document frequency)
        ss.real_collfreq(self.pseg)
        ss.real_collfreq(self.jseg)
        self.uniq = ss.uniqterms(self.pseg)
        self.pseg.uniqterms = self.uniq
        self.jseg.uniqterms = self.uniq.copy()
        self.stats = ss.real_stats(self.pseg)
        self.jstats = JStats(**{f: getattr(self.stats, f) for f in (
            "doc_count", "avg_doclen", "doclen_lower", "doclen_upper",
            "total_len", "query_length")})
        self.ps = SegmentSearcher(self.pseg, device=CPU)
        self.js = JSearcher(self.jseg)
        # bench.py's draw (df <= 10% of N), and four ORs with one of the
        # most frequent terms: PL2Plus scores only terms with F >= N, and
        # LM's two-stage smoothing only terms of a large collection share
        self.queries = sample_queries(self.pseg, 24, 3, seed=11)
        self.queries += [[f"t{i}", *q[:2]] for i, q in
                         enumerate(self.queries[:4])]
        mixed = sample_queries(self.pseg, 12, 3, seed=12)
        self.mixed = [q[:1 + i % 3] for i, q in enumerate(mixed)]

    def both(self, config):
        _label, name, params = config
        return get_scheme(name, **params), jget(name, **params)

    def batch_run(self, config, irs, jirs, **kw):
        ps, js = self.both(config)
        kw = {"k": K, "max_batch": 32, "min_batch": 8, "class_groups": 1,
              **kw}
        got = BatchSearcher(self.ps, scheme=ps, **kw).run(irs,
                                                          stats=self.stats)
        want = JBatch(self.js, scheme=js, **kw).run(jirs, stats=self.jstats)
        return ps, got, want


_WORLD = []


@pytest.fixture(scope="module")
def world():
    if not _WORLD:
        _WORLD.append(World())
    return _WORLD[0]


def check(got, want, oracle, want_count=None, docid_order=False):
    """Both sides against the float64 oracle, and against each other."""
    for side, r in (("port", got), ("jax", want)):
        err = ss.match_docid_order(r["docids"], r["scores"], r["count"],
                                   oracle, K) if docid_order else \
            ss.match_ranked(r["docids"], r["scores"], int(r["count"]),
                            oracle, K, want_count)
        assert err is None, f"{side}: {err}"
    assert int(got["count"]) == int(want["count"])
    gd, wd = np.asarray(got["docids"]), np.asarray(want["docids"])
    common = np.intersect1d(gd[gd != ss.SENTINEL], wd[wd != ss.SENTINEL])
    _ok, _o, tol = oracle.at(common)
    gs = np.asarray(got["scores"], np.float64)[
        [int(np.flatnonzero(gd == d)[0]) for d in common]]
    ws = np.asarray(want["scores"], np.float64)[
        [int(np.flatnonzero(wd == d)[0]) for d in common]]
    assert (np.abs(gs - ws) <= 2 * tol).all()


def _ors(queries):
    return [Q.or_terms(q) for q in queries], [JQ.or_terms(q) for q in queries]


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_batch_run_matches_jax(world, label):
    irs, jirs = _ors(world.queries)
    ps, got, want = world.batch_run(CONFIGS[label], irs, jirs)
    oracle = ss.relevance_answers(world.pseg, world.queries, ps, world.stats,
                                  world.uniq)
    for g, w, o in zip(got, want, oracle):
        check(g, w, o)
    if label != "bool":
        assert any((r["scores"][r["docids"] != ss.SENTINEL] != 0).any()
                   for r in got)


@pytest.mark.parametrize("label", ["pl2", "lm-absolute_discount", "bb2"])
def test_batch_run_mixed_term_counts(world, label):
    """One launch group of one-, two- and three-term ORs (T = 4) under a
    scheme of two constants a term: the rows of the absent terms are
    zeros along both constants."""
    irs, jirs = _ors(world.mixed)
    ps, got, want = world.batch_run(CONFIGS[label], irs, jirs)
    oracle = ss.relevance_answers(world.pseg, world.mixed, ps, world.stats,
                                  world.uniq)
    for g, w, o in zip(got, want, oracle):
        check(g, w, o)


def _certified(bs, irs, stats, stats_d):
    """Per query the certified flag of its prefix-mode launch."""
    flags = {}
    planned = bs.plan(irs, stats=stats)     # uploads the impact mirror
    arrays = bs.searcher.device_segment.arrays_pytree()
    for _cfg, fn, batch, chunk in planned:
        cert = np.asarray(fn(arrays, batch, stats_d)["certified"])
        for row, qi in enumerate(chunk):
            flags.setdefault(qi, bool(cert[row]))
    return [flags[i] for i in range(len(irs))]


def test_bm25plus_prefix_mode_matches_jax(world):
    """BM25Plus takes impact-prefix mode with BM25's impact order and its
    own tail bound: the same queries certify in both packages, and the
    answers after the exact re-run agree."""
    cfg = CONFIGS["bm25plus"]
    irs, jirs = _ors(world.queries)
    ps, js = world.both(cfg)
    pb = BatchSearcher(world.ps, k=K, max_batch=32, min_batch=8,
                       class_groups=1, prefix_cap=64, scheme=ps)
    jb = JBatch(world.js, k=K, max_batch=32, min_batch=8, class_groups=1,
                prefix_cap=64, scheme=js)
    st = world.stats
    sd = ss.stats_dict(st)
    jsd = {k: jnp.float32(v) for k, v in sd.items()}
    assert all(c.prefix for c, *_x in pb.plan(irs, stats=st))
    pc = _certified(pb, irs, st, sd)
    jc = _certified(jb, jirs, world.jstats, jsd)
    assert pc == jc
    assert 0 < sum(pc) < len(pc)
    got, want = pb.run(irs, stats=st), jb.run(jirs, stats=world.jstats)
    assert sorted(pb.reran) == [i for i, c in enumerate(pc) if not c]
    oracle = ss.relevance_answers(world.pseg, world.queries, ps, st,
                                  world.uniq)
    imp = world.pseg.impact_arrays(ps, st)[0]
    prefix = next(iter(pb.plan(irs[:1], stats=st)))[0].prefix
    for qi, (g, w, o) in enumerate(zip(got, want, oracle)):
        # a certified answer counts the docs of the rows it read
        n = None if not pc[qi] else ss.prefix_count(
            world.pseg, imp, world.queries[qi], prefix)
        check(g, w, o, n)


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_execute_matches_jax(world, label):
    """One bound OR of three terms through SegmentSearcher.execute: the
    scheme reads the plan's query length (qlen 3)."""
    q = world.queries[0]
    ps, js = world.both(CONFIGS[label])
    pbound = pplan.bind(pplan.compile_ir(Q.or_terms(q)), world.pseg, ps,
                        world.stats, k=K)
    jbound = jplan.bind(jplan.compile_ir(JQ.or_terms(q)), world.jseg, js,
                        world.jstats, k=K)
    assert float(pbound.arrays["qlen"]) == 3.0
    got = world.ps.execute(pbound, ss.stats_dict(world.stats), scheme=ps)
    want = world.js.execute(jbound, ss.stats_dict(world.stats), scheme=js)
    tw = ss.TermWeights(world.pseg, ps, world.stats, world.uniq,
                        query_length=3)
    check(got, want, ss.or_scores([tw(t) for t in q], N_DOCS))


def _special_queries(world):
    """(family, port IR, JAX IR) of a dense, a synonym and an OP_MAX plan
    over the segment's words."""
    a, b, c, d = world.queries[1] + world.queries[2][:1]
    return {
        "dense": (Q.and_maybe(Q.match_all(), Q.or_terms([a, b])),
                  JQ.and_maybe(JQ.match_all(), JQ.or_terms([a, b]))),
        "synonym": (Q.or_(Q.synonym([a, b, c]), Q.term(d)),
                    JQ.or_(JQ.synonym([a, b, c]), JQ.term(d))),
        "max": (Q.max_(Q.term(a), Q.term(b), Q.and_(Q.term(c), Q.term(d))),
                JQ.max_(JQ.term(a), JQ.term(b),
                        JQ.and_(JQ.term(c), JQ.term(d)))),
    }, (a, b, c, d)


def _special_oracle(world, ps, family, words):
    tw = ss.TermWeights(world.pseg, ps, world.stats, world.uniq)
    a, b, c, d = words
    if family == "dense":
        # AND_MAYBE(match_all, OR(a, b)): every doc, scored by a and b
        sc = ss.or_scores([tw(a), tw(b)], N_DOCS)
        ok, o, t = sc.at(np.arange(N_DOCS))
        return ss.Scores(np.arange(N_DOCS), np.where(ok, o, 0.0),
                         np.where(ok, t, 0.0))
    if family == "synonym":
        # the members do not score: NaN under PL2, as JAX keeps it
        return ss.or_scores([tw.syn([a, b, c], world.pseg.doclen), tw(d)]
                            + [tw.nonscoring(t) for t in (a, b, c)], N_DOCS)
    ids = np.union1d(np.union1d(tw(a)[0], tw(b)[0]),
                     np.intersect1d(tw(c)[0], tw(d)[0]))
    best, tol = np.zeros(len(ids)), np.zeros(len(ids))
    for br in ([tw(a)], [tw(b)], [tw(c), tw(d)]):
        ok, o, t = ss.or_scores(br, N_DOCS).at(ids)
        best = np.maximum(best, np.where(ok, o, 0.0))
        tol = tol + np.where(ok, t, 0.0)
    return ss.Scores(ids, best, tol)


@pytest.mark.parametrize("family", ["dense", "synonym", "max"])
@pytest.mark.parametrize("label", ["pl2", "dicecoeff"])
def test_special_plans_match_jax(world, label, family):
    """dense_rows (K12) and merge_special (K13) under a scheme of two
    constants a term and under one that reads uniqterms, in a batch.

    OP_SYNONYM under PL2 mirrors a reference fault: the synonym's member
    terms do not score (constants 0), PL2's weight is NaN at F = 0, and
    JAX multiplies it by 0 and keeps the NaN in the doc's sum, and its
    compiled execute ranks such a doc below every other: the docs holding
    a member drop out of its top k, though they count. The port does the
    same (csrc/common.cuh scored, topk_rows.cu), and so does the oracle
    (utils/synth_schemes.py nonscoring, match_ranked)."""
    plans, words = _special_queries(world)
    ir, jir = plans[family]
    ps, got, want = world.batch_run(CONFIGS[label], [ir] * 3, [jir] * 3)
    oracle = _special_oracle(world, ps, family, words)
    for g, w in zip(got, want):
        assert (g["scores"][g["docids"] != ss.SENTINEL] > 0).any()
        if (label, family) == ("pl2", "synonym"):
            assert np.isnan(oracle.score).sum() > K   # the mirrored NaN
            np.testing.assert_array_equal(g["docids"], w["docids"])
        check(g, w, oracle, docid_order=family == "dense")


def test_non_scoring_terms_keep_jax_nan(world):
    """The mirrored fault above at its source: JAX's PL2 is NaN at
    constants of 0, and score_slices keeps that NaN for a non-scoring row
    (scoring 0) as JAX does, and weighs a scoring one as sumpart."""
    f32 = jnp.float32
    jst = JStats(f32(N_DOCS), f32(30.0), f32(1.0), f32(60.0), f32(1e5),
                 f32(1.0))
    assert np.isnan(np.asarray(jget("pl2").sumpart(
        jnp.float32(2.0), jnp.float32(20.0), jnp.zeros(2, jnp.float32),
        jst)))
    from xapiand_tpu_torch.ops import kernels as kn
    seg = world.ps.device_segment.arrays_pytree()
    ti = world.pseg.terms["t5"]
    spec = get_scheme("pl2").kernel_spec(world.stats)
    offsets = torch.tensor([[ti.offset, ti.offset]], dtype=torch.int32)
    lens = torch.tensor([[ti.length, ti.length]], dtype=torch.int32)
    tconst = torch.tensor([[[0.0, 0.0], [1.0, float(ti.collfreq)]]])
    scoring = torch.tensor([[0.0, 1.0]])
    W = 1 << (ti.length - 1).bit_length()
    _ids, w, _tail = kn.score_slices(
        (seg["post_docids"], seg["post_wdf"], seg["post_doclen"]), None,
        offsets, lens, tconst, scoring, (W, W), (False, False), spec)
    assert torch.isnan(w[0, :ti.length]).all()
    assert (w[0, ti.length:W] == 0).all()
    assert torch.isfinite(w[0, W:]).all()
    assert (w[0, W:W + ti.length] > 0).any()
    assert ss.nan_when_not_scoring(get_scheme("pl2"), world.stats)
    assert not ss.nan_when_not_scoring(get_scheme("bm25"), world.stats)


def test_batched_dicecoeff_uses_query_length_one(world):
    """JAX's BatchSearcher stacks no qlen (xapiand_tpu/search.py:346-349),
    so its batched DiceCoeff scores 2 wqf / (1 + uniqterms) whatever the
    query's length, and execute 2 wqf / (qlen + uniqterms). The port
    mirrors both: a doc holding one term of an OR of three scores
    2 / (1 + u) in a batch and 2 / (3 + u) alone."""
    q = world.queries[3]
    ps, got, want = world.batch_run(CONFIGS["dicecoeff"],
                                    [Q.or_terms(q)], [JQ.or_terms(q)])
    tw1 = ss.TermWeights(world.pseg, ps, world.stats, world.uniq)
    check(got[0], want[0], ss.or_scores([tw1(t) for t in q], N_DOCS))
    pbound = pplan.bind(pplan.compile_ir(Q.or_terms(q)), world.pseg, ps,
                        world.stats, k=K)
    alone = world.ps.execute(pbound, ss.stats_dict(world.stats), scheme=ps)
    holds = {int(d): sum(int(d) in set(tw1(t)[0].tolist()) for t in q)
             for d in got[0]["docids"].tolist() + alone["docids"].tolist()
             if d != ss.SENTINEL}
    u = world.uniq
    for res, qlen in ((got[0], 1.0), (alone, 3.0)):
        for d, s in zip(res["docids"].tolist(), res["scores"].tolist()):
            if d != ss.SENTINEL and holds[d] == 1:
                assert s == pytest.approx(2.0 / (qlen + float(u[d])),
                                          rel=1e-6)
