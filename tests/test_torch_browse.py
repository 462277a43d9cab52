"""Slice 6, the single-query entry point and the remaining plan shapes,
against the JAX package on the CPU: the same numpy-seeded segment and IRs
through both.

  SegmentSearcher.execute   vs the JAX SegmentSearcher.execute (jit), with
                            and without a collapse, collapse_max 1, 3 and 9
                            (9 exercises the cap at 8), by relevance and by
                            a value sort, over docs that lack the collapse
                            value, with tied scores, and with cfg.carry set
  collapse_rows (K10)       its plain version vs _collapse
  dense_rows (K12)          through execute: _match_all and NOT plans
  merge_special (K13)       through execute: _max and _synonym plans
  BatchSearcher.run         vs the JAX BatchSearcher.run for the browse
                            families M, N, S, X, launch groups included

The segment is a JAX ``Database`` commit (3,000 docs: a 12-word body, a
category missing on every 7th doc, a price, a multi-value size) with every
53rd doc then marked deleted, carried into the port as the predicate tests
carry theirs.

Tolerances: docids and counts are equal, scores agree to rtol 1e-5 (JAX
adds a doc's weights in its segmented scan's association order, the port
in term order). Relevance ranks are compared as tie groups, except after a
collapse: there JAX's order among equal scores is fixed (lax.sort is
stable, lax.top_k takes the lower position) - collapse key ascending, then
docs without the value by docid - and the port must return exactly it, so
those lists are compared as they are wherever the scores of the two sides
agree bit for bit, and as tie groups elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xapiand_tpu.ops.executor as jex
import xapiand_tpu.query.plan as jplan
from xapiand_tpu.database import Database
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.segment import (Segment, ValueColumn,
                                              device_segment_from_numpy,
                                              terms_from)
from xapiand_tpu_torch.models.weights import BM25, CollectionStats
from xapiand_tpu_torch.ops import aggs as paggs
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import (SENTINEL, ExecConfig,
                                            check_supported, execute_batch)
from xapiand_tpu_torch.query import plan as pplan
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import serialise as ser

RTOL = 1e-5
CPU = torch.device("cpu")
N_DOCS, N_WORDS, N_CATS = 3000, 200, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")
    monkeypatch.setenv("XT_FULLWIDTH", "0")


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _fields(obj, cls, **over):
    return cls(**{**{f.name: getattr(obj, f.name)
                     for f in dataclasses.fields(cls)}, **over})


class World:
    def __init__(self):
        rng = np.random.Generator(np.random.PCG64(5))
        words = np.array([f"w{i}" for i in range(N_WORDS)])
        p = 1.0 / (np.arange(N_WORDS) + 1) ** 1.07
        db = Database()
        for i in range(N_DOCS):
            doc = {"body": " ".join(rng.choice(words, 12, p=p / p.sum())),
                   "price": round(float(rng.random() * 99 + 1), 2)}
            if i % 7 != 3:
                doc["cat"] = f"cat{int(rng.integers(0, N_CATS))}"
            n = int(rng.integers(1, 4))
            sizes = [int(x) for x in
                     rng.choice(np.arange(35, 49), n, replace=False)]
            doc["size"] = sizes if n > 1 else sizes[0]
            db.index_document(doc, doc_id=str(i))
        db.commit()
        jseg = db._searchers[0].segment
        jseg.deleted[np.arange(5, N_DOCS, 53)] = True
        self.price = db.schema.get_field("price").slot
        self.size = db.schema.get_field("size").slot
        self.cat = db.schema.get_field("cat").slot
        self.jseg = jseg
        self.pseg = _fields(
            jseg, Segment,
            terms=terms_from(jseg.terms),
            values={s: _fields(c, ValueColumn)
                    for s, c in jseg.values.items()})
        self.js = JSearcher(jseg, JBM25())
        self.ps = SegmentSearcher(self.pseg, device=CPU)
        self.jarr = self.js.device_segment.arrays_pytree()
        self.parr = device_segment_from_numpy(_np_tree(self.jarr), CPU)
        # the five stats Database.search passes
        self.stats = {"N": float(jseg.doc_count),
                      "avg_doclen": float(jseg.avg_doclen),
                      "doclen_lower": 1.0, "doclen_upper": 64.0,
                      "total_len": float(jseg.total_doclen)}
        self.cstats = CollectionStats(doc_count=jseg.doc_count,
                                      avg_doclen=jseg.avg_doclen,
                                      doclen_lower=1.0)

    @staticmethod
    def word(i):
        return f"w{i}"

    def bind_both(self, build, **kw):
        """compile_ir + bind of build(Q class, word) in both packages."""
        jst = JStats(doc_count=self.jseg.doc_count,
                     avg_doclen=self.jseg.avg_doclen, doclen_lower=1.0)
        jb = jplan.bind(jplan.compile_ir(build(JQ, self.word)), self.jseg,
                        JBM25(), jst, **kw)
        pb = pplan.bind(pplan.compile_ir(build(Q, self.word)), self.pseg,
                        BM25(), self.cstats, **kw)
        return jb, pb

    def execute_both(self, build, **kw):
        jb, pb = self.bind_both(build, **kw)
        assert _fields(jb.cfg, ExecConfig) == pb.cfg
        want = self.js.execute(jb, self.stats)
        got = self.ps.execute(pb, self.stats)
        return got, want, pb.cfg


_WORLD = []


@pytest.fixture(scope="module")
def world():
    if not _WORLD:
        _WORLD.append(World())
    return _WORLD[0]


def tie_groups_equal(got_d, got_s, want_d, want_s):
    """Equal counts of real hits, scores within RTOL rank by rank, and the
    docids equal as sets within each run of scores equal at RTOL (the last
    run, which the cut at k may split, only as a subset of the docs JAX
    could have returned: checked by score alone)."""
    gd, gs = np.asarray(got_d), np.asarray(got_s)
    wd, ws = np.asarray(want_d), np.asarray(want_s)
    real = wd != SENTINEL
    assert (gd != SENTINEL).tolist() == real.tolist()
    np.testing.assert_allclose(gs[real], ws[real], rtol=RTOL)
    assert np.isneginf(gs[~real]).all()
    n = int(real.sum())
    i = 0
    while i < n:
        j = i
        while j + 1 < n and abs(ws[j + 1] - ws[i]) <= RTOL * abs(ws[i]):
            j += 1
        if j + 1 < n or n < len(wd):     # a complete run
            assert set(gd[i:j + 1].tolist()) == set(wd[i:j + 1].tolist())
        i = j + 1


def compare(got, want, exact_order):
    assert int(got["count"]) == int(want["count"])
    assert got["docids"].dtype == np.int32
    assert got["scores"].dtype == np.float32
    assert got["docids"].shape == want["docids"].shape
    if exact_order:
        assert got["docids"].tolist() == np.asarray(want["docids"]).tolist()
        real = np.asarray(want["docids"]) != SENTINEL
        np.testing.assert_allclose(got["scores"][real],
                                   np.asarray(want["scores"])[real],
                                   rtol=RTOL)
    else:
        tie_groups_equal(got["docids"], got["scores"], want["docids"],
                         want["scores"])


# ---------------------------------------------------------------------------
# SegmentSearcher.execute, no collapse: one case per plan shape of the slice
# ---------------------------------------------------------------------------

def _price_range(Qc, slot, lo, hi):
    return Qc.value_range(slot, ser.sortable_key_u64(float(lo)),
                          ser.sortable_key_u64(float(hi)))


PLAIN_CASES = {
    "or3": (lambda w: lambda Qc, t: Qc.or_terms([t(3), t(17), t(60)]),
            {}, False),
    "and_filter_sorted": (
        lambda w: lambda Qc, t: Qc.and_(Qc.term(t(2)),
                                        _price_range(Qc, w.price, 10, 60)),
        lambda w: {"sort": (("value", w.price, True),)}, True),
    "match_all": (lambda w: lambda Qc, t: Qc.match_all(), {}, True),
    "match_all_price_sorted": (
        lambda w: lambda Qc, t: Qc.and_(Qc.match_all(),
                                        _price_range(Qc, w.price, 20, 30)),
        lambda w: {"sort": (("value", w.price, True),)}, True),
    "not_terms": (
        lambda w: lambda Qc, t: Qc.and_not(Qc.match_all(),
                                           Qc.or_(Qc.term(t(0)),
                                                  Qc.term(t(1)))),
        {}, True),
    "synonym": (
        lambda w: lambda Qc, t: Qc.or_(Qc.synonym([t(4), t(9), t(30)]),
                                       Qc.term(t(12))), {}, False),
    "synonym_alone": (
        lambda w: lambda Qc, t: Qc.synonym([t(5), t(6)]), {}, False),
    "max": (
        lambda w: lambda Qc, t: Qc.max_(Qc.term(t(3)), Qc.term(t(8)),
                                        Qc.and_(Qc.term(t(1)),
                                                Qc.term(t(2)))), {}, False),
    "max_in_and": (
        lambda w: lambda Qc, t: Qc.and_(Qc.max_(Qc.term(t(3)),
                                                Qc.term(t(8))),
                                        Qc.term(t(0))), {}, False),
    "max_plus_term": (
        lambda w: lambda Qc, t: Qc.or_(Qc.max_(Qc.term(t(3)), Qc.term(t(8))),
                                       Qc.term(t(20)),
                                       Qc.synonym([t(40), t(41)])),
        {}, False),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_execute_matches_jax(world, case):
    build, kw, exact = PLAIN_CASES[case]
    kw = kw(world) if callable(kw) else kw
    got, want, cfg = world.execute_both(build(world), k=10, **kw)
    compare(got, want, exact)
    if case in ("match_all", "not_terms"):
        # a dense plan with no sort: docid order, its scores returned
        assert cfg.dense and not cfg.sort
        real = got["docids"] != SENTINEL
        assert (np.diff(got["docids"][real]) > 0).all()


def test_execute_dense_scores_every_doc(world):
    """dense_rows' scores and masks through execute at k = 64: NOT w with
    scoring terms beside it (AND_MAYBE keeps match_all generative)."""
    def build(Qc, t):
        return Qc.and_maybe(Qc.match_all(),
                            Qc.or_(Qc.term(t(0)), Qc.term(t(7))))

    got, want, cfg = world.execute_both(build, k=64)
    assert cfg.dense
    compare(got, want, True)
    assert (got["scores"][got["docids"] != SENTINEL] > 0).any()


def test_execute_with_aggs_and_stats_dict(world):
    """The five-stat dict of Database.search; aggregations ride along."""
    aggs = (("count",), ("stats", world.price), ("cardinality", world.size),
            ("geo_stats", world.price))
    got, want, _cfg = world.execute_both(
        lambda Qc, t: Qc.and_(Qc.match_all(),
                              _price_range(Qc, world.price, 20, 70)),
        k=10, aggs=aggs, sort=(("value", world.price, False),))
    compare(got, want, True)
    assert int(got["aggs"][0]) == int(want["aggs"][0])
    for key in ("n", "maxn"):
        assert int(got["aggs"][2][key]) == int(want["aggs"][2][key])
    assert got["aggs"][2]["hll"].tolist() == \
        np.asarray(want["aggs"][2]["hll"]).tolist()
    for key, v in want["aggs"][3].items():
        np.testing.assert_allclose(got["aggs"][3][key], np.asarray(v),
                                   rtol=RTOL)


# ---------------------------------------------------------------------------
# SegmentSearcher.execute with a collapse
# ---------------------------------------------------------------------------

COLLAPSE_CASES = {
    # relevance over three terms
    "relevance": (lambda w: lambda Qc, t: Qc.or_terms([t(3), t(17), t(60)]),
                  {}),
    # one term: docs of equal wdf and length tie, so the order among equal
    # scores is the collapsed position (key ascending, then docs without
    # the value by docid)
    "tied": (lambda w: lambda Qc, t: Qc.term(t(1)), {}),
    "value_sort": (lambda w: lambda Qc, t: Qc.or_terms([t(3), t(17)]),
                   lambda w: {"sort": (("value", w.price, True),)}),
    "dense_sorted": (lambda w: lambda Qc, t: Qc.match_all(),
                     lambda w: {"sort": (("value", w.price, True),)}),
    # a required conjunct: the plan has a compaction cap
    "and_compacted": (
        lambda w: lambda Qc, t: Qc.and_(Qc.term(t(40)),
                                        Qc.or_terms([t(0), t(1), t(2)])),
        {}),
}


@pytest.mark.parametrize("cmax", [1, 3, 9])
@pytest.mark.parametrize("case", sorted(COLLAPSE_CASES))
def test_execute_collapse_matches_jax(world, case, cmax):
    build, kw = COLLAPSE_CASES[case]
    kw = kw(world) if callable(kw) else kw
    got, want, cfg = world.execute_both(
        build(world), k=10, collapse_slot=world.cat, collapse_max=cmax,
        **kw)
    assert cfg.collapse_slot == world.cat and cfg.collapse_max == cmax
    # the count is taken before the collapse
    assert int(got["count"]) == int(want["count"])
    same_scores = np.array_equal(got["scores"], np.asarray(want["scores"]))
    compare(got, want, exact_order=bool(kw) or same_scores)
    if case == "tied":
        assert same_scores, "single-term scores are one float32 expression"
        real = got["docids"] != SENTINEL
        assert len(set(got["scores"][real].tolist())) < int(real.sum())
    # at most min(cmax, 8) survivors a category among the hits
    col = world.jseg.values[world.cat]
    hits = got["docids"][got["docids"] != SENTINEL]
    keys = [(int(col.hi[d]), int(col.lo[d])) for d in hits if col.present[d]]
    assert max((keys.count(x) for x in set(keys)), default=0) <= min(cmax, 8)


def test_execute_collapse_keeps_docs_without_the_value(world):
    """Docs without the collapse value all survive: with the hits of one
    category cut to 1, several valueless docs still rank."""
    got, want, _cfg = world.execute_both(
        lambda Qc, t: Qc.or_terms([t(0), t(1)]), k=64,
        collapse_slot=world.cat, collapse_max=1)
    compare(got, want, np.array_equal(got["scores"],
                                      np.asarray(want["scores"])))
    col = world.jseg.values[world.cat]
    hits = got["docids"][got["docids"] != SENTINEL]
    assert sum(1 for d in hits if not col.present[d]) > N_CATS


def test_execute_collapse_with_carry(world, monkeypatch):
    """cfg.carry set (tests/test_carry.py:71-100): JAX reads the collapse
    key from posting-aligned channels, the port by docid; same answer."""
    monkeypatch.setattr(jplan, "_carry_enabled", lambda: True)
    monkeypatch.setattr(pplan, "_carry_enabled", lambda: True)
    for sort in ((), (("value", world.price, True),)):
        got, want, cfg = world.execute_both(
            lambda Qc, t: Qc.or_terms([t(3), t(17), t(60)]), k=10,
            collapse_slot=world.cat, collapse_max=3, sort=sort,
            keep_carry=True)
        assert (world.cat, ("fval", "hi", "lo")) in cfg.carry
        compare(got, want, bool(sort) or np.array_equal(
            got["scores"], np.asarray(want["scores"])))


# ---------------------------------------------------------------------------
# K10's plain version against _collapse on the same rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmax", [1, 2, 8, 9])
def test_collapse_rows_plain_matches_jax_collapse(world, cmax):
    rng = np.random.Generator(np.random.PCG64(17 + cmax))
    R = 700
    ids = np.sort(rng.choice(N_DOCS, R, replace=False)).astype(np.int32)
    # few distinct scores: ties within and across keys
    scores = rng.integers(1, 6, R).astype(np.float32) / 4
    elig = rng.random(R) < 0.8
    ids[-20:] = SENTINEL
    elig[-20:] = False
    cfg = jex.ExecConfig(T=1, L=128, k=10, tree=("G", 0),
                         collapse_slot=world.cat, collapse_max=cmax)
    od, osc, oel, _ = jax.jit(
        lambda d, s, e: jex._collapse(cfg, world.jarr, d, s, e))(
        jnp.asarray(ids), jnp.asarray(scores), jnp.asarray(elig))
    od, oel = np.asarray(od), np.asarray(oel)
    keep, tie = kernels.collapse_rows(
        torch.from_numpy(ids)[None], torch.from_numpy(scores)[None],
        torch.from_numpy(elig)[None], world.parr["values"][world.cat], cmax)
    keep, tie = keep[0].numpy(), tie[0].numpy()
    # the same survivors
    assert sorted(ids[keep].tolist()) == sorted(od[oel].tolist())
    # and the same order among them: JAX's position, the port's (tie, docid)
    port_order = ids[keep][np.lexsort((ids[keep], tie[keep]))]
    # within one key JAX orders by score first; compare per score
    for s in np.unique(scores[keep]):
        jpos = [d for d, e, sc in zip(od, oel, np.asarray(osc))
                if e and sc == s]
        ppos = [d for d in port_order
                if scores[np.searchsorted(ids[:-20], d)] == s]
        assert jpos == ppos


def test_collapse_rows_missing_slot_keeps_every_eligible_row():
    ids = torch.arange(50, dtype=torch.int32)[None]
    sums = torch.ones((1, 50))
    elig = torch.arange(50)[None] % 3 != 0
    keep, tie = kernels.collapse_rows(ids, sums, elig, None, 1)
    assert torch.equal(keep, elig)
    assert (tie == kernels.I32MAX).all()


# ---------------------------------------------------------------------------
# BatchSearcher: the browse families against the JAX BatchSearcher
# ---------------------------------------------------------------------------

def family(world, fam, Qc):
    rng = np.random.Generator(np.random.PCG64(23))
    t = world.word
    out = []
    for _ in range(12):
        a, b, c, d = (int(x) for x in rng.integers(0, 60, 4))
        if fam == "M":
            lo = int(rng.integers(1, 80))
            out.append(Qc.and_(Qc.match_all(),
                               _price_range(Qc, world.price, lo, lo + 15)))
        elif fam == "N":
            out.append(Qc.and_not(Qc.match_all(),
                                  Qc.or_(Qc.term(t(a)), Qc.term(t(b)))))
        elif fam == "S":
            out.append(Qc.or_(Qc.synonym([t(a), t(b), t(c)]), Qc.term(t(d))))
        else:
            out.append(Qc.max_(Qc.term(t(a)), Qc.term(t(b)),
                               Qc.and_(Qc.term(t(c)), Qc.term(t(d)))))
    return out


def family_kwargs(world, fam):
    if fam != "M":
        return {}
    return {"sort": (("value", world.price, True),),
            "aggs": ((("count",), ("stats", world.price),
                      ("cardinality", world.size)), None)}


@pytest.mark.parametrize("fam", ["M", "N", "S", "X"])
def test_batch_run_matches_jax(world, fam):
    kw = family_kwargs(world, fam)
    jb = JBatch(world.js, k=10, min_batch=8, **kw)
    pb = BatchSearcher(world.ps, k=10, min_batch=8, **kw)
    jq, pq = family(world, fam, JQ), family(world, fam, Q)
    jgroups, pgroups = jb.plan(jq), pb.plan(pq)
    assert [(_fields(c, ExecConfig), ch) for c, _f, _b, ch in jgroups] == \
        [(c, ch) for c, _f, _b, ch in pgroups]
    for (_c, _f, jbatch, _ch), (cfg, _f2, pbatch, chunk) in zip(jgroups,
                                                               pgroups):
        if cfg.syn_groups:
            assert pbatch["syn_tconst"].shape == (len(chunk),
                                                  len(cfg.syn_groups))
            np.testing.assert_array_equal(pbatch["syn_tconst"].numpy(),
                                          np.asarray(jbatch["syn_tconst"]))
        # a group runs under its first member's masks: every member's are
        # the unified config's (one signature, one group numbering)
        for qi in chunk:
            own = pplan.bind(pplan.compile_ir(pq[qi]), world.pseg, BM25(),
                             world.cstats).cfg
            assert own.syn_groups == cfg.syn_groups
            assert own.max_specs == cfg.max_specs
            assert own.dense == cfg.dense
    want, got = jb.run(jq), pb.run(pq)
    for g, w in zip(got, want):
        compare(g, w, exact_order=fam in "MN")
        if fam == "M":
            assert int(g["aggs"][0]) == int(w["aggs"][0])
            assert int(g["aggs"][2]["n"]) == int(w["aggs"][2]["n"])
            assert g["aggs"][2]["hll"].tolist() == \
                np.asarray(w["aggs"][2]["hll"]).tolist()
            for key in ("n", "min", "max"):
                assert float(g["aggs"][1][key]) == float(w["aggs"][1][key])
            np.testing.assert_allclose(g["aggs"][1]["s"], w["aggs"][1]["s"],
                                       rtol=RTOL)


def test_prefixify_leaves_special_plans_alone(world):
    """Dense, synonym and max groups are never prefixified
    (xapiand_tpu/search.py:492-494)."""
    pb = BatchSearcher(world.ps, k=10, min_batch=8, prefix_cap=128)
    for fam in "NSX":
        for cfg, *_ in pb.plan(family(world, fam, Q)):
            assert not any(cfg.prefix) and not cfg.verify_k


# ---------------------------------------------------------------------------
# repairs and refusals
# ---------------------------------------------------------------------------

def test_compaction_condition_includes_collapse(world, monkeypatch):
    """A collapsing plan with a cap below its row width packs its eligible
    rows before the collapse reads its keys, as JAX does (execute 893-895),
    also without a sort or aggregations."""
    _jb, pb = world.bind_both(
        lambda Qc, t: Qc.and_(Qc.term(t(40)),
                              Qc.or_terms([t(0), t(1), t(2)])),
        k=10, collapse_slot=world.cat)
    cfg = pb.cfg
    assert 0 < cfg.compact_cap < sum(cfg.classes)
    assert not cfg.sort and not cfg.with_aggs
    calls = []
    real = kernels.compact_rows
    monkeypatch.setattr(kernels, "compact_rows",
                        lambda *a: calls.append(a[4]) or real(*a))
    world.ps.execute(pb, world.stats)
    assert calls == [cfg.compact_cap]
    calls.clear()
    world.ps.execute(dataclasses.replace(pb, cfg=dataclasses.replace(
        cfg, collapse_slot=None)), world.stats)
    assert calls == []


def test_zero_synonym_constant_scores_zero(world):
    """syn_tconst pads with zeros; a zero constant adds nothing."""
    _jb, pb = world.bind_both(
        lambda Qc, t: Qc.or_(Qc.synonym([t(4), t(9)]), Qc.term(t(12))), k=10)
    base = world.ps.execute(pb, world.stats)
    arrays = dict(pb.arrays, syn_tconst=np.zeros_like(
        pb.arrays["syn_tconst"]))
    zero = world.ps.execute(dataclasses.replace(pb, arrays=arrays),
                            world.stats)
    term = world.ps.execute(world.bind_both(
        lambda Qc, t: Qc.term(t(12)), k=10)[1], world.stats)
    assert int(zero["count"]) == int(base["count"])
    # with the constant 0 only w12 scores: the top is w12's own top
    assert zero["docids"].tolist() == term["docids"].tolist()
    assert np.array_equal(zero["scores"], term["scores"])
    assert zero["scores"][0] <= base["scores"][0]


@pytest.mark.parametrize("field,value,item", [
    ("emit_sort_keys", True, "K19"),
    ("n_chunks", 2, "K21"),
    ("join", True, "K21"),
])
def test_check_supported_still_refuses(field, value, item):
    cfg = ExecConfig(T=1, L=128, k=10, tree=("G", 0), **{field: value})
    with pytest.raises(NotImplementedError, match=item):
        check_supported(cfg, BM25())


@pytest.mark.parametrize("over", [
    {"dense": True, "tree": ("ALL",)},
    {"collapse_slot": 3},
    {"syn_groups": (1,)},
    {"max_specs": ((1, 2),)},
])
def test_check_supported_admits_the_slice(over):
    cfg = ExecConfig(**{**dict(T=1, L=128, k=10, tree=("G", 0)), **over})
    check_supported(cfg, BM25())


def test_check_supported_refuses_too_many_synonym_groups():
    cfg = ExecConfig(T=1, L=128, k=10, tree=("G", 0),
                     syn_groups=(1,) * (kernels.MAX_SPECIAL + 1))
    with pytest.raises(NotImplementedError, match="synonym groups"):
        check_supported(cfg, BM25())


def test_check_supported_refuses_a_collapse_in_prefix_mode():
    """The impact-prefix branch goes round the collapse step, so the pair
    is refused by name rather than answered without the collapse."""
    cfg = ExecConfig(T=1, L=128, k=10, tree=("G", 0), collapse_slot=3,
                     prefix=(64,), verify_k=32)
    with pytest.raises(NotImplementedError, match="collapse in impact-prefix"):
        check_supported(cfg, BM25())


def test_check_aggs_admits_k17b_and_refuses_k17c():
    """K17b runs on both paths; K17c (here percentiles) runs on the single
    query path since PR 8 and is refused on the batch path, whose JAX
    BatchSearcher drops its plan arrays."""
    paggs.check_aggs((("cardinality", 1), ("geo_stats", 2)))
    paggs.check_aggs((("cardinality", 1), ("geo_stats", 2)), batched=True)
    paggs.check_aggs((("percentiles", 1, 64),))
    with pytest.raises(NotImplementedError, match="K17c"):
        paggs.check_aggs((("percentiles", 1, 64),), batched=True)
