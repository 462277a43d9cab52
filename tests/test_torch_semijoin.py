"""The semijoin executor (K21c) against the JAX package on the CPU.

A semijoin plan (``cfg.drive >= 0``) is what the shared planner binds
whenever ``query/plan.py``'s SEMIJOIN_RATIO is a number (``_pick_drive``);
each package's pinned planner module is forced here, as
``tests/test_query_ops.py::test_semijoin_matches_sort_pipeline_exactly``
forces the JAX one, and every search takes the device path (XT_HOST_PATH
0: conjunctive ANDs route to the native host executor by default). Each
test counts the calls of ``kernels.semijoin_rows``, so a semijoin that
silently fell back to the sort pipeline would fail it.

  Database.search       the mirror of test_query_ops:126-170 (ratio 1 and
                        10**9) against JAX's Database and the port's own
                        sort pipeline; then value filters, a geo leg,
                        aggregations, a value sort, a collapse, deletes
  BatchSearcher.run     semijoin launch groups against JAX's
  semijoin_rows         its plain version against the rows JAX's
                        _execute_semijoin hands to _finish_rows, under
                        BM25, PL2 (two constants a term) and DiceCoeff
                        (the drive row's uniqterms)

Tolerances: ids, counts, orbits and first flags are equal; the semijoin's
sums are added drive term first, as JAX adds them, so under BM25 a doc's
row sums equal JAX's bit for bit, and under PL2 and DiceCoeff within rtol
1e-5 (XLA's and torch's log2 differ by ulps: 2.6e-6 relative at most on
this segment); answers agree to rtol 1e-5 with JAX's and with the sort
pipeline, which adds in term order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import xapiand_tpu.ops.executor as jex
import xapiand_tpu.query.plan as jplan
from xapiand_tpu.database import Database as JDB
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.models.weights import get_scheme as jget
from xapiand_tpu.query.dsl import parse_sort as jparse_sort
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu.utils.synth import build_synthetic_segment
from xapiand_tpu_torch.database import Database as PDB
from xapiand_tpu_torch.models.segment import Segment, terms_from
from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.query import plan as pplan
from xapiand_tpu_torch.query.dsl import parse_sort
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_schemes as ss

RTOL = 1e-5
CPU = torch.device("cpu")
N_DOCS = 3000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


@pytest.fixture
def semijoin(monkeypatch):
    """Force both planners to bind semijoins (ratio 1) and count the
    port's semijoin_rows calls; ratio(r) sets another ratio."""
    calls = []
    real = kernels.semijoin_rows
    monkeypatch.setattr(kernels, "semijoin_rows",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def ratio(r):
        monkeypatch.setattr(jplan, "SEMIJOIN_RATIO", r)
        monkeypatch.setattr(pplan, "SEMIJOIN_RATIO", r)

    ratio(1)
    return calls, ratio


def _doc(i):
    g = np.random.Generator(np.random.PCG64(i))
    p = 1.0 / np.arange(1, 51)
    d = {"body": " ".join(f"w{int(x)}" for x in
                          g.choice(50, 10, p=p / p.sum())),
         "price": int(g.integers(0, 100)),
         "loc": {"_point": {"_latitude": 30.0 + float(g.random()) * 10,
                            "_longitude": -100.0 + float(g.random()) * 10}}}
    if i % 9:
        d["cat"] = f"cat{int(g.integers(0, 20))}"
    return d


@pytest.fixture(scope="module")
def dbs():
    """The same docs in a JAX Database and the port's: two commits (two
    segments), then 1% deleted and a third commit."""
    out = (JDB(), PDB(device="cpu"))
    for db in out:
        for i in range(N_DOCS):
            db.index_document(_doc(i), doc_id=str(i))
            if i == N_DOCS // 2:
                db.commit()
        db.commit()
        for i in range(3, N_DOCS, 97):
            db.delete_document(str(i))
        db.commit()
    return out


def _same(got, want, rtol=RTOL):
    assert got.total == want.total
    assert [h.id for h in got.hits] == [h.id for h in want.hits]
    np.testing.assert_allclose([h.score for h in got.hits],
                               [h.score for h in want.hits], rtol=rtol)


# the queries of tests/test_query_ops.py:150-155, with its seed
def _mirror_queries():
    import random

    rng = random.Random(7)
    qs = [{"_and": [{"cat": f"cat{rng.randint(0, 19)}"},
                    {"body": f"w{rng.randint(0, 6)}"}]} for _ in range(6)]
    return qs + [{"_and": [{"cat": "cat3"}, {"body": "w0"}, {"body": "w1"}]},
                 {"_filter": [{"body": "w2"}, {"cat": "cat5"}]},
                 {"_and": [{"cat": "cat1"},
                           {"_or": [{"body": "w0"}, {"body": "w3"}]}]}]


def test_semijoin_matches_jax_and_the_sort_pipeline(dbs, semijoin):
    """test_query_ops.py:126-170 through the port's Database: at ratio 1
    every query runs the semijoin (semijoin_rows called, nothing
    host-routed) and equals JAX's and the port's sort pipeline (ratio
    10**9, no semijoin call)."""
    jdb, pdb = dbs
    calls, ratio = semijoin
    qs = _mirror_queries()
    semi = []
    for q in qs:
        n0 = len(calls)
        got, want = pdb.search(q, k=10), jdb.search(q, k=10)
        _same(got, want)
        assert len(calls) > n0, q
        semi.append(got)
    ratio(10 ** 9)
    n0 = len(calls)
    for q, a in zip(qs, semi):
        b = pdb.search(q, k=10)
        _same(a, b)
        _same(b, jdb.search(q, k=10))
    assert len(calls) == n0


FEATURES = {
    "filter": ({"_and": [{"cat": "cat2"}, {"body": "w1"},
                         {"price": {"_from": 20, "_to": 70}}]}, {}),
    "geo": ({"_and": [{"body": "w4"}, {"cat": "cat7"},
                      {"loc": {"_circle": {"_lat": 35.0, "_lon": -95.0,
                                           "_radius": 400000.0}}}]}, {}),
    "aggs": ({"_and": [{"cat": "cat4"}, {"body": "w0"}]},
             {"aggs": {"p": {"_stats": {"_field": "price"}},
                       "h": {"_histogram": {"_field": "price",
                                            "_interval": 25}}}}),
    "sort": ({"_and": [{"body": "w2"}, {"cat": "cat9"}]},
             {"sort": [{"price": {"_order": "desc"}}], "k": 15}),
    "collapse": ({"_and": [{"body": "w0"},
                           {"_or": [{"cat": "cat1"}, {"cat": "cat2"},
                                    {"body": "w3"}]}]},
                 {"collapse": "cat", "collapse_max": 2}),
    "count_only": ({"_and": [{"body": "w5"}, {"cat": "cat0"}]},
                   {"count_only": True}),
}


@pytest.mark.parametrize("case", list(FEATURES))
def test_semijoin_search_features_match_jax(dbs, semijoin, case):
    """Database.search at ratio 1 with value filters, a geo leg,
    aggregations, a value sort, a collapse and count-only, over segments
    with deletes: the semijoin runs and the answers equal JAX's."""
    jdb, pdb = dbs
    calls, _ratio = semijoin
    q, kw = FEATURES[case]
    kw = dict(kw)
    out = []
    for db, ps in ((jdb, jparse_sort), (pdb, parse_sort)):
        kwd = dict(kw)
        if "sort" in kwd:
            kwd["sort"] = ps(db.schema, kwd["sort"])
        if "collapse" in kwd:
            kwd["collapse_slot"] = db.schema.get_field(
                kwd.pop("collapse")).slot
        out.append(db.search(q, **kwd))
    want, got = out
    assert calls, "no semijoin ran"
    _same(got, want)
    assert got.aggregations == want.aggregations
    if case != "count_only":
        assert want.total > 0


def _segment_pair():
    """A 4,000-doc synthetic segment with real uniqterms and stats, as the
    JAX package's and the port's segment."""
    seg = build_synthetic_segment(4000, 300, seed=3)
    seg.uniqterms = ss.uniqterms(seg)
    ss.real_collfreq(seg)
    seg.deleted[7::61] = True
    pseg = Segment(**{**{f: getattr(seg, f) for f in
                         Segment.__dataclass_fields__},
                      "terms": terms_from(seg.terms)})
    return seg, pseg


@pytest.fixture(scope="module")
def segs():
    return _segment_pair()


def _and_queries(seg, n=12):
    rng = np.random.Generator(np.random.PCG64(4))
    names = sorted(seg.terms, key=lambda t: -seg.terms[t].length)
    out = []
    for _ in range(n):
        big = names[int(rng.integers(0, 10))]
        small = names[int(rng.integers(40, 200))]
        mid = names[int(rng.integers(5, 40))]
        out.append((small, big, mid))
    return out


@pytest.mark.parametrize("scheme", ["bm25", "pl2", "dicecoeff"])
def test_semijoin_rows_equal_jax_rows(segs, semijoin, monkeypatch, scheme):
    """kernels.semijoin_rows (its plain version) against the rows JAX's
    _execute_semijoin builds - ids, sums (drive term first), orbits and
    the real flags, the deletes applied - for every drive position of
    AND(term, OR(term, term)) plans."""
    seg, pseg = segs
    st = ss.real_stats(seg)
    jst = JStats(**{f: getattr(st, f) for f in
                    ("doc_count", "avg_doclen", "doclen_lower",
                     "doclen_upper", "total_len")})
    js = JSearcher(seg, jget(scheme))
    jarr = js.device_segment.arrays_pytree()
    ps = SegmentSearcher(pseg, get_scheme(scheme), device=CPU)
    parr = ps.device_segment.arrays_pytree()
    captured = {}

    def capture(seg_, plan_, cfg_, d, sums, orbits, first):
        captured.update(d=d, sums=sums, orbits=orbits, first=first)
        return {}

    monkeypatch.setattr(jex, "_finish_rows", capture)
    spec = get_scheme(scheme).kernel_spec(st)
    n_rows = 0
    for small, big, mid in _and_queries(seg):
        for drive in range(3):
            jb = jplan.bind(jplan.compile_ir(JQ.and_(
                JQ.term(small), JQ.or_terms([big, mid]))), seg, jget(scheme),
                jst, k=10)
            cfg = dataclasses.replace(jb.cfg, drive=drive)
            jex._execute_semijoin(jarr, {k: np.asarray(v) for k, v in
                                         jb.arrays.items()},
                                  cfg, jst, jget(scheme))
            arr = {k: torch.from_numpy(np.asarray(jb.arrays[k])[None])
                   for k in ("offsets", "lens", "tconst", "scoring",
                             "group_bits")}
            ids, sums, orbits, first, count = kernels.semijoin_rows(
                (parr["post_docids"], parr["post_wdf"], parr["post_doclen"]),
                arr["offsets"], arr["lens"], arr["tconst"], arr["scoring"],
                arr["group_bits"], cfg.term_classes(), drive,
                parr["deleted"], spec,
                parr["uniqterms"] if spec.needs_uniq else None)
            d = np.asarray(captured["d"])
            real = d != kernels.SENTINEL
            dele = np.asarray(seg.deleted)[np.minimum(
                d, len(seg.deleted) - 1)]
            assert ids[0].tolist() == d.tolist()
            assert orbits[0].tolist() == np.asarray(
                captured["orbits"]).tolist()
            assert first[0].tolist() == (np.asarray(captured["first"])
                                         & ~dele).tolist()
            assert int(count[0]) == int((real & ~dele).sum())
            np.testing.assert_allclose(sums[0].numpy()[real],
                                       np.asarray(captured["sums"])[real],
                                       rtol=0 if scheme == "bm25" else RTOL)
            n_rows += int(real.sum())
    assert n_rows > 0


def test_semijoin_batch_matches_jax(segs, semijoin):
    """BatchSearcher.run with every launch group a semijoin (forced
    ratio), a value-free plan: the port's answers equal JAX's, and its
    groups carry JAX's drive positions."""
    seg, pseg = segs
    qs = _and_queries(seg, 24)
    irs = [Q.and_(Q.term(s), Q.or_terms([b, m])) for s, b, m in qs]
    jirs = [JQ.and_(JQ.term(s), JQ.or_terms([b, m])) for s, b, m in qs]
    calls, _ratio = semijoin
    js = JSearcher(seg, jget("bm25"))
    jb = JBatch(js, k=10)
    want = jb.run(jirs)
    bs = BatchSearcher(SegmentSearcher(pseg, device=CPU), k=10)
    groups = bs.plan(irs)
    assert [c.drive for c, *_x in groups] == \
        [c.drive for c, *_x in jb.plan(jirs)]
    assert all(c.drive >= 0 for c, *_x in groups)
    got = bs.run(irs)
    assert calls
    for g, w in zip(got, want):
        assert int(g["count"]) == int(w["count"])
        assert g["docids"].tolist() == np.asarray(w["docids"]).tolist()
        real = g["docids"] != kernels.SENTINEL
        np.testing.assert_allclose(g["scores"][real],
                                   np.asarray(w["scores"])[real], rtol=RTOL)


@pytest.mark.parametrize("scheme", ["pl2", "pl2plus", "dlh", "dph"])
def test_semijoin_nan_schemes_match_jax(dbs, semijoin, scheme):
    """ROADMAP queue 3's mirrored NaN: under these schemes a non-scoring
    term (a FILTER's right side) weighs NaN where its constants are 0, a
    semijoin row holding it sums to NaN, and JAX ranks such rows below
    every other, though they count. FILTER plans at ratio 1 under each
    scheme: the semijoin runs and the hits and totals equal JAX's. (BB2,
    the sixth such scheme, cancels in float32 - port and JAX 7.8e-4
    apart, relative, on these plans - and is held to its derived bound in
    tests/test_torch_schemes.py.)"""
    jdb, pdb = dbs
    calls, _ratio = semijoin
    qs = [{"_filter": [{"body": "w2"}, {"cat": "cat5"}]},
          {"_and": [{"body": "w1"}, {"_filter": [{"cat": "cat3"},
                                                  {"body": "w0"}]}]}]
    for q in qs:
        want = jdb.search(q, k=10, scheme=jget(scheme))
        got = pdb.search(q, k=10, scheme=get_scheme(scheme))
        assert want.total > 0
        _same(got, want)
    assert calls
