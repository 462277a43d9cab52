"""The port's Database against the JAX Database, on the CPU: the engine
(tests/test_engine.py), the cutoffs (tests/test_cutoff.py, its single-node
cases), search_many (tests/test_search_many.py, its single-node cases),
host routing and the state carry.

Both packages index the same documents with the same ids; the port runs
with ``device="cpu"``, where every kernel wrapper runs its plain version.
Hits are compared as ranked ids, with scores within rtol 1e-5 (the two
sum a doc's rows in another order; ties are broken by (segment, docid)
on both sides, so equal scores rank alike), counts exactly.

Routing: the JAX side always runs its device path (XT_HOST_PATH=0: its
native library may be missing in a test worker, and its host executors
then decline), the port either path; the native host executors are
exact, so the results must be the same. The port's own native library is
built into its gitignored _build/ at first use, never in place.

The state carry (database.from_jax_state) builds a port Database from a
JAX Database's committed segments, schema, document store and id map;
searches over it must equal the JAX ones, whatever indexing does.
"""

import random

import numpy as np
import pytest
import torch

from xapiand_tpu.database import Database as JDB
from xapiand_tpu.query.dsl import parse_sort as jparse_sort
from xapiand_tpu_torch.database import (Database as PDB, DocumentNotFound,
                                        from_jax_state)
from xapiand_tpu_torch.models.segment import terms_from
from xapiand_tpu_torch.query.dsl import QueryDSL, parse_sort
from xapiand_tpu_torch.search import SegmentSearcher

RTOL = 1e-5
WORDS = ("quick brown fox jumps over lazy dog cat bird fish red blue green "
         "big small fast slow happy sad city town river mountain code search "
         "engine data index query tensor device mesh shard").split()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


def make_docs(n, seed=42):
    rng = random.Random(seed)
    return [{"title": " ".join(rng.choices(WORDS, k=3)),
             "body": " ".join(rng.choices(WORDS, k=rng.randint(5, 40))),
             "price": rng.randint(1, 1000),
             "category": rng.choice(["alpha", "beta", "gamma", "delta"]),
             "stars": rng.random() * 5} for _ in range(n)]


def _index(db, docs, commit_every=None):
    for i, doc in enumerate(docs):
        db.index_document(dict(doc), doc_id=str(i))
        if commit_every and (i + 1) % commit_every == 0:
            db.commit()
    db.commit()
    return db


@pytest.fixture(scope="module")
def dbs():
    docs = make_docs(300)
    return (_index(JDB(), docs, commit_every=150),
            _index(PDB(device="cpu"), docs, commit_every=150))


def same_hits(got, want, ranks=True):
    assert got.total == want.total
    assert [h.id for h in got.hits] == [h.id for h in want.hits]
    np.testing.assert_allclose([h.score for h in got.hits],
                               [h.score for h in want.hits], rtol=RTOL)
    if ranks:
        assert [h.rank for h in got.hits] == [h.rank for h in want.hits]


def both(dbs, query, jquery=None, monkeypatch=None, host=None, **kw):
    """The JAX Database on its device path; the port with XT_HOST_PATH as
    given (default: off)."""
    jdb, pdb = dbs
    want = jdb.search(jquery if jquery is not None else query, **kw)
    if host is not None:
        monkeypatch.setenv("XT_HOST_PATH", host)
    got = pdb.search(query, **kw)
    same_hits(got, want)
    return got, want


ENGINE = {
    "single_term": {"body": "fox"},
    "multi_term_or": {"body": "fox river code"},
    "and": {"_and": [{"body": "fox"}, {"body": "dog"}]},
    "and_not": {"_and_not": [{"body": "fox"}, {"body": "dog"}]},
    "and_maybe": {"_and_maybe": [{"body": "fox"}, {"body": "river"}]},
    "value_range": {"price": {"_from": 100, "_to": 300}},
    "range_and_term": {"body": "fox", "price": {"_from": 0, "_to": 500}},
    "keyword": {"category": "alpha"},
    "match_all": {"_match_all": {}},
}


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_engine_queries_match_jax(dbs, case):
    """BM25 ranks and scores, AND / AND_NOT / AND_MAYBE, value ranges and
    keyword terms over two generations (test_engine.py's queries)."""
    got, _want = both(dbs, ENGINE[case], k=20)
    assert got.total > 0


@pytest.mark.parametrize("order", ["asc", "desc"])
def test_sort_by_value_matches_jax(dbs, order):
    jdb, pdb = dbs
    q = {"category": "beta"}
    spec = [{"price": {"_order": order}}]
    want = jdb.search(q, k=12, sort=jparse_sort(jdb.schema, spec))
    got = pdb.search(q, k=12, sort=parse_sort(pdb.schema, spec))
    same_hits(got, want)
    prices = [got.hits[i].data["price"] for i in range(len(got.hits))]
    assert prices == sorted(prices, reverse=order == "desc")


def test_count_matches_jax(dbs):
    jdb, pdb = dbs
    for q in ({"body": "river"}, {"category": "gamma"},
              {"_and": [{"body": "fox"}, {"price": {"_from": 0,
                                                    "_to": 400}}]}):
        assert pdb.count(q) == jdb.count(q) > 0


def test_offsets_and_k_zero_match_jax(dbs):
    both(dbs, {"body": "fox river"}, k=7, offset=5)
    got, _w = both(dbs, {"body": "fox"}, k=0,
                   aggs={"c": {"_terms": {"_field": "category"}}})
    assert got.hits == []


@pytest.mark.parametrize("case", ["single_term", "multi_term_or", "and",
                                  "range_and_term", "keyword"])
def test_host_routing_on_and_off(dbs, monkeypatch, case):
    """The port with its native host executors on (the default) and off:
    the same answers, both equal to the JAX device path."""
    on, _w = both(dbs, ENGINE[case], monkeypatch=monkeypatch, host="1",
                  k=10)
    off, _w = both(dbs, ENGINE[case], monkeypatch=monkeypatch, host="0",
                   k=10)
    same_hits(on, off)


def test_plain_queries_take_the_host_route(dbs, monkeypatch):
    """A lone plain relevance query goes to the native TAAT scorer
    (Database._use_host_path), as in the JAX package; with XT_HOST_PATH=0
    it goes to the device."""
    _jdb, pdb = dbs
    calls = []
    real = PDB._search_host

    def spy(self, cqs, *a, **kw):
        calls.append(len(cqs))
        return real(self, cqs, *a, **kw)

    monkeypatch.setattr(PDB, "_search_host", spy)
    monkeypatch.setenv("XT_HOST_PATH", "1")
    pdb.search({"body": "fox"}, k=5)
    assert calls == [1]
    monkeypatch.setenv("XT_HOST_PATH", "0")
    pdb.search({"body": "fox"}, k=5)
    assert calls == [1]


def test_batch_searcher_routes_to_the_host(dbs, monkeypatch):
    """BatchSearcher.run routes conjunctive and small pure-OR queries to
    the native executors before it plans (JAX search.py:399-483); the
    answers equal the device path's."""
    from xapiand_tpu_torch.search import BatchSearcher

    _jdb, pdb = dbs
    searcher = pdb._searchers[0]
    irs = [QueryDSL(pdb.schema).parse(q) for q in
           ({"body": "fox river"},
            {"_and": [{"body": "fox"}, {"body": "dog"}]}, {"body": "code"})]
    monkeypatch.setenv("XT_HOST_PATH", "1")
    bs = BatchSearcher(searcher, k=10, min_batch=4)
    on = bs.run(irs)
    assert bs.routed["device"] == 0 and \
        bs.routed["conj"] + bs.routed["or"] == len(irs)
    monkeypatch.setenv("XT_HOST_PATH", "0")
    bs0 = BatchSearcher(searcher, k=10, min_batch=4)
    off = bs0.run(irs)
    assert bs0.routed["device"] == len(irs)
    for a, b in zip(on, off):
        assert int(a["count"]) == int(b["count"])
        real = np.asarray(b["docids"]) != 2**31 - 1
        np.testing.assert_array_equal(np.asarray(a["docids"])[real],
                                      np.asarray(b["docids"])[real])
        np.testing.assert_allclose(np.asarray(a["scores"])[real],
                                   np.asarray(b["scores"])[real], rtol=RTOL)


def test_delete_and_replace_across_commits(monkeypatch):
    """Deletes after a commit reach the device mirror (refresh_deleted);
    replacements across generations keep the last version; both packages
    agree (test_engine.py test_delete_and_replace, over three
    generations)."""
    docs = make_docs(60, seed=3)
    jdb, pdb = JDB(), PDB(device="cpu")
    for db in (jdb, pdb):
        _index(db, docs, commit_every=20)
    q = {"body": "fox river dog"}
    both((jdb, pdb), q, k=10)      # the device mirrors are uploaded
    for db in (jdb, pdb):
        db.delete_document("7")
        db.delete_document("31", commit=True)
        db.index_document({"body": "zebra unicorn", "price": 5},
                          doc_id="8")
        db.index_document({"body": "zebra fox", "price": 6}, doc_id="45",
                          commit=True)
        db.delete_document("50")   # not committed: the bitmap alone
    assert pdb.doc_count == jdb.doc_count == 57
    for query in (q, {"body": "zebra"}, {"_id": "7"}, {"_match_all": {}}):
        both((jdb, pdb), query, k=15)
    got = pdb.search({"body": "zebra"}, k=10)
    assert sorted(h.id for h in got.hits) == ["45", "8"]
    with pytest.raises(DocumentNotFound):
        pdb.get_document("7")
    assert pdb.get_document("8")["body"] == "zebra unicorn"
    ps, js = pdb.stats(), jdb.stats()   # two packages' dataclasses
    assert [getattr(ps, f) for f in ps.__dataclass_fields__] == \
        [getattr(js, f) for f in js.__dataclass_fields__]


def test_multiple_uncommitted_replacements_survive_commit():
    jdb, pdb = JDB(), PDB(device="cpu")
    for db in (jdb, pdb):
        db.index_document({"body": "one"}, doc_id="x")
        db.index_document({"body": "two"}, doc_id="x")
        db.index_document({"body": "three"}, doc_id="x")
        db.commit()
    for w in ("one", "two", "three"):
        both((jdb, pdb), {"body": w}, k=5)
    assert pdb.get_document("x")["body"] == "three"


def test_merge_segments_keeps_answers(dbs):
    docs = make_docs(90, seed=8)
    jdb, pdb = JDB(), PDB(device="cpu")
    for db in (jdb, pdb):
        _index(db, docs, commit_every=30)
        db.delete_document("4")
        db.merge_segments()
        assert len(db._searchers) == 1
    both((jdb, pdb), {"body": "fox city"}, k=10)
    for term in list(pdb._searchers[0].segment.terms)[:50]:
        assert pdb.global_termfreq(term) == jdb.global_termfreq(term), term
        assert pdb.global_collfreq(term) == jdb.global_collfreq(term), term


# -- tests/test_cutoff.py, single-node ---------------------------------------

def _cutoff_dbs():
    docs = [("d0", "apple apple apple apple banana"),
            ("d1", "apple apple apple cherry"),
            ("d2", "apple apple date"),
            ("d3", "apple elderberry"),
            ("d4", "fig grape")]
    out = []
    for db in (JDB(), PDB(device="cpu")):
        for did, body in docs:
            db.index_document({"_id": did, "body": body})
        db.commit()
        out.append(db)
    return out


@pytest.mark.parametrize("host", ["0", "1"])
def test_cutoffs_match_jax(monkeypatch, host):
    dbs2 = _cutoff_dbs()
    base, _w = both(dbs2, {"body": "apple"}, monkeypatch=monkeypatch,
                    host=host, k=10)
    scores = [h.score for h in base.hits]
    thr = (scores[1] + scores[2]) / 2.0
    got, _w = both(dbs2, {"body": "apple"}, monkeypatch=monkeypatch,
                   host=host, k=10, weight_cutoff=thr)
    assert len(got.hits) == 2 and got.total == 4
    pct = (scores[2] / scores[0]) * 100 + 1e-6
    got, _w = both(dbs2, {"body": "apple"}, monkeypatch=monkeypatch,
                   host=host, k=10, percent_cutoff=pct)
    assert len(got.hits) == 2
    thr3 = (scores[2] + scores[3]) / 2.0
    got, _w = both(dbs2, {"body": "apple"}, monkeypatch=monkeypatch,
                   host=host, k=2, offset=1, weight_cutoff=thr3)
    assert [h.rank for h in got.hits] == [1, 2]


# -- tests/test_search_many.py, single-node ----------------------------------

@pytest.fixture(scope="module")
def many_dbs():
    rng = random.Random(5)
    words = [f"w{i}" for i in range(120)]
    docs = [{"body": " ".join(rng.choices(words, k=25)),
             "n": rng.randrange(100)} for _ in range(900)]
    out = []
    for db in (JDB(), PDB(device="cpu")):
        _index(db, docs, commit_every=300)
        for d in ("3", "7", "401", "802"):
            db.delete_document(d)
        db.commit()
        out.append(db)
    return out


MANY = [{"body": "w1 w2 w3"},
        {"_or": [{"body": "w5"}, {"body": "w9"}, {"body": "w17"}]},
        {"body": "w40"},
        {"_and": [{"body": "w3"}, {"body": "w8"}]},
        {"_or": [{"body": "w110"}, {"body": "w111"}]}]


@pytest.mark.parametrize("host", ["0", "1"])
def test_search_many_matches_search_and_jax(many_dbs, monkeypatch, host):
    jdb, pdb = many_dbs
    want = jdb.search_many(MANY, k=10)
    monkeypatch.setenv("XT_HOST_PATH", host)
    singles = [pdb.search(q, k=10) for q in MANY]
    many = pdb.search_many(MANY, k=10)
    for a, b, w in zip(singles, many, want):
        same_hits(b, a)
        same_hits(b, w)


def test_search_many_offset_and_scheme(many_dbs):
    jdb, pdb = many_dbs
    qs = [{"body": "w1 w2"}, {"body": "w4 w6"}]
    for a, w in zip(pdb.search_many(qs, k=5, offset=3, scheme="pl2"),
                    jdb.search_many(qs, k=5, offset=3, scheme="pl2")):
        same_hits(a, w)


# -- the state carry ------------------------------------------------------------

def _jax_state(jdb):
    def fields(obj):
        return {f: getattr(obj, f) for f in obj.__dataclass_fields__}

    segs = []
    for s in jdb._searchers:
        f = fields(s.segment)
        f["terms"] = terms_from(s.segment.terms)
        f["values"] = {k: fields(c) for k, c in s.segment.values.items()}
        f["geo"] = {k: fields(g) for k, g in s.segment.geo.items()}
        segs.append(f)
    return {"segments": segs, "schema": jdb.schema.to_dict(),
            "docs": dict(jdb._docs_store), "locate": dict(jdb._locate)}


def test_state_carry_matches_jax(dbs):
    """A port Database holding the JAX Database's committed state
    (segments, schema, document store, id map) answers as the JAX one:
    search parity apart from indexing parity."""
    jdb, _pdb = dbs
    carried = from_jax_state(**_jax_state(jdb), device="cpu",
                             revision=jdb.revision)
    assert carried.doc_count == jdb.doc_count
    assert len(carried._searchers) == len(jdb._searchers)
    for q in ENGINE.values():
        same_hits(carried.search(q, k=10), jdb.search(q, k=10))
    aggs = {"h": {"_histogram": {"_field": "price", "_interval": 100,
                                 "_buckets": 10},
                  "_aggs": {"m": {"_median": {"_field": "stars"}}}},
            "c": {"_terms": {"_field": "category"}}}
    got = carried.search({"body": "fox"}, k=5, aggs=aggs)
    want = jdb.search({"body": "fox"}, k=5, aggs=aggs)
    assert str(got.aggregations) == str(want.aggregations)
    assert carried.get_document("12") == jdb.get_document("12")
    carried.delete_document("12", commit=True)   # the carry is a copy
    assert "12" in jdb._locate


# -- device plumbing and refusals ---------------------------------------------

def test_database_runs_on_the_card_unless_told():
    """device None means cuda: without a card that raises, never runs on
    the CPU; SegmentSearcher's default is cuda too."""
    if torch.cuda.is_available():
        assert PDB().device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PDB()
    assert PDB(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("call", ["path", "script", "scripted_metric",
                                  "cluster_hits", "diversify",
                                  "find_similar", "expand_terms",
                                  "add_spelling", "add_synonym"])
def test_left_out_parts_refuse_by_name(call, tmp_path):
    db = PDB(device="cpu")
    db.index_document({"body": "fox"}, doc_id="a", commit=True)
    run = {
        "path": lambda: PDB(path=str(tmp_path), device="cpu"),
        "script": lambda: db.index_document(
            {"body": "x", "_script": "doc"}, doc_id="b"),
        "scripted_metric": lambda: db.search(
            {"_match_all": {}}, aggs={"s": {"_scripted_metric": {
                "_map": "state"}}}),
        "cluster_hits": lambda: db.cluster_hits(["a"]),
        "diversify": lambda: db.diversify(db.search({"body": "fox"})),
        "find_similar": lambda: db.find_similar("a"),
        "expand_terms": lambda: db.expand_terms(["a"]),
        "add_spelling": lambda: db.add_spelling("fox"),
        "add_synonym": lambda: db.add_synonym("fox", "vixen"),
    }[call]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run()


def test_segment_searcher_refreshes_deletes():
    """refresh_deleted re-uploads the bitmap of an uploaded mirror."""
    db = PDB(device="cpu")
    for i in range(5):
        db.index_document({"body": "fox"}, doc_id=str(i))
    db.commit()
    searcher = db._searchers[0]
    assert isinstance(searcher, SegmentSearcher)
    ds = searcher.device_segment
    searcher.segment.deleted[2] = True
    searcher.refresh_deleted()
    assert bool(ds.arrays["deleted"][2])
