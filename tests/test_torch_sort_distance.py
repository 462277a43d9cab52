"""tests/test_sort_distance.py for the torch port: a dense plan (match_all)
under the distance sort keys - numeric nearest-to-value, geo haversine and
string metrics - through SegmentSearcher.execute, against the JAX package
on the CPU.

The segment is a JAX ``Database`` commit of the four documents of
tests/test_sort_distance.py, carried into the port as
tests/test_torch_aggs_compile.py carries its segment; the sort specs are
the JAX package's parse_sort of the same requests. Each plan binds to the
same ExecConfig in both packages, and the port's answers (docids, scores,
counts) equal JAX's execute and the orders the JAX test asserts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import xapiand_tpu.query.plan as jplan
from xapiand_tpu.database import Database
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.query.dsl import parse_sort
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.segment import (Segment, ValueColumn,
                                              terms_from)
from xapiand_tpu_torch.models.weights import BM25, CollectionStats
from xapiand_tpu_torch.ops.executor import SENTINEL, ExecConfig
from xapiand_tpu_torch.query import plan as pplan
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import SegmentSearcher

DOCS = [
    {"name": "alpha", "price": 10, "loc": {"_point": {
        "_latitude": 40.7, "_longitude": -74.0}}},      # NYC
    {"name": "beta", "price": 95, "loc": {"_point": {
        "_latitude": 51.5, "_longitude": -0.1}}},       # London
    {"name": "gamma", "price": 52, "loc": {"_point": {
        "_latitude": 35.7, "_longitude": 139.7}}},      # Tokyo
    {"name": "delta", "price": 48, "loc": {"_point": {
        "_latitude": 48.9, "_longitude": 2.35}}},       # Paris
]


def _fields(obj, cls, **over):
    return cls(**{**{f.name: getattr(obj, f.name)
                     for f in dataclasses.fields(cls)}, **over})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ddb():
    db = Database()
    for i, d in enumerate(DOCS):
        db.index_document(d, doc_id=f"d{i}")
    db.commit()
    jseg = db._searchers[0].segment
    pseg = _fields(jseg, Segment,
                   terms=terms_from(jseg.terms),
                   values={s: _fields(c, ValueColumn)
                           for s, c in jseg.values.items()})
    return db, jseg, pseg


def ids_sorted(ddb, sort_spec):
    """The match_all plan under the sort in both packages: equal configs
    and answers; -> the port's hits as external ids."""
    db, jseg, pseg = ddb
    sort = parse_sort(db.schema, sort_spec)
    st = dict(doc_count=jseg.doc_count, avg_doclen=jseg.avg_doclen,
              doclen_lower=1.0)
    jb = jplan.bind(jplan.compile_ir(JQ.match_all()), jseg, JBM25(),
                    JStats(**st), k=10, sort=sort)
    pb = pplan.bind(pplan.compile_ir(Q.match_all()), pseg, BM25(),
                    CollectionStats(**st), k=10, sort=sort)
    assert pb.cfg.dense and pb.cfg.sort
    assert _fields(jb.cfg, ExecConfig) == pb.cfg
    stats = {"N": float(jseg.doc_count), "avg_doclen": float(jseg.avg_doclen),
             "doclen_lower": 1.0, "doclen_upper": 4.0,
             "total_len": float(jseg.total_doclen)}
    want = JSearcher(jseg, JBM25()).execute(jb, stats)
    got = SegmentSearcher(pseg, device=torch.device("cpu")).execute(pb,
                                                                    stats)
    assert got["docids"].tolist() == np.asarray(want["docids"]).tolist()
    np.testing.assert_array_equal(got["scores"], np.asarray(want["scores"]))
    assert int(got["count"]) == int(want["count"]) == len(DOCS)
    return [pseg.doc_keys[d] for d in got["docids"].tolist()
            if d != SENTINEL]


def test_numeric_distance_sort(ddb):
    # nearest to 50: gamma(52), delta(48) tie-ish -> |2| both, then others
    ids = ids_sorted(ddb, [{"price": {"_order": "asc", "_value": 50}}])
    assert set(ids[:2]) == {"d2", "d3"}
    assert ids[2] == "d0" and ids[3] == "d1"
    # farthest first
    ids = ids_sorted(ddb, [{"price": {"_order": "desc", "_value": 50}}])
    assert ids[0] == "d1"


def test_geo_distance_sort(ddb):
    # nearest to London: London, Paris, NYC, Tokyo
    ids = ids_sorted(ddb, [{"loc": {"_order": "asc", "_value": {
        "_point": {"_latitude": 51.5, "_longitude": -0.1}}}}])
    assert ids == ["d1", "d3", "d0", "d2"]
    # farthest from London first
    ids = ids_sorted(ddb, [{"loc": {"_order": "desc", "_value": {
        "_point": {"_latitude": 51.5, "_longitude": -0.1}}}}])
    assert ids == ["d2", "d0", "d3", "d1"]


def test_string_metric_sort(ddb):
    # levenshtein distance to "alphaz": alpha closest
    ids = ids_sorted(ddb, [{"name": {"_order": "asc", "_value": "alphaz",
                                     "_metric": "levenshtein"}}])
    assert ids[0] == "d0"
    # jaro-winkler alias parses too
    ids = ids_sorted(ddb, [{"name": {"_order": "asc", "_value": "bet",
                                     "_metric": "jarowinkler"}}])
    assert ids[0] == "d1"


def test_distance_then_value_sort(ddb):
    """Two keys: nearest to 50, ties (gamma, delta) by price descending."""
    ids = ids_sorted(ddb, [{"price": {"_order": "asc", "_value": 50}},
                           {"price": {"_order": "desc"}}])
    assert ids == ["d2", "d3", "d0", "d1"]
