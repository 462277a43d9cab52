"""The port's aggregations.compile_for_segment against the JAX package's
for the kinds whose host modules the port copies (utils/dtutils.py,
utils/iputils.py, geo/, native/, and since PR 8 query/dsl.py and the
analysis chain): _date_range, _ip_range, _geo_ip, _geo_distance with an
origin, _geo_trixels and _filter compile to the same (names, specs,
arrays, metas), and BatchSearcher refuses them by name: their device
aggregations (K17c) run on the single-query path only, as the JAX
BatchSearcher drops their plan arrays.

The segment is a JAX ``Database`` commit with a date, an IP and a numeric
field, carried into the port's Segment as tests/test_torch_predicate.py
carries it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xapiand_tpu import aggregations as jagg
from xapiand_tpu.database import Database
from xapiand_tpu_torch import aggregations as pagg
from xapiand_tpu_torch.models.segment import (Segment, ValueColumn,
                                              terms_from)
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher


def _fields(obj, cls, **over):
    return cls(**{**{f.name: getattr(obj, f.name)
                     for f in dataclasses.fields(cls)}, **over})


@pytest.fixture(scope="module")
def world():
    db = Database()
    for i in range(40):
        doc = {"body": f"w{i % 7} w{i % 3}", "n": float(i),
               "opened": f"20{20 + i % 5}-0{1 + i % 9}-1{i % 10}T00:00:00Z"}
        if i % 6:
            doc["addr"] = {"_type": "ip",
                           "_value": f"{(10, 192, 8)[i % 3]}.0.{i}.7"}
        db.index_document(doc, doc_id=str(i))
    db.commit()
    jseg = db._searchers[0].segment
    pseg = _fields(jseg, Segment,
                   terms=terms_from(jseg.terms),
                   values={s: _fields(c, ValueColumn)
                           for s, c in jseg.values.items()})
    return db.schema, jseg, pseg


COMPILED = {
    "date_range": {"eras": {"_date_range": {"_field": "opened", "_ranges": [
        {"_key": "old", "_to": "2022-01-01T00:00:00Z"},
        {"_from": "2022-01-01T00:00:00Z", "_to": "2023-06-01T00:00:00Z"},
        {"_key": "new", "_from": "2023-06-01T00:00:00Z"}]},
        "_aggs": {"s": {"_sum": {"_field": "n"}}}}},
    "ip_range": {"nets": {"_ip_range": {"_field": "addr", "_ranges": [
        {"_key": "ten", "_cidr": "10.0.0.0/8"},
        {"_from": "192.0.0.0", "_to": "192.1.0.0"},
        {"_key": "all", "_from": "0.0.0.0"}]}}},
    "geo_ip": {"locs": {"_geo_ip": {"_field": "addr", "_networks": [
        {"_key": "dc", "_cidrs": ["10.0.0.0/8", "8.0.0.0/24"]},
        {"_key": "office", "_cidr": "192.0.0.0/16"}]},
        "_aggs": {"m": {"_max": {"_field": "n"}}}}},
    "geo_distance": {"d": {"_geo_distance": {
        "_field": "n", "_origin": "POINT(-74.0 40.7)",
        "_ranges": [{"_to": 1000.0}]}}},
    "geo_trixels": {"t": {"_geo_trixels": {"_field": "n", "_level": 5}}},
}


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, where)
    else:
        assert got == want, where


@pytest.mark.parametrize("kind", sorted(COMPILED))
def test_repaired_kinds_compile_as_jax(world, kind):
    """(names, specs, arrays, metas) equal to the JAX package's, and the
    port's BatchSearcher refuses the compiled kind by name (K17c)."""
    schema, jseg, pseg = world
    want = jagg.compile_for_segment(schema, jseg, COMPILED[kind])
    got = pagg.compile_for_segment(schema, pseg, COMPILED[kind])
    _assert_same(got, want)
    assert got[1][0][0] == {"date_range": "range", "ip_range": "key_range",
                            "geo_ip": "geo_ip",
                            "geo_distance": "geodist_range",
                            "geo_trixels": "geo_trixels"}[kind]
    ps = SegmentSearcher(pseg, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP.*K17c"):
        BatchSearcher(ps, aggs=got[1:3])


STILL_BROKEN = {
    "filter": {"f": {"_filter": {"_term": {"body": "w1"}}}},
}


@pytest.mark.parametrize("kind", sorted(STILL_BROKEN))
def test_kinds_without_their_host_modules(world, kind):
    """The kinds whose host modules the port lacked until PR 8 (_filter:
    query/dsl.py and the analysis chain) compile as the JAX package's; the
    port's BatchSearcher refuses them by name (K17c), as the others."""
    schema, jseg, pseg = world
    dsl = STILL_BROKEN[kind]
    want = jagg.compile_for_segment(schema, jseg, dsl)
    got = pagg.compile_for_segment(schema, pseg, dsl)
    _assert_same(got, want)
    ps = SegmentSearcher(pseg, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP.*K17c"):
        BatchSearcher(ps, aggs=got[1:3])
