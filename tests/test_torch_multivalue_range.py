"""tests/test_multivalue_range.py for the torch port: per-value containment
over a multi-value column. A doc matches a range only when one of its
ACTUAL values lies inside it (src/multivalue/range.cc:352-366), not when
the range merely overlaps its [min, max]: a doc with values {1, 10} must
not match _from 4, _to 6.

The segment is a JAX ``Database`` commit of the eight documents of
tests/test_multivalue_range.py, carried into the port as
tests/test_torch_aggs_compile.py carries its segment; each request is the
JAX package's QueryDSL parse, rebuilt as the port's IR. Every plan runs
through the port's SegmentSearcher.execute and BatchSearcher.run and the
JAX SegmentSearcher.execute: the same ExecConfig, the same hits, and the
docs the reference's rule selects.
"""

import dataclasses

import numpy as np
import pytest
import torch

import xapiand_tpu.query.plan as jplan
from xapiand_tpu.database import Database
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.query.dsl import QueryDSL
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.segment import (Segment, ValueColumn,
                                              terms_from)
from xapiand_tpu_torch.models.weights import BM25, CollectionStats
from xapiand_tpu_torch.ops.executor import SENTINEL, ExecConfig
from xapiand_tpu_torch.query import plan as pplan
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher

DOCS = [
    {"body": "alpha one", "price": [1, 10]},       # 0: straddles, no value in
    {"body": "alpha two", "price": [1, 5]},        # 1: 5 in [4,6]
    {"body": "alpha three", "price": 5},           # 2: single value in
    {"body": "alpha four", "price": [4, 6]},       # 3: endpoints inclusive
    {"body": "alpha five", "price": 7},            # 4: single value out
    {"body": "alpha six", "price": [2, 3, 9, 11]}, # 5: none in [4,6]
    {"body": "alpha seven", "price": [0, 6, 20]},  # 6: 6 in [4,6]
    {"body": "alpha eight"},                       # 7: no value at all
]


def _expect(lo, hi):
    out = []
    for i, d in enumerate(DOCS):
        vals = d.get("price")
        if vals is None:
            continue
        if not isinstance(vals, list):
            vals = [vals]
        if any(lo <= v <= hi for v in vals):
            out.append(str(i))
    return sorted(out)


def _fields(obj, cls, **over):
    return cls(**{**{f.name: getattr(obj, f.name)
                     for f in dataclasses.fields(cls)}, **over})


def _port_ir(q):
    """The JAX IR node as the port's (the same dataclass fields)."""
    return Q(**{f.name: (tuple(_port_ir(c) for c in q.children)
                         if f.name == "children" else getattr(q, f.name))
                for f in dataclasses.fields(Q)})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


class World:
    def __init__(self):
        db = Database()
        for i, doc in enumerate(DOCS):
            db.index_document(dict(doc), doc_id=str(i))
        db.commit()
        self.jseg = jseg = db._searchers[0].segment
        self.pseg = _fields(jseg, Segment,
                            terms=terms_from(jseg.terms),
                            values={s: _fields(c, ValueColumn)
                                    for s, c in jseg.values.items()})
        self.dsl = QueryDSL(db.schema)
        st = dict(doc_count=jseg.doc_count, avg_doclen=jseg.avg_doclen,
                  doclen_lower=1.0)
        self.jst, self.pst = JStats(**st), CollectionStats(**st)
        self.stats = {"N": float(jseg.doc_count),
                      "avg_doclen": float(jseg.avg_doclen),
                      "doclen_lower": 1.0, "doclen_upper": 3.0,
                      "total_len": float(jseg.total_doclen)}
        self.js = JSearcher(jseg, JBM25())
        self.ps = SegmentSearcher(self.pseg, device=torch.device("cpu"))

    def hits(self, dsl):
        """The request through both packages; -> the port's hit ids."""
        jir = self.dsl.parse(dsl)
        ir = _port_ir(jir)
        jb = jplan.bind(jplan.compile_ir(jir), self.jseg, JBM25(), self.jst,
                        k=20)
        pb = pplan.bind(pplan.compile_ir(ir), self.pseg, BM25(), self.pst,
                        k=20)
        assert _fields(jb.cfg, ExecConfig) == pb.cfg
        want = self.js.execute(jb, self.stats)
        got = self.ps.execute(pb, self.stats)
        batch = BatchSearcher(self.ps, k=20, min_batch=8).run([ir])[0]
        real = sorted(d for d in np.asarray(want["docids"]).tolist()
                      if d != SENTINEL)
        for r in (got, batch):
            assert sorted(d for d in r["docids"].tolist()
                          if d != SENTINEL) == real
            assert int(r["count"]) == int(want["count"])
        return sorted(self.pseg.doc_keys[d] for d in got["docids"].tolist()
                      if d != SENTINEL)


@pytest.fixture(scope="module")
def world():
    return World()


def test_straddling_doc_does_not_match(world):
    got = world.hits({"price": {"_from": 4, "_to": 6}})
    assert got == _expect(4, 6)
    assert "0" not in got          # the confirmed round-2 false positive
    assert "5" not in got


@pytest.mark.parametrize("lo,hi", [(4, 6), (0, 0), (10, 10), (1, 1),
                                   (2, 9), (11, 50), (-5, 0)])
def test_per_value_containment_grid(world, lo, hi):
    assert world.hits({"price": {"_from": lo, "_to": hi}}) == _expect(lo, hi)


def test_open_ended_ranges(world):
    assert world.hits({"price": {"_from": 10}}) == \
        _expect(10, float("inf"))
    assert world.hits({"price": {"_to": 1}}) == _expect(float("-inf"), 1)


def test_range_and_term_conjunction(world):
    assert world.hits({"_and": [{"body": "alpha"},
                                {"price": {"_from": 4, "_to": 6}}]}) == \
        _expect(4, 6)
