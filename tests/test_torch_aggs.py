"""Slice 3, the aggregations (K17a) and the fullwidth path (K9), against
the JAX package on the CPU: the port's plain versions and the JAX functions
on the same inputs.

  compute_aggs (K17a)    vs ops/aggs.py compute_aggs under jit(vmap), for
                         every admitted kind: count, the eight metrics,
                         terms with and without metric subs, missing with
                         and without them; slots with absent values, a
                         slot the segment lacks, a slot without categories
  fullwidth_topk (K9)    vs _fullwidth_topk (through _rank_and_topk's fast
                         branch) for each key kind, ascending and
                         descending: certified flags equal for every
                         query, certified docids and scores equal; a
                         score key is refused
  BatchSearcher.plan     the same ExecConfigs (fullwidth, carry,
                         compact_cap, ...) under XT_FULLWIDTH=1 and 0
  BatchSearcher.run      vs the JAX BatchSearcher.run with config 3's
                         aggregations and sort, and with a wider set;
                         merge_and_shape of both; ``reran`` lists the
                         queries whose fullwidth launch did not certify
  compaction for aggs    a relevance plan with a cap and aggregations packs
                         its rows (the JAX condition, execute 893-895)
  refusals               K17b / K17c kinds raise NotImplementedError in the
                         port; the JAX BatchSearcher fails on _histogram
                         with KeyError (it does not stack agg_params)

The segment is tests/test_torch_predicate.py's World (a JAX ``Database``
commit: body, cat, price, size absent on every 11th doc, deletes).

Tolerances: counts, n, min and max are equal; s and s2 within rtol 1e-5
(float32 sums in another order), and so are the shaped floats, but for
the variance (s2 / n - mean^2: rtol 1e-5 of the mean square) and what
derives from it (the square root of that); docids and counts as in
test_torch_predicate (value-sorted results docid for docid, relevance as
tie groups, scores within rtol 1e-5).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_predicate as tp
import xapiand_tpu.ops.executor as jex
from xapiand_tpu import aggregations as jagg
from xapiand_tpu.ops import aggs as jaggs
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu_torch import aggregations as pagg
from xapiand_tpu_torch.models.segment import device_segment_from_numpy
from xapiand_tpu_torch.models.weights import BM25
from xapiand_tpu_torch.ops import aggs as paggs
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import (SENTINEL, ExecConfig,
                                            execute_batch)
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher
from xapiand_tpu_torch.utils import synth_faceted as sf

RTOL = 1e-5
CPU = torch.device("cpu")
MISSING_SLOT = tp.MISSING_SLOT


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    # the JAX device path, not its native host executors
    monkeypatch.setenv("XT_HOST_PATH", "0")


class Schema:
    """The World's fields as compile_for_segment reads a schema."""

    def __init__(self, slots):
        self.slots = slots

    def get_field(self, name):
        return SimpleNamespace(slot=self.slots[name])


@pytest.fixture(scope="module")
def world():
    if not tp._WORLD:
        tp._WORLD.append(tp.World())
    w = tp._WORLD[0]
    w.cat = next(s for s, c in w.jseg.values.items()
                 if c.cat_names and c.cat_names[0] == "cat0")
    w.schema = Schema({"cat": w.cat, "price": w.price, "size": w.size,
                       "nosuch": MISSING_SLOT})
    w.geo = sf.SORT_TEST_SLOT     # a slot for a synthetic lat / lon column
    return w


METRICS = ("sum", "avg", "min", "max", "variance", "std_deviation", "stats",
           "extended_stats")


def _spec_sets(w):
    subs = (("count", -1), ("avg", w.price), ("max", w.size),
            ("stats", MISSING_SLOT))
    return {
        "metrics": (("count",),) + tuple((m, w.price) for m in METRICS),
        "metric_slots": (("stats", w.size), ("extended_stats", MISSING_SLOT),
                         ("min", w.cat), ("count",)),
        "terms": (("terms", w.cat, 16, ()), ("terms", w.price, 16, ()),
                  ("terms", MISSING_SLOT, 16, ())),
        "terms_subs": (("terms", w.cat, 16, subs),
                       ("terms", w.cat, 64, (("sum", w.size),))),
        "missing": (("missing", w.size, ()), ("missing", MISSING_SLOT, ()),
                    ("missing", w.price, ())),
        "missing_subs": (("missing", w.size, subs),
                         ("missing", MISSING_SLOT, (("avg", w.price),))),
        # K17b, mirroring tests/test_aggs_ext.py:172-187: the multi-value
        # size column counts each doc's one key (hi, lo), its smallest
        # value; the price has no fval2, so its longitude reads 0
        "cardinality": (("cardinality", w.size), ("cardinality", w.price),
                        ("cardinality", w.cat),
                        ("cardinality", MISSING_SLOT)),
        "geo_stats": (("geo_stats", w.geo), ("geo_stats", w.price),
                      ("geo_stats", MISSING_SLOT), ("count",)),
    }


def _rows(seed=8, B=5, R=700):
    """Random docids (SENTINEL padding at the end of each query) and an
    eligible mask from a numpy seed."""
    rng = np.random.Generator(np.random.PCG64(seed))
    ids = rng.integers(0, tp.N_DOCS + 1, (B, R)).astype(np.int32)
    ids[:, -40:] = SENTINEL
    elig = rng.random((B, R)) < np.linspace(0.05, 0.9, B)[:, None]
    elig[:, -40:] = False
    elig[0] = False                      # a query with no rows
    return ids, elig


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_aggs(got, want, key=""):
    """got / want: the aggs structure (numpy leaves)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), key
        for k in want:
            _assert_aggs(got[k], want[k], k)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _assert_aggs(g, w, key)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (key, g, w)
        if key in ("s", "s2", "slat", "slon"):
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("name", ["metrics", "metric_slots", "terms",
                                  "terms_subs", "missing", "missing_subs",
                                  "cardinality", "geo_stats"])
def test_compute_aggs_vs_jax(world, name):
    """K17a and K17b: every admitted kind, plain version vs compute_aggs,
    on the same rows and masks; the structure is JAX's (cardinality: n,
    maxn and all 1024 registers equal; geo_stats: n, minima and maxima
    equal, the two sums within rtol 1e-5)."""
    specs = _spec_sets(world)[name]
    ids, elig = _rows()
    jarr, parr = world.jarr, world.parr["values"]
    if name == "geo_stats":
        # a synthetic lat / lon column: the World's segment has no geo
        # value column
        col, _tg, _tab = sf.sort_test_inputs(tp.N_DOCS, 1)
        col = {ch: col[ch] for ch in ("hi", "lo", "present", "fval",
                                      "fval2")}
        jarr = {**jarr, "values": {**jarr["values"], world.geo: {
            ch: jnp.asarray(v) for ch, v in col.items()}}}
        parr = {**parr, world.geo: device_segment_from_numpy(col, CPU)}
    want = _np(jax.jit(jax.vmap(lambda d, m: jaggs.compute_aggs(
        jarr, specs, jnp.minimum(d, tp.N_DOCS), m,
        jnp.zeros(d.shape, jnp.float32))))(jnp.asarray(ids),
                                           jnp.asarray(elig)))
    paggs.check_aggs(specs)
    got = paggs.compute_aggs({"values": parr}, specs,
                             torch.from_numpy(ids), torch.from_numpy(elig))
    got = jax.tree_util.tree_map(lambda t: t.numpy(), got)
    _assert_aggs(got, want)
    assert isinstance(got, tuple) and len(got) == len(specs)
    flat = jax.tree_util.tree_leaves(want)
    assert any(np.asarray(x).any() for x in flat)


def _fw_world(world, spec):
    """Rows for one sort key: q0/q4/q5 many eligible rows, q1 five, q2 only
    docs without a value (the plateau of the largest image, or -inf for a
    descending float key), q3 100 docs
    whose synthetic values were made equal (one image, distinct exact
    keys through lo and the docid)."""
    rng = np.random.Generator(np.random.PCG64(9))
    B, C = 6, 300
    col, tg, tab = sf.sort_test_inputs(tp.N_DOCS, B)
    present = world.jseg.values[spec[1]].present if spec[1] == world.price \
        else col["present"]
    tie = rng.permutation(np.flatnonzero(col["present"][:tp.N_DOCS]))[:100]
    col = {k: v.copy() for k, v in col.items()}
    col["hi"][tie], col["fval"][tie], col["fval2"][tie] = 5, 12.5, 33.0
    col["cats"][tie] = 7
    docids = np.stack([rng.permutation(tp.N_DOCS)[:C]
                       for _ in range(B)]).astype(np.int32)
    elig = rng.random((B, C)) < np.array([0.7, 0, 0, 0, 0.7, 0.95])[:, None]
    elig[1, :5] = True
    absent = np.flatnonzero(~present[:tp.N_DOCS])[:30]
    docids[2, :len(absent)] = absent
    elig[2, :len(absent)] = True
    docids[3] = np.concatenate([tie, np.setdiff1d(
        np.arange(tp.N_DOCS), tie)[:C - len(tie)]]).astype(np.int32)
    elig[3, :len(tie)] = True
    docids[:, -10:] = SENTINEL
    elig[:, -10:] = False
    scores = (rng.integers(0, 40, (B, C)) / 8.0).astype(np.float32)
    return docids, scores, elig, col, tg[:, :1].copy(), tab


FW_SPECS = [("value", sf.SORT_TEST_SLOT, False),
            ("value", sf.SORT_TEST_SLOT, True),
            ("dist", sf.SORT_TEST_SLOT, False),
            ("dist", sf.SORT_TEST_SLOT, True),
            ("geodist", sf.SORT_TEST_SLOT, False),
            ("geodist", sf.SORT_TEST_SLOT, True),
            ("strmetric", sf.SORT_TEST_SLOT, False, 64),
            ("strmetric", sf.SORT_TEST_SLOT, True, 64),
            ("value", "price", True)]


@pytest.mark.parametrize("spec", FW_SPECS,
                         ids=[f"{s[0]}{'D' if s[2] else 'A'}"
                              + ("-price" if s[1] == "price" else "")
                              for s in FW_SPECS])
def test_fullwidth_topk_vs_jax(world, spec):
    """K9: the certificate equals JAX's for every query (a plateau of
    absent values, equal images of one hi word and fewer than k eligible
    rows fail it), and certified queries return JAX's docids and scores."""
    if spec[1] == "price":
        spec = (spec[0], world.price) + spec[2:]
    docids, scores, elig, col, tg, tab = _fw_world(world, spec)
    jseg = dict(world.jarr)
    jseg["values"] = {**world.jarr["values"],
                      sf.SORT_TEST_SLOT: {k: jnp.asarray(v)
                                          for k, v in col.items()}}
    cfg = jex.ExecConfig(T=1, L=128, k=10, tree=("G", 0), sort=(spec,))
    strtabs = {0: tab} if spec[0] == "strmetric" else {}
    plan = {"sort_targets": jnp.asarray(tg),
            "sort_strtabs": {i: jnp.asarray(t) for i, t in strtabs.items()}}

    def one(p, d, s, e):
        out = {}
        dd, vv, _ = jex._rank_and_topk(cfg, jseg, d, s, e, plan=p,
                                       fast=True, out=out)
        return dd, vv, out["certified"]

    jd, js, jc = (np.asarray(a) for a in jax.vmap(one)(
        plan, jnp.asarray(docids), jnp.asarray(scores), jnp.asarray(elig)))
    values = dict(world.parr["values"])
    values[sf.SORT_TEST_SLOT] = device_segment_from_numpy(col, CPU)
    gd, gs, gc = (t.numpy() for t in kernels.fullwidth_topk(
        spec, torch.from_numpy(docids), torch.from_numpy(scores),
        torch.from_numpy(elig), 10, values, torch.from_numpy(tg),
        {i: torch.from_numpy(t) for i, t in strtabs.items()}))
    np.testing.assert_array_equal(gc, jc)
    assert gc.any() and not gc.all()
    assert gc[0] and not gc[1]
    # absent values sit on the plateau, but a descending float key puts
    # them first (-inf), as in JAX (strmetric reads category codes)
    if spec[0] != "strmetric":
        assert gc[2] == (spec[0] != "value" and spec[2])
    if spec[1] == sf.SORT_TEST_SLOT:
        assert not gc[3]
    np.testing.assert_array_equal(gd[gc], jd[jc])
    np.testing.assert_array_equal(gs[gc], js[jc])
    # an uncertified query's first k is the exact multi-key top-k
    sd, ss = kernels.sort_topk((spec,), torch.from_numpy(docids),
                               torch.from_numpy(scores),
                               torch.from_numpy(elig), 10, values,
                               torch.from_numpy(tg),
                               {i: torch.from_numpy(t)
                                for i, t in strtabs.items()})
    np.testing.assert_array_equal(gd, sd.numpy())
    np.testing.assert_array_equal(gs, ss.numpy())


def test_fullwidth_topk_refuses_score_keys(world):
    """K9 takes the key kinds query/plan.py fullwidth_ok admits, and no
    relevance-score key."""
    ids = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="sort kind 'score'"):
        kernels.fullwidth_topk(("score", -1, True), ids,
                               torch.zeros((2, 128)),
                               torch.ones((2, 128), dtype=torch.bool), 10,
                               world.parr["values"])


@pytest.mark.parametrize("fw", ["1", "0"])
def test_run_reports_reran_queries(world, monkeypatch, fw):
    """BatchSearcher.run lists the queries it re-ran on the exact path:
    those whose first fullwidth launch did not certify (none with
    XT_FULLWIDTH=0), in the order they first appear in the plan."""
    monkeypatch.setenv("XT_FULLWIDTH", fw)
    _jc, pc = _aggs_of(world, "cfg3")
    bs = BatchSearcher(world.ps, k=10, sort=world.sort("A"),
                       aggs=(pc[1], pc[2]))
    irs = [q for f in "AB" for q in world.queries(f, Q)]
    want, seen = [], set()
    for cfg, fn, batch, chunk in bs.plan(irs):
        out = fn(world.parr, batch, world.pstats)
        for row, qi in enumerate(chunk):
            if qi not in seen:
                seen.add(qi)
                if cfg.fullwidth and not bool(out["certified"][row]):
                    want.append(qi)
    bs.run(irs)
    assert bs.reran == want
    assert bool(want) == (fw == "1")


def _aggs_of(world, which):
    dsl = sf.CFG3_AGGS if which == "cfg3" else {
        "cats": {"_terms": {"_field": "cat", "_size": 5},
                 "_aggs": {"avg_price": {"_avg": {"_field": "price"}},
                           "n": {"_count": {}}}},
        "px": {"_extended_stats": {"_field": "price"}},
        "nosize": {"_missing": {"_field": "size"},
                   "_aggs": {"top": {"_max": {"_field": "price"}}}},
        "n": {"_count": {}},
        "sz": {"_sum": {"_field": "size"}},
    }
    jc = jagg.compile_for_segment(world.schema, world.jseg, dsl)
    pc = pagg.compile_for_segment(world.schema, world.pseg, dsl)
    assert jc[:2] == pc[:2] and jc[3] == pc[3]
    return jc, pc


CASES = {"AB": ("cfg3", True), "CDE": ("wide", False)}


@pytest.mark.parametrize("fw", ["1", "0"])
def test_plan_configs_vs_jax(world, monkeypatch, fw):
    """BatchSearcher.plan with sort and aggs: the port's launch groups have
    the JAX package's ExecConfigs, fullwidth / carry / compact_cap
    included, under either XT_FULLWIDTH."""
    monkeypatch.setenv("XT_FULLWIDTH", fw)
    seen = []
    for fams, (which, sorted_) in CASES.items():
        jc, pc = _aggs_of(world, which)
        sort = world.sort("A") if sorted_ else None
        pp = BatchSearcher(world.ps, k=10, sort=sort,
                           aggs=(pc[1], pc[2])).plan(
            [q for f in fams for q in world.queries(f, Q)])
        jp = JBatch(world.js, k=10, sort=sort, aggs=(jc[1], jc[2])).plan(
            [q for f in fams for q in world.queries(f, JQ)])
        assert [dataclasses.asdict(c) for c, *_ in pp] == \
            [dataclasses.asdict(c) for c, *_ in jp]
        seen += [(c.fullwidth, bool(c.carry), 0 < c.compact_cap)
                 for c, *_ in pp]
    if fw == "1":
        assert (True, True, True) in seen and (False, False, True) in seen
    else:
        assert not any(f or c for f, c, _ in seen)


def _shape(names, metas, aggs):
    cats = {i: m["cat_names"] for i, m in enumerate(metas)
            if m["kind"] == "terms"}
    return pagg.merge_and_shape(names, metas, [aggs], [cats])


def _assert_shaped(got, want, atol=1e-9):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        if want.get("_count") and "_sum_of_squares" in want:
            # the variance is s2 / n - mean^2, a difference of two nearly
            # equal numbers: it agrees to rtol 1e-5 of the mean square, the
            # standard deviation and its bounds to the square root of that
            tol = RTOL * want["_sum_of_squares"] / want["_count"]
            assert got["_variance"] == pytest.approx(want["_variance"],
                                                     abs=tol)
            got, want = dict(got), dict(want)
            del got["_variance"], want["_variance"]
            atol = 3 * tol ** 0.5
        for k in want:
            _assert_shaped(got[k], want[k], atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_shaped(g, w, atol)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=atol)
    else:
        assert got == want


@pytest.mark.parametrize("fams", sorted(CASES))
def test_batch_run_with_aggs_vs_jax(world, fams):
    """BatchSearcher.run with aggregations (config 3's on the sorted
    families, through the fullwidth path; a wider set with subs, missing
    and count on the relevance families): the port vs the JAX package,
    results and aggregation parts per query, then merge_and_shape."""
    which, sorted_ = CASES[fams]
    jc, pc = _aggs_of(world, which)
    sort = world.sort("A") if sorted_ else None
    got = BatchSearcher(world.ps, k=10, sort=sort, aggs=(pc[1], pc[2])).run(
        [q for f in fams for q in world.queries(f, Q)])
    want = JBatch(world.js, k=10, sort=sort, aggs=(jc[1], jc[2])).run(
        [q for f in fams for q in world.queries(f, JQ)])
    for g, w in zip(got, want):
        assert g["count"] == w["count"]
        tp._assert_ranks((g["docids"], g["scores"]),
                         (w["docids"], w["scores"]), sorted_)
        _assert_aggs(g["aggs"], w["aggs"])
        _assert_shaped(_shape(pc[0], pc[3], g["aggs"]),
                       jagg.merge_and_shape(jc[0], jc[3], [w["aggs"]], [
                           {i: m["cat_names"] for i, m in enumerate(jc[3])
                            if m["kind"] == "terms"}]))
    assert sum(g["count"] for g in got) > 0


def test_relevance_plan_with_a_cap_compacts_for_aggs(world, monkeypatch):
    """The compaction condition is JAX's (execute 893-895): a relevance
    plan with a compaction cap and aggregations packs its eligible rows
    before the aggregations, and returns JAX's counts, ranks and aggs."""
    monkeypatch.setenv("XT_FULLWIDTH", "0")
    jc, _pc = _aggs_of(world, "wide")
    packed = []
    compact = kernels.compact_rows

    def spy(mask, ids, sums, orbits, cap):
        packed.append(cap)
        return compact(mask, ids, sums, orbits, cap)

    monkeypatch.setattr(kernels, "compact_rows", spy)
    n = 0
    for jcfg, _fn, batch, _chunk in JBatch(
            world.js, k=10, aggs=(jc[1], jc[2])).plan(
            world.queries("A", JQ)):
        cfg = tp._fields(jcfg, ExecConfig)
        R = sum(cfg.classes)
        assert not cfg.sort and cfg.with_aggs and not cfg.fullwidth
        if not 0 < cfg.compact_cap < R:
            continue
        packed.clear()
        got = execute_batch(world.parr, world.port_batch(batch), cfg,
                            world.pstats, BM25())
        assert packed == [cfg.compact_cap]
        want = world.js.batched(jcfg)(world.jarr, batch, world.jstats)
        np.testing.assert_array_equal(got["count"].numpy(),
                                      np.asarray(want["count"]))
        _assert_aggs(jax.tree_util.tree_map(lambda t: t.numpy(),
                                            got["aggs"]), _np(want["aggs"]))
        for b in range(len(got["count"])):
            tp._assert_ranks((got["docids"][b], got["scores"][b]),
                             (want["docids"][b], want["scores"][b]), False)
        n += 1
    assert n


REFUSED = {
    "histogram": ({"h": {"_histogram": {"_field": "price", "_interval": 10}}},
                  "K17c"),
    "range": ({"r": {"_range": {"_field": "price",
                                "_ranges": [{"_to": 50}]}}}, "K17c"),
    "median": ({"m": {"_median": {"_field": "price"}}}, "K17c"),
    "percentiles": ({"p": {"_percentiles": {"_field": "price"}}}, "K17c"),
    "median_sub": ({"t": {"_terms": {"_field": "cat"},
                          "_aggs": {"m": {"_median": {"_field": "price"}}}}},
                   "K17c"),
    "nested": ({"t": {"_terms": {"_field": "cat"},
                      "_aggs": {"h": {"_histogram": {"_field": "price",
                                                     "_interval": 50,
                                                     "_buckets": 4}}}}},
               "K17c"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_aggs_raise(world, case):
    """K17c kinds raise NotImplementedError naming their item, when the
    searcher is made."""
    dsl, item = REFUSED[case]
    _n, specs, arrays, _m = pagg.compile_for_segment(world.schema,
                                                     world.pseg, dsl)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        BatchSearcher(world.ps, aggs=(specs, arrays))


def test_geo_stats_raises():
    """geo_stats is ported (K17b): what still raises is a spec of another
    arity than (kind, slot), which no compile produces."""
    paggs.check_aggs((("geo_stats", 1), ("cardinality", 1)))
    for bad in (("geo_stats", 1, 2), ("cardinality",)):
        with pytest.raises(NotImplementedError, match="K17c"):
            paggs.check_aggs((bad,))


def test_hash32_replica_vs_jax():
    """kernels.hash32 (the plain version's, and the model of the numpy
    replicas in utils/synth_browse.py and utils/synth_geo.py) against
    _hash32 on random and edge key pairs."""
    from xapiand_tpu_torch.utils.synth_browse import hash32_np

    rng = np.random.Generator(np.random.PCG64(3))
    hi = rng.integers(-2**31, 2**31, 4000).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, 4000).astype(np.int32)
    hi[:4] = (0, -1, 2**31 - 1, -2**31)
    lo[:4] = (0, -1, 2**31 - 1, -2**31)
    want = np.asarray(jaggs._hash32(jnp.asarray(hi), jnp.asarray(lo)))
    assert want.dtype == np.uint32
    got = kernels.hash32(torch.from_numpy(hi), torch.from_numpy(lo)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(hash32_np(hi, lo), want)


def test_jax_batch_searcher_drops_agg_arrays(world):
    """The reference's fault the port does not copy: the JAX BatchSearcher
    stacks no agg_params into its batches, so a batched _histogram fails
    while it is traced (the port refuses it by name instead, above)."""
    _n, specs, arrays, _m = jagg.compile_for_segment(
        world.schema, world.jseg, REFUSED["histogram"][0])
    assert "agg_params" in arrays
    with pytest.raises(KeyError, match="agg_params"):
        JBatch(world.js, k=10, aggs=(specs, arrays)).run(
            world.queries("A", JQ)[:2])
