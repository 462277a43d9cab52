"""K17c through the port's Database against the JAX Database, on the CPU.

What runs: both packages' ``Database`` with the same documents, ids and
seed, in three generations (two commits, then deletes and replacements),
the port with ``device="cpu"`` (every kernel wrapper runs its plain
version). XT_HOST_PATH=0: the JAX side stays on its device path (the
searches here carry aggregations, which neither side routes to the host).

What must match, by the shaped aggregation response
(``aggregations.merge_and_shape``): every aggregation kind of
``xapiand_tpu/ops/aggs.py``, with metric and median sub-aggregations -
counts exact, sums and the stats made from them within rtol 1e-5 (the
port's plain versions add in float64 and round once, JAX in float32),
medians, modes and percentiles equal (the same bin grid), and the hits.
The worlds are the small fixtures of tests/test_aggs_nested.py and
tests/test_aggs_ext.py (their aggregations mirrored) and the bank / netlog
corpus of utils/synth_docs.py (every kind over a match-all, the dense
path, and over a text OR).

Array level: each K17c kind of the port's ``ops/aggs.py compute_aggs``
(its plain versions) against JAX ``compute_aggs`` under ``jit(vmap)`` on
the same segment arrays (the JAX segments carried into the port by
``database.from_jax_state``), rows and masks.

A departure is named: a median / mode sub-aggregation under range,
geodist_range, key_range or geo_trixels fails in JAX (its compute_aggs
passes no plan there), and the port refuses it by name.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xapiand_tpu.database import Database as JDB
from xapiand_tpu.ops import aggs as jaggs
from xapiand_tpu_torch.database import Database as PDB
from xapiand_tpu_torch.database import from_jax_state
from xapiand_tpu_torch.ops import aggs as paggs
from xapiand_tpu_torch.utils import synth_docs as sd

RTOL = 1e-5
ORDER_KEYS = ("_median", "_mode", "_percentiles")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


def _same(got, want, where="", exact=False):
    """Shaped responses: keys, lists, ints equal; floats within RTOL, the
    order statistics (ORDER_KEYS) equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}", exact or k in ORDER_KEYS)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for j, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{j}]", exact)
    elif isinstance(want, float) and not exact and want == want:
        assert got == pytest.approx(want, rel=RTOL, abs=1e-9), where
    elif isinstance(want, float) and want != want:
        assert got != got, where
    else:
        assert got == want, where


def _both(docs, commit_at=(), deletes=(), replace=()):
    """(JAX Database, port Database) over the same docs and ids."""
    out = []
    for cls, kw in ((JDB, {}), (PDB, {"device": "cpu"})):
        db = cls(**kw)
        for i, d in enumerate(docs):
            db.index_document(dict(d), doc_id=f"d{i}")
            if i in commit_at:
                db.commit()
        db.commit()
        for i in deletes:
            db.delete_document(f"d{i}")
        for i in replace:
            db.index_document(dict(docs[i]), doc_id=f"d{i}")
        db.commit()
        out.append(db)
    return out


def _check(dbs, aggs, query=None, k=3):
    jdb, pdb = dbs
    q = query or {"_match_all": {}}
    want = jdb.search(q, k=k, aggs=aggs)
    got = pdb.search(q, k=k, aggs=aggs)
    assert got.total == want.total
    assert [h.id for h in got.hits] == [h.id for h in want.hits]
    _same(got.aggregations, want.aggregations)
    return got.aggregations


# -- tests/test_aggs_nested.py's world ----------------------------------------

NESTED_DOCS = [
    {"fruit": "apple", "balance": 100.0, "state": "WA",
     "opened": "2021-01-15T10:00:00"},
    {"fruit": "apple", "balance": 300.0, "state": "OR",
     "opened": "2021-02-10T09:00:00"},
    {"fruit": "banana", "balance": 50.0, "state": "WA",
     "opened": "2021-02-20T12:00:00"},
    {"fruit": "cherry", "balance": 700.0, "state": "CA",
     "opened": "2022-03-01T00:00:00"},
    {"fruit": "apple", "balance": 200.0, "state": "CA",
     "opened": "2022-07-04T18:30:00"},
    {"balance": 999.0, "state": "NV",
     "opened": "2022-08-01T00:00:00"},           # no fruit (missing)
]

NESTED = {
    "terms_subs": {"fruits": {"_terms": {"_field": "fruit"}, "_aggs": {
        "avg_balance": {"_avg": {"_field": "balance"}},
        "max_balance": {"_max": {"_field": "balance"}}}}},
    "filter_subs": {"apple_lovers": {
        "_filter": {"_term": {"fruit": "apple"}},
        "_aggs": {"avg_balance": {"_avg": {"_field": "balance"}}}}},
    "missing": {"no_fruit": {"_missing": {"_field": "fruit"},
                             "_aggs": {"s": {"_sum": {"_field": "balance"}}}}},
    "histogram_subs": {"by_balance": {
        "_histogram": {"_field": "balance", "_interval": 250},
        "_aggs": {"n": {"_count": {}},
                  "st": {"_stats": {"_field": "balance"}}}}},
    "date_histogram_month": {"months": {"_date_histogram": {
        "_field": "opened", "_interval": "month"}}},
    "date_histogram_year_subs": {"years": {
        "_date_histogram": {"_field": "opened", "_interval": "year"},
        "_aggs": {"total": {"_sum": {"_field": "balance"}}}}},
    "date_range": {"eras": {"_date_range": {"_field": "opened", "_ranges": [
        {"_key": "before_2022", "_to": "2022-01-01T00:00:00Z"},
        {"_key": "since_2022", "_from": "2022-01-01T00:00:00Z"}]}}},
    "range_subs": {"tiers": {"_range": {
        "_field": "balance", "_ranges": [{"_key": "low", "_to": 250},
                                         {"_key": "high", "_from": 250}]},
        "_aggs": {"st": {"_stats": {"_field": "balance"}}}}},
    "terms_terms": {"s": {"_terms": {"_field": "state"}, "_aggs": {
        "f": {"_terms": {"_field": "fruit"}}}}},
    "terms_histogram": {"s": {"_terms": {"_field": "state"}, "_aggs": {
        "h": {"_histogram": {"_field": "balance", "_interval": 200,
                             "_buckets": 8},
              "_aggs": {"a": {"_avg": {"_field": "balance"}}}}}}},
    "three_levels": {"s": {"_terms": {"_field": "state"}, "_aggs": {
        "f": {"_terms": {"_field": "fruit"}, "_aggs": {
            "r": {"_range": {"_field": "balance", "_ranges": [
                {"_to": 150}, {"_from": 150}]},
                "_aggs": {"m": {"_max": {"_field": "balance"}}}}}}}}},
    "median_mode_under_buckets": {"f": {"_terms": {"_field": "fruit"},
                                        "_aggs": {
        "med": {"_median": {"_field": "balance"}},
        "mo": {"_mode": {"_field": "balance"}}}}},
    "top_level_order_stats": {
        "med": {"_median": {"_field": "balance"}},
        "mo": {"_mode": {"_field": "balance"}},
        "p": {"_percentiles": {"_field": "balance",
                               "_percentiles": [0, 25, 50, 75, 100]}}},
}


@pytest.fixture(scope="module")
def nested_dbs():
    return _both(NESTED_DOCS)


@pytest.mark.parametrize("case", sorted(NESTED))
def test_nested_world_matches_jax(nested_dbs, case):
    _check(nested_dbs, NESTED[case])


def test_filter_bucket_respects_query_context(nested_dbs):
    out = _check(nested_dbs, NESTED["filter_subs"],
                 query={"state": "WA"})
    assert out["apple_lovers"]["_doc_count"] == 1


# -- tests/test_aggs_ext.py's worlds ------------------------------------------

IP_DOCS = [
    {"addr": {"_type": "ip", "_value": "10.0.0.5"}, "bytes": 100.0},
    {"addr": {"_type": "ip", "_value": "10.0.1.7"}, "bytes": 200.0},
    {"addr": {"_type": "ip", "_value": "192.168.1.1"}, "bytes": 300.0},
    {"addr": {"_type": "ip", "_value": "192.168.1.2"}, "bytes": 400.0},
    {"addr": {"_type": "ip", "_value": "8.8.8.8"}, "bytes": 500.0},
    {"bytes": 999.0},                                  # no addr
    {"addr": {"_type": "ip", "_value": ["10.9.0.1", "192.168.7.7"]},
     "bytes": 50.0},                                   # two values
]

IP = {
    "ip_range": {"nets": {"_ip_range": {"_field": "addr", "_ranges": [
        {"_key": "ten", "_cidr": "10.0.0.0/8"},
        {"_key": "private192", "_from": "192.168.0.0",
         "_to": "192.169.0.0"},
        {"_key": "all", "_from": "0.0.0.0"}]}}},
    "ip_range_subs": {"nets": {"_ip_range": {"_field": "addr", "_ranges": [
        {"_key": "ten", "_cidr": "10.0.0.0/8"}]},
        "_aggs": {"total": {"_sum": {"_field": "bytes"}}}}},
    "geo_ip": {"locs": {"_geo_ip": {"_field": "addr", "_networks": [
        {"_key": "dc", "_cidrs": ["10.0.0.0/8", "8.0.0.0/8"]},
        {"_key": "office", "_cidrs": ["192.168.0.0/16"]}]},
        "_aggs": {"total": {"_sum": {"_field": "bytes"}},
                  "med": {"_median": {"_field": "bytes"}}}}},
}

GEO_DOCS = [
    {"name": "nyc1", "loc": {"_point": {"_latitude": 40.7128,
                                        "_longitude": -74.0060}}, "v": 1.0},
    {"name": "nyc2", "loc": {"_point": {"_latitude": 40.7130,
                                        "_longitude": -74.0050}}, "v": 2.0},
    {"name": "london", "loc": {"_point": {"_latitude": 51.5074,
                                          "_longitude": -0.1278}}, "v": 3.0},
    {"name": "sydney", "loc": {"_point": {"_latitude": -33.8688,
                                          "_longitude": 151.2093}}, "v": 4.0},
    {"name": "paris", "loc": {"_point": {"_latitude": 48.8566,
                                         "_longitude": 2.3522}}, "v": 5.0},
]

GEO = {
    "geo_trixels": {"t": {"_geo_trixels": {"_field": "loc", "_level": 5},
                          "_aggs": {"s": {"_sum": {"_field": "v"}}}}},
    "geo_trixels_deep": {"t": {"_geo_trixels": {"_field": "loc",
                                                "_level": 13}}},
    "geo_distance": {"d": {"_geo_distance": {
        "_field": "loc", "_origin": [51.5, -0.1],
        "_ranges": [{"_key": "near", "_to": 1_000_000},
                    {"_key": "far", "_from": 1_000_000}]},
        "_aggs": {"n": {"_count": {}}, "a": {"_avg": {"_field": "v"}}}}},
    "geo_bounds_centroid": {"b": {"_geo_bounds": {"_field": "loc"}},
                            "c": {"_geo_centroid": {"_field": "loc"}}},
}


@pytest.fixture(scope="module")
def ip_dbs():
    return _both(IP_DOCS)


@pytest.fixture(scope="module")
def geo_dbs():
    return _both(GEO_DOCS)


@pytest.mark.parametrize("case", sorted(IP))
def test_ip_world_matches_jax(ip_dbs, case):
    _check(ip_dbs, IP[case])


@pytest.mark.parametrize("case", sorted(GEO))
def test_geo_world_matches_jax(geo_dbs, case):
    _check(geo_dbs, GEO[case])


# -- the bank / netlog corpus: every kind, in three generations -------------

def _synth_docs():
    corpus = sd.build_corpus(900, seed=7)
    return corpus, [corpus.doc(i) for i in range(900)]


@pytest.fixture(scope="module")
def bank_dbs():
    corpus, docs = _synth_docs()
    return corpus, _both(docs, commit_at=(449,), deletes=range(0, 900, 31),
                         replace=range(5, 900, 97))


def _bundles(corpus):
    """Every K17c kind with its subs, from the Database path's traffic."""
    qs, _terms = sd.queries(corpus, n_each=1, n_terms=1, seed=11)
    out = {fam: aggs for fam, _q, aggs, _co in qs if fam != "M"}
    out["extended"] = {"st": {"_extended_stats": {"_field": "balance",
                                                  "_sigma": 1.5}},
                       "v": {"_variance": {"_field": "age"}},
                       "sd": {"_std_deviation": {"_field": "age"}}}
    out["missing_filter_median"] = {
        "m": {"_missing": {"_field": "employer"},
              "_aggs": {"med": {"_median": {"_field": "age"}}}},
        "f": {"_filter": {"_term": {"eyeColor": "green"}},
              "_aggs": {"med": {"_median": {"_field": "balance"}},
                        "mo": {"_mode": {"_field": "age"}}}}}
    out["three_levels"] = {"g": {"_terms": {"_field": "gender"}, "_aggs": {
        "f": {"_terms": {"_field": "favoriteFruit"}, "_aggs": {
            "r": {"_range": {"_field": "age", "_ranges": [
                {"_to": 30}, {"_from": 30, "_to": 50}, {"_from": 40}]},
                "_aggs": {"m": {"_mode": {"_field": "age"}}}}}}}}}
    out["card_geo"] = {"c": {"_cardinality": {"_field": "age"}},
                       "b": {"_geo_bounds": {"_field": "loc"}}}
    return out


@pytest.mark.parametrize("query", ["match_all", "text"])
@pytest.mark.parametrize("bundle", ["H", "R", "F", "N", "I", "G", "P",
                                    "extended", "missing_filter_median",
                                    "three_levels", "card_geo"])
def test_bank_corpus_matches_jax(bank_dbs, bundle, query):
    """Every kind over three generations of the bank / netlog corpus, as a
    match-all (the dense path: every row aggregated) and as a text OR."""
    corpus, dbs = bank_dbs
    q = {"_match_all": {}} if query == "match_all" else \
        {"about": "connecting developers running"}
    out = _check(dbs, _bundles(corpus)[bundle], query=q, k=10)
    assert out


def test_median_sub_under_range_kinds_is_a_jax_fault(bank_dbs):
    """A median sub under range, geodist_range, key_range or geo_trixels:
    JAX's compute_aggs calls _sub_stats_bucketed there without its plan
    (ops/aggs.py:336-337, 393-394, 419-420) and fails while it traces; the
    port refuses it by name (ROADMAP queue 3, mirrored)."""
    _corpus, (jdb, pdb) = bank_dbs
    sub = {"_aggs": {"m": {"_median": {"_field": "age"}}}}
    for body in ({"_range": {"_field": "balance", "_ranges": [{"_to": 5e4}]}},
                 {"_ip_range": {"_field": "addr",
                                "_ranges": [{"_cidr": "10.0.0.0/8"}]}},
                 {"_geo_distance": {"_field": "loc", "_origin": [10.0, 10.0],
                                    "_ranges": [{"_to": 1e6}]}},
                 {"_geo_trixels": {"_field": "loc", "_level": 4}}):
        aggs = {"a": {**body, **sub}}
        with pytest.raises(TypeError, match="not subscriptable"):
            jdb.search({"_match_all": {}}, k=1, aggs=aggs)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            pdb.search({"_match_all": {}}, k=1, aggs=aggs)


def test_date_histogram_per_segment_anchor_is_a_jax_fault():
    """A _date_histogram over segments of different least dates: JAX
    anchors each segment's daily buckets at its own least value
    (aggregations.py compile_for_segment, one segment a compile) and
    shapes the merged buckets from the last segment's anchor
    (database.py merge_and_shape with the last agg_meta), so months move.
    The port answers as JAX does (ROADMAP queue 3, mirrored), and the
    answer is not the documents' own months."""
    import collections
    import datetime as dt

    corpus = sd.build_corpus(60, seed=7)
    order = np.argsort(corpus.registered)
    docs = [corpus.doc(int(i)) for i in order]
    dbs = _both(docs, commit_at=(29,))
    aggs = {"m": {"_date_histogram": {"_field": "registered",
                                      "_interval": "month"}}}
    got = _check(dbs, aggs, k=1)
    months = collections.Counter(
        dt.datetime.fromtimestamp(float(np.float32(corpus.registered[i])),
                                  dt.timezone.utc).strftime("%Y-%m")
        for i in order)
    assert {b["_key"]: b["_doc_count"] for b in got["m"]} != dict(months)
    assert sum(b["_doc_count"] for b in got["m"]) == 60


# -- array level: the plain K17c functions against JAX compute_aggs ---------

@pytest.fixture(scope="module")
def arrays_world(bank_dbs):
    """Segment 0 of the JAX Database and its carry into the port
    (database.from_jax_state), with rows and masks of two queries."""
    corpus, (jdb, _pdb) = bank_dbs
    seg = jdb._searchers[0].segment
    state = _jax_state(jdb)
    pdb = from_jax_state(**state, device="cpu")
    rng = np.random.Generator(np.random.PCG64(9))
    R = 700
    ids = rng.integers(0, seg.num_docs, (2, R)).astype(np.int32)
    elig = rng.random((2, R)) < 0.7
    return corpus, jdb, pdb, ids, elig


def _jax_state(jdb):
    segments = []
    for s in jdb._searchers:
        seg = s.segment
        fields = {f: getattr(seg, f) for f in seg.__dataclass_fields__}
        from xapiand_tpu_torch.models.segment import terms_from
        fields["terms"] = terms_from(seg.terms)
        fields["values"] = {slot: {f: getattr(c, f)
                                   for f in c.__dataclass_fields__}
                            for slot, c in seg.values.items()}
        fields["geo"] = {slot: {f: getattr(g, f)
                                for f in g.__dataclass_fields__}
                         for slot, g in seg.geo.items()}
        segments.append(fields)
    return {"segments": segments, "schema": jdb.schema.to_dict(),
            "docs": dict(jdb._docs_store), "locate": dict(jdb._locate)}


ARRAY_CASES = {
    "histogram_subs": ["H"],
    "range_median": ["R"],
    "filter_percentiles": ["F"],
    "nested_median": ["N"],
    "ip_geo_ip": ["I"],
    "trixels_geodist": ["G"],
    "order_stats": ["P"],
}


def _leaves(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return [] if x is None else [x]


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_compute_aggs_vs_jax(arrays_world, case):
    """Each K17c kind of compute_aggs (the plain versions) against JAX's on
    the same segment arrays, rows, masks and plan arrays: counts and
    histograms equal, n / min / max equal, sums within rtol 1e-5."""
    from xapiand_tpu import aggregations as jagg
    from xapiand_tpu_torch import aggregations as pagg

    corpus, jdb, pdb, ids, elig = arrays_world
    bundle = _bundles(corpus)[ARRAY_CASES[case][0]]
    jseg = jdb._searchers[0].segment
    pseg = pdb._searchers[0].segment
    _n, jspecs, jarrays, _m = jagg.compile_for_segment(jdb.schema, jseg,
                                                      bundle)
    _n, pspecs, parrays, _m = pagg.compile_for_segment(pdb.schema, pseg,
                                                      bundle)
    assert pspecs == jspecs
    B = ids.shape[0]
    jplan = {k: {kk: jnp.asarray(np.repeat(np.asarray(v)[None], B, 0))
                 for kk, v in d.items()} for k, d in jarrays.items()}
    jarr = jdb._searchers[0].device_segment.arrays_pytree()
    nd = jseg.num_docs
    want = jax.jit(jax.vmap(lambda d, m, p: jaggs.compute_aggs(
        jarr, jspecs, jnp.minimum(d, nd), m, jnp.zeros(d.shape, jnp.float32),
        p)))(jnp.asarray(ids), jnp.asarray(elig), jplan)
    pplan = {k: {kk: torch.from_numpy(np.repeat(np.asarray(v)[None], B, 0))
                 for kk, v in d.items()} for k, d in parrays.items()}
    paggs.check_aggs(pspecs)
    got = paggs.compute_aggs(pdb._searchers[0].device_segment.arrays_pytree(),
                             pspecs, torch.from_numpy(ids),
                             torch.from_numpy(elig), pplan)
    gl = _leaves(got)
    wl = _leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating) and not \
                np.array_equal(g, w, equal_nan=True):
            np.testing.assert_allclose(g, w, rtol=RTOL)
        else:
            np.testing.assert_array_equal(g, w)
    assert any(np.asarray(x).any() for x in wl)
