"""The weight schemes of the torch port against the JAX package's, on the
same inputs.

BM25: term_constant is the same float64 host arithmetic (equal); sumpart
is a float32 device formula evaluated in the same operation order (rtol
1e-6); impact_np is the same numpy code (equal).

Every scheme (the 15 others and LM's five smoothings, several parameter
sets, two collections): get_scheme builds it with JAX's name, parameters
and key(); term_constant is equal (float64 host arithmetic); sumpart on
the same seeded postings, under jax.jit as the executor runs it, is within
the float64 oracle's per-posting bound of utils/synth_schemes.py on both
sides (ERR_ULPS = 8 ulps of each formula's error scale S), so the two
differ by at most twice it. BB2's S is units: its Stirling terms cancel in
float32, in JAX as in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xapiand_tpu.models import weights as jw
from xapiand_tpu_torch.models import weights as pw
from xapiand_tpu_torch.utils import synth_schemes as ss

PARAMS = [
    {},
    {"k1": 1.2, "b": 0.75},
    {"k1": 2.0, "b": 0.0},          # length factor 0 (b == 0)
    {"k1": 0.0, "b": 0.5},          # length factor 0 (k1 == 0)
    {"k1": 0.9, "k3": 0.0, "b": 0.4, "min_normlen": 0.2},
]
AVGS = [1.0, 37.25, 412.5]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    wdf = rng.integers(0, 12, 512).astype(np.float32)
    doclen = rng.uniform(1, 900, 512).astype(np.float32)
    tconst = rng.uniform(0.1, 9.0, 512).astype(np.float32)
    return wdf, doclen, tconst


@pytest.mark.parametrize("params", PARAMS)
def test_term_constant_equal(params):
    js, ps = jw.BM25(**params), pw.BM25(**params)
    for n_docs, avg in ((1000, 40.0), (1_000_000, 65.0)):
        jst = jw.CollectionStats(doc_count=n_docs, avg_doclen=avg)
        pst = pw.CollectionStats(doc_count=n_docs, avg_doclen=avg)
        for tf in (0, 1, 7, 300, n_docs // 2, n_docs):
            for wqf, factor in ((1, 1.0), (3, 0.5)):
                assert ps.term_constant(pst, tf, wqf, factor) == \
                    js.term_constant(jst, tf, wqf, factor)
    assert ps.key() == js.key()


@pytest.mark.parametrize("avg", AVGS)
@pytest.mark.parametrize("params", PARAMS)
def test_sumpart_matches_jax(params, avg):
    wdf, doclen, tconst = _inputs(int(avg))
    js, ps = jw.BM25(**params), pw.BM25(**params)
    want = np.asarray(js.sumpart(jnp.asarray(wdf), jnp.asarray(doclen),
                                 jnp.asarray(tconst),
                                 jw.CollectionStats(100, jnp.float32(avg))))
    got = ps.sumpart(torch.from_numpy(wdf), torch.from_numpy(doclen),
                     torch.from_numpy(tconst), pw.CollectionStats(100, avg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("params", PARAMS)
def test_impact_np_equal(params):
    wdf, doclen, _ = _inputs(3)
    for avg in AVGS:
        np.testing.assert_array_equal(
            pw.BM25(**params).impact_np(wdf, doclen,
                                        pw.CollectionStats(100, avg)),
            jw.BM25(**params).impact_np(wdf, doclen,
                                        jw.CollectionStats(100, avg)))


def test_get_scheme_rejects_unknown_names():
    """get_scheme raises ValueError on an unknown name, as JAX's does, and
    builds every JAX name (case-insensitively)."""
    assert isinstance(pw.get_scheme("BM25"), pw.BM25)
    for name in jw._SCHEMES:
        assert type(pw.get_scheme(name)).__name__ == \
            type(jw.get_scheme(name)).__name__
    for name in ("bm26", "", "lm2"):
        with pytest.raises(ValueError):
            jw.get_scheme(name)
        with pytest.raises(ValueError, match="unknown weight scheme"):
            pw.get_scheme(name)
    with pytest.raises(ValueError):
        pw.get_scheme("lm", smoothing="laplace")
    for bad in ({"c": 0.0}, {"c": -1.0}):
        with pytest.raises(ValueError, match="invalid"):
            pw.get_scheme("pl2", **bad)
    with pytest.raises(ValueError, match="invalid"):
        pw.get_scheme("pl2plus", delta=0.0)


# ---------------------------------------------------------------------------
# every scheme
# ---------------------------------------------------------------------------

SCHEMES = [
    ("bm25plus", {}), ("bm25plus", {"k1": 1.5, "b": 0.8, "delta": 0.5}),
    ("tfidf", {}), ("trad", {}), ("trad", {"k": 2.5}), ("trad", {"k": 0.0}),
    ("bool", {}), ("coord", {}), ("dicecoeff", {}),
    ("inl2", {}), ("inl2", {"c": 7.0}), ("ifb2", {}), ("ifb2", {"c": 0.4}),
    ("ineb2", {}), ("ineb2", {"c": 2.0}), ("bb2", {}), ("bb2", {"c": 3.0}),
    ("pl2", {}), ("pl2", {"c": 2.0}), ("pl2plus", {}),
    ("pl2plus", {"c": 0.5, "delta": 1.5}), ("dlh", {}), ("dph", {}),
] + [("lm", {"smoothing": sm}) for sm in jw.LM.SMOOTHINGS] + [
    ("lm", {"smoothing": "two_stage", "s1": 0.4, "s2": 900.0}),
    ("lm", {"smoothing": "dirichlet_plus", "param_log": 300.0}),
    ("lm", {"smoothing": "absolute_discount", "s1": 0.3}),
]
# (N, avg_doclen, doclen_upper, query_length): a large collection, and a
# small one of short docs
COLLECTIONS = [(1_000_000, 64.5, 412.0, 3), (3000, 12.25, 40.0, 1)]


def _scheme_id(case):
    name, params = case
    return name + "".join(f"-{k}={v}" for k, v in sorted(params.items()))


def _postings(seed, n_docs, upper):
    rng = np.random.default_rng(seed)
    L = 4096
    wdf = rng.integers(0, 24, L).astype(np.float32)
    doclen = np.maximum(wdf + rng.integers(0, 2, L),
                        rng.integers(1, int(upper) + 1, L)).astype(np.float32)
    uniq = np.maximum(1, doclen * rng.uniform(0.3, 1.0, L)).astype(
        np.float32)
    tf = rng.integers(1, max(n_docs // 4, 2), L)
    cf = np.maximum(tf, (tf * rng.uniform(0.5, 40.0, L)).astype(np.int64))
    return wdf, doclen, uniq, tf, cf


@pytest.mark.parametrize("case", SCHEMES, ids=_scheme_id)
def test_scheme_term_constant_and_key_equal(case):
    name, params = case
    js, ps = jw.get_scheme(name, **params), pw.get_scheme(name, **params)
    assert ps.key() == js.key()
    assert ps.n_constants == js.n_constants
    assert ps.needs_uniqterms == js.needs_uniqterms
    assert (ps.impact_np(np.ones(3, np.float32), np.ones(3, np.float32),
                         pw.CollectionStats(10, 5.0)) is None) == \
        (js.impact_np(np.ones(3, np.float32), np.ones(3, np.float32),
                      jw.CollectionStats(10, 5.0)) is None)
    for n_docs, avg, upper, qlen in COLLECTIONS:
        st = dict(doc_count=n_docs, avg_doclen=avg, doclen_lower=1.0,
                  doclen_upper=upper, total_len=n_docs * avg,
                  query_length=qlen)
        jst, pst = jw.CollectionStats(**st), pw.CollectionStats(**st)
        for tf, cf in ((0, 0), (1, 1), (7, 40), (300, 299), (n_docs // 2,
                                                             n_docs * 3)):
            for wqf, factor in ((1, 1.0), (3, 0.5)):
                assert ps.term_constant(pst, tf, wqf, factor, cf) == \
                    js.term_constant(jst, tf, wqf, factor, cf)
        if name != "trad":
            assert ps.max_sumpart(2.5 if ps.n_constants == 1 else (2.5, 9.0),
                                  4.0, pst) == \
                js.max_sumpart(2.5 if js.n_constants == 1 else (2.5, 9.0),
                               4.0, jst)


@pytest.mark.parametrize("coll", range(len(COLLECTIONS)))
@pytest.mark.parametrize("case", SCHEMES, ids=_scheme_id)
def test_scheme_sumpart_matches_jax(case, coll):
    name, params = case
    n_docs, avg, upper, qlen = COLLECTIONS[coll]
    js, ps = jw.get_scheme(name, **params), pw.get_scheme(name, **params)
    wdf, doclen, uniq, tf, cf = _postings(coll + 11, n_docs, upper)
    st = dict(doc_count=n_docs, avg_doclen=avg, doclen_lower=1.0,
              doclen_upper=upper, total_len=n_docs * avg, query_length=qlen)
    pst = pw.CollectionStats(**st)
    tc = np.asarray([ps.term_constant(pst, int(a), 1, 1.0, int(b))
                     for a, b in zip(tf, cf)], np.float32)
    # per posting, constant i of scheme is tc[i] (a [C, L] array)
    tcv = tc.T if tc.ndim == 2 else tc
    u = uniq if ps.needs_uniqterms else None
    # the executor's stats: float32 scalars, traced under jit
    f32 = jnp.float32
    jst = jw.CollectionStats(f32(n_docs), f32(avg), f32(1.0), f32(upper),
                             f32(n_docs * avg), f32(qlen))
    if u is None:
        want = jax.jit(lambda w, d, t: js.sumpart(w, d, t, jst))(
            wdf, doclen, tcv)
    else:
        want = jax.jit(lambda w, d, t, q: js.sumpart(w, d, t, jst, uniq=q))(
            wdf, doclen, tcv, u)
    got = ps.sumpart(torch.from_numpy(wdf), torch.from_numpy(doclen),
                     torch.from_numpy(tcv), pst,
                     uniq=None if u is None else torch.from_numpy(u))
    assert got.dtype == torch.float32 and got.shape == wdf.shape
    got = got.numpy().astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    tcs = tuple(tcv.astype(np.float64)) if tc.ndim == 2 else \
        (tcv.astype(np.float64),)
    w64, S = ss.sumpart64(ps, wdf, doclen, tcs, pst, u)
    bound = ss.ERR_ULPS * ss.U32 * S
    assert (np.abs(got - w64) <= bound).all()
    assert (np.abs(want - w64) <= bound).all()
    assert (np.abs(got - want) <= 2 * bound).all()
    if name != "bool":
        assert (got != 0).any()
