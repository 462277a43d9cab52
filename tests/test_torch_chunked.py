"""Docid-chunked execution (K21a) against the JAX package on the CPU.

``BatchSearcher(chunk_rows=n)`` splits the docid space of a wide pure term
tree into up to 16 ranges (``_chunkify``, JAX search.py:510-566), ranks
each range on its own and merges the finalists (``_execute_chunked``,
executor.py:1000-1063). The mirror of
``tests/test_batch_search.py::test_chunked_docid_range_exact`` (30k docs,
deletes, chunk_rows 500, its "never engaged" guard) runs the port's
chunked BatchSearcher against JAX's chunked one and against the port's
unchunked one, under BM25, PL2 and DiceCoeff; the chunk plans (n_chunks,
chunk widths, each query's chunk spans) are JAX's; and the finalists'
ranking (``kernels.chunk_merge``, shard_merge.cu unstriped) is held
against JAX's ``lax.sort((-v, d, v), num_keys=2)``.

Tolerances: counts and docids are equal; scores agree to rtol 1e-5 (JAX
adds a doc's weights in its segmented scan's association order, the port
in term order); the merge's docids and scores are equal bit for bit, a NaN
equal to a NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from xapiand_tpu.models.weights import get_scheme as jget
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu.utils.synth import build_synthetic_segment, sample_queries
from xapiand_tpu_torch.models.segment import Segment, terms_from
from xapiand_tpu_torch.models.weights import get_scheme
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_schemes as ss

RTOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


@pytest.fixture(scope="module")
def world():
    """test_batch_search.py:143-147's segment and queries, the segment's
    uniqterms set (DiceCoeff reads them), in both packages."""
    seg = build_synthetic_segment(30000, 2000, seed=9)
    seg.deleted[5:2000:7] = True
    seg.uniqterms = ss.uniqterms(seg)
    qs = [sorted(q, key=lambda t: -seg.terms[t].length)
          for q in sample_queries(seg, 24, 3, seed=5)]
    pseg = Segment(**{**{f: getattr(seg, f) for f in
                         Segment.__dataclass_fields__},
                      "terms": terms_from(seg.terms)})
    return seg, pseg, qs


def _check(got, want):
    for g, w in zip(got, want):
        assert int(g["count"]) == int(w["count"])
        assert np.asarray(g["docids"]).tolist() == \
            np.asarray(w["docids"]).tolist()
        gs, ws = np.asarray(g["scores"]), np.asarray(w["scores"])
        fin = np.isfinite(ws)
        assert (np.isfinite(gs) == fin).all()
        np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL)


@pytest.mark.parametrize("scheme", ["bm25", "pl2", "dicecoeff"])
def test_chunked_matches_jax_and_unchunked(world, scheme):
    """chunk_rows 500 over 30k docs with deletes: the port's chunked run
    equals JAX's chunked run and the port's unchunked run, its launch
    groups chunked as JAX's, the chunk_merge of each group called."""
    seg, pseg, qs = world
    st = ss.real_stats(seg)
    js = JSearcher(seg, jget(scheme))
    jbs = JBatch(js, k=10, chunk_rows=500)
    jirs = [JQ.or_terms(q) for q in qs]
    want = jbs.run(jirs, stats=st)
    ps = SegmentSearcher(pseg, get_scheme(scheme), device=CPU)
    bs = BatchSearcher(ps, k=10, chunk_rows=500)
    irs = [Q.or_terms(q) for q in qs]
    planned = bs.plan(irs, stats=st)
    assert any(cfg.n_chunks > 1 for cfg, *_x in planned), \
        "chunking never engaged - test is vacuous"
    jplanned = jbs.plan(jirs, stats=st)
    assert [(c.n_chunks, c.chunk_classes) for c, *_x in planned] == \
        [(c.n_chunks, c.chunk_classes) for c, *_x in jplanned]
    for (_c, _f, pb, _h), (_jc, _jf, jb, _jh) in zip(planned, jplanned):
        for key in ("c_offsets", "c_lens"):
            assert pb[key].tolist() == np.asarray(jb[key]).tolist()
    calls = []
    real = kernels.chunk_merge
    kernels.chunk_merge = lambda *a: calls.append(1) or real(*a)
    try:
        got = bs.run(irs, stats=st)
    finally:
        kernels.chunk_merge = real
    assert len(calls) == sum(1 for c, *_x in planned if c.n_chunks > 1)
    _check(got, want)
    _check(BatchSearcher(ps, k=10).run(irs, stats=st), want)


def test_chunk_rows_off_or_declined_plans_nothing(world):
    """chunk_rows 0 (the default) and a shape _chunkify declines (an AND
    tree) plan no chunk, as in JAX."""
    seg, pseg, qs = world
    ps = SegmentSearcher(pseg, device=CPU)
    irs = [Q.or_terms(q) for q in qs]
    assert not any(c.n_chunks > 1 for c, *_x in
                   BatchSearcher(ps, k=10).plan(irs))
    ands = [Q.and_(Q.term(q[0]), Q.or_terms(q[1:])) for q in qs]
    assert not any(c.n_chunks > 1 for c, *_x in
                   BatchSearcher(ps, k=10, chunk_rows=500).plan(ands))
    assert not any(c.n_chunks > 1 for c, *_x in JBatch(
        JSearcher(seg, jget("bm25")), k=10, chunk_rows=500).plan(
        [JQ.and_(JQ.term(q[0]), JQ.or_terms(q[1:])) for q in qs]))


def _lax_finalists(d, v, k):
    """_execute_chunked 1058-1063 on [NC, Q, k] finalists, per query."""
    NC, Q, _k = d.shape

    def one(dq, vq):
        _, dd, vv = lax.sort((-vq, dq, vq), num_keys=2)
        return dd[:k], vv[:k]

    dd, vv = jax.vmap(one)(jnp.asarray(np.transpose(d, (1, 0, 2)).reshape(
        Q, NC * k)), jnp.asarray(np.transpose(v, (1, 0, 2)).reshape(
            Q, NC * k)))
    return np.asarray(dd), np.asarray(vv)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("NC", [2, 16])
def test_chunk_merge_plain_matches_lax_sort(seed, NC):
    """The finalists' ranking against lax.sort((-v, d, v), num_keys=2):
    -inf finalists (SENTINEL docids, as each chunk's top-k gives them),
    NaN scores, ties across chunks, -0.0 beside 0.0."""
    rng = np.random.Generator(np.random.PCG64(seed))
    Q, k = 12, 10
    vals = np.array([0.5, 1.0, 2.0, 0.0, -0.0, np.nan, -np.inf],
                    np.float32)
    v = vals[rng.integers(0, len(vals), (NC, Q, k))]
    # half the queries hold 3 finite and 3 -inf finalists, the rest NaN:
    # -inf and NaN reach their top k
    v[:, :Q // 2] = np.nan
    v[0, :Q // 2, :3] = vals[rng.integers(0, 5, (Q // 2, 3))]
    v[0, :Q // 2, 3:6] = -np.inf
    d = rng.integers(0, 3000, (NC, Q, k)).astype(np.int32)
    d = np.where(np.isfinite(v), d, np.int32(kernels.SENTINEL))
    want_d, want_v = _lax_finalists(d, v, k)
    got_d, got_v = kernels.chunk_merge(torch.from_numpy(d),
                                       torch.from_numpy(v))
    assert got_d.tolist() == want_d.tolist()
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert np.isnan(want_v).any() and np.isneginf(want_v).any()
