"""The slice as a whole: the port's BatchSearcher.run against the JAX
package's, on the four cases of tests/test_prefix.py.

Each side builds its corpus and queries with its own modules, from the
same seeds (the port's synth.py and ir.py are copies of the JAX package's),
so the port runs alone. XT_HOST_PATH=0 keeps the JAX side on its device
path (otherwise its small batches go to the native host scorer). Ranks are compared as tie groups
with scores at rtol 1e-5 (JAX sums a doc's rows in lax.sort order, the
port in term order) and every returned doc is held against a float64 BM25
oracle; within the port, prefix mode must reproduce the exact path's ranks
exactly.
"""

import numpy as np
import pytest
import torch

import xapiand_tpu.utils.synth as jsynth
from xapiand_tpu.models.weights import get_scheme as jscheme
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.weights import BM25, CollectionStats
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                           sample_queries)

RTOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


def _queries(seg, n, seed, **kw):
    return [sorted(q, key=lambda t: -seg.terms[t].length)
            for q in sample_queries(seg, n, 3, seed=seed, **kw)]


def _dense(seg, terms):
    """float64 BM25 over every doc (bench.cpu_baseline's formula)."""
    st = CollectionStats(seg.doc_count, seg.avg_doclen)
    out = np.zeros(seg.num_docs)
    for t in terms:
        ti = seg.terms[t]
        sl = slice(ti.offset, ti.offset + ti.length)
        wdf = seg.post_wdf[sl].astype(np.float64)
        nl = np.maximum(seg.post_doclen[sl] / st.avg_doclen, 0.5)
        out[seg.post_docids[sl]] += BM25().term_constant(
            st, ti.length) * wdf / (nl * 0.5 + 0.5 + wdf)
    return out


def _doc_ranks(res):
    return [int(d) for d, s in zip(res["docids"], res["scores"])
            if np.isfinite(s)]


def _assert_matches_jax(seg, queries, got, want, k=10):
    for terms, g, w in zip(queries, got, want):
        dense = _dense(seg, terms)
        gd, gs = np.asarray(g["docids"]), np.asarray(g["scores"])
        fin = np.isfinite(gs)
        np.testing.assert_array_equal(fin, np.isfinite(w["scores"]))
        assert (gd[~fin] == kernels.SENTINEL).all()
        np.testing.assert_allclose(gs[fin], np.asarray(w["scores"])[fin],
                                   rtol=RTOL)
        d, s = gd[fin], gs[fin]
        np.testing.assert_allclose(dense[d], s, rtol=RTOL)
        assert len(set(d.tolist())) == len(d)
        assert all(d[i] < d[i + 1] for i in range(len(d) - 1)
                   if s[i] == s[i + 1])
        assert len(d) == min(k, int((dense > 0).sum()))
        if len(d):
            assert set(np.flatnonzero(dense > s[-1] * (1 + RTOL)).tolist()) \
                <= set(d.tolist())
        assert g["count"] == w["count"]


def _jax_run(n_docs, vocab, seed, queries, ties=False, **kw):
    """The JAX package end to end on its own corpus from the same seed."""
    seg = jsynth.build_synthetic_segment(n_docs, vocab, seed=seed)
    if ties:
        _make_ties(seg)
    return JBatch(JSearcher(seg, jscheme("bm25")), k=10, **kw).run(
        [JQ.or_terms(q) for q in queries])


def _make_ties(seg):
    n = seg.num_docs
    seg.post_wdf[:] = 1.0
    seg.doclen[:n] = 50.0
    seg.post_doclen[:] = 50.0
    seg.total_doclen = 50.0 * n
    return seg


def test_impact_mirror_is_per_term_descending_permutation():
    seg = build_synthetic_segment(3000, 200, seed=3)
    ps = SegmentSearcher(seg, device=CPU)
    scheme = ps.scheme
    stats = CollectionStats(seg.doc_count, seg.avg_doclen, 1.0)
    assert ps.device_segment.ensure_impact(scheme, stats)
    arrs = ps.device_segment.arrays_pytree()
    imp_d, imp_w, imp_l = (arrs[k].numpy() for k in
                           ("imp.docids", "imp.wdf", "imp.doclen"))
    g_imp = scheme.impact_np(imp_w, imp_l, stats)
    for t, ti in seg.terms.items():
        o, ln = ti.offset, ti.length
        assert sorted(zip(seg.post_docids[o:o + ln], seg.post_wdf[o:o + ln])) \
            == sorted(zip(imp_d[o:o + ln], imp_w[o:o + ln])), t
        gs = g_imp[o:o + ln]
        assert np.all(gs[:-1] >= gs[1:] - 1e-7), t
        ties = gs[:-1] == gs[1:]
        assert np.all(imp_d[o:o + ln][:-1][ties] < imp_d[o:o + ln][1:][ties])


@pytest.mark.parametrize("prefix_cap", [0, 256])
def test_prefix_rank_parity_zipf(prefix_cap):
    """Zipf corpus: port vs JAX in the same mode, and the port's prefix
    ranks equal to its exact ranks."""
    seg = build_synthetic_segment(4000, 300, seed=3)
    queries = _queries(seg, 48, 5)
    irs = [Q.or_terms(q) for q in queries]
    ps = SegmentSearcher(seg, device=CPU)
    bs = BatchSearcher(ps, k=10, prefix_cap=prefix_cap)
    if prefix_cap:
        assert any(cfg.prefix for cfg, *_ in bs.plan(irs))
    got = bs.run(irs)
    want = _jax_run(4000, 300, 3, queries, prefix_cap=prefix_cap)
    _assert_matches_jax(seg, queries, got, want)
    exact = BatchSearcher(ps, k=10).run(irs)
    for e, p in zip(exact, got):
        assert _doc_ranks(e) == _doc_ranks(p)
        np.testing.assert_array_equal(np.asarray(e["scores"]),
                                      np.asarray(p["scores"]))


def test_prefix_all_ties_falls_back_exact():
    """Every posting the same weight: certificates fail closed and the
    exact re-run reproduces the docid-tiebreak order."""
    seg = _make_ties(build_synthetic_segment(2000, 200, seed=1))
    queries = _queries(seg, 16, 2, max_df_frac=1.0)
    irs = [Q.or_terms(q) for q in queries]
    ps = SegmentSearcher(seg, device=CPU)
    bs = BatchSearcher(ps, k=10, prefix_cap=128)
    planned = bs.plan(irs)
    pref = [p for p in planned if p[0].prefix]
    assert pref
    seg_arrays = ps.device_segment.arrays_pytree()
    stats_d = {"N": float(seg.doc_count), "avg_doclen": seg.avg_doclen}
    assert any(not bool(fn(seg_arrays, b, stats_d)["certified"].all())
               for _cfg, fn, b, _c in pref)
    got = bs.run(irs)
    exact = BatchSearcher(ps, k=10).run(irs)
    want = _jax_run(2000, 200, 1, queries, ties=True)
    _assert_matches_jax(seg, queries, exact, want)
    for e, p in zip(exact, got):
        assert _doc_ranks(e) == _doc_ranks(p)


def test_prefix_short_query_in_truncated_group_certifies():
    """All terms shorter than the cap in a truncated group: zero unread
    mass, so the query certifies and stays exact (U == 0 branch)."""
    seg = build_synthetic_segment(4000, 300, seed=7)
    queries = _queries(seg, 32, 9)
    irs = [Q.or_terms(q) for q in queries]
    ps = SegmentSearcher(seg, device=CPU)
    got = BatchSearcher(ps, k=10, prefix_cap=256).run(irs)
    exact = BatchSearcher(ps, k=10).run(irs)
    want = _jax_run(4000, 300, 7, queries)
    _assert_matches_jax(seg, queries, exact, want)
    for e, p in zip(exact, got):
        assert _doc_ranks(e) == _doc_ranks(p)


def test_plain_versions_count_no_launches():
    seg = build_synthetic_segment(2000, 200, seed=4)
    irs = [Q.or_terms(q) for q in _queries(seg, 5, 1)]
    kernels.reset_launches()   # plain versions on the CPU count nothing
    res = BatchSearcher(SegmentSearcher(seg, device=CPU), k=10).run(irs)
    assert len(res) == 5 and all(len(r["docids"]) == 10 for r in res)
    assert not any(kernels.launches.values())


def test_unported_options_raise():
    seg = build_synthetic_segment(500, 50, seed=1)
    ps = SegmentSearcher(seg, device=CPU)
    # docid-range chunking is ported (K21, slice 11): chunk_rows is
    # accepted and held against JAX in tests/test_torch_chunked.py
    assert BatchSearcher(ps, chunk_rows=4096).chunk_rows == 4096
    with pytest.raises(NotImplementedError, match="K17c"):
        BatchSearcher(ps, aggs=((("histogram", 1, 64, ()),), {}))
    # a prefix_cap past one block's shared memory is admitted: score_slices
    # sorts such a prefix block in device memory (held against JAX in
    # tests/test_torch_limits.py)
    assert BatchSearcher(ps, prefix_cap=2 * kernels.MAX_PREFIX_ROWS
                         ).prefix_cap == 2 * kernels.MAX_PREFIX_ROWS
    bs = BatchSearcher(ps, k=10)
    # phrases are ported (K14), of any length since the kernel finds the
    # lists past its per-thread table again (17 terms: answered; held
    # against JAX in tests/test_torch_limits.py)
    out = bs.run([Q.phrase([f"t{i}" for i in range(17)])])
    assert len(out) == 1 and int(out[0]["count"]) >= 0
