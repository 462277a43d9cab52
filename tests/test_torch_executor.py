"""The port's executor kernels (plain versions, on the CPU) against their
JAX counterparts, called on the same numpy inputs.

  K1 score_slices      vs lax.dynamic_slice + BM25.sumpart (executor 691-742)
  K2+K3 merge_docs     vs lax.sort + _merge_runs + run tails (743-828, 881)
  K4 topk_rows         vs _rank_and_topk(rows_sorted=True)
  K5 prefix_certify    vs _prefix_topk
  execute_batch        vs SegmentSearcher.batched(cfg), exact + prefix mode

(The predicate path, K6-K8 and K11, is held against JAX in
tests/test_torch_predicate.py.)

Tolerances: lax.sort is stable (executor.py:774-783), so a doc's rows
stand in term order on both sides; JAX adds them in the association order
of _merge_runs' segmented scan, the port one after another in term order:
scores agree to rtol 1e-5, ranks are compared as tie groups, and every
returned doc is checked against a float64 BM25 oracle. Docids of equal
float32 scores must ascend. Counts and certificates are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import xapiand_tpu.ops.executor as jex
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.query.ir import Q
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu.utils.synth import build_synthetic_segment, sample_queries
from xapiand_tpu_torch.models.segment import device_segment_from_numpy
from xapiand_tpu_torch.models.weights import BM25, CollectionStats
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import (SENTINEL, check_supported,
                                            execute_batch)

RTOL = 1e-5
CASES = {   # corpus: (n_docs, vocab, seed, queries, query seed,
    #                 max_df_frac, prefix_cap) - tests/test_prefix.py's
    "zipf": (4000, 300, 3, 48, 5, 0.1, 256),
    "ties": (2000, 200, 1, 16, 2, 1.0, 128),
}
MODES = ("exact", "prefix")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _tree_to_numpy(tree):
    return {k: (_tree_to_numpy(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


class Case:
    """One corpus + mode: its launch groups, both segments, both stats."""

    def __init__(self, corpus, mode):
        self.corpus = corpus
        n, vocab, seed, nq, qseed, frac, cap = CASES[corpus]
        seg = build_synthetic_segment(n, vocab, seed=seed)
        if corpus == "ties":     # every posting the same weight
            seg.post_wdf[:] = 1.0
            seg.doclen[:n] = 50.0
            seg.post_doclen[:] = 50.0
            seg.total_doclen = 50.0 * n
        self.seg = seg
        self.queries = [sorted(q, key=lambda t: -seg.terms[t].length)
                        for q in sample_queries(seg, nq, 3, seed=qseed,
                                                max_df_frac=frac)]
        irs = [Q.or_terms(q) for q in self.queries]
        self.js = JSearcher(seg, JBM25())
        self.planned = JBatch(self.js, k=10,
                              prefix_cap=cap if mode == "prefix" else 0
                              ).plan(irs)
        self.jseg = self.js.device_segment.arrays_pytree()
        # the JAX package's state, carried into the port
        self.pseg = device_segment_from_numpy(_tree_to_numpy(self.jseg),
                                              torch.device("cpu"))
        self.jstats = {"N": jnp.float32(seg.doc_count),
                       "avg_doclen": jnp.float32(seg.avg_doclen),
                       "doclen_lower": jnp.float32(1.0)}
        self.pstats = {"N": float(seg.doc_count),
                       "avg_doclen": float(seg.avg_doclen)}
        self.params = BM25().kernel_spec(
            CollectionStats(seg.doc_count, seg.avg_doclen))
        self.dense = [self._dense(q) for q in self.queries]

    def _dense(self, terms):
        """float64 BM25 over every doc (bench.cpu_baseline's formula)."""
        seg = self.seg
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

    def groups(self):
        """(cfg, port batch tensors, query idxs) per launch."""
        for cfg, fn, batch, chunk in self.planned:
            pb = {k: torch.from_numpy(np.array(batch[k]))
                  for k in ("offsets", "lens", "tconst", "scoring")}
            yield cfg, fn, batch, pb, chunk

    def slices(self, cfg, pb):
        prefix = cfg.prefix or (0,) * cfg.T
        widths = tuple(p or c for p, c in zip(prefix, cfg.term_classes()))
        post = tuple(self.pseg[k] for k in
                     ("post_docids", "post_wdf", "post_doclen"))
        imp = tuple(self.pseg[k] for k in
                    ("imp.docids", "imp.wdf", "imp.doclen")) \
            if any(prefix) else None
        args = (pb["offsets"], pb["lens"], pb["tconst"], pb["scoring"])
        ids, w, tail = kernels.score_slices(post, imp, *args, widths, prefix,
                                            self.params)
        return post, args, widths, prefix, ids, w, tail


_CACHE = {}


@pytest.fixture(params=[(c, m) for c in CASES for m in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    if request.param not in _CACHE:
        _CACHE[request.param] = Case(*request.param)
    return _CACHE[request.param]


def check_ranking(gd, gs, wd, ws, dense, k):
    """Port (gd, gs) vs JAX (wd, ws) for one query, as tie groups, with
    every returned doc held against the float64 oracle ``dense``."""
    gd, gs, wd, ws = (np.asarray(x) for x in (gd, gs, wd, ws))
    fin = np.isfinite(gs)
    np.testing.assert_array_equal(fin, np.isfinite(ws))
    assert (gd[~fin] == SENTINEL).all() and (wd[~fin] == SENTINEL).all()
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL)
    d, s = gd[fin], gs[fin]
    assert len(set(d.tolist())) == len(d)
    np.testing.assert_allclose(dense[d], s, rtol=RTOL)
    assert all(d[i] < d[i + 1] for i in range(len(d) - 1)
               if s[i] == s[i + 1])
    assert len(d) == min(k, int((dense > 0).sum()))
    if len(d):
        must = np.flatnonzero(dense > s[-1] * (1 + RTOL))
        assert set(must.tolist()) <= set(d.tolist())


def test_score_slices_vs_jax_slices(case):
    """K1: each term block holds the JAX slice's rows (impact prefixes
    re-sorted by docid), same weights; the tail bound matches 698-705."""
    jb = JBM25()
    jst = JStats(case.jstats["N"], case.jstats["avg_doclen"])
    for cfg, _fn, batch, pb, _chunk in case.groups():
        _post, _a, widths, prefix, ids, w, tail = case.slices(cfg, pb)
        ro = kernels.row_offsets(widths)
        offs, lens = np.asarray(batch["offsets"]), np.asarray(batch["lens"])
        tc, sc = np.asarray(batch["tconst"]), np.asarray(batch["scoring"])
        for t, W in enumerate(widths):
            src = "imp." if prefix[t] else "post_"
            dk = "imp.docids" if prefix[t] else "post_docids"
            n = case.jseg[dk].shape[0]
            idx = np.minimum(offs[:, t], n - W)[:, None] + np.arange(W)
            inl = np.arange(W)[None, :] < lens[:, t:t + 1]
            jd = np.where(inl, np.asarray(case.jseg[dk])[idx], SENTINEL)
            jw = jb.sumpart(jnp.asarray(case.jseg[src + "wdf"])[idx],
                            jnp.asarray(case.jseg[src + "doclen"])[idx],
                            jnp.asarray(tc[:, t:t + 1]), jst)
            jw = np.where(inl, np.asarray(jw) * sc[:, t:t + 1], 0.0)
            if prefix[t]:
                order = np.argsort(jd, axis=1, kind="stable")
                jd = np.take_along_axis(jd, order, 1)
                jw = np.take_along_axis(jw, order, 1)
                bpos = np.minimum(offs[:, t] + W, n - 1)
                gb = np.asarray(jb.sumpart(
                    jnp.asarray(case.jseg["imp.wdf"])[bpos],
                    jnp.asarray(case.jseg["imp.doclen"])[bpos],
                    jnp.asarray(tc[:, t]), jst))
                jt = np.where(lens[:, t] > W,
                              np.maximum(gb * sc[:, t], 0.0), 0.0)
            else:
                jt = np.zeros(len(offs), np.float32)
            np.testing.assert_array_equal(ids[:, ro[t]:ro[t + 1]].numpy(),
                                          jd)
            np.testing.assert_allclose(w[:, ro[t]:ro[t + 1]].numpy(), jw,
                                       rtol=1e-6)
            np.testing.assert_allclose(tail[:, t].numpy(), jt, rtol=1e-6)


def _jax_merge(ids, w, T):
    """The JAX package's docid sort + run merge + tails (743-828, 881)."""
    def one(i, x):
        d, wv = lax.sort((i, x), num_keys=1)
        sums, _ = jex._merge_runs(d, wv, None, T)
        tail = jnp.concatenate([d[1:] != d[:-1], jnp.ones((1,), bool)])
        first = tail & (d != jex.SENTINEL)
        return d, sums, first, jnp.sum(first.astype(jnp.int32))

    return jax.vmap(one)(jnp.asarray(ids.numpy()), jnp.asarray(w.numpy()))


def test_merge_docs_vs_merge_runs(case):
    """K2+K3: one owner row per doc carrying the doc's total; counts equal."""
    for cfg, _fn, _batch, pb, _chunk in case.groups():
        _post, _a, widths, _p, ids, w, _tail = case.slices(cfg, pb)
        sums, owner, count, _ = kernels.merge_docs(ids, w, widths)
        d, jsums, first, jcount = (np.asarray(x) for x in
                                   _jax_merge(ids, w, cfg.T))
        np.testing.assert_array_equal(count.numpy(), jcount)
        for b in range(ids.shape[0]):
            o = owner[b].numpy()
            got = dict(zip(ids[b].numpy()[o].tolist(),
                           sums[b].numpy()[o].tolist()))
            want = dict(zip(d[b][first[b]].tolist(),
                            jsums[b][first[b]].tolist()))
            assert sorted(got) == sorted(want)
            np.testing.assert_allclose([got[x] for x in sorted(got)],
                                       [want[x] for x in sorted(want)],
                                       rtol=RTOL)


def test_topk_rows_vs_rank_and_topk(case):
    """K4: exact top-k, score desc / docid asc, SENTINEL / -inf padding."""
    for cfg, _fn, _batch, pb, chunk in case.groups():
        _post, _a, widths, _p, ids, w, _tail = case.slices(cfg, pb)
        sums, owner, _count, _ = kernels.merge_docs(ids, w, widths)
        gd, gs = kernels.topk_rows(sums, ids, owner, cfg.k)
        d, jsums, first, _ = _jax_merge(ids, w, cfg.T)
        jd, js = jax.vmap(lambda a, b, c: jex._rank_and_topk(
            cfg, case.jseg, a, b, c, rows_sorted=True)[:2])(d, jsums, first)
        for b, qi in enumerate(chunk):
            dense = case.dense[qi]
            if cfg.prefix:   # the truth over the rows the prefixes read
                dense = np.zeros(case.seg.num_docs)
                real = ids[b].numpy() != SENTINEL
                np.add.at(dense, ids[b].numpy()[real],
                          w[b].numpy()[real].astype(np.float64))
            check_ranking(gd[b], gs[b], jd[b], js[b], dense, cfg.k)


def test_prefix_certify_vs_prefix_topk(case):
    """K5: rescored top-k and the certificate of _prefix_topk."""
    if not any(cfg.prefix for cfg, *_ in case.planned):
        assert all(not cfg.verify_k for cfg, *_ in case.planned)
        return   # exact mode: K5 is not on the path
    cst = JStats(case.jstats["N"], case.jstats["avg_doclen"], 1.0)
    n_checked = n_uncertified = 0
    for cfg, _fn, batch, pb, chunk in case.groups():
        if not cfg.verify_k:
            continue
        post, args, widths, prefix, ids, w, tail = case.slices(cfg, pb)
        sums, owner, _count, _ = kernels.merge_docs(ids, w, widths)
        K = min(cfg.verify_k, ids.shape[1] - 1)
        cd, cv = kernels.topk_rows(sums, ids, owner, K + 1)
        gd, gs, gc = kernels.prefix_certify(post, *args, cfg.term_classes(),
                                            tail, cd, cv, cfg.k, case.params)
        d, jsums, first, _ = _jax_merge(ids, w, cfg.T)
        tb = jnp.asarray(tail.numpy()[:, [t for t, p in enumerate(prefix)
                                          if p]])

        def one(plan, d1, s1, f1, tb1):
            out = {}
            jex._prefix_topk(cfg, case.jseg, plan, cst, JBM25(), d1, s1, f1,
                             [tb1[i] for i in range(tb1.shape[0])], out)
            return out["docids"], out["scores"], out["certified"]

        jd, js, jc = jax.vmap(one)(
            {k: batch[k] for k in ("offsets", "lens", "tconst", "scoring")},
            d, jsums, first, tb)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(jc))
        for b, qi in enumerate(chunk):
            if bool(gc[b]):
                check_ranking(gd[b], gs[b], jd[b], js[b], case.dense[qi],
                              cfg.k)
                n_checked += 1
            else:
                n_uncertified += 1
    # zipf: most certify; all ties: the certificate must fail closed
    assert n_checked if case.corpus == "zipf" else n_uncertified


def test_execute_batch_vs_jax_batched(case):
    """The whole executor: port execute_batch vs JAX batched(cfg) on every
    launch group of the case."""
    for cfg, fn, batch, pb, chunk in case.groups():
        want = fn(case.jseg, batch, case.jstats)
        got = execute_batch(case.pseg, pb, cfg, case.pstats, BM25())
        assert set(got) == set(want)
        assert got["docids"].dtype == torch.int32
        assert got["scores"].dtype == torch.float32
        assert got["count"].dtype == torch.int32
        np.testing.assert_array_equal(got["count"].numpy(),
                                      np.asarray(want["count"]))
        cert = np.ones(len(chunk), bool)
        if "certified" in want:
            assert got["certified"].dtype == torch.bool
            cert = got["certified"].numpy()
            np.testing.assert_array_equal(cert, np.asarray(want["certified"]))
        for b, qi in enumerate(chunk):
            if cert[b]:
                check_ranking(got["docids"][b], got["scores"][b],
                              want["docids"][b], want["scores"][b],
                              case.dense[qi], cfg.k)


# configurations the ported slices still refuse, with the ROADMAP item that
# ports each; those the predicate path admits (tree, deletes, filters,
# sorts, unweighted, compaction, count-only) run against the JAX executor
# in tests/test_torch_predicate.py::test_configs_inside_the_slice_run_as_jax
OUTSIDE = [   # (test id, ExecConfig change, ROADMAP item)
    ("join", {"join": True}, "K21"),
    ("drive", {"drive": 0}, "K21"), ("n_chunks", {"n_chunks": 2}, "K21"),
    # the fullwidth path (K9) and the K17a / K17b / K17c aggregations are
    # ported: their cases now carry aggregations wider than the kernels'
    # bucket tables (kernels.MAX_AGG_BUCKETS), or of an arity no compile
    # produces
    ("fullwidth", {"fullwidth": True, "carry": ((1, ("fval",)),),
                   "with_aggs": (("histogram", 1, 8192, ()),)}, "K17c"),
    ("carry", {"carry": ((1, ("hi",)),),
               "with_aggs": (("geo_stats", 1, 2),)}, "K17c"),
    # synonym groups and max specs are ported (K13): the cases carry more
    # of them than the kernel's table holds
    ("syn_groups", {"syn_groups": (1,) * 33}, "K13"),
    ("max_specs", {"max_specs": ((1, 2),) * 33}, "K13"),
    # phrases are ported (K14): the case carries a cap beyond the kernel's
    ("phrases", {"phrases": (((0, 1), (0, 1), 0, True),),
                 "cand_cap": 8192}, "K14"),
    # geo leaves are ported (K16): the case carries a cover beyond the
    # kernel's
    ("geo_specs", {"geo_specs": ((1, 2048, 16),)}, "K16"),
    ("with_aggs", {"with_aggs": (("terms", 1, 8192, ()),)}, "K17c"),
    ("emit_sort_keys", {"emit_sort_keys": True}, "K19"),
    ("sort_kind", {"sort": (("bogus", 1, False),)}, "K8"),
    ("sort_k", {"sort": (("value", 1, False),), "k": 100}, "K8"),
]


@pytest.mark.parametrize("change,item", [c[1:] for c in OUTSIDE],
                         ids=[c[0] for c in OUTSIDE])
def test_configs_outside_the_slice_raise(change, item):
    from dataclasses import replace

    from xapiand_tpu_torch.ops.executor import ExecConfig

    cfg = ExecConfig(T=4, L=256, k=10, tree=("G", 0), classes=(256,) * 4)
    check_supported(cfg, BM25())
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        check_supported(replace(cfg, **change), BM25())


# the shapes slice 6 ported: refused before it, admitted now (they run
# against the JAX executor in tests/test_torch_browse.py)
INSIDE = [
    ("dense", {"dense": True, "tree": ("ALL",)}),
    ("dense_join", {"dense": True, "join": True}),
    ("collapse_slot", {"collapse_slot": 1, "collapse_max": 3}),
    ("syn_groups", {"syn_groups": (1,)}),
    ("max_specs", {"max_specs": ((1, 2),)}),
    ("cardinality", {"with_aggs": (("cardinality", 1),)}),
    ("geo_stats", {"carry": ((1, ("hi",)),),
                   "with_aggs": (("geo_stats", 1),)}),
]


@pytest.mark.parametrize("change", [c[1] for c in INSIDE],
                         ids=[c[0] for c in INSIDE])
def test_configs_of_slice_6_are_admitted(change):
    from dataclasses import replace

    from xapiand_tpu_torch.ops.executor import ExecConfig

    cfg = ExecConfig(T=4, L=256, k=10, tree=("G", 0), classes=(256,) * 4)
    check_supported(replace(cfg, **change), BM25())


def test_other_scheme_raises():
    """Every scheme of the JAX package is admitted (K18); a scheme without a
    per-posting formula, the base class, raises when its spec is built."""
    from xapiand_tpu_torch.models.weights import (_SCHEMES, CollectionStats,
                                                  WeightScheme, get_scheme)
    from xapiand_tpu_torch.ops.executor import ExecConfig

    cfg = ExecConfig(T=4, L=256, k=10, tree=("G", 0), classes=(256,) * 4)
    for name in _SCHEMES:
        check_supported(cfg, get_scheme(name))
    with pytest.raises(NotImplementedError):
        WeightScheme().kernel_spec(CollectionStats(10, 5.0))
