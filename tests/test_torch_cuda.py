"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here but the three corpus pins needs a CUDA device and skips
without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
without them:

    python -m pytest --noconftest tests/test_torch_cuda.py

Inputs are the real launch groups of three small synthetic corpora
(BatchSearcher.plan): the relevance corpus in exact and impact-prefix
mode, the faceted corpus (utils/synth_faceted.py) with its four query
families and config 3's aggregations, plus synthetic columns for every
sort key kind, config 2's positional corpus (utils/synth_positional.py)
with its phrase, NEAR and boolean traffic, and config 4's geotagged corpus
(utils/synth_geo.py) with its circle AND window traffic, and the browse
traffic of utils/synth_browse.py over the faceted corpus (dense, synonym,
max and collapse plans, the cardinality and geo_stats aggregations) with
hand-made collapse rows for the edge shapes, and every weight scheme (K18)
over the relevance corpus with real collection frequencies, uniqterms and
stats and over the browse groups. Phrase and geo
verdicts and candidate counts must be equal; under the other schemes
every kernel output must be equal bit for bit. Tolerances: the kernels evaluate the same float32
expressions in the same order as the plain versions (nvcc -fmad=false),
so docids, masks, bits, packed rows, counts and certificates must be equal
and floats agree to rtol 1e-6; the aggregation sums (s, s2) add in
another order than torch.sum and agree to rtol 1e-5, and two kernel runs
give the same bits.
"""

import os

import numpy as np
import pytest
import torch

from xapiand_tpu_torch.aggregations import compile_for_segment
from xapiand_tpu_torch.models.segment import device_segment_from_numpy
from xapiand_tpu_torch.ops import aggs, kernels, phrase
from xapiand_tpu_torch.ops.executor import upper_tree
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_faceted as sf
from xapiand_tpu_torch.utils import synth_geo as sg
from xapiand_tpu_torch.utils import synth_positional as sp
from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                           sample_queries)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    # the kernels' path: no query routed to the native host executors
    monkeypatch.setenv("XT_HOST_PATH", "0")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def groups(cuda):
    seg = build_synthetic_segment(20000, 2000, seed=3)
    qs = sample_queries(seg, 96, 3, seed=5)
    irs = [Q.or_terms(sorted(q, key=lambda t: -seg.terms[t].length))
           for q in qs]
    searcher = SegmentSearcher(seg, device=cuda)
    out = []
    for cap in (0, 512):
        bs = BatchSearcher(searcher, k=10, prefix_cap=cap)
        for cfg, _fn, batch, _chunk in bs.plan(irs):
            out.append((cfg, batch))
    assert any(cfg.prefix for cfg, _ in out)
    return searcher, bs, irs, out


def _inputs(searcher, cfg, batch):
    seg = searcher.device_segment.arrays_pytree()
    prefix = cfg.prefix or (0,) * cfg.T
    widths = tuple(p or c for p, c in zip(prefix, cfg.term_classes()))
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    imp = (seg["imp.docids"], seg["imp.wdf"], seg["imp.doclen"]) \
        if "imp.docids" in seg else None
    params = searcher.scheme.kernel_spec(searcher.segment)
    return post, imp, widths, prefix, params


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)


def test_kernels_match_plain_versions(groups):
    searcher, _bs, _irs, planned = groups
    for cfg, batch in planned:
        post, imp, widths, prefix, params = _inputs(searcher, cfg, batch)
        args = (batch["offsets"], batch["lens"], batch["tconst"],
                batch["scoring"])
        ids, w, tail = kernels.score_slices(post, imp, *args, widths,
                                            prefix, params)
        pids, pw, ptail = kernels._score_slices_plain(
            post, imp, *args, widths, tuple(map(bool, prefix)), params)
        assert torch.equal(ids, pids)
        _close(w, pw)
        _close(tail, ptail)

        sums, owner, count, _ = kernels.merge_docs(ids, w, widths)
        psums, powner, pcount, _ = kernels._merge_docs_plain(ids, w, widths)
        _close(sums, psums)
        assert torch.equal(owner, powner)
        assert torch.equal(count, pcount)

        k = cfg.verify_k + 1 if cfg.verify_k else cfg.k
        d, s = kernels.topk_rows(sums, ids, owner, k)
        pd, ps = kernels._topk_rows_plain(sums, ids, owner, k)
        assert torch.equal(d, pd)
        assert torch.equal(s, ps)

        if cfg.verify_k:
            res = kernels.prefix_certify(post, *args, cfg.term_classes(),
                                         tail, d, s, cfg.k, params)
            pres = kernels._prefix_certify_plain(
                post, *args, cfg.term_classes(), tail, d, s, cfg.k, params)
            assert torch.equal(res[0], pres[0])
            _close(res[1], pres[1])
            assert torch.equal(res[2], pres[2])
    torch.cuda.synchronize()


def test_batch_search_cuda_equals_cpu(groups, cuda):
    searcher, _bs, irs, _planned = groups
    cpu = SegmentSearcher(searcher.segment, device=torch.device("cpu"))
    for cap in (0, 512):
        kernels.reset_launches()
        got = BatchSearcher(searcher, k=10, prefix_cap=cap).run(irs)
        assert kernels.launches["score_slices"] > 0
        want = BatchSearcher(cpu, k=10, prefix_cap=cap).run(irs)
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g["docids"], e["docids"])
            np.testing.assert_allclose(g["scores"], e["scores"], rtol=1e-6)
            assert g["count"] == e["count"]


@pytest.fixture(scope="module")
def faceted(cuda):
    corpus = sf.build_faceted_corpus(30000, seed=7)
    qs = sf.faceted_queries(24, seed=11)
    searcher = SegmentSearcher(corpus.seg, device=cuda)
    _n, specs, arrays, _m = compile_for_segment(sf.SCHEMA, corpus.seg,
                                                sf.CFG3_AGGS)
    sorted_bs = BatchSearcher(searcher, k=10, prefix_cap=8192,
                              sort=sf.PRICE_DESC, aggs=(specs, arrays))
    rel_bs = BatchSearcher(searcher, k=10, prefix_cap=8192,
                           aggs=(specs, arrays))
    fams = [(sorted_bs, [q for f, q, _ in qs if f in "AB"]),
            (rel_bs, [q for f, q, _ in qs if f in "CD"])]
    return corpus, searcher, fams


def _stages(searcher, cfg, batch):
    """Each predicate-path kernel of one launch group against its plain
    version, in execute_batch's order; -> the launch's final rows."""
    seg = searcher.device_segment.arrays_pytree()
    post, imp, widths, prefix, params = _inputs(searcher, cfg, batch)
    assert not any(prefix)
    ids, w, _tail = kernels.score_slices(
        post, None, batch["offsets"], batch["lens"], batch["tconst"],
        batch["scoring"], widths, prefix, params)
    deleted = seg["deleted"] if cfg.has_deletes else None
    bits = batch["group_bits"]
    cap = cfg.compact_cap if 0 < cfg.compact_cap < ids.shape[1] else 0
    prog = kernels.tree_program(cfg.tree)
    mprog = prog
    if cfg.n_filters:
        mprog = kernels.tree_program(upper_tree(cfg.tree)) if cap else None
    got = kernels.merge_docs(ids, w, widths, bits, deleted, mprog, True)
    want = kernels._merge_docs_plain(ids, w, widths, bits, deleted, mprog,
                                     True)
    _close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    sums, mask, count, orbits = got
    if cap and (cfg.n_filters or cfg.sort):
        ob = orbits if cfg.n_filters else None
        got = kernels.compact_rows(mask, ids, sums, ob, cap)
        want = kernels._compact_rows_plain(mask, ids, sums, ob, cap)
        assert int(got[3].max()) <= cap
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        ids, sums, orbits, _n = got
        mask = None if cfg.n_filters else ids != kernels.SENTINEL
    if cfg.n_filters:
        args = (seg["values"], cfg.filter_slots, cfg.filter_vmax,
                batch["fparams"], ids, mask, orbits, prog)
        got = kernels.filter_leaves(*args)
        cols = [seg["values"].get(s) for s in cfg.filter_slots]
        want = kernels._filter_leaves_plain(
            cols, tuple(cfg.filter_vmax), *args[3:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        mask = got[0]
    return ids, sums, mask


def test_faceted_kernels_match_plain_versions(faceted):
    corpus, searcher, fams = faceted
    n_groups = 0
    for bs, irs in fams:
        for cfg, _fn, batch, _chunk in bs.plan(irs):
            n_groups += 1
            ids, sums, elig = _stages(searcher, cfg, batch)
            if cfg.sort:
                got = kernels.sort_topk(cfg.sort, ids, sums, elig, cfg.k,
                                        searcher.device_segment.arrays[
                                            "values"],
                                        batch["sort_targets"])
                want = kernels._sort_topk_plain(
                    cfg.sort, [searcher.device_segment.arrays["values"].get(
                        s[1]) for s in cfg.sort], ids, sums, elig, cfg.k,
                    batch["sort_targets"], {})
            else:
                got = kernels.topk_rows(sums, ids, elig, cfg.k)
                want = kernels._topk_rows_plain(sums, ids, elig, cfg.k)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            # every sort key kind on the same rows
            B = ids.shape[0]
            col, tg, tab = sf.sort_test_inputs(corpus.seg.num_docs, B)
            values = dict(searcher.device_segment.arrays["values"])
            values[sf.SORT_TEST_SLOT] = device_segment_from_numpy(
                col, ids.device)
            targets = torch.from_numpy(tg).to(ids.device)
            strtab = torch.from_numpy(tab).to(ids.device)
            for specs in sf.SORT_TEST_SPECS:
                strtabs = {i: strtab for i, s in enumerate(specs)
                           if s[0] == "strmetric"}
                tgt = targets[:, :len(specs)].contiguous()
                got = kernels.sort_topk(specs, ids, sums, elig, cfg.k,
                                        values, tgt, strtabs)
                want = kernels._sort_topk_plain(
                    specs, [values.get(s[1]) for s in specs], ids, sums,
                    elig, cfg.k, tgt, strtabs)
                assert torch.equal(got[0], want[0]), specs
                assert torch.equal(got[1], want[1]), specs
    assert n_groups >= 4
    torch.cuda.synchronize()


def test_faceted_search_cuda_equals_cpu(faceted):
    corpus, searcher, fams = faceted
    cpu = SegmentSearcher(corpus.seg, device=torch.device("cpu"))
    fw = 0
    for bs, irs in fams:
        kernels.reset_launches()
        got = bs.run(irs)
        assert kernels.launches["merge_docs"] > 0
        assert kernels.launches["prefix_certify"] == 0
        assert kernels.launches["agg_metrics"] > 0
        assert kernels.launches["agg_buckets"] > 0
        fw += kernels.launches["fullwidth_topk"]
        want = BatchSearcher(cpu, k=10, prefix_cap=8192, sort=bs.sort,
                             aggs=(bs.aggs_specs, bs.agg_arrays)).run(irs)
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g["docids"], e["docids"])
            np.testing.assert_allclose(g["scores"], e["scores"], rtol=1e-6)
            assert g["count"] == e["count"]
            _assert_aggs(g["aggs"], e["aggs"])
    assert fw > 0 or os.environ.get("XT_FULLWIDTH") == "0"


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_aggs(got, want, key=""):
    if isinstance(want, dict):
        for k in want:
            _assert_aggs(got[k], want[k], k)
    elif isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _assert_aggs(g, w, key)
    elif key in ("s", "s2"):
        np.testing.assert_allclose(_host(got), _host(want), rtol=1e-5)
    else:
        np.testing.assert_array_equal(_host(got), _host(want))


def _twice(fn):
    """fn() on the card twice: the results, bit for bit the same."""
    a, b = fn(), fn()
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
    return a


def _equal(g, w):
    """Equal tensors, a NaN equal to a NaN: a non-scoring term's weight
    under a scheme that is NaN at its constants of 0 is NaN on both sides,
    as JAX keeps it."""
    if torch.equal(g, w):
        return True
    return g.is_floating_point() and g.shape == w.shape and \
        torch.equal(g.isnan(), w.isnan()) and \
        torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def test_agg_and_fullwidth_kernels_match_plain_versions(faceted):
    """agg_metrics, agg_buckets (every admitted kind) and fullwidth_topk
    (each key kind) on the full-width rows of every faceted launch group,
    against their plain versions; each kernel twice, bit for bit."""
    corpus, searcher, fams = faceted
    values = dict(searcher.device_segment.arrays["values"])
    col, tg, tab = sf.sort_test_inputs(corpus.seg.num_docs, 256)
    values[sf.SORT_TEST_SLOT] = device_segment_from_numpy(
        col, searcher.device)
    P, S, C = sf.PRICE_SLOT, sf.SIZE_SLOT, sf.CAT_SLOT
    subs = (("count", -1), ("avg", P), ("max", S), ("stats", 99))
    specs = ((("count",),) + tuple((m, P) for m in sorted(aggs.METRIC_KINDS))
             + (("stats", S), ("sum", 99), ("terms", C, 64, ()),
                ("terms", C, 4096, subs), ("terms", P, 16, ()),
                ("missing", S, ()), ("missing", 99, subs)))
    n = 0
    for bs, irs in fams:
        for cfg, _fn, batch, _chunk in bs.plan(irs):
            seg = searcher.device_segment.arrays_pytree()
            post, imp, widths, prefix, params = _inputs(searcher, cfg, batch)
            ids, w, _ = kernels.score_slices(
                post, None, batch["offsets"], batch["lens"], batch["tconst"],
                batch["scoring"], widths, prefix, params)
            sums, elig, _c, _o = kernels.merge_docs(
                ids, w, widths, batch["group_bits"], seg["deleted"],
                kernels.tree_program(upper_tree(cfg.tree)))
            got = _twice(lambda: aggs.compute_aggs({"values": values},
                                                   specs, ids, elig))
            want = aggs.compute_aggs(
                {"values": {k: {c: t.cpu() for c, t in v.items()}
                            for k, v in values.items()}}, specs, ids.cpu(),
                elig.cpu())
            _assert_aggs(got, want)
            B = ids.shape[0]
            for spec in [("value", P, True), ("value", S, False),
                         ("dist", sf.SORT_TEST_SLOT, False),
                         ("geodist", sf.SORT_TEST_SLOT, True),
                         ("strmetric", sf.SORT_TEST_SLOT, False, 64),
                         ("dist", sf.SORT_TEST_SLOT, True)]:
                tgt = torch.from_numpy(tg[:B, :1].copy()).to(ids.device)
                st = {0: torch.from_numpy(tab[:B]).to(ids.device)} \
                    if spec[0] == "strmetric" else None
                args = (spec, ids, sums, elig, 10, values, tgt, st)
                gd, gs, gc = _twice(lambda: kernels.fullwidth_topk(*args))
                pd, ps, pc = kernels.fullwidth_topk(
                    spec, ids.cpu(), sums.cpu(), elig.cpu(), 10,
                    {k: {c: t.cpu() for c, t in v.items()}
                     for k, v in values.items()}, tgt.cpu(),
                    {0: st[0].cpu()} if st else None)
                assert torch.equal(gc.cpu(), pc), spec
                assert torch.equal(gd.cpu(), pd), spec
                assert torch.equal(gs.cpu(), ps), spec
            n += 1
    assert n >= 4
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def positional(cuda):
    corpus = sp.build_corpus2(20000, seed=7)
    qs = sp.queries2(corpus, n_each=64, n_three=32, seed=11)
    irs = [q for _f, q, _w in qs]
    # two 3-word phrases of the two commonest words: more candidates than
    # the cap, which the kernel must cut where the plain version does
    irs += [Q.phrase(("w0", "w1", "w0")), Q.phrase(("w1", "w0", "w0")),
            Q.and_not(Q.phrase(("w0", "w1")), Q.or_terms(["w2"]))]
    return corpus, SegmentSearcher(corpus.seg, device=cuda), irs


def test_phrase_kernel_matches_plain_version(positional):
    """phrase_leaves on every phrase launch group of config 2's traffic
    (and of the cap-hitting phrases) against its plain version: verdict
    words and candidate counts equal, bit for bit twice; then the tree in
    filter_leaves over them."""
    corpus, searcher, irs = positional
    seg = searcher.device_segment.arrays_pytree()
    n = hit_cap = 0
    for cfg, _fn, batch, _chunk in BatchSearcher(searcher, k=10).plan(irs):
        if not cfg.phrases:
            continue
        post, imp, widths, prefix, params = _inputs(searcher, cfg, batch)
        ids, w, _ = kernels.score_slices(
            post, None, batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, prefix, params)
        sums, first, _c, orbits = kernels.merge_docs(
            ids, w, widths, batch["group_bits"], None, None, True)
        args = (ids, widths, batch["offsets"], batch["lens"], orbits, first,
                seg["post_posoff"], seg["post_poslen"], seg["positions"],
                cfg.phrases, cfg.cand_cap, cfg.pmax)
        got = _twice(lambda: phrase.phrase_leaves(*args))
        want = phrase._phrase_leaves_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        hit_cap += int((got[1] == cfg.cand_cap).sum())
        B = ids.shape[0]
        fargs = (seg["values"], (), (), ids.new_empty((B, 0, 4)), ids, first,
                 orbits, kernels.tree_program(cfg.tree), got[0])
        el = kernels.filter_leaves(*fargs)
        pel = kernels._filter_leaves_plain([], (), *fargs[3:])
        assert torch.equal(el[0], pel[0]) and torch.equal(el[1], pel[1])
        n += 1
    assert n >= 3 and hit_cap > 0
    torch.cuda.synchronize()


def test_phrase_search_cuda_equals_cpu(positional):
    corpus, searcher, irs = positional
    cpu = SegmentSearcher(corpus.seg, device=torch.device("cpu"))
    kernels.reset_launches()
    got = BatchSearcher(searcher, k=10).run(irs)
    assert kernels.launches["phrase_leaves"] > 0
    want = BatchSearcher(cpu, k=10).run(irs)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g["docids"], e["docids"])
        np.testing.assert_allclose(g["scores"], e["scores"], rtol=1e-6)
        assert g["count"] == e["count"]


def test_positional_corpus_is_pinned():
    """Config 2's corpus and queries come out the same wherever the file
    runs (Python's random, draw for draw as scripts/config_bench.py).
    Needs no card."""
    c = sp.build_corpus2(20000, seed=7)
    assert sp.fingerprint(c) == {"sha256": "bc07b7cc47c245f7",
                                 "postings": 597844, "positions": 800000,
                                 "terms": 5000}
    qs = sp.queries2(c, n_each=8, n_three=4, seed=11)
    assert [w for _f, _q, w in qs][::4] == [
        ("w17", "w124"), ("w1391", "w393"), ("not", "w1308", "w4172",
                                             "w4723"),
        ("or", "w2483", "w789", "w2793"), ("w43", "w117", "w82"),
        ("w43", "w82")]


def test_faceted_corpus_is_pinned():
    """The faceted corpus and queries come out the same under any numpy
    release (PCG64 draws through searchsorted): this hash was taken under
    numpy 2.0.2 and must hold wherever the file runs, the card's machine
    included. Needs no card."""
    c = sf.build_faceted_corpus(20000, seed=7)
    fp = sf.fingerprint(c)
    assert (fp["sha256"], fp["postings"], fp["values"], fp["deleted"]) == \
        ("4c48234d729a2984", 228180, 59941, 208), fp
    assert fp["cat_sha256"] == "2fe78ffbc7e13db9", fp
    qs = sf.faceted_queries(8, seed=11)
    assert [p for _f, _q, p in qs][::8] == [
        {"cat": 2, "w": 190}, {"cat": 13, "w": 71, "p": 75},
        {"w": 6, "s": 37}, {"a": 62, "b": 148, "cat": 1}]


@pytest.fixture(scope="module")
def geo(cuda):
    corpus = sg.build_corpus4(20000, seed=7)
    qs = sg.queries4(64, 32)
    irs = [q for _f, q, _p in qs]
    # two leaves a query, one negated, and an empty cover
    c0, c1 = irs[0].children[0], irs[1].children[0]
    irs += [Q.and_(Q.or_(c0, c1), irs[2].children[1]),
            Q.and_not(irs[3].children[1], c0),
            Q.and_(Q.geo(sg.LOC_SLOT, ()), irs[4].children[1])]
    return corpus, SegmentSearcher(corpus.seg, device=cuda), irs


def test_geo_kernel_matches_plain_version(geo):
    """geo_leaves on every launch group of config 4's traffic against its
    plain version, over the rows execute_batch gives it (packed rows where
    a group precompacts): verdict words equal, bit for bit twice; then the
    tree in filter_leaves over them."""
    corpus, searcher, irs = geo
    seg = searcher.device_segment.arrays_pytree()
    n = n_true = 0
    for cfg, _fn, batch, _chunk in BatchSearcher(searcher, k=10).plan(irs):
        post, _imp, widths, prefix, params = _inputs(searcher, cfg, batch)
        ids, w, _ = kernels.score_slices(
            post, None, batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, prefix, params)
        cap = cfg.compact_cap if 0 < cfg.compact_cap < ids.shape[1] else 0
        mprog = kernels.tree_program(upper_tree(cfg.tree)) if cap else None
        sums, first, _c, orbits = kernels.merge_docs(
            ids, w, widths, batch["group_bits"], None, mprog, True)
        if cap:
            ids, sums, orbits, _n = kernels.compact_rows(first, ids, sums,
                                                         orbits, cap)
            first = None
        args = ([seg["geo"][s] for s, _qr, _rm in cfg.geo_specs],
                cfg.geo_specs, batch["geo_queries"], ids, first)
        got = _twice(lambda: kernels.geo_leaves(*args))
        assert torch.equal(got, kernels._geo_leaves_plain(*args))
        n_true += int((got != 0).sum())
        B = ids.shape[0]
        fp = batch["fparams"] if cfg.n_filters else ids.new_empty((B, 0, 4))
        fargs = (seg["values"], cfg.filter_slots, cfg.filter_vmax, fp, ids,
                 first, orbits, kernels.tree_program(cfg.tree), None, got)
        el = kernels.filter_leaves(*fargs)
        pel = kernels._filter_leaves_plain(
            [seg["values"].get(s) for s in cfg.filter_slots],
            tuple(cfg.filter_vmax), *fargs[3:])
        assert torch.equal(el[0], pel[0]) and torch.equal(el[1], pel[1])
        n += 1
    assert n >= 2 and n_true > 0
    torch.cuda.synchronize()


def test_geo_search_cuda_equals_cpu(geo):
    corpus, searcher, irs = geo
    cpu = SegmentSearcher(corpus.seg, device=torch.device("cpu"))
    kernels.reset_launches()
    got = BatchSearcher(searcher, k=10).run(irs)
    assert kernels.launches["geo_leaves"] > 0
    want = BatchSearcher(cpu, k=10).run(irs)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g["docids"], e["docids"])
        np.testing.assert_array_equal(g["scores"], e["scores"])
        assert g["count"] == e["count"]
    assert sum(g["count"] for g in got) > 0


def test_geo_corpus_is_pinned():
    """Config 4's corpus and queries come out the same wherever the file
    runs (Python's random, draw for draw as scripts/config_bench.py, and
    the native HTM cover). Needs no card."""
    c = sg.build_corpus4(20000, seed=7)
    assert sg.fingerprint(c) == {"sha256": "d1213921c5975743",
                                 "postings": 1516275, "terms": 1099915,
                                 "geo_ranges": 44043, "max_doc_ranges": 6}
    qs = sg.queries4(4, 2)
    assert [(f, round(p["radius"], 3), p["lo"], p["hi"],
             len(q.children[0].geo_ranges), len(q.children[0].cover_terms))
            for f, q, p in qs] == [
        ("P", 377263.175, "2024-08-01T00:00:00", "2024-11-01T00:00:00", 452,
         17),
        ("P", 156970.609, "2024-09-01T00:00:00", "2024-12-01T00:00:00", 166,
         4),
        ("P", 155852.106, "2024-08-01T00:00:00", "2024-11-01T00:00:00", 188,
         3),
        ("P", 342893.36, "2024-01-01T00:00:00", "2024-04-01T00:00:00", 436,
         14),
        ("T", 299923.141, "2024-03-13T00:00:00", "2024-03-14T00:00:00", 355,
         16),
        ("T", 293022.625, "2024-08-23T00:00:00", "2024-08-26T00:00:00", 309,
         6)]


# ---------------------------------------------------------------------------
# slice 6: collapse_rows, dense_rows, merge_special, agg_distinct
# ---------------------------------------------------------------------------

def _cpu_col(col):
    return {c: t.cpu() for c, t in col.items()}


def _collapse_case(rng, B, R, n_docs, n_keys, absent, elig_p):
    ids = np.stack([np.sort(rng.choice(n_docs, R, replace=False))
                    for _ in range(B)]).astype(np.int32)
    sums = (rng.integers(1, 7, (B, R)) / 4).astype(np.float32)
    elig = rng.random((B, R)) < elig_p
    ids[:, -7:] = kernels.SENTINEL
    elig[:, -7:] = False
    key = rng.integers(0, n_keys, n_docs + 1)
    col = {"hi": (key // 3 - 2).astype(np.int32),
           "lo": (key % 3 - 1).astype(np.int32),
           "present": rng.random(n_docs + 1) >= absent}
    return ids, sums, elig, col


@pytest.mark.parametrize("case", ["keys", "one_key", "empty_query",
                                  "all_ones_key", "no_column"])
def test_collapse_rows_matches_plain_version(cuda, case):
    """collapse_rows (keep and tie ranks) and the tie-ranked topk_rows
    against their plain versions: categorical keys with ties within and
    across keys (negative words among them), all rows one key, a query
    with no eligible row, the key of all ones (the table's empty mark), a
    slot the segment lacks; collapse_max 1, 3, 8 and 9 (capped at 8)."""
    rng = np.random.Generator(np.random.PCG64(41))
    ids, sums, elig, col = _collapse_case(
        rng, 3, 3000, 9000, 1 if case == "one_key" else 23,
        0.0 if case == "one_key" else 0.15, 0.8)
    if case == "empty_query":
        elig[1] = False
    if case == "all_ones_key":
        col["hi"][::3] = -1
        col["lo"][::3] = -1
    dcol = None if case == "no_column" else \
        {c: torch.from_numpy(v).to(cuda) for c, v in col.items()}
    args = tuple(torch.from_numpy(x).to(cuda) for x in (ids, sums, elig))
    for cmax in (1, 3, 8, 9):
        keep, tie = _twice(lambda: kernels.collapse_rows(*args, dcol, cmax))
        pkeep, ptie = kernels.collapse_rows(
            *(x.cpu() for x in args),
            None if dcol is None else _cpu_col(dcol), cmax)
        assert torch.equal(keep.cpu(), pkeep), (case, cmax)
        assert torch.equal(tie.cpu(), ptie), (case, cmax)
        d, s = _twice(lambda: kernels.topk_rows(args[1], args[0], keep, 10,
                                                tie))
        pd, ps = kernels._topk_rows_plain(args[1], args[0], keep, 10, tie)
        assert torch.equal(d, pd) and torch.equal(s, ps), (case, cmax)
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def browse(faceted):
    from xapiand_tpu_torch.utils import synth_browse as sb

    corpus, searcher, _fams = faceted
    qs = sb.browse_queries(24, 16, 24, 24, 32, seed=11)
    _n, specs, arrays, _m = compile_for_segment(sf.SCHEMA, corpus.seg,
                                                sb.BROWSE_AGGS)
    return corpus, searcher, qs, (specs, arrays)


def _plans(searcher, qs, fams, **kw):
    bs = BatchSearcher(searcher, k=10, min_batch=8, **kw)
    return bs.plan([q for f, q, _p in qs if f in fams])


def test_dense_rows_matches_plain_version(browse):
    """dense_rows on the M groups (no term: T = 0 searches nothing) and
    the N groups (term masks; docs that every term holds among them),
    against its plain version, twice bit for bit."""
    _corpus, searcher, qs, aggs_ = browse
    seg = searcher.device_segment.arrays_pytree()
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    params = searcher.scheme.kernel_spec(searcher.segment)
    n_terms = set()
    for cfg, _fn, batch, _chunk in \
            _plans(searcher, qs, "M", sort=sf.PRICE_DESC, aggs=aggs_) + \
            _plans(searcher, qs, "N"):
        assert cfg.dense
        args = (post, batch["offsets"], batch["lens"], batch["tconst"],
                batch["scoring"], batch["group_bits"], cfg.term_classes(),
                seg["deleted"], params)
        got = _twice(lambda: kernels.dense_rows(*args))
        want = kernels._dense_rows_plain(*args)
        for g, w, name in zip(got, want, ("ids", "scores", "orbits", "live")):
            if name == "scores":
                _close(g, w)
            else:
                assert torch.equal(g, w), name
        real = int((batch["lens"] > 0).sum(1).max())
        n_terms.add(real)
        if real > 1:
            # a doc in every term: its orbits hold every term's bit
            every = batch["group_bits"][0].unique().sum()
            assert bool((got[2][0] == every).any())
        else:
            assert not bool(got[1].any()) and not bool(got[2].any())
    assert 0 in n_terms and max(n_terms) >= 2
    torch.cuda.synchronize()


def test_merge_special_matches_plain_version(browse):
    """merge_special on the S (synonym) and X (max) groups' rows against
    its plain version, twice bit for bit."""
    _corpus, searcher, qs, _aggs = browse
    seg = searcher.device_segment.arrays_pytree()
    seen = set()
    for cfg, _fn, batch, _chunk in _plans(searcher, qs, "SX"):
        post, _imp, widths, prefix, params = _inputs(searcher, cfg, batch)
        ids, w, _ = kernels.score_slices(
            post, None, batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, prefix, params)
        args = (ids, w, widths, batch["group_bits"], batch["offsets"],
                seg["post_wdf"], seg["post_doclen"], cfg.max_specs,
                cfg.syn_groups, batch.get("syn_tconst"), params)
        got = _twice(lambda: kernels.merge_special(*args))
        _close(got, kernels._merge_special_plain(*args))
        assert bool((got > 0).any())
        seen.add((bool(cfg.max_specs), bool(cfg.syn_groups)))
    assert seen == {(True, False), (False, True)}
    torch.cuda.synchronize()


def test_agg_distinct_matches_plain_version(browse):
    """agg_distinct (the exact count and the 1024 registers) over a dense
    group's rows for the multi-value size, the price, the category and a
    slot the segment lacks, with a query without a match among them; and
    geo_stats through compute_aggs on a column with and without fval2."""
    corpus, searcher, qs, aggs_ = browse
    seg = searcher.device_segment.arrays_pytree()
    values = dict(seg["values"])
    col, _tg, _tab = sf.sort_test_inputs(corpus.seg.num_docs, 1)
    values[sf.SORT_TEST_SLOT] = device_segment_from_numpy(col,
                                                          searcher.device)
    cfg, _fn, batch, _chunk = _plans(searcher, qs, "M", sort=sf.PRICE_DESC,
                                     aggs=aggs_)[0]
    ids, _s, orbits, live = kernels.dense_rows(
        (seg["post_docids"], seg["post_wdf"], seg["post_doclen"]),
        batch["offsets"], batch["lens"], batch["tconst"], batch["scoring"],
        batch["group_bits"], cfg.term_classes(), seg["deleted"],
        searcher.scheme.kernel_spec(searcher.segment))
    elig, _count = kernels.filter_leaves(
        values, cfg.filter_slots, cfg.filter_vmax, batch["fparams"], ids,
        live, orbits, kernels.tree_program(cfg.tree))
    elig[1] = False            # an empty query
    for slot in (sf.SIZE_SLOT, sf.PRICE_SLOT, sf.CAT_SLOT,
                 sf.SORT_TEST_SLOT, None):
        c = values[slot] if slot is not None else \
            kernels.absent_column(ids.device)
        n, regs = _twice(lambda: kernels.agg_distinct(ids, elig, c))
        pn, pregs = kernels._agg_distinct_plain(ids, elig, c)
        assert torch.equal(n, pn) and torch.equal(regs, pregs), slot
        assert int(n[1]) == 0 and not bool(regs[1].any())
        assert slot is None or int(n[0]) > 0
    specs = (("geo_stats", sf.SORT_TEST_SLOT), ("geo_stats", sf.PRICE_SLOT),
             ("geo_stats", 99), ("cardinality", sf.SIZE_SLOT))
    assert "fval2" not in values[sf.PRICE_SLOT]
    got = _twice(lambda: aggs.compute_aggs({"values": values}, specs, ids,
                                           elig))
    want = aggs.compute_aggs(
        {"values": {k: _cpu_col(v) for k, v in values.items()}}, specs,
        ids.cpu(), elig.cpu())
    for g, w in zip(got, want):
        for key in w:
            if key in ("slat", "slon"):
                np.testing.assert_allclose(_host(g[key]), _host(w[key]),
                                           rtol=1e-5)
            else:
                np.testing.assert_array_equal(_host(g[key]), _host(w[key]))
    assert not bool(got[1]["slon"].any())     # no fval2: longitude 0
    torch.cuda.synchronize()


def test_browse_search_cuda_equals_cpu(browse):
    """The browse families end to end, card against CPU: M, N, S, X
    through BatchSearcher.run, C through SegmentSearcher.execute with its
    collapse."""
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.query.plan import bind, compile_ir

    corpus, searcher, qs, aggs_ = browse
    seg = corpus.seg
    cpu = SegmentSearcher(seg, device=torch.device("cpu"))
    kernels.reset_launches()
    for fams, kw in (("M", {"sort": sf.PRICE_DESC, "aggs": aggs_}),
                     ("NSX", {})):
        irs = [q for f, q, _p in qs if f in fams]
        got = BatchSearcher(searcher, k=10, min_batch=8, **kw).run(irs)
        want = BatchSearcher(cpu, k=10, min_batch=8, **kw).run(irs)
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g["docids"], e["docids"])
            np.testing.assert_allclose(g["scores"], e["scores"], rtol=1e-6)
            assert g["count"] == e["count"]
            if "aggs" in e:
                _assert_aggs(g["aggs"], e["aggs"])
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    stats_d = {"N": float(seg.doc_count), "avg_doclen": float(seg.avg_doclen)}
    for _f, q, p in (x for x in qs if x[0] == "C"):
        bound = bind(compile_ir(q), seg, searcher.scheme, stats, k=10,
                     sort=sf.PRICE_DESC if p["sorted"] else (),
                     collapse_slot=sf.CAT_SLOT,
                     collapse_max=p["collapse_max"])
        g, e = searcher.execute(bound, stats_d), cpu.execute(bound, stats_d)
        np.testing.assert_array_equal(g["docids"], e["docids"])
        np.testing.assert_allclose(g["scores"], e["scores"], rtol=1e-6)
        assert int(g["count"]) == int(e["count"])
    for name in ("collapse_rows", "dense_rows", "merge_special",
                 "agg_distinct"):
        assert kernels.launches[name] > 0, name


# ---------------------------------------------------------------------------
# K18: every weight scheme through score_slices, prefix_certify, dense_rows
# and merge_special, bit for bit
# ---------------------------------------------------------------------------

def _scheme_ids():
    from xapiand_tpu_torch.utils import synth_schemes as ss

    return [c[0] for c in ss.SCHEME_CONFIGS]


@pytest.fixture(scope="module")
def scheme_world(cuda):
    """The relevance corpus with real collection frequencies, uniqterms and
    stats, its ORs and four with a frequent term."""
    from xapiand_tpu_torch.utils import synth_schemes as ss

    seg = build_synthetic_segment(20000, 2000, seed=3)
    ss.real_collfreq(seg)
    seg.uniqterms = ss.uniqterms(seg)
    qs = sample_queries(seg, 60, 3, seed=5)
    qs += [[f"t{i}", *q[:2]] for i, q in enumerate(qs[:4])]
    return SegmentSearcher(seg, device=cuda), qs, ss.real_stats(seg)


def _config(label):
    from xapiand_tpu_torch.utils import synth_schemes as ss

    return ss.make(dict((c[0], c) for c in ss.SCHEME_CONFIGS)[label])


@pytest.mark.parametrize("label", _scheme_ids())
def test_scheme_slices_and_certify_match_plain_versions(scheme_world, label):
    """score_slices under every scheme (tconst [B, T, C], uniqterms where
    read), and prefix_certify under BM25 and BM25Plus (prefix mode),
    equal to their plain versions bit for bit, twice."""
    searcher, qs, st = scheme_world
    scheme = _config(label)
    seg = searcher.device_segment
    spec = scheme.kernel_spec(st)
    uniq = seg.arrays["uniqterms"] if spec.needs_uniq else None
    irs = [Q.or_terms(q) for q in qs]
    n_prefix = nonzero = 0
    for cap in (0, 512):
        bs = BatchSearcher(searcher, k=10, prefix_cap=cap, scheme=scheme)
        for cfg, _fn, batch, _chunk in bs.plan(irs, stats=st):
            post, imp, widths, prefix, _p = _inputs(searcher, cfg, batch)
            args = (batch["offsets"], batch["lens"], batch["tconst"],
                    batch["scoring"])
            assert batch["tconst"].dim() == (2 if scheme.n_constants == 1
                                             else 3)
            got = _twice(lambda: kernels.score_slices(
                post, imp, *args, widths, prefix, spec, uniq))
            want = kernels._score_slices_plain(
                post, imp, *args, widths, tuple(map(bool, prefix)), spec,
                uniq)
            for g, w in zip(got, want):
                assert _equal(g, w)
            nonzero += int((got[1].nan_to_num(0.0) != 0).sum())
            if cfg.verify_k:
                n_prefix += 1
                ids, w, tail = got
                sums, owner, _c, _o = kernels.merge_docs(ids, w, widths)
                d, s = kernels.topk_rows(sums, ids, owner, cfg.verify_k + 1)
                res = _twice(lambda: kernels.prefix_certify(
                    post, *args, cfg.term_classes(), tail, d, s, cfg.k,
                    spec))
                pres = kernels._prefix_certify_plain(
                    post, *args, cfg.term_classes(), tail, d, s, cfg.k, spec)
                for g, w in zip(res, pres):
                    assert _equal(g, w)
    assert (n_prefix > 0) == (label in ("bm25", "bm25plus"))
    assert (nonzero > 0) == (label != "bool")
    torch.cuda.synchronize()


@pytest.mark.parametrize("label", ["tfidf", "pl2", "dicecoeff",
                                   "lm-absolute_discount", "bb2", "dph"])
def test_scheme_dense_and_special_match_plain_versions(browse, label):
    """dense_rows on the N groups and on scored dense groups (D:
    AND_MAYBE(match_all, OR(w, w)) on N's words; N's right side scores
    nothing) and merge_special on the S and X groups under a scheme, with
    the corpus' uniqterms, bit for bit, twice; D's scores are not all 0."""
    from xapiand_tpu_torch.utils import synth_schemes as ss

    corpus, searcher, qs, _aggs = browse
    qs = qs + [("D", Q.and_maybe(Q.match_all(),
                                 Q.or_terms([f"w{i}" for i in p["w"]])), p)
               for f, _q, p in qs if f == "N"]
    scheme = _config(label)
    st = ss.real_stats(corpus.seg)
    spec = scheme.kernel_spec(st)
    seg = searcher.device_segment.arrays_pytree()
    uniq = torch.from_numpy(ss.uniqterms(corpus.seg)).to(searcher.device) \
        if spec.needs_uniq else None
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    seen = set()
    for cfg, _fn, batch, _chunk in _plans(searcher, qs, "NDSX",
                                          scheme=scheme):
        if cfg.dense:
            args = (post, batch["offsets"], batch["lens"], batch["tconst"],
                    batch["scoring"], batch["group_bits"],
                    cfg.term_classes(), seg["deleted"], spec, uniq)
            got = _twice(lambda: kernels.dense_rows(*args))
            for g, w in zip(got, kernels._dense_rows_plain(*args)):
                assert _equal(g, w)
            scored = bool(batch["scoring"].any())
            assert bool((got[1].nan_to_num(0.0) != 0).any()) == scored
            seen.add("dense scored" if scored else "dense")
            continue
        _p, _i, widths, prefix, _s = _inputs(searcher, cfg, batch)
        ids, w, _ = kernels.score_slices(
            post, None, batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, prefix, spec, uniq)
        args = (ids, w, widths, batch["group_bits"], batch["offsets"],
                seg["post_wdf"], seg["post_doclen"], cfg.max_specs,
                cfg.syn_groups, batch.get("syn_tconst"), spec, uniq)
        got = _twice(lambda: kernels.merge_special(*args))
        assert _equal(got, kernels._merge_special_plain(*args))
        assert bool((got > 0).any())
        seen.add("syn" if cfg.syn_groups else "max")
    assert seen == {"dense", "dense scored", "syn", "max"}
    torch.cuda.synchronize()


@pytest.mark.parametrize("label", ["bm25plus", "pl2", "dicecoeff",
                                   "lm-absolute_discount", "bb2"])
def test_scheme_search_cuda_matches_oracle(scheme_world, label):
    """BatchSearcher.run on the card under a scheme, held to the float64
    oracle of utils/synth_schemes.py (BM25Plus in prefix mode, its
    uncertified queries re-run exactly)."""
    from xapiand_tpu_torch.utils import synth_schemes as ss

    searcher, qs, st = scheme_world
    scheme = _config(label)
    cap = 512 if label == "bm25plus" else 0
    bs = BatchSearcher(searcher, k=10, prefix_cap=cap, scheme=scheme)
    kernels.reset_launches()
    got = bs.run([Q.or_terms(q) for q in qs], stats=st)
    assert kernels.launches["score_slices"] > 0
    uniq = ss.uniqterms(searcher.segment)
    oracle = ss.relevance_answers(searcher.segment, qs, scheme, st, uniq)
    imp = searcher.segment.impact_arrays(scheme, st)[0] if cap else None
    prefix = {}
    if cap:
        for cfg, _fn, _b, chunk in bs.plan([Q.or_terms(q) for q in qs],
                                           stats=st):
            for qi in chunk:
                prefix[qi] = cfg.prefix
    for qi, (r, o) in enumerate(zip(got, oracle)):
        n = None
        if cap and qi not in bs.reran and any(prefix[qi]):
            n = ss.prefix_count(searcher.segment, imp, qs[qi], prefix[qi])
        err = ss.match_ranked(r["docids"], r["scores"], r["count"], o, 10, n)
        assert err is None, (qi, err)


# --------------------------------------------------------------------------
# K17c: the Database's aggregation kernels (agg_buckets' code modes,
# agg_ranges, agg_hist, agg_filter) on the launches of real searches
# --------------------------------------------------------------------------

K17C = ("agg_buckets", "agg_ranges", "agg_hist", "agg_filter")


@pytest.fixture(scope="module")
def database(cuda):
    """The bank / netlog corpus of utils/synth_docs.py in two commits, once
    on the card and once on the CPU, and its traffic (two searches a
    family)."""
    from xapiand_tpu_torch.database import Database
    from xapiand_tpu_torch.utils import synth_docs as sd

    corpus = sd.build_corpus(3000, seed=7)
    dbs = []
    for dev in (cuda, torch.device("cpu")):
        db = Database(device=dev)
        for i in range(3000):
            db.index_document(corpus.doc(i), doc_id=str(i))
            if i == 1499:
                db.commit()
        db.commit()
        for i in range(0, 3000, 97):
            db.delete_document(str(i))
        db.commit()
        dbs.append(db)
    qs, terms = sd.queries(corpus, n_each=2, n_terms=8)
    return dbs, qs, terms


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _calls(db, qs, names):
    """Every call the searches make to the named kernel wrappers."""
    saved = {n: getattr(kernels, n) for n in names}
    calls = []

    def wrap(name, fn):
        def f(*a, **kw):
            calls.append((name, fn, a, kw))
            return fn(*a, **kw)
        return f

    for n, fn in saved.items():
        setattr(kernels, n, wrap(n, fn))
    try:
        for _fam, q, aggs_, count_only in qs:
            db.search(q, k=10, aggs=aggs_, count_only=count_only)
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)
    return calls


def test_k17c_kernels_match_plain_versions(database):
    """Each K17c launch of the Database's searches against its plain
    version on the same inputs: counts, codes, member matrices, masks and
    histograms equal, n / min / max equal and the sums within rtol 1e-5;
    two kernel runs bit for bit."""
    (gdb, _cdb), qs, _terms = database
    calls = _calls(gdb, qs, K17C)
    assert {n for n, *_x in calls} == set(K17C)
    for name, fn, a, kw in calls:
        got = _twice(lambda: fn(*a, **kw))
        want = fn(*_to_cpu(a), **_to_cpu(kw))
        if name in ("agg_hist", "agg_filter"):
            assert torch.equal(got.cpu(), want), name
            continue
        assert torch.equal(got[0].cpu(), want[0]), name
        if got[1] is not None:
            for st, (g, w) in enumerate(zip(got[1], want[1])):
                if st in (1, 2):
                    np.testing.assert_allclose(_host(g), _host(w),
                                               rtol=1e-5)
                else:
                    assert torch.equal(g.cpu(), w), (name, st)
        if len(got) > 2:
            assert torch.equal(got[2].cpu(), want[2]), name


def test_database_search_cuda_equals_cpu(database):
    """The same searches through the Database on the card and on the CPU
    (plain versions): equal totals and hits, the shaped aggregations
    equal (sums within synth_docs.SUM_RTOL)."""
    from xapiand_tpu_torch.utils import synth_docs as sd

    (gdb, cdb), qs, terms = database
    for _fam, q, aggs_, count_only in qs:
        g = gdb.search(q, k=10, aggs=aggs_, count_only=count_only)
        c = cdb.search(q, k=10, aggs=aggs_, count_only=count_only)
        assert g.total == c.total
        assert [h.id for h in g.hits] == [h.id for h in c.hits]
        assert sd.compare_aggs(g.aggregations, c.aggregations) is None
    for q in terms:
        assert [(h.id, h.score) for h in gdb.search(q, k=10).hits] == \
            [(h.id, h.score) for h in cdb.search(q, k=10).hits]
