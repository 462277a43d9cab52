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

import contextlib
import os

import numpy as np
import pytest
import torch

from xapiand_tpu_torch.aggregations import compile_for_segment
from xapiand_tpu_torch.models.segment import (device_segment_from_numpy,
                                              value_arrays)
from xapiand_tpu_torch.ops import aggs, kernels, phrase
from xapiand_tpu_torch.ops.executor import upper_tree
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_faceted as sf
from xapiand_tpu_torch.utils import synth_geo as sg
from xapiand_tpu_torch.utils import synth_positional as sp
from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                           sample_queries)
from xapiand_tpu_torch.utils.synth_schemes import SCHEME_CONFIGS

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
    n_docs = searcher.device_segment.arrays["deleted"].shape[0]
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

        sums, owner, count, _ = kernels.merge_docs(ids, w, widths,
                                                   n_docs=n_docs)
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
    got = kernels.merge_docs(ids, w, widths, bits, deleted, mprog, True,
                             n_docs=seg["deleted"].shape[0])
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
                kernels.tree_program(upper_tree(cfg.tree)),
                n_docs=seg["deleted"].shape[0])
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
            ids, w, widths, batch["group_bits"], None, None, True,
            n_docs=seg["deleted"].shape[0])
        args = (ids, widths, batch["offsets"], batch["lens"], orbits, first,
                seg["post_posoff"], seg["post_poslen"], seg["positions"],
                cfg.phrases, cfg.cand_cap, cfg.pmax)
        # merge_docs applied no deleted flags; its group bits as the
        # executor passes them
        kw = {"deleted": None, "bits": batch["group_bits"]}
        got = _twice(lambda: phrase.phrase_leaves(*args, **kw))
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


@pytest.fixture(scope="module")
def leaves_world(cuda):
    import test_torch_leaves_design as ld

    _corpus, searcher, irs = ld.positional_world(cuda)
    return {k: ld.phrase_args(searcher, ir) for k, ir in irs.items()}


@pytest.mark.parametrize("case", ["common", "apart", "repeated", "near1",
                                  "near5", "zero", "long", "or_group"])
def test_phrase_leaves_edge_cases_match_plain_version(leaves_world, case):
    """The edge shapes of tests/test_torch_leaves_design.py on the card,
    deleted docs and phrases with no candidate among them: the common
    phrase with the cap inside the first 1,024-row tile, in the middle of
    a later one and never reached. Verdict words and candidate counts
    equal the plain version's, bit for bit twice."""
    import test_torch_leaves_design as ld

    args, kw, _cfg = leaves_world[case]
    assert kw["deleted"] is not None
    caps = [args[10]]
    if case == "common":
        _p, _n, info = ld.emulate_phrase_leaves(
            ld.with_cap(args, 1 << 30), kw, verify=False)
        at = info[(0, 0)][1]
        last = int(at[-1]) // ld.PH_TILE
        assert last >= 1
        inside = at[at >= last * ld.PH_TILE]
        caps = [max(1, int((at < ld.PH_TILE).sum()) // 2),
                int((at < last * ld.PH_TILE).sum()) + len(inside) // 2,
                len(at) + 5]
    n = 0
    for cap in caps:
        a = ld.with_cap(args, cap)
        want = phrase._phrase_leaves_plain(*a)
        got = _twice(lambda: phrase.phrase_leaves(*a, **kw))
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        n += int(want[1].sum())
    assert (n == 0) == (case in ("zero", "apart"))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["qr1", "qr1024", "all_real", "past_rmax",
                                  "no_base", "wide"])
def test_geo_leaves_edge_cases_match_plain_version(cuda, case):
    """geo_leaves on tests/test_torch_leaves_design.py's synthetic columns
    and covers: a cover of one range and of 1,024, INT32_MAX pads and
    none, ranges touching a cover range's ends, re = INT32_MAX, docs past
    RMAX ranges, packed rows (no base), a launch of several row tiles.
    Verdicts equal the plain version's, bit for bit twice."""
    import test_torch_leaves_design as ld

    kw = {"qr1": {"QR": 1, "n_real": 1}, "qr1024": {"QR": 1024},
          "all_real": {"QR": 64, "n_real": 64},
          "past_rmax": {"RMAX": 4, "max_ranges": 12},
          "no_base": {"base": False},
          "wide": {"B": 2, "C": 9000, "QR": 1024, "nd": 4000}}[case]
    cols, specs, queries, docids, base = ld.geo_case(31 + len(case), **kw)
    on = (lambda t: None if t is None else t.to(cuda))
    a = ([{k: v.to(cuda) for k, v in cols[0].items()}], specs,
         [queries[0].to(cuda)], docids.to(cuda), on(base))
    want = kernels._geo_leaves_plain(cols, specs, queries, docids, base)
    got = _twice(lambda: kernels.geo_leaves(*a))
    assert torch.equal(got.cpu(), want)
    assert int((want != 0).sum()) > 0
    torch.cuda.synchronize()


def test_geo_leaves_refuses_a_column_without_pairs(cuda):
    """The kernel reads a geo column's int2 pairs (models/segment.py
    geo_arrays) and nothing else: a column without them is refused by
    name, not read as another layout."""
    import test_torch_leaves_design as ld

    cols, specs, queries, docids, base = ld.geo_case(4)
    bare = {k: v.to(cuda) for k, v in cols[0].items()
            if k not in ("span", "flat")}
    with pytest.raises(ValueError, match="int2 pairs"):
        kernels.geo_leaves([bare], specs, [queries[0].to(cuda)],
                           docids.to(cuda), base.to(cuda))


# slice 18: filter_leaves' row tiles, agg_distinct's K-bit set

FILTER_CASES = {"b1": {"B": 1, "C": 1000}, "packed": {"base": False,
                                                     "C": 4099},
                "wide_f": {"F": 34, "C": 300},
                "verdicts": {"ph": True, "geo": True, "C": 777},
                "tiles": {"B": 5, "C": 20011, "F": 4},
                "deep": {"B": 2, "C": 700, "deep": True}}


def _unaligned(t):
    """The same values in a contiguous tensor 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = flat[1:t.numel() + 1].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filter_leaves_tiles_match_plain_version(cuda, case, aligned):
    """filter_leaves' row tiles (16-row groups on the flat index, flags
    first, a lane's rows interleaved across the warp, the tree once over
    16 rows as masks, a leaf's packed keys in one gather) bit for bit
    against the plain version: one query,
    packed rows, 34 leaves, phrase and geo words, five queries of rows
    that do not start on 16, a program past the masks' stack (row by row);
    aligned rows and rows 4 bytes off a 16-byte boundary (each group's
    flags and eligible bytes then one by one)."""
    import test_torch_filter_distinct_design as fd

    args, _tree = fd.filter_case(40 + len(case), **FILTER_CASES[case])
    want = fd._plain(args)
    values = {s: {c: v.to(cuda) for c, v in col.items()}
              for s, col in args[0].items()}
    rest = [a.to(cuda) if isinstance(a, torch.Tensor) else a
            for a in args[3:]]
    if not aligned:
        rest = [_unaligned(a) if isinstance(a, torch.Tensor) and
                a.dim() == 2 else a for a in rest]
    got = _twice(lambda: kernels.filter_leaves(values, *args[1:3], *rest))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert want[0].any()


def test_filter_leaves_refuses_a_column_without_packed_keys(cuda):
    import test_torch_filter_distinct_design as fd

    args, _tree = fd.filter_case(50, F=2)
    values = {s: {c: v.to(cuda) for c, v in col.items() if c != "keys"}
              for s, col in args[0].items()}
    rest = [a.to(cuda) if isinstance(a, torch.Tensor) else a
            for a in args[3:]]
    with pytest.raises(ValueError, match="no packed keys"):
        kernels.filter_leaves(values, (5, 6), args[2], *rest)


@pytest.mark.parametrize("case", ["k1", "skip_key", "past_n", "absent",
                                  "wide_k", "none", "wide_rows"])
def test_agg_distinct_set_matches_plain_version(cuda, case):
    """agg_distinct's K-bit set bit for bit against the plain version (n
    and the 1024 registers): K = 1, the left-out key alone, ids past
    n - 1, absent docs, K past the shared-memory set, no eligible row, and
    a launch of several blocks a query whose rows do not start on 16."""
    import test_torch_filter_distinct_design as fd

    if case == "wide_rows":
        ids, elig, col = fd.distinct_case(60, B=7, R=50001, nd=20000,
                                          p_elig=0.3)
    else:
        ids, elig, col = fd.distinct_edge(case)
    want = kernels._agg_distinct_plain(ids, elig, col)
    dcol = {c: v.to(cuda) for c, v in col.items()}
    got = _twice(lambda: kernels.agg_distinct(ids.to(cuda), elig.to(cuda),
                                              dcol))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_agg_distinct_refuses_a_column_without_codes(cuda):
    import test_torch_filter_distinct_design as fd

    ids, elig, col = fd.distinct_edge("k1")
    dcol = {c: v.to(cuda) for c, v in col.items() if c != "codes"}
    with pytest.raises(ValueError, match="without its codes"):
        kernels.agg_distinct(ids.to(cuda), elig.to(cuda), dcol)


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
            ids, w, widths, batch["group_bits"], None, mprog, True,
            n_docs=seg["deleted"].shape[0])
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
    slot the segment lacks; collapse_max 1, 3, 8 and 9 (capped at 8);
    equal scores of a key ranked by docid and by row index (row_order,
    the join path's)."""
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
        for ro in (False, True):
            keep, tie = _twice(lambda: kernels.collapse_rows(
                *args, dcol, cmax, ro))
            pkeep, ptie = kernels.collapse_rows(
                *(x.cpu() for x in args),
                None if dcol is None else _cpu_col(dcol), cmax, ro)
            assert torch.equal(keep.cpu(), pkeep), (case, cmax, ro)
            assert torch.equal(tie.cpu(), ptie), (case, cmax, ro)
            d, s = _twice(lambda: kernels.topk_rows(args[1], args[0], keep,
                                                    10, tie))
            pd, ps = kernels._topk_rows_plain(args[1], args[0], keep, 10,
                                              tie)
            assert torch.equal(d, pd) and torch.equal(s, ps), \
                (case, cmax, ro)
    torch.cuda.synchronize()


COLLAPSE_DESIGNS = {
    # the global design wherever; the tiles wherever the table fits (a
    # table of 1024 slots: up to 512 keys): a block a chunk, one block, 8
    # blocks (blocks past the chunks hold no key)
    "global": lambda B, R, n: (0, 0),
    "tiles": lambda B, R, n: (kernels.COLLAPSE_TABLE,
                              -(-R // kernels.COLLAPSE_CHUNK)),
    "tiles_one_block": lambda B, R, n: (kernels.COLLAPSE_TABLE, 1),
    "tiles_eight_blocks": lambda B, R, n: (kernels.COLLAPSE_TABLE, 8),
}


@pytest.mark.parametrize("design", sorted(COLLAPSE_DESIGNS))
@pytest.mark.parametrize("case", ["keys", "one_key", "empty_query",
                                  "all_ones_key", "no_column", "many_keys",
                                  "nan_scores"])
def test_collapse_rows_designs_match_plain_version(cuda, monkeypatch, case,
                                                   design):
    """Each design of collapse_rows forced (kernels.collapse_plan) at the
    edge shapes of test_collapse_rows_matches_plain_version, and at 400
    keys over 20,000 rows a query (several chunks a tile block), and NaN
    scores: keep and tie equal to the plain version's, the same bits
    twice."""
    monkeypatch.setattr(kernels, "collapse_plan", COLLAPSE_DESIGNS[design])
    rng = np.random.Generator(np.random.PCG64(43))
    many = case == "many_keys"
    ids, sums, elig, col = _collapse_case(
        rng, 3, 20000 if many else 3000, 60000 if many else 9000,
        1 if case == "one_key" else 400 if many else 23,
        0.0 if case == "one_key" else 0.15, 0.8)
    if case == "empty_query":
        elig[1] = False
    if case == "all_ones_key":
        col["hi"][::3] = -1
        col["lo"][::3] = -1
    if case == "nan_scores":
        sums[rng.random(sums.shape) < 0.2] = np.nan
    dcol = None if case == "no_column" else \
        {c: torch.from_numpy(v).to(cuda) for c, v in col.items()}
    args = tuple(torch.from_numpy(x).to(cuda) for x in (ids, sums, elig))
    for cmax in (1, 3, 8, 9):
        for ro in (False, True):
            keep, tie = _twice(lambda: kernels.collapse_rows(
                *args, dcol, cmax, ro))
            pkeep, ptie = kernels.collapse_rows(
                *(x.cpu() for x in args),
                None if dcol is None else _cpu_col(dcol), cmax, ro)
            assert torch.equal(keep.cpu(), pkeep), (case, cmax, ro)
            assert torch.equal(tie.cpu(), ptie), (case, cmax, ro)
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
    its plain version, twice bit for bit (the design special_plan takes
    there)."""
    _corpus, searcher, qs, _aggs = browse
    seg = searcher.device_segment.arrays_pytree()
    n_docs = seg["deleted"].shape[0]
    seen = set()
    for cfg, _fn, batch, _chunk in _plans(searcher, qs, "SX"):
        post, _imp, widths, prefix, params = _inputs(searcher, cfg, batch)
        ids, w, _ = kernels.score_slices(
            post, None, batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, prefix, params)
        args = (ids, w, widths, batch["group_bits"], batch["offsets"],
                seg["post_wdf"], seg["post_doclen"], cfg.max_specs,
                cfg.syn_groups, batch.get("syn_tconst"), params)
        got = _twice(lambda: kernels.merge_special(*args, n_docs=n_docs))
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
    # a hand-made column takes its codes from value_arrays, as an upload
    values[sf.SORT_TEST_SLOT] = device_segment_from_numpy(
        {**col, **value_arrays(col)}, searcher.device)
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
                sums, owner, _c, _o = kernels.merge_docs(
                    ids, w, widths, n_docs=seg.arrays["deleted"].shape[0])
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
        got = _twice(lambda: kernels.merge_special(
            *args, n_docs=seg["deleted"].shape[0]))
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


# -- K20: kmeans -----------------------------------------------------------

def _unit_rows(n, v, k, seed):
    """n non-negative rows in k blocks plus noise, L2-normalised (TF-IDF
    rows are non-negative)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    centres = rng.random((k, v)) ** 4
    rows = centres[rng.integers(0, k, n)] + 0.05 * rng.random((n, v))
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("n,v,k", [(4096, 2048, 16), (256, 2048, 8),
                                   (10, 300, 3), (37, 17, 20), (1, 5, 1)])
def test_kmeans_matches_plain_version(cuda, n, v, k):
    """Each step of the kernel against kmeans_step_plain on the card, from
    the same centroids: labels equal on every row ops/cluster.py's
    near_ties does not flag (a positive top similarity within 2 gamma_V of
    the second), the new centroids within rtol 1e-5 where the labels
    agree; twice bit for bit; with update=False the labels alone."""
    from xapiand_tpu_torch.ops import cluster

    k = min(k, n)
    X = torch.from_numpy(_unit_rows(n, v, max(k, 1), seed=n + v)).to(cuda)
    C = X[torch.arange(k, device=cuda) * (n // k)].clone()
    for _step in range(4):
        got_l, got_c = kernels.kmeans(X, C)
        again_l, again_c = kernels.kmeans(X, C)
        assert torch.equal(got_l, again_l) and torch.equal(
            got_c.view(torch.int32), again_c.view(torch.int32))
        want_l, want_c = kernels.kmeans_step_plain(X, C)
        outside = torch.from_numpy(
            ~cluster.near_ties(X.cpu().numpy(), C.cpu().numpy())).to(cuda)
        assert torch.equal(got_l[outside], want_l[outside])
        if torch.equal(got_l, want_l):
            torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=0)
        only, none = kernels.kmeans(X, C, update=False)
        assert none is None and torch.equal(only, got_l)
        C = got_c
    torch.cuda.synchronize()


def test_kmeans_cosine_cuda_equals_cpu(cuda):
    """ops/cluster.py kmeans_cosine on the card and on the CPU (the plain
    version) from the same seeding: the same labels on block data."""
    from xapiand_tpu_torch.ops import cluster

    X = _unit_rows(512, 256, 6, seed=9)
    gl, gc = cluster.kmeans_cosine(X, 6, device=cuda)
    wl, wc = cluster.kmeans_cosine(X, 6, device="cpu")
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=0)


# -- the wide mode (wide_topk.cu) and the mesh merge (shard_merge.cu) --------

def _sort_world(dev, B=3, R=5000, nd=6000, seed=2):
    g = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randperm(nd, generator=g)[:R]
                       for _ in range(B)]).to(torch.int32)
    sums = torch.randint(0, 40, (B, R), generator=g).float() / 8
    elig = torch.rand((B, R), generator=g) < 0.7
    col = {"hi": torch.randint(-3, 3, (nd + 1,), generator=g,
                               dtype=torch.int32),
           "lo": torch.randint(-5, 5, (nd + 1,), generator=g,
                               dtype=torch.int32),
           "present": torch.rand(nd + 1, generator=g) < 0.9,
           "fval": torch.randn(nd + 1, generator=g),
           "cats": torch.randint(-1, 12, (nd + 1,), generator=g,
                                 dtype=torch.int32)}
    tab = torch.rand((B, 16), generator=g)
    remap = torch.tensor([5, 4, 3, 2, 1, 0, 9, 8, 7, 6, 11, 10, -1, -1, -1,
                          -1], dtype=torch.int32)
    on = [t.to(dev) for t in (ids, sums, elig)]
    cols = {1: {c: t.to(dev) for c, t in col.items()}}
    return on, cols, tab.to(dev), remap.to(dev)


@pytest.mark.parametrize("k", [300, 1024, 9000])
@pytest.mark.parametrize("tie", [False, True])
def test_wide_topk_rows_matches_plain_version(cuda, k, tie):
    """topk_rows beyond MAX_TOPK (the wide mode; k 9000 sorts in device
    memory) against its plain version, bit for bit, with NaN and -inf
    rows and ties."""
    g = torch.Generator().manual_seed(k)
    B, R = 4, 12000
    s = (torch.randint(0, 50, (B, R), generator=g).float() / 4)
    s[0, ::97] = float("nan")
    s[1, ::89] = float("-inf")
    ids = torch.stack([torch.randperm(R * 2, generator=g)[:R]
                       for _ in range(B)]).to(torch.int32)
    own = torch.rand((B, R), generator=g) < 0.6
    t = torch.randint(0, 5, (B, R), generator=g, dtype=torch.int32) \
        if tie else None
    args = [x.to(cuda) for x in (s, ids, own)]
    n0 = kernels.launches["wide_topk"]
    got = kernels.topk_rows(*args, k, t.to(cuda) if tie else None)
    torch.cuda.synchronize()
    assert kernels.launches["wide_topk"] == n0 + 1
    want = kernels._topk_rows_plain(*args, k, t.to(cuda) if tie else None)
    assert torch.equal(got[0], want[0])
    assert got[1].cpu().numpy().tobytes() == want[1].cpu().numpy().tobytes()


@pytest.mark.parametrize("case", ["k80", "k4000", "keys5", "strmetric"])
def test_wide_sort_topk_matches_plain_version(cuda, case):
    """sort_topk beyond MAX_SORT_TOPK or 8 key words (the wide mode), and
    at k 10 with the mesh's emitted keys and a strmetric remap, against
    its plain version: docids, scores and key words equal."""
    (ids, sums, elig), cols, tab, remap = _sort_world(cuda)
    specs, k, strtabs, remaps = ((("value", 1, True),), 80, None, None)
    if case == "k4000":
        specs, k = (("value", 1, False), ("score", None, True)), 4000
    elif case == "keys5":
        specs = (("value", 1, False), ("score", None, True),
                 ("value", 1, True), ("dist", 1, False))
        k = 20
    elif case == "strmetric":
        specs, k = (("strmetric", 1, False, 16),), 10
        strtabs, remaps = {0: tab}, {0: remap}
    targets = torch.full((ids.shape[0], len(specs), 2), 0.25, device=cuda)
    args = (specs, ids, sums, elig, k, cols, targets, strtabs, remaps)
    got = kernels.sort_topk(*args, emit=True)
    torch.cuda.synchronize()
    want = kernels.sort_topk(specs, ids.cpu(), sums.cpu(), elig.cpu(), k,
                             {1: {c: t.cpu() for c, t in cols[1].items()}},
                             targets.cpu(),
                             {0: tab.cpu()} if strtabs else None,
                             {0: remap.cpu()} if remaps else None, emit=True)
    for a, b in zip(got, want):
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("S,k,okeys,nu", [(8, 10, True, 0), (8, 80, False, 0),
                                          (4, 33, True, 3)])
def test_shard_merge_matches_plain_version(cuda, S, k, okeys, nu):
    """The mesh merge on the card against its plain version, bit for bit:
    ties, -0.0 beside 0.0, NaN and -inf scores, orderkeys or striped
    docids, emitted key words."""
    g = torch.Generator().manual_seed(S * k)
    Q, nd = 24, 200
    d = torch.randint(0, nd, (S, Q, k), generator=g, dtype=torch.int32)
    vals = torch.tensor([0.5, 1.0, 0.0, -0.0, float("nan"), float("-inf")])
    s = vals[torch.randint(0, 6, (S, Q, k), generator=g)]
    ok = torch.randint(0, 50, (S, nd + 1), generator=g, dtype=torch.int32)
    kw = torch.randint(-2**31, 2**31 - 1, (S, Q, k, nu), generator=g,
                       dtype=torch.int64).to(torch.int32) % 3 if nu else None
    args = [d, s, ok if okeys else None, kw]
    got = kernels.shard_merge(*[a.to(cuda) if a is not None else None
                                for a in args])
    torch.cuda.synchronize()
    want = kernels.shard_merge(*args)
    assert torch.equal(got[0].cpu(), want[0])
    assert got[1].cpu().numpy().tobytes() == want[1].numpy().tobytes()
    x = torch.randn((S, Q, 7), generator=g)
    x[1, 2, 3] = float("nan")
    for rule in ("sum", "min", "max"):
        a = kernels.shard_reduce(x.to(cuda), rule).cpu()
        assert a.numpy().tobytes() == kernels.shard_reduce(
            x, rule).numpy().tobytes()
    c = torch.randint(0, 2**20, (S, Q), generator=g, dtype=torch.int32)
    assert torch.equal(kernels.shard_reduce(c.to(cuda), "sum").cpu(),
                       kernels.shard_reduce(c, "sum"))


def test_agg_buckets_remap_matches_plain_version(cuda):
    """The terms mode through a mesh cat_remap row, on the card and plain."""
    g = torch.Generator().manual_seed(9)
    B, R, n = 4, 3000, 5000
    ids = torch.randint(0, n, (B, R), generator=g, dtype=torch.int32)
    elig = torch.rand((B, R), generator=g) < 0.8
    cats = torch.randint(-1, 20, (n,), generator=g, dtype=torch.int32)
    remap = torch.randperm(32, generator=g).to(torch.int32) - 4
    got = kernels.agg_buckets(ids.to(cuda), elig.to(cuda), "terms",
                              cats.to(cuda), 32, remap=remap.to(cuda))
    want = kernels.agg_buckets(ids, elig, "terms", cats, 32, remap=remap)
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.parametrize("case", ["terms", "remap", "missing", "mask",
                                  "histogram", "range", "trixels",
                                  "nested"])
@pytest.mark.parametrize("B,R", [(2, 9000), (64, 40000)])
def test_agg_buckets_one_launch_matches_plain_version(cuda, case, B, R):
    """agg_buckets' one launch (every row's code written, warps' sub
    partials, the last block's fold) in every mode, a nested level of
    8 x 300 buckets, a mesh remap, with and without subs (one of values
    near 5e5 of both signs, a count sub): counts and codes equal to the
    plain version's, sub n, min and max equal, s2 within rtol 1e-5 of its
    float64 sums and s within 1e-5 of the sums of |value| (where a few
    values of both signs cancel, no float32 sum is within rtol of the
    float64 one), the same bits twice; 64 queries of 40,000 rows split each
    query over several blocks."""
    from test_torch_collapse_buckets_design import bucket_world, mode_codes

    w = bucket_world(31, B, R)
    ids, elig = w["ids"], w["elig"]
    if case == "nested":
        codes, nb, _kw = mode_codes(w, "histogram")
        prev = kernels._agg_buckets_plain(ids, elig, "terms", w["cats"], 8,
                                          (), want_codes=True)[2]
        kw, mode = {"prev": prev, "size": 8 * nb}, "histogram"
    else:
        codes, nb, kw = mode_codes(w, case)
        mode = "terms" if case == "remap" else case

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(cuda)
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(to(v) for v in x)
        return x

    # the sums of |value|: a float32 sum of values of both signs is held
    # within 1e-5 of them (its rounding bound), not of a sum they cancel
    absum = kernels.agg_buckets(
        ids, elig, mode, codes, nb,
        tuple(None if c is None else (c[0].abs(), c[1])
              for c in w["subs"]), **kw)[1][1].numpy()
    for subs in ((), w["subs"]):
        got = _twice(lambda: kernels.agg_buckets(
            to(ids), to(elig), mode, to(codes), nb, to(subs),
            want_codes=True, **to(kw)))
        want = kernels.agg_buckets(ids, elig, mode, codes, nb, subs,
                                   want_codes=True, **kw)
        assert torch.equal(got[0].cpu(), want[0]), (case, "counts")
        assert torch.equal(got[2].cpu(), want[2]), (case, "codes")
        if subs:
            for st in range(5):
                g, x = got[1][st].cpu().numpy(), want[1][st].numpy()
                if st in (0, 3, 4):
                    assert np.array_equal(g, x), (case, st)
                elif st == 1:
                    assert (np.abs(g - x) <= 1e-5 * absum).all(), case
                else:
                    np.testing.assert_allclose(g, x, rtol=1e-5, atol=0)
    torch.cuda.synchronize()


def test_repaired_limits_cuda_equals_cpu(cuda):
    """The limits repaired in the kernels - a phrase of 18 words (past
    phrase_leaves' table), 40 value filters and a 41-deep tree
    (filter_leaves' lazy leaves, the 64-bit stack), a relevance page of
    300 and a sorted page of 70 (wide_topk), five sort keys - through the
    port's Database on the card and on the CPU: the same answers."""
    from xapiand_tpu_torch.database import Database
    from xapiand_tpu_torch.query.dsl import parse_sort

    def doc(i):
        g = np.random.Generator(np.random.PCG64(i))
        d = {"body": " ".join(f"w{int(x)}" for x in g.integers(0, 30, 24)),
             "n": i, "m": i % 13, "p": int(g.integers(0, 5)),
             "q": int(g.integers(0, 4)), "r": float(g.integers(0, 3))}
        if i % 5 == 0:
            d["body"] += " " + " ".join(f"s{j}" for j in range(20))
        return d

    dbs = [Database(device=cuda), Database(device="cpu")]
    for db in dbs:
        for i in range(400):
            db.index_document(doc(i), doc_id=str(i))
        db.commit()
    deep = {"body": "w3"}
    for j in range(40):
        deep = {"_and" if j % 2 else "_or": [
            {"n": {"_from": j, "_to": 399 - j}}, deep]}
    many = {"_and": [{"body": "w1"}] + [
        {"n": {"_from": j, "_to": 400 - j}} if j % 2 else
        {"m": {"_from": 0, "_to": 12 - (j % 3)}} for j in range(40)]}
    ors = {"_or": [{"body": "w3"}, {"body": "w7"}, {"body": "w11"}]}
    aggs = {"c": {"_count": {"_field": "n"}}}
    keys5 = [{"p": {"_order": "asc"}}, {"q": {"_order": "desc"}},
             {"r": {"_order": "desc"}}, {"m": {"_order": "asc"}},
             {"n": {"_order": "desc"}}]
    cases = [({"body": {"_phrase": " ".join(f"s{j}" for j in range(18))}},
              20, None), (many, 10, None), (deep, 10, None),
             (ors, 300, None), (ors, 70, [{"p": {"_order": "desc"}}]),
             (ors, 25, keys5)]
    n0 = kernels.launches["wide_topk"]
    for q, k, sort in cases:
        got, want = [db.search(q, k=k, aggs=aggs, sort=parse_sort(
            db.schema, sort) if sort else ()) for db in dbs]
        assert got.total == want.total
        assert [h.id for h in got.hits] == [h.id for h in want.hits]
        np.testing.assert_allclose([h.score for h in got.hits],
                                   [h.score for h in want.hits], rtol=1e-6)
    assert kernels.launches["wide_topk"] >= n0 + 3


def test_wide_prefix_cuda_equals_cpu(cuda):
    """BatchSearcher at prefix_cap 32768: score_slices sorts the prefix
    blocks in device memory on the card; the same answers as the CPU's."""
    seg = build_synthetic_segment(40000, 60, seed=3)
    irs = [Q.or_terms(t) for t in (["t0", "t1", "t7"], ["t2", "t4", "t9"],
                                   ["t3", "t12"])]
    out = [BatchSearcher(SegmentSearcher(seg, device=d), k=10,
                         prefix_cap=32768).run(irs)
           for d in (cuda, torch.device("cpu"))]
    for g, w in zip(*out):
        assert int(g["count"]) == int(w["count"])
        assert np.asarray(g["docids"]).tolist() == \
            np.asarray(w["docids"]).tolist()
        np.testing.assert_allclose(np.asarray(g["scores"]),
                                   np.asarray(w["scores"]), rtol=1e-6)


def deep_tree(depth, n_docs):
    """A 100-deep tree the shared planner admits (at most 31 leaf groups):
    a chain of AND (a range first, so the old program's stack grew with
    it) with an AND_NOT of a range every fourth level, over a term."""
    deep = {"body": "w3"}
    for j in range(depth):
        rng = {"n" if j % 2 else "m": {"_from": j % 7, "_to": n_docs - j}}
        deep = {"_and_not": [deep, {"n": {"_from": j, "_to": j + 2}}]} \
            if j % 4 == 3 else {"_and": [rng, deep]}
    return deep


def _k21_world(cuda):
    """A synthetic segment with deletes on the card and on the CPU, its
    stats and 24 three-term queries."""
    seg = build_synthetic_segment(30000, 2000, seed=9)
    seg.deleted[5:2000:7] = True
    qs = [sorted(q, key=lambda t: -seg.terms[t].length)
          for q in sample_queries(seg, 24, 3, seed=5)]
    return seg, qs, [SegmentSearcher(seg, device=d)
                     for d in (cuda, torch.device("cpu"))]


@pytest.mark.parametrize("scheme", ["bm25", "pl2", "dicecoeff"])
def test_semijoin_rows_matches_plain_version(cuda, scheme):
    """semijoin_rows (K21) on the card against its plain version on the
    same card tensors (the card's log2f under PL2), bit for bit: ids,
    sums, orbits, first and counts, with deletes, under BM25, a scheme of
    two constants a term and one that reads uniqterms."""
    from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme
    from xapiand_tpu_torch.query.plan import bind, compile_ir, unify_cfgs

    seg, qs, (ps, _cpu) = _k21_world(cuda)
    uniq = np.maximum(np.bincount(seg.post_docids, minlength=seg.num_docs + 1),
                      1).astype(np.float32)
    sch = get_scheme(scheme)
    st = CollectionStats(doc_count=seg.doc_count, avg_doclen=seg.avg_doclen,
                         doclen_lower=1.0, doclen_upper=200.0,
                         total_len=float(seg.total_doclen))
    bounds = [bind(compile_ir(Q.and_(Q.term(q[2]), Q.or_terms(q[:2]))), seg,
                   sch, st, k=10) for q in qs]
    cfg = unify_cfgs([b.cfg for b in bounds], k=10)
    arrs = {key: torch.from_numpy(np.stack([np.pad(
        b.arrays[key], [(0, cfg.T - b.arrays[key].shape[0])] +
        [(0, 0)] * (b.arrays[key].ndim - 1)) for b in bounds]))
        for key in ("offsets", "lens", "tconst", "scoring", "group_bits")}
    spec = sch.kernel_spec(st)
    post = tuple(torch.from_numpy(np.asarray(a)) for a in
                 (seg.post_docids, seg.post_wdf, seg.post_doclen))
    dele = torch.from_numpy(np.asarray(seg.deleted, np.bool_))
    u = torch.from_numpy(uniq) if spec.needs_uniq else None
    hits = 0
    for drive in range(cfg.T):
        args = (arrs["offsets"], arrs["lens"], arrs["tconst"],
                arrs["scoring"], arrs["group_bits"])
        on = (tuple(p.to(cuda) for p in post), *(a.to(cuda) for a in args),
              cfg.term_classes(), drive, dele.to(cuda), spec,
              u.to(cuda) if u is not None else None)
        want = kernels._semijoin_rows_plain(*on)
        n0 = kernels.launches["semijoin_rows"]
        got = kernels.semijoin_rows(*on)
        torch.cuda.synchronize()
        assert kernels.launches["semijoin_rows"] == n0 + 1
        for a, b in zip(got, want):
            assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
        hits += int(want[4].sum())
    assert hits > 0


def test_chunk_merge_matches_plain_version(cuda):
    """chunk_merge (K21, shard_merge.cu unstriped) on the card against its
    plain version, bit for bit: ties, -0.0 beside 0.0, NaN, and -inf
    finalists with SENTINEL docids."""
    g = torch.Generator().manual_seed(21)
    for NC, Q, k in ((2, 16, 10), (16, 40, 10), (4, 8, 80)):
        d = torch.randint(0, 5000, (NC, Q, k), generator=g,
                          dtype=torch.int32)
        vals = torch.tensor([0.5, 1.0, 0.0, -0.0, float("nan"),
                             float("-inf")])
        s = vals[torch.randint(0, 6, (NC, Q, k), generator=g)]
        d = torch.where(torch.isfinite(s), d, kernels.SENTINEL)
        n0 = kernels.launches["chunk_merge"]
        got = kernels.chunk_merge(d.to(cuda), s.to(cuda))
        torch.cuda.synchronize()
        assert kernels.launches["chunk_merge"] == n0 + 1
        want = kernels.chunk_merge(d, s)
        assert torch.equal(got[0].cpu(), want[0])
        assert got[1].cpu().numpy().tobytes() == want[1].numpy().tobytes()


def test_k21_paths_cuda_equal_cpu(cuda):
    """The three K21 executors through their entry points on the card and
    on the CPU: BatchSearcher(chunk_rows=500), a semijoin group (the
    pinned planner's SEMIJOIN_RATIO forced to 1) and a join group
    (join=True on the planned groups), with deletes: the same answers,
    and each path's kernels launched."""
    import dataclasses

    from xapiand_tpu_torch.query import plan as pplan

    seg, qs, searchers = _k21_world(cuda)
    ors = [Q.or_terms(q) for q in qs]
    ands = [Q.and_(Q.term(q[2]), Q.or_terms(q[:2])) for q in qs]

    def run(searcher, mode):
        if mode == "chunked":
            bs = BatchSearcher(searcher, k=10, chunk_rows=500)
            assert any(c.n_chunks > 1 for c, *_x in bs.plan(ors))
            return bs.run(ors)
        bs = BatchSearcher(searcher, k=10)
        groups = bs.plan(ands)
        if mode == "semijoin":
            assert all(c.drive >= 0 for c, *_x in groups)
        out = [None] * len(ands)
        for cfg, _fn, batch, chunk in groups:
            if mode == "join":
                cfg = dataclasses.replace(cfg, join=True)
            res = searcher.batched(cfg)(
                searcher.device_segment.arrays_pytree(), batch,
                {"N": seg.doc_count, "avg_doclen": seg.avg_doclen})
            for b, qi in enumerate(chunk):
                out[qi] = {k: v[b].cpu().numpy() for k, v in res.items()}
        return out

    saved = pplan.SEMIJOIN_RATIO
    try:
        for mode, name in (("chunked", "chunk_merge"),
                           ("semijoin", "semijoin_rows"),
                           ("join", "merge_docs")):
            pplan.SEMIJOIN_RATIO = 1 if mode == "semijoin" else None
            n0 = kernels.launches[name]
            got, want = (run(s, mode) for s in searchers)
            torch.cuda.synchronize()
            assert kernels.launches[name] > n0, mode
            for g, w in zip(got, want):
                assert int(g["count"]) == int(w["count"])
                assert g["docids"].tolist() == w["docids"].tolist()
                np.testing.assert_allclose(g["scores"], w["scores"],
                                           rtol=1e-6)
    finally:
        pplan.SEMIJOIN_RATIO = saved


def test_deep_tree_and_many_sort_keys_cuda_equal_cpu(cuda):
    """The two limits repaired in slice 11 through the port's Database on
    the card and on the CPU: a tree of AND / AND_NOT 100 deep (the
    reordered program on the 64-bit stack), its negation (NOTAND), and
    sorts of 16 and 24 value keys (wide_topk at 34 and 50 key words):
    the same answers."""
    from xapiand_tpu_torch.database import Database
    from xapiand_tpu_torch.query.dsl import parse_sort

    dbs = [Database(device=cuda), Database(device="cpu")]
    for db in dbs:
        for i in range(300):
            g = np.random.Generator(np.random.PCG64(i))
            d = {"body": " ".join(f"w{int(x)}" for x in
                                  g.integers(0, 30, 24)), "n": i, "m": i % 13}
            d.update({f"f{j}": int(g.integers(0, 3)) for j in range(24)})
            db.index_document(d, doc_id=str(i))
        db.commit()
    deep = deep_tree(100, 300)
    n0 = kernels.launches["wide_topk"]
    for q, nkeys in ((deep, 0), ({"_and_not": [{"n": {"_from": 0, "_to": 150}},
                                               deep]}, 0),
                     ({"body": "w1"}, 16), ({"body": "w2"}, 24)):
        sort = [{f"f{j}": {"_order": "desc" if j % 2 else "asc"}}
                for j in range(nkeys)]
        got, want = [db.search(q, k=20, sort=parse_sort(db.schema, sort)
                               if sort else ()) for db in dbs]
        assert got.total == want.total > 0
        assert [h.id for h in got.hits] == [h.id for h in want.hits]
        np.testing.assert_allclose([h.score for h in got.hits],
                                   [h.score for h in want.hits], rtol=1e-6)
    assert kernels.launches["wide_topk"] >= n0 + 2


# -- slice 12: topk_rows over row tiles, dense_rows over doc tiles -----------

TOPK_KS = (1, 10, 33, 64, 65, 80, 256)


def _topk_shapes():
    """Below one tile at a large B, one tile less one row, exactly one
    tile, one tile and a row (two), odd R over several tiles (row bases
    not 16-byte aligned)."""
    m = kernels.TOPK_TILE_MIN
    return ((300, 700), (2, m - 1), (2, m), (2, m + 1), (3, 40001),
            (2, 123457))


def _topk_same(got, want, what):
    assert torch.equal(got[0], want[0]), what
    assert got[1].cpu().numpy().tobytes() == \
        want[1].cpu().numpy().tobytes(), what


@pytest.mark.parametrize("tie", ["none", "ranks", "row"])
@pytest.mark.parametrize("k", TOPK_KS)
def test_topk_rows_tiles_match_plain_version(cuda, k, tie):
    """topk_rows (both key types: the tie ranks of a collapse, the row
    index of the tie window) against its plain version, bit for bit and
    twice: uniform and ascending scores (the most inserts), all equal,
    NaN and +-inf rows, fewer owners than k; one launch counted a call."""
    from test_torch_topk_design import TOPK_CASES, topk_rows_case

    for B, R in _topk_shapes():
        for i, case in enumerate(TOPK_CASES):
            s, d, o, t = topk_rows_case(case, B, R, 7 * i + k, tie)
            args = [x.to(cuda) for x in (s, d, o)]
            tt = t.to(cuda) if t is not None else None
            n0 = kernels.launches["topk_rows"]
            got = _twice(lambda: kernels.topk_rows(*args, k, tt))
            assert kernels.launches["topk_rows"] == n0 + 2
            _topk_same(got, kernels._topk_rows_plain(*args, k, tt),
                       (B, R, case))
    torch.cuda.synchronize()


@pytest.mark.parametrize("tie", ["none", "row"])
def test_topk_rows_one_wide_query_matches_plain_version(cuda, tie):
    """B1 R4194304 (513 tiles' lists merged) at k 10 and 80, uniform and
    ascending scores, against the plain version, twice."""
    from test_torch_topk_design import topk_rows_case

    for case in ("uniform", "ascending"):
        s, d, o, t = topk_rows_case(case, 1, 4_194_304, 5, tie)
        args = [x.to(cuda) for x in (s, d, o)]
        tt = t.to(cuda) if t is not None else None
        for k in (10, 80):
            got = _twice(lambda: kernels.topk_rows(*args, k, tt))
            _topk_same(got, kernels._topk_rows_plain(*args, k, tt),
                       (case, k))
    torch.cuda.synchronize()


def test_topk_rows_unaligned_pointers_match_plain_version(cuda):
    """Inputs whose storage starts one element past an allocation (a
    pointer not 16-byte aligned: the kernel's scalar loads), with and
    without the tie, against the plain version."""
    from test_torch_topk_design import topk_rows_case

    B, R = 3, 50001
    s, d, o, t = topk_rows_case("special", B, R, 9, "ranks")

    def shifted(x):
        buf = torch.empty(B * R + 1, dtype=x.dtype, device=cuda)
        v = buf[1:].view(B, R)
        v.copy_(x.to(cuda))
        assert v.is_contiguous() and v.data_ptr() % 16 != 0
        return v

    args = [shifted(x) for x in (s, d, o)]
    tt = shifted(t)
    for k, tie in ((10, None), (80, tt)):
        got = _twice(lambda: kernels.topk_rows(*args, k, tie))
        _topk_same(got, kernels._topk_rows_plain(*args, k, tie), k)
    torch.cuda.synchronize()


@pytest.mark.parametrize("label", [c[0] for c in SCHEME_CONFIGS])
def test_dense_rows_tiles_match_plain_version(cuda, label):
    """dense_rows under every scheme configuration (C of 1 and 2
    constants, uniqterms where read) against its plain version, every
    output bit for bit (a NaN equal to a NaN), twice: docs at the doc
    tiles' borders, a term block clamped at the end of the postings, lens
    above the class width, T of 300 (past the 256 threads that find the
    term cursors); and at B 399, where a block walks a run of tiles."""
    from test_torch_topk_design import dense_world

    for variant in ("borders", "clamp", "over", "wide"):
        (post, offsets, lens, tconst, scoring, bits, classes, deleted, spec,
         uniq) = dense_world(variant, label)
        on = [x.to(cuda) for x in (offsets, lens, tconst, scoring, bits)]
        args = (tuple(x.to(cuda) for x in post), *on, classes,
                deleted.to(cuda), spec,
                uniq.to(cuda) if uniq is not None else None)
        n0 = kernels.launches["dense_rows"]
        got = _twice(lambda: kernels.dense_rows(*args))
        assert kernels.launches["dense_rows"] == n0 + 2
        want = kernels._dense_rows_plain(*args)
        for g, w, name in zip(got, want, ("ids", "scores", "orbits",
                                          "live")):
            assert _equal(g, w), (variant, name)
    # B 399: one run a query, every tile of it walked by one block
    rep = [x.repeat(133, *(1,) * (x.dim() - 1)) for x in on]
    assert kernels.dense_per(399, deleted.shape[0], classes) > 1
    args = (args[0], *rep, classes, args[7], spec, args[9])
    got = _twice(lambda: kernels.dense_rows(*args))
    want = kernels._dense_rows_plain(*args)
    for g, w in zip(got, want):
        assert _equal(g, w)
    torch.cuda.synchronize()


# -- slice 13: sort_topk over row tiles, a threshold filter and a merge ------

def _sort_on(world, dev):
    """A tests/test_torch_sort_design.py sort_world on the device."""
    ids, sums, elig, values, targets, strtabs, remaps = world
    return (ids.to(dev), sums.to(dev), elig.to(dev),
            {s: {c: t.to(dev) for c, t in col.items()}
             for s, col in values.items()},
            targets.to(dev), {i: t.to(dev) for i, t in strtabs.items()},
            {i: t.to(dev) for i, t in remaps.items()})


def _sort_held(specs, world, k, emit, what):
    """sort_topk on the card, twice, against its plain version on the same
    tensors: docids, scores (bits) and emitted words equal; one launch a
    call."""
    ids, sums, elig, values, targets, strtabs, remaps = world
    n0 = kernels.launches["sort_topk"]
    got = _twice(lambda: kernels.sort_topk(specs, ids, sums, elig, k, values,
                                           targets, strtabs, remaps,
                                           emit=emit))
    assert kernels.launches["sort_topk"] == n0 + 2, what
    cols = [values.get(s[1]) if s[0] not in ("score", "docid") else None
            for s in specs]
    want = kernels._sort_topk_plain(specs, cols, ids, sums, elig, k, targets,
                                    strtabs, remaps, emit)
    assert torch.equal(got[0], want[0]), what
    assert got[1].cpu().numpy().tobytes() == \
        want[1].cpu().numpy().tobytes(), what
    if emit:
        assert torch.equal(got[2], want[2]), what


@pytest.mark.parametrize("k", [1, 10, 64])
def test_sort_topk_tiles_match_plain_version(cuda, k):
    """sort_topk against its plain version, bit for bit and twice, for
    every key kind and 3 to 8 key words, emit on and off: B1 over many
    tiles, B8, B64 and B256; every case of the design tests (NaN scores
    beside ineligible rows, few or no eligible rows, tied first words,
    docids ascending and descending along the rows)."""
    from test_torch_sort_design import CASES, SPECS, n_words, sort_world

    shapes = ((1, 200_001), (8, 40_001), (64, 20_000), (256, 3_001))
    for si, specs in enumerate(SPECS):
        assert 3 <= n_words(specs) <= kernels.MAX_SORT_WORDS
        for j, (B, C) in enumerate(shapes):
            case = CASES[(si + j) % len(CASES)]
            world = _sort_on(sort_world(specs, B, C, 13 * si + j, case,
                                        remap=True), cuda)
            _sort_held(specs, world, k, (si + j) % 2 == 0,
                       (specs, B, C, case))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["nan", "few", "ineligible", "ties"])
def test_sort_topk_short_and_nan_cases_match_plain_version(cuda, case):
    """C < k (all ones past C), C at k, a few rows over odd C (row bases
    not 4-aligned), one tile less a row, and one tile and a row; a score
    key alone (NaN beside ineligible rows) and a value key with a score."""
    from test_torch_sort_design import SPECS, sort_world

    m = kernels.SORT_TILE_MIN
    for specs in (SPECS[-1], SPECS[1], SPECS[9]):
        for B, C in ((3, 1), (3, 9), (2, 10), (3, 37), (2, m - 1),
                     (2, m + 1)):
            world = _sort_on(sort_world(specs, B, C, C, case), cuda)
            for k in (10, 64):
                _sort_held(specs, world, k, True, (specs, B, C, k))
    torch.cuda.synchronize()


def test_sort_topk_unaligned_flags_match_plain_version(cuda):
    """Eligibility flags whose storage starts one byte past an allocation
    (the kernel's byte loads), against the plain version."""
    from test_torch_sort_design import SPECS, sort_world

    specs = SPECS[1]
    ids, sums, elig, *rest = _sort_on(sort_world(specs, 3, 50_001, 4,
                                                 "uniform"), cuda)
    buf = torch.zeros(elig.numel() + 1, dtype=torch.bool, device=cuda)
    el = buf[1:].view(elig.shape)
    el.copy_(elig)
    assert el.data_ptr() % 4 != 0
    _sort_held(specs, (ids, sums, el, *rest), 10, True, "unaligned")
    torch.cuda.synchronize()


def _semijoin_world(B, seed=3):
    """Three terms' ascending postings over 4M docs (600,000, 100,000 and
    2,000 of them) and B queries, each its own case: the drive term
    whole, its length a tail of the class (rows past it), a window
    clamped at the end of the postings (two ascending runs), an empty
    drive term, an empty probed term, a probed term longer than its class
    (JAX's rounds stop short)."""
    g = np.random.Generator(np.random.PCG64(seed))
    ns = (600_000, 100_000, 2_000)
    docs = [np.sort(g.choice(4_000_000, n, replace=False)) for n in ns]
    post = (torch.from_numpy(np.concatenate(docs).astype(np.int32)),
            torch.from_numpy(g.integers(1, 6, sum(ns)).astype(np.float32)),
            torch.from_numpy((g.random(sum(ns)) * 300 + 5)
                             .astype(np.float32)))
    P = sum(ns)
    offs = np.array([0, ns[0], ns[0] + ns[1]], np.int32)
    offsets = np.tile(offs, (B, 1))
    lens = np.tile(np.array(ns, np.int32), (B, 1))
    lens[1::6, 0] = 300_000                       # rows past the length
    offsets[2::6, 0] = P - 1_000                  # a clamped window
    lens[3::6, 0] = 0                             # an empty drive term
    lens[4::6, 1] = 0                             # an empty probed term
    lens[5::6, 2] = 1_500
    deleted = torch.from_numpy(g.random(4_000_001) < 0.01)
    return post, torch.from_numpy(offsets), torch.from_numpy(lens), \
        deleted


@pytest.mark.parametrize("scheme", ["bm25", "pl2", "dicecoeff"])
def test_semijoin_rows_brackets_match_plain_version(cuda, scheme):
    """semijoin_rows at the K21 path's drive class (2^19 rows a query, B
    12, every case of _semijoin_world twice) against its plain version on
    the same card tensors, bit for bit, driven by the longest term and by
    the middle one: brackets staged (the short term) and searched in place
    (the long ones); and with the middle term's class 512, below its
    length of 100,000, where JAX's rounds stop short and run as they
    are."""
    from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme

    B = 12
    post, offsets, lens, deleted = _semijoin_world(B)
    sch = get_scheme(scheme)
    st = CollectionStats(doc_count=4_000_000, avg_doclen=150.0,
                         doclen_lower=1.0, doclen_upper=400.0,
                         total_len=6.0e8)
    spec = sch.kernel_spec(st)
    g = torch.Generator().manual_seed(5)
    C = sch.n_constants
    tconst = torch.rand((B, 3) + ((C,) if C > 1 else ()), generator=g) + 0.5
    scoring = torch.ones((B, 3))
    bits = torch.tensor([[1, 2, 4]] * B, dtype=torch.int32)
    uniq = (torch.rand(4_000_001, generator=g) * 50 + 1).floor() \
        if spec.needs_uniq else None
    for drive, classes in ((0, (524_288, 131_072, 2_048)),
                           (1, (524_288, 131_072, 2_048)),
                           (0, (524_288, 512, 2_048))):
        on = (tuple(p.to(cuda) for p in post), offsets.to(cuda),
              lens.to(cuda), tconst.to(cuda), scoring.to(cuda), bits.to(cuda),
              classes, drive, deleted.to(cuda), spec,
              uniq.to(cuda) if uniq is not None else None)
        n0 = kernels.launches["semijoin_rows"]
        got = _twice(lambda: kernels.semijoin_rows(*on))
        assert kernels.launches["semijoin_rows"] == n0 + 2
        want = kernels._semijoin_rows_plain(*on)
        for a, b in zip(got, want):
            assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes(), \
                (scheme, drive)
        assert int(want[4].sum()) > 0
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# score_slices' row tiles and merge_docs' doc tiles (slice 14)
# --------------------------------------------------------------------------

SLICE_CASES = {
    # browse C: one query over 2M rows (4 terms of class 524288)
    "B1_2M": dict(seed=1, B=1, T=4, nd=1_000_000, df=(300_000, 520_000),
                  n_terms=4, missing_p=0.0),
    # geo: T = 128, ~1.4k postings a term
    "T128": dict(seed=2, B=8, T=128, nd=1_000_000, df=(1_000, 1_440),
                 n_terms=300),
    # relevance prefix: two prefix terms beside two exact ones
    "mixed_prefix": dict(seed=3, B=64, T=4, nd=1_000_000, df=(100, 40_000),
                         prefix=(True, True, False, False), pcap=8192),
    # a prefix past MAX_PREFIX_ROWS (device-memory sort)
    "wide_prefix": dict(seed=4, B=4, T=2, nd=1_000_000,
                        df=(20_000, 60_000), prefix=(True, False),
                        pcap=2 * kernels.MAX_PREFIX_ROWS, missing_p=0.0),
    # GENERIC schemes: uniqterms read (DiceCoeff), two constants (PL2)
    "dicecoeff": dict(seed=5, B=16, T=4, nd=1_000_000, df=(1_000, 200_000),
                      scheme="dicecoeff"),
    "pl2": dict(seed=6, B=16, T=3, nd=1_000_000, df=(1_000, 100_000),
                scheme="pl2", prefix=(False, True, False), pcap=4096),
    # queries whose every term is missing
    "all_sentinel": dict(seed=7, B=8, T=4, nd=100_000, df=(10, 5_000),
                         empty=tuple(range(8))),
}


@contextlib.contextmanager
def _tiles_forced(tiles: bool):
    """merge_docs by the doc tiles or by the probes inside the block,
    whatever kernels.merge_plan would choose."""
    rule = kernels.merge_plan
    kernels.merge_plan = (lambda w, n: -(-int(n) // kernels.MERGE_TILE)) \
        if tiles else (lambda w, n: 0)
    try:
        yield
    finally:
        kernels.merge_plan = rule


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_score_slices_row_tiles_match_plain_version(cuda, case):
    """The row tiles (and, in the prefix cases, the prefix blocks in the
    same call) against the plain version on the same card tensors, bit
    for bit, twice; then merge_docs on those rows by the doc tiles and by
    the probes (each forced), each equal to the plain version."""
    from test_torch_slices_design import slices_world, world_args

    wd = slices_world(**SLICE_CASES[case])
    args = world_args(wd, cuda)
    n0 = kernels.launches["score_slices"]
    got = _twice(lambda: kernels.score_slices(*args))
    assert kernels.launches["score_slices"] == n0 + 2
    want = kernels._score_slices_plain(*args)
    for g, w in zip(got, want):
        assert _equal(g, w), case
    ids, w, _tail = got
    widths = wd["widths"]
    n_docs = wd["nd"] + 1
    plain = kernels._merge_docs_plain(ids, w, widths)
    for tiles in (True, False):
        with _tiles_forced(tiles):
            m = _twice(lambda: kernels.merge_docs(ids, w, widths,
                                                  n_docs=n_docs))
        assert _equal(m[0], plain[0]) and torch.equal(m[1], plain[1]) and \
            torch.equal(m[2], plain[2]), (case, tiles)
    if case == "all_sentinel":
        assert not bool((ids != kernels.SENTINEL).any())
    torch.cuda.synchronize()


MERGE_CASES = {
    # T = 1 over a million docids
    "T1": dict(B=2, widths=(300_000,), nd=1_000_000),
    # NaN and -0.0 weights on docs that every term shares
    "nan_neg0": dict(B=8, widths=(4_096, 8_192, 2_048), nd=100_000,
                     hot=6_000, nan_p=0.05, neg0_p=0.1),
    # geo's T = 128, docs shared; and its aggregation run's few rows a
    # tile (added by one warp)
    "T128": dict(B=4, widths=(2_048,) * 128, nd=1_000_000, hot=300_000),
    "T128_sparse": dict(B=8, widths=(256,) * 128, nd=1_000_000, fill=0.5),
    "all_sentinel": dict(B=4, widths=(1_024, 65_536), nd=1_000_000,
                         empty=(0, 1, 2, 3)),
    # the mesh's dense blocks
    "dense": dict(B=2, widths=(1_048_576, 524_288, 131_072, 1_024),
                  nd=1_250_000, fill=0.9),
}


@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_docs_doc_tiles_match_plain_version(cuda, case, extras):
    """The doc tiles (forced, whatever merge_plan would choose) against
    the plain version and the probes on the same card rows, bit for bit,
    twice: sums, mask, count and, with extras, group bits, deletes, a tree
    and orbits."""
    from test_torch_slices_design import merge_world

    kw = dict(MERGE_CASES[case])
    B, widths, nd = kw.pop("B"), kw.pop("widths"), kw.pop("nd")
    ids, w = merge_world(11, B, widths, nd, **kw)
    T = len(widths)
    g = torch.Generator().manual_seed(3)
    bits = deleted = prog = None
    if extras:
        bits = (1 << torch.randint(0, 3, (B, T), generator=g)).to(
            torch.int32).to(cuda)
        deleted = (torch.rand(nd + 1, generator=g) < 0.05).to(cuda)
        prog = kernels.tree_program(("OR", ("G", 0), ("AND", ("G", 1),
                                                      ("G", 2))))
    ids, w = ids.to(cuda), w.to(cuda)
    args = (ids, w, widths, bits, deleted, prog, extras)
    plain = kernels._merge_docs_plain(*args)
    # the tiles over the docids, and over too few (the last tile's
    # probes); the probes
    for tiles, n_docs in ((True, nd + 1), (True, 1000), (False, nd + 1)):
        with _tiles_forced(tiles):
            got = _twice(lambda: kernels.merge_docs(*args, n_docs=n_docs))
        assert _equal(got[0], plain[0]), (case, n_docs)
        for a, b in zip(got[1:], plain[1:]):
            assert (a is None and b is None) or torch.equal(a, b), \
                (case, n_docs)
    if case == "all_sentinel":
        assert int(plain[2].sum()) == 0
    torch.cuda.synchronize()


def test_merge_docs_rule_border_matches_plain_version(cuda):
    """At merge_plan's border (four equal terms over a million docids: the
    width where the probes give way to the tiles), both sides by the rule
    and by the probes equal the plain version."""
    from test_torch_slices_design import merge_world

    nd = 1_000_000
    lo, hi = 1, 1 << 20
    while lo < hi:   # the least width the tiles take
        mid = (lo + hi) // 2
        if kernels.merge_plan((mid,) * 4, nd + 1):
            hi = mid
        else:
            lo = mid + 1
    assert 1 < lo < 1 << 20
    for W in (lo - 1, lo):
        ids, w = merge_world(W, 3, (W,) * 4, nd, fill=1.0)
        ids, w = ids.to(cuda), w.to(cuda)
        plain = kernels._merge_docs_plain(ids, w, (W,) * 4)
        for how in ("rule", "probes"):
            with _tiles_forced(False) if how == "probes" else \
                    contextlib.nullcontext():
                got = _twice(lambda: kernels.merge_docs(ids, w, (W,) * 4,
                                                        n_docs=nd + 1))
            assert _equal(got[0], plain[0]) and \
                torch.equal(got[1], plain[1]) and \
                torch.equal(got[2], plain[2]), (W, how)
    torch.cuda.synchronize()


# -- slice 15: merge_special's doc tiles; kmeans, one launch a call ----------

@contextlib.contextmanager
def _special_forced(design, tile=None):
    """merge_special by the probes or by the doc tiles (of ``tile``
    docids, else the rule's tile, else 1024) inside the block, whatever
    kernels.special_plan would choose."""
    rule = kernels.special_plan

    def tiles(w, n, p):
        t = tile or rule(w, n, p)[1] or 1024
        return -(-int(n) // t), t

    kernels.special_plan = tiles if design == "tiles" else \
        (lambda w, n, p: (0, 0))
    try:
        yield
    finally:
        kernels.special_plan = rule


@pytest.mark.parametrize("label", ["bm25", "tfidf", "pl2", "dicecoeff",
                                   "lm-absolute_discount"])
def test_merge_special_designs_match_plain_version(browse, label):
    """merge_special on the browse S and X groups under a scheme (BM25's
    own instance and the generic one, two constants a term, uniqterms),
    by the rule, the probes, and the doc tiles of 4096 and 1024 docids,
    each forced: every design equal to the plain version bit for bit (a
    NaN equal to a NaN), twice, one launch a call."""
    from xapiand_tpu_torch.utils import synth_schemes as ss

    corpus, searcher, qs, _aggs = browse
    scheme = _config(label) if label != "bm25" else searcher.scheme
    st = ss.real_stats(corpus.seg)
    spec = scheme.kernel_spec(st)
    seg = searcher.device_segment.arrays_pytree()
    n_docs = seg["deleted"].shape[0]
    uniq = torch.from_numpy(ss.uniqterms(corpus.seg)).to(searcher.device) \
        if spec.needs_uniq else None
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    seen = set()
    for cfg, _fn, batch, _chunk in _plans(searcher, qs, "SX",
                                          scheme=scheme):
        _p, _i, widths, prefix, _s = _inputs(searcher, cfg, batch)
        ids, w, _ = kernels.score_slices(
            post, None, batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, prefix, spec, uniq)
        args = (ids, w, widths, batch["group_bits"], batch["offsets"],
                seg["post_wdf"], seg["post_doclen"], cfg.max_specs,
                cfg.syn_groups, batch.get("syn_tconst"), spec, uniq)
        want = kernels._merge_special_plain(*args)
        for design, tile in (("rule", None), ("probes", None),
                             ("tiles", 4096), ("tiles", 1024)):
            with _special_forced(design, tile) if design != "rule" else \
                    contextlib.nullcontext():
                n0 = kernels.launches["merge_special"]
                got = _twice(lambda: kernels.merge_special(*args,
                                                           n_docs=n_docs))
                assert kernels.launches["merge_special"] == n0 + 2
            assert _equal(got, want), (label, design, tile)
        seen.add("syn" if cfg.syn_groups else "max")
    assert seen == {"syn", "max"}
    torch.cuda.synchronize()


@pytest.mark.parametrize("P", [20, 34])
def test_merge_special_wide_plans_match_plain_version(cuda, P):
    """Plans of many channels over a million docids (shared docs, synonym
    groups and overlapping masks): at 20 channels special_plan halves the
    tile to 2048, at 34 (past the tiles' channel word) it takes the
    probes; by the rule, the probes and the tiles (where they fit), each
    equal to the plain version bit for bit."""
    from test_torch_special_kmeans_design import special_world

    branches = (1, 2, 4, 8, 16, 32) * 6
    max_specs = (branches[:P - 2],) if P == 20 else (branches[:32],)
    widths = (65536, 32768, 16384, 4096)
    args = special_world(21, 3, widths, 1_000_000, max_specs, (0b101,),
                         hot=300_000, fill=0.9, scheme="pl2")
    P_ = kernels.special_channels(max_specs, (0b101,))
    assert P_ == (20 if P == 20 else 34)
    rule = kernels.special_plan(widths, 1_000_001, P_)
    assert rule[1] == (2048 if P_ <= 24 else 0)
    args = tuple(x.to(cuda) if isinstance(x, torch.Tensor) else x
                 for x in args)
    want = kernels._merge_special_plain(*args)
    designs = [("rule", None), ("probes", None)] + \
        ([("tiles", 2048), ("tiles", 1024)] if P_ <= 32 else [])
    for design, tile in designs:
        with _special_forced(design, tile) if design != "rule" else \
                contextlib.nullcontext():
            got = _twice(lambda: kernels.merge_special(*args,
                                                       n_docs=1_000_001))
        assert _equal(got, want), (P_, design, tile)
    torch.cuda.synchronize()


def _kmeans_held(X, C0, iters, got):
    """One kmeans_loop result with its history against the plain version
    step by step from the kernel's own centroids: labels equal outside the
    margin (ops/cluster.py near_ties), the next centroids within rtol 1e-5
    where the labels agree; the first step's centroids C0 bit for bit."""
    from xapiand_tpu_torch.ops import cluster

    labels, C, (hl, hc) = got
    assert hl.shape == (iters, X.shape[0]) and \
        hc.shape == (iters, *C0.shape)
    if iters:
        assert torch.equal(hc[0], C0)
    nexts = [hc[t + 1] for t in range(iters - 1)] + [C]
    for t in range(iters):
        want_l, want_c = kernels.kmeans_step_plain(X, hc[t])
        outside = torch.from_numpy(~cluster.near_ties(
            X.cpu().numpy(), hc[t].cpu().numpy())).to(X.device)
        assert torch.equal(hl[t][outside], want_l[outside]), t
        if torch.equal(hl[t], want_l):
            torch.testing.assert_close(nexts[t], want_c, rtol=1e-5, atol=0)
    want_l, _ = kernels.kmeans_step_plain(X, C, update=False)
    outside = torch.from_numpy(~cluster.near_ties(
        X.cpu().numpy(), C.cpu().numpy())).to(X.device)
    assert torch.equal(labels[outside], want_l[outside])


@pytest.mark.parametrize("n,v,k", [(4096, 2048, 16), (256, 2048, 8),
                                   (10, 300, 3), (37, 17, 20), (1, 5, 1)])
def test_kmeans_loop_matches_plain_version(cuda, n, v, k):
    """A kmeans_cosine call in one launch at the five shapes of
    test_kmeans_matches_plain_version: with its history every step held to
    kmeans_step_plain from the kernel's own centroids (the margin rule,
    rtol 1e-5), twice bit for bit, the history changing nothing, one
    launch a call; at the cluster size and count kmeans_plan takes, in one
    cluster, and at 1 and 4 blocks a cluster (KMEANS_CLUSTER,
    KMEANS_GRID)."""
    k = min(k, n)
    X = torch.from_numpy(_unit_rows(n, v, max(k, 1), seed=n + v)).to(cuda)
    C0 = X[torch.arange(k, device=cuda) * (n // k)].clone()
    sizes, grids = set(), set()
    full = (kernels.KMEANS_CLUSTER, kernels.KMEANS_GRID)
    for cap, grid in (full, (full[0], 1), (4, full[1]), (1, full[1])):
        saved = kernels.KMEANS_CLUSTER, kernels.KMEANS_GRID
        kernels.KMEANS_CLUSTER, kernels.KMEANS_GRID = cap, grid
        try:
            plan = kernels.kmeans_plan(n, v, k)
            sizes.add(plan[0])
            grids.add(plan[3])
            n0 = kernels.launches["kmeans"]
            got = _twice(lambda: kernels.kmeans_loop(X, C0, 6, history=True))
            plain = kernels.kmeans_loop(X, C0, 6)
            assert kernels.launches["kmeans"] == n0 + 3
        finally:
            kernels.KMEANS_CLUSTER, kernels.KMEANS_GRID = saved
        assert torch.equal(plain[0], got[0]) and \
            torch.equal(plain[1].view(torch.int32), got[1].view(torch.int32))
        _kmeans_held(X, C0, 6, got)
        print(f"n{n} V{v} k{k}: plan {plan}")
    if v >= 2048:
        assert max(sizes) == kernels.KMEANS_CLUSTER
    if n >= 4096:
        assert max(grids) > 1
    torch.cuda.synchronize()


def test_kmeans_loop_workspace_matches_plain_version(cuda):
    """k * V past a cluster's shared memory (k 300 at V 2048): one block
    with its buffers in a device workspace, held the same way."""
    n, v, k = 600, 2048, 300
    assert kernels.kmeans_plan(n, v, k)[2]
    X = torch.from_numpy(_unit_rows(n, v, 40, seed=5)).to(cuda)
    C0 = X[torch.arange(k, device=cuda) * 2].clone()
    got = _twice(lambda: kernels.kmeans_loop(X, C0, 3, history=True))
    _kmeans_held(X, C0, 3, got)
    torch.cuda.synchronize()


def test_kmeans_step_is_a_loop_of_one_step(cuda):
    """kernels.kmeans (one step; the assignment alone) equals kmeans_loop of
    one step (of none, with the last assignment) bit for bit."""
    X = torch.from_numpy(_unit_rows(256, 2048, 8, seed=3)).to(cuda)
    C = X[torch.arange(8, device=cuda) * 32].clone()
    l1, c1 = kernels.kmeans(X, C)
    l2, c2 = kernels.kmeans_loop(X, C, 1, assign_last=False)
    assert torch.equal(l1, l2) and \
        torch.equal(c1.view(torch.int32), c2.view(torch.int32))
    l0, none = kernels.kmeans(X, C, update=False)
    assert none is None and torch.equal(l0, kernels.kmeans_loop(X, C, 0)[0])
    assert torch.equal(l0, l1)
    torch.cuda.synchronize()


# agg_metrics (K17a) and agg_ranges (K17c-2) as one launch of warp row
# queues: the CPU emulations of tests/test_torch_metrics_ranges_design.py

METRIC_CASES = {"count": {"M": 0}, "one": {"M": 1}, "three": {"M": 3,
                                                             "signs": True},
                "eight": {"M": 8}, "crowd": {"M": 2, "crowd": True},
                "none": {"M": 2, "p_elig": 0.0}}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
@pytest.mark.parametrize("B,R", [(1, 82048), (5, 20011), (64, 40000)])
def test_agg_metrics_one_launch_matches_plain_version(cuda, case, B, R):
    """agg_metrics' one launch (flags first, the eligible rows queued and
    drained a row a lane, the last block's fold) against the plain
    version: the count alone, 1, 3 and 8 channels, eligible rows in one
    crowded run, none; one query, five of rows that do not start on 16,
    64 of several blocks each. Counts, n, min and max equal, s2 within
    rtol 1e-5, s within 1e-5 of the sums of |value|, the same bits twice
    and, where the CPU emulation is quick, its bits."""
    import test_torch_metrics_ranges_design as md

    ids, elig, cols = md.metrics_case(70 + B, B, R, nd=60000,
                                      **METRIC_CASES[case])
    want = kernels._agg_metrics_plain(ids, elig, cols)
    dcols = [(f.to(cuda), p.to(cuda)) for f, p in cols]
    got = _twice(lambda: kernels.agg_metrics(ids.to(cuda), elig.to(cuda),
                                             dcols))
    got = tuple(x.cpu() for x in got)
    md.check_metrics(got, want, cols, ids, elig)
    if B * R <= 110000:
        emu = md.emulate_agg_metrics(ids, elig, cols)
        for g, e in zip(got, emu):
            assert torch.equal(g, e)


RANGE_CUDA = {"range_sub": ("range", 5, 1, 1, 57472, False),
              "range_member": ("range", 7, 2, 6, 20011, True),
              "geodist": ("geodist", 4, 0, 1, 65664, False),
              "key_sub": ("key", 8, 1, 1, 57472, False),
              "geo_ip": ("geo_ip", 16, 2, 6, 20011, True),
              "wide_subs": ("range", 300, 3, 2, 9000, False),
              "key_wide": ("key", 4096, 0, 1, 300, False),
              "geo_ip_wide": ("geo_ip", 2048, 1, 1, 40, True),
              "none": ("key", 8, 2, 3, 5000, False)}


@pytest.mark.parametrize("case", sorted(RANGE_CUDA))
def test_agg_ranges_one_launch_matches_plain_version(cuda, case):
    """agg_ranges' one launch in every mode (the ranges staged, geo_ip's
    intervals grouped by bucket, the key words one gather, subs on the
    warps' partials in shared or device memory, the last block's fold)
    against the plain version: counts and member bytes equal, sub n, min,
    max equal, s and s2 within rtol 1e-5, the same bits twice and, where
    the CPU emulation is quick, its bits; no eligible row ("none")."""
    import test_torch_metrics_ranges_design as md

    mode, nb, S, B, R, member = RANGE_CUDA[case]
    args, kw = md.range_case(80 + nb, mode, B, R, nb, S, nd=3000,
                             p_elig=0.0 if case == "none" else 0.4)

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(cuda)
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(to(v) for v in x)
        return x

    want = kernels._agg_ranges_plain(*args, **kw, want_member=member)
    got = _twice(lambda: kernels.agg_ranges(*to(args), **to(kw),
                                            want_member=member))
    got = tuple(None if x is None else to_cpu(x) for x in got)
    md.check_ranges(got, want, S)
    if member:
        assert torch.equal(got[2], want[2])
    if B * R * nb <= 2_000_000 and B * R <= 60000:
        emu = md.emulate_agg_ranges(*args, **kw)
        assert torch.equal(got[0], emu[0])
        if S:
            for s in range(5):
                assert torch.equal(got[1][s], emu[1][s]), s


def to_cpu(x):
    return tuple(y.cpu() for y in x) if isinstance(x, tuple) else x.cpu()


def test_agg_ranges_refuses_a_key_column_without_packed_keys(cuda):
    import test_torch_metrics_ranges_design as md

    (ids, elig, mode, col, bounds, nb, subs), kw = md.range_case(
        5, "key", 1, 100, 4, 0)
    bare = {c: v.to(cuda) for c, v in col.items() if c != "keys"}
    with pytest.raises(ValueError, match="without its packed keys"):
        kernels.agg_ranges(ids.to(cuda), elig.to(cuda), mode, bare,
                           bounds.to(cuda), nb, **kw)


# agg_hist (K17c-3) as one launch of warp row queues and wide_topk (K4+K8
# wide) as row tiles and a merge: the CPU emulations of
# tests/test_torch_hist_wide_design.py

def _hist_scratch_zero(cuda):
    """agg_hist's kept scratch on the card (if made) is all zeros."""
    t = kernels._KEPT.get(("agg_hist", cuda.type, cuda.index or 0))
    return t is None or not bool(t.any())


@pytest.mark.parametrize("case", ["one_b1", "one_many_blocks",
                                  "one_small_bins", "one_none", "codes",
                                  "codes_b3", "member", "member_b2",
                                  "codes_none"])
@pytest.mark.parametrize("flout", [True, False])
def test_agg_hist_one_launch_matches_plain_version(cuda, case, flout,
                                                   monkeypatch):
    """agg_hist's one launch (the top level's last-block conversion, hist2
    by float atomics or by the zero-kept scratch and a grid barrier)
    against the plain version and the CPU emulation, bit for bit, twice;
    one launch counted a call; the kept scratch zero after it."""
    import test_torch_hist_wide_design as hw

    monkeypatch.setattr(kernels, "HIST2_FLOAT", flout)
    mode, B, R, nb, nbins, p = hw.HIST_CASES[case]
    args, kw = hw.hist_case(sorted(hw.HIST_CASES).index(case), B, R, nbins,
                            mode, nb, p_elig=p)
    want = kernels._agg_hist_plain(*args, **kw)
    dargs = [x.to(cuda) if isinstance(x, torch.Tensor) else x for x in args]
    dkw = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    n0 = kernels.launches["agg_hist"]
    got = _twice(lambda: kernels.agg_hist(*dargs, **dkw)).cpu()
    torch.cuda.synchronize()
    assert kernels.launches["agg_hist"] == n0 + 2
    assert torch.equal(got, want)
    assert torch.equal(got, hw.emulate_agg_hist(*args, **kw)[0])
    assert _hist_scratch_zero(cuda)


@pytest.mark.parametrize("fill", [1, 33, 528])
def test_agg_hist_fills_match_plain_version(cuda, fill, monkeypatch):
    """The top level and hist2 at other row_plan fills (one block a query,
    blocks of 16 rows a warp): the same counts."""
    import test_torch_hist_wide_design as hw

    monkeypatch.setattr(kernels, "HIST_FILL", fill)
    monkeypatch.setattr(kernels, "HIST2_FILL", fill)
    for mode, nb in (("one", 1), ("codes", 7)):
        args, kw = hw.hist_case(fill, 2, 40000, 2048, mode, nb)
        want = kernels._agg_hist_plain(*args, **kw)
        dargs = [x.to(cuda) if isinstance(x, torch.Tensor) else x
                 for x in args]
        dkw = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        assert torch.equal(kernels.agg_hist(*dargs, **dkw).cpu(), want)
    assert _hist_scratch_zero(cuda)


@pytest.mark.parametrize("case", ["uniform", "deep", "special", "few"])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k,tiles", [(300, None), (300, 512), (700, 512),
                                     (5000, None)])
def test_wide_topk_rows_tiles_match_plain_version(cuda, case, tie, k, tiles,
                                                  monkeypatch):
    """topk_rows' wide mode (its tiles' radix passes, the merge by ranks)
    against the plain version and the CPU emulation of the same plan, bit
    for bit, twice; one launch counted a call."""
    import test_torch_hist_wide_design as hw

    if tiles:
        hw.small_tiles(monkeypatch, tile=tiles)
    s, d, o, t = hw.wide_rows_case(case, 3, 4000, k + len(case), tie)
    args = [x.to(cuda) for x in (s, d, o)]
    tt = t.to(cuda) if tie else None
    n0 = kernels.launches["wide_topk"]
    got = _twice(lambda: kernels.topk_rows(*args, k, tt))
    torch.cuda.synchronize()
    assert kernels.launches["wide_topk"] == n0 + 2
    got = tuple(x.cpu() for x in got)
    for a, b in zip(got, kernels._topk_rows_plain(s, d, o, k, t)):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for a, b in zip(got, hw.wide_rows_answer(s, d, o, k, t)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("n_keys,k", [(1, 80), (20, 10), (40, 10), (3, 700)])
@pytest.mark.parametrize("tiles", [None, 300])
def test_wide_sort_topk_tiles_match_plain_version(cuda, n_keys, k, tiles,
                                                  monkeypatch):
    """sort_topk's wide mode at 4 to 82 key words (ties deep through the
    repeated columns), k past the eligible rows at 700, against the plain
    version and the CPU emulation, emitted key words included, twice."""
    import test_torch_hist_wide_design as hw

    if tiles:
        hw.small_tiles(monkeypatch, tile=tiles)
    specs, (ids, sums, elig), values = hw.table_world(2, 1200, n_keys,
                                                      n_keys)
    dv = {c: {ch: x.to(cuda) for ch, x in col.items()}
          for c, col in values.items()}
    got = _twice(lambda: kernels.sort_topk(specs, ids.to(cuda),
                                           sums.to(cuda), elig.to(cuda), k,
                                           dv, emit=True))
    got = tuple(x.cpu() for x in got)
    cols = [values[sp[1]] for sp in specs]
    want = kernels._sort_topk_plain(specs, cols, ids, sums, elig, k, None,
                                    {}, None, True)
    emu, _ = hw.wide_sort_answer(specs, ids, sums, elig, k, values)
    for a, b, c in zip(got, want, emu):
        assert a.numpy().tobytes() == b.numpy().tobytes()
        assert a.numpy().tobytes() == c.numpy().tobytes()


def test_wide_sort_topk_table_shape_matches_plain_version(cuda):
    """The key-word table's sort at chip_smoke.py's shape (B4 R262144, 40
    value keys, 82 words, k 10): several tiles a query, every buffer in
    shared memory, equal to the plain version."""
    import test_torch_hist_wide_design as hw

    specs, (ids, sums, elig), values = hw.table_world(4, 262144, 40, 12)
    plan = kernels.wide_plan(4, 262144, 10, 82)
    assert plan[0] > 1 and plan[3] == 0
    dv = {c: {ch: x.to(cuda) for ch, x in col.items()}
          for c, col in values.items()}
    da = [x.to(cuda) for x in (ids, sums, elig)]
    got = _twice(lambda: kernels.sort_topk(specs, *da, 10, dv))
    cols = [dv[sp[1]] for sp in specs]
    want = kernels._sort_topk_plain(specs, cols, *da, 10, None, {})
    for a, b in zip(got, want):
        assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


# --------------------------------------------------------------------------
# fullwidth_topk's warp lists, shard_merge's staged ranks, compact_rows'
# cases: from tests/test_torch_fullwidth_shard_design.py
# --------------------------------------------------------------------------

FW_PLANS = (None, (1, 32), (1, 1), (3, 4), (17, 2))


@pytest.mark.parametrize("plan", FW_PLANS)
@pytest.mark.parametrize("case", ["random", "few", "none", "kk_R",
                                  "hi_collide", "zeros", "nan_inf",
                                  "nan_few", "strmetric", "geodist",
                                  "cert_ties", "many_ties", "dense"])
def test_fullwidth_topk_lists_match_plain_version(cuda, case, plan,
                                                  monkeypatch):
    """fullwidth_topk's warp buffers and block merge on every named case
    (fewer than k eligible rows, none, kk = R, hi words one float32 image,
    -0.0 and +0.0, NaN and +-inf keys, NaN keys in the first k, ties on
    the image across k - 1 and kk - 1, more than MAX_FULLWIDTH_KK rows on
    one key, warps whose buffers overflow mid-walk), at the launch's plan
    and at forced ones (one block, one group a warp a step, blocks of a
    few warps' rows, more blocks than a merge warp takes): bit for bit the
    plain version and the emulation, twice."""
    import test_torch_fullwidth_shard_design as fs

    c = fs.fw_case(case, seed=1, k=60 if case == "many_ties" else 10)
    if plan is not None:
        monkeypatch.setattr(kernels, "fullwidth_plan", lambda B, R: plan)
    spec, col, ids, sums, elig, k, tg, st = c
    dcol = {ch: x.to(cuda) for ch, x in col.items()}
    got = _twice(lambda: kernels.fullwidth_topk(
        spec, ids.to(cuda), sums.to(cuda), elig.to(cuda), k,
        {spec[1]: dcol}, tg.to(cuda), {i: t.to(cuda) for i, t in st.items()}))
    want = fs.fw_plain(c)
    emu = fs.emulate_fullwidth(*c, plan=plan)
    for a, b, e in zip(got, want, emu):
        assert a.cpu().numpy().tobytes() == b.tobytes()
        assert a.cpu().numpy().tobytes() == np.asarray(e).tobytes()


@pytest.mark.parametrize("kind", ["value", "dist"])
def test_fullwidth_topk_wide_launch_matches_plain_version(cuda, kind):
    """A launch of several blocks a query whose warps fill their lists
    many times over (B4 R400000, 30% eligible, k 64: kk 128, the widest
    list): equal to the plain version, twice."""
    import test_torch_fullwidth_shard_design as fs

    c = list(fs.fw_case("random", B=4, R=400_000, seed=9, k=64,
                        n_docs=300_000))
    if kind == "dist":
        c[0] = ("dist", fs.SLOT, True)
    spec, col, ids, sums, elig, k, tg, st = c
    assert kernels.fullwidth_plan(4, 400_000)[0] > 1
    dcol = {ch: x.to(cuda) for ch, x in col.items()}
    got = _twice(lambda: kernels.fullwidth_topk(
        spec, ids.to(cuda), sums.to(cuda), elig.to(cuda), k,
        {spec[1]: dcol}, tg.to(cuda), {}))
    want = fs.fw_plain(c)
    for a, b in zip(got, want):
        assert a.cpu().numpy().tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["relevance", "okey", "keys", "chunk", "k1",
                                  "s1", "wide", "global"])
def test_shard_merge_staged_ranks_match_plain_version(cuda, case):
    """shard_merge's planes in shared memory (in the device scratch for
    the global case) and its counted ranks, through the shard_merge
    wrapper or, unstriped, chunk_merge's: bit for bit the plain version
    and the emulation, twice."""
    import test_torch_fullwidth_shard_design as fs

    c = fs.merge_case(case, seed=3)
    d, s, ok, keys, stripe = c
    dv = [None if x is None else x.to(cuda) for x in (d, s, ok, keys)]
    if stripe:
        got = _twice(lambda: kernels.shard_merge(*dv))
    else:
        got = _twice(lambda: kernels.chunk_merge(dv[0], dv[1]))
    want = fs.merge_plain(*c)
    emu = fs.emulate_merge(*c)
    for a, b, e in zip(got, want, emu):
        assert a.cpu().numpy().tobytes() == b.tobytes() == e.tobytes()


@pytest.mark.parametrize("case", ["orbits", "no_orbits", "full", "zero",
                                  "run"])
def test_compact_rows_cases_match_plain_version(cuda, case):
    """compact_rows with and without orbits, count = cap, count 0, a run
    of masked rows across the kernel's chunks: bit for bit the plain
    version, twice."""
    import test_torch_fullwidth_shard_design as fs

    c = fs.compact_case(case, B=3, R=30000, seed=2)
    got = _twice(lambda: kernels.compact_rows(
        *(x.to(cuda) if isinstance(x, torch.Tensor) else x for x in c)))
    want = fs.compact_plain(c)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.cpu().numpy().tobytes() == b.tobytes()


def test_compact_rows_past_the_cap_keeps_the_first_rows(cuda):
    """Past the cap the kernel writes the first cap rows in row order and
    reports the full count (the plain version refuses)."""
    import test_torch_fullwidth_shard_design as fs

    mask, ids, sums, orbits, _cap = fs.compact_case("orbits", seed=4)
    got = _twice(lambda: kernels.compact_rows(
        mask.to(cuda), ids.to(cuda), sums.to(cuda), orbits.to(cuda), 50))
    want = fs.compact_expect(mask, ids, sums, orbits, 50)
    for a, e in zip(got, want):
        assert a.cpu().numpy().tobytes() == e.tobytes()
