"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here but the last needs a CUDA device and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
without them:

    python -m pytest --noconftest tests/test_torch_cuda.py

Inputs are the real launch groups of two small synthetic corpora
(BatchSearcher.plan): the relevance corpus in exact and impact-prefix
mode, and the faceted corpus (utils/synth_faceted.py) with its four query
families, plus synthetic columns for every sort key kind. Tolerances: the
kernels evaluate the same float32 expressions in the same order as the
plain versions (nvcc -fmad=false), so docids, masks, bits, packed rows,
counts and certificates must be equal and floats agree to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from xapiand_tpu_torch.models.segment import device_segment_from_numpy
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import upper_tree
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_faceted as sf
from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                           sample_queries)

pytestmark = pytest.mark.cuda


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
    params = searcher.scheme.kernel_params(searcher.segment)
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
    sorted_bs = BatchSearcher(searcher, k=10, prefix_cap=8192,
                              sort=(("value", sf.PRICE_SLOT, True),))
    rel_bs = BatchSearcher(searcher, k=10, prefix_cap=8192)
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
    for bs, irs in fams:
        kernels.reset_launches()
        got = bs.run(irs)
        assert kernels.launches["merge_docs"] > 0
        assert kernels.launches["prefix_certify"] == 0
        want = BatchSearcher(cpu, k=10, prefix_cap=8192, sort=bs.sort).run(
            irs)
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g["docids"], e["docids"])
            np.testing.assert_allclose(g["scores"], e["scores"], rtol=1e-6)
            assert g["count"] == e["count"]


def test_faceted_corpus_is_pinned():
    """The faceted corpus and queries come out the same under any numpy
    release (PCG64 draws through searchsorted): this hash was taken under
    numpy 2.0.2 and must hold wherever the file runs, the card's machine
    included. Needs no card."""
    c = sf.build_faceted_corpus(20000, seed=7)
    fp = sf.fingerprint(c)
    assert (fp["sha256"], fp["postings"], fp["values"], fp["deleted"]) == \
        ("4c48234d729a2984", 228180, 59941, 208), fp
    qs = sf.faceted_queries(8, seed=11)
    assert [p for _f, _q, p in qs][::8] == [
        {"cat": 2, "w": 190}, {"cat": 13, "w": 71, "p": 75},
        {"w": 6, "s": 37}, {"a": 62, "b": 148, "cat": 1}]
