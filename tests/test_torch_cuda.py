"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest tests/test_torch_cuda.py

Inputs are the real launch groups of a small synthetic corpus
(BatchSearcher.plan), both exact and impact-prefix mode. Tolerances: the
kernels evaluate the same float32 expressions in the same order as the
plain versions (nvcc -fmad=false), so docids, owners, counts and
certificates must be equal and floats agree to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
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

        sums, owner, count = kernels.merge_docs(ids, w, widths)
        psums, powner, pcount = kernels._merge_docs_plain(ids, w, widths)
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
