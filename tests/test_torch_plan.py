"""The port's query/plan.py is the JAX package's, apart from its package
imports (ExecConfig and the host modules come from the port); bound plans
and BatchSearcher launch groups come out the same from both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import xapiand_tpu.query.plan as jplan
import xapiand_tpu_torch.query.plan as pplan
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.models.weights import get_scheme as jscheme
from xapiand_tpu.query.ir import Q
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu.utils.synth import build_synthetic_segment, sample_queries
from xapiand_tpu_torch.models.weights import CollectionStats as PStats
from xapiand_tpu_torch.models.weights import get_scheme as pscheme
from xapiand_tpu_torch.ops.executor import ExecConfig
from xapiand_tpu_torch.search import BatchSearcher as PBatch
from xapiand_tpu_torch.search import SegmentSearcher as PSearcher

# the OR corpora of tests/test_prefix.py: (n_docs, vocab, seed, queries,
# query seed, max_df_frac)
CORPORA = {
    "zipf": (4000, 300, 3, 48, 5, 0.1),
    "short": (4000, 300, 7, 32, 9, 0.1),
    "ties": (2000, 200, 1, 16, 2, 1.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _corpus(name):
    n, vocab, seed, nq, qseed, frac = CORPORA[name]
    seg = build_synthetic_segment(n, vocab, seed=seed)
    if name == "ties":
        seg.post_wdf[:] = 1.0
        seg.doclen[:n] = 50.0
        seg.post_doclen[:] = 50.0
        seg.total_doclen = 50.0 * n
    qs = sample_queries(seg, nq, 3, seed=qseed, max_df_frac=frac)
    return seg, [Q.or_terms(sorted(q, key=lambda t: -seg.terms[t].length))
                 for q in qs]


def test_plan_is_the_jax_file_but_one_import():
    """Only the package imports differ: ExecConfig comes from the port's
    executor, and the host modules from the port's copies of them."""
    def lines(mod):
        with open(mod.__file__) as f:
            return f.read().splitlines()

    j, p = lines(jplan), lines(pplan)
    assert len(j) == len(p)
    diff = [(a, b) for a, b in zip(j, p) if a != b]
    assert ("from xapiand_tpu.ops.executor import ExecConfig",
            "from xapiand_tpu_torch.ops.executor import ExecConfig") in diff
    assert len(diff) == 5
    for a, b in diff:
        assert a.lstrip().startswith("from xapiand_tpu.")
        assert b == a.replace("from xapiand_tpu.", "from xapiand_tpu_torch.")
    assert pplan.ExecConfig is ExecConfig


def test_exec_config_fields_are_jax_fields():
    from xapiand_tpu.ops.executor import ExecConfig as JCfg

    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(JCfg)]
    pf = [(f.name, f.type, f.default) for f in dataclasses.fields(ExecConfig)]
    assert pf == jf


def _bind_both(seg, ir, k=10):
    jst = JStats(doc_count=seg.doc_count, avg_doclen=seg.avg_doclen)
    pst = PStats(doc_count=seg.doc_count, avg_doclen=seg.avg_doclen)
    jb = jplan.bind(jplan.compile_ir(ir), seg, jscheme("bm25"), jst, k=k)
    pb = pplan.bind(pplan.compile_ir(ir), seg, pscheme("bm25"), pst, k=k)
    return jb, pb


def _assert_bound_equal(jb, pb):
    assert dataclasses.asdict(pb.cfg) == dataclasses.asdict(jb.cfg)
    assert sorted(pb.arrays) == sorted(jb.arrays)
    for key, arr in jb.arrays.items():
        got = np.asarray(pb.arrays[key])
        assert got.dtype == np.asarray(arr).dtype, key
        np.testing.assert_array_equal(got, np.asarray(arr), err_msg=key)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_bind_equal_on_or_queries(corpus):
    seg, irs = _corpus(corpus)
    for ir in irs:
        _assert_bound_equal(*_bind_both(seg, ir))


@pytest.mark.parametrize("n_terms", [1, 3, 5, 9])
def test_bind_equal_with_term_padding(n_terms):
    """T pads up to a bucket (1, 2, 4, 8, 16): the padded positions carry
    zero offsets/lens/tconst and class 128 on both sides; an unknown term
    binds as an empty span."""
    seg, _ = _corpus("zipf")
    terms = sorted(seg.terms, key=lambda t: -seg.terms[t].length)
    ir = Q.or_terms(terms[5: 5 + n_terms - 1] + ["no-such-term"])
    jb, pb = _bind_both(seg, ir)
    assert pb.cfg.T >= n_terms and pb.cfg.T & (pb.cfg.T - 1) == 0
    _assert_bound_equal(jb, pb)


@pytest.mark.parametrize("prefix_cap", [0, 128, 256])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_batch_plan_groups_equal(corpus, prefix_cap):
    """BatchSearcher.plan: same groups, unified configs (prefix included),
    query chunks (wraparound padding) and stacked batch arrays."""
    seg, irs = _corpus(corpus)
    jp = JBatch(JSearcher(seg, jscheme("bm25")), k=10,
                prefix_cap=prefix_cap).plan(irs)
    pp = PBatch(PSearcher(seg, device=torch.device("cpu")), k=10,
                prefix_cap=prefix_cap).plan(irs)
    assert len(pp) == len(jp)
    for (jc, _jf, jb, jch), (pc, _pf, pb, pch) in zip(jp, pp):
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        assert pch == jch
        for key, t in pb.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jb[key]),
                                          err_msg=key)
    if prefix_cap:
        assert any(c.prefix for c, *_ in pp)
