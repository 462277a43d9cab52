"""BM25 of the torch port against the JAX package's, on the same inputs.

term_constant is the same float64 host arithmetic (equal); sumpart is a
float32 device formula evaluated in the same operation order (rtol 1e-6);
impact_np is the same numpy code (equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xapiand_tpu.models import weights as jw
from xapiand_tpu_torch.models import weights as pw

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


def test_other_schemes_name_their_roadmap_item():
    assert isinstance(pw.get_scheme("BM25"), pw.BM25)
    for name in ("tfidf", "pl2", "lm"):
        with pytest.raises(NotImplementedError, match="K18"):
            pw.get_scheme(name)
