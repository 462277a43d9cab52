"""The Database path's float64 oracle (utils/synth_docs.py) against the
port's Database on the CPU.

The world is the Database path's at a small size: the bank / netlog
corpus indexed through ``Database.index_document`` in three commits, then
1% of the docs deleted and 0.5% replaced, as ``chip_smoke.py``'s
``database_path`` does; every family of its traffic, two searches each,
and eight plain term queries (host-routed). Each answer must equal the
oracle's as the chip gate holds it (hits as tie groups within each doc's
float32 tolerance, counts exact, sums within ``synth_docs.SUM_RTOL``,
medians and percentiles exact). The oracle must also see a fault: an
answer with one bucket count changed, or computed over a corpus whose
values differ from the indexed ones, fails it, and an indexing history
that is not the database's is refused.
"""

import copy

import numpy as np
import pytest
import torch

from xapiand_tpu_torch.database import Database
from xapiand_tpu_torch.utils import synth_docs as sd

N_DOCS, COMMITS = 1500, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    corpus = sd.build_corpus(N_DOCS, seed=7)
    docs = [corpus.doc(i) for i in range(N_DOCS)]
    db = Database(device="cpu")
    per = N_DOCS // COMMITS
    commits = [range(c * per, N_DOCS if c == COMMITS - 1
                     else (c + 1) * per) for c in range(COMMITS)]
    for rows in commits:
        for i in rows:
            db.index_document(docs[i], doc_id=str(i))
        db.commit()
    rng = np.random.Generator(np.random.PCG64(5))
    gone = rng.choice(N_DOCS, N_DOCS // 100, replace=False)
    for i in gone:
        db.delete_document(str(i))
    commits.append(rng.choice(np.setdiff1d(np.arange(N_DOCS), gone),
                              N_DOCS // 200, replace=False))
    for i in commits[-1]:
        db.index_document(docs[int(i)], doc_id=str(i))
    db.commit()
    qs, terms = sd.queries(corpus, n_each=2, n_terms=8, seed=11)
    return (corpus, db, sd.Truth(corpus, db, commits, gone), qs, terms,
            commits, gone)


def _check(db, truth, q, aggs, count_only, r):
    want = sd.oracle_search(db, truth, q, aggs=aggs, count_only=count_only)
    if aggs:
        err = sd.compare_aggs(r.aggregations, want["aggregations"])
        if err:
            return err
    if count_only:
        return None if r.total == want["total"] else \
            f"total {r.total} != {want['total']}"
    return sd.check_hits(db, r, want, 10)


@pytest.mark.parametrize("fam", list(sd.FAMILIES) + ["terms"])
def test_oracle_equals_the_database(world, fam):
    _corpus, db, truth, qs, terms, *_h = world
    cases = [(q, aggs, co) for f, q, aggs, co in qs if f == fam] if \
        fam != "terms" else [(q, None, False) for q in terms]
    assert cases
    for q, aggs, co in cases:
        r = db.search(q, k=10, aggs=aggs, count_only=co)
        assert _check(db, truth, q, aggs, co, r) is None, (fam, q)


def test_oracle_sees_a_changed_count(world):
    _corpus, db, truth, qs, _terms, *_h = world
    _f, q, aggs, co = next(x for x in qs if x[0] == "I")
    r = db.search(q, k=10, aggs=aggs, count_only=co)
    bad = copy.deepcopy(r.aggregations)
    bucket = bad["nets"][next(k for k in bad["nets"] if k != "_doc_count")] \
        if isinstance(bad["nets"], dict) else bad["nets"][0]
    bucket["_doc_count"] += 1
    r.aggregations = bad
    assert _check(db, truth, q, aggs, co, r) is not None


def test_oracle_sees_other_values(world):
    """A corpus whose balances differ from the indexed ones (a fault in
    indexing a value column): the histogram and range answers differ."""
    corpus, db, _truth, qs, _terms, commits, gone = world
    other = copy.copy(corpus)
    other.balance = corpus.balance + 6000.0
    truth = sd.Truth(other, db, commits, gone)
    for fam in "HR":
        _f, q, aggs, co = next(x for x in qs if x[0] == fam)
        r = db.search(q, k=10, aggs=aggs, count_only=co)
        assert _check(db, truth, q, aggs, co, r) is not None, fam


def test_truth_holds_the_id_map(world):
    corpus, db, _truth, _qs, _terms, commits, gone = world
    with pytest.raises(AssertionError, match="id map"):
        sd.Truth(corpus, db, commits, gone[1:])
