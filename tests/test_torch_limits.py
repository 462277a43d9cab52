"""The kernel limits that refused what the JAX package answers (ROADMAP
queue 3, "Port faults"), repaired, each request run through both packages
on the CPU (the port's plain versions) and the answers held equal:

- a relevance page beyond topk_rows' per-thread lists and a sorted page
  beyond sort_topk's (their wide mode, wide_topk.cu), more than three sort
  keys (more than eight key words);
- a phrase or NEAR of more than 16 words (phrase_leaves.cu finds the lists
  past its table again);
- an index's prefix_cap above 16384 (score_slices sorts the prefix block
  in device memory);
- more than 32 value filters (filter_leaves.cu computes each leaf where
  the tree reads it) and a boolean tree deeper than 32 (a 64-bit stack);
- since slice 11, a tree of any depth (tree_program emits each node's
  deepest child first: the stack needs at most log2(leaves) + 1 bits; held
  against JAX's _eval_tree on random trees too) and sorts of any number of
  keys (wide_topk reads key words past 32 from a device-memory table).

The limits found to refuse nothing JAX answers are pinned too: more than
31 phrase or geo leaves, or a deeper tree of term leaves, meet the shared
planner's "more than 31 leaf groups" in both packages first.
"""

import numpy as np
import pytest
import torch

from xapiand_tpu.database import Database as JDB
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.query.dsl import parse_sort as jparse_sort
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.query.plan import PlanError as JPlanError
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu.utils.synth import build_synthetic_segment
from xapiand_tpu_torch.database import Database as PDB
from xapiand_tpu_torch.models.segment import Segment, terms_from
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.query.dsl import parse_sort
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.query.plan import PlanError
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher

RTOL = 1e-5
N_DOCS = 400


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    # every search on the device path (the kernels' plain versions here)
    monkeypatch.setenv("XT_HOST_PATH", "0")


def _doc(i):
    rng = np.random.Generator(np.random.PCG64(i))
    words = " ".join(f"w{int(x)}" for x in rng.integers(0, 30, 24))
    return {"body": words, "n": i, "m": i % 13, "p": int(rng.integers(0, 5)),
            "q": int(rng.integers(0, 4)), "r": float(rng.integers(0, 3)),
            "tag": f"t{i % 7}",
            "loc": {"_point": {"_latitude": 10.0 + i % 9,
                               "_longitude": 20.0 + i % 7}}}


@pytest.fixture(scope="module")
def dbs():
    """The same docs (a repeated 20-word sentence in every fifth) in a JAX
    Database and the port's, two commits each."""
    jdb, pdb = JDB(), PDB(device="cpu")
    sentence = " ".join(f"s{j}" for j in range(20))
    for db in (jdb, pdb):
        for i in range(N_DOCS):
            d = _doc(i)
            if i % 5 == 0:
                d["body"] += " " + sentence
            db.index_document(d, doc_id=str(i))
            if i == N_DOCS // 2:
                db.commit()
        db.commit()
    return jdb, pdb


def _same(got, want, exact_order=True):
    assert got.total == want.total
    assert [h.id for h in got.hits] == [h.id for h in want.hits]
    np.testing.assert_allclose([h.score for h in got.hits],
                               [h.score for h in want.hits], rtol=RTOL)


@pytest.mark.parametrize("case", ["relevance_300", "sorted_70",
                                  "sorted_offset", "keys_4", "keys_5"])
def test_wide_pages_and_sort_keys_match_jax(dbs, case):
    """Pages beyond the per-thread lists (k 300 by relevance, k 70 sorted)
    and 4-5 sort keys: the same hits, in order, as JAX's."""
    jdb, pdb = dbs
    q = {"_or": [{"body": "w3"}, {"body": "w7"}, {"body": "w11"}]}
    aggs = {"c": {"_count": {"_field": "n"}}}
    sort, k, off = [], 10, 0
    if case == "relevance_300":
        k = 300
    elif case == "sorted_70":
        sort, k = [{"p": {"_order": "desc"}}], 70
    elif case == "sorted_offset":
        sort, k, off = [{"q": {"_order": "asc"}}], 40, 30
    elif case == "keys_4":
        sort, k = [{"p": {"_order": "desc"}}, {"q": {"_order": "asc"}},
                   {"m": {"_order": "desc"}}, {"r": {"_order": "asc"}}], 25
    else:
        sort, k = [{"p": {"_order": "asc"}}, {"q": {"_order": "desc"}},
                   {"r": {"_order": "desc"}}, {"m": {"_order": "asc"}},
                   {"tag": {"_order": "desc"}}], 80
    kw = {}
    if sort:
        want = jdb.search(q, k=k, offset=off, aggs=aggs,
                          sort=jparse_sort(jdb.schema, sort))
        got = pdb.search(q, k=k, offset=off, aggs=aggs,
                         sort=parse_sort(pdb.schema, sort))
    else:
        want = jdb.search(q, k=k, offset=off, aggs=aggs, **kw)
        got = pdb.search(q, k=k, offset=off, aggs=aggs, **kw)
    assert len(got.hits) > (64 if sort else 256) or case in (
        "sorted_offset", "keys_4")
    _same(got, want)
    assert got.aggregations == want.aggregations


@pytest.mark.parametrize("words,near", [(17, False), (20, False),
                                        (18, True)])
def test_long_phrase_matches_jax(dbs, words, near):
    """A phrase (or NEAR) of more than 16 words: the same hits as JAX's."""
    jdb, pdb = dbs
    text = " ".join(f"s{j}" for j in range(words))
    body = {"_near": text, "_window": 30} if near else {"_phrase": text}
    want = jdb.search({"body": body}, k=20)
    got = pdb.search({"body": body}, k=20)
    assert want.total == N_DOCS // 5
    _same(got, want)


def test_forty_filters_and_a_deep_tree_match_jax(dbs):
    """40 value filters under one AND, and a tree of alternating AND / OR
    forty deep: the port answers as JAX does."""
    jdb, pdb = dbs
    q = {"_and": [{"body": "w1"}] + [
        {"n": {"_from": j, "_to": N_DOCS - j}} if j % 2 else
        {"m": {"_from": 0, "_to": 12 - (j % 3)}} for j in range(40)]}
    _same(pdb.search(q, k=10), jdb.search(q, k=10))
    deep = {"body": "w3"}
    for j in range(40):
        deep = {"_and" if j % 2 else "_or": [
            {"n": {"_from": j, "_to": N_DOCS - 1 - j}}, deep]}
    want = jdb.search(deep, k=10)
    assert want.total > 0
    _same(pdb.search(deep, k=10), want)


@pytest.mark.parametrize("kind", ["phrases", "geo", "terms_tree"])
def test_leaf_limits_meet_the_planner_first(dbs, kind):
    """40 phrase leaves, 40 geo leaves, a tree of 40 term leaves: both
    packages refuse them in the shared planner (more than 31 leaf groups)
    before any kernel limit (MAX_PHRASES, MAX_GEO, MAX_TREE_DEPTH)."""
    jdb, pdb = dbs
    if kind == "phrases":
        q = {"_or": [{"body": {"_phrase": f"w{j} w{j + 1}"}}
                     for j in range(40)]}
    elif kind == "geo":
        q = {"_or": [{"loc": {"_circle": {"_lat": 10.0 + j, "_lon": 20.0,
                                          "_radius": 1000.0}}}
                     for j in range(40)]}
    else:
        q = {"body": "w0"}
        for j in range(40):
            q = {"_and": [q, {"body": f"w{j % 30}"}]} if j % 2 else \
                {"_or": [{"body": f"w{j % 30}"}, q]}
    with pytest.raises(JPlanError, match="31 leaf groups"):
        jdb.search(q, k=10)
    with pytest.raises(PlanError, match="31 leaf groups"):
        pdb.search(q, k=10)


def test_prefix_cap_beyond_shared_memory_matches_jax():
    """A prefix_cap of 32768 (the REST server admits any power of two from
    128): BatchSearcher's prefix mode over terms of 35-40k postings, the
    same certified top-k, re-runs and counts as JAX's."""
    seg = build_synthetic_segment(40000, 60, seed=3)
    irs = [["t0", "t1", "t7"], ["t2", "t4", "t9"], ["t3", "t12"]]
    js = JSearcher(seg, JBM25())
    want = JBatch(js, k=10, prefix_cap=32768).run(
        [JQ.or_terms(t) for t in irs])
    pseg = Segment(**{**{f: getattr(seg, f) for f in
                         Segment.__dataclass_fields__},
                      "terms": terms_from(seg.terms)})
    bs = BatchSearcher(SegmentSearcher(pseg, device=torch.device("cpu")),
                       k=10, prefix_cap=32768)
    got = bs.run([Q.or_terms(t) for t in irs])
    assert 32768 > kernels.MAX_PREFIX_ROWS
    for g, w in zip(got, want):
        assert int(g["count"]) == int(w["count"])
        assert np.asarray(g["docids"]).tolist() == \
            np.asarray(w["docids"]).tolist()
        np.testing.assert_allclose(np.asarray(g["scores"]),
                                   np.asarray(w["scores"]), rtol=RTOL)


# -- slice 11: the last two limits --------------------------------------------

def deep_tree(depth, n_docs):
    """A tree ``depth`` deep that the shared planner admits (at most 31
    leaf groups): a chain of AND with a range first (the old program's
    stack grew a bit a level) and an AND_NOT of a range every fourth
    level, over a term."""
    deep = {"body": "w3"}
    for j in range(depth):
        rng = {"n" if j % 2 else "m": {"_from": j % 7, "_to": n_docs - j}}
        deep = {"_and_not": [deep, {"n": {"_from": j, "_to": j + 2}}]} \
            if j % 4 == 3 else {"_and": [rng, deep]}
    return deep


@pytest.mark.parametrize("negated", [False, True])
def test_hundred_deep_tree_matches_jax(dbs, negated):
    """A tree 100 deep (refused past 64 before slice 11: the bit stack is
    one 64-bit register): the port emits each node's deepest child first,
    so the stack needs at most log2(leaves) + 1 bits, and answers as JAX
    does; negated, the deep side is AND_NOT's right operand (NOTAND)."""
    jdb, pdb = dbs
    q = deep_tree(100, N_DOCS)
    if negated:
        q = {"_and_not": [{"body": "w5"}, q]}
    want = jdb.search(q, k=10)
    assert want.total > 0
    _same(pdb.search(q, k=10), want)


@pytest.mark.parametrize("n_keys", [16, 24])
def test_many_sort_keys_match_jax(dbs, n_keys):
    """Sorts of 16 and 24 value keys (34 and 50 key words: refused past 32
    before slice 11; wide_topk reads them from a device-memory table): the
    same hits in order as JAX's."""
    jdb, pdb = dbs
    fields = ("p", "q", "r", "m", "tag", "n")
    sort = [{fields[j % len(fields)]: {"_order": "desc" if j % 3 else
                                        "asc"}} for j in range(n_keys)]
    q = {"_or": [{"body": "w2"}, {"body": "w9"}]}
    want = jdb.search(q, k=30, sort=jparse_sort(jdb.schema, sort))
    got = pdb.search(q, k=30, sort=parse_sort(pdb.schema, sort))
    assert len(want.hits) == 30
    _same(got, want)


def _random_tree(rng, n_leaves):
    """A random tree over G and F leaves of every op the planner emits."""
    if n_leaves == 1:
        r = rng.integers(0, 10)
        return ("ALL",) if r == 0 else ("NONE",) if r == 1 else \
            ("G", int(rng.integers(0, 8))) if r < 6 else \
            ("F", int(rng.integers(0, 6)))
    op = ("AND", "OR", "FILTER", "AND_NOT", "XOR", "AND_MAYBE")[
        int(rng.integers(0, 6))]
    if op in ("AND", "OR") and n_leaves > 2 and rng.random() < 0.5:
        cut = sorted(rng.choice(np.arange(1, n_leaves), 2, replace=False))
        parts = (cut[0], cut[1] - cut[0], n_leaves - cut[1])
    else:
        a = int(rng.integers(1, n_leaves))
        parts = (a, n_leaves - a)
    return (op,) + tuple(_random_tree(rng, n) for n in parts)


def _stack_need(prog):
    depth = need = 0
    for ins in prog:
        op = ins & 0xff
        depth += 1 if op in (kernels.OP_G, kernels.OP_F, kernels.OP_PH,
                             kernels.OP_GEO, kernels.OP_ALL,
                             kernels.OP_NONE) else -1
        need = max(need, depth)
    assert depth == 1
    return need


def _leaves(tree):
    return 1 if tree[0] in ("G", "F", "ALL", "NONE") else \
        sum(_leaves(t) for t in (tree[1:2] if tree[0] == "AND_MAYBE"
                                 else tree[1:]))


def test_tree_program_equals_jax_eval_tree_on_random_trees():
    """tree_program's reordered program (its plain evaluator) against JAX's
    _eval_tree on 300 random trees of up to 200 leaves, some of them
    chains 150 deep, over random group bits and filter verdicts; its stack
    never needs more than floor(log2 leaves) + 1 bits."""
    import jax.numpy as jnp

    import xapiand_tpu.ops.executor as jex

    rng = np.random.Generator(np.random.PCG64(11))
    R = 64
    orbits = rng.integers(0, 256, R).astype(np.int32)
    fres = [rng.random(R) < 0.5 for _ in range(6)]
    trees = [_random_tree(rng, int(rng.integers(1, 200))) for _ in range(280)]
    for _ in range(20):   # deep chains, the deep side left or right
        t = ("G", 0)
        for j in range(150):
            leaf = ("F", j % 6)
            op = ("AND", "OR", "AND_NOT", "XOR")[j % 4]
            t = (op, leaf, t) if rng.random() < 0.5 else (op, t, leaf)
        trees.append(t)
    for tree in trees:
        prog = kernels.tree_program(tree)
        need = _stack_need(prog)
        assert need <= int(np.log2(_leaves(tree))) + 1 <= \
            kernels.MAX_TREE_DEPTH
        got = kernels._eval_program_plain(
            prog, torch.from_numpy(orbits), [torch.from_numpy(f)
                                              for f in fres], (R,), "cpu")
        want = jex._eval_tree(tree, {
            "G": lambda g: (jnp.asarray(orbits) & (1 << g)) != 0,
            "F": lambda i: jnp.asarray(fres[i]),
            "ALL": lambda: jnp.ones(R, bool)})
        assert got.tolist() == np.asarray(want).tolist()
