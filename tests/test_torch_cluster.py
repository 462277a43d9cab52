"""MSet clustering on the CPU: the port's ``ops/cluster.py`` against the JAX
one, and ``Database.cluster_hits`` / ``diversify`` against the JAX
``Database``.

``kmeans_cosine`` runs K20's plain version here (``kernels.
kmeans_loop_plain``, ``kmeans_step_plain`` a step, on CPU tensors). The
JAX loop sums its dot products in another order, so labels are held by
the margin rule (``cluster.label_margin_bound``): at every step t of the
loop, rows whose top-2 margin over the JAX centroids C_t exceeds the
bound (2 gamma_V plus twice the largest distance between the two sides'
centroids) carry the same label on both sides; while every label agrees
the centroids agree within rtol 1e-5. Block-structured data has no row
inside the margin; the random case reports its rows inside it."""

import numpy as np
import pytest
import torch

from xapiand_tpu.database import Database as JDB
from xapiand_tpu.ops import cluster as jcl
from xapiand_tpu_torch.database import Database as PDB
from xapiand_tpu_torch.ops import cluster as pcl
from xapiand_tpu_torch.ops import kernels

DOCS = {
    "m1": "machine learning tensor models training",
    "m2": "tensor training machine learning devices",
    "m3": "deep learning model tensors",
    "c1": "pasta tomato basil cooking dinner",
    "c2": "cooking pasta sauce tomato recipe",
    "g1": "hiking mountain trail camping",
    "g2": "mountain camping gear trails",
}
C_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _fill(db):
    for did, body in DOCS.items():
        db.index_document({"body": body, "cat": did[0],
                           "price": ord(did[0]) * 10 + int(did[1])},
                          doc_id=did)
    db.commit()
    return db


@pytest.fixture(scope="module")
def dbs():
    return _fill(JDB()), _fill(PDB(device="cpu"))


def _blocks(n, v, k, seed):
    """n rows in k blocks: each row its block's centre plus noise, all
    non-negative (as TF-IDF rows are), L2-normalised."""
    rng = np.random.Generator(np.random.PCG64(seed))
    centres = rng.random((k, v)) ** 4
    rows = centres[rng.integers(0, k, n)] + 0.05 * rng.random((n, v))
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)


def _random(n, v, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    rows = rng.random((n, v)) ** 3
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)


def _trajectories(X, k, iters):
    """Per step t: (port labels, port C_t, JAX labels, JAX C_t, rows
    inside the margin, rows outside it whose labels differ)."""
    out = []
    for t in range(iters + 1):
        pl, pc = pcl.kmeans_cosine(X, k, iters=t, device="cpu")
        jl, jc = jcl.kmeans_cosine(X, k, iters=t)
        dc = float(np.linalg.norm(pc.astype(np.float64) - jc, axis=1).max())
        # the labels of step t assign rows to the centroids of step t
        inside = pcl.near_ties(X, jc, dc)
        out.append((pl, pc, np.asarray(jl), jc, int(inside.sum()),
                    int(((pl != jl) & ~inside).sum())))
    return out


def test_kmeans_cosine_block_structured_matches_jax():
    """Blocks: no row inside the margin at any step; labels equal, and the
    centroids within rtol 1e-5, at every step."""
    X = _blocks(300, 96, 5, seed=1)
    for pl, pc, jl, jc, inside, bad in _trajectories(X, 5, 20):
        assert inside == 0 and bad == 0
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_allclose(pc, jc, rtol=C_RTOL, atol=0)
    assert len(set(pl.tolist())) == 5


def test_kmeans_cosine_random_by_the_margin_rule():
    """Random rows: at every step, every label outside the margin agrees;
    while all labels agree, so do the centroids. The rows inside the
    margin are reported."""
    X = _random(400, 48, seed=2)
    agree = True
    inside_total = 0
    for t, (pl, pc, jl, jc, inside, bad) in enumerate(
            _trajectories(X, 8, 20)):
        if not agree:
            break          # a near-tie row parted the trajectories
        assert bad == 0, f"step {t}: {bad} labels differ outside the margin"
        inside_total += inside
        np.testing.assert_allclose(pc, jc, rtol=C_RTOL, atol=0)
        agree = bool((pl == jl).all())
    print(f"rows inside the margin over the steps compared: {inside_total}")


@pytest.mark.parametrize("data", ["blocks", "random"])
def test_kmeans_loop_plain_history_is_the_jax_trajectory(data):
    """kmeans_loop_plain with its history (csrc/kmeans.cu's history
    output, which chip_smoke.py's held check reads) from JAX's seeds: step
    t's input centroids are JAX's after t steps (kmeans_cosine at
    iters=t), within rtol 1e-5 while every label has agreed, and step t's
    labels are JAX's assignment under them outside the margin; the last
    assignment is JAX's labels at iters=20."""
    X = _blocks(300, 96, 5, seed=1) if data == "blocks" else \
        _random(400, 48, seed=2)
    k = 5 if data == "blocks" else 8
    _, c0 = jcl.kmeans_cosine(X, k, iters=0)
    labels, C, (hl, hc) = kernels.kmeans_loop_plain(
        torch.from_numpy(X), torch.from_numpy(np.asarray(c0)), 20,
        history=True)
    assert hl.shape == (20, X.shape[0]) and hc.shape == (20, k, X.shape[1])
    agree = True
    for t in range(21):
        jl, jc = jcl.kmeans_cosine(X, k, iters=t)
        pc = hc[t].numpy() if t < 20 else C.numpy()
        pl = hl[t].numpy() if t < 20 else labels.numpy()
        if not agree:
            break          # a near-tie row parted the trajectories
        dc = float(np.linalg.norm(pc.astype(np.float64) - jc, axis=1).max())
        inside = pcl.near_ties(X, jc, dc)
        assert not ((pl != np.asarray(jl)) & ~inside).any(), t
        np.testing.assert_allclose(pc, jc, rtol=C_RTOL, atol=0)
        agree = bool((pl == np.asarray(jl)).all())
    if data == "blocks":
        assert agree


def test_kmeans_step_plain_is_one_jax_step():
    """One call of kmeans_step_plain is the JAX loop's body: from the same
    seeds, its labels and centroids are kmeans_cosine's at iters=1."""
    X = _blocks(120, 32, 4, seed=3)
    _, c0 = jcl.kmeans_cosine(X, 4, iters=0)
    labels, c1 = kernels.kmeans_step_plain(torch.from_numpy(X),
                                           torch.from_numpy(c0))
    want_l0, _ = jcl.kmeans_cosine(X, 4, iters=0)
    _, want_c1 = jcl.kmeans_cosine(X, 4, iters=1)
    np.testing.assert_array_equal(labels.numpy(), want_l0)
    np.testing.assert_allclose(c1.numpy(), want_c1, rtol=C_RTOL, atol=0)
    only, none = kernels.kmeans(torch.from_numpy(X), torch.from_numpy(c0),
                                update=False)
    assert none is None and torch.equal(only, labels)


def test_kmeans_keeps_an_empty_centroid():
    """A centroid no row picks (its new norm 0) stays as it was."""
    X = np.eye(4, 6, dtype=np.float32)
    C = np.zeros((2, 6), np.float32)
    C[0, :4] = 0.5
    C[1, 5] = 1.0                        # no row is near it
    labels, new_c = kernels.kmeans(torch.from_numpy(X),
                                   torch.from_numpy(C))
    assert labels.tolist() == [0, 0, 0, 0]
    np.testing.assert_array_equal(new_c[1].numpy(), C[1])


def test_label_margin_bound():
    """2 gamma_V, plus twice the centroids' distance."""
    u = 2.0 ** -24
    assert pcl.label_margin_bound(2048) == pytest.approx(2 * 2048 * u,
                                                         rel=1e-3)
    assert pcl.label_margin_bound(10, 0.25) > 0.5
    m = pcl.top2_margins(np.eye(2, dtype=np.float32),
                         np.array([[1.0, 0.0], [0.6, 0.8]], np.float32))
    np.testing.assert_allclose(m, [0.4, 0.8])
    # a zero row ties at 0 exactly on every side: not a near tie
    X = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    C = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    assert pcl.near_ties(X, C).tolist() == [False, True]


def test_tfidf_vectors_and_diversify_mmr_are_the_jax_functions():
    """The numpy copies return what JAX's return, bit for bit."""
    rng = np.random.Generator(np.random.PCG64(4))
    tl = [{f"t{int(x)}": int(rng.integers(1, 5))
           for x in rng.integers(0, 40, int(rng.integers(1, 9)))}
          for _ in range(30)]
    df = {f"t{i}": int(rng.integers(1, 20)) for i in range(40)}
    (px, pv), (jx, jv) = (pcl.tfidf_vectors(tl, 50, df, max_vocab=32),
                          jcl.tfidf_vectors(tl, 50, df, max_vocab=32))
    assert pv == jv
    np.testing.assert_array_equal(px, jx)
    scores = rng.random(30)
    for lam in (0.0, 0.3, 1.0):
        assert pcl.diversify_mmr(scores, px, 12, lam=lam) == \
            jcl.diversify_mmr(scores, jx, 12, lam=lam)


def test_cluster_hits_matches_jax(dbs):
    """tests/test_cluster_ops.py's seven docs: the same labels, by topic."""
    jdb, pdb = dbs
    ids = list(DOCS)
    for k in (1, 2, 3, 5):
        assert pdb.cluster_hits(ids, k=k) == jdb.cluster_hits(ids, k=k)
    labels = pdb.cluster_hits(ids, k=3)
    by_topic = {}
    for did, lab in zip(ids, labels):
        by_topic.setdefault(did[0], set()).add(lab)
    assert all(len(s) == 1 for s in by_topic.values())
    assert len({next(iter(s)) for s in by_topic.values()}) == 3
    assert pdb.cluster_hits([]) == []


def test_diversify_matches_jax(dbs):
    """The same reorder as JAX's, one topic of each up front."""
    jdb, pdb = dbs
    q = {"body": "machine pasta mountain learning cooking"}
    for lam in (0.3, 0.5, 0.9):
        got = pdb.diversify(pdb.search(q, k=7), lam=lam)
        want = jdb.diversify(jdb.search(q, k=7), lam=lam)
        assert [h.id for h in got.hits] == [h.id for h in want.hits]
        assert [h.rank for h in got.hits] == list(range(len(got.hits)))
    first3 = {h.id[0] for h in pdb.diversify(pdb.search(q, k=7),
                                             lam=0.3).hits[:3]}
    assert len(first3) == 3


def test_doc_vectors_match_jax(dbs):
    """The TF-IDF rows clustering reads: equal on both sides."""
    jdb, pdb = dbs
    (px, pv), (jx, jv) = pdb._doc_vectors(list(DOCS)), \
        jdb._doc_vectors(list(DOCS))
    assert pv == jv
    np.testing.assert_array_equal(px, jx)


def test_a_zero_first_row_seeds_one_cluster_as_in_jax():
    """Mirrored JAX behaviour (ROADMAP queue 3): the farthest-first seeding
    starts at row 0; when row 0 is 0 (no term among the vocabulary's
    highest-idf terms, as most passages of a wide MSet), X @ X[0] is 0
    everywhere, argmin takes row 0 again, and every seed is row 0: all
    rows end in cluster 0, on both sides."""
    X = _blocks(64, 16, 4, seed=5)
    X[0] = 0.0
    pl, pc = pcl.kmeans_cosine(X, 4, device="cpu")
    jl, jc = jcl.kmeans_cosine(X, 4)
    np.testing.assert_array_equal(pl, np.asarray(jl))
    assert set(pl.tolist()) == {0}
    np.testing.assert_allclose(pc, jc, rtol=C_RTOL, atol=0)
