"""The port's mesh plane on the CPU: ``tests/test_sharded.py``, its body
unchanged, run against the port (``tests/test_torch_sharded_db.py``'s
rewrite rule), on a (dp 2, shard 4) mesh stacked on the CPU; then
``make_sharded_step`` against the JAX step for the same segments and
plans, ``kernels.shard_merge`` / ``shard_reduce``'s plain versions against
numpy replicas, and ``utils/synth_mesh.py`` against JAX's commit."""

import os

import numpy as np
import pytest

from test_torch_sharded_db import HERE, on_the_cpu, port_text


@pytest.fixture(autouse=True, scope="module")
def _port_on_the_cpu():
    mp = on_the_cpu()
    yield
    mp.undo()


@pytest.fixture(scope="module")
def eight_devices():
    """The port's mesh cells: eight on the one CPU device."""
    return ["cpu"] * 8


exec(compile(port_text("test_sharded"),
             os.path.join(HERE, "test_sharded.py"), "exec"))


# -- the mesh step against JAX's ----------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from xapiand_tpu.parallel import ShardedIndex as JIndex  # noqa: E402
from xapiand_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from xapiand_tpu.parallel.sharded import MeshExecutor as JExec  # noqa: E402
from xapiand_tpu.query.dsl import parse_sort as jparse_sort  # noqa: E402
from xapiand_tpu_torch.ops import kernels  # noqa: E402
from xapiand_tpu_torch.parallel.mesh import make_mesh as pmake  # noqa: E402
from xapiand_tpu_torch.parallel.sharded import \
    MeshExecutor as PExec  # noqa: E402
from xapiand_tpu_torch.parallel.sharded import \
    ShardedIndex as PIndex  # noqa: E402
from xapiand_tpu_torch.query.dsl import parse_sort  # noqa: E402

RTOL = 1e-5
N_DOCS = 240
CATS = ("red", "green", "blue", "cyan", "amber")


def _docs():
    rng = np.random.Generator(np.random.PCG64(21))
    p = 1.0 / np.arange(1, 41) ** 1.07
    out = []
    for i in range(N_DOCS):
        doc = {"body": " ".join(f"w{j}" for j in rng.choice(
            40, 10, p=p / p.sum())), "price": int(rng.integers(0, 50))}
        if i % 9:
            doc["cat"] = CATS[int(rng.integers(0, len(CATS)))]
        out.append(doc)
    return out


_PAIRS: dict = {}


def pair(scheme="bm25"):
    """(JAX ShardedIndex on 4 of conftest's virtual devices, the port's on
    the CPU) over the same docs, one per scheme."""
    if scheme not in _PAIRS:
        jidx = JIndex(mesh=jmake_mesh(n_shards=4, n_dp=1,
                                      devices=jax.devices()[:4]),
                      scheme=scheme)
        pidx = PIndex(mesh=pmake(4, devices="cpu"), scheme=scheme)
        for i, d in enumerate(_docs()):
            jidx.index_document(dict(d), doc_id=str(i))
            pidx.index_document(dict(d), doc_id=str(i))
        jidx.commit()
        pidx.commit()
        _PAIRS[scheme] = (jidx, pidx)
    return _PAIRS[scheme]


def run_both(scheme, queries, k=10, aggs=None, sort=None, params=None):
    """MeshExecutor.run of both packages on one same-signature batch
    (with params, each package's get_scheme(scheme, **params) for the
    run, over the BM25-built pair)."""
    jidx, pidx = pair("bm25" if params else scheme)
    out = []
    for idx, ex_cls, is_jax in ((jidx, JExec, True), (pidx, PExec, False)):
        run_scheme = None
        if params:
            run_scheme = (__import__("xapiand_tpu.models.weights",
                                     fromlist=["get_scheme"]) if is_jax else
                          __import__("xapiand_tpu_torch.models.weights",
                                     fromlist=["get_scheme"])
                          ).get_scheme(scheme, **params)
        from_dsl = idx.schema
        dsl = (__import__("xapiand_tpu.query.dsl", fromlist=["QueryDSL"])
               if is_jax else
               __import__("xapiand_tpu_torch.query.dsl",
                          fromlist=["QueryDSL"])).QueryDSL(from_dsl)
        irs = [dsl.parse(q) for q in queries]
        srt = None
        if sort:
            srt = (jparse_sort if is_jax else parse_sort)(idx.schema, sort)
        ex = ex_cls(idx.mesh, idx.n_shards, idx.scheme)
        out.append(ex.run(idx.segments, idx._stacked, idx.schema,
                          idx.stats(), idx.global_termfreq,
                          idx.global_collfreq, irs, k, aggs=aggs,
                          sort=srt, scheme=run_scheme))
    return out


def _same(got, want):
    assert got["docids"].tolist() == np.asarray(want["docids"]).tolist()
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               rtol=RTOL)
    assert got["counts"].tolist() == np.asarray(want["counts"]).tolist()


ORS = [{"_or": [{"body": f"w{a}"}, {"body": f"w{b}"}]}
       for a, b in ((0, 3), (1, 9), (2, 30), (5, 6), (11, 39), (7, 8))]


@pytest.mark.parametrize("case", ["relevance", "value", "strmetric",
                                  "terms", "hist_range"])
def test_mesh_executor_matches_jax(case):
    """The port's step (execute per shard, shard_merge, shard_reduce) and
    JAX's shard_map step over the same 4 shards: global docids and counts
    exact, scores within rtol 1e-5, merged agg parts within rtol 1e-5."""
    kw = {}
    if case == "value":
        kw["sort"] = [{"price": {"_order": "desc"}}]
    elif case == "strmetric":
        kw["sort"] = [{"cat": {"_order": "asc", "_value": "grey",
                               "_metric": "levenshtein"}}]
    elif case == "terms":
        kw["aggs"] = {"c": {"_terms": {"_field": "cat"},
                            "_aggs": {"p": {"_avg": {"_field": "price"}}}},
                      "s": {"_stats": {"_field": "price"}}}
    elif case == "hist_range":
        kw["aggs"] = {"h": {"_histogram": {"_field": "price",
                                           "_interval": 10}},
                      "r": {"_range": {"_field": "price", "_ranges": [
                          {"_to": 20}, {"_from": 20}]}},
                      "m": {"_median": {"_field": "price"}},
                      "n": {"_cardinality": {"_field": "cat"}}}
    want, got = run_both("bm25", ORS, k=12, **kw)
    _same(got, want)
    if "aggs" in kw:
        assert got["shaped_aggs"] == want["shaped_aggs"]
        assert got["mesh_cats"] == want["mesh_cats"]


@pytest.mark.parametrize("scheme", ["pl2", "pl2plus", "dlh", "dph", "bb2",
                                    "lm-dirichlet_plus"])
def test_mesh_nan_schemes_match_jax(scheme):
    """Under the six schemes where a non-scoring term is NaN (ROADMAP queue
    3), a synonym's members give NaN sums on every shard: the merge ranks
    those docs as JAX's does. BB2's float32 weight cancels (ROADMAP,
    "Reference faults"): on these queries the port's scores read up to
    1.33e-4 from JAX's, relative, where the other five schemes read at most
    1.2e-7; a float16 stand-in for JAX's BB2 scores would read 2.7e-4. So
    BB2 is held at 2e-4."""
    q = [{"_or": [{"body": {"_synonym": "w1 w2"}}, {"body": "w3"}]},
         {"_or": [{"body": {"_synonym": "w0 w5"}}, {"body": "w9"}]}]
    params = None
    if scheme.startswith("lm-"):
        scheme, params = "lm", {"smoothing": scheme[3:]}
    want, got = run_both(scheme, q, k=10, params=params)
    assert got["docids"].tolist() == np.asarray(want["docids"]).tolist()
    assert got["counts"].tolist() == np.asarray(want["counts"]).tolist()
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               rtol=RTOL if scheme != "bb2" else 2e-4)


def test_mesh_semijoin_matches_jax(monkeypatch):
    """MeshExecutor.run with both pinned planners' SEMIJOIN_RATIO forced
    to 1 (tests/test_query_ops.py:159): every shard runs the semijoin
    (K21; the group's drive from its first member, unify_cfgs) and the
    merged answers and aggregations equal JAX's mesh."""
    import xapiand_tpu.query.plan as jplan
    from xapiand_tpu_torch.query import plan as pplan

    monkeypatch.setattr(jplan, "SEMIJOIN_RATIO", 1)
    monkeypatch.setattr(pplan, "SEMIJOIN_RATIO", 1)
    calls = []
    real = kernels.semijoin_rows
    monkeypatch.setattr(kernels, "semijoin_rows",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q = [{"_and": [{"cat": c}, {"body": f"w{w}"}]}
         for c, w in (("red", 0), ("blue", 3), ("green", 1), ("cyan", 7))]
    want, got = run_both("bm25", q, k=10, aggs={
        "s": {"_stats": {"_field": "price"}}})
    assert len(calls) == 4   # a semijoin a shard
    _same(got, want)
    assert got["shaped_aggs"] == want["shaped_aggs"]


def _lax_merge(docids, scores, okeys=None, keys=None):
    """make_sharded_step's merge (sharded.py:444-478) over [S, Q, k]
    per-shard outputs, in JAX."""
    S, Q, k = docids.shape
    shard = jnp.arange(S, dtype=jnp.int32)[:, None, None]
    d, s = jnp.asarray(docids), jnp.asarray(scores)
    gdoc = d * S + shard
    invalid = jnp.isinf(s) & (s < 0)
    gdoc = jnp.where(invalid, jnp.int32(2**31 - 1), gdoc)
    ok = gdoc if okeys is None else jnp.where(
        invalid, jnp.int32(2**31 - 1),
        jnp.take_along_axis(jnp.asarray(okeys)[:, None, :].repeat(Q, 1),
                            d, axis=2, mode="clip"))

    def g(x):
        return jnp.moveaxis(x, 0, 1).reshape(Q, S * k, *x.shape[3:])
    if keys is not None:
        gk = [g(kk) for kk in keys]
        order = jax.lax.sort(tuple(gk) + (g(ok), g(gdoc), g(s)),
                             num_keys=len(gk) + 1, dimension=1)
        return np.asarray(order[-2][:, :k]), np.asarray(order[-1][:, :k])
    _, _, dd, ss = jax.lax.sort((-g(s), g(ok), g(gdoc), g(s)), num_keys=2,
                                dimension=1)
    return np.asarray(dd[:, :k]), np.asarray(ss[:, :k])


def _merge_inputs(seed, S=4, Q=6, k=9, nd=50):
    rng = np.random.Generator(np.random.PCG64(seed))
    d = rng.integers(0, nd, (S, Q, k)).astype(np.int32)
    s = rng.choice(np.array([0.5, 1.0, 2.0, 0.0, -0.0, np.nan, -np.inf,
                             np.inf], np.float32), (S, Q, k))
    ok = rng.integers(0, 30, (S, nd)).astype(np.int32)
    return d, s, ok


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("okeys", [False, True])
def test_shard_merge_plain_matches_lax_sort(seed, okeys):
    """shard_merge's plain version against make_sharded_step's lax.sort on
    scores full of ties, -0.0 beside 0.0, NaN, +-inf (lax.sort: -0.0 equal
    to 0.0, NaN after +inf, stable), with and without orderkeys."""
    d, s, ok = _merge_inputs(seed)
    wd, ws = _lax_merge(d, s, ok if okeys else None)
    gd, gs = kernels.shard_merge(torch.from_numpy(d), torch.from_numpy(s),
                                 torch.from_numpy(ok) if okeys else None)
    assert gd.tolist() == wd.tolist()
    assert gs.numpy().tobytes() == ws.tobytes()


@pytest.mark.parametrize("seed", [3, 4])
def test_shard_merge_plain_matches_lax_sort_by_keys(seed):
    """The value-ordered merge: two emitted key words (an int key as
    sort_topk emits it, a float key with -0.0 and NaN) then the orderkey."""
    d, s, ok = _merge_inputs(seed)
    rng = np.random.Generator(np.random.PCG64(seed + 10))
    ikey = rng.integers(-3, 3, d.shape).astype(np.int32)
    fkey = rng.choice(np.array([1.5, 0.0, -0.0, np.nan, np.inf], np.float32),
                      d.shape)
    wd, ws = _lax_merge(d, s, ok, keys=(ikey, fkey))
    words = np.stack([
        (ikey.view(np.uint32) ^ np.uint32(2**31)),
        kernels._fkey(torch.from_numpy(fkey)).numpy().astype(np.uint32)], 3)
    gd, gs = kernels.shard_merge(torch.from_numpy(d), torch.from_numpy(s),
                                 torch.from_numpy(ok),
                                 torch.from_numpy(words.view(np.int32)))
    assert gd.tolist() == wd.tolist()
    assert gs.numpy().tobytes() == ws.tobytes()


def test_shard_merge_plain_matches_numpy_lexsort():
    """On random ties: (-score, striped docid), then the gathered
    position, as numpy's lexsort orders them."""
    rng = np.random.Generator(np.random.PCG64(5))
    S, Q, k = 8, 5, 10
    d = rng.integers(0, 1000, (S, Q, k)).astype(np.int32)
    s = rng.integers(0, 4, (S, Q, k)).astype(np.float32)
    gd, gs = kernels.shard_merge(torch.from_numpy(d), torch.from_numpy(s))
    for q in range(Q):
        cand_d = (d[:, q, :].astype(np.int64) * S
                  + np.arange(S)[:, None]).reshape(-1)
        cand_s = s[:, q, :].reshape(-1)
        order = np.lexsort((np.arange(S * k), cand_d, -cand_s))[:k]
        assert gd[q].tolist() == cand_d[order].tolist()
        assert gs[q].tolist() == cand_s[order].tolist()


def test_shard_reduce_plain_matches_jax():
    """psum of int32 counts; psum / pmin / pmax of float packs with NaN
    (XLA's min / max return NaN) - the sum folded in shard order."""
    rng = np.random.Generator(np.random.PCG64(6))
    c = rng.integers(0, 2**28, (8, 7)).astype(np.int32)
    x = rng.random((8, 7, 3)).astype(np.float32)
    x[2, 1, 0] = np.nan
    got = kernels.shard_reduce(torch.from_numpy(c), "sum")
    assert got.tolist() == c.sum(0, dtype=np.int64).astype(np.int32).tolist()
    acc = x[0].copy()
    for i in range(1, 8):
        acc = acc + x[i]
    got = kernels.shard_reduce(torch.from_numpy(x), "sum")
    assert got.numpy().tobytes() == acc.tobytes()
    for rule, fn in (("min", jnp.min), ("max", jnp.max)):
        got = kernels.shard_reduce(torch.from_numpy(x), rule).numpy()
        np.testing.assert_array_equal(got, np.asarray(fn(x, axis=0)))


# -- utils/synth_mesh.py: config 5's shards and oracle ----------------------

from xapiand_tpu_torch.utils import synth_mesh as sm  # noqa: E402

MESH_DOCS = 2000


@pytest.fixture(scope="module")
def mesh5():
    """config 5's first 2,000 docs: synth_mesh's shards, and JAX's
    ShardedIndex over the same docs on conftest's 8 virtual devices."""
    corpus = sm.Corpus(MESH_DOCS, seed=7)
    jidx = JIndex(mesh=jmake_mesh(n_shards=8, n_dp=1,
                                  devices=jax.devices()[:8]))
    for i in range(MESH_DOCS):
        jidx.index_document(sm.doc(corpus.tok, i), doc_id=str(i))
    jidx.commit()
    return corpus, jidx


def test_synth_mesh_routes_as_fnv1ah64():
    from xapiand_tpu_torch.utils.hashing import fnv1ah64

    got = sm.route(12345)
    assert got.tolist() == [fnv1ah64("Q" + str(i)) % 8
                            for i in range(12345)]


def test_synth_mesh_shards_equal_jax_commit(mesh5):
    """Each shard synth_mesh builds equals JAX ShardedIndex.commit's for
    the same docs: doc ids, doclen, uniqterms, every term's stats,
    postings (docids, wdf, doclen) and each posting's positions."""
    corpus, jidx = mesh5
    from xapiand_tpu_torch.models.segment import terms_from

    for s, (pseg, jseg) in enumerate(zip(corpus.segments, jidx.segments)):
        n = pseg.num_docs
        assert pseg.doc_keys == jseg.doc_keys[:n], s
        assert jseg.deleted[:n].sum() == 0 and not pseg.deleted[:n].any()
        np.testing.assert_array_equal(pseg.doclen[:n], jseg.doclen[:n])
        np.testing.assert_array_equal(pseg.uniqterms[:n], jseg.uniqterms[:n])
        assert pseg.total_doclen == jseg.total_doclen
        jterms = terms_from(jseg.terms)
        assert len(pseg.terms) == len(jterms)
        for t, jt in jterms.items():
            pt = pseg.get_term(t)
            assert (pt.length, pt.collfreq, pt.max_wdf, pt.max_poslen) == \
                (jt.length, jt.collfreq, jt.max_wdf, jt.max_poslen), t
            a = slice(pt.offset, pt.offset + pt.length)
            b = slice(jt.offset, jt.offset + jt.length)
            for arr in ("post_docids", "post_wdf", "post_doclen",
                        "post_poslen"):
                assert getattr(pseg, arr)[a].tolist() == \
                    getattr(jseg, arr)[b].tolist(), (t, arr)
            for po, pl, jo in zip(pseg.post_posoff[a], pseg.post_poslen[a],
                                  jseg.post_posoff[b]):
                assert pseg.positions[po:po + pl].tolist() == \
                    jseg.positions[jo:jo + pl].tolist(), t


def test_synth_mesh_oracle_holds_the_port_and_jax(mesh5):
    """config 5's 256 queries over the 2,000 docs: the port's ShardedIndex
    on synth_mesh's shards and JAX's on its own commit, each answer held
    to the float64 oracle (total exact, scores within rtol 1e-5, ranks as
    tie groups)."""
    corpus, jidx = mesh5
    pidx = PIndex(mesh=pmake(8, devices="cpu"))
    pidx.load_segments(corpus.segments)
    qs = sm.queries5()
    got = pidx.search_batch([q for _w, q in qs], k=10)
    want = jidx.search_batch([q for _w, q in qs], k=10)
    for (words, _q), g, w in zip(qs, got, want):
        ref = sm.oracle(corpus, words)
        for ans in (g, w):
            err = sm.check([(h["id"], h["score"]) for h in ans["hits"]],
                           ans["total"], ref)
            assert err is None, (words, err)
