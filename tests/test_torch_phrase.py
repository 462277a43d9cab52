"""Slice 4, phrase and NEAR leaves (K14, with the K15 lookups inside it),
against the JAX package on the CPU: the port's plain versions and the JAX
functions on the same inputs. The cases mirror tests/test_phrase_carry.py
and the phrase parts of tests/test_engine.py and tests/test_query_ops.py.

  phrase_leaves (K14)    vs ops/phrase.py phrase_leaves after the JAX
                         docid sort and _merge_runs (execute 743-828), at
                         XT_PHRASE_CARRY 0 and 1 (the carried channels of
                         execute 685-823): the verdicts compared per doc
                         (JAX's rows are docid-sorted, the port's are
                         grouped by term with one owner row a doc)
  execute_batch          vs jit(vmap(execute)): 2- and 3-word phrases,
                         NEAR, a phrase inside AND / OR / AND_NOT, a
                         phrase AND a value range with a hand-built
                         compaction cap (no precompaction: execute
                         836-837), a phrase past pmax = 128 positions, and
                         phrases with more candidates than cand_cap
  BatchSearcher.run      vs the JAX BatchSearcher.run on a mixed phrase +
                         boolean batch
  the tree program       PH leaves vs _eval_tree
  limits                 plans beyond the kernel's limits raise
                         NotImplementedError naming K14
  config 2's generator   utils/synth_positional.py draws what
                         scripts/config_bench.py draws, and BatchSearcher
                         at 2,000 docs matches its float64 oracle

Two JAX ``Database`` commits (XT_HOST_PATH=0: the JAX device path), carried
into the port's Segment: 800 docs of 30 tokens drawn uniformly from 60
words (tests/test_phrase_carry.py's corpus) with every 53rd doc deleted and
one doc of "w5" 140 times then "w6" (its only "w5 w6" lies past the first
128 positions); and 6,000 docs of 30 tokens drawn from the same 60 words
with Zipf(1.07) weights, where w0 and w1 are each in over 95% of the docs,
so a "w0 w1" phrase has more candidates than the cap of 4,096.

Tolerances as in tests/test_torch_predicate.py: masks, verdicts, counts
and docids equal; scores within rtol 1e-5; relevance ranks compared as tie
groups.
"""

import dataclasses
import importlib.util
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import test_torch_predicate as tp
import xapiand_tpu.ops.executor as jex
from xapiand_tpu.database import Database
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.ops.phrase import phrase_leaves as jax_phrase_leaves
from xapiand_tpu.query.dsl import QueryDSL
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.segment import (Segment, ValueColumn,
                                              device_segment_from_numpy,
                                              terms_from)
from xapiand_tpu_torch.models.weights import BM25
from xapiand_tpu_torch.ops import kernels, phrase
from xapiand_tpu_torch.ops.executor import (SENTINEL, ExecConfig,
                                            check_supported, execute_batch)
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_positional as sp

RTOL = 1e-5
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")
    monkeypatch.setenv("XT_PHRASE_CARRY", "0")


def to_port(jq) -> Q:
    """A JAX IR node as the port's (the two Q classes have one field
    list)."""
    kw = {f.name: getattr(jq, f.name) for f in dataclasses.fields(Q)}
    kw["children"] = tuple(to_port(c) for c in jq.children)
    return Q(**kw)


class PWorld:
    """One segment on both sides, its query families, the searchers."""

    def __init__(self, docs, deleted=()):
        db = Database()
        for i, d in enumerate(docs):
            db.index_document({"body": d, "n": float(i % 97)},
                              doc_id=str(i))
        db.commit()
        jseg = db._searchers[0].segment
        jseg.deleted[list(deleted)] = True
        self.docs = [d.split() for d in docs]
        self.dsl = QueryDSL(db.schema)
        self.n_slot = db.schema.get_field("n").slot
        self.jseg = jseg
        self.pseg = tp._fields(
            jseg, Segment,
            terms=terms_from(jseg.terms),
            values={s: tp._fields(c, ValueColumn)
                    for s, c in jseg.values.items()})
        self.js = JSearcher(jseg, JBM25())
        self.ps = SegmentSearcher(self.pseg, device=CPU)
        self.jarr = self.js.device_segment.arrays_pytree()
        self.parr = device_segment_from_numpy(tp._np_tree(self.jarr), CPU)
        self.jstats = {"N": jnp.float32(jseg.doc_count),
                       "avg_doclen": jnp.float32(jseg.avg_doclen),
                       "doclen_lower": jnp.float32(1.0)}
        self.pstats = {"N": float(jseg.doc_count),
                       "avg_doclen": float(jseg.avg_doclen)}
        self.params = BM25().kernel_spec(self.ps.segment)
        self.fams: dict = {}

    def parse(self, dsl):
        return self.dsl.parse(dsl)

    def jax_groups(self, fam):
        return JBatch(self.js, k=10).plan(self.fams[fam])

    def port_batch(self, batch):
        return {k: torch.from_numpy(np.array(batch[k]))
                for k in ("offsets", "lens", "tconst", "scoring",
                          "group_bits", "fparams") if k in batch}


def _phrase(a):
    return {"body": {"_phrase": a}}


def _uniform_world():
    rng = random.Random(3)
    words = [f"w{i}" for i in range(60)]
    docs = [" ".join(rng.choices(words, k=30)) for _ in range(800)]
    docs.append(" ".join(["w5"] * 140 + ["w6"]))
    w = PWorld(docs, deleted=range(5, 800, 53))
    rng = random.Random(9)
    pairs, triples = [], []
    for _ in range(12):
        toks = w.docs[rng.randrange(800)]
        i = rng.randrange(len(toks) - 1)
        pairs.append(f"{toks[i]} {toks[i + 1]}")
    for _ in range(6):
        toks = w.docs[rng.randrange(800)]
        i = rng.randrange(len(toks) - 2)
        triples.append((" ".join(toks[i:i + 3]), f"{toks[i]} {toks[i + 2]}"))
    w.fams = {
        "P2": [w.parse(_phrase(p)) for p in pairs],
        "P3": [w.parse(_phrase(t)) for t, _ in triples],
        "N": [w.parse({"body": {"_near": n, "_window": 4}})
              for _, n in triples],
        "AND": [w.parse({"_and": [_phrase(p), {"body": f"w{i}"}]})
                for i, p in enumerate(pairs[:6])],
        "OR": [w.parse({"_or": [_phrase(p), {"body": f"w{i + 9}"}]})
               for i, p in enumerate(pairs[:6])],
        "NOT": [w.parse({"_and_not": [{"body": f"w{i}"}, _phrase(p)]})
                for i, p in enumerate(pairs[:3])]
        + [w.parse({"_and_not": [_phrase(p), {"body": f"w{i + 20}"}]})
           for i, p in enumerate(pairs[3:6])],
        "RANGE": [w.parse({"_and": [_phrase(p), {"n": {"_range": {
            "_from": 10 + 7 * i, "_to": 60 + 7 * i}}}]})
            for i, p in enumerate(pairs[:6])],
        "PMAX": [w.parse(_phrase("w5 w6")), w.parse(_phrase("w6 w5")),
                 w.parse({"body": {"_near": "w6 w5", "_window": 3}})],
        "BOOL": [w.parse({kind: [{"body": f"w{i}"}, {"body": f"w{i + 1}"},
                                 {"body": f"w{i + 7}"}]})
                 for i, kind in zip(range(0, 30, 5),
                                    ("_and", "_or") * 3)],
    }
    return w


def _zipf_world():
    rng = random.Random(5)
    words = [f"w{i}" for i in range(60)]
    wts = [1.0 / (i + 1) ** 1.07 for i in range(60)]
    docs = [" ".join(rng.choices(words, weights=wts, k=30))
            for _ in range(6000)]
    w = PWorld(docs, deleted=range(3, 6000, 97))
    w.fams = {"CAP": [w.parse(_phrase(p)) for p in
                      ("w0 w1", "w1 w0", "w0 w2", "w0 w0", "w3 w1")]
              + [w.parse({"body": {"_near": "w1 w0", "_window": 2}})]}
    return w


_WORLDS: dict = {}


@pytest.fixture(scope="module")
def uniform():
    if "u" not in _WORLDS:
        _WORLDS["u"] = _uniform_world()
    return _WORLDS["u"]


@pytest.fixture(scope="module")
def zipf():
    if "z" not in _WORLDS:
        _WORLDS["z"] = _zipf_world()
    return _WORLDS["z"]


def _port_rows(world, cfg, pb):
    """score_slices and merge_docs (plain) of one group: ids, w, widths,
    sums, first (owner & not deleted), orbits."""
    widths = cfg.term_classes()
    post = tuple(world.parr[k] for k in
                 ("post_docids", "post_wdf", "post_doclen"))
    ids, w, _tail = kernels.score_slices(
        post, None, pb["offsets"], pb["lens"], pb["tconst"], pb["scoring"],
        widths, (0,) * cfg.T, world.params)
    deleted = world.parr["deleted"] if cfg.has_deletes else None
    sums, first, _count, orbits = kernels.merge_docs(
        ids, w, widths, pb["group_bits"], deleted, None, True,
        n_docs=world.parr["deleted"].shape[0])
    return ids, w, widths, sums, first, orbits


def _jax_phrase_verdicts(world, jcfg, pb, ids, w, widths):
    """JAX's docid sort and _merge_runs over the same rows (with the
    positional channels when jcfg.phrase_carry), then phrase_leaves:
    -> per phrase leaf the set of (query, docid) it holds for."""
    T = len(widths)
    rowterm = np.repeat(np.arange(T), widths)
    idn = ids.numpy()
    inlen = idn != SENTINEL
    rbits = np.where(inlen, pb["group_bits"].numpy()[:, rowterm], 0)
    ptrms = sorted({t for p in jcfg.phrases for t in p[0]}) \
        if jcfg.phrase_carry else []
    chans = []
    offs = pb["offsets"].numpy()
    col = np.concatenate([np.arange(wd) for wd in widths])
    posoff, poslen = world.jseg.post_posoff, world.jseg.post_poslen
    for t in ptrms:
        slot = np.minimum(offs[:, rowterm] + col[None, :], len(posoff) - 1)
        mine = inlen & (rowterm == t)[None, :]
        po, pl = posoff[slot], poslen[slot]
        chans += [np.where(mine, po + 1, 0).astype(np.int32),
                  np.where(mine, pl, 0).astype(np.int32)]
    nd1 = world.jarr["doclen"].shape[0]

    def one(i, x, b, offsets, lens, *pc):
        srt = lax.sort((i, x, b) + tuple(pc), num_keys=1)
        d, wv, bv, rest = srt[0], srt[1], srt[2], srt[3:]
        _sums, orbits = jex._merge_runs(d, wv, bv, T)
        tail = jnp.concatenate([d[1:] != d[:-1], jnp.ones((1,), bool)])
        first = tail & (d != jex.SENTINEL)
        first &= ~world.jarr["deleted"][jnp.minimum(d, nd1 - 1)]
        pcarry = None
        if ptrms:
            pcarry = {t: (jex._merge_runs(d, wv, rest[2 * k], T)[1],
                          jex._merge_runs(d, wv, rest[2 * k + 1], T)[1])
                      for k, t in enumerate(ptrms)}
        plan = {"offsets": offsets, "lens": lens}
        return d, jax_phrase_leaves(world.jarr, plan, jcfg, d, first,
                                    orbits, pcarry=pcarry)

    d, outs = jax.jit(jax.vmap(one))(
        jnp.asarray(idn), jnp.asarray(w.numpy()), jnp.asarray(rbits),
        jnp.asarray(offs), jnp.asarray(pb["lens"].numpy()),
        *[jnp.asarray(c) for c in chans])
    d = np.asarray(d)
    return [_pairs(d, np.asarray(o)) for o in outs]


def _pairs(docids, mask):
    q, r = np.nonzero(mask)
    return set(zip(q.tolist(), docids[q, r].tolist()))


@pytest.mark.parametrize("carry", ["0", "1"])
@pytest.mark.parametrize("fam", ["P2", "P3", "N", "PMAX", "CAP"])
def test_phrase_leaves_vs_jax(uniform, zipf, monkeypatch, fam, carry):
    """K14: per phrase leaf, the docs whose owner row carries its verdict
    bit are the docs JAX's phrase_leaves holds true, at both
    XT_PHRASE_CARRY values; the candidate counts are the first cand_cap
    (hit on the Zipf segment)."""
    monkeypatch.setenv("XT_PHRASE_CARRY", carry)
    world = zipf if fam == "CAP" else uniform
    n_true = 0
    for jcfg, _fn, batch, _chunk in world.jax_groups(fam):
        assert jcfg.phrases and jcfg.phrase_carry == (carry == "1")
        cfg = tp._fields(jcfg, ExecConfig)
        pb = world.port_batch(batch)
        ids, w, widths, _s, first, orbits = _port_rows(world, cfg, pb)
        phbits, ncand = phrase.phrase_leaves(
            ids, widths, pb["offsets"], pb["lens"], orbits, first,
            world.parr["post_posoff"], world.parr["post_poslen"],
            world.parr["positions"], cfg.phrases, cfg.cand_cap, cfg.pmax,
            deleted=world.parr["deleted"] if cfg.has_deletes else None,
            bits=pb["group_bits"])
        want = _jax_phrase_verdicts(world, jcfg, pb, ids, w, widths)
        for p, wp in enumerate(want):
            got = _pairs(ids.numpy(), ((phbits.numpy() >> p) & 1) == 1)
            assert got == wp, (fam, p)
            assert got <= _pairs(ids.numpy(), first.numpy())
            n_true += len(got)
        assert (ncand.numpy() <= cfg.cand_cap).all()
        if fam == "CAP":
            assert (ncand.numpy() == cfg.cand_cap).any()
            assert cfg.cand_cap == kernels.MAX_CAND_CAP
        if fam == "PMAX":
            assert cfg.pmax == kernels.MAX_PMAX
    assert n_true > 0


def _run_case(world, jcfg, batch, over=None):
    """execute_batch vs the JAX package's jit(vmap(execute)) on one launch
    group (jcfg changed by ``over`` on both sides)."""
    jcfg = dataclasses.replace(jcfg, **(over or {}))
    cfg = tp._fields(jcfg, ExecConfig)
    want = world.js.batched(jcfg)(world.jarr, batch, world.jstats)
    got = execute_batch(world.parr, world.port_batch(batch), cfg,
                        world.pstats, BM25())
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["count"].numpy(),
                                  np.asarray(want["count"]))
    for b in range(len(got["count"])):
        tp._assert_ranks((got["docids"][b], got["scores"][b]),
                         (want["docids"][b], want["scores"][b]), False)
    return int(got["count"].sum())


CASES = ["P2", "P3", "N", "AND", "OR", "NOT", "RANGE", "PMAX", "CAP"]


@pytest.mark.parametrize("fam", CASES)
def test_execute_batch_vs_jax(uniform, zipf, fam):
    """execute_batch equals JAX execute on each phrase family's launch
    groups (these configurations raised NotImplementedError before this
    slice)."""
    world = zipf if fam == "CAP" else uniform
    total = 0
    for jcfg, _fn, batch, _chunk in world.jax_groups(fam):
        assert jcfg.phrases
        if fam == "RANGE":
            assert jcfg.n_filters == 1
        total += _run_case(world, jcfg, batch)
    assert total > 0 or fam == "PMAX"


def test_phrase_plan_with_a_cap_does_not_precompact(uniform):
    """A phrase, a value filter and a compaction cap below the row width,
    set by hand (plans give phrases no cap): JAX skips the precompaction
    (execute 836-837), whose upper tree would keep the PH leaf at rows the
    phrase step never reads; the port does the same and equals it."""
    n = 0
    for jcfg, _fn, batch, _chunk in uniform.jax_groups("RANGE"):
        R = sum(jcfg.classes)
        assert jcfg.n_filters and jcfg.phrases and not jcfg.compact_cap
        n += _run_case(uniform, jcfg, batch, {"compact_cap": R // 4})
    assert n > 0


def test_batch_search_run_vs_jax(uniform):
    """BatchSearcher.run: the port vs the JAX package on one mixed batch
    of phrases, NEAR, booleans and phrases inside booleans."""
    fams = ("P2", "P3", "N", "AND", "OR", "NOT", "BOOL", "PMAX")
    jirs = [q for f in fams for q in uniform.fams[f]]
    got = BatchSearcher(uniform.ps, k=10).run([to_port(q) for q in jirs])
    want = JBatch(uniform.js, k=10).run(jirs)
    for g, w in zip(got, want):
        assert g["count"] == w["count"]
        tp._assert_ranks((g["docids"], g["scores"]),
                         (w["docids"], w["scores"]), False)
    assert sum(g["count"] for g in got) > 0


def test_tree_program_phrase_leaves():
    """PH leaves of the postfix program read the verdict word, as
    _eval_tree's PH leaves read phrase_leaves' rows."""
    rng = np.random.Generator(np.random.PCG64(2))
    orbits = rng.integers(0, 8, (3, 200)).astype(np.int32)
    fres = [rng.random((3, 200)) < 0.5]
    ph = rng.integers(0, 4, (3, 200)).astype(np.int32)
    for tree in [("PH", 1), ("AND", ("G", 0), ("PH", 0)),
                 ("AND_NOT", ("PH", 1), ("OR", ("G", 2), ("F", 0))),
                 ("XOR", ("PH", 0), ("PH", 1))]:
        want = jex._eval_tree(tree, {
            "G": lambda g: (jnp.asarray(orbits) & (1 << g)) != 0,
            "F": lambda i: jnp.asarray(fres[i]),
            "PH": lambda i: (jnp.asarray(ph) & (1 << i)) != 0,
            "ALL": lambda: jnp.ones(orbits.shape, bool)})
        got = kernels._eval_program_plain(
            kernels.tree_program(tree), torch.from_numpy(orbits),
            [torch.from_numpy(fres[0])], orbits.shape, CPU,
            torch.from_numpy(ph))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plans_beyond_the_limits_raise(uniform):
    (jcfg, _fn, _batch, _chunk), *_ = uniform.jax_groups("P2")
    cfg = tp._fields(jcfg, ExecConfig)
    check_supported(dataclasses.replace(cfg, phrase_carry=True), BM25())
    p = cfg.phrases[0]
    for over in ({"cand_cap": 2 * kernels.MAX_CAND_CAP},
                 {"pmax": 2 * kernels.MAX_PMAX},
                 {"phrases": (p,) * (kernels.MAX_PHRASES + 1)}):
        with pytest.raises(NotImplementedError, match="K14"):
            check_supported(dataclasses.replace(cfg, **over), BM25())
    # a phrase of more than 16 terms is admitted: the kernel finds the
    # lists past its per-thread table again (tests/test_torch_limits.py)
    check_supported(dataclasses.replace(
        cfg, phrases=((tuple(range(17)), p[1], p[2], p[3]),)), BM25())


def _config_bench():
    spec = importlib.util.spec_from_file_location(
        "config_bench", os.path.join(ROOT, "scripts", "config_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config2_draws_are_config_bench_draws():
    """The corpus and the published queries are config_bench's, draw for
    draw."""
    cb = _config_bench()
    docs = cb.build_corpus2(2000, seed=7)
    corpus = sp.build_corpus2(2000, seed=7)
    assert [" ".join(sp.word(t) for t in row) for row in corpus.tokens] \
        == docs
    phrases, booleans = cb.queries2(docs, n_each=40, seed=11)
    qs = sp.queries2(corpus, n_each=40, n_three=4, seed=11)
    assert [w for f, _q, w in qs if f == "P2"] == phrases
    assert [(w[0], list(w[1:])) for f, _q, w in qs if f == "B"] == booleans


def test_config2_generator_matches_its_oracle():
    """BatchSearcher(k=10) over config 2's generator at 2,000 docs: every
    query at parity with the float64 oracle (counts exact, ranks as tie
    groups within rtol 1e-5), under the launch groups' cand_cap and pmax;
    every phrase hit a real adjacency in the text."""
    corpus = sp.build_corpus2(2000, seed=7)
    qs = sp.queries2(corpus, n_each=48, n_three=16, seed=11)
    bs = BatchSearcher(SegmentSearcher(corpus.seg, device=CPU), k=10)
    irs = [q for _f, q, _w in qs]
    caps, pmaxes = [0] * len(qs), [0] * len(qs)
    for cfg, _fn, _batch, chunk in bs.plan(irs):
        for qi in chunk:
            caps[qi], pmaxes[qi] = cfg.cand_cap, cfg.pmax
    res = bs.run(irs)
    want = sp.oracle_answers(corpus, qs, caps, pmaxes, k=10, rtol=RTOL)
    for (fam, _q, ws), r, w in zip(qs, res, want):
        assert r["count"] == w["count"], (fam, ws)
        fin = np.isfinite(r["scores"])
        got = list(zip(r["docids"][fin].tolist(), r["scores"][fin].tolist()))
        assert len(got) == min(10, w["count"])
        for i, (d, s) in enumerate(got):
            assert abs(s - w["ranked"][i][1]) <= RTOL * w["ranked"][i][1]
            assert d in {ed for ed, es in w["ranked"]
                         if abs(es - s) <= RTOL * es}
            if fam in ("P2", "P3"):
                toks = [sp.word(t) for t in corpus.tokens[d]]
                n = len(ws)
                assert any(tuple(toks[j:j + n]) == ws
                           for j in range(len(toks) - n + 1))
    assert sum(r["count"] for r in res[:48]) > 0
