"""The join executor (K21b) against the JAX package on the CPU.

JAX's ``_execute_join`` (executor.py:1066-1129) is chosen by no planner:
a caller sets ``join=True`` on a bound plan, as these tests do on both
packages' plans. The port runs it through the kernels it has -
score_slices at the class widths and merge_docs - and JAX's row epilogue
``_finish_rows`` with its tie window.

  rows              score_slices + merge_docs against the rows JAX's
                    _execute_join hands to _finish_rows: the same row
                    indices, owner at the doc's lowest term, group bits,
                    and a kept row's sum (JAX adds the row's own term, then
                    0.0 for every earlier one, then the later ones: the
                    term order merge_docs adds in)
  execute           SegmentSearcher.execute of join plans against JAX's on
                    the browse corpus (tests/test_torch_browse.py's world:
                    deletes, a category missing on every 7th doc): ORs, an
                    AND, an AND_NOT, a value filter, a value sort,
                    aggregations, a collapse
  the tie window    under Coord (one point a matching term) the best
                    k * 8 rows by row index, then by docid: JAX's top 10 is
                    not the 10 smallest docids of the top score, and the
                    port returns JAX's; under Bool (an unweighted plan)
                    both rank by docid
  phrases           JAX's _finish_rows has no PH leaf: JAX fails with a
                    KeyError, the port raises by name

Tolerances: ids, owners, orbits and counts are equal; a kept row's sum
equals JAX's bit for bit under BM25, within rtol 1e-5 under PL2 and
DiceCoeff (XLA's and torch's log2 differ by ulps); answers agree to rtol
1e-5 and rank exactly (the tie window orders them the same on both sides).
"""

import dataclasses

import numpy as np
import pytest
import torch

import xapiand_tpu.ops.executor as jex
import xapiand_tpu.query.plan as jplan
from test_torch_browse import _price_range, compare, world  # noqa: F401
from test_torch_semijoin import segs  # noqa: F401
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.models.weights import get_scheme as jget
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.weights import get_scheme
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import SENTINEL
from xapiand_tpu_torch.query import plan as pplan
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import SegmentSearcher
from xapiand_tpu_torch.utils import synth_schemes as ss

RTOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


def _joined(bound):
    return dataclasses.replace(bound, cfg=dataclasses.replace(bound.cfg,
                                                              join=True))


@pytest.mark.parametrize("scheme", ["bm25", "pl2", "dicecoeff"])
def test_merge_docs_rows_equal_jax_join_rows(segs, monkeypatch, scheme):
    """score_slices at the class widths + merge_docs against the rows of
    JAX's _execute_join, for ORs and ANDs of three terms."""
    seg, pseg = segs
    st = ss.real_stats(seg)
    jst = JStats(**{f: getattr(st, f) for f in
                    ("doc_count", "avg_doclen", "doclen_lower",
                     "doclen_upper", "total_len")})
    jarr = JSearcher(seg, jget(scheme)).device_segment.arrays_pytree()
    parr = SegmentSearcher(pseg, get_scheme(scheme),
                           device=CPU).device_segment.arrays_pytree()
    spec = get_scheme(scheme).kernel_spec(st)
    uniq = parr["uniqterms"] if spec.needs_uniq else None
    captured = {}

    def capture(seg_, plan_, cfg_, d, sums, orbits, first):
        captured.update(d=d, sums=sums, orbits=orbits, first=first)
        return {}

    monkeypatch.setattr(jex, "_finish_rows", capture)
    names = sorted(seg.terms, key=lambda t: -seg.terms[t].length)
    rng = np.random.Generator(np.random.PCG64(6))
    n_kept = 0
    for i in range(16):
        a, b, c = (names[int(x)] for x in rng.integers(0, 120, 3))
        ir = JQ.or_terms([a, b, c]) if i % 2 else \
            JQ.and_(JQ.term(a), JQ.or_terms([b, c]))
        jb = jplan.bind(jplan.compile_ir(ir), seg, jget(scheme), jst, k=10)
        jex._execute_join(jarr, {k: np.asarray(v) for k, v in
                                 jb.arrays.items()},
                          dataclasses.replace(jb.cfg, join=True), jst,
                          jget(scheme))
        arr = {k: torch.from_numpy(np.asarray(jb.arrays[k])[None])
               for k in ("offsets", "lens", "tconst", "scoring",
                         "group_bits")}
        classes = jb.cfg.term_classes()
        ids, w, _tail = kernels.score_slices(
            (parr["post_docids"], parr["post_wdf"], parr["post_doclen"]),
            None, arr["offsets"], arr["lens"], arr["tconst"], arr["scoring"],
            classes, (False,) * len(classes), spec, uniq)
        sums, owner, count, orbits = kernels.merge_docs(
            ids, w, classes, arr["group_bits"], None, None, True,
            n_docs=parr["deleted"].shape[0])
        keep = np.asarray(captured["first"])
        assert ids[0].tolist() == np.asarray(captured["d"]).tolist()
        assert owner[0].tolist() == keep.tolist()
        assert int(count[0]) == int(keep.sum())
        assert orbits[0].tolist() == np.asarray(captured["orbits"]).tolist()
        np.testing.assert_allclose(sums[0].numpy()[keep],
                                   np.asarray(captured["sums"])[keep],
                                   rtol=0 if scheme == "bm25" else RTOL)
        n_kept += int(keep.sum())
    assert n_kept > 0


JOIN_CASES = {
    "or3": (lambda w: lambda Qc, t: Qc.or_terms([t(3), t(17), t(60)]), {}),
    "and": (lambda w: lambda Qc, t: Qc.and_(Qc.term(t(2)),
                                            Qc.or_terms([t(5), t(9)])), {}),
    "and_not": (lambda w: lambda Qc, t: Qc.and_not(
        Qc.or_terms([t(0), t(4)]), Qc.term(t(1))), {}),
    "filter_sorted": (
        lambda w: lambda Qc, t: Qc.and_(Qc.term(t(2)),
                                        _price_range(Qc, w.price, 10, 60)),
        lambda w: {"sort": (("value", w.price, True),)}),
    "aggs": (lambda w: lambda Qc, t: Qc.or_terms([t(6), t(11)]),
             lambda w: {"aggs": (("count",), ("stats", w.price),
                                 ("terms", w.cat, 16, ()))}),
    "collapse": (lambda w: lambda Qc, t: Qc.or_terms([t(3), t(17), t(60)]),
                 lambda w: {"collapse_slot": w.cat, "collapse_max": 2}),
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_join_execute_matches_jax(world, case):  # noqa: F811
    """SegmentSearcher.execute of a join plan in both packages: counts,
    the ranked docids in order, scores, aggregations."""
    build, kw = JOIN_CASES[case]
    kw = kw(world) if callable(kw) else kw
    jb, pb = world.bind_both(build(world), k=10, **kw)
    want = world.js.execute(_joined(jb), world.stats)
    got = world.ps.execute(_joined(pb), world.stats)
    assert int(want["count"]) > 0
    compare(got, want, True)
    if "aggs" in kw:
        assert int(got["aggs"][0]) == int(want["aggs"][0])
        for key, v in want["aggs"][1].items():
            np.testing.assert_allclose(got["aggs"][1][key], np.asarray(v),
                                       rtol=RTOL)
        assert np.asarray(got["aggs"][2]).tolist() == \
            np.asarray(want["aggs"][2]).tolist()


def _scheme_bound(world, scheme, words):  # noqa: F811
    """Both packages' join plans of OR(words) under a scheme."""
    jst = JStats(doc_count=world.jseg.doc_count,
                 avg_doclen=world.jseg.avg_doclen, doclen_lower=1.0)
    jb = jplan.bind(jplan.compile_ir(JQ.or_terms(words)), world.jseg,
                    jget(scheme), jst, k=10)
    pb = pplan.bind(pplan.compile_ir(Q.or_terms(words)), world.pseg,
                    get_scheme(scheme), world.cstats, k=10)
    return _joined(jb), _joined(pb)


def test_join_tie_window_matches_jax(world):  # noqa: F811
    """Coord scores a doc by its matching terms, so the docs of the top
    score tie; a join's rows are term-grouped, and past k * 8 ties JAX's
    window keeps the first rows by row index - the docs of the first
    term - and its top 10 is not the 10 smallest docids of the top score.
    The port returns JAX's list. Under Bool the plan is unweighted and
    both rank by docid."""
    seg = world.jseg

    def docs_of(t):
        ti = seg.terms[t]
        return set(seg.post_docids[ti.offset:ti.offset + ti.length].tolist())

    # two words of 90-300 docs that fewer than 10 docs hold both: the top
    # score holds fewer than 10 docs and the next ties past k * 8
    words = sorted(t for t, ti in seg.terms.items()
                   if t[:1] == "w" and t[1:].isdigit() and
                   90 <= ti.length <= 300)
    pair = next([a, b] for i, a in enumerate(words) for b in words[i + 1:]
                if len(docs_of(a) & docs_of(b)) < 8)
    for scheme in ("coord", "bool"):
        jb, pb = _scheme_bound(world, scheme, pair)
        want = world.js.execute(jb, world.stats, scheme=jget(scheme))
        got = world.ps.execute(pb, world.stats, scheme=get_scheme(scheme))
        assert int(got["count"]) == int(want["count"]) > 80
        assert got["docids"].tolist() == np.asarray(want["docids"]).tolist()
        assert got["scores"].tolist() == np.asarray(want["scores"]).tolist()
        if scheme == "bool":
            assert jb.cfg.unweighted
            assert (np.diff(got["docids"]) > 0).all()
            continue
        top = got["scores"][-1]
        sets = [docs_of(t) for t in pair]
        holds = {d: sum(d in x for x in sets) for d in sets[0] | sets[1]
                 if not seg.deleted[d]}
        at_top = sorted(d for d, n in holds.items() if n == top)
        assert len(at_top) > 80
        above = [d for d in got["docids"].tolist()
                 if holds[d] > top]
        assert got["docids"].tolist() != \
            sorted(above) + at_top[:10 - len(above)]


def test_join_with_phrases_fails_in_both(world):  # noqa: F811
    """A join plan with a phrase leaf: JAX's _finish_rows has no PH leaf
    (KeyError while it traces); the port raises NotImplementedError naming
    it."""
    jb, pb = world.bind_both(
        lambda Qc, t: Qc.and_(Qc.phrase([t(0), t(1)]), Qc.term(t(2))), k=10)
    assert jb.cfg.phrases and pb.cfg.phrases
    with pytest.raises(KeyError, match="PH"):
        world.js.execute(_joined(jb), world.stats)
    with pytest.raises(NotImplementedError, match="PH leaf"):
        world.ps.execute(_joined(pb), world.stats)
    assert SENTINEL == kernels.SENTINEL


def _collapse_both(world, scheme, cmax):  # noqa: F811
    """A collapse on the category over a join plan of three words under a
    scheme, through JAX's execute and the port's."""
    words = ["w20", "w31", "w40"]
    jst = JStats(doc_count=world.jseg.doc_count,
                 avg_doclen=world.jseg.avg_doclen, doclen_lower=1.0)
    kw = {"k": 10, "collapse_slot": world.cat, "collapse_max": cmax}
    jb = jplan.bind(jplan.compile_ir(JQ.or_terms(words)), world.jseg,
                    jget(scheme), jst, **kw)
    pb = pplan.bind(pplan.compile_ir(Q.or_terms(words)), world.pseg,
                    get_scheme(scheme), world.cstats, **kw)
    want = world.js.execute(_joined(jb), world.stats, scheme=jget(scheme))
    got = world.ps.execute(_joined(pb), world.stats,
                           scheme=get_scheme(scheme))
    return got, want, jb


def test_join_collapse_ties_depart_from_jax(world, monkeypatch):  # noqa: F811
    """Once a named departure (ROADMAP queue 3), now JAX's answer: a
    collapse on a join plan keeps, among the equal-score rows of one key,
    the first in row order (_collapse's stable sort of term-grouped rows),
    and collapse_rows' row-order mode keeps the same rows and orders equal
    scores as the collapsed rows stand. Under Coord every doc of a key that
    holds one term ties: the docids, scores and count are JAX's, at a cap
    of 1 and of 3. A docid-ordered collapse (the sort path's) keeps other
    rows here: forced on the join rows, its docids differ from JAX's."""
    for cmax in (1, 3):
        got, want, _jb = _collapse_both(world, "coord", cmax)
        assert int(got["count"]) == int(want["count"]) > 0
        assert got["docids"].tolist() == \
            np.asarray(want["docids"]).tolist(), cmax
        assert got["scores"].tolist() == \
            np.asarray(want["scores"]).tolist(), cmax
    by_docid = kernels.collapse_rows
    monkeypatch.setattr(kernels, "collapse_rows",
                        lambda *a: by_docid(*a[:5], False))
    got, want, _jb = _collapse_both(world, "coord", 1)
    assert got["scores"].tolist() == np.asarray(want["scores"]).tolist()
    assert got["docids"].tolist() != np.asarray(want["docids"]).tolist()


def test_join_collapse_ties_bool_matches_jax(world):  # noqa: F811
    """The same collapse under Bool: an unweighted plan, ordered by docid
    (sort_topk), where every row ties at 0 and the survivor of each key is
    its first row in JAX's row order: docids and count are JAX's."""
    for cmax in (1, 3):
        got, want, jb = _collapse_both(world, "bool", cmax)
        assert jb.cfg.unweighted
        assert int(got["count"]) == int(want["count"]) > 0
        assert got["docids"].tolist() == \
            np.asarray(want["docids"]).tolist(), cmax
        assert got["scores"].tolist() == \
            np.asarray(want["scores"]).tolist(), cmax


@pytest.mark.parametrize("scheme", ["pl2", "dlh"])
def test_join_nan_schemes_match_jax(world, scheme):  # noqa: F811
    """A join plan with a non-scoring term under a scheme that weighs it
    NaN (ROADMAP queue 3): the rows holding it sum to NaN on both sides,
    and the tie window leaves them out as JAX's does; counts equal."""
    jst = JStats(doc_count=world.jseg.doc_count,
                 avg_doclen=world.jseg.avg_doclen, doclen_lower=1.0,
                 doclen_upper=64.0, total_len=float(world.jseg.total_doclen))
    jb = jplan.bind(jplan.compile_ir(JQ.or_(
        JQ.term("w3"), JQ.filter(JQ.term("w5"), JQ.term("w7")))),
        world.jseg, jget(scheme), jst, k=10)
    pb = pplan.bind(pplan.compile_ir(Q.or_(
        Q.term("w3"), Q.filter(Q.term("w5"), Q.term("w7")))),
        world.pseg, get_scheme(scheme), world.cstats, k=10)
    want = world.js.execute(_joined(jb), world.stats, scheme=jget(scheme))
    got = world.ps.execute(_joined(pb), world.stats,
                           scheme=get_scheme(scheme))
    assert int(got["count"]) == int(want["count"]) > 0
    assert got["docids"].tolist() == np.asarray(want["docids"]).tolist()
    real = got["docids"] != SENTINEL
    assert real.any()
    np.testing.assert_allclose(got["scores"][real],
                               np.asarray(want["scores"])[real], rtol=RTOL)
