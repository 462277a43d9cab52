"""Slice 5, geo circle AND datetime range (BASELINE config 4), with the
HTM range test (K16) and rank_count (K15), against the JAX package on the
CPU: the port's plain versions and the JAX functions on the same inputs.
The cases mirror tests/test_geo.py, test_engine.py::test_geo_query_e2e
and the geo parts of test_sort_distance.py.

  rank_count (K15)       vs executor.py rank_count on random, tied and
                         INT32_MAX-padded inputs, at both count_equal
  geo_leaves (K16)       vs executor.py _gather_geo_leaves per doc, on the
                         rows the port's merge gives every family
  execute_batch          vs jit(vmap(execute)): circle AND 3-month window
                         (P: the geo cover drives), circle AND 1-3 days (T:
                         the hour cover drives), a circle under OR and
                         under AND_NOT, a hand-cut RMAX below the docs'
                         range counts, an empty cover; precompacted groups
                         among them
  BatchSearcher.run      vs the JAX BatchSearcher.run on a mixed P + T
                         batch: launch groups, batch widths (the geo
                         weight) and results
  the tree program       GEO leaves vs _eval_tree
  limits                 plans beyond the kernel's limits raise
                         NotImplementedError naming K16
  config 4's generator   utils/synth_geo.py draws what
                         scripts/config_bench.py draws, builds what the JAX
                         Database indexes (geo column, geo value column, ts
                         keys, geo and date terms), builds the IR
                         QueryDSL.parse builds, and BatchSearcher at 2,000
                         docs matches its oracle and the haversine bounds

The world is one JAX ``Database`` commit (XT_HOST_PATH=0: the JAX device
path) of config_bench.build_corpus4(2000)'s docs, then three docs whose
``loc`` is a circle or a polygon (11-14 ranges a doc, where a point has
at most 6, so the plan's RMAX is 16), every 53rd doc deleted, carried into
the port's Segment as tests/test_torch_phrase.py carries its segments.
Both BatchSearchers batch at least 8 queries a launch, not 64: the JAX
execute's sort-joins over B x R x RMAX rows are slow on the CPU.

Tolerances: masks, verdicts, counts and docids equal; scores equal too
(config 4's plans are unweighted: every doc scores 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_predicate as tp
import xapiand_tpu.ops.executor as jex
from test_torch_phrase import _config_bench, to_port
from xapiand_tpu.database import Database
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.query.dsl import QueryDSL
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.segment import (GeoColumn, Segment,
                                              ValueColumn,
                                              device_segment_from_numpy,
                                              terms_from)
from xapiand_tpu_torch.models.weights import BM25
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import (SENTINEL, ExecConfig,
                                            check_supported, execute_batch)
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_geo as sg

CPU = torch.device("cpu")
N_CB = 2000
I32MAX = 2**31 - 1

EXTRA = [
    {"body": "w1 w2", "ts": "2024-03-05T10:00:00",
     "loc": {"_circle": {"_longitude": -100.0, "_latitude": 40.0,
                         "_radius": 13000}}},
    {"body": "w3", "ts": "2024-04-15T00:00:00",
     "loc": {"_circle": {"_longitude": -90.5, "_latitude": 35.2,
                         "_radius": 13000}}},
    {"body": "w4", "ts": "2024-03-20T12:00:00",
     "loc": {"_polygon": {"_longitude": [-101.0, -100.8, -100.9],
                          "_latitude": [39.0, 39.05, 39.25]}}},
]
MIN_BATCH = 8      # both BatchSearchers: launch groups of 8-32 queries


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


def _circle(lon, lat, radius):
    return {"loc": {"_circle": {"_longitude": lon, "_latitude": lat,
                                "_radius": radius}}}


def _window(lo, hi):
    return {"ts": {"_from": lo, "_to": hi}}


class GWorld:
    """The segment on both sides, the query families, the searchers."""

    def __init__(self):
        self.cb = _config_bench()
        docs = self.cb.build_corpus4(N_CB, seed=7) + EXTRA
        db = Database()
        for i, d in enumerate(docs):
            db.index_document(dict(d), doc_id=str(i))
        db.commit()
        jseg = db._searchers[0].segment
        jseg.deleted[list(range(5, len(docs), 53))] = True
        self.db, self.jseg = db, jseg
        self.dsl = QueryDSL(db.schema)
        self.pseg = tp._fields(
            jseg, Segment,
            terms=terms_from(jseg.terms),
            values={s: tp._fields(c, ValueColumn)
                    for s, c in jseg.values.items()},
            geo={s: tp._fields(g, GeoColumn) for s, g in jseg.geo.items()})
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
        P = [p for f, _q, p in sg.queries4(24, 0)]
        T = [p for f, _q, p in sg.queries4(0, 12)]
        near = [_circle(-100.0, 40.0, 100_000.0),
                _circle(-90.0, 35.0, 150_000.0),
                _circle(-100.5, 39.5, 120_000.0)]
        spring = _window("2024-03-01T00:00:00", "2024-06-01T00:00:00")
        self.fams = {
            "P": [self.parse(sg.query_dsl(p)) for p in P]
            + [self.parse({"_and": [c, spring]}) for c in near],
            "T": [self.parse(sg.query_dsl(p)) for p in T],
            "OR": [self.parse({"_or": [c, near[i - 1]]})
                   for i, c in enumerate(near)],
            "NOT": [self.parse({"_and_not": [spring, c]}) for c in near]
            + [self.parse({"_and_not": [
                _window("2024-01-10T00:00:00", "2024-01-12T00:00:00"),
                sg.query_dsl(P[0])["_and"][0]]})],
            "RMAX": [self.parse({"_and": [c, spring]}) for c in near],
            "EMPTY": [JQ.and_(JQ.geo(sg.LOC_SLOT, (), ()),
                              self.parse(spring))],
        }

    def parse(self, dsl):
        return self.dsl.parse(dsl)

    def jax_groups(self, fam):
        return JBatch(self.js, k=10, min_batch=MIN_BATCH).plan(
            self.fams[fam])

    def port_batch(self, batch):
        out = {k: torch.from_numpy(np.array(batch[k]))
               for k in ("offsets", "lens", "tconst", "scoring",
                         "group_bits", "fparams") if k in batch}
        if "geo_queries" in batch:
            out["geo_queries"] = [torch.from_numpy(np.array(q))
                                  for q in batch["geo_queries"]]
        return out


_WORLD: list = []


@pytest.fixture(scope="module")
def world():
    if not _WORLD:
        _WORLD.append(GWorld())
    return _WORLD[0]


def _over(fam, jcfg):
    """The hand-cut RMAX of the RMAX family: 2 ranges a doc."""
    if fam != "RMAX":
        return jcfg
    return dataclasses.replace(jcfg, geo_specs=tuple(
        (s, qr, 2) for s, qr, _rm in jcfg.geo_specs))


# ---------------------------------------------------------------------------
# K15 rank_count


def _rank_inputs(case):
    rng = np.random.Generator(np.random.PCG64({"random": 1, "tied": 2,
                                               "padded": 3}[case]))
    if case == "random":
        a = np.sort(rng.integers(-1000, 1000, 300))
        x = rng.integers(-1200, 1200, 500)
    elif case == "tied":
        a = np.sort(rng.integers(0, 12, 200))
        x = np.concatenate([np.arange(-1, 14), rng.integers(0, 12, 100)])
    else:
        a = np.concatenate([np.sort(rng.integers(0, 2**30, 40)),
                            np.full(24, I32MAX)])
        x = np.concatenate([rng.integers(0, 2**30, 200), [I32MAX, -1, 0]])
    return a.astype(np.int32), x.astype(np.int32)


@pytest.mark.parametrize("count_equal", [False, True])
@pytest.mark.parametrize("case", ["random", "tied", "padded"])
def test_rank_count_vs_jax(case, count_equal):
    """K15: the count of a below (or at most) each x equals JAX's sort-join
    rank_count, over any order of x, ties and INT32_MAX pads."""
    a, x = _rank_inputs(case)
    want = np.asarray(jex.rank_count(jnp.asarray(a), jnp.asarray(x),
                                     count_equal))
    got = kernels.rank_count(torch.from_numpy(a), torch.from_numpy(x),
                             count_equal)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the batched form: one row of a per row of x
    got2 = kernels.rank_count(torch.from_numpy(np.stack([a, a])),
                              torch.from_numpy(np.stack([x, x[::-1]])),
                              count_equal)
    np.testing.assert_array_equal(got2[1].numpy(), want[::-1])


# ---------------------------------------------------------------------------
# K16 geo_leaves


def _port_rows(world, cfg, pb):
    """score_slices and merge_docs (plain) of one group: ids, first (owner
    & not deleted), orbits."""
    widths = cfg.term_classes()
    post = tuple(world.parr[k] for k in
                 ("post_docids", "post_wdf", "post_doclen"))
    ids, w, _tail = kernels.score_slices(
        post, None, pb["offsets"], pb["lens"], pb["tconst"], pb["scoring"],
        widths, (0,) * cfg.T, world.params)
    deleted = world.parr["deleted"] if cfg.has_deletes else None
    _sums, first, _count, orbits = kernels.merge_docs(
        ids, w, widths, pb["group_bits"], deleted, None, True,
        n_docs=world.parr["deleted"].shape[0])
    return ids, first, orbits


@pytest.mark.parametrize("fam", ["P", "T", "OR", "NOT", "RMAX"])
def test_geo_leaves_vs_jax(world, fam):
    """K16: on every live row, bit g of the port's word is JAX's
    _gather_geo_leaves result for leaf g (the doc's first RMAX ranges
    against the query's cover); rows that are not live get 0."""
    n_true = 0
    for jcfg, _fn, batch, _chunk in world.jax_groups(fam):
        jcfg = _over(fam, jcfg)
        cfg = tp._fields(jcfg, ExecConfig)
        assert cfg.geo_specs
        pb = world.port_batch(batch)
        ids, first, _orbits = _port_rows(world, cfg, pb)
        cols = [world.parr["geo"][s] for s, _qr, _rm in cfg.geo_specs]
        got = kernels.geo_leaves(cols, cfg.geo_specs, pb["geo_queries"],
                                 ids, first)
        nd1 = world.jarr["doclen"].shape[0]
        want = jax.vmap(lambda gq, d: jnp.stack(jex._gather_geo_leaves(
            world.jarr, jcfg, list(gq), jnp.minimum(d, nd1 - 1))))(
                tuple(batch["geo_queries"]), jnp.asarray(ids.numpy()))
        want = np.asarray(want)                      # [B, G, C]
        live = first.numpy()
        bits = got.numpy()
        assert (bits[~live] == 0).all()
        for g in range(len(cfg.geo_specs)):
            mine = (bits >> g) & 1 == 1
            np.testing.assert_array_equal(mine[live], want[:, g][live])
            n_true += int(mine.sum())
    assert n_true > 0


def test_geo_leaves_packed_rows_and_padding():
    """Packed rows (base None: live = docid != SENTINEL), a SENTINEL row,
    a doc past RMAX and a cover padded with INT32_MAX rows, by hand."""
    col = {"doc_off": torch.tensor([0, 2, 5, 0], dtype=torch.int32),
           "doc_len": torch.tensor([2, 3, 1, 0], dtype=torch.int32),
           "flat_start": torch.tensor([10, 40, 5, 53, 90, 70, I32MAX],
                                      dtype=torch.int32),
           "flat_end": torch.tensor([20, 45, 8, 60, 95, 75, -1],
                                    dtype=torch.int32)}
    q = torch.tensor([[[44, 52], [80, 100]] + [[I32MAX, I32MAX]] * 14],
                     dtype=torch.int32)
    ids = torch.tensor([[0, 1, 2, SENTINEL, 1]], dtype=torch.int32)
    got = kernels.geo_leaves([col], ((7, 16, 2),), [q], ids, None)
    # doc 0: [40, 45] meets [44, 52]; doc 1's third range, [90, 95],
    # meets [80, 100] but lies past RMAX 2; doc 2: [70, 75] meets nothing;
    # the SENTINEL row reads the pad doc, which has no range
    assert got.tolist() == [[1, 0, 0, 0, 0]]
    got = kernels.geo_leaves([col], ((7, 16, 1),), [q], ids, None)
    assert got.tolist() == [[0, 0, 0, 0, 0]]
    base = torch.tensor([[True, False, True, True, True]])
    got = kernels.geo_leaves([col, col], ((7, 16, 4),) * 2, [q, q], ids,
                             base)
    assert got.tolist() == [[3, 0, 0, 0, 3]]


# ---------------------------------------------------------------------------
# execute_batch


def _run_case(world, jcfg, batch):
    """execute_batch vs the JAX package's jit(vmap(execute)) on one launch
    group: counts, docids and scores equal."""
    cfg = tp._fields(jcfg, ExecConfig)
    want = world.js.batched(jcfg)(world.jarr, batch, world.jstats)
    got = execute_batch(world.parr, world.port_batch(batch), cfg,
                        world.pstats, BM25())
    assert set(got) == set(want)
    for key in ("count", "docids", "scores"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), key)
    return int(got["count"].sum())


@pytest.mark.parametrize("fam", ["P", "T", "OR", "NOT", "RMAX", "EMPTY"])
def test_execute_batch_vs_jax(world, fam):
    """execute_batch equals JAX execute on each geo family's launch groups
    (these configurations raised NotImplementedError before this slice)."""
    total = 0
    for jcfg, _fn, batch, _chunk in world.jax_groups(fam):
        jcfg = _over(fam, jcfg)
        assert jcfg.geo_specs and jcfg.unweighted
        total += _run_case(world, jcfg, batch)
    assert (total == 0) == (fam == "EMPTY")


def test_precompaction_and_full_rows_both_run(world):
    """The NOT groups precompact (a cap below the row width: geo_leaves
    over packed rows), the OR groups do not (every owner row), the
    multi-range docs set RMAX to 16, and P's geo cover and T's hour cover
    each drive their family."""
    def caps(fam):
        return [(c.compact_cap, sum(c.classes)) for c, *_x in
                world.jax_groups(fam)]

    assert any(0 < cap < R for cap, R in caps("NOT"))
    assert all(not 0 < cap < R for cap, R in caps("OR"))
    rmax = {c.geo_specs[0][2] for c, *_x in world.jax_groups("P")}
    assert rmax == {16}
    trees = {c.tree for f in "PT" for c, *_x in world.jax_groups(f)}
    assert trees == {("AND", ("AND", ("G", 0), ("GEO", 0)), ("F", 0)),
                     ("AND", ("GEO", 0), ("AND", ("G", 0), ("F", 0)))}
    assert world.jseg.geo[sg.LOC_SLOT].max_doc_ranges > 8


def test_batch_search_run_vs_jax(world):
    """BatchSearcher.run: the port vs the JAX package on one mixed batch of
    P and T; the launch groups and batch widths are JAX's (geo groups weigh
    4 (1 + RMAX) a row)."""
    fams = ("P", "T")
    jirs = [q for f in fams for q in world.fams[f]]
    pb = BatchSearcher(world.ps, k=10, min_batch=MIN_BATCH)
    jb = JBatch(world.js, k=10, min_batch=MIN_BATCH)
    irs = [to_port(q) for q in jirs]
    got_plan = [(c.tree, c.classes, c.geo_specs, c.compact_cap,
                 int(b["offsets"].shape[0]), tuple(ch))
                for c, _f, b, ch in pb.plan(irs)]
    want_plan = [(c.tree, c.classes, c.geo_specs, c.compact_cap,
                  int(b["offsets"].shape[0]), tuple(ch))
                 for c, _f, b, ch in jb.plan(jirs)]
    assert got_plan == want_plan
    got, want = pb.run(irs), jb.run(jirs)
    for g, w in zip(got, want):
        assert g["count"] == w["count"]
        np.testing.assert_array_equal(g["docids"], np.asarray(w["docids"]))
        np.testing.assert_array_equal(g["scores"], np.asarray(w["scores"]))
    assert sum(g["count"] for g in got) > 0


def test_tree_program_geo_leaves():
    """GEO leaves of the postfix program read the geo verdict word, as
    _eval_tree's GEO leaves read _gather_geo_leaves' rows."""
    rng = np.random.Generator(np.random.PCG64(4))
    orbits = rng.integers(0, 8, (3, 200)).astype(np.int32)
    fres = [rng.random((3, 200)) < 0.5]
    ph = rng.integers(0, 4, (3, 200)).astype(np.int32)
    geo = rng.integers(0, 4, (3, 200)).astype(np.int32)
    for tree in [("GEO", 1), ("AND", ("AND", ("G", 0), ("GEO", 0)), ("F", 0)),
                 ("AND_NOT", ("F", 0), ("OR", ("GEO", 1), ("PH", 0))),
                 ("XOR", ("GEO", 0), ("GEO", 1))]:
        want = jex._eval_tree(tree, {
            "G": lambda g: (jnp.asarray(orbits) & (1 << g)) != 0,
            "F": lambda i: jnp.asarray(fres[i]),
            "PH": lambda i: (jnp.asarray(ph) & (1 << i)) != 0,
            "GEO": lambda i: (jnp.asarray(geo) & (1 << i)) != 0,
            "ALL": lambda: jnp.ones(orbits.shape, bool)})
        got = kernels._eval_program_plain(
            kernels.tree_program(tree), torch.from_numpy(orbits),
            [torch.from_numpy(fres[0])], orbits.shape, CPU,
            torch.from_numpy(ph), torch.from_numpy(geo))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plans_beyond_the_limits_raise(world):
    (jcfg, _fn, _batch, _chunk), *_ = world.jax_groups("P")
    cfg = tp._fields(jcfg, ExecConfig)
    check_supported(cfg, BM25())
    g = cfg.geo_specs[0]
    for over in ({"geo_specs": (g,) * (kernels.MAX_GEO + 1)},
                 {"geo_specs": ((g[0], 2 * kernels.MAX_GEO_QR, g[2]),)},
                 {"geo_specs": ((g[0], g[1], 2 * kernels.MAX_GEO_RMAX),)}):
        with pytest.raises(NotImplementedError, match="K16"):
            check_supported(dataclasses.replace(cfg, **over), BM25())
    # the dense path is ported (K12): a dense geo plan is admitted
    check_supported(dataclasses.replace(cfg, dense=True), BM25())
    ids = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="geobits"):
        kernels.filter_leaves({}, (), (), torch.zeros((1, 0, 4),
                                                      dtype=torch.int32),
                              ids, None, ids, kernels.tree_program(
                                  ("GEO", 0)))


# ---------------------------------------------------------------------------
# config 4's generator


def test_config4_draws_are_config_bench_draws(world):
    """The corpus and the published queries are config_bench's, draw for
    draw."""
    docs = world.cb.build_corpus4(N_CB, seed=7)
    words, lon, lat, month, day, hour = sg.draw_docs(N_CB, seed=7)
    for i, d in enumerate(docs):
        assert d["body"] == " ".join(f"w{t}" for t in words[i])
        assert d["loc"]["_point"] == {"_longitude": lon[i],
                                      "_latitude": lat[i]}
        assert d["ts"] == sg.ts_string(month[i], day[i], hour[i])
    pub = world.cb.queries4(40, seed=11)
    mine = [sg.query_dsl(p) for _f, _q, p in sg.queries4(40, 0)]
    assert mine == pub


def test_synth_geo_is_the_database(world):
    """synth_geo at 2,000 docs: the JAX Database's slots and prefixes, its
    geo column and geo value column, its ts keys, and its geo and date
    terms (their postings among the same 2,000 docs); and its queries are
    the IR QueryDSL.parse builds."""
    schema = world.db.schema
    for f, slot, prefix in (("loc", sg.LOC_SLOT, sg.LOC_PREFIX),
                            ("ts", sg.TS_SLOT, sg.TS_PREFIX)):
        spec = schema.get_field(f)
        assert (spec.slot, spec.prefix) == (slot, prefix)
    loc = schema.get_field("loc")
    assert (loc.error, list(loc.accuracy)) == (sg.GEO_ERROR, sg.GEO_LEVELS)
    assert list(schema.get_field("ts").accuracy) == sg.DATE_UNITS
    c = sg.build_corpus4(N_CB, seed=7)
    jg, pg = world.jseg.geo[sg.LOC_SLOT], c.seg.geo[sg.LOC_SLOT]
    n = int(pg.doc_len.sum())
    np.testing.assert_array_equal(pg.doc_len[:N_CB], jg.doc_len[:N_CB])
    np.testing.assert_array_equal(pg.doc_off[:N_CB], jg.doc_off[:N_CB])
    np.testing.assert_array_equal(pg.flat_start[:n], jg.flat_start[:n])
    np.testing.assert_array_equal(pg.flat_end[:n], jg.flat_end[:n])
    assert pg.max_doc_ranges == int(jg.doc_len[:N_CB].max())
    for slot, chans in ((sg.LOC_SLOT, ("hi", "lo", "max_hi", "max_lo",
                                       "fval", "fval2", "present")),
                        (sg.TS_SLOT, ("hi", "lo", "max_hi", "max_lo", "fval",
                                      "present"))):
        jc, pc = world.jseg.values[slot], c.seg.values[slot]
        assert (jc.kind, jc.max_vals) == (pc.kind, pc.max_vals)
        for ch in chans:
            np.testing.assert_array_equal(getattr(pc, ch)[:N_CB],
                                          getattr(jc, ch)[:N_CB], ch)
    h, lo = sg.ser.split_keys_np(c.ts_key)
    np.testing.assert_array_equal(h, world.jseg.values[sg.TS_SLOT].hi[:N_CB])
    np.testing.assert_array_equal(lo, world.jseg.values[sg.TS_SLOT].lo[:N_CB])

    def postings(seg, ti):
        d = seg.post_docids[ti.offset:ti.offset + ti.length]
        return d[d < N_CB].tolist()

    heads = (sg.LOC_PREFIX + "#G", sg.TS_PREFIX + "#D")
    want = {}
    for t, ti in terms_from(world.jseg.terms).items():
        if t.startswith(heads):
            d = postings(world.jseg, ti)
            if d:
                want[t] = d
    got = {t: postings(c.seg, c.seg.terms[t]) for t in c.seg.terms
           if t.startswith(heads)}
    assert got == want
    assert all(c.seg.terms[t].collfreq == 0 for t in got)
    for _f, q, p in sg.queries4(12, 6):
        assert q == to_port(world.parse(sg.query_dsl(p)))


def test_synth_geo_matches_its_oracle():
    """BatchSearcher(k=10) over config 4's generator at 2,000 docs: every
    query's count and docids equal the oracle's, and every answer keeps
    config_bench's haversine bounds."""
    c = sg.build_corpus4(N_CB, seed=7)
    qs = sg.queries4(48, 24)
    bs = BatchSearcher(SegmentSearcher(c.seg, device=CPU), k=10)
    irs = [q for _f, q, _p in qs]
    planned = bs.plan(irs)
    rmax = {cfg.geo_specs[0][2] for cfg, *_x in planned}
    assert len(rmax) == 1
    res = bs.run(irs)
    want = sg.oracle_answers(c, qs, rmax.pop(), k=10)
    for r, w in zip(res, want):
        assert r["count"] == w["count"]
        fin = r["docids"] != SENTINEL
        assert r["docids"][fin].tolist() == w["docids"]
        assert (r["scores"][fin] == 0.0).all()
        assert w["bounds_ok"]
    assert sum(w["count"] for w in want) > 0
    assert sum(w["inside"] < w["count"] for w in want) > 0
