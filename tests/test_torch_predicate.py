"""Slice 2, the predicate path of the executor, against the JAX package on
the CPU: the port's plain versions and the JAX functions on the same
inputs.

  merge_docs + K6 tree   vs lax.sort + _merge_runs + deletes + _eval_tree /
                         _upper_tree (executor 743-880)
  compact_rows (K11)     vs the compaction sorts (836-857, 893-911)
  filter_leaves (K7)     vs _gather_filter_leaves (absent slots, open
                         bounds, multi-value containment) + _eval_tree
  sort_topk (K8)         vs _rank_and_topk for every key kind, asc/desc,
                         with missing values
  execute_batch          vs jit(vmap(execute)), one case per ExecConfig
                         field the slice admits
  BatchSearcher.run      vs the JAX BatchSearcher.run (XT_HOST_PATH=0)
  _prefixify             no prefix on AND, filtered or sorted plans

The segment is a JAX ``Database`` commit (2,000 docs: body, cat, price,
a multi-value size missing on every 11th doc) with every 53rd doc then
marked deleted, carried into the port's Segment (its dataclasses are
pinned copies) and its device arrays through device_segment_from_numpy.

Tolerances: masks, counts, docids, bits and packed-row sets are equal. JAX
sums a doc's rows (lax.sort is stable: they stand in term order) in the
association order of its segmented scan and the port one after another,
so scores agree to rtol 1e-5 and relevance ranks are compared as tie
groups. Packed rows are compared as sets: the port packs rows in its own
(term-grouped) order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import xapiand_tpu.ops.executor as jex
from xapiand_tpu.database import Database
from xapiand_tpu.models.weights import BM25 as JBM25
from xapiand_tpu.query.ir import Q as JQ
from xapiand_tpu.search import BatchSearcher as JBatch
from xapiand_tpu.search import SegmentSearcher as JSearcher
from xapiand_tpu_torch.models.segment import (Segment, ValueColumn,
                                              device_segment_from_numpy,
                                              terms_from)
from xapiand_tpu_torch.models.weights import BM25
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import (SENTINEL, ExecConfig,
                                            execute_batch, upper_tree)
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import serialise as ser
from xapiand_tpu_torch.utils import synth_faceted as sf

RTOL = 1e-5
CPU = torch.device("cpu")
N_DOCS, N_WORDS, N_CATS = 2000, 200, 8
MISSING_SLOT = 77          # a slot no doc of the segment has


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_compaction_path(monkeypatch):
    # the JAX device path (not its native host executors), and its
    # compaction layout, which the port plans (the fullwidth path is K9)
    monkeypatch.setenv("XT_HOST_PATH", "0")
    monkeypatch.setenv("XT_FULLWIDTH", "0")


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _fields(obj, cls, **over):
    return cls(**{**{f.name: getattr(obj, f.name)
                     for f in dataclasses.fields(cls)}, **over})


class World:
    """The segment on both sides, the query families, the searchers."""

    def __init__(self):
        rng = np.random.Generator(np.random.PCG64(3))
        words = np.array([f"w{i}" for i in range(N_WORDS)])
        p = 1.0 / (np.arange(N_WORDS) + 1) ** 1.07
        db = Database()
        for i in range(N_DOCS):
            doc = {"body": " ".join(rng.choice(words, 12, p=p / p.sum())),
                   "cat": f"cat{int(rng.integers(0, N_CATS))}",
                   "price": round(float(rng.random() * 99 + 1), 2)}
            n = int(rng.integers(1, 4))
            if i % 11:
                sizes = [int(x) for x in
                         rng.choice(np.arange(35, 49), n, replace=False)]
                doc["size"] = sizes if n > 1 else sizes[0]
            db.index_document(doc, doc_id=str(i))
        db.commit()
        jseg = db._searchers[0].segment
        jseg.deleted[np.arange(5, N_DOCS, 53)] = True
        self.price = db.schema.get_field("price").slot
        self.size = db.schema.get_field("size").slot
        assert jseg.values[self.size].max_vals == 3
        self.jseg = jseg
        self.pseg = _fields(
            jseg, Segment,
            terms=terms_from(jseg.terms),
            values={s: _fields(c, ValueColumn)
                    for s, c in jseg.values.items()})
        self.js = JSearcher(jseg, JBM25())
        self.ps = SegmentSearcher(self.pseg, device=CPU)
        self.jarr = self.js.device_segment.arrays_pytree()
        self.parr = device_segment_from_numpy(_np_tree(self.jarr), CPU)
        self.jstats = {"N": jnp.float32(jseg.doc_count),
                       "avg_doclen": jnp.float32(jseg.avg_doclen),
                       "doclen_lower": jnp.float32(1.0)}
        self.pstats = {"N": float(jseg.doc_count),
                       "avg_doclen": float(jseg.avg_doclen)}
        self.params = BM25().kernel_spec(self.ps.segment)
        qr = np.random.Generator(np.random.PCG64(11))
        self.draws = {fam: [tuple(int(x) for x in qr.integers(0, hi))
                            for _ in range(16)]
                      for fam, hi in (("A", (N_CATS, 40)),
                                      ("B", (N_CATS, 40, 70)),
                                      ("C", (40, 13)),
                                      ("D", (40, 40, N_CATS)),
                                      ("E", (30, 60, 120)),
                                      ("F", (3, 60)))}

    def queries(self, fam, Qc):
        """The family's IRs built with the IR class of either package."""
        def rng_q(slot, lo, hi):
            return Qc.value_range(slot, ser.sortable_key_u64(float(lo)),
                                  ser.sortable_key_u64(float(hi)))

        out = []
        for d in self.draws[fam]:
            if fam in "AB":
                q = [Qc.term(f"cat{d[0]}"), Qc.term(f"w{d[1]}")]
                if fam == "B":
                    q.append(rng_q(self.price, d[2] + 1, d[2] + 31))
                out.append(Qc.and_(*q))
            elif fam == "C":
                out.append(Qc.and_(Qc.term(f"w{d[0]}"),
                                   rng_q(self.size, 35 + d[1], 36 + d[1])))
            elif fam == "D":
                out.append(Qc.and_not(
                    Qc.or_(Qc.term(f"w{d[0]}"),
                           Qc.term(f"w{(d[0] + 1 + d[1]) % 40}")),
                    Qc.term(f"cat{d[2]}")))
            else:    # E, F: relevance ORs of three terms
                out.append(Qc.or_terms([f"w{d[0]}", f"w{d[1]}",
                                        f"w{d[-1] + 100}"]))
        return out

    def sort(self, fam):
        return {"A": (("value", self.price, True),),
                "B": (("value", self.price, True),),
                "F": (("value", self.price, False),)}.get(fam)

    def jax_groups(self, fam, prefix_cap=0):
        return JBatch(self.js, k=10, sort=self.sort(fam),
                      prefix_cap=prefix_cap).plan(self.queries(fam, JQ))

    def port_batch(self, batch):
        out = {k: torch.from_numpy(np.array(batch[k]))
               for k in ("offsets", "lens", "tconst", "scoring",
                         "group_bits", "fparams") if k in batch}
        if "sort_targets" in batch:
            out["sort_targets"] = torch.from_numpy(
                np.stack([np.asarray(t) for t in batch["sort_targets"]], 1))
        return out

    def rows(self, cfg, pb):
        """score_slices (plain) of one group: ids, w, widths."""
        widths = cfg.term_classes()
        post = tuple(self.parr[k] for k in
                     ("post_docids", "post_wdf", "post_doclen"))
        ids, w, _tail = kernels.score_slices(
            post, None, pb["offsets"], pb["lens"], pb["tconst"],
            pb["scoring"], widths, (0,) * cfg.T, self.params)
        return ids, w, widths


_WORLD = []


@pytest.fixture(scope="module")
def world():
    if not _WORLD:
        _WORLD.append(World())
    return _WORLD[0]


_MERGED: dict = {}


def _jax_merge(world, fam, ids, w, widths, bits, tree):
    """JAX's docid sort + _merge_runs (sums, orbits) + first & ~deleted
    (743-828, once per family), then the tree over the bits (858-880)."""
    if fam not in _MERGED:
        rowterm = np.repeat(np.arange(len(widths)), widths)
        rbits = np.where(ids.numpy() != SENTINEL,
                         bits.numpy()[:, rowterm], 0).astype(np.int32)
        nd1 = world.jarr["doclen"].shape[0]

        def one(i, x, b):
            d, wv, bv = lax.sort((i, x, b), num_keys=1)
            sums, orbits = jex._merge_runs(d, wv, bv, len(widths))
            tail = jnp.concatenate([d[1:] != d[:-1], jnp.ones((1,), bool)])
            first = tail & (d != jex.SENTINEL)
            first &= ~world.jarr["deleted"][jnp.minimum(d, nd1 - 1)]
            return d, sums, orbits, first

        _MERGED[fam] = jax.jit(jax.vmap(one))(
            jnp.asarray(ids.numpy()), jnp.asarray(w.numpy()),
            jnp.asarray(rbits))
    d, sums, orbits, first = _MERGED[fam]
    fns = {"G": lambda g: (orbits & (1 << g)) != 0,
           "ALL": lambda: jnp.ones_like(d, dtype=bool)}
    return [np.asarray(a) for a in
            (d, sums, orbits, first & jex._eval_tree(tree, fns))]


def _masked_rows(d, s, ob, m):
    """(query, docid)-sorted (query, docid, bits) and sums of the masked
    rows of a [B, R] batch."""
    d, s, ob, m = (np.asarray(x) for x in (d, s, ob, m))
    q = np.broadcast_to(np.arange(d.shape[0])[:, None], d.shape)[m]
    order = np.lexsort((d[m], q))
    return (np.stack([q[order], d[m][order], ob[m][order]]),
            s[m][order])


def _assert_rows_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL)


TREES = [
    ("AND_NOT", ("OR", ("G", 0), ("G", 1)), ("G", 2)),
    ("XOR", ("G", 0), ("G", 2)),
    ("AND_MAYBE", ("G", 1), ("G", 0)),
    ("AND", ("OR", ("G", 0), ("G", 2)), ("G", 1)),
    ("FILTER", ("G", 0), ("AND_NOT", ("ALL",), ("G", 1))),
    ("OR", ("G", 2), ("NONE",)),
    # with F leaves: merge_docs runs their _upper_tree rewrite
    ("AND_NOT", ("G", 0), ("AND", ("G", 2), ("F", 0))),
    ("XOR", ("AND", ("G", 0), ("F", 1)), ("G", 1)),
    ("AND_MAYBE", ("OR", ("F", 0), ("G", 1)), ("F", 1)),
    ("AND_NOT", ("G", 1), ("XOR", ("G", 0), ("F", 0))),
]


@pytest.mark.parametrize("tree", TREES,
                         ids=[str(i) for i in range(len(TREES))])
def test_merge_docs_tree_vs_merge_runs_and_eval_tree(world, tree):
    """K2+K3+K6: one masked row per eligible doc, carrying the doc's OR of
    group bits and total; counts equal. Trees with F leaves run their upper
    tree, which equals JAX's _upper_tree."""
    jt = jex._upper_tree(tree)
    assert upper_tree(tree) == jt
    prog = kernels.tree_program(upper_tree(tree))
    (cfg, _fn, batch, _ch), = world.jax_groups("D")
    pb = world.port_batch(batch)
    ids, w, widths = world.rows(cfg, pb)
    sums, mask, count, orbits = kernels.merge_docs(
        ids, w, widths, pb["group_bits"], world.parr["deleted"], prog, True)
    d, jsums, jorb, jmask = _jax_merge(world, "D", ids, w, widths,
                                       pb["group_bits"], jt)
    np.testing.assert_array_equal(count.numpy(), jmask.sum(1))
    assert jmask.sum() > 0
    _assert_rows_equal(_masked_rows(ids, sums, orbits, mask),
                       _masked_rows(d, jsums, jorb, jmask))


def test_tree_program_vs_eval_tree(world):
    """The postfix program on random bits and leaf results equals
    _eval_tree, for every tree form."""
    rng = np.random.Generator(np.random.PCG64(1))
    orbits = rng.integers(0, 8, (4, 300)).astype(np.int32)
    fres = [rng.random((4, 300)) < 0.5 for _ in range(2)]
    for tree in TREES + [("ALL",), ("NONE",), ("G", 2),
                         ("AND", ("G", 0), ("G", 1), ("G", 2), ("F", 1))]:
        want = jex._eval_tree(tree, {
            "G": lambda g: (jnp.asarray(orbits) & (1 << g)) != 0,
            "F": lambda i: jnp.asarray(fres[i]),
            "ALL": lambda: jnp.ones(orbits.shape, bool)})
        got = kernels._eval_program_plain(
            kernels.tree_program(tree), torch.from_numpy(orbits),
            [torch.from_numpy(f) for f in fres], orbits.shape, CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="deeper"):
        deep = ("G", 0)
        for _ in range(40):
            deep = ("AND", ("G", 1), deep)
        kernels.tree_program(deep)


@pytest.mark.parametrize("fam", ["A", "B"])
def test_compact_rows_vs_compaction_sort(world, fam):
    """K11: the packed rows, as sets, are JAX's first cap rows of the
    (mask key, docid) sort: docid, bits and sum; the rest is padding."""
    (cfg, _fn, batch, _ch), = world.jax_groups(fam)
    pb = world.port_batch(batch)
    ids, w, widths = world.rows(cfg, pb)
    R = ids.shape[1]
    assert 0 < cfg.compact_cap < R
    tree = upper_tree(cfg.tree)
    sums, mask, count, orbits = kernels.merge_docs(
        ids, w, widths, pb["group_bits"], world.parr["deleted"],
        kernels.tree_program(tree), True)
    gd, gs, gob, n = kernels.compact_rows(mask, ids, sums, orbits,
                                          cfg.compact_cap)
    np.testing.assert_array_equal(n.numpy(), count.numpy())
    d, jsums, jorb, jmask = _jax_merge(world, fam, ids, w, widths,
                                       pb["group_bits"],
                                       jex._upper_tree(cfg.tree))

    def pack(m, dd, s, ob):
        key = jnp.where(m, 0, 1)
        k2, dd, s, ob = lax.sort((key, dd, s, ob), num_keys=2)
        c = cfg.compact_cap
        return k2[:c] == 0, dd[:c], s[:c], ob[:c]

    jm, jd, js, jo = (np.asarray(a) for a in jax.jit(jax.vmap(pack))(
        jnp.asarray(jmask), jnp.asarray(d), jnp.asarray(jsums),
        jnp.asarray(jorb)))
    real = gd.numpy() != SENTINEL
    np.testing.assert_array_equal(real.sum(1), jm.sum(1))
    np.testing.assert_array_equal(real.sum(1), n.numpy())
    assert (gs.numpy()[~real] == 0).all() and (gob.numpy()[~real] == 0).all()
    _assert_rows_equal(_masked_rows(gd, gs, gob, real),
                       _masked_rows(jd, js, jo, jm))
    with pytest.raises(AssertionError, match="exceed"):
        kernels.compact_rows(mask, ids, sums, orbits, 1)


def test_filter_leaves_vs_gather_filter_leaves(world):
    """K7: each leaf equals JAX's on random docids, including a slot the
    segment lacks, open lower and upper bounds, multi-value containment
    (size, up to 3 values a doc, absent on every 11th doc); then the full
    tree over bits and leaves."""
    rng = np.random.Generator(np.random.PCG64(4))
    slots = (world.price, world.size, world.size, MISSING_SLOT, world.price,
             world.size)
    vmax = (1, 4, 4, 1, 1, 1)      # the last: size at interval-only width
    B, C = 6, 400

    def key(x):
        return ser.split_key(ser.sortable_key_u64(float(x)))

    fp = np.zeros((B, len(slots), 4), np.int32)
    for b in range(B):
        lo = float(rng.integers(1, 60))
        s = 35 + int(rng.integers(0, 13))
        bounds = [(lo, lo + 30), (s, s + 1), (s, None), (0, 100),
                  (None, lo), (s, s + 1)]
        for i, (a, z) in enumerate(bounds):
            fp[b, i, :2] = ser.split_key(0) if a is None else key(a)
            fp[b, i, 2:] = ser.split_key((1 << 64) - 1) if z is None \
                else key(z)
    docids = rng.integers(0, N_DOCS + 1, (B, C)).astype(np.int32)
    docids[:, ::17] = SENTINEL
    orbits = rng.integers(0, 4, (B, C)).astype(np.int32)
    cfg = jex.ExecConfig(T=1, L=128, k=10, tree=("G", 0),
                         n_filters=len(slots), filter_slots=slots,
                         filter_vmax=vmax)
    jres = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda f, d: jex._gather_filter_leaves(
            world.jarr, cfg, f, jnp.minimum(d, N_DOCS))))(
        jnp.asarray(fp), jnp.asarray(docids))]
    pd, pfp = torch.from_numpy(docids), torch.from_numpy(fp)
    first = docids != SENTINEL
    for i in range(len(slots)):
        got, count = kernels.filter_leaves(
            world.parr["values"], slots, vmax, pfp, pd, None,
            torch.from_numpy(orbits), kernels.tree_program(("F", i)))
        np.testing.assert_array_equal(got.numpy(), jres[i] & first, str(i))
        np.testing.assert_array_equal(count.numpy(), got.numpy().sum(1))
    assert jres[1].any() and jres[2].any() and jres[4].any()
    assert not jres[3].any()
    # multi-value containment excludes docs whose [min, max] alone overlaps
    assert (jres[1] <= jres[5]).all() and (jres[5] & ~jres[1]).any()
    tree = ("OR", ("AND", ("G", 0), ("F", 0)), ("AND_NOT", ("F", 1),
                                               ("G", 1)))
    got, _ = kernels.filter_leaves(
        world.parr["values"], slots, vmax, pfp, pd,
        torch.from_numpy(first), torch.from_numpy(orbits),
        kernels.tree_program(tree))
    want = jex._eval_tree(tree, {
        "G": lambda g: (jnp.asarray(orbits) & (1 << g)) != 0,
        "F": lambda i: jnp.asarray(jres[i])})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want) & first)


def _sort_world(world, specs):
    """Random rows over the segment plus the synthetic sort column: docids
    unique among eligible rows, scores with ties."""
    rng = np.random.Generator(np.random.PCG64(6))
    B, C = 4, 300
    docids = np.stack([rng.permutation(N_DOCS + 1)[:C] for _ in range(B)])
    docids = docids.astype(np.int32)
    elig = rng.random((B, C)) < 0.7
    docids[:, -20:] = SENTINEL          # padding rows
    elig[:, -20:] = False
    scores = (rng.integers(0, 40, (B, C)) / 8.0).astype(np.float32)
    col, tg, tab = sf.sort_test_inputs(N_DOCS, B)
    S = len(specs)
    tg = tg[:, :S].copy()
    strtabs = {i: tab for i, s in enumerate(specs) if s[0] == "strmetric"}
    return docids, scores, elig, col, tg, strtabs


@pytest.mark.parametrize("specs", sf.SORT_TEST_SPECS,
                         ids=["-".join(f"{s[0]}{'D' if s[2] else 'A'}"
                                       for s in sp)
                              for sp in sf.SORT_TEST_SPECS])
def test_sort_topk_vs_rank_and_topk(world, specs):
    """K8: the first k rows of the multi-key order and their payloads
    equal _rank_and_topk's, for each key kind ascending and descending,
    with absent values, a slot the segment lacks, ineligible padding rows
    and score ties (docid tiebreak)."""
    docids, scores, elig, col, tg, strtabs = _sort_world(world, specs)
    jseg = dict(world.jarr)
    jseg["values"] = {**world.jarr["values"],
                      sf.SORT_TEST_SLOT: {k: jnp.asarray(v)
                                          for k, v in col.items()}}
    unweighted = specs[0][0] == "docid"
    cfg = jex.ExecConfig(T=1, L=128, k=10, tree=("G", 0),
                         sort=() if unweighted else specs,
                         unweighted=unweighted)
    plan = {"sort_targets": jnp.asarray(tg),
            "sort_strtabs": {i: jnp.asarray(t) for i, t in strtabs.items()}}
    jd, js = (np.asarray(a) for a in jax.vmap(
        lambda p, d, s, e: jex._rank_and_topk(cfg, jseg, d, s, e,
                                              plan=p)[:2])(
        plan, jnp.asarray(docids), jnp.asarray(scores), jnp.asarray(elig)))
    values = dict(world.parr["values"])
    values[sf.SORT_TEST_SLOT] = device_segment_from_numpy(col, CPU)
    gd, gs = kernels.sort_topk(
        specs, torch.from_numpy(docids), torch.from_numpy(scores),
        torch.from_numpy(elig), 10, values, torch.from_numpy(tg),
        {i: torch.from_numpy(t) for i, t in strtabs.items()})
    np.testing.assert_array_equal(gd.numpy(), jd)
    np.testing.assert_array_equal(gs.numpy(), js)
    assert (jd != SENTINEL).all()


def _assert_ranks(got, want, sorted_by_value):
    """One query's port (docids, scores) vs JAX's: finite pattern equal,
    scores within RTOL; value-sorted results equal docid for docid,
    relevance results equal as tie groups."""
    gd, gs, wd, ws = (np.asarray(x) for x in got + want)
    fin = np.isfinite(gs)
    np.testing.assert_array_equal(fin, np.isfinite(ws))
    assert (gd[~fin] == SENTINEL).all() and (wd[~fin] == SENTINEL).all()
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL)
    if sorted_by_value:
        np.testing.assert_array_equal(gd, wd)
        return
    d, s, jd = gd[fin], gs[fin], wd[fin]
    assert len(set(d.tolist())) == len(d)
    assert all(d[i] < d[i + 1] for i in range(len(d) - 1)
               if s[i] == s[i + 1])
    if len(d):   # docs above the last tie group are the same
        above = s > s[-1] * (1 + 2 * RTOL)
        assert set(d[above].tolist()) <= set(jd.tolist())
        assert set(jd[np.asarray(ws)[fin] > s[-1] * (1 + 2 * RTOL)]
                   .tolist()) <= set(d.tolist())


# each ExecConfig field the slice admits: the family whose plan sets it,
# and what else the case changes
ADMITTED = {
    "tree": ("D", {}),
    "has_deletes": ("E", {}),
    "n_filters": ("C", {}),
    "sort": ("A", {}),
    "unweighted": ("D", {"unweighted": True}),
    "compact_cap": ("B", {}),
    "count_only": ("E", {"count_only": True}),
}


@pytest.mark.parametrize("change", sorted(ADMITTED))
def test_configs_inside_the_slice_run_as_jax(world, change):
    """execute_batch vs the JAX package's jit(vmap(execute)) on the launch
    groups of a plan that sets the field (these configurations raised
    NotImplementedError before the predicate path was ported)."""
    fam, over = ADMITTED[change]
    n = 0
    for jcfg, _fn, batch, _chunk in world.jax_groups(fam):
        jcfg = dataclasses.replace(jcfg, **over)
        cfg = _fields(jcfg, ExecConfig)
        assert getattr(cfg, change) not in (0, (), False, ("G", 0)), change
        if change == "compact_cap":
            assert cfg.n_filters and cfg.compact_cap < sum(cfg.classes)
        want = world.js.batched(jcfg)(world.jarr, batch, world.jstats)
        got = execute_batch(world.parr, world.port_batch(batch), cfg,
                            world.pstats, BM25())
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["count"].numpy(),
                                      np.asarray(want["count"]))
        assert got["count"].dtype == torch.int32
        if cfg.count_only:
            continue
        assert got["docids"].dtype == torch.int32
        assert got["scores"].dtype == torch.float32
        for b in range(len(got["count"])):
            _assert_ranks((got["docids"][b], got["scores"][b]),
                          (want["docids"][b], want["scores"][b]),
                          bool(cfg.sort or cfg.unweighted))
        n += 1
    assert n or change == "count_only"


@pytest.mark.parametrize("fams", ["AB", "CDE"])
def test_batch_search_run_vs_jax(world, fams):
    """BatchSearcher.run: the port vs the JAX package, same queries, same
    sort; value-sorted results docid for docid, counts equal."""
    sort = world.sort(fams[0])
    irs = [q for f in fams for q in world.queries(f, Q)]
    jirs = [q for f in fams for q in world.queries(f, JQ)]
    got = BatchSearcher(world.ps, k=10, sort=sort, prefix_cap=256).run(irs)
    want = JBatch(world.js, k=10, sort=sort, prefix_cap=256).run(jirs)
    for g, w in zip(got, want):
        assert g["count"] == w["count"]
        _assert_ranks((g["docids"], g["scores"]), (w["docids"], w["scores"]),
                      sort is not None)
    assert sum(g["count"] for g in got) > 0


def test_prefixify_only_on_pure_relevance_ors(world):
    """An AND query and a sorted OR query whose largest term exceeds
    prefix_cap get no prefix in the port's plan, equal to the JAX plan, and
    their results equal the JAX results; the same ORs unsorted do get a
    prefix."""
    cap = 128
    for fam in ("A", "F", "E"):
        pp = BatchSearcher(world.ps, k=10, sort=world.sort(fam),
                           prefix_cap=cap).plan(world.queries(fam, Q))
        jp = world.jax_groups(fam, prefix_cap=cap)
        assert [dataclasses.asdict(c) for c, *_ in pp] == \
            [dataclasses.asdict(c) for c, *_ in jp]
        wide = any(max(c.classes) > cap for c, *_ in pp)
        assert wide, fam
        assert any(c.prefix for c, *_ in pp) == (fam == "E"), fam
        if fam == "E":
            continue
        got = BatchSearcher(world.ps, k=10, sort=world.sort(fam),
                            prefix_cap=cap).run(world.queries(fam, Q))
        want = JBatch(world.js, k=10, sort=world.sort(fam),
                      prefix_cap=cap).run(world.queries(fam, JQ))
        for g, w in zip(got, want):
            assert g["count"] == w["count"]
            _assert_ranks((g["docids"], g["scores"]),
                          (w["docids"], w["scores"]), True)
