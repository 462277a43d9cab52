"""IR -> device-plan compiler.

Lowers a logical Q tree to:
  - ExecConfig: the *static* program shape (term-count bucket, posting size
    class, boolean tree, filter/geo/phrase slots, sort/collapse/agg spec) -
    the jit cache key; queries with the same shape share one compilation
    (the reference recompiles nothing but re-walks iterators per query; XLA
    needs bucketed static shapes instead, SURVEY.md §7 "hard parts").
  - plan arrays: the *dynamic* values (posting offsets/lengths, per-term
    weight constants, filter keys, geo query ranges).

Scoring/boolean context rules mirror the Xapian operator semantics
(OP_AND/OR/AND_NOT/AND_MAYBE/FILTER/XOR; src/xapian/matcher/queryoptimiser.h).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

from xapiand_tpu_torch.models.segment import Segment, size_class
from xapiand_tpu_torch.ops.executor import ExecConfig
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.utils import serialise as ser

MAX_GROUPS = 31
T_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
QR_BUCKETS = (16, 64, 256, 1024)
DEFAULT_CAND_CAP = 4096
DEFAULT_PMAX = 128


class PlanError(ValueError):
    pass


@dataclass
class PlanTerm:
    term: str
    group: int
    scoring: bool
    wqf: int = 1
    factor: float = 1.0


@dataclass
class CompiledQuery:
    tree: tuple = ("NONE",)
    terms: list = field(default_factory=list)           # [PlanTerm]
    filters: list = field(default_factory=list)          # [(slot, lo, hi)]
    geo: list = field(default_factory=list)              # [(slot, ranges)]
    phrases: list = field(default_factory=list)  # (tidxs, gidxs, win, exact)
    n_groups: int = 0
    dense: bool = False
    synonyms: list = field(default_factory=list)  # (group, terms, wqf, factor)
    max_specs: list = field(default_factory=list)  # tuple of branch gr-masks
    _cost_fn: Optional[Callable] = None

    def _new_group(self) -> int:
        if self.n_groups >= MAX_GROUPS:
            raise PlanError("query too complex: more than 31 leaf groups")
        g = self.n_groups
        self.n_groups += 1
        return g


def _t_bucket(n: int) -> int:
    for b in T_BUCKETS:
        if n <= b:
            return b
    raise PlanError(f"too many query terms: {n}")


def _qr_bucket(n: int) -> int:
    for b in QR_BUCKETS:
        if n <= b:
            return b
    raise PlanError(f"geo query too fine: {n} ranges")


def compile_ir(ir: Q, cost_fn: Optional[Callable[[str], int]] = None
               ) -> CompiledQuery:
    """cost_fn(term) -> posting-list length estimate; used to pick the
    cheapest candidate-driving leg inside AND nodes (the reference picks
    the shortest postlist to drive and skip_to()s the rest,
    src/xapian/matcher/queryoptimiser.h). Optional: without it, AND legs
    are costed by cover-term count."""
    cq = CompiledQuery()
    cq._cost_fn = cost_fn
    cq.tree = _walk(cq, ir, scoring=True, generative=True, factor=1.0)
    if not cq.terms or _contains_generative_all(cq.tree):
        # no candidate-generating terms, or a generative match_all
        # (e.g. NOT x): evaluate over the dense doc axis
        cq.dense = True
    return cq


def _has_terms(node: Q) -> bool:
    if node.op in ("term", "or_terms", "phrase", "near"):
        return True
    if node.op in ("value_range", "geo"):
        return False
    return any(_has_terms(c) for c in node.children)


def _contains_generative_all(tree) -> bool:
    if tree[0] == "ALL":
        return True
    if tree[0] in ("G", "F", "GEO", "PH", "NONE"):
        return False
    if tree[0] in ("AND", "FILTER", "AND_NOT", "AND_MAYBE"):
        # ALL under an AND-like op never generates; only the first child of
        # AND_NOT / AND_MAYBE and any child of OR/XOR can
        if tree[0] in ("AND", "FILTER"):
            return False
        return _contains_generative_all(tree[1])
    return any(_contains_generative_all(t) for t in tree[1:])


def _walk(cq: CompiledQuery, node: Q, scoring: bool, generative: bool,
          factor: float) -> tuple:
    op = node.op
    if op in ("term", "or_terms"):
        g = cq._new_group()
        for t in node.terms:
            cq.terms.append(PlanTerm(t, g, scoring, node.wqf,
                                     factor * node.factor))
        return ("G", g)
    if op in ("phrase", "near"):
        gidxs = []
        tidxs = []
        for t in node.terms:
            g = cq._new_group()
            gidxs.append(g)
            tidxs.append(len(cq.terms))
            cq.terms.append(PlanTerm(t, g, scoring, node.wqf,
                                     factor * node.factor))
        pidx = len(cq.phrases)
        cq.phrases.append((tuple(tidxs), tuple(gidxs), int(node.window),
                           op == "phrase"))
        return ("PH", pidx)
    if op == "value_range":
        fidx = len(cq.filters)
        cq.filters.append((node.slot, node.lo_key, node.hi_key))
        if generative:
            if not node.cover_terms:
                # only legal if the whole query ends up dense
                return ("F", fidx)
            g = cq._new_group()
            for t in node.cover_terms:
                cq.terms.append(PlanTerm(t, g, False))
            return ("AND", ("G", g), ("F", fidx))
        return ("F", fidx)
    if op == "geo":
        gidx = len(cq.geo)
        cq.geo.append((node.slot, node.geo_ranges))
        if generative:
            if not node.cover_terms:
                return ("GEO", gidx)
            g = cq._new_group()
            for t in node.cover_terms:
                cq.terms.append(PlanTerm(t, g, False))
            return ("AND", ("G", g), ("GEO", gidx))
        return ("GEO", gidx)
    if op == "match_all":
        return ("ALL",)
    if op == "match_none":
        return ("NONE",)
    if op == "scale":
        return _walk(cq, node.children[0], scoring, generative,
                     factor * node.factor)
    if op == "synonym":
        # one group, terms non-scoring; the executor sums wdf per doc and
        # weights the merged pseudo-term once (synonympostlist.h semantics)
        g = cq._new_group()
        for t in node.terms:
            cq.terms.append(PlanTerm(t, g, False, node.wqf,
                                     factor * node.factor))
        if scoring:
            cq.synonyms.append((g, tuple(node.terms), node.wqf,
                                factor * node.factor))
        return ("G", g)
    if op == "max":
        subs, masks = [], []
        for k in node.children:
            g0 = cq.n_groups
            subs.append(_walk(cq, k, scoring, generative, factor))
            g1 = cq.n_groups
            mask = 0
            for g in range(g0, g1):
                mask |= 1 << g
            masks.append(mask)
        if scoring:
            cq.max_specs.append(tuple(masks))
        return ("OR",) + tuple(subs)
    if op == "elite_set":
        # unresolved elite set degrades to OR (exact when n >= children;
        # resolve_special() prunes against stats before compile otherwise)
        return ("OR",) + tuple(
            _walk(cq, k, scoring, generative, factor) for k in node.children)
    if op in ("and", "filter"):
        kids = node.children
        term_kids = [k for k in kids if _has_terms(k)]
        # without term children, coverable range/geo legs could all drive
        # candidates, but ONE suffices: every other AND leg is an exact
        # per-candidate predicate (value compare / HTM range test). Keep
        # only the cheapest cover generative - e.g. "circle AND 3-month
        # range" drives off the geo trixel cover instead of also pulling
        # ~100 day-accuracy posting classes into the sort
        drive = None
        if generative and not term_kids:
            coverable = [i for i, k in enumerate(kids)
                         if k.op in ("value_range", "geo") and k.cover_terms]
            if len(coverable) > 1:
                cost_fn = cq._cost_fn

                def leg_cost(i):
                    cov = kids[i].cover_terms
                    if cost_fn is None:
                        return len(cov)
                    return sum(cost_fn(t) for t in cov)

                drive = min(coverable, key=leg_cost)
        subs = []
        for i, k in enumerate(kids):
            child_scoring = scoring and not (op == "filter" and i > 0)
            # range/geo/all children of an AND act as pure filters when some
            # sibling generates candidates
            child_gen = generative and not (term_kids and not _has_terms(k))
            if drive is not None and i != drive \
                    and kids[i].op in ("value_range", "geo"):
                child_gen = False
            subs.append(_walk(cq, k, child_scoring, child_gen, factor))
        return ("AND",) + tuple(subs)
    if op == "or":
        return ("OR",) + tuple(
            _walk(cq, k, scoring, generative, factor) for k in node.children)
    if op == "and_not":
        a = _walk(cq, node.children[0], scoring, generative, factor)
        b = _walk(cq, node.children[1], False, generative, factor)
        return ("AND_NOT", a, b)
    if op == "and_maybe":
        a = _walk(cq, node.children[0], scoring, generative, factor)
        b = _walk(cq, node.children[1], scoring, generative, factor)
        return ("AND_MAYBE", a, b)
    if op == "xor":
        a = _walk(cq, node.children[0], scoring, generative, factor)
        b = _walk(cq, node.children[1], scoring, generative, factor)
        return ("XOR", a, b)
    raise PlanError(f"unknown IR op {op!r}")


# ---------------------------------------------------------------------------
# binding to a concrete segment
# ---------------------------------------------------------------------------

@dataclass
class BoundPlan:
    cfg: ExecConfig
    arrays: dict       # jit-traced plan arrays (numpy; converted by jax)


# Semijoin auto-selection is DISABLED (None): measured on v5e, the
# binary-search probes (serialized gathers, ~30 cycles/element through
# this memory path) lose to the streaming sort in every tested regime -
# 44 vs 193 qps at Σ/min ratio 9 (1M docs), 15 vs 596 at ratio 5 (400k).
# The path stays correct + force-selectable (tests set a numeric ratio);
# the production answer to the faceted-AND problem is compact_cap below.
SEMIJOIN_RATIO = None   # numeric: enable when Σclasses >= ratio * class


def _pick_drive(cq: CompiledQuery, classes) -> int:
    """Asymmetric-AND semijoin selection (executor._execute_semijoin):
    when the root is an AND/FILTER with a required single-term group whose
    posting class is far smaller than the total, that term's postings
    drive and every other term is probed by binary search — the
    reference's shortest-postlist-drives + skip_to
    (src/xapian/matcher/queryoptimiser.h). Returns the driving term
    position, or -1 to keep the sort pipeline."""
    if SEMIJOIN_RATIO is None:
        return -1
    tree = cq.tree
    if tree[0] not in ("AND", "FILTER") or cq.dense:
        return -1
    if cq.phrases or cq.synonyms or cq.max_specs or len(cq.terms) < 2:
        return -1
    group_positions: dict = {}
    for i, pt in enumerate(cq.terms):
        group_positions.setdefault(pt.group, []).append(i)
    cands = []
    for sub in tree[1:]:
        if sub[0] == "G" and len(group_positions.get(sub[1], ())) == 1:
            cands.append(group_positions[sub[1]][0])
    if not cands:
        return -1
    pos = min(cands, key=lambda i: classes[i])
    if sum(classes) < SEMIJOIN_RATIO * classes[pos]:
        return -1
    return pos


def _required_groups(cq: CompiledQuery) -> tuple:
    """Term positions of each required direct-G conjunct of an AND/FILTER
    root (structural - identical for every query of a plan signature).
    Every match must carry each of these groups, so the smallest one's
    posting classes statically bound the eligible-row count."""
    tree = cq.tree
    if tree[0] not in ("AND", "FILTER", "AND_NOT", "AND_MAYBE") \
            or cq.dense or cq.phrases:
        return ()
    group_positions: dict = {}
    for i, pt in enumerate(cq.terms):
        group_positions.setdefault(pt.group, []).append(i)
    out = []

    def walk(node):
        # conjunct descent: every G reached only through AND/FILTER
        # edges (incl. the required first child of AND_NOT/AND_MAYBE)
        # is required at the root
        if node[0] == "G" and node[1] in group_positions:
            out.append(tuple(group_positions[node[1]]))
        elif node[0] in ("AND", "FILTER"):
            for c in node[1:]:
                walk(c)
        elif node[0] in ("AND_NOT", "AND_MAYBE"):
            walk(node[1])

    walk(tree)
    return tuple(out)


def compact_cap_for(classes, req_groups) -> int:
    """Compaction width from the CURRENT classes (per-query at bind time,
    merged maxima after unify_cfgs): min over required conjuncts of its
    summed class, if that actually shrinks the row width."""
    if not req_groups:
        return 0
    best = min(sum(classes[i] for i in g if i < len(classes))
               for g in req_groups)
    return best if 2 * best <= sum(classes) else 0


def group_compact_cap(cfgs, classes) -> int:
    """Group-sound compaction cap: req_groups POSITIONS differ per query
    (or_terms conjuncts vary in size within one signature bucket), so the
    group bound is the max over members of each member's own conjunct
    bound evaluated on the MERGED classes. Any member without a bound
    disables compaction for the whole group."""
    best = 0
    for c in cfgs:
        if not c.req_groups:
            return 0
        b = min(sum(classes[i] for i in g if i < len(classes))
                for g in c.req_groups)
        best = max(best, b)
    return best if best and 2 * best <= sum(classes) else 0


FULLWIDTH_AGGS = frozenset(("count", "sum", "avg", "min", "max", "variance",
                            "std_deviation", "stats", "extended_stats"))
FULLWIDTH_TERMS_MAX_CATS = 256   # [rows, ncats] one-hot reduce at full width


def fullwidth_ok(cfg) -> bool:
    """Sort-free faceted eligibility (ExecConfig.fullwidth): every sort/agg
    consumer must read a CARRIED channel row-aligned with kernels that are
    streaming/one-hot reductions at full row width - then skipping
    compaction removes one full-width lax.sort and the windowed top_k
    removes the other (chip A/B facts this encodes: count-only runs 262.8
    qps where compaction+gathers run 88.2; carry-into-compaction LOST,
    72.9). Gated CLOSED: any spec outside the proven set keeps the
    compaction path. Set by BatchSearcher.plan only - the exactness
    certificate consumer (uncertified re-run) lives in BatchSearcher.run.
    XT_FULLWIDTH=0 restores the compaction+gather path for A/B."""
    import os

    if os.environ.get("XT_FULLWIDTH", "1") == "0":
        return False
    if not cfg.carry or cfg.collapse_slot is not None or cfg.count_only:
        return False
    if cfg.phrases or cfg.n_filters or cfg.geo_specs or cfg.dense:
        return False
    if cfg.unweighted or cfg.emit_sort_keys or cfg.join or cfg.n_chunks > 1:
        return False
    if cfg.drive >= 0:           # semijoin path has its own row layout
        return False
    if cfg.verify_k or any(cfg.prefix):
        return False
    if not cfg.sort and not cfg.with_aggs:
        return False
    if cfg.sort and (len(cfg.sort) != 1 or cfg.sort[0][0] not in
                     ("value", "dist", "geodist", "strmetric")):
        return False
    for spec in cfg.with_aggs:
        kind = spec[0] if spec else None
        if kind in FULLWIDTH_AGGS:
            continue
        if kind == "terms" and (len(spec) < 4 or not spec[3]) \
                and spec[2] <= FULLWIDTH_TERMS_MAX_CATS:
            continue     # no sub-aggs, bounded category table
        return False
    return True


def _carry_enabled() -> bool:
    """Posting-aligned value channels (ExecConfig.carry): value sort keys
    and agg fields ride the docid sort instead of being gathered per
    candidate (~30 serialized cycles/element on TPU). Default ON; set
    XT_CARRY=0 to A/B the gather path."""
    import os

    return os.environ.get("XT_CARRY", "1") != "0"


def carry_channels(sort_static, aggs, collapse_slot) -> tuple:
    """Which pv channels each sort/agg consumer can read row-aligned.
    Only kinds whose executor/agg reads understand carried channels are
    listed - everything else keeps the clamped-gather path. Collapse
    keys carry too (the collapse sort permutes every carried channel
    along with the rows)."""
    need: dict = {}

    def add(slot, *chs):
        if slot is None or slot < 0:
            return
        need.setdefault(int(slot), set()).update(chs)

    add(collapse_slot, "hi", "lo", "fval")
    for spec in sort_static or ():
        kind, slot = spec[0], spec[1]
        if kind == "value":
            add(slot, "hi", "lo", "fval")   # fval: NaN codes absence
        elif kind == "dist":
            add(slot, "fval")
        elif kind == "geodist":
            add(slot, "fval", "fval2")
        elif kind == "strmetric":
            add(slot, "cats")
    for spec in aggs or ():
        kind = spec[0] if spec else None
        if kind in ("sum", "avg", "min", "max", "variance",
                    "std_deviation", "stats", "extended_stats",
                    "median", "mode", "histogram"):
            add(spec[1], "fval")
        elif kind == "terms":
            add(spec[1], "cats")
    return tuple(sorted((slot, tuple(sorted(chs)))
                        for slot, chs in need.items()))


def bind(cq: CompiledQuery, seg: Segment, scheme, stats,
         global_tf: Optional[Callable[[str], int]] = None,
         k: int = 10, sort: tuple = (), collapse_slot: Optional[int] = None,
         aggs: tuple = (), agg_arrays: Optional[dict] = None,
         count_only: bool = False,
         global_cf: Optional[Callable[[str], int]] = None,
         collapse_max: int = 1,
         sort_strtabs_override: Optional[dict] = None,
         keep_carry: bool = False) -> BoundPlan:
    """Bind a compiled query to one segment, producing cfg + plan arrays.

    global_tf/global_cf supply cross-shard/segment termfreqs and collection
    freqs for idf (the two-phase global-stats merge of the reference,
    handler.cc:1532-1538); they default to this segment's own stats."""
    if global_tf is None:
        global_tf = lambda t: (ti.length if (ti := seg.get_term(t)) else 0)

    if global_cf is None:
        global_cf = lambda t: (ti.collfreq if (ti := seg.get_term(t)) else 0)

    T = _t_bucket(max(len(cq.terms), 1))
    C = getattr(scheme, "n_constants", 1)
    offsets = np.zeros(T, dtype=np.int32)
    lens = np.zeros(T, dtype=np.int32)
    tconst = np.zeros(T if C == 1 else (T, C), dtype=np.float32)
    scoring = np.zeros(T, dtype=np.float32)
    group_bits = np.zeros(T, dtype=np.int32)
    classes = [128] * T   # per-term posting-gather size class
    max_poslens = [0] * T
    qlen = 0
    for i, pt in enumerate(cq.terms):
        ti = seg.get_term(pt.term)
        if ti is not None:
            offsets[i] = ti.offset
            lens[i] = ti.length
            classes[i] = size_class(max(ti.length, 1))
            max_poslens[i] = getattr(ti, "max_poslen", 0)
        tf = global_tf(pt.term)
        if pt.scoring:
            qlen += pt.wqf
        if tf > 0 and pt.scoring:
            tconst[i] = scheme.term_constant(stats, tf, pt.wqf, pt.factor,
                                             collfreq=global_cf(pt.term))
        scoring[i] = 1.0 if pt.scoring else 0.0
        group_bits[i] = 1 << pt.group

    L = max(classes)
    nd1 = seg.num_docs + 1

    # data-driven positional shapes: phrase candidates cannot exceed the
    # rarest phrase term's df, and positions per (term, doc) cannot exceed
    # the term's longest position list - sizing to the data instead of the
    # static worst case cut measured phrase-batch time ~100x
    pmax_c, cand_c = DEFAULT_PMAX, DEFAULT_CAND_CAP
    if cq.phrases:
        pmax_c, cand_c = 4, 64
        for term_idxs, _g, _w, _isp in cq.phrases:
            mindf = min((int(lens[t]) for t in term_idxs), default=1)
            cand_c = max(cand_c, size_class(max(mindf, 1)))
            for t in term_idxs:
                mp = max_poslens[t]
                if mp <= 0:
                    pmax_c = DEFAULT_PMAX   # unknown: old static cap
                else:
                    pc = 4
                    while pc < mp:
                        pc *= 2
                    pmax_c = max(pmax_c, pc)
        pmax_c = min(pmax_c, DEFAULT_PMAX)
        cand_c = min(cand_c, DEFAULT_CAND_CAP)

    arrays = {
        "offsets": offsets, "lens": lens, "tconst": tconst,
        "scoring": scoring, "group_bits": group_bits,
        "qlen": np.float32(max(qlen, 1)),
    }

    filter_vmax = []
    if cq.filters:
        fp = np.zeros((len(cq.filters), 4), dtype=np.int32)
        for i, (slot, lo, hi) in enumerate(cq.filters):
            lo = 0 if lo is None else lo
            hi = (1 << 64) - 1 if hi is None else hi
            fp[i, 0], fp[i, 1] = ser.split_key(lo)
            fp[i, 2], fp[i, 3] = ser.split_key(hi)
            # static per-value gather width (pow2) for exact multi-value
            # containment; 1 = single-value column, interval test exact
            col = seg.values.get(slot)
            mv = int(getattr(col, "max_vals", 1)) if col is not None else 1
            filter_vmax.append(1 if mv <= 1
                               else 1 << (mv - 1).bit_length())
        arrays["fparams"] = fp

    geo_specs = []
    if cq.geo:
        gq = []
        for slot, ranges in cq.geo:
            QR = _qr_bucket(max(len(ranges), 1))
            # pad = INT32_MAX so the sorted-search overlap test (executor
            # _gather_geo_leaves lower_bound) never matches padding
            q = np.full((QR, 2), 2**31 - 1, dtype=np.int32)
            for j, (s, e) in enumerate(ranges):
                q[j, 0], q[j, 1] = s, e
            gq.append(q)
            gcol = seg.geo.get(slot)
            rmax = 16
            if gcol is not None and gcol.max_doc_ranges > 0:
                # exact data-driven width, NO floor: a point-only column
                # (max_doc_ranges == 1, the geo+time workload) shrinks the
                # per-candidate overlap sort-join 16x vs the old floor-16
                rmax = int(min(
                    1 << max((gcol.max_doc_ranges - 1).bit_length(), 0),
                    256))
            geo_specs.append((slot, QR, rmax))
        arrays["geo_queries"] = gq

    if cq.synonyms:
        # one pseudo-term constant per synonym group: termfreq estimated as
        # min(sum of child tfs, N) (xapian OP_SYNONYM freq estimation)
        syn_tconst = np.zeros(
            len(cq.synonyms) if C == 1 else (len(cq.synonyms), C),
            dtype=np.float32)
        for i, (g, syn_terms, wqf, fac) in enumerate(cq.synonyms):
            tf = min(sum(global_tf(t) for t in syn_terms),
                     max(int(stats.doc_count), 1))
            cf = sum(global_cf(t) for t in syn_terms)
            if tf > 0:
                syn_tconst[i] = scheme.term_constant(stats, tf, wqf, fac,
                                                     collfreq=cf)
        arrays["syn_tconst"] = syn_tconst

    # sort specs: static (kind, slot, desc[, tab-size]) for the jit key;
    # distance targets / string-metric tables are dynamic plan arrays
    # (≙ keymaker.h distance keys - same compiled program serves any
    # target value)
    sort_static = []
    if sort:
        sort_targets = np.zeros((len(sort), 2), np.float32)
        strtabs = {}
        for si, spec in enumerate(sort):
            kind, slot_s, desc = spec[0], spec[1], spec[2]
            if kind == "dist":
                sort_targets[si, 0] = spec[3]
                sort_static.append((kind, slot_s, desc))
            elif kind == "geodist":
                sort_targets[si, 0], sort_targets[si, 1] = spec[3]
                sort_static.append((kind, slot_s, desc))
            elif kind == "strmetric":
                override = (sort_strtabs_override or {}).get(si)
                if override is not None:
                    # mesh path: one GLOBAL category metric table shared by
                    # every shard (local codes remap on device)
                    tab = np.asarray(override, np.float32)
                    nb = tab.shape[0]
                else:
                    from xapiand_tpu_torch.utils import strmetrics

                    metric, target = spec[3]
                    col = seg.values.get(slot_s)
                    names = (col.cat_names or []) if col is not None else []
                    nb = 16
                    while nb < len(names):
                        nb *= 2
                    tab = np.full(nb, np.inf, np.float32)
                    for code, nm in enumerate(names):
                        tab[code] = 1.0 - strmetrics.similarity(
                            str(nm), target, metric)
                strtabs[si] = tab
                sort_static.append((kind, slot_s, desc, nb))
            else:
                sort_static.append((kind, slot_s, desc))
        arrays["sort_targets"] = sort_targets
        if strtabs:
            arrays["sort_strtabs"] = strtabs

    # key_range/geo_ip agg buckets share the range-filter per-value
    # containment semantics; stamp the static multi-value gather width
    # (trailing spec element) so ops/aggs.py can be exact on multi slots
    if aggs:
        patched = []
        for spec in aggs:
            if spec and spec[0] in ("key_range", "geo_ip"):
                col_a = seg.values.get(spec[1])
                mv = int(getattr(col_a, "max_vals", 1)) \
                    if col_a is not None else 1
                vmax_a = 1 if mv <= 1 else 1 << (mv - 1).bit_length()
                spec = tuple(spec) + (vmax_a,)
            patched.append(spec)
        aggs = tuple(patched)

    rows = nd1 if cq.dense else sum(classes)
    unweighted = (getattr(scheme, "name", "") == "bool"
                  or not (any(pt.scoring for pt in cq.terms)
                          or cq.synonyms))
    # carry only pays on the fullwidth (sort-free) path: chip A/B
    # measured carry-into-compaction 17% SLOWER (72.9 vs 88.2 qps, 1M
    # faceted). Only BatchSearcher (the sole fullwidth driver) asks for
    # carry; every other caller - single-query search, the mesh bind, the
    # uncertified exact re-run - gets the unwidened compaction layout.
    carry = carry_channels(sort_static, aggs, collapse_slot) \
        if (keep_carry and _carry_enabled()) else ()
    cfg = ExecConfig(
        T=T, L=L, k=min(k, rows),
        tree=cq.tree,
        classes=tuple(classes),
        n_filters=len(cq.filters),
        filter_slots=tuple(slot for slot, _, _ in cq.filters),
        filter_vmax=tuple(filter_vmax),
        geo_specs=tuple(geo_specs),
        sort=tuple(sort_static),
        collapse_slot=collapse_slot,
        collapse_max=collapse_max,
        count_only=count_only,
        phrases=tuple(cq.phrases),
        pmax=pmax_c,
        cand_cap=cand_c,
        with_aggs=tuple(aggs),
        dense=cq.dense,
        unweighted=unweighted,
        has_deletes=bool(seg.deleted.any()),
        syn_groups=tuple(1 << g for g, _, _, _ in cq.synonyms),
        max_specs=tuple(cq.max_specs),
        # join (searchsorted, sort-free) measured 8.5x SLOWER than the
        # sort+scan path on TPU v5e: binary-search rounds are serialized
        # gathers, while lax.sort streams on the VPU. Kept selectable for
        # CPU experiments; never auto-chosen.
        join=False,
        drive=_pick_drive(cq, classes),
        req_groups=_required_groups(cq),
        compact_cap=compact_cap_for(classes, _required_groups(cq)),
        carry=carry,
    )
    if agg_arrays:
        arrays.update(agg_arrays)
    return BoundPlan(cfg=cfg, arrays=arrays)


def resolve_special(ir: Q, scheme, stats, global_tf, global_cf=None) -> Q:
    """IR -> IR transform run against collection stats before compile:
    prunes _elite_set nodes to their n highest-impact subqueries
    (OP_ELITE_SET picks by estimated max term weights; we estimate each
    child by the max term_constant over its terms)."""
    if global_cf is None:
        global_cf = lambda t: 0

    def child_estimate(node: Q) -> float:
        if node.op in ("term", "or_terms", "synonym", "phrase", "near"):
            best = 0.0
            for t in node.terms:
                tf = global_tf(t)
                if tf > 0:
                    try:
                        tc = scheme.term_constant(
                            stats, tf, node.wqf, node.factor,
                            collfreq=global_cf(t))
                    except Exception:
                        tc = 0.0
                    t0 = tc[0] if isinstance(tc, tuple) else tc
                    best = max(best, abs(float(t0)))
            return best
        return max((child_estimate(c) for c in node.children), default=0.0)

    def walk(node: Q) -> Q:
        kids = tuple(walk(c) for c in node.children)
        if node.op == "elite_set":
            n = max(int(node.window), 1)
            if len(kids) > n:
                ranked = sorted(kids, key=child_estimate, reverse=True)
                kids = tuple(ranked[:n])
            return Q("or", children=kids) if len(kids) > 1 else \
                (kids[0] if kids else Q.match_none())
        if kids != node.children:
            return Q(node.op, children=kids, terms=node.terms, wqf=node.wqf,
                     factor=node.factor, window=node.window, slot=node.slot,
                     lo_key=node.lo_key, hi_key=node.hi_key,
                     cover_terms=node.cover_terms,
                     geo_ranges=node.geo_ranges)
        return node

    return walk(ir)


def unify_cfgs(cfgs: list[ExecConfig], k: Optional[int] = None) -> ExecConfig:
    """Merge same-structure configs (across a query batch and/or shards)
    into one shared compilation shape: element-wise max size classes."""
    T = max(c.T for c in cfgs)
    classes = [128] * T
    for c in cfgs:
        for i, cl in enumerate(c.term_classes()):
            classes[i] = max(classes[i], cl)
    base = cfgs[0]
    geo_specs = base.geo_specs
    if geo_specs:
        # element-wise max QR bucket so every query's ranges fit the
        # shared shape (plan arrays pad to this; search.py batch stacking)
        geo_specs = tuple(
            (base.geo_specs[gi][0],
             max(c.geo_specs[gi][1] for c in cfgs),
             max(c.geo_specs[gi][2] for c in cfgs))
            for gi in range(len(base.geo_specs)))
    return ExecConfig(**{
        **base.__dict__,
        "T": T, "classes": tuple(classes), "L": max(classes),
        "k": k if k is not None else base.k,
        "has_deletes": any(c.has_deletes for c in cfgs),
        "pmax": max(c.pmax for c in cfgs),
        "cand_cap": max(c.cand_cap for c in cfgs),
        "geo_specs": geo_specs,
        "filter_vmax": tuple(
            max(c.filter_vmax[fi] if fi < len(c.filter_vmax) else 1
                for c in cfgs)
            for fi in range(len(base.filter_slots))),
        # key_range/geo_ip specs carry a trailing static mv gather width -
        # take the shard-wise max so one compiled shape fits every shard
        "with_aggs": tuple(
            (spec[:-1] + (max(c.with_aggs[si][-1] for c in cfgs),))
            if spec and spec[0] in ("key_range", "geo_ip") else spec
            for si, spec in enumerate(base.with_aggs)),
        # re-derive from the MERGED classes, member-wise: each query's
        # conjunct POSITIONS differ (variable-size or_terms groups), so
        # the sound group cap is the max of per-member bounds
        "compact_cap": group_compact_cap(cfgs, classes),
    })
