"""The batched match executor (torch port of ``xapiand_tpu/ops/executor.py``).

``execute_batch`` runs one launch group of BatchSearcher: B queries of one
ExecConfig against one segment, through the kernels of ``kernels.py``,
step for step as the JAX ``execute`` (825-932) runs its predicate half:

  1. score_slices: each (query, term) posting span, weighed by the
     query's scheme (any of the JAX package's 16, K18), each term block
     docid-ascending (prefix blocks sorted in the kernel);
  2. merge_docs: per-doc sums and OR of group bits by binary-search join
     across the term blocks (the TPU's global docid sort + run merge is
     not needed here: gathers do not serialise on the H100), one owner
     row per doc, and the eligible mask owner & not deleted & tree;
  3. with value filters or geo leaves and a compaction cap below the row
     width (and no phrase, execute 836-837): the mask is the upper tree
     (filter and geo leaves ALL or NONE by polarity), compact_rows packs
     those rows to the cap, geo_leaves (K16) writes each packed row's geo
     verdicts and filter_leaves applies the leaves and the full tree
     there; with filters, geo leaves or phrases and no such compaction,
     phrase_leaves (K14, ops/phrase.py) and geo_leaves write each owner
     row's phrase and geo verdicts and filter_leaves runs the leaves and
     the full tree over every owner row (execute 858-876); otherwise the
     full tree ran in merge_docs; then a sorted or
     aggregating plan with a cap that did not precompact packs its
     eligible rows with compact_rows (execute 893-911) - unless the plan
     is on the fullwidth path (below);
  4. aggregations (``ops/aggs.py``: agg_metrics, agg_buckets) over the
     same rows the ordering reads (execute 915-919);
  5. order: relevance -> topk_rows, exact top-k by (score desc, docid
     asc); a sort or an unweighted plan -> sort_topk; one sort key on the
     fullwidth path -> fullwidth_topk, with a certificate; count_only ->
     the count (and aggregations) alone; prefix mode -> topk_rows picks
     the top verify_k+1 of the prefix rows and prefix_certify rescores
     them exactly and certifies.

The fullwidth path (``cfg.fullwidth``, set by BatchSearcher.plan when
query/plan.py fullwidth_ok holds) skips the compaction of step 3 and
orders a single sort key with fullwidth_topk (execute 883-892, 560-562).
The JAX package reads sort keys and agg fields there from posting-aligned
copies of the value columns (``cfg.carry``, DeviceSegment.ensure_postval);
the port gathers them by docid, which the H100 does at full speed, and
reads ``cfg.carry`` as the list of channels that must exist: the path is
taken, as in JAX, only when every (slot, channel) of it is in the
segment's value columns.

Output keys, dtypes and conventions are the JAX package's: docids i32[B,k]
(SENTINEL when missing), scores f32[B,k] (-inf when missing), count i32[B],
certified bool[B] in prefix mode and for fullwidth_topk, and aggs (the
structure of ``ops/aggs.py``) with aggregations.

Configurations outside the ported slices raise NotImplementedError naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from xapiand_tpu_torch.models.weights import CollectionStats
from xapiand_tpu_torch.ops import aggs, kernels, phrase

SENTINEL = kernels.SENTINEL


@dataclass(frozen=True)
class ExecConfig:
    """Field-for-field copy of xapiand_tpu/ops/executor.py:55-137 (the
    static plan shape; see the JAX package for each field's meaning)."""
    T: int
    L: int
    k: int
    tree: tuple
    classes: tuple = ()
    n_filters: int = 0
    filter_slots: tuple = ()
    filter_vmax: tuple = ()
    geo_specs: tuple = ()
    sort: tuple = ()
    collapse_slot: Optional[int] = None
    collapse_max: int = 1
    count_only: bool = False
    phrases: tuple = ()
    pmax: int = 128
    cand_cap: int = 4096
    with_aggs: tuple = ()
    dense: bool = False
    unweighted: bool = False
    has_deletes: bool = False
    syn_groups: tuple = ()
    max_specs: tuple = ()
    join: bool = False
    drive: int = -1
    compact_cap: int = 0
    req_groups: tuple = ()
    emit_sort_keys: bool = False
    n_chunks: int = 1
    chunk_classes: tuple = ()
    carry: tuple = ()
    phrase_carry: bool = False
    prefix: tuple = ()
    verify_k: int = 0
    fullwidth: bool = False

    def term_classes(self) -> tuple:
        return self.classes if self.classes else (self.L,) * self.T


# the plan's sort kinds (kernels' "docid" key is the unweighted order)
SORT_KINDS = tuple(k for k in kernels.SORT_KINDS if k != "docid")


def check_supported(cfg: ExecConfig, scheme):
    """Raise NotImplementedError, naming the ROADMAP item that ports it,
    for a plan outside the ported slices. Every weight scheme is ported."""
    special = bool(cfg.syn_groups or cfg.max_specs)
    # a dense plan reads neither drive nor join (execute 643-648)
    checks = (
        ((cfg.join or cfg.drive >= 0 or cfg.n_chunks > 1) and not cfg.dense,
         "join/semijoin/chunked execution (ROADMAP queue 2, K21)"),
        (cfg.emit_sort_keys, "sort keys for the mesh merge (ROADMAP queue "
                             "2, K19)"),
        (special and not cfg.dense and (
            len(cfg.syn_groups) > kernels.MAX_SPECIAL
            or len(cfg.max_specs) > kernels.MAX_SPECIAL
            or any(len(br) > kernels.MAX_SPECIAL for br in cfg.max_specs)),
         f"more than {kernels.MAX_SPECIAL} synonym groups, max specs or "
         "branches of one (ROADMAP queue 2, K13)"),
        (special and not cfg.dense and any(cfg.prefix),
         "OP_SYNONYM / OP_MAX in impact-prefix mode (ROADMAP queue 2, K13)"),
        # the prefix branch of execute_batch orders its candidates itself
        (cfg.collapse_slot is not None and not cfg.dense and any(cfg.prefix),
         "a collapse in impact-prefix mode (ROADMAP queue 2, K10)"),
        (len(cfg.geo_specs) > kernels.MAX_GEO,
         f"more than {kernels.MAX_GEO} geo leaves (ROADMAP queue 2, K16)"),
        (any(qr > kernels.MAX_GEO_QR or rm > kernels.MAX_GEO_RMAX
             for _s, qr, rm in cfg.geo_specs),
         f"geo covers beyond {kernels.MAX_GEO_QR} ranges or docs beyond "
         f"{kernels.MAX_GEO_RMAX} ranges (ROADMAP queue 2, K16)"),
        (any(s[0] not in SORT_KINDS for s in cfg.sort),
         f"sort kinds other than {SORT_KINDS} (ROADMAP queue 2, K8)"),
        (len(cfg.sort) > kernels.MAX_SORT_KEYS,
         f"more than {kernels.MAX_SORT_KEYS} sort keys (ROADMAP queue 2, "
         "K8)"),
        ((cfg.sort or cfg.unweighted or cfg.dense) and not cfg.count_only
         and cfg.k > kernels.MAX_SORT_TOPK,
         f"sorted top-k beyond k={kernels.MAX_SORT_TOPK} (ROADMAP queue 2, "
         "K8)"),
        (cfg.n_filters > kernels.MAX_FILTERS,
         f"more than {kernels.MAX_FILTERS} value filters (ROADMAP queue 2, "
         "K7)"),
    )
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"not ported yet: {what}")
    if cfg.phrases:
        phrase.check_phrases(cfg.phrases, cfg.cand_cap, cfg.pmax)
    aggs.check_aggs(cfg.with_aggs)


# channels ensure_postval can build (xapiand_tpu/models/segment.py:486-509)
CARRY_CHANNELS = ("fval", "fval2", "cats", "hi", "lo")


def fullwidth_fast(cfg: ExecConfig, values: dict, R: int) -> bool:
    """JAX's ``fast`` (execute 883-892): the plan is on the fullwidth path,
    every carried (slot, channel) exists in the segment's value columns
    (ensure_postval builds nothing for a missing slot, fval2 or cats),
    and a sorted plan's window k + 64 fits in the R rows."""
    fast = cfg.fullwidth and bool(cfg.carry) and all(
        ch in CARRY_CHANNELS and ch in values.get(slot, {})
        for slot, chs in cfg.carry for ch in chs)
    if fast and cfg.sort:
        fast = min(cfg.k + kernels.FULLWIDTH_WINDOW, R) > cfg.k
    return fast


def upper_tree(tree, positive: bool = True):
    """The tree with every F leaf replaced by ALL under positive polarity
    and NONE under a negation: a superset of the matches from group bits
    alone (xapiand_tpu/ops/executor.py _upper_tree 285-310, its rules
    copied as they are)."""
    op = tree[0]
    if op in ("F", "GEO"):
        return ("ALL",) if positive else ("NONE",)
    if op in ("G", "PH", "ALL", "NONE"):
        return tree
    if op in ("AND", "OR", "FILTER"):
        return (op,) + tuple(upper_tree(t, positive) for t in tree[1:])
    if op == "AND_NOT":
        return ("AND_NOT", upper_tree(tree[1], positive),
                upper_tree(tree[2], not positive))
    if op == "AND_MAYBE":
        # the mask is the first child alone (matcher semantics)
        return ("AND_MAYBE", upper_tree(tree[1], positive), ("NONE",))
    if op == "XOR":
        if positive:   # XOR(a,b) <= a|b
            return ("OR", upper_tree(tree[1], True),
                    upper_tree(tree[2], True))
        return ("NONE",)   # ~NONE = everything: sound upper bound
    return ("ALL",) if positive else ("NONE",)


def _rank_and_topk(cfg: ExecConfig, values: dict, batch: dict, ids, sums,
                   eligible, out: dict, fast: bool = False,
                   unweighted=None) -> None:
    """The final ordering (_rank_and_topk 462-574) into out: a collapse
    first (K10: the survivors stay in place, and a relevance top-k breaks
    ties by the collapsed position), then the fullwidth window, the
    multi-key sort, or the relevance top-k."""
    unweighted = cfg.unweighted if unweighted is None else unweighted
    if cfg.k == 0:
        # a search for the count and aggregations alone (Database.search
        # with k=0): lax.top_k of width 0, no launch
        B = ids.shape[0]
        out["docids"] = ids.new_empty((B, 0))
        out["scores"] = sums.new_empty((B, 0))
        return
    tie = None
    if cfg.collapse_slot is not None:
        eligible, tie = kernels.collapse_rows(
            ids, sums, eligible, values.get(cfg.collapse_slot),
            cfg.collapse_max)
    if fast and len(cfg.sort) == 1 and not unweighted:
        out["docids"], out["scores"], out["certified"] = \
            kernels.fullwidth_topk(cfg.sort[0], ids, sums, eligible, cfg.k,
                                   values, batch.get("sort_targets"),
                                   batch.get("sort_strtabs"))
    elif cfg.sort or unweighted:
        # the last sort key is the docid (564), so a collapse changes only
        # which rows are eligible
        specs = cfg.sort or (("docid", None, False),)
        out["docids"], out["scores"] = kernels.sort_topk(
            specs, ids, sums, eligible, cfg.k, values,
            batch.get("sort_targets"), batch.get("sort_strtabs"))
    else:
        out["docids"], out["scores"] = kernels.topk_rows(sums, ids, eligible,
                                                         cfg.k, tie)


def _execute_dense(seg: dict, batch: dict, cfg: ExecConfig, spec,
                   uniq) -> dict:
    """The dense path for match-all roots (_execute_dense 1237-1308): every
    doc is a row (dense_rows, K12), then the leaves and the tree over all
    rows, the aggregations over the matches with the scores as their sums,
    and the ordering - by docid, with the scores returned, when the plan
    has no sort. Synonym and max specs are not read here, as in JAX."""
    B = batch["offsets"].shape[0]
    values = seg["values"]
    ids, scores, orbits, live = kernels.dense_rows(
        (seg["post_docids"], seg["post_wdf"], seg["post_doclen"]),
        batch["offsets"], batch["lens"], batch["tconst"], batch["scoring"],
        batch["group_bits"], cfg.term_classes(), seg["deleted"], spec, uniq)
    geobits = None
    if cfg.geo_specs:
        geobits = kernels.geo_leaves(
            [seg["geo"][s] for s, _qr, _rm in cfg.geo_specs], cfg.geo_specs,
            batch["geo_queries"], ids, live)
    fparams = batch["fparams"] if cfg.n_filters else \
        ids.new_empty((B, 0, 4))
    match, count = kernels.filter_leaves(
        values, cfg.filter_slots, cfg.filter_vmax, fparams, ids, live,
        orbits, kernels.tree_program(cfg.tree), None, geobits)
    out = {"count": count}
    if cfg.with_aggs:
        out["aggs"] = aggs.compute_aggs(seg, cfg.with_aggs, ids, match,
                                        batch)
    if not cfg.count_only:
        _rank_and_topk(cfg, values, batch, ids, scores, match, out,
                       unweighted=cfg.unweighted or not cfg.sort)
    return out


def execute_batch(seg: dict, batch: dict, cfg: ExecConfig, stats: dict,
                  scheme) -> dict:
    """B queries of one config against one segment.

    seg: DeviceSegment.arrays_pytree() (torch tensors, + imp.* in prefix
    mode); batch: {offsets i32[B,T], lens i32[B,T], tconst f32[B,T] (or
    f32[B,T,C] for a scheme of C constants a term), scoring f32[B,T],
    group_bits i32[B,T], fparams i32[B,F,4] with filters, geo_queries
    [i32[B,QR,2] per geo leaf] with geo leaves, syn_tconst f32[B,NS(,C)]
    with synonym groups, sort_targets f32[B,S,2] and sort_strtabs {si:
    f32[B,nb]} with a sort} on the same device; stats: {"N", "avg_doclen",
    "doclen_lower", "doclen_upper", "total_len"} numbers and, from
    SegmentSearcher.execute only, "query_length" (the bound plan's qlen,
    JAX execute 636-641; the batch path stacks no qlen, so there it is 1,
    as in JAX). cfg.phrase_carry is admitted and changes nothing
    (ops/phrase.py)."""
    check_supported(cfg, scheme)
    if "sort_cat_remap" in batch:
        raise NotImplementedError("not ported yet: mesh category remaps "
                                  "(ROADMAP queue 2, K19)")
    spec = scheme.kernel_spec(CollectionStats(
        doc_count=float(stats["N"]), avg_doclen=float(stats["avg_doclen"]),
        doclen_lower=float(stats.get("doclen_lower", 1.0)),
        doclen_upper=float(stats.get("doclen_upper", 1.0)),
        total_len=float(stats.get("total_len", 0.0)),
        query_length=float(stats.get("query_length", 1.0))))
    # DiceCoeff and LM absolute discount read the doc's distinct terms
    uniq = seg["uniqterms"] if spec.needs_uniq else None
    if cfg.dense:
        return _execute_dense(seg, batch, cfg, spec, uniq)
    T = cfg.T
    classes = cfg.term_classes()
    # impact-prefix mode reads the first prefix[t] rows of the impact-
    # ordered mirror; without the mirror every term reads its full block
    # and the certificate holds trivially (no unread tail), as in JAX
    has_imp = "imp.docids" in seg
    prefix = cfg.prefix if (cfg.prefix and has_imp) else (0,) * T
    widths = tuple(p or c for p, c in zip(prefix, classes))
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    imp = (seg["imp.docids"], seg["imp.wdf"], seg["imp.doclen"]) \
        if has_imp else None
    offsets, lens = batch["offsets"], batch["lens"]
    tconst, scoring = batch["tconst"], batch["scoring"]

    ids, w, tail = kernels.score_slices(post, imp, offsets, lens, tconst,
                                        scoring, widths, prefix, spec, uniq)
    R = ids.shape[1]
    values = seg["values"]
    # the tree over group bits only matters beyond a single group leaf
    # (executor.py:661-663): ("G", 0) holds on every real row; synonym and
    # max specs read the bits too
    leaves = cfg.n_filters or cfg.phrases or cfg.geo_specs
    special = bool(cfg.syn_groups or cfg.max_specs)
    needs_bits = cfg.tree != ("G", 0) or leaves or special
    bits = batch["group_bits"] if needs_bits else None
    deleted = seg["deleted"] if cfg.has_deletes else None
    cap = cfg.compact_cap if 0 < cfg.compact_cap < R else 0

    def merged(prog, want_orbits=False):
        """merge_docs, then the OP_MAX / OP_SYNONYM sums (K13) on the same
        rows, before any compaction moves them (execute 746-812)."""
        sums, mask, count, orbits = kernels.merge_docs(
            ids, w, widths, bits, deleted, prog, want_orbits)
        if special:
            sums = kernels.merge_special(
                ids, w, widths, bits, offsets, seg["post_wdf"],
                seg["post_doclen"], cfg.max_specs, cfg.syn_groups,
                batch.get("syn_tconst"), spec, uniq)
        return sums, mask, count, orbits

    # phrase leaves read every owner row: no precompaction (execute
    # 836-837), whatever the plan's cap
    precompact = bool(cap and (cfg.n_filters or cfg.geo_specs)
                      and not cfg.phrases)
    if leaves:
        prog = kernels.tree_program(cfg.tree)
        slots = cfg.filter_slots
        fparams = batch["fparams"] if cfg.n_filters else \
            offsets.new_empty((offsets.shape[0], 0, 4))
        if precompact:
            # pack the upper-tree rows, then the leaves at cap width
            # (execute 836-857)
            sums, mask, _, orbits = merged(
                kernels.tree_program(upper_tree(cfg.tree)), True)
            ids, sums, orbits, _ = kernels.compact_rows(mask, ids, sums,
                                                        orbits, cap)
            mask = None
        else:
            sums, mask, _, orbits = merged(None, True)
        phbits = None
        if cfg.phrases:
            # the phrase step: after the merge (owner rows, deletes,
            # orbits), before the tree and the ordering (execute 869-876)
            phbits, _ = phrase.phrase_leaves(
                ids, widths, offsets, lens, orbits, mask, seg["post_posoff"],
                seg["post_poslen"], seg["positions"], cfg.phrases,
                cfg.cand_cap, cfg.pmax)
        geobits = None
        if cfg.geo_specs:
            # the HTM range tests: after the merge or the precompaction,
            # before the tree (execute 866-868)
            geobits = kernels.geo_leaves(
                [seg["geo"][s] for s, _qr, _rm in cfg.geo_specs],
                cfg.geo_specs, batch["geo_queries"], ids, mask)
        eligible, count = kernels.filter_leaves(
            values, slots, cfg.filter_vmax, fparams, ids, mask, orbits, prog,
            phbits, geobits)
    else:
        prog = kernels.tree_program(cfg.tree) \
            if cfg.tree != ("G", 0) else None
        sums, eligible, count, _ = merged(prog)
    fast = fullwidth_fast(cfg, values, ids.shape[1])
    if cap and not precompact and not fast and \
            (cfg.sort or cfg.with_aggs or cfg.collapse_slot is not None):
        # pack the eligible rows before the sort-key, agg-field and
        # collapse-key gathers (execute 893-911)
        ids, sums, _, _ = kernels.compact_rows(eligible, ids, sums, None, cap)
        eligible = ids != SENTINEL
    # the count is taken before a collapse (execute 881)
    out = {"count": count}
    if cfg.with_aggs:
        out["aggs"] = aggs.compute_aggs(seg, cfg.with_aggs, ids,
                                        eligible, batch)
    if cfg.count_only:
        return out
    if cfg.verify_k and any(prefix):
        K = min(cfg.verify_k, R - 1)
        cand_d, cand_v = kernels.topk_rows(sums, ids, eligible, K + 1)
        out["docids"], out["scores"], out["certified"] = \
            kernels.prefix_certify(post, offsets, lens, tconst, scoring,
                                   classes, tail, cand_d, cand_v, cfg.k,
                                   spec, uniq)
    else:
        _rank_and_topk(cfg, values, batch, ids, sums, eligible, out, fast)
    return out
