"""The batched match executor (torch port of ``xapiand_tpu/ops/executor.py``).

``execute_batch`` runs one launch group of BatchSearcher: B queries of one
ExecConfig against one segment, through the kernels of ``kernels.py``,
step for step as the JAX ``execute`` (825-932) runs its predicate half:

  1. score_slices: each (query, term) posting span, BM25-scored, each term
     block docid-ascending (prefix blocks sorted in the kernel);
  2. merge_docs: per-doc sums and OR of group bits by binary-search join
     across the term blocks (the TPU's global docid sort + run merge is
     not needed here: gathers do not serialise on the H100), one owner
     row per doc, and the eligible mask owner & not deleted & tree;
  3. with value filters and a compaction cap below the row width: the
     mask is the upper tree (filter leaves ALL or NONE by polarity),
     compact_rows packs those rows to the cap, and filter_leaves applies
     the leaves and the full tree there; with filters and no compaction,
     filter_leaves runs over every owner row; without filters the full
     tree ran in merge_docs, and a sorted plan with a cap packs its
     eligible rows with compact_rows;
  4. order: relevance -> topk_rows, exact top-k by (score desc, docid
     asc); a sort or an unweighted plan -> sort_topk; count_only -> the
     count alone; prefix mode -> topk_rows picks the top verify_k+1 of the
     prefix rows and prefix_certify rescores them exactly and certifies.

Output keys, dtypes and conventions are the JAX package's: docids i32[B,k]
(SENTINEL when missing), scores f32[B,k] (-inf when missing), count i32[B],
and certified bool[B] in prefix mode.

Configurations outside the ported slices raise NotImplementedError naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from xapiand_tpu_torch.models.weights import BM25, CollectionStats
from xapiand_tpu_torch.ops import kernels

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
    for a plan outside the ported slices."""
    if type(scheme) is not BM25:
        raise NotImplementedError(f"not ported yet: weight scheme "
                                  f"{scheme.key()!r} (ROADMAP queue 2, K18)")
    checks = (
        (cfg.dense, "the dense match-all path (ROADMAP queue 2, K12)"),
        (cfg.join or cfg.drive >= 0 or cfg.n_chunks > 1,
         "join/semijoin/chunked execution (ROADMAP queue 2, K21)"),
        (cfg.emit_sort_keys, "sort keys for the mesh merge (ROADMAP queue "
                             "2, K19)"),
        (cfg.fullwidth or cfg.carry,
         "the fullwidth path (ROADMAP queue 2, K9)"),
        (cfg.collapse_slot is not None, "collapse (ROADMAP queue 2, K10)"),
        (cfg.syn_groups or cfg.max_specs,
         "OP_SYNONYM / OP_MAX (ROADMAP queue 2, K13)"),
        (cfg.phrases or cfg.phrase_carry, "phrases (ROADMAP queue 2, K14)"),
        (cfg.geo_specs, "geo filters (ROADMAP queue 2, K16)"),
        (cfg.with_aggs, "aggregations (ROADMAP queue 2, K17)"),
        (any(s[0] not in SORT_KINDS for s in cfg.sort),
         f"sort kinds other than {SORT_KINDS} (ROADMAP queue 2, K8)"),
        (len(cfg.sort) > kernels.MAX_SORT_KEYS,
         f"more than {kernels.MAX_SORT_KEYS} sort keys (ROADMAP queue 2, "
         "K8)"),
        ((cfg.sort or cfg.unweighted) and not cfg.count_only
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


def execute_batch(seg: dict, batch: dict, cfg: ExecConfig, stats: dict,
                  scheme) -> dict:
    """B queries of one config against one segment.

    seg: DeviceSegment.arrays_pytree() (torch tensors, + imp.* in prefix
    mode); batch: {offsets i32[B,T], lens i32[B,T], tconst f32[B,T],
    scoring f32[B,T], group_bits i32[B,T], fparams i32[B,F,4] with
    filters, sort_targets f32[B,S,2] and sort_strtabs {si: f32[B,nb]} with
    a sort} on the same device; stats: {"N", "avg_doclen", ...} numbers."""
    check_supported(cfg, scheme)
    if "sort_cat_remap" in batch:
        raise NotImplementedError("not ported yet: mesh category remaps "
                                  "(ROADMAP queue 2, K19)")
    params = scheme.kernel_params(CollectionStats(
        doc_count=float(stats["N"]), avg_doclen=float(stats["avg_doclen"])))
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
                                        scoring, widths, prefix, params)
    R = ids.shape[1]
    # the tree over group bits only matters beyond a single group leaf
    # (executor.py:661-663): ("G", 0) holds on every real row
    needs_bits = cfg.tree != ("G", 0) or cfg.n_filters
    bits = batch["group_bits"] if needs_bits else None
    deleted = seg["deleted"] if cfg.has_deletes else None
    cap = cfg.compact_cap if 0 < cfg.compact_cap < R else 0
    if cfg.n_filters:
        prog = kernels.tree_program(cfg.tree)
        slots, fparams = cfg.filter_slots, batch["fparams"]
        if cap:
            # pack the upper-tree rows, then the leaves at cap width
            # (execute 836-857)
            sums, mask, _, orbits = kernels.merge_docs(
                ids, w, widths, bits, deleted,
                kernels.tree_program(upper_tree(cfg.tree)), want_orbits=True)
            ids, sums, orbits, _ = kernels.compact_rows(mask, ids, sums,
                                                        orbits, cap)
            mask = None
        else:
            sums, mask, _, orbits = kernels.merge_docs(
                ids, w, widths, bits, deleted, None, want_orbits=True)
        eligible, count = kernels.filter_leaves(
            seg["values"], slots, cfg.filter_vmax, fparams, ids, mask,
            orbits, prog)
    else:
        prog = kernels.tree_program(cfg.tree) if needs_bits else None
        sums, eligible, count, _ = kernels.merge_docs(ids, w, widths, bits,
                                                      deleted, prog)
        if cap and cfg.sort:
            # pack the eligible rows before the sort-key gathers
            # (execute 893-911)
            ids, sums, _, _ = kernels.compact_rows(eligible, ids, sums,
                                                   None, cap)
            eligible = ids != SENTINEL
    out = {"count": count}
    if cfg.count_only:
        return out
    if cfg.verify_k and any(prefix):
        K = min(cfg.verify_k, R - 1)
        cand_d, cand_v = kernels.topk_rows(sums, ids, eligible, K + 1)
        out["docids"], out["scores"], out["certified"] = \
            kernels.prefix_certify(post, offsets, lens, tconst, scoring,
                                   classes, tail, cand_d, cand_v, cfg.k,
                                   params)
    elif cfg.sort or cfg.unweighted:
        specs = cfg.sort or (("docid", None, False),)
        out["docids"], out["scores"] = kernels.sort_topk(
            specs, ids, sums, eligible, cfg.k, seg["values"],
            batch.get("sort_targets"), batch.get("sort_strtabs"))
    else:
        out["docids"], out["scores"] = kernels.topk_rows(sums, ids, eligible,
                                                         cfg.k)
    return out
