"""The batched match executor for relevance OR queries (torch port of
``xapiand_tpu/ops/executor.py``).

``execute_batch`` runs one launch group of BatchSearcher: B queries of one
ExecConfig against one segment, through four kernels (``kernels.py``):

  1. score_slices: each (query, term) posting span, BM25-scored, each term
     block docid-ascending (prefix blocks sorted in the kernel);
  2. merge_docs: per-doc sums by binary-search join across the term blocks
     (the TPU's global docid sort + run merge is not needed here: gathers
     do not serialise on the H100), one owner row per doc, and the count;
  3. topk_rows: exact top-k by (score desc, docid asc);
  4. prefix mode only: topk_rows picks the top verify_k+1 of the prefix
     rows and prefix_certify rescores them exactly and certifies.

Output keys, dtypes and conventions are the JAX package's: docids i32[B,k]
(SENTINEL when missing), scores f32[B,k] (-inf when missing), count i32[B],
and certified bool[B] in prefix mode.

Only the slice's configurations run: a relevance OR over one group
(tree ("G", 0)) with BM25. Every other ExecConfig raises
NotImplementedError naming the ROADMAP item that ports it.
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


def check_supported(cfg: ExecConfig, scheme):
    """Raise NotImplementedError, naming the ROADMAP item that ports it,
    for a plan outside the ported slice."""
    if type(scheme) is not BM25:
        raise NotImplementedError(f"not ported yet: weight scheme "
                                  f"{scheme.key()!r} (ROADMAP queue 2, K18)")
    checks = (
        (cfg.dense, "the dense match-all path (ROADMAP queue 2, K12)"),
        (cfg.join or cfg.drive >= 0 or cfg.n_chunks > 1,
         "join/semijoin/chunked execution (ROADMAP queue 2, K21)"),
        (cfg.tree != ("G", 0) or cfg.has_deletes,
         "boolean trees and deletes (ROADMAP queue 2, K6)"),
        (cfg.n_filters, "value filters (ROADMAP queue 2, K7)"),
        (cfg.sort or cfg.unweighted or cfg.emit_sort_keys,
         "multi-key sorts (ROADMAP queue 2, K8)"),
        (cfg.fullwidth or cfg.carry,
         "the fullwidth path (ROADMAP queue 2, K9)"),
        (cfg.collapse_slot is not None, "collapse (ROADMAP queue 2, K10)"),
        (cfg.compact_cap or cfg.count_only,
         "compaction and count-only plans (ROADMAP queue 2, K11)"),
        (cfg.syn_groups or cfg.max_specs,
         "OP_SYNONYM / OP_MAX (ROADMAP queue 2, K13)"),
        (cfg.phrases or cfg.phrase_carry, "phrases (ROADMAP queue 2, K14)"),
        (cfg.geo_specs, "geo filters (ROADMAP queue 2, K16)"),
        (cfg.with_aggs, "aggregations (ROADMAP queue 2, K17)"),
    )
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"not ported yet: {what}")


def execute_batch(seg: dict, batch: dict, cfg: ExecConfig, stats: dict,
                  scheme) -> dict:
    """B queries of one config against one segment.

    seg: DeviceSegment.arrays_pytree() (torch tensors, + imp.* in prefix
    mode); batch: {offsets i32[B,T], lens i32[B,T], tconst f32[B,T],
    scoring f32[B,T], ...} on the same device; stats: {"N",
    "avg_doclen", ...} numbers."""
    check_supported(cfg, scheme)
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
    sums, owner, count = kernels.merge_docs(ids, w, widths)
    out = {"count": count}
    if cfg.verify_k and any(cfg.prefix):
        K = min(cfg.verify_k, ids.shape[1] - 1)
        cand_d, cand_v = kernels.topk_rows(sums, ids, owner, K + 1)
        out["docids"], out["scores"], out["certified"] = \
            kernels.prefix_certify(post, offsets, lens, tconst, scoring,
                                   classes, tail, cand_d, cand_v, cfg.k,
                                   params)
    else:
        out["docids"], out["scores"] = kernels.topk_rows(sums, ids, owner,
                                                         cfg.k)
    return out
