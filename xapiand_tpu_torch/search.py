"""SegmentSearcher and BatchSearcher on torch tensors (counterpart of
``xapiand_tpu/search.py:23-641``).

PyTorch runs eagerly, so there is no compilation cache: ``batched(cfg)``
returns a plain callable over a batch whose leading axis is the query
axis (the JAX package's ``jit(vmap(execute))``).
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from xapiand_tpu_torch.models.segment import (DeviceSegment, Segment,
                                              size_class)
from xapiand_tpu_torch.models.weights import (CollectionStats, WeightScheme,
                                              get_scheme)
from xapiand_tpu_torch.ops.executor import (ExecConfig, check_supported,
                                            execute_batch)
from xapiand_tpu_torch.ops.kernels import MAX_PREFIX_ROWS

_BATCH_KEYS = ("offsets", "lens", "tconst", "scoring", "group_bits",
               "fparams")


class SegmentSearcher:
    def __init__(self, seg: Segment, scheme: Optional[WeightScheme] = None,
                 *, device: torch.device):
        self.segment = seg
        self.device = torch.device(device)
        self.scheme = scheme or get_scheme("bm25")
        self._device_segment: Optional[DeviceSegment] = None
        self._lock = threading.Lock()

    @property
    def device_segment(self) -> DeviceSegment:
        """Device mirror, uploaded once, on the first device-routed query
        (under a lock: concurrent first queries share one upload)."""
        ds = self._device_segment
        if ds is None:
            with self._lock:
                ds = self._device_segment
                if ds is None:
                    ds = self._device_segment = DeviceSegment(
                        self.segment, self.device)
        return ds

    def batched(self, cfg: ExecConfig, scheme: Optional[WeightScheme] = None):
        """fn(seg_arrays, batch, stats) over a leading query axis; raises
        NotImplementedError at once for a config outside the port."""
        scheme = scheme or self.scheme
        check_supported(cfg, scheme)

        def run(seg_arrays, batch, stats):
            return execute_batch(seg_arrays, batch, cfg, stats, scheme)

        return run


class BatchSearcher:
    """Shape-bucketed batch execution over one segment (see the JAX
    package's BatchSearcher for the bucketing rationale): plan signature,
    size-class terciles, equal-work batch widths, wraparound padding,
    impact-prefix pruning with an exact re-run of uncertified queries,
    and ``sort=`` bound into every query (value-sorted faceted serving).

    Every query goes to the device: the native host scorers the JAX
    package routes small batches to are not ported yet (ROADMAP queue 1).
    The host path is exact too, so results are the same either way.
    Not ported: docid-range chunking (``chunk_rows`` must be 0, K21),
    aggregations (``aggs``, K17) and the fullwidth path (K9): plans keep
    the compaction layout, as the JAX package's ``XT_FULLWIDTH=0`` does,
    which returns the same answers.
    """

    def __init__(self, searcher: SegmentSearcher, k: int = 10,
                 max_batch: int = 256, min_batch: int = 64,
                 class_groups: int = 3, work_ratio: float = 2.0,
                 scheme: Optional[WeightScheme] = None,
                 sort=None, aggs=None, chunk_rows: int = 0,
                 prefix_cap: int = 0, global_tf=None, global_cf=None):
        if aggs:
            raise NotImplementedError(
                "not ported yet: batch aggregations (ROADMAP queue 2, K17)")
        if chunk_rows != 0:
            raise NotImplementedError(
                "not ported yet: docid-range chunking (ROADMAP queue 2, K21)")
        if prefix_cap > MAX_PREFIX_ROWS:
            raise ValueError(f"prefix_cap {prefix_cap} exceeds "
                             f"{MAX_PREFIX_ROWS} rows (score_slices sorts a "
                             "prefix block in one block's shared memory)")
        self.searcher = searcher
        self.k = k
        self.sort = sort
        self.global_tf = global_tf
        self.global_cf = global_cf
        self.prefix_cap = prefix_cap
        self.max_batch = max_batch
        self.min_batch = min_batch
        self.class_groups = class_groups
        self.work_ratio = work_ratio
        self.scheme = scheme or searcher.scheme

    def plan(self, irs: list, stats=None) -> list:
        """Bind + bucket + pad a mixed list of Q IRs.

        -> list of (cfg, fn, batch_tensors, chunk_query_idxs); feed each to
        fn(seg_arrays, batch, stats_d) in order."""
        from xapiand_tpu_torch.query.plan import (bind, compile_ir,
                                                  resolve_special, unify_cfgs)

        seg = self.searcher.segment
        if stats is None:
            stats = CollectionStats(
                doc_count=seg.doc_count, avg_doclen=seg.avg_doclen,
                doclen_lower=1.0)

        def gtf(t):
            ti = seg.get_term(t)
            return ti.length if ti else 0

        def gcf(t):
            ti = seg.get_term(t)
            return ti.collfreq if ti else 0

        gtf, gcf = self.global_tf or gtf, self.global_cf or gcf
        irs = [resolve_special(ir, self.scheme, stats, gtf, gcf)
               for ir in irs]
        bounds = [bind(compile_ir(ir, cost_fn=gtf), seg, self.scheme, stats,
                       k=self.k, global_tf=gtf, global_cf=gcf,
                       sort=self.sort, keep_carry=False)
                  for ir in irs]

        # signature buckets, then size-class tercile sub-groups
        sig_buckets: dict = {}
        for qi, ir in enumerate(irs):
            sig_buckets.setdefault(ir.signature(), []).append(qi)
        groups: list[list[int]] = []
        for idxs in sig_buckets.values():
            if len(idxs) <= 1 or self.class_groups <= 1:
                groups.append(idxs)
                continue
            # frequency-weighted quantile cuts over per-query max class; a
            # group smaller than half a launch merges upward
            cmaxes = sorted(max(bounds[i].cfg.term_classes())
                            for i in idxs)
            n = len(cmaxes)
            cuts = sorted({cmaxes[(j * n) // self.class_groups - 1]
                           for j in range(1, self.class_groups)}
                          | {cmaxes[-1]})
            sub: dict = {c: [] for c in cuts}
            for i in idxs:
                cm = max(bounds[i].cfg.term_classes())
                sub[next(c for c in cuts if cm <= c)].append(i)
            pending: list[int] = []
            for c in sorted(sub):
                cur = pending + sub[c]
                pending = []
                if not cur:
                    continue
                if c != max(sub) and len(cur) < self.min_batch // 2:
                    pending = cur
                    continue
                groups.append(cur)
            if pending:
                groups.append(pending)

        # unify within each group; equal-work batch widths across groups
        unified = [(unify_cfgs([bounds[i].cfg for i in idxs], k=self.k),
                    idxs) for idxs in groups]
        for cfg_u, _ in unified:
            check_supported(cfg_u, self.scheme)
        if self.prefix_cap > 0 and self.k <= 64:
            unified = [(self._prefixify(cfg_u, stats), idxs)
                       for cfg_u, idxs in unified]
        works = [max(sum(p or c for p, c in
                         zip(cfg.prefix or (0,) * cfg.T, cfg.classes)), 1)
                 if cfg.classes else 1
                 for cfg, _ in unified]
        wmin = min(works)
        dev = self.searcher.device
        out = []
        for (cfg_g, idxs), work in zip(unified, works):
            if cfg_g.compact_cap and cfg_g.req_groups:
                # tighten the compaction cap from the ACTUAL conjunct lens
                # of the group's queries (classes are pow2-quantized group
                # maxima): eligible_q <= min over required conjuncts of its
                # summed len, so the group max of that is a sound static
                # cap. Each query's OWN req_groups positions are used.
                m = 0
                for i in idxs:
                    lq = np.asarray(bounds[i].arrays["lens"])
                    rgs = bounds[i].cfg.req_groups or cfg_g.req_groups
                    mi = min(sum(int(lq[p]) if p < len(lq) else 0
                                 for p in g)
                             for g in rgs)
                    m = max(m, mi)
                cap = size_class(max(m, 128))
                if cap < cfg_g.compact_cap:
                    cfg_g = replace(cfg_g, compact_cap=cap)
            width = self.max_batch
            while width > self.min_batch and \
                    width * work > self.work_ratio * self.max_batch * wmin:
                width //= 2
            # absolute per-launch budget (rows)
            while width > 1 and width * work > 100_000_000:
                width //= 2
            T = cfg_g.T
            fn = self.searcher.batched(cfg_g, self.scheme)
            s = 0
            while s < len(idxs):
                chunk = list(idxs[s: s + width])
                s += width
                bs = width if len(idxs) > width else _pow2_cover(
                    len(chunk), self.min_batch)
                while len(chunk) < bs:      # wraparound pad: same work/row
                    chunk.append(chunk[0])
                b0 = bounds[chunk[0]].arrays
                batch = {
                    key: torch.from_numpy(np.stack([
                        np.pad(bounds[i].arrays[key],
                               _pad_spec(bounds[i].arrays[key],
                                         T if key != "fparams" else
                                         bounds[i].arrays[key].shape[0]))
                        for i in chunk])).to(dev)
                    for key in _BATCH_KEYS if key in b0
                }
                if cfg_g.sort:
                    # [B, S, 2]: the vmapped form of each plan's [S, 2]
                    batch["sort_targets"] = torch.from_numpy(np.stack(
                        [bounds[i].arrays["sort_targets"]
                         for i in chunk])).to(dev)
                if "sort_strtabs" in b0:
                    batch["sort_strtabs"] = {
                        si: torch.from_numpy(np.stack(
                            [bounds[i].arrays["sort_strtabs"][si]
                             for i in chunk])).to(dev)
                        for si in b0["sort_strtabs"]}
                out.append((cfg_g, fn, batch, chunk))
        return out

    def _prefixify(self, cfg_g, stats):
        """Impact-prefix pruning for the pure relevance OR-of-terms shape:
        terms wider than prefix_cap read only their top-impact prefix.
        Eligibility is the JAX package's (xapiand_tpu/search.py:490-498):
        any predicate/sort/agg machinery needs the full row set."""
        if (cfg_g.tree != ("G", 0) or cfg_g.n_filters or cfg_g.geo_specs
                or cfg_g.phrases or cfg_g.sort
                or cfg_g.collapse_slot is not None or cfg_g.with_aggs
                or cfg_g.count_only or cfg_g.dense or cfg_g.join
                or cfg_g.unweighted or cfg_g.syn_groups or cfg_g.max_specs
                or cfg_g.emit_sort_keys or cfg_g.n_chunks > 1):
            return cfg_g
        if getattr(self.scheme, "needs_uniqterms", False):
            return cfg_g
        cap = self.prefix_cap
        prefix = tuple(cap if c > cap else 0
                       for c in cfg_g.term_classes())
        if not any(prefix):
            return cfg_g
        if not self.searcher.device_segment.ensure_impact(
                self.scheme, stats):
            return cfg_g   # scheme not impact-separable
        return replace(cfg_g, prefix=prefix,
                       verify_k=max(32, 2 * self.k))

    def run(self, irs: list, stats=None) -> list[dict]:
        """Execute a mixed batch; returns per-query dicts in input order:
        {"docids": np[k], "scores": np[k], "count": int}. Every launch is
        enqueued before the first readback; uncertified prefix-mode queries
        re-run on the exact path (prefix_cap 0)."""
        planned = self.plan(irs, stats=stats)
        seg_arrays = self.searcher.device_segment.arrays_pytree()
        seg = self.searcher.segment
        st = stats or CollectionStats(
            doc_count=seg.doc_count, avg_doclen=seg.avg_doclen,
            doclen_lower=1.0, total_len=float(seg.total_doclen))
        stats_d = {"N": float(st.doc_count),
                   "avg_doclen": float(st.avg_doclen),
                   "doclen_lower": float(st.doclen_lower),
                   "doclen_upper": float(st.doclen_upper),
                   "total_len": float(st.total_len)}
        pend = [(fn(seg_arrays, batch, stats_d), chunk)
                for _cfg, fn, batch, chunk in planned]
        results: list = [None] * len(irs)
        uncertified: list = []
        for out, chunk in pend:
            docids = out["docids"].cpu().numpy()
            scores = out["scores"].cpu().numpy()
            counts = out["count"].cpu().numpy()
            cert = out["certified"].cpu().numpy() \
                if "certified" in out else None
            for row, qi in enumerate(chunk):
                if results[qi] is None:
                    if cert is not None and not bool(cert[row]):
                        results[qi] = False   # placeholder: exact re-run
                        uncertified.append(qi)
                        continue
                    results[qi] = {"docids": docids[row],
                                   "scores": scores[row],
                                   "count": int(counts[row])}
        if uncertified:
            save = self.prefix_cap
            self.prefix_cap = 0
            try:
                redo = self.run([irs[qi] for qi in uncertified],
                                stats=stats)
            finally:
                self.prefix_cap = save
            for qi, res in zip(uncertified, redo):
                results[qi] = res
        return results


def _pow2_cover(n: int, lo: int) -> int:
    w = lo
    while w < n:
        w *= 2
    return w


def _pad_spec(arr, t):
    spec = [(0, t - arr.shape[0])]
    spec.extend((0, 0) for _ in range(arr.ndim - 1))
    return spec
