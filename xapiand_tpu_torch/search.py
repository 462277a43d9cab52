"""SegmentSearcher and BatchSearcher on torch tensors (counterpart of
``xapiand_tpu/search.py:23-641``).

PyTorch runs eagerly, so there is no compilation cache: ``batched(cfg)``
returns a plain callable over a batch whose leading axis is the query
axis (the JAX package's ``jit(vmap(execute))``).

A ``SegmentSearcher`` runs on the card unless the caller names another
device (``device=torch.device("cpu")`` in the tests, where every kernel
wrapper runs its plain version). Its native host executors
(``host_scorer``, ``host_query``: pinned copies of the JAX package's
``ops/host_scorer.py`` and ``ops/host_query.py``) answer the queries the
JAX package routes to the host, as ``BatchSearcher.run`` routes them.
"""

from __future__ import annotations

import os
import threading
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from xapiand_tpu_torch.models.segment import (DeviceSegment, Segment,
                                              size_class)
from xapiand_tpu_torch.models.weights import (CollectionStats, WeightScheme,
                                              get_scheme)
from xapiand_tpu_torch.ops.aggs import check_aggs
from xapiand_tpu_torch.ops.executor import (ExecConfig, check_supported,
                                            execute_batch)

_BATCH_KEYS = ("offsets", "lens", "tconst", "scoring", "group_bits",
               "fparams", "syn_tconst")
# a bound plan's aggregation arrays (query/plan.py:685-686), dicts keyed by
# spec: ``execute`` uploads them; the JAX BatchSearcher does not stack them
# (ROADMAP queue 3), so a batch carries none
_AGG_KEYS = ("agg_params", "agg_ranges", "agg_filters")
# stacked at their own length, not padded to T (xapiand_tpu/search.py:353)
_OWN_LENGTH = ("fparams", "syn_tconst")
# a chunked plan's per-term chunk spans i32[T, n_chunks] (_chunkify)
_CHUNK_KEYS = ("c_offsets", "c_lens")


class SegmentSearcher:
    def __init__(self, seg: Segment, scheme: Optional[WeightScheme] = None,
                 *, device=None):
        self.segment = seg
        self.device = torch.device("cuda" if device is None else device)
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

    def host_scorer(self):
        """Lazy native latency-path scorer over this segment's flat arrays
        (ops/host_scorer.py; JAX search.py:47-55)."""
        hs = getattr(self, "_host_scorer", None)
        if hs is None:
            from xapiand_tpu_torch.ops.host_scorer import HostScorer

            hs = self._host_scorer = HostScorer(self.segment)
        return hs

    def host_query(self):
        """Lazy native conjunctive executor (ops/host_query.py); None when
        the native library is unavailable (JAX search.py:57-68)."""
        hq = getattr(self, "_host_query", None)
        if hq is None:
            from xapiand_tpu_torch.native import lib

            if lib is None:
                return None
            from xapiand_tpu_torch.ops.host_query import HostQueryExecutor

            hq = self._host_query = HostQueryExecutor(self.segment)
        return hq

    def refresh_deleted(self):
        """Re-upload the delete bitmap after host-side deletes (JAX
        search.py:70-78); the native conjunctive executor registered a
        has-deletes flag when it was built, so it is dropped."""
        ds = self._device_segment
        if ds is not None:
            ds.arrays["deleted"] = torch.from_numpy(
                np.array(self.segment.deleted, np.bool_)).to(self.device)
        self.__dict__.pop("_host_query", None)

    def batched(self, cfg: ExecConfig, scheme: Optional[WeightScheme] = None):
        """fn(seg_arrays, batch, stats) over a leading query axis; raises
        NotImplementedError at once for a config outside the port."""
        scheme = scheme or self.scheme
        check_supported(cfg, scheme)

        def run(seg_arrays, batch, stats):
            return execute_batch(seg_arrays, batch, cfg, stats, scheme)

        return run

    def execute(self, bound, stats: dict,
                scheme: Optional[WeightScheme] = None) -> dict:
        """One bound plan (query/plan.py bind) against the segment: the
        single-query entry point, and the only one that collapses
        (``bind(collapse_slot=...)``). stats: {"N", "avg_doclen",
        "doclen_lower", "doclen_upper", "total_len"}; the scheme's query
        length is the bound plan's ``qlen``, as JAX's execute reads it
        (xapiand_tpu/ops/executor.py:636-641). -> numpy arrays without a
        query axis: docids i32[k],
        scores f32[k], count i32[()] (taken before a collapse), aggs with
        aggregations, certified bool[()] where the plan certifies.

        ``bound.cfg.carry`` is admitted: the port reads value channels by
        docid, so nothing is uploaded for it."""
        scheme = scheme or self.scheme
        cfg, arrays = bound.cfg, bound.arrays
        check_supported(cfg, scheme)
        dev = self.device

        def up(a):
            return torch.from_numpy(np.asarray(a)[None]).to(dev)

        batch = {key: up(arrays[key]) for key in _BATCH_KEYS + _CHUNK_KEYS
                 if key in arrays}
        if "geo_queries" in arrays:
            batch["geo_queries"] = [up(q) for q in arrays["geo_queries"]]
        if "sort_targets" in arrays:
            batch["sort_targets"] = up(arrays["sort_targets"])
        if "sort_strtabs" in arrays:
            batch["sort_strtabs"] = {si: up(t) for si, t in
                                     arrays["sort_strtabs"].items()}
        for key in _AGG_KEYS:
            if key in arrays:
                batch[key] = {pk: up(a) for pk, a in arrays[key].items()}
        stats = {**stats, "query_length": float(arrays.get("qlen", 1.0))}
        out = execute_batch(self.device_segment.arrays_pytree(), batch, cfg,
                            stats, scheme)
        return _tree_map(lambda a: a[0].cpu().numpy(), out)


class BatchSearcher:
    """Shape-bucketed batch execution over one segment (see the JAX
    package's BatchSearcher for the bucketing rationale): plan signature,
    size-class terciles, equal-work batch widths, wraparound padding,
    impact-prefix pruning with an exact re-run of uncertified queries,
    and ``sort=`` / ``aggs=`` bound into every query (faceted serving:
    ``aggs = (specs, arrays)`` from aggregations.compile_for_segment).

    The fullwidth path is on unless the environment sets XT_FULLWIDTH=0,
    as in the JAX package: launch groups that query/plan.py fullwidth_ok
    admits skip the compaction and order one sort key with the windowed
    top-k (K9); queries it cannot certify re-run on the exact path.

    ``run`` routes queries to the native host executors before it plans,
    as the JAX package does (``_route_host``, JAX search.py:399-483):
    conjunctive queries within HOST_CONJ_MAX_WORK go to the conjunctive
    executor and a small pure-OR residue to the TAAT scorer, unless
    XT_HOST_PATH=0; ``routed`` counts the queries each route served.
    ``chunk_rows`` > 0 splits the docid space of a wide pure term tree
    into up to 16 ranges of at least that many rows, each ranked on its
    own and the finalists merged (``_chunkify``, the executor's chunked
    path, K21); 0, the default, as in the JAX package, turns it off. The
    aggregation kinds of K17c raise here at once (ops/aggs.py check_aggs):
    the JAX BatchSearcher does not stack their plan arrays (ROADMAP queue
    3); ``SegmentSearcher.execute`` runs them.
    """

    def __init__(self, searcher: SegmentSearcher, k: int = 10,
                 max_batch: int = 256, min_batch: int = 64,
                 class_groups: int = 3, work_ratio: float = 2.0,
                 scheme: Optional[WeightScheme] = None,
                 sort=None, aggs=None, chunk_rows: int = 0,
                 prefix_cap: int = 0, global_tf=None, global_cf=None):
        self.aggs_specs, self.agg_arrays = aggs if aggs else ((), None)
        check_aggs(self.aggs_specs, batched=True)
        self.chunk_rows = chunk_rows
        self.searcher = searcher
        self.k = k
        self.sort = sort
        self.global_tf = global_tf
        self.global_cf = global_cf
        self.prefix_cap = prefix_cap
        self._fullwidth = os.environ.get("XT_FULLWIDTH", "1") != "0"
        self.reran: list = []
        self.max_batch = max_batch
        self.min_batch = min_batch
        self.class_groups = class_groups
        self.work_ratio = work_ratio
        self.scheme = scheme or searcher.scheme
        self.routed = {"conj": 0, "or": 0, "device": 0}

    def plan(self, irs: list, stats=None) -> list:
        """Bind + bucket + pad a mixed list of Q IRs.

        -> list of (cfg, fn, batch_tensors, chunk_query_idxs); feed each to
        fn(seg_arrays, batch, stats_d) in order."""
        from xapiand_tpu_torch.query.plan import (bind, compile_ir,
                                                  fullwidth_ok,
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
                       sort=self.sort, aggs=self.aggs_specs,
                       agg_arrays=self.agg_arrays,
                       keep_carry=self._fullwidth)
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
        if os.environ.get("XT_PHRASE_CARRY", "0") == "1":
            # read as the JAX package reads it (xapiand_tpu/search.py:
            # 272-276); the port's phrase step runs one path either way
            unified = [(replace(c, phrase_carry=True) if c.phrases else c,
                        i) for c, i in unified]
        works = []
        for cfg, _ in unified:
            w = max(sum(p or c for p, c in
                        zip(cfg.prefix or (0,) * cfg.T, cfg.classes)), 1) \
                if cfg.classes else 1
            for _slot, _QR, RMAX in cfg.geo_specs:
                # the JAX package's geo weight (xapiand_tpu/search.py:
                # 288-293), kept so batch widths and launch groups are its
                w *= 4 * (1 + RMAX)
            works.append(w)
        wmin = min(works)
        dev = self.searcher.device
        out = []
        for (cfg_g, idxs), work in zip(unified, works):
            cfg_g = self._chunkify(cfg_g, bounds, idxs)
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
            if self._fullwidth and fullwidth_ok(cfg_g):
                cfg_g = replace(cfg_g, fullwidth=True)
            elif cfg_g.carry:
                # carried channels never ride into the compaction layout
                # (the exact re-run included: it runs with _fullwidth off)
                cfg_g = replace(cfg_g, carry=())
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
                                         T if key not in _OWN_LENGTH else
                                         bounds[i].arrays[key].shape[0]))
                        for i in chunk])).to(dev)
                    for key in _BATCH_KEYS if key in b0
                }
                if "geo_queries" in b0:
                    # per geo leaf [B, QR, 2]: each query's cover padded
                    # to the group's unified QR with INT32_MAX rows, which
                    # no range test counts (xapiand_tpu/search.py:360-376)
                    gqs = []
                    for gi, (_slot, QR, _rm) in enumerate(cfg_g.geo_specs):
                        rows = np.full((len(chunk), QR, 2), 2**31 - 1,
                                       np.int32)
                        for r, i in enumerate(chunk):
                            q = bounds[i].arrays["geo_queries"][gi]
                            rows[r, :q.shape[0]] = q
                        gqs.append(torch.from_numpy(rows).to(dev))
                    batch["geo_queries"] = gqs
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
                if cfg_g.n_chunks > 1:
                    for key in _CHUNK_KEYS:
                        batch[key] = torch.from_numpy(np.stack(
                            [bounds[i].arrays[key] for i in chunk])).to(dev)
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

    def _chunkify(self, cfg_g, bounds, idxs):
        """Docid-range chunking of a wide single-group term tree (JAX
        search.py _chunkify 510-566, its rules as they are): n_chunks
        doubles to 16 while each chunk keeps chunk_rows rows; each query's
        per-term chunk spans (c_offsets / c_lens i32[T, nc], into its
        bound arrays) are cut at the docid grid by np.searchsorted; each
        term's chunk width is its widest chunk on the 128-lane grid (0:
        the term is skipped); a group whose chunked total exceeds 1.3x
        its unchunked rows (clustered postings) is not chunked."""
        if (cfg_g.tree != ("G", 0) or cfg_g.n_filters or cfg_g.geo_specs
                or cfg_g.phrases or cfg_g.sort
                or cfg_g.collapse_slot is not None or cfg_g.with_aggs
                or cfg_g.count_only or cfg_g.dense or cfg_g.join
                or cfg_g.unweighted or cfg_g.syn_groups or cfg_g.max_specs
                or cfg_g.emit_sort_keys or cfg_g.prefix):
            return cfg_g
        if self.chunk_rows <= 0:
            return cfg_g
        R = sum(cfg_g.term_classes())
        nc = 1
        while nc < 16 and R // (nc * 2) >= self.chunk_rows:
            nc *= 2
        if nc <= 1:
            return cfg_g
        seg = self.searcher.segment
        nd = max(seg.doc_count, 1)
        bpoints = (np.arange(1, nc, dtype=np.int64) * nd) // nc
        T = cfg_g.T
        maxlens = np.zeros(T, np.int64)
        for i in idxs:
            arr = bounds[i].arrays
            offs = np.asarray(arr["offsets"])
            lens = np.asarray(arr["lens"])
            c_off = np.zeros((T, nc), np.int32)
            c_len = np.zeros((T, nc), np.int32)
            for t in range(offs.shape[0]):
                off, ln = int(offs[t]), int(lens[t])
                cuts = np.searchsorted(seg.post_docids[off: off + ln],
                                       bpoints)
                edges = np.concatenate([[0], cuts, [ln]])
                c_off[t] = off + edges[:-1]
                c_len[t] = np.diff(edges)
            arr["c_offsets"] = c_off
            arr["c_lens"] = c_len
            maxlens = np.maximum(maxlens, c_len.max(axis=1))
        chunk_classes = tuple(
            int(-(-int(m) // 128) * 128) if m > 0 else 0 for m in maxlens)
        if not any(chunk_classes):
            return cfg_g
        if nc * sum(chunk_classes) > 1.3 * R:
            return cfg_g
        return replace(cfg_g, n_chunks=nc, chunk_classes=chunk_classes)

    HOST_CONJ_MAX_WORK = 8_000_000

    def _route_host(self, irs: list, stats=None):
        """-> ({qi: out}, [remaining qi]): conjunctive queries served by
        the native executor, the rest left for the device batch (JAX
        search.py:399-483, line for line)."""
        from xapiand_tpu_torch.ops.host_query import conj_eligible
        from xapiand_tpu_torch.ops.host_scorer import (host_eligible,
                                                       term_constants)
        from xapiand_tpu_torch.query.plan import compile_ir, resolve_special

        results: dict = {}
        rem = list(range(len(irs)))
        if os.environ.get("XT_HOST_PATH", "1") == "0":
            return results, rem
        hq = self.searcher.host_query()
        if hq is None:
            return results, rem
        seg = self.searcher.segment
        st = stats or CollectionStats(
            doc_count=seg.doc_count, avg_doclen=seg.avg_doclen,
            doclen_lower=1.0, total_len=float(seg.total_doclen))

        def gtf(t):
            ti = seg.get_term(t)
            return ti.length if ti else 0

        def gcf(t):
            ti = seg.get_term(t)
            return ti.collfreq if ti else 0

        if self.global_tf is not None:
            gtf = self.global_tf
        if self.global_cf is not None:
            gcf = self.global_cf
        rem = []
        or_cands: list = []   # (qi, cq) pure-OR queries, host-eligible
        for qi, ir in enumerate(irs):
            cq = compile_ir(resolve_special(ir, self.scheme, st, gtf, gcf),
                            cost_fn=gtf)
            parts = conj_eligible(cq, self.scheme, self.sort or (),
                                  self.aggs_specs, None)
            out = None
            if parts is not None and \
                    hq.driver_work(cq, parts) <= self.HOST_CONJ_MAX_WORK:
                tc = term_constants(cq, self.scheme, st, gtf, gcf)
                out = hq.run(cq, parts, self.scheme, st, tc, self.k,
                             sort=self.sort or (), aggs=self.aggs_specs)
            if out is None:
                if host_eligible(cq, self.scheme, self.sort or (),
                                 self.aggs_specs, None):
                    or_cands.append((qi, cq))
                else:
                    rem.append(qi)
            else:
                results[qi] = out
                self.routed["conj"] += 1
        if or_cands:
            # the whole pure-OR residue in one host call while its posting
            # work is within the budget; past it, all of it stays on the
            # device (JAX search.py:456-482)
            budget = int(os.environ.get("XT_HOST_OR_BUDGET", "4000000"))
            total_work = sum(gtf(pt.term) for _qi, cq in or_cands
                             for pt in cq.terms)
            if total_work <= budget:
                hs = self.searcher.host_scorer()
                plans = []
                for _qi, cq in or_cands:
                    offs, lens = hs.offsets_lens(cq)
                    plans.append((offs, lens,
                                  term_constants(cq, self.scheme, st,
                                                 gtf, gcf)))
                outs = hs.search_many(plans, self.scheme, st, self.k)
                for (qi, _cq), out in zip(or_cands, outs):
                    results[qi] = out
                self.routed["or"] += len(or_cands)
            else:
                rem.extend(qi for qi, _cq in or_cands)
                rem.sort()
        return results, rem

    def run(self, irs: list, stats=None) -> list[dict]:
        """Execute a mixed batch; returns per-query dicts in input order:
        {"docids": np[k], "scores": np[k], "count": int[, "aggs": the
        query's row of ops/aggs.py's structure, numpy]}. Queries the host
        executors take are routed first (``_route_host``); the rest go to
        the device, every launch enqueued before the first readback;
        uncertified queries (prefix mode, fullwidth window) re-run on the
        exact path (prefix_cap 0, fullwidth off), and ``self.reran`` lists
        their indices into the irs of the device call, in the order they
        re-ran."""
        host_results, rem_idx = self._route_host(irs, stats)
        if not rem_idx:
            return [host_results[qi] for qi in range(len(irs))]
        if len(rem_idx) < len(irs):
            sub = self.run([irs[qi] for qi in rem_idx], stats=stats)
            for j, qi in enumerate(rem_idx):
                host_results[qi] = sub[j]
            return [host_results[qi] for qi in range(len(irs))]
        self.routed["device"] += len(irs)
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
            aggs = _tree_map(lambda a: a.cpu().numpy(), out["aggs"]) \
                if "aggs" in out else None
            for row, qi in enumerate(chunk):
                if results[qi] is None:
                    if cert is not None and not bool(cert[row]):
                        results[qi] = False   # placeholder: exact re-run
                        uncertified.append(qi)
                        continue
                    results[qi] = {"docids": docids[row],
                                   "scores": scores[row],
                                   "count": int(counts[row])}
                    if aggs is not None:
                        results[qi]["aggs"] = _tree_map(
                            lambda a, r=row: a[r], aggs)
        if uncertified:
            save, save_fw = self.prefix_cap, self._fullwidth
            self.prefix_cap, self._fullwidth = 0, False
            try:
                redo = self.run([irs[qi] for qi in uncertified],
                                stats=stats)
            finally:
                self.prefix_cap, self._fullwidth = save, save_fw
            self.routed["device"] -= len(uncertified)
            for qi, res in zip(uncertified, redo):
                results[qi] = res
        self.reran = uncertified
        return results


def _tree_map(fn, tree):
    """fn over the arrays of a tuple / list / dict tree (the aggs
    structure), keeping the containers and their None leaves (a nested
    level without subs), as jax.tree_util.tree_map does."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _pow2_cover(n: int, lo: int) -> int:
    w = lo
    while w < n:
        w *= 2
    return w


def _pad_spec(arr, t):
    spec = [(0, t - arr.shape[0])]
    spec.extend((0, 0) for _ in range(arr.ndim - 1))
    return spec
