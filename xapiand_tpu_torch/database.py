"""Database on the card: the torch port of ``xapiand_tpu/database.py``
(the operations facade over schema + segments + searchers, for one local
shard).

It follows the JAX file closely enough to diff the two. Documents index
through the schema into a host-side builder (``models/builder.py``, a
pinned copy); ``commit`` freezes them into a new immutable segment, one a
generation, whose ``SegmentSearcher`` uploads it to the card at its first
device-routed query; deletes are bitmap updates re-uploaded by
``refresh_deleted``. ``search`` compiles the query once, routes it to the
native host executors where the JAX package does (``_use_host_path``,
the conjunctive executor per segment), and otherwise binds and runs it on
each segment through ``SegmentSearcher.execute``, aggregations of every
kind included (K17c), then merges the segments' hits and shapes the
aggregations (``aggregations.merge_and_shape``). ``search_many`` batches
plain queries through ``BatchSearcher``. ``from_jax_state`` carries a
JAX ``Database``'s committed state into the port.

It runs on the card unless the caller names another device: ``device``
None means ``cuda``, and without a card that raises rather than running
on the CPU (the tests pass ``device="cpu"``, where every kernel wrapper
runs its plain version).

Left out, each refused by name with its ROADMAP item: persistence
(``path=``: ``index/``, ``models/snapshot.py``, the WAL, checkpoints),
``_script`` on write and ``_scripted_metric`` (``utils/scripting.py``),
the typed blob store, metadata, clustering and diversification (K20), and
the relevance-feedback, spelling and synonym stores.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from xapiand_tpu_torch.models.builder import SegmentBuilder
from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme
from xapiand_tpu_torch.query.dsl import QueryDSL
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.query.plan import bind, compile_ir, resolve_special
from xapiand_tpu_torch.schema import Schema
from xapiand_tpu_torch.search import SegmentSearcher


@dataclass
class Hit:
    id: str
    score: float
    rank: int
    data: dict


@dataclass
class SearchResult:
    total: int
    hits: list = field(default_factory=list)
    aggregations: Optional[dict] = None


class DocumentNotFound(KeyError):
    pass


class VersionConflict(ValueError):
    """Optimistic-concurrency failure (≙ reference 409 Conflict)."""

    def __init__(self, doc_id, expected, current):
        super().__init__(
            f"version conflict on {doc_id!r}: expected {expected}, "
            f"current {current}")
        self.doc_id = doc_id
        self.expected = expected
        self.current = current


def _refuse(what: str, item: str):
    raise NotImplementedError(f"not ported yet: {what} (ROADMAP {item})")


def _device(device) -> torch.device:
    """The device a Database runs on: the card unless the caller names
    another; a card that is missing raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Database runs on the card and torch sees no "
                           "CUDA device; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


class Database:
    # impact-prefix pruning cap for the batched plain path (search_many):
    # 0 = off; certified-exact top-k with counts as lower bounds
    prefix_cap = 0

    def __init__(self, path: Optional[str] = None, scheme: str = "bm25",
                 schema: Optional[Schema] = None, device=None,
                 **scheme_params):
        if path is not None:
            _refuse("persistence (path=: index/, models/snapshot.py, the "
                    "WAL, checkpoints)", "queue 1 item 5, REST with "
                    "persistence")
        self.schema = schema or Schema()
        self.scheme = get_scheme(scheme, **scheme_params)
        self.device = _device(device)
        self._builder = self._new_builder()
        self._pending_docs: dict[str, dict] = {}      # doc_id -> data
        self._docs_store: dict[str, dict] = {}
        self._searchers: list[SegmentSearcher] = []
        self._locate: dict[str, tuple[int, int]] = {}  # doc_id -> (seg, docid)
        self._pending_deletes: set[str] = set()
        self._versions: dict[str, int] = {}           # doc_id -> _version
        self.revision = 0
        self.auto_merge_segments = 16   # tiered compaction trigger

    def _new_builder(self):
        return SegmentBuilder()

    def _finalize_pending(self) -> list:
        return [self._builder.finalize()]

    def _defer_text(self) -> bool:
        return getattr(self._builder, "wants_deferred_text", False)

    # -- write path ----------------------------------------------------------

    def index_document(self, obj: dict, doc_id: Optional[str] = None,
                       commit: bool = False,
                       version: Optional[int] = None) -> str:
        """Index (upsert) one document; ≙ DatabaseHandler::index
        (handler.h:113). version enables optimistic concurrency."""
        if isinstance(obj, dict) and "_script" in obj:
            _refuse("_script on write (utils/scripting.py)",
                    "queue 1 item 5, REST with persistence")
        idoc = self.schema.index(obj, doc_id,
                                 defer_text=self._defer_text())
        did = idoc.doc_id
        cur = self._versions.get(did, 0)
        if version is not None and int(version) != cur:
            raise VersionConflict(did, int(version), cur)
        self.delete_document(did, missing_ok=True, _keep_version=True)
        self._builder.add(idoc)
        self._pending_docs[did] = idoc.data
        # re-adding supersedes any pending delete of this id (commit's
        # last-occurrence rule handles replaced rows)
        self._pending_deletes.discard(did)
        self._versions[did] = cur + 1
        if commit:
            self.commit()
        return did

    def version_of(self, doc_id: str) -> int:
        return self._versions.get(str(doc_id), 0)

    def delete_document(self, doc_id: str, commit: bool = False,
                        missing_ok: bool = False,
                        version: Optional[int] = None,
                        _keep_version: bool = False) -> bool:
        doc_id = str(doc_id)
        if version is not None and \
                int(version) != self._versions.get(doc_id, 0):
            raise VersionConflict(doc_id, int(version),
                                  self._versions.get(doc_id, 0))
        if not _keep_version:
            self._versions.pop(doc_id, None)
        found = False
        if doc_id in self._pending_docs:
            # mark the pending version dead at commit
            self._pending_deletes.add(doc_id)
            found = True
        loc = self._locate.get(doc_id)
        if loc is not None:
            seg_idx, docid = loc
            searcher = self._searchers[seg_idx]
            if not searcher.segment.deleted[docid]:
                searcher.segment.deleted[docid] = True
                searcher.refresh_deleted()
                # host latency path caches delete-bitmap pointers
                self._host_epoch = getattr(self, "_host_epoch", 0) + 1
                found = True
            del self._locate[doc_id]
        if not found and not missing_ok:
            raise DocumentNotFound(doc_id)
        if commit:
            self.commit()
        return found

    def commit(self) -> int:
        """Freeze pending docs into a new immutable segment generation;
        ≙ Shard::commit (shard.cc:706): revision bump."""
        if len(self._builder) == 0 and not self._pending_deletes:
            return self.revision
        if len(self._builder):
            for seg in self._finalize_pending():
                # apply deletes that targeted pending docs (replaced
                # in-batch): keep only the LAST occurrence of each doc key
                last = {}
                for docid, key in enumerate(seg.doc_keys):
                    last[key] = docid
                for docid, key in enumerate(seg.doc_keys):
                    if last[key] != docid or key in self._pending_deletes:
                        seg.deleted[docid] = True
                self._add_segment(seg, last)
            self._builder = self._new_builder()
            self._docs_store.update(self._pending_docs)
            self._pending_docs = {}
        self._pending_deletes.clear()
        self.revision += 1
        if len(self._searchers) > self.auto_merge_segments:
            self._compact_tier()
        return self.revision

    def _add_segment(self, seg, last: dict) -> int:
        """Append a committed segment's searcher and locate its live docs
        (doc key -> its docid there)."""
        searcher = SegmentSearcher(seg, self.scheme, device=self.device)
        seg_idx = len(self._searchers)
        self._searchers.append(searcher)
        for key, docid in last.items():
            if not seg.deleted[docid]:
                self._locate[key] = (seg_idx, docid)
        return seg_idx

    def _compact_tier(self):
        """Tiered background compaction (≙ glass_compact / the honey
        read-optimised rebuild): merge the smallest segments down to half
        the trigger count. Large segments are left alone, so steady-state
        write amplification stays logarithmic like an LSM. The merge is a
        pure data merge (models/merge.py) - posting spans and value/geo
        columns are concatenated with docids rebased, NO re-tokenization
        (the reference's compact streams tables, glass_compact.cc; it
        never re-analyzes documents)."""
        from xapiand_tpu_torch.models.merge import merge_segments_data

        order = sorted(range(len(self._searchers)),
                       key=lambda i: self._searchers[i].segment.doc_count)
        n_keep_small = self.auto_merge_segments // 2
        victims = set(order[: len(order) - n_keep_small])
        if len(victims) < 2:
            return
        vlist = sorted(victims)
        segs = [self._searchers[i].segment for i in vlist]
        alive = []
        for i, seg in zip(vlist, segs):
            al = (~seg.deleted[: seg.num_docs]).copy()
            keys = seg.doc_keys
            for docid in np.nonzero(al)[0]:
                # replaced rows are delete-flagged at replace time, so this
                # locate check is belt-and-braces against drift
                if self._locate.get(keys[docid]) != (i, int(docid)):
                    al[docid] = False
            alive.append(al)
        merged_seg, _remaps = merge_segments_data(segs, alive)
        merged = merged_seg if merged_seg.num_docs else None
        new_searchers, remap = [], {}
        for i, s in enumerate(self._searchers):
            if i in victims:
                continue
            remap[i] = len(new_searchers)
            new_searchers.append(s)
        mi = None
        if merged is not None:
            mi = len(new_searchers)
            new_searchers.append(SegmentSearcher(merged, self.scheme,
                                                 device=self.device))
        new_locate = {}
        for key, (si, docid) in self._locate.items():
            if si in remap:
                new_locate[key] = (remap[si], docid)
        if merged is not None:
            for docid, key in enumerate(merged.doc_keys):
                new_locate[key] = (mi, docid)
        self._searchers = new_searchers
        self._locate = new_locate

    # -- stats ----------------------------------------------------------------

    @property
    def doc_count(self) -> int:
        return sum(s.segment.doc_count for s in self._searchers)

    @property
    def total_doclen(self) -> float:
        # approximation: includes deleted docs until merge (documented
        # deviation from glass, which maintains exact stats on delete)
        return sum(s.segment.total_doclen for s in self._searchers)

    def stats(self) -> CollectionStats:
        # cached per mutation state: doc_count sums a delete-bitmap
        # reduction per segment, doclen_upper a max - O(docs) numpy work.
        # revision covers commits (incl. compaction), _host_epoch covers
        # uncommitted deletes, len covers any segment-list change.
        key = (self.revision, getattr(self, "_host_epoch", 0),
               len(self._searchers))
        cached = getattr(self, "_stats_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        n = self.doc_count
        total = self.total_doclen
        avg = (total / n) if n else 0.0
        upper = 1.0
        for s in self._searchers:
            seg = s.segment
            if seg.num_docs:
                upper = max(upper, float(seg.doclen[:seg.num_docs].max()))
        st = CollectionStats(doc_count=n, avg_doclen=avg, doclen_lower=1.0,
                             doclen_upper=upper, total_len=total)
        self._stats_cache = (key, st)
        return st

    def global_termfreq(self, term: str) -> int:
        tf = 0
        for s in self._searchers:
            ti = s.segment.get_term(term)
            if ti:
                tf += ti.length
        return tf

    def global_collfreq(self, term: str) -> int:
        cf = 0
        for s in self._searchers:
            ti = s.segment.get_term(term)
            if ti:
                cf += ti.collfreq
        return cf

    # -- read path ----------------------------------------------------------

    def get_document(self, doc_id: str) -> dict:
        doc_id = str(doc_id)
        if doc_id in self._pending_docs:
            return self._pending_docs[doc_id]
        if doc_id in self._locate:
            return self._docs_store[doc_id]
        raise DocumentNotFound(doc_id)

    def dump_documents(self):
        """Iterate all live documents as objects with _id (DUMP verb)."""
        for seg_idx, s in enumerate(self._searchers):
            seg = s.segment
            for docid, key in enumerate(seg.doc_keys):
                if not seg.deleted[docid] and \
                        self._locate.get(key) == (seg_idx, docid):
                    doc = dict(self._docs_store.get(key, {}))
                    doc["_id"] = key
                    yield doc
        for key, data in self._pending_docs.items():
            if key not in self._pending_deletes:
                doc = dict(data)
                doc["_id"] = key
                yield doc

    def merge_segments(self) -> int:
        """Compact all segments into one (≙ glass compaction): rebuilds from
        live documents, dropping deletes."""
        docs = list(self.dump_documents())
        self._searchers = []
        self._locate = {}
        self._builder = self._new_builder()
        self._pending_docs = {}
        self._pending_deletes = set()
        for doc in docs:
            did = doc.pop("_id")
            idoc = self.schema.index(doc, did,
                                     defer_text=self._defer_text())
            self._builder.add(idoc)
            self._pending_docs[did] = idoc.data
        self.commit()
        return len(docs)

    def _search_with_cutoff(self, percent_cutoff: float,
                            weight_cutoff: float, query, k: int,
                            offset: int, **kw) -> SearchResult:
        """Enquire::set_cutoff analog (≙ handler.cc:1264,1443 — the
        reference threads percent/weight thresholds into every shard
        matcher and the mset merger; its REST plane hard-codes both to 0,
        so exposing them is a strict superset). Engine-agnostic: scores
        are final when a SearchResult is assembled, so a post-filter on
        the ranked hits is exactly equivalent to the in-matcher filter
        for relevance-ordered results. percent_cutoff is relative to the
        top attained score (Xapian scales vs max attained weight in the
        mset); totals stay exact pre-cutoff counts (documented superset:
        the reference degrades them to estimates under cutoff)."""
        res = self.search(query, k=k + offset, offset=0, **kw)
        thr = float(weight_cutoff)
        if percent_cutoff and res.hits:
            top = max(h.score for h in res.hits)
            thr = max(thr, top * float(percent_cutoff) / 100.0)
        kept = [h for h in res.hits if h.score >= thr]
        res.hits = [Hit(id=h.id, score=h.score, rank=offset + i,
                        data=h.data)
                    for i, h in enumerate(kept[offset:])]
        return res

    def search(self, query: Any, k: int = 10, offset: int = 0,
               sort: tuple = (), collapse_slot: Optional[int] = None,
               aggs: Optional[dict] = None,
               count_only: bool = False,
               scheme: Optional[Any] = None,
               collapse_max: int = 1,
               percent_cutoff: float = 0.0,
               weight_cutoff: float = 0.0) -> SearchResult:
        """query: a Q IR node, or a JSON query-DSL dict/string.

        ≙ DatabaseHandler::get_mset (handler.cc:1067,1415): global stats are
        computed across all segments first (two-phase stat merge), then each
        segment executes with those stats and partial top-ks merge by score.
        scheme overrides the database's default weight scheme per query
        (Enquire::set_weighting_scheme); a string names a registered scheme.
        """
        if percent_cutoff or weight_cutoff:
            return self._search_with_cutoff(
                percent_cutoff, weight_cutoff, query, k, offset,
                sort=sort, collapse_slot=collapse_slot, aggs=aggs,
                count_only=count_only, scheme=scheme,
                collapse_max=collapse_max)
        from xapiand_tpu_torch import aggregations as aggs_mod

        if scheme is None:
            scheme = self.scheme
        elif isinstance(scheme, str):
            scheme = get_scheme(scheme)

        # search-plan cache (JAX database.py:662-670): everything derived
        # only from (ir, scheme, sort/aggs/collapse shape, index state) -
        # resolve+compile, slot ranges, per-segment agg compilations and
        # the native executor's marshalled arrays - is reused across
        # calls, keyed on IR object identity + the same mutation-state
        # tuple as the host scorers.
        ir0 = query if isinstance(query, Q) else \
            QueryDSL(self.schema, term_expander=self.expand_prefix).parse(query)
        stats = self.stats()
        state = (self.revision, getattr(self, "_host_epoch", 0),
                 len(self._searchers))
        skey = (state, scheme.key(), repr(sort), repr(aggs),
                collapse_slot, collapse_max)
        pcache = getattr(self, "_search_plan_cache", None)
        if pcache is None:
            pcache = self._search_plan_cache = {}
        pent = pcache.get(id(ir0))
        plan = pent[2] if (pent is not None and pent[0] is ir0
                           and pent[1] == skey) else None
        if plan is not None:
            slot_ranges = plan["slot_ranges"]
            aggs = plan["aggs"]
            ir = plan["rir"]
            cq = plan["cq"]
        else:
            slot_ranges = None
            if aggs:
                slot_ranges = aggs_mod.slot_ranges_of(
                    [sr.segment for sr in self._searchers])
            if aggs and any(isinstance(b, dict) and "_scripted_metric" in b
                            for b in aggs.values()):
                _refuse("_scripted_metric aggregations (utils/scripting.py)",
                        "queue 1 item 5, REST with persistence")
            ir = resolve_special(ir0, scheme, stats, self.global_termfreq,
                                 self.global_collfreq)
            cq = compile_ir(ir, cost_fn=self.global_termfreq)
        # latency path (JAX database.py:706-717): a lone plain-relevance
        # query executes host-native (ops/host_scorer.py); the device
        # keeps batches and every heavier operator
        from xapiand_tpu_torch.ops.host_scorer import \
            host_path_enabled as host_path_enabled_fn

        if self._use_host_path(cq, scheme, sort, aggs, collapse_slot):
            return self._search_host([cq], k=k, offset=offset,
                                     stats=stats, scheme=scheme,
                                     count_only=count_only)[0]
        stats_d = {"N": float(stats.doc_count),
                   "avg_doclen": float(stats.avg_doclen),
                   "doclen_lower": float(stats.doclen_lower),
                   "doclen_upper": float(stats.doclen_upper),
                   "total_len": float(stats.total_len)}
        want = k + offset
        # conjunctive host route (ops/host_query.py): AND trees with
        # predicate leaves + flat aggs/value sort are gather-bound on the
        # device; the native executor walks the smallest conjunct and
        # verifies by binary search. Decided per segment (falls back when
        # a column is missing or the driver conjunct is too big).
        conj_parts = conj_tc = None
        if plan is not None:
            conj_parts, conj_tc = plan["conj_parts"], plan["conj_tc"]
        elif host_path_enabled_fn():
            from xapiand_tpu_torch.ops.host_query import conj_eligible

            first_specs = ()
            if aggs and self._searchers:
                from xapiand_tpu_torch import aggregations as aggs_mod2

                try:
                    _, first_specs, _, _ = aggs_mod2.compile_for_segment(
                        self.schema, self._searchers[0].segment, aggs,
                        slot_ranges=slot_ranges)
                except Exception:
                    first_specs = None
            if first_specs is not None:
                conj_parts = conj_eligible(cq, scheme, sort, first_specs,
                                           collapse_slot)
            if conj_parts is not None:
                from xapiand_tpu_torch.ops.host_scorer import term_constants

                conj_tc = term_constants(cq, scheme, stats,
                                         self.global_termfreq,
                                         self.global_collfreq)
        total = 0
        merged: list[tuple[float, int, int]] = []  # (-score, seg, docid)
        agg_parts, agg_cats, agg_names, agg_meta = [], [], None, None
        seg_plans = plan["segs"] if plan is not None else None
        built_segs: list = []
        for seg_idx, searcher in enumerate(self._searchers):
            sp = seg_plans[seg_idx] if seg_plans is not None else None
            specs, arrays = (), None
            if sp is not None:
                specs, arrays = sp["specs"], sp["arrays"]
                if aggs:
                    agg_names, agg_meta = plan["agg_names"], sp["agg_meta"]
                    agg_cats.append(sp["cats_j"])
            elif aggs:
                (agg_names, specs, arrays,
                 agg_meta) = aggs_mod.compile_for_segment(
                    self.schema, searcher.segment, aggs,
                    slot_ranges=slot_ranges)
                cats_j: dict = {}
                for j, spec in enumerate(specs):
                    vals = searcher.segment.values
                    if spec[0] == "terms" and spec[1] in vals:
                        cats_j[j] = vals[spec[1]].cat_names or []
                    elif spec[0] == "geo_trixels":
                        # per-compile trixel table -> HTM names live in this
                        # segment's meta (codes are segment-local, like cats)
                        cats_j[j] = agg_meta[j]["cat_names"]
                    elif spec[0] == "nested":
                        for lvl, d in enumerate(spec[1]):
                            if d[0] == "terms" and d[1] in vals:
                                cats_j[(j, lvl)] = \
                                    vals[d[1]].cat_names or []
                agg_cats.append(cats_j)
            out = None
            prep = sp["prep"] if sp is not None else None
            hq = None
            if prep is None and sp is None and conj_parts is not None:
                hq = searcher.host_query()
                if hq is not None and hq.driver_work(cq, conj_parts) \
                        <= self.HOST_MAX_WORK:
                    prep = hq.prepare(cq, conj_parts, conj_tc,
                                      sort=sort, aggs=specs)
            if prep is not None:
                if hq is None:
                    hq = searcher.host_query()
                out = hq.exec_prepared(prep, scheme, stats, want,
                                       count_only=count_only)
            if sp is None:
                built_segs.append({
                    "specs": specs, "arrays": arrays,
                    "cats_j": agg_cats[-1] if aggs else None,
                    "agg_meta": agg_meta, "prep": prep})
            if out is None:
                bound = bind(cq, searcher.segment, scheme, stats,
                             global_tf=self.global_termfreq, k=want,
                             sort=sort, collapse_slot=collapse_slot,
                             aggs=specs, agg_arrays=arrays,
                             count_only=count_only,
                             global_cf=self.global_collfreq,
                             collapse_max=collapse_max)
                out = searcher.execute(bound, stats_d, scheme=scheme)
            total += int(out["count"])
            if aggs:
                agg_parts.append(out["aggs"])
            if not count_only:
                for sc, did in zip(out["scores"], out["docids"]):
                    if sc == float("-inf"):
                        continue
                    if did >= searcher.segment.num_docs:
                        continue
                    if searcher.segment.deleted[did]:
                        continue
                    merged.append((-float(sc),
                                   self._tiebreak(seg_idx, int(did)),
                                   seg_idx, int(did)))
        if plan is None and isinstance(query, Q):
            # cache only identity-stable IRs (the server's parsed-IR
            # cache); dict/string queries parse fresh objects per call
            if len(pcache) >= 2048:
                for old in list(pcache)[:1024]:
                    pcache.pop(old, None)
            pcache[id(ir0)] = (ir0, skey, {
                "slot_ranges": slot_ranges,
                "aggs": aggs, "rir": ir, "cq": cq,
                "conj_parts": conj_parts, "conj_tc": conj_tc,
                "agg_names": agg_names, "segs": built_segs})
        result = SearchResult(total=total)
        if aggs and agg_parts:
            result.aggregations = aggs_mod.merge_and_shape(
                agg_names, agg_meta, agg_parts, agg_cats)
        if count_only:
            return result
        if sort:
            # value-ordered: per-segment lists are already in key order;
            # merge by re-binding keys host-side (scores are not the key)
            merged = self._merge_sorted(merged, sort)
        else:
            merged.sort()
        if collapse_slot is not None and len(self._searchers) > 1:
            # two-level collapse (≙ collapser.cc across shards): each
            # segment collapsed locally during execution; the merged run
            # re-collapses so at most collapse_max survive per key globally
            merged = self._recollapse(merged, collapse_slot, collapse_max)
        docs_store = getattr(self, "_docs_store", {})
        for rank, (negscore, _tb, seg_idx, did) in enumerate(
                merged[offset:offset + k]):
            seg = self._searchers[seg_idx].segment
            key = seg.doc_keys[did]
            result.hits.append(Hit(id=key, score=-negscore,
                                   rank=offset + rank,
                                   data=docs_store.get(key, {})))
        return result

    # host-path routing: total postings per call below which the native
    # TAAT scorer serves the call (the JAX package's threshold and
    # variable, database.py:870-874)
    HOST_MAX_WORK = int(__import__("os").environ.get(
        "XT_HOST_MAX_WORK", "8000000"))

    def _use_host_path(self, cqs, scheme, sort=(), aggs=None,
                       collapse_slot=None) -> bool:
        """True when every query in the call is host-eligible and the
        summed postings work is below the device-crossover threshold."""
        from xapiand_tpu_torch.ops.host_scorer import (host_eligible,
                                                 host_path_enabled)

        if not host_path_enabled() or not self._searchers:
            return False
        # the native global top-k hard-codes the plain (seg, docid)
        # insertion-order tiebreak; subclasses with their own rank order
        # (ShardedDatabase's global sequence) keep their own paths
        if type(self)._tiebreak is not Database._tiebreak:
            return False
        if not isinstance(cqs, list):
            cqs = [cqs]
        if not all(host_eligible(cq, scheme, sort, aggs, collapse_slot)
                   for cq in cqs):
            return False
        work = sum(self.global_termfreq(pt.term)
                   for cq in cqs for pt in cq.terms)
        return work * max(len(self._searchers), 1) <= self.HOST_MAX_WORK

    def try_search_host(self, query, k: int = 10, offset: int = 0,
                        scheme=None):
        """Serving fast path: run the query on the native host scorer if
        it is host-eligible, else return None (caller takes the full
        search() route). One resolve+compile, no device contact.

        Host-plan cache: resolve_special + compile_ir + term_constants +
        the per-segment (offset, length) matrix all derive only from
        (ir, scheme, index state). Cached per IR object identity, keyed
        on the same (revision, host_epoch, segments) state as the global
        scorer."""
        if scheme is None:
            scheme = self.scheme
        elif isinstance(scheme, str):
            scheme = get_scheme(scheme)
        ir = query if isinstance(query, Q) else \
            QueryDSL(self.schema, term_expander=self.expand_prefix).parse(query)
        stats = self.stats()
        state = (self.revision, getattr(self, "_host_epoch", 0),
                 len(self._searchers), scheme.key())
        cache = getattr(self, "_host_plan_cache", None)
        if cache is None:
            cache = self._host_plan_cache = {}
        ent = cache.get(id(ir))
        if ent is not None and ent[0] is ir and ent[1] == state:
            plan = ent[2]
            if plan is None:      # remembered ineligible
                return None
            cq, tc, offs, lens = plan
            g = self._host_global_scorer()
            out = g.search_planned(cq, tc, offs, lens, scheme, stats,
                                   k + offset)
            return self._host_hits(g, out, k, offset)
        rir = resolve_special(ir, scheme, stats, self.global_termfreq,
                              self.global_collfreq)
        cq = compile_ir(rir, cost_fn=self.global_termfreq)
        if len(cache) >= 2048:
            for old in list(cache)[:1024]:
                cache.pop(old, None)
        if not self._use_host_path(cq, scheme):
            cache[id(ir)] = (ir, state, None)
            return None
        from xapiand_tpu_torch.ops.host_scorer import term_constants
        tc = term_constants(cq, scheme, stats, self.global_termfreq,
                            self.global_collfreq)
        g = self._host_global_scorer()
        offs, lens = g.plan_terms(cq)
        cache[id(ir)] = (ir, state, (cq, tc, offs, lens))
        out = g.search_planned(cq, tc, offs, lens, scheme, stats,
                               k + offset)
        return self._host_hits(g, out, k, offset)

    def _host_hits(self, g, out, k: int, offset: int):
        """Assemble a SearchResult from one global-scorer output row."""
        docs_store = getattr(self, "_docs_store", {})
        result = SearchResult(total=int(out["count"]))
        scores, segs_a, dids = out["scores"], out["seg"], out["docids"]
        for rank in range(offset, k + offset):
            if rank >= len(scores) or scores[rank] == float("-inf"):
                break
            seg = g.segs[int(segs_a[rank])]
            key = seg.doc_keys[int(dids[rank])]
            result.hits.append(Hit(id=key, score=float(scores[rank]),
                                   rank=rank,
                                   data=docs_store.get(key, {})))
        return result

    def _host_global_scorer(self):
        """Cached whole-database native scorer; invalidated on commit
        (revision) and on deletes (_host_epoch)."""
        from xapiand_tpu_torch.ops.host_scorer import GlobalHostScorer

        key = (self.revision, getattr(self, "_host_epoch", 0),
               len(self._searchers))
        g = getattr(self, "_host_global", None)
        if g is None or g._key != key:
            g = GlobalHostScorer(self._searchers)
            g._key = key
            self._host_global = g
        return g

    def _search_host(self, cqs: list, k: int, offset: int, stats, scheme,
                     count_only: bool = False) -> list:
        """Native latency path: one xt_score_topk_global crossing for the
        whole call, already globally merged (score desc, (seg, docid) asc
        = the device path's merge contract)."""
        from xapiand_tpu_torch.ops.host_scorer import term_constants

        want = k + offset
        tcs = [term_constants(cq, scheme, stats, self.global_termfreq,
                              self.global_collfreq) for cq in cqs]
        g = self._host_global_scorer()
        outs = g.search_many(cqs, tcs, scheme, stats,
                             1 if count_only else want)
        docs_store = getattr(self, "_docs_store", {})
        results = []
        for qi, out in enumerate(outs):
            result = SearchResult(total=int(out["count"]))
            if not count_only:
                scores, segs_a, dids = \
                    out["scores"], out["seg"], out["docids"]
                for rank in range(offset, want):
                    if rank >= len(scores) or scores[rank] == float("-inf"):
                        break
                    seg = g.segs[int(segs_a[rank])]
                    key = seg.doc_keys[int(dids[rank])]
                    result.hits.append(Hit(id=key, score=float(scores[rank]),
                                           rank=rank,
                                           data=docs_store.get(key, {})))
            results.append(result)
        return results

    def _collapse_key(self, seg, slot: int, did: int):
        """Cross-segment-comparable collapse key for a doc, or None when
        the doc has no value in the slot (uncollapsed, Xapian semantics)."""
        col = seg.values.get(slot)
        if col is None or not col.present[did]:
            return None
        if col.cats is not None and getattr(col, "cat_names", None) \
                and col.cats[did] >= 0:
            # category codes are segment-local; compare by name
            return ("cat", col.cat_names[int(col.cats[did])])
        return ("v", int(col.hi[did]), int(col.lo[did]))

    def _recollapse(self, merged, slot: int, cmax: int):
        seen: dict = {}
        out = []
        for item in merged:
            seg_idx, did = item[2], item[3]
            key = self._collapse_key(self._searchers[seg_idx].segment,
                                     slot, did)
            if key is None:
                out.append(item)
                continue
            c = seen.get(key, 0)
            if c < cmax:
                seen[key] = c + 1
                out.append(item)
        return out

    def _merge_sorted(self, merged, sort):
        import math as _math

        def sort_key(item):
            _, tiebreak, seg_idx, did = item
            seg = self._searchers[seg_idx].segment
            keys = []
            for spec in sort:
                kind, slot, desc = spec[0], spec[1], spec[2]
                col = seg.values.get(slot) if kind != "score" else None
                present = col is not None and bool(col.present[did])
                if kind == "value":
                    if not present:
                        keys.append((1, 0, 0))
                    else:
                        h, l = int(col.hi[did]), int(col.lo[did])
                        if desc:
                            h, l = ~h, ~l
                        keys.append((0, h, l))
                elif kind == "dist":
                    kf = abs(float(col.fval[did]) - spec[3]) if present \
                        else _math.inf
                    keys.append((0, -kf if desc else kf, 0))
                elif kind == "geodist":
                    if present:
                        from xapiand_tpu_torch.geo.cartesian import \
                            haversine_meters
                        lon = float(col.fval2[did]) \
                            if col.fval2 is not None else 0.0
                        kf = haversine_meters(float(col.fval[did]), lon,
                                              spec[3][0], spec[3][1])
                    else:
                        kf = _math.inf
                    keys.append((0, -kf if desc else kf, 0))
                elif kind == "strmetric":
                    from xapiand_tpu_torch.utils import strmetrics
                    metric, target = spec[3]
                    if present and col.cats is not None \
                            and col.cats[did] >= 0:
                        nm = col.cat_names[int(col.cats[did])]
                        kf = 1.0 - strmetrics.similarity(str(nm), target,
                                                         metric)
                    else:
                        kf = _math.inf
                    keys.append((0, -kf if desc else kf, 0))
                else:
                    keys.append((0, item[0], 0))
            keys.append(tiebreak)
            return tuple(keys)

        return sorted(merged, key=sort_key)

    def _tiebreak(self, seg_idx: int, did: int):
        """Equal-score (or equal-sort-key) rank order: segment order then
        docid = insertion order on a single node. ShardedDatabase overrides
        with the global insertion sequence so sharded and unsharded indexes
        rank ties identically (stricter than the reference, where tie order
        follows the docid striping and so changes with num_shards)."""
        return (seg_idx, did)

    def count(self, query: Any) -> int:
        return self.search(query, count_only=True).total

    def search_many(self, queries: list, k: int = 10, offset: int = 0,
                    scheme: Optional[Any] = None) -> list:
        """Batched plain relevance search: many queries, few device
        launches. Each segment runs the whole list through BatchSearcher
        (shape-bucketed batches); per-query results then merge across
        segments exactly like search(). Plain top-k only: queries needing
        sort/aggs/collapse/count_only take search().
        """
        from xapiand_tpu_torch.search import BatchSearcher

        if scheme is None:
            scheme = self.scheme
        elif isinstance(scheme, str):
            scheme = get_scheme(scheme)
        stats = self.stats()
        irs = []
        for q in queries:
            irs.append(q if isinstance(q, Q) else
                       QueryDSL(self.schema,
                                term_expander=self.expand_prefix).parse(q))
        # host latency path for small plain batches (see search()): the
        # native TAAT scorer below HOST_MAX_WORK postings
        cqs = [compile_ir(resolve_special(ir, scheme, stats,
                                          self.global_termfreq,
                                          self.global_collfreq),
                          cost_fn=self.global_termfreq) for ir in irs]
        if self._use_host_path(cqs, scheme):
            return self._search_host(cqs, k=k, offset=offset, stats=stats,
                                     scheme=scheme)
        want = k + offset
        per_seg = []
        for searcher in self._searchers:
            bs = BatchSearcher(searcher, k=want, min_batch=4,
                               scheme=scheme,
                               prefix_cap=self.prefix_cap,
                               global_tf=self.global_termfreq,
                               global_cf=self.global_collfreq)
            per_seg.append(bs.run(irs, stats=stats))
        results = []
        docs_store = getattr(self, "_docs_store", {})
        for qi in range(len(irs)):
            total = 0
            merged: list = []
            for seg_idx, outs in enumerate(per_seg):
                out = outs[qi]
                total += int(out["count"])
                seg = self._searchers[seg_idx].segment
                for sc, did in zip(out["scores"], out["docids"]):
                    if sc == float("-inf"):
                        continue
                    did = int(did)
                    if did >= seg.num_docs or seg.deleted[did]:
                        continue
                    merged.append((-float(sc),
                                   self._tiebreak(seg_idx, did),
                                   seg_idx, did))
            merged.sort()
            result = SearchResult(total=total)
            for rank, (negscore, _tb, seg_idx, did) in enumerate(
                    merged[offset:offset + k]):
                key = self._searchers[seg_idx].segment.doc_keys[did]
                result.hits.append(Hit(id=key, score=-negscore,
                                       rank=offset + rank,
                                       data=docs_store.get(key, {})))
            results.append(result)
        return results

    # -- left out: each refused by name ---------------------------------------

    def cluster_hits(self, doc_ids: list, k: int = 3, iters: int = 20):
        _refuse("cluster_hits: spherical k-means (ops/cluster.py "
                "kmeans_cosine, K20)", "queue 1 item 6")

    def diversify(self, result, k=None, lam: float = 0.5):
        _refuse("diversify (ops/cluster.py diversify_mmr, with K20)",
                "queue 1 item 6")

    def expand_terms(self, doc_ids, n_terms: int = 20, scheme: str = "bo1",
                     expand_k: float = 1.0):
        _refuse("expand_terms: relevance-feedback expansion",
                "queue 1 item 5, REST with persistence")

    def find_similar(self, doc_id: str, k: int = 10, n_terms: int = 20,
                     scheme: str = "bo1", expand_k: float = 1.0):
        _refuse("find_similar (expand_terms)",
                "queue 1 item 5, REST with persistence")

    def add_spelling(self, word: str, freqinc: int = 1):
        _refuse("the spelling store", "queue 1 item 5, REST with "
                "persistence")

    remove_spelling = suggest_spelling = add_spelling

    def add_synonym(self, term: str, synonym: str):
        _refuse("the synonym store", "queue 1 item 5, REST with "
                "persistence")

    remove_synonym = synonyms_of = expand_stored_synonyms = add_synonym

    def expand_prefix(self, prefix: str, limit: int = 256) -> list[str]:
        """All index terms starting with prefix (wildcard expansion,
        ≙ glass spelling/allterms cursor scans)."""
        out: set[str] = set()
        for s in self._searchers:
            seg = s.segment
            cache = getattr(seg, "_sorted_terms", None)
            if cache is None:
                cache = sorted(seg.terms.keys())
                seg._sorted_terms = cache
            import bisect

            i = bisect.bisect_left(cache, prefix)
            while i < len(cache) and cache[i].startswith(prefix):
                out.add(cache[i])
                if len(out) >= limit:
                    break
                i += 1
        return sorted(out)


# -- state carried across from a JAX Database --------------------------------

def from_jax_state(segments: list, schema: dict, docs: dict,
                   locate: dict, scheme: str = "bm25", device=None,
                   versions: Optional[dict] = None,
                   revision: int = 0) -> Database:
    """A port Database holding a JAX Database's committed state.

    segments: per committed segment a dict of the host Segment's fields
    (numpy arrays and plain values; ``terms`` a dict term -> the TermInfo
    fields as a tuple, or anything ``models/segment.py terms_from``
    reads; ``values`` / ``geo`` dicts of column field dicts); schema:
    ``Schema.to_dict()``; docs: the document store (doc id -> data);
    locate: doc id -> (segment index, docid). The segments' delete
    bitmaps are copied, so later edits on either side stay apart."""
    import dataclasses

    from xapiand_tpu_torch.models.segment import (GeoColumn, Segment,
                                                  TermInfo, ValueColumn,
                                                  terms_from)

    def build(cls, fields: dict, **over):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{**{k: v for k, v in fields.items() if k in names},
                      **over})

    db = Database(scheme=scheme, schema=Schema.from_dict(schema),
                  device=device)
    for fields in segments:
        terms = fields["terms"]
        if isinstance(terms, dict) and terms and \
                isinstance(next(iter(terms.values())), tuple):
            terms = {t: TermInfo(*raw) for t, raw in terms.items()}
        else:
            terms = terms_from(terms)
        seg = build(Segment, fields, terms=terms,
                    deleted=np.array(fields["deleted"], np.bool_),
                    values={s: build(ValueColumn, c)
                            for s, c in fields.get("values", {}).items()},
                    geo={s: build(GeoColumn, g)
                         for s, g in fields.get("geo", {}).items()})
        db._searchers.append(SegmentSearcher(seg, db.scheme,
                                             device=db.device))
    db._docs_store = dict(docs)
    db._locate = {str(k): (int(s), int(d)) for k, (s, d) in locate.items()}
    db._versions = dict(versions or {k: 1 for k in db._locate})
    db.revision = revision
    return db
