"""Conjunctive host query executor: native AND-tree matching with
predicate leaves, single-key sorts and flat aggregations.

Gather-bound faceted / geo+time queries are where the device pipeline
pays ~30 serialized cycles per randomly-touched element (value sort keys,
agg fields, HTM doc ranges - CLAUDE.md chip measurements), while the
candidate set after an AND is small and the columns are cache-resident on
the host. This module routes such queries to native.cpp xt_query_exec:
walk the smallest conjunct's postings, verify the rest by binary search,
apply MultipleValueRange / HTM-overlap predicates exactly, accumulate agg
sufficient statistics, and rank with the engine's exact tie contract.

~ the reference's DAAT matcher + AND ordering
(src/xapian/matcher/matcher.cc:179-560,
queryoptimiser.cc) re-shaped for flat immutable arrays; results are
indistinguishable from the device executor's (same counts, ranks, agg
partial structures), so Database.search's merge/shaping layers need no
changes.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from xapiand_tpu_torch.models.weights import BM25
from xapiand_tpu_torch.utils import serialise as ser

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_NULL_I32 = ctypes.cast(None, _i32p)

_STAT_KINDS = ("sum", "avg", "min", "max", "variance", "std_deviation",
               "stats", "extended_stats")


def conjunctive_parts(tree):
    """Flatten a conjunctive tree -> (pos_entries, neg_entries, f_leaves,
    geo_leaves, ph_leaves) or None when the tree is not a pure
    conjunction the native executor implements. Each pos/neg entry is a
    TUPLE of group ids: a 1-tuple is a plain term-group conjunct, a
    wider tuple is a disjunction of groups (an OR leaf inside the AND) -
    marshalled as one native group, whose hit rule (any term present)
    and scoring (every matching scoring term adds) are exactly the
    device tree's OR semantics."""
    pos, neg, fs, geos, phs = [], [], [], [], []

    def disjunct_groups(t):
        """-> tuple of group ids for an OR-of-groups subtree, or None."""
        gids = []
        for c in t[1:]:
            if c[0] == "G":
                gids.append(c[1])
            elif c[0] == "OR":
                sub = disjunct_groups(c)
                if sub is None:
                    return None
                gids.extend(sub)
            else:
                return None
        return tuple(gids)

    def walk(t, negate=False):
        op = t[0]
        if op == "ALL" and not negate:
            return True
        if op == "G":
            (neg if negate else pos).append((t[1],))
            return True
        if op == "F" and not negate:
            fs.append(t[1])
            return True
        if op == "GEO" and not negate:
            geos.append(t[1])
            return True
        if op == "PH" and not negate:
            phs.append(t[1])
            return True
        if op == "AND" and not negate:
            return all(walk(c) for c in t[1:])
        if op == "AND_NOT" and not negate:
            return walk(t[1]) and walk(t[2], negate=True)
        if op == "OR" and negate:
            # NOT(OR(a, b)) == NOT a AND NOT b
            return all(walk(c, True) for c in t[1:])
        if op == "OR" and not negate:
            gids = disjunct_groups(t)
            if gids is None:
                return False
            pos.append(gids)
            return True
        return False

    if not walk(tree):
        return None
    return pos, neg, fs, geos, phs


def conj_eligible(cq, scheme, sort=(), aggs=(), collapse_slot=None):
    """-> flattened parts when the native executor serves this compiled
    query exactly, else None. Phrase/NEAR leaves are conjunctive too:
    their term groups join the positive conjuncts and the positional
    check runs exactly (no pmax/cand caps on the host)."""
    if collapse_slot is not None or cq.synonyms \
            or cq.max_specs or cq.dense:
        return None
    scoring = any(pt.scoring for pt in cq.terms)
    if scoring and not (type(scheme) is BM25 and scheme.k2 == 0):
        return None
    if sort:
        if len(sort) != 1 or sort[0][0] != "value":
            return None
    for spec in aggs or ():
        kind = spec[0]
        if kind == "count":
            continue
        if kind == "terms" and (len(spec) < 4 or not spec[3]):
            continue
        if kind in _STAT_KINDS:
            continue
        return None
    parts = conjunctive_parts(cq.tree)
    if parts is None:
        return None
    pos, neg, fs, geos, phs = parts
    for pi in phs:
        # a phrase's term groups are implicit positive conjuncts
        pos.extend((g,) for g in cq.phrases[pi][1])
    pos = list(dict.fromkeys(pos))    # dedupe: a group scores once
    if not pos:
        return None
    if len(pos) < 2 and not (fs or geos or neg or phs):
        return None   # plain ORs belong to the flat scorer path
    return pos, neg, fs, geos, phs


def ph_leaves_gate(parts, driver_w) -> bool:
    """True = decline: positional queries with a WIDE driver conjunct are
    the one conjunctive shape where the vectorized device batch still
    wins (cfg2 A/B: common-word phrases with ~94k-posting drivers at
    100k docs dominated the host mean, 152 qps vs the device's wide
    vmapped position kernels); light phrases stay host."""
    phs = parts[4] if len(parts) > 4 else ()
    if not phs:
        return False
    cap = int(os.environ.get("XT_HOST_PHRASE_MAX", "4096"))
    return (driver_w or 0) > cap


class HostQueryExecutor:
    """One per Segment: registers the flat arrays with the native side
    once, then executes conjunctive queries with single ctypes crossings."""

    def __init__(self, segment):
        import threading

        from xapiand_tpu_torch.native import lib

        assert lib is not None
        self._c = lib._c
        self.seg = segment
        # the native QSeg owns per-executor scratch (seen/touched/acc) and
        # xt_query_exec releases the GIL (ctypes) - concurrent pool
        # readers on the same segment MUST serialize the native call or
        # results silently corrupt (found by tests/test_concurrent_reads)
        self._lock = threading.RLock()   # re-entrant: builders nest
        self._keep = []   # keep numpy arrays alive for registered pointers

        def hold(a, dt):
            a = np.ascontiguousarray(a, dt)
            self._keep.append(a)
            return a

        self._docids = hold(segment.post_docids, np.int32)
        self._wdf = hold(segment.post_wdf, np.float32)
        self._doclen = hold(segment.post_doclen, np.float32)
        self._deleted = hold(
            segment.deleted.view(np.uint8)
            if segment.deleted.dtype == np.bool_ else
            segment.deleted.astype(np.uint8), np.uint8)
        self.has_deletes = bool(segment.deleted[: segment.num_docs].any())
        self._h = self._c.xt_qseg_new(
            self._docids.ctypes.data_as(_i32p),
            self._wdf.ctypes.data_as(_f32p),
            self._doclen.ctypes.data_as(_f32p),
            self._deleted.ctypes.data_as(_u8p),
            1 if self.has_deletes else 0,
            max(int(segment.num_docs), 1))
        self._registered_slots: set = set()
        self._registered_geo: set = set()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._c.xt_qseg_free(h)

    def refresh_deleted(self):
        """Deletes flip entries in the registered bitmap in place (numpy
        view shares memory with segment.deleted) - only the has_deletes
        flag needs recomputation, which happens per run() below."""

    def _ensure_bigrams(self):
        """Build (once) the derived bigram/nextword table from the
        position arrays; -> the table's minlen (0 = every pair indexed)
        or None when bigrams are unavailable. A 2-term exact phrase whose
        terms both have posting length >= minlen is then answered from a
        plain docid list - no per-candidate positional verification (the
        measured cfg2 bottleneck; ~ nextword indexes, no reference
        analog: phrasepostlist.cc re-verifies positions per candidate)."""
        if hasattr(self, "_bigram_minlen"):
            return self._bigram_minlen
        with self._lock:
            return self._build_bigrams()

    def _build_bigrams(self):
        if hasattr(self, "_bigram_minlen"):   # double-checked under lock
            return self._bigram_minlen
        self._bigram_minlen = None
        if os.environ.get("XT_BIGRAM", "1") == "0":
            return None
        seg = self.seg
        total = int(seg.positions.size)
        if not total:
            return None
        self._ensure_positions()
        nt = len(seg.terms)
        if not nt:
            return None
        cols = getattr(seg.terms, "cols", None)
        if cols is not None:
            # native-export stat columns: no TermInfo materialization
            offsets, cf_col, _mw, _mp = cols
            offs = np.asarray(offsets[:nt], np.int64)
            lens = np.asarray(offsets[1:nt + 1], np.int64) - offs
        else:
            terms = list(seg.terms.values())
            offs = np.fromiter((t.offset for t in terms), np.int64, nt)
            lens = np.fromiter((t.length for t in terms), np.int64, nt)
        cap = int(os.environ.get("XT_BIGRAM_MAX_OCC", "48000000"))
        minlen = 0
        if total > cap:
            # index only heavy terms: smallest posting-length cutoff
            # whose occurrence mass fits the cap (light phrases verify
            # positionally at trivial cost anyway)
            occ = cf_col[:nt] if cols is not None else \
                np.fromiter((t.collfreq for t in terms), np.int64, nt)
            order = np.argsort(-lens, kind="stable")
            mass = np.cumsum(occ[order])
            hi = int(np.searchsorted(mass, cap, side="right"))
            if hi == 0:
                return None
            minlen = int(lens[order[hi - 1]])
            if minlen <= 1:
                return None
        npairs = self._c.xt_qseg_build_bigrams(
            self._h, offs.ctypes.data_as(_i64p),
            lens.ctypes.data_as(_i64p), nt, minlen)
        if npairs < 0:
            return None
        self._bigram_minlen = minlen
        return minlen

    def _ensure_positions(self):
        if getattr(self, "_pos_registered", False):
            return
        with self._lock:
            if getattr(self, "_pos_registered", False):
                return
            self._register_positions()

    def _register_positions(self):
        def hold(a, dt):
            a = np.ascontiguousarray(a, dt)
            self._keep.append(a)
            return a

        self._c.xt_qseg_set_positions(
            self._h,
            hold(self.seg.post_posoff, np.int32).ctypes.data_as(_i32p),
            hold(self.seg.post_poslen, np.int32).ctypes.data_as(_i32p),
            hold(self.seg.positions, np.int32).ctypes.data_as(_i32p))
        self._pos_registered = True

    def _ensure_valcol(self, slot: int) -> bool:
        if slot in self._registered_slots:
            return True
        col = self.seg.values.get(slot)
        if col is None:
            return False
        with self._lock:
            if slot in self._registered_slots:
                return True
            return self._register_valcol(slot, col)

    def _register_valcol(self, slot: int, col) -> bool:
        def hold(a, dt):
            a = np.ascontiguousarray(a, dt)
            self._keep.append(a)
            return a

        present = hold(col.present.view(np.uint8)
                       if col.present.dtype == np.bool_
                       else col.present.astype(np.uint8), np.uint8)
        hi = hold(col.hi, np.int32)
        lo = hold(col.lo, np.int32)
        max_hi = hold(col.max_hi, np.int32)
        max_lo = hold(col.max_lo, np.int32)
        fval = hold(col.fval, np.float32)
        cats = hold(col.cats, np.int32) if col.cats is not None else None
        ncats = len(col.cat_names or []) if col.cats is not None else 0
        if col.mv_hi is not None:
            mv_off = hold(col.mv_off, np.int32)
            mv_len = hold(col.mv_len, np.int32)
            mv_hi = hold(col.mv_hi, np.int32)
            mv_lo = hold(col.mv_lo, np.int32)
        else:
            mv_off = mv_len = mv_hi = mv_lo = None
        self._c.xt_qseg_add_valcol(
            self._h, slot, present.ctypes.data_as(_u8p),
            hi.ctypes.data_as(_i32p), lo.ctypes.data_as(_i32p),
            max_hi.ctypes.data_as(_i32p), max_lo.ctypes.data_as(_i32p),
            fval.ctypes.data_as(_f32p),
            cats.ctypes.data_as(_i32p) if cats is not None else _NULL_I32,
            ncats,
            mv_off.ctypes.data_as(_i32p) if mv_off is not None
            else _NULL_I32,
            mv_len.ctypes.data_as(_i32p) if mv_len is not None
            else _NULL_I32,
            mv_hi.ctypes.data_as(_i32p) if mv_hi is not None
            else _NULL_I32,
            mv_lo.ctypes.data_as(_i32p) if mv_lo is not None
            else _NULL_I32)
        self._registered_slots.add(slot)
        return True

    def _ensure_geocol(self, slot: int) -> bool:
        if slot in self._registered_geo:
            return True
        gcol = self.seg.geo.get(slot)
        if gcol is None:
            return False
        with self._lock:
            if slot in self._registered_geo:
                return True
            return self._register_geocol(slot, gcol)

    def _register_geocol(self, slot: int, gcol) -> bool:
        def hold(a, dt):
            a = np.ascontiguousarray(a, dt)
            self._keep.append(a)
            return a

        self._c.xt_qseg_add_geocol(
            self._h, slot,
            hold(gcol.doc_off, np.int32).ctypes.data_as(_i32p),
            hold(gcol.doc_len, np.int32).ctypes.data_as(_i32p),
            hold(gcol.flat_start, np.int32).ctypes.data_as(_i32p),
            hold(gcol.flat_end, np.int32).ctypes.data_as(_i32p))
        self._registered_geo.add(slot)
        return True

    def driver_work(self, cq, parts) -> int:
        """Postings walked by the cheapest positive conjunct here (a
        disjunctive entry walks the union of its groups' postings)."""
        pos = parts[0]
        best = None
        for entry in pos:
            w = 0
            for pt in cq.terms:
                if pt.group in entry:
                    ti = self.seg.get_term(pt.term)
                    w += ti.length if ti else 0
            best = w if best is None else min(best, w)
        return best or 0

    def run(self, cq, parts, scheme, stats, tconst, k: int,
            sort=(), aggs=(), count_only: bool = False) -> Optional[dict]:
        """Execute one conjunctive query -> device-shaped out dict, or
        None when a referenced column is missing on this segment (caller
        falls back to the device path)."""
        prep = self.prepare(cq, parts, tconst, sort=sort, aggs=aggs)
        if prep is None:
            return None
        return self.exec_prepared(prep, scheme, stats, k,
                                  count_only=count_only)

    def prepare(self, cq, parts, tconst, sort=(), aggs=()):
        """Marshal one conjunctive query into the native call's arrays -
        the cacheable half of run() (~0.8ms/segment of pure-python work
        per served facet request before round 5 cached it). Returns None
        when this segment must fall back to the device path; the result
        is immutable and reusable for any (k, count_only, stats) as long
        as the segment and tconst stay valid (callers key their caches
        on the database mutation state)."""
        pos, neg, f_leaves, geo_leaves, ph_leaves = parts
        seg = self.seg

        # group layout: positives then negatives, dedup of NON-scoring
        # duplicate terms within a group (geo accuracy covers repeat
        # terms; scoring dupes must stay - the device double-adds them).
        # flat_of maps cq term indices -> flat slots (phrase marshalling)
        t_off, t_len, t_tc = [], [], []
        g_start, g_nterms, g_neg = [], [], []
        driver_g, driver_w = 0, None
        flat_of: dict = {}
        for gi, (entry, is_neg) in enumerate(
                [(e, 0) for e in pos] + [(e, 1) for e in neg]):
            g_start.append(len(t_off))
            seen_terms: dict = {}
            gw = 0
            for ti_idx, pt in enumerate(cq.terms):
                if pt.group not in entry:
                    continue
                if not pt.scoring and pt.term in seen_terms:
                    flat_of[ti_idx] = seen_terms[pt.term]
                    continue
                seen_terms[pt.term] = len(t_off)
                flat_of[ti_idx] = len(t_off)
                ti = seg.get_term(pt.term)
                off, ln = (ti.offset, ti.length) if ti is not None \
                    else (0, 0)
                t_off.append(off)
                t_len.append(ln)
                t_tc.append(float(tconst[ti_idx]))
                gw += ln
            g_nterms.append(len(t_off) - g_start[-1])
            g_neg.append(is_neg)
            if not is_neg and (driver_w is None or gw < driver_w):
                driver_w, driver_g = gw, gi
        # phrases the bigram table resolves need no positional work, so
        # only "hard" (positionally-verified) phrase leaves can force the
        # wide-driver query back to the device batch
        bg_minlen = self._ensure_bigrams() if ph_leaves else None
        hard_phrases = False
        for pi in ph_leaves:
            term_idxs, _gids, _window, is_phrase = cq.phrases[pi]
            ok_bg = (bg_minlen is not None and is_phrase
                     and len(term_idxs) == 2)
            if ok_bg and bg_minlen > 0:
                for t in term_idxs:
                    ti = seg.get_term(cq.terms[t].term)
                    if ti is None or ti.length < bg_minlen:
                        ok_bg = False
                        break
            if not ok_bg:
                hard_phrases = True
                break
        if hard_phrases and ph_leaves_gate(parts, driver_w):
            return None   # wide-driver positional phrase: device wins

        # phrase / NEAR leaves: flat term-slot lists + positional arrays
        ph_start = np.zeros(max(len(ph_leaves), 1), np.int32)
        ph_nterms = np.zeros(max(len(ph_leaves), 1), np.int32)
        ph_window = np.zeros(max(len(ph_leaves), 1), np.int32)
        ph_exact = np.zeros(max(len(ph_leaves), 1), np.uint8)
        ph_tidx = []
        for j, pi in enumerate(ph_leaves):
            term_idxs, _gids, window, is_phrase = cq.phrases[pi]
            if len(term_idxs) > 16:      # native per-phrase term cap
                return None
            ph_start[j] = len(ph_tidx)
            ph_nterms[j] = len(term_idxs)
            ph_window[j] = int(window)
            ph_exact[j] = 1 if is_phrase else 0
            for t in term_idxs:
                if t not in flat_of:
                    return None
                ph_tidx.append(flat_of[t])
        ph_tidx_a = np.asarray(ph_tidx or [0], np.int32)
        if ph_leaves:
            self._ensure_positions()

        fp = np.zeros((max(len(f_leaves), 1), 4), np.int32)
        f_slots = np.zeros(max(len(f_leaves), 1), np.int32)
        for j, fi in enumerate(f_leaves):
            slot, lo, hi = cq.filters[fi]
            lo = 0 if lo is None else lo
            hi = (1 << 64) - 1 if hi is None else hi
            fp[j, 0], fp[j, 1] = ser.split_key(lo)
            fp[j, 2], fp[j, 3] = ser.split_key(hi)
            f_slots[j] = slot
            if not self._ensure_valcol(slot):
                return None

        geo_slots = np.zeros(max(len(geo_leaves), 1), np.int32)
        geo_qstart = np.zeros(max(len(geo_leaves), 1), np.int32)
        geo_qn = np.zeros(max(len(geo_leaves), 1), np.int32)
        granges = []
        at = 0
        for j, gi in enumerate(geo_leaves):
            slot, ranges = cq.geo[gi]
            geo_slots[j] = slot
            geo_qstart[j] = at
            geo_qn[j] = len(ranges)
            at += len(ranges)
            granges.extend(ranges)
            if not self._ensure_geocol(slot):
                return None
        granges_a = np.asarray(granges or [(0, 0)], np.int32)

        unweighted = not any(pt.scoring for pt in cq.terms)
        if sort:
            kind, slot_s, desc = sort[0][0], sort[0][1], sort[0][2]
            if not self._ensure_valcol(slot_s):
                return None
            sort_mode, sort_slot = (2 if desc else 1), slot_s
        elif unweighted:
            sort_mode, sort_slot = 3, -1
        else:
            sort_mode, sort_slot = 0, -1

        AGG_MAP = {"count": 0, "terms": 1}
        agg_kind = np.zeros(max(len(aggs), 1), np.int32)
        agg_slot = np.zeros(max(len(aggs), 1), np.int32)
        agg_off = np.zeros(max(len(aggs), 1), np.int64)
        sizes = []
        for j, spec in enumerate(aggs or ()):
            kind = spec[0]
            if kind == "count":
                agg_kind[j], agg_slot[j] = 0, -1
                sizes.append(1)
            elif kind == "terms":
                agg_kind[j], agg_slot[j] = 1, spec[1]
                if not self._ensure_valcol(spec[1]):
                    return None
                # device counts arrays are sized to the spec's pow2
                # category bucket (spec[2]); pad so partials merge 1:1
                sizes.append(int(spec[2]))
            else:                     # stats family
                agg_kind[j], agg_slot[j] = 2, spec[1]
                if not self._ensure_valcol(spec[1]):
                    return None
                sizes.append(5)
            agg_off[j] = sum(sizes[:-1])

        t_off_a = np.asarray(t_off, np.int64)
        t_len_a = np.asarray(t_len, np.int64)
        t_tc_a = np.asarray(t_tc, np.float64)
        g_start_a = np.asarray(g_start, np.int32)
        g_nterms_a = np.asarray(g_nterms, np.int32)
        g_neg_a = np.asarray(g_neg, np.uint8)
        return {
            "t_off": t_off_a, "t_len": t_len_a, "t_tc": t_tc_a,
            "g_start": g_start_a, "g_nterms": g_nterms_a, "g_neg": g_neg_a,
            "n_groups": len(g_start), "driver_g": driver_g,
            "f_slots": f_slots, "fp": fp, "n_f": len(f_leaves),
            "geo_slots": geo_slots, "geo_qstart": geo_qstart,
            "geo_qn": geo_qn, "granges": granges_a,
            "n_geo": len(geo_leaves),
            "sort_mode": sort_mode, "sort_slot": sort_slot,
            "ph_start": ph_start, "ph_nterms": ph_nterms,
            "ph_tidx": ph_tidx_a, "ph_window": ph_window,
            "ph_exact": ph_exact, "n_ph": len(ph_leaves),
            "agg_kind": agg_kind, "agg_slot": agg_slot,
            "agg_off": agg_off, "n_aggs": len(aggs or ()),
            "sizes": sizes, "aggs": aggs,
        }

    def exec_prepared(self, prep, scheme, stats, k: int,
                      count_only: bool = False) -> dict:
        """The per-request half: scratch allocation + ONE native crossing
        + output shaping. Thread-safe (the native scratch serializes on
        the executor lock)."""
        k1, b, mn, lf = _bm25_params(scheme, stats)
        kk = max(int(k), 1)
        out_d = np.full(kk, np.int32(2**31 - 1), np.int32)
        out_s = np.full(kk, -np.inf, np.float64)
        sizes = prep["sizes"]
        agg_out = np.zeros(max(int(sum(sizes)), 1), np.float64)
        agg_off = prep["agg_off"]
        with self._lock:
            matched = self._c.xt_query_exec(
                self._h,
                prep["t_off"].ctypes.data_as(_i64p),
                prep["t_len"].ctypes.data_as(_i64p),
                prep["t_tc"].ctypes.data_as(_f64p),
                prep["g_start"].ctypes.data_as(_i32p),
                prep["g_nterms"].ctypes.data_as(_i32p),
                prep["g_neg"].ctypes.data_as(_u8p),
                prep["n_groups"], prep["driver_g"], k1, b, mn, lf,
                prep["f_slots"].ctypes.data_as(_i32p),
                prep["fp"].ctypes.data_as(_i32p), prep["n_f"],
                prep["geo_slots"].ctypes.data_as(_i32p),
                prep["geo_qstart"].ctypes.data_as(_i32p),
                prep["geo_qn"].ctypes.data_as(_i32p),
                prep["granges"].ctypes.data_as(_i32p), prep["n_geo"],
                prep["sort_mode"], prep["sort_slot"],
                prep["ph_start"].ctypes.data_as(_i32p),
                prep["ph_nterms"].ctypes.data_as(_i32p),
                prep["ph_tidx"].ctypes.data_as(_i32p),
                prep["ph_window"].ctypes.data_as(_i32p),
                prep["ph_exact"].ctypes.data_as(_u8p), prep["n_ph"],
                prep["agg_kind"].ctypes.data_as(_i32p),
                prep["agg_slot"].ctypes.data_as(_i32p), prep["n_aggs"],
                0 if count_only else kk, 1 if count_only else 0,
                out_d.ctypes.data_as(_i32p), out_s.ctypes.data_as(_f64p),
                agg_out.ctypes.data_as(_f64p),
                agg_off.ctypes.data_as(_i64p))

        n = min(int(matched), kk)
        out_s[n:] = -np.inf
        out = {"count": int(matched), "docids": out_d, "scores": out_s}
        aggs = prep["aggs"]
        if aggs:
            shaped = []
            for j, spec in enumerate(aggs):
                o = int(agg_off[j])
                if spec[0] == "count":
                    shaped.append(int(matched))
                elif spec[0] == "terms":
                    shaped.append(agg_out[o: o + sizes[j]])
                else:
                    nn = agg_out[o]
                    shaped.append({
                        "n": nn, "s": agg_out[o + 1], "s2": agg_out[o + 2],
                        "min": agg_out[o + 3] if nn > 0 else np.inf,
                        "max": agg_out[o + 4] if nn > 0 else -np.inf})
            out["aggs"] = shaped
        return out

def _bm25_params(scheme, stats):
    if type(scheme) is not BM25:
        return 1.0, 0.5, 0.5, 0.0    # unweighted query: params unused
    avg = float(stats.avg_doclen)
    lf = 0.0
    if avg > 0 and not (scheme.k2 == 0
                        and (scheme.b == 0 or scheme.k1 == 0)):
        lf = 1.0 / max(avg, 1e-9)
    return scheme.k1, scheme.b, scheme.min_normlen, lf
