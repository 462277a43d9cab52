"""SegmentBuilder: accumulates analysed documents into a Segment.

Replaces the glass inverter/B-tree insert path
(src/xapian/backends/glass/glass_inverter.cc) with columnar accumulation +
one flat pack at finalize. Document length = sum of wdf over all terms,
matching Xapian document length semantics (used by BM25 normlen).
"""

from __future__ import annotations

import struct
from collections import defaultdict

import numpy as np

from xapiand_tpu_torch.analysis import accuracy as acc_mod
from xapiand_tpu_torch.analysis import termgen as tg_mod
from xapiand_tpu_torch.analysis.accuracy import DEF_ACC_DATE, DEF_ACC_NUMERIC
from xapiand_tpu_torch.analysis.stem import resolve_language
from xapiand_tpu_torch.models.segment import (GeoColumn, Segment, TermInfo,
                                        TermTable, ValueColumn, size_class)
from xapiand_tpu_torch.schema.schema import IndexedDocument
from xapiand_tpu_torch.utils import serialise as ser

_I32MAX = np.int32(2**31 - 1)


_PREFIX_BLOB_CACHE: dict = {}


def _prefix_blob(prefixes) -> bytes:
    """(u16 len + utf-8 bytes) per prefix, memoized: field prefixes repeat
    on every doc, so _pack_doc never re-encodes them."""
    key = tuple(prefixes)
    b = _PREFIX_BLOB_CACHE.get(key)
    if b is None:
        out = []
        for p in key:
            praw = p.encode("utf-8")
            out.append(struct.pack("<H", len(praw)))
            out.append(praw)
        b = _PREFIX_BLOB_CACHE[key] = b"".join(out)
    return b


def _materialize_acc_ops(idoc: IndexedDocument) -> None:
    """Run deferred numeric/date accuracy ops through the Python generators
    (used on the pure-Python path and the native per-call fallback); emits
    exactly the terms schema._emit_terms produces eagerly."""

    for num, accs, prefix in idoc.num_acc_ops:
        idoc.terms.add_boolean(prefix + ":" + ser.serialise_float_term(num))
        idoc.terms.add_booleans(acc_mod.numeric_terms(num, accs, prefix))
    idoc.num_acc_ops = []
    for ts, units, prefix in idoc.date_acc_ops:
        idoc.terms.add_boolean(prefix + ":" + ser.serialise_float_term(ts))
        idoc.terms.add_booleans(acc_mod.date_terms(ts, units, prefix))
    idoc.date_acc_ops = []


def _materialize_text_ops(idoc: IndexedDocument) -> None:
    """Run deferred text ops through the Python TermGenerator (used when a
    deferred document lands in a pure-Python builder)."""

    termpos = 0
    for (value, prefixes, language, stem_s, stop_s, weight,
         with_pos, pos_start, cjk, cjk_w) in idoc.text_ops:
        tg = tg_mod.TermGenerator(language, stem_strategy=stem_s,
                                  stop_strategy=stop_s, cjk_ngram=cjk,
                                  cjk_words=cjk_w)
        tg.position = max(termpos, pos_start)
        tg.index_text(idoc.terms, value, wdf_inc=weight, prefixes=prefixes,
                      with_positions=with_pos)
        tg.increase_termpos()
        termpos = tg.position
    idoc.text_ops = []


class SegmentBuilder:
    def __init__(self, native: bool = True):
        self._postings = defaultdict(list)   # term -> [(docid, wdf)]
        self._positions = defaultdict(list)  # term -> [(docid, [pos...])]
        self._doclen: list[float] = []
        self._values = defaultdict(dict)     # slot -> {docid: [values]}
        self._geo = defaultdict(dict)        # slot -> {docid: [(s,e)...]}
        self._doc_keys: list[str] = []
        self._collfreq = defaultdict(int)
        self._uniq: list[int] = []
        self._inv = None
        if native:
            from xapiand_tpu_torch.native import lib as _nlib

            if _nlib is not None and hasattr(_nlib._c, "xt_inv_new"):
                from xapiand_tpu_torch.analysis.stopwords import get_stopwords

                self._inv = _nlib.make_inverter(get_stopwords("english"))

    @property
    def wants_deferred_text(self) -> bool:
        """True when Schema.index should defer text analysis to add()'s
        native inverter (tokenise+stem+accumulate in C++)."""
        return self._inv is not None

    def __len__(self):
        return len(self._doc_keys)

    def add(self, idoc: IndexedDocument) -> int:
        if self._inv is not None:
            return self._add_native(idoc)
        if idoc.num_acc_ops or idoc.date_acc_ops:
            _materialize_acc_ops(idoc)
        if idoc.text_ops:
            _materialize_text_ops(idoc)
        if idoc.geo_acc_ops:
            for ranges, levels, prefix in idoc.geo_acc_ops:
                idoc.terms.add_booleans(
                    acc_mod.geo_terms(ranges, list(levels), prefix))
            idoc.geo_acc_ops = []
        docid = len(self._doc_keys)
        self._doc_keys.append(idoc.doc_id)
        # distinct terms incl. the id term (Xapian UNIQUE_TERMS = termlist
        # entry count; used by dicecoeff / LM absolute-discount smoothing)
        self._uniq.append(len(idoc.terms) + 1)
        length = 0
        for term, entry in idoc.terms.items():
            self._postings[term].append((docid, entry.wdf))
            self._collfreq[term] += entry.wdf
            length += entry.wdf
            if entry.positions:
                self._positions[term].append((docid, entry.positions))
        self._doclen.append(float(length))
        for slot, vals in idoc.values.items():
            if vals:
                self._values[slot][docid] = list(vals)
        for slot, ranges in idoc.geo_ranges.items():
            if ranges:
                self._geo[slot].setdefault(docid, []).extend(ranges)
        # the id term must exist so deletes/replaces can find the doc
        self._postings[idoc.id_term].append((docid, 0))
        return docid

    def _add_native(self, idoc: IndexedDocument) -> int:
        """Stream one analysed document through the C++ inverter: non-text
        terms via add_term, deferred text ops via index_text (which does
        tokenise+stem+per-doc accumulation natively); non-ASCII or
        non-English text ops fall back to the Python TermGenerator per op
        but still land their terms in the inverter."""
        inv = self._inv
        docid = len(self._doc_keys)
        if inv.can_add_doc:
            buf = self._pack_doc(idoc)
            if buf is not None:
                self._doc_keys.append(idoc.doc_id)
                doclen, uniq = inv.add_doc(docid, buf)
                self._doclen.append(float(doclen))
                self._uniq.append(int(uniq))
                for slot, vals in idoc.values.items():
                    if vals:
                        self._values[slot][docid] = list(vals)
                for slot, ranges in idoc.geo_ranges.items():
                    if ranges:
                        self._geo[slot].setdefault(docid, []).extend(ranges)
                return docid
        if idoc.num_acc_ops or idoc.date_acc_ops:
            _materialize_acc_ops(idoc)
        self._doc_keys.append(idoc.doc_id)
        inv.begin_doc(docid)
        # raw dict on purpose: .items() would fold bool_terms into it;
        # booleans ship in ONE bulk call below instead
        for term, entry in idoc.terms.terms.items():
            inv.add_term(term, float(entry.wdf), entry.positions or None)
        inv.add_bools(idoc.terms.bool_terms)
        idoc.terms.bool_terms = []
        if idoc.geo_acc_ops:
            from xapiand_tpu_torch.geo import htm

            for ranges, levels, prefix in idoc.geo_acc_ops:
                inv.add_geo_acc(ranges, levels, htm.MAX_LEVEL, prefix)
            idoc.geo_acc_ops = []
        termpos = 0
        for (value, prefixes, language, stem_s, stop_s, weight,
             with_pos, pos_start, cjk, cjk_w) in idoc.text_ops:
            base = max(termpos, pos_start)
            r = None
            lang = resolve_language(language)
            if lang in (None, "english"):
                # no language => TermGenerator forces stem none and an
                # empty stopword set; mirror that before going native
                eff_stem = stem_s if lang else tg_mod.STEM_NONE
                eff_stop = stop_s if lang else tg_mod.STOP_NONE
                r = inv.index_text(value, list(prefixes), base,
                                   float(weight), with_pos, eff_stem,
                                   eff_stop)
            if r is None:
                tg = tg_mod.TermGenerator(language, stem_strategy=stem_s,
                                          stop_strategy=stop_s,
                                          cjk_ngram=cjk, cjk_words=cjk_w)
                tg.position = base
                tmp = tg_mod.DocumentTerms()
                tg.index_text(tmp, value, wdf_inc=weight, prefixes=prefixes,
                              with_positions=with_pos)
                for term, entry in tmp.items():
                    inv.add_term(term, float(entry.wdf),
                                 entry.positions or None)
                r = tg.position
            termpos = r + 100   # ≙ tg.increase_termpos() between fields
        inv.add_term(idoc.id_term, 0.0, None)
        doclen, uniq = inv.end_doc()
        self._doclen.append(float(doclen))
        self._uniq.append(int(uniq))
        for slot, vals in idoc.values.items():
            if vals:
                self._values[slot][docid] = list(vals)
        for slot, ranges in idoc.geo_ranges.items():
            if ranges:
                self._geo[slot].setdefault(docid, []).extend(ranges)
        return docid

    _DATE_UNIT_ENUM = {"second": 0, "minute": 1, "hour": 2, "day": 3,
                       "month": 4, "year": 5, "decade": 6, "century": 7,
                       "millennium": 8}
    # packed-path timestamp window: year 1000..9999. Above it Python's
    # fromtimestamp raises; below it decade/century/millennium truncation
    # can land before year 1 and the Python oracle raises ValueError —
    # the C++ proleptic calendar wouldn't, so such ops take the Python
    # fallback to reproduce the oracle's behavior (including the raise)
    _TS_MIN, _TS_MAX = -30610224000.0, 253402300800.0

    def _pack_doc(self, idoc: IndexedDocument):
        """Serialise one analysed document into the xt_inv_add_doc buffer
        (native.cpp packed layout) for a SINGLE ctypes crossing; date and
        numeric accuracy terms are generated in C++ from the raw values
        (≙ the reference running GenerateTerms inside DocPreparer,
        handler.h:256-361). Returns None when any feature needs the
        per-call path (non-ASCII/non-English text, >16 prefixes);
        unpackable num/date ops degrade per-op via _materialize_acc_ops
        semantics instead."""
        from xapiand_tpu_torch.native import _STEM_MODES, _STOP_MODES

        pk = struct.pack
        parts = []
        ap = parts.append
        # TEXT sections (order preserved: termpos advances per section)
        for (value, prefixes, language, stem_s, stop_s, weight,
             with_pos, pos_start, cjk, cjk_w) in idoc.text_ops:
            text = str(value)
            if not text.isascii() or len(prefixes) > 16:
                return None
            lang = resolve_language(language)
            if lang not in (None, "english"):
                return None
            eff_stem = stem_s if lang else tg_mod.STEM_NONE
            eff_stop = stop_s if lang else tg_mod.STOP_NONE
            flags = ((1 if with_pos else 0)
                     | (_STEM_MODES[eff_stem] << 2)
                     | (_STOP_MODES[eff_stop] << 4))
            ap(pk("<BB", 3, len(prefixes)))
            ap(_prefix_blob(prefixes))
            raw = text.encode("ascii")
            ap(pk("<ifBI", int(pos_start), float(weight), flags, len(raw)))
            ap(raw)
        # plain weighted terms (+ positions)
        for term, entry in idoc.terms.terms.items():
            raw = term.encode("utf-8")
            pos = entry.positions or ()
            if len(raw) > 0xFFFF or len(pos) > 0xFFFF:
                return None
            ap(pk("<BH", 1, len(raw)))
            ap(raw)
            ap(pk("<fH", float(entry.wdf), len(pos)))
            if pos:
                ap(pk("<%di" % len(pos), *pos))
        # id term
        raw = idoc.id_term.encode("utf-8")
        ap(pk("<BH", 1, len(raw)))
        ap(raw)
        ap(pk("<fH", 0.0, 0))
        # numeric/date accuracy ops; ops the C++ generator can't reproduce
        # bit-identically spill into extra_bools (same strings as eager)
        extra_bools = []
        if idoc.num_acc_ops:
            groups = []
            for num, accs, prefix in idoc.num_acc_ops:
                eff = DEF_ACC_NUMERIC if accs is None else accs
                ok = (isinstance(num, (int, float))
                      and not isinstance(num, bool)
                      and (isinstance(num, float) or abs(num) <= 2**53)
                      and (not isinstance(num, float) or num == num)
                      and len(eff) <= 32
                      and all(isinstance(a, int) and not isinstance(a, bool)
                              and 0 < a < 2**62 for a in eff)
                      and abs(float(num)) < 2**62)
                if not ok:
                    extra_bools.append(
                        prefix + ":" + ser.serialise_float_term(num))
                    extra_bools.extend(
                        acc_mod.numeric_terms(num, accs, prefix))
                    continue
                if (groups and groups[-1][0] == num
                        and groups[-1][1] is accs):
                    groups[-1][2].append(prefix)
                else:
                    groups.append((num, accs, [prefix], eff))
            for num, _accs, prefs, eff in groups:
                ap(pk("<BdBB", 6, float(num), 1, len(eff)))
                ap(pk("<%dq" % len(eff), *eff))
                ap(pk("<B", len(prefs)))
                ap(_prefix_blob(prefs))
        if idoc.date_acc_ops:
            enum = self._DATE_UNIT_ENUM
            groups = []
            for ts, units, prefix in idoc.date_acc_ops:
                eff = DEF_ACC_DATE if units is None else units
                codes = [enum.get(u, -1) for u in eff]
                ok = (isinstance(ts, float) and ts == ts
                      and self._TS_MIN <= ts < self._TS_MAX
                      and len(codes) <= 255 and min(codes, default=0) >= 0)
                if not ok:
                    extra_bools.append(
                        prefix + ":" + ser.serialise_float_term(ts))
                    extra_bools.extend(acc_mod.date_terms(ts, units, prefix))
                    continue
                if (groups and groups[-1][0] == ts
                        and groups[-1][1] is units):
                    groups[-1][2].append(prefix)
                else:
                    groups.append((ts, units, [prefix], codes))
            for ts, _units, prefs, codes in groups:
                ap(pk("<BdBB%dB" % len(codes), 5, ts, 1, len(codes), *codes))
                ap(pk("<B", len(prefs)))
                ap(_prefix_blob(prefs))
        # booleans (chunked: u16 count per section)
        bools = idoc.terms.bool_terms
        if extra_bools:
            bools = bools + extra_bools
        for i in range(0, len(bools), 0xFFFF):
            chunk = bools[i:i + 0xFFFF]
            ap(pk("<BH", 2, len(chunk)))
            for t in chunk:
                raw = t.encode("utf-8")
                if len(raw) > 0xFFFF:
                    return None
                ap(pk("<H", len(raw)))
                ap(raw)
        # geo accuracy sections (one per distinct cover; prefixes grouped)
        if idoc.geo_acc_ops:
            from xapiand_tpu_torch.geo import htm
            groups = []
            for ranges, levels, prefix in idoc.geo_acc_ops:
                if (groups and groups[-1][0] is ranges
                        and groups[-1][1] == levels):
                    groups[-1][2].append(prefix)
                else:
                    groups.append((ranges, levels, [prefix]))
            for ranges, levels, prefs in groups:
                if (len(ranges) > 0xFFFF or not ranges or len(levels) > 255
                        or len(prefs) > 255
                        or any(not (0 <= int(lv) < 256) for lv in levels)):
                    return None
                ap(pk("<BH", 4, len(ranges)))
                for a, b in ranges:
                    ap(pk("<qq", int(a), int(b)))
                ap(pk("<B%dB" % len(levels), len(levels),
                      *[int(lv) for lv in levels]))
                ap(pk("<BB", htm.MAX_LEVEL, len(prefs)))
                ap(_prefix_blob(prefs))
        return b"".join(parts)

    # -- pack ------------------------------------------------------------------

    def finalize(self) -> Segment:
        if self._inv is not None:
            return self._finalize_native()
        nd = len(self._doc_keys)
        terms = sorted(self._postings.keys())
        total_post = sum(len(self._postings[t]) for t in terms)
        max_len = max((len(self._postings[t]) for t in terms), default=0)
        guard = size_class(max(max_len, 1))
        P = total_post + guard

        post_docids = np.full(P, nd, dtype=np.int32)  # pad -> dump row
        post_wdf = np.zeros(P, dtype=np.float32)
        post_posoff = np.zeros(P, dtype=np.int32)
        post_poslen = np.zeros(P, dtype=np.int32)

        # positions flat array
        pos_chunks = []
        pos_index = {}  # (term, docid) -> (off, len)
        pos_total = 0
        for term, entries in self._positions.items():
            for docid, plist in entries:
                pos_index[(term, docid)] = (pos_total, len(plist))
                pos_chunks.append(np.asarray(sorted(plist), dtype=np.int32))
                pos_total += len(plist)
        positions = (np.concatenate(pos_chunks) if pos_chunks
                     else np.zeros(0, dtype=np.int32))
        positions = np.concatenate(
            [positions, np.zeros(128, dtype=np.int32)])  # guard

        # one global pack instead of 2 numpy conversions per term: the
        # per-call overhead dominates with many small posting lists
        import itertools

        lens = np.fromiter((len(self._postings[t]) for t in terms),
                           dtype=np.int64, count=len(terms))
        offs = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        if total_post:
            flat = np.fromiter(
                itertools.chain.from_iterable(
                    itertools.chain.from_iterable(
                        self._postings[t] for t in terms)),
                dtype=np.float64, count=2 * total_post).reshape(-1, 2)
            post_docids[:total_post] = flat[:, 0].astype(np.int32)
            post_wdf[:total_post] = flat[:, 1].astype(np.float32)
            maxw = np.maximum.reduceat(flat[:, 1], offs[:-1]) \
                if len(terms) else np.zeros(0)
        else:
            maxw = np.zeros(len(terms))

        term_infos: dict[str, TermInfo] = {}
        for tid, term in enumerate(terms):
            off, L = int(offs[tid]), int(lens[tid])
            if term in self._positions:
                plist = self._postings[term]
                for k, (docid, _) in enumerate(plist):
                    pi = pos_index.get((term, docid))
                    if pi is not None:
                        post_posoff[off + k] = pi[0]
                        post_poslen[off + k] = pi[1]
            mp = int(post_poslen[off: off + L].max()) if L else 0
            term_infos[term] = TermInfo(
                tid=tid, offset=off, length=L,
                collfreq=self._collfreq.get(term, 0),
                max_wdf=float(maxw[tid]) if L else 0.0,
                max_poslen=mp)

        doclen = np.zeros(nd + 1, dtype=np.float32)
        uniqterms = np.ones(nd + 1, dtype=np.float32)
        if nd:
            doclen[:nd] = np.asarray(self._doclen, dtype=np.float32)
            uniqterms[:nd] = np.asarray(self._uniq, dtype=np.float32)
        deleted = np.zeros(nd + 1, dtype=bool)
        # denormalised per-posting doclen (see segment.py docstring)
        post_doclen = doclen[np.minimum(post_docids, nd)]

        values = {}
        for slot, per_doc in self._values.items():
            values[slot] = self._pack_value_column(slot, per_doc, nd)

        geo = {}
        for slot, per_doc in self._geo.items():
            geo[slot] = self._pack_geo_column(per_doc, nd)

        return Segment(
            num_docs=nd,
            total_doclen=float(sum(self._doclen)),
            post_docids=post_docids,
            post_wdf=post_wdf,
            post_doclen=post_doclen,
            post_posoff=post_posoff,
            post_poslen=post_poslen,
            positions=positions,
            doclen=doclen,
            deleted=deleted,
            terms=term_infos,
            values=values,
            geo=geo,
            doc_keys=list(self._doc_keys),
            guard=guard,
            uniqterms=uniqterms,
        )

    def _finalize_native(self) -> Segment:
        """Pack the C++ inverter's exported arrays into a Segment - the
        postings/positions/term-stats equivalents of the Python pack below,
        with the per-term loops replaced by one export call."""
        nd = len(self._doc_keys)
        ex = self._inv.export()
        nt = ex["n_terms"]
        total_post = ex["n_postings"]
        guard = size_class(max(int(ex["max_post_len"]), 1))
        P = total_post + guard
        post_docids = np.full(P, nd, dtype=np.int32)
        post_wdf = np.zeros(P, dtype=np.float32)
        post_posoff = np.zeros(P, dtype=np.int32)
        post_poslen = np.zeros(P, dtype=np.int32)
        post_docids[:total_post] = ex["docids"]
        post_wdf[:total_post] = ex["wdf"]
        post_posoff[:total_post] = ex["posoff"]
        post_poslen[:total_post] = ex["poslen"]
        positions = np.concatenate(
            [ex["positions"], np.zeros(128, dtype=np.int32)])  # guard

        term_infos = TermTable()
        buf = ex["term_buf"]
        cf_col = np.rint(ex["collfreq"][:nt]).astype(np.int64)
        if nt and total_post:
            mps = np.maximum.reduceat(
                ex["poslen"], np.minimum(ex["offsets"][:nt],
                                         total_post - 1))
            # reduceat spans [off_i, off_{i+1}); empty terms read a
            # neighbour's value - zero them via the length mask
            span = ex["offsets"][1:] - ex["offsets"][:nt]
            mps = np.where(span > 0, mps, 0)
        else:
            mps = np.zeros(nt, np.int64)
        # term_buf is NUL-separated and sorted (xt_inv_export): the table
        # stays LAZY — lookups bisect the buffer, stats come from the
        # shared columns, and bulk paths (merge/snapshot) materialize on
        # demand. Finalize does ZERO per-term Python work (a 20k-doc geo
        # corpus creates 2.2M unique terms; even a C-speed dict build of
        # those was ~1s of the commit).
        term_infos.cols = (ex["offsets"], cf_col, ex["maxwdf"][:nt], mps)
        lens32 = ex["term_lens"][:nt]
        starts = np.zeros(max(nt, 1), np.int64)
        if nt > 1:
            np.cumsum(lens32[:-1].astype(np.int64) + 1, out=starts[1:])
        term_infos.src = (buf, starts[:nt], lens32)

        doclen = np.zeros(nd + 1, dtype=np.float32)
        uniqterms = np.ones(nd + 1, dtype=np.float32)
        if nd:
            doclen[:nd] = np.asarray(self._doclen, dtype=np.float32)
            uniqterms[:nd] = np.asarray(self._uniq, dtype=np.float32)
        deleted = np.zeros(nd + 1, dtype=bool)
        post_doclen = doclen[np.minimum(post_docids, nd)]

        values = {}
        for slot, per_doc in self._values.items():
            values[slot] = self._pack_value_column(slot, per_doc, nd)
        geo = {}
        for slot, per_doc in self._geo.items():
            geo[slot] = self._pack_geo_column(per_doc, nd)

        return Segment(
            num_docs=nd,
            total_doclen=float(sum(self._doclen)),
            post_docids=post_docids,
            post_wdf=post_wdf,
            post_doclen=post_doclen,
            post_posoff=post_posoff,
            post_poslen=post_poslen,
            positions=positions,
            doclen=doclen,
            deleted=deleted,
            terms=term_infos,
            values=values,
            geo=geo,
            doc_keys=list(self._doc_keys),
            guard=guard,
            uniqterms=uniqterms,
        )

    def _pack_value_column(self, slot, per_doc, nd) -> ValueColumn:
        hi = np.full(nd + 1, _I32MAX, dtype=np.int32)
        lo = np.full(nd + 1, _I32MAX, dtype=np.int32)
        max_hi = np.full(nd + 1, -(2**31), dtype=np.int32)
        max_lo = np.full(nd + 1, -(2**31), dtype=np.int32)
        fval = np.zeros(nd + 1, dtype=np.float32)
        fval2 = None
        present = np.zeros(nd + 1, dtype=bool)
        raw = [None] * nd
        kind = "numeric"
        cats: dict[str, int] = {}
        cat_codes = np.full(nd + 1, -1, dtype=np.int32)
        has_strings = False

        doc_keylists: dict[int, list] = {}
        max_vals = 1
        # vectorised fast path: every doc has exactly ONE plain-number
        # value (the dominant shape - price-like fields). The per-value
        # Python loop below costs ~75s/1M docs; this is 3 numpy passes.
        if per_doc and all(
                len(vals) == 1 and type(vals[0]) in (int, float)
                for vals in per_doc.values()):
            dids = np.fromiter(per_doc.keys(), np.int64, len(per_doc))
            xs = np.fromiter((vals[0] for vals in per_doc.values()),
                             np.float64, len(per_doc))
            keys_np = ser.sortable_keys_u64_np(xs)
            h, l = ser.split_keys_np(keys_np)
            hi[dids], lo[dids] = h, l
            max_hi[dids], max_lo[dids] = h, l
            present[dids] = True
            fval[dids] = xs.astype(np.float32)
            for docid, vals in per_doc.items():
                raw[docid] = vals[0]
            return ValueColumn(
                kind="numeric", hi=hi, lo=lo, max_hi=max_hi,
                max_lo=max_lo, fval=fval, present=present, cats=None,
                raw=raw, fval2=None, max_vals=1)
        # vectorised fast path #2: every doc has exactly ONE string value
        # (the _id column shape - 50k unique ids made serialise_string_key
        # the hottest commit-time line). numpy 'S8' encodes+truncates+pads
        # in C; non-ASCII falls through to the generic loop.
        if per_doc and all(
                len(vals) == 1 and type(vals[0]) is str
                for vals in per_doc.values()):
            strs = [vals[0] for vals in per_doc.values()]
            try:
                s8 = np.array(strs, dtype="S8")
            except UnicodeEncodeError:
                s8 = None
            if s8 is not None:
                dids = np.fromiter(per_doc.keys(), np.int64, len(per_doc))
                keys_np = np.ascontiguousarray(s8).view(">u8").ravel() \
                    .astype(np.uint64)
                h, l = ser.split_keys_np(keys_np)
                hi[dids], lo[dids] = h, l
                max_hi[dids], max_lo[dids] = h, l
                present[dids] = True
                for docid, v in zip(per_doc.keys(), strs):
                    raw[docid] = v
                names, codes = np.unique(np.array(strs, dtype=object),
                                         return_inverse=True)
                cat_codes[dids] = codes.astype(np.int32)
                col = ValueColumn(
                    kind="string", hi=hi, lo=lo, max_hi=max_hi,
                    max_lo=max_lo, fval=fval, present=present, raw=raw,
                    fval2=None, max_vals=1)
                col.cats = cat_codes
                col.cat_names = list(names)
                return col
        _skey_memo: dict[str, int] = {}
        for docid, vals in per_doc.items():
            raw[docid] = vals[0] if len(vals) == 1 else vals
            keys = []
            for v in vals:
                if isinstance(v, bool):
                    kind = "bool"
                    keys.append(ser.sortable_key_u64(1.0 if v else 0.0))
                elif isinstance(v, (int, float)):
                    keys.append(ser.sortable_key_u64(float(v)))
                elif isinstance(v, str):
                    has_strings = True
                    k = _skey_memo.get(v)
                    if k is None:
                        k = ser.serialise_string_key(v)
                        _skey_memo[v] = k
                    keys.append(k)
                elif isinstance(v, tuple) and len(v) == 2:
                    # geo centroid (lat, lon): key on packed lat for sorting;
                    # real geo filtering uses the GeoColumn ranges
                    kind = "geo"
                    keys.append(ser.sortable_key_u64(float(v[0])))
                else:
                    keys.append(ser.sortable_key_u64(0.0))
            if not keys:
                continue
            kmin, kmax = min(keys), max(keys)
            hi[docid], lo[docid] = ser.split_key(kmin)
            max_hi[docid], max_lo[docid] = ser.split_key(kmax)
            present[docid] = True
            if len(keys) > 1:
                doc_keylists[docid] = sorted(keys)
                max_vals = max(max_vals, len(keys))
            v0 = vals[0]
            if isinstance(v0, bool):
                fval[docid] = 1.0 if v0 else 0.0
            elif isinstance(v0, (int, float)):
                fval[docid] = float(v0)
            elif isinstance(v0, tuple) and len(v0) == 2:
                fval[docid] = float(v0[0])
                if fval2 is None:
                    fval2 = np.zeros(nd + 1, dtype=np.float32)
                fval2[docid] = float(v0[1])     # geo centroid lon
            if isinstance(v0, str):
                code = cats.setdefault(v0, len(cats))
                cat_codes[docid] = code

        if has_strings and kind == "numeric":
            kind = "string"
        # exact per-value containment arrays (MultipleValueRange::insideRange,
        # multivalue/range.cc:352-366): only docs with >=2 values need them -
        # single-value docs are exact under the [min,max] interval test
        # (min == max), so mv_len == 0 means "trust the interval".
        mv_hi = mv_lo = mv_off = mv_len = None
        if doc_keylists:
            mv_off = np.zeros(nd + 1, dtype=np.int32)
            mv_len = np.zeros(nd + 1, dtype=np.int32)
            flat: list[int] = []
            for docid in sorted(doc_keylists):
                ks = doc_keylists[docid]
                mv_off[docid] = len(flat)
                mv_len[docid] = len(ks)
                flat.extend(ks)
            guard_v = 8
            mv_hi = np.full(len(flat) + guard_v, _I32MAX, dtype=np.int32)
            mv_lo = np.full(len(flat) + guard_v, _I32MAX, dtype=np.int32)
            for j, kk in enumerate(flat):
                mv_hi[j], mv_lo[j] = ser.split_key(kk)
        col = ValueColumn(kind=kind, hi=hi, lo=lo, max_hi=max_hi,
                          max_lo=max_lo, fval=fval, present=present, raw=raw,
                          fval2=fval2, mv_hi=mv_hi, mv_lo=mv_lo,
                          mv_off=mv_off, mv_len=mv_len, max_vals=max_vals)
        if cats:
            names = [None] * len(cats)
            for name, code in cats.items():
                names[code] = name
            col.cats = cat_codes
            col.cat_names = names
        return col

    def _pack_geo_column(self, per_doc, nd) -> GeoColumn:
        doc_off = np.zeros(nd + 1, dtype=np.int32)
        doc_len = np.zeros(nd + 1, dtype=np.int32)
        starts, ends = [], []
        off = 0
        max_r = 0
        for docid in sorted(per_doc):
            ranges = sorted(per_doc[docid])
            doc_off[docid] = off
            doc_len[docid] = len(ranges)
            max_r = max(max_r, len(ranges))
            for s, e in ranges:
                starts.append(s)
                ends.append(e)
            off += len(ranges)
        guard = 64
        flat_start = np.full(off + guard, _I32MAX, dtype=np.int32)
        flat_end = np.full(off + guard, -1, dtype=np.int32)
        if starts:
            flat_start[:off] = np.asarray(starts, dtype=np.int32)
            flat_end[:off] = np.asarray(ends, dtype=np.int32)
        return GeoColumn(flat_start=flat_start, flat_end=flat_end,
                         doc_off=doc_off, doc_len=doc_len,
                         max_doc_ranges=max_r)
