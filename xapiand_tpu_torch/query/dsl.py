"""JSON Query DSL -> logical IR.

Reference parity target: src/query_dsl.{h,cc} (keywords in
src/reserved/query_dsl.h:27-59). Supported here:

  operators: _and, _or, _not, _and_not, _xor, _and_maybe, _filter
  leaves: _match_all, _match_none, field leaves {"field": <value|spec>}
  field specs: _value, _from/_to (ranges), _in {_range: {...}} or geo,
               _phrase, _near, _wildcard, _boost/_weight, geo objects
  plus "_id" document-id queries and plain-string free-text queries over
  the global (unprefixed) term namespace.

Sort specs (reference: _sort with per-field _order) parse via parse_sort.
"""

from __future__ import annotations

from typing import Callable, Optional

from xapiand_tpu_torch.analysis import accuracy as acc_mod
from xapiand_tpu_torch.analysis import termgen as tg_mod
from xapiand_tpu_torch.analysis.unicode_tok import tokenize
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.schema import FieldType, Schema
from xapiand_tpu_torch.utils import dtutils, serialise as ser, uuid64

_OPS = {"_and": "and", "_or": "or", "_xor": "xor", "_and_not": "and_not",
        "_and_maybe": "and_maybe", "_filter": "filter"}


class QueryDSLError(ValueError):
    pass


class QueryDSL:
    def __init__(self, schema: Schema,
                 term_expander: Optional[Callable[[str], list]] = None,
                 default_op: str = "or"):
        self.schema = schema
        self.expand = term_expander or (lambda prefix, limit=256: [])
        self.default_op = default_op

    # -- entry ----------------------------------------------------------------

    def parse(self, query) -> Q:
        if query is None or query == "" or query == "*":
            return Q.match_all()
        if isinstance(query, str):
            return self.text_query(query)
        if isinstance(query, dict):
            return self._parse_obj(query)
        if isinstance(query, list):
            return self._combine([self.parse(q) for q in query], "and")
        raise QueryDSLError(f"cannot parse query: {query!r}")

    def _parse_obj(self, obj: dict) -> Q:
        parts = []
        for key, val in obj.items():
            if key in _OPS:
                if not isinstance(val, list) or not val:
                    raise QueryDSLError(f"{key} expects a non-empty list")
                children = [self.parse(v) for v in val]
                parts.append(self._combine(children, _OPS[key]))
            elif key == "_not":
                sub = self.parse(val if not isinstance(val, list)
                                 else {"_or": val})
                parts.append(Q.and_not(Q.match_all(), sub))
            elif key == "_max":
                if not isinstance(val, list) or not val:
                    raise QueryDSLError("_max expects a non-empty list")
                parts.append(Q.max_(*[self.parse(v) for v in val]))
            elif key == "_elite_set":
                n = 10
                if isinstance(val, dict):
                    n = int(val.get("_n", val.get("_set_size", 10)))
                    val = val.get("_value", val.get("_queries"))
                if not isinstance(val, list) or not val:
                    raise QueryDSLError("_elite_set expects a list of "
                                        "subqueries")
                parts.append(Q.elite_set([self.parse(v) for v in val], n=n))
            elif key == "_synonym":
                if not isinstance(val, list) or not val:
                    raise QueryDSLError("_synonym expects a non-empty list")
                kids = [self.parse(v) for v in val]
                terms: list[str] = []
                plain = all(k.op in ("term", "or_terms") for k in kids)
                if plain:
                    for k_ in kids:
                        terms.extend(k_.terms)
                    parts.append(Q.synonym(terms))
                else:
                    # non-term children degrade to OR (documented deviation:
                    # OP_SYNONYM over complex subqueries)
                    parts.append(self._combine(kids, "or"))
            elif key == "_scale_weight":
                if not isinstance(val, dict):
                    raise QueryDSLError("_scale_weight expects an object")
                factor = float(val.get("_factor", 1.0))
                sub = val.get("_query")
                if sub is None:
                    sub = {k_: v_ for k_, v_ in val.items()
                           if k_ != "_factor"}
                parts.append(Q.scale(factor, self.parse(sub)))
            elif key == "_match_all":
                parts.append(Q.match_all())
            elif key == "_match_none":
                parts.append(Q.match_none())
            elif key == "_id":
                parts.append(Q.term("Q" + str(val)))
            elif key.startswith("_"):
                raise QueryDSLError(f"unknown query keyword {key!r}")
            else:
                parts.append(self.field_query(key, val))
        return self._combine(parts, "and")

    @staticmethod
    def _combine(parts: list[Q], op: str) -> Q:
        parts = [p for p in parts if p is not None]
        if not parts:
            return Q.match_all()
        if len(parts) == 1:
            return parts[0]
        if op in ("and", "or"):
            return Q(op, children=tuple(parts))
        out = parts[0]
        for p in parts[1:]:
            out = Q(op, children=(out, p))
        return out

    # -- free text over the global namespace ----------------------------------

    def text_query(self, text: str, factor: float = 1.0) -> Q:
        tg = tg_mod.TermGenerator("english")
        terms = tg.index_query_text(text)
        if not terms:
            return Q.match_none()
        if self.default_op == "and" and len(terms) > 1:
            return Q.and_(*[Q.term(t, factor=factor) for t in terms])
        return Q.or_terms(terms, factor=factor)

    def text_phrase(self, text: str, factor: float = 1.0) -> Q:
        """Quoted phrase over the global (unprefixed, unstemmed) namespace."""
        toks = [t.text for t in tokenize(text)]
        if not toks:
            return Q.match_none()
        if len(toks) == 1:
            return Q.term(toks[0], factor=factor)
        return Q.phrase(toks, factor=factor)

    def parse_string(self, text: str) -> Q:
        """?q= string syntax (booleanParser + field_parser analog)."""
        from xapiand_tpu_torch.query.boolparser import BoolParser

        return BoolParser(self).parse(text)

    # -- field leaves -----------------------------------------------------------

    def field_query(self, path: str, value, factor: float = 1.0) -> Q:
        spec = self.schema.get_field(path)
        if isinstance(value, dict):
            from xapiand_tpu_torch.schema.schema import Schema as _S

            cast = _S.resolve_cast(value)
            if cast is not value:   # {"_integer": "25"} etc. (cast.h)
                value = {"_value": cast["_value"], "_type": cast["_type"]}
            if _S.guess_type(value) == FieldType.GEO:
                return self._geo_query(spec, value)
            factor = float(value.get("_boost", value.get("_weight", factor)))
            if "_from" in value or "_to" in value:
                return self._range_query(spec, value.get("_from"),
                                         value.get("_to"))
            if "_range" in value:
                r = value["_range"]
                return self._range_query(spec, r.get("_from"), r.get("_to"))
            if "_in" in value:
                inner = value["_in"]
                if isinstance(inner, dict) and "_range" in inner:
                    r = inner["_range"]
                    return self._range_query(spec, r.get("_from"),
                                             r.get("_to"))
                return self._geo_query(spec, inner)
            if "_phrase" in value:
                return self._positional(spec, str(value["_phrase"]),
                                        int(value.get("_window", 0)),
                                        True, factor)
            if "_near" in value:
                return self._positional(spec, str(value["_near"]),
                                        int(value.get("_window", 0)),
                                        False, factor)
            if "_wildcard" in value or "_partial" in value:
                pre = spec.prefix + str(value.get(
                    "_wildcard", value.get("_partial"))).lower()
                terms = self.expand(pre)
                return Q.or_terms(terms, factor=factor)
            if "_edit_distance" in value or "_fuzzy" in value:
                word = str(value.get("_edit_distance",
                                     value.get("_fuzzy"))).lower()
                edits = int(value.get("_edits",
                                      value.get("_max_edits", 2)))
                return self._fuzzy_query(spec, word, edits, factor)
            if "_synonym" in value:
                terms = self._text_terms(spec, str(value["_synonym"]))
                return Q.synonym(terms, factor=factor)
            if "_elite_set" in value:
                terms = self._text_terms(spec, str(value["_elite_set"]))
                n = int(value.get("_n", value.get("_set_size", 10)))
                return Q.elite_set([Q.term(t, factor=factor) for t in terms],
                                   n=n)
            if "_value" in value:
                return self.field_query(path, value["_value"], factor)
            if value and not any(k.startswith("_") for k in value):
                # nested field-name object: {"style": {"clothing": ...}}
                # == dotted-path fields (namespace-queries.md)
                return self._combine(
                    [self.field_query(f"{path}.{k}", v, factor)
                     for k, v in value.items()], self.default_op)
            raise QueryDSLError(f"cannot parse field query {path}: {value!r}")
        if isinstance(value, list):
            return self._combine(
                [self.field_query(path, v, factor) for v in value],
                self.default_op)
        return self._scalar_query(spec, path, value, factor)

    def _text_terms(self, spec, text: str) -> list[str]:
        """Field-prefixed query terms for a text value (stem-aware)."""
        if spec.type == FieldType.KEYWORD:
            return [spec.prefix + w for w in str(text).split()]
        tg = tg_mod.TermGenerator(spec.language,
                                  stem_strategy=spec.stem_strategy,
                                  stop_strategy=spec.stop_strategy,
                                  cjk_ngram=spec.cjk_ngram,
                                  cjk_words=spec.cjk_words)
        out = []
        for t in tg.index_query_text(str(text)):
            if t.startswith("Z"):
                out.append("Z" + spec.prefix + t[1:])
            else:
                out.append(spec.prefix + t)
        return out

    def _fuzzy_query(self, spec, word: str, edits: int, factor: float) -> Q:
        """_edit_distance / _fuzzy: expand dictionary terms of this field
        within `edits` Levenshtein distance (OP_EDIT_DISTANCE,
        query_dsl.cc DEFAULT_FUZZY_EDIT_DISTANCE 2)."""
        from xapiand_tpu_torch.utils.strmetrics import levenshtein

        pfx = spec.prefix
        plen = len(pfx)
        matches = []
        for t in self.expand(pfx):
            suffix = t[plen:]
            if suffix.startswith("\x00") or not suffix:
                continue
            if abs(len(suffix) - len(word)) > edits:
                continue
            if levenshtein(suffix, word) <= edits:
                matches.append(t)
        if not matches:
            return Q.match_none()
        return Q.or_terms(matches, factor=factor)

    def _scalar_query(self, spec, path, value, factor) -> Q:
        ftype = spec.type
        if ftype == FieldType.EMPTY:
            from xapiand_tpu_torch.schema.schema import Schema as _S

            ftype = _S.guess_type(value)
        pfx = spec.prefix
        if ftype == FieldType.TEXT:
            tg = tg_mod.TermGenerator(spec.language,
                                      stem_strategy=spec.stem_strategy,
                                      stop_strategy=spec.stop_strategy,
                                      cjk_ngram=spec.cjk_ngram,
                                      cjk_words=spec.cjk_words)
            toks = tg.index_query_text(str(value))
            terms = []
            for t in toks:
                if t.startswith("Z"):
                    terms.append("Z" + pfx + t[1:])
                else:
                    terms.append(pfx + t)
            if not terms:
                return Q.match_none()
            if self.default_op == "and" and len(terms) > 1:
                return Q.and_(*[Q.term(t, factor=factor) for t in terms])
            return Q.or_terms(terms, factor=factor)
        if ftype == FieldType.KEYWORD:
            return Q.term(pfx + str(value), factor=factor)
        if ftype in (FieldType.INTEGER, FieldType.POSITIVE, FieldType.FLOATING):
            return Q.term(pfx + ":" + ser.serialise_float_term(float(value)),
                          factor=factor)
        if ftype in (FieldType.DATE, FieldType.DATETIME):
            ts = dtutils.parse_datetime(value)
            return Q.term(pfx + ":" + ser.serialise_float_term(ts),
                          factor=factor)
        if ftype == FieldType.TIME:
            return Q.term(pfx + ":" + ser.serialise_float_term(
                dtutils.parse_time(value)), factor=factor)
        if ftype == FieldType.TIMEDELTA:
            return Q.term(pfx + ":" + ser.serialise_float_term(
                dtutils.parse_timedelta(value)), factor=factor)
        if ftype == FieldType.BOOLEAN:
            from xapiand_tpu_torch.schema.schema import _to_bool

            return Q.term(pfx + ":" + ser.serialise_bool_term(_to_bool(value)),
                          factor=factor)
        if ftype == FieldType.UUID:
            return Q.term(pfx + ":" + uuid64.normalise_uuid(str(value)),
                          factor=factor)
        if ftype == FieldType.IP:
            from xapiand_tpu_torch.utils import iputils

            s = str(value)
            if "/" in s:
                # CIDR query = half-open value-range over the sortable keys;
                # ip_interval_keys clamps IPv6 prefixes finer than float53
                # resolution to the enclosing bucket (never an empty range)
                if spec.slot is None:
                    raise QueryDSLError(f"CIDR query on {path!r} needs values")
                fkey, tkey = iputils.ip_interval_keys(s)
                return Q.value_range(spec.slot, fkey, tkey)
            return Q.term(pfx + ":" + ser.serialise_float_term(
                iputils.parse_ip(s)), factor=factor)
        if ftype == FieldType.GEO:
            return self._geo_query(spec, value)
        raise QueryDSLError(f"cannot query type {ftype} at {path!r}")

    # -- ranges ------------------------------------------------------------------

    def _range_query(self, spec, lo, hi) -> Q:
        ftype = spec.type
        if spec.slot is None:
            raise QueryDSLError("range query on a field without values")
        if ftype in (FieldType.DATE, FieldType.DATETIME):
            lo_v = dtutils.parse_datetime(lo) if lo is not None else None
            hi_v = dtutils.parse_datetime(hi) if hi is not None else None
            cover = []
            if lo_v is not None and hi_v is not None:
                cover = acc_mod.date_range_terms(lo_v, hi_v, spec.accuracy,
                                                 spec.prefix)
        elif ftype in (FieldType.INTEGER, FieldType.POSITIVE,
                       FieldType.FLOATING, FieldType.TIME,
                       FieldType.TIMEDELTA, FieldType.EMPTY):
            lo_v = float(lo) if lo is not None else None
            hi_v = float(hi) if hi is not None else None
            cover = []
            if lo_v is not None and hi_v is not None:
                cover = acc_mod.numeric_range_terms(lo_v, hi_v, spec.accuracy,
                                                    spec.prefix)
        elif ftype == FieldType.IP:
            from xapiand_tpu_torch.utils import iputils

            lo_v = iputils.parse_ip(lo) if lo is not None else None
            hi_v = iputils.parse_ip(hi) if hi is not None else None
            cover = []
        elif ftype in (FieldType.KEYWORD, FieldType.TEXT):
            lo_key = ser.serialise_string_key(str(lo)) if lo is not None else None
            hi_key = (ser.serialise_string_key(str(hi)) + 1) \
                if hi is not None else None
            return Q.value_range(spec.slot, lo_key, hi_key)
        else:
            raise QueryDSLError(f"range unsupported for type {ftype}")
        lo_key = ser.sortable_key_u64(lo_v) if lo_v is not None else None
        hi_key = ser.sortable_key_u64(hi_v) if hi_v is not None else None
        return Q.value_range(spec.slot, lo_key, hi_key, cover_terms=cover)

    # -- positional --------------------------------------------------------------

    def _positional(self, spec, text, window, is_phrase, factor) -> Q:
        # positions are stored on the *unstemmed* prefixed terms (STEM_SOME)
        toks = [t.text for t in tokenize(text)]
        terms = [spec.prefix + t for t in toks]
        if not terms:
            return Q.match_none()
        if len(terms) == 1:
            return Q.term(terms[0], factor=factor)
        if is_phrase:
            return Q.phrase(terms, window=window, factor=factor)
        return Q.near(terms, window=window, factor=factor)

    # -- geo ------------------------------------------------------------------------

    def _geo_query(self, spec, value) -> Q:
        from xapiand_tpu_torch.geo import geospatial

        if spec.slot is None:
            raise QueryDSLError("geo query on a field without values")
        ranges, _ = geospatial.extract(value, error=spec.error)
        cover = acc_mod.geo_range_cover(
            ranges, spec.accuracy, spec.prefix,
            max_terms=acc_mod.GEO_COVER_MAX_TERMS)
        return Q.geo(spec.slot, ranges, cover_terms=cover)


_SORT_METRICS = {
    "levenshtein": "levenshtein", "leven": "levenshtein",
    "jarowinkler": "jaro_winkler", "jarow": "jaro_winkler",
    "jaro": "jaro",
    "sorensendice": "sorensen_dice", "sorensen": "sorensen_dice",
    "dice": "sorensen_dice", "jaccard": "jaccard",
    "lcsubstr": "lcs_substr", "lcs": "lcs_substr",
    "lcsubsequence": "lcs_seq", "lcsq": "lcs_seq",
    "soundex": "soundex", "sound": "soundex",
}


def parse_sort(schema: Schema, sort_spec) -> tuple:
    """Reference sort forms: "field", "-field", ["-field", ...],
    [{"field": {"_order": "desc"}}], "_score", plus distance sorting:
    {"field": {"_order": "asc", "_value": <target>[, "_metric": "..."]}}
    (≙ Multi_MultiValueKeyMaker distance keys, src/multivalue/
    keymaker.h:64-366: numeric |v-t|, geo haversine, string metrics)."""
    if sort_spec is None:
        return ()
    if isinstance(sort_spec, (str, dict)):
        sort_spec = [sort_spec]
    out = []
    for item in sort_spec:
        if isinstance(item, str):
            desc = item.startswith("-")
            name = item.lstrip("+-")
            if name == "_score":
                out.append(("score", 0, True))
                continue
            spec = schema.get_field(name)
            if spec.slot is None:
                raise QueryDSLError(f"cannot sort on {name!r} (no values)")
            out.append(("value", spec.slot, desc))
        elif isinstance(item, dict):
            for name, opts in item.items():
                desc = str(opts.get("_order", "asc")).lower() == "desc" \
                    if isinstance(opts, dict) else False
                if name == "_score":
                    out.append(("score", 0, True))
                    continue
                spec = schema.get_field(name)
                if spec.slot is None:
                    raise QueryDSLError(f"cannot sort on {name!r}")
                target = opts.get("_value") if isinstance(opts, dict) \
                    else None
                if target is None:
                    out.append(("value", spec.slot, desc))
                    continue
                metric = opts.get("_metric")
                if isinstance(target, str) and not metric \
                        and spec.type not in (FieldType.DATE,
                                              FieldType.DATETIME,
                                              FieldType.TIME,
                                              FieldType.TIMEDELTA):
                    metric = "levenshtein"
                if metric:
                    mkey = _SORT_METRICS.get(
                        str(metric).lower().replace("_", "").replace("-", ""))
                    if mkey is None:
                        raise QueryDSLError(f"unknown sort _metric "
                                            f"{metric!r}")
                    out.append(("strmetric", spec.slot, desc,
                                (mkey, str(target))))
                elif isinstance(target, (dict, tuple, list)) or \
                        spec.type == FieldType.GEO:
                    from xapiand_tpu_torch.geo import geospatial
                    _, centroid = geospatial.extract(target) \
                        if isinstance(target, (dict, str)) else \
                        (None, tuple(target))
                    out.append(("geodist", spec.slot, desc,
                                (float(centroid[0]), float(centroid[1]))))
                else:
                    if spec.type in (FieldType.DATE, FieldType.DATETIME):
                        tval = dtutils.parse_datetime(target)
                    elif spec.type == FieldType.TIME:
                        tval = dtutils.parse_time(target)
                    elif spec.type == FieldType.TIMEDELTA:
                        tval = dtutils.parse_timedelta(target)
                    else:
                        tval = float(target)
                    out.append(("dist", spec.slot, desc, float(tval)))
    return tuple(out)
