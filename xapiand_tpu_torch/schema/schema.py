"""Schema: walks JSON/MsgPack documents, infers/validates field specs, and
produces terms + value-slot entries for indexing.

Reference parity target: Schema::index (src/database/schema.cc:2709) with its
~40 `process_*` reserved-keyword handlers (schema.h:862-893), type guessing
(src/serialise.cc:795 guess_type), per-field prefixes/slots
(required_spc_t, schema.h:307), accuracy terms, nested objects/arrays and
dynamic fields.

The persistent schema is a plain nested dict (stored msgpack'd in the index
metadata, like the reference's foreign schema documents in
`.xapiand/indices`, schemas_lru.cc:289-293).
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field as dfield
from typing import Any

from xapiand_tpu_torch.analysis import accuracy as acc_mod
from xapiand_tpu_torch.analysis import termgen as tg_mod
from xapiand_tpu_torch.schema.types import (FieldType, TypeIndex, index_name,
                                      parse_index, parse_type)
from xapiand_tpu_torch.utils import dtutils, serialise as ser, uuid64
from xapiand_tpu_torch.utils.hashing import fnv1ah64

# slots reserved by the engine (reference: DB_SLOT_ID / DB_SLOT_VERSION in
# src/database/utils.h)
SLOT_ID = 0
SLOT_VERSION = 1
FIRST_USER_SLOT = 100

ID_FIELD = "_id"
VERSION_FIELD = "_version"

_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$")


_SCALARS = (str, int, float, bool, type(None))


def _fast_doc_copy(v):
    """Deep copy for JSON-shaped documents: ~10x copy.deepcopy (no memo,
    no reduce protocol). Non-JSON containers fall back to deepcopy."""
    t = type(v)
    if t is dict:
        return {k: _fast_doc_copy(x) for k, x in v.items()}
    if t is list:
        return [_fast_doc_copy(x) for x in v]
    if t in _SCALARS:
        return v
    return copy.deepcopy(v)


class SchemaError(ValueError):
    pass


@dataclass
class FieldSpec:
    """Resolved per-field indexing spec (required_spc_t, schema.h:307)."""

    type: FieldType = FieldType.EMPTY
    prefix: str = ""
    slot: int | None = None
    index: TypeIndex = TypeIndex.ALL
    accuracy: list | None = None
    language: str | None = "english"
    stem_strategy: str = tg_mod.STEM_SOME
    stop_strategy: str = tg_mod.STOP_STEMMED
    weight: int = 1
    positions: bool = True
    bool_term: bool = True        # keyword terms are boolean filters
    store: bool = True
    dynamic: bool = True
    strict: bool = False
    recurse: bool = True
    partial_paths: bool | None = None  # None = default (ON inside _namespace)
    ngram: bool = False
    cjk_ngram: bool = True
    error: float = 0.3           # geo HTM error (htm.h:39-51)
    value: Any = None            # explicit _value override
    ignored: frozenset = dfield(default_factory=frozenset)
    spelling: bool = True        # feed this field's words to the spelling
                                 # dictionary (process_spelling)
    cjk_words: bool = False      # CJK dictionary word segmentation
                                 # back to bigrams (no segmenter shipped -
                                 # documented deviation from cjk-tokenizer)
    index_uuid_field: str = "both"   # uuid-typed field-name indexing
    partials: bool = True        # geo partial-trixel terms (process_partials)
    acc_prefix: list | None = None   # explicit accuracy-term prefixes
    position_start: int = 0      # starting term position (process_position)
    # unpacked `index` flags, set by _resolve_concrete (IntFlag bit tests
    # allocate a new Flag object per `&` - too slow for per-doc use)
    do_field_terms: bool = True
    do_field_values: bool = True
    do_global_terms: bool = True
    # _namespace subtree state (schema.cc inside_namespace +
    # get_partial_paths, schema.cc:4495-4549): terms for a leaf are
    # emitted under root · (every subset of middle levels) · leaf
    namespace_: bool = False
    ns_root_prefix: str = ""
    ns_levels: tuple = ()            # per-level NAME prefixes below root
    ns_partial_prefixes: tuple = ()  # resolved partial-path prefixes


@dataclass
class IndexedDocument:
    """The output of Schema.index: everything the segment builder needs."""

    doc_id: str
    id_term: str
    terms: tg_mod.DocumentTerms
    values: dict  # slot -> list of typed values (float | str | bool | tuple)
    data: dict    # the stored document object
    geo_ranges: dict = dfield(default_factory=dict)  # slot -> HTM ranges
    # text analysis ops deferred to the builder's native inverter (each is
    # (value, prefixes, language, stem_strategy, stop_strategy, weight,
    # with_positions, position_start)); empty on the eager path
    text_ops: list = dfield(default_factory=list)
    # geo accuracy-term ops deferred to the native inverter (each is
    # (ranges, levels, prefix)); empty on the eager path
    geo_acc_ops: list = dfield(default_factory=list)
    # numeric/date accuracy-term ops deferred to the native inverter's
    # packed doc-add (xt_inv_add_doc generates bucket/truncation terms in
    # C++; ≙ GenerateTerms src/multivalue/generate_terms.cc). Each is
    # (value_or_ts, accuracies_or_None, prefix); empty on the eager path.
    num_acc_ops: list = dfield(default_factory=list)
    date_acc_ops: list = dfield(default_factory=list)


def field_prefix(path: str) -> str:
    """Deterministic short field prefix from the full dotted path.

    The reference derives prefixes from the field path too (get_prefix in
    schema.cc); exact byte-parity is not required since terms never leave an
    index, only determinism is."""
    return "F" + format(fnv1ah64(path) & 0xFFFFFFFF, "08x") + "."


def global_spec_for(ftype: FieldType) -> FieldSpec:
    """Spec used for GLOBAL_TERMS/GLOBAL_VALUES (unprefixed namespace)."""
    return FieldSpec(type=ftype, prefix="", slot=None)


def partial_path_prefixes(root: str, levels: tuple, partial: bool) -> tuple:
    """All partial-path term prefixes for a namespaced leaf: root and leaf
    are mandatory, every subset of the middle levels is emitted
    (Schema::get_partial_paths, schema.cc:4495-4549). With partial paths
    off, only the full path."""
    full = root + "".join(levels)
    if not partial or len(levels) <= 1:
        return (full,)
    if len(levels) + 1 > 10:  # LIMIT_PARTIAL_PATHS_DEPTH (schema.h:119)
        raise SchemaError(
            f"partial paths limit depth is 10, got {len(levels) + 1}")
    mids, leaf = levels[:-1], levels[-1]
    out = []
    for mask in range(1 << len(mids)):
        out.append(root + "".join(
            m for i, m in enumerate(mids) if (mask >> i) & 1) + leaf)
    return tuple(dict.fromkeys(out))


class Schema:
    """Mutable schema bound to one index.

    ``props`` is the persistent nested dict; indexing unknown fields mutates
    it (``self.mutated`` flips True so the caller persists + broadcasts it,
    mirroring SchemasLRU update semantics).
    """

    VERSION = 1

    def __init__(self, props: dict | None = None):
        if props is None:
            props = {"_version": self.VERSION, "schema": {}}
        self.props = props
        self.props.setdefault("schema", {})
        self.mutated = False
        self._next_slot = self._scan_max_slot() + 1
        # path -> (node, resolved concrete FieldSpec): once a field's node
        # is established (types/prefix/slot/accuracy persisted), the spec
        # pipeline (copy + _apply_reserved keyword re-parse +
        # _resolve_concrete) is a pure function of the node - skip it per
        # doc. Invalidated on ANY schema mutation (_persist/_child_node).
        self._spec_cache: dict = {}
        # monotonic mutation counter: parse/IR caches key on it (any
        # schema change may alter field resolution of a cached query)
        self.mutations = 0

    # -- persistence ---------------------------------------------------------

    def to_dict(self) -> dict:
        return self.props

    @classmethod
    def from_dict(cls, props: dict) -> "Schema":
        return cls(copy.deepcopy(props))

    def _scan_max_slot(self) -> int:
        mx = FIRST_USER_SLOT - 1

        def walk(node):
            nonlocal mx
            for k, v in node.items():
                if k == "_slot" and isinstance(v, int):
                    mx = max(mx, v)
                elif isinstance(v, dict):
                    walk(v)

        walk(self.props["schema"])
        return mx

    # -- field spec resolution -----------------------------------------------

    def _root_defaults(self) -> FieldSpec:
        # rebuilt only after schema mutations (_spec_cache doubles as the
        # invalidation signal); callers get a copy - get_field mutates its
        # spec in place on namespace paths
        cached = self._spec_cache.get("")
        if cached is None:
            spec = FieldSpec()
            self._apply_reserved(spec, self.props.get("schema", {}),
                                 path="", mutate=False)
            self._spec_cache[""] = cached = (None, spec)
        # copy.copy's protocol probing (~5us/doc) dominated bulk indexing;
        # FieldSpec is a plain dataclass, a __dict__ clone is equivalent
        spec = FieldSpec.__new__(FieldSpec)
        spec.__dict__.update(cached[1].__dict__)
        return spec

    def get_field(self, path: str) -> FieldSpec:
        """Resolve the spec for a dotted field path (query-side view).

        Inside a `_namespace` subtree the prefix is rebuilt from the level
        NAMES alone (root prefix + one per-name prefix per remaining
        part), so dotted paths that skip middle levels resolve to the
        partial-path terms the indexer emitted (namespace-queries.md;
        schema.cc get_partial_paths)."""
        spec = self._root_defaults()
        node = self.props["schema"]
        parts = path.split(".") if path else []
        ns_accum = None   # namespace prefix accumulator once inside
        for i, part in enumerate(parts):
            nxt = node.get(part) if isinstance(node, dict) else None
            if ns_accum is not None:
                ns_accum += field_prefix(part)
                if isinstance(nxt, dict):
                    # known full-path level: adopt its concrete spec
                    spec = self._apply_reserved(copy.copy(spec), nxt, path,
                                                mutate=False)
                else:
                    # skipped-middle partial path: type unknown (guessed
                    # from the query value downstream)
                    spec = copy.copy(spec)
                    spec.type = FieldType.EMPTY
                    spec.slot = None
                node = nxt
                continue
            if not isinstance(nxt, dict):
                # unknown field: namespace-style guess (empty type)
                return FieldSpec(type=FieldType.EMPTY,
                                 prefix=field_prefix(path), slot=None)
            node = nxt
            spec = self._apply_reserved(copy.copy(spec), node, path,
                                        mutate=False)
            if spec.namespace_:
                ns_accum = node.get("_prefix") or \
                    field_prefix(".".join(parts[:i + 1]))
        if ns_accum is not None:
            spec.prefix = ns_accum
        elif not spec.prefix:
            spec.prefix = field_prefix(path)
        return spec

    _RESERVED_PARSERS = {}  # populated below

    def _apply_reserved(self, spec: FieldSpec, props: dict, path: str,
                        mutate: bool) -> FieldSpec:
        """Apply `_`-keyword properties from a schema/doc node onto a spec.

        Mirrors dispatch_process_properties (schema.h:862-893)."""
        for key, val in props.items():
            if not key.startswith("_"):
                continue
            handler = self._RESERVED_PARSERS.get(key)
            if handler is not None:
                handler(self, spec, val, path)
            elif self._root_is_strict() and key not in _PASSTHROUGH_KEYS:
                raise SchemaError(f"unknown reserved keyword {key!r} in {path!r}")
        return spec

    def _root_is_strict(self) -> bool:
        return bool(self.props.get("schema", {}).get("_strict", False))

    # individual keyword handlers (subset of the reference's 40; the
    # remainder raise via strict mode so gaps are visible, not silent)

    def _kw_type(self, spec, val, path):
        spec.type = parse_type(val)

    def _kw_index(self, spec, val, path):
        spec.index = parse_index(val)

    def _kw_slot(self, spec, val, path):
        spec.slot = int(val)

    def _kw_prefix(self, spec, val, path):
        spec.prefix = str(val)

    def _kw_accuracy(self, spec, val, path):
        if not isinstance(val, list):
            raise SchemaError(f"_accuracy must be a list in {path!r}")
        spec.accuracy = list(val)

    def _kw_language(self, spec, val, path):
        spec.language = str(val)

    def _kw_stem_language(self, spec, val, path):
        spec.language = str(val)

    def _kw_stem_strategy(self, spec, val, path):
        v = str(val).lower().replace("stem_", "")
        if v not in (tg_mod.STEM_NONE, tg_mod.STEM_SOME, tg_mod.STEM_ALL,
                     tg_mod.STEM_ALL_Z):
            raise SchemaError(f"invalid _stem_strategy: {val!r}")
        spec.stem_strategy = v

    def _kw_stop_strategy(self, spec, val, path):
        v = str(val).lower().replace("stop_", "")
        if v not in (tg_mod.STOP_NONE, tg_mod.STOP_ALL, tg_mod.STOP_STEMMED):
            raise SchemaError(f"invalid _stop_strategy: {val!r}")
        spec.stop_strategy = v

    def _kw_weight(self, spec, val, path):
        spec.weight = int(val)

    def _kw_positions(self, spec, val, path):
        spec.positions = bool(val)

    def _kw_bool_term(self, spec, val, path):
        spec.bool_term = bool(val)

    def _kw_store(self, spec, val, path):
        spec.store = bool(val)

    def _kw_dynamic(self, spec, val, path):
        spec.dynamic = bool(val)

    def _kw_strict(self, spec, val, path):
        spec.strict = bool(val)

    def _kw_recurse(self, spec, val, path):
        spec.recurse = bool(val)

    def _kw_partial_paths(self, spec, val, path):
        spec.partial_paths = bool(val)

    def _kw_namespace(self, spec, val, path):
        spec.namespace_ = bool(val)

    def _kw_ngram(self, spec, val, path):
        spec.ngram = bool(val)

    def _kw_cjk_ngram(self, spec, val, path):
        spec.cjk_ngram = bool(val)

    def _kw_error(self, spec, val, path):
        spec.error = float(val)

    def _kw_value(self, spec, val, path):
        spec.value = val

    def _kw_ignore(self, spec, val, path):
        vals = val if isinstance(val, list) else [val]
        spec.ignored = frozenset(str(v) for v in vals)

    def _kw_spelling(self, spec, val, path):
        spec.spelling = bool(val)

    def _kw_cjk_words(self, spec, val, path):
        spec.cjk_words = bool(val)

    def _kw_index_uuid_field(self, spec, val, path):
        v = str(val).lower()
        if v not in ("uuid", "uuid_field", "both"):
            raise SchemaError(f"invalid _index_uuid_field: {val!r}")
        spec.index_uuid_field = v

    def _kw_partials(self, spec, val, path):
        spec.partials = bool(val)

    def _kw_acc_prefix(self, spec, val, path):
        if not isinstance(val, list):
            raise SchemaError(f"_acc_prefix must be a list in {path!r}")
        spec.acc_prefix = [str(v) for v in val]

    def _kw_position(self, spec, val, path):
        spec.position_start = int(val)

    _RESERVED_PARSERS = {
        "_type": _kw_type, "_index": _kw_index, "_slot": _kw_slot,
        "_prefix": _kw_prefix, "_accuracy": _kw_accuracy,
        "_language": _kw_language, "_stem_language": _kw_stem_language,
        "_stem_strategy": _kw_stem_strategy, "_stop_strategy": _kw_stop_strategy,
        "_weight": _kw_weight, "_positions": _kw_positions,
        "_bool_term": _kw_bool_term, "_store": _kw_store,
        "_dynamic": _kw_dynamic, "_strict": _kw_strict,
        "_recurse": _kw_recurse, "_partial_paths": _kw_partial_paths,
        "_namespace": _kw_namespace,
        "_ngram": _kw_ngram, "_cjk_ngram": _kw_cjk_ngram,
        "_error": _kw_error, "_value": _kw_value, "_ignore": _kw_ignore,
        "_spelling": _kw_spelling, "_cjk_words": _kw_cjk_words,
        "_index_uuid_field": _kw_index_uuid_field,
        "_partials": _kw_partials, "_acc_prefix": _kw_acc_prefix,
        "_accuracy_prefix": _kw_acc_prefix,   # canonical reference spelling
        "_position": _kw_position,
    }
    # `_*_detection` root flags are consumed via _detections(), not per
    # field - register no-op handlers so strict mode accepts them
    for _dk in ("_bool_detection", "_date_detection", "_datetime_detection",
                "_geo_detection", "_numeric_detection", "_term_detection",
                "_text_detection", "_time_detection", "_timedelta_detection",
                "_uuid_detection"):
        _RESERVED_PARSERS[_dk] = lambda self, spec, val, path: None
    del _dk

    # -- type inference (guess_type, serialise.cc:795; detection flags
    #    gate the index-time chain, schema.cc:5085-5190) ---------------------

    def _detections(self) -> dict:
        # `_*_detection` root flags (schema.cc:1899 defaults, all true):
        # turning one off removes that type from dynamic inference
        return self.props.get("schema", {})

    @staticmethod
    def guess_type(value, detection=None) -> FieldType:
        d = detection or {}

        def on(flag):
            return d.get(flag, True) is not False

        if isinstance(value, bool):
            if detection is not None and not on("_bool_detection"):
                raise SchemaError("boolean value with _bool_detection off")
            return FieldType.BOOLEAN
        if isinstance(value, int):
            if detection is not None and not on("_numeric_detection"):
                raise SchemaError("numeric value with _numeric_detection off")
            return FieldType.INTEGER if value < 0 else FieldType.POSITIVE
        if isinstance(value, float):
            if detection is not None and not on("_numeric_detection"):
                raise SchemaError("numeric value with _numeric_detection off")
            return FieldType.FLOATING
        if isinstance(value, dict):
            if any(k in value for k in (
                    "_point", "_circle", "_polygon", "_multipoint",
                    "_multicircle", "_multipolygon", "_chull", "_convex",
                    "_multichull", "_multiconvex", "_ewkt",
                    "_geometrycollection", "_geometryintersection")):
                return FieldType.GEO
            if value.get("_type") == "geo" and "_value" not in value:
                # a bare {"_type": "geo", ...} geometry; specs carrying
                # _value route through inline-spec handling instead
                return FieldType.GEO
            return FieldType.OBJECT
        if isinstance(value, list):
            return FieldType.ARRAY
        if isinstance(value, str):
            if on("_uuid_detection") and uuid64.is_uuid(value):
                return FieldType.UUID
            if on("_date_detection") or on("_datetime_detection"):
                # pure dates ("2015-03-14") gate on _date_detection,
                # values with a time part on _datetime_detection - the two
                # reference flags are independent (schema.cc:5133-5147)
                date_only = "T" not in value and ":" not in value
                if on("_date_detection") if date_only \
                        else on("_datetime_detection"):
                    try:
                        dtutils.parse_datetime(value)
                        return FieldType.DATETIME
                    except dtutils.DatetimeError:
                        pass
            if on("_time_detection"):
                try:
                    dtutils.parse_time(value)
                    return FieldType.TIME
                except dtutils.DatetimeError:
                    pass
            if on("_numeric_detection"):
                if _INT_RE.match(value):
                    v = int(value)
                    return FieldType.INTEGER if v < 0 \
                        else FieldType.POSITIVE
                if _FLOAT_RE.match(value):
                    return FieldType.FLOATING
            if on("_geo_detection"):
                from xapiand_tpu_torch.geo.ewkt import is_ewkt

                if is_ewkt(value):
                    return FieldType.GEO
            if on("_bool_detection") and value in ("true", "false"):
                # bare true/false strings (schema.cc:5174-5181)
                return FieldType.BOOLEAN
            if on("_text_detection"):
                return FieldType.TEXT
            if on("_term_detection"):
                return FieldType.KEYWORD
            raise SchemaError(
                f"cannot infer type for {value!r} (text and term "
                f"detection disabled)")
        raise SchemaError(f"cannot infer type for {value!r}")

    # -- indexing --------------------------------------------------------------

    def index(self, obj: dict, doc_id: str | None = None,
              defer_text: bool = False) -> IndexedDocument:
        """Walk a document, producing terms/values and updating the schema.

        ≙ Schema::index (schema.cc:2709). With defer_text, text fields are
        recorded as IndexedDocument.text_ops instead of being analysed here
        - the segment builder streams them through the native inverter
        (tokenise+stem+accumulate in C++), its hottest path."""
        if not isinstance(obj, dict):
            raise SchemaError("document must be an object")
        # flat docs (no nested containers) need only a top-level copy;
        # deepcopy is ~80x the cost and only guards shared nested state
        if any(isinstance(v, (dict, list)) for v in obj.values()):
            obj = _fast_doc_copy(obj)
        else:
            obj = dict(obj)
        if doc_id is None:
            doc_id = obj.get(ID_FIELD) or uuid64.generate_uuid()
        doc_id = str(doc_id)
        obj.pop(ID_FIELD, None)
        obj.pop(VERSION_FIELD, None)

        out = IndexedDocument(
            doc_id=doc_id,
            id_term="Q" + doc_id,
            terms=tg_mod.DocumentTerms(),
            values={},
            data=obj,
        )
        out.values[SLOT_ID] = [doc_id]
        out._defer = defer_text
        root_spec = self._root_defaults()
        schema_node = self.props["schema"]
        for name, value in obj.items():
            if name.startswith("_"):
                continue  # reserved at root (e.g. _schema hints) - skip data
            self._index_field(out, schema_node, root_spec, name, value,
                              path=name)
        return out

    def no_spelling_prefixes(self) -> frozenset:
        """Prefixes of fields with _spelling: false - their words stay out
        of the spelling dictionary (process_spelling semantics)."""
        out: set[str] = set()

        def walk(node, path):
            for name, sub in node.items():
                if name.startswith("_") or not isinstance(sub, dict):
                    continue
                p = f"{path}.{name}" if path else name
                if sub.get("_spelling") is False:
                    out.add(sub.get("_prefix") or field_prefix(p))
                walk(sub, p)

        walk(self.props["schema"], "")
        return frozenset(out)

    def _child_node(self, parent_node: dict, name: str, parent_spec: FieldSpec,
                    path: str) -> dict | None:
        node = parent_node.get(name)
        if node is None:
            if parent_spec.strict:
                raise SchemaError(f"strict schema: unknown field {path!r}")
            if not parent_spec.dynamic:
                return None
            node = parent_node[name] = {}
            self.mutated = True
            self.mutations += 1
            self._spec_cache.clear()
        return node

    def _ns_setup(self, spec: FieldSpec, parent_spec: FieldSpec,
                  node: dict, name: str, path: str):
        """Namespace bookkeeping after reserved keys are applied: mark the
        root (inside_namespace transition, schema.cc:3007) or extend the
        per-level prefix chain under it. Idempotent."""
        if not spec.namespace_:
            return
        if not spec.ns_root_prefix:
            pfx = node.get("_prefix") or field_prefix(path)
            self._persist(node, "_prefix", pfx)
            spec.ns_root_prefix = pfx
        elif parent_spec.namespace_ and \
                spec.ns_levels is parent_spec.ns_levels:
            # a level below the root: per-NAME prefix so any partial
            # dotted path can be rebuilt query-side without the tree
            # (identity check = append exactly once per recursion level)
            spec.ns_levels = parent_spec.ns_levels + (field_prefix(name),)

    # value cast keywords (≙ cast.h HASH_OPTIONS / Cast::get_field_type):
    # {"field": {"_integer": "25"}} types the field AND converts the value
    _CAST_TYPES = {
        "_integer": "integer", "_positive": "positive",
        "_float": "floating", "_boolean": "boolean",
        "_keyword": "keyword", "_term": "keyword",
        "_text": "text", "_string": "text", "_uuid": "uuid",
        "_date": "date", "_datetime": "datetime", "_time": "time",
        "_timedelta": "timedelta", "_script": None, "_chai": None,
    }

    @classmethod
    def resolve_cast(cls, value):
        """A single-cast-key dict -> ({"_type": t, "_value": casted}) or
        the value unchanged. Conversion follows Cast::cast (cast.cc):
        numeric strings parse, booleans accept true/false/1/0 spellings."""
        if not isinstance(value, dict) or len(value) != 1:
            return value
        key = next(iter(value))
        t = cls._CAST_TYPES.get(key)
        if t is None:
            return value
        raw = value[key]
        try:
            if t == "integer" or t == "positive":
                v = int(float(raw)) if isinstance(raw, str) else int(raw)
            elif t == "floating":
                v = float(raw)
            elif t == "boolean":
                v = raw if isinstance(raw, bool) else \
                    str(raw).strip().lower() in ("true", "1", "t")
            elif t in ("keyword", "text", "uuid"):
                v = str(raw)
            else:   # date/datetime/time/timedelta: serializers parse
                v = raw
        except (TypeError, ValueError) as exc:
            raise SchemaError(f"cannot cast {raw!r} via {key}: {exc}")
        return {"_type": t, "_value": v}

    def _index_field(self, out: IndexedDocument, parent_node: dict,
                     parent_spec: FieldSpec, name: str, value, path: str):
        if name in parent_spec.ignored:
            return
        value = self.resolve_cast(value)
        if "." in name:
            # field expansion (api.md): {"a.b.c": v} == {"a": {"b":
            # {"c": v}}} - same schema tree, prefixes, and terms
            head, rest = name.split(".", 1)
            self._index_field(out, parent_node, parent_spec, head,
                              {rest: value},
                              path[: len(path) - len(name)] + head)
            return
        # fast path: established field with a cached resolved spec - skip
        # the whole spec pipeline (copy + keyword re-parse + resolve) for
        # plain concrete values / geo payloads / lists of those
        hit = self._spec_cache.get(path)
        if hit is not None and hit[0] is parent_node.get(name):
            cnode, cspec = hit
            vs = value if isinstance(value, list) else (value,)
            if all(not isinstance(v, (dict, list)) or
                   (isinstance(v, dict) and cspec.type == FieldType.GEO
                    and self.guess_type(v) == FieldType.GEO)
                   for v in vs):
                for v in vs:
                    self._index_resolved(out, cnode, cspec, v, path)
                return
            # inline specs / objects / nested lists: fall through
        node = self._child_node(parent_node, name, parent_spec, path)
        if node is None:
            return

        spec = copy.copy(parent_spec)
        spec.value = None
        spec.slot = None
        spec.prefix = ""
        spec.accuracy = None
        spec = self._apply_reserved(spec, node, path, mutate=True)
        self._ns_setup(spec, parent_spec, node, name, path)
        ck = path   # cacheable unless an inline doc spec shaped this spec

        # geo payloads use _-keys but are values, not specs
        if isinstance(value, dict) and self.guess_type(value) == FieldType.GEO:
            self._index_concrete(out, node, spec, value, path, cache_key=ck)
            return

        # explicit spec keys sent inline with the document
        if isinstance(value, dict) and any(k.startswith("_") for k in value):
            ck = None
            inline = {k: v for k, v in value.items() if k.startswith("_")}
            payload = {k: v for k, v in value.items() if not k.startswith("_")}
            spec = self._apply_reserved(spec, inline, path, mutate=True)
            self._persist_inline(node, inline)
            # inline `_namespace: true` (the documented way to enable it)
            self._ns_setup(spec, parent_spec, node, name, path)
            if spec.value is not None:
                value = spec.value
            elif payload:
                value = payload
            elif spec.type == FieldType.EMPTY or spec.type in (
                    FieldType.OBJECT, FieldType.ARRAY):
                return  # pure spec object, nothing to index
            else:
                return

        if isinstance(value, dict) and spec.type is not None and \
                getattr(spec.type, "is_temporal", False):
            # datetime/time/timedelta map form ({"_year": ..}) is a VALUE
            # (datetime.cc process_date_datetime), not a subobject
            self._index_concrete(out, node, spec, value, path)
            return

        if isinstance(value, dict) and self.guess_type(value) == FieldType.OBJECT:
            if not spec.recurse:
                return
            if spec.type == FieldType.EMPTY:
                self._persist(node, "_type", FieldType.OBJECT.value)
            for k, v in value.items():
                if k.startswith("_"):
                    continue
                self._index_field(out, node, spec, k, v, path + "." + k)
            return

        if isinstance(value, list):
            for item in value:
                self._index_concrete_or_object(out, node, spec, name, item,
                                               path, cache_key=ck)
            return

        self._index_concrete_or_object(out, node, spec, name, value, path,
                                       cache_key=ck)

    def _index_concrete_or_object(self, out, node, spec, name, value, path,
                                  cache_key=None):
        cast = self.resolve_cast(value)
        if cast is not value:   # list items may be cast objects too
            spec2 = self._apply_reserved(copy.copy(spec), cast, path,
                                         mutate=True)
            self._index_concrete(out, node, spec2, cast["_value"], path)
            return
        if isinstance(value, dict) and self.guess_type(value) == FieldType.OBJECT:
            for k, v in value.items():
                if k.startswith("_"):
                    continue
                self._index_field(out, node, spec, k, v, path + "." + k)
            return
        self._index_concrete(out, node, spec, value, path,
                             cache_key=cache_key)

    # -- concrete value indexing ------------------------------------------------

    def _persist(self, node: dict, key: str, value):
        if node.get(key) != value:
            node[key] = value
            self.mutated = True
            self.mutations += 1
            self._spec_cache.clear()

    def _persist_inline(self, node: dict, inline: dict):
        for k, v in inline.items():
            if k in ("_value",):
                continue
            if k == "_type":
                continue  # _type persisted via concrete-type resolution
            self._persist(node, k, v)

    def _resolve_concrete(self, node: dict, spec: FieldSpec, value,
                          path: str) -> FieldSpec:
        if spec.type in (FieldType.EMPTY, FieldType.OBJECT, FieldType.ARRAY):
            guessed = self.guess_type(value, detection=self._detections())
            if guessed in (FieldType.OBJECT, FieldType.ARRAY):
                raise SchemaError(f"expected concrete value at {path!r}")
            spec.type = guessed
            self._persist(node, "_type", guessed.value)
        elif "_type" not in node:
            self._persist(node, "_type", spec.type.value)
        if spec.namespace_ and spec.ns_levels:
            # namespaced leaf: prefix = root · every level; term emission
            # additionally covers the partial paths (default ON inside a
            # namespace; _partial_paths: false narrows to the full path)
            spec.prefix = spec.ns_root_prefix + "".join(spec.ns_levels)
            self._persist(node, "_prefix", spec.prefix)
            spec.ns_partial_prefixes = partial_path_prefixes(
                spec.ns_root_prefix, spec.ns_levels,
                spec.partial_paths is not False)
        elif not spec.prefix:
            spec.prefix = node.get("_prefix") or field_prefix(path)
            self._persist(node, "_prefix", spec.prefix)
        idx = int(spec.index)
        spec.do_field_terms = bool(idx & TypeIndex.FIELD_TERMS)
        spec.do_field_values = bool(idx & TypeIndex.FIELD_VALUES)
        spec.do_global_terms = bool(idx & TypeIndex.GLOBAL_TERMS)
        if spec.slot is None and spec.do_field_values:
            slot = node.get("_slot")
            if slot is None:
                slot = self._next_slot
                self._next_slot += 1
                self._persist(node, "_slot", slot)
            spec.slot = slot
        if spec.accuracy is None:
            accd = node.get("_accuracy")
            if accd is None:
                if spec.type.is_numeric:
                    accd = list(acc_mod.DEF_ACC_NUMERIC)
                elif spec.type in (FieldType.DATE, FieldType.DATETIME):
                    accd = list(acc_mod.DEF_ACC_DATE)
                elif spec.type == FieldType.GEO:
                    accd = list(acc_mod.DEF_ACC_GEO)
                if accd is not None:
                    self._persist(node, "_accuracy", accd)
            spec.accuracy = accd
        if "_index" not in node:
            self._persist(node, "_index", index_name(spec.index))
        return spec

    def _index_concrete(self, out: IndexedDocument, node: dict,
                        spec: FieldSpec, value, path: str, cache_key=None):
        spec = self._resolve_concrete(node, spec, value, path)
        if cache_key is not None and spec.type not in (
                FieldType.EMPTY, FieldType.OBJECT, FieldType.ARRAY):
            # resolved spec is now a pure function of the (persisted) node;
            # reuse it for every later doc until the schema mutates
            self._spec_cache[cache_key] = (node, spec)
        self._index_resolved(out, node, spec, value, path)

    def _index_resolved(self, out: IndexedDocument, node: dict,
                        spec: FieldSpec, value, path: str):
        ftype = spec.type
        do_field_terms = spec.do_field_terms
        do_field_values = spec.do_field_values
        do_global_terms = spec.do_global_terms

        geo = None
        if ftype == FieldType.GEO:
            # ONE HTM cover serves field terms, global terms, and the
            # value slot (extraction dominates geo indexing time)
            from xapiand_tpu_torch.geo import geospatial

            geo = geospatial.extract(value, error=spec.error)

        ts = None
        if ftype in (FieldType.DATE, FieldType.DATETIME):
            # ONE parse serves field terms, global terms, and the value
            # slot (ISO parsing is a measurable slice of date-heavy docs)
            ts = dtutils.parse_datetime(value)

        def add_terms(prefix: str):
            self._emit_terms(out, spec, ftype, value, prefix, path,
                             geo=geo, ts=ts)

        field_prefixes = spec.ns_partial_prefixes or (spec.prefix,)
        if ftype == FieldType.TEXT:
            # one tokenise+stem pass emits both the field-prefixed and
            # global namespaces (2x indexing-throughput win)
            prefixes = []
            if do_field_terms:
                prefixes.extend(field_prefixes)
            if do_global_terms:
                prefixes.append("")
            if prefixes:
                self._emit_text_terms(out, spec, value, tuple(prefixes))
        else:
            if do_field_terms:
                for pfx in field_prefixes:
                    add_terms(pfx)
            if do_global_terms:
                add_terms("")
        if do_field_values and spec.slot is not None:
            tv = self._typed_value(out, spec, ftype, value, path, geo=geo,
                                   ts=ts)
            if tv is not None:
                out.values.setdefault(spec.slot, []).append(tv)

    def _emit_text_terms(self, out, spec, value, prefixes: tuple):
        if getattr(out, "_defer", False):
            out.text_ops.append(
                (str(value), prefixes, spec.language, spec.stem_strategy,
                 spec.stop_strategy, spec.weight, spec.positions,
                 spec.position_start, spec.cjk_ngram, spec.cjk_words))
            return
        tg = tg_mod.TermGenerator(spec.language,
                                  stem_strategy=spec.stem_strategy,
                                  stop_strategy=spec.stop_strategy,
                                  cjk_ngram=spec.cjk_ngram,
                                  cjk_words=spec.cjk_words)
        tg.position = max(getattr(out, "_termpos", 0),
                          spec.position_start)
        tg.index_text(out.terms, str(value), wdf_inc=spec.weight,
                      prefixes=prefixes, with_positions=spec.positions)
        tg.increase_termpos()
        out._termpos = tg.position

    def _emit_terms(self, out, spec, ftype, value, prefix, path, geo=None,
                    ts=None):
        terms = out.terms
        if ftype == FieldType.TEXT:
            self._emit_text_terms(out, spec, value, (prefix,))
        elif ftype == FieldType.KEYWORD:
            term = prefix + str(value)
            if spec.bool_term:
                terms.add_boolean(term)
            else:
                terms.add(term.lower(), spec.weight)
        elif ftype in (FieldType.INTEGER, FieldType.POSITIVE, FieldType.FLOATING):
            num = _to_number(value, path)
            if getattr(out, "_defer", False):
                out.num_acc_ops.append((num, spec.accuracy, prefix))
            else:
                terms.add_boolean(prefix + ":" + ser.serialise_float_term(num))
                terms.add_booleans(
                    acc_mod.numeric_terms(num, spec.accuracy, prefix))
        elif ftype in (FieldType.DATE, FieldType.DATETIME):
            if ts is None:
                ts = dtutils.parse_datetime(value)
            if getattr(out, "_defer", False):
                out.date_acc_ops.append((ts, spec.accuracy, prefix))
            else:
                terms.add_boolean(prefix + ":" + ser.serialise_float_term(ts))
                terms.add_booleans(
                    acc_mod.date_terms(ts, spec.accuracy, prefix))
        elif ftype == FieldType.TIME:
            t = dtutils.parse_time(value)
            terms.add_boolean(prefix + ":" + ser.serialise_float_term(t))
        elif ftype == FieldType.TIMEDELTA:
            t = dtutils.parse_timedelta(value)
            terms.add_boolean(prefix + ":" + ser.serialise_float_term(t))
        elif ftype == FieldType.BOOLEAN:
            terms.add_boolean(prefix + ":" + ser.serialise_bool_term(_to_bool(value)))
        elif ftype == FieldType.UUID:
            terms.add_boolean(prefix + ":" + uuid64.normalise_uuid(str(value)))
        elif ftype == FieldType.IP:
            from xapiand_tpu_torch.utils import iputils

            ipf = iputils.parse_ip(value)
            terms.add_boolean(prefix + ":" + ser.serialise_float_term(ipf))
        elif ftype == FieldType.GEO:
            if geo is None:
                from xapiand_tpu_torch.geo import geospatial

                geo = geospatial.extract(value, error=spec.error)
            if getattr(out, "_defer", False):
                # native inverter computes ancestors + formats the terms
                # in C++ (Inverter.add_geo_acc); same strings as geo_terms
                levels = spec.accuracy if spec.accuracy is not None \
                    else acc_mod.DEF_ACC_GEO
                out.geo_acc_ops.append(
                    (geo[0], tuple(int(lv) for lv in levels), prefix))
            else:
                terms.add_booleans(
                    acc_mod.geo_terms(geo[0], spec.accuracy, prefix))
        elif ftype == FieldType.SCRIPT:
            pass  # scripts are executed by the handler, not indexed
        else:
            raise SchemaError(f"cannot index type {ftype} at {path!r}")

    def _typed_value(self, out, spec, ftype, value, path, geo=None, ts=None):
        if ftype in (FieldType.INTEGER, FieldType.POSITIVE, FieldType.FLOATING):
            return float(_to_number(value, path))
        if ftype in (FieldType.DATE, FieldType.DATETIME):
            return ts if ts is not None else dtutils.parse_datetime(value)
        if ftype == FieldType.TIME:
            return dtutils.parse_time(value)
        if ftype == FieldType.TIMEDELTA:
            return dtutils.parse_timedelta(value)
        if ftype == FieldType.BOOLEAN:
            return bool(_to_bool(value))
        if ftype in (FieldType.KEYWORD, FieldType.TEXT):
            return str(value)
        if ftype == FieldType.UUID:
            return uuid64.normalise_uuid(str(value))
        if ftype == FieldType.IP:
            from xapiand_tpu_torch.utils import iputils

            return iputils.parse_ip(value)
        if ftype == FieldType.GEO:
            if geo is None:
                from xapiand_tpu_torch.geo import geospatial

                geo = geospatial.extract(value, error=spec.error)
            ranges, centroid = geo
            out.geo_ranges.setdefault(spec.slot, []).extend(ranges)
            return centroid  # (lat, lon) tuple
        return None


_PASSTHROUGH_KEYS = frozenset({
    "_meta", "_description", "_schema", "_settings", "_id", "_version",
    "_script", "_foreign", "_endpoint", "_chai",
})


def _to_number(value, path):
    if isinstance(value, bool):
        raise SchemaError(f"expected number at {path!r}")
    if isinstance(value, (int, float)):
        return value
    try:
        return int(value)
    except (TypeError, ValueError):
        try:
            return float(value)
        except (TypeError, ValueError):
            raise SchemaError(f"expected number at {path!r}") from None


def _to_bool(value):
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        return value.lower() in ("true", "t", "1", "yes")
    return bool(value)
