"""Field types and index-mode flags.

Reference: src/database/schema.h - FieldType enum (schema.h:201-222 chars
S/K/U/X/Z/... per type) and TypeIndex bitfield (schema.h:50-68).
"""

from __future__ import annotations

import enum


class FieldType(str, enum.Enum):
    EMPTY = "empty"
    FOREIGN = "foreign"
    ARRAY = "array"
    OBJECT = "object"
    BOOLEAN = "boolean"
    DATE = "date"
    DATETIME = "datetime"
    FLOATING = "floating"
    GEO = "geo"
    INTEGER = "integer"
    KEYWORD = "keyword"
    POSITIVE = "positive"
    SCRIPT = "script"
    TEXT = "text"
    TIME = "time"
    TIMEDELTA = "timedelta"
    UUID = "uuid"
    IP = "ip"

    @property
    def is_numeric(self) -> bool:
        return self in (FieldType.INTEGER, FieldType.POSITIVE, FieldType.FLOATING)

    @property
    def is_temporal(self) -> bool:
        return self in (FieldType.DATE, FieldType.DATETIME, FieldType.TIME,
                        FieldType.TIMEDELTA)


# canonical single-char type markers used in term payload prefixes
# (mirrors get_ctype, schema.h)
TYPE_CHAR = {
    FieldType.BOOLEAN: "B", FieldType.DATE: "D", FieldType.DATETIME: "D",
    FieldType.FLOATING: "F", FieldType.GEO: "G", FieldType.INTEGER: "N",
    FieldType.KEYWORD: "K", FieldType.POSITIVE: "P", FieldType.TEXT: "S",
    FieldType.TIME: "Z", FieldType.TIMEDELTA: "Z", FieldType.UUID: "U",
    FieldType.IP: "I",
}


class TypeIndex(enum.IntFlag):
    """What to index for a field (TypeIndex bitfield, schema.h:50-68)."""

    NONE = 0
    FIELD_TERMS = 0b0001
    FIELD_VALUES = 0b0010
    FIELD_ALL = FIELD_TERMS | FIELD_VALUES
    GLOBAL_TERMS = 0b0100
    TERMS = GLOBAL_TERMS | FIELD_TERMS
    GLOBAL_VALUES = 0b1000
    VALUES = GLOBAL_VALUES | FIELD_VALUES
    GLOBAL_ALL = GLOBAL_VALUES | GLOBAL_TERMS
    ALL = GLOBAL_ALL | FIELD_ALL


_INDEX_NAMES = {
    "none": TypeIndex.NONE,
    "field_terms": TypeIndex.FIELD_TERMS,
    "field_values": TypeIndex.FIELD_VALUES,
    "field_all": TypeIndex.FIELD_ALL,
    "field": TypeIndex.FIELD_ALL,
    "global_terms": TypeIndex.GLOBAL_TERMS,
    "terms": TypeIndex.TERMS,
    "global_values": TypeIndex.GLOBAL_VALUES,
    "values": TypeIndex.VALUES,
    "global_all": TypeIndex.GLOBAL_ALL,
    "global": TypeIndex.GLOBAL_ALL,
    "all": TypeIndex.ALL,
}


def parse_index(value) -> TypeIndex:
    if isinstance(value, TypeIndex):
        return value
    if isinstance(value, str):
        out = TypeIndex.NONE
        for part in value.split(","):
            part = part.strip().lower()
            if part not in _INDEX_NAMES:
                raise ValueError(f"invalid _index: {value!r}")
            out |= _INDEX_NAMES[part]
        return out
    if isinstance(value, list):
        out = TypeIndex.NONE
        for part in value:
            out |= parse_index(part)
        return out
    raise ValueError(f"invalid _index: {value!r}")


def index_name(ti: TypeIndex) -> str:
    for name, v in _INDEX_NAMES.items():
        if v == ti and name not in ("field", "global"):
            return name
    parts = []
    for name in ("global_terms", "global_values", "field_terms", "field_values"):
        if _INDEX_NAMES[name] & ti:
            parts.append(name)
    return ",".join(parts) if parts else "none"


def parse_type(value: str) -> FieldType:
    v = str(value).strip().lower()
    aliases = {
        "string": FieldType.TEXT, "str": FieldType.TEXT,
        "int": FieldType.INTEGER, "number": FieldType.FLOATING,
        "float": FieldType.FLOATING, "bool": FieldType.BOOLEAN,
        "term": FieldType.KEYWORD, "point": FieldType.GEO,
        "ipv4": FieldType.IP, "ipv6": FieldType.IP,
    }
    if v in aliases:
        return aliases[v]
    # allow "foreign/object/array/<concrete>" paths like the reference's
    # sep_types; the last component is the concrete type
    last = v.split("/")[-1]
    try:
        return FieldType(last)
    except ValueError:
        raise ValueError(f"invalid _type: {value!r}") from None
