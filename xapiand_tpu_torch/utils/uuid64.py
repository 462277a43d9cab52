"""UUID generation and compact encodings.

Reference parity target: src/cuuid/ (v1/v4 UUIDs with "condensed" compact
serialisations, uuid.h:114-165; base59 encoding via base_x). Documents with
no explicit id get a fresh UUID (schema.cc:2749+); UUID-typed fields index a
canonical compact byte serialisation.
"""

from __future__ import annotations

import re
import uuid as _uuid

# base59 alphabet: base62 minus the visually ambiguous 0/O/l, as in the
# reference's cuuid base59 (src/cuuid/base_x.hh configuration).
_B59 = "123456789ABCDEFGHIJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
assert len(_B59) == 59
_B59_INDEX = {c: i for i, c in enumerate(_B59)}

_UUID_RE = re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$"
)


def generate_uuid() -> str:
    """Fresh v4 UUID string (reference default for missing doc ids)."""
    return str(_uuid.uuid4())


def generate_uuid1() -> str:
    return str(_uuid.uuid1())


def is_uuid(s: str) -> bool:
    if not isinstance(s, str):
        return False
    if _UUID_RE.match(s):
        return True
    if s.startswith("~") and all(c in _B59_INDEX for c in s[1:]) and s[1:]:
        return True
    if s.startswith("{") and s.endswith("}"):
        return bool(_UUID_RE.match(s[1:-1]))
    if s.startswith("urn:uuid:"):
        return bool(_UUID_RE.match(s[9:]))
    return False


def normalise_uuid(s: str) -> str:
    """Any accepted encoding -> canonical lowercase dashed form."""
    if s.startswith("~"):
        raw = b59_decode(s[1:])
        if len(raw) < 16:
            raw = b"\x00" * (16 - len(raw)) + raw
        return str(_uuid.UUID(bytes=raw))
    if s.startswith("{") and s.endswith("}"):
        s = s[1:-1]
    elif s.startswith("urn:uuid:"):
        s = s[9:]
    return str(_uuid.UUID(s))


def serialise_uuid(s: str) -> bytes:
    """Canonical 16-byte serialisation used as term payload / value."""
    return _uuid.UUID(normalise_uuid(s)).bytes


def unserialise_uuid(b: bytes) -> str:
    return str(_uuid.UUID(bytes=b))


def b59_encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    digits = []
    while n:
        n, r = divmod(n, 59)
        digits.append(_B59[r])
    body = "".join(reversed(digits))
    # leading zero bytes <-> leading zero digits, one per byte
    pad = 0
    for byte in data:
        if byte == 0:
            pad += 1
        else:
            break
    return _B59[0] * pad + body


def b59_decode(s: str) -> bytes:
    n = 0
    for c in s:
        n = n * 59 + _B59_INDEX[c]
    pad = 0
    for c in s:
        if c == _B59[0]:
            pad += 1
        else:
            break
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    return b"\x00" * pad + body


def encode_compact(s: str) -> str:
    """Condensed form: '~' + base59 of the 16 bytes (reference: uuid.h base59
    encoded 'condensed' UUIDs, CMake option UUID_ENCODED)."""
    return "~" + b59_encode(serialise_uuid(s))
