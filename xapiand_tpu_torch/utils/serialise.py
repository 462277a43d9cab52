"""Canonical order-preserving serialisation of typed values.

The reference encodes every sortable value into an order-preserving byte
string (src/sortable_serialise.cc: 9-byte float encoding;
src/serialise.cc:106+ per-type encodings) so that Xapian value slots compare
lexicographically. The TPU build needs *fixed-width integer* sort keys instead,
because device value columns are dense int32 pairs compared vectorised on the
VPU (see xapiand_tpu.ops.values). This module provides:

- ``sortable_key_u64(x)``: total-order-preserving uint64 key for a float64
  (IEEE-754 monotone bit trick; equivalent ordering to sortable_serialise).
- ``split_key(u64) -> (hi_i32, lo_i32)``: signed int32 pair whose
  lexicographic signed comparison preserves the u64 order (device layout).
- ``sortable_serialise/unserialise``: 8-byte big-endian host encoding
  (round-trips exactly; byte format intentionally differs from the
  reference's variable-length one - parity is at the *ordering* level).
- ``serialise_string_key``: 8-byte prefix key for string slots.
"""

from __future__ import annotations

import math
import struct

_SIGN = 1 << 63
_MASK64 = (1 << 64) - 1


def sortable_key_u64(x: float) -> int:
    """Map a float to a uint64 such that x < y  <=>  key(x) < key(y).

    NaN maps above +inf (stable, never produced by indexing which rejects
    NaN). -0.0 and +0.0 map to the same key, matching the reference where
    sortable_serialise(-0.0) == sortable_serialise(0.0).
    """
    if x == 0.0:
        x = 0.0  # normalise -0.0
    if isinstance(x, int):
        x = float(x)
    bits = struct.unpack("<Q", struct.pack("<d", x))[0]
    if bits & _SIGN:
        return (~bits) & _MASK64
    return bits | _SIGN


def sortable_keys_u64_np(x):
    """Vectorised sortable_key_u64 over a float64 numpy array."""
    import numpy as np

    x = np.asarray(x, np.float64)
    x = x + 0.0                       # normalises -0.0 to +0.0
    bits = x.view(np.uint64)
    neg = (bits >> np.uint64(63)) != 0
    return np.where(neg, ~bits, bits | np.uint64(1 << 63))


def split_keys_np(keys):
    """Vectorised split_key: uint64 array -> (hi, lo) int32 arrays."""
    import numpy as np

    keys = np.asarray(keys, np.uint64)
    hi = ((keys >> np.uint64(32)).astype(np.uint32)
          ^ np.uint32(0x80000000)).view(np.int32)
    lo = (keys.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    return hi, lo


def sortable_key_to_float(key: int) -> float:
    key &= _MASK64
    if key & _SIGN:
        bits = key & ~_SIGN
    else:
        bits = (~key) & _MASK64
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


def split_key(key: int) -> tuple[int, int]:
    """uint64 key -> (hi, lo) signed int32s; signed-lex compare == u64 compare."""
    hi = ((key >> 32) & 0xFFFFFFFF) ^ 0x80000000
    lo = (key & 0xFFFFFFFF) ^ 0x80000000
    # to signed int32
    if hi >= 0x80000000:
        hi -= 1 << 32
    if lo >= 0x80000000:
        lo -= 1 << 32
    return hi, lo


def join_key(hi: int, lo: int) -> int:
    hi = (hi + (1 << 32)) % (1 << 32)
    lo = (lo + (1 << 32)) % (1 << 32)
    return (((hi ^ 0x80000000) << 32) | (lo ^ 0x80000000)) & _MASK64


def sortable_serialise(x: float) -> bytes:
    """Order-preserving byte encoding of a float (8 bytes, big-endian key).

    Ordering-parity with the reference's sortable_serialise
    (src/sortable_serialise.cc:35-100); byte layout differs (fixed width).
    """
    return struct.pack(">Q", sortable_key_u64(x))


def sortable_unserialise(b: bytes) -> float:
    return sortable_key_to_float(struct.unpack(">Q", b[:8])[0])


def serialise_string_key(s: str) -> int:
    """uint64 key from the first 8 bytes of a UTF-8 string.

    Preserves order up to the 8-byte prefix; exact string order ties are
    broken host-side during hydration (the reference compares full byte
    strings; device columns are fixed width).
    """
    b = s.encode("utf-8")[:8]
    b = b + b"\x00" * (8 - len(b))
    return struct.unpack(">Q", b)[0]


# ---------------------------------------------------------------------------
# Typed term serialisation (host level): terms are strings "P<payload>" with
# a per-field prefix P, mirroring the reference's term scheme
# (src/serialise.cc Serialise::serialise; schema prefixes schema.h:307).
# Device level only ever sees dictionary-coded int32 term ids.
# ---------------------------------------------------------------------------

def serialise_float_term(x: float) -> str:
    """Canonical term payload for a numeric value (hex of sortable key)."""
    return format(sortable_key_u64(float(x)), "016x")


def unserialise_float_term(p: str) -> float:
    return sortable_key_to_float(int(p, 16))


def serialise_int_term(x: int) -> str:
    # Integers up to 2**63 get an exact, order-preserving encoding via the
    # float path only when exactly representable; otherwise use offset hex.
    return format((int(x) + (1 << 63)) & _MASK64, "016x")


def unserialise_int_term(p: str) -> int:
    return int(p, 16) - (1 << 63)


def serialise_bool_term(x: bool) -> str:
    return "t" if x else "f"


def is_simple_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)
