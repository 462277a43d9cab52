"""Hash functions used for shard routing, endpoint hashing and integrity.

Reference parity targets:
- fnv1ah64: shard routing hash (src/hashes.hh; used at src/database/handler.cc:2004
  ``fnv1ah64(term) % n_shards``). Bit-exact parity matters so that a document
  indexed by either engine lands on the same shard number.
- xxh64: endpoint hashing (src/database/utils.h:115-117) - via the xxhash lib.
- md5/sha256 (src/hash/) - via hashlib.
"""

from __future__ import annotations

import hashlib

try:
    import xxhash as _xxhash
except ImportError:  # pragma: no cover
    _xxhash = None

_FNV64_PRIME = 0x100000001B3
_FNV64_OFFSET = 0xCBF29CE484222325
_MASK64 = (1 << 64) - 1


def fnv1ah64(data: bytes | str) -> int:
    """FNV-1a 64-bit (src/hashes.hh fnv1ah64 semantics)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = _FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & _MASK64
    return h


def xxh64(data: bytes | str, seed: int = 0) -> int:
    if isinstance(data, str):
        data = data.encode("utf-8")
    if _xxhash is not None:
        return _xxhash.xxh64_intdigest(data, seed)
    # Fallback (not bit-compatible, only used if xxhash is unavailable).
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def md5_hex(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return hashlib.md5(data).hexdigest()


def sha256_hex(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return hashlib.sha256(data).hexdigest()
