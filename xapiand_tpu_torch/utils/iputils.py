"""IP address parsing for the IP field type and IP aggregations.

The reference reserves `_ip_range` / `_geo_ip` aggregation names but ships
them disabled (src/aggregations/aggregations.cc:86-87 commented out); it has
no IP field type either. This build defines the natural semantics: an `ip`
field stores the address's integer value as a sortable numeric, so range
filters, `_ip_range` buckets and CIDR queries all ride the existing
order-preserving u64 sort keys (utils/serialise.py sortable_key_u64).

Precision: the numeric value is a float64. IPv4 (32 bits) is exact; IPv6
(128 bits) keeps the top 53 bits, i.e. prefixes through /53 compare exactly
and finer distinctions within the same /53 collapse (documented deviation -
the split point still orders correctly because float order == value order).
"""

from __future__ import annotations

import ipaddress


def parse_ip(value) -> float:
    """Address string/int -> order-preserving float of its integer value."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    addr = ipaddress.ip_address(str(value).strip())
    return float(int(addr))


def parse_ip_interval(value) -> tuple[float, float]:
    """CIDR or single address -> [lo, hi) half-open float interval."""
    s = str(value).strip()
    if "/" in s:
        net = ipaddress.ip_network(s, strict=False)
        lo = int(net.network_address)
        return float(lo), float(lo + net.num_addresses)
    v = int(ipaddress.ip_address(s))
    return float(v), float(v + 1)


def ip_interval_keys(value) -> tuple[int, int]:
    """CIDR or single address -> INCLUSIVE (lo_key, hi_key) sortable-u64
    pair, safe against float53 collapse.

    IPv6 prefixes finer than the float64 mantissa at the address's
    magnitude (finer than ~/53 for global-unicast space, including the
    standard /64) round ``float(lo + num_addresses)`` back onto
    ``float(lo)``; the naive ``key(hi) - 1`` then INVERTS the range and
    matches nothing. Clamp to an equal-key range instead so such queries
    degrade to the enclosing float-resolution bucket (every address that
    rounds with the prefix), never to silence."""
    from xapiand_tpu_torch.utils import serialise as ser

    lo_v, hi_v = parse_ip_interval(value)
    fkey = ser.sortable_key_u64(lo_v)
    tkey = ser.sortable_key_u64(hi_v) - 1
    if tkey < fkey:
        tkey = fkey
    return fkey, tkey


def format_ip(value: float, version_hint: int = 4) -> str:
    """Best-effort float -> address string (for response shaping)."""
    v = int(value)
    try:
        if v < 2**32 and version_hint == 4:
            return str(ipaddress.IPv4Address(v))
        return str(ipaddress.IPv6Address(v))
    except ValueError:
        return str(v)
