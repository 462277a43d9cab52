"""EWKT (extended well-known text) geometry parsing.

Reference parity target: src/geospatial/ewkt.{h,cc}. Supported forms
(coordinates are ``lon lat`` order, radius in metres, optional
``SRID=4326;`` prefix as in the reference's docs
docs/_docs/reference-guide/schemas/field-types/geospatial-type.md):

  POINT (lon lat)
  CIRCLE (lon lat, radius_m)
  POLYGON ((lon lat, lon lat, ...))
  MULTIPOINT ((lon lat), (lon lat), ...)
  MULTICIRCLE ((lon lat, r), ...)
  GEOMETRYCOLLECTION (<geom>, <geom>, ...)
"""

from __future__ import annotations

import re

from xapiand_tpu_torch.geo import cartesian as C
from xapiand_tpu_torch.geo import htm

_HEAD_RE = re.compile(
    r"^\s*(?:SRID\s*=\s*(\d+)\s*;)?\s*"
    r"(POINT|CIRCLE|POLYGON|MULTIPOINT|MULTICIRCLE|MULTIPOLYGON|"
    r"GEOMETRYCOLLECTION|CHULL)\s*\((.*)\)\s*$",
    re.IGNORECASE | re.DOTALL,
)


class EWKTError(ValueError):
    pass


def is_ewkt(s: str) -> bool:
    return isinstance(s, str) and bool(_HEAD_RE.match(s))


def _nums(body: str) -> list[float]:
    try:
        return [float(tok) for tok in re.split(r"[\s,]+", body.strip()) if tok]
    except ValueError as e:
        raise EWKTError(f"bad coordinates: {body!r}") from e


def _split_groups(body: str) -> list[str]:
    """Split a parenthesised list at top level: "(a),(b)" -> ["a", "b"]."""
    out, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
            if depth == 1:
                cur = []
                continue
        elif ch == ")":
            depth -= 1
            if depth == 0:
                out.append("".join(cur))
                continue
        if depth >= 1:
            cur.append(ch)
    if not out:
        raise EWKTError(f"expected parenthesised groups in {body!r}")
    return out


def parse(s: str, srid: int | None = None) -> htm.Region:
    """Parse EWKT into an HTM region. Non-WGS84 SRIDs from the
    reference's datum table (cartesian.cc:66-153) are Helmert-
    transformed to WGS84 geodetic coordinates before HTM cover
    generation (geo/datum.py); unknown SRIDs raise, matching
    Cartesian::is_SRID_supported. `srid` carries an outer SRID prefix
    into GEOMETRYCOLLECTION members (which have no prefix of their own).
    """
    m = _HEAD_RE.match(s)
    if not m:
        raise EWKTError(f"invalid EWKT: {s!r}")
    srid_s, kind, body = m.groups()
    if srid_s:
        srid = int(srid_s)
    if srid is not None and srid not in (4326, 4979, 4083):
        from xapiand_tpu_torch.geo import datum as _datum

        if not _datum.is_srid_supported(srid):
            raise EWKTError(f"unsupported SRID {srid}")
        _sr = srid

        def _ll(lat, lon):
            la, lo, _h = _datum.to_wgs84(lat, lon, 0.0, _sr)
            return la, lo
    else:
        def _ll(lat, lon):
            return lat, lon
    kind = kind.upper()
    if kind == "POINT":
        lon, lat = _nums(body)[:2]
        return htm.Cap(*_ll(lat, lon), _point_radius())
    if kind == "CIRCLE":
        nums = _nums(body)
        if len(nums) < 3:
            raise EWKTError(f"CIRCLE needs lon lat radius: {s!r}")
        lon, lat, radius = nums[:3]
        return htm.Cap(*_ll(lat, lon), C.metres_to_radians(radius))
    if kind in ("POLYGON", "CHULL"):
        ring = _split_groups(body)[0]
        nums = _nums(ring)
        pts = [_ll(nums[i + 1], nums[i])
               for i in range(0, len(nums) - 1, 2)]
        if len(pts) > 1 and pts[0] == pts[-1]:
            pts = pts[:-1]
        return htm.ConvexPolygon(pts)
    if kind == "MULTIPOINT":
        groups = _split_groups(body) if "(" in body else [body]
        regions = []
        for g in groups:
            nums = _nums(g)
            for i in range(0, len(nums) - 1, 2):
                regions.append(htm.Cap(*_ll(nums[i + 1], nums[i]),
                                       _point_radius()))
        return htm.MultiRegion(regions)
    if kind == "MULTICIRCLE":
        regions = []
        for g in _split_groups(body):
            lon, lat, radius = _nums(g)[:3]
            regions.append(htm.Cap(*_ll(lat, lon),
                                   C.metres_to_radians(radius)))
        return htm.MultiRegion(regions)
    if kind == "MULTIPOLYGON":
        regions = []
        for g in _split_groups(body):
            inner = _split_groups(g)[0] if "(" in g else g
            nums = _nums(inner)
            pts = [_ll(nums[i + 1], nums[i])
                   for i in range(0, len(nums) - 1, 2)]
            if len(pts) > 1 and pts[0] == pts[-1]:
                pts = pts[:-1]
            regions.append(htm.ConvexPolygon(pts))
        return htm.MultiRegion(regions)
    if kind == "GEOMETRYCOLLECTION":
        parts = _split_top_geoms(body)
        return htm.MultiRegion([parse(p, srid=srid) for p in parts])
    raise EWKTError(f"unsupported EWKT kind {kind}")


def _split_top_geoms(body: str) -> list[str]:
    out, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [p.strip() for p in out if p.strip()]


def _point_radius() -> float:
    """Points are tiny caps spanning roughly one level-MAX trixel."""
    import math

    return math.pi / (2 ** (htm.MAX_LEVEL + 1))
