"""GeoSpatial extraction: MsgPack/GeoJSON-ish values -> HTM ranges + centroid.

Reference parity target: src/geospatial/geospatial.{h,cc} (GeoSpatial class
extracting _point/_circle/_polygon/... objects from document values).

Accepted forms:
  EWKT string                          "CIRCLE (-100 40, 1000)"
  {"_point": {"_longitude": .., "_latitude": ..}}
  {"_circle": {"_longitude": .., "_latitude": .., "_radius": metres}}
  {"_polygon": {"_longitude": [..], "_latitude": [..]}}
  {"_multipoint": ...}, {"_multicircle": ...}
  GeoJSON: {"type": "Point", "coordinates": [lon, lat]}, Polygon, MultiPoint
  [lon, lat] bare pair
"""

from __future__ import annotations

from xapiand_tpu_torch.geo import cartesian as C
from xapiand_tpu_torch.geo import ewkt, htm


class GeoError(ValueError):
    pass


def _norm(p):
    """Normalize a geometry payload map: _lat/_lon aliases, _units
    (degrees default, radians converted), _alt/_altitude/_srid accepted
    (WGS84-only engine: srid/altitude don't shift the HTM cover; ≙
    geospatial.cc:203 process_units + RESERVED_GEO_* aliases)."""
    if not isinstance(p, dict):
        return p
    out = dict(p)
    if "_lat" in out and "_latitude" not in out:
        out["_latitude"] = out["_lat"]
    if "_lon" in out and "_longitude" not in out:
        out["_longitude"] = out["_lon"]
    units = str(out.get("_units", "degrees")).lower()
    if units not in ("degrees", "radians"):
        raise GeoError("_units must be 'degrees' or 'radians'")
    if units == "radians":
        import math
        for k in ("_latitude", "_longitude"):
            v = out.get(k)
            if isinstance(v, (list, tuple)):
                out[k] = [math.degrees(float(x)) for x in v]
            elif v is not None:
                out[k] = math.degrees(float(v))
    return out


def _radius_list(p, n):
    r = p.get("_radius", 0.0)
    if isinstance(r, (list, tuple)):
        return [C.metres_to_radians(float(x)) for x in r]
    return [C.metres_to_radians(float(r))] * n


def _poly(p):
    p = _norm(p)
    lats, lons = p["_latitude"], p["_longitude"]
    # nested lists = multiple rings/polygons
    if lats and isinstance(lats[0], (list, tuple)):
        return htm.MultiRegion([
            htm.ConvexPolygon(list(zip(la, lo)))
            for la, lo in zip(lats, lons)])
    return htm.ConvexPolygon(list(zip(lats, lons)))


def _convex(p):
    """CONVEX geometry = intersection of caps (geometry/convex.h)."""
    p = _norm(p)
    lats, lons = p["_latitude"], p["_longitude"]
    radii = _radius_list(p, len(lats))
    return htm.IntersectionRegion([
        htm.Cap(lat, lon, r) for lat, lon, r in zip(lats, lons, radii)])


_GEOMETRY_KEYS = ("_point", "_circle", "_polygon", "_chull", "_convex",
                  "_multipoint", "_multicircle", "_multipolygon",
                  "_multichull", "_multiconvex", "_ewkt",
                  "_geometrycollection", "_geometryintersection")


def to_region(value) -> htm.Region:
    if isinstance(value, str):
        return ewkt.parse(value)
    if isinstance(value, (list, tuple)) and len(value) == 2 and all(
            isinstance(v, (int, float)) for v in value):
        lon, lat = value
        return htm.Cap(lat, lon, ewkt._point_radius())
    if isinstance(value, dict):
        if "_ewkt" in value:
            return ewkt.parse(str(value["_ewkt"]))
        if "_point" in value:
            p = _norm(value["_point"])
            return htm.Cap(p["_latitude"], p["_longitude"], ewkt._point_radius())
        if "_circle" in value:
            p = _norm(value["_circle"])
            return htm.Cap(p["_latitude"], p["_longitude"],
                           C.metres_to_radians(float(p["_radius"])))
        if "_polygon" in value or "_chull" in value:
            return _poly(value.get("_polygon") or value.get("_chull"))
        if "_convex" in value:
            return _convex(value["_convex"])
        if "_multipolygon" in value or "_multichull" in value:
            return _poly(value.get("_multipolygon")
                         or value.get("_multichull"))
        if "_multiconvex" in value:
            p = _norm(value["_multiconvex"])
            lats, lons = p["_latitude"], p["_longitude"]
            rr = p.get("_radius", 0.0)   # metres; _convex converts
            rlist = rr if isinstance(rr, (list, tuple)) \
                else [rr] * len(lats)
            return htm.MultiRegion([
                _convex({"_latitude": la, "_longitude": lo, "_radius": r})
                for la, lo, r in zip(lats, lons, rlist)])
        if "_multipoint" in value:
            p = _norm(value["_multipoint"])
            return htm.MultiRegion([
                htm.Cap(lat, lon, ewkt._point_radius())
                for lat, lon in zip(p["_latitude"], p["_longitude"])])
        if "_multicircle" in value:
            p = _norm(value["_multicircle"])
            lats = p["_latitude"]
            return htm.MultiRegion([
                htm.Cap(lat, lon, r) for lat, lon, r in
                zip(lats, p["_longitude"], _radius_list(p, len(lats)))])
        if "_geometrycollection" in value:
            # map of geometry-cast keys -> union (make_collection,
            # geospatial.cc:640)
            members = value["_geometrycollection"]
            return htm.MultiRegion([
                to_region({k: v}) for k, v in members.items()
                if k in _GEOMETRY_KEYS])
        if "_geometryintersection" in value:
            members = value["_geometryintersection"]
            return htm.IntersectionRegion([
                to_region({k: v}) for k, v in members.items()
                if k in _GEOMETRY_KEYS])
        t = str(value.get("type", "")).lower()
        coords = value.get("coordinates")
        if t == "point" and coords:
            return htm.Cap(coords[1], coords[0], ewkt._point_radius())
        if t == "polygon" and coords:
            ring = coords[0]
            pts = [(lat, lon) for lon, lat in ring]
            if len(pts) > 1 and pts[0] == pts[-1]:
                pts = pts[:-1]
            return htm.ConvexPolygon(pts)
        if t == "multipoint" and coords:
            return htm.MultiRegion([
                htm.Cap(lat, lon, ewkt._point_radius()) for lon, lat in coords])
        if t == "circle" and coords:
            return htm.Cap(coords[1], coords[0],
                           C.metres_to_radians(float(value.get("radius", 1.0))))
    raise GeoError(f"cannot interpret geo value: {value!r}")


def extract(value, error: float = 0.3) -> tuple[list[tuple[int, int]],
                                                tuple[float, float]]:
    """value -> (level-MAX HTM id ranges, centroid (lat, lon)).

    ``error`` mirrors the reference's HTM error knob (htm.h:39-51); smaller
    error -> deeper cover level. We map it onto a level cap."""
    region = to_region(value)
    level = htm.MAX_LEVEL
    if error >= 0.5:
        level = max(6, htm.MAX_LEVEL - 4)
    elif error >= 0.2:
        level = max(8, htm.MAX_LEVEL - 2)
    ranges = htm.cover(region, level=level)
    return ranges, region.centroid_latlon()
