"""Geodetic <-> geocentric unit-vector conversion (WGS84).

Reference parity target: src/geospatial/cartesian.{h,cc} (Cartesian class
with datum transforms; WGS84 is the default datum there too).
"""

from __future__ import annotations

import math

# WGS84
_A = 6378137.0
_E2 = 0.00669437999014132
EARTH_RADIUS_M = 6371008.8  # mean radius, used for metre->radian conversion


def toCartesian(lat_deg: float, lon_deg: float, height: float = 0.0) -> tuple:
    """(lat, lon) degrees -> unit vector on the geocentric sphere.

    Applies the geodetic-latitude correction (scaled by the prime vertical
    radius) then normalises, matching Cartesian::toCartesian behaviour."""
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    cos_lat = math.cos(lat)
    sin_lat = math.sin(lat)
    n = _A / math.sqrt(1.0 - _E2 * sin_lat * sin_lat)
    x = (n + height) * cos_lat * math.cos(lon)
    y = (n + height) * cos_lat * math.sin(lon)
    z = (n * (1.0 - _E2) + height) * sin_lat
    return normalize((x, y, z))


def toLatLon(v: tuple) -> tuple:
    """Unit vector -> (lat, lon) degrees (geodetic)."""
    x, y, z = v
    lon = math.degrees(math.atan2(y, x))
    hyp = math.hypot(x, y)
    # inverse of toCartesian at height 0: z/hyp = (1-e2)*tan(lat)
    lat = math.atan2(z, hyp * (1.0 - _E2))
    return math.degrees(lat), lon


def normalize(v) -> tuple:
    x, y, z = v
    norm = math.sqrt(x * x + y * y + z * z)
    if norm == 0:
        raise ValueError("zero vector")
    return (x / norm, y / norm, z / norm)


def dot(a, b) -> float:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b) -> tuple:
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def add(a, b) -> tuple:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def midpoint(a, b) -> tuple:
    return normalize(add(a, b))


def angle_between(a, b) -> float:
    """Angular distance in radians between two unit vectors."""
    d = max(-1.0, min(1.0, dot(a, b)))
    return math.acos(d)


def metres_to_radians(m: float) -> float:
    return m / EARTH_RADIUS_M


def haversine_meters(lat1: float, lon1: float,
                     lat2: float, lon2: float) -> float:
    """Great-circle distance in meters (used by geo distance sort keys,
    ≙ GeoKey/Metric in src/multivalue/keymaker.h)."""
    import math

    r = math.pi / 180.0
    dlat = (lat2 - lat1) * r * 0.5
    dlon = (lon2 - lon1) * r * 0.5
    a = math.sin(dlat) ** 2 + math.cos(lat1 * r) * math.cos(lat2 * r) \
        * math.sin(dlon) ** 2
    return 2.0 * 6371008.8 * math.asin(min(math.sqrt(a), 1.0))
