"""Geodetic datum transforms: any supported SRID → WGS84.

Reference parity target: src/geospatial/cartesian.{h,cc} — the
reference carries a table of 17 datums (cartesian.cc:66-153
``map_datums``) with per-datum ellipsoids (cartesian.cc:38-55) and
7-parameter Helmert transforms to WGS84 (cartesian.cc:299-318
``toWGS84``).  The ellipsoid axes and Helmert parameters are the
published EPSG/NATO constants (earth-info.nga.mil NATO_DT); any
implementation carries the same numbers.

The forward conversion (geodetic → geocentric) is the textbook prime-
vertical formula; the inverse here is Bowring's iteration rather than
the reference's Lin-Wang polynomial root — both converge far below the
HTM trixel resolution, and tests round-trip to < 1e-9 degrees.
"""

from __future__ import annotations

import math

# (major_axis a, minor_axis b) — first eccentricity² derived, not stored
_ELLIPSOIDS = {
    "WE": (6378137.0, 6356752.314245179),      # WGS84
    "RF": (6378137.0, 6356752.314140356),      # GRS80
    "AA": (6377563.396, 6356256.909237285),    # Airy 1830
    "AM": (6377340.189, 6356034.447938534),    # Modified Airy
    "IN": (6378388.0, 6356911.946127946),      # International 1924
    "BR": (6377397.155, 6356078.962818188),    # Bessel 1841
    "HE": (6378200.0, 6356818.169627891),      # Helmert 1906
    "AN": (6378160.0, 6356774.719195305),      # Australian National
    "CC": (6378206.4, 6356583.799998980),      # Clarke 1866
    "SA": (6378160.0, 6356774.719195305),      # South American 1969
    "KA": (6378245.0, 6356863.018773047),      # Krassovsky 1940
    "WD": (6378135.0, 6356750.520016093),      # WGS72
}

_AS = math.pi / (180.0 * 3600.0)  # arc-seconds → radians

# SRID → (ellipsoid code, tx, ty, tz [m], rx, ry, rz [rad], s [unitless])
# Rows mirror cartesian.cc map_datums (rotations there are stored as
# (v/3600)*RAD_PER_DEG and scale as ppm/1e6 — same normalised units).
DATUMS = {
    4326: ("WE", 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),            # WGS84
    4322: ("WD", 0.0, 0.0, 4.5, 0.0, 0.0, 0.554 * _AS,          # WGS72
           0.219e-6),
    4269: ("RF", 1.0, 1.0, -1.0, 0.0, 0.0, 0.0, 0.0),           # NAD83
    4267: ("CC", -8.0, 160.0, 176.0, 0.0, 0.0, 0.0, 0.0),       # NAD27
    4277: ("AA", 446.448, -125.157, 542.06, 0.150 * _AS,        # OSGB36
           0.247 * _AS, 0.8421 * _AS, -20.4894e-6),
    4300: ("AM", 482.5, -130.6, 564.6, -1.042 * _AS,            # TM75
           -0.214 * _AS, -0.631 * _AS, 8.150e-6),
    4299: ("AM", 482.530, -130.596, 564.557, -1.042 * _AS,      # TM65
           -0.214 * _AS, -0.631 * _AS, 8.150e-6),
    4668: ("IN", -86.0, -98.0, -119.0, 0.0, 0.0, 0.0, 0.0),     # ED79
    4230: ("IN", -87.0, -98.0, -121.0, 0.0, 0.0, 0.0, 0.0),     # ED50
    4301: ("BR", -148.0, 507.0, 685.0, 0.0, 0.0, 0.0, 0.0),     # TOYA
    4314: ("BR", 582.0, 105.0, 414.0, 1.04 * _AS, 0.35 * _AS,   # DHDN
           -3.08 * _AS, 8.3e-6),
    4229: ("HE", -130.0, 110.0, -13.0, 0.0, 0.0, 0.0, 0.0),     # OEG
    4203: ("AN", -116.0, -50.47, 141.69, 0.23 * _AS,            # AGD84
           0.39 * _AS, 0.344 * _AS, 0.0983e-6),
    4618: ("SA", -57.0, 1.0, -41.0, 0.0, 0.0, 0.0, 0.0),        # SAD69
    4178: ("KA", 21.58719, -97.541, -60.925, 1.01378 * _AS,     # PUL42
           0.58117 * _AS, 0.2348 * _AS, -4.6121e-6),
    3906: ("BR", 515.149, 186.233, 511.959, 5.49721 * _AS,      # MGI1901
           3.51742 * _AS, -12.948 * _AS, 0.782e-6),
    4121: ("RF", -199.87, 74.79, 246.62, 0.0, 0.0, 0.0, 0.0),   # GGRS87
}

# SRIDs treated as already-WGS84 by the rest of the geo stack
WGS84_FAMILY = frozenset({4326, 4979, 4083})


def is_srid_supported(srid: int) -> bool:
    """≙ Cartesian::is_SRID_supported (cartesian.cc:563-566)."""
    return srid in DATUMS or srid in WGS84_FAMILY


def _e2(code: str) -> float:
    a, b = _ELLIPSOIDS[code]
    return 1.0 - (b * b) / (a * a)


def geodetic_to_geocentric(lat_deg: float, lon_deg: float, height: float,
                           code: str) -> tuple[float, float, float]:
    """≙ Cartesian::toCartesian (cartesian.cc:330-360)."""
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    if not -math.pi / 2 <= lat <= math.pi / 2:
        raise ValueError("Latitude out-of-range")
    a, _ = _ELLIPSOIDS[code]
    e2 = _e2(code)
    sin_lat = math.sin(lat)
    n = a / math.sqrt(1.0 - e2 * sin_lat * sin_lat)
    cos_lat = math.cos(lat)
    return ((n + height) * cos_lat * math.cos(lon),
            (n + height) * cos_lat * math.sin(lon),
            ((1.0 - e2) * n + height) * sin_lat)


def geocentric_to_geodetic(x: float, y: float, z: float,
                           code: str = "WE") -> tuple[float, float, float]:
    """Inverse of geodetic_to_geocentric via Bowring's iteration
    (the reference uses Lin-Wang 1995, cartesian.cc:376-420 — same
    fixed point to well below trixel resolution)."""
    a, b = _ELLIPSOIDS[code]
    e2 = _e2(code)
    ep2 = (a * a - b * b) / (b * b)
    p = math.hypot(x, y)
    lon = math.atan2(y, x)
    if p < 1e-12:  # on the polar axis
        lat = math.copysign(math.pi / 2, z)
        return (math.degrees(lat), math.degrees(lon), abs(z) - b)
    theta = math.atan2(z * a, p * b)
    lat = math.atan2(z + ep2 * b * math.sin(theta) ** 3,
                     p - e2 * a * math.cos(theta) ** 3)
    for _ in range(8):
        sin_lat = math.sin(lat)
        n = a / math.sqrt(1.0 - e2 * sin_lat * sin_lat)
        new_lat = math.atan2(z + e2 * n * sin_lat, p)
        if abs(new_lat - lat) < 1e-15:
            lat = new_lat
            break
        lat = new_lat
    sin_lat = math.sin(lat)
    n = a / math.sqrt(1.0 - e2 * sin_lat * sin_lat)
    cos_lat = math.cos(lat)
    height = p / cos_lat - n if abs(cos_lat) > 1e-12 else abs(z) - b
    return (math.degrees(lat), math.degrees(lon), height)


def helmert_to_wgs84(x: float, y: float, z: float,
                     srid: int) -> tuple[float, float, float]:
    """7-parameter Helmert transform (≙ Cartesian::toWGS84,
    cartesian.cc:299-318: small-angle rotation matrix + scale + shift)."""
    code, tx, ty, tz, rx, ry, rz, s = DATUMS[srid]
    s1 = s + 1.0
    return (tx + s1 * (x - rz * y + ry * z),
            ty + s1 * (rz * x + y - rx * z),
            tz + s1 * (-ry * x + rx * y + z))


def to_wgs84(lat_deg: float, lon_deg: float, height: float,
             srid: int) -> tuple[float, float, float]:
    """Geodetic coordinates on `srid`'s datum → geodetic WGS84.

    ≙ Cartesian::Cartesian(lat, lon, h, units, SRID) + toWGS84()
    (cartesian.cc:167-180): forward to geocentric on the source
    ellipsoid, Helmert-shift the frame, invert on the WGS84 ellipsoid.
    """
    if srid in WGS84_FAMILY:
        return (lat_deg, lon_deg, height)
    if srid not in DATUMS:
        raise ValueError(f"SRID = {srid} is not supported")
    code = DATUMS[srid][0]
    x, y, z = geodetic_to_geocentric(lat_deg, lon_deg, height, code)
    x, y, z = helmert_to_wgs84(x, y, z, srid)
    return geocentric_to_geodetic(x, y, z, "WE")
