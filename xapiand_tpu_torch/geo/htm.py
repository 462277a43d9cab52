"""Hierarchical Triangular Mesh: trixel ids, point location, region covers.

Reference parity target: src/geospatial/htm.{h,cc} (level <= 25 trixels,
trixel id <-> ranges, getTrixels). The TPU build fixes the *device* level at
``DEVICE_LEVEL`` = 13 so every trixel id fits an int32 (root ids 8..15,
child = 4*id + k, so level-13 ids < 16 * 4**13 = 2**30); host-side covers may
use any level <= 13 internally and always emit level-13 id ranges.

Canonical SDSS HTM root decomposition: S0..S3 ids 8..11, N0..N3 ids 12..15.
"""

from __future__ import annotations

import math

from xapiand_tpu_torch.geo import cartesian as C

DEVICE_LEVEL = 13
MAX_LEVEL = 13  # host cover level == device level in this build

_V = [
    (0.0, 0.0, 1.0),    # v0 north pole
    (1.0, 0.0, 0.0),    # v1
    (0.0, 1.0, 0.0),    # v2
    (-1.0, 0.0, 0.0),   # v3
    (0.0, -1.0, 0.0),   # v4
    (0.0, 0.0, -1.0),   # v5 south pole
]

# (id, v0, v1, v2) canonical HTM roots
_ROOTS = [
    (8, _V[1], _V[5], _V[2]),   # S0
    (9, _V[2], _V[5], _V[3]),   # S1
    (10, _V[3], _V[5], _V[4]),  # S2
    (11, _V[4], _V[5], _V[1]),  # S3
    (12, _V[1], _V[0], _V[4]),  # N0
    (13, _V[4], _V[0], _V[3]),  # N1
    (14, _V[3], _V[0], _V[2]),  # N2
    (15, _V[2], _V[0], _V[1]),  # N3
]

_EPS = -1e-12


def _contains(a, b, c, p) -> bool:
    return (C.dot(C.cross(a, b), p) >= _EPS
            and C.dot(C.cross(b, c), p) >= _EPS
            and C.dot(C.cross(c, a), p) >= _EPS)


def _children(tid, a, b, c):
    w0 = C.midpoint(b, c)
    w1 = C.midpoint(a, c)
    w2 = C.midpoint(a, b)
    return (
        (tid * 4 + 0, a, w2, w1),
        (tid * 4 + 1, b, w0, w2),
        (tid * 4 + 2, c, w1, w0),
        (tid * 4 + 3, w0, w1, w2),
    )


def point_to_trixel(lat: float, lon: float, level: int = DEVICE_LEVEL) -> int:
    """Trixel id at `level` containing the point."""
    p = C.toCartesian(lat, lon)
    for tid, a, b, c in _ROOTS:
        if _contains(a, b, c, p):
            cur = (tid, a, b, c)
            break
    else:  # numerical edge case: snap to the nearest root by centroid
        cur = max(_ROOTS, key=lambda r: C.dot(C.normalize(
            C.add(C.add(r[1], r[2]), r[3])), p))
    tid, a, b, c = cur
    for _ in range(level):
        for ctid, ca, cb, cc in _children(tid, a, b, c):
            if _contains(ca, cb, cc, p):
                tid, a, b, c = ctid, ca, cb, cc
                break
        else:
            # numerical fallback: nearest child centroid
            ctid, ca, cb, cc = max(
                _children(tid, a, b, c),
                key=lambda t: C.dot(C.normalize(C.add(C.add(t[1], t[2]), t[3])), p))
            tid, a, b, c = ctid, ca, cb, cc
    return tid


def trixel_range_at_level(tid: int, tid_level: int, level: int) -> tuple[int, int]:
    """Inclusive id range at `level` covered by trixel `tid` of `tid_level`."""
    if level < tid_level:
        raise ValueError("level must be >= trixel level")
    shift = 2 * (level - tid_level)
    return tid << shift, ((tid + 1) << shift) - 1


def ancestor(tid: int, tid_level: int, level: int) -> int:
    if level > tid_level:
        raise ValueError("ancestor level must be <= trixel level")
    return tid >> (2 * (tid_level - level))


_ROOT_NAMES = {8: "s0", 9: "s1", 10: "s2", 11: "s3",
               12: "n0", 13: "n1", 14: "n2", 15: "n3"}


def trixel_name(tid: int, level: int) -> str:
    """SDSS HTM name of a level-`level` trixel id, e.g. "s0231" (matches
    the reference's HTM::getTrixelName digit encoding, htm.cc)."""
    root = tid >> (2 * level)
    digits = "".join(str((tid >> (2 * (level - 1 - i))) & 3)
                     for i in range(level))
    return _ROOT_NAMES.get(root, f"?{root}") + digits


def ancestors_of_ranges(ranges, level: int) -> set[int]:
    """Unique ancestor trixel ids at `level` for level-MAX_LEVEL id ranges."""
    shift = 2 * (MAX_LEVEL - min(level, MAX_LEVEL))
    out: set[int] = set()
    for start, end in ranges:
        a, b = start >> shift, end >> shift
        if b - a > 4096:  # safety cap; callers escalate to coarser level
            b = a + 4096
        out.update(range(a, b + 1))
    return out


# --- region interfaces -------------------------------------------------------

class Region:
    """Spherical region supporting inside/intersection classification."""

    def classify(self, a, b, c) -> int:
        """-1 disjoint, 0 partial, 1 trixel fully inside region."""
        raise NotImplementedError

    def centroid_latlon(self) -> tuple[float, float]:
        raise NotImplementedError


class Cap(Region):
    """Spherical cap: all points within angle `radius` of `center`."""

    def __init__(self, lat: float, lon: float, radius_rad: float):
        self.center = C.toCartesian(lat, lon)
        self.radius = radius_rad
        self._cos_r = math.cos(min(radius_rad, math.pi))
        self._lat, self._lon = lat, lon

    def _inside(self, p) -> bool:
        return C.dot(self.center, p) >= self._cos_r

    def classify(self, a, b, c) -> int:
        ins = sum((self._inside(a), self._inside(b), self._inside(c)))
        if ins == 3:
            return 1  # cap is convex, triangle vertices inside -> whole inside
        if ins > 0:
            return 0
        # no vertex inside: intersects iff center is in the triangle or the
        # cap crosses one of the edges
        if _contains(a, b, c, self.center):
            return 0
        for u, v in ((a, b), (b, c), (c, a)):
            if _edge_min_angle(u, v, self.center) <= self.radius:
                return 0
        return -1

    def centroid_latlon(self):
        return self._lat, self._lon


class ConvexPolygon(Region):
    """Convex spherical polygon from (lat, lon) vertices (CCW)."""

    def __init__(self, latlons):
        pts = [C.toCartesian(lat, lon) for lat, lon in latlons]
        if len(pts) < 3:
            raise ValueError("polygon needs >= 3 vertices")
        # ensure counter-clockwise (positive orientation wrt centroid)
        cx = C.normalize(tuple(sum(p[i] for p in pts) for i in range(3)))
        if C.dot(C.cross(pts[0], pts[1]), cx) < 0:
            pts = pts[::-1]
        self.pts = pts
        self.edges = [C.cross(pts[i], pts[(i + 1) % len(pts)])
                      for i in range(len(pts))]
        self._centroid = cx

    def _inside(self, p) -> bool:
        return all(C.dot(e, p) >= _EPS for e in self.edges)

    def classify(self, a, b, c) -> int:
        ins = sum((self._inside(a), self._inside(b), self._inside(c)))
        if ins == 3:
            return 1
        if ins > 0:
            return 0
        # polygon vertex inside trixel?
        if any(_contains(a, b, c, p) for p in self.pts):
            return 0
        # edge crossings?
        tri_edges = ((a, b), (b, c), (c, a))
        n = len(self.pts)
        for i in range(n):
            p0, p1 = self.pts[i], self.pts[(i + 1) % n]
            for u, v in tri_edges:
                if _segments_cross(p0, p1, u, v):
                    return 0
        return -1

    def centroid_latlon(self):
        return C.toLatLon(self._centroid)


class MultiRegion(Region):
    """Union of regions (MultiPoint/MultiCircle/Collection)."""

    def __init__(self, regions):
        self.regions = list(regions)

    def classify(self, a, b, c) -> int:
        out = -1
        for r in self.regions:
            cl = r.classify(a, b, c)
            if cl == 1:
                return 1
            if cl == 0:
                out = 0
        return out

    def centroid_latlon(self):
        lats, lons = zip(*(r.centroid_latlon() for r in self.regions))
        return sum(lats) / len(lats), sum(lons) / len(lons)


class IntersectionRegion(Region):
    """Intersection of regions (≙ geometry/intersection.h Intersection;
    also the CONVEX geometry = intersection of caps). classify is exactly
    conservative: fully-inside iff inside every member, disjoint when
    disjoint from any - cover() then subdivides partials as usual."""

    def __init__(self, regions):
        self.regions = list(regions)
        if not self.regions:
            raise ValueError("intersection needs >= 1 region")

    def classify(self, a, b, c) -> int:
        out = 1
        for r in self.regions:
            cl = r.classify(a, b, c)
            if cl == -1:
                return -1
            if cl == 0:
                out = 0
        return out

    def centroid_latlon(self):
        lats, lons = zip(*(r.centroid_latlon() for r in self.regions))
        return sum(lats) / len(lats), sum(lons) / len(lons)


def _edge_min_angle(u, v, p) -> float:
    """Minimum angular distance from p to the great-circle segment (u, v)."""
    n = C.cross(u, v)
    nn = math.sqrt(C.dot(n, n))
    if nn == 0:
        return C.angle_between(u, p)
    n = (n[0] / nn, n[1] / nn, n[2] / nn)
    # closest point on the great circle
    d = C.dot(n, p)
    proj = C.normalize((p[0] - d * n[0], p[1] - d * n[1], p[2] - d * n[2]))
    # is the projection within the segment arc?
    if C.dot(C.cross(u, proj), n) >= 0 and C.dot(C.cross(proj, v), n) >= 0:
        return abs(math.asin(max(-1.0, min(1.0, d))))
    return min(C.angle_between(u, p), C.angle_between(v, p))


def _segments_cross(p0, p1, q0, q1) -> bool:
    n1 = C.cross(p0, p1)
    n2 = C.cross(q0, q1)
    s1, s2 = C.dot(n1, q0), C.dot(n1, q1)
    s3, s4 = C.dot(n2, p0), C.dot(n2, p1)
    if (s1 * s2 > 0) or (s3 * s4 > 0):
        return False
    # intersection direction
    x = C.cross(n1, n2)
    norm = math.sqrt(C.dot(x, x))
    if norm == 0:
        return False
    x = (x[0] / norm, x[1] / norm, x[2] / norm)
    for cand in (x, (-x[0], -x[1], -x[2])):
        if (C.dot(C.cross(p0, cand), n1) >= 0 and C.dot(C.cross(cand, p1), n1) >= 0
                and C.dot(C.cross(q0, cand), n2) >= 0
                and C.dot(C.cross(cand, q1), n2) >= 0):
            return True
    return False


def cover(region: Region, level: int = MAX_LEVEL,
          max_trixels: int = 4096) -> list[tuple[int, int]]:
    """HTM cover: sorted, merged, inclusive level-MAX_LEVEL id ranges for all
    trixels intersecting the region (partials at `level` are included, like
    the reference's getTrixels with partials).

    Cap regions route through the native port (xt_htm_cap_cover), which is
    bit-identical (same IEEE double ops in the same order; fuzz-gated by
    tests/test_native.py) - geo extraction dominates geotagged indexing."""
    if isinstance(region, Cap):
        from xapiand_tpu_torch import native

        if native.lib is not None and \
                hasattr(native.lib._c, "xt_htm_cap_cover"):
            out = native.lib.htm_cap_cover(region._lat, region._lon,
                                           region.radius, level,
                                           max_trixels)
            if out is not None:
                return out
            raise ValueError("cover too fine; use a coarser level")
    ranges: list[tuple[int, int]] = []

    def emit(tid, tlevel):
        ranges.append(trixel_range_at_level(tid, tlevel, MAX_LEVEL))

    stack = [(0, tid, a, b, c) for tid, a, b, c in _ROOTS]
    while stack:
        lvl, tid, a, b, c = stack.pop()
        cl = region.classify(a, b, c)
        if cl == -1:
            continue
        if cl == 1 or lvl >= level:
            emit(tid, lvl)
            continue
        stack.extend((lvl + 1, ctid, ca, cb, cc)
                     for ctid, ca, cb, cc in _children(tid, a, b, c))
    ranges.sort()
    merged: list[list[int]] = []
    for s, e in ranges:
        if merged and s <= merged[-1][1] + 1:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
        if len(merged) > max_trixels:
            raise ValueError("cover too fine; use a coarser level")
    return [(s, e) for s, e in merged]


def point_ranges(lat: float, lon: float) -> list[tuple[int, int]]:
    tid = point_to_trixel(lat, lon, MAX_LEVEL)
    return [(tid, tid)]


def ranges_intersect(r1, r2) -> bool:
    """Host-side check that two sorted range lists intersect."""
    i = j = 0
    while i < len(r1) and j < len(r2):
        a, b = r1[i]
        c, d = r2[j]
        if b < c:
            i += 1
        elif d < a:
            j += 1
        else:
            return True
    return False
