"""Accuracy terms: bucketed terms for fast numeric/date/geo range queries.

Reference parity target: GenerateTerms (src/multivalue/generate_terms.h:57-116,
generate_terms.cc): at index time each numeric/date/geo value emits one term
per configured accuracy level; at query time a range picks the coarsest level
that covers it with few terms and ORs those posting lists, with the exact
bound check done against value slots (in the TPU build: a vectorised compare
over the dense device value column - see xapiand_tpu.ops.values).

Term shapes (host-level strings; device sees dictionary ids):
  numeric:  "<prefix>#<acc>:<bucket>"      bucket = floor(value / acc)
  date:     "<prefix>#D<unit>:<int ts>"    ts truncated to the unit
  geo:      "<prefix>#G<level>:<trixel>"   HTM trixel id at level
"""

from __future__ import annotations

import math

from xapiand_tpu_torch.utils import dtutils

DEF_ACC_NUMERIC = [100, 1000, 10000, 100000, 1000000, 100000000]
DEF_ACC_DATE = ["hour", "day", "month", "year", "decade", "century"]
DEF_ACC_GEO = [3, 5, 8, 10, 12, 13]  # HTM levels (device max = htm.MAX_LEVEL)

MAX_RANGE_TERMS = 256
# Geo covers use a lower cap: each cover term becomes a separate posting
# slice in the executor with a 128-row class floor, so 256 tiny terms =
# a 32k-row floor AND a 256-slice XLA graph (minutes of compile, most
# rows padding). 64 coarser-level terms over-select a little more - the
# exact HTM range test corrects - at 4x fewer slices and floor rows.
GEO_COVER_MAX_TERMS = 64


def numeric_terms(value: float, accuracies=None, prefix: str = "") -> list[str]:
    accuracies = DEF_ACC_NUMERIC if accuracies is None else accuracies
    out = []
    for acc in accuracies:
        bucket = math.floor(value / acc)
        out.append(f"{prefix}#{acc}:{bucket}")
    return out


def date_terms(ts: float, units=None, prefix: str = "") -> list[str]:
    units = DEF_ACC_DATE if units is None else units
    out = []
    for unit in units:
        t = dtutils.truncate_to(ts, unit)
        out.append(f"{prefix}#D{unit}:{int(t)}")
    return out


def geo_terms(ranges, levels=None, prefix: str = "") -> list[str]:
    """Terms for HTM trixel ranges (list of (start,end) id ranges at
    MAX_LEVEL). Each configured level emits the ancestor trixels."""
    from xapiand_tpu_torch.geo import htm

    levels = DEF_ACC_GEO if levels is None else levels
    out = set()
    for level in levels:
        for tid in htm.ancestors_of_ranges(ranges, level):
            out.add(f"{prefix}#G{level}:{tid}")
    return sorted(out)


def numeric_range_terms(lo: float, hi: float, accuracies=None,
                        prefix: str = "",
                        max_terms: int = MAX_RANGE_TERMS) -> list[str]:
    """Accuracy terms covering [lo, hi]; [] means no cover exists (caller
    falls back to a full-column scan). The cover may over-select: the caller
    always applies the exact value filter."""
    accuracies = sorted(DEF_ACC_NUMERIC if accuracies is None else accuracies)
    for acc in accuracies:
        b_lo = math.floor(lo / acc)
        b_hi = math.floor(hi / acc)
        n = b_hi - b_lo + 1
        if n <= max_terms:
            return [f"{prefix}#{acc}:{b}" for b in range(b_lo, b_hi + 1)]
    return []


_UNIT_SECONDS = {
    "second": 1, "minute": 60, "hour": 3600, "day": 86400,
    "month": 86400 * 28, "year": 86400 * 365,
    "decade": 86400 * 3650, "century": 86400 * 36500,
    "millennium": 86400 * 365000,
}


def date_range_terms(lo_ts: float, hi_ts: float, units=None,
                     prefix: str = "",
                     max_terms: int = MAX_RANGE_TERMS) -> list[str]:
    units = DEF_ACC_DATE if units is None else units
    units = sorted(units, key=lambda u: _UNIT_SECONDS[u])
    for unit in units:
        approx = (hi_ts - lo_ts) / _UNIT_SECONDS[unit] + 2
        if approx > max_terms * 1.5:
            continue
        terms = []
        t = dtutils.truncate_to(lo_ts, unit)
        guard = 0
        while t <= hi_ts and guard <= max_terms:
            terms.append(f"{prefix}#D{unit}:{int(t)}")
            t = _next_unit(t, unit)
            guard += 1
        if guard <= max_terms:
            return terms
    return []


def _next_unit(ts: float, unit: str) -> float:
    """Start of the next calendar unit after the unit containing ts."""
    import datetime as _dt

    dt = _dt.datetime.fromtimestamp(ts, tz=dtutils.UTC)
    if unit == "second":
        return ts + 1
    if unit == "minute":
        return ts + 60
    if unit == "hour":
        return ts + 3600
    if unit == "day":
        return ts + 86400
    if unit == "month":
        y, m = (dt.year + 1, 1) if dt.month == 12 else (dt.year, dt.month + 1)
        return dt.replace(year=y, month=m, day=1).timestamp()
    years = {"year": 1, "decade": 10, "century": 100, "millennium": 1000}[unit]
    return dt.replace(year=dt.year + years).timestamp()


def geo_range_cover(ranges, levels=None, prefix: str = "",
                    max_terms: int = MAX_RANGE_TERMS) -> list[str]:
    """Pick the finest HTM level whose ancestor-trixel cover of the query
    region fits max_terms."""
    from xapiand_tpu_torch.geo import htm

    levels = sorted(DEF_ACC_GEO if levels is None else levels, reverse=True)
    for level in levels:
        tids = htm.ancestors_of_ranges(ranges, level)
        if len(tids) <= max_terms:
            return [f"{prefix}#G{level}:{t}" for t in sorted(tids)]
    return []
