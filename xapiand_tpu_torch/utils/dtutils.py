"""Datetime / date / time / timedelta parsing and math.

Reference parity target: src/datetime.{h,cc} (ISO-8601 parsing with optional
timezone, fractional seconds, and date math) and the `date`/`datetime`/`time`/
`timedelta` field types of the schema (src/database/schema.h:201-222).

All values normalise to a float64 POSIX timestamp (UTC) for value slots and
range queries; accuracy terms are generated from UTC calendar fields
(xapiand_tpu.analysis.accuracy).
"""

from __future__ import annotations

import calendar
import datetime as _dt
import re
from typing import Union

UTC = _dt.timezone.utc

_ISO_RE = re.compile(
    r"^\s*(\d{4})([-/.])(\d{1,2})\2(\d{1,2})"
    r"(?:[Tt ](\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:[.,](\d{1,9}))?)?"
    r"(Z|[+-]\d{1,2}:?\d{2})?)?\s*$"
)

_TIME_RE = re.compile(
    r"^\s*(\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:[.,](\d{1,9}))?)?\s*$"
)

_TIMEDELTA_RE = re.compile(
    r"^\s*([+-]?)(\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:[.,](\d{1,9}))?)?\s*$"
)


class DatetimeError(ValueError):
    pass


def _tz_offset(tz: str | None) -> float:
    if not tz or tz in ("Z", "z"):
        return 0.0
    sign = 1 if tz[0] == "+" else -1
    body = tz[1:].replace(":", "")
    if len(body) == 3:
        body = "0" + body
    hours, mins = int(body[:2]), int(body[2:])
    return sign * (hours * 3600 + mins * 60)


def parse_datetime(value: Union[str, int, float, dict, _dt.datetime]) -> float:
    """Parse a datetime-ish value into a UTC POSIX timestamp (float seconds).

    Accepts ISO-8601 strings (date-only or full), POSIX numbers, dicts with
    ``{_year,_month,_day,_time}`` keys (reference: datetime.cc dict form),
    and datetime objects.
    """
    if isinstance(value, _dt.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=UTC)
        return value.timestamp()
    if isinstance(value, bool):
        raise DatetimeError(f"invalid datetime: {value!r}")
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, dict):
        # full reference map form (datetime.cc process_date_datetime):
        # _year/_month/_day (or a nested _date map), _time OR the split
        # _hour/_minute/_second/_fsec components
        d = value
        if isinstance(value.get("_date"), dict):
            d = {**value["_date"], **{k: v for k, v in value.items()
                                      if k != "_date"}}
        year = int(d.get("_year", 1970))
        month = int(d.get("_month", 1))
        day = int(d.get("_day", 1))
        base = _ymd_to_ts(year, month, day)
        t = d.get("_time")
        if t is not None:
            base += parse_time(t)
        else:
            base += int(d.get("_hour", 0)) * 3600 \
                + int(d.get("_minute", 0)) * 60 \
                + int(d.get("_second", d.get("_sec", 0))) \
                + float(d.get("_fsec", 0.0))
        return base
    if isinstance(value, str):
        m = _ISO_RE.match(value)
        if not m:
            raise DatetimeError(f"invalid datetime: {value!r}")
        year, _, month, day, hh, mm, ss, frac, tz = m.groups()
        ts = _ymd_to_ts(int(year), int(month), int(day))
        if hh is not None:
            ts += int(hh) * 3600 + int(mm) * 60
            if ss is not None:
                ts += int(ss)
            if frac is not None:
                ts += float("0." + frac)
            ts -= _tz_offset(tz)
        return ts
    raise DatetimeError(f"invalid datetime: {value!r}")


def _ymd_to_ts(year: int, month: int, day: int) -> float:
    if not (1 <= month <= 12):
        raise DatetimeError(f"invalid month: {month}")
    ndays = calendar.monthrange(year, month)[1]
    if not (1 <= day <= ndays):
        raise DatetimeError(f"invalid day: {day}")
    d = _dt.date(year, month, day)
    return float((d - _dt.date(1970, 1, 1)).days * 86400)


def parse_time(value: Union[str, int, float]) -> float:
    """Parse a time-of-day into seconds since midnight (reference: time type)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    m = _TIME_RE.match(str(value))
    if not m:
        raise DatetimeError(f"invalid time: {value!r}")
    hh, mm, ss, frac = m.groups()
    out = int(hh) * 3600 + int(mm) * 60
    if ss:
        out += int(ss)
    if frac:
        out += float("0." + frac)
    return float(out)


def parse_timedelta(value: Union[str, int, float]) -> float:
    """Parse a timedelta into signed seconds (reference: timedelta type)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    m = _TIMEDELTA_RE.match(str(value))
    if not m:
        raise DatetimeError(f"invalid timedelta: {value!r}")
    sign, hh, mm, ss, frac = m.groups()
    out = int(hh) * 3600 + int(mm) * 60
    if ss:
        out += int(ss)
    if frac:
        out += float("0." + frac)
    return -out if sign == "-" else float(out)


def timestamp_to_iso(ts: float) -> str:
    dt = _dt.datetime.fromtimestamp(ts, tz=UTC)
    if dt.microsecond:
        return dt.strftime("%Y-%m-%dT%H:%M:%S.%f")
    return dt.strftime("%Y-%m-%dT%H:%M:%S")


def calendar_fields(ts: float) -> tuple[int, int, int, int, int, int]:
    """(year, month, day, hour, minute, second) in UTC for accuracy terms."""
    dt = _dt.datetime.fromtimestamp(ts, tz=UTC)
    return dt.year, dt.month, dt.day, dt.hour, dt.minute, dt.second


def truncate_to(ts: float, unit: str) -> float:
    """Truncate a timestamp down to a calendar unit boundary (UTC).

    Units mirror the reference's date accuracy levels
    (src/multivalue/generate_terms.h:57-116): second, minute, hour, day,
    month, year, decade, century, millennium.
    """
    dt = _dt.datetime.fromtimestamp(ts, tz=UTC)
    if unit == "second":
        dt = dt.replace(microsecond=0)
    elif unit == "minute":
        dt = dt.replace(second=0, microsecond=0)
    elif unit == "hour":
        dt = dt.replace(minute=0, second=0, microsecond=0)
    elif unit == "day":
        dt = dt.replace(hour=0, minute=0, second=0, microsecond=0)
    elif unit == "month":
        dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "year":
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "decade":
        dt = dt.replace(year=dt.year - dt.year % 10, month=1, day=1,
                        hour=0, minute=0, second=0, microsecond=0)
    elif unit == "century":
        dt = dt.replace(year=dt.year - dt.year % 100, month=1, day=1,
                        hour=0, minute=0, second=0, microsecond=0)
    elif unit == "millennium":
        dt = dt.replace(year=dt.year - dt.year % 1000, month=1, day=1,
                        hour=0, minute=0, second=0, microsecond=0)
    else:
        raise DatetimeError(f"unknown datetime accuracy unit: {unit}")
    return dt.timestamp()


DATE_UNITS = ("second", "minute", "hour", "day", "month", "year",
              "decade", "century", "millennium")
