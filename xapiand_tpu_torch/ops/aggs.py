"""On-device aggregations (torch port of ``xapiand_tpu/ops/aggs.py``, K17a
and K17b).

``compute_aggs`` walks ``ExecConfig.with_aggs`` in order over one launch
group's rows - the rows the ordering step reads: the compacted rows, or
every row on the fullwidth path - and returns the JAX ``compute_aggs``
structure with a leading query axis on every array:

  ("count",)                          i32[B]
  (sum | avg | min | max | variance | std_deviation | stats |
   extended_stats, slot)              {"n", "s", "s2", "min", "max"} f32[B]
  ("terms", slot, ncats, subs)        i32[B, ncats] without subs, else
                                      {"counts": i32[B, ncats], "subs":
                                      [{"n", "s", "s2", "min", "max"}
                                      f32[B, ncats] per sub]}
  ("missing", slot, subs)             {"count": i32[B][, "subs": [... f32
                                      [B, 1] per sub]]}
  ("cardinality", slot)               {"n", "maxn": i32[B] (the exact
                                      distinct count, twice), "hll":
                                      i32[B, 1024]}
  ("geo_stats", slot)                 {"n", "slat", "slon", "minlat",
                                      "maxlat", "minlon", "maxlon"} f32[B]

The count and every metric spec share one ``agg_metrics`` launch (up to
kernels.MAX_AGG_METRICS metrics a launch); each terms or missing spec is
one ``agg_buckets`` launch, each cardinality spec one ``agg_distinct``
launch, and each geo_stats spec one ``agg_metrics`` launch over the
slot's two channels (fval the latitude, fval2 the longitude, 0 where the
column has none). A slot the segment lacks reads as a column where no doc
has a value (executor.py _get_value_col 313-325).

``check_aggs`` refuses every other kind with NotImplementedError naming
its ROADMAP item, K17c (the kinds that
read plan arrays - median, mode, percentiles, histogram, range, filter,
nested, key_range, geo_ip, geo_trixels, geodist_range, and median/mode
sub-aggregations - which come with ``Database``: the JAX BatchSearcher
does not stack those arrays into its batches).
"""

from __future__ import annotations

import torch

from xapiand_tpu_torch.ops import kernels

METRIC_KINDS = frozenset(("sum", "avg", "min", "max", "variance",
                          "std_deviation", "stats", "extended_stats"))
SUB_KINDS = METRIC_KINDS | {"count"}
STATS = ("n", "s", "s2", "min", "max")


def _refuse(what: str, item: str):
    raise NotImplementedError(f"not ported yet: {what} (ROADMAP queue 2, "
                              f"{item})")


def check_aggs(specs) -> None:
    """Raise NotImplementedError for an aggregation spec outside K17a and
    K17b."""
    for spec in specs:
        kind = spec[0] if spec else None
        if kind == "count" or (kind in METRIC_KINDS and len(spec) == 2) \
                or (kind in ("cardinality", "geo_stats") and len(spec) == 2):
            continue
        if kind not in ("terms", "missing"):
            _refuse(f"the {kind} aggregation", "K17c, with Database")
        subs = spec[2] if kind == "missing" else \
            (spec[3] if len(spec) > 3 else ())
        for sub in subs:
            if sub[0] not in SUB_KINDS or len(sub) != 2:
                _refuse(f"the {sub[0]} sub-aggregation",
                        "K17c, with Database")
        if kind == "terms" and spec[2] > kernels.MAX_AGG_BUCKETS:
            _refuse(f"terms over {spec[2]} categories", "K17c")


def column(values: dict, slot, device) -> dict:
    """The slot's value column, or the absent column of a slot the
    segment lacks."""
    col = values.get(slot)
    return col if col is not None else kernels.absent_column(device)


def sub_columns(values: dict, subs, device) -> list:
    """(fval, present) per sub spec; None for a count sub."""
    out = []
    for kind, slot in subs:
        if kind == "count" or slot < 0:
            out.append(None)
        else:
            c = column(values, slot, device)
            out.append((c["fval"], c["present"]))
    return out


def _shape_subs(stats, n_subs: int) -> list:
    return [dict(zip(STATS, (x[si] for x in stats)))
            for si in range(n_subs)]


def compute_aggs(values: dict, specs, ids, eligible) -> tuple:
    """The aggregations of specs over the rows (ids i32[B,R], eligible
    bool[B,R]) of one launch group; values: the segment's value columns."""
    dev = ids.device
    out: list = [None] * len(specs)
    flat = [i for i, s in enumerate(specs)
            if s[0] == "count" or s[0] in METRIC_KINDS]
    if flat:
        mids = [i for i in flat if specs[i][0] != "count"]
        step = kernels.MAX_AGG_METRICS
        count = None
        for c0 in range(0, max(len(mids), 1), step):
            part = mids[c0:c0 + step]
            cols = [(c["fval"], c["present"]) for c in
                    (column(values, specs[i][1], dev) for i in part)]
            count, *stats = kernels.agg_metrics(ids, eligible, cols)
            for j, i in enumerate(part):
                out[i] = dict(zip(STATS, (x[j] for x in stats)))
        for i in flat:
            if specs[i][0] == "count":
                out[i] = count
    for i, spec in enumerate(specs):
        if spec[0] == "terms":
            subs = spec[3] if len(spec) > 3 else ()
            col = values.get(spec[1])
            counts, stats = kernels.agg_buckets(
                ids, eligible, "terms",
                col.get("cats") if col is not None else None, spec[2],
                sub_columns(values, subs, dev))
            out[i] = {"counts": counts,
                      "subs": _shape_subs(stats, len(subs))} \
                if subs else counts
        elif spec[0] == "missing":
            subs = spec[2]
            counts, stats = kernels.agg_buckets(
                ids, eligible, "missing",
                column(values, spec[1], dev)["present"], 1,
                sub_columns(values, subs, dev))
            out[i] = {"count": counts[:, 0]}
            if subs:
                out[i]["subs"] = _shape_subs(stats, len(subs))
        elif spec[0] == "cardinality":
            n, regs = kernels.agg_distinct(ids, eligible,
                                           column(values, spec[1], dev))
            # maxn is n on the device; it grows when partials merge
            out[i] = {"n": n, "maxn": n, "hll": regs}
        elif spec[0] == "geo_stats":
            col = column(values, spec[1], dev)
            lon = col["fval2"] if "fval2" in col else \
                torch.zeros_like(col["fval"])
            _, n, s, _s2, mn, mx = kernels.agg_metrics(
                ids, eligible, [(col["fval"], col["present"]),
                                (lon, col["present"])])
            out[i] = {"n": n[0], "slat": s[0], "slon": s[1],
                      "minlat": mn[0], "maxlat": mx[0],
                      "minlon": mn[1], "maxlon": mx[1]}
    return tuple(out)
