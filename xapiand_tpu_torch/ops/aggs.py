"""On-device aggregations (torch port of ``xapiand_tpu/ops/aggs.py``, K17a,
K17b and K17c).

``compute_aggs`` walks ``ExecConfig.with_aggs`` in order over one launch
group's rows - the rows the ordering step reads: the compacted rows, or
every row on the fullwidth and dense paths - and returns the JAX
``compute_aggs`` structure with a leading query axis on every array:

  ("count",)                          i32[B]
  (sum | avg | min | max | variance | std_deviation | stats |
   extended_stats, slot)              {"n", "s", "s2", "min", "max"} f32[B]
  (median | mode, slot, nbins)        the same and "hist" f32[B, nbins]
  ("percentiles", slot, nbins)        {"n", "min", "max", "hist"}
  ("terms", slot, ncats, subs)        i32[B, ncats] without subs, else
                                      {"counts": i32[B, ncats], "subs":
                                      [{"n", "s", "s2", "min", "max"[,
                                      "hist2" f32[B, ncats, nbins]]}
                                      f32[B, ncats] per sub]}
  ("histogram", slot, nb, subs), ("range" | "geodist_range" | "key_range",
   slot, nr, subs[, vmax]), ("geo_ip", slot, nb, ncidr, subs[, vmax]),
  ("geo_trixels", slot, nb, shift, subs)
                                      as terms, over nb buckets
  ("missing", slot, subs),
  ("filter", n_terms, Lf, subs)       {"count": i32[B][, "subs": [... f32
                                      [B, 1] per sub]]}
  ("nested", descs, level_subs)       {"counts": (i32[B, size_l] per
                                      level), "subs": (per level a subs
                                      list or None)}
  ("cardinality", slot)               {"n", "maxn": i32[B] (the exact
                                      distinct count, twice), "hll":
                                      i32[B, 1024]}
  ("geo_stats", slot)                 {"n", "slat", "slon", "minlat",
                                      "maxlat", "minlon", "maxlon"} f32[B]

Launches: the count and every metric spec (median, mode and percentiles
included) share one ``agg_metrics`` launch (up to
kernels.MAX_AGG_METRICS metrics a launch); each terms, missing,
histogram, geo_trixels or filter spec and each level of a nested spec is
one ``agg_buckets`` launch (a filter spec first one ``agg_filter``
launch); range, geodist_range, key_range and geo_ip one ``agg_ranges``
launch; every order-statistic histogram (a median, mode or percentiles
spec, a median or mode sub) one ``agg_hist`` launch; each cardinality
spec one ``agg_distinct`` launch, each geo_stats spec one
``agg_metrics`` launch over the slot's two channels (fval the latitude,
fval2 the longitude, 0 where the column has none). A slot the segment
lacks reads as a column where no doc has a value (executor.py
_get_value_col 313-325). The kinds that read plan arrays (K17c) take
them from ``plan``: the batch of a single ``SegmentSearcher.execute``.

``check_aggs`` refuses by name, with its ROADMAP item:
- on the batch path (``batched=True``), every K17c kind: the JAX
  BatchSearcher does not stack their plan arrays (ROADMAP queue 3);
- a median or mode sub under range, geodist_range, key_range or
  geo_trixels: JAX calls ``_sub_stats_bucketed`` there without its plan
  (ops/aggs.py:336-337, 393-394, 419-420) and fails while it traces
  (ROADMAP queue 3, mirrored);
- buckets beyond kernels.MAX_AGG_BUCKETS.
"""

from __future__ import annotations

import torch

from xapiand_tpu_torch.ops import kernels

METRIC_KINDS = frozenset(("sum", "avg", "min", "max", "variance",
                          "std_deviation", "stats", "extended_stats"))
ORDER_KINDS = ("median", "mode")
SUB_KINDS = METRIC_KINDS | {"count"}
STATS = ("n", "s", "s2", "min", "max")
# the kinds whose plan arrays the JAX BatchSearcher drops (K17c)
PLAN_KINDS = frozenset(("median", "mode", "percentiles", "histogram",
                        "range", "geodist_range", "key_range", "geo_ip",
                        "geo_trixels", "filter", "nested"))
KINDS = PLAN_KINDS | METRIC_KINDS | {"count", "terms", "missing",
                                     "cardinality", "geo_stats"}
# the arity of the specs compile_for_segment produces, where it is fixed
_ARITY = {"count": 1, "cardinality": 2, "geo_stats": 2, "median": 3,
          "mode": 3, "percentiles": 3, "missing": 3, "nested": 3,
          **{k: 2 for k in METRIC_KINDS}}
# JAX calls _sub_stats_bucketed without its plan under these kinds, so an
# order-statistic sub there fails in JAX
_PLANLESS_SUBS = ("range", "geodist_range", "key_range", "geo_trixels")


def _refuse(what: str, item: str):
    raise NotImplementedError(f"not ported yet: {what} (ROADMAP {item})")


def spec_subs(spec) -> tuple:
    """The metric sub-aggregations of a bucket spec."""
    kind = spec[0]
    if kind == "missing":
        return spec[2]
    if kind in ("geo_ip", "geo_trixels"):
        return spec[4] if len(spec) > 4 else ()
    if kind in ("terms", "histogram", "range", "geodist_range",
                "key_range", "filter"):
        return spec[3] if len(spec) > 3 else ()
    return ()


def check_aggs(specs, batched: bool = False) -> None:
    """Raise NotImplementedError for an aggregation spec the port does not
    run: every K17c kind on the batch path, the order-statistic subs JAX
    cannot trace, a spec of an arity no compile produces, and buckets
    beyond the kernels' widths."""
    for spec in specs:
        kind = spec[0] if spec else None
        if batched and (kind in PLAN_KINDS or any(
                len(sub) > 2 for sub in spec_subs(spec))):
            _refuse(f"the {kind} aggregation on the batch path: the JAX "
                    "BatchSearcher does not stack its plan arrays",
                    "queue 3, K17c; SegmentSearcher.execute runs it")
        if kind not in KINDS:
            raise ValueError(f"unknown aggregation {kind!r}")
        if len(spec) != _ARITY.get(kind, len(spec)):
            _refuse(f"a {kind} spec of arity {len(spec)}", "queue 2, K17c")
        levels = spec[2] if kind == "nested" else (spec_subs(spec),)
        for subs in levels:
            for sub in subs or ():
                if sub[0] not in SUB_KINDS and sub[0] not in ORDER_KINDS:
                    raise ValueError(f"unknown sub-aggregation {sub[0]!r}")
                if kind in _PLANLESS_SUBS and len(sub) > 2:
                    _refuse(f"a {sub[0]} sub-aggregation under {kind}: "
                            "the JAX package calls _sub_stats_bucketed "
                            "there without its plan and fails",
                            "queue 3, mirrored")
        widths = []
        if kind in ("terms", "histogram", "range", "geodist_range",
                    "key_range", "geo_ip", "geo_trixels"):
            widths.append(spec[2])
        if kind == "nested":
            size = 1
            for desc in spec[1]:
                size *= desc[2]
                widths.append(size)
        for w in widths:
            if w > kernels.MAX_AGG_BUCKETS:
                _refuse(f"{kind} over {w} buckets (kernels."
                        "MAX_AGG_BUCKETS)", "queue 2, K17c")


def column(values: dict, slot, device) -> dict:
    """The slot's value column, or the absent column of a slot the
    segment lacks."""
    col = values.get(slot)
    return col if col is not None else kernels.absent_column(device)


def sub_columns(values: dict, subs, device) -> list:
    """(fval, present) per sub spec; None for a count sub."""
    out = []
    for sub in subs:
        kind, slot = sub[0], sub[1]
        if kind == "count" or slot < 0:
            out.append(None)
        else:
            c = column(values, slot, device)
            out.append((c["fval"], c["present"]))
    return out


def _shape_subs(stats, subs, hists=None) -> list:
    out = []
    for si in range(len(subs)):
        res = dict(zip(STATS, (x[si] for x in stats)))
        if hists is not None and hists[si] is not None:
            res["hist2"] = hists[si]
        out.append(res)
    return out


def _sub_hists(values, subs, ids, eligible, plan, dev, codes=None,
               member=None, nb=1) -> list:
    """hist2 [B, nb, nbins] of each median / mode sub (None for the
    others): the rows of each bucket by codes or member."""
    out = []
    for sub in subs:
        if len(sub) <= 3:
            out.append(None)
            continue
        c = column(values, sub[1], dev)
        out.append(kernels.agg_hist(
            ids, eligible, c["fval"], c["present"],
            plan["agg_params"][sub[3]], sub[2], codes=codes, member=member,
            nb=nb))
    return out


def _buckets(values, subs, ids, eligible, plan, mode, codes, nb, dev,
             **kw):
    """One agg_buckets launch with its subs' hist2 -> (counts, shaped
    subs or None, row codes or None)."""
    need = kw.pop("want_codes", False) or any(len(sub) > 3 for sub in subs)
    res = kernels.agg_buckets(ids, eligible, mode, codes, nb,
                              sub_columns(values, subs, dev),
                              want_codes=need, **kw)
    counts, stats = res[0], res[1]
    rows = res[2] if need else None
    shaped = None
    if subs:
        size = counts.shape[1]
        hists = _sub_hists(values, subs, ids, eligible, plan, dev,
                           codes=rows, nb=size)
        shaped = _shape_subs(stats, subs, hists)
    return counts, shaped, rows


def compute_aggs(seg: dict, specs, ids, eligible, plan=None) -> tuple:
    """The aggregations of specs over the rows (ids i32[B,R], eligible
    bool[B,R]) of one launch group; seg: the segment's arrays
    (``arrays_pytree()``); plan: the batch's plan arrays (agg_params,
    agg_ranges, agg_filters: dicts of [B, ...] tensors)."""
    values = seg["values"]
    dev = ids.device
    plan = plan or {}
    out: list = [None] * len(specs)
    flat = [i for i, s in enumerate(specs)
            if s[0] == "count" or s[0] in METRIC_KINDS
            or s[0] in ORDER_KINDS or s[0] == "percentiles"]
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
            spec = specs[i]
            if spec[0] == "count":
                out[i] = count
            elif spec[0] in ORDER_KINDS or spec[0] == "percentiles":
                c = column(values, spec[1], dev)
                hist = kernels.agg_hist(ids, eligible, c["fval"],
                                        c["present"],
                                        plan["agg_params"][str(i)],
                                        spec[2])[:, 0]
                if spec[0] == "percentiles":
                    out[i] = {"n": out[i]["n"], "min": out[i]["min"],
                              "max": out[i]["max"], "hist": hist}
                else:
                    out[i]["hist"] = hist
    for i, spec in enumerate(specs):
        kind = spec[0]
        subs = spec_subs(spec)
        if kind == "terms":
            col = values.get(spec[1])
            counts, shaped, _ = _buckets(
                values, subs, ids, eligible, plan, "terms",
                col.get("cats") if col is not None else None, spec[2], dev)
            out[i] = {"counts": counts, "subs": shaped} if subs else counts
        elif kind in ("missing", "filter"):
            if kind == "missing":
                mode, codes = "missing", column(values, spec[1],
                                                dev)["present"]
            else:
                mode = "mask"
                codes = kernels.agg_filter(ids, eligible, seg["post_docids"],
                                           plan["agg_filters"][str(i)],
                                           spec[2])
            counts, shaped, _ = _buckets(values, subs, ids, eligible, plan,
                                         mode, codes, 1, dev)
            out[i] = {"count": counts[:, 0]}
            if subs:
                out[i]["subs"] = shaped
        elif kind == "histogram":
            c = column(values, spec[1], dev)
            counts, shaped, _ = _buckets(
                values, subs, ids, eligible, plan, "histogram",
                {"fval": c["fval"], "present": c["present"],
                 "params": plan["agg_params"][str(i)]}, spec[2], dev)
            out[i] = {"counts": counts, "subs": shaped} if subs else counts
        elif kind == "geo_trixels":
            g = seg["geo"].get(spec[1]) if "geo" in seg else None
            if g is None:
                raise KeyError(spec[1])   # JAX indexes seg["geo"][slot]
            counts, shaped, _ = _buckets(
                values, subs, ids, eligible, plan, "trixels",
                {"doc_off": g["doc_off"], "doc_len": g["doc_len"],
                 "flat_start": g["flat_start"],
                 "table": plan["agg_params"][str(i)], "shift": spec[3]},
                spec[2], dev, sub_clamp=g["doc_off"].shape[0])
            out[i] = {"counts": counts, "subs": shaped} if subs else counts
        elif kind == "nested":
            counts_l, subs_l = [], []
            prev, size = None, 1
            for lvl, desc in enumerate(spec[1]):
                dkind, slot, nb, pkey = desc
                size *= nb
                c = column(values, slot, dev)
                if dkind == "terms":
                    codes = c.get("cats")
                elif dkind == "histogram":
                    codes = {"fval": c["fval"], "present": c["present"],
                             "params": plan["agg_params"][pkey]}
                elif dkind == "range":
                    codes = {"fval": c["fval"], "present": c["present"],
                             "bounds": plan["agg_ranges"][pkey]}
                else:
                    raise ValueError(f"unbucketable nested kind {dkind!r}")
                lsubs = spec[2][lvl]
                last = lvl == len(spec[1]) - 1
                counts, shaped, prev = _buckets(
                    values, lsubs or (), ids, eligible, plan, dkind, codes,
                    nb, dev, prev=prev, size=size, want_codes=not last)
                counts_l.append(counts)
                subs_l.append(shaped if lsubs else None)
            out[i] = {"counts": tuple(counts_l), "subs": tuple(subs_l)}
        elif kind in ("range", "geodist_range", "key_range", "geo_ip"):
            col = column(values, spec[1], dev)
            kw = {}
            if kind == "geo_ip":
                mode, nb = "geo_ip", spec[2]
                kw["assign"] = plan["agg_params"][str(i)]
                kw["vmax"] = spec[5] if len(spec) > 5 else 1
            elif kind == "key_range":
                mode, nb = "key", spec[2]
                kw["vmax"] = spec[4] if len(spec) > 4 else 1
            elif kind == "geodist_range":
                mode, nb = "geodist", spec[2]
                kw["origin"] = plan["agg_params"][str(i)]
            else:
                mode, nb = "range", spec[2]
            need = any(len(sub) > 3 for sub in subs)
            res = kernels.agg_ranges(ids, eligible, mode, col,
                                     plan["agg_ranges"][str(i)], nb,
                                     sub_columns(values, subs, dev),
                                     want_member=need, **kw)
            counts = res[0]
            if subs:
                hists = _sub_hists(values, subs, ids, eligible, plan, dev,
                                   member=res[2] if need else None, nb=nb)
                out[i] = {"counts": counts,
                          "subs": _shape_subs(res[1], subs, hists)}
            else:
                out[i] = counts
        elif kind == "cardinality":
            n, regs = kernels.agg_distinct(ids, eligible,
                                           column(values, spec[1], dev))
            # maxn is n on the device; it grows when partials merge
            out[i] = {"n": n, "maxn": n, "hll": regs}
        elif kind == "geo_stats":
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
