#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: its two main paths.

Relevance path - BM25 top-10 batch search as bench.py defines it: 1M-doc
Zipf segment (200k vocab, seed 7), 1024 three-term OR queries (seed 11,
terms sorted by df descending), BatchSearcher(k=10, max_batch=256,
prefix_cap=8192), through score_slices, merge_docs, topk_rows and
prefix_certify.

Faceted path - BASELINE.json config 3 without its aggregations
(utils/synth_faceted.py, the counterpart of scripts/config_bench.py:
153-179): 1M docs (12-token Zipf(1.07) bodies over 3,000 words, one of 40
categories, a price, a 1-3 value multi-value size, 1% deleted), 1024
queries in four families of 256 (seed 11): A AND(cat, w) sorted by price
desc, B A with a price range, C AND(w, size range) and D AND_NOT(OR(w, w),
cat) by relevance; A+B through one BatchSearcher(sort=price desc,
prefix_cap=8192), C+D through one without a sort, through score_slices,
merge_docs (with group bits, deletes and the tree), compact_rows,
filter_leaves, sort_topk and topk_rows.

For each path, in order:

  1. the corpus (the faceted one with its fingerprint: numpy version,
     array hash, postings and values counts) and its launch groups;
  2. each kernel against its plain PyTorch version on the card, on the
     path's real launch groups, with times of both (CUDA events); on the
     faceted groups also sort_topk for every key kind on synthetic
     columns (the path drives only value keys and docids);
  3. the path, counted: the launch counters are set to 0 just before it
     and read just after; every kernel of the path > 0 (the faceted path:
     no group in prefix mode and prefix_certify 0; the relevance path: a
     prefix group ran, and its exact re-run's kernels are compared too);
  4. all 1024 results against a float64 numpy oracle: relevance as tie
     groups with scores within rtol 1e-5; A and B as exact docid lists;
     counts exactly on the faceted path;
  5. QPS of 20 warm runs (median and spread), host planning's share of
     them, and the device-busy share of one run from a torch.profiler
     trace.

It imports the port and bench.py (numpy only), nothing of JAX or of the
JAX package. The kernels are built first, from csrc/, one nvcc per source
started together.

Any failure raises (exit != 0). The second-to-last line is the kernel JSON
record (launches: both paths' counted runs; ms / plain_ms: per-launch
times summed over the distinct launch groups compared); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repo, it exits non-zero with no result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_DOCS, VOCAB, N_QUERIES, TERMS, K = 1_000_000, 200_000, 1024, 3, 10
FACETED_DOCS, FACETED_PER_FAMILY = 1_000_000, 256
MAX_BATCH, PREFIX_CAP = 256, 8192
ORACLE_RTOL = 1e-5        # float32 device sums vs the float64 oracle
KERNEL_RTOL = 1e-6        # kernel vs plain version: same float32 op order
SOURCES = {
    "score_slices": ("xapiand_tpu_torch/csrc/score_slices.cu",
                     "xapiand_tpu/ops/executor.py:691"),
    "merge_docs": ("xapiand_tpu_torch/csrc/merge_docs.cu",
                   "xapiand_tpu/ops/executor.py:158"),
    "topk_rows": ("xapiand_tpu_torch/csrc/topk_rows.cu",
                  "xapiand_tpu/ops/executor.py:470"),
    "prefix_certify": ("xapiand_tpu_torch/csrc/prefix_certify.cu",
                       "xapiand_tpu/ops/executor.py:935"),
    "compact_rows": ("xapiand_tpu_torch/csrc/compact_rows.cu",
                     "xapiand_tpu/ops/executor.py:836"),
    "filter_leaves": ("xapiand_tpu_torch/csrc/filter_leaves.cu",
                      "xapiand_tpu/ops/executor.py:328"),
    "sort_topk": ("xapiand_tpu_torch/csrc/sort_topk.cu",
                  "xapiand_tpu/ops/executor.py:487"),
}
RELEVANCE_KERNELS = ("score_slices", "merge_docs", "topk_rows",
                     "prefix_certify")
FACETED_KERNELS = ("score_slices", "merge_docs", "compact_rows",
                   "filter_leaves", "sort_topk", "topk_rows")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10):
    """Mean device milliseconds of fn() over reps launches (warmed)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(a, b):
    import torch

    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or \
            not torch.equal(a[~fin], b[~fin]):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def check_close(name, a, b):
    import torch

    err = max_err(a, b)
    scale = float(b[torch.isfinite(b)].abs().max()) if \
        torch.isfinite(b).any() else 0.0
    if not err <= KERNEL_RTOL * max(scale, 1e-30):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} "
                             f"(scale {scale}, rtol {KERNEL_RTOL})")
    return err


def check_equal(name, a, b):
    import torch

    if (a is None) != (b is None) or (a is not None and
                                      not torch.equal(a, b)):
        raise AssertionError(f"{name}: kernel and plain version differ")


class Recorder:
    """Per-kernel max error and per-launch times summed over the launch
    groups compared, and one log line per group."""

    def __init__(self):
        self.rec: dict = {}
        self.line: dict = {}

    def note(self, name, err, ms, plain_ms):
        r = self.rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                       "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        self.line[name] = (round(ms, 4), round(plain_ms, 4))

    def flush(self, what):
        log(f"[kernels] {what}: kernel/plain ms {self.line}")
        self.line = {}


def slices(searcher, cfg, batch, stats_d, rec):
    """score_slices of one launch group, kernel vs plain."""
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn

    seg = searcher.device_segment.arrays_pytree()
    params = searcher.scheme.kernel_params(CollectionStats(
        doc_count=stats_d["N"], avg_doclen=stats_d["avg_doclen"]))
    prefix = cfg.prefix or (0,) * cfg.T
    pflags = tuple(bool(p) for p in prefix)
    widths = tuple(p or c for p, c in zip(prefix, cfg.term_classes()))
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    imp = (seg["imp.docids"], seg["imp.wdf"], seg["imp.doclen"]) \
        if any(pflags) else None
    args = (batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"])

    def k1():
        return kn.score_slices(post, imp, *args, widths, pflags, params)

    def p1():
        return kn._score_slices_plain(post, imp, *args, widths, pflags,
                                      params)

    (ids, w, tail), (pids, pw, ptail) = k1(), p1()
    check_equal("score_slices ids", ids, pids)
    err = max(check_close("score_slices w", w, pw),
              check_close("score_slices tail", tail, ptail))
    rec.note("score_slices", err, cuda_ms(k1), cuda_ms(p1))
    return seg, params, post, args, widths, ids, w, tail


def compare_relevance(searcher, cfg, batch, stats_d, rec, shape_name):
    """Each relevance-path kernel against its plain version on one launch
    group's real inputs."""
    from xapiand_tpu_torch.ops import kernels as kn

    seg, params, post, args, widths, ids, w, tail = slices(
        searcher, cfg, batch, stats_d, rec)
    R = ids.shape[1]

    def k2():
        return kn.merge_docs(ids, w, widths)

    def p2():
        return kn._merge_docs_plain(ids, w, widths)

    (sums, owner, count, _), (psums, powner, pcount, _) = k2(), p2()
    check_equal("merge_docs owner", owner, powner)
    check_equal("merge_docs count", count, pcount)
    rec.note("merge_docs", check_close("merge_docs sums", sums, psums),
             cuda_ms(k2), cuda_ms(p2))

    kk = min(cfg.verify_k, R - 1) + 1 if cfg.verify_k else cfg.k

    def k3():
        return kn.topk_rows(sums, ids, owner, kk)

    def p3():
        return kn._topk_rows_plain(sums, ids, owner, kk)

    (d, s), (pd, ps) = k3(), p3()
    check_equal("topk_rows docids", d, pd)
    check_equal("topk_rows scores", s, ps)
    rec.note("topk_rows", 0.0, cuda_ms(k3), cuda_ms(p3))

    if cfg.verify_k:
        classes = cfg.term_classes()

        def k4():
            return kn.prefix_certify(post, *args, classes, tail, d, s,
                                     cfg.k, params)

        def p4():
            return kn._prefix_certify_plain(post, *args, classes, tail, d, s,
                                            min(cfg.k, kk - 1), params)

        (cd, cs, cc), (pcd, pcs, pcc) = k4(), p4()
        check_equal("prefix_certify docids", cd, pcd)
        check_equal("prefix_certify certified", cc, pcc)
        rec.note("prefix_certify",
                 check_close("prefix_certify scores", cs, pcs),
                 cuda_ms(k4), cuda_ms(p4))
    rec.flush(f"{shape_name} B={ids.shape[0]} R={R}")


def compare_faceted(searcher, cfg, batch, stats_d, rec, shape_name,
                    sort_inputs):
    """Each faceted-path kernel against its plain version on one launch
    group's real inputs, in execute_batch's order; then sort_topk for
    every key kind on the group's final rows."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.ops.executor import upper_tree
    from xapiand_tpu_torch.utils import synth_faceted as sf

    seg, _params, _post, _args, widths, ids, w, _tail = slices(
        searcher, cfg, batch, stats_d, rec)
    if any(cfg.prefix):
        raise AssertionError(f"faceted group in prefix mode: {cfg}")
    R = ids.shape[1]
    deleted = seg["deleted"] if cfg.has_deletes else None
    bits = batch["group_bits"]
    cap = cfg.compact_cap if 0 < cfg.compact_cap < R else 0
    prog = kn.tree_program(cfg.tree)
    mprog = prog
    if cfg.n_filters:
        mprog = kn.tree_program(upper_tree(cfg.tree)) if cap else None
    margs = (ids, w, widths, bits, deleted, mprog, bool(cfg.n_filters))
    got, want = kn.merge_docs(*margs), kn._merge_docs_plain(*margs)
    err = check_close("merge_docs sums", got[0], want[0])
    for nm, a, b in zip(("mask", "count", "orbits"), got[1:], want[1:]):
        check_equal(f"merge_docs {nm}", a, b)
    rec.note("merge_docs", err, cuda_ms(lambda: kn.merge_docs(*margs)),
             cuda_ms(lambda: kn._merge_docs_plain(*margs)))
    sums, mask, _count, orbits = got
    if cap and (cfg.n_filters or cfg.sort):
        cargs = (mask, ids, sums, orbits, cap)
        got, want = kn.compact_rows(*cargs), kn._compact_rows_plain(*cargs)
        if int(got[3].max()) > cap:
            raise AssertionError(f"compact_rows: {int(got[3].max())} rows "
                                 f"exceed the cap {cap}")
        for nm, a, b in zip(("docids", "sums", "orbits", "n"), got, want):
            check_equal(f"compact_rows {nm}", a, b)
        rec.note("compact_rows", 0.0, cuda_ms(lambda: kn.compact_rows(
            *cargs)), cuda_ms(lambda: kn._compact_rows_plain(*cargs)))
        ids, sums, orbits, _n = got
        mask = None if cfg.n_filters else ids != kn.SENTINEL
    if cfg.n_filters:
        fargs = (seg["values"], cfg.filter_slots, cfg.filter_vmax,
                 batch["fparams"], ids, mask, orbits, prog)
        cols = [seg["values"].get(s) for s in cfg.filter_slots]
        pargs = (cols, tuple(cfg.filter_vmax)) + fargs[3:]
        got, want = kn.filter_leaves(*fargs), kn._filter_leaves_plain(*pargs)
        check_equal("filter_leaves eligible", got[0], want[0])
        check_equal("filter_leaves count", got[1], want[1])
        rec.note("filter_leaves", 0.0,
                 cuda_ms(lambda: kn.filter_leaves(*fargs)),
                 cuda_ms(lambda: kn._filter_leaves_plain(*pargs)))
        mask = got[0]
    values = seg["values"]
    if cfg.sort:
        sargs = (cfg.sort, ids, sums, mask, cfg.k, values,
                 batch["sort_targets"])
        pargs = (cfg.sort, [values.get(s[1]) for s in cfg.sort], ids, sums,
                 mask, cfg.k, batch["sort_targets"], {})
        got, want = kn.sort_topk(*sargs), kn._sort_topk_plain(*pargs)
        check_equal("sort_topk docids", got[0], want[0])
        check_equal("sort_topk scores", got[1], want[1])
        rec.note("sort_topk", 0.0, cuda_ms(lambda: kn.sort_topk(*sargs)),
                 cuda_ms(lambda: kn._sort_topk_plain(*pargs)))
    else:
        targs = (sums, ids, mask, cfg.k)
        got, want = kn.topk_rows(*targs), kn._topk_rows_plain(*targs)
        check_equal("topk_rows docids", got[0], want[0])
        check_equal("topk_rows scores", got[1], want[1])
        rec.note("topk_rows", 0.0, cuda_ms(lambda: kn.topk_rows(*targs)),
                 cuda_ms(lambda: kn._topk_rows_plain(*targs)))
    # every sort key kind, on synthetic columns over the same rows
    B = ids.shape[0]
    col, tg, tab = sort_inputs
    vals = dict(values)
    vals[sf.SORT_TEST_SLOT] = col
    kinds = {}
    for specs in sf.SORT_TEST_SPECS:
        strtabs = {i: tab[:B] for i, s in enumerate(specs)
                   if s[0] == "strmetric"}
        tgt = tg[:B, :len(specs)].contiguous()
        sargs = (specs, ids, sums, mask, cfg.k, vals, tgt, strtabs)
        pargs = (specs, [vals.get(s[1]) for s in specs], ids, sums, mask,
                 cfg.k, tgt, strtabs)
        got, want = kn.sort_topk(*sargs), kn._sort_topk_plain(*pargs)
        check_equal(f"sort_topk {specs} docids", got[0], want[0])
        check_equal(f"sort_topk {specs} scores", got[1], want[1])
        kinds["-".join(s[0] + ("D" if s[2] else "A") for s in specs)] = (
            round(cuda_ms(lambda: kn.sort_topk(*sargs), reps=3), 4),
            round(cuda_ms(lambda: kn._sort_topk_plain(*pargs), reps=3), 4))
    torch.cuda.synchronize()
    rec.flush(f"{shape_name} B={B} R={R} cap={cap}")
    log(f"[kernels] {shape_name} sort_topk every key kind, kernel/plain ms "
        f"{kinds}")


def tie_group_match(got_d, got_s, exp, k):
    """got vs the float64 oracle's ranked (docid, score) list (which runs
    past k): same length, each rank's score within ORACLE_RTOL, and each
    docid one of the oracle's docs tied with it at that tolerance."""
    import numpy as np

    got = [(int(d), float(s)) for d, s in zip(got_d, got_s)
           if np.isfinite(s)]
    if len(got) != min(k, len(exp)) or len({d for d, _ in got}) != len(got):
        return False
    for i, (d, s) in enumerate(got):
        if abs(s - exp[i][1]) > ORACLE_RTOL * abs(exp[i][1]):
            return False
        if d not in {ed for ed, es in exp
                     if abs(es - s) <= ORACLE_RTOL * abs(es)}:
            return False
    return True


def device_busy(prof, span_name):
    """(busy ms, span ms): the union of the CUDA events' intervals inside
    the CPU span named span_name, from one torch.profiler trace. busy is
    None when the trace holds no device events."""
    evts = prof.events()
    span = next(e for e in evts
                if e.name == span_name and e.device_type.name == "CPU")
    lo, hi = span.time_range.start, span.time_range.end
    # the span's own annotation on the device timeline is not device work
    ivs = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                 for e in evts
                 if e.device_type.name == "CUDA" and e.name != span_name
                 and e.time_range.end > lo and e.time_range.start < hi)
    if not ivs:
        return None, (hi - lo) / 1e3
    busy, cur_s, cur_e = 0.0, *ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, (hi - lo) / 1e3


def timed_runs(runs, stats, n_queries, smi, tag):
    """20 warm runs of every (BatchSearcher, irs) in ``runs``, host-clock
    fenced by torch.cuda.synchronize(); each searcher's plan is wrapped on
    the instance so host planning (re-runs' plans included) is timed inside
    the same runs; then one run under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    plan_s: list = []
    saved = []
    for bs, _irs in runs:
        plan = bs.plan

        def timed_plan(*a, _plan=plan, **kw):
            t = time.perf_counter()
            try:
                return _plan(*a, **kw)
            finally:
                plan_s[-1] += time.perf_counter() - t

        saved.append(plan)
        bs.plan = timed_plan
    run_s = []
    for _ in range(20):
        plan_s.append(0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bs, irs in runs:
            bs.run(irs, stats=stats)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    rest_s = sorted(r - p for r, p in zip(run_s, plan_s))
    run_s, plan_s = sorted(run_s), sorted(plan_s)
    med = run_s[len(run_s) // 2]
    log(f"[qps] {tag}: {n_queries / med} QPS median of {len(run_s)} warm "
        f"BatchSearcher.run (plan + launches + readback + re-run), min "
        f"{n_queries / run_s[-1]} max {n_queries / run_s[0]}; ms/run "
        f"median {med * 1e3} min {run_s[0] * 1e3} max {run_s[-1] * 1e3}; "
        f"on {smi}")
    log(f"[time] {tag}: per run, median of {len(run_s)}: host planning "
        f"{plan_s[len(plan_s) // 2] * 1e3} ms, the rest (launches, batch "
        f"copies, readback) {rest_s[len(rest_s) // 2] * 1e3} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.run"):
            for bs, irs in runs:
                bs.run(irs, stats=stats)
            torch.cuda.synchronize()
    busy, span = device_busy(prof, "smoke.run")
    log(f"[trace] {tag}: one profiled run: " + (
        f"device busy {busy} ms of {span} ms ({100 * busy / span} %)"
        if busy is not None else
        f"{span} ms; device busy not measured (no device events traced)"))
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and e.name != "smoke.run":
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3
    log(f"[trace] {tag}: device ms by kernel, largest first: " + str(
        {n[:40]: round(v, 4) for n, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:10]}))
    for (bs, _irs), plan in zip(runs, saved):
        bs.plan = plan


def relevance_path(dev, rec, smi) -> dict:
    """Slice 1: BM25 top-10 over three-term ORs, bench.py's corpus."""
    import numpy as np
    import torch

    import bench
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.query.ir import Q
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                               sample_queries)

    # corpus and plan: bench.py:125-157
    t0 = time.time()
    seg = build_synthetic_segment(N_DOCS, VOCAB, seed=7)
    queries = sample_queries(seg, N_QUERIES, TERMS, seed=11)
    queries = [sorted(q, key=lambda t: -seg.terms[t].length)
               for q in queries]
    irs = [Q.or_terms(q) for q in queries]
    log(f"[corpus] relevance: {N_DOCS} docs, {len(seg.post_docids)} "
        f"posting rows, {time.time() - t0:.1f} s")
    t0 = time.time()
    searcher = SegmentSearcher(seg, device=dev)
    bs = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                       prefix_cap=PREFIX_CAP)
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    planned = bs.plan(irs, stats=stats)
    torch.cuda.synchronize()
    log(f"[plan] relevance: upload + impact mirror + plan "
        f"{time.time() - t0:.1f} s; launches: " + str(
            [(list(c.classes), list(c.prefix), int(b['offsets'].shape[0]))
             for c, _f, b, _ch in planned]))
    stats_d = {"N": float(stats.doc_count),
               "avg_doclen": float(stats.avg_doclen)}

    def compare_groups(groups, what):
        seen = set()
        for cfg, _fn, batch, _chunk in groups:
            key = (cfg.classes, cfg.prefix, int(batch["offsets"].shape[0]))
            if key not in seen:
                seen.add(key)
                compare_relevance(searcher, cfg, batch, stats_d, rec,
                                  f"{what} {key}")
        torch.cuda.synchronize()

    compare_groups(planned, "relevance plan")

    # the path, counted
    kn.reset_launches()
    results = bs.run(irs, stats=stats)
    torch.cuda.synchronize()
    counts = dict(kn.launches)
    log(f"[main] relevance launches {counts}")
    if not all(counts[n] for n in RELEVANCE_KERNELS):
        raise AssertionError(f"a relevance kernel never launched: {counts}")
    if not any(cfg.prefix for cfg, *_ in planned):
        raise AssertionError("no impact-prefix group ran")
    # the queries run() re-ran, in its order: first appearance, not
    # certified by its prefix launch
    seen_q: set = set()
    uncert: list = []
    for cfg, fn, batch, chunk in planned:
        out = fn(searcher.device_segment.arrays_pytree(), batch, stats_d)
        cert = out["certified"].cpu().numpy() if cfg.prefix else None
        for row, qi in enumerate(chunk):
            if qi not in seen_q:
                seen_q.add(qi)
                if cert is not None and not cert[row]:
                    uncert.append(qi)
    log(f"[main] relevance uncertified {len(uncert)}/{N_QUERIES} -> exact "
        f"re-run")
    if uncert:
        rerun = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH).plan(
            [irs[qi] for qi in uncert], stats=stats)
        compare_groups(rerun, "exact re-run")

    # parity with the float64 oracle, then the warm timed run
    t0 = time.time()
    oracle = bench.cpu_baseline(seg, queries, k=2 * K)
    bad = [qi for qi, (r, e) in enumerate(zip(results, oracle))
           if not tie_group_match(r["docids"], r["scores"], e, K)]
    log(f"[parity] relevance: {N_QUERIES - len(bad)}/{N_QUERIES} queries "
        f"match the float64 oracle as tie groups, rtol {ORACLE_RTOL} "
        f"({time.time() - t0:.1f} s)")
    if bad:
        r = results[bad[0]]
        got = list(zip(r["docids"].tolist(), r["scores"].tolist()))
        raise AssertionError(f"{len(bad)} queries differ; first {bad[0]}: "
                             f"got {got} want {oracle[bad[0]][:K]}")
    for r in results:
        if not (np.isfinite(r["scores"]) | (r["docids"] == kn.SENTINEL)).all():
            raise AssertionError("non-finite score on a real docid")
    timed_runs([(bs, irs)], stats, N_QUERIES, smi, "relevance")
    del searcher, bs, planned, seg
    return counts


def faceted_path(dev, rec, smi) -> dict:
    """Slice 2: config 3's faceted search without its aggregations."""
    import numpy as np
    import torch

    from xapiand_tpu_torch.models.segment import device_segment_from_numpy
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils import synth_faceted as sf

    t0 = time.time()
    corpus = sf.build_faceted_corpus(FACETED_DOCS, seed=7)
    seg = corpus.seg
    log(f"[corpus] faceted: {FACETED_DOCS} docs, fingerprint "
        f"{sf.fingerprint(corpus)}, {time.time() - t0:.1f} s")
    qs = sf.faceted_queries(FACETED_PER_FAMILY, seed=11)
    t0 = time.time()
    searcher = SegmentSearcher(seg, device=dev)
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    stats_d = {"N": float(stats.doc_count),
               "avg_doclen": float(stats.avg_doclen)}
    fams = []
    for sort, names in (((("value", sf.PRICE_SLOT, True),), "AB"),
                        (None, "CD")):
        bs = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                           prefix_cap=PREFIX_CAP, sort=sort)
        idx = [i for i, (f, _q, _p) in enumerate(qs) if f in names]
        fams.append((bs, idx, [qs[i][1] for i in idx]))
    planned = [(bs, bs.plan(irs, stats=stats)) for bs, _i, irs in fams]
    torch.cuda.synchronize()
    log(f"[plan] faceted: upload + plan {time.time() - t0:.1f} s; launches "
        "(tree, classes, compact_cap, n_filters, B): " + str(
            [(c.tree, list(c.classes), c.compact_cap, c.n_filters,
              int(b["offsets"].shape[0]))
             for _bs, groups in planned for c, _f, b, _ch in groups]))
    if any(c.prefix for _bs, groups in planned for c, *_ in groups):
        raise AssertionError("a faceted launch group is in prefix mode")

    # kernels vs plain versions, one launch per distinct group shape
    col, tg, tab = sf.sort_test_inputs(seg.num_docs, MAX_BATCH)
    sort_inputs = (device_segment_from_numpy(col, dev),
                   torch.from_numpy(tg).to(dev),
                   torch.from_numpy(tab).to(dev))
    seen = set()
    for _bs, groups in planned:
        for cfg, _fn, batch, _chunk in groups:
            key = (cfg.tree, cfg.classes, cfg.compact_cap,
                   int(batch["offsets"].shape[0]))
            if key not in seen:
                seen.add(key)
                compare_faceted(searcher, cfg, batch, stats_d, rec,
                                f"faceted {key}", sort_inputs)
    del sort_inputs

    # the path, counted
    kn.reset_launches()
    results: list = [None] * len(qs)
    for bs, idx, irs in fams:
        for i, r in zip(idx, bs.run(irs, stats=stats)):
            results[i] = r
    torch.cuda.synchronize()
    counts = dict(kn.launches)
    log(f"[main] faceted launches {counts}")
    if not all(counts[n] for n in FACETED_KERNELS) or \
            counts["prefix_certify"]:
        raise AssertionError(f"faceted launches wrong: {counts}")

    # parity with the float64 oracle
    t0 = time.time()
    want = sf.oracle_answers(corpus, qs, K, ORACLE_RTOL)
    bad = []
    for qi, ((fam, _q, _p), r, w) in enumerate(zip(qs, results, want)):
        fin = np.isfinite(r["scores"])
        ok = r["count"] == w["count"] and \
            (r["docids"][~fin] == kn.SENTINEL).all()
        if fam in "AB":
            exp = w["ranked"]
            ok = ok and r["docids"][fin].tolist() == [d for d, _ in exp] \
                and all(abs(s - es) <= ORACLE_RTOL * abs(es)
                        for s, (_d, es) in zip(r["scores"][fin], exp))
        else:
            ok = ok and tie_group_match(r["docids"], r["scores"],
                                        w["ranked"], K)
        if not ok:
            bad.append(qi)
    per_fam = {f: sum(1 for qi, (ff, *_x) in enumerate(qs)
                      if ff == f and qi not in bad) for f in "ABCD"}
    log(f"[parity] faceted: {len(qs) - len(bad)}/{len(qs)} queries match "
        f"the float64 oracle (A, B exact docid lists; C, D tie groups at "
        f"rtol {ORACLE_RTOL}; counts exact) per family {per_fam}; counts "
        f"min/median/max {min(w['count'] for w in want)}/"
        f"{sorted(w['count'] for w in want)[len(want) // 2]}/"
        f"{max(w['count'] for w in want)} ({time.time() - t0:.1f} s)")
    if bad:
        qi = bad[0]
        r = results[qi]
        raise AssertionError(
            f"{len(bad)} faceted queries differ; first {qi} {qs[qi][0]} "
            f"{qs[qi][2]}: got count {r['count']} "
            f"{list(zip(r['docids'].tolist(), r['scores'].tolist()))} want "
            f"count {want[qi]['count']} {want[qi]['ranked'][:K]}")
    timed_runs([(bs, irs) for bs, _i, irs in fams], stats, len(qs), smi,
               "faceted")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "xapiand_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    # environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    from xapiand_tpu_torch.ops import kernels as kn

    import numpy as np

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} numpy {np.__version__} "
        f"nvcc {kn.find_nvcc()} device {torch.cuda.get_device_name(0)}")

    # kernel build: one nvcc per source, all started together
    kn.build()
    log(f"[build] {kn.build_info['seconds']:.2f} s "
        f"(cached={kn.build_info['cached']}) {kn.build_info['path']}")
    if "log" in kn.build_info:
        with open(kn.build_info["log"]) as f:
            for ln in f:
                if "spill" in ln and " 0 bytes spill stores" not in ln:
                    log("[ptxas] " + ln.strip())

    dev = torch.device("cuda")
    rec = Recorder()
    t0 = time.time()
    rel = relevance_path(dev, rec, smi)
    torch.cuda.empty_cache()
    log(f"[time] relevance path {time.time() - t0:.1f} s")
    t0 = time.time()
    fac = faceted_path(dev, rec, smi)
    log(f"[time] faceted path {time.time() - t0:.1f} s")
    if [m for m in sys.modules
            if m.split(".")[0] in ("jax", "xapiand_tpu")]:
        raise AssertionError("JAX or the JAX package was imported")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": rel.get(name, 0) + fac.get(name, 0),
         "max_abs_err": rec.rec[name]["max_abs_err"],
         "ms": rec.rec[name]["ms"], "plain_ms": rec.rec[name]["plain_ms"]}
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
