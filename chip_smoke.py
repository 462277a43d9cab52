#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: BM25 top-10 batch search.

Drives xapiand_tpu_torch's main path as bench.py defines it - 1M-doc Zipf
segment (200k vocab, seed 7), 1024 three-term OR queries (seed 11, terms
sorted by df descending), BatchSearcher(k=10, max_batch=256,
prefix_cap=8192) - through the four hand-written CUDA kernels, and checks:

  1. the card (name, power limit), torch / CUDA versions, nvcc;
  2. the kernel build from csrc/ (seconds, ptxas report);
  3. each kernel against its plain PyTorch version on the card, on the
     launch groups of the real corpus (B = 256/128/64), with times of both;
  4. the main path: every launch counter > 0 and a prefix group run; then
     the kernels again on the launch groups of the exact re-run that path
     made (the uncertified queries planned with prefix_cap 0);
  5. all 1024 results against bench.cpu_baseline, the float64 numpy
     oracle, as tie groups with scores within rtol 1e-5; QPS of warm timed
     runs (median and spread), host planning's share of them, and the
     device-busy share of one run from a torch.profiler trace.

It imports the port and bench.py (numpy only), nothing of JAX or of the
JAX package.

Any failure raises (exit != 0). The second-to-last line is the kernel JSON
record; the last line is {"ok": true, "device": {...}}. Without a CUDA
device, or outside a checkout of the repo, it exits non-zero with no
result.

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
}


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

    if not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel and plain version differ")


def compare_kernels(searcher, cfg, batch, stats_d, rec, shape_name):
    """Each kernel against its plain version on one launch group's real
    inputs; errors and per-launch times go into rec[kernel]."""
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
    B, R = args[0].shape[0], sum(widths)
    line = {}

    def note(name, err, ms, plain_ms):
        r = rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                  "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        line[name] = (round(ms, 4), round(plain_ms, 4))

    def k1():
        return kn.score_slices(post, imp, *args, widths, pflags, params)

    def p1():
        return kn._score_slices_plain(post, imp, *args, widths, pflags,
                                      params)

    (ids, w, tail), (pids, pw, ptail) = k1(), p1()
    check_equal("score_slices ids", ids, pids)
    err = max(check_close("score_slices w", w, pw),
              check_close("score_slices tail", tail, ptail))
    note("score_slices", err, cuda_ms(k1), cuda_ms(p1))

    def k2():
        return kn.merge_docs(ids, w, widths)

    def p2():
        return kn._merge_docs_plain(ids, w, widths)

    (sums, owner, count), (psums, powner, pcount) = k2(), p2()
    check_equal("merge_docs owner", owner, powner)
    check_equal("merge_docs count", count, pcount)
    note("merge_docs", check_close("merge_docs sums", sums, psums),
         cuda_ms(k2), cuda_ms(p2))

    kk = min(cfg.verify_k, R - 1) + 1 if cfg.verify_k else cfg.k

    def k3():
        return kn.topk_rows(sums, ids, owner, kk)

    def p3():
        return kn._topk_rows_plain(sums, ids, owner, kk)

    (d, s), (pd, ps) = k3(), p3()
    check_equal("topk_rows docids", d, pd)
    check_equal("topk_rows scores", s, ps)
    note("topk_rows", 0.0, cuda_ms(k3), cuda_ms(p3))

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
        note("prefix_certify", check_close("prefix_certify scores", cs, pcs),
             cuda_ms(k4), cuda_ms(p4))
    log(f"[kernels] {shape_name} B={B} R={R}: kernel/plain ms {line}")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "xapiand_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    # 1. environment
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

    # 2. kernel build
    kn.build()
    log(f"[build] {kn.build_info['seconds']:.2f} s "
        f"(cached={kn.build_info['cached']}) {kn.build_info['path']}")
    if "log" in kn.build_info:
        with open(kn.build_info["log"]) as f:
            for ln in f:
                if "Used" in ln or "spill" in ln:
                    log("[ptxas] " + ln.strip())

    # corpus and plan: bench.py:125-157
    import bench
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.query.ir import Q
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                               sample_queries)

    t0 = time.time()
    seg = build_synthetic_segment(N_DOCS, VOCAB, seed=7)
    queries = sample_queries(seg, N_QUERIES, TERMS, seed=11)
    queries = [sorted(q, key=lambda t: -seg.terms[t].length)
               for q in queries]
    irs = [Q.or_terms(q) for q in queries]
    log(f"[corpus] {N_DOCS} docs, {len(seg.post_docids)} posting rows, "
        f"{time.time() - t0:.1f} s")
    dev = torch.device("cuda")
    t0 = time.time()
    searcher = SegmentSearcher(seg, device=dev)
    bs = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                       prefix_cap=PREFIX_CAP)
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    planned = bs.plan(irs, stats=stats)
    torch.cuda.synchronize()
    log(f"[plan] upload + impact mirror + plan {time.time() - t0:.1f} s; "
        f"launches: " + str([(list(c.classes), list(c.prefix),
                              int(b['offsets'].shape[0]))
                             for c, _f, b, _ch in planned]))
    stats_d = {"N": float(stats.doc_count),
               "avg_doclen": float(stats.avg_doclen)}

    # 3. kernels vs plain versions at the main path's shapes (one launch
    # per distinct group)
    rec: dict = {}

    def compare_groups(groups, what):
        seen = set()
        for cfg, _fn, batch, _chunk in groups:
            key = (cfg.classes, cfg.prefix, int(batch["offsets"].shape[0]))
            if key not in seen:
                seen.add(key)
                compare_kernels(searcher, cfg, batch, stats_d, rec,
                                f"{what} {key}")
        torch.cuda.synchronize()

    compare_groups(planned, "plan")

    # 4. the main path, counted
    kn.reset_launches()
    results = bs.run(irs, stats=stats)
    torch.cuda.synchronize()
    counts = dict(kn.launches)
    log(f"[main] launches {counts}")
    if not all(counts.values()):
        raise AssertionError(f"a kernel never launched: {counts}")
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
    log(f"[main] uncertified {len(uncert)}/{N_QUERIES} -> exact re-run")
    if uncert:
        rerun = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH).plan(
            [irs[qi] for qi in uncert], stats=stats)
        compare_groups(rerun, "exact re-run")

    # 5. parity with the float64 oracle, then the warm timed run
    t0 = time.time()
    oracle = bench.cpu_baseline(seg, queries, k=2 * K)
    bad = [qi for qi, (r, e) in enumerate(zip(results, oracle))
           if not tie_group_match(r["docids"], r["scores"], e, K)]
    log(f"[parity] {N_QUERIES - len(bad)}/{N_QUERIES} queries match the "
        f"float64 oracle as tie groups, rtol {ORACLE_RTOL} "
        f"({time.time() - t0:.1f} s)")
    if bad:
        r = results[bad[0]]
        got = list(zip(r["docids"].tolist(), r["scores"].tolist()))
        raise AssertionError(f"{len(bad)} queries differ; first {bad[0]}: "
                             f"got {got} want {oracle[bad[0]][:K]}")
    for r in results:
        if not (np.isfinite(r["scores"]) | (r["docids"] == kn.SENTINEL)).all():
            raise AssertionError("non-finite score on a real docid")
    # warm timed runs; bs.plan is wrapped on the instance so that host
    # planning (the re-run's plan included) is timed inside the same runs
    plan_s: list = []
    plan = bs.plan

    def timed_plan(*a, **kw):
        t = time.perf_counter()
        try:
            return plan(*a, **kw)
        finally:
            plan_s[-1] += time.perf_counter() - t

    bs.plan = timed_plan
    run_s = []
    for _ in range(20):
        plan_s.append(0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bs.run(irs, stats=stats)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    rest_s = sorted(r - p for r, p in zip(run_s, plan_s))
    run_s, plan_s = sorted(run_s), sorted(plan_s)
    med = run_s[len(run_s) // 2]
    log(f"[qps] {N_QUERIES / med} QPS median of {len(run_s)} warm "
        f"BatchSearcher.run (plan + launches + readback + re-run), min "
        f"{N_QUERIES / run_s[-1]} max {N_QUERIES / run_s[0]}; ms/run "
        f"median {med * 1e3} min {run_s[0] * 1e3} max {run_s[-1] * 1e3}; "
        f"on {smi}")
    log(f"[time] per run, median of {len(run_s)}: host planning "
        f"{plan_s[len(plan_s) // 2] * 1e3} ms, the rest (launches, batch "
        f"copies, readback) {rest_s[len(rest_s) // 2] * 1e3} ms")
    # one warm run under torch.profiler: the device-busy share
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.run"):
            bs.run(irs, stats=stats)
            torch.cuda.synchronize()
    busy, span = device_busy(prof, "smoke.run")
    log("[trace] one profiled run: " + (
        f"device busy {busy} ms of {span} ms ({100 * busy / span} %)"
        if busy is not None else
        f"{span} ms; device busy not measured (no device events traced)"))
    bs.plan = plan
    if [m for m in sys.modules
            if m.split(".")[0] in ("jax", "xapiand_tpu")]:
        raise AssertionError("JAX or the JAX package was imported")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name],
         "max_abs_err": rec[name]["max_abs_err"], "ms": rec[name]["ms"],
         "plain_ms": rec[name]["plain_ms"]}
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
