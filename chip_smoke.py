#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: its seven main paths.

Relevance path - BM25 top-10 batch search as bench.py defines it: 1M-doc
Zipf segment (200k vocab, seed 7), 1024 three-term OR queries (seed 11,
terms sorted by df descending), BatchSearcher(k=10, max_batch=256,
prefix_cap=8192), through score_slices, merge_docs, topk_rows and
prefix_certify.

Faceted path - BASELINE.json config 3 in full (utils/synth_faceted.py, the
counterpart of scripts/config_bench.py:153-206): 1M docs (12-token
Zipf(1.07) bodies over 3,000 words, one of 40 categories, a price, a 1-3
value multi-value size, 1% deleted), 1024 queries in four families of 256
(seed 11): A AND(cat, w) sorted by price desc, B A with a price range, C
AND(w, size range) and D AND_NOT(OR(w, w), cat) by relevance; every query
carries config 3's aggregations (CFG3_AGGS: terms over the category,
stats of the price); A+B through one BatchSearcher(sort=price desc,
prefix_cap=8192, aggs=...), C+D through one without a sort; the fullwidth
path on (XT_FULLWIDTH=1, the default): A and D skip the compaction, A is
ordered by fullwidth_topk and its uncertified queries re-run on the exact
path; B and C compact and filter. The same traffic at XT_FULLWIDTH=0 (the
exact re-run's path: A packs its rows for its sort and aggregations) is
compared and held against the oracle too. Kernels: score_slices,
merge_docs (with group bits, deletes and the tree), compact_rows,
filter_leaves, sort_topk, topk_rows, fullwidth_topk, agg_metrics,
agg_buckets.

Positional path - BASELINE.json config 2 (utils/synth_positional.py, the
counterpart of scripts/config_bench.py:35-76) at its published 100k docs
of 40 Zipf(1.07) tokens over 5,000 words, with positions: 512 2-word
phrases and 512 AND / OR / AND_NOT booleans of three words (config_bench's
queries2, seed 11), then 128 3-word phrases and 128 NEAR pairs at window 4
from the same generator, through one BatchSearcher(k=10). Kernels:
score_slices, merge_docs, phrase_leaves (K14 with the K15 lookups),
filter_leaves (the tree over the phrase verdicts), topk_rows; every phrase
launch group's phrase_leaves against its plain version, twice bit for
bit; the torch.searchsorted time of the same K15 lookups beside it.

Geo path - BASELINE.json config 4 (utils/synth_geo.py, the counterpart of
scripts/config_bench.py:244-344) at its published 1M geotagged docs (12
Zipf(1.07) tokens over 2,000 words, a point in lon [-120, -70] x lat [25,
48], a 2024 timestamp; the native library's HTM covers, which must load):
1024 queries "circle AND 3-month window" (config_bench's queries4, seed 11;
P) and 256 "circle AND 1-3 days" (seed 12; T, whose hour cover is the
cheaper leg), through one BatchSearcher(k=10): one IR signature, so T
shares launch groups with P and runs under their first member's tree. Kernels: score_slices, merge_docs,
geo_leaves (K16, with rank_count's counts as binary searches, K15),
filter_leaves (the tree over the geo verdicts), sort_topk (the docid order
of an unweighted plan), compact_rows where a group precompacts; geo_leaves
against its plain version at every launch group, twice bit for bit; the
torch.searchsorted time of its two counts beside it.

Browse path - the single-query entry point and the remaining plan shapes
(utils/synth_browse.py) over the faceted path's 1M-doc corpus, nothing
cut: 1024 queries (seed 11) in five families: M 256 "match_all AND price
range" by price desc with config 3's aggregations and the cardinality of
the multi-value size (dense, no term; one BatchSearcher(sort=price desc,
aggs=...)), N 128 "AND_NOT(match_all, OR(w, w))" (dense with term masks),
S 256 "OR(synonym(w, w, w), w)" and X 256 "max_(w, w, AND(w, w))" by
relevance (N, S and X through one BatchSearcher(k=10)), and C, 128 calls
of SegmentSearcher.execute with a collapse on the category: 64 "OR(w, w,
w)" by relevance and 64 dense plans by price desc. Kernels: collapse_rows
(K10), dense_rows (K12), merge_special (K13), agg_distinct (K17b), and
score_slices, merge_docs, filter_leaves, sort_topk, topk_rows (with the
collapse's tie ranks), agg_metrics, agg_buckets. Every one of them is held
against its plain version inside a run of the path itself, at every launch
it gets (``Held``), twice bit for bit, and timed at its widest launch.

Schemes path - every weight scheme of the JAX package (K18) through the
serving paths, over the relevance path's corpus (its docs' distinct terms
and its terms' summed wdf set before the upload: the statistics the other
schemes read, BM25 none) and the faceted path's corpus and device
segments, with real stats (utils/synth_schemes.py real_stats:
doclen_upper the longest doc, total_len the collection's length): the 20
configurations of utils/synth_schemes.py (the 15 other schemes at their
defaults, LM's four other smoothings, BM25) each over 64 of bench.py's
ORs (the draw continued past its 1,024: 1,280 queries) through
BatchSearcher(prefix_cap=8192, k=10) - BM25 and BM25Plus in impact-prefix
mode with its exact re-runs, the others on the exact path - and the
catalogue, 16 N (dense; its right side scores nothing), 16 D (dense and
scored: AND_MAYBE(match_all, OR(w, w)) on N's words, ranked by docid as
JAX ranks a dense plan without a sort, its scores held to the oracle, and
dense_rows must return nonzero scores), 16 S (synonym), 16 X (OP_MAX)
queries of utils/synth_browse.py (seed 13) through BatchSearcher.run and
32 relevance C calls of SegmentSearcher.execute with their collapse, under
TfIdf, PL2, DiceCoeff and LM absolute discount, and C alone under every
configuration
that scored nothing on the relevance ORs. score_slices, prefix_certify,
dense_rows and merge_special are held against their plain versions at
every launch (``Held``), bit for bit (max abs err 0.0), twice; every answer
is held to utils/synth_schemes.py's float64 oracle at each scheme's
derived tolerance (counts exact, an impact-prefix answer's count the docs
of the rows it read); every scheme but Bool returns a nonzero score.

Database path - the port's own Database (xapiand_tpu_torch/database.py)
at full width over utils/synth_docs.py's bank / netlog corpus: 200k JSON
documents (docs/EXAMPLES.md's /bank and /netlog shapes: text, numbers,
dates, IPv4 / IPv6 addresses, 10% of docs with several, geo points)
indexed through Database.index_document in 4 commits, then 1% deleted and
0.5% replaced; 512 Database.search calls in 8 families of 64 (H
histograms, R ranges + median, F filter + percentiles, N terms >
histogram > median, I ip_range + geo_ip, G geo_trixels + geo_distance, M
match-all count-only carrying 3-4 bundles: the dense path, P modes and
medians) and 256 plain term queries, which the native host scorer answers
(XT_HOST_PATH at its default; the earlier paths run with it 0, the device
path). The counted run's launches, routes, host ms a call and bind ms;
every answer against synth_docs' float64 oracle (in forked numpy workers);
one profiled window's device-busy share; then every K17c launch
(agg_buckets' code modes, agg_ranges, agg_hist, agg_filter) of the 512
searches held against its plain version, each kernel timed at its widest
launch beside its bound and its library yardstick (torch.bincount for
agg_buckets' counts and agg_hist, torch.searchsorted for agg_filter).

The geo path ends with an aggregation run: the 256 T queries again through
a BatchSearcher with ``_geo_bounds`` of loc and ``_cardinality`` of ts
(K17b: agg_metrics over the latitude and longitude channels, agg_distinct),
every kernel of the run (score_slices, merge_docs, geo_leaves,
filter_leaves, sort_topk and the two) held against its plain version at
every launch group, and the answers against synth_geo's oracle.

For each path, in order:

  1. the corpus (the faceted one with its fingerprint: numpy version,
     array hash, postings and values counts) and its launch groups;
  2. each kernel against its plain PyTorch version on the card, on the
     path's real launch groups (on the faceted path those of both
     XT_FULLWIDTH values), with times of both (CUDA events); on the
     faceted groups also sort_topk (and, on fullwidth groups,
     fullwidth_topk) for every key kind on synthetic columns (the path
     drives only value keys and docids), every K17a aggregation kind on
     the corpus columns at A's widest group, and each new kernel twice,
     bit for bit;
  3. the path, counted: the launch counters are set to 0 just before it
     and read just after; every kernel of the path > 0 (the faceted path:
     no group in prefix mode and prefix_certify 0; the relevance path: a
     prefix group ran); the queries the run re-ran on the exact path
     (BatchSearcher.reran), and that re-run's launch groups compared too;
  4. all 1024 results (the faceted path: of both XT_FULLWIDTH values; the
     positional and geo paths: all 1280) against a numpy oracle: relevance
     as tie groups with scores within rtol 1e-5; A and B as exact docid
     lists; counts exactly on the faceted and positional paths, and the
     faceted aggregations: facet counts per category code exact, price n,
     min and max exact (min and max as float32), sums within rtol 1e-5;
     the shaped response (merge_and_shape) of the first A query; the
     positional oracle applies the launch group's cand_cap and pmax, and
     every phrase and NEAR hit is checked in the text; the geo oracle
     tests each doc's first RMAX ranges against the cover and the window
     on the keys (counts and the first 10 docids exact), and holds
     config_bench's haversine bounds on every answer;
  5. QPS of 20 warm runs (median and spread), host planning's share of
     them, and the device-busy share of one run from a torch.profiler
     trace; on the faceted path the same traffic with the fullwidth path
     on and off, in the order on, off, off, on (not a gate).

It imports the port and bench.py (numpy only), nothing of JAX or of the
JAX package. The kernels are built first, from csrc/, one nvcc per source
started together.

Any failure raises (exit != 0). The second-to-last line is the kernel JSON
record (launches: the paths' counted runs; ms / plain_ms: per-launch
times summed over the launch groups compared; bound_ms: the least time the
card could take for the same launches, summed likewise, each launch the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s, the
H100 SXM's published rates, counted from this run's inputs, and bound_by
the one that dominates; library_ms: for geo_leaves the torch.searchsorted
calls of its two counts, for topk_rows torch.topk of the masked scores
(ties in no fixed order), for dense_rows one scatter_add_ of the term
weights, for agg_distinct torch.unique of the batch's packed keys plus
scatter_reduce_(amax) of the registers, for agg_buckets (its K17c modes)
and agg_hist torch.bincount of the rows' bucket (and bin) codes, for
agg_filter torch.searchsorted of the rows' docids in each term's postings,
null elsewhere: no single PyTorch call computes any of the other
functions); the last line is {"ok": true,
"device": {...}}.
Without a CUDA device, or outside a checkout of the repo, it exits
non-zero with no result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))

N_DOCS, VOCAB, N_QUERIES, TERMS, K = 1_000_000, 200_000, 1024, 3, 10
FACETED_DOCS, FACETED_PER_FAMILY = 1_000_000, 256
POSITIONAL_DOCS, POSITIONAL_EACH, POSITIONAL_THREE = 100_000, 512, 128
GEO_DOCS, GEO_P, GEO_T = 1_000_000, 1024, 256
BROWSE_M, BROWSE_N, BROWSE_S, BROWSE_X, BROWSE_C = 256, 128, 256, 256, 128
DB_DOCS, DB_COMMITS, DB_EACH, DB_TERMS = 200_000, 4, 64, 256
MAX_BATCH, PREFIX_CAP = 256, 8192
# queries a scheme; the catalogue's float64 oracles are the schemes path's
# largest cost (PERF.md section 5), so its depth is 16 a family since the
# Database path came in (32 before it)
SCHEME_RELEVANCE, SCHEME_CATALOGUE = 64, 16
ORACLE_RTOL = 1e-5        # float32 device sums vs the float64 oracle
KERNEL_RTOL = 1e-6        # kernel vs plain version: same float32 op order
AGG_RTOL = 1e-5           # aggregation sums: float32, another add order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
PEAK_OPS_PER_S = 67e12     # H100 SXM published float32 rate (no tensor core)
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
    "fullwidth_topk": ("xapiand_tpu_torch/csrc/fullwidth_topk.cu",
                       "xapiand_tpu/ops/executor.py:431"),
    "agg_metrics": ("xapiand_tpu_torch/csrc/agg_metrics.cu",
                    "xapiand_tpu/ops/aggs.py:249"),
    "agg_buckets": ("xapiand_tpu_torch/csrc/agg_buckets.cu",
                    "xapiand_tpu/ops/aggs.py:275"),
    "phrase_leaves": ("xapiand_tpu_torch/csrc/phrase_leaves.cu",
                      "xapiand_tpu/ops/phrase.py:28"),
    "geo_leaves": ("xapiand_tpu_torch/csrc/geo_leaves.cu",
                   "xapiand_tpu/ops/executor.py:367"),
    "collapse_rows": ("xapiand_tpu_torch/csrc/collapse_rows.cu",
                      "xapiand_tpu/ops/executor.py:577"),
    "dense_rows": ("xapiand_tpu_torch/csrc/dense_rows.cu",
                   "xapiand_tpu/ops/executor.py:1237"),
    "merge_special": ("xapiand_tpu_torch/csrc/merge_special.cu",
                      "xapiand_tpu/ops/executor.py:746"),
    "agg_distinct": ("xapiand_tpu_torch/csrc/agg_distinct.cu",
                     "xapiand_tpu/ops/aggs.py:424"),
    "agg_ranges": ("xapiand_tpu_torch/csrc/agg_ranges.cu",
                   "xapiand_tpu/ops/aggs.py:396"),
    "agg_hist": ("xapiand_tpu_torch/csrc/agg_hist.cu",
                 "xapiand_tpu/ops/aggs.py:52"),
    "agg_filter": ("xapiand_tpu_torch/csrc/agg_filter.cu",
                   "xapiand_tpu/ops/aggs.py:199"),
}
RELEVANCE_KERNELS = ("score_slices", "merge_docs", "topk_rows",
                     "prefix_certify")
FACETED_KERNELS = ("score_slices", "merge_docs", "compact_rows",
                   "filter_leaves", "sort_topk", "topk_rows",
                   "fullwidth_topk", "agg_metrics", "agg_buckets")
POSITIONAL_KERNELS = ("score_slices", "merge_docs", "phrase_leaves",
                      "filter_leaves", "topk_rows")
GEO_KERNELS = ("score_slices", "merge_docs", "geo_leaves", "filter_leaves",
               "sort_topk")
GEO_AGG_KERNELS = GEO_KERNELS + ("agg_metrics", "agg_distinct")
K17C_KERNELS = ("agg_buckets", "agg_ranges", "agg_hist", "agg_filter")
# the kernels the Database path launches: the text ORs' relevance path,
# the match-all family's dense path, and every aggregation kernel
DATABASE_KERNELS = ("score_slices", "merge_docs", "topk_rows", "dense_rows",
                    "filter_leaves", "agg_metrics") + K17C_KERNELS
BROWSE_KERNELS = ("score_slices", "merge_docs", "filter_leaves", "sort_topk",
                  "topk_rows", "agg_metrics", "agg_buckets", "collapse_rows",
                  "dense_rows", "merge_special", "agg_distinct")


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
    # the non-finite values equal, a NaN equal to a NaN
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or \
            not torch.equal(a[~fin].isnan(), b[~fin].isnan()) or \
            not torch.equal(a[~fin].nan_to_num(0.0), b[~fin].nan_to_num(0.0)):
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


def max_ulps(got, want):
    """The largest distance in float32 ulps between the float outputs of
    a kernel and its plain version."""
    import torch

    ulps = 0
    for x, y in zip(leaves(got), leaves(want)):
        if x.dtype == torch.float32 and x.shape == y.shape and x.numel():
            ix = x.view(torch.int32).long()
            iy = y.view(torch.int32).long()
            ix = torch.where(ix < 0, -2**31 - ix, ix)
            iy = torch.where(iy < 0, -2**31 - iy, iy)
            both = x.isnan() & y.isnan()   # a NaN is a NaN, any payload
            ulps = max(ulps, int(torch.where(both, 0, (ix - iy).abs())
                                 .max()))
    return ulps


def check_equal(name, a, b):
    """Equal tensors, a NaN equal to a NaN (the scores of the schemes that
    are NaN at a non-scoring term's constants, as JAX's are)."""
    import torch

    if (a is None) != (b is None) or (a is not None and not (
            torch.equal(a, b) or (a.is_floating_point() and
                                  a.shape == b.shape and
                                  torch.equal(a.isnan(), b.isnan()) and
                                  torch.equal(a.nan_to_num(0.0),
                                              b.nan_to_num(0.0))))):
        raise AssertionError(f"{name}: kernel and plain version differ")


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def twice(name, fn):
    """fn() launched twice: the two results, bit for bit the same."""
    import torch

    a, b = fn(), fn()
    for x, y in zip(leaves(a), leaves(b)):
        if not torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y):
            raise AssertionError(f"{name}: two kernel runs differ")
    return a


def check_stats(name, got, want):
    """(n, s, s2, min, max) tensors, kernel vs plain: n, min and max equal,
    s and s2 within AGG_RTOL. -> the largest absolute difference of a
    sum."""
    err = 0.0
    for nm, a, b in zip(("n", "s", "s2", "min", "max"), got, want):
        if nm not in ("s", "s2"):
            check_equal(f"{name} {nm}", a, b)
            continue
        d = (a.double() - b.double()).abs()
        if not bool((d <= AGG_RTOL * b.double().abs()).all()):
            raise AssertionError(f"{name} {nm}: kernel vs plain beyond rtol "
                                 f"{AGG_RTOL}: {float(d.max())}")
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


class Recorder:
    """Per-kernel max error, and per-launch times and bounds summed over
    the launch groups compared; one log line per group."""

    def __init__(self):
        self.rec: dict = {}
        self.line: dict = {}

    def note(self, name, err, ms, plain_ms, work, library_ms=None):
        """work: (bytes, operations) that the launch must move and do;
        library_ms: one PyTorch call's time for the same function."""
        r = self.rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                       "plain_ms": 0.0, "bytes_ms": 0.0,
                                       "ops_ms": 0.0, "bound_ms": 0.0,
                                       "library_ms": None})
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        b_ms = 1e3 * work[0] / HBM_BYTES_PER_S
        o_ms = 1e3 * work[1] / PEAK_OPS_PER_S
        r["bytes_ms"] += b_ms
        r["ops_ms"] += o_ms
        r["bound_ms"] += max(b_ms, o_ms)
        self.line[name] = (round(ms, 4), round(plain_ms, 4),
                           round(max(b_ms, o_ms), 4)) + (
            (round(library_ms, 4),) if library_ms is not None else ())

    def flush(self, what):
        log(f"[kernels] {what}: kernel/plain/bound(/library) ms "
            f"{self.line}")
        self.line = {}

    def record(self, name, launches):
        """The kernel's entry of the JSON line."""
        r = self.rec[name]
        return {"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("bytes" if r["bytes_ms"] >= r["ops_ms"]
                             else "operations"),
                "library_ms": r["library_ms"]}


# The work each kernel must do for one launch, counted from its inputs
# (each input byte read once, each output byte written once; data-
# dependent loops counted as this run's data runs them): (bytes, ops).

def n_true(t):
    return int(t.sum())


def log2c(n):
    return max(int(n) - 1, 1).bit_length()


# float operations per posting of each scheme's formula (a logarithm
# counted as one), models/weights.py S_* order
SCHEME_OPS = (9, 11, 1, 6, 0, 1, 5, 8, 9, 33, 18, 32, 22, 21, 12, 10, 9, 11,
              12)


def work_score_slices(lens, widths, B, R, spec=None, C=1, n_uniq=0):
    """score_slices: each in-length posting read once (12 bytes), its
    doc's uniqterms where the scheme reads them (n_uniq: the column's rows
    at most), the rows written, the per-term words read (C constants)."""
    import torch

    w = torch.tensor(widths, device=lens.device)
    n = int(torch.minimum(lens, w[None, :]).sum())
    ops = SCHEME_OPS[spec.sid] if spec is not None else 9
    return (12 * n + 8 * B * R + 4 * lens.numel() * C +
            4 * min(n, n_uniq), ops * n)


def work_merge_docs(ids, widths, deleted, orbits):
    B, R = ids.shape
    real = n_true(ids != 2**31 - 1)
    out = 5 + (4 if orbits is not None else 0)
    return (8 * B * R + 4 * B * len(widths) +
            (real if deleted is not None else 0) + out * B * R + 4 * B,
            real * sum(log2c(w) for w in widths))


def work_rows(R_rows, B, per_row, per_query):
    return per_row * B * R_rows + per_query * B, B * R_rows


def work_selected(B, R, per_row, n_sel, per_sel, out_bytes, n_col=None):
    """Rows read per_row bytes each, n_sel selected rows per_sel more; where
    the per_sel bytes are gathered by docid from a column of n_col rows,
    the column is an input read at most once, whatever the queries share."""
    n_read = n_sel if n_col is None else min(n_sel, n_col)
    return per_row * B * R + per_sel * n_read + out_bytes, B * R + n_sel


def n_rows(values):
    """The rows of the segment's value columns (every doc and the pad)."""
    return max((c["present"].shape[0] for c in values.values()), default=1)


def work_filter(ids, base, F, phbits, n_col=None):
    """filter_leaves: docids, orbits, base and verdict words read per row,
    5 key words of 17 bytes a leaf per first row (of n_col column rows at
    most), eligible written."""
    B, C = ids.shape
    first = base if base is not None else ids != 2**31 - 1
    per_row = 8 + (1 if base is not None else 0) + \
        (4 if phbits is not None else 0) + 1
    return work_selected(B, C, per_row, n_true(first), 17 * F, 4 * B, n_col)


# bytes of one eligible row's sort key columns, by key kind
KEY_BYTES = {"value": 9, "score": 0, "dist": 5, "geodist": 9,
             "strmetric": 8, "docid": 0}


def work_sort(specs, elig, k, n_col=None):
    """sort_topk / fullwidth_topk: ids, sums and flags per row, the key
    columns per eligible row (of n_col column rows at most), the top k
    (docid, score) written."""
    B, C = elig.shape
    return work_selected(B, C, 9, n_true(elig),
                         sum(KEY_BYTES[s[0]] for s in specs), 9 * B * k,
                         n_col)


def topk_library_ms(sums, owner, k):
    """The library yardstick of topk_rows: one torch.topk of the masked
    scores (the same rows and k; it breaks ties in no fixed order)."""
    import torch

    masked = torch.where(owner, sums, float("-inf"))
    kk = min(k, masked.shape[1])
    return cuda_ms(lambda: torch.topk(masked, kk, dim=1), reps=5)


def slices(searcher, cfg, batch, stats_d, rec):
    """score_slices of one launch group, kernel vs plain."""
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn

    seg = searcher.device_segment.arrays_pytree()
    params = searcher.scheme.kernel_spec(CollectionStats(
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
    rec.note("score_slices", err, cuda_ms(k1), cuda_ms(p1),
             work_score_slices(batch["lens"], widths, *ids.shape))
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
             cuda_ms(k2), cuda_ms(p2), work_merge_docs(ids, widths, None,
                                                       None))

    kk = min(cfg.verify_k, R - 1) + 1 if cfg.verify_k else cfg.k

    def k3():
        return kn.topk_rows(sums, ids, owner, kk)

    def p3():
        return kn._topk_rows_plain(sums, ids, owner, kk)

    (d, s), (pd, ps) = k3(), p3()
    check_equal("topk_rows docids", d, pd)
    check_equal("topk_rows scores", s, ps)
    B = ids.shape[0]
    rec.note("topk_rows", 0.0, cuda_ms(k3), cuda_ms(p3),
             work_rows(R, B, 9, 8 * kk), topk_library_ms(sums, owner, kk))

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
        # candidates read, one posting probe of 12 bytes per candidate
        # and term, the certified top k written
        rec.note("prefix_certify",
                 check_close("prefix_certify scores", cs, pcs),
                 cuda_ms(k4), cuda_ms(p4),
                 work_certify(B, kk, cfg.T, classes, cfg.k))
    rec.flush(f"{shape_name} B={ids.shape[0]} R={R}")


def compare_aggs(values, specs, ids, elig, rec, what):
    """agg_metrics and agg_buckets for the aggregation specs over one
    launch group's rows, kernel (twice, bit for bit) vs plain; times go to
    rec when rec is given, else to one log line."""
    from xapiand_tpu_torch.ops import aggs as ag
    from xapiand_tpu_torch.ops import kernels as kn

    dev = ids.device
    line = {}

    B, R = ids.shape
    ne = n_true(elig)

    def note(name, err, k, p, work):
        ms, pms = cuda_ms(k, reps=5), cuda_ms(p, reps=3)
        if rec is not None:
            rec.note(name, err, ms, pms, work)
        line.setdefault(name, []).append((round(ms, 4), round(pms, 4)))

    mets = [sp for sp in specs if sp[0] in ag.METRIC_KINDS]
    if mets or any(sp[0] == "count" for sp in specs):
        for c0 in range(0, max(len(mets), 1), kn.MAX_AGG_METRICS):
            cols = [(c["fval"], c["present"]) for c in
                    (ag.column(values, sp[1], dev)
                     for sp in mets[c0:c0 + kn.MAX_AGG_METRICS])]
            args = (ids, elig, cols)
            got = twice("agg_metrics", lambda: kn.agg_metrics(*args))
            want = kn._agg_metrics_plain(*args)
            check_equal("agg_metrics count", got[0], want[0])
            M = len(cols)
            note("agg_metrics", check_stats("agg_metrics", got[1:], want[1:]),
                 lambda: kn.agg_metrics(*args),
                 lambda: kn._agg_metrics_plain(*args),
                 work_selected(B, R, 5, ne, 5 * M, 20 * M * B + 4 * B,
                               n_rows(values)))
    for sp in specs:
        if sp[0] not in ("terms", "missing"):
            continue
        subs = sp[2] if sp[0] == "missing" else sp[3]
        codes = ag.column(values, sp[1], dev).get("cats") \
            if sp[0] == "terms" else ag.column(values, sp[1], dev)["present"]
        args = (ids, elig, sp[0], codes, sp[2] if sp[0] == "terms" else 1,
                ag.sub_columns(values, subs, dev))
        got = twice(f"agg_buckets {sp}", lambda: kn.agg_buckets(*args))
        want = kn._agg_buckets_plain(*args)
        check_equal(f"agg_buckets {sp} counts", got[0], want[0])
        err = 0.0
        if subs:
            err = check_stats(f"agg_buckets {sp}", got[1], want[1])
        S = len(args[5])
        n_val = sum(c is not None for c in args[5])
        note("agg_buckets", err, lambda: kn.agg_buckets(*args),
             lambda: kn._agg_buckets_plain(*args),
             work_selected(B, R, 5, ne, 4 + 5 * n_val,
                           4 * B * args[4] * (1 + 5 * S), n_rows(values)))
    if rec is None:
        log(f"[kernels] {what}: kernel/plain ms {line}")


FW_KINDS = (("value", None, False), ("dist", None, False),
            ("dist", None, True), ("geodist", None, False),
            ("strmetric", None, True, 64))


def compare_faceted(searcher, cfg, batch, stats_d, rec, shape_name,
                    sort_inputs, all_aggs=None):
    """Each faceted-path kernel against its plain version on one launch
    group's real inputs, in execute_batch's order (the fullwidth path
    skips the compaction and orders through fullwidth_topk); then
    sort_topk - and fullwidth_topk on a fullwidth group - for every key
    kind on the group's final rows, and every aggregation kind of
    all_aggs when given. -> (B, uncertified queries of the launch)."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.ops.executor import fullwidth_fast, upper_tree
    from xapiand_tpu_torch.utils import synth_faceted as sf

    seg, _params, _post, _args, widths, ids, w, _tail = slices(
        searcher, cfg, batch, stats_d, rec)
    if any(cfg.prefix):
        raise AssertionError(f"faceted group in prefix mode: {cfg}")
    R = ids.shape[1]
    values = seg["values"]
    deleted = seg["deleted"] if cfg.has_deletes else None
    bits = batch["group_bits"]
    cap = cfg.compact_cap if 0 < cfg.compact_cap < R else 0
    fast = fullwidth_fast(cfg, values, R)
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
             cuda_ms(lambda: kn._merge_docs_plain(*margs)),
             work_merge_docs(ids, widths, deleted, got[3]))
    sums, mask, _count, orbits = got
    B = ids.shape[0]
    if cap and (cfg.n_filters or
                (not fast and (cfg.sort or cfg.with_aggs))):
        cargs = (mask, ids, sums, orbits, cap)
        got, want = kn.compact_rows(*cargs), kn._compact_rows_plain(*cargs)
        if int(got[3].max()) > cap:
            raise AssertionError(f"compact_rows: {int(got[3].max())} rows "
                                 f"exceed the cap {cap}")
        for nm, a, b in zip(("docids", "sums", "orbits", "n"), got, want):
            check_equal(f"compact_rows {nm}", a, b)
        row_b = 12 if orbits is not None else 8
        rec.note("compact_rows", 0.0, cuda_ms(lambda: kn.compact_rows(
            *cargs)), cuda_ms(lambda: kn._compact_rows_plain(*cargs)),
            work_selected(B, R, 1, int(got[3].clamp(max=cap).sum()), row_b,
                          B * cap * row_b + 4 * B))
        ids, sums, orbits, _n = got
        mask = None if cfg.n_filters else ids != kn.SENTINEL
    if cfg.n_filters:
        fargs = (values, cfg.filter_slots, cfg.filter_vmax,
                 batch["fparams"], ids, mask, orbits, prog)
        cols = [values.get(s) for s in cfg.filter_slots]
        pargs = (cols, tuple(cfg.filter_vmax)) + fargs[3:]
        got, want = kn.filter_leaves(*fargs), kn._filter_leaves_plain(*pargs)
        check_equal("filter_leaves eligible", got[0], want[0])
        check_equal("filter_leaves count", got[1], want[1])
        rec.note("filter_leaves", 0.0,
                 cuda_ms(lambda: kn.filter_leaves(*fargs)),
                 cuda_ms(lambda: kn._filter_leaves_plain(*pargs)),
                 work_filter(ids, mask, cfg.n_filters, None,
                             n_rows(values)))
        mask = got[0]
    if cfg.with_aggs:
        compare_aggs(values, cfg.with_aggs, ids, mask, rec, shape_name)
    if all_aggs:
        compare_aggs(values, all_aggs, ids, mask, None,
                     f"{shape_name} every aggregation kind")
    n_uncert = 0
    if fast and len(cfg.sort) == 1:
        spec = cfg.sort[0]
        fargs = (spec, ids, sums, mask, cfg.k, values,
                 batch.get("sort_targets"), batch.get("sort_strtabs"))
        pargs = (spec, values.get(spec[1]), ids, sums, mask, cfg.k,
                 batch.get("sort_targets"), batch.get("sort_strtabs") or {})
        got = twice("fullwidth_topk", lambda: kn.fullwidth_topk(*fargs))
        want = kn._fullwidth_topk_plain(*pargs)
        for nm, a, b in zip(("docids", "scores", "certified"), got, want):
            check_equal(f"fullwidth_topk {nm}", a, b)
        n_uncert = int((~got[2]).sum())
        rec.note("fullwidth_topk", 0.0,
                 cuda_ms(lambda: kn.fullwidth_topk(*fargs)),
                 cuda_ms(lambda: kn._fullwidth_topk_plain(*pargs), reps=3),
                 work_sort((spec,), mask, cfg.k, n_rows(values)))
    elif cfg.sort:
        sargs = (cfg.sort, ids, sums, mask, cfg.k, values,
                 batch["sort_targets"])
        pargs = (cfg.sort, [values.get(s[1]) for s in cfg.sort], ids, sums,
                 mask, cfg.k, batch["sort_targets"], {})
        got, want = kn.sort_topk(*sargs), kn._sort_topk_plain(*pargs)
        check_equal("sort_topk docids", got[0], want[0])
        check_equal("sort_topk scores", got[1], want[1])
        rec.note("sort_topk", 0.0, cuda_ms(lambda: kn.sort_topk(*sargs)),
                 cuda_ms(lambda: kn._sort_topk_plain(*pargs)),
                 work_sort(cfg.sort, mask, cfg.k, n_rows(values)))
    else:
        targs = (sums, ids, mask, cfg.k)
        got, want = kn.topk_rows(*targs), kn._topk_rows_plain(*targs)
        check_equal("topk_rows docids", got[0], want[0])
        check_equal("topk_rows scores", got[1], want[1])
        rec.note("topk_rows", 0.0, cuda_ms(lambda: kn.topk_rows(*targs)),
                 cuda_ms(lambda: kn._topk_rows_plain(*targs)),
                 work_rows(ids.shape[1], B, 9, 8 * cfg.k),
                 topk_library_ms(sums, mask, cfg.k))
    # every sort key kind, on synthetic columns over the same rows
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
    fw_kinds = {}
    for spec in FW_KINDS if fast else ():
        spec = (spec[0], sf.SORT_TEST_SLOT) + spec[2:]
        strtabs = {0: tab[:B]} if spec[0] == "strmetric" else {}
        tgt = tg[:B, :1].contiguous()
        fargs = (spec, ids, sums, mask, cfg.k, vals, tgt, strtabs)
        pargs = (spec, col, ids, sums, mask, cfg.k, tgt, strtabs)
        got = twice(f"fullwidth_topk {spec}",
                    lambda: kn.fullwidth_topk(*fargs))
        want = kn._fullwidth_topk_plain(*pargs)
        for nm, a, b in zip(("docids", "scores", "certified"), got, want):
            check_equal(f"fullwidth_topk {spec} {nm}", a, b)
        fw_kinds[f"{spec[0]}{'D' if spec[2] else 'A'}"] = (
            round(cuda_ms(lambda: kn.fullwidth_topk(*fargs), reps=3), 4),
            round(cuda_ms(lambda: kn._fullwidth_topk_plain(*pargs), reps=2),
                  4), int((~got[2]).sum()))
    torch.cuda.synchronize()
    rec.flush(f"{shape_name} B={B} R={R} cap={cap} fullwidth={fast}")
    log(f"[kernels] {shape_name} sort_topk every key kind, kernel/plain ms "
        f"{kinds}")
    if fw_kinds:
        log(f"[kernels] {shape_name} fullwidth_topk key kinds, kernel/plain "
            f"ms, uncertified: {fw_kinds}")
    return B, n_uncert


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


@contextmanager
def fullwidth(flag):
    """XT_FULLWIDTH=flag inside the block (BatchSearcher and query/plan.py
    fullwidth_ok read it), "1" again after it."""
    os.environ["XT_FULLWIDTH"] = flag
    try:
        yield
    finally:
        os.environ["XT_FULLWIDTH"] = "1"


def timed_runs(runs, stats, n_queries, smi, tag, profiled=True):
    """20 warm runs of every (BatchSearcher, irs) in ``runs``, host-clock
    fenced by torch.cuda.synchronize(); each searcher's plan is wrapped on
    the instance so host planning (re-runs' plans included) is timed inside
    the same runs; then, if profiled, one run under torch.profiler.
    -> the median QPS."""
    import torch

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
    for (bs, _irs), plan in zip(runs, saved):
        bs.plan = plan
    if profiled:
        device_trace(runs, stats, tag)
    return n_queries / med


def device_trace(runs, stats, tag):
    """One run of every (BatchSearcher, irs) under torch.profiler: the
    device-busy share and the device ms by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

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
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (
                ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    log(f"[trace] {tag}: device (ms, launches) by kernel, largest first: "
        + str({n[:40]: (round(v, 4), c) for n, (v, c) in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][0])[:12]}))


# --------------------------------------------------------------------------
# kernels held against their plain versions inside a run of the path itself
# --------------------------------------------------------------------------

def work_collapse(ids, elig, cmax, n_col):
    """collapse_rows: docid, score and flag read per row, the key column
    (hi, lo, present; n_col rows) per eligible row, keep and tie written
    per row; one table operation per eligible row and round."""
    B, R = ids.shape
    ne = n_true(elig)
    return 14 * B * R + 9 * min(ne, n_col), B * R + ne * cmax


def work_dense(lens, classes, B, nd1):
    """dense_rows, the function: each term block's postings read once
    (docid, wdf, doclen) and the deleted flags once; scores and orbits
    written per (query, doc), 8 bytes, and the live flags once, one byte a
    doc; one binary search per (query, doc) and term with postings. The
    kernel writes 5 bytes a row more than this (the docid of every row and
    the live flags once a query, for the kernels after it): that is the
    design's cost above the bound, not part of it."""
    import torch

    T = len(classes)
    if not T:
        return 2 * nd1 + 8 * B * nd1, B * nd1
    ln = torch.minimum(lens, torch.tensor(classes, device=lens.device))
    steps = torch.where(ln > 0, torch.log2(ln.clamp(min=1).float()).ceil()
                        + 1, 0.0)
    return (12 * int(ln.sum()) + 2 * nd1 + 8 * B * nd1 + 20 * B * T,
            B * nd1 + nd1 * int(steps.sum()))


def work_special(ids, widths, max_specs, syn_groups):
    """merge_special: docid and weight read and the sum written per row,
    the doc's length and the synonym terms' wdf per real row; per real row
    one pass of binary searches over the term blocks for the base, each
    branch and each synonym group."""
    B, R = ids.shape
    real = n_true(ids != 2**31 - 1)
    passes = 1 + sum(len(br) for br in max_specs) + len(syn_groups)
    return (12 * B * R + 8 * B * len(widths) +
            (8 * real if syn_groups else 0),
            real * passes * sum(log2c(w) for w in widths))


def work_distinct(ids, elig, n_col):
    """agg_distinct: docid and flag per row, the key column (n_col rows)
    per eligible row, the count and 1024 registers written per query; a
    hash and an insert per eligible row."""
    B, R = ids.shape
    ne = n_true(elig)
    return 5 * B * R + 9 * min(ne, n_col) + 4 * B * 1025, B * R + ne


def held_collapse(a):
    from xapiand_tpu_torch.ops import kernels as kn

    ids, sums, elig, col, cmax = a
    c = col if col is not None else kn.absent_column(ids.device)
    cm = min(int(cmax), kn.MAX_COLLAPSE)

    def check(got, want):
        check_equal("collapse_rows keep", got[0], want[0])
        check_equal("collapse_rows tie", got[1], want[1])
        return 0.0

    return (lambda: kn._collapse_rows_plain(ids, sums, elig, c, cm), check,
            f"B={ids.shape[0]} R={ids.shape[1]} max={cm}",
            lambda: work_collapse(ids, elig, cm, c["present"].shape[0]),
            None)


def held_dense(a):
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    post, offsets, lens, tconst, scoring, _bits, classes, deleted, spec = \
        a[:9]
    uniq = a[9] if len(a) > 9 else None
    B, T = offsets.shape
    nd1 = deleted.shape[0]

    def check(got, want):
        for nm, g, w in zip(("ids", "scores", "orbits", "live"), got, want):
            if nm != "scores":
                check_equal(f"dense_rows {nm}", g, w)
        return check_close("dense_rows scores", got[1], want[1])

    def library():
        """One scatter_add_ of the term weights over the doc axis (the
        weights and docids made beforehand)."""
        d, w, _tail = kn._score_slices_plain(
            post, None, offsets, lens, tconst, scoring, classes,
            (False,) * T, spec, uniq)
        d = d.clamp(max=nd1 - 1).long()
        return cuda_ms(lambda: torch.zeros(
            (B, nd1), dtype=torch.float32, device=d.device).scatter_add_(
                1, d, w), reps=3)

    def work():
        nbytes, ops = work_dense(lens, tuple(classes), B, nd1)
        C = tconst.shape[2] if tconst.dim() == 3 else 1
        return (nbytes + 4 * (C - 1) * B * T +
                (4 * nd1 if uniq is not None else 0),
                ops + (SCHEME_OPS[spec.sid] - 9) * int(lens.sum()))

    return (lambda: kn._dense_rows_plain(*a), check,
            f"B={B} R={nd1} T={T} classes={tuple(classes)} "
            f"scored={bool(scoring.any())}", work,
            library if T else None)


def held_special(a):
    from xapiand_tpu_torch.ops import kernels as kn

    ids, _w, widths, _bits, _off, _wdf, _dl, max_specs, syn_groups = a[:9]

    def check(got, want):
        return check_close("merge_special sums", got, want)

    uniq = a[11] if len(a) > 11 else None

    def work():
        nbytes, ops = work_special(ids, widths, max_specs, syn_groups)
        if syn_groups and uniq is not None:
            nbytes += 4 * min(n_true(ids != 2**31 - 1), uniq.shape[0])
        return nbytes, ops

    return (lambda: kn._merge_special_plain(*a), check,
            f"B={ids.shape[0]} R={ids.shape[1]} T={len(widths)} "
            f"max_specs={max_specs} syn_groups={syn_groups}", work, None)


def held_distinct(a):
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    ids, elig, col = a

    def check(got, want):
        check_equal("agg_distinct n", got[0], want[0])
        check_equal("agg_distinct registers", got[1], want[1])
        return 0.0

    def library():
        """torch.unique of the batch's packed 64-bit keys (one call over
        every query's rows) and scatter_reduce_(amax) into the registers;
        keys, register indices and values made beforehand."""
        B = ids.shape[0]
        d = ids.clamp(max=col["hi"].shape[0] - 1).long()
        m = elig & col["present"][d]
        kh, kl = col["hi"][d], col["lo"][d]
        keys = torch.where(m, (kh.long() << 32) | (kl.long() & 0xFFFFFFFF),
                           2**63 - 1)
        idx = kn.hash32(kh, kl) >> 22
        del d, kh, kl
        rho = m.to(torch.int32)
        ms = cuda_ms(lambda: torch.unique(keys), reps=2)
        return ms + cuda_ms(lambda: torch.zeros(
            (B, kn.HLL_REGS), dtype=torch.int32,
            device=ids.device).scatter_reduce_(1, idx, rho, "amax"), reps=2)

    return (lambda: kn._agg_distinct_plain(ids, elig, col), check,
            f"B={ids.shape[0]} R={ids.shape[1]}",
            lambda: work_distinct(ids, elig, col["present"].shape[0]),
            library)


def held_topk(a):
    """topk_rows; after a collapse its tie ranks order equal scores."""
    from xapiand_tpu_torch.ops import kernels as kn

    scores, ids, owner, k = a[:4]
    tie = a[4] if len(a) > 4 else None

    def check(got, want):
        check_equal("topk_rows docids", got[0], want[0])
        check_equal("topk_rows scores", got[1], want[1])
        return 0.0

    B, R = ids.shape
    return (lambda: kn._topk_rows_plain(scores, ids, owner, k, tie), check,
            f"{'tie ' if tie is not None else ''}B={B} R={R} k={k}",
            lambda: work_rows(R, B, 13 if tie is not None else 9, 8 * k),
            lambda: topk_library_ms(scores, owner, k))


def held_slices(a):
    from xapiand_tpu_torch.ops import kernels as kn

    post, imp, offsets, lens, tconst, scoring, widths, is_prefix, spec = \
        a[:9]
    uniq = a[9] if len(a) > 9 else None
    widths = tuple(int(w) for w in widths)
    pflags = tuple(bool(p) for p in is_prefix)
    B, R = offsets.shape[0], sum(widths)
    C = tconst.shape[2] if tconst.dim() == 3 else 1

    def check(got, want):
        check_equal("score_slices ids", got[0], want[0])
        return max(check_close("score_slices w", got[1], want[1]),
                   check_close("score_slices tail", got[2], want[2]))

    return (lambda: kn._score_slices_plain(post, imp, offsets, lens, tconst,
                                           scoring, widths, pflags, spec,
                                           uniq),
            check, f"B={B} R={R} T={len(widths)}",
            lambda: work_score_slices(lens, widths, B, R, spec, C,
                                      uniq.shape[0] if uniq is not None
                                      else 0), None)


def work_certify(B, kk, T, classes, k):
    """prefix_certify: the candidates read, one posting probe of 12 bytes
    per candidate and term, the certified top k written; a binary search
    per candidate and term."""
    return (8 * B * kk + 12 * B * (kk - 1) * T + 9 * B * min(k, kk - 1),
            B * (kk - 1) * sum(log2c(c) for c in classes))


def held_certify(a):
    from xapiand_tpu_torch.ops import kernels as kn

    post, offsets, lens, tconst, scoring, classes, tail, cand_d, cand_v, \
        k, spec = a[:11]
    uniq = a[11] if len(a) > 11 else None
    classes = tuple(int(c) for c in classes)
    B, kk = cand_d.shape
    kout = min(k, kk - 1)

    def check(got, want):
        check_equal("prefix_certify docids", got[0], want[0])
        check_equal("prefix_certify certified", got[2], want[2])
        return check_close("prefix_certify scores", got[1], want[1])

    return (lambda: kn._prefix_certify_plain(
        post, offsets, lens, tconst, scoring, classes, tail, cand_d, cand_v,
        kout, spec, uniq), check, f"B={B} K={kk - 1} T={len(classes)}",
        lambda: work_certify(B, kk, len(classes), classes, k), None)


def held_merge(a):
    from xapiand_tpu_torch.ops import kernels as kn

    a = tuple(a) + (None, None, None, False)[len(a) - 3:]
    ids, _w, widths, bits, deleted, prog, want_orbits = a

    def check(got, want):
        for nm, g, w in zip(("mask", "count", "orbits"), got[1:], want[1:]):
            check_equal(f"merge_docs {nm}", g, w)
        return check_close("merge_docs sums", got[0], want[0])

    return (lambda: kn._merge_docs_plain(*a), check,
            f"B={ids.shape[0]} R={ids.shape[1]} T={len(widths)} "
            f"bits={bits is not None} deletes={deleted is not None} "
            f"tree={bool(prog)}",
            lambda: work_merge_docs(ids, widths, deleted,
                                    ids if want_orbits else None), None)


def held_compact(a):
    from xapiand_tpu_torch.ops import kernels as kn

    mask, ids, _sums, orbits, cap = a

    def check(got, want):
        if int(got[3].max()) > cap:
            raise AssertionError(f"compact_rows: {int(got[3].max())} rows "
                                 f"exceed the cap {cap}")
        for nm, g, w in zip(("docids", "sums", "orbits", "n"), got, want):
            check_equal(f"compact_rows {nm}", g, w)
        return 0.0

    B, R = ids.shape
    row_b = 12 if orbits is not None else 8
    return (lambda: kn._compact_rows_plain(*a), check,
            f"B={B} R={R} cap={cap}",
            lambda: work_selected(B, R, 1, min(n_true(mask), B * cap), row_b,
                                  B * cap * row_b + 4 * B), None)


def held_filter(a):
    from xapiand_tpu_torch.ops import kernels as kn

    values, slots, vmax, fparams, ids, base, orbits, prog = a[:8]
    phbits, geobits = (tuple(a[8:]) + (None, None))[:2]
    cols = [values.get(sl) for sl in slots]
    vm = tuple(int(vmax[i]) if i < len(vmax) else 1
               for i in range(len(slots)))

    def check(got, want):
        check_equal("filter_leaves eligible", got[0], want[0])
        check_equal("filter_leaves count", got[1], want[1])
        return 0.0

    def work():
        nbytes, ops = work_filter(ids, base, len(slots), phbits,
                                  n_rows(values))
        return nbytes + (4 * ids.numel() if geobits is not None else 0), ops

    return (lambda: kn._filter_leaves_plain(cols, vm, fparams, ids, base,
                                            orbits, prog, phbits, geobits),
            check, f"B={ids.shape[0]} R={ids.shape[1]} F={len(slots)} "
            f"base={base is not None} geo={geobits is not None}", work, None)


def held_geo(a):
    from xapiand_tpu_torch.ops import kernels as kn

    cols, specs, queries, ids, base = a

    def check(got, want):
        check_equal("geo_leaves verdicts", got, want)
        return 0.0

    return (lambda: kn._geo_leaves_plain(*a), check,
            f"B={ids.shape[0]} R={ids.shape[1]} geo_specs={tuple(specs)} "
            f"base={base is not None}",
            lambda: work_geo(ids, base, cols, specs, queries),
            lambda: searchsorted_ms(cols, specs, queries, ids))


# bytes a bucket code reads per eligible row, by agg_buckets mode
CODE_BYTES = {"terms": 4, "missing": 1, "mask": 1, "histogram": 5,
              "range": 5, "trixels": 12}


def _code_rows(mode, codes):
    """The rows of the column(s) a bucket mode reads by docid, or None."""
    if mode == "mask" or codes is None:
        return None
    if isinstance(codes, dict):
        return (codes["doc_off"] if mode == "trixels"
                else codes["fval"]).shape[0]
    return codes.shape[0]


def held_buckets(a, **kw):
    """agg_buckets: terms / missing (K17a) and the K17c modes (histogram,
    a nested level, geo_trixels, the filter mask)."""
    from xapiand_tpu_torch.ops import kernels as kn

    ids, elig, mode, codes, nb = a[:5]
    subs = a[5] if len(a) > 5 else kw.get("subs", ())
    prev, size = kw.get("prev"), kw.get("size") or nb
    want_codes, clamp = kw.get("want_codes", False), kw.get("sub_clamp", 0)

    def plain():
        return kn._agg_buckets_plain(ids, elig, mode, codes, nb, subs, prev,
                                     size, want_codes, clamp)

    def check(got, want):
        check_equal("agg_buckets counts", got[0], want[0])
        if want_codes:
            check_equal("agg_buckets codes", got[2], want[2])
        return check_stats("agg_buckets", got[1], want[1]) if subs else 0.0

    B, R = ids.shape
    n_val = sum(c is not None for c in subs)

    def work():
        # eligible flag and docid a row (the mask a row in mask mode), the
        # code's column bytes and each value sub's fval and flag per
        # eligible row; the counts and statistics out. A nested level's
        # codes, written for the next level and read back by it, are the
        # chain's own intermediates, not the function's
        per_sel = CODE_BYTES[mode] + 5 * n_val
        out = 4 * B * size * (1 + 5 * len(subs)) + \
            (4 * B * nb if mode == "trixels" else 0)
        per_row = 5 + (1 if mode == "mask" else 0)
        return work_selected(B, R, per_row, n_true(elig), per_sel, out,
                             _code_rows(mode, codes))

    def library():
        # torch.bincount of each eligible row's (query, bucket) code: the
        # counts, not the sub statistics
        import torch

        code = kn._agg_buckets_plain(ids, elig, mode, codes, nb, (), prev,
                                     size, True)[2]
        flat = (code + size * torch.arange(B, device=ids.device)[:, None])
        flat = flat[code >= 0]
        return cuda_ms(lambda: torch.bincount(flat, minlength=B * size),
                       reps=5)

    return (plain, check,
            f"B={B} R={R} {mode} nb={nb} size={size} subs={len(subs)}",
            work, library if mode not in ("terms", "missing") else None)


def held_ranges(a, **kw):
    """agg_ranges (K17c): range, geodist_range, key_range, geo_ip."""
    from xapiand_tpu_torch.ops import kernels as kn

    ids, elig, mode, col, bounds, nb = a[:6]
    subs = a[6] if len(a) > 6 else kw.get("subs", ())
    vmax, assign, origin = kw.get("vmax", 1), kw.get("assign"), \
        kw.get("origin")
    want_member = kw.get("want_member", False)

    def plain():
        return kn._agg_ranges_plain(ids, elig, mode, col, bounds, nb, subs,
                                    vmax, assign, origin, want_member)

    def check(got, want):
        check_equal("agg_ranges counts", got[0], want[0])
        if want_member:
            check_equal("agg_ranges member", got[2], want[2])
        return check_stats("agg_ranges", got[1], want[1]) if subs else 0.0

    B, R = ids.shape
    n_val = sum(c is not None for c in subs)
    nr = bounds.shape[1]

    def work():
        # per eligible row its value(s): fval (+ fval2) or four key words
        # and, for a doc of several values, its per-value keys, and each
        # value sub's fval and flag; a test per range (geo_ip: per
        # interval); the counts and statistics out. The byte a (row,
        # range) of membership that the kernel writes for its subs pass
        # and reads back is the design's intermediate, not the function's
        keyed = mode in ("key", "geo_ip")
        per_sel = 4 + 1 + (16 if keyed else (8 if mode == "geodist" else 4))
        sel = n_true(elig)
        mv = 0
        if keyed and vmax > 1 and "mv_len" in col:
            d = ids[elig].clamp(max=col["mv_len"].shape[0] - 1).long()
            mv = 8 * int(col["mv_len"][d].sum())
        out = 4 * B * nb * (1 + 5 * len(subs)) + 5 * n_val * sel
        b, o = work_selected(B, R, 1, sel, per_sel,
                             out + mv + bounds.numel() * 4,
                             col["present"].shape[0])
        return b, o + sel * nr * (20 if mode == "geodist" else 2)

    return (plain, check,
            f"B={B} R={R} {mode} nr={nr} nb={nb} vmax={vmax} "
            f"subs={len(subs)}", work, None)


def held_hist(a, **kw):
    """agg_hist (K17c): order-statistic histograms."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    ids, elig, fval, present, params, nbins = a[:6]
    codes, member, nb = kw.get("codes"), kw.get("member"), kw.get("nb", 1)
    if member is not None:
        nb = member.shape[2]

    def plain():
        return kn._agg_hist_plain(ids, elig, fval, present, params, nbins,
                                  codes, member, nb)

    def check(got, want):
        check_equal("agg_hist", got, want)
        return 0.0

    B, R = ids.shape

    def work():
        sel = n_true(elig)
        per_sel = 4 + 5 + (4 if codes is not None else 0) + \
            (nb if member is not None else 0)
        b, o = work_selected(B, R, 1, sel, per_sel, 4 * B * nb * nbins,
                             fval.shape[0])
        return b, o + 3 * sel

    def library():
        # torch.bincount of each counted row's (query, bucket, bin) index
        d = ids.clamp(max=fval.shape[0] - 1).long()
        m = elig & present[d]
        vb = kn.value_bins(fval[d], params, nbins)
        if member is not None:
            bi, ri, ji = (member & m[:, :, None]).nonzero(as_tuple=True)
        else:
            c = torch.zeros_like(vb) if codes is None else codes.long()
            bi, ri = (m & (c >= 0)).nonzero(as_tuple=True)
            ji = c[bi, ri]
        flat = (bi * nb + ji) * nbins + vb[bi, ri]
        return cuda_ms(lambda: torch.bincount(flat,
                                              minlength=B * nb * nbins),
                       reps=5)

    mode = "codes" if codes is not None else \
        ("member" if member is not None else "one")
    return (plain, check, f"B={B} R={R} {mode} nb={nb} bins={nbins}", work,
            library)


def held_afilter(a):
    """agg_filter (K17c): the filter bucket's posting lookups."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    ids, elig, post, spans, Lf = a[:5]

    def plain():
        return kn._agg_filter_plain(ids, elig, post, spans, Lf)

    def check(got, want):
        check_equal("agg_filter", got, want)
        return 0.0

    B, R = ids.shape
    nt = spans.shape[1]

    def work():
        sel = n_true(elig)
        span = int(spans[..., 1].sum())
        b, o = work_selected(B, R, 2, sel, 4 * nt, B * R + 4 * span)
        return b, o + sel * nt * log2c(Lf)

    def library():
        # torch.searchsorted of every row's docid in each term's span
        sp = spans.cpu().tolist()

        def run():
            for b in range(B):
                for off, ln in sp[b]:
                    torch.searchsorted(post[off:off + ln], ids[b])
        return cuda_ms(run, reps=5)

    return (plain, check, f"B={B} R={R} terms={nt} Lf={Lf}", work, library)


def held_sort(a):
    """sort_topk over the dense path's rows (every doc a row)."""
    from xapiand_tpu_torch.ops import kernels as kn

    specs, ids, sums, elig, k, values = a[:6]
    targets = a[6] if len(a) > 6 else None
    strtabs = (a[7] if len(a) > 7 else None) or {}
    cols = [values.get(sp[1]) if sp[0] not in ("score", "docid") else None
            for sp in specs]

    def check(got, want):
        check_equal("sort_topk docids", got[0], want[0])
        check_equal("sort_topk scores", got[1], want[1])
        return 0.0

    return (lambda: kn._sort_topk_plain(specs, cols, ids, sums, elig, k,
                                        targets, strtabs), check,
            f"B={ids.shape[0]} R={ids.shape[1]} keys="
            f"{'-'.join(sp[0] for sp in specs)}",
            lambda: work_sort(specs, elig, k, n_rows(values)), None)


def held_metrics(a):
    """agg_metrics over the channels of a geo_stats aggregation."""
    from xapiand_tpu_torch.ops import kernels as kn

    ids, elig, cols = a

    def check(got, want):
        check_equal("agg_metrics count", got[0], want[0])
        return check_stats("agg_metrics", got[1:], want[1:])

    B, R = ids.shape
    M = len(cols)
    return (lambda: kn._agg_metrics_plain(ids, elig, cols), check,
            f"B={B} R={R} metrics={M}",
            lambda: work_selected(B, R, 5, n_true(elig), 5 * M,
                                  20 * M * B + 4 * B,
                                  cols[0][0].shape[0] if cols else None),
            None)


HELD = {"collapse_rows": held_collapse, "dense_rows": held_dense,
        "merge_special": held_special, "agg_distinct": held_distinct,
        "topk_rows": held_topk, "sort_topk": held_sort,
        "agg_metrics": held_metrics, "score_slices": held_slices,
        "merge_docs": held_merge, "compact_rows": held_compact,
        "filter_leaves": held_filter, "geo_leaves": held_geo,
        "agg_buckets": held_buckets, "prefix_certify": held_certify,
        "agg_ranges": held_ranges, "agg_hist": held_hist,
        "agg_filter": held_afilter}


class Held:
    """Inside the block, every call the port makes to one of ``names`` (a
    wrapper of ops/kernels.py) is held against the kernel's plain version
    on the call's own tensors: the kernel is launched twice (bit for bit
    the same) and compared, and the call returns the kernel's result, so
    the run goes on as the port runs it. After the block each kernel is
    timed at its widest launch (the most bytes of its bound), beside the
    plain version, its bound and its library yardstick. ``calls`` counts
    the calls held, per kernel, and ``nonzero`` the nonzero floats the
    kernel returned over them."""

    def __init__(self, rec, tag, names, exact=False):
        """exact: every float the kernel returns must be the plain
        version's, bit for bit (max abs err 0.0)."""
        self.rec, self.tag, self.exact = rec, tag, exact
        self.calls = {n: 0 for n in names}
        self.nonzero = {n: 0 for n in names}
        self.widest: dict = {}
        self.saved: dict = {}

    def __enter__(self):
        from xapiand_tpu_torch.ops import kernels as kn

        for name in self.calls:
            self.saved[name] = getattr(kn, name)
            setattr(kn, name, self.hold(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        from xapiand_tpu_torch.ops import kernels as kn

        for name, fn in self.saved.items():
            setattr(kn, name, fn)
        if exc[0] is None:
            for name, (_b, err, key, run, plain, work, library) in \
                    self.widest.items():
                self.rec.note(name, err, cuda_ms(run, reps=5),
                              cuda_ms(plain, reps=2), work,
                              library() if library else None)
                self.rec.flush(f"{self.tag} widest {key}")
        self.widest.clear()

    def hold(self, name, kernel):
        def held(*args, **kw):
            plain, check, key, work, library = HELD[name](args, **kw)
            got = twice(name, lambda: kernel(*args, **kw))
            want = plain()
            err = check(got, want)
            if self.exact and err != 0.0:
                raise AssertionError(
                    f"{name} {self.tag}: kernel vs plain max abs err {err}, "
                    f"{max_ulps(got, want)} ulps at most")
            self.calls[name] += 1
            self.nonzero[name] += sum(int(x.count_nonzero())
                                      for x in leaves(got)
                                      if x.is_floating_point())
            w = work()
            best = self.widest.get(name)
            err = max(err, best[1] if best else 0.0)
            if best is None or w[0] > best[0]:
                self.widest[name] = (w[0], err, key,
                                     lambda: kernel(*args, **kw), plain, w,
                                     library)
            else:
                self.widest[name] = best[:1] + (err,) + best[2:]
            return got

        return held


def browse_match(fam, p, r, w, cat_of, agg_at):
    """One browse result against the oracle's answer (see the module
    docstring, step 4)."""
    import numpy as np

    sent = 2**31 - 1
    real = r["docids"] != sent
    if r["count"] != w["count"] or \
            not (np.isfinite(r["scores"]) == real).all() or \
            not np.isneginf(r["scores"][~real]).all():
        return False
    exp = w["ranked"]
    if fam in "MN" or (fam == "C" and p["sorted"]):
        if r["docids"][real].tolist() != [d for d, _s in exp] or \
                (r["scores"][real] != 0.0).any():
            return False
    elif fam in "SX":
        if not tie_group_match(r["docids"], r["scores"], exp, K):
            return False
    else:
        got = list(zip(r["docids"][real].tolist(),
                       r["scores"][real].tolist()))
        if len(got) != min(K, len(exp)) or \
                len({d for d, _s in got}) != len(got):
            return False
        for i, (d, sc) in enumerate(got):
            ms = w["maybe"].get(d)
            if ms is None or abs(ms - sc) > ORACLE_RTOL * abs(ms) or \
                    abs(sc - exp[i][1]) > ORACLE_RTOL * abs(exp[i][1]):
                return False
        cats = [int(cat_of[d]) for d, _s in got]
        if max((cats.count(c) for c in set(cats)), default=0) > \
                min(p["collapse_max"], 8):
            return False
    if fam != "M":
        return True
    a = w["aggs"]
    cats = np.asarray(r["aggs"][agg_at["cats"]])
    st, card = r["aggs"][agg_at["price_stats"]], r["aggs"][agg_at["sizes"]]
    n, s1, s2, mn, mx = a["price"]
    ncat = len(a["cats"])

    def close(x, y):
        return abs(float(x) - y) <= ORACLE_RTOL * abs(y)

    return bool(
        (cats[:ncat] == a["cats"]).all() and not cats[ncat:].any()
        and float(st["n"]) == n and st["min"] == np.float32(mn)
        and st["max"] == np.float32(mx) and close(st["s"], s1)
        and close(st["s2"], s2) and int(card["n"]) == a["sizes"]
        and int(card["maxn"]) == a["sizes"]
        and np.asarray(card["hll"]).tolist() == a["hll"].tolist())


class ExecuteRunner:
    """The C family as Database.search drives it: one bind and one
    SegmentSearcher.execute a query. ``run`` has BatchSearcher.run's
    shape, so the timing helpers take it."""

    def __init__(self, searcher, stats, stats_d):
        self.searcher, self.stats, self.stats_d = searcher, stats, stats_d

    def bind(self, item):
        from xapiand_tpu_torch.query.plan import bind, compile_ir
        from xapiand_tpu_torch.utils import synth_faceted as sf

        q, p = item
        seg = self.searcher.segment

        def gtf(t):
            ti = seg.get_term(t)
            return ti.length if ti else 0

        return bind(compile_ir(q, cost_fn=gtf), seg, self.searcher.scheme,
                    self.stats, global_tf=gtf, k=K,
                    sort=sf.PRICE_DESC if p["sorted"] else (),
                    collapse_slot=sf.CAT_SLOT,
                    collapse_max=p["collapse_max"])

    def run(self, items, stats=None):
        return [self.searcher.execute(self.bind(item), self.stats_d)
                for item in items]


def browse_path(dev, rec, smi, corpus, searcher) -> dict:
    """Slice 6: the single-query entry point and the dense, collapse,
    OP_MAX / OP_SYNONYM and cardinality plan shapes, over the faceted
    path's corpus and device segment."""
    import numpy as np
    import torch

    from xapiand_tpu_torch import aggregations as am
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import BatchSearcher
    from xapiand_tpu_torch.utils import synth_browse as sb
    from xapiand_tpu_torch.utils import synth_faceted as sf

    seg = corpus.seg
    qs = sb.browse_queries(BROWSE_M, BROWSE_N, BROWSE_S, BROWSE_X, BROWSE_C,
                           seed=11)
    names, specs, arrays, metas = am.compile_for_segment(sf.SCHEMA, seg,
                                                         sb.BROWSE_AGGS)
    agg_at = {n: i for i, n in enumerate(names)}
    log(f"[plan] browse: {len(qs)} queries "
        f"{ {f: sum(1 for ff, *_x in qs if ff == f) for f in 'MNSXC'} }; "
        f"aggregations {sb.BROWSE_AGGS} -> {specs}")
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    stats_d = {"N": float(stats.doc_count),
               "avg_doclen": float(stats.avg_doclen), "doclen_lower": 1.0,
               "doclen_upper": float(seg.doclen.max()),
               "total_len": float(seg.total_doclen)}
    idx = {f: [i for i, (ff, *_x) in enumerate(qs) if ff in f]
           for f in ("M", "NSX", "C")}
    bs_m = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                         sort=sf.PRICE_DESC, aggs=(specs, arrays))
    bs_r = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH)
    ex = ExecuteRunner(searcher, stats, stats_d)
    runs = [(bs_m, [qs[i][1] for i in idx["M"]]),
            (bs_r, [qs[i][1] for i in idx["NSX"]]),
            (ex, [(qs[i][1], qs[i][2]) for i in idx["C"]])]
    t0 = time.time()
    for bs, irs in runs[:2]:
        groups = bs.plan(irs, stats=stats)
        log(f"[plan] browse: launches (tree, dense, T, R (every doc for a "
            f"dense group), syn_groups, max_specs, B): " + str(
                [(c.tree, c.dense, c.T,
                  seg.num_docs + 1 if c.dense else sum(c.classes),
                  c.syn_groups, c.max_specs, int(b["offsets"].shape[0]))
                 for c, _f, b, _ch in groups]))
        if any(c.prefix or c.fullwidth for c, *_x in groups):
            raise AssertionError("a browse group in prefix or fullwidth "
                                 "mode")
    log(f"[plan] browse: plan {time.time() - t0:.1f} s")

    def run_all():
        out: list = [None] * len(qs)
        peak = {}
        for fam, (runner, items) in zip(("M", "NSX", "C"), runs):
            torch.cuda.reset_peak_memory_stats()
            for i, r in zip(idx[fam], runner.run(items, stats=stats)):
                out[i] = r
            torch.cuda.synchronize()
            peak[fam] = torch.cuda.max_memory_allocated()
        return out, peak

    # the path once with every kernel it runs held against its plain
    # version at every launch
    t0 = time.time()
    with Held(rec, "browse", BROWSE_KERNELS) as held:
        run_all()
    torch.cuda.empty_cache()
    log(f"[kernels] browse: every launch equal to its plain version, the "
        f"kernels twice bit for bit: {held.calls} launches held, each "
        f"kernel timed at its widest ({time.time() - t0:.1f} s)")
    if not all(held.calls.values()):
        raise AssertionError(f"a browse kernel was never held: {held.calls}")

    # the path, counted
    kn.reset_launches()
    results, peak = run_all()
    counts = dict(kn.launches)
    log(f"[main] browse launches {counts}; peak device memory allocated, "
        f"bytes: {peak}")
    if not all(counts[n] for n in BROWSE_KERNELS) or \
            counts["prefix_certify"] or counts["fullwidth_topk"]:
        raise AssertionError(f"browse launches wrong: {counts}")

    # parity with the float64 oracle
    t0 = time.time()
    want = sb.oracle_answers(corpus, qs, K, ORACLE_RTOL)
    bad = [qi for qi, ((fam, _q, p), r, w) in enumerate(zip(qs, results,
                                                            want))
           if not browse_match(fam, p, r, w, corpus.cat_codes, agg_at)]
    per_fam = {f: sum(1 for qi, (ff, *_x) in enumerate(qs)
                      if ff == f and qi not in bad) for f in "MNSXC"}
    cnt = sorted(w["count"] for w in want)
    log(f"[parity] browse: {len(qs) - len(bad)}/{len(qs)} queries match the "
        f"float64 oracle (M, N and the sorted half of C exact docid lists; "
        f"S, X and the relevance half of C tie groups at rtol "
        f"{ORACLE_RTOL}, C's survivors at most collapse_max a category; "
        f"counts exact, before the collapse; M's facet counts, price n, "
        f"min, max and distinct sizes exact, sums at rtol {ORACLE_RTOL}, "
        f"the 1024 registers equal to the numpy replica) per family "
        f"{per_fam}; counts min/median/max {cnt[0]}/{cnt[len(cnt) // 2]}/"
        f"{cnt[-1]} ({time.time() - t0:.1f} s)")
    if bad:
        qi = bad[0]
        r = results[qi]
        raise AssertionError(
            f"browse: {len(bad)} queries differ; first {qi} {qs[qi][0]} "
            f"{qs[qi][2]}: got count {r['count']} "
            f"{list(zip(r['docids'].tolist(), r['scores'].tolist()))} "
            f"want count {want[qi]['count']} {want[qi]['ranked'][:K]}")
    first_m = idx["M"][0]
    shaped = am.merge_and_shape(names, metas, [results[first_m]["aggs"]],
                                [{agg_at["cats"]:
                                  metas[agg_at["cats"]]["cat_names"]}])
    log(f"[parity] browse: shaped response of query {first_m} "
        f"{qs[first_m][2]}: count {results[first_m]['count']}, "
        f"aggregations {json.dumps(shaped)}")

    # the batched families, then execute's calls one by one
    n_batched = len(idx["M"]) + len(idx["NSX"])
    timed_runs(runs[:2], stats, n_batched, smi, "browse M+N+S+X")
    items = runs[2][1]
    call_ms, bind_ms = [], []
    for _ in range(3):
        for item in items:
            t0 = time.perf_counter()
            bound = ex.bind(item)
            t1 = time.perf_counter()
            searcher.execute(bound, stats_d)
            torch.cuda.synchronize()
            bind_ms.append((t1 - t0) * 1e3)
            call_ms.append((time.perf_counter() - t1) * 1e3)
    call_ms, bind_ms = sorted(call_ms), sorted(bind_ms)
    log(f"[qps] browse C: SegmentSearcher.execute ms per call over "
        f"{len(call_ms)} warm calls: median {call_ms[len(call_ms) // 2]} "
        f"min {call_ms[0]} max {call_ms[-1]}; bind ms per call median "
        f"{bind_ms[len(bind_ms) // 2]} min {bind_ms[0]} max {bind_ms[-1]}; "
        f"on {smi}")
    device_trace(runs[2:], stats, "browse C")
    return counts


SCHEME_KERNELS = ("score_slices", "prefix_certify", "dense_rows",
                  "merge_special")


def schemes_path(dev, rec, smi, rel_world, corpus, fac_searcher) -> dict:
    """Slice 7: every weight scheme (K18) through the serving paths, on the
    relevance path's corpus and the faceted path's corpus and device
    segments. -> the launch counts of its counted runs."""
    import numpy as np
    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.query.ir import Q
    from xapiand_tpu_torch.query.plan import bind, compile_ir
    from xapiand_tpu_torch.search import BatchSearcher
    from xapiand_tpu_torch.utils import synth_browse as sb
    from xapiand_tpu_torch.utils import synth_faceted as sf
    from xapiand_tpu_torch.utils import synth_schemes as ss

    seg, searcher, drawn = rel_world
    st = ss.real_stats(seg)
    uniq = seg.uniqterms
    log(f"[plan] schemes: relevance stats {st}; uniqterms min/median/max "
        f"{uniq[:-1].min()}/{float(np.median(uniq[:-1]))}/{uniq[:-1].max()}")
    counts = {n: 0 for n in kn.launches}
    nonzero: dict = {}

    def add_counts():
        for n, c in kn.launches.items():
            counts[n] += c

    # 1. relevance: 64 of bench.py's ORs a configuration
    t_rel = time.time()
    oracle_s = 0.0
    for i, config in enumerate(ss.SCHEME_CONFIGS):
        label = config[0]
        scheme = ss.make(config)
        qs = drawn[SCHEME_RELEVANCE * i:SCHEME_RELEVANCE * (i + 1)]
        irs = [Q.or_terms(q) for q in qs]
        bs = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                           prefix_cap=PREFIX_CAP, scheme=scheme)
        planned = bs.plan(irs, stats=st)
        prefix = {}
        for cfg, _fn, _b, chunk in planned:
            for qi in chunk:
                prefix[qi] = cfg.prefix
        names = ("score_slices", "prefix_certify") if any(
            c.prefix for c, *_x in planned) else ("score_slices",)
        with Held(rec, f"schemes {label}", names, exact=True) as held:
            bs.run(irs, stats=st)
        torch.cuda.synchronize()
        if not all(held.calls.values()):
            raise AssertionError(f"schemes {label}: {held.calls}")
        kn.reset_launches()
        results = bs.run(irs, stats=st)
        torch.cuda.synchronize()
        add_counts()
        if not all(kn.launches[n] for n in names):
            raise AssertionError(f"schemes {label} launches {kn.launches}")
        t0 = time.time()
        want = ss.relevance_answers(seg, qs, scheme, st, uniq)
        imp = seg.impact_arrays(scheme, st)[0] if "prefix_certify" in names \
            else None
        bad = []
        for qi, (r, w) in enumerate(zip(results, want)):
            n = None
            if imp is not None and qi not in bs.reran and any(prefix[qi]):
                n = ss.prefix_count(seg, imp, qs[qi], prefix[qi])
            err = ss.match_ranked(r["docids"], r["scores"], r["count"], w,
                                  K, n)
            if err:
                bad.append((qi, err))
        oracle_s += time.time() - t0
        nonzero[label] = sum(int((r["scores"][r["docids"] != kn.SENTINEL]
                                  != 0).sum()) for r in results)
        shapes = [(bool(c.prefix), int(g["offsets"].shape[0]))
                  for c, _f, g, _h in planned]
        log(f"[parity] schemes relevance {label}: {len(qs) - len(bad)}/"
            f"{len(qs)} match the float64 oracle (counts exact, scores "
            f"within {ss.ERR_ULPS} ulps of each posting's error scale, "
            f"ranks as tie groups at that tolerance); groups (prefix, B) "
            f"{shapes}; {len(bs.reran)} re-ran exactly; {nonzero[label]} "
            f"nonzero scores returned")
        timed_runs([(bs, irs)], st, len(irs), smi,
                   f"schemes relevance {label}", profiled=False)
        if bad:
            qi, err = bad[0]
            raise AssertionError(f"schemes relevance {label}: {len(bad)} "
                                 f"queries differ; first {qi} {qs[qi]}: "
                                 f"{err}")
    log(f"[time] schemes relevance: {time.time() - t_rel:.1f} s, oracle "
        f"{oracle_s:.1f} s")

    # 2. the catalogue: N and D (dense), S (synonym), X (OP_MAX) through
    # BatchSearcher.run and relevance C through SegmentSearcher.execute
    t_cat = time.time()
    fseg = corpus.seg
    fst = ss.real_stats(fseg)
    fuq = fseg.uniqterms
    qs = [q for q in sb.browse_queries(0, SCHEME_CATALOGUE,
                                       SCHEME_CATALOGUE, SCHEME_CATALOGUE,
                                       2 * SCHEME_CATALOGUE, seed=13)
          if not q[2].get("sorted")]
    # N's right side does not score, so its dense_rows weights are all 0;
    # D scores N's words on every doc: AND_MAYBE(match_all, OR(w, w))
    qs += [("D", Q.and_maybe(Q.match_all(),
                             Q.or_terms([f"w{i}" for i in p["w"]])), p)
           for f, _q, p in qs if f == "N"]
    batch_i = [i for i, q in enumerate(qs) if q[0] in "NDSX"]
    exec_i = [i for i, q in enumerate(qs) if q[0] == "C"]
    stats_d = ss.stats_dict(fst)
    # the configurations that scored nothing on bench.py's ORs (their
    # formulas need a term of a large collection share) run C as well
    zero = [c for c in ss.SCHEME_CONFIGS if not nonzero[c[0]] and
            c[0] != "bool"]
    log(f"[plan] schemes catalogue: {len(qs)} queries "
        f"{ {f: sum(1 for q in qs if q[0] == f) for f in 'NDSXC'} }; "
        f"schemes {[c[0] for c in ss.CATALOGUE_SCHEMES]}, and C alone "
        f"under {[c[0] for c in zero]} (no nonzero score on the relevance "
        f"ORs)")

    def gtf(t):
        ti = fseg.get_term(t)
        return ti.length if ti else 0

    for config in ss.CATALOGUE_SCHEMES + tuple(zero):
        label = config[0]
        scheme = ss.make(config)
        only_c = config not in ss.CATALOGUE_SCHEMES
        bs = BatchSearcher(fac_searcher, k=K, max_batch=MAX_BATCH,
                           scheme=scheme)
        b_irs = [] if only_c else [qs[i][1] for i in batch_i]
        bounds = [bind(compile_ir(qs[i][1], cost_fn=gtf), fseg, scheme, fst,
                       global_tf=gtf, k=K, collapse_slot=sf.CAT_SLOT,
                       collapse_max=qs[i][2]["collapse_max"])
                  for i in exec_i]

        def run():
            out = bs.run(b_irs, stats=fst) if b_irs else []
            return out + [fac_searcher.execute(b, stats_d, scheme=scheme)
                          for b in bounds]

        names = ("score_slices",) if only_c else \
            ("score_slices", "dense_rows", "merge_special")
        t0 = time.time()
        with Held(rec, f"schemes catalogue {label}", names,
                  exact=True) as held:
            run()
        torch.cuda.synchronize()
        t1 = time.time()
        if not all(held.calls.values()) or \
                not (only_c or held.nonzero["dense_rows"]):
            raise AssertionError(f"schemes catalogue {label}: {held.calls}"
                                 f" held, nonzero floats {held.nonzero}")
        kn.reset_launches()
        results = run()
        torch.cuda.synchronize()
        add_counts()
        if not all(kn.launches[n] for n in names):
            raise AssertionError(f"schemes catalogue {label} launches "
                                 f"{kn.launches}")
        t2 = time.time()
        idx = exec_i if only_c else batch_i + exec_i
        want = ss.catalogue_answers(corpus, [qs[i] for i in idx], scheme,
                                    fst, fuq)
        bad = []
        for i, r, w in zip(idx, results, want):
            fam, _q, p = qs[i]
            if fam == "N":
                real = r["docids"] != kn.SENTINEL
                err = None if (r["count"] == w["count"] and
                               r["docids"][real].tolist() ==
                               w["docids"][:K].tolist() and
                               not r["scores"][real].any()) else "N differs"
            elif fam == "D":
                err = ss.match_docid_order(r["docids"], r["scores"],
                                           r["count"], w, K)
            elif fam == "C":
                err = ss.match_collapsed(
                    r["docids"], r["scores"], int(r["count"]), w,
                    corpus.cat_codes, min(p["collapse_max"], 8), K)
            else:
                err = ss.match_ranked(r["docids"], r["scores"], r["count"],
                                      w, K)
            if err:
                bad.append((i, err))
        nz = sum(int((r["scores"][r["docids"] != kn.SENTINEL] != 0).sum())
                 for r in results)
        nonzero[label] = nonzero.get(label, 0) + nz
        log(f"[parity] schemes catalogue {label}: {len(idx) - len(bad)}/"
            f"{len(idx)} match the float64 oracle (N and D the first docids"
            f" ascending, D's scores within tolerance, S and X tie groups, C "
            f"at most collapse_max a category; counts exact); {held.calls} "
            f"launches held, nonzero floats out {held.nonzero}; {nz} nonzero "
            f"scores returned; held "
            f"run {t1 - t0:.1f} s, counted run {t2 - t1:.1f} s, oracle "
            f"{time.time() - t2:.1f} s")
        if bad:
            i, err = bad[0]
            raise AssertionError(f"schemes catalogue {label}: {len(bad)} "
                                 f"differ; first {i} {qs[i][0]} {qs[i][2]}: "
                                 f"{err}")
    log(f"[time] schemes catalogue: {time.time() - t_cat:.1f} s")
    empty = [lb for lb, n in nonzero.items() if not n and lb != "bool"]
    if empty or nonzero["bool"]:
        raise AssertionError(f"schemes with no nonzero score: {empty}; "
                             f"bool {nonzero['bool']}")
    log(f"[main] schemes launches {counts}; nonzero scores by scheme "
        f"{nonzero}")
    if not all(counts[n] for n in SCHEME_KERNELS):
        raise AssertionError(f"a schemes kernel never launched: {counts}")
    return counts


def relevance_path(dev, rec, smi) -> tuple:
    """Slice 1: BM25 top-10 over three-term ORs, bench.py's corpus. ->
    (launch counts, (the segment, its SegmentSearcher, the drawn queries):
    the schemes path runs over them)."""
    import numpy as np
    import torch

    import bench
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.query.ir import Q
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils import synth_schemes as ss
    from xapiand_tpu_torch.utils.synth import (build_synthetic_segment,
                                               sample_queries)

    # corpus and plan: bench.py:125-157; the schemes path's queries
    # continue bench.py's draw (the first N_QUERIES are bench.py's)
    t0 = time.time()
    seg = build_synthetic_segment(N_DOCS, VOCAB, seed=7)
    drawn = sample_queries(seg, max(N_QUERIES, SCHEME_RELEVANCE *
                                    len(ss.SCHEME_CONFIGS)), TERMS, seed=11)
    drawn = [sorted(q, key=lambda t: -seg.terms[t].length) for q in drawn]
    queries = drawn[:N_QUERIES]
    irs = [Q.or_terms(q) for q in queries]
    # the statistics the other schemes read, as a deployment has them (BM25
    # reads none of them): each doc's distinct terms, each term's summed wdf
    seg.uniqterms = ss.uniqterms(seg)
    ss.real_collfreq(seg)
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
    uncert = bs.reran
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
    del bs, planned
    return counts, (seg, searcher, drawn)


def faceted_path(dev, rec, smi) -> tuple:
    """Slices 2 and 3: config 3 in full - the predicate path with its
    aggregations, through the fullwidth path. -> (launch counts, the
    corpus, its SegmentSearcher: the browse path runs over both)."""
    import numpy as np
    import torch

    from xapiand_tpu_torch import aggregations as am
    from xapiand_tpu_torch.models.segment import device_segment_from_numpy
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import aggs as ag
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils import synth_faceted as sf
    from xapiand_tpu_torch.utils import synth_schemes as ss

    os.environ["XT_FULLWIDTH"] = "1"
    t0 = time.time()
    corpus = sf.build_faceted_corpus(FACETED_DOCS, seed=7)
    seg = corpus.seg
    # each doc's distinct terms, for the schemes path (BM25 reads none)
    seg.uniqterms = ss.uniqterms(seg)
    log(f"[corpus] faceted: {FACETED_DOCS} docs, fingerprint "
        f"{sf.fingerprint(corpus)}, {time.time() - t0:.1f} s")
    qs = sf.faceted_queries(FACETED_PER_FAMILY, seed=11)
    names, specs, arrays, metas = am.compile_for_segment(sf.SCHEMA, seg,
                                                         sf.CFG3_AGGS)
    log(f"[plan] faceted aggregations {sf.CFG3_AGGS} -> {specs}")
    t0 = time.time()
    searcher = SegmentSearcher(seg, device=dev)
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    stats_d = {"N": float(stats.doc_count),
               "avg_doclen": float(stats.avg_doclen)}

    def searchers():
        """(BatchSearcher, query indices, IRs): A+B by price desc, C+D by
        relevance, config 3's aggregations in every query."""
        out = []
        for sort, fam_names in ((sf.PRICE_DESC, "AB"), (None, "CD")):
            bs = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                               prefix_cap=PREFIX_CAP, sort=sort,
                               aggs=(specs, arrays))
            idx = [i for i, (f, _q, _p) in enumerate(qs) if f in fam_names]
            out.append((bs, idx, [qs[i][1] for i in idx]))
        return out

    def launches(groups):
        return str([(c.tree, list(c.classes), c.compact_cap, c.n_filters,
                     c.fullwidth, int(b["offsets"].shape[0]))
                    for c, _f, b, _ch in groups])

    fams = searchers()
    groups_all = [g for bs, _idx, irs in fams
                  for g in bs.plan(irs, stats=stats)]
    torch.cuda.synchronize()
    log(f"[plan] faceted: upload + plan {time.time() - t0:.1f} s; launches "
        f"(tree, classes, compact_cap, n_filters, fullwidth, B): "
        f"{launches(groups_all)}")
    if any(c.prefix for c, *_ in groups_all):
        raise AssertionError("a faceted launch group is in prefix mode")
    if not any(c.fullwidth and c.sort for c, *_ in groups_all) or \
            not any(c.fullwidth and not c.sort for c, *_ in groups_all):
        raise AssertionError("no sorted or no relevance fullwidth group")
    # the same traffic on the compaction path, the exact re-run's: A packs
    # its eligible rows to the cap for its sort and its aggregations
    with fullwidth("0"):
        fams0 = searchers()
        groups0 = [g for bs, _idx, irs in fams0
                   for g in bs.plan(irs, stats=stats)]
    log(f"[plan] faceted XT_FULLWIDTH=0: launches {launches(groups0)}")
    if any(c.fullwidth for c, *_ in groups0) or not any(
            not c.n_filters and 0 < c.compact_cap < sum(c.classes)
            for c, *_ in groups0):
        raise AssertionError("XT_FULLWIDTH=0: no unfiltered group compacts")

    # kernels vs plain versions, one launch per distinct group shape; every
    # K17a kind on the corpus columns at A's widest group
    col, tg, tab = sf.sort_test_inputs(seg.num_docs, MAX_BATCH)
    sort_inputs = (device_segment_from_numpy(col, dev),
                   torch.from_numpy(tg).to(dev),
                   torch.from_numpy(tab).to(dev))
    P, S, C = sf.PRICE_SLOT, sf.SIZE_SLOT, sf.CAT_SLOT
    subs = (("count", -1), ("avg", P), ("max", S))
    all_aggs = ((("count",),) + tuple((m, P) for m in
                                     sorted(ag.METRIC_KINDS))
                + (("stats", S), ("terms", C, 64, ()),
                   ("terms", C, 64, subs), ("missing", S, subs),
                   ("missing", 99, subs)))

    def shape_key(cfg, batch):
        return (cfg.tree, cfg.classes, cfg.compact_cap, cfg.fullwidth,
                int(batch["offsets"].shape[0]))

    widest = max(((sum(c.classes), shape_key(c, b))
                  for c, _f, b, _ch in groups_all
                  if c.fullwidth and c.sort))[1]
    seen: set = set()

    def compare_groups(groups, what):
        for cfg, _fn, batch, _chunk in groups:
            key = shape_key(cfg, batch)
            if key not in seen:
                seen.add(key)
                compare_faceted(searcher, cfg, batch, stats_d, rec,
                                f"{what} {key}", sort_inputs,
                                all_aggs if key == widest else None)

    compare_groups(groups_all, "faceted")
    compare_groups(groups0, "faceted XT_FULLWIDTH=0")

    def run_all(families):
        out: list = [None] * len(qs)
        for bs, idx, irs in families:
            for i, r in zip(idx, bs.run(irs, stats=stats)):
                out[i] = r
        torch.cuda.synchronize()
        return out

    # the path, counted
    kn.reset_launches()
    results = run_all(fams)
    counts = dict(kn.launches)
    log(f"[main] faceted launches {counts}")
    if not all(counts[n] for n in FACETED_KERNELS) or \
            counts["prefix_certify"]:
        raise AssertionError(f"faceted launches wrong: {counts}")
    bs_ab, idx_ab, _irs = fams[0]
    uncert = [idx_ab[qi] for qi in bs_ab.reran]
    n_fw = len({qi for c, _f, _b, chunk in groups_all
                if c.fullwidth and c.sort for qi in chunk})
    log(f"[main] faceted fullwidth sorted: {len(uncert)}/{n_fw} queries "
        f"uncertified -> exact re-run (XT_FULLWIDTH=0 path)")
    if uncert:
        with fullwidth("0"):
            rerun = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                                  prefix_cap=PREFIX_CAP, sort=sf.PRICE_DESC,
                                  aggs=(specs, arrays)).plan(
                [qs[qi][1] for qi in uncert], stats=stats)
        compare_groups(rerun, "exact re-run")

    # parity with the float64 oracle, aggregations included, on both paths
    t0 = time.time()
    want = sf.oracle_answers(corpus, qs, K, ORACLE_RTOL)
    log(f"[parity] faceted oracle {time.time() - t0:.1f} s")
    ncat = len(corpus.cat_names)

    def close(x, y):
        return abs(float(x) - y) <= ORACLE_RTOL * abs(y)

    def parity(results, tag):
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
            cats, st = np.asarray(r["aggs"][0]), r["aggs"][1]
            n, s1, s2, mn, mx = w["aggs"]["price"]
            ok = ok and (cats[:ncat] == w["aggs"]["cats"]).all() and \
                not cats[ncat:].any() and float(st["n"]) == n and \
                st["min"] == np.float32(mn) and st["max"] == np.float32(mx) \
                and close(st["s"], s1) and close(st["s2"], s2)
            if not ok:
                bad.append(qi)
        per_fam = {f: sum(1 for qi, (ff, *_x) in enumerate(qs)
                          if ff == f and qi not in bad) for f in "ABCD"}
        log(f"[parity] {tag}: {len(qs) - len(bad)}/{len(qs)} queries match "
            f"the float64 oracle (A, B exact docid lists; C, D tie groups at "
            f"rtol {ORACLE_RTOL}; counts exact; facet counts exact; price "
            f"n, min, max exact, sums at rtol {ORACLE_RTOL}) per family "
            f"{per_fam}; counts min/median/max "
            f"{min(w['count'] for w in want)}/"
            f"{sorted(w['count'] for w in want)[len(want) // 2]}/"
            f"{max(w['count'] for w in want)}")
        if bad:
            qi = bad[0]
            r = results[qi]
            raise AssertionError(
                f"{tag}: {len(bad)} queries differ; first {qi} {qs[qi][0]} "
                f"{qs[qi][2]}: got count {r['count']} "
                f"{list(zip(r['docids'].tolist(), r['scores'].tolist()))} "
                f"aggs {r['aggs']} want count {want[qi]['count']} "
                f"{want[qi]['ranked'][:K]} aggs {want[qi]['aggs']}")

    parity(results, "faceted")
    with fullwidth("0"):
        parity(run_all(fams0), "faceted XT_FULLWIDTH=0")
    first_a = next(qi for qi, (f, *_x) in enumerate(qs) if f == "A")
    shaped = am.merge_and_shape(names, metas, [results[first_a]["aggs"]],
                                [{0: metas[0]["cat_names"]}])
    log(f"[parity] faceted: shaped response of query {first_a} "
        f"{qs[first_a][2]}: count {results[first_a]['count']}, "
        f"aggregations {json.dumps(shaped)}")

    # does K9 pay on this card? the same traffic with the fullwidth path
    # on and off, in the order on, off, off, on (not a gate)
    runs = {"1": [(bs, irs) for bs, _i, irs in fams],
            "0": [(bs, irs) for bs, _i, irs in fams0]}
    qps = []
    for i, flag in enumerate("1001"):
        with fullwidth(flag):
            qps.append(timed_runs(
                runs[flag], stats, len(qs), smi,
                "faceted" + ("" if flag == "1" else " XT_FULLWIDTH=0")
                + ("" if i < 2 else " (second pair)"), profiled=i < 2))
    log(f"[qps] faceted fullwidth on / off, median QPS: first pair (on "
        f"first) {qps[0]} / {qps[1]}, second pair (off first) {qps[3]} / "
        f"{qps[2]}")
    return counts, corpus, searcher


def work_phrase(ids, widths, batch, orbits, first, seg, cfg, ncand):
    """phrase_leaves: per (query, leaf) the walked term block's docids up
    to the last candidate kept (the walk stops at cand_cap), per kept
    candidate its first flag and, per phrase term, posoff / poslen and
    its positions; the verdict words written. Operations: a binary search
    per walked row and other phrase term, and per kept candidate one per
    position of t0 and other term. The candidates are the plain version's
    (ops/phrase.py phrase_candidates)."""
    import torch

    from xapiand_tpu_torch.ops import phrase as ph
    from xapiand_tpu_torch.ops.kernels import row_offsets

    B, R = ids.shape
    lens = batch["lens"]
    ro = row_offsets(widths)
    nbytes = 4 * B * R + 4 * B * len(cfg.phrases)
    ops = 0
    for p, (tidx, gidx, _win, _ex) in enumerate(cfg.phrases):
        cand_d, _src, valid, per_term = ph.phrase_candidates(
            ids, widths, batch["offsets"], orbits, first, seg["post_posoff"],
            seg["post_poslen"], tidx, gidx, cfg.cand_cap, cfg.pmax)
        rows = torch.minimum(lens[:, list(tidx)], torch.tensor(
            [widths[t] for t in tidx], device=ids.device))
        nw, tw = rows.min(1)
        walked = nw.clone()
        full = ncand[:, p] >= cfg.cand_cap
        if bool(full.any()):
            C = cand_d.shape[1]
            for b in torch.nonzero(full).flatten().tolist():
                t = tidx[int(tw[b])]
                blk = ids[b, ro[t]:ro[t + 1]]
                walked[b] = int(torch.searchsorted(
                    blk, cand_d[b, C - 1:C])) + 1
        n_walk = int(walked.sum())
        n_cand = n_true(valid)
        n_pos = sum(int(torch.where(f, pl, 0).sum()) for f, _po, pl in
                    per_term)
        nbytes += 4 * n_walk + n_cand + 8 * n_cand * len(tidx) + 4 * n_pos
        ops += n_walk * sum(log2c(widths[t]) for t in tidx[1:]) + \
            n_pos * log2c(cfg.pmax)
    return nbytes, ops


def compare_positional(searcher, cfg, batch, stats_d, rec, shape_name):
    """Each positional-path kernel against its plain version on one launch
    group's real inputs, in execute_batch's order: score_slices,
    merge_docs, and for a phrase plan phrase_leaves (twice, bit for bit)
    and filter_leaves over its verdict words, then topk_rows; for a phrase
    plan also the torch.searchsorted time of the K15 lookups (each
    candidate's docid in each phrase term's block). -> ms of those
    lookups (0.0 without phrases)."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.ops import phrase as ph
    from xapiand_tpu_torch.ops.kernels import row_offsets

    seg, _params, _post, _args, widths, ids, w, _tail = slices(
        searcher, cfg, batch, stats_d, rec)
    B, R = ids.shape
    bits = batch["group_bits"]
    deleted = seg["deleted"] if cfg.has_deletes else None
    prog = kn.tree_program(cfg.tree)
    mprog = None if cfg.phrases else prog
    margs = (ids, w, widths, bits, deleted, mprog, bool(cfg.phrases))
    got, want = kn.merge_docs(*margs), kn._merge_docs_plain(*margs)
    err = check_close("merge_docs sums", got[0], want[0])
    for nm, a, b in zip(("mask", "count", "orbits"), got[1:], want[1:]):
        check_equal(f"merge_docs {nm}", a, b)
    rec.note("merge_docs", err, cuda_ms(lambda: kn.merge_docs(*margs)),
             cuda_ms(lambda: kn._merge_docs_plain(*margs)),
             work_merge_docs(ids, widths, deleted, got[3]))
    sums, mask, _count, orbits = got
    lookup_ms = 0.0
    if cfg.phrases:
        pargs = (ids, widths, batch["offsets"], batch["lens"], orbits, mask,
                 seg["post_posoff"], seg["post_poslen"], seg["positions"],
                 cfg.phrases, cfg.cand_cap, cfg.pmax)
        phb, ncand = twice("phrase_leaves",
                           lambda: ph.phrase_leaves(*pargs))
        pphb, pncand = ph._phrase_leaves_plain(*pargs)
        check_equal("phrase_leaves verdicts", phb, pphb)
        check_equal("phrase_leaves candidates", ncand, pncand)
        rec.note("phrase_leaves", 0.0,
                 cuda_ms(lambda: ph.phrase_leaves(*pargs)),
                 cuda_ms(lambda: ph._phrase_leaves_plain(*pargs), reps=3),
                 work_phrase(ids, widths, batch, orbits, mask, seg, cfg,
                             ncand))
        # the library yardstick of the K15 lookups: torch.searchsorted of
        # the candidates in each phrase term's block
        ro = row_offsets(widths)
        look = []
        for tidx, gidx, _w, _e in cfg.phrases:
            cand_d = ph.phrase_candidates(
                ids, widths, batch["offsets"], orbits, mask,
                seg["post_posoff"], seg["post_poslen"], tidx, gidx,
                cfg.cand_cap, cfg.pmax)[0]
            look += [(ids[:, ro[t]:ro[t + 1]].contiguous(), cand_d)
                     for t in tidx]
        lookup_ms = cuda_ms(lambda: [torch.searchsorted(a, x)
                                     for a, x in look])
        fargs = (seg["values"], (), (), ids.new_empty((B, 0, 4)), ids, mask,
                 orbits, prog, phb)
        got, want = kn.filter_leaves(*fargs), \
            kn._filter_leaves_plain([], (), *fargs[3:])
        check_equal("filter_leaves eligible", got[0], want[0])
        check_equal("filter_leaves count", got[1], want[1])
        rec.note("filter_leaves", 0.0,
                 cuda_ms(lambda: kn.filter_leaves(*fargs)),
                 cuda_ms(lambda: kn._filter_leaves_plain([], (),
                                                         *fargs[3:])),
                 work_filter(ids, mask, 0, phb))
        mask = got[0]
    targs = (sums, ids, mask, cfg.k)
    got, want = kn.topk_rows(*targs), kn._topk_rows_plain(*targs)
    check_equal("topk_rows docids", got[0], want[0])
    check_equal("topk_rows scores", got[1], want[1])
    rec.note("topk_rows", 0.0, cuda_ms(lambda: kn.topk_rows(*targs)),
             cuda_ms(lambda: kn._topk_rows_plain(*targs)),
             work_rows(R, B, 9, 8 * cfg.k),
             topk_library_ms(sums, mask, cfg.k))
    torch.cuda.synchronize()
    rec.flush(f"{shape_name} B={B} R={R}" + (
        f" cand_cap={cfg.cand_cap} pmax={cfg.pmax} K15 lookups "
        f"torch.searchsorted {round(lookup_ms, 4)} ms" if cfg.phrases
        else ""))
    return lookup_ms


def positional_path(dev, rec, smi) -> dict:
    """Slice 4: config 2, phrase + boolean search over 100k positional
    docs."""
    import numpy as np
    import torch

    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils import synth_positional as sp

    t0 = time.time()
    corpus = sp.build_corpus2(POSITIONAL_DOCS, seed=7)
    seg = corpus.seg
    qs = sp.queries2(corpus, n_each=POSITIONAL_EACH,
                     n_three=POSITIONAL_THREE, seed=11)
    irs = [q for _f, q, _w in qs]
    log(f"[corpus] positional: {POSITIONAL_DOCS} docs, fingerprint "
        f"{sp.fingerprint(corpus)}, {len(qs)} queries, "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    searcher = SegmentSearcher(seg, device=dev)
    bs = BatchSearcher(searcher, k=K)
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    stats_d = {"N": float(stats.doc_count),
               "avg_doclen": float(stats.avg_doclen)}
    planned = bs.plan(irs, stats=stats)
    torch.cuda.synchronize()
    log(f"[plan] positional: upload + plan {time.time() - t0:.1f} s; "
        f"launches (tree, classes, cand_cap, pmax, B): " + str(
            [(c.tree, list(c.classes), c.cand_cap, c.pmax,
              int(b["offsets"].shape[0])) for c, _f, b, _ch in planned]))
    if any(c.prefix for c, *_ in planned):
        raise AssertionError("a positional group in prefix mode")
    caps, pmaxes = [0] * len(qs), [0] * len(qs)
    for cfg, _fn, _batch, chunk in planned:
        for qi in chunk:
            caps[qi], pmaxes[qi] = cfg.cand_cap, cfg.pmax

    # every phrase launch group, and each other group shape once
    seen: set = set()
    lookup_ms = 0.0
    for cfg, _fn, batch, _chunk in planned:
        key = (cfg.tree, cfg.classes, int(batch["offsets"].shape[0]))
        if cfg.phrases or key not in seen:
            seen.add(key)
            lookup_ms += compare_positional(searcher, cfg, batch, stats_d,
                                            rec, f"positional {key}")
    log(f"[kernels] positional K15 lookups over every phrase group: "
        f"torch.searchsorted {lookup_ms} ms, phrase_leaves "
        f"{rec.rec['phrase_leaves']['ms']} ms (the whole phrase step)")

    # the path, counted
    kn.reset_launches()
    results = bs.run(irs, stats=stats)
    torch.cuda.synchronize()
    counts = dict(kn.launches)
    log(f"[main] positional launches {counts}")
    if not all(counts[n] for n in POSITIONAL_KERNELS) or \
            counts["prefix_certify"] or counts["compact_rows"]:
        raise AssertionError(f"positional launches wrong: {counts}")

    # parity with the float64 oracle, and the phrase hits in the text
    t0 = time.time()
    want = sp.oracle_answers(corpus, qs, caps, pmaxes, K, ORACLE_RTOL)
    bad, capped = [], 0
    for qi, ((fam, _q, ws), r, w) in enumerate(zip(qs, results, want)):
        fin = np.isfinite(r["scores"])
        ok = r["count"] == w["count"] and \
            (r["docids"][~fin] == kn.SENTINEL).all() and \
            tie_group_match(r["docids"], r["scores"], w["ranked"], K)
        for d in r["docids"][fin].tolist() if fam != "B" else ():
            toks = [sp.word(t) for t in corpus.tokens[d]]
            if fam == "N":
                pa = [i for i, t in enumerate(toks) if t == ws[0]]
                pb = [i for i, t in enumerate(toks) if t == ws[1]]
                ok = ok and any(abs(a - b) < sp.NEAR_WINDOW
                                for a in pa for b in pb)
            else:
                n = len(ws)
                ok = ok and any(tuple(toks[j:j + n]) == ws
                                for j in range(len(toks) - n + 1))
        if fam != "B":
            m = np.ones(seg.num_docs, bool)
            for t in ws:
                ti = seg.terms[t]
                hit = np.zeros(seg.num_docs, bool)
                hit[seg.post_docids[ti.offset:ti.offset + ti.length]] = True
                m &= hit
            capped += int(m.sum() > caps[qi])
        if not ok:
            bad.append(qi)
    per_fam = {f: sum(1 for qi, (ff, *_x) in enumerate(qs)
                      if ff == f and qi not in bad)
               for f in ("P2", "B", "P3", "N")}
    log(f"[parity] positional: {len(qs) - len(bad)}/{len(qs)} queries "
        f"match the float64 oracle (counts exact, tie groups at rtol "
        f"{ORACLE_RTOL}, cand_cap and pmax of each launch group; phrase "
        f"and NEAR hits found in the text) per family {per_fam}; "
        f"{capped} phrase/NEAR queries with more candidates than their "
        f"cand_cap; counts min/median/max {min(w['count'] for w in want)}/"
        f"{sorted(w['count'] for w in want)[len(want) // 2]}/"
        f"{max(w['count'] for w in want)} ({time.time() - t0:.1f} s)")
    if bad:
        qi = bad[0]
        r = results[qi]
        raise AssertionError(
            f"positional: {len(bad)} queries differ; first {qi} {qs[qi][0]} "
            f"{qs[qi][2]}: got count {r['count']} "
            f"{list(zip(r['docids'].tolist(), r['scores'].tolist()))} want "
            f"count {want[qi]['count']} {want[qi]['ranked'][:K]}")
    if not capped:
        raise AssertionError("no phrase query hit its cand_cap")
    timed_runs([(bs, irs)], stats, len(qs), smi, "positional")
    return counts


def work_geo(ids, base, cols, specs, queries):
    """geo_leaves: docids (and base) read and the verdict words written per
    row; per live row and leaf its span (doc_off, doc_len) and its first
    min(doc_len, RMAX) ranges, 8 bytes each; each query's cover once per
    leaf. Operations: two binary searches over the cover per range."""
    import torch

    B, C = ids.shape
    live = base if base is not None else ids != 2**31 - 1
    nbytes = 8 * B * C + (B * C if base is not None else 0)
    ops = 0
    for col, (_slot, QR, RMAX), _q in zip(cols, specs, queries):
        d = ids[live].clamp(max=col["doc_off"].shape[0] - 1).long()
        nr = int(torch.clamp(col["doc_len"][d], max=RMAX).sum())
        # the column is read once at most, whatever the queries share
        nbytes += 8 * min(int(d.numel()), col["doc_off"].shape[0]) + \
            8 * min(nr, col["flat_start"].shape[0]) + 8 * B * QR
        ops += 2 * nr * log2c(QR)
    return nbytes, ops


def searchsorted_ms(cols, specs, queries, ids):
    """The library yardstick of K15 inside K16: torch.searchsorted of the
    same two counts over every row's first RMAX ranges (#qs <= re, #qe <
    rs), the ranges gathered beforehand."""
    import torch

    B = ids.shape[0]
    ins = []
    for col, (_slot, _QR, RMAX), q in zip(cols, specs, queries):
        d = ids.clamp(max=col["doc_off"].shape[0] - 1).long()
        j = torch.arange(RMAX, device=ids.device)
        ridx = (col["doc_off"][d].long()[..., None] + j).clamp(
            max=col["flat_start"].shape[0] - 1)
        ins.append((q[..., 0].contiguous(), q[..., 1].contiguous(),
                    col["flat_start"][ridx].reshape(B, -1),
                    col["flat_end"][ridx].reshape(B, -1)))
    return cuda_ms(lambda: [(torch.searchsorted(qs, re, right=True),
                             torch.searchsorted(qe, rs))
                            for qs, qe, rs, re in ins], reps=5)


def compare_geo(searcher, cfg, batch, stats_d, rec, shape_name, full):
    """geo_leaves against its plain version on one launch group's real
    rows (execute_batch's: score_slices, merge_docs and, with a cap below
    the row width, the upper-tree compaction), twice bit for bit. With
    full, also every other kernel of the group against its plain version
    in execute_batch's order (filter_leaves over the geo verdicts, then
    sort_topk on the docid key) with the times of both, geo_leaves' bound
    and the torch.searchsorted time of its two counts. -> the group's
    precompaction cap (0: none)."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.ops.executor import upper_tree

    if full:
        seg, _pr, _post, _args, widths, ids, w, _tail = slices(
            searcher, cfg, batch, stats_d, rec)
    else:
        from xapiand_tpu_torch.models.weights import CollectionStats

        seg = searcher.device_segment.arrays_pytree()
        widths = cfg.term_classes()
        ids, w, _tail = kn.score_slices(
            (seg["post_docids"], seg["post_wdf"], seg["post_doclen"]), None,
            batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, (0,) * cfg.T,
            searcher.scheme.kernel_spec(CollectionStats(
                doc_count=stats_d["N"], avg_doclen=stats_d["avg_doclen"])))
    B, R = ids.shape
    deleted = seg["deleted"] if cfg.has_deletes else None
    cap = cfg.compact_cap if 0 < cfg.compact_cap < R else 0
    prog = kn.tree_program(cfg.tree)
    mprog = kn.tree_program(upper_tree(cfg.tree)) if cap else None
    margs = (ids, w, widths, batch["group_bits"], deleted, mprog, True)
    got = kn.merge_docs(*margs)
    if full:
        want = kn._merge_docs_plain(*margs)
        err = check_close("merge_docs sums", got[0], want[0])
        for nm, a, b in zip(("mask", "count", "orbits"), got[1:], want[1:]):
            check_equal(f"merge_docs {nm}", a, b)
        rec.note("merge_docs", err, cuda_ms(lambda: kn.merge_docs(*margs)),
                 cuda_ms(lambda: kn._merge_docs_plain(*margs)),
                 work_merge_docs(ids, widths, deleted, got[3]))
    sums, mask, _count, orbits = got
    if cap:
        cargs = (mask, ids, sums, orbits, cap)
        got = kn.compact_rows(*cargs)
        if int(got[3].max()) > cap:
            raise AssertionError(f"compact_rows: {int(got[3].max())} rows "
                                 f"exceed the cap {cap}")
        if full:
            want = kn._compact_rows_plain(*cargs)
            for nm, a, b in zip(("docids", "sums", "orbits", "n"), got,
                                want):
                check_equal(f"compact_rows {nm}", a, b)
            rec.note("compact_rows", 0.0, cuda_ms(lambda: kn.compact_rows(
                *cargs)), cuda_ms(lambda: kn._compact_rows_plain(*cargs)),
                work_selected(B, R, 1, int(got[3].clamp(max=cap).sum()), 12,
                              B * cap * 12 + 4 * B))
        ids, sums, orbits, _n = got
        mask = None
    cols = [seg["geo"][s] for s, _qr, _rm in cfg.geo_specs]
    gargs = (cols, cfg.geo_specs, batch["geo_queries"], ids, mask)
    geobits = twice("geo_leaves", lambda: kn.geo_leaves(*gargs))
    check_equal("geo_leaves verdicts", geobits, kn._geo_leaves_plain(*gargs))
    if not full:
        return cap
    rec.note("geo_leaves", 0.0, cuda_ms(lambda: kn.geo_leaves(*gargs)),
             cuda_ms(lambda: kn._geo_leaves_plain(*gargs), reps=3),
             work_geo(ids, mask, *gargs[:3]),
             searchsorted_ms(*gargs[:4]))
    values = seg["values"]
    fparams = batch["fparams"] if cfg.n_filters else \
        ids.new_empty((B, 0, 4))
    fargs = (values, cfg.filter_slots, cfg.filter_vmax, fparams, ids, mask,
             orbits, prog, None, geobits)
    pargs = ([values.get(sl) for sl in cfg.filter_slots],
             tuple(cfg.filter_vmax)) + fargs[3:]
    got, want = kn.filter_leaves(*fargs), kn._filter_leaves_plain(*pargs)
    check_equal("filter_leaves eligible", got[0], want[0])
    check_equal("filter_leaves count", got[1], want[1])
    F = cfg.n_filters
    nbytes, ops = work_filter(ids, mask, F, None, n_rows(values))
    rec.note("filter_leaves", 0.0, cuda_ms(lambda: kn.filter_leaves(*fargs)),
             cuda_ms(lambda: kn._filter_leaves_plain(*pargs)),
             (nbytes + 4 * ids.numel(), ops))
    elig = got[0]
    spec = (("docid", None, False),)
    sargs = (spec, ids, sums, elig, cfg.k, values)
    pargs = (spec, [None], ids, sums, elig, cfg.k, None, {})
    got, want = kn.sort_topk(*sargs), kn._sort_topk_plain(*pargs)
    check_equal("sort_topk docids", got[0], want[0])
    check_equal("sort_topk scores", got[1], want[1])
    rec.note("sort_topk", 0.0, cuda_ms(lambda: kn.sort_topk(*sargs)),
             cuda_ms(lambda: kn._sort_topk_plain(*pargs)),
             work_sort(spec, elig, cfg.k, n_rows(values)))
    torch.cuda.synchronize()
    rec.flush(f"{shape_name} B={B} R={R} cap={cap} geo_specs "
              f"{cfg.geo_specs}")
    return cap


def geo_path(dev, rec, smi) -> dict:
    """Slice 5: config 4, circle AND datetime window over 1M geotagged
    docs."""
    import numpy as np
    import torch

    from xapiand_tpu_torch import native
    from xapiand_tpu_torch.models.weights import CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils import synth_geo as sg

    if native.lib is None:
        raise AssertionError(f"the native library did not load: "
                             f"{native.build_info}")
    log(f"[build] native library {native.build_info}")
    corpus = sg.build_corpus4(GEO_DOCS, seed=7)
    seg = corpus.seg
    t0 = time.time()
    qs = sg.queries4(GEO_P, GEO_T)
    irs = [q for _f, q, _p in qs]
    log(f"[corpus] geo: {GEO_DOCS} docs in {corpus.build_s:.1f} s, "
        f"fingerprint {sg.fingerprint(corpus)}; {len(qs)} queries (P "
        f"{GEO_P}, T {GEO_T}) in {time.time() - t0:.1f} s")
    t0 = time.time()
    searcher = SegmentSearcher(seg, device=dev)
    bs = BatchSearcher(searcher, k=K)
    stats = CollectionStats(doc_count=seg.doc_count,
                            avg_doclen=seg.avg_doclen, doclen_lower=1.0)
    stats_d = {"N": float(stats.doc_count),
               "avg_doclen": float(stats.avg_doclen)}
    planned = bs.plan(irs, stats=stats)
    torch.cuda.synchronize()
    fam_of = [f for f, _q, _p in qs]
    log(f"[plan] geo: upload + plan {time.time() - t0:.1f} s; "
        f"{len(planned)} launches (tree, T, R, geo_specs (slot, QR, RMAX), "
        f"compact_cap, B, families): " + str(
            [(c.tree, c.T, sum(c.classes), c.geo_specs, c.compact_cap,
              int(b["offsets"].shape[0]),
              "".join(sorted({fam_of[qi] for qi in ch})))
             for c, _f, b, ch in planned]))
    if any(c.prefix or not c.unweighted for c, *_x in planned):
        raise AssertionError("a geo group in prefix mode or weighted")
    rmax = {c.geo_specs[0][2] for c, *_x in planned}
    if len(rmax) != 1:
        raise AssertionError(f"geo groups with several RMAX {rmax}")
    rmax = rmax.pop()

    # geo_leaves at every launch group; every kernel at each group shape
    seen: set = set()
    caps = []
    t0 = time.time()
    for cfg, _fn, batch, _chunk in planned:
        key = (cfg.tree, cfg.classes, cfg.geo_specs, cfg.compact_cap,
               int(batch["offsets"].shape[0]))
        caps.append(compare_geo(searcher, cfg, batch, stats_d, rec,
                                f"geo {key[0]} R={sum(key[1])}",
                                key not in seen))
        seen.add(key)
    torch.cuda.synchronize()
    log(f"[kernels] geo: geo_leaves equal to its plain version at all "
        f"{len(planned)} launch groups, twice bit for bit ({len(seen)} "
        f"group shapes compared in full; {time.time() - t0:.1f} s); "
        f"precompaction caps {sorted(set(caps))}, "
        f"{sum(1 for c in caps if c)} groups precompacted")

    # the path, counted
    kn.reset_launches()
    results = bs.run(irs, stats=stats)
    torch.cuda.synchronize()
    counts = dict(kn.launches)
    log(f"[main] geo launches {counts}")
    if not all(counts[n] for n in GEO_KERNELS) or \
            counts["prefix_certify"] or counts["topk_rows"]:
        raise AssertionError(f"geo launches wrong: {counts}")

    # parity with the oracle, and config_bench's haversine bounds
    t0 = time.time()
    want = sg.oracle_answers(corpus, qs, rmax, K, aggs=True)
    bad = []
    for qi, (r, w) in enumerate(zip(results, want)):
        real = r["docids"] != kn.SENTINEL
        ok = r["count"] == w["count"] and w["bounds_ok"] and \
            r["docids"][real].tolist() == w["docids"] and \
            (r["scores"][real] == 0.0).all() and \
            np.isneginf(r["scores"][~real]).all()
        if not ok:
            bad.append(qi)
    per_fam = {f: sum(1 for qi, ff in enumerate(fam_of)
                      if ff == f and qi not in bad) for f in "PT"}
    cnt = sorted(w["count"] for w in want)
    log(f"[parity] geo: {len(qs) - len(bad)}/{len(qs)} queries match the "
        f"oracle (counts and the first {K} docids exact; config_bench's "
        f"haversine bounds: every doc inside the circle matches, none "
        f"beyond radius + 15 km) per family {per_fam}; counts "
        f"min/median/max {cnt[0]}/{cnt[len(cnt) // 2]}/{cnt[-1]}, "
        f"{sum(w['count'] - w['inside'] for w in want)} matches in "
        f"boundary trixels outside the circles; RMAX {rmax} "
        f"({time.time() - t0:.1f} s)")
    if bad:
        qi = bad[0]
        r = results[qi]
        raise AssertionError(
            f"geo: {len(bad)} queries differ; first {qi} {qs[qi][0]} "
            f"{qs[qi][2]}: got count {r['count']} {r['docids'].tolist()} "
            f"want {want[qi]}")
    timed_runs([(bs, irs)], stats, len(qs), smi, "geo")
    agg_counts = geo_aggregations(searcher, corpus, qs, want, stats, rec)
    return {n: counts[n] + agg_counts[n] for n in counts}


def geo_aggregations(searcher, corpus, qs, want, stats, rec) -> dict:
    """The geo path's aggregation run (K17b): the T queries again with the
    bounds of loc and the cardinality of ts, held against the kernels'
    plain versions at every launch group and against the oracle's
    aggregations (``want``: oracle_answers with aggs=True)."""
    import numpy as np
    import torch

    from xapiand_tpu_torch import aggregations as am
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import BatchSearcher
    from xapiand_tpu_torch.utils import synth_geo as sg

    t_idx = [qi for qi, (f, _q, _p) in enumerate(qs) if f == "T"]
    irs = [qs[qi][1] for qi in t_idx]
    names, specs, arrays, metas = am.compile_for_segment(
        sg.SCHEMA, corpus.seg, sg.GEO_AGGS)
    at = {n: i for i, n in enumerate(names)}
    bs = BatchSearcher(searcher, k=K, aggs=(specs, arrays))
    groups = bs.plan(irs, stats=stats)
    log(f"[plan] geo aggregations {sg.GEO_AGGS} -> {specs}; {len(irs)} T "
        f"queries in {len(groups)} launches (R, compact_cap, B): " + str(
            sorted({(sum(c.classes), c.compact_cap,
                     int(b['offsets'].shape[0])) for c, _f, b, _ch in
                    groups})))
    with Held(rec, "geo aggregations",
              GEO_AGG_KERNELS + ("compact_rows",)) as held:
        bs.run(irs, stats=stats)
        torch.cuda.synchronize()
    log(f"[kernels] geo aggregations: every launch equal to its plain "
        f"version, twice bit for bit: {held.calls} launches held, each "
        f"kernel timed at its widest")
    if not all(held.calls[n] for n in GEO_AGG_KERNELS):
        raise AssertionError(f"a geo aggregation kernel was never held: "
                             f"{held.calls}")
    kn.reset_launches()
    results = bs.run(irs, stats=stats)
    torch.cuda.synchronize()
    counts = dict(kn.launches)
    log(f"[main] geo aggregations launches {counts}")
    if not all(counts[n] for n in GEO_AGG_KERNELS):
        raise AssertionError(f"geo aggregation launches wrong: {counts}")

    def close(x, y):
        return abs(float(x) - y) <= ORACLE_RTOL * abs(y)

    bad = []
    for qi, r in zip(t_idx, results):
        w = want[qi]
        a = w["aggs"]
        g, card = r["aggs"][at["bounds"]], r["aggs"][at["hours"]]
        ok = r["count"] == w["count"] and float(g["n"]) == a["n"] and \
            all(g[key] == np.float32(a[key]) for key in
                ("minlat", "maxlat", "minlon", "maxlon")) and \
            close(g["slat"], a["slat"]) and close(g["slon"], a["slon"]) and \
            int(card["n"]) == int(card["maxn"]) == a["ts_distinct"] and \
            np.asarray(card["hll"]).tolist() == a["hll"].tolist()
        if not ok:
            bad.append(qi)
    nd = sorted(want[qi]["aggs"]["ts_distinct"] for qi in t_idx)
    log(f"[parity] geo aggregations: {len(t_idx) - len(bad)}/{len(t_idx)} "
        f"queries match the oracle (counts exact; bounds equal to the "
        f"float32 minima and maxima of the matched docs' centroids; "
        f"centroid sums at rtol {ORACLE_RTOL}; distinct timestamps exact; "
        f"the 1024 registers equal to the numpy replica); distinct "
        f"timestamps min/median/max {nd[0]}/{nd[len(nd) // 2]}/{nd[-1]}")
    if bad:
        qi = bad[0]
        raise AssertionError(
            f"geo aggregations: {len(bad)} queries differ; first {qi} "
            f"{qs[qi][2]}: got {results[t_idx.index(qi)]['aggs']} want "
            f"{want[qi]['aggs']}")
    first = t_idx[0]
    shaped = am.merge_and_shape(names, metas, [results[0]["aggs"]], [{}])
    log(f"[parity] geo aggregations: shaped response of query {first}: "
        f"count {results[0]['count']}, aggregations {json.dumps(shaped)}")
    return counts


_ORACLE: dict = {}


def _oracle_job(i):
    """The oracle's verdict on result i of the Database path (a forked
    worker's job): None, or what differs."""
    from xapiand_tpu_torch.utils import synth_docs as sd

    db, truth, qs, terms, results = _ORACLE["state"]
    r = results[i]
    if i >= len(qs):
        err = sd.check_hits(db, r, sd.oracle_search(db, truth,
                                                    terms[i - len(qs)]), K)
        return err[:200] if err else None
    _fam, q, aggs, count_only = qs[i]
    want = sd.oracle_search(db, truth, q, aggs=aggs, count_only=count_only)
    err = sd.compare_aggs(r.aggregations, want["aggregations"])
    if not err and count_only and r.total != want["total"]:
        err = f"total {r.total} != {want['total']}"
    if not err and not count_only:
        err = sd.check_hits(db, r, want, K)
    return err[:300] if err else None


def database_path(dev, rec, smi) -> dict:
    """Slice 8: the port's Database at full width - the bank / netlog
    corpus of utils/synth_docs.py indexed through Database.index_document
    in DB_COMMITS commits, 1% deleted and 0.5% replaced after the last,
    then DB_EACH aggregated searches of each of its 8 families and DB_TERMS
    plain term queries (host-routed), gated by its float64 oracle."""
    import numpy as np
    import torch

    from xapiand_tpu_torch import database as dbm
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import SegmentSearcher
    from xapiand_tpu_torch.utils import synth_docs as sd

    os.environ["XT_HOST_PATH"] = "1"   # the default: Database routes
    t0 = time.time()
    corpus = sd.build_corpus(DB_DOCS, seed=7)
    docs = [corpus.doc(i) for i in range(DB_DOCS)]
    log(f"[corpus] database: {DB_DOCS} bank / netlog docs "
        f"{time.time() - t0:.1f} s")
    db = dbm.Database(device=dev)
    t_index = t_commit = 0.0
    per = DB_DOCS // DB_COMMITS
    commits = [range(c * per, DB_DOCS if c == DB_COMMITS - 1
                     else (c + 1) * per) for c in range(DB_COMMITS)]
    for rows in commits:
        t0 = time.perf_counter()
        for i in rows:
            db.index_document(docs[i], doc_id=str(i))
        t1 = time.perf_counter()
        db.commit()
        t_index += t1 - t0
        t_commit += time.perf_counter() - t1
    rng = np.random.Generator(np.random.PCG64(5))
    gone = rng.choice(DB_DOCS, DB_DOCS // 100, replace=False)
    for i in gone:
        db.delete_document(str(i))
    commits.append(rng.choice(np.setdiff1d(np.arange(DB_DOCS), gone),
                              DB_DOCS // 200, replace=False))
    for i in commits[-1]:
        db.index_document(docs[int(i)], doc_id=str(i))
    t1 = time.perf_counter()
    db.commit()
    t_commit += time.perf_counter() - t1
    log(f"[index] database: {DB_DOCS / t_index} doc/s through "
        f"index_document ({t_index:.2f} s); commits {t_commit:.3f} s in all "
        f"({DB_COMMITS} + 1); segments "
        f"{[s.segment.num_docs for s in db._searchers]}, live "
        f"{db.doc_count}")
    qs, terms = sd.queries(corpus, n_each=DB_EACH, n_terms=DB_TERMS,
                           seed=11)

    # routes and bind time, counted by wrapping the Database's entries
    routes = {"host": 0, "device": 0}
    bind_s = [0.0]
    orig = (dbm.Database._search_host, SegmentSearcher.execute, dbm.bind)

    def search_host(self, cqs, *a, **kw):
        routes["host"] += len(cqs)
        return orig[0](self, cqs, *a, **kw)

    def execute(self, *a, **kw):
        routes["device"] += 1
        return orig[1](self, *a, **kw)

    def timed_bind(*a, **kw):
        t = time.perf_counter()
        try:
            return orig[2](*a, **kw)
        finally:
            bind_s[0] += time.perf_counter() - t

    dbm.Database._search_host = search_host
    SegmentSearcher.execute = execute
    dbm.bind = timed_bind

    try:
        # warm: the segments' uploads, one search of each family
        for fam in sd.FAMILIES:
            _f, q, aggs, count_only = next(x for x in qs if x[0] == fam)
            db.search(q, k=K, aggs=aggs, count_only=count_only)
        db.search(terms[0], k=K)
        torch.cuda.synchronize()
        kn.reset_launches()
        routes.update(host=0, device=0)
        bind_s[0] = 0.0
        call_ms = []
        results = []
        for _fam, q, aggs, count_only in qs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            results.append(db.search(q, k=K, aggs=aggs,
                                     count_only=count_only))
            torch.cuda.synchronize()
            call_ms.append(1e3 * (time.perf_counter() - t))
        term_ms = []
        for q in terms:
            t = time.perf_counter()
            results.append(db.search(q, k=K))
            term_ms.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        counts = dict(kn.launches)
        n_exec = routes["device"]
        log(f"[routes] database: {len(qs)} aggregated searches, "
            f"{n_exec} SegmentSearcher.execute calls "
            f"({len(db._searchers)} segments a search); {len(terms)} term "
            f"queries, {routes['host']} answered by the native host "
            f"scorer (Database._search_host)")
        if routes["host"] != len(terms):
            raise AssertionError(f"database: {routes['host']} of "
                                 f"{len(terms)} term queries took the host "
                                 "route")
        if not all(counts[n] for n in DATABASE_KERNELS):
            raise AssertionError(f"database launches {counts}")
        cm, tm = sorted(call_ms), sorted(term_ms)
        log(f"[latency] database: Database.search host ms a call (fenced), "
            f"aggregated median {cm[len(cm) // 2]} p99 "
            f"{cm[int(len(cm) * 0.99)]} max {cm[-1]}; term queries median "
            f"{tm[len(tm) // 2]} p99 {tm[int(len(tm) * 0.99)]}; bind "
            f"{1e3 * bind_s[0] / max(n_exec, 1)} ms a call over {n_exec} "
            f"execute calls; on {smi}")
        fam_ms = {f: sorted(m for (ff, *_x), m in zip(qs, call_ms)
                            if ff == f) for f in sd.FAMILIES}
        log("[latency] database: median ms a call by family " + str(
            {f: round(m[len(m) // 2], 3) for f, m in fam_ms.items()}))

        # the oracle, in forked workers (numpy on the corpus and the
        # host's data only; they touch no CUDA state), joined before the
        # path goes on
        t0 = time.time()
        import multiprocessing

        _ORACLE["state"] = (db, sd.Truth(corpus, db, commits, gone), qs,
                            terms, results)
        n_proc = max(1, min(8, os.cpu_count() or 1) - 1)
        with multiprocessing.get_context("fork").Pool(n_proc) as pool:
            errs = pool.map(_oracle_job, range(len(results)), chunksize=4)
        _ORACLE.clear()
        bad = [(qs[i][0], i, e) for i, e in enumerate(errs[:len(qs)]) if e]
        n_ok = len(qs) - len(bad)
        bad_t = [(terms[i], e) for i, e in enumerate(errs[len(qs):]) if e]
        log(f"[parity] database: {n_ok}/{len(qs)} aggregated searches and "
            f"{len(terms) - len(bad_t)}/{len(terms)} routed term queries "
            f"equal to the float64 oracle (hits as tie groups, scores "
            f"within float32 tolerance, counts exact, sums within "
            f"synth_docs.SUM_RTOL, medians and percentiles exact); oracle "
            f"{time.time() - t0:.1f} s in {n_proc} processes")
        if bad or bad_t:
            raise AssertionError(f"database oracle: {bad[:4]} {bad_t[:4]}")

        # device busy over 64 aggregated searches
        from torch.profiler import ProfilerActivity, profile, record_function

        window = [x for x in qs if x[0] != "M"][:48] + \
            [x for x in qs if x[0] == "M"][:16]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("smoke.run"):
                for _fam, q, aggs, count_only in window:
                    db.search(q, k=K, aggs=aggs, count_only=count_only)
                torch.cuda.synchronize()
        busy, span = device_busy(prof, "smoke.run")
        log(f"[trace] database: {len(window)} searches (48 text, 16 "
            f"match-all): " + (
                f"device busy {busy} ms of {span} ms ({100 * busy / span} %)"
                if busy is not None else
                f"{span} ms; device busy not measured (no device events)"))

        # every K17c launch of the aggregated searches held against its
        # plain version; each kernel timed at its widest launch
        with Held(rec, "database", K17C_KERNELS) as held:
            for _fam, q, aggs, count_only in qs:
                db.search(q, k=K, aggs=aggs, count_only=count_only)
            torch.cuda.synchronize()
        log(f"[held] database: K17c launches held against their plain "
            f"versions (twice bit for bit, counts and codes exact, sums "
            f"within rtol {AGG_RTOL}): {held.calls}")
        if not all(held.calls.values()):
            raise AssertionError(f"database held {held.calls}")
    finally:
        dbm.Database._search_host, SegmentSearcher.execute, dbm.bind = orig
        os.environ["XT_HOST_PATH"] = "0"
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
    # the earlier paths time the device path of BatchSearcher.run; the
    # Database path routes as the JAX package does (XT_HOST_PATH=1)
    os.environ["XT_HOST_PATH"] = "0"
    t0 = time.time()
    rel, rel_world = relevance_path(dev, rec, smi)
    torch.cuda.empty_cache()
    log(f"[time] relevance path {time.time() - t0:.1f} s")
    t0 = time.time()
    fac, corpus, searcher = faceted_path(dev, rec, smi)
    torch.cuda.empty_cache()
    log(f"[time] faceted path {time.time() - t0:.1f} s")
    t0 = time.time()
    bro = browse_path(dev, rec, smi, corpus, searcher)
    torch.cuda.empty_cache()
    log(f"[time] browse path {time.time() - t0:.1f} s")
    t0 = time.time()
    sch = schemes_path(dev, rec, smi, rel_world, corpus, searcher)
    del corpus, searcher, rel_world
    torch.cuda.empty_cache()
    log(f"[time] schemes path {time.time() - t0:.1f} s")
    t0 = time.time()
    pos = positional_path(dev, rec, smi)
    torch.cuda.empty_cache()
    log(f"[time] positional path {time.time() - t0:.1f} s")
    t0 = time.time()
    geo = geo_path(dev, rec, smi)
    log(f"[time] geo path and its aggregation run {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    dbp = database_path(dev, rec, smi)
    log(f"[time] database path {time.time() - t0:.1f} s")
    if [m for m in sys.modules
            if m.split(".")[0] in ("jax", "xapiand_tpu")]:
        raise AssertionError("JAX or the JAX package was imported")

    print(json.dumps({"kernels": [
        rec.record(name, sum(c.get(name, 0)
                             for c in (rel, fac, bro, sch, pos, geo, dbp)))
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
