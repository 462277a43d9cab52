#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: its eleven main paths.

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

K21 path - the three other executors of the JAX package, after the
schemes path, over the relevance path's 1M-doc segment and the faceted
path's 1M-doc corpus and device segments: the 1024 relevance ORs through
BatchSearcher(k=10, prefix_cap=0, chunk_rows=CHUNK_ROWS) - at least half
the queries must run chunked, each group's n_chunks printed - against the
float64 oracle and the
unchunked exact run; faceted A and B with the pinned planner's
SEMIJOIN_RATIO at 1 (every A query a semijoin, semijoin_rows) against the
faceted oracle, aggregations included; join=True on the relevance exact
groups and on faceted A against the same oracles. Every launch of
score_slices, merge_docs, topk_rows, chunk_merge, shard_reduce,
semijoin_rows, filter_leaves, sort_topk and the aggregation kernels in the
three runs is held against its plain version (``Held``); each mode's QPS
is printed beside the default path on the same queries (information).

Database path - the port's own Database (xapiand_tpu_torch/database.py)
at full width over utils/synth_docs.py's bank / netlog corpus: 100k JSON
documents (docs/EXAMPLES.md's /bank and /netlog shapes: text, numbers,
dates, IPv4 / IPv6 addresses, 10% of docs with several, geo points)
indexed through Database.index_document in 4 commits, then 1% deleted and
0.5% replaced; 256 Database.search calls in 8 families of 32 (H
histograms, R ranges + median, F filter + percentiles, N terms >
histogram > median, I ip_range + geo_ip, G geo_trixels + geo_distance, M
match-all count-only carrying 3-4 bundles: the dense path, P modes and
medians) and 256 plain term queries, which the native host scorer answers
(XT_HOST_PATH at its default; the earlier paths run with it 0, the device
path). The counted run's launches, routes, host ms a call and bind ms;
every answer against synth_docs' float64 oracle (in forked numpy workers);
one profiled window's device-busy share and device ms by kernel; then
every K17c launch (agg_buckets' code modes, agg_ranges, agg_hist,
agg_filter) and every agg_metrics launch of the 256 searches held against
its plain version, each kernel timed at its widest launch beside its bound
and its library yardstick (torch.bincount for agg_buckets' counts and
agg_hist, torch.searchsorted for agg_filter).

REST path - the port's REST server (xapiand_tpu_torch/server/, create_app
with an IndexManager on the card, the server's default options) in a
thread of this process, with persistence and MSet clustering: the
conformance replay of docs/EXAMPLES.md (scripts/conformance.py), every
case passing, the four /sharded ones (a 2-shard index) among them;
BASELINE.json config 1 at its published 10k documents
(utils/synth_passages.py: ~60-token passages, Zipf(1.07) over 30k
words, in place of the MS MARCO sample the repository lacks) indexed
through POST /passages/:restore (NDJSON) and :commit, then 256 BM25
top-10 term queries of 1-3 words (POST /passages/:search) at one client
and at 8, each held to synth_passages' float64 oracle, with the route
each took and one profiled window; POST :snapshot, a new server on the
same data dir, the same 256 answers; 100 passages written with no commit
to a server without autocommit, stopped, and recovered by the WAL replay
of the next (each found by a query of its rarest word, held to the
oracle); 64 searches with "_cluster": {"_k": 3} at _limit 10, 16 with
_k 8 at _limit 256, 32 with "_diversify", and Database.cluster_hits over
4096 passages at k 16, V 2048, counted (kmeans, K20: one launch a
kmeans_cosine call), then held: every step of every call, read from the
call's history, against the plain step and float64 numpy by the margin
rule (ops/cluster.py near_ties: labels equal on every row whose top-2
margin exceeds 2 gamma_V; centroids within rtol 1e-5), and each
kmeans_cosine call replayed by a float64 replica from the same seeding;
last, the Database path's 100k-doc state through models/snapshot.py
snapshot_bytes into a fresh Database on the card, 64 of its aggregated
searches and 64 of its term queries equal to the original answers.

Mesh path - BASELINE.json config 5 at its published 10M documents over 8
shards stacked on the card (utils/synth_mesh.py: 16 Zipf(1.07) words over
20,000 a doc, fnv1a routing, each shard's segment built with numpy; dp =
1, one card), its 256 three-word ORs (config_bench.queries5's draws)
through parallel/sharded.py MeshExecutor.run at k 10: each shard's
execute_batch (score_slices, merge_docs, topk_rows) in sub-batches of
MESH_ROWS rows, then shard_merge and shard_reduce (K19). The counted run
(launches, the S x Q binds' ms, each shard execute's device ms), a run
with every launch held bit for bit, warm runs for QPS, one profiled run,
and every answer against synth_mesh's float64 oracle (in forked numpy
workers): totals exact, scores within rtol 1e-5, ranks as tie groups.

REST mesh path - 20k bank / netlog docs through :restore into an
8-shard and a 1-shard index (two commits, 1% deleted), then the traffic
on both: aggregated searches of synth_docs' H, R and P families (the
kinds in MESH_AGG_KINDS), value sorts, a strmetric sort, collapses (a
sorted one at _limit 10 runs sort_topk at k 80 a shard: wide_topk),
count-only searches, filtered searches with a cardinality, a match-all,
pages of 300 (wide_topk) and Database.search_many; every launch held
against its plain version; the sharded answers equal to the unsharded
ones (hits in order, totals exact, scores and sums within rtol 1e-5; a
sorted collapse on employer, where the unsharded index keeps one hit a
segment as JAX's does, held hit for hit to synth_docs' oracle of JAX
ShardedDatabase's rule).

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
  5. QPS of 7 warm runs (median and spread), host planning's share of
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
for semijoin_rows torch.searchsorted of the drive rows' docids in each probed
block, for chunk_merge and shard_merge torch.sort of the packed keys, for
sort_topk where the only key is the docid (an unweighted plan: geo, browse
N) torch.topk(largest=False) of the masked docids, null elsewhere: no
single PyTorch call computes any of the other functions); the last line is
{"ok": true, "device": {...}}.

Before them: a "[kernels] <name> every shape" line for topk_rows,
dense_rows, sort_topk and merge_special (SHAPE_KERNELS): each distinct launch shape of
every path, timed once where it first came (kernel, plain version, bound
and library call, the path's tag first), outside the counted runs; and
wide_topk's key-word table (a sort of 40 value keys, 82 words a key, the
widest sort the wide mode takes; no path drives it), held against its
plain version and
timed in its own phase after the paths; then each design of collapse_rows
(the tiles, in one block and in several, and the global design) forced
at the edge shapes of tests/test_torch_cuda.py's collapse tests, each call
twice bit for bit and against its plain version. Every held collapse_rows
call's key names the design kernels.collapse_plan took for it.
Without a CUDA device, or outside a checkout of the repo, it exits
non-zero with no result.

    python3 chip_smoke.py [--capture DIR [--only PATH]]

--capture DIR saves the arguments of the launches tools/sort_pairs.py
replays (CAPTURE: merge_special at browse S and X, B16 and B32, and a
schemes S and X launch; kmeans' kmeans_cosine calls at n10 k3, n256 V2048
k8 and n4096 V2048 k16; sort_topk's geo, browse, faceted and REST mesh
shapes, the widest agg_filter and semijoin_rows; score_slices and
merge_docs at
browse C, the mesh, browse B16, faceted A, geo, geo aggregations and the
relevance prefix group; shard_reduce at the REST mesh and mesh shapes and
its min / max; collapse_rows at browse C's, its dense plans' and the REST
mesh's shapes; agg_buckets' widest launch of faceted A and D with and
without subs, browse M, the geo aggregations, the Database path's
trixels and nested level of 144 buckets, the REST mesh's histogram with
a sub; phrase_leaves at the positional launch groups B64 R65536, R196736,
R262144 and R393344; geo_leaves at geo's B8 R184448 and R312960 and the
geo aggregations' B64 R25728; wide_topk, the wide mode of topk_rows and
sort_topk, at the REST mesh's widest page of 300 and sorted collapse of
k 80 and at the key-word table's sort) as the paths make them. With
--only PATH (relevance, positional, geo, mesh, rest_mesh, faceted,
database, wide_table) it runs that path alone for its captures and
prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager

from xapiand_tpu_torch.utils.cudatime import device_ms, event_ms as cuda_ms

ROOT = os.path.dirname(os.path.abspath(__file__))

N_DOCS, VOCAB, N_QUERIES, TERMS, K = 1_000_000, 200_000, 1024, 3, 10
FACETED_DOCS, FACETED_PER_FAMILY = 1_000_000, 256
POSITIONAL_DOCS, POSITIONAL_EACH, POSITIONAL_THREE = 100_000, 512, 128
GEO_DOCS, GEO_P, GEO_T = 1_000_000, 1024, 256
BROWSE_M, BROWSE_N, BROWSE_S, BROWSE_X, BROWSE_C = 256, 128, 256, 256, 128
# wide_topk's key-word table: one sort of WIDE_TABLE_KEYS value keys (two
# words each) over B x R synthetic rows
WIDE_TABLE_KEYS, WIDE_TABLE_B, WIDE_TABLE_R = 40, 4, 262_144
# the Database path's depth: 100k docs since the mesh path came in (200k
# before it; PERF.md section 4), 32 searches a family since the script
# outgrew half of its time limit (64 before)
DB_DOCS, DB_COMMITS, DB_EACH, DB_TERMS = 100_000, 4, 32, 256
# BASELINE config 5 at its published 10M docs over 8 shards stacked on the
# card; the REST mesh phase's bank / netlog docs (a depth cut: 50k in PR
# 10, 20k since the script outgrew half of its time limit)
MESH_DOCS, MESH_SHARDS, MESH_QUERIES, MESH_RUNS = 10_000_000, 8, 256, 5
REST_MESH_DOCS, REST_MESH_EACH = 20_000, 8
MAX_BATCH, PREFIX_CAP = 256, 8192
# warm runs behind each path's QPS (20 until the script outgrew half of
# its time limit; PERF.md section 4)
TIMED_RUNS = 5
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
    "kmeans": ("xapiand_tpu_torch/csrc/kmeans.cu",
               "xapiand_tpu/ops/cluster.py:43"),
    "wide_topk": ("xapiand_tpu_torch/csrc/wide_topk.cu",
                  "xapiand_tpu/ops/executor.py:470"),
    "shard_merge": ("xapiand_tpu_torch/csrc/shard_merge.cu",
                    "xapiand_tpu/parallel/sharded.py:341"),
    "shard_reduce": ("xapiand_tpu_torch/csrc/shard_merge.cu",
                     "xapiand_tpu/parallel/sharded.py:341"),
    "semijoin_rows": ("xapiand_tpu_torch/csrc/semijoin_rows.cu",
                      "xapiand_tpu/ops/executor.py:1172"),
    "chunk_merge": ("xapiand_tpu_torch/csrc/shard_merge.cu",
                    "xapiand_tpu/ops/executor.py:1000"),
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
# config 5's 3-word ORs on the mesh; the REST mesh traffic adds its
# aggregations, sorts, collapses and wide pages
MESH_KERNELS = ("score_slices", "merge_docs", "topk_rows", "shard_merge",
                "shard_reduce")
REST_MESH_KERNELS = MESH_KERNELS + (
    "sort_topk", "collapse_rows", "filter_leaves", "dense_rows",
    "agg_metrics", "agg_buckets", "agg_ranges", "agg_hist", "agg_distinct",
    "wide_topk")


# the kernels timed at every distinct launch shape of every path
# ([kernels] ... every shape lines): topk_rows, dense_rows and
# merge_special, whose shapes PERF.md section 6 tabulates, and sort_topk,
# whose docid-only launches have a library call
SHAPE_KERNELS = ("topk_rows", "dense_rows", "sort_topk", "merge_special")


def log(msg):
    print(msg, flush=True)


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
        # SHAPE_KERNELS' times at each distinct launch shape, first seen
        self.shapes: dict = {n: {} for n in SHAPE_KERNELS}

    def shape(self, name, key, tag, ms, plain_ms, work, library_ms=None):
        """One launch shape's times beside its bound, apart from the
        kernel's summed record."""
        bound = max(1e3 * work[0] / HBM_BYTES_PER_S,
                    1e3 * work[1] / PEAK_OPS_PER_S)
        self.shapes[name][key] = (tag, ms, plain_ms, bound, library_ms)

    def shape_lines(self):
        for name, shapes in self.shapes.items():
            log(f"[kernels] {name} every shape: [path, kernel, plain, "
                f"bound, library] ms {json.dumps(shapes)}")

    def note(self, name, err, ms, plain_ms, work, library_ms=None,
             shape=None):
        """work: (bytes, operations) that the launch must move and do;
        library_ms: one PyTorch call's time for the same function; shape:
        (key, tag), the launch shape a SHAPE_KERNELS entry is kept under
        (once a key)."""
        if shape is not None and shape[0] not in self.shapes.get(name,
                                                                 {0: 0}):
            self.shape(name, shape[0], shape[1], ms, plain_ms, work,
                       library_ms)
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
    """merge_docs, the function: a real row's docid and weight read (a
    term block's SENTINEL rows need no read: they follow its real rows),
    the outputs written per row, the per-term words, a deleted flag per
    real row; one add per real row (a doc's sum is its rows' weights
    added; the probes' searches are their design's cost, not the
    function's)."""
    B, R = ids.shape
    real = n_true(ids != 2**31 - 1)
    out = 5 + (4 if orbits is not None else 0)
    return (8 * real + 4 * B * len(widths) +
            (real if deleted is not None else 0) + out * B * R + 4 * B,
            real)


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


PACKED_CH = ("keys", "codes", "code_hll")


def packed_bytes(values):
    """The device bytes of the value columns' packed keys and codes
    (models/segment.py value_arrays), and of the columns whole."""
    from xapiand_tpu_torch.parallel.sharded import stacked_nbytes

    packed = stacked_nbytes({s: {ch: c[ch] for ch in PACKED_CH if ch in c}
                             for s, c in values.items()})
    return packed, stacked_nbytes(values)


def log_packed(tag, searcher):
    """[index] line: a segment's device bytes, whole and those of its value
    columns' packed keys and codes."""
    from xapiand_tpu_torch.parallel.sharded import stacked_nbytes

    tree = searcher.device_segment.arrays_pytree()
    packed, cols = packed_bytes(tree["values"])
    total = stacked_nbytes(tree)
    log(f"[index] {tag}: the segment {total} bytes on the card, its value "
        f"columns {cols}, of which their packed keys and codes {packed} "
        f"({packed / max(total - packed, 1):.2%} over the rest)")


def work_filter(ids, base, F, phbits, n_col=None, geobits=None,
                prog=None):
    """filter_leaves, the function: on every row its flag byte (base) and
    its eligible byte written; on a first row its docid where a leaf
    reads it (F > 0), its orbits where the tree prog reads a group bit
    (any prog but one without a G leaf) and its verdict words (phrase,
    geo), and 17 bytes a leaf (the four key words and present; the column
    read at most once, of n_col rows); where base is None (packed rows)
    the docid is the flag and is read on every row; the count written a
    query."""
    from xapiand_tpu_torch.ops import kernels as kn

    B, C = ids.shape
    first = base if base is not None else ids != 2**31 - 1
    nf = n_true(first)
    words = 4 * ((phbits is not None) + (geobits is not None))
    if prog is None or any(i & 0xff == kn.OP_G for i in prog):
        words += 4
    if base is not None:
        per_row, per_first = 2, (4 if F else 0) + words
    else:
        per_row, per_first = 5, words
    col = 17 * F * (nf if n_col is None else min(nf, n_col))
    return per_row * B * C + per_first * nf + col + 4 * B, B * C + nf


# bytes of one eligible row's sort key columns, by key kind
KEY_BYTES = {"value": 9, "score": 0, "dist": 5, "geodist": 9,
             "strmetric": 8, "docid": 0}


def work_sort(specs, elig, k, n_col=None):
    """wide_topk: ids, sums and flags per row, the key columns per
    eligible row (of n_col column rows at most), the top k (docid, score)
    written."""
    B, C = elig.shape
    return work_selected(B, C, 9, n_true(elig),
                         sum(KEY_BYTES[s[0]] for s in specs), 9 * B * k,
                         n_col)


def work_fullwidth(spec, elig, k, n_col=None):
    """fullwidth_topk, the function: the flag of every row; an eligible
    row's docid and its key column bytes (gathered by docid from a column
    of n_col rows at most: read once); the k winners' docid and score
    read and written, and the certificate written."""
    B, R = elig.shape
    sel = n_true(elig)
    col = KEY_BYTES[spec[0]] * (sel if n_col is None else min(sel, n_col))
    return B * R + 4 * sel + col + 16 * B * k + B, B * R + sel


def fullwidth_image_call(spec, col, ids, sums, elig, k, targets, strtabs):
    """A part of fullwidth_topk as one PyTorch call: torch.topk(largest=
    False) of the masked float32 image over kk rows (JAX's lax.top_k,
    xapiand_tpu/ops/executor.py:447, :454), without the exact order of the
    window or the certificate. The image is made at the first call, which
    the timers take as their warm-up."""
    from xapiand_tpu_torch.ops import kernels as kn

    import torch

    kk = min(k + kn.FULLWIDTH_WINDOW, ids.shape[1])
    img: list = []

    def call():
        if not img:
            mk = kn._masked_key(0, spec, col, ids, sums, elig, targets,
                                strtabs)
            img.append(mk[0].to(torch.float32).contiguous())
        return torch.topk(img[0], kk, dim=1, largest=False)

    return call


def work_sort_topk(specs, elig, k, n_col=None, emit=False):
    """sort_topk: a flag byte every row; for an eligible row its docid, its
    score only under a score key, and its key columns (gathered by docid
    from columns of n_col rows at most: read once); the k (docid, score)
    and, with emit, the k rows' key words written. An ineligible row's
    key needs nothing but its flag. (The kernel's 16-byte docid load also
    reads the ineligible docids of a group of 4 rows with an eligible one:
    the function does not need them, so they are not counted.)"""
    B, C = elig.shape
    sel = n_true(elig)
    col = sum(KEY_BYTES[s[0]] for s in specs)
    score = 4 if any(s[0] == "score" for s in specs) else 0
    words = sum(2 if s[0] == "value" else 1 for s in specs) if emit else 0
    return (B * C + (4 + score) * sel +
            col * (sel if n_col is None else min(sel, n_col)) +
            (8 + 4 * words) * B * k, B * C + sel)


def topk_library_ms(sums, owner, k):
    """The library yardstick of topk_rows: one torch.topk of the masked
    scores (the same rows and k; it breaks ties in no fixed order)."""
    return cuda_ms(topk_library_call(sums, owner, k), reps=5)


def topk_library_call(sums, owner, k):
    """topk_library_ms' call: the masking made at the first call, which
    the timers take as their warm-up."""
    import torch

    kk = min(k, sums.shape[1])
    masked = []

    def call():
        if not masked:
            masked.append(torch.where(owner, sums, float("-inf")))
        return torch.topk(masked[0], kk, dim=1)

    return call


def docid_topk_call(ids, elig, k):
    """The library yardstick of sort_topk where the only key is the docid
    (an unweighted plan): one torch.topk(largest=False) of the masked
    docids gives the same docid list. The masking is made at the first
    call, which the timers take as their warm-up."""
    import torch

    kk = min(k, ids.shape[1])
    masked = []

    def call():
        if not masked:
            masked.append(torch.where(elig, ids, 2**31 - 1))
        return torch.topk(masked[0], kk, dim=1, largest=False)

    return call


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
        return kn.merge_docs(ids, w, widths, n_docs=seg["deleted"].shape[0])

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
             work_rows(R, B, 9, 8 * kk), topk_library_ms(sums, owner, kk),
             (f"B={B} R={R} k={kk}", shape_name))

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
                 work_metrics(ids, elig, M, n_rows(values)))
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
        # as held_buckets counts it: the flag a row, an eligible row's
        # docid, code and value subs
        b, ops = work_selected(B, R, 1, ne, CODE_BYTES[sp[0]] + 5 * n_val,
                               4 * B * args[4] * (1 + 5 * S), n_rows(values))
        note("agg_buckets", err, lambda: kn.agg_buckets(*args),
             lambda: kn._agg_buckets_plain(*args), (b + 4 * ne, ops))
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
    nd = seg["deleted"].shape[0]
    got, want = kn.merge_docs(*margs, n_docs=nd), \
        kn._merge_docs_plain(*margs)
    err = check_close("merge_docs sums", got[0], want[0])
    for nm, a, b in zip(("mask", "count", "orbits"), got[1:], want[1:]):
        check_equal(f"merge_docs {nm}", a, b)
    rec.note("merge_docs", err,
             cuda_ms(lambda: kn.merge_docs(*margs, n_docs=nd)),
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
                             n_rows(values), prog=prog))
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
                 work_fullwidth(spec, mask, cfg.k, n_rows(values)))
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
                 work_sort_topk(cfg.sort, mask, cfg.k, n_rows(values)),
                 None,
                 (f"B={B} R={ids.shape[1]} k={cfg.k} keys="
                  f"{'-'.join(sp[0] for sp in cfg.sort)}", shape_name))
    else:
        targs = (sums, ids, mask, cfg.k)
        got, want = kn.topk_rows(*targs), kn._topk_rows_plain(*targs)
        check_equal("topk_rows docids", got[0], want[0])
        check_equal("topk_rows scores", got[1], want[1])
        rec.note("topk_rows", 0.0, cuda_ms(lambda: kn.topk_rows(*targs)),
                 cuda_ms(lambda: kn._topk_rows_plain(*targs)),
                 work_rows(ids.shape[1], B, 9, 8 * cfg.k),
                 topk_library_ms(sums, mask, cfg.k),
                 (f"B={B} R={ids.shape[1]} k={cfg.k}", shape_name))
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


_FORKED: dict = {}


def _forked_job(i):
    fn, corpus, qs, n, a, kw = _FORKED["job"]
    return fn(corpus, qs[i::n], *a, **kw)


def forked_answers(fn, corpus, qs, *a, **kw):
    """fn(corpus, qs, *a, **kw) - a float64 oracle that answers each query
    of qs on its own, in order - over strided slices of qs in forked numpy
    workers (they touch no CUDA state), reassembled in qs' order."""
    import multiprocessing

    n = max(1, min(8, os.cpu_count() or 1) - 1)
    _FORKED["job"] = (fn, corpus, qs, n, a, kw)
    try:
        with multiprocessing.get_context("fork").Pool(n) as pool:
            parts = pool.map(_forked_job, range(n), chunksize=1)
    finally:
        _FORKED.clear()
    out: list = [None] * len(qs)
    for i, part in enumerate(parts):
        out[i::n] = part
    return out


@contextmanager
def fullwidth(flag):
    """XT_FULLWIDTH=flag inside the block (BatchSearcher and query/plan.py
    fullwidth_ok read it), "1" again after it."""
    os.environ["XT_FULLWIDTH"] = flag
    try:
        yield
    finally:
        os.environ["XT_FULLWIDTH"] = "1"


def timed_runs(runs, stats, n_queries, smi, tag, profiled=True,
               n_runs=TIMED_RUNS):
    """n_runs warm runs of every (BatchSearcher, irs) in ``runs``, host-clock
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
    for _ in range(n_runs):
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
    trace_by_kernel(prof, tag)


def trace_by_kernel(prof, tag, top=12):
    """The device ms and launches of the top kernels of one profiled
    run."""
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and e.name != "smoke.run":
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (
                ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    log(f"[trace] {tag}: device (ms, launches) by kernel, largest first: "
        + str({n[:40]: (round(v, 4), c) for n, (v, c) in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][0])[:top]}))


# --------------------------------------------------------------------------
# kernels held against their plain versions inside a run of the path itself
# --------------------------------------------------------------------------

def work_collapse(ids, elig, cmax, n_col):
    """collapse_rows: the flag read per row, keep and tie written per row
    (6 bytes); docid and score read per eligible row (8) and the key column
    (hi, lo, present; n_col rows) per eligible row, 9 bytes, the column
    read once at most; one table operation per eligible row and round."""
    B, R = ids.shape
    ne = n_true(elig)
    return 6 * B * R + 8 * ne + 9 * min(ne, n_col), B * R + ne * cmax


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


def work_special(ids, widths, bits, offsets, post_wdf, max_specs,
                 syn_groups, uniq=None):
    """merge_special, the function (not either design's searches): each
    real row's docid and weight read, 8 bytes, and every row's sum
    written, 4; each term's bits and offset a query, 8 bytes; where the
    plan has synonym groups, 4 bytes more a real row of a term that feeds
    one (its posting's wdf), and per query 4 a doc whose synonym sums are
    not all 0 (its length, read once), 4 more with uniqterms; one add a
    (real row, channel): the base, each branch of each max spec, each
    synonym group."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    B, R = ids.shape
    realm = ids != 2**31 - 1
    real = n_true(realm)
    nbytes = 8 * real + 4 * B * R + 8 * B * len(widths)
    if syn_groups:
        smask = 0
        for m in syn_groups:
            smask |= m
        feeds = (bits & kn._i32(smask)) != 0
        ro = kn.row_offsets(widths)
        n = post_wdf.shape[0]
        qb = torch.arange(B, device=ids.device)[:, None] << 31
        keys, wdfs = [], []
        for u, W in enumerate(widths):
            on = realm[:, ro[u]:ro[u + 1]] & feeds[:, u:u + 1]
            start = offsets[:, u].long().clamp(max=n - W).clamp(min=0)
            wdf = post_wdf[start[:, None] +
                           torch.arange(W, device=ids.device)]
            keys.append((qb + ids[:, ro[u]:ro[u + 1]].long())[on])
            wdfs.append(wdf[on])
        keys, wdfs = torch.cat(keys), torch.cat(wdfs)
        nbytes += 4 * keys.numel()
        if keys.numel():
            docs, inv = torch.unique(keys, return_inverse=True)
            ssum = torch.zeros(docs.numel(), dtype=torch.float32,
                               device=ids.device).index_add_(0, inv, wdfs)
            nbytes += (8 if uniq is not None else 4) * n_true(ssum > 0)
    return nbytes, real * kn.special_channels(max_specs, syn_groups)


def work_distinct(ids, elig, n_col):
    """agg_distinct, the function: the flag byte of every row; an eligible
    row's docid, and its key (hi, lo, present: 9 bytes, the column read
    at most once, of n_col rows); the count and 1024 registers written a
    query; a hash and an insert an eligible row."""
    B, R = ids.shape
    ne = n_true(elig)
    return B * R + 4 * ne + 9 * min(ne, n_col) + 4 * B * 1025, B * R + ne


def work_metrics(ids, elig, M, n_col):
    """agg_metrics over M channels, the function: the flag byte of every
    row; an eligible row's docid and its 5 bytes a channel (the column
    read at most once, of n_col rows); 5 statistics a channel and the
    count written a query."""
    B, R = ids.shape
    ne = n_true(elig)
    b, ops = work_selected(B, R, 1, ne, 5 * M, 20 * M * B + 4 * B, n_col)
    return b + 4 * ne, ops


def held_collapse(a):
    from xapiand_tpu_torch.ops import kernels as kn

    ids, sums, elig, col, cmax = a[:5]
    row_order = bool(a[5]) if len(a) > 5 else False
    c = col if col is not None else kn.absent_column(ids.device)
    cm = min(int(cmax), kn.MAX_COLLAPSE)

    def check(got, want):
        check_equal("collapse_rows keep", got[0], want[0])
        check_equal("collapse_rows tie", got[1], want[1])
        return 0.0

    # the design kernels.collapse_plan takes for the call (the table's
    # slots and the tile blocks a query, or the global design)
    ts, G = kn.collapse_plan(ids.shape[0], ids.shape[1],
                             kn.collapse_keys(c))
    return (lambda: kn._collapse_rows_plain(ids, sums, elig, c, cm,
                                            row_order), check,
            f"B={ids.shape[0]} R={ids.shape[1]} max={cm}"
            f"{' row order' if row_order else ''} "
            f"{f'tiles TS={ts} G={G}' if ts else 'global'}",
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


def unwrapped(fn):
    """The port's own wrapper under the hooks of Held and capture."""
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    return fn


@contextmanager
def uncounted():
    """Launches inside the block leave ops/kernels.py's counts as they
    were (a check's own launches)."""
    from xapiand_tpu_torch.ops import kernels as kn

    saved = dict(kn.launches)
    try:
        yield
    finally:
        kn.launches.update(saved)


def special_other(widths, n_docs, P, tiles):
    """merge_special's other design than special_plan's (tiles, tile): the
    probes where it took the tiles, else the doc tiles of the widest tile
    whose P slots a docid fit (kernels.special_tile; None where none
    fits)."""
    from xapiand_tpu_torch.ops import kernels as kn

    if tiles:
        return 0, 0
    tile = kn.special_tile(len(widths), P)
    return (-(-int(n_docs) // tile), tile) if tile else None


def held_special(a, n_docs):
    from xapiand_tpu_torch.ops import kernels as kn

    ids, _w, widths, bits, offsets, post_wdf, _dl, max_specs, syn_groups = \
        a[:9]
    spec = a[10]
    P = kn.special_channels(max_specs, syn_groups)
    tiles, tile = kn.special_plan(widths, n_docs, P)
    other = special_other(widths, n_docs, P, tiles)

    def check(got, want):
        """The call's design against the plain version, then the other
        design on the same tensors, each bit for bit (the other's launch
        not counted)."""
        err = check_close("merge_special sums", got, want)
        if err != 0.0:
            raise AssertionError(f"merge_special {(tiles, tile)}: kernel vs "
                                 f"plain max abs err {err}")
        if other is not None:
            rule = kn.special_plan
            kn.special_plan = lambda w, n, p: other
            try:
                with uncounted():
                    alt = unwrapped(kn.merge_special)(*a, n_docs=n_docs)
            finally:
                kn.special_plan = rule
            if max_err(alt, want) != 0.0:
                raise AssertionError(
                    f"merge_special {other}: the other design vs plain max "
                    f"abs err {max_err(alt, want)}")
            SPECIAL["other"] += 1
        return err

    uniq = a[11] if len(a) > 11 else None

    def work():
        return work_special(ids, widths, bits, offsets, post_wdf, max_specs,
                            syn_groups, uniq)

    return (lambda: kn._merge_special_plain(*a), check,
            f"{'syn' if syn_groups else 'max'} sid={spec.sid} "
            f"B={ids.shape[0]} R={ids.shape[1]} T={len(widths)} P={P} "
            f"tiles={tiles}x{tile} max_specs={max_specs} "
            f"syn_groups={syn_groups}", work, None)


# merge_special's calls held in the other design (held_special)
SPECIAL = {"other": 0}


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

    # the set's codes and the scratch bytes of its words
    K = col["code_hll"].shape[0] if "code_hll" in col else None
    scratch = f" K={K} scratch={4 * ids.shape[0] * kn.distinct_words(K)}" \
        if K is not None else ""
    return (lambda: kn._agg_distinct_plain(ids, elig, col), check,
            f"B={ids.shape[0]} R={ids.shape[1]}{scratch}",
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
    # the wide mode's library call, device-only too (tools/sort_pairs.py)
    yard = [topk_library_call(scores, owner, k)] \
        if goes_wide("topk_rows", a) else []
    return (lambda: kn._topk_rows_plain(scores, ids, owner, k, tie), check,
            f"{'tie ' if tie is not None else ''}B={B} R={R} k={k}",
            lambda: work_rows(R, B, 13 if tie is not None else 9, 8 * k),
            lambda: topk_library_ms(scores, owner, k), *yard)


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


def held_merge(a, *, n_docs):
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
            f"tree={bool(prog)} tiles={kn.merge_plan(widths, n_docs)}",
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


def held_fullwidth(a):
    """fullwidth_topk (K9): the window's first k and the certificate; its
    yardstick, torch.topk of the masked image, is a part of the function
    (timed device-only, no library_ms)."""
    from xapiand_tpu_torch.ops import kernels as kn

    spec, ids, sums, elig, k, values = a[:6]
    targets = a[6] if len(a) > 6 else None
    strtabs = (a[7] if len(a) > 7 else None) or {}
    col = values.get(spec[1])

    def check(got, want):
        for nm, g, w in zip(("docids", "scores", "certified"), got, want):
            check_equal(f"fullwidth_topk {nm}", g, w)
        return 0.0

    B, R = ids.shape
    return (lambda: kn._fullwidth_topk_plain(spec, col, ids, sums, elig, k,
                                             targets, strtabs), check,
            f"B={B} R={R} k={k} key={spec[0]}{'D' if spec[2] else 'A'}",
            lambda: work_fullwidth(spec, elig, k, n_rows(values)), None,
            fullwidth_image_call(spec, col, ids, sums, elig, k, targets,
                                 strtabs))


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
        return work_filter(ids, base, len(slots), phbits, n_rows(values),
                           geobits, prog)

    return (lambda: kn._filter_leaves_plain(cols, vm, fparams, ids, base,
                                            orbits, prog, phbits, geobits),
            check, f"B={ids.shape[0]} R={ids.shape[1]} F={len(slots)} "
            f"base={base is not None} geo={geobits is not None}", work, None)


def lazy_call(make):
    """A call that runs make()'s call, made at its first run: a capture
    takes a HELD entry at every launch, a yardstick's inputs are formed
    only for the launches timed."""
    made: list = []

    def call():
        if not made:
            made.append(make())
        return made[0]()

    return call


def held_geo(a):
    from xapiand_tpu_torch.ops import kernels as kn

    cols, specs, queries, ids, base = a

    def check(got, want):
        check_equal("geo_leaves verdicts", got, want)
        return 0.0

    yard = lazy_call(lambda: geo_lookups(cols, specs, queries, ids))
    return (lambda: kn._geo_leaves_plain(*a), check,
            f"B={ids.shape[0]} R={ids.shape[1]} geo_specs={tuple(specs)} "
            f"base={base is not None}",
            lambda: work_geo(ids, base, cols, specs, queries),
            lambda: cuda_ms(yard, reps=5), yard)


def phrase_lookups(a):
    """The library yardstick of K15 inside K14, on phrase_leaves'
    arguments ``a``: torch.searchsorted of each candidate's docid (the
    plain version's candidates, formed beforehand) in each phrase term's
    block. -> the call."""
    import torch

    from xapiand_tpu_torch.ops import phrase as ph
    from xapiand_tpu_torch.ops.kernels import row_offsets

    ids, widths, offsets, _lens, orbits, first, posoff, poslen, _pos, \
        phrases, cand_cap, pmax = a[:12]
    ro = row_offsets(widths)
    look = []
    for tidx, gidx, _w, _e in phrases:
        cand_d = ph.phrase_candidates(ids, widths, offsets, orbits, first,
                                      posoff, poslen, tidx, gidx, cand_cap,
                                      pmax)[0]
        look += [(ids[:, ro[t]:ro[t + 1]].contiguous(), cand_d)
                 for t in tidx]
    return lambda: [torch.searchsorted(x, y) for x, y in look]


def held_phrase(a, **_kw):
    from xapiand_tpu_torch.ops import phrase as ph

    ids, widths = a[0], a[1]
    phrases, cand_cap, pmax = a[9:12]
    yard = lazy_call(lambda: phrase_lookups(a))

    def plain():
        return ph._phrase_leaves_plain(*a[:12])

    def check(got, want):
        check_equal("phrase_leaves verdicts", got[0], want[0])
        check_equal("phrase_leaves candidates", got[1], want[1])
        return 0.0

    return (plain, check,
            f"B={ids.shape[0]} R={ids.shape[1]} T={len(widths)} "
            f"NP={len(phrases)} cand_cap={cand_cap} pmax={pmax}",
            lambda: work_phrase(*a[:8], *a[9:12], plain()[1]),
            lambda: cuda_ms(yard, reps=5), yard)


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
    remap = kw.get("remap")

    def plain():
        return kn._agg_buckets_plain(ids, elig, mode, codes, nb, subs, prev,
                                     size, want_codes, clamp, remap)

    def check(got, want):
        check_equal("agg_buckets counts", got[0], want[0])
        if want_codes:
            check_equal("agg_buckets codes", got[2], want[2])
        return check_stats("agg_buckets", got[1], want[1]) if subs else 0.0

    B, R = ids.shape
    n_val = sum(c is not None for c in subs)

    def work():
        # the eligible flag a row; per eligible row its docid (unless the
        # mask mode has no value sub to gather), then the code's column
        # bytes (the mask's byte in mask mode) and each value sub's fval and
        # flag, gathered from columns each read once at most; the counts
        # and statistics out. A nested level's codes, written for the next
        # level and read back by it, are the chain's own intermediates, not
        # the function's
        ne = n_true(elig)
        docid = 0 if mode == "mask" and not n_val else 4 * ne
        out = 4 * B * size * (1 + 5 * len(subs)) + \
            (4 * B * nb if mode == "trixels" else 0)
        b, ops = work_selected(B, R, 1, ne, CODE_BYTES[mode] + 5 * n_val,
                               out, _code_rows(mode, codes))
        return b + docid, ops

    flat = []

    def yard():
        # torch.bincount of each eligible row's (query, bucket) code, the
        # codes made beforehand: the counts, not the sub statistics
        import torch

        if not flat:
            code = kn._agg_buckets_plain(ids, elig, mode, codes, nb, (),
                                         prev, size, True)[2]
            f = code + size * torch.arange(B, device=ids.device)[:, None]
            flat.append(f[code >= 0])
        return torch.bincount(flat[0], minlength=B * size)

    def library():
        return cuda_ms(yard, reps=5)

    return (plain, check,
            f"B={B} R={R} {mode} nb={nb} size={size} subs={len(subs)}",
            work, library if mode not in ("terms", "missing") else None,
            yard)


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
        # interval); the counts and statistics out, and with want_member
        # the byte a (row, range) of membership
        keyed = mode in ("key", "geo_ip")
        per_sel = 4 + 1 + (16 if keyed else (8 if mode == "geodist" else 4))
        sel = n_true(elig)
        mv = 0
        if keyed and vmax > 1 and "mv_len" in col:
            d = ids[elig].clamp(max=col["mv_len"].shape[0] - 1).long()
            mv = 8 * int(col["mv_len"][d].sum())
        out = 4 * B * nb * (1 + 5 * len(subs)) + 5 * n_val * sel + \
            (B * R * nb if want_member else 0)
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

    flat = []

    def yard():
        # torch.bincount of each counted row's (query, bucket, bin) index,
        # made at the first call (the timers' warm-up)
        if not flat:
            d = ids.clamp(max=fval.shape[0] - 1).long()
            m = elig & present[d]
            vb = kn.value_bins(fval[d], params, nbins)
            if member is not None:
                bi, ri, ji = (member & m[:, :, None]).nonzero(as_tuple=True)
            else:
                c = torch.zeros_like(vb) if codes is None else codes.long()
                bi, ri = (m & (c >= 0) & (c < nb)).nonzero(as_tuple=True)
                ji = c[bi, ri]
            flat.append((bi * nb + ji) * nbins + vb[bi, ri])
        return torch.bincount(flat[0], minlength=B * nb * nbins)

    mode = "codes" if codes is not None else \
        ("member" if member is not None else "one")
    return (plain, check, f"B={B} R={R} {mode} nb={nb} bins={nbins}", work,
            lambda: cuda_ms(yard, reps=5), yard)


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

    sp = spans.cpu().tolist()

    def yard():
        # torch.searchsorted of every row's docid in each term's span
        for b in range(B):
            for off, ln in sp[b]:
                torch.searchsorted(post[off:off + ln], ids[b])

    return (plain, check, f"B={B} R={R} terms={nt} Lf={Lf}", work,
            lambda: cuda_ms(yard, reps=5), yard)


def goes_wide(name, a) -> bool:
    """Whether a call of the topk_rows or sort_topk wrapper with arguments
    a launches their wide mode (wide_topk.cu): topk_rows past MAX_TOPK,
    sort_topk past MAX_SORT_TOPK or MAX_SORT_WORDS key words."""
    from xapiand_tpu_torch.ops import kernels as kn

    if name == "topk_rows":
        return a[3] > kn.MAX_TOPK
    if name == "sort_topk":
        return a[4] > kn.MAX_SORT_TOPK or \
            sum(2 if sp[0] == "value" else 1 for sp in a[0]) + 2 > \
            kn.MAX_SORT_WORDS
    return False


def held_sort(a):
    """sort_topk over the dense path's rows (every doc a row)."""
    from xapiand_tpu_torch.ops import kernels as kn

    specs, ids, sums, elig, k, values = a[:6]
    targets = a[6] if len(a) > 6 else None
    strtabs = (a[7] if len(a) > 7 else None) or {}
    remaps = (a[8] if len(a) > 8 else None) or {}
    emit = a[9] if len(a) > 9 else False
    cols = [values.get(sp[1]) if sp[0] not in ("score", "docid") else None
            for sp in specs]
    # the calls the wrapper sends to wide_topk.cu keep its count
    wide = goes_wide("sort_topk", a)

    def check(got, want):
        check_equal("sort_topk docids", got[0], want[0])
        check_equal("sort_topk scores", got[1], want[1])
        if emit:
            check_equal("sort_topk keys", got[2], want[2])
        return 0.0

    # the docid key alone: torch.topk, timed after the block (device-only
    # too, the [device] line)
    yard = [docid_topk_call(ids, elig, k)] \
        if tuple(sp[0] for sp in specs) == ("docid",) else []
    return (lambda: kn._sort_topk_plain(specs, cols, ids, sums, elig, k,
                                        targets, strtabs, remaps, emit),
            check,
            f"B={ids.shape[0]} R={ids.shape[1]} k={k} keys="
            f"{'-'.join(sp[0] for sp in specs)}{' emit' if emit else ''}",
            lambda: (work_sort(specs, elig, k, n_rows(values)) if wide
                     else work_sort_topk(specs, elig, k, n_rows(values),
                                         emit)),
            *((lambda: cuda_ms(yard[0], reps=5), yard[0])
              if yard else (None,)))


def held_shard_merge(a):
    """shard_merge (K19): the mesh merge of S shards' top-k lists."""
    from xapiand_tpu_torch.ops import kernels as kn

    docids, scores = a[:2]
    okey = a[2] if len(a) > 2 else None
    skeys = a[3] if len(a) > 3 else None
    S, Q, k = docids.shape
    nu = skeys.shape[3] if skeys is not None else 0

    def check(got, want):
        check_equal("shard_merge docids", got[0], want[0])
        check_equal("shard_merge scores", got[1], want[1])
        return 0.0

    def work():
        # each candidate's docid, score and okey (or its key words) read
        # once, the k winners' docid and score written; a comparison
        # sort's M * ceil(log2 M) compares of the M = S * k candidates of
        # a query, a key word each, counted as operations
        n = S * Q * k
        nw = (nu or 1) + 2
        return (n * (8 + (4 if okey is not None else 0) + 4 * nu)
                + Q * k * 8, Q * S * k * log2c(S * k) * nw)

    def library():
        # torch.sort of the gathered candidates' packed 64-bit keys
        # (the score's order word and the tie key), stable; the keys made
        # at the first call
        import torch

        g = scores.permute(1, 0, 2).reshape(Q, S * k)
        key = (kn._fkey(-g) << 31) | (torch.arange(
            S * k, device=g.device).expand(Q, S * k))
        return lambda: torch.sort(key, dim=1, stable=True)

    yard = lazy_call(library)
    return (lambda: kn._shard_merge_plain(docids, scores, okey, skeys),
            check, f"S={S} Q={Q} k={k}{' okey' if okey is not None else ''}"
            f"{f' keys={nu}' if nu else ''}", work,
            lambda: cuda_ms(yard, reps=5), yard)


def held_shard_reduce(a):
    """shard_reduce (K19): psum / pmin / pmax over the shard axis; the
    yardstick torch.sum / amin / amax over the shards."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    x, rule = a[:2]

    def check(got, want):
        check_equal(f"shard_reduce {rule}", got, want)
        return 0.0

    def library():
        return cuda_ms(lambda: fn(x, 0), reps=5)

    S, n = x.shape[0], x[0].numel()
    fn = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}[rule]
    return (lambda: kn._shard_reduce_plain(x, rule), check,
            f"{rule} S={S} n={n}",
            lambda: (4 * S * n + 4 * n, S * n), library,
            lambda: fn(x, 0))


def held_semijoin(a):
    """semijoin_rows (K21c): a semijoin plan's drive rows, every other term
    probed; held bit for bit (the sums in JAX's order on both sides)."""
    from xapiand_tpu_torch.ops import kernels as kn

    post, offsets, lens, tconst, scoring, bits, classes, drive = a[:8]
    classes = tuple(int(c) for c in classes)
    B, T = offsets.shape
    S = classes[drive]

    def check(got, want):
        for nm, g, w in zip(("ids", "sums", "orbits", "first", "count"),
                            got, want):
            check_equal(f"semijoin_rows {nm}", g, w)
        return 0.0

    def work():
        # the real drive rows' docid, wdf and doclen read, every output
        # row's id, sum, orbits and flag written (the rows past the drive
        # term's length too: they are outputs); per probe the posting it
        # lands on (docid and wdf) and its rounds of compares plus the
        # weight
        n = int(lens[:, drive].clamp(max=S).sum())
        rounds = sum(max(classes[t].bit_length() - 1, 1) + 1
                     for t in range(T) if t != drive)
        return (12 * n + 13 * B * S + 8 * n * (T - 1) + 4 * B,
                n * (rounds + T * SCHEME_OPS[a[9].sid]))

    blocks = []

    def yard():
        # torch.searchsorted of the drive's docids in each probed block,
        # the blocks gathered beforehand (once)
        import torch

        if not blocks:
            n = post[0].shape[0]
            ar = torch.arange(S, device=offsets.device)
            start = offsets[:, drive].long().clamp(0, max(n - S, 0))
            blocks.append(post[0][(start[:, None] + ar).clamp(max=n - 1)]
                          .contiguous())
            for t in range(T):
                if t == drive:
                    continue
                al = torch.arange(classes[t], device=offsets.device)
                idx = (offsets[:, t:t + 1].long() + al).clamp(max=n - 1)
                blocks.append(torch.where(al < lens[:, t:t + 1],
                                          post[0][idx], kn.SENTINEL)
                              .contiguous())
        for blk in blocks[1:]:
            torch.searchsorted(blk, blocks[0])

    return (lambda: kn._semijoin_rows_plain(*a), check,
            f"B={B} S={S} T={T} drive={drive}", work,
            lambda: cuda_ms(yard, reps=5), yard)


def held_chunk_merge(a):
    """chunk_merge (K21a): the n_chunks * k finalists of each query."""
    from xapiand_tpu_torch.ops import kernels as kn

    docids, scores = a[:2]
    NC, Q, k = docids.shape

    def check(got, want):
        check_equal("chunk_merge docids", got[0], want[0])
        check_equal("chunk_merge scores", got[1], want[1])
        return 0.0

    def library():
        # torch.sort of the finalists' packed keys (the score's order word,
        # then the docid), stable; the keys made at the first call
        import torch

        g = scores.permute(1, 0, 2).reshape(Q, NC * k)
        gd = docids.permute(1, 0, 2).reshape(Q, NC * k)
        key = (kn._fkey(-g) << 31) | (kn._ikey(gd) >> 1)
        return lambda: torch.sort(key, dim=1, stable=True)

    yard = lazy_call(library)

    # each finalist's docid and score read once, the k winners written;
    # a comparison sort's M * ceil(log2 M) compares of the M = NC * k
    # finalists of a query, 3 key words each
    M = NC * k
    return (lambda: kn._shard_merge_plain(docids, scores, stripe=False),
            check, f"NC={NC} Q={Q} k={k}",
            lambda: (8 * M * Q + 8 * Q * k, Q * M * log2c(M) * 3),
            lambda: cuda_ms(yard, reps=5), yard)


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
            lambda: work_metrics(ids, elig, M,
                                 cols[0][0].shape[0] if cols else None),
            None)


# K20: every kmeans_cosine call is one launch of kernels.kmeans_loop, held
# step by step by its history (one more launch of the call with it, not
# counted; the same labels and centroids bit for bit): at each step the
# labels under the step's input centroids equal kmeans_step_plain's from
# the same centroids and float64 numpy's wherever the row's top-2 margin
# exceeds 2 gamma_V (ops/cluster.py label_margin_bound), and the next
# centroids lie within C_RTOL of the float64 update of the kernel's own
# labels, and of the plain step's where the labels agree; the last
# assignment likewise. The call's steps are then replayed by
# KMEANS_REPLICA from the same seeding.

C_RTOL = 1e-5
KMEANS = {"near": 0, "launches": 0, "calls": 0, "parted": 0,
          "replica_near": 0, "steps": 0}


def _update64(X64, labels, C, k):
    """One centroid update in float64: sums of each label's rows, each
    divided by its norm above 1e-6, else the old centroid."""
    import numpy as np

    S = np.zeros((k, X64.shape[1]))
    np.add.at(S, labels, X64)
    norms = np.linalg.norm(S, axis=1, keepdims=True)
    return np.where(norms > 1e-6, S / np.maximum(norms, 1e-6), C)


def _close(got, want):
    """|got - want| <= C_RTOL |want|, elementwise (zeros exact)."""
    import numpy as np

    return bool((np.abs(got - want) <= C_RTOL * np.abs(want)).all())


def kmeans_replica(X, steps):
    """The float64 replica of ops/cluster.py kmeans_cosine over one call's
    assignments (each step's input centroids and labels, then the last
    assignment's): the same numpy seeding (which must give the call's first
    centroids bit for bit), then per step the float64 labels against the
    kernel's wherever the margin exceeds label_margin_bound(V, dc), dc the
    distance between the two trajectories' centroids; the first step with
    a label inside the margin that differs parts the trajectories, and the
    steps after it are not compared."""
    import numpy as np

    from xapiand_tpu_torch.ops import cluster

    n, v = X.shape
    k = steps[0][0].shape[0]
    chosen = [0]
    sims_to_chosen = X @ X[0]
    for _ in range(k - 1):
        nxt = int(np.argmin(sims_to_chosen))
        chosen.append(nxt)
        sims_to_chosen = np.maximum(sims_to_chosen, X @ X[nxt])
    if not np.array_equal(X[chosen], steps[0][0]):
        raise AssertionError("kmeans: the seeding differs from the replica's")
    X64 = X.astype(np.float64)
    C = X64[chosen]
    for t, (c_port, l_port) in enumerate(steps):
        sims = X64 @ C.T
        lab = sims.argmax(axis=1)
        dc = float(np.linalg.norm(c_port - C, axis=1).max())
        near = cluster.near_ties(X64, C, dc)
        KMEANS["replica_near"] += int(near.sum())
        differ = lab != l_port
        if (differ & ~near).any():
            raise AssertionError(f"kmeans step {t}: {int(differ.sum())} "
                                 "labels differ from the float64 replica "
                                 "outside the margin")
        if differ.any():
            KMEANS["parted"] += 1
            return
        C = _update64(X64, lab, C, k)


def work_kmeans(n, v, k, iters, assign_last):
    """kmeans, a kmeans_cosine call: X and C0 read once, the labels and C
    written once; each step's products, sums and norms (2nVk + nV + 3kV
    operations), and the last assignment's products."""
    return (4 * (n * v + 2 * k * v + n),
            iters * (2 * n * v * k + n * v + 3 * k * v) +
            (2 * n * v * k if assign_last else 0))


def held_kmeans(a, assign_last=True, history=False):
    import numpy as np
    import torch

    from xapiand_tpu_torch.ops import cluster
    from xapiand_tpu_torch.ops import kernels as kn

    X, C0, iters = a[0], a[1], int(a[2])
    if len(a) > 3:
        assign_last = bool(a[3])
    n, v = X.shape
    k = C0.shape[0]
    tag = f"kmeans n{n} V{v} k{k} iters{iters}"

    def check(got, want):
        with uncounted():
            l_h, c_h, (hl, hc) = unwrapped(kn.kmeans_loop)(
                X, C0, iters, assign_last, history=True)
        if not torch.equal(l_h, got[0]) or \
                not torch.equal(c_h.view(torch.int32),
                                got[1].view(torch.int32)):
            raise AssertionError(f"{tag}: the history changed the result")
        Xh = X.cpu().numpy()
        X64 = Xh.astype(np.float64)
        hl, hc = hl.cpu().numpy(), hc.cpu().numpy()
        gl, gc = got[0].cpu().numpy(), got[1].cpu().numpy()
        if iters and not np.array_equal(hc[0], C0.cpu().numpy()):
            raise AssertionError(f"{tag}: history C[0] is not C0")
        steps = [(hc[t], hl[t]) for t in range(iters)] + \
            ([(gc, gl)] if assign_last else [])
        nexts = [hc[t + 1] for t in range(iters - 1)] + [gc]
        err = 0.0
        for t, (Ch, lab) in enumerate(steps):
            upd = t < iters
            wl, wc = kn.kmeans_step_plain(X, torch.from_numpy(Ch).to(
                X.device), upd)
            wl = wl.cpu().numpy()
            near = cluster.near_ties(X64, Ch)
            lab64 = (X64 @ Ch.astype(np.float64).T).argmax(axis=1)
            if ((lab != wl) & ~near).any() or ((lab != lab64) & ~near).any():
                raise AssertionError(f"{tag} step {t}: labels differ "
                                     "outside the margin")
            KMEANS["near"] += int(near.sum())
            if not upd:
                continue
            if not _close(nexts[t], _update64(X64, lab, Ch.astype(np.float64),
                                              k)):
                raise AssertionError(f"{tag} step {t}: centroids beyond "
                                     f"rtol {C_RTOL} of float64")
            if np.array_equal(lab, wl):
                wc = wc.cpu().numpy()
                if not _close(nexts[t], wc):
                    raise AssertionError(f"{tag} step {t}: centroids beyond "
                                         "rtol of the plain version")
                err = max(err, float(np.abs(nexts[t] - wc).max()))
        KMEANS["launches"] += 1
        KMEANS["calls"] += 1
        KMEANS["steps"] += len(steps)
        kmeans_replica(Xh, steps)
        return err

    return (lambda: kn.kmeans_loop_plain(X, C0, iters, assign_last), check,
            f"n{n} V{v} k{k} iters{iters}" +
            ("" if assign_last else " no last"),
            lambda: work_kmeans(n, v, k, iters, assign_last), None)


HELD = {"collapse_rows": held_collapse, "dense_rows": held_dense,
        "merge_special": held_special, "agg_distinct": held_distinct,
        "topk_rows": held_topk, "sort_topk": held_sort,
        "agg_metrics": held_metrics, "score_slices": held_slices,
        "merge_docs": held_merge, "compact_rows": held_compact,
        "filter_leaves": held_filter, "geo_leaves": held_geo,
        "phrase_leaves": held_phrase,
        "agg_buckets": held_buckets, "prefix_certify": held_certify,
        "agg_ranges": held_ranges, "agg_hist": held_hist,
        "agg_filter": held_afilter, "kmeans": held_kmeans,
        "shard_merge": held_shard_merge, "shard_reduce": held_shard_reduce,
        "semijoin_rows": held_semijoin, "chunk_merge": held_chunk_merge,
        "fullwidth_topk": held_fullwidth}

# the port's wrapper Held and capture hold for a kernel where it is not the
# kernel's own name: kmeans_cosine calls kmeans_loop (kernels.kmeans, one
# step, calls it too)
WRAPPERS = {"kmeans": "kmeans_loop"}
# the module of xapiand_tpu_torch.ops that holds a kernel's wrapper, where
# it is not ops/kernels.py
WRAPPER_HOMES = {"phrase_leaves": "phrase"}


def wrapper_home(name):
    """-> (the module holding the wrapper of kernel ``name``, the
    wrapper's attribute there)."""
    import importlib

    mod = importlib.import_module(
        "xapiand_tpu_torch.ops." + WRAPPER_HOMES.get(name, "kernels"))
    return mod, WRAPPERS.get(name, name)

# python3 chip_smoke.py --capture DIR: the launches tools/sort_pairs.py
# replays, by their HELD keys or the start of them up to a space (the
# first launch of each), or by a pattern the whole key matches, alone or
# after the tag of the Held block the launch must come in (a tag None:
# outside every Held block) (the widest launch that matches, the most
# rows; an entry None: the kernel's widest launch), as the paths make
# them
CAPTURE = {
    "score_slices": ("B=1 R=2105472 T=4",        # browse C
                     "B=36 R=3670144 T=4",       # mesh
                     "B=16 R=4194304 T=4",       # browse
                     "B=64 R=1310720 T=2",       # faceted A
                     "B=8 R=184448 T=128",       # geo
                     "B=64 R=25728 T=128",       # geo aggregations
                     "B=64 R=17536 T=4",         # relevance prefix
                     "B=256 R=896 T=4"),         # relevance exact
    "merge_docs": ("B=1 R=2105472 T=4", "B=36 R=3670144 T=4",
                   "B=16 R=4194304 T=4", "B=64 R=1310720 T=2",
                   "B=8 R=184448 T=128", "B=64 R=25728 T=128",
                   "B=64 R=17536 T=4", "B=256 R=896 T=4",
                   # merge_plan's border: relevance's exact re-run, faceted
                   # B, D and the AND_NOT family, positional, K21 chunked,
                   # REST mesh
                   "B=64 R=148608 T=4", "B=128 R=65536 T=2",
                   "B=128 R=131072 T=2", "B=32 R=1835136 T=4",
                   "B=64 R=98432 T=4", "B=64 R=393344 T=4",
                   "B=64 R=65536 T=2", "B=1024 R=7040 T=3",
                   "B=32 R=12416 T=4"),
    "shard_reduce": ("sum S=8 n=6153",     # REST mesh
                     "sum S=8 n=36",       # mesh
                     "min S=8 n=64", "max S=8 n=64"),
    "sort_topk": ("B=8 R=184448 k=10 keys=docid",      # geo
                  "B=8 R=312960 k=10 keys=docid",      # geo
                  "B=32 R=1000001 k=10 keys=docid",    # browse N
                  "B=64 R=1000001 k=10 keys=docid",    # browse N
                  "B=1 R=1000001 k=10 keys=value",     # browse C
                  "B=256 R=1000001 k=10 keys=value",   # browse M
                  "B=64 R=131072 k=10 keys=value",     # faceted B
                  "B=64 R=262144 k=10 keys=value",     # faceted A, off
                  "B=1 R=3127 k=10 keys=docid"),       # REST mesh
    "semijoin_rows": None,
    "agg_filter": None,
    # positional's launch groups (pmax 8 at R65536, 16 past it); geo's two
    # widths and its aggregation run
    "phrase_leaves": ("B=64 R=65536", "B=64 R=262144", "B=64 R=196736",
                      "B=64 R=393344"),
    "geo_leaves": ("B=8 R=184448", "B=8 R=312960", "B=64 R=25728"),
    # browse S and X at B16 and B32, the schemes' S under TfIdf (sid 2,
    # B64) and X under PL2 (sid 10); no path makes a sparse launch (the
    # probes are held on the card by tests/test_torch_cuda.py)
    "merge_special": ("syn sid=0 B=16 R=4194304", "max sid=0 B=16 R=4194304",
                      "syn sid=0 B=32 R=2097152", "max sid=0 B=32 R=2097152",
                      "syn sid=2", "max sid=10"),
    # kmeans_cosine calls: the _cluster _k 3 searches (V 1,024-1,360), the
    # _k 8 ones, cluster_hits
    "kmeans": ("n10", "n256 V2048 k8", "n4096 V2048 k16"),
    # browse C (its collapse on the category), the dense plans' rows, the
    # REST mesh's and the join path's one-query launches
    "collapse_rows": ("B=1 R=2359424 max=3", "B=1 R=1312896 max=1",
                      "B=1 R=1312896 max=3", "B=1 R=1000001 max=1",
                      "B=1 R=1000001 max=8", "B=1 R=139392 max=1",
                      re.compile(r"B=1 R=57472 max=1 (tiles|global).*"),
                      re.compile(r"B=1 R=57472 max=1 row order .*")),
    # the widest launch of each: faceted A (B64) and D (B32) terms without
    # subs and with them, browse M's 64 buckets, the geo aggregations, the
    # Database path's trixels and its nested level of 144 buckets, the REST
    # mesh's histogram with a sub; the K21 join's and semijoin's count-only
    # launches (faceted A's shape)
    "agg_buckets": (re.compile(r"B=64 R=\d+ terms nb=\d+ size=\d+ subs=0"),
                    re.compile(r"B=64 R=\d+ terms nb=\d+ size=\d+ subs=1"),
                    re.compile(r"B=64 R=\d+ terms nb=\d+ size=\d+ subs=3"),
                    re.compile(r"B=32 R=\d+ terms nb=\d+ size=\d+ subs=0"),
                    re.compile(r"B=32 R=\d+ terms nb=\d+ size=\d+ subs=1"),
                    re.compile(r"B=256 R=1000001 .* nb=64 .*"),
                    re.compile(r"B=64 R=25728 .*"),
                    re.compile(r"B=1 R=\d+ trixels nb=4096 .*"),
                    re.compile(r"B=1 R=\d+ \w+ nb=\d+ size=144 .*"),
                    re.compile(r"B=1 R=57472 histogram .* subs=1"),
                    ("k21 join", re.compile(r"B=64 R=\d+ terms .* subs=0")),
                    ("k21 semijoin",
                     re.compile(r"B=64 R=\d+ terms .* subs=0"))),
    # geo's two widths and its aggregation run, positional over the PH
    # bits, browse M (dense, one F leaf), N and C (the widest of its
    # one-query calls), faceted B at its cap (packed rows, base None) and C
    "filter_leaves": ("B=8 R=184448", "B=8 R=312960", "B=64 R=25728",
                      "B=64 R=262144", "B=256 R=1000001", "B=64 R=1000001",
                      ("browse", re.compile(r"B=1 R=\d+ .*")),
                      re.compile(r"B=\d+ R=131072 F=\d+ base=False .*"),
                      "B=64 R=1048576"),
    # browse M and the geo aggregations
    "agg_distinct": ("B=256 R=1000001", "B=64 R=25728"),
    # faceted A and D (fullwidth), the geo aggregations' geo_stats; the
    # Database path's one-query launches by their channels (the count
    # alone, a metric spec, geo_stats' two, three or more)
    "agg_metrics": (re.compile(r"B=64 R=1310720 .*"),
                    re.compile(r"B=32 R=1835136 .*"), "B=64 R=25728",
                    ("database", re.compile(r"B=1 R=\d+ metrics=0")),
                    ("database", re.compile(r"B=1 R=\d+ metrics=1")),
                    ("database", re.compile(r"B=1 R=\d+ metrics=2")),
                    ("database", re.compile(r"B=1 R=\d+ metrics=[3-8]"))),
    # the Database path's one-query launches, by mode: R's balance ranges
    # with a _stats sub, I's _ip_range (key) with a _sum sub and _geo_ip,
    # G's _geo_distance ranges; each without subs and with them
    "agg_ranges": tuple(("database", re.compile(
        rf"B=1 R=\d+ {m} .* subs={s}")) for m in
        ("range", "geodist", "key", "geo_ip") for s in ("0", "[1-9]")),
    # the Database path's top-level histograms (_median, _mode,
    # _percentiles), N's hist2 by agg_buckets' codes, a geo_ip median's by
    # agg_ranges' member matrix
    "agg_hist": tuple(("database", re.compile(rf"B=1 R=\d+ {m} .*"))
                      for m in ("one", "codes", "member")),
    # the wide mode of topk_rows and sort_topk (their calls past MAX_TOPK,
    # MAX_SORT_TOPK or MAX_SORT_WORDS, saved under wide_topk): the REST
    # mesh's pages of 300 (the widest, and the widest of under 10,000
    # rows), its sorted collapses of k 80 (likewise) and the key-word
    # table's sort
    "wide_topk": (("rest mesh", re.compile(r"B=\d+ R=\d+ k=\d+")),
                  ("rest mesh", re.compile(r"B=\d+ R=\d{1,4} k=\d+")),
                  ("rest mesh", re.compile(r"B=\d+ R=\d+ k=\d+ keys=.*")),
                  ("rest mesh",
                   re.compile(r"B=\d+ R=\d{1,4} k=\d+ keys=.*")),
                  re.compile(rf"B={WIDE_TABLE_B} R={WIDE_TABLE_R} k=\d+ "
                             r"keys=.*")),
    # faceted A's fullwidth launches (XT_FULLWIDTH=1): the widest and the
    # two narrower groups
    "fullwidth_topk": ("B=64 R=1310720 k=10", "B=64 R=131072 k=10",
                       "B=128 R=65536 k=10"),
    # faceted A at XT_FULLWIDTH=0 (caps 262144, 65536) and B's
    # precompaction (cap 131072; B=128 R=65536 cap=32768 is A's and B's)
    "compact_rows": ("B=64 R=1310720 cap=262144", "B=64 R=1310720 cap=131072",
                     "B=128 R=65536 cap=32768", "B=64 R=131072 cap=65536"),
    # the mesh's sub-batches of 36 queries; the REST mesh's widest merge
    # with order keys
    "shard_merge": ("S=8 Q=36 k=10",
                    ("rest mesh", re.compile(r"S=\d+ Q=\d+ k=\d+ okey.*"))),
    # K21's chunked relevance ORs (16 chunks of 1,024 rows)
    "chunk_merge": ("NC=16 Q=64 k=10",),
    # the relevance path's prefix groups (outside any Held block: tag
    # None), the schemes path's BM25Plus prefix launch
    "prefix_certify": ((None, re.compile(r"B=64 K=\d+ T=\d+")),
                       ("schemes bm25plus",
                        re.compile(r"B=\d+ K=\d+ T=\d+")))}
# the wrappers whose wide mode CAPTURE's wide_topk entries take
WIDE_WRAPPERS = ("topk_rows", "sort_topk")
# the launches that matched each CAPTURE pattern, by (kernel, index): how
# often a path makes each captured shape (logged by an --only run)
CAPTURED: dict = {}
# the tags of the Held blocks open, innermost last
HELD_TAGS: list = []


def capture(dirname):
    """From here on, the CAPTURE launches' arguments are saved to dirname
    (torch.save: the tensors stay on their device), one file a launch,
    {"name", "key", "tag", "args", "kw"}: the first launch of a listed key,
    or the widest so far. The hook sits under Held's, and saves after the
    launch returns, so the counts and answers are the run's own; the
    saving's time falls in whatever block timed the launch, so a capturing
    run's times are not kept."""
    import torch

    os.makedirs(dirname, exist_ok=True)
    done, widest = set(), {}

    def compact(x):
        # a view (a shard of the mesh's stacked arrays) saved alone
        if isinstance(x, torch.Tensor):
            return x.clone() if x.untyped_storage().nbytes() > \
                x.numel() * x.element_size() else x
        if isinstance(x, (tuple, list)):
            return type(x)(compact(v) for v in x)
        if isinstance(x, dict):
            return {k: compact(v) for k, v in x.items()}
        return x

    def save(name, key, args, kw, file):
        # the Held block's tag the launch came in (None outside one)
        tag = HELD_TAGS[-1] if HELD_TAGS else None
        torch.save({"name": name, "key": key, "tag": tag,
                    "args": compact(args), "kw": compact(kw)},
                   os.path.join(dirname, file))
        log(f"[capture] {name} {key}{f' ({tag})' if tag else ''}")

    def hook(name, fn):
        def call(*args, **kw):
            got = fn(*args, **kw)
            # a wrapper's wide mode is saved under wide_topk (the record's
            # name stays the wrapper's, which tools/sort_pairs.py calls)
            kname = "wide_topk" if goes_wide(name, args) else name
            if kname not in CAPTURE:
                return got
            key = HELD[name](args, **kw)[2]
            if CAPTURE[kname] is None:
                # agg_filter's rows, semijoin_rows' B x S
                rows = args[0].numel() if name == "agg_filter" else \
                    args[1].shape[0] * int(args[6][args[7]])
                if rows > widest.get(name, 0):
                    widest[name] = rows
                    save(name, key, args, kw, f"{name} widest.pt")
            else:
                for i, p in enumerate(CAPTURE[kname]):
                    if isinstance(p, tuple):
                        tag, p = p
                        if HELD_TAGS[-1:] != ([tag] if tag else []):
                            continue
                    if isinstance(p, re.Pattern):
                        if p.fullmatch(key):
                            CAPTURED[(kname, i)] = \
                                CAPTURED.get((kname, i), 0) + 1
                        # the rows of the first tensor argument (ids
                        # i32[B,R] of collapse_rows, agg_buckets, the
                        # leaves), filter_leaves' docids
                        rows = (args[4] if name == "filter_leaves" else
                                next(x for x in args if isinstance(
                                    x, torch.Tensor))).numel() \
                            if p.fullmatch(key) else 0
                        if rows > widest.get((kname, i), 0):
                            widest[(kname, i)] = rows
                            save(name, key, args, kw,
                                 f"{kname} pattern{i} widest.pt")
                    elif key == p or key.startswith(p + " "):
                        if (kname, p) not in done:
                            done.add((kname, p))
                            save(name, key, args, kw, f"{kname} {key}.pt")
                        break
            return got

        call.__wrapped__ = fn
        return call

    for name in {n for n in CAPTURE if n != "wide_topk"} | \
            set(WIDE_WRAPPERS if "wide_topk" in CAPTURE else ()):
        mod, attr = wrapper_home(name)
        setattr(mod, attr, hook(name, getattr(mod, attr)))


class Held:
    """Inside the block, every call the port makes to one of ``names`` (a
    wrapper of ops/kernels.py) is held against the kernel's plain version
    on the call's own tensors: the kernel is launched twice (bit for bit
    the same) and compared, and the call returns the kernel's result, so
    the run goes on as the port runs it. After the block each kernel is
    timed at its widest launch (the most bytes of its bound), beside the
    plain version, its bound and its library yardstick; where HELD gives
    the yardstick's call (agg_filter, semijoin_rows, sort_topk on the docid
    key), a [device] line beside it reads both on the device alone
    (device_ms). ``calls`` counts
    the calls held, per kernel, and ``nonzero`` the nonzero floats the
    kernel returned over them."""

    def __init__(self, rec, tag, names, exact=False, counted=False):
        """exact: every float the kernel returns must be the plain
        version's, bit for bit (max abs err 0.0); counted: the block is the
        path's counted run, so ops/kernels.py's launch counts keep one
        launch a call, the path's own, and none of the comparison's second
        launch or the timing's."""
        self.rec, self.tag, self.exact = rec, tag, exact
        self.counted = counted
        self.calls = {n: 0 for n in names}
        self.nonzero = {n: 0 for n in names}
        self.widest: dict = {}
        self.saved: dict = {}

    def __enter__(self):
        for name in self.calls:
            mod, attr = wrapper_home(name)
            self.saved[name] = getattr(mod, attr)
            setattr(mod, attr, self.hold(name, self.saved[name]))
        HELD_TAGS.append(self.tag)
        return self

    def __exit__(self, *exc):
        from xapiand_tpu_torch.ops import kernels as kn

        for name, fn in self.saved.items():
            mod, attr = wrapper_home(name)
            setattr(mod, attr, fn)
        HELD_TAGS.pop()
        counts = dict(kn.launches)
        if exc[0] is None:
            for name, (_b, err, key, run, plain, work, library, yard) in \
                    self.widest.items():
                self.rec.note(name, err, cuda_ms(run, reps=5),
                              cuda_ms(plain, reps=2), work,
                              library() if library else None)
                self.rec.flush(f"{self.tag} widest {key}")
                if yard:
                    log(f"[device] {self.tag} {name} widest {key}: "
                        f"device-only ms a call (torch.profiler) kernel "
                        f"{device_ms(run)}, library {device_ms(yard[0])}")
        if self.counted:
            kn.launches.update(counts)
        self.widest.clear()

    def hold(self, name, kernel):
        def held(*args, **kw):
            from xapiand_tpu_torch.ops import kernels as kn

            plain, check, key, work, library, *yard = HELD[name](args,
                                                                  **kw)
            before = dict(kn.launches)
            got = twice(name, lambda: kernel(*args, **kw))
            # the wrapper may have launched its wide mode (wide_topk.cu):
            # the call is held, and timed, under the kernel it launched
            ran = [n for n in kn.launches if kn.launches[n] > before[n]]
            name_ = ran[0] if len(ran) == 1 else name
            if self.counted:
                for n in ran:   # the comparison's launch
                    kn.launches[n] -= (kn.launches[n] - before[n]) // 2
            self.calls.setdefault(name_, 0)
            self.nonzero.setdefault(name_, 0)
            want = plain()
            err = check(got, want)
            if self.exact and err != 0.0:
                raise AssertionError(
                    f"{name_} {self.tag}: kernel vs plain max abs err {err}, "
                    f"{max_ulps(got, want)} ulps at most")
            self.calls[name_] += 1
            self.nonzero[name_] += sum(int(x.count_nonzero())
                                       for x in leaves(got)
                                       if x.is_floating_point())
            w = work()
            if name_ in SHAPE_KERNELS and key not in self.rec.shapes[name_]:
                # this launch shape's times, once: none of its launches
                # count
                saved = dict(kn.launches)
                self.rec.shape(name_, key, self.tag,
                               cuda_ms(lambda: kernel(*args, **kw), reps=5),
                               cuda_ms(plain, reps=2), w,
                               library() if library else None)
                kn.launches.update(saved)
            best = self.widest.get(name_)
            err = max(err, best[1] if best else 0.0)
            if best is None or w[0] > best[0]:
                self.widest[name_] = (w[0], err, key,
                                      lambda: kernel(*args, **kw), plain, w,
                                      library, yard)
            else:
                self.widest[name_] = best[:1] + (err,) + best[2:]
            return got

        held.__wrapped__ = kernel
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
    SPECIAL["other"] = 0
    with Held(rec, "browse", BROWSE_KERNELS) as held:
        run_all()
    torch.cuda.empty_cache()
    log(f"[kernels] browse: every launch equal to its plain version, the "
        f"kernels twice bit for bit: {held.calls} launches held, each "
        f"kernel timed at its widest ({time.time() - t0:.1f} s); "
        f"merge_special's other design held bit for bit at "
        f"{SPECIAL['other']} calls")
    if not all(held.calls.values()):
        raise AssertionError(f"a browse kernel was never held: {held.calls}")
    if SPECIAL["other"] != held.calls["merge_special"]:
        raise AssertionError(f"merge_special: the other design held at "
                             f"{SPECIAL['other']} of "
                             f"{held.calls['merge_special']} calls")

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
    want = forked_answers(sb.oracle_answers, corpus, qs, K, ORACLE_RTOL)
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


def catalogue_errors(corpus, items, scheme, fst, fuq) -> list:
    """Each (query, result) of the schemes catalogue against
    synth_schemes' float64 oracle: None, or what differs."""
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.utils import synth_schemes as ss

    want = ss.catalogue_answers(corpus, [q for q, _r in items], scheme,
                                fst, fuq)
    out = []
    for ((fam, _q, p), r), w in zip(items, want):
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
        out.append(err)
    return out


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

    seg, searcher, drawn = rel_world[:3]
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
        SPECIAL["other"] = 0
        with Held(rec, f"schemes catalogue {label}", names,
                  exact=True) as held:
            run()
        torch.cuda.synchronize()
        t1 = time.time()
        if not all(held.calls.values()) or \
                SPECIAL["other"] != held.calls.get("merge_special", 0) or \
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
        # the oracle's answers hold float64 scores over every matched doc,
        # too large to send back from a worker: each worker checks its
        # share and sends back the verdicts
        errs = forked_answers(catalogue_errors, corpus,
                              [(qs[i], r) for i, r in zip(idx, results)],
                              scheme, fst, fuq)
        bad = [(i, err) for i, err in zip(idx, errs) if err]
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


# the K21 phase's chunk_rows: the largest power of two at which at least
# half of the relevance ORs run chunked (their groups' rows decide it: at
# 2048-16384 only the 229 queries of the widest groups chunk; PERF.md
# section 5)
CHUNK_ROWS = 1024
# warm runs of each K21 mode's QPS and its default's (information only)
K21_RUNS = 5
K21_CHUNKED = ("score_slices", "merge_docs", "topk_rows", "chunk_merge",
               "shard_reduce")
K21_SEMIJOIN = ("semijoin_rows", "filter_leaves", "sort_topk", "agg_metrics",
                "agg_buckets")
K21_JOIN = ("score_slices", "merge_docs", "topk_rows", "sort_topk",
            "agg_metrics", "agg_buckets")


def join_searcher(*a, **kw):
    """A BatchSearcher whose launch groups run as join plans: join=True set
    on each planned group (dataclasses.replace, as a test sets it; no
    planner chooses a join)."""
    import dataclasses

    from xapiand_tpu_torch.search import BatchSearcher

    class JoinSearcher(BatchSearcher):
        def plan(self, irs, stats=None):
            out = []
            for cfg, _fn, batch, chunk in super().plan(irs, stats=stats):
                cfg = dataclasses.replace(cfg, join=True)
                out.append((cfg, self.searcher.batched(cfg, self.scheme),
                            batch, chunk))
            return out

    return JoinSearcher(*a, **kw)


def k21_path(dev, rec, smi, rel_world, corpus, fac_searcher,
             fac_gate) -> dict:
    """Slice 11: the three other executors of the JAX package (K21) on the
    relevance path's and the faceted path's worlds - docid-chunked
    relevance ORs (BatchSearcher chunk_rows), semijoin faceted ANDs (the
    pinned planner's SEMIJOIN_RATIO at 1 for the phase) and join plans
    (relevance exact groups and faceted A) - each held launch by launch,
    counted, held to the paths' float64 oracles, and timed beside the
    default path on the same queries. -> the launch counts of its counted
    runs."""
    import numpy as np
    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.query import plan as pplan
    from xapiand_tpu_torch.query.ir import Q
    from xapiand_tpu_torch.search import BatchSearcher
    from xapiand_tpu_torch.utils import synth_faceted as sf

    seg, searcher, drawn, oracle = rel_world
    qs_f, want_f, specs, arrays = fac_gate
    queries = drawn[:N_QUERIES]
    irs = [Q.or_terms(q) for q in queries]
    stats = default_stats(seg)
    fstats = default_stats(corpus.seg)
    counts = {n: 0 for n in kn.launches}

    def counted(run, names, what):
        kn.reset_launches()
        out = run()
        torch.cuda.synchronize()
        for n, c in kn.launches.items():
            counts[n] += c
        log(f"[main] k21 {what} launches {dict(kn.launches)}")
        if not all(kn.launches[n] for n in names):
            raise AssertionError(f"k21 {what}: a kernel never launched")
        return out

    def relevance_gate(results, what):
        bad = [qi for qi, (r, e) in enumerate(zip(results, oracle))
               if not tie_group_match(r["docids"], r["scores"], e, K)]
        log(f"[parity] k21 {what}: {N_QUERIES - len(bad)}/{N_QUERIES} match "
            f"the float64 oracle as tie groups, rtol {ORACLE_RTOL}")
        if bad:
            r = results[bad[0]]
            raise AssertionError(
                f"k21 {what}: {len(bad)} queries differ; first {bad[0]}: "
                f"{list(zip(r['docids'].tolist(), r['scores'].tolist()))} "
                f"want {oracle[bad[0]][:K]}")

    # 1. docid-chunked relevance ORs
    t0 = time.time()
    bs_c = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH, prefix_cap=0,
                         chunk_rows=CHUNK_ROWS)
    planned = bs_c.plan(irs, stats=stats)
    n_eng = len({qi for c, _f, _b, ch in planned if c.n_chunks > 1
                 for qi in ch})
    log(f"[plan] k21 chunked: CHUNK_ROWS = {CHUNK_ROWS}, {n_eng}/"
        f"{N_QUERIES} queries chunked; groups (R, n_chunks, chunk_classes, "
        f"B): {[(sum(c.classes), c.n_chunks, c.chunk_classes, int(b['offsets'].shape[0])) for c, _f, b, _ch in planned]}")
    if not n_eng:
        raise AssertionError("k21 chunked: chunking never engaged")
    if 2 * n_eng < N_QUERIES:
        raise AssertionError(f"k21 chunked: {n_eng}/{N_QUERIES} queries "
                             f"chunked, fewer than half")
    with Held(rec, "k21 chunked", K21_CHUNKED, exact=True) as held:
        bs_c.run(irs, stats=stats)
    torch.cuda.synchronize()
    log(f"[held] k21 chunked: {held.calls} launches held bit for bit")
    chunked = counted(lambda: bs_c.run(irs, stats=stats), K21_CHUNKED,
                      "chunked")
    relevance_gate(chunked, "chunked")
    bs_x = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH, prefix_cap=0)
    exact = bs_x.run(irs, stats=stats)
    torch.cuda.synchronize()
    diff = [qi for qi, (a, b) in enumerate(zip(chunked, exact))
            if a["count"] != b["count"] or
            a["docids"].tolist() != b["docids"].tolist() or
            not np.array_equal(a["scores"], b["scores"])]
    log(f"[parity] k21 chunked: {N_QUERIES - len(diff)}/{N_QUERIES} equal "
        f"to the unchunked exact run (counts, docids, scores bit for bit)")
    if diff:
        raise AssertionError(f"k21 chunked: {len(diff)} differ from the "
                             f"unchunked run; first {diff[0]}")
    bs_d = BatchSearcher(searcher, k=K, max_batch=MAX_BATCH,
                         prefix_cap=PREFIX_CAP)
    # the schemes path left other schemes' impact mirrors on the segment:
    # BM25's is rebuilt here, not inside the timed runs
    bs_d.run(irs, stats=stats)
    qps = {m: timed_runs([(b, irs)], stats, N_QUERIES, smi,
                         f"k21 relevance {m}", profiled=False,
                         n_runs=K21_RUNS)
           for m, b in (("chunked", bs_c), ("exact", bs_x),
                        ("default", bs_d))}
    log(f"[time] k21 chunked: {time.time() - t0:.1f} s")

    # 2. semijoin: faceted A and B with the pinned planner's ratio at 1
    t0 = time.time()
    ab = [i for i, (f, _q, _p) in enumerate(qs_f) if f in "AB"]
    ab_irs = [qs_f[i][1] for i in ab]
    ncat = len(corpus.cat_names)

    def fac_bs(cls=BatchSearcher):
        return cls(fac_searcher, k=K, max_batch=MAX_BATCH,
                   prefix_cap=PREFIX_CAP, sort=sf.PRICE_DESC,
                   aggs=(specs, arrays))

    saved = pplan.SEMIJOIN_RATIO
    pplan.SEMIJOIN_RATIO = 1
    try:
        bs_s = fac_bs()
        planned = bs_s.plan(ab_irs, stats=fstats)
        drive = {qi for c, _f, _b, ch in planned if c.drive >= 0
                 for qi in ch}
        n_a = sum(1 for i in ab if qs_f[i][0] == "A")
        a_drive = sum(1 for j, i in enumerate(ab)
                      if qs_f[i][0] == "A" and j in drive)
        log(f"[plan] k21 semijoin: {len(drive)}/{len(ab)} A+B plans take "
            f"drive >= 0 (A {a_drive}/{n_a}); groups (drive, classes, B): "
            f"{[(c.drive, c.classes, int(b['offsets'].shape[0])) for c, _f, b, _ch in planned]}")
        if a_drive != n_a:
            raise AssertionError("k21 semijoin: an A query is not a semijoin")
        with Held(rec, "k21 semijoin", K21_SEMIJOIN) as held:
            bs_s.run(ab_irs, stats=fstats)
        torch.cuda.synchronize()
        log(f"[held] k21 semijoin: {held.calls} launches held "
            f"(semijoin_rows bit for bit)")
        semi = counted(lambda: bs_s.run(ab_irs, stats=fstats), K21_SEMIJOIN,
                       "semijoin")
        faceted_parity([qs_f[i] for i in ab], semi, [want_f[i] for i in ab],
                       ncat, "k21 semijoin")
        qps["semijoin"] = timed_runs([(bs_s, ab_irs)], fstats, len(ab), smi,
                                     "k21 faceted A+B semijoin",
                                     profiled=False, n_runs=K21_RUNS)
    finally:
        pplan.SEMIJOIN_RATIO = saved
    qps["faceted A+B default"] = timed_runs(
        [(fac_bs(), ab_irs)], fstats, len(ab), smi,
        "k21 faceted A+B default", profiled=False, n_runs=K21_RUNS)
    log(f"[time] k21 semijoin: {time.time() - t0:.1f} s")

    # 3. join: the relevance exact groups and faceted A
    t0 = time.time()
    a_idx = [i for i in ab if qs_f[i][0] == "A"]
    a_irs = [qs_f[i][1] for i in a_idx]
    bs_j = join_searcher(searcher, k=K, max_batch=MAX_BATCH, prefix_cap=0)
    bs_ja = fac_bs(join_searcher)
    if not all(c.join for c, *_x in bs_j.plan(irs, stats=stats)):
        raise AssertionError("k21 join: a group is not a join")
    with Held(rec, "k21 join", K21_JOIN) as held:
        bs_j.run(irs, stats=stats)
        bs_ja.run(a_irs, stats=fstats)
    torch.cuda.synchronize()
    log(f"[held] k21 join: {held.calls} launches held")

    def join_run():
        return bs_j.run(irs, stats=stats), bs_ja.run(a_irs, stats=fstats)

    joined, joined_a = counted(join_run, K21_JOIN, "join")
    relevance_gate(joined, "join relevance")
    faceted_parity([qs_f[i] for i in a_idx], joined_a,
                   [want_f[i] for i in a_idx], ncat, "k21 join faceted A")
    qps["join relevance"] = timed_runs([(bs_j, irs)], stats, N_QUERIES, smi,
                                       "k21 relevance join", profiled=False,
                                       n_runs=K21_RUNS)
    qps["join faceted A"] = timed_runs([(bs_ja, a_irs)], fstats, len(a_irs),
                                       smi, "k21 faceted A join",
                                       profiled=False, n_runs=K21_RUNS)
    qps["faceted A default"] = timed_runs([(fac_bs(), a_irs)], fstats,
                                          len(a_irs), smi,
                                          "k21 faceted A default",
                                          profiled=False, n_runs=K21_RUNS)
    log(f"[time] k21 join: {time.time() - t0:.1f} s")
    log(f"[qps] k21 modes beside the default path on the same queries "
        f"(information, no default changes): {qps}")
    return counts


def default_stats(seg):
    """The stats BatchSearcher takes by default for a segment."""
    from xapiand_tpu_torch.models.weights import CollectionStats

    return CollectionStats(doc_count=seg.doc_count,
                           avg_doclen=seg.avg_doclen, doclen_lower=1.0)


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
    log_packed("relevance", searcher)
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
    return counts, (seg, searcher, drawn, oracle)


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
    log_packed("faceted", searcher)
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

    # the path, counted: every compaction and fullwidth launch held to its
    # plain version (the comparison's launches uncounted)
    kn.reset_launches()
    with Held(rec, "faceted", ("compact_rows", "fullwidth_topk"),
              exact=True, counted=True) as held:
        results = run_all(fams)
    counts = dict(kn.launches)
    log(f"[main] faceted launches {counts}")
    log(f"[held] faceted: {held.calls} launches held, bit for bit")
    if held.calls != {n: counts[n] for n in held.calls}:
        raise AssertionError(f"faceted: {held.calls} held of {counts}")
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
    want = forked_answers(sf.oracle_answers, corpus, qs, K, ORACLE_RTOL)
    log(f"[parity] faceted oracle {time.time() - t0:.1f} s")
    ncat = len(corpus.cat_names)

    def parity(results, tag):
        faceted_parity(qs, results, want, ncat, tag)

    parity(results, "faceted")
    with fullwidth("0"), Held(rec, "faceted XT_FULLWIDTH=0",
                              ("compact_rows",), exact=True) as held0:
        parity(run_all(fams0), "faceted XT_FULLWIDTH=0")
    log(f"[held] faceted XT_FULLWIDTH=0: {held0.calls} launches held, bit "
        f"for bit")
    if not held0.calls["compact_rows"]:
        raise AssertionError("XT_FULLWIDTH=0: no compaction held")
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
    return counts, corpus, searcher, (qs, want, specs, arrays)


def faceted_parity(qs, results, want, ncat, tag):
    """The faceted gate: each answer (aggregations included) against
    synth_faceted's float64 oracle - A and B exact docid lists, C and D
    tie groups, counts and facet counts exact, price n / min / max exact,
    sums within ORACLE_RTOL."""
    import numpy as np

    from xapiand_tpu_torch.ops import kernels as kn

    def close(x, y):
        return abs(float(x) - y) <= ORACLE_RTOL * abs(y)

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


def work_phrase(ids, widths, offsets, lens, orbits, first, posoff, poslen,
                phrases, cand_cap, pmax, ncand):
    """phrase_leaves: per (query, leaf) the walked term block's docids up
    to the last candidate kept (the walk stops at cand_cap), per kept
    candidate its first flag and, per phrase term, posoff / poslen and
    its positions; the verdict words written. Operations: a binary search
    per walked row and other phrase term, and per kept candidate one per
    position of t0 and other term. The candidates are the plain version's
    (ops/phrase.py phrase_candidates); the arguments are the wrapper's,
    ncand its candidate counts."""
    import torch

    from xapiand_tpu_torch.ops import phrase as ph
    from xapiand_tpu_torch.ops.kernels import row_offsets

    B, R = ids.shape
    ro = row_offsets(widths)
    nbytes = 4 * B * R + 4 * B * len(phrases)
    ops = 0
    for p, (tidx, gidx, _win, _ex) in enumerate(phrases):
        cand_d, _src, valid, per_term = ph.phrase_candidates(
            ids, widths, offsets, orbits, first, posoff, poslen, tidx, gidx,
            cand_cap, pmax)
        rows = torch.minimum(lens[:, list(tidx)], torch.tensor(
            [widths[t] for t in tidx], device=ids.device))
        nw, tw = rows.min(1)
        walked = nw.clone()
        full = ncand[:, p] >= cand_cap
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
            n_pos * log2c(pmax)
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

    seg, _params, _post, _args, widths, ids, w, _tail = slices(
        searcher, cfg, batch, stats_d, rec)
    B, R = ids.shape
    bits = batch["group_bits"]
    deleted = seg["deleted"] if cfg.has_deletes else None
    prog = kn.tree_program(cfg.tree)
    mprog = None if cfg.phrases else prog
    margs = (ids, w, widths, bits, deleted, mprog, bool(cfg.phrases))
    nd = seg["deleted"].shape[0]
    got, want = kn.merge_docs(*margs, n_docs=nd), \
        kn._merge_docs_plain(*margs)
    err = check_close("merge_docs sums", got[0], want[0])
    for nm, a, b in zip(("mask", "count", "orbits"), got[1:], want[1:]):
        check_equal(f"merge_docs {nm}", a, b)
    rec.note("merge_docs", err,
             cuda_ms(lambda: kn.merge_docs(*margs, n_docs=nd)),
             cuda_ms(lambda: kn._merge_docs_plain(*margs)),
             work_merge_docs(ids, widths, deleted, got[3]))
    sums, mask, _count, orbits = got
    lookup_ms = 0.0
    if cfg.phrases:
        pargs = (ids, widths, batch["offsets"], batch["lens"], orbits, mask,
                 seg["post_posoff"], seg["post_poslen"], seg["positions"],
                 cfg.phrases, cfg.cand_cap, cfg.pmax)
        pkw = {"deleted": deleted, "bits": bits}
        plain, check, _key, work, _lib, yard = held_phrase(pargs, **pkw)
        phb, ncand = twice("phrase_leaves",
                           lambda: ph.phrase_leaves(*pargs, **pkw))
        check((phb, ncand), plain())
        rec.note("phrase_leaves", 0.0,
                 cuda_ms(lambda: ph.phrase_leaves(*pargs, **pkw)),
                 cuda_ms(plain, reps=3), work())
        # the library yardstick of the K15 lookups: torch.searchsorted of
        # the candidates in each phrase term's block
        lookup_ms = cuda_ms(yard)
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
                 work_filter(ids, mask, 0, phb, prog=prog))
        mask = got[0]
    targs = (sums, ids, mask, cfg.k)
    got, want = kn.topk_rows(*targs), kn._topk_rows_plain(*targs)
    check_equal("topk_rows docids", got[0], want[0])
    check_equal("topk_rows scores", got[1], want[1])
    rec.note("topk_rows", 0.0, cuda_ms(lambda: kn.topk_rows(*targs)),
             cuda_ms(lambda: kn._topk_rows_plain(*targs)),
             work_rows(R, B, 9, 8 * cfg.k),
             topk_library_ms(sums, mask, cfg.k),
             (f"B={B} R={R} k={cfg.k}", shape_name))
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
    log_packed("positional", searcher)
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


def geo_lookups(cols, specs, queries, ids):
    """The library yardstick of K15 inside K16: torch.searchsorted of the
    same two counts over every row's first RMAX ranges (#qs <= re, #qe <
    rs), the ranges gathered beforehand. -> the call."""
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
    return lambda: [(torch.searchsorted(qs, re, right=True),
                     torch.searchsorted(qe, rs)) for qs, qe, rs, re in ins]


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
    nd = seg["deleted"].shape[0]
    got = kn.merge_docs(*margs, n_docs=nd)
    if full:
        want = kn._merge_docs_plain(*margs)
        err = check_close("merge_docs sums", got[0], want[0])
        for nm, a, b in zip(("mask", "count", "orbits"), got[1:], want[1:]):
            check_equal(f"merge_docs {nm}", a, b)
        rec.note("merge_docs", err,
                 cuda_ms(lambda: kn.merge_docs(*margs, n_docs=nd)),
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
             cuda_ms(geo_lookups(*gargs[:4]), reps=5))
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
    rec.note("filter_leaves", 0.0, cuda_ms(lambda: kn.filter_leaves(*fargs)),
             cuda_ms(lambda: kn._filter_leaves_plain(*pargs)),
             work_filter(ids, mask, F, None, n_rows(values), geobits,
                         prog))
    elig = got[0]
    spec = (("docid", None, False),)
    sargs = (spec, ids, sums, elig, cfg.k, values)
    pargs = (spec, [None], ids, sums, elig, cfg.k, None, {})
    got, want = kn.sort_topk(*sargs), kn._sort_topk_plain(*pargs)
    check_equal("sort_topk docids", got[0], want[0])
    check_equal("sort_topk scores", got[1], want[1])
    rec.note("sort_topk", 0.0, cuda_ms(lambda: kn.sort_topk(*sargs)),
             cuda_ms(lambda: kn._sort_topk_plain(*pargs)),
             work_sort_topk(spec, elig, cfg.k, n_rows(values)),
             cuda_ms(docid_topk_call(ids, elig, cfg.k), reps=5),
             (f"B={B} R={R} k={cfg.k} keys=docid", shape_name))
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
    log_packed("geo", searcher)
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
    want = forked_answers(sg.oracle_answers, corpus, qs, rmax, K,
                          aggs=True)
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
    for i, s in enumerate(db._searchers):
        log_packed(f"database segment {i}", s)
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
        trace_by_kernel(prof, "database", top=24)

        # every K17c and agg_metrics launch of the aggregated searches
        # held against its plain version; each kernel timed at its widest
        # launch
        t0 = time.time()
        with Held(rec, "database", K17C_KERNELS + ("agg_metrics",)) \
                as held:
            for _fam, q, aggs, count_only in qs:
                db.search(q, k=K, aggs=aggs, count_only=count_only)
            torch.cuda.synchronize()
        log(f"[held] database: K17c and agg_metrics launches held against "
            f"their plain versions (twice bit for bit, counts and codes "
            f"exact, sums within rtol {AGG_RTOL}): {held.calls} "
            f"({time.time() - t0:.1f} s)")
        if not all(held.calls.values()):
            raise AssertionError(f"database held {held.calls}")
    finally:
        dbm.Database._search_host, SegmentSearcher.execute, dbm.bind = orig
        os.environ["XT_HOST_PATH"] = "0"
    return counts, (db, qs, terms, results)


# -- the REST path (slice 9) ------------------------------------------------

REST_DOCS, REST_QUERIES, REST_CLIENTS, REST_TAIL = 10_000, 256, 8, 100
# the wide clusterings re-index 256 hits each on the host (_doc_vectors):
# 16 of them since the script outgrew half of its time limit (64 before)
CLUSTER_SMALL, CLUSTER_WIDE, DIVERSIFY = 64, 16, 32
WIDE_N, WIDE_K = 4096, 16
SNAP_EACH = 8             # of each Database family: 64 aggregated searches
SNAP_TERMS = 64


class RestServer:
    """The port's REST app (create_app, IndexManager on ``dev``, the
    server's default options: autocommit, a 2 ms search batch window) in
    a thread of this process, as tests/test_rest.py runs it."""

    def __init__(self, data_dir, dev, **manager_opts):
        import asyncio
        import threading

        # the server package picks aiohttp's pure-Python parser (the custom
        # verbs) before aiohttp loads, so it is imported first
        from xapiand_tpu_torch.server.app import IndexManager, create_app

        from aiohttp import web

        self.port = None
        started = threading.Event()

        def run():
            async def start():
                app = create_app(manager=IndexManager(
                    data_dir, device=dev, **manager_opts))
                self.app = app
                self.runner = web.AppRunner(app)
                await self.runner.setup()
                site = web.TCPSite(self.runner, "127.0.0.1", 0)
                await site.start()
                self.port = self.runner.addresses[0][1]
                started.set()

            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(start())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not started.wait(120):
            raise AssertionError("the REST server did not start")
        self.url = f"http://127.0.0.1:{self.port}"

    def db(self, name):
        return self.app["manager"].get(name)

    def req(self, method, path, body=None, ctype="application/json"):
        import urllib.error
        import urllib.request

        data = None
        headers = {}
        if body is not None:
            data = body if isinstance(body, bytes) else \
                json.dumps(body).encode()
            headers["Content-Type"] = ctype
        r = urllib.request.Request(self.url + path, data=data,
                                   method=method, headers=headers)
        try:
            with urllib.request.urlopen(r, timeout=600) as resp:
                return resp.status, json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")

    def stop(self):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)


def _conformance():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "conformance", os.path.join(ROOT, "scripts", "conformance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _search_all(srv, qs, limit=K, clients=1):
    """Each query's (hits [(id, score)], total) and the wall ms of each
    request, ``clients`` requests in flight."""
    from concurrent.futures import ThreadPoolExecutor

    def one(body):
        t = time.perf_counter()
        status, out = srv.req("POST", "/passages/:search",
                              dict(body, _limit=limit))
        ms = 1e3 * (time.perf_counter() - t)
        if status != 200:
            raise AssertionError(f"search {body}: {status} {out}")
        return [(h["_id"], h["_score"]) for h in out["hits"]], \
            out["total"], ms

    if clients == 1:
        got = [one(b) for _w, b in qs]
    else:
        with ThreadPoolExecutor(clients) as pool:
            got = list(pool.map(one, [b for _w, b in qs]))
    return [(h, t) for h, t, _ms in got], [ms for _h, _t, ms in got]


def _held_to_oracle(what, answers, qs, oracle, limit=K):
    from xapiand_tpu_torch.utils import synth_passages as sp

    bad = [(words, err) for (words, _b), (hits, total) in zip(qs, answers)
           for err in [sp.check_hits(hits, total, oracle.search(words),
                                     limit)] if err]
    log(f"[parity] rest {what}: {len(qs) - len(bad)}/{len(qs)} BM25 "
        f"top-{limit} answers equal to the float64 oracle (ranks as tie "
        f"groups, scores within rtol {sp.SCORE_RTOL}, totals exact)")
    if bad:
        raise AssertionError(f"rest {what}: {bad[:3]}")


_SNAPSHOT: dict = {}


def _write_snapshot(path):
    """A forked worker's job: the Database path's state through
    models/snapshot.py snapshot_bytes into path, and its seconds and size
    beside it (host data only; the worker touches no CUDA state)."""
    from xapiand_tpu_torch.models import snapshot

    t = time.perf_counter()
    data = snapshot.snapshot_bytes(_SNAPSHOT["db"])
    with open(path, "wb") as f:
        f.write(data)
    with open(path + ".json", "w") as f:
        json.dump({"seconds": time.perf_counter() - t,
                   "bytes": len(data)}, f)


def rest_path(dev, rec, smi, db_world) -> dict:
    """Slice 9: the port's REST server on the card, with persistence, and
    MSet clustering through K20 (see the module docstring)."""
    import shutil

    import numpy as np
    import torch

    from xapiand_tpu_torch import database as dbm
    from xapiand_tpu_torch.models import snapshot
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils import synth_passages as sp

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    os.environ["XT_HOST_PATH"] = "1"   # the server routes as JAX does
    data_dir = os.path.join(ROOT, "data", "chip_smoke_rest")
    shutil.rmtree(data_dir, ignore_errors=True)
    writer = None
    srv = RestServer(data_dir, dev)
    try:
        # conformance: docs/EXAMPLES.md, the four /sharded cases (a
        # 2-shard index: the mesh plane) among them
        conf = _conformance()
        cases = conf.parse_spec(os.path.join(ROOT, "docs", "EXAMPLES.md"))
        mesh = [c for c in cases if c["path"].startswith("/sharded/")]
        fails = conf.replay(srv.url, cases)
        log(f"[conformance] rest: {len(cases) - fails}/{len(cases)} "
            f"docs/EXAMPLES.md cases pass against the port's server, the "
            f"{len(mesh)} /sharded cases (num_shards 2) among them")
        if fails or len(cases) < 54 or len(mesh) != 4:
            raise AssertionError(f"conformance: {fails} failures")

        # BASELINE config 1: 10k passages indexed through REST, BM25
        # top-10 term queries at one client, then at REST_CLIENTS
        corpus = sp.build_corpus(REST_DOCS + REST_TAIL, seed=7)
        nd = "\n".join(json.dumps(dict(corpus.doc(i), _id=str(i)))
                       for i in range(REST_DOCS)).encode()
        t0 = time.perf_counter()
        status, out = srv.req("POST", "/passages/:restore", nd,
                              ctype="application/x-ndjson")
        t1 = time.perf_counter()
        srv.req("POST", "/passages/:commit")
        t2 = time.perf_counter()
        if status != 200 or out["#indexed"] != REST_DOCS:
            raise AssertionError(f"restore: {status} {out}")
        log(f"[index] rest: {REST_DOCS} passages through POST "
            f"/passages/:restore (NDJSON) and :commit, "
            f"{REST_DOCS / (t2 - t0)} doc/s ({t1 - t0:.3f} s restore, "
            f"{t2 - t1:.3f} s commit)")
        oracle = sp.Oracle(corpus, range(REST_DOCS))
        qs = sp.queries(corpus, REST_QUERIES, seed=11)

        routes = {"host": 0, "device": 0}
        orig = (dbm.Database.try_search_host, dbm.Database._search_host,
                SegmentSearcher.execute, BatchSearcher.run)

        def try_search_host(self, *a, **kw):
            out = orig[0](self, *a, **kw)
            routes["host"] += out is not None
            return out

        def search_host(self, cqs, *a, **kw):
            routes["host"] += len(cqs)
            return orig[1](self, cqs, *a, **kw)

        def execute(self, *a, **kw):
            routes["device"] += 1
            return orig[2](self, *a, **kw)

        def run(self, irs, *a, **kw):
            routes["device"] += len(irs)
            return orig[3](self, irs, *a, **kw)

        (dbm.Database.try_search_host, dbm.Database._search_host,
         SegmentSearcher.execute, BatchSearcher.run) = (
            try_search_host, search_host, execute, run)
        try:
            _search_all(srv, qs[:8])                     # warm
            routes.update(host=0, device=0)
            answers, ms1 = _search_all(srv, qs)
            r1 = dict(routes)
            routes.update(host=0, device=0)
            t0 = time.perf_counter()
            answers8, _ms8 = _search_all(srv, qs, clients=REST_CLIENTS)
            qps8 = len(qs) / (time.perf_counter() - t0)
            r8 = dict(routes)
        finally:
            (dbm.Database.try_search_host, dbm.Database._search_host,
             SegmentSearcher.execute, BatchSearcher.run) = orig
        ms = sorted(ms1)
        log(f"[latency] rest: POST /passages/:search at 1 client, ms a "
            f"request median {ms[len(ms) // 2]} p99 {ms[int(len(ms) * .99)]}"
            f" max {ms[-1]}; {REST_CLIENTS} clients {qps8} QPS; on {smi}")
        log(f"[routes] rest: 1 client {r1}, {REST_CLIENTS} clients {r8} "
            "(host: the native host scorer; device: SegmentSearcher."
            "execute calls and BatchSearcher.run queries)")
        _held_to_oracle("config 1, 1 client", answers, qs, oracle)
        _held_to_oracle(f"config 1, {REST_CLIENTS} clients", answers8, qs,
                        oracle)

        # device busy over the 256 queries (the window of the run)
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("smoke.run"):
                _search_all(srv, qs)
                torch.cuda.synchronize()
        busy, span = device_busy(prof, "smoke.run")
        log(f"[trace] rest config 1: {len(qs)} searches at 1 client: " + (
            f"device busy {busy} ms of {span} ms ({100 * busy / span} %)"
            if busy is not None else
            f"{span} ms, no device events (every query on the host)"))


        # persistence: snapshot, restart, the same answers
        status, out = srv.req("POST", "/passages/:snapshot")
        if status != 200 or "#snapshot" not in out:
            raise AssertionError(f":snapshot {status} {out}")
        srv.stop()

        # the Database path's 200k-doc state is written by a worker forked
        # here (no server thread alive), while the phases below run: the
        # pinned snapshot code walks every term in Python; its load and
        # answers are checked at the end
        import multiprocessing

        snap_path = os.path.join(data_dir, "database.snapshot")
        _SNAPSHOT["db"] = db_world[0]
        writer = multiprocessing.get_context("fork").Process(
            target=_write_snapshot, args=(snap_path,))
        writer.start()
        t0 = time.perf_counter()
        srv = RestServer(data_dir, dev)
        again, _ms = _search_all(srv, qs[:1])
        restart_s = time.perf_counter() - t0
        again, _ms = _search_all(srv, qs)
        same = sum(a == b for a, b in zip(again, answers))
        log(f"[persist] rest: restart from the snapshot {restart_s:.3f} s "
            f"(a new server, the index opened at its first search); "
            f"{same}/{len(qs)} answers equal to the first server's")
        if same != len(qs):
            raise AssertionError("answers changed across the restart")
        srv.stop()

        # the WAL tail: REST_TAIL passages written with no commit (a server
        # without autocommit, so its stop commits nothing), then a restart
        srv = RestServer(data_dir, dev, autocommit_s=0)
        for i in range(REST_DOCS, REST_DOCS + REST_TAIL):
            status, _ = srv.req("PUT", f"/passages/{i}", corpus.doc(i))
            if status not in (200, 201):
                raise AssertionError(f"PUT tail {i}: {status}")
        status, info = srv.req("GET", "/passages/:info")
        if info["doc_count"] != REST_DOCS or info["pending"] != REST_TAIL:
            raise AssertionError(f"tail not pending: {info}")
        srv.stop()
        srv = RestServer(data_dir, dev)
        tail_qs = []
        for i in range(REST_DOCS, REST_DOCS + REST_TAIL):
            w = corpus.words[int(corpus.tokens[i].max())]   # its rarest
            tail_qs.append(([w], {"_query": {"body": w}}))
        tail, _ms = _search_all(srv, tail_qs, limit=256)
        status, info = srv.req("GET", "/passages/:info")
        found = sum(str(i) in {h for h, _s in hits} for i, (hits, _t) in
                    zip(range(REST_DOCS, REST_DOCS + REST_TAIL), tail))
        log(f"[persist] rest: WAL tail of {REST_TAIL} uncommitted passages "
            f"recovered at restart: doc_count {info['doc_count']}, "
            f"{found}/{REST_TAIL} found by a query of their rarest word")
        if info["doc_count"] != REST_DOCS + REST_TAIL or found != REST_TAIL:
            raise AssertionError("the WAL tail was not recovered")
        _held_to_oracle("the WAL tail", tail, tail_qs,
                        sp.Oracle(corpus, range(REST_DOCS + REST_TAIL)),
                        limit=256)

        # MSet clustering (K20) and diversification through REST, then one
        # wide MSet through Database.cluster_hits: counted, then held
        small = [dict(b, _cluster={"_k": 3}) for _w, b in qs[:CLUSTER_SMALL]]
        wide = [dict(b, _cluster={"_k": 8}, _limit=256)
                for _w, b in qs[CLUSTER_SMALL:CLUSTER_SMALL + CLUSTER_WIDE]]
        div = [dict(b, _diversify={"_lambda": 0.3})
               for _w, b in qs[-DIVERSIFY:]]
        pdb = srv.db("passages")
        ids = [str(i) for i in range(WIDE_N)]
        vec_s = [0.0]
        last_x = []
        orig_vec = dbm.Database._doc_vectors

        def doc_vectors(self, doc_ids, *a, **kw):
            t = time.perf_counter()
            out = orig_vec(self, doc_ids, *a, **kw)
            vec_s[0] += time.perf_counter() - t
            last_x[:] = [out[0]]
            return out

        def clustering():
            for b in small + wide:
                status, out = srv.req("POST", "/passages/:search", b)
                labels = [h["_cluster"] for h in out["hits"]]
                if status != 200 or not labels or \
                        max(labels) >= b["_cluster"]["_k"]:
                    raise AssertionError(f"_cluster: {status} {out}")
            for b in div:
                status, out = srv.req("POST", "/passages/:search", b)
                _s, plain = srv.req("POST", "/passages/:search",
                                    {"_query": b["_query"]})
                if status != 200 or sorted(h["_id"] for h in out["hits"]) \
                        != sorted(h["_id"] for h in plain["hits"]):
                    raise AssertionError(f"_diversify: {status} {out}")
            t = time.perf_counter()
            labels = pdb.cluster_hits(ids, k=WIDE_K)
            torch.cuda.synchronize()
            return labels, time.perf_counter() - t

        # the run is counted and held at once: every kmeans_cosine call (one
        # kmeans launch) step by step against its plain version and float64
        # (Held, counted: the comparison's launches are not counted)
        from xapiand_tpu_torch.ops import cluster as pcl

        KMEANS.update(near=0, launches=0, calls=0, parted=0,
                      replica_near=0, steps=0)
        cosine = pcl.kmeans_cosine
        n_cosine = [0]

        def counted_cosine(*a, **kw):
            n_cosine[0] += 1
            return cosine(*a, **kw)

        dbm.Database._doc_vectors = doc_vectors
        pcl.kmeans_cosine = counted_cosine
        try:
            torch.cuda.synchronize()
            kn.reset_launches()
            with Held(rec, "rest kmeans", ("kmeans",), counted=True) as held:
                labels, wide_s = clustering()
                torch.cuda.synchronize()
            counts = dict(kn.launches)
        finally:
            dbm.Database._doc_vectors = orig_vec
            pcl.kmeans_cosine = cosine
        X = last_x[0]
        zero = np.flatnonzero(~X.any(axis=1))
        log(f"[cluster] rest: {len(small)} searches with _cluster _k 3 "
            f"at _limit 10, {len(wide)} with _k 8 at _limit 256, "
            f"{len(div)} with _diversify _lambda 0.3; Database."
            f"cluster_hits over {WIDE_N} passages, k {WIDE_K}, V "
            f"{X.shape[1]}: {wide_s:.3f} s with the held comparisons, "
            f"_doc_vectors (host) {vec_s[0]:.3f} s of the run; "
            f"{len(set(labels))} clusters; {len(zero)} of its rows are 0 (no "
            f"term among the vocabulary's {X.shape[1]} highest-idf terms), "
            f"row 0 {'among them' if 0 in set(zero.tolist()) else 'not'}; "
            f"kmeans launches {counts['kmeans']} for {n_cosine[0]} "
            f"kmeans_cosine calls")
        if not counts["kmeans"] or X.shape != (WIDE_N, 2048):
            raise AssertionError(f"clustering launches {counts}")
        if counts["kmeans"] != n_cosine[0]:
            raise AssertionError(f"kmeans: {counts['kmeans']} launches for "
                                 f"{n_cosine[0]} kmeans_cosine calls")
        log(f"[held] rest: kmeans calls held {held.calls['kmeans']} "
            f"(one launch each, twice bit for bit; each call's "
            f"{KMEANS['steps']} steps and last assignments in all, by its "
            f"history, labels by the margin rule against the plain step and "
            f"float64, {KMEANS['near']} rows inside the margin; centroids "
            f"within rtol {C_RTOL}); {KMEANS['calls']} kmeans_cosine calls "
            f"replayed in float64: {KMEANS['calls'] - KMEANS['parted']} "
            f"followed to the end, {KMEANS['parted']} parted at a near tie; "
            f"{KMEANS['replica_near']} replica rows inside the margin")
        if held.calls["kmeans"] != counts["kmeans"] or \
                KMEANS["launches"] != counts["kmeans"] or not KMEANS["calls"]:
            raise AssertionError(f"kmeans held {held.calls} of {counts}")
        # the cluster phase once more, traced: device ms by kernel, and
        # kmeans' calls by shape
        shapes: dict = {}
        kfn = kn.kmeans_loop

        def by_shape(X, C, iters, *a, **kw):
            key = f"n{X.shape[0]} V{X.shape[1]} k{C.shape[0]} iters{iters}"
            shapes[key] = shapes.get(key, 0) + 1
            return kfn(X, C, iters, *a, **kw)

        class _Cluster:
            def run(self, _irs, stats=None):
                return clustering()

        kn.kmeans_loop = by_shape
        try:
            device_trace([(_Cluster(), None)], None, "rest cluster")
        finally:
            kn.kmeans_loop = kfn
        log(f"[trace] rest cluster: kmeans calls (launches) by shape "
            f"{shapes}")
        srv.stop()
        srv = None

        # the Database path's 200k-doc state: snapshot_bytes, loaded into a
        # fresh Database on the card, the same answers
        _db, dqs, terms, results = db_world
        writer.join()
        _SNAPSHOT.clear()
        if writer.exitcode != 0:
            raise AssertionError(f"snapshot writer exit {writer.exitcode}")
        with open(snap_path + ".json") as f:
            wrote = json.load(f)
        t1 = time.perf_counter()
        with open(snap_path, "rb") as f:
            data = f.read()
        fresh = dbm.Database(device=dev)
        snapshot.load_snapshot_bytes(fresh, data)
        t2 = time.perf_counter()
        pick = [i for f in sorted({q[0] for q in dqs})
                for i in [j for j, q in enumerate(dqs) if q[0] == f][
                    :SNAP_EACH]]
        diff = []
        for i in pick + list(range(len(dqs), len(dqs) + SNAP_TERMS)):
            if i < len(dqs):
                _f, q, aggs, count_only = dqs[i]
                got = fresh.search(q, k=K, aggs=aggs, count_only=count_only)
            else:
                got = fresh.search(terms[i - len(dqs)], k=K)
            want = results[i]
            if got.total != want.total or \
                    [(h.id, h.score) for h in got.hits] != \
                    [(h.id, h.score) for h in want.hits] or \
                    str(got.aggregations) != str(want.aggregations):
                diff.append(i)
        log(f"[persist] database snapshot: {wrote['bytes']} bytes, written "
            f"in {wrote['seconds']:.3f} s (snapshot_bytes in a forked "
            f"worker, beside the phases above), read and loaded into a fresh "
            f"Database on the card in {t2 - t1:.3f} s; {len(pick) - sum(i < len(dqs) for i in diff)}"
            f"/{len(pick)} aggregated searches and "
            f"{SNAP_TERMS - sum(i >= len(dqs) for i in diff)}/{SNAP_TERMS} "
            f"term queries equal to the original's answers")
        if diff:
            raise AssertionError(f"snapshot round trip differs at {diff[:8]}")
        del fresh, data
    finally:
        if srv is not None:
            srv.stop()
        if writer is not None and writer.is_alive():
            writer.terminate()
            writer.join()
        _SNAPSHOT.clear()
        os.environ["XT_HOST_PATH"] = "0"
        shutil.rmtree(data_dir, ignore_errors=True)
    return counts


# --------------------------------------------------------------------------
# the mesh plane (slice 10): config 5 on 8 stacked shards, then sharded
# indexes over REST
# --------------------------------------------------------------------------

_MESH: dict = {}


def _mesh_oracle_job(i):
    """The oracle's verdict on answer i of the mesh path (a forked numpy
    worker; the corpus and the answers are the parent's)."""
    from xapiand_tpu_torch.utils import synth_mesh as sm

    words = _MESH["qs"][i][0]
    hits, total = _MESH["answers"][i]
    return sm.check(hits, total, sm.oracle(_MESH["corpus"], words))


def mesh_path(dev, rec, smi) -> dict:
    """BASELINE config 5 (see the module docstring): 10M docs over 8 shards
    stacked on the card, its 256 queries through MeshExecutor.run."""
    import multiprocessing

    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.parallel import sharded
    from xapiand_tpu_torch.parallel.mesh import make_mesh
    from xapiand_tpu_torch.query.dsl import QueryDSL
    from xapiand_tpu_torch.utils import synth_mesh as sm

    os.environ["XT_HOST_PATH"] = "0"
    t0 = time.time()
    corpus = sm.Corpus(MESH_DOCS, seed=7, n_shards=MESH_SHARDS)
    t1 = time.time()
    idx = sharded.ShardedIndex(mesh=make_mesh(MESH_SHARDS, devices=dev))
    idx.schema = sm.schema()
    idx.load_segments(corpus.segments)
    torch.cuda.synchronize()
    t2 = time.time()
    nbytes = sharded.stacked_nbytes(idx._stacked)
    packed, _cols = packed_bytes(idx._stacked["values"])
    log(f"[index] mesh: config 5, {MESH_DOCS} docs over {MESH_SHARDS} "
        f"shards ({[s.num_docs for s in corpus.segments]} docs; "
        f"{sum(s.post_docids.shape[0] for s in corpus.segments)} postings "
        f"with guards), built in {t1 - t0:.1f} s; padded and stacked on "
        f"the card in {t2 - t1:.1f} s: {nbytes} bytes "
        f"({nbytes / 2**30:.2f} GiB), of which the value columns' packed "
        f"keys and codes {packed} ({(nbytes - packed) / 2**30:.2f} GiB "
        f"without them), dp = 1 (one card)")
    qs = sm.queries5(MESH_QUERIES)
    dsl = QueryDSL(idx.schema)
    irs = [dsl.parse(q) for _w, q in qs]
    stats = idx.stats()
    ex = sharded.MeshExecutor(idx.mesh, idx.n_shards, idx.scheme)

    def run():
        return ex.run(idx.segments, idx._stacked, idx.schema, stats,
                      idx.global_termfreq, idx.global_collfreq, irs, K)

    run()   # warm: the first run allocates

    # the counted run: launches per kernel, binds, per-shard execute ms
    exec_ms: list = []
    orig = sharded.execute_batch

    def timed_execute(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a, **kw)
        e1.record()
        exec_ms.append((e0, e1))
        return out

    kn.reset_launches()
    sharded.execute_batch = timed_execute
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = run()
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
    finally:
        sharded.execute_batch = orig
    launches = {n: kn.launches[n] for n in kn.launches if kn.launches[n]}
    missing = [n for n in MESH_KERNELS if not launches.get(n)]
    if missing:
        raise AssertionError(f"mesh path: {missing} never launched")
    ems = [a.elapsed_time(b) for a, b in exec_ms]
    log(f"[main] mesh: launches {launches}; the counted run "
        f"{counted_s * 1e3:.1f} ms: binds {ex.bind_seconds * 1e3:.1f} ms "
        f"({len(irs) * MESH_SHARDS} binds, one a query and shard), "
        f"{len(ems)} shard executes {sum(ems):.1f} ms device "
        f"(median {sorted(ems)[len(ems) // 2]:.2f} ms)")

    # every launch held against its plain version, bit for bit
    with Held(rec, "mesh", MESH_KERNELS, exact=True) as held:
        raw_h = run()
    if raw_h["docids"].tolist() != raw["docids"].tolist() or \
            raw_h["scores"].tobytes() != raw["scores"].tobytes():
        raise AssertionError("mesh path: the held run's answers differ")
    log(f"[held] mesh: calls held bit for bit {held.calls}")

    # warm runs for QPS, then one under the profiler
    run_s = []
    for _ in range(MESH_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    run_s.sort()
    med = run_s[len(run_s) // 2]
    log(f"[qps] mesh: {len(irs) / med} QPS median of {MESH_RUNS} warm "
        f"MeshExecutor.run of {len(irs)} queries (binds, {MESH_SHARDS} "
        f"shard executes a sub-batch, shard_merge, readback), min "
        f"{len(irs) / run_s[-1]} max {len(irs) / run_s[0]}; ms/run median "
        f"{med * 1e3} min {run_s[0] * 1e3} max {run_s[-1] * 1e3}; on {smi}")

    class _Run:
        def run(self, _irs, stats=None):
            return run()

    device_trace([(_Run(), irs)], None, "mesh")

    # the gate: every answer against the float64 oracle
    answers = []
    for bi in range(len(irs)):
        hits = []
        for gd, sc in zip(raw["docids"][bi], raw["scores"][bi]):
            if gd == 2**31 - 1 or not (sc > float("-inf")):
                continue
            shard, local = int(gd) % MESH_SHARDS, int(gd) // MESH_SHARDS
            hits.append((idx.segments[shard].doc_keys[local], float(sc)))
        answers.append((hits, int(raw["counts"][bi])))
    _MESH.update(corpus=corpus, qs=qs, answers=answers)
    t0 = time.time()
    with multiprocessing.get_context("fork").Pool(8) as pool:
        errs = pool.map(_mesh_oracle_job, range(len(qs)))
    _MESH.clear()
    bad = [(qs[i][0], e) for i, e in enumerate(errs) if e]
    log(f"[parity] mesh: {len(qs) - len(bad)}/{len(qs)} answers equal to "
        f"synth_mesh's float64 oracle (totals exact, scores within rtol "
        f"{ORACLE_RTOL}, ranks as tie groups; {time.time() - t0:.1f} s in "
        f"8 forked workers)")
    if bad:
        raise AssertionError(f"mesh path: {bad[:3]}")
    del idx, ex, corpus
    return launches


def _same_answer(what, got, want):
    """A sharded index's REST answer against the unsharded one's: the
    totals and hit ids equal, scores and every aggregation number within
    ORACLE_RTOL (counts exact)."""
    def walk(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            if set(a) != set(b):
                return f"{path}: keys {sorted(a)} != {sorted(b)}"
            for key in a:
                if key in ("#took",):
                    continue
                err = walk(a[key], b[key], f"{path}.{key}")
                if err:
                    return err
            return None
        if isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                return f"{path}: {len(a)} items != {len(b)}"
            for i, (x, y) in enumerate(zip(a, b)):
                err = walk(x, y, f"{path}[{i}]")
                if err:
                    return err
            return None
        if isinstance(a, bool) or isinstance(b, bool) or \
                not isinstance(a, (int, float)) or \
                not isinstance(b, (int, float)):
            return None if a == b else f"{path}: {a!r} != {b!r}"
        if isinstance(a, int) and isinstance(b, int):
            return None if a == b else f"{path}: {a} != {b}"
        if a == b or (a != a and b != b):
            return None
        return None if abs(a - b) <= ORACLE_RTOL * max(abs(a), abs(b)) \
            else f"{path}: {a} != {b}"

    err = walk(got, want, what)
    if err:
        raise AssertionError(f"rest mesh: {err}")


def rest_mesh_path(dev, rec, smi) -> dict:
    """Sharded indexes through the port's REST server: bank / netlog docs
    into a num_shards 8 index and a num_shards 1 index, the traffic on
    both, the sharded answers equal to the unsharded ones (a sorted
    collapse: to synth_docs' oracle of JAX ShardedDatabase's rule), every
    launch held."""
    import shutil

    import numpy as np
    import torch

    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.utils import synth_docs as sd

    os.environ["XT_HOST_PATH"] = "1"   # the server routes as JAX does
    data_dir = os.path.join(ROOT, "data", "chip_smoke_mesh")
    shutil.rmtree(data_dir, ignore_errors=True)
    srv = RestServer(data_dir, dev)
    try:
        corpus = sd.build_corpus(REST_MESH_DOCS, seed=7)
        half = REST_MESH_DOCS // 2
        t0 = time.perf_counter()
        ndjson = {(a, b): "\n".join(json.dumps(dict(corpus.doc(i),
                                                    _id=str(i)))
                                    for i in range(a, b)).encode()
                  for a, b in ((0, half), (half, REST_MESH_DOCS))}
        for name, ns in (("mesh8", MESH_SHARDS), ("mesh1", 1)):
            status, _ = srv.req("PUT", f"/{name}/:settings",
                                {"num_shards": ns})
            if status != 200:
                raise AssertionError(f"{name} settings: {status}")
            for (a, b), nd in ndjson.items():
                status, out = srv.req("POST", f"/{name}/:restore", nd,
                                      ctype="application/x-ndjson")
                if status != 200 or out["#indexed"] != b - a:
                    raise AssertionError(f"{name} restore: {status} {out}")
                srv.req("POST", f"/{name}/:commit")
        rng = np.random.Generator(np.random.PCG64(13))
        gone = [str(int(i)) for i in rng.choice(REST_MESH_DOCS,
                                                REST_MESH_DOCS // 100,
                                                replace=False)]
        for name in ("mesh8", "mesh1"):
            for i in gone:
                srv.req("DELETE", f"/{name}/{i}")
            srv.req("POST", f"/{name}/:commit")
        db8, db1 = srv.db("mesh8"), srv.db("mesh1")
        truth = sd.Truth(corpus, db1, [range(0, half),
                                       range(half, REST_MESH_DOCS)],
                         [int(i) for i in gone])
        log(f"[index] rest mesh: {REST_MESH_DOCS} bank / netlog docs "
            f"through :restore into /mesh8 (num_shards 8, "
            f"{len(db8._generations)} generations of "
            f"{db8.n_shards} shards) and /mesh1, two commits, "
            f"{len(gone)} deleted, {time.perf_counter() - t0:.1f} s")

        searches, _terms = sd.queries(corpus, n_each=REST_MESH_EACH, seed=5)
        text = [q for f, q, _a, _c in searches if f != "M"]
        bodies = [("agg " + f, "search", {"_query": q, "_aggs": a,
                                          "_limit": K})
                  for f, q, a, _c in searches if f in "HRP"]
        for j in range(REST_MESH_EACH):
            q = text[j]
            bodies += [
                ("value sort", "search",
                 {"_query": q, "_limit": K,
                  "_sort": [{"balance": {"_order": "desc"}}]}),
                ("strmetric sort", "search",
                 {"_query": q, "_limit": K, "_sort": [{"favoriteFruit": {
                     "_order": "asc", "_value": "grape",
                     "_metric": "levenshtein"}}]}),
                ("sorted collapse", "search",
                 {"_query": q, "_limit": K,
                  "_collapse": {"_field": "employer"},
                  "_sort": [{"age": {"_order": "desc"}}]}),
                ("collapse", "search",
                 {"_query": q, "_limit": K,
                  "_collapse": {"_field": "eyeColor"}}),
                ("count", "count", {"_query": q}),
                ("filtered", "search",
                 {"_query": {"_and": [q, {"balance": {"_from": 10000.0,
                                                      "_to": 80000.0}}]},
                  "_limit": K, "_aggs": {"d": {"_cardinality": {
                      "_field": "favoriteFruit"}}}})]
        bodies.append(("match all", "search",
                       {"_query": {"_match_all": {}}, "_limit": K,
                        "_aggs": {"a": {"_stats": {"_field": "age"}}}}))
        for j in range(4):
            bodies.append(("wide page", "search",
                           {"_query": text[j], "_limit": 300,
                            "_aggs": {"n": {"_count": {"_field": "age"}}}}))
        kn.reset_launches()
        t0 = time.perf_counter()
        with Held(rec, "rest mesh", tuple(
                n for n in REST_MESH_KERNELS if n != "wide_topk"),
                counted=True) as held:
            got = [srv.req("POST", f"/mesh8/:{v}", b)
                   for _w, v, b in bodies]
            want = [srv.req("POST", f"/mesh1/:{v}", b)
                    for _w, v, b in bodies]
            many_q = text[:32]
            many8 = db8.search_many(many_q, k=K)
            many1 = db1.search_many(many_q, k=K)
        launches = {n: kn.launches[n] for n in kn.launches
                    if kn.launches[n]}
        missing = [n for n in REST_MESH_KERNELS if not launches.get(n)]
        if missing:
            raise AssertionError(f"rest mesh: {missing} never launched")
        fams: dict = {}
        for (what, _v, body), (gs, g), (ws, w) in zip(bodies, got, want):
            if gs != 200 or ws != 200:
                raise AssertionError(f"rest mesh {what}: {gs} {ws} {g}")
            if what == "sorted collapse":
                # the device collapse keys a string on its first 8 bytes
                # ("employer"), so the unsharded index keeps one hit a
                # segment, as the JAX Database does (ROADMAP queue 3): the
                # sharded answer is held hit for hit to JAX
                # ShardedDatabase's rule over the corpus
                total, ids, near = sd.sharded_collapse_oracle(
                    db1, truth, db8, body["_query"], "age", "employer", K)
                if g["total"] != total or \
                        [h["_id"] for h in g["hits"]] != ids:
                    raise AssertionError(
                        f"rest mesh sorted collapse: {g} vs the oracle's "
                        f"{total} {ids} ({near} near ties)")
                fams["sorted collapse near ties"] = \
                    fams.get("sorted collapse near ties", 0) + near
            else:
                _same_answer(what, g, w)
            fams[what] = fams.get(what, 0) + 1
        for a, b in zip(many8, many1):
            _same_answer("search_many",
                         {"total": a.total, "hits": [[h.id, h.score]
                                                     for h in a.hits]},
                         {"total": b.total, "hits": [[h.id, h.score]
                                                     for h in b.hits]})
        log(f"[parity] rest mesh: {len(bodies)} requests and "
            f"{len(many_q)} search_many queries, /mesh8 equal to /mesh1 "
            f"(hits in order, totals and counts exact, scores and sums "
            f"within rtol {ORACLE_RTOL}), the sorted collapses to the "
            f"corpus oracle hit for hit: {fams}; "
            f"{time.perf_counter() - t0:.1f} s held")
        log(f"[held] rest mesh: launches {launches}; calls held against "
            f"their plain versions {held.calls}")
        return launches
    finally:
        srv.stop()
        torch.cuda.empty_cache()



def wide_table_phase(dev, rec):
    """wide_topk's table of key words (sort_topk at 82 key words; no path
    drives it): a sort of 40 value keys over 8 value columns
    of 2-7 distinct values (ties run deep), 70% of the rows eligible, k 10,
    against its plain version and timed. Outside every counted run."""
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    g = torch.Generator().manual_seed(12)
    B, R, nd = WIDE_TABLE_B, WIDE_TABLE_R, 2 * WIDE_TABLE_R
    ids = torch.stack([torch.randperm(nd, generator=g)[:R]
                       for _ in range(B)]).to(torch.int32).to(dev)
    sums = (torch.randint(0, 40, (B, R), generator=g).float() / 8).to(dev)
    elig = (torch.rand((B, R), generator=g) < 0.7).to(dev)
    values = {}
    for c in range(8):
        v = torch.randint(0, 2 + c % 6, (nd + 1,), generator=g,
                          dtype=torch.int32)
        values[c] = {"hi": v.to(dev), "lo": (v * 3 - 1).to(dev),
                     "present": (torch.rand(nd + 1, generator=g) < 0.95)
                     .to(dev)}
    specs = tuple(("value", i % 8, bool(i % 3)) for i in range(
        WIDE_TABLE_KEYS))
    k = 10
    sargs = (specs, ids, sums, elig, k, values)
    pargs = (specs, [values[sp[1]] for sp in specs], ids, sums, elig, k,
             None, {})
    before = kn.launches["wide_topk"]
    got = twice("wide_topk table", lambda: kn.sort_topk(*sargs))
    if kn.launches["wide_topk"] != before + 2:
        raise AssertionError("wide_topk table: the sort did not take the "
                             "wide mode")
    want = kn._sort_topk_plain(*pargs)
    check_equal("wide_topk table docids", got[0], want[0])
    check_equal("wide_topk table scores", got[1], want[1])
    rec.note("wide_topk", 0.0, cuda_ms(lambda: kn.sort_topk(*sargs), reps=3),
             cuda_ms(lambda: kn._sort_topk_plain(*pargs), reps=2),
             work_sort(specs, elig, k, nd + 1))
    rec.flush(f"wide_topk key-word table B={B} R={R} k={k} "
              f"{WIDE_TABLE_KEYS} value keys ({2 * WIDE_TABLE_KEYS + 2} "
              "words)")
    kn.launches["wide_topk"] = before


def collapse_designs_phase(dev):
    """Each design of collapse_rows forced (kernels.collapse_plan) once at
    the edge shapes of tests/test_torch_cuda.py's collapse tests: 3
    queries of 3,000 rows, 23 categorical keys (negative words among them),
    one key, a query with no eligible row, the all-ones key, a slot the
    segment lacks; collapse_max 1, 3, 8 and 9; docid and row order. Each
    call twice, bit for bit, and equal to the plain version. Outside
    every counted run."""
    import numpy as np
    import torch

    from xapiand_tpu_torch.ops import kernels as kn

    designs = {"global": lambda B, R, n: (0, 0),
               "tiles": lambda B, R, n: (kn.COLLAPSE_TABLE, 1),
               "tiles in 4 blocks": lambda B, R, n: (kn.COLLAPSE_TABLE, 4)}
    rule, before = kn.collapse_plan, kn.launches["collapse_rows"]
    calls = 0
    try:
        for case in ("keys", "one_key", "empty_query", "all_ones_key",
                     "no_column"):
            rng = np.random.Generator(np.random.PCG64(41))
            B, R, nd = 3, 3000, 9000
            ids = np.stack([np.sort(rng.choice(nd, R, replace=False))
                            for _ in range(B)]).astype(np.int32)
            sums = (rng.integers(1, 7, (B, R)) / 4).astype(np.float32)
            elig = rng.random((B, R)) < 0.8
            ids[:, -7:] = kn.SENTINEL
            elig[:, -7:] = False
            key = rng.integers(0, 1 if case == "one_key" else 23, nd + 1)
            col = {"hi": (key // 3 - 2).astype(np.int32),
                   "lo": (key % 3 - 1).astype(np.int32),
                   "present": rng.random(nd + 1) >=
                   (0.0 if case == "one_key" else 0.15)}
            if case == "empty_query":
                elig[1] = False
            if case == "all_ones_key":
                col["hi"][::3] = -1
                col["lo"][::3] = -1
            dcol = None if case == "no_column" else \
                {c: torch.from_numpy(v).to(dev) for c, v in col.items()}
            pcol = kn.absent_column(dev) if dcol is None else dcol
            args = tuple(torch.from_numpy(x).to(dev)
                         for x in (ids, sums, elig))
            for cmax in (1, 3, 8, 9):
                for ro in (False, True):
                    want = kn._collapse_rows_plain(
                        *args, pcol, min(cmax, kn.MAX_COLLAPSE), ro)
                    for name, plan in designs.items():
                        kn.collapse_plan = plan
                        got = twice(f"collapse_rows {name} {case}",
                                    lambda: kn.collapse_rows(*args, dcol,
                                                             cmax, ro))
                        check_equal(f"collapse_rows {name} {case} keep",
                                    got[0], want[0])
                        check_equal(f"collapse_rows {name} {case} tie",
                                    got[1], want[1])
                        calls += 1
    finally:
        kn.collapse_plan = rule
        kn.launches["collapse_rows"] = before
    torch.cuda.synchronize()
    log(f"[held] collapse_rows designs: the tiles (one block, 4 blocks a "
        f"query) and the global design forced at {calls // 3} edge calls each "
        "(5 cases, collapse_max 1, "
        "3, 8, 9, docid and row order), twice bit for bit, equal to the "
        "plain version")


# the paths that need no other path's world, for --only
ALONE = {"relevance": "relevance_path", "positional": "positional_path",
         "geo": "geo_path", "mesh": "mesh_path",
         "rest_mesh": "rest_mesh_path", "faceted": "faceted_browse_path",
         "database": "database_path", "wide_table": "wide_table_alone",
         "schemes_k21": "schemes_k21_alone"}


def wide_table_alone(dev, rec, _smi):
    """wide_topk's key-word table phase (--only wide_table: its
    capture)."""
    wide_table_phase(dev, rec)


def schemes_k21_alone(dev, rec, smi):
    """The relevance and faceted paths, then the schemes and K21 paths over
    their worlds (--only schemes_k21: the captures of the schemes path's
    prefix_certify and of K21's chunk_merge)."""
    _rel, rel_world = relevance_path(dev, rec, smi)
    _fac, corpus, searcher, gate = faceted_path(dev, rec, smi)
    schemes_path(dev, rec, smi, rel_world, corpus, searcher)
    k21_path(dev, rec, smi, rel_world, corpus, searcher, gate)


def faceted_browse_path(dev, rec, smi):
    """The faceted path, then the browse path over its corpus (--only
    faceted: their captures without the paths before and after them)."""
    _fac, corpus, searcher, _gate = faceted_path(dev, rec, smi)
    browse_path(dev, rec, smi, corpus, searcher)


def phase_done(tag, t0, t_script):
    """The [time] line of a phase, also on stderr with the script's time so
    far, so that a run stopped at its time limit shows how far it got."""
    log(f"[time] {tag} {time.time() - t0:.1f} s")
    print(f"[time] {tag} {time.time() - t0:.1f} s, the script "
          f"{time.time() - t_script:.1f} s so far", file=sys.stderr,
          flush=True)


def main() -> int:
    t_script = time.time()
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--capture", metavar="DIR",
                    help="save the CAPTURE launches to DIR, for "
                         "tools/sort_pairs.py (this run's times are not "
                         "kept)")
    ap.add_argument("--only", choices=sorted(ALONE),
                    help="with --capture: run this path alone, for its "
                         "captures, and print no result")
    args = ap.parse_args()
    if args.only and not args.capture:
        ap.error("--only captures: give --capture DIR")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
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
    if args.capture:
        capture(args.capture)
    # the earlier paths time the device path of BatchSearcher.run; the
    # Database path routes as the JAX package does (XT_HOST_PATH=1)
    os.environ["XT_HOST_PATH"] = "0"
    if args.only:
        t0 = time.time()
        globals()[ALONE[args.only]](dev, rec, smi)
        phase_done(f"{args.only} path alone", t0, t_script)
        log("[capture] launches a pattern matched: " + json.dumps(
            {f"{n} {getattr(p, 'pattern', p)}": c
             for (n, i), c in sorted(CAPTURED.items())
             for p in [CAPTURE[n][i][-1] if isinstance(CAPTURE[n][i], tuple)
                       else CAPTURE[n][i]]}))
        return 0
    t0 = time.time()
    rel, rel_world = relevance_path(dev, rec, smi)
    torch.cuda.empty_cache()
    phase_done("relevance path", t0, t_script)
    t0 = time.time()
    fac, corpus, searcher, fac_gate = faceted_path(dev, rec, smi)
    torch.cuda.empty_cache()
    phase_done("faceted path", t0, t_script)
    t0 = time.time()
    bro = browse_path(dev, rec, smi, corpus, searcher)
    torch.cuda.empty_cache()
    phase_done("browse path", t0, t_script)
    t0 = time.time()
    sch = schemes_path(dev, rec, smi, rel_world, corpus, searcher)
    torch.cuda.empty_cache()
    phase_done("schemes path", t0, t_script)
    t0 = time.time()
    k21 = k21_path(dev, rec, smi, rel_world, corpus, searcher, fac_gate)
    del corpus, searcher, rel_world, fac_gate
    torch.cuda.empty_cache()
    phase_done("k21 path", t0, t_script)
    t0 = time.time()
    pos = positional_path(dev, rec, smi)
    torch.cuda.empty_cache()
    phase_done("positional path", t0, t_script)
    t0 = time.time()
    geo = geo_path(dev, rec, smi)
    phase_done("geo path and its aggregation run", t0, t_script)
    torch.cuda.empty_cache()
    t0 = time.time()
    dbp, db_world = database_path(dev, rec, smi)
    phase_done("database path", t0, t_script)
    t0 = time.time()
    rst = rest_path(dev, rec, smi, db_world)
    del db_world
    phase_done("rest path", t0, t_script)
    torch.cuda.empty_cache()
    t0 = time.time()
    msh = mesh_path(dev, rec, smi)
    torch.cuda.empty_cache()
    phase_done("mesh path", t0, t_script)
    t0 = time.time()
    rmh = rest_mesh_path(dev, rec, smi)
    phase_done("rest mesh path", t0, t_script)
    t0 = time.time()
    wide_table_phase(dev, rec)
    phase_done("wide_topk table", t0, t_script)
    t0 = time.time()
    collapse_designs_phase(dev)
    phase_done("collapse_rows designs", t0, t_script)
    rec.shape_lines()
    if [m for m in sys.modules
            if m.split(".")[0] in ("jax", "xapiand_tpu")]:
        raise AssertionError("JAX or the JAX package was imported")
    log(f"[time] script {time.time() - t_script:.1f} s, the kernel build "
        f"included")

    print(json.dumps({"kernels": [
        rec.record(name, sum(c.get(name, 0)
                             for c in (rel, fac, bro, sch, k21, pos, geo,
                                       dbp, rst, msh, rmh)))
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
