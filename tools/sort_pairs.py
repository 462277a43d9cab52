#!/usr/bin/env python3
"""Time two versions of the port's kernels, and variants of this tree's,
against each other on one card, on the launches the paths make.

    python3 chip_smoke.py --capture _archive/captures
    python tools/sort_pairs.py --parent DIR --captures _archive/captures \\
        [--rounds 2] [--kernels score_slices,merge_docs,shard_reduce]

``chip_smoke.py --capture`` saves the arguments of the launches its paths
make at the shapes of its ``CAPTURE`` table (sort_topk at geo, browse N, C
and M, faceted A and B, a REST mesh shape; the widest agg_filter and
semijoin_rows; score_slices and merge_docs at browse C, the mesh, browse
B16, faceted A, geo, geo aggregations and the relevance prefix group;
shard_reduce at the REST mesh and mesh shapes; merge_special at browse S
and X and the schemes' S and X; collapse_rows at browse C's, its dense
plans' and the REST mesh's shapes; agg_buckets' widest launches of
faceted A and D, browse M, the geo aggregations, the Database path and
the REST mesh; kmeans' kmeans_cosine calls, a capture a
call, which a version without ``kmeans_loop`` replays as its step calls
and the assignment, 21 wrapper calls, and every version holds by the
margin rule; phrase_leaves at the positional launch groups, whose wrapper
lives in ``ops/phrase.py``: DIR's copy of that module is loaded over
DIR's ``ops/kernels.py``; geo_leaves at geo's two widths and the geo
aggregations'; filter_leaves at geo, positional, browse M, N and C and
faceted B and C; agg_distinct at browse M and the geo aggregations;
agg_metrics at faceted A and D and the geo aggregations; agg_ranges and
agg_hist at the Database path's one-query launches; wide_topk, the wide
mode of the topk_rows and sort_topk wrappers, at the REST mesh's pages
of 300 and sorted collapses of k 80 and at the key-word table's sort of
``--only wide_table``; fullwidth_topk at faceted A's three fullwidth
groups; compact_rows at faceted A's XT_FULLWIDTH=0 caps and B's
precompaction; shard_merge at the mesh's sub-batches and the REST mesh's
widest merge with order keys; chunk_merge at K21's chunked ORs;
prefix_certify at the relevance prefix groups and the schemes path's
BM25Plus launch; the ``--only faceted`` run takes the faceted
path, then browse, ``--only schemes_k21`` the relevance and faceted
paths, then the schemes and K21 paths). DIR is a
checkout of the version to compare with (for example a ``git archive``
of the parent commit unpacked under ``_archive/``). The versions, each built with the
flags of ``ops/kernels.py`` into ``_archive/sort_pairs/`` (one nvcc a
source, all at once): ``parent`` (DIR's sources, launched through DIR's own
``ops/kernels.py`` wrappers, whose C signatures may differ), ``change``
(this tree's) and the ``VARIANTS`` of this tree's kernels (other -D
constants, or other values of ``ops/kernels.py``'s constants and rules).
Each captured launch of the ``--kernels`` named is replayed through each
version, its answer held to the plain version's (``chip_smoke.HELD``),
then timed in the order parent, change, the variants, the variants
reversed, change, parent, ``--rounds`` times. One JSON line a launch: its
key, the Held block's tag it came in, the eligible rows' share
(sort_topk, agg_filter, agg_buckets, collapse_rows, agg_distinct,
agg_metrics; filter_leaves' first rows), every time and each
version's median, device-only (``utils/cudatime.device_ms``: CUDA
activity alone, the mean a call over 20 calls, a call all the launches it
makes) and by CUDA events around the same 20 wrapper calls (``event_ms``), the
change's time by kernel, the library call's (HELD's yardstick: ``torch.topk(largest=False)`` of the masked
docids for the docid key, ``torch.searchsorted`` for agg_filter and
semijoin_rows, ``torch.sum`` / ``amin`` / ``amax`` over the shards for
shard_reduce, ``torch.bincount`` of the rows' precomputed codes for
agg_buckets and of their (bucket, bin) indices for agg_hist,
``torch.topk`` of the masked scores for topk_rows' wide mode,
``torch.topk`` of the masked float32 image for fullwidth_topk (a part of
its function: no exact order, no certificate), ``torch.sort`` of the
packed candidate keys for shard_merge and chunk_merge,
``torch.searchsorted`` of the K15 lookups for phrase_leaves
and of the two counts for geo_leaves) and the bound (HELD's work over
``chip_smoke.py``'s rates).
Then the card's name and power limit.

``tools/synth_captures.py`` writes launches made from a seed in the same
format (kmeans calls at the REST path's shapes, sparse merge_special
launches no path makes). ``build_many`` and ``using`` are also the harness
of ``tools/topk_pairs.py`` and ``tools/dense_pairs.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the kernels replayed, by source
SOURCES = {"sort_topk": "sort_topk.cu", "agg_filter": "agg_filter.cu",
           "semijoin_rows": "semijoin_rows.cu",
           "score_slices": "score_slices.cu", "merge_docs": "merge_docs.cu",
           "shard_reduce": "shard_merge.cu",
           "merge_special": "merge_special.cu", "kmeans": "kmeans.cu",
           "collapse_rows": "collapse_rows.cu",
           "agg_buckets": "agg_buckets.cu",
           "phrase_leaves": "phrase_leaves.cu", "geo_leaves": "geo_leaves.cu",
           "filter_leaves": "filter_leaves.cu",
           "agg_distinct": "agg_distinct.cu", "agg_metrics": "agg_metrics.cu",
           "agg_ranges": "agg_ranges.cu", "agg_hist": "agg_hist.cu",
           "wide_topk": "wide_topk.cu",
           "fullwidth_topk": "fullwidth_topk.cu",
           "compact_rows": "compact_rows.cu",
           "shard_merge": "shard_merge.cu", "chunk_merge": "shard_merge.cu",
           "prefix_certify": "prefix_certify.cu"}
# variants of this tree's kernels: (kernel, nvcc -D flags of its source,
# ops/kernels.py attributes set around each call)
VARIANTS = {
    # sort_topk: tiles of 16384 rows, 8 blocks an SM, each docid alone
    "tile16384": ("sort_topk", ("-DSK_TILE_MIN=16384",), {}),
    "blocks1056": ("sort_topk", ("-DSK_BLOCKS=1056",), {}),
    "scalar_ids": ("sort_topk", ("-DSK_IDS_VEC=0",), {}),
    # score_slices: 8 or 16 rows a thread (a tile of 2048 or 4096 rows)
    "ss_rpt8": ("score_slices", ("-DSS_RPT=8",), {}),
    "ss_rpt16": ("score_slices", ("-DSS_RPT=16",), {}),
    # merge_docs: the probes wherever, the tiles wherever (by 2048-docid
    # tiles too)
    "md_probes": ("merge_docs", (), {"merge_plan": lambda w, n: 0}),
    "md_tiles": ("merge_docs", (), {"merge_plan": "tiles"}),
    "md_tiles2048": ("merge_docs", (), {"merge_plan": "tiles",
                                        "MERGE_TILE": 2048}),
    # merge_special: the probes wherever, the doc tiles wherever (the
    # widest tile whose slots fit, or 2048 docids), 4 rows a thread
    "ms_probes": ("merge_special", (), {"special_plan": "probes"}),
    "ms_tiles": ("merge_special", (), {"special_plan": "tiles"}),
    "ms_tiles2048": ("merge_special", (), {"special_plan": "tiles2048"}),
    "ms_rpt4": ("merge_special", ("-DMS_RPT=4",), {}),
    # kmeans: clusters of at most 4 or 8 blocks
    "km_cluster4": ("kmeans", (), {"KMEANS_CLUSTER": 4}),
    "km_cluster8": ("kmeans", (), {"KMEANS_CLUSTER": 8}),
    # collapse_rows: the global design wherever; the tiles over 66 blocks
    "cr_global": ("collapse_rows", (), {"collapse_plan":
                                        lambda B, R, n: (0, 0)}),
    "cr_blocks66": ("collapse_rows", (), {"COLLAPSE_BLOCKS": 66}),
    # agg_buckets: 8 queued rows a lane at once; blocks of 16,384 rows
    "ab_u8": ("agg_buckets", ("-DAB_U=8",), {}),
    "ab_rows16384": ("agg_buckets", (), {"AGG_ROWS": 16384}),
    # agg_metrics: 8 queued rows a lane at once; blocks of 16,384 rows;
    # row_plan filling 132 blocks (one an SM) or 33
    "am_u8": ("agg_metrics", ("-DAM_U=8",), {}),
    "am_rows16384": ("agg_metrics", (), {"AGG_ROWS": 16384}),
    "am_fill132": ("agg_metrics", (), {"AGG_FILL": 132}),
    "am_fill33": ("agg_metrics", (), {"AGG_FILL": 33}),
    # agg_ranges: 4 queued rows a lane at once; row_plan filling 264
    # blocks or 66
    "ar_u4": ("agg_ranges", ("-DAR_U=4",), {}),
    "ar_fill264": ("agg_ranges", (), {"RANGES_FILL": 264}),
    "ar_fill66": ("agg_ranges", (), {"RANGES_FILL": 66}),
    # agg_hist: hist2 by the zero-kept int scratch and a grid barrier (the
    # cooperative launch) in place of float atomics; row_plan filling 33
    # or 132 blocks at the top level, 66 or 264 for hist2
    "ah_coop": ("agg_hist", (), {"HIST2_FLOAT": False}),
    "ah_fill33": ("agg_hist", (), {"HIST_FILL": 33}),
    "ah_fill132": ("agg_hist", (), {"HIST_FILL": 132}),
    "ah2_fill66": ("agg_hist", (), {"HIST2_FILL": 66}),
    "ah2_fill264": ("agg_hist", (), {"HIST2_FILL": 264}),
    # wide_topk: tiles of at least 1,024 or 4,096 rows; the merge ranking
    # up to 1,280 or 5,120 candidates a query
    "wt_tile1024": ("wide_topk", (), {"WIDE_TILE_MIN": 1024}),
    "wt_tile4096": ("wide_topk", (), {"WIDE_TILE_MIN": 4096}),
    "wt_merge1280": ("wide_topk", (), {"WIDE_MERGE": 1280}),
    "wt_merge5120": ("wide_topk", (), {"WIDE_MERGE": 5120}),
    # fullwidth_topk: blocks of at least 65,536 rows; B x G up to 528,
    # 2,112 or 4,224 blocks
    "fw_rows65536": ("fullwidth_topk", (), {"FULLWIDTH_ROWS": 65536}),
    "fw_blocks528": ("fullwidth_topk", (), {"FULLWIDTH_BLOCKS": 528}),
    "fw_blocks2112": ("fullwidth_topk", (), {"FULLWIDTH_BLOCKS": 2112}),
    "fw_blocks4224": ("fullwidth_topk", (), {"FULLWIDTH_BLOCKS": 4224}),
}
REPS = 20


def build_many(jobs) -> list:
    """jobs: (library path, csrc directory, sources, extra nvcc flags[,
    C signatures]). Every nvcc is started at once, then each job's objects
    are linked into its library, which is loaded with the signatures given
    (ops/kernels.py's by default)."""
    from xapiand_tpu_torch.ops import kernels as kn

    procs = []
    for out, csrc, sources, flags, *_sig in jobs:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        for n in sources:
            obj = f"{out[:-3]}.{n[:-3]}.o"
            procs.append((n, obj, subprocess.Popen(
                [kn.find_nvcc(), *kn.NVCC_FLAGS, *flags, "-c", "-o", obj,
                 os.path.join(csrc, n)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for n, _obj, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc {n} failed:\n{log}")
    libs = []
    for out, _csrc, sources, _flags, *sig in jobs:
        subprocess.run([kn.find_nvcc(), "-shared", "-o", out,
                        *(f"{out[:-3]}.{n[:-3]}.o" for n in sources)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(out)
        for fn, argtypes in (sig[0] if sig else kn._SIGNATURES).items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs.append(lib)
    return libs


@contextlib.contextmanager
def using(lib, mod=None):
    """The wrappers of mod (this tree's ops/kernels.py by default) launch
    from lib inside the block."""
    if mod is None:
        from xapiand_tpu_torch.ops import kernels as mod

    saved, mod._lib = mod._lib, lib
    try:
        yield
    finally:
        mod._lib = saved


@contextlib.contextmanager
def patched(mod, attrs):
    """mod's attributes set to attrs inside the block ("tiles": merge_plan
    or special_plan taking the doc tiles wherever, "tiles2048":
    special_plan's tiles of 2048 docids, "probes": special_plan taking the
    probes)."""
    import chip_smoke as cs

    saved = {k: getattr(mod, k) for k in attrs}
    for k, v in attrs.items():
        if (k, v) == ("merge_plan", "tiles"):
            v = (lambda w, n: -(-int(n) // mod.MERGE_TILE))
        elif (k, v) == ("special_plan", "tiles"):
            v = (lambda w, n, p: cs.special_other(w, n, p, 0))
        elif (k, v) == ("special_plan", "tiles2048"):
            v = (lambda w, n, p: (-(-int(n) // 2048), 2048))
        elif (k, v) == ("special_plan", "probes"):
            v = (lambda w, n, p: (0, 0))
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


def load_kernels(parent: str):
    """DIR's ops/kernels.py as a module of its own (its wrappers and C
    signatures; the rest of the package is this tree's)."""
    path = os.path.join(parent, "xapiand_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.__parent_dir__ = parent
    return mod


def load_home(parent: str, home: str, pmod):
    """DIR's ops/<home>.py as a module of its own, its names from
    ops/kernels.py taken from pmod (DIR's), so its wrappers launch from
    the library pmod is given."""
    path = os.path.join(parent, "xapiand_tpu_torch", "ops", f"{home}.py")
    spec = importlib.util.spec_from_file_location(f"parent_{home}", path)
    mod = importlib.util.module_from_spec(spec)
    key = "xapiand_tpu_torch.ops.kernels"
    saved = sys.modules[key]
    sys.modules[key] = pmod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules[key] = saved
    return mod


def parent_kmeans_loop(mod, X, C0, iters, assign_last=True):
    """A kmeans_cosine call as a version without kmeans_loop runs it: its
    iters step calls of mod.kmeans, then the assignment alone."""
    C, labels = C0, None
    for _ in range(iters):
        labels, C = mod.kmeans(X, C)
    if assign_last:
        labels, _ = mod.kmeans(X, C, update=False)
    return labels, C


def check_kmeans_call(X, C0, iters):
    """A replayed kmeans_cosine call held by the margin rule, whatever the
    version: the last labels equal float64's under the version's own last
    centroids outside the margin, and where they equal the plain version's,
    the centroids lie within rtol 1e-5 of its."""
    import numpy as np

    import chip_smoke as cs
    from xapiand_tpu_torch.ops import cluster

    X64 = X.cpu().numpy().astype(np.float64)

    def check(got, want):
        gl, gc = got[0].cpu().numpy(), got[1].cpu().numpy()
        near = cluster.near_ties(X64, gc)
        if ((gl != (X64 @ gc.astype(np.float64).T).argmax(axis=1)) &
                ~near).any():
            raise AssertionError(f"kmeans n{X.shape[0]}: labels differ "
                                 "outside the margin")
        if np.array_equal(gl, want[0].cpu().numpy()) and \
                not cs._close(gc, want[1].cpu().numpy()):
            raise AssertionError(f"kmeans n{X.shape[0]}: centroids beyond "
                                 "rtol of the plain version")
        return 0.0

    return check


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def replay(path, libs, pmod, rounds):
    """One captured launch: every version held to the plain version, then
    timed; its JSON line."""
    import torch

    import chip_smoke as cs
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.utils.cudatime import device_ms, event_ms

    cap = torch.load(path, weights_only=False)
    name, args, kw = cap["name"], cap["args"], cap["kw"]
    # the kernel replayed: the file's first word (wide_topk for the wide
    # calls of the topk_rows and sort_topk wrappers, the record's name)
    kernel = os.path.basename(path).split(" ")[0]
    plain, check, key, work, _library, *yard = cs.HELD[name](args, **kw)
    if name == "kmeans":
        check = check_kmeans_call(*args[:3])
    want = plain()
    # the call's arguments by name, as this tree's wrapper takes them; a
    # version gets those its wrapper has (the parent's may lack some); a
    # wrapper outside ops/kernels.py (chip_smoke.WRAPPER_HOMES) is the
    # parent's own module's, launching through pmod
    home, attr = cs.wrapper_home(name)
    phome = pmod if home is kn else load_home(
        pmod.__parent_dir__, cs.WRAPPER_HOMES[name], pmod)
    given = inspect.signature(getattr(home, attr)).bind(*args,
                                                        **kw).arguments
    run = {}
    for v in ("parent", "change", *(v for v, (k, _f, _a) in
                                    VARIANTS.items() if k == kernel)):
        mod = pmod if v == "parent" else kn
        where = phome if v == "parent" else home
        wrapper = getattr(where, attr) if hasattr(where, attr) else \
            functools.partial(parent_kmeans_loop, mod)
        params = inspect.signature(wrapper).parameters
        kwv = {k: x for k, x in given.items() if k in params}
        attrs = VARIANTS[v][2] if v in VARIANTS else {}
        lib = libs.get(v, libs["change"])

        def call(mod=mod, wrapper=wrapper, kwv=kwv, attrs=attrs, lib=lib):
            with using(lib, mod), patched(mod, attrs):
                return wrapper(**kwv)

        with using(libs["change"]):   # a check's own launches
            check(call(), want)
        run[v] = call
    torch.cuda.synchronize()
    names = list(run)
    dev = {v: [] for v in names}
    ev = {v: [] for v in names}
    var = names[2:]
    for _ in range(rounds):
        for v in ("parent", "change", *var, *var[::-1], "change", "parent"):
            dev[v].append(device_ms(run[v], REPS))
            ev[v].append(event_ms(run[v], REPS))
    by: dict = {}
    device_ms(run["change"], REPS, by=by)
    b, ops = work()
    elig = args[3] if name in ("sort_topk", "fullwidth_topk") else \
        args[0] if name == "compact_rows" else \
        args[2] if name in ("collapse_rows", "topk_rows") else \
        args[1] if name in ("agg_filter", "agg_buckets", "agg_distinct",
                            "agg_metrics", "agg_ranges", "agg_hist") else \
        (args[5] if args[5] is not None else args[4] != kn.SENTINEL) \
        if name == "filter_leaves" else None
    return {
        "kernel": kernel, "wrapper": name, "key": key,
        "tag": cap.get("tag"),
        "eligible_share": float(elig.float().mean()) if elig is not None
        else None,
        "device_ms": dev, "event_ms": ev,
        "median_device_ms": {v: statistics.median(t) for v, t in dev.items()
                             if None not in t},
        "median_event_ms": {v: statistics.median(t) for v, t in ev.items()},
        "change_by_kernel_ms": by,
        "library_device_ms": device_ms(yard[0], REPS) if yard else None,
        "library_event_ms": event_ms(yard[0], REPS) if yard else None,
        "bound_ms": max(1e3 * b / cs.HBM_BYTES_PER_S,
                        1e3 * ops / cs.PEAK_OPS_PER_S)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--captures", required=True,
                    help="chip_smoke.py --capture's directory")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default=",".join(SOURCES),
                    help="the kernels whose captures are replayed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sort_pairs: no CUDA device", file=sys.stderr)
        return 2
    want = set(args.kernels.split(","))
    files = sorted(f for f in os.listdir(args.captures)
                   if f.endswith(".pt") and f.split(" ")[0] in want)
    if not files:
        print(f"sort_pairs: no capture of {sorted(want)} in "
              f"{args.captures}", file=sys.stderr)
        return 2
    pmod = load_kernels(args.parent)
    out = os.path.join(ROOT, "_archive", "sort_pairs")
    here = os.path.join(ROOT, "xapiand_tpu_torch", "csrc")
    srcs = tuple(sorted({SOURCES[k] for k in want}))
    jobs = {"parent": (os.path.join(out, "parent.so"),
                       os.path.join(args.parent, "xapiand_tpu_torch", "csrc"),
                       srcs, (), pmod._SIGNATURES),
            "change": (os.path.join(out, "change.so"), here, srcs, ())}
    for v, (k, flags, _a) in VARIANTS.items():
        if k in want and flags:
            jobs[v] = (os.path.join(out, f"{v}.so"), here, (SOURCES[k],),
                       flags)
    libs = dict(zip(jobs, build_many(list(jobs.values()))))
    for f in files:
        print(json.dumps(replay(os.path.join(args.captures, f), libs, pmod,
                                args.rounds)), flush=True)
        torch.cuda.empty_cache()
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
