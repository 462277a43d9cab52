"""ShardedIndex: docid-striped shards executed over a device mesh (torch
port of ``xapiand_tpu/parallel/sharded.py``).

Reference parity:
- shard routing: ``fnv1ah64(id_term) % n_shards`` (handler.cc:2004);
- global docids stripe as ``global = local * n_shards + shard``
  (zero-based form of handler.cc:835);
- the two-phase match becomes: host-side global stats (the coordinator's
  term dictionary already sums per-shard termfreqs = add_prepared_mset),
  per-shard local top-k, the gather of every shard's top-k, re-top-k
  (= merge_mset), sums for counts/aggregates.

All shards must share array shapes; ``pad_uniform`` pads each shard's
segment to the max shapes (padding rows are flagged deleted, so they can
never match).

Differences from the JAX file:

- ``stack_segments`` stacks each array with a leading shard axis [S, ...]
  on the mesh's one device (``parallel/mesh.py``): every shard of a mesh is
  stacked on the card, where JAX shards the axis over the mesh's devices.
- ``make_sharded_step`` is no ``shard_map`` program: it runs the port's
  ``execute_batch`` once for each shard, on that shard's view of the
  stacked arrays with its ``cat_remap`` / ``sort_cat_remap`` rows, and
  hands the per-shard outputs to ``kernels.shard_merge`` (the stripe, the
  all_gather and the re-sort, K19) and ``kernels.shard_reduce`` (the psum /
  pmin / pmax). The plan arrays the JAX step closes over, shared by every
  query (agg plan arrays, sort targets and tables), are expanded to the
  batch's query axis. A batch whose rows would pass MESH_ROWS at once runs
  in sub-batches of queries (the answers are unchanged; JAX runs it as one
  program).
- ``pack_agg_parts`` concatenates torch tensors; the layout records numpy
  dtype names, so ``unpack_agg_parts`` is the JAX text on numpy.
- The step cache keeps each step closure with its uploaded shared arrays:
  PyTorch runs eagerly and compiles nothing.
- ``ShardedIndex.load_segments`` (commit's tail) takes one committed
  segment a shard built elsewhere (utils/synth_mesh.py).
- ``pad_uniform`` reads the longest posting list from a lazy term table's
  offsets column (``_max_posting_len``) rather than building every term's
  TermInfo.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from xapiand_tpu_torch.models.builder import SegmentBuilder
from xapiand_tpu_torch.models.segment import (Segment, geo_arrays, size_class,
                                              value_arrays)
from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.ops.executor import ExecConfig, execute_batch
from xapiand_tpu_torch.parallel.mesh import Mesh
from xapiand_tpu_torch.query.dsl import QueryDSL
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.query.plan import bind, compile_ir
from xapiand_tpu_torch.schema import Schema
from xapiand_tpu_torch.utils.hashing import fnv1ah64

_I32MAX = np.int32(2**31 - 1)
# rows of score_slices (queries x the per-query row width) one execute of a
# shard may take at once: ~20 bytes a row of transient tensors, ~2.7 GB
MESH_ROWS = 2**27


class MeshAggRefused(ValueError):
    """An aggregation kind outside MESH_AGG_KINDS: ShardedDatabase.search
    serves it on the per-segment path."""


# ---------------------------------------------------------------------------
# uniform padding + stacking
# ---------------------------------------------------------------------------

def pad_uniform(segments: list[Segment]) -> list[Segment]:
    nd_pad = max(s.num_docs for s in segments)
    # guard must cover the GLOBAL max posting-gather size class so a
    # dynamic_slice near any shard's data end stays in bounds unclamped
    guard = size_class(max(max(_max_posting_len(s) for s in segments), 1))
    p_pad = max(s.post_docids.shape[0] for s in segments) + guard
    pp_pad = max(s.positions.shape[0] for s in segments)
    all_slots = sorted({slot for s in segments for slot in s.values})
    all_geo = sorted({slot for s in segments for slot in s.geo})
    gr_pad = {slot: max((s.geo[slot].flat_start.shape[0]
                         for s in segments if slot in s.geo), default=64)
              for slot in all_geo}
    # slots where ANY shard has multi-value docs need uniform mv_* arrays
    # on every shard (SPMD pytree structure must match)
    vr_pad = {}
    for slot in all_slots:
        sizes = [s.values[slot].mv_hi.shape[0] for s in segments
                 if slot in s.values and s.values[slot].mv_hi is not None]
        if sizes:
            vr_pad[slot] = max(sizes)
    out = []
    for s in segments:
        out.append(_pad_one(s, nd_pad, p_pad, pp_pad, all_slots, all_geo,
                            gr_pad, vr_pad))
    return out


def _max_posting_len(s: Segment) -> int:
    """Segment.max_posting_len, read from a lazy term table's offsets
    column where it has one (no TermInfo built for its terms)."""
    cols = getattr(s.terms, "cols", None)
    if cols is not None and getattr(s.terms, "src", None) is not None:
        offs = np.asarray(cols[0])
        return int(np.diff(offs).max()) if offs.shape[0] > 1 else 0
    return s.max_posting_len()


def _pad_one(s: Segment, nd_pad, p_pad, pp_pad, all_slots, all_geo, gr_pad,
             vr_pad=None):
    import copy as _copy

    from xapiand_tpu_torch.models.segment import GeoColumn, ValueColumn

    def pad1(a, n, fill):
        if a.shape[0] >= n:
            return a
        out = np.full(n, fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    ns = _copy.copy(s)
    # postings: pad rows point at the dump row (nd_pad)
    ns.post_docids = pad1(np.where(s.post_docids == s.num_docs, nd_pad,
                                   s.post_docids).astype(np.int32),
                          p_pad, nd_pad)
    ns.post_wdf = pad1(s.post_wdf, p_pad, 0.0)
    ns.post_doclen = pad1(s.post_doclen, p_pad, 0.0)
    ns.post_posoff = pad1(s.post_posoff, p_pad, 0)
    ns.post_poslen = pad1(s.post_poslen, p_pad, 0)
    ns.positions = pad1(s.positions, pp_pad, 0)
    ns.doclen = pad1(s.doclen, nd_pad + 1, 0.0)
    uniq = s.uniqterms if s.uniqterms is not None \
        else np.ones_like(s.doclen)
    ns.uniqterms = pad1(uniq, nd_pad + 1, 1.0)
    deleted = np.ones(nd_pad + 1, dtype=bool)
    deleted[: s.num_docs] = s.deleted[: s.num_docs]
    deleted[nd_pad] = True
    ns.deleted = deleted
    ns.values = {}
    for slot in all_slots:
        col = s.values.get(slot)
        if col is None:
            ns.values[slot] = ValueColumn(
                kind="numeric",
                hi=np.full(nd_pad + 1, _I32MAX, np.int32),
                lo=np.full(nd_pad + 1, _I32MAX, np.int32),
                max_hi=np.full(nd_pad + 1, -(2**31), np.int32),
                max_lo=np.full(nd_pad + 1, -(2**31), np.int32),
                fval=np.zeros(nd_pad + 1, np.float32),
                present=np.zeros(nd_pad + 1, bool),
                cats=np.full(nd_pad + 1, -1, np.int32))
        else:
            nc = _copy.copy(col)
            nc.hi = pad1(col.hi, nd_pad + 1, _I32MAX)
            nc.lo = pad1(col.lo, nd_pad + 1, _I32MAX)
            nc.max_hi = pad1(col.max_hi, nd_pad + 1, -(2**31))
            nc.max_lo = pad1(col.max_lo, nd_pad + 1, -(2**31))
            nc.fval = pad1(col.fval, nd_pad + 1, 0.0)
            nc.present = pad1(col.present, nd_pad + 1, False)
            if col.cats is not None:
                nc.cats = pad1(col.cats, nd_pad + 1, -1)
            else:
                nc.cats = np.full(nd_pad + 1, -1, np.int32)
            if col.fval2 is not None:
                nc.fval2 = pad1(col.fval2, nd_pad + 1, 0.0)
            ns.values[slot] = nc
        if vr_pad and slot in vr_pad:
            nc = ns.values[slot]
            vr = vr_pad[slot]
            if nc.mv_hi is None:
                nc.mv_hi = np.full(vr, _I32MAX, np.int32)
                nc.mv_lo = np.full(vr, _I32MAX, np.int32)
                nc.mv_off = np.zeros(nd_pad + 1, np.int32)
                nc.mv_len = np.zeros(nd_pad + 1, np.int32)
            else:
                nc.mv_hi = pad1(nc.mv_hi, vr, _I32MAX)
                nc.mv_lo = pad1(nc.mv_lo, vr, _I32MAX)
                nc.mv_off = pad1(nc.mv_off, nd_pad + 1, 0)
                nc.mv_len = pad1(nc.mv_len, nd_pad + 1, 0)
    ns.geo = {}
    for slot in all_geo:
        g = s.geo.get(slot)
        if g is None:
            ns.geo[slot] = GeoColumn(
                flat_start=np.full(gr_pad[slot], _I32MAX, np.int32),
                flat_end=np.full(gr_pad[slot], -1, np.int32),
                doc_off=np.zeros(nd_pad + 1, np.int32),
                doc_len=np.zeros(nd_pad + 1, np.int32),
                max_doc_ranges=1)
        else:
            ng = _copy.copy(g)
            ng.flat_start = pad1(g.flat_start, gr_pad[slot], _I32MAX)
            ng.flat_end = pad1(g.flat_end, gr_pad[slot], -1)
            ng.doc_off = pad1(g.doc_off, nd_pad + 1, 0)
            ng.doc_len = pad1(g.doc_len, nd_pad + 1, 0)
            ns.geo[slot] = ng
    ns.num_docs = nd_pad
    return ns


def stack_segments(segments: list[Segment], mesh: Mesh) -> dict:
    """Stack uniform shards along a leading shard axis [S, ...] on the
    mesh's device, keyed as DeviceSegment.arrays_pytree()."""
    dev = mesh.device

    def shard_arr(arrs, dtype):
        return torch.from_numpy(np.stack([np.asarray(a, dtype)
                                          for a in arrs])).to(dev)

    out = {
        "post_docids": shard_arr([s.post_docids for s in segments],
                                 np.int32),
        "post_wdf": shard_arr([s.post_wdf for s in segments], np.float32),
        "post_doclen": shard_arr([s.post_doclen for s in segments],
                                 np.float32),
        "post_posoff": shard_arr([s.post_posoff for s in segments],
                                 np.int32),
        "post_poslen": shard_arr([s.post_poslen for s in segments],
                                 np.int32),
        "positions": shard_arr([s.positions for s in segments], np.int32),
        "doclen": shard_arr([s.doclen for s in segments], np.float32),
        "deleted": shard_arr([s.deleted for s in segments], np.bool_),
        "uniqterms": shard_arr(
            [s.uniqterms if s.uniqterms is not None
             else np.ones_like(s.doclen) for s in segments], np.float32),
        "values": {}, "geo": {},
    }
    for slot in segments[0].values:
        cols = [s.values[slot] for s in segments]
        v = out["values"][slot] = {
            ch: shard_arr([getattr(c, ch) for c in cols], dt)
            for ch, dt in (("hi", np.int32), ("lo", np.int32),
                           ("max_hi", np.int32), ("max_lo", np.int32),
                           ("fval", np.float32), ("present", np.bool_),
                           ("cats", np.int32))}
        if any(c.fval2 is not None for c in cols):
            v["fval2"] = shard_arr(
                [c.fval2 if c.fval2 is not None
                 else np.zeros_like(c.fval) for c in cols], np.float32)
        if all(c.mv_hi is not None for c in cols):
            for ch in ("mv_hi", "mv_lo", "mv_off", "mv_len"):
                v[ch] = shard_arr([getattr(c, ch) for c in cols], np.int32)
        # each shard's packed keys and codes (its own distinct keys); the
        # code tables padded to the widest shard's K, whose pad no code
        # reaches
        va = [value_arrays({ch: getattr(c, ch) for ch in
                            ("hi", "lo", "max_hi", "max_lo", "present")})
              for c in cols]
        K = max(a["code_hll"].shape[0] for a in va)
        for a in va:
            a["code_hll"] = np.pad(a["code_hll"],
                                   (0, K - a["code_hll"].shape[0]))
        for ch in ("keys", "codes", "code_hll"):
            v[ch] = shard_arr([a[ch] for a in va], np.int32)
    for slot in segments[0].geo:
        gs = [geo_arrays(s.geo[slot]) for s in segments]
        out["geo"][slot] = {ch: shard_arr([g[ch] for g in gs], np.int32)
                            for ch in gs[0]}
    return out


def shard_view(tree, s: int):
    """Shard s's arrays of a stacked generation (contiguous views)."""
    if isinstance(tree, dict):
        return {k: shard_view(v, s) for k, v in tree.items()}
    return tree[s]


def stacked_nbytes(tree) -> int:
    """Device bytes of a stacked generation."""
    if isinstance(tree, dict):
        return sum(stacked_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# mesh aggregations: pack sufficient statistics into three flat vectors so
# the cross-shard merge is exactly psum/pmin/pmax over ICI
# (≙ AggregationMatchSpy::merge_results, handler.cc:1543-1545)
# ---------------------------------------------------------------------------

MESH_AGG_KINDS = ("count", "sum", "avg", "min", "max", "variance",
                  "std_deviation", "stats", "extended_stats", "histogram",
                  "range", "geodist_range", "missing", "geo_stats",
                  "terms", "cardinality",
                  # order statistics psum as fixed-grid histograms
                  # (aggregations.ORDER_STAT_BINS)
                  "median", "mode", "percentiles")

_MIN_KEYS = ("min", "minlat", "minlon")
_MAX_KEYS = ("max", "maxlat", "maxlon",
             # cardinality: exact lower bound + HLL registers merge by max
             "maxn", "hll")
_DTYPE_NAMES = {torch.int32: "int32", torch.float32: "float32",
                torch.bool: "bool", torch.int64: "int64"}


def _agg_leaves(part):
    """Deterministic (key-path, leaf, merge-rule) walk of one agg part."""
    out = []

    def walk(p, prefix):
        if isinstance(p, dict):
            for kk in sorted(p.keys()):
                if kk == "subs":
                    for si, sub in enumerate(p[kk]):
                        walk(sub, prefix + (kk, si))
                else:
                    rule = "min" if kk in _MIN_KEYS else \
                        "max" if kk in _MAX_KEYS else "sum"
                    out.append((prefix + (kk,), p[kk], rule))
        else:
            out.append((prefix, p, "sum"))

    walk(part, ())
    return out


def pack_agg_parts(specs, aggs):
    """aggs: tuple of per-agg parts with [Q, ...] leaves -> three [Q, W]
    vectors (sum-merged, min-merged, max-merged) + the static layout."""
    packs = {"sum": [], "min": [], "max": []}
    layout = []
    for spec, part in zip(specs, aggs):
        entry = []
        for path, leaf, rule in _agg_leaves(part):
            leaf2 = leaf.to(torch.float32)
            if leaf2.dim() == 1:
                leaf2 = leaf2[:, None]
            else:
                leaf2 = leaf2.reshape(leaf2.shape[0], -1)
            entry.append((path, rule, len(packs[rule]),
                          leaf2.shape[1], _DTYPE_NAMES[leaf.dtype],
                          tuple(leaf.shape[1:])))
            packs[rule].append(leaf2)
        layout.append(entry)
    packed = {}
    for rule, parts in packs.items():
        if parts:
            packed[rule] = torch.cat(parts, dim=1)
        else:
            packed[rule] = None
    return packed, layout


def unpack_agg_parts(layout, packed_np):
    """Inverse of pack_agg_parts on host numpy arrays; returns per-query
    lists of agg parts shaped like compute_aggs outputs."""
    offs = {"sum": 0, "min": 0, "max": 0}
    # compute per-leaf slices in pack order (layout preserves it)
    parts_per_agg = []
    for entry in layout:
        leaves = {}
        for path, rule, idx, width, dtype, tail in entry:
            arrs = packed_np[rule]
            sl = arrs[:, offs[rule]: offs[rule] + width]
            offs[rule] += width
            if tail:
                sl = sl.reshape(sl.shape[0], *tail)
            else:
                sl = sl[:, 0]
            leaves[path] = sl.astype(dtype) if dtype != "float32" else sl
        parts_per_agg.append(leaves)

    def rebuild(leaves, qi):
        root: dict = {}
        plain = None
        for path, arr in leaves.items():
            v = arr[qi]
            if path == ():
                plain = v
                continue
            node = root
            for p in path[:-1]:
                if p == "subs":
                    node = node.setdefault("subs", {})
                elif isinstance(p, int):
                    node = node.setdefault(p, {})
                else:
                    node = node.setdefault(p, {})
            node[path[-1]] = v
        if plain is not None:
            return plain
        if "subs" in root:
            subs_map = root.pop("subs")
            root["subs"] = [subs_map[i] for i in sorted(subs_map)]
        return root

    def per_query(qi):
        return tuple(rebuild(leaves, qi) for leaves in parts_per_agg)

    return per_query


# ---------------------------------------------------------------------------
# the search step
# ---------------------------------------------------------------------------

def _expand(tree, q: int):
    """A shared plan array (or dict of them) with the batch's query axis."""
    if isinstance(tree, dict):
        return {k: _expand(v, q) for k, v in tree.items()}
    return tree.unsqueeze(0).expand(q, *tree.shape).contiguous()


def make_sharded_step(cfg: ExecConfig, scheme, mesh: Mesh, n_shards: int,
                      agg_arrays=None, layout_out: dict | None = None,
                      cat_remaps=None, sort_remaps=None):
    """The batch search step over a stacked generation.

    plan arrays: offsets/lens [Q, S, T]; tconst/scoring/group_bits [Q, T]
    (tconst [Q, T, C] for a scheme of C constants); fparams [Q, F, 4];
    syn_tconst [Q, NS(, C)]; geo_queries per geo leaf [Q, QR, 2] - torch
    tensors on the mesh's device. Returns global docids/scores [Q, k] +
    counts [Q] (+ the packed agg sufficient statistics, psum/pmin/pmax-
    merged over the shards). agg_arrays: {"agg_params": {i: arr},
    "agg_ranges": {i: arr}, "sort_targets": arr, "sort_strtabs": {si:
    arr}} shared across queries (torch tensors on the device);
    layout_out captures the static pack layout for host-side unpacking;
    cat_remaps / sort_remaps: {spec index: i32[S, n]} local -> global
    category codes, a row per shard.
    """
    agg_arrays = agg_arrays or {}
    cat_remaps = cat_remaps or {}
    sort_remaps = sort_remaps or {}

    def step(seg, offsets, lens, tconst, scoring, group_bits, stats,
             fparams, syn_tconst, geo_queries):
        nq = offsets.shape[0]
        rows = seg["doclen"].shape[1] if cfg.dense else \
            max(sum(p or c for p, c in zip(
                cfg.prefix or (0,) * cfg.T, cfg.term_classes())), 1)
        qb = max(1, min(nq, MESH_ROWS // rows))
        tops, scs, cnts, packs = [], [], [], []
        for q0 in range(0, nq, qb):
            q1 = min(nq, q0 + qb)
            shared = {kk: _expand(vv, q1 - q0)
                      for kk, vv in agg_arrays.items()}
            outs = []
            for s in range(n_shards):
                seg1 = shard_view(seg, s)
                # per-shard local->global category remap rows
                batch = {"offsets": offsets[q0:q1, s].contiguous(),
                         "lens": lens[q0:q1, s].contiguous(),
                         "tconst": tconst[q0:q1], "scoring": scoring[q0:q1],
                         "group_bits": group_bits[q0:q1]}
                if cfg.n_filters:
                    batch["fparams"] = fparams[q0:q1]
                if cfg.geo_specs:
                    batch["geo_queries"] = [g[q0:q1] for g in geo_queries]
                if cfg.syn_groups:
                    batch["syn_tconst"] = syn_tconst[q0:q1]
                if cat_remaps:
                    batch["cat_remap"] = {j: r[s]
                                          for j, r in cat_remaps.items()}
                if sort_remaps:
                    batch["sort_cat_remap"] = {si: r[s] for si, r in
                                               sort_remaps.items()}
                batch.update(shared)
                outs.append(execute_batch(seg1, batch, cfg, stats, scheme))
            counts = kernels.shard_reduce(
                torch.stack([o["count"].to(torch.int32) for o in outs]),
                "sum")
            z = torch.zeros((q1 - q0, 1), dtype=torch.float32,
                            device=offsets.device)
            agg_packed = (z, z, z)
            if cfg.with_aggs:
                per = [pack_agg_parts(cfg.with_aggs, o["aggs"])
                       for o in outs]
                if layout_out is not None:
                    layout_out["layout"] = per[0][1]
                agg_packed = tuple(
                    kernels.shard_reduce(torch.stack(
                        [p[0][rule] for p in per]), rule)
                    if per[0][0][rule] is not None else z
                    for rule in ("sum", "min", "max"))
            skeys = None
            if cfg.sort and "sort_keys" in outs[0]:
                # value-ordered merge: re-sort the gathered union by the
                # same keys with the insertion-order / global-docid tiebreak
                # (merge_mset with a KeyMaker)
                skeys = torch.stack([o["sort_keys"] for o in outs])
            top_docs, top_scores = kernels.shard_merge(
                torch.stack([o["docids"] for o in outs]),
                torch.stack([o["scores"] for o in outs]),
                seg.get("orderkey"), skeys)
            tops.append(top_docs)
            scs.append(top_scores)
            cnts.append(counts)
            packs.append(agg_packed)
        return (torch.cat(tops), torch.cat(scs), torch.cat(cnts),
                tuple(torch.cat([p[i] for p in packs]) for i in range(3)))

    return step


# ---------------------------------------------------------------------------
# ShardedIndex
# ---------------------------------------------------------------------------

class ShardedIndex:
    """N-shard index over a device mesh; single coordinator host.

    ≙ an IndexSettings of num_shards local shards (index_resolver_lru.h:41)
    with the DatabaseHandler's routing + scatter-gather."""

    def __init__(self, n_shards: Optional[int] = None,
                 mesh: Optional[Mesh] = None, scheme: str = "bm25",
                 schema: Optional[Schema] = None, path: Optional[str] = None):
        import os

        from xapiand_tpu_torch.parallel.mesh import make_mesh

        self.mesh = mesh or make_mesh(n_shards)
        self.n_shards = n_shards or self.mesh.shape["shard"]
        self.n_dp = self.mesh.shape["dp"]
        self.schema = schema or Schema()
        self.scheme = get_scheme(scheme)
        self._builders = [SegmentBuilder() for _ in range(self.n_shards)]
        self.segments: list[Segment] = []
        self._stacked = None
        self._step_cache: dict = {}
        self._docs: dict[str, dict] = {}
        self._locate: dict[str, tuple[int, int]] = {}   # id -> (shard, did)
        self._deleted_ids: set[str] = set()
        self._wals = None
        if path is not None:
            from xapiand_tpu_torch.index.wal import DatabaseWAL

            self._wals = []
            for i in range(self.n_shards):
                d = os.path.join(path, f"shard_{i}", "wal")
                os.makedirs(d, exist_ok=True)
                self._wals.append(DatabaseWAL(d))
            self._replay()

    def _replay(self):
        """Per-shard WAL replay on open (≙ DatabaseWAL::execute_line,
        wal.cc:506; each shard keeps its own redo log)."""
        from xapiand_tpu_torch.index.wal import WalOp

        any_ops = False
        for wal in self._wals:
            def apply(entry):
                nonlocal any_ops
                op = entry[0]
                if op == WalOp.REPLACE_DOCUMENT:
                    self.index_document(entry[2], doc_id=entry[1],
                                        _log=False)
                    any_ops = True
                elif op == WalOp.DELETE_DOCUMENT:
                    self.delete_document(entry[1], _log=False,
                                         missing_ok=True)
                    any_ops = True
                elif op == WalOp.SET_SCHEMA:
                    self.schema = Schema.from_dict(entry[1])

            wal.replay(apply)
        if any_ops:
            self.commit(_log=False)

    # -- routing (fnv1ah64 % n, handler.cc:2004) -----------------------------

    def route(self, doc_id: str) -> int:
        return fnv1ah64("Q" + str(doc_id)) % self.n_shards

    def index_document(self, obj: dict, doc_id: Optional[str] = None,
                       _log: bool = True) -> str:
        idoc = self.schema.index(
            obj, doc_id,
            defer_text=getattr(self._builders[0], "wants_deferred_text",
                               False))
        shard = self.route(idoc.doc_id)
        if self._wals is not None and _log:
            self._wals[shard].write_replace_document(idoc.doc_id, obj)
        self._builders[shard].add(idoc)
        self._docs[idoc.doc_id] = idoc.data
        self._deleted_ids.discard(idoc.doc_id)
        return idoc.doc_id

    def delete_document(self, doc_id: str, missing_ok: bool = False,
                        _log: bool = True) -> bool:
        doc_id = str(doc_id)
        known = doc_id in self._docs
        if not known and not missing_ok:
            raise KeyError(doc_id)
        shard = self.route(doc_id)
        if self._wals is not None and _log:
            self._wals[shard].write_delete_document(doc_id)
        self._deleted_ids.add(doc_id)
        self._docs.pop(doc_id, None)
        loc = self._locate.get(doc_id)
        if loc is not None and self.segments:
            si, did = loc
            self.segments[si].deleted[did] = True
            if self._stacked is not None:
                # refresh only the delete bitmaps on device
                self._stacked["deleted"] = torch.from_numpy(
                    np.stack([s.deleted for s in self.segments])).to(
                        self.mesh.device)
        return known

    def commit(self, _log: bool = True):
        if self._wals is not None and _log:
            for wal in self._wals:
                if self.schema.mutated:
                    wal.write_set_schema(self.schema.to_dict())
                wal.write_commit(fsync=True)
            self.schema.mutated = False
        segs = [b.finalize() for b in self._builders]
        # duplicates (re-added ids) and pre-commit deletes: last write wins
        for si, seg in enumerate(segs):
            last: dict = {}
            for did, key in enumerate(seg.doc_keys):
                last[key] = did
            for did, key in enumerate(seg.doc_keys):
                if last[key] != did or key in self._deleted_ids:
                    seg.deleted[did] = True
        self.load_segments(segs)

    def load_segments(self, segs: list[Segment]):
        """Pad, locate and stack one committed segment a shard (commit's
        tail; utils/synth_mesh.py hands its built shards here)."""
        segs = pad_uniform(segs)
        self.segments = segs
        self._locate = {}
        for si, seg in enumerate(segs if self._docs else ()):
            for did, key in enumerate(seg.doc_keys):
                if not seg.deleted[did] and key in self._docs:
                    self._locate[key] = (si, did)
        self._stacked = stack_segments(segs, self.mesh)
        self._step_cache.clear()

    def close(self):
        if self._wals is not None:
            for wal in self._wals:
                wal.close()

    # -- stats (global = the merged prepare_mset stats) -----------------------

    def stats(self) -> CollectionStats:
        n = sum(s.doc_count for s in self.segments)
        tot = sum(s.total_doclen for s in self.segments)
        upper = max((float(s.doclen[:s.num_docs].max())
                     for s in self.segments if s.num_docs), default=1.0)
        return CollectionStats(doc_count=n, avg_doclen=tot / n if n else 0.0,
                               doclen_lower=1.0, doclen_upper=upper,
                               total_len=tot)

    def global_termfreq(self, term: str) -> int:
        return sum(ti.length for s in self.segments
                   if (ti := s.get_term(term)) is not None)

    def global_collfreq(self, term: str) -> int:
        return sum(ti.collfreq for s in self.segments
                   if (ti := s.get_term(term)) is not None)

    # -- search ----------------------------------------------------------------

    def search_batch(self, queries: list, k: int = 10,
                     aggs: Optional[dict] = None,
                     sort=None) -> list[dict]:
        """Relevance-ordered batch search over mixed query shapes.

        Queries are bucketed by plan signature (compilation shape) and each
        bucket runs as one mesh step - the library owns the shape
        grouping, so real mixed traffic never fails on heterogeneous
        batches (SURVEY §7 bucketed compilation).

        aggs: shared aggregation spec; sufficient statistics merge across
        shards as psum/pmin/pmax (shard_reduce) inside the step (the
        collective form of AggregationMatchSpy::merge_results)."""
        if self._stacked is None:
            raise RuntimeError("commit() before searching")
        from xapiand_tpu_torch.query.plan import resolve_special

        dsl = QueryDSL(self.schema)
        stats = self.stats()
        irs = [resolve_special(q if isinstance(q, Q) else dsl.parse(q),
                               self.scheme, stats, self.global_termfreq,
                               self.global_collfreq) for q in queries]
        buckets: dict = {}
        for qi, ir in enumerate(irs):
            buckets.setdefault(ir.signature(), []).append(qi)
        ex = MeshExecutor(self.mesh, self.n_shards, self.scheme,
                          self._step_cache)
        S = self.n_shards
        results: list = [None] * len(queries)
        for idxs in buckets.values():
            raw = ex.run(self.segments, self._stacked, self.schema, stats,
                         self.global_termfreq, self.global_collfreq,
                         [irs[i] for i in idxs], k, aggs=aggs, sort=sort)
            for bi, qi in enumerate(idxs):
                hits = []
                for gd, sc in zip(raw["docids"][bi], raw["scores"][bi]):
                    if not np.isfinite(sc) and sc < 0:
                        continue
                    if gd == 2**31 - 1:
                        continue
                    shard, local = int(gd) % S, int(gd) // S
                    seg = self.segments[shard]
                    if local >= len(seg.doc_keys):
                        continue
                    key_ = seg.doc_keys[local]
                    hits.append({"id": key_, "score": float(sc),
                                 "data": self._docs.get(key_, {})})
                out_q = {"total": int(raw["counts"][bi]), "hits": hits}
                if raw["shaped_aggs"] is not None:
                    out_q["aggregations"] = raw["shaped_aggs"][bi]
                results[qi] = out_q
        return results

    def search(self, query, k: int = 10, aggs: Optional[dict] = None,
               sort=None) -> dict:
        return self.search_batch([query], k=k, aggs=aggs, sort=sort)[0]


def _global_codes(segments, slot, n_shards):
    """(global names, remap i32[S, nbl]): the shards' category names of a
    slot unified in first-seen order, and each shard's local -> global
    code row (-1 past its names)."""
    global_names: list = []
    gcode: dict = {}
    local_tabs = []
    nbl = 16
    for seg in segments:
        col = seg.values.get(slot)
        names_l = (col.cat_names or []) if col is not None else []
        tab = []
        for nm in names_l:
            if nm not in gcode:
                gcode[nm] = len(global_names)
                global_names.append(nm)
            tab.append(gcode[nm])
        local_tabs.append(tab)
        while nbl < len(names_l):
            nbl *= 2
    remap = np.full((n_shards, nbl), -1, np.int32)
    for si, tab in enumerate(local_tabs):
        remap[si, : len(tab)] = tab
    return global_names, remap


class MeshExecutor:
    """The scatter-gather engine over one generation of stacked,
    uniform-padded per-shard segments. Shared by ShardedIndex (library
    mesh plane) and ShardedDatabase (REST-on-mesh): plan binding, agg
    packing, category unification, the step cache, and the step's launch
    live here; callers own documents/hydration.

    ≙ DocMatcher two-phase scatter-gather (handler.cc:1415-1553) with the
    merge running as the shard_merge kernel instead of a coordinator loop."""

    def __init__(self, mesh: Mesh, n_shards: int, scheme,
                 step_cache: Optional[dict] = None):
        self.mesh = mesh
        self.n_shards = n_shards
        self.n_dp = mesh.shape["dp"]
        self.scheme = scheme
        self._step_cache = step_cache if step_cache is not None else {}
        # host seconds of the last run's binds (chip_smoke.py reads it)
        self.bind_seconds = 0.0

    def run(self, segments, stacked, schema, stats, global_tf, global_cf,
            irs: list, k: int, aggs: Optional[dict] = None, sort=None,
            scheme=None, slot_ranges=None, collapse_slot=None,
            collapse_max: int = 1) -> dict:
        """Execute a same-signature batch of Q IRs over the mesh.

        Returns {"docids": [nq,k] global-striped int, "scores": [nq,k],
        "counts": [nq], "agg_parts": per-query parts fn or None,
        "shaped_aggs": list per query or None, "agg_names"/"agg_metas"/
        "mesh_cats" for callers that merge across generations}."""
        import time

        from xapiand_tpu_torch.query.plan import resolve_special, unify_cfgs

        scheme = scheme or self.scheme
        dev = self.mesh.device
        agg_specs, agg_arrays, agg_names, agg_metas = (), {}, None, None
        cat_remaps: dict = {}
        cat_names: dict = {}
        if aggs:
            from xapiand_tpu_torch import aggregations as aggs_mod
            from xapiand_tpu_torch.aggregations import _cat_bucket

            (agg_names, agg_specs, arrs,
             agg_metas) = aggs_mod.compile_for_segment(
                schema, list(segments), aggs, slot_ranges=slot_ranges)
            bad = [s[0] for s in agg_specs if s[0] not in MESH_AGG_KINDS]
            if bad:
                raise MeshAggRefused(
                    f"aggregations {bad} are not supported on the mesh "
                    f"batch path (supported: {MESH_AGG_KINDS})")
            agg_arrays = arrs
            # terms buckets: unify per-shard category code spaces into one
            # global table; each shard carries a local->global remap array
            agg_specs = list(agg_specs)
            for j, spec in enumerate(agg_specs):
                if spec[0] != "terms":
                    continue
                global_names, remap = _global_codes(segments, spec[1],
                                                    self.n_shards)
                nbg = _cat_bucket(max(len(global_names), 1))
                cat_remaps[j] = remap
                cat_names[j] = global_names
                agg_specs[j] = ("terms", spec[1], nbg, spec[3])
                agg_metas[j]["cat_names"] = global_names
            agg_specs = tuple(agg_specs)

        sort_t = ()
        sort_overrides: dict = {}
        sort_remaps: dict = {}
        if sort:
            from xapiand_tpu_torch.query.dsl import parse_sort

            sort_t = sort if isinstance(sort, tuple) \
                else parse_sort(schema, sort)
            for si, spec in enumerate(sort_t):
                if spec[0] != "strmetric":
                    continue
                # one GLOBAL category metric table + per-shard local->
                # global remaps (same scheme as terms aggregations)
                from xapiand_tpu_torch.utils import strmetrics

                metric, target = spec[3]
                global_names, remap = _global_codes(segments, spec[1],
                                                    self.n_shards)
                nbg = 16
                while nbg < len(global_names):
                    nbg *= 2
                gtab = np.full(nbg, np.inf, np.float32)
                for code, nm in enumerate(global_names):
                    gtab[code] = 1.0 - strmetrics.similarity(
                        str(nm), target, metric)
                sort_overrides[si] = gtab
                sort_remaps[si] = remap

        irs = [resolve_special(ir, scheme, stats, global_tf, global_cf)
               for ir in irs]
        cqs = [compile_ir(ir, cost_fn=global_tf) for ir in irs]
        sigs = {ir.signature() for ir in irs}
        if len(sigs) != 1:
            raise ValueError("search_batch requires same-shape queries")
        stats_d = {"N": float(stats.doc_count),
                   "avg_doclen": float(stats.avg_doclen),
                   "doclen_lower": 1.0,
                   "doclen_upper": float(stats.doclen_upper),
                   "total_len": float(stats.total_len)}

        nq = len(irs)
        q_pad = -(-nq // self.n_dp) * self.n_dp
        cqs = cqs + [cqs[-1]] * (q_pad - nq)

        t0 = time.perf_counter()
        bounds = []
        for cq in cqs:
            per_shard = [bind(cq, seg, scheme, stats,
                              global_tf=global_tf, k=k,
                              global_cf=global_cf,
                              aggs=agg_specs, sort=sort_t,
                              collapse_slot=collapse_slot,
                              collapse_max=collapse_max,
                              sort_strtabs_override=sort_overrides or None)
                         for seg in segments]
            bounds.append(per_shard)
        self.bind_seconds = time.perf_counter() - t0
        cfg = unify_cfgs([b.cfg for per in bounds for b in per], k=k)
        if sort_t:
            import dataclasses as _dc

            cfg = _dc.replace(cfg, emit_sort_keys=True)
        T = cfg.T
        S = self.n_shards
        offsets = np.zeros((q_pad, S, T), np.int32)
        lens = np.zeros((q_pad, S, T), np.int32)
        C = getattr(scheme, "n_constants", 1)
        tconst = np.zeros((q_pad, T) if C == 1 else (q_pad, T, C),
                          np.float32)
        scoring = np.zeros((q_pad, T), np.float32)
        gbits = np.zeros((q_pad, T), np.int32)
        n_filters = bounds[0][0].cfg.n_filters
        fparams = np.zeros((q_pad, max(n_filters, 1), 4), np.int32) \
            if n_filters else None
        for qi, per_shard in enumerate(bounds):
            for si, b in enumerate(per_shard):
                t = b.arrays["offsets"].shape[0]
                offsets[qi, si, :t] = b.arrays["offsets"]
                lens[qi, si, :t] = b.arrays["lens"]
            b0 = per_shard[0].arrays
            t = b0["tconst"].shape[0]
            tconst[qi, :t] = b0["tconst"]
            scoring[qi, :t] = b0["scoring"]
            gbits[qi, :t] = b0["group_bits"]
            if n_filters:
                fparams[qi] = b0["fparams"]

        shared_plan = dict(agg_arrays)
        st = bounds[0][0].arrays.get("sort_targets")
        if st is not None:
            shared_plan["sort_targets"] = st
        stt = bounds[0][0].arrays.get("sort_strtabs")
        if stt is not None:
            shared_plan["sort_strtabs"] = stt   # global tables (overrides)

        def leaves(tree):
            if isinstance(tree, dict):
                for kk in sorted(tree, key=str):
                    yield from leaves(tree[kk])
            else:
                yield np.asarray(tree)

        digest = tuple(leaf.tobytes() for leaf in leaves(
            {"p": shared_plan, "c": cat_remaps, "s": sort_remaps})) \
            if (shared_plan or cat_remaps or sort_remaps) else ()
        key = (cfg, scheme.key(), digest)
        cached = self._step_cache.get(key)
        if cached is None:
            layout_holder: dict = {}

            def up(tree):
                if isinstance(tree, dict):
                    return {kk: up(v) for kk, v in tree.items()}
                return torch.from_numpy(np.array(tree)).to(dev)

            step = make_sharded_step(cfg, scheme, self.mesh, S,
                                     agg_arrays=up(shared_plan),
                                     layout_out=layout_holder,
                                     cat_remaps=up(cat_remaps),
                                     sort_remaps=up(sort_remaps))
            cached = (step, layout_holder)
            self._step_cache[key] = cached
        step, layout_holder = cached
        if fparams is None:
            fparams = np.zeros((q_pad, 1, 4), np.int32)
        n_syn = len(cfg.syn_groups)
        syn = np.zeros((q_pad, max(n_syn, 1)) if C == 1
                       else (q_pad, max(n_syn, 1), C), np.float32)
        if n_syn:
            for qi, per_shard in enumerate(bounds):
                st = per_shard[0].arrays.get("syn_tconst")
                if st is not None:
                    syn[qi, : st.shape[0]] = st
        # geo leaves: per-query HTM range tables, padded to the unified QR
        # with INVALID rows (start > end), shared by the shards (the
        # query geometry is global; doc-side ranges live in the segments)
        geo_batched = []
        for gi, (_slot, QR, _rm) in enumerate(cfg.geo_specs):
            rows = []
            for qi in range(q_pad):
                b0 = bounds[qi][0].arrays
                q = np.asarray(b0["geo_queries"][gi])
                if q.shape[0] < QR:
                    padq = np.full((QR, 2), 2**31 - 1, np.int32)
                    padq[: q.shape[0]] = q
                    q = padq
                rows.append(q)
            geo_batched.append(torch.from_numpy(np.stack(rows)).to(dev))

        def t(a):
            return torch.from_numpy(a).to(dev)

        top_docs, top_scores, counts, agg_packed = step(
            stacked, t(offsets), t(lens), t(tconst), t(scoring), t(gbits),
            stats_d, t(fparams), t(syn), tuple(geo_batched))
        out = {"docids": top_docs.cpu().numpy()[:nq],
               "scores": top_scores.cpu().numpy()[:nq],
               "counts": counts.cpu().numpy()[:nq],
               "agg_parts": None, "shaped_aggs": None,
               "agg_names": agg_names, "agg_metas": agg_metas,
               "mesh_cats": cat_names}
        if aggs and layout_holder.get("layout") is not None:
            from xapiand_tpu_torch import aggregations as aggs_mod

            packed_np = {"sum": agg_packed[0].cpu().numpy()[:nq],
                         "min": agg_packed[1].cpu().numpy()[:nq],
                         "max": agg_packed[2].cpu().numpy()[:nq]}
            per_query = unpack_agg_parts(layout_holder["layout"], packed_np)
            out["agg_parts"] = per_query
            out["shaped_aggs"] = [
                aggs_mod.merge_and_shape(agg_names, agg_metas,
                                         [per_query(qi)], [cat_names])
                for qi in range(nq)]
        return out
