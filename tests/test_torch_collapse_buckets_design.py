"""The decomposition the redesigned collapse_rows (K10) kernel relies on,
held on the CPU against its plain version and JAX. JAX is imported inside
the tests that run it.

  collapse_rows  csrc/collapse_rows.cu's tiles: each tile block takes the
                 chunks g, g + G, ... of a query's rows and keeps, per key
                 of an open-addressed table of TS slots, its best cmax
                 packed words (cr_pack), chunk by chunk, by cmax rounds
                 that admit only words below the previous round's winner
                 (the chunk's rows and the earlier chunks' words); one
                 block a query merges the blocks' lists by the same rounds
                 and ranks the query's distinct keys; the out pass gives
                 keep (the word against its key's cmax-th) and tie (rank x
                 cmax + the key's words above it, cut at cmax - 1). An
                 emulation of that, the table slot by slot (mix64, linear
                 probing, the reserved slot of the all-ones key), equals
                 _collapse_rows_plain bit for bit: 1-40 keys and docid-like
                 keys, an absent slot, cmax 1, 3, 8 and 9, row_order, NaN
                 and tied scores, the all-ones key; a table that would
                 overflow raises (the kernel traps), and collapse_plan's
                 table never does. JAX's _collapse keeps the same rows in
                 the same order of equal scores.
  collapse_plan  the rule between the tiles and the global design at the
                 captured launches' shapes, and the column's distinct
                 count, cached while the column lives unchanged.
  agg_buckets    csrc/agg_buckets.cu's sub statistics: each of a block's 8
                 warps queues its groups' eligible rows in row order and
                 sums them in batches of 32 (a code's lanes in lane order)
                 into its own partials; the warps added in warp order, the
                 blocks in block order - in float32. An
                 emulation of that association is within rtol 1e-5 of
                 _sub_stats_plain (float64 sums) and of JAX's
                 _sub_stats_bucketed, in every bucket mode, a nested
                 level, a mesh remap, count subs, 1 and 3 blocks, a spec
                 of 2,400 buckets; n, min and max exactly (a sum s of
                 values of both signs within 1e-5 of their sum of
                 |value|).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xapiand_tpu_torch.ops import kernels

SENTINEL = kernels.SENTINEL
I32MAX = kernels.I32MAX
EMPTY = (1 << 64) - 1
ORDER = 0x8000000080000000
M64 = (1 << 64) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# collapse_rows: tiles, a merge sized by the keys, an out pass
# --------------------------------------------------------------------------

def fkey(s):
    """csrc/common.cuh fkey for float32 s (not NaN): -0.0 as +0.0, the
    sign bit flipped for positives, every bit for negatives."""
    u = int(np.float32(s).view(np.uint32)) if s != 0 else 0
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def cr_pack(s, d):
    """csrc/collapse_rows.cu cr_pack: (score desc, docid or row asc) as one
    word, larger is better; a NaN score the worst."""
    hi = 0 if np.isnan(s) else fkey(s)
    return (hi << 32) | (~int(d) & 0xFFFFFFFF)


def mix64(x):
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & M64
    x ^= x >> 33
    return x


class Table:
    """An open-addressed table of TS slots as the kernels keep it: linear
    probing from mix64(key), the all-ones key in the reserved slot TS; a
    full table raises where the kernel traps."""

    def __init__(self, ts, cmax):
        self.ts, self.cmax = ts, cmax
        self.keys = [EMPTY] * ts
        self.words = [[0] * cmax for _ in range(ts + 1)]

    def slot(self, key, insert=True):
        if key == EMPTY:
            return self.ts
        h = mix64(key) & (self.ts - 1)
        for _ in range(self.ts):
            if self.keys[h] == key:
                return h
            if self.keys[h] == EMPTY:
                if not insert:
                    break
                self.keys[h] = key
                return h
            h = (h + 1) & (self.ts - 1)
        raise OverflowError("collapse table full: the kernel traps")

    def used(self):
        return [s for s in range(self.ts) if self.keys[s] != EMPTY] + \
            ([self.ts] if self.words[self.ts][0] else [])

    def key(self, s):
        return self.keys[s] if s < self.ts else EMPTY


def below(words, lim):
    """ct_below: a descending list's first word under lim, or 0."""
    return next((x for x in words if x < lim), 0)


def rounds(table, cands):
    """cmax rounds into table.words (cleared): round j's word of a slot is
    the largest candidate below round j - 1's; cands: (slot, descending
    words) - a row is one word, an earlier chunk's or a tile's list
    cmax."""
    cm = table.cmax
    w = table.words = [[0] * cm for _ in range(table.ts + 1)]
    for j in range(cm):
        for s, words in cands:
            x = below(words, w[s][j - 1] if j else EMPTY + 1)
            w[s][j] = max(w[s][j], x)


def rows_of(ids, sums, elig, col, row_order):
    """Per query the grouped rows: (row, key, packed word)."""
    hi, lo, present = (col[c].numpy() for c in ("hi", "lo", "present"))
    n = hi.shape[0]
    out = []
    for b in range(ids.shape[0]):
        rows = []
        for r in range(ids.shape[1]):
            if not elig[b, r]:
                continue
            d = int(ids[b, r])
            dd = min(d, n - 1)
            if present[dd]:
                key = ((int(hi[dd]) & 0xFFFFFFFF) << 32) | \
                    (int(lo[dd]) & 0xFFFFFFFF)
                rows.append((r, key, cr_pack(float(sums[b, r]),
                                             r if row_order else d)))
        out.append(rows)
    return out


def merge_lists(ts, cmax, lists):
    """One table from several blocks' (key, words) lists by the rounds."""
    tab = Table(ts, cmax)
    rounds(tab, [(tab.slot(key), words) for lst in lists
                 for key, words in lst])
    return tab


def collapse_tiles_emulated(ids, sums, elig, col, cmax, row_order, ts, G,
                            chunk=kernels.COLLAPSE_CHUNK):
    """keep, tie as csrc/collapse_rows.cu's tiles give them: G blocks a
    query, each block's table written as a list, the lists merged."""
    cmax = min(cmax, kernels.MAX_COLLAPSE)
    B, R = ids.shape
    ids_, sums_, elig_ = ids.numpy(), sums.numpy(), elig.numpy()
    keep = elig_.copy()
    tie = np.full((B, R), I32MAX, np.int32)
    for b, rows in enumerate(rows_of(ids_, sums_, elig_, col, row_order)):
        by_chunk = {}
        for r, key, p in rows:
            by_chunk.setdefault(r // chunk, []).append((key, p))
        lists = []
        for g in range(G):
            tab = Table(ts, cmax)
            for c in range(g, -(-R // chunk), G):
                old = [(s, list(tab.words[s])) for s in tab.used()]
                cands = [(tab.slot(key), [p]) for key, p in
                         by_chunk.get(c, [])]
                rounds(tab, cands + old)
            lists.append([(tab.key(s), list(tab.words[s]))
                          for s in tab.used()])
        merged = merge_lists(ts, cmax, lists)
        rank = {merged.key(s): i for i, s in enumerate(sorted(
            merged.used(), key=lambda s: merged.key(s) ^ ORDER))}
        for r, key, p in rows:
            w = merged.words[merged.slot(key, insert=False)]
            keep[b, r] = p >= w[cmax - 1]
            j = sum(x > p for x in w)
            tie[b, r] = rank[key] * cmax + min(j, cmax - 1)
    return torch.from_numpy(keep), torch.from_numpy(tie)


def collapse_case(seed, B, R, n_docs, n_keys, absent=0.15, elig_p=0.8,
                  levels=4, nan_p=0.0, all_ones=False):
    """Sorted distinct docids (the last rows SENTINEL), scores on a few
    levels (ties within and across keys), a key column of n_keys keys
    (negative words among them)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    ids = np.stack([np.sort(rng.choice(n_docs, R, replace=False))
                    for _ in range(B)]).astype(np.int32)
    sums = (rng.integers(1, levels + 1, (B, R)) / 4).astype(np.float32)
    sums[rng.random((B, R)) < nan_p] = np.nan
    elig = rng.random((B, R)) < elig_p
    ids[:, -3:] = SENTINEL
    elig[:, -3:] = False
    key = rng.integers(0, max(n_keys, 1), n_docs + 1)
    col = {"hi": (key // 3 - 2).astype(np.int32),
           "lo": (key % 3 - 1).astype(np.int32),
           "present": rng.random(n_docs + 1) >= absent}
    if all_ones:
        col["hi"][::4] = -1
        col["lo"][::4] = -1
    return (torch.from_numpy(ids), torch.from_numpy(sums),
            torch.from_numpy(elig),
            {c: torch.from_numpy(v) for c, v in col.items()})


def same_as_plain(ids, sums, elig, col, cmax, row_order, chunk):
    """The emulation at the plan's table and G (and at 1, 3, 4 and 6
    blocks, blocks past the chunks) equals _collapse_rows_plain."""
    want = kernels._collapse_rows_plain(ids, sums, elig, col,
                                        min(cmax, kernels.MAX_COLLAPSE),
                                        row_order)
    B, R = ids.shape
    ts, G = kernels.collapse_plan(B, R, kernels.collapse_keys(col))
    assert ts, "these columns take the tiles"
    for g in sorted({G, 1, 3, 4, 6}):
        got = collapse_tiles_emulated(ids, sums, elig, col, cmax, row_order,
                                      ts, g, chunk)
        assert torch.equal(got[0], want[0]), ("keep", cmax, row_order, g)
        assert torch.equal(got[1], want[1]), ("tie", cmax, row_order, g)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), n_keys=st.integers(1, 40),
       cmax=st.sampled_from([1, 3, 8, 9]), row_order=st.booleans(),
       levels=st.sampled_from([1, 3, 1000]),
       nan_p=st.sampled_from([0.0, 0.2]), all_ones=st.booleans())
def test_collapse_tiles_emulation_matches_plain(seed, n_keys, cmax,
                                                row_order, levels, nan_p,
                                                all_ones):
    """1-40 keys, cmax 1, 3, 8 and 9 (capped at 8), row_order, tied and NaN
    scores, the all-ones key; chunks of 64 rows, so a block takes several
    and a list merges many."""
    case = collapse_case(seed, 2, 700, 2000, n_keys, levels=levels,
                         nan_p=nan_p, all_ones=all_ones)
    same_as_plain(*case, cmax, row_order, chunk=64)


@pytest.mark.parametrize("case", ["docid_like", "absent_slot", "one_key",
                                  "empty_query", "all_absent"])
def test_collapse_tiles_emulation_edges(case):
    """Keys that nearly all differ (a docid-like column that still fits the
    table), a slot the segment lacks (every row solo), one key, a query
    with no eligible row, no value present."""
    B, R = 2, 600
    if case == "docid_like":
        ids, sums, elig, col = collapse_case(5, B, R, 900, 400, absent=0.0)
        col = {"hi": torch.zeros(401, dtype=torch.int32),
               "lo": torch.arange(401, dtype=torch.int32),
               "present": torch.ones(401, dtype=torch.bool)}
        ids = torch.where(ids == SENTINEL, ids, ids % 400)
        ids = torch.sort(ids, 1)[0]
        for b in range(B):   # distinct eligible docids
            _u, first = np.unique(ids[b].numpy(), return_index=True)
            m = np.zeros(R, bool)
            m[first] = True
            elig[b] &= torch.from_numpy(m)
    else:
        ids, sums, elig, col = collapse_case(
            6, B, R, 3000, 1 if case == "one_key" else 23,
            absent=1.0 if case == "all_absent" else 0.1)
        if case == "absent_slot":
            col = kernels.absent_column(torch.device("cpu"))
        if case == "empty_query":
            elig[1] = False
    for cmax in (1, 3, 8):
        for ro in (False, True):
            same_as_plain(ids, sums, elig, col, cmax, ro, chunk=128)


def test_collapse_table_overflow_raises():
    """A table with fewer slots than the keys raises (the kernel traps);
    collapse_plan's table holds twice the column's keys, so a query's
    keys never fill it."""
    ids, sums, elig, col = collapse_case(8, 1, 900, 3000, 40, absent=0.0)
    with pytest.raises(OverflowError):
        collapse_tiles_emulated(ids, sums, elig, col, 3, False, 16, 2,
                                chunk=128)
    for n in (0, 1, 8, 9, 40, 400, 511, 512):
        for B, R in ((1, 10**6), (3, 5000), (200, 70000)):
            ts, G = kernels.collapse_plan(B, R, n)
            assert ts >= 2 * n and ts & (ts - 1) == 0 and ts >= 16
            assert G >= 1 and B * G <= max(kernels.COLLAPSE_BLOCKS, B)


def test_jax_collapse_keeps_the_same_rows():
    """JAX's _collapse (one query a call, as vmap runs it) against the
    emulation: the same survivors, and equal scores in the same order
    (the collapsed position against (tie, docid))."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from xapiand_tpu.ops import executor as jex

    ids, sums, elig, col = collapse_case(11, 3, 500, 1500, 12, levels=3,
                                         all_ones=True)
    jcol = {c: jnp.asarray(v.numpy()) for c, v in col.items()}
    seg = {"values": {7: jcol}}
    for cmax in (1, 3):
        cfg = SimpleNamespace(collapse_slot=7, collapse_max=cmax)
        ts, _G = kernels.collapse_plan(3, 500, kernels.collapse_keys(col))
        keep, tie = collapse_tiles_emulated(ids, sums, elig, col, cmax,
                                            False, ts, 4, chunk=128)
        for b in range(3):
            od, osc, okeep, _c = jex._collapse(
                cfg, seg, jnp.asarray(ids[b].numpy()),
                jnp.asarray(sums[b].numpy()), jnp.asarray(elig[b].numpy()))
            od, osc, okeep = (np.asarray(x) for x in (od, osc, okeep))
            want = [(-float(s), i, int(d)) for i, (d, s, k) in
                    enumerate(zip(od, osc, okeep)) if k]
            kept = keep[b].numpy()
            assert sorted(int(d) for *_x, d in want) == \
                sorted(ids[b].numpy()[kept].tolist())
            t, s, d = (x[b].numpy()[kept] for x in (tie, sums, ids))
            got = sorted(zip((-s).tolist(), t.tolist(), d.tolist()))
            assert [x[2] for x in got] == [x[2] for x in sorted(want)]


# --------------------------------------------------------------------------
# collapse_plan and the column's distinct count
# --------------------------------------------------------------------------

# (B, R, the column's distinct keys) of the captured launches: browse C on
# the category (utils/synth_faceted.py N_CATS), its dense plans' rows; the
# REST mesh's collapses on employer (utils/synth_docs.py, 400 values) and
# eyeColor; a docid-like column
PLAN_CASES = [
    ((1, 2359424, 40), (128, 132)),
    ((1, 1312896, 40), (128, 132)),
    ((1, 1000001, 40), (128, 132)),
    ((1, 139392, 40), (128, 35)),
    ((1, 57472, 400), (1024, 15)),
    ((1, 57472, 3), (16, 15)),
    ((2, 4096, 40), (128, 1)),
    ((64, 1310720, 40), (128, 2)),
    ((1, 1000001, 1000000), (0, 0)),
    ((1, 57472, 513), (0, 0)),
]


@pytest.mark.parametrize("shape,plan", PLAN_CASES)
def test_collapse_plan_at_the_captured_shapes(shape, plan):
    assert kernels.collapse_plan(*shape) == plan


def test_collapse_keys_counts_once_a_column():
    """The distinct present keys, cached by the column's tensors (a view
    of a stacked column too), counted anew after an in-place change."""
    hi = torch.tensor([0, 0, 1, 1, -1, 5], dtype=torch.int32)
    lo = torch.tensor([0, 1, 0, 1, -1, 5], dtype=torch.int32)
    present = torch.tensor([True, True, True, False, True, False])
    col = {"hi": hi, "lo": lo, "present": present}
    assert kernels.collapse_keys(col) == 4
    assert kernels.collapse_keys(dict(col)) == 4
    present[3] = True
    assert kernels.collapse_keys(col) == 5
    stacked = {c: torch.stack([t, t]) for c, t in col.items()}
    view = {c: t[1] for c, t in stacked.items()}
    assert kernels.collapse_keys(view) == 5
    stacked["present"][1, 5] = True
    assert kernels.collapse_keys(view) == 6
    assert kernels.collapse_keys(
        kernels.absent_column(torch.device("cpu"))) == 0


# --------------------------------------------------------------------------
# agg_buckets: the sub statistics' association
# --------------------------------------------------------------------------

F32 = np.float32
INF = F32(np.inf)


def bucket_stats_emulated(ids, elig, codes, subs, nb, G, sub_clamp=0):
    """[S, 5, B, nb] float32 as csrc/agg_buckets.cu sums them: codes
    i32[B, R] (-1: no bucket, eligibility applied). Block g of a query
    takes the 16-row groups [ng g / G, ng (g + 1) / G); its warp w the 32
    groups g0 + (8 k + w) * 32 .. + 31 of each step k; a warp's eligible
    rows in that order, in batches of 32, each sub's values of a code in
    a batch summed in lane order onto the warp's partial; the warps added
    in warp order, the blocks in block order."""
    B, R = ids.shape
    S = len(subs)
    ng = -(-R // 16)
    out = np.zeros((S, 5, B, nb), F32)
    for b in range(B):
        blocks = []
        for g in range(G):
            g0, g1 = ng * g // G, ng * (g + 1) // G
            acc = np.zeros((S, nb, 5), F32)
            acc[..., 3], acc[..., 4] = np.inf, -np.inf
            for w in range(8):
                rows = [r for gs in range(g0 + w * 32, g1, 256)
                        for gi in range(gs, min(gs + 32, g1))
                        for r in range(gi * 16, min(gi * 16 + 16, R))
                        if elig[b, r]]
                wp = np.zeros((S, nb, 5), F32)
                wp[..., 3], wp[..., 4] = np.inf, -np.inf
                for i0 in range(0, len(rows), 32):
                    batch = rows[i0:i0 + 32]
                    for si, sub in enumerate(subs):
                        step = {}
                        for r in batch:
                            c = int(codes[b, r])
                            if c < 0:
                                continue
                            if sub is None:
                                step.setdefault(c, []).append(None)
                                continue
                            fval, present = sub
                            d = int(ids[b, r])
                            if sub_clamp > 0:
                                d = min(d, sub_clamp - 1)
                            dd = min(d, fval.shape[0] - 1)
                            if present[dd]:
                                step.setdefault(c, []).append(F32(fval[dd]))
                        for c, xs in step.items():
                            n, sm, sq, mn, mx = (F32(0), F32(0), F32(0),
                                                 INF, -INF)
                            for x in xs:
                                n = F32(n + F32(1))
                                if x is not None:
                                    sm = F32(sm + x)
                                    sq = F32(sq + F32(x * x))
                                    mn, mx = min(mn, x), max(mx, x)
                            q = wp[si, c]
                            q[0] = F32(q[0] + n)
                            q[1] = F32(q[1] + sm)
                            q[2] = F32(q[2] + sq)
                            q[3], q[4] = min(q[3], mn), max(q[4], mx)
                acc[..., :3] = (acc[..., :3] + wp[..., :3]).astype(F32)
                acc[..., 3] = np.minimum(acc[..., 3], wp[..., 3])
                acc[..., 4] = np.maximum(acc[..., 4], wp[..., 4])
            blocks.append(acc)
        tot = blocks[0].copy()
        for acc in blocks[1:]:
            tot[..., :3] = (tot[..., :3] + acc[..., :3]).astype(F32)
            tot[..., 3] = np.minimum(tot[..., 3], acc[..., 3])
            tot[..., 4] = np.maximum(tot[..., 4], acc[..., 4])
        out[:, :, b, :] = tot.transpose(0, 2, 1)
    return out


def bucket_world(seed, B=2, R=9000, n_docs=12000):
    """Rows (docids, eligibility) and a segment's columns for every bucket
    mode: cats of 40 categories, a float column with absences, a trixel
    layout, two sub columns and a count sub."""
    rng = np.random.Generator(np.random.PCG64(seed))
    ids = rng.integers(0, n_docs, (B, R)).astype(np.int32)
    elig = rng.random((B, R)) < 0.7
    n = n_docs + 1
    w = {"ids": torch.from_numpy(ids), "elig": torch.from_numpy(elig)}
    w["cats"] = torch.from_numpy(rng.integers(-1, 40, n).astype(np.int32))
    w["present"] = torch.from_numpy(rng.random(n) < 0.85)
    w["fval"] = torch.from_numpy(
        (rng.random(n) * 1000 - 200).astype(np.float32))
    subs = []
    for scale in (1.0, 1e4):
        subs.append((torch.from_numpy(
            (rng.normal(50, 30, n) * scale).astype(np.float32)),
            torch.from_numpy(rng.random(n) < 0.9)))
    w["subs"] = (subs[0], None, subs[1])
    off = np.arange(n, dtype=np.int32)
    flat = np.sort(rng.integers(0, 1 << 28, n)).astype(np.int32)
    w["trixels"] = {"doc_off": torch.from_numpy(off),
                    "doc_len": torch.from_numpy(
                        (rng.random(n) < 0.9).astype(np.int32)),
                    "flat_start": torch.from_numpy(flat), "shift": 22}
    w["rng"] = rng
    return w


def mode_codes(w, mode):
    """(codes argument, nb, kw) of one launch of mode in world w."""
    B = w["ids"].shape[0]
    rng = w["rng"]
    if mode == "terms":
        return w["cats"], 40, {}
    if mode == "remap":
        remap = torch.from_numpy(rng.permutation(48).astype(np.int32) - 6)
        return w["cats"], 40, {"remap": remap}
    if mode == "missing":
        return w["present"], 1, {}
    if mode == "mask":
        return torch.from_numpy(rng.random(tuple(w["ids"].shape)) < 0.5), \
            1, {}
    if mode == "histogram":
        prm = torch.tensor([[3.5, -200.0]] * B, dtype=torch.float32)
        return {"fval": w["fval"], "present": w["present"],
                "params": prm}, 300, {}
    if mode == "range":
        edges = np.sort(rng.random((B, 9)) * 1200 - 250, 1).astype(np.float32)
        bnd = np.stack([edges[:, :-1], edges[:, 1:]], 2)
        return {"fval": w["fval"], "present": w["present"],
                "bounds": torch.from_numpy(np.ascontiguousarray(bnd))}, 8, {}
    if mode == "trixels":
        tri = w["trixels"]
        vals = np.unique((tri["flat_start"].numpy() >> 22))
        tab = np.stack([np.sort(rng.choice(vals, 48, replace=False))
                        for _ in range(B)]).astype(np.int32)
        return dict(tri, table=torch.from_numpy(tab)), 48, \
            {"sub_clamp": 9000}
    raise ValueError(mode)


BUCKET_CASES = ["terms", "remap", "missing", "mask", "histogram", "range",
                "trixels", "nested"]


def stats_close(got, want, absum):
    """n, min and max exactly; s2 within rtol 1e-5; s within 1e-5 of the
    sums of |value| absum (a float32 sum's rounding bound: where values of
    both signs cancel, no float32 sum is within rtol of the float64 one)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    for st in (0, 3, 4):
        assert np.array_equal(got[:, st], want[:, st]), st
    assert (np.abs(got[:, 1] - want[:, 1]) <= 1e-5 * absum).all()
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("case", BUCKET_CASES)
def test_bucket_sub_association_matches_plain(case, G):
    """The kernel's association against _sub_stats_plain's float64 sums:
    a sub of values near 50, a count sub, a sub of values near 5e5 of
    both signs."""
    w = bucket_world(21)
    ids, elig = w["ids"], w["elig"]
    if case == "nested":
        # a terms level of 40, then a histogram level of 300 under it
        codes, nb, kw = mode_codes(w, "histogram")
        _c, _s, prev = kernels._agg_buckets_plain(
            ids, elig, "terms", w["cats"], 8, (), want_codes=True)
        kw = {"prev": prev, "size": 8 * nb}
        mode = "histogram"
    else:
        codes, nb, kw = mode_codes(w, case)
        mode = "terms" if case == "remap" else case
    size = kw.get("size", nb)
    counts, stats, code = kernels._agg_buckets_plain(
        ids, elig, mode, codes, nb, w["subs"], kw.get("prev"), size, True,
        kw.get("sub_clamp", 0), kw.get("remap"))
    assert int((code >= 0).sum()) > 1000
    got = bucket_stats_emulated(ids.numpy(), elig.numpy(), code.numpy(),
                                w["subs"], size, G, kw.get("sub_clamp", 0))
    absum = kernels._agg_buckets_plain(
        ids, elig, mode, codes, nb,
        tuple(None if c is None else (c[0].abs(), c[1]) for c in w["subs"]),
        kw.get("prev"), size, False, kw.get("sub_clamp", 0),
        kw.get("remap"))[1][1].numpy()
    stats_close(got, np.stack([stats[k].numpy() for k in range(5)], 1),
                absum)
    # the count sub's n is the bucket's count
    assert np.array_equal(got[1, 0], counts.numpy().astype(np.float32))


def test_bucket_sub_association_matches_jax():
    """The association against JAX's _sub_stats_bucketed (einsum sums in
    float32) on the terms and histogram launches of one query each."""
    import jax.numpy as jnp

    from xapiand_tpu.ops import aggs as jaggs

    w = bucket_world(22, B=2, R=6000)
    ids, elig = w["ids"], w["elig"]
    fval, present = w["subs"][0]
    jseg = {"values": {5: {"fval": jnp.asarray(fval.numpy()),
                           "present": jnp.asarray(present.numpy())}}}
    for mode in ("terms", "histogram"):
        codes, nb, _kw = mode_codes(w, mode)
        _n, _s, code = kernels._agg_buckets_plain(
            ids, elig, mode, codes, nb, (), None, nb, True)
        got = bucket_stats_emulated(ids.numpy(), elig.numpy(), code.numpy(),
                                    (w["subs"][0], None), nb, 2)
        for b in range(2):
            oh = code[b].numpy()[:, None] == np.arange(nb)[None, :]
            want = jaggs._sub_stats_bucketed(
                jseg, [("stats", 5), ("count", -1)],
                jnp.asarray(ids[b].numpy()), jnp.asarray(oh))
            for si, ws in enumerate(want):
                for st, name in enumerate(("n", "s", "s2", "min", "max")):
                    np.testing.assert_allclose(
                        got[si, st, b], np.asarray(ws[name]), rtol=1e-5,
                        atol=0, err_msg=f"{mode} sub {si} {name}")


# (B, R, size, subs) of the captured agg_buckets launches, and G: faceted A
# with and without subs, D, browse M, the Database path's trixels and
# nested level of 144 buckets, the REST mesh's histogram with a sub, a
# trixel spec with a sub (the warps' partials in device memory), a wide
# nested spec with three subs over 64 queries
BUCKET_PLAN_CASES = [
    ((64, 1310720, 64, 0), 64),
    ((64, 1310720, 64, 3), 64),
    ((32, 1835136, 64, 0), 128),
    ((256, 1000001, 64, 0), 16),
    ((1, 57472, 4096, 0), 15),
    ((1, 65664, 144, 1), 17),
    ((1, 57472, 64, 1), 15),
    ((1, 57472, 4096, 1), 15),
    ((64, 40000, 2400, 3), 1),
]


@pytest.mark.parametrize("shape,G", BUCKET_PLAN_CASES)
def test_bucket_plan_at_the_captured_shapes(shape, G):
    assert kernels.bucket_plan(*shape) == G
