"""The decompositions the redesigned agg_metrics (K17a) and agg_ranges
(K17c-2) kernels rely on, held on the CPU against their plain versions and
JAX. JAX is imported inside the tests that run it, so
tests/test_torch_cuda.py takes the cases from here.

Both kernels walk a query's rows the same way (csrc/common.cuh
warp_row_queue): G blocks a query (kernels.row_plan,
kernels.ranges_plan) split its flat 16-row groups (a query's rows need not
start on 16); warp w of a block takes the groups whose place in the block
is gpw (8 k + w) .. + gpw - 1 (gpw 32, or fewer where the queries are
few); its eligible rows are queued in row order and drained 32 at a time,
so lane l takes the rows at places l, l + 32, ... of the warp's queue, in
that order. The last block of a query folds the G blocks' partials
(common.cuh fold_blocks): a warp an output, lane l taking blocks l, l +
32, ... in order from the identity, then an xor tree, where a query has
at most 64 outputs; else a thread an output, the blocks in order.

  agg_metrics  csrc/agg_metrics.cu: the count is the eligible rows'
               (__popc of the flags); each lane sums its rows' present
               values of each channel in queue order; the lanes by an xor
               shuffle tree, the warps in order, then the blocks. The
               emulation's counts, n, min and max equal
               _agg_metrics_plain's and JAX compute_aggs'; its sums agree
               within rtol 1e-5 (or 1e-5 of the sums of |value| where
               signs cancel).
  agg_ranges   csrc/agg_ranges.cu: a lane's row is tested against every
               range (key modes: the doc's packed key words, present iff
               min <= max; geo_ip: each bucket's intervals, grouped by a
               counting sort of assign, up to the first hit); counts exact;
               each sub's values of a batch's member lanes summed in lane
               order onto the warp's partial of the range, batch after
               batch; then the warps in order, then the blocks. The member
               bytes (want_member) are the rows' memberships, 0 where a row
               is not eligible. Counts and member bytes equal
               _agg_ranges_plain's and JAX's; sums within rtol 1e-5.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from test_torch_filter_distinct_design import torch_col, value_case
from xapiand_tpu_torch.ops import kernels

WARPS = 8                    # csrc AM_WARPS, AR_WARPS
SENTINEL = kernels.SENTINEL
INF = np.float32(np.inf)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the row queues
# --------------------------------------------------------------------------

def warp_queues(elig_b, b, R, G, gpw=32):
    """-> per block g of query b, per warp, its queue: the eligible rows
    (within the query) of its groups (gpw a step), in row order."""
    lo = b * R
    f0, f1 = lo // 16, (lo + R + 15) // 16
    gi = (lo + np.arange(R)) // 16
    out = []
    for g in range(G):
        q0 = f0 + (f1 - f0) * g // G
        q1 = f0 + (f1 - f0) * (g + 1) // G
        inb = (gi >= q0) & (gi < q1) & elig_b
        warp = ((gi - q0) % (WARPS * gpw)) // gpw
        out.append([np.flatnonzero(inb & (warp == w)) for w in range(WARPS)])
    return out


def fold_blocks(parts, op, lanes):
    """common.cuh fold_blocks of the G blocks' partials (an array a block)
    by op: lanes 32, lane l takes blocks l, l + 32, ... from the identity,
    then the xor tree; lanes 1, the blocks in order from the identity."""
    ident = {0: 0.0, 1: INF, 2: -INF}[op]
    f = FOLD[(0, 3, 4)[op]]
    if lanes == 1:
        a = np.full_like(parts[0], ident)
        for x in parts:
            a = f(a, x)
        return a
    acc = []
    for lane in range(32):
        a = np.full_like(parts[0], ident)
        for x in parts[lane::32]:
            a = f(a, x)
        acc.append(a)
    return xor_tree(np.stack(acc), f)


def lane_rows(queue):
    """[32, L] places of a warp's queue a lane takes (l, l + 32, ...), -1
    past its end."""
    L = -(-len(queue) // 32)
    pos = np.full(32 * L, -1)
    pos[:len(queue)] = np.arange(len(queue))
    return pos.reshape(L, 32).T


def xor_tree(a, op):
    """The shuffle tree of csrc: at each o in 16 .. 1, lane l's value and
    lane l ^ o's combined."""
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        a = op(a, a[idx ^ o])
    return a[0]


def _add(a, b):
    return (a + b).astype(np.float32)


FOLD = (_add, _add, _add, np.minimum, np.maximum)


# --------------------------------------------------------------------------
# agg_metrics
# --------------------------------------------------------------------------

def emulate_agg_metrics(ids, elig, cols, G=None):
    """csrc/agg_metrics.cu's sums in its order: -> count i32[B], n, s, s2,
    min, max f32[M, B]."""
    B, R = ids.shape
    M = len(cols)
    G, gpw = kernels.row_plan(B, R) if G is None else (G, 32)
    ids_n, elig_n = ids.numpy(), elig.numpy()
    cn = [(f.numpy(), p.numpy()) for f, p in cols]
    count = np.zeros(B, np.int32)
    out = np.zeros((5, M, B), np.float32)
    for b in range(B):
        blocks = []
        for warps in warp_queues(elig_n[b], b, R, G, gpw):
            red = []
            for q in warps:
                count[b] += len(q)
                pos = lane_rows(q)
                stats = []
                for f, p in cn:
                    acc = [np.zeros(32, np.float32), np.zeros(32, np.float32),
                           np.zeros(32, np.float32), np.full(32, INF),
                           np.full(32, -INF)]
                    for k in range(pos.shape[1]):
                        r = pos[:, k]
                        live = r >= 0
                        d = np.minimum(ids_n[b, q[np.where(live, r, 0)]],
                                       f.shape[0] - 1)
                        use = live & p[d]
                        x = np.where(use, f[d], np.float32(0))
                        acc[0] = _add(acc[0], use.astype(np.float32))
                        acc[1] = _add(acc[1], x)
                        acc[2] = _add(acc[2], (x * x).astype(np.float32))
                        acc[3] = np.minimum(acc[3], np.where(use, x, INF))
                        acc[4] = np.maximum(acc[4], np.where(use, x, -INF))
                    stats.append([xor_tree(a, op)
                                  for a, op in zip(acc, FOLD)])
                red.append(stats)
            # the warps in order
            blk = [[red[0][m][s] for s in range(5)] for m in range(M)]
            for w in range(1, WARPS):
                for m in range(M):
                    for s in range(5):
                        blk[m][s] = FOLD[s](blk[m][s], red[w][m][s])
            blocks.append(blk)
        for m in range(M):
            for s in range(5):
                out[s, m, b] = blocks[0][m][s] if G == 1 else fold_blocks(
                    [np.float32(x[m][s]) for x in blocks],
                    (0, 0, 0, 1, 2)[s], 32)
    return (torch.from_numpy(count),) + tuple(torch.from_numpy(x)
                                              for x in out)


def metrics_case(seed, B=3, R=300, M=2, nd=400, p_elig=0.3, crowd=False,
                 past_n=True, signs=False):
    """ids, eligible, cols (CPU): M value columns of nd docs (absent docs
    ~20%; one of values of both signs near 5e5 where ``signs``), ids past
    n - 1 where ``past_n``; ``crowd``: each query's eligible rows one run
    of a fifth of its rows."""
    rng = np.random.Generator(np.random.PCG64(seed))
    ids = rng.integers(0, nd + (20 if past_n else 0), (B, R)).astype(np.int32)
    if crowd:
        elig = np.zeros((B, R), bool)
        for b in range(B):
            s = int(rng.integers(0, R))
            elig[b, s:s + max(1, R // 5)] = True
    else:
        elig = rng.random((B, R)) < p_elig
    cols = []
    for m in range(M):
        n = int(nd - 37 * m) if nd > 80 else nd
        if signs and m == 0:
            f = (5e5 + rng.random(n) * 1e3) * rng.choice([-1.0, 1.0], n)
        else:
            f = rng.random(n) * 10.0 ** int(rng.integers(0, 4))
        cols.append((torch.from_numpy(f.astype(np.float32)),
                     torch.from_numpy(rng.random(n) < 0.8)))
    return torch.from_numpy(ids), torch.from_numpy(elig), cols


def check_metrics(got, want, cols, ids, elig):
    """Counts, n, min, max equal; s2 within rtol 1e-5; s within 1e-5 of
    the sums of |value| (values of both signs cancel)."""
    assert torch.equal(got[0], want[0])
    for s in (1, 4, 5):
        assert torch.equal(got[s], want[s]), s
    absum = kernels._agg_metrics_plain(
        ids, elig, [(f.abs(), p) for f, p in cols])[2].numpy()
    assert (np.abs(got[2].numpy() - want[2].numpy()) <= 1e-5 * absum).all()
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), rtol=1e-5)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 64),
       M=st.integers(0, 8), p=st.sampled_from([0.0, 0.05, 0.5, 1.0]),
       crowd=st.booleans(), G=st.integers(0, 3))
@example(seed=1, B=1, M=0, p=0.5, crowd=False, G=0)
@example(seed=2, B=64, M=8, p=0.0, crowd=False, G=2)
@example(seed=3, B=5, M=1, p=1.0, crowd=True, G=3)
def test_metrics_queues_match_plain_version(seed, B, M, p, crowd, G):
    """The emulation over G blocks a query (0: row_plan's) against the
    plain version: B 1-64 (rows that do not start on 16 where R is not a
    multiple of 16), M 0-8, no eligible row, eligible rows in one crowded
    run, ids past n - 1, absent docs, values of both signs."""
    R = max(1, 4000 // B) + seed % 7
    ids, elig, cols = metrics_case(seed, B, R, M, p_elig=p, crowd=crowd,
                                   signs=bool(seed % 2))
    got = emulate_agg_metrics(ids, elig, cols, G or None)
    if G:
        got2 = emulate_agg_metrics(ids, elig, cols, None)
        assert torch.equal(got[0], got2[0])
    want = kernels._agg_metrics_plain(ids, elig, cols)
    check_metrics(got, want, cols, ids, elig)
    if p == 0.0 and not crowd:
        assert not got[0].any()
        assert (got[4] == np.inf).all() and (got[5] == -np.inf).all()


def test_metrics_geo_stats_channels():
    """geo_stats' two channels (latitude, and the longitude or zeros where
    the column has none) through the same launch."""
    rng = np.random.Generator(np.random.PCG64(4))
    n = 500
    lat = torch.from_numpy((rng.random(n) * 180 - 90).astype(np.float32))
    lon = torch.from_numpy((rng.random(n) * 360 - 180).astype(np.float32))
    present = torch.from_numpy(rng.random(n) < 0.7)
    ids = torch.from_numpy(rng.integers(0, n + 5, (6, 333)).astype(np.int32))
    elig = torch.from_numpy(rng.random((6, 333)) < 0.4)
    for cols in ([(lat, present), (lon, present)],
                 [(lat, present), (torch.zeros_like(lat), present)]):
        got = emulate_agg_metrics(ids, elig, cols, 2)
        check_metrics(got, kernels._agg_metrics_plain(ids, elig, cols),
                      cols, ids, elig)


def test_row_plan_at_the_captured_shapes():
    """Blocks of AGG_ROWS rows, at most AGG_BLOCKS a launch: faceted A and
    D, the geo aggregations; a Database segment's one-query launches in
    blocks of fewer rows (gpw < 32), AGG_FILL blocks or more."""
    assert kernels.row_plan(64, 1310720) == (64, 32)
    assert kernels.row_plan(32, 1835136) == (128, 32)
    assert kernels.row_plan(64, 25728) == (7, 32)
    assert kernels.row_plan(1, 82048) == (81, 8)
    assert kernels.row_plan(1, 1) == (1, 1)
    for R in (1000, 25001, 57472, 82048, 300000):
        G, gpw = kernels.row_plan(1, R)
        assert G * kernels.AGG_ROWS * gpw // 32 >= R
        assert G >= kernels.AGG_FILL or gpw == 1


@pytest.mark.parametrize("seed", range(3))
def test_metrics_queues_match_jax(seed):
    """The emulation's count and statistics against JAX compute_aggs'
    count, stats and geo_stats on the same rows."""
    import jax
    import jax.numpy as jnp

    from xapiand_tpu.ops import aggs as jaggs

    ids, elig, cols = metrics_case(40 + seed, B=4, R=517, M=3, p_elig=0.4)
    seg = {"values": {5 + m: {"fval": jnp.asarray(f.numpy()),
                              "present": jnp.asarray(p.numpy()),
                              "fval2": jnp.asarray(cols[2][0].numpy()[
                                  :f.shape[0]] if m == 2 else
                                  np.zeros(f.shape[0], np.float32))}
                      for m, (f, p) in enumerate(cols)}}
    specs = (("count",), ("stats", 5), ("sum", 6), ("geo_stats", 7))
    want = jax.jit(jax.vmap(lambda d, m: jaggs.compute_aggs(
        seg, specs, d, m, jnp.zeros(d.shape, jnp.float32))))(
        jnp.asarray(ids.numpy()), jnp.asarray(elig.numpy()))
    got = emulate_agg_metrics(ids, elig, cols[:2])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for m in range(2):
        for s, k in enumerate(("n", "s", "s2", "min", "max")):
            w = np.asarray(want[1 + m][k])
            if k in ("s", "s2"):
                np.testing.assert_allclose(got[1 + s][m].numpy(), w,
                                           rtol=1e-5)
            else:
                np.testing.assert_array_equal(got[1 + s][m].numpy(), w)
    geo = [cols[2], (cols[2][0], cols[2][1])]
    g = emulate_agg_metrics(ids, elig, geo)
    w = want[3]
    np.testing.assert_array_equal(g[1][0].numpy(), np.asarray(w["n"]))
    np.testing.assert_allclose(g[2][0].numpy(), np.asarray(w["slat"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(g[4][0].numpy(), np.asarray(w["minlat"]))
    np.testing.assert_array_equal(g[5][1].numpy(), np.asarray(w["maxlon"]))
    assert got[0].min() > 0


# --------------------------------------------------------------------------
# agg_ranges
# --------------------------------------------------------------------------

def _lex_ge(ah, al, bh, bl):
    return (ah > bh) | ((ah == bh) & (al >= bl))


def _lex_le(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al <= bl))


def range_membership(ids, mode, col, bounds, nb, vmax=1, assign=None,
                     origin=None):
    """[B, R, nb] as the kernel tests a row (eligibility aside): the float
    modes on present and fval (geodist: the haversine distance), the key
    modes on the packed key words (present iff min <= max) and, for a doc
    of several values, its first vmax per-value keys; geo_ip each
    bucket's intervals in the order of a counting sort of assign, up to
    the first hit."""
    B, R = ids.shape
    n = col["present"].shape[0]
    d = ids.clamp(max=n - 1).long()
    if mode in ("range", "geodist"):
        ok = col["present"][d]
        v = col["fval"][d]
        if mode == "geodist":
            lon = col["fval2"][d] if "fval2" in col else torch.zeros_like(v)
            v = kernels.haversine(v, lon, origin[:, 0:1], origin[:, 1:2])
        inr = (v[:, :, None] >= bounds[:, None, :, 0]) & \
            (v[:, :, None] < bounds[:, None, :, 1])
        return (inr & ok[:, :, None]).numpy()
    w = col["keys"][d].numpy()                                # [B, R, 4]
    ok = _lex_le(w[..., 0], w[..., 1], w[..., 2], w[..., 3])
    mv = vmax > 1 and "mv_hi" in col
    mvo = col["mv_off"][d].numpy() if mv else np.zeros((B, R), np.int64)
    mvc = col["mv_len"][d].numpy() if mv else np.zeros((B, R), np.int64)
    kb = bounds.numpy()
    nmv = col["mv_hi"].shape[0] if mv else 0
    mh = col["mv_hi"].numpy() if mv else None
    ml = col["mv_lo"].numpy() if mv else None

    def key_in(b, k):                                         # -> [R]
        h, lo_, H, L = kb[b, k]
        hit = _lex_ge(w[b, :, 2], w[b, :, 3], h, lo_) & \
            _lex_le(w[b, :, 0], w[b, :, 1], H, L)
        if not mv:
            return hit
        anyv = mvc[b] == 0
        for v in range(vmax):
            i = np.minimum(mvo[b] + v, nmv - 1)
            anyv = anyv | ((v < mvc[b]) & _lex_ge(mh[i], ml[i], h, lo_) &
                           _lex_le(mh[i], ml[i], H, L))
        return hit & anyv

    out = np.zeros((B, R, nb), bool)
    for b in range(B):
        if mode == "key":
            for j in range(nb):
                out[b, :, j] = key_in(b, j)
        else:
            a = assign[b].numpy()
            order = [i for j in range(nb) for i in np.flatnonzero(a == j)]
            for i in order:       # the grouped intervals; an OR a bucket
                out[b, :, a[i]] |= key_in(b, i)
        out[b] &= ok[b][:, None]
    return out


def emulate_agg_ranges(ids, elig, mode, col, bounds, nb, subs=(), vmax=1,
                       assign=None, origin=None, G=None):
    """csrc/agg_ranges.cu in its order: -> counts i32[B, nb], per sub n, s,
    s2, min, max f32[S, B, nb] (None without subs), member bool[B, R, nb]
    (0 where not eligible)."""
    B, R = ids.shape
    S = len(subs)
    G, gpw = kernels.ranges_plan(B, R, nb, S) if G is None else (G, 32)
    inr = range_membership(ids, mode, col, bounds, nb, vmax, assign, origin)
    ids_n, elig_n = ids.numpy(), elig.numpy()
    member = inr & elig_n[:, :, None]
    counts = member.sum(1).astype(np.int32)
    if not S:
        return torch.from_numpy(counts), None, torch.from_numpy(member)
    sc = [None if c is None else (c[0].numpy(), c[1].numpy()) for c in subs]
    out = np.zeros((5, S, B, nb), np.float32)
    for b in range(B):
        blocks = []
        for warps in warp_queues(elig_n[b], b, R, G, gpw):
            wps = []
            for q in warps:
                wp = np.zeros((5, S, nb), np.float32)
                wp[3], wp[4] = INF, -INF
                for k0 in range(0, len(q), 32):      # a batch, lane order
                    rows = q[k0:k0 + 32]
                    d = ids_n[b, rows]
                    for si, c in enumerate(sc):
                        if c is None:
                            use_v = np.ones(len(rows), bool)
                            x = np.zeros(len(rows), np.float32)
                        else:
                            ds = np.minimum(d, c[0].shape[0] - 1)
                            use_v, x = c[1][ds], c[0][ds]
                        for j in range(nb):
                            use = inr[b, rows, j] & use_v
                            if not use.any():
                                continue
                            acc = [np.float32(0), np.float32(0),
                                   np.float32(0), INF, -INF]
                            for y in x[use]:
                                acc[0] = np.float32(acc[0] + 1)
                                if c is not None:
                                    acc[1] = np.float32(acc[1] + y)
                                    acc[2] = np.float32(acc[2] +
                                                        np.float32(y * y))
                                    acc[3] = min(acc[3], y)
                                    acc[4] = max(acc[4], y)
                            for s in range(5):
                                wp[s, si, j] = FOLD[s](wp[s, si, j], acc[s])
                wps.append(wp)
            blk = np.zeros((5, S, nb), np.float32)
            blk[3], blk[4] = INF, -INF
            for wp in wps:
                for s in range(5):
                    blk[s] = FOLD[s](blk[s], wp[s])
            blocks.append(blk)
        lanes = 32 if nb * (1 + 5 * S) <= 64 else 1
        for s in range(5):
            out[s, :, b] = blocks[0][s] if G == 1 else fold_blocks(
                [x[s] for x in blocks], (0, 0, 0, 1, 2)[s], lanes)
    return torch.from_numpy(counts), tuple(torch.from_numpy(x)
                                           for x in out), \
        torch.from_numpy(member)


def range_case(seed, mode, B=3, R=200, nb=5, S=1, vmax=3, nd=300,
               p_elig=0.5, overlap=True):
    """(args, kw) of one agg_ranges call (CPU tensors): a value column of
    nd docs (multi-value in the key modes, its packed keys from
    value_arrays), nb ranges (geo_ip: 2 nb intervals, overlapping where
    ``overlap``, their buckets in random order, one of no bucket), S subs
    (the last a count sub)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    keyed = mode in ("key", "geo_ip")
    ch = value_case(seed, nd, mv=keyed)
    ch["fval"] = (rng.random(nd + 1) * 100).astype(np.float32)
    if mode == "geodist":
        ch["fval"] = (rng.random(nd + 1) * 180 - 90).astype(np.float32)
        ch["fval2"] = (rng.random(nd + 1) * 360 - 180).astype(np.float32)
    col = torch_col(ch)
    ids = torch.from_numpy(rng.integers(0, nd + 9, (B, R)).astype(np.int32))
    elig = torch.from_numpy(rng.random((B, R)) < p_elig)
    kw = {}
    if keyed:
        nr = 2 * nb if mode == "geo_ip" else nb
        lo = np.stack([rng.integers(-12, 12, (B, nr)),
                       rng.integers(-4, 4, (B, nr))], -1)
        width = rng.integers(0, 6 if overlap else 1, (B, nr))
        hi = np.stack([lo[..., 0] + width, rng.integers(-4, 4, (B, nr))], -1)
        bounds = torch.from_numpy(np.concatenate([lo, hi], -1)
                                  .astype(np.int32))
        kw["vmax"] = vmax
        if mode == "geo_ip":
            a = rng.integers(0, nb, (B, nr)).astype(np.int32)
            a[:, 0] = nb           # an interval of no bucket
            kw["assign"] = torch.from_numpy(a)
    else:
        top = 20000000.0 if mode == "geodist" else 100.0
        lo = np.sort(rng.random((B, nb)) * top, 1)
        hi = lo + rng.random((B, nb)) * top * (0.5 if overlap else 0.05)
        bounds = torch.from_numpy(np.stack([lo, hi], -1).astype(np.float32))
        if mode == "geodist":
            kw["origin"] = torch.from_numpy(
                np.stack([rng.random(B) * 180 - 90,
                          rng.random(B) * 360 - 180], -1).astype(np.float32))
    subs = []
    for s in range(S):
        if s == S - 1 and S > 1:
            subs.append(None)
            continue
        n = nd - 11 * s
        subs.append((torch.from_numpy((rng.random(n) * 50 + 1)
                                      .astype(np.float32)),
                     torch.from_numpy(rng.random(n) < 0.85)))
    return (ids, elig, mode, col, bounds, nb, tuple(subs)), kw


def check_ranges(got, want, S):
    """Counts equal; sub n, min, max equal, s and s2 within rtol 1e-5."""
    assert torch.equal(got[0], want[0])
    if S:
        for s in range(5):
            g, x = got[1][s].numpy(), want[1][s].numpy()
            if s in (0, 3, 4):
                assert np.array_equal(g, x), s
            else:
                np.testing.assert_allclose(g, x, rtol=1e-5, atol=0)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1),
       mode=st.sampled_from(sorted(kernels.RANGE_MODES)),
       B=st.integers(1, 6), nb=st.integers(1, 12), S=st.integers(0, 3),
       p=st.sampled_from([0.0, 0.3, 1.0]), G=st.integers(0, 3))
@example(seed=1, mode="geo_ip", B=2, nb=1, S=2, p=0.3, G=2)
@example(seed=2, mode="range", B=1, nb=12, S=0, p=1.0, G=0)
def test_ranges_queues_match_plain_version(seed, mode, B, nb, S, p, G):
    """The emulation against the plain version in every mode: counts and
    member bytes equal (want_member), sub statistics (a count sub among
    them) within rtol 1e-5; no eligible row; overlapping geo_ip
    intervals."""
    R = 37 + seed % 300
    args, kw = range_case(seed, mode, B, R, nb, S, p_elig=p)
    got = emulate_agg_ranges(*args, **kw, G=G or None)
    want = kernels._agg_ranges_plain(*args, **{**kw, "want_member": True})
    check_ranges(got, want, S)
    assert torch.equal(got[2], want[2])
    if p == 0.0:
        assert not got[0].any() and not got[2].any()


@pytest.mark.parametrize("mode", sorted(kernels.RANGE_MODES))
def test_ranges_wide(mode):
    """nb 4096 (geo_ip: 4096 intervals over 2048 buckets) on few rows:
    the staging and the counts."""
    geo = mode == "geo_ip"
    args, kw = range_case(8, mode, B=1, R=8 if geo else 40,
                          nb=2048 if geo else 4096, S=0, nd=60)
    got = emulate_agg_ranges(*args, **kw)
    want = kernels._agg_ranges_plain(*args, **{**kw, "want_member": True})
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert got[0].any()


def test_ranges_keys_need_no_channels():
    """The key modes read only the packed keys (and the per-value keys):
    the same membership with hi, lo, max_hi, max_lo and present dropped."""
    for mode in ("key", "geo_ip"):
        (ids, elig, _m, col, bounds, nb, subs), kw = range_case(
            12, mode, B=2, R=150, nb=6, S=0)
        bare = {c: v for c, v in col.items()
                if c not in ("hi", "lo", "max_hi", "max_lo")}
        bare["present"] = torch.zeros_like(col["present"])
        got = range_membership(ids, mode, bare, bounds, nb, kw["vmax"],
                               kw.get("assign"))
        want = kernels._agg_ranges_plain(ids, torch.ones_like(elig), mode,
                                         col, bounds, nb, (),
                                         want_member=True, **kw)[2]
        assert np.array_equal(got, want.numpy())


def test_ranges_plan_at_the_captured_shapes():
    """ranges_plan's (G, gpw) at the Database path's captured launches, and
    G held to AGG_FOLD // nb."""
    assert kernels.ranges_plan(1, 82048, 5, 1) == (161, 4)
    assert kernels.ranges_plan(1, 57472, 16, 0) == (225, 2)
    assert kernels.ranges_plan(1, 300, 4096, 0) == (3, 1)
    assert kernels.ranges_plan(1, 1000000, 4096, 0) == (16, 32)
    assert kernels.ranges_plan(1, 1, 4096, 3) == (1, 1)


@pytest.mark.parametrize("mode", sorted(kernels.RANGE_MODES))
def test_ranges_queues_match_jax(mode):
    """The emulation's counts and subs against JAX compute_aggs' range,
    geodist_range, key_range and geo_ip on the same rows and plan
    arrays."""
    import jax
    import jax.numpy as jnp

    from xapiand_tpu.ops import aggs as jaggs

    nb = 4
    (ids, elig, _m, col, bounds, _nb, subs), kw = range_case(
        60, mode, B=3, R=411, nb=nb, S=2, p_elig=0.6)
    jcol = {c: jnp.asarray(v.numpy()) for c, v in col.items()
            if c not in ("keys", "codes", "code_hll")}
    seg = {"values": {5: jcol, 6: {"fval": jnp.asarray(subs[0][0].numpy()),
                                   "present": jnp.asarray(
                                       subs[0][1].numpy())}}}
    sub_specs = (("sum", 6), ("count", -1))
    if mode == "geo_ip":
        spec = ("geo_ip", 5, nb, 2 * nb, sub_specs, kw["vmax"])
        params = kw["assign"]
    elif mode == "key":
        spec = ("key_range", 5, nb, sub_specs, kw["vmax"])
        params = None
    else:
        spec = ("geodist_range" if mode == "geodist" else "range", 5, nb,
                sub_specs)
        params = kw.get("origin")
    plan = {"agg_ranges": {"0": jnp.asarray(bounds.numpy())}}
    if params is not None:
        plan["agg_params"] = {"0": jnp.asarray(params.numpy())}
    want = jax.jit(jax.vmap(lambda d, m, p: jaggs.compute_aggs(
        seg, (spec,), d, m, jnp.zeros(d.shape, jnp.float32), p)))(
        jnp.asarray(ids.numpy()), jnp.asarray(elig.numpy()), plan)[0]
    got = emulate_agg_ranges(ids, elig, mode, col, bounds, nb, subs, **kw)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want["counts"]))
    for si in range(2):
        for s, k in enumerate(("n", "s", "s2", "min", "max")):
            w = np.asarray(want["subs"][si][k])
            g = got[1][s][si].numpy()
            if k in ("s", "s2"):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(g, w)
    assert got[0].any()
