"""The decompositions the redesigned fullwidth_topk (K9) and shard_merge
(K19) kernels rely on, held on the CPU against their plain versions and
JAX. JAX is imported inside the tests that run it, so
tests/test_torch_cuda.py takes the cases and emulations from here.

  fullwidth_topk  csrc/fullwidth_topk.cu: G blocks a query
                  (kernels.fullwidth_plan) walk its rows by common.cuh
                  warp_row_queue, its steps of WARPS x gpw 16-row groups
                  dealt to the blocks in turn (fw_queues); each warp drains
                  its eligible rows 128 at a time, 32 by 32, a row passing
                  where its first 64-bit word (two key words) is at most
                  the warp threshold's, the block's bound and the query's
                  as they stood at the 128's start and its key is below
                  the threshold as it stands; the survivors are appended to
                  the warp's buffer of FW_CAP keys, whose kk best are
                  selected where an append would overflow it (the kk-th
                  found bit by bit on the first 64-bit words, then on the
                  second among keys that tie there; the kk-th the
                  threshold, its first 64-bit word lowering the block's
                  and the query's bounds, the append's keys compared
                  again) and at the walk's end where it holds more than
                  kk; a block whose warps end with more than 2 kk keys
                  keeps its kk best and their ties on the first 64-bit
                  word (block_select, bit by bit), which lowers the
                  query's bound; each warp then appends its keys to the
                  query's candidates. The merge's warps take the
                  candidates in runs of 32 (warp w the runs w, w + 8,
                  ..., FW_MQ at a time) into their buffers the same way,
                  behind the walk's bound; the block keeps its kk best
                  the same way, and ranks them by counting. The warps
                  run in any
                  order (the emulation interleaves their batches from a
                  seed). The answer: the window's keys below the plateau,
                  then the R - n_elig ineligible rows, then the NaN keys;
                  the certificate on the images at k - 1 and kk - 1. Bit
                  for bit _fullwidth_topk_plain's, and JAX's
                  _fullwidth_topk where it certifies: fewer than k eligible
                  rows, none, kk = R, value keys whose hi collide in
                  float32, -0.0 and +0.0, NaN and +-inf float keys, ties on
                  the image across k - 1 and kk - 1, more than
                  MAX_FULLWIDTH_KK rows on one key.
  shard_merge     csrc/shard_merge.cu (K19; chunk_merge, K21a, its
                  unstriped mode): a block a query stages its M = S k
                  candidates' key words (the emitted sort words or the
                  negated score's, okey, the gathered position) as planes
                  of 64-bit word pairs, gdoc and score, in shared memory
                  (a device scratch past kernels.SHARD_MERGE_SMEM); each
                  candidate is ranked by counting the candidates before
                  it, four at a time, the count stopping once it reaches
                  k; those below k are written at their rank, every slot
                  once. Bit for bit _shard_merge_plain's and JAX's stable
                  lax.sort merge (xapiand_tpu/parallel/sharded.py
                  394-441, executor.py 1058-1063): scores full of ties,
                  -0.0 beside 0.0, NaN, +-inf, -inf (invalid) rows,
                  insertion-order keys, emitted key words, the chunk
                  merge, k 1, one shard, pages of 300 (M 2,400), planes
                  past shared memory.

compact_rows' cases (with and without orbits, count = cap, count 0, a run
of masked rows across the kernel's chunks) are here too: its kernel is the
parent's (compact_rows stays in the ROADMAP), and tests/test_torch_cuda.py
holds it on them.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_torch_metrics_ranges_design import WARPS
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.utils import synth_faceted as sf

SENTINEL = kernels.SENTINEL
FULL = 0xFFFFFFFF
FW_U = 4                 # csrc FW_U: queued rows a lane in flight
FW_CAP = 256             # csrc FW_CAP: a warp's candidate buffer
FW_MQ = 4                # csrc FW_MQ: the merge's runs a lane in flight
SLOT = sf.SORT_TEST_SLOT
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def test_warps_match_the_kernel():
    assert kernels.FULLWIDTH_WARPS == WARPS


# --------------------------------------------------------------------------
# fullwidth_topk
# --------------------------------------------------------------------------

def fw_case(case, B=3, R=3000, seed=0, k=10, n_docs=2000):
    """(spec, col, ids, sums, elig, k, targets, strtabs) of a named case;
    torch tensors on the CPU, col a value column dict."""
    rng = np.random.default_rng(seed)
    n = n_docs + 1
    col = {"hi": rng.integers(-40, 40, n).astype(np.int32),
           "lo": rng.integers(-2**31, 2**31, n).astype(np.int64)
           .astype(np.int32),
           "present": rng.random(n) >= 0.1,
           "fval": (rng.random(n) * 180 - 90).astype(np.float32),
           "fval2": (rng.random(n) * 360 - 180).astype(np.float32),
           "cats": rng.integers(-1, 40, n).astype(np.int32)}
    ids = rng.integers(0, n_docs, (B, R)).astype(np.int32)
    if case == "dense":
        # a query of common terms: several buffers' worth a warp
        B, R = 1, 20000
        ids = rng.integers(0, n_docs, (B, R)).astype(np.int32)
    p = {"few": 0.001, "none": 0.0, "dense": 0.7}.get(case, 0.3)
    elig = rng.random((B, R)) < p
    targets = np.stack([rng.random((B, 1)) * 180 - 90,
                        rng.random((B, 1)) * 360 - 180], 2) \
        .astype(np.float32)
    tab = np.full((B, 64), np.inf, np.float32)
    tab[:, :40] = rng.random((B, 40))
    spec = ("value", SLOT, bool(seed % 2))
    if case == "few":
        elig[:, :] = False
        for b in range(B):
            elig[b, rng.choice(R, min(b + 3, R), replace=False)] = True
    elif case == "kk_R":
        ids, elig = ids[:, :k + 30], elig[:, :k + 30]
    elif case == "hi_collide":
        # hi words 2^30 + small: one float32 image, distinct exact keys
        col["hi"] = (2**30 + rng.integers(0, 40, n)).astype(np.int32)
        col["present"][:] = True
    elif case == "zeros":
        # |fval - target| = 0 on a third of the docs, negated descending
        spec = ("dist", SLOT, True)
        targets[:, :, 0] = 12.5
        col["fval"][rng.random(n) < 0.3] = 12.5
    elif case == "nan_inf":
        spec = ("dist", SLOT, bool(seed % 2))
        r = rng.random(n)
        col["fval"][r < 0.05] = np.nan
        col["fval"][(r >= 0.05) & (r < 0.1)] = np.inf
        col["fval"][(r >= 0.1) & (r < 0.15)] = -np.inf
    elif case == "nan_few":
        # NaN keys with few ineligible rows: they reach the window
        spec = ("dist", SLOT, False)
        col["fval"][rng.random(n) < 0.95] = np.nan
        elig = rng.random((B, R)) < 0.97
        ids, elig = ids[:, :80], elig[:, :80]
    elif case == "strmetric":
        spec = ("strmetric", SLOT, bool(seed % 2), 64)
        tab[:, 3] = np.nan
        tab[:, 5] = -np.inf
    elif case == "geodist":
        spec = ("geodist", SLOT, bool(seed % 2))
    elif case == "cert_ties":
        # every key on a handful of images: k - 1 and kk - 1 tie
        col["hi"] = rng.integers(0, 3, n).astype(np.int32)
    elif case == "many_ties":
        # more than MAX_FULLWIDTH_KK eligible rows on one key
        col["hi"][:] = 7
        col["lo"][:] = 3
        col["present"][:] = True
    sums = (rng.integers(0, 40, ids.shape) / 8.0).astype(np.float32)
    t = torch.from_numpy
    colt = {c: t(v) for c, v in col.items()}
    colt["max_hi"], colt["max_lo"] = colt["hi"].clone(), colt["lo"].clone()
    strtabs = {0: t(tab)} if spec[0] == "strmetric" else {}
    return (spec, colt, t(np.ascontiguousarray(ids)),
            t(np.ascontiguousarray(sums)), t(np.ascontiguousarray(elig)), k,
            t(targets), strtabs)


FW_CASES = ("random", "few", "none", "kk_R", "hi_collide", "zeros",
            "nan_inf", "nan_few", "strmetric", "geodist", "cert_ties",
            "many_ties", "dense")


def fw_words(spec, col, ids, sums, elig, targets, strtabs):
    """Every row's key words as the kernel compares them, int64 [B, R, NK]
    in [0, 2^32): the spec's words, the masked docid, the row."""
    B, R = ids.shape
    ws = kernels.sort_words((spec,), [col], ids, sums, elig, targets,
                            strtabs)
    ws = [w.numpy() for w in ws] + [np.broadcast_to(np.arange(R), (B, R))]
    return np.stack(ws, -1).astype(np.int64)


def fw_queues(elig_b, b, R, G, gpw):
    """-> per block g of query b, per warp, its queue: the eligible rows
    (within the query) of its groups, in row order. The query's flat
    16-row groups [f0, f1) go in steps of WARPS x gpw to the G blocks in
    turn, gpw groups a warp a step."""
    lo = b * R
    f0 = lo // 16
    gi = (lo + np.arange(R)) // 16 - f0
    step = WARPS * gpw
    block = (gi // step) % G
    warp = (gi % step) // gpw
    return [[np.flatnonzero(elig_b & (block == g) & (warp == w))
             for w in range(WARPS)] for g in range(G)]


def word64(x):
    """A key's first 64-bit word: its first two 32-bit words."""
    return (x[0] << 32) | x[1]


def word64_b(x):
    """A key's second 64-bit word: its other 32-bit words (a value key's
    docid and row, a float key's row)."""
    b = 0
    for w in x[2:]:
        b = (b << 32) | w
    return b


SELECT_PATHS = {"one on A": 0, "all on A": 0, "search on A": 0,
                "block": 0}


def kth_word(av, kk):
    """The largest 64-bit A with fewer than kk of the words av below it
    (the kk-th smallest), bit by bit below the highest bit in which the
    words differ, as warp_select and block_select find it."""
    lo, hi = min(av), max(av)
    A = lo
    if lo != hi:
        top = (lo ^ hi).bit_length() - 1
        A = lo & ~((2 << top) - 1)
        for bit in range(top, -1, -1):
            if sum(v < (A | 1 << bit) for v in av) < kk:
                A |= 1 << bit
    assert A == sorted(av)[kk - 1]
    return A


def block_keep(lists, kk):
    """csrc block_select and warp_keep: each WarpList's keys whose first
    64-bit word is at most the block's kk-th key's. -> that word as a key
    prefix (two words)."""
    SELECT_PATHS["block"] += 1
    A = kth_word([word64(x) for L in lists for x in L.buf], kk)
    for L in lists:
        L.buf = [x for x in L.buf if word64(x) <= A]
    return (A >> 32, A & FULL)


def warp_select(buf, kk):
    """csrc warp_select: the kk-th of n > kk unique keys, found as the
    kernel finds it - the largest 64-bit X with fewer than kk keys' first
    64-bit word below X, bit by bit below the highest bit in which the
    words differ; then, among the keys on that word, the largest Y with
    fewer than m of their last 64-bit words below Y (m the kk-th's place
    among them), or the largest of those words where all of them are in.
    -> (the kk best keys in buf's order, the kk-th)."""
    av = [word64(x) for x in buf]
    A = kth_word(av, kk)
    bv = [word64_b(x) for x in buf]
    m = kk - sum(v < A for v in av)
    tied = [b for v, b in zip(av, bv) if v == A]
    assert 1 <= m <= len(tied)
    if m == len(tied):
        SELECT_PATHS["one on A" if m == 1 else "all on A"] += 1
        B = max(tied)
    else:
        SELECT_PATHS["search on A"] += 1
        B = 0
        for bit in range(63, -1, -1):
            if sum(b < (B | 1 << bit) for b in tied) < m:
                B |= 1 << bit
    K = next(x for x, v, b in zip(buf, av, bv) if (v, b) == (A, B))
    kept = [x for x in buf if x <= K]
    assert len(kept) == kk and K == sorted(buf)[kk - 1]
    return kept, K


class WarpList:
    """A warp's candidate buffer (keys as tuples, in no order) of FW_CAP
    keys and its threshold, as csrc/fullwidth_topk.cu list_add and
    list_flush keep them: survivors appended; where an append would
    overflow, the buffer's kk best selected (warp_select), the threshold
    their kk-th (and the keys compared again with it). A key's first
    64-bit word is its first two words; the block's bound blk[0] and the
    query's qb[0] (qb None in the merge) are the least of their warps'
    thresholds' first 64-bit words."""

    flushes = 0   # the selections of every list, for the tests

    def __init__(self, nk):
        self.buf = []
        self.thr = (FULL,) * nk

    def flush(self, kk, blk0, qb):
        WarpList.flushes += 1
        self.buf, self.thr = warp_select(self.buf, kk)
        blk0[0] = min(blk0[0], self.thr[:2])
        if qb is not None:
            qb[0] = min(qb[0], self.thr[:2])

    def add(self, batch, kk, blk0, qb):
        if not batch:
            return
        if len(self.buf) + len(batch) > FW_CAP:
            self.flush(kk, blk0, qb)
            batch = [x for x in batch if x < self.thr]
        self.buf += batch

    def done(self, kk, blk0, qb):
        if len(self.buf) > kk:
            self.flush(kk, blk0, qb)
        return self.buf


def run_interleaved(walks, rng):
    """Step the generators in an order drawn from rng until all end: the
    warps of a block run in any order, a batch at a time."""
    live = list(walks)
    while live:
        i = int(rng.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live.pop(i)


def block_best(lists, kk):
    """The block's kk best keys in order: each key (of at most kk a list)
    ranked by counting the keys below it in every list (keys are
    unique)."""
    n = sum(len(L) for L in lists)
    F = [None] * min(kk, n)
    for L in lists:
        assert len(L) <= kk
        for x in L:
            at = sum(y < x for M in lists for y in M)
            if at < kk:
                assert F[at] is None
                F[at] = x
    assert None not in F
    return F


def key_image(w0, value):
    """csrc key_image: float(hi) of a value key's first word, the float key
    of the others' (fkey inverted)."""
    if value:
        return np.float32(np.uint32(w0 ^ 0x80000000).view(np.int32))
    bits = (w0 & 0x7FFFFFFF) if w0 & 0x80000000 else (~w0 & FULL)
    return np.uint32(bits).view(np.float32)


def emulate_fullwidth(spec, col, ids, sums, elig, k, targets=None,
                      strtabs=None, plan=None, seed=0):
    """csrc/fullwidth_topk.cu's decomposition, row by row. -> (docids
    i32[B,k], scores f32[B,k], certified bool[B]) as numpy arrays."""
    B, R = ids.shape
    kk = min(k + kernels.FULLWIDTH_WINDOW, R)
    value = spec[0] == "value"
    nk = 4 if value else 3
    words = fw_words(spec, col, ids, sums, elig, targets, strtabs or {})
    G, gpw = plan or kernels.fullwidth_plan(B, R)
    rng = np.random.default_rng(seed)
    el, idn, sn = elig.numpy(), ids.numpy(), sums.numpy()
    out_d = np.empty((B, k), np.int32)
    out_s = np.empty((B, k), np.float32)
    cert = np.empty(B, bool)
    for b in range(B):
        qb = [(FULL, FULL)]   # the query's bound
        cand = []             # the query's candidates, as warps end
        n_elig = 0
        for queues in fw_queues(el[b], b, R, G, gpw):
            lists = [WarpList(nk) for _ in range(WARPS)]
            blk0 = [(FULL, FULL)]

            def walk(w, q, lists=lists, blk0=blk0):
                L = lists[w]
                for i0 in range(0, len(q), 32 * FW_U):
                    # the first 64-bit words of 4 x 32 rows against the
                    # bounds as they stood; each 32 in full against the
                    # threshold as it stands
                    lim = min(L.thr[:2], blk0[0], qb[0])
                    for i in range(i0, min(i0 + 32 * FW_U, len(q)), 32):
                        keys = [tuple(int(v) for v in words[b, r])
                                for r in q[i:i + 32]]
                        L.add([x for x in keys
                               if x[:2] <= lim and x < L.thr], kk, blk0, qb)
                        yield
                L.done(kk, blk0, qb)

            run_interleaved([walk(w, q) for w, q in enumerate(queues)], rng)
            n_elig += sum(len(q) for q in queues)
            if sum(len(L.buf) for L in lists) > 2 * kk:
                # the block's kk best (and ties on their first 64-bit
                # word) alone, that word the query's bound
                qb[0] = min(qb[0], block_keep(lists, kk))
            # the warps append their keys as they end
            for w in rng.permutation(WARPS):
                cand.extend(lists[w].buf)
        assert len(cand) <= WARPS * G * kk
        # the merge: warp w the runs of 32 w, w + 8, ... in FW_MQ's, behind
        # the walk's bound
        lists = [WarpList(nk) for _ in range(WARPS)]
        blk0 = [qb[0]]

        def merge(w):
            L = lists[w]
            for c0 in range(w * 32 * FW_MQ, len(cand), 32 * FW_MQ * WARPS):
                for q in range(FW_MQ):
                    run = cand[c0 + 32 * q:c0 + 32 * q + 32]
                    L.add([x for x in run if x[:2] <= blk0[0] and x < L.thr],
                          kk, blk0, None)
                    yield
            L.done(kk, blk0, None)

        run_interleaved([merge(w) for w in range(WARPS)], rng)
        if sum(len(L.buf) for L in lists) > kk:
            block_keep(lists, kk)
        F = block_best([L.buf for L in lists], kk)
        c0 = FULL if value else 0xFF800000
        nb = sum(1 for x in F if x[0] <= c0)
        n_inel = R - n_elig

        def src(j):
            return j if j < nb else (-1 if j - nb < n_inel else j - n_inel)

        for j in range(k):
            s = src(j)
            if s < 0:
                out_d[b, j], out_s[b, j] = SENTINEL, -np.inf
            else:
                out_d[b, j] = idn[b, F[s][-1]]
                out_s[b, j] = sn[b, F[s][-1]]
        plateau = np.float32(2.0**31) if value else np.float32(np.inf)

        def img(j):
            s = src(j)
            return plateau if s < 0 else key_image(F[s][0], value)

        cert[b] = img(kk - 1) > img(k - 1)
    return out_d, out_s, cert


def fw_plain(case):
    spec, col, ids, sums, elig, k, targets, strtabs = case
    return [t.numpy() for t in kernels._fullwidth_topk_plain(
        spec, col, ids, sums, elig, k, targets, strtabs)]


def same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


def fw_plans(B, R):
    """The plan of the launch and others: one block, several blocks of few
    warps' rows, many small blocks."""
    return sorted({kernels.fullwidth_plan(B, R), (1, 32), (1, 1), (3, 4),
                   (2 * WARPS + 1, 2)})


@pytest.mark.parametrize("case", FW_CASES)
def test_fullwidth_emulation_equals_plain(case):
    c = fw_case(case, seed=FW_CASES.index(case))
    want = fw_plain(c)
    B, R = c[2].shape
    for i, plan in enumerate(fw_plans(B, R)):
        same(emulate_fullwidth(*c, plan=plan, seed=i), want)


def test_fullwidth_cases_reach_their_edges():
    """Each named case makes the edge it names."""
    d, _s, cert = fw_plain(fw_case("few"))
    assert not cert.any() and (d == SENTINEL).sum(1).min() > 0
    d, _s, cert = fw_plain(fw_case("none"))
    assert (d == SENTINEL).all() and not cert.any()
    c = fw_case("kk_R")
    assert min(c[5] + kernels.FULLWIDTH_WINDOW, c[2].shape[1]) == \
        c[2].shape[1]
    d, _s, cert = fw_plain(fw_case("cert_ties"))
    assert not cert.any()
    # NaN keys past the ineligible rows reach the window's first k
    c = fw_case("nan_few")
    d, _s, _c = fw_plain(c)
    nan_rows = torch.isnan(c[1]["fval"][c[2].long()]) & c[4]
    assert nan_rows.any()
    assert any(int(x) in set(c[2][b][nan_rows[b]].tolist())
               for b in range(d.shape[0]) for x in d[b] if x != SENTINEL)
    c = fw_case("many_ties", k=60)
    assert int(c[4].sum(1).min()) > kernels.MAX_FULLWIDTH_KK
    # the dense case's warps overflow their buffers mid-walk: more flushes
    # than the walk's end makes (one a warp, and the merge's)
    c = fw_case("dense")
    WarpList.flushes = 0
    emulate_fullwidth(*c, plan=(1, 32))
    assert WarpList.flushes > 2 * WARPS
    # warp_select's three ways to the kk-th key's second word: the one key
    # on its first word, all the keys on it in, a search among them; and
    # block_select
    for p in SELECT_PATHS:
        SELECT_PATHS[p] = 0
    for case in ("dense", "many_ties"):
        for plan in ((1, 32), (3, 4)):
            emulate_fullwidth(*fw_case(case, k=60), plan=plan)
    assert all(SELECT_PATHS.values()), SELECT_PATHS


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(B=st.integers(1, 3), R=st.integers(1, 2500), G=st.integers(1, 12),
       gpw=st.sampled_from([1, 2, 8, 32]),
       case=st.sampled_from(FW_CASES), k=st.integers(1, 64),
       seed=st.integers(0, 2**16))
def test_fullwidth_any_plan_equals_plain(B, R, G, gpw, case, k, seed):
    if case == "kk_R":
        R = max(R, k + 30)
    c = fw_case(case, B=B, R=R, seed=seed, k=k)
    R = c[2].shape[1]
    if not 0 < k < min(k + kernels.FULLWIDTH_WINDOW, R):
        return
    same(emulate_fullwidth(*c, plan=(G, gpw), seed=seed), fw_plain(c))


def jax_fullwidth(spec, col, ids, sums, elig, k, targets, strtabs):
    """JAX's _fullwidth_topk through _rank_and_topk's fast branch under
    vmap (as tests/test_torch_aggs.py drives it)."""
    import jax
    import jax.numpy as jnp

    import xapiand_tpu.ops.executor as jex

    jseg = {"values": {spec[1]: {c: jnp.asarray(v.numpy())
                                 for c, v in col.items()}}}
    cfg = jex.ExecConfig(T=1, L=128, k=k, tree=("G", 0), sort=(spec,))
    plan = {"sort_targets": jnp.asarray(targets.numpy()),
            "sort_strtabs": {i: jnp.asarray(t.numpy())
                             for i, t in strtabs.items()}}

    def one(p, d, s, e):
        out = {}
        dd, vv, _ = jex._rank_and_topk(cfg, jseg, d, s, e, plan=p,
                                       fast=True, out=out)
        return dd, vv, out["certified"]

    return [np.asarray(a) for a in jax.vmap(one)(
        plan, jnp.asarray(ids.numpy()), jnp.asarray(sums.numpy()),
        jnp.asarray(elig.numpy()))]


@pytest.mark.parametrize("case", [c for c in FW_CASES if c != "nan_few"])
def test_fullwidth_emulation_equals_jax(case):
    """The certificate is JAX's for every query, the certified queries'
    docids and scores JAX's. (nan_few: JAX's top_k places NaN images
    elsewhere, and such queries do not certify in either.)"""
    c = fw_case(case, seed=FW_CASES.index(case))
    gd, gs, gc = emulate_fullwidth(*c)
    jd, js, jc = jax_fullwidth(*c)
    np.testing.assert_array_equal(gc, jc)
    np.testing.assert_array_equal(gd[gc], jd[jc])
    np.testing.assert_array_equal(gs[gc].view(np.int32),
                                  js[jc].view(np.int32))


def test_fullwidth_nan_window_does_not_certify():
    c = fw_case("nan_few", seed=3)
    _d, _s, gc = emulate_fullwidth(*c)
    _jd, _js, jc = jax_fullwidth(*c)
    assert not gc.any() and not jc.any()


@pytest.mark.parametrize("B,R", [(64, 1310720), (64, 131072), (128, 65536),
                                 (1, 1000), (2, 40)])
def test_fullwidth_plans_at_the_faceted_shapes(B, R):
    """fullwidth_plan: B x G within FULLWIDTH_BLOCKS (or one block a
    query), blocks of FULLWIDTH_ROWS rows at least where there are two or
    more, every warp a step; the faceted launches fill the card."""
    G, gpw = kernels.fullwidth_plan(B, R)
    assert 1 <= G and (G == 1 or B * G <= kernels.FULLWIDTH_BLOCKS)
    assert G == 1 or -(-R // G) >= kernels.FULLWIDTH_ROWS
    groups = -(-(-(-R // 16)) // G)
    assert gpw in (1, 2, 4, 8, 16, 32)
    assert gpw == 1 or groups >= WARPS * gpw
    if R >= 65536 and B >= 64:
        assert B * G >= 132


# --------------------------------------------------------------------------
# shard_merge (and chunk_merge, its unstriped mode)
# --------------------------------------------------------------------------

def merge_case(case, S=8, Q=6, k=10, seed=0, nd=60):
    """(docids i32[S,Q,k], scores f32[S,Q,k], orderkey i32[S,nd] or None,
    sort_keys i32[S,Q,k,NU] or None, stripe) of a named case, CPU tensors:
    scores full of ties, -0.0 beside 0.0, NaN, +-inf; -inf rows (invalid);
    insertion-order keys with ties; emitted key words with ties; the chunk
    merge (unstriped); k 1; one shard; wide pages (M 2,400); planes past
    SHARD_MERGE_SMEM (the device scratch)."""
    rng = np.random.default_rng(seed)
    if case == "k1":
        k = 1
    elif case == "s1":
        S = 1
    elif case == "wide":
        k, Q = 300, 2
    elif case == "global":
        k, Q = 2100, 2
    d = rng.integers(0, nd, (S, Q, k)).astype(np.int32)
    s = rng.choice(np.array([0.5, 1.0, 2.0, 0.0, -0.0, np.nan, -np.inf,
                             np.inf], np.float32), (S, Q, k))
    ok = keys = None
    stripe = case != "chunk"
    if case in ("okey", "keys"):
        ok = rng.integers(0, 30, (S, nd)).astype(np.int32)
    if case == "keys":
        ik = rng.integers(-3, 3, (S, Q, k)).astype(np.int32)
        fk = rng.choice(np.array([1.5, 0.0, -0.0, np.nan, np.inf],
                                 np.float32), (S, Q, k))
        keys = np.stack([(ik.view(np.uint32) ^ np.uint32(2**31)),
                         kernels._fkey(torch.from_numpy(fk)).numpy()
                         .astype(np.uint32)], 3).view(np.int32)
    if case == "chunk":
        # each chunk's finalists: SENTINEL where the score is -inf
        d = np.where(np.isneginf(s), SENTINEL, d).astype(np.int32)
    t = torch.from_numpy
    return (t(d), t(s), None if ok is None else t(ok),
            None if keys is None else t(np.ascontiguousarray(keys)), stripe)


MERGE_CASES = ("relevance", "okey", "keys", "chunk", "k1", "s1", "wide",
               "global")


def merge_words(docids, scores, orderkey, sort_keys, stripe):
    """Every candidate's key words, int64 [Q, M, nw] in [0, 2^32) in the
    gathered (shard-major) order - the key words, okey, the position - and
    its gdoc and score, as shard_merge.cu stages them."""
    S, Q, k = docids.shape
    shard = torch.arange(S).view(S, 1, 1)
    invalid = torch.isinf(scores) & (scores < 0)
    gdoc = torch.where(invalid, 2**31 - 1, kernels._wrap32(
        docids.long() * S + shard) if stripe else docids)
    okey = gdoc
    if orderkey is not None:
        n = orderkey.shape[1]
        okey = torch.gather(orderkey, 1, docids.clamp(0, n - 1).long()
                            .view(S, Q * k)).view(S, Q, k)
        okey = torch.where(invalid, 2**31 - 1, okey)

    def g(x):
        return x.permute(1, 0, *range(2, x.dim())).reshape(
            Q, S * k, *x.shape[3:])
    if sort_keys is not None:
        ws = [g(sort_keys).long() & FULL]
    else:
        ws = [kernels._fkey(-g(scores))[..., None]]
    ws.append(kernels._ikey(g(okey))[..., None])
    ws.append(torch.arange(S * k).expand(Q, S * k)[..., None])
    return (torch.cat(ws, 2).numpy(), g(gdoc).numpy(),
            g(scores).numpy())


def emulate_merge(docids, scores, orderkey, sort_keys, stripe):
    """shard_merge.cu's block: each candidate ranked by counting the
    candidates before it, four first words at a time, stopping once the
    count reaches k; those below k written at their rank (every slot
    once). -> (docids i32[Q,k], scores f32[Q,k])."""
    S, Q, k = docids.shape
    M = S * k
    words, gdoc, sc = merge_words(docids, scores, orderkey, sort_keys,
                                  stripe)
    out_d = np.zeros((Q, k), np.int32)
    out_s = np.zeros((Q, k), np.float32)
    for q in range(Q):
        # the candidates before each (keys are unique: its place in their
        # order); where M is small, counted as the block counts them
        order = np.lexsort(words[q].T[::-1])
        ranks = np.empty(M, np.int64)
        ranks[order] = np.arange(M)
        if M <= 256:
            w = [tuple(int(x) for x in row) for row in words[q]]
            for i in range(M):
                rank, j = 0, 0
                while j < M and rank < k:
                    step = 4 if j + 4 <= M else 1
                    rank += sum(w[t] < w[i] for t in range(j, j + step))
                    j += step
                assert (rank < k) == (ranks[i] < k)
                assert rank >= k or rank == ranks[i]
        written = np.zeros(k, int)
        for i in np.flatnonzero(ranks < k):
            out_d[q, ranks[i]], out_s[q, ranks[i]] = gdoc[q, i], sc[q, i]
            written[ranks[i]] += 1
        assert (written == 1).all()
    return out_d, out_s


def merge_plain(docids, scores, orderkey, sort_keys, stripe):
    return [t.numpy() for t in kernels._shard_merge_plain(
        docids, scores, orderkey, sort_keys, stripe)]


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_emulation_equals_plain(case):
    c = merge_case(case, seed=MERGE_CASES.index(case))
    same(emulate_merge(*c), merge_plain(*c))


def test_merge_cases_reach_their_edges():
    """The wide pages' planes fit shared memory, the global case's do not;
    the relevance case ties on its first word across shards."""
    for case, fits in (("wide", True), ("global", False), ("keys", True)):
        d, _s, _o, keys, _st = merge_case(case)
        S, Q, k = d.shape
        nw = (keys.shape[-1] if keys is not None else 1) + 2
        assert (kernels.merge_plane_bytes(S * k, nw) <=
                kernels.SHARD_MERGE_SMEM) == fits
        assert (kernels._merge_scratch(S * k, Q, nw, CPU) is None) == fits
    words, _g, _s = merge_words(*merge_case("relevance"))
    assert len(np.unique(words[0, :, 0])) < words.shape[1] // 4


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(S=st.integers(1, 9), Q=st.integers(1, 3), k=st.integers(1, 40),
       case=st.sampled_from(("relevance", "okey", "keys", "chunk")),
       seed=st.integers(0, 2**16))
def test_merge_any_shape_equals_plain(S, Q, k, case, seed):
    c = merge_case(case, S=S, Q=Q, k=k, seed=seed)
    same(emulate_merge(*c), merge_plain(*c))


def jax_merge(docids, scores, orderkey, sort_keys, stripe):
    """make_sharded_step's merge (xapiand_tpu/parallel/sharded.py 394-441)
    or _execute_chunked's finalists' sort (executor.py 1058-1063): the
    stable lax.sort of the gathered keys, its first k."""
    import jax
    import jax.numpy as jnp

    S, Q, k = docids.shape
    d, s = jnp.asarray(docids.numpy()), jnp.asarray(scores.numpy())
    shard = jnp.arange(S, dtype=jnp.int32)[:, None, None]
    invalid = jnp.isinf(s) & (s < 0)
    gdoc = jnp.where(invalid, jnp.int32(2**31 - 1),
                     d * S + shard if stripe else d)
    ok = gdoc if orderkey is None else jnp.where(
        invalid, jnp.int32(2**31 - 1),
        jnp.take_along_axis(jnp.asarray(orderkey.numpy())[:, None, :]
                            .repeat(Q, 1), d, axis=2, mode="clip"))

    def g(x):
        return jnp.moveaxis(x, 0, 1).reshape(Q, S * k, *x.shape[3:])
    if sort_keys is not None:
        kw = g(jnp.asarray(sort_keys.numpy()).view(jnp.uint32))
        gk = tuple(kw[..., u] for u in range(kw.shape[-1]))
        out = jax.lax.sort(gk + (g(ok), g(gdoc), g(s)),
                           num_keys=len(gk) + 1, dimension=1)
    else:
        out = jax.lax.sort((-g(s), g(ok), g(gdoc), g(s)), num_keys=2,
                           dimension=1)
    return np.asarray(out[-2][:, :k]), np.asarray(out[-1][:, :k])


@pytest.mark.parametrize("case", ["relevance", "okey", "keys", "chunk",
                                  "k1", "s1"])
def test_merge_emulation_equals_jax(case):
    c = merge_case(case, seed=20 + MERGE_CASES.index(case))
    same(emulate_merge(*c), jax_merge(*c))


# --------------------------------------------------------------------------
# compact_rows' cases (its kernel is the parent's; the CUDA tests hold it
# on them)
# --------------------------------------------------------------------------

def compact_case(case, B=3, R=3000, seed=0):
    """(mask, ids, sums, orbits, cap) of a named case, CPU tensors."""
    rng = np.random.default_rng(seed)
    mask = rng.random((B, R)) < 0.2
    if case == "zero":
        mask[:] = False
    elif case == "run":
        # one run of masked rows across the kernel's chunks of 8,192 rows
        mask[:] = False
        mask[:, R // 8:R - R // 8] = True
    ids = rng.integers(0, 10**6, (B, R)).astype(np.int32)
    sums = rng.random((B, R)).astype(np.float32)
    orbits = rng.integers(0, 2**31, (B, R)).astype(np.int32)
    n = mask.sum(1)
    cap = int(n.max()) if case == "full" else int(n.max()) + 37
    if case == "zero":
        cap = 16
    t = torch.from_numpy
    return (t(mask), t(ids), t(sums),
            None if case == "no_orbits" else t(orbits), max(cap, 1))


COMPACT_CASES = ("orbits", "no_orbits", "full", "zero", "run")


def compact_expect(mask, ids, sums, orbits, cap):
    """What the kernel writes: the masked rows in row order, the first cap
    of them, SENTINEL / 0 / 0 past the count, the full count. -> numpy
    arrays (orbits None without)."""
    B = mask.shape[0]
    out_d = np.full((B, cap), SENTINEL, np.int32)
    out_s = np.zeros((B, cap), np.float32)
    out_o = np.zeros((B, cap), np.int32)
    n = mask.sum(1).numpy().astype(np.int32)
    for b in range(B):
        rows = np.flatnonzero(mask[b].numpy())[:cap]
        out_d[b, :len(rows)] = ids[b].numpy()[rows]
        out_s[b, :len(rows)] = sums[b].numpy()[rows]
        if orbits is not None:
            out_o[b, :len(rows)] = orbits[b].numpy()[rows]
    return out_d, out_s, out_o if orbits is not None else None, n


def compact_plain(case):
    return [None if t is None else t.numpy()
            for t in kernels._compact_rows_plain(*case)]


def same_compact(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            same([g], [w])


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_expectation_equals_plain(case):
    c = compact_case(case, seed=COMPACT_CASES.index(case))
    same_compact(compact_expect(*c), compact_plain(c))


def test_compact_cases_reach_their_edges():
    c = compact_case("full")
    assert int(c[0].sum(1).max()) == c[4]
    c = compact_case("zero")
    assert int(c[0].sum()) == 0
    c = compact_case("run", R=40000)
    assert bool(c[0][0, 8191]) and bool(c[0][0, 8192])
    mask, ids, sums, orbits, _cap = compact_case("orbits")
    with pytest.raises(AssertionError):
        kernels._compact_rows_plain(mask, ids, sums, orbits, 50)


@pytest.mark.parametrize("case", ["orbits", "no_orbits", "run"])
def test_compact_equals_jax(case):
    """The packed rows are JAX's lax.sort compaction's (executor.py
    893-911: key 0 for a masked row, then the docid) up to their order:
    the same (docid, sum, bits) rows and count, the port's in row order,
    JAX's by docid."""
    import jax.numpy as jnp
    from jax import lax

    mask, ids, sums, orbits, cap = compact_case(case, seed=5)
    d, s, o, n = compact_plain((mask, ids, sums, orbits, cap))
    ob = orbits if orbits is not None else torch.zeros_like(ids)
    for b in range(mask.shape[0]):
        key = jnp.where(jnp.asarray(mask[b].numpy()), 0, 1).astype(
            jnp.int32)
        k2, jd, js, jo = (np.asarray(a) for a in lax.sort(
            (key, jnp.asarray(ids[b].numpy()), jnp.asarray(sums[b].numpy()),
             jnp.asarray(ob[b].numpy())), num_keys=2))
        jn = int((k2 == 0).sum())
        assert jn == n[b]
        got = sorted(zip(d[b, :jn].tolist(), s[b, :jn].tolist(),
                         (o[b, :jn] if o is not None else
                          jo[:jn]).tolist()))
        # (lax.sort is not stable: rows of one docid in either order)
        assert got == sorted(zip(jd[:jn].tolist(), js[:jn].tolist(),
                                 jo[:jn].tolist()))
        assert (d[b, jn:] == SENTINEL).all()
