"""The decompositions the redesigned score_slices (K1) and merge_docs
(K2+K3) kernels rely on, held on the CPU against their plain versions.

  score_slices  csrc/score_slices.cu cuts each query's R rows into row
                tiles of SS_THREADS * SS_RPT rows across every term: a row
                finds its term by a search over row_off (terms of width 0
                passed), skips prefix terms' rows, reads nothing past lens
                and weighs the rest from lax.dynamic_slice's clamped start,
                uniqterms gathered at min(docid, ND); tile 0 writes the
                non-prefix tails; a block a (prefix term, query) sorts its
                rows by docid and writes its tail. An emulation of that
                writes every row and tail once and gives the plain
                version's bits, on hypothesis-drawn shapes: tiles across
                term borders, mixed prefix groups, clamped starts, queries
                without postings, uniqterms read by DiceCoeff.
  merge_docs    csrc/merge_docs.cu's doc tiles: a block a (query, docid
                range) brackets each term block's rows in its range, adds
                them in term order into an accumulator indexed by docid,
                ORs the bits, marks the first term of each doc, writes each
                row's sum, mask and orbits, and its share of the SENTINEL
                rows; the first and last tiles' rows outside every range go
                to the probes. An emulation of that (chunks of rows, one
                barrier a term, registers) gives _merge_docs_plain's
                outputs bit for bit: T = 1 to 128, NaN and -0.0 weights,
                docids at tile edges, empty tiles, all-SENTINEL queries,
                deletes, trees and orbits, n_docs too small.
  merge_plan    the rule between the doc tiles and the probes at the main
                paths' shapes.
  JAX           both emulations on the launch groups of a small segment,
                against JAX's rows (lax.dynamic_slice + the scheme; the
                docid sort and _merge_runs).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from xapiand_tpu_torch.models.weights import (CollectionStats, get_scheme,
                                              scheme_sumpart)
from xapiand_tpu_torch.ops import kernels

SENTINEL = kernels.SENTINEL
NONE = 0xffff


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def slices_world(seed, B, T, nd=3000, df=(1, 300), n_terms=None,
                 prefix=None, pcap=64, scheme="bm25", missing_p=0.1,
                 zero_scoring_p=0.1, guard=True, empty=(), hot=0):
    """One score_slices call's inputs, made with numpy from the seed (CPU
    tensors): a pool of n_terms terms of df[0]..df[1] sorted unique docids
    in [0, nd) (hot > 0: drawn from the first hot docids, so that terms
    share docs), their impact-ordered mirror (each term's postings
    shuffled), guard rows after the last term (the widest width and one;
    none without guard: a clamped start at the end); each (query, term) a
    pool term or, at missing_p, none; the queries in `empty` without
    postings; widths the power-of-two class of each term's longest, pcap
    for prefix terms. -> dict of the call's arguments."""
    rng = np.random.default_rng(seed)
    n_terms = n_terms or max(2 * T, 4)
    dfs = rng.integers(df[0], df[1] + 1, n_terms)
    space = hot if hot else nd
    dfs = np.minimum(dfs, space)
    docids = [np.sort(rng.choice(space, d, replace=False)) for d in dfs]
    toff = np.concatenate([[0], np.cumsum(dfs)])
    n = int(toff[-1])
    pick = rng.integers(0, n_terms, (B, T))
    lens = dfs[pick].astype(np.int32)
    offsets = toff[pick].astype(np.int32)
    miss = rng.random((B, T)) < missing_p
    for b in empty:
        miss[b] = True
    lens[miss] = 0
    offsets[miss] = 0
    is_prefix = tuple(bool(p) for p in (prefix or (False,) * T))
    widths = tuple(pcap if p else _pow2(max(int(lens[:, t].max()), 1))
                   for t, p in enumerate(is_prefix))
    guard = max(widths) + 1 if guard else 0
    wdf = rng.integers(1, 9, n + guard).astype(np.float32)
    dl = rng.integers(1, 400, n + guard).astype(np.float32)
    did = np.concatenate(docids + [np.zeros(guard, np.int64)]).astype(
        np.int32)
    perm = np.concatenate([toff[i] + rng.permutation(dfs[i])
                           for i in range(n_terms)] +
                          [np.arange(n, n + guard)]).astype(np.int64)
    stats = CollectionStats(doc_count=nd, avg_doclen=float(dl.mean()),
                            doclen_upper=float(dl.max()),
                            total_len=float(dl.sum()))
    sch = get_scheme(scheme)
    tc = np.array([[sch.term_constant(stats, max(int(x), 1),
                                      collfreq=max(int(x), 1))
                    for x in row] for row in lens], np.float32)
    scoring = np.where(rng.random((B, T)) < zero_scoring_p, 0.0,
                       1.0).astype(np.float32)
    spec = sch.kernel_spec(stats)
    uniq = rng.integers(1, 60, nd + 1).astype(np.float32) \
        if spec.needs_uniq else None
    t = torch.from_numpy
    post = (t(did), t(wdf), t(dl))
    imp = (t(did[perm]), t(wdf[perm]), t(dl[perm])) if any(is_prefix) \
        else None
    return {"post": post, "imp": imp, "offsets": t(offsets),
            "lens": t(lens), "tconst": t(tc), "scoring": t(scoring),
            "widths": widths, "is_prefix": is_prefix, "spec": spec,
            "uniq": None if uniq is None else t(uniq), "nd": nd}


def world_args(wd, device="cpu"):
    """score_slices' positional arguments of a slices_world, on device."""
    def on(x):
        return None if x is None else x.to(device)

    return ((tuple(on(x) for x in wd["post"]),
             None if wd["imp"] is None else tuple(on(x) for x in wd["imp"]),
             on(wd["offsets"]), on(wd["lens"]), on(wd["tconst"]),
             on(wd["scoring"]), wd["widths"], wd["is_prefix"], wd["spec"],
             on(wd["uniq"])))


def merge_world(seed, B, widths, nd, fill=0.7, hot=0, nan_p=0.0,
                neg0_p=0.0, empty=()):
    """One merge_docs call's rows, made with numpy: each term block of
    widths[t] rows holds up to fill * width sorted unique docids in
    [0, nd) (hot: from the first hot docids), SENTINEL-padded; weights
    in [0, 4), NaN at nan_p and -0.0 at neg0_p; the queries in `empty`
    all SENTINEL. -> ids i32[B,R], w f32[B,R] (CPU)."""
    rng = np.random.default_rng(seed)
    R = sum(widths)
    ids = np.full((B, R), SENTINEL, np.int32)
    w = np.zeros((B, R), np.float32)
    ro = kernels.row_offsets(widths)
    for b in range(B):
        if b in empty:
            continue
        for t, W in enumerate(widths):
            space = hot if hot else nd
            n = min(int(rng.integers(0, int(fill * W) + 1)), space, W)
            d = np.sort(rng.choice(space, n, replace=False))
            ids[b, ro[t]:ro[t] + n] = d
            w[b, ro[t]:ro[t] + n] = rng.random(n) * 4
    real = ids != SENTINEL
    w[real & (rng.random((B, R)) < nan_p)] = np.nan
    w[real & (rng.random((B, R)) < neg0_p)] = -0.0
    return torch.from_numpy(ids), torch.from_numpy(w)


# --------------------------------------------------------------------------
# score_slices: row tiles, prefix blocks
# --------------------------------------------------------------------------

def emulate_score_slices(post, imp, offsets, lens, tconst, scoring, widths,
                         is_prefix, spec, uniq=None, threads=256, rpt=8):
    """csrc/score_slices.cu as it runs: the row tiles (every row a thread
    takes, its term by the search over row_off, prefix rows skipped,
    nothing read past lens), tile 0's tails, then the prefix blocks. ->
    (ids, w, tail) and the times each row and tail was written."""
    B, T = offsets.shape
    ro = kernels.row_offsets(widths)
    R = ro[-1]
    ids = torch.full((B, R), -1, dtype=torch.int32)
    w = torch.full((B, R), float("nan"))
    tail = torch.full((B, T), float("nan"))
    wrote = torch.zeros((B, R), dtype=torch.int32)
    wrote_tail = torch.zeros((B, T), dtype=torch.int32)
    tile = threads * rpt
    n_post = post[0].shape[0]
    starts = torch.tensor(ro[:T])
    pref = torch.tensor(is_prefix, dtype=torch.bool)
    width = torch.tensor(widths, dtype=torch.long)
    if not all(is_prefix):
        for b in range(B):
            for j in range(max(1, -(-R // tile))):
                if j == 0:
                    tail[b, ~pref] = 0.0
                    wrote_tail[b, ~pref] += 1
                # the rows of the tile's SS_RPT runs of SS_THREADS
                r = torch.arange(j * tile, min(R, (j + 1) * tile))
                t = torch.searchsorted(starts, r, right=True) - 1
                keep = ~pref[t]
                r, t = r[keep], t[keep]
                i = r - starts[t]
                ln = lens[b, t].long()
                inl = i < ln
                start = offsets[b, t].long().clamp(
                    max=n_post - width[t]).clamp(min=0)
                s = (start + i)[inl]
                tt = t[inl]
                d = post[0][s]
                u = uniq[d.clamp(max=uniq.shape[0] - 1)] \
                    if uniq is not None else None
                tc = (tconst[b, tt],) if tconst.dim() == 2 else \
                    tuple(tconst[b, tt, c] for c in range(tconst.shape[2]))
                wv = kernels._scored(scheme_sumpart(
                    spec, post[1][s], post[2][s], tc, u), scoring[b, tt])
                ids[b, r] = SENTINEL
                w[b, r] = 0.0
                ids[b, r[inl]] = d
                w[b, r[inl]] = wv
                wrote[b, r] += 1
    for t in (t for t in range(T) if is_prefix[t]):
        one = kernels._score_slices_plain(
            post, imp, offsets[:, t:t + 1], lens[:, t:t + 1],
            tconst[:, t:t + 1], scoring[:, t:t + 1], (widths[t],), (True,),
            spec, uniq)
        ids[:, ro[t]:ro[t + 1]] = one[0]
        w[:, ro[t]:ro[t + 1]] = one[1]
        tail[:, t] = one[2][:, 0]
        wrote[:, ro[t]:ro[t + 1]] += 1
        wrote_tail[:, t] += 1
    return ids, w, tail, wrote, wrote_tail


def same_bits(got, want):
    """Equal tensors, float NaNs equal to NaNs, -0.0 apart from +0.0."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(
        got.masked_fill(nan, 0.0).view(torch.int32),
        want.masked_fill(nan, 0.0).view(torch.int32))


def check_slices(wd, threads=256, rpt=8):
    args = world_args(wd)
    want = kernels._score_slices_plain(*args)
    ids, w, tail, wrote, wrote_tail = emulate_score_slices(
        *args, threads=threads, rpt=rpt)
    assert bool((wrote == 1).all()) and bool((wrote_tail == 1).all())
    for g, x in zip((ids, w, tail), want):
        assert same_bits(g, x)
    # every term block leaves docid-ascending (merge_docs' premise)
    ro = kernels.row_offsets(wd["widths"])
    for t in range(len(wd["widths"])):
        blk = ids[:, ro[t]:ro[t + 1]]
        assert bool((blk[:, 1:] >= blk[:, :-1]).all()) or wd["clamped"]


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 10**6), B=st.integers(1, 4),
       T=st.integers(1, 9), n_pref=st.integers(0, 3),
       rpt=st.sampled_from([1, 2, 8]), threads=st.sampled_from([32, 256]),
       scheme=st.sampled_from(["bm25", "dicecoeff"]),
       guard=st.booleans())
@example(seed=707418, B=1, T=1, n_pref=0, rpt=1, threads=32, scheme="bm25",
         guard=False)  # a pool of 124 rows under a width of 128
def test_score_slices_row_tiles_equal_plain(seed, B, T, n_pref, rpt,
                                            threads, scheme, guard):
    """Row tiles across term borders, mixed prefix groups (a prefix width
    of 32 under the longest posting lists, so the tail bound is read), the
    clamped start (no guard rows: the last pool term's slice shifted back),
    uniqterms gathered for DiceCoeff."""
    n_pref = min(n_pref, T)
    prefix = (True,) * n_pref + (False,) * (T - n_pref)
    wd = slices_world(seed, B, T, df=(1, 90), prefix=prefix, pcap=32,
                      scheme=scheme, guard=guard, empty=(0,) if B > 2
                      else ())
    wd["clamped"] = not guard
    check_slices(wd, threads, rpt)


@pytest.mark.parametrize("widths_case", ["zero_width", "one_row", "T128"])
def test_score_slices_tile_edges(widths_case):
    """A term whose every query misses it (width 1, all SENTINEL), single
    rows, and geo's T = 128 with tiles of 64 rows (several terms a tile,
    several tiles a term)."""
    if widths_case == "T128":
        wd = slices_world(5, 3, 128, df=(10, 60), n_terms=300)
        wd["clamped"] = False
        check_slices(wd, threads=16, rpt=4)
        return
    wd = slices_world(7, 3, 5, df=(1, 1) if widths_case == "one_row"
                      else (1, 40), missing_p=0.0)
    if widths_case == "zero_width":
        wd["lens"][:, 2] = 0
        wd["offsets"][:, 2] = 0
    wd["clamped"] = False
    check_slices(wd, threads=32, rpt=1)


def test_score_slices_prefix_past_shared_memory():
    """A prefix wider than MAX_PREFIX_ROWS sorts in device scratch: the
    same rows (the emulation's prefix blocks are the plain version's)."""
    wd = slices_world(11, 2, 3, nd=40000, df=(100, 20000),
                      prefix=(True, False, True),
                      pcap=2 * kernels.MAX_PREFIX_ROWS, missing_p=0.0)
    wd["clamped"] = False
    check_slices(wd)


# --------------------------------------------------------------------------
# merge_docs: doc tiles summed in term order
# --------------------------------------------------------------------------

def _probe(ids, w, ro, widths, b, r, d, t, bits):
    """merge_docs.cu probe_row: the sum in term order, bits, owner."""
    s = np.float32(0.0)
    ob = 0
    m = 1
    for u, W in enumerate(widths):
        if u == t:
            s = np.float32(s + w[b, r])
            ob |= int(bits[b, u]) if bits is not None else 0
            continue
        blk = ids[b, ro[u]:ro[u] + W]
        p = int(np.searchsorted(blk, d, "left"))
        if p < W and blk[p] == d:
            s = np.float32(s + w[b, ro[u] + p])
            ob |= int(bits[b, u]) if bits is not None else 0
            if u < t:
                m = 0
    return s, ob, m


def emulate_merge_docs(ids, w, widths, bits=None, deleted=None, prog=None,
                       want_orbits=False, n_docs=None, tile=4096,
                       threads=256, rpt=8):
    """csrc/merge_docs.cu's doc tiles as they run, block by block: each
    term's bracket [a, e) in the block's docid range (from row 0 in the
    first tile, to the first SENTINEL in the last), the bracketed rows in
    chunks of threads * rpt, each chunk's terms in order with a barrier
    between them (the accumulator, the OR of bits, the first term), then
    each row's outputs (the probes for a docid outside the tiles), then the
    block's share of the SENTINEL rows. -> (sums, mask, count, orbits) as
    merge_docs returns them, and the times each row was written."""
    ids_n, w_n = ids.numpy(), w.numpy()
    bits_n = None if bits is None else bits.numpy()
    B, R = ids_n.shape
    T = len(widths)
    ro = kernels.row_offsets(widths)
    nt = max(1, -(-int(n_docs) // tile))
    sums = np.full((B, R), np.nan, np.float32)
    owner = np.zeros((B, R), bool)
    orbits = np.zeros((B, R), np.int64)
    wrote = np.zeros((B, R), np.int32)
    CH = threads * rpt
    for b in range(B):
        for j in range(nt):
            lo = j * tile
            a0, z0, n, ns = [], [], [], []
            for u, W in enumerate(widths):
                blk = ids_n[b, ro[u]:ro[u] + W]
                z = int(np.searchsorted(blk, SENTINEL, "left"))
                a = 0 if j == 0 else int(np.searchsorted(blk[:z], lo))
                e = z if j == nt - 1 else \
                    int(np.searchsorted(blk[:z], lo + tile))
                a0.append(a)
                z0.append(z)
                n.append(e - a)
                ns.append(W - z)
            pr = np.concatenate([[0], np.cumsum(n)])
            ps = np.concatenate([[0], np.cumsum(ns)])
            N = int(pr[-1])
            k = np.arange(N)
            term = np.searchsorted(pr[:T], k, "right") - 1
            rows = np.array([ro[u] for u in range(T)])[term] + \
                np.asarray(a0)[term] + (k - pr[term])
            d = ids_n[b, rows].astype(np.int64)
            slot = d - lo
            inside = (slot >= 0) & (slot < tile)
            acc = np.zeros(tile, np.float32)
            sob = np.zeros(tile, np.int64)
            first = np.full(tile, NONE, np.int64)
            for c0 in range(0, N, CH):
                c1 = min(N, c0 + CH)
                u0 = int(np.searchsorted(pr[:T + 1], c0, "right") - 1)
                u1 = int(np.searchsorted(pr[:T + 1], c1 - 1, "right") - 1)
                for u in range(u0, u1 + 1):   # a barrier after each
                    sel = np.arange(c0, c1)
                    sel = sel[(term[sel] == u) & inside[sel]]
                    s = slot[sel]
                    assert len(np.unique(s)) == len(s)   # one row a slot
                    acc[s] = acc[s] + w_n[b, rows[sel]]
                    if bits_n is not None:
                        sob[s] |= int(bits_n[b, u])
                    first[s] = np.where(first[s] == NONE, u, first[s])
            for kk in range(N):
                r, u = int(rows[kk]), int(term[kk])
                if inside[kk]:
                    sums[b, r] = acc[slot[kk]]
                    orbits[b, r] = sob[slot[kk]]
                    owner[b, r] = first[slot[kk]] == u
                else:
                    s, ob, m = _probe(ids_n, w_n, ro, widths, b, r,
                                      int(d[kk]), u, bits_n)
                    sums[b, r], orbits[b, r], owner[b, r] = s, ob, m
                wrote[b, r] += 1
            S = int(ps[-1])
            for e in range(S * j // nt, S * (j + 1) // nt):
                u = int(np.searchsorted(ps[:T], e, "right") - 1)
                r = ro[u] + z0[u] + (e - ps[u])
                sums[b, r], orbits[b, r], owner[b, r] = 0.0, 0, False
                wrote[b, r] += 1
    mask = torch.from_numpy(owner)
    ids_t = torch.from_numpy(ids_n)
    orb = torch.from_numpy(orbits.astype(np.int64).astype(np.int32))
    if deleted is not None:
        mask = mask & ~deleted[ids_t.clamp(max=deleted.shape[0] - 1).long()]
    if prog:
        mask = mask & kernels._eval_program_plain(prog, orb, [], ids.shape,
                                                  ids.device)
    return (torch.from_numpy(sums), mask, mask.sum(1, dtype=torch.int32),
            orb if want_orbits else None, wrote)


def check_merge(ids, w, widths, bits=None, deleted=None, prog=None,
                want_orbits=False, n_docs=3000, tile=256, threads=32,
                rpt=2):
    want = kernels._merge_docs_plain(ids, w, widths, bits, deleted, prog,
                                     want_orbits)
    got = emulate_merge_docs(ids, w, widths, bits, deleted, prog,
                             want_orbits, n_docs, tile, threads, rpt)
    assert (got[4] == 1).all(), "every row written once"
    for g, x in zip(got[:4], want):
        assert (g is None) == (x is None)
        if g is not None:
            assert same_bits(g, x)
    return want


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 10**6), B=st.integers(1, 3),
       T=st.sampled_from([1, 2, 3, 4, 7]), wmax=st.integers(1, 300),
       hot=st.sampled_from([0, 50, 400]), tile=st.sampled_from([16, 64,
                                                                 256]),
       rpt=st.sampled_from([1, 2, 8]), nan_p=st.sampled_from([0.0, 0.1]),
       neg0_p=st.sampled_from([0.0, 0.2]), tree=st.booleans(),
       deletes=st.booleans())
def test_merge_docs_doc_tiles_equal_plain(seed, B, T, wmax, hot, tile, rpt,
                                          nan_p, neg0_p, tree, deletes):
    """Doc tiles bracketed per term and summed in term order, owner the
    lowest term, on hypothesis-drawn blocks: shared docs (hot), NaN and
    -0.0 weights, tiles narrower than the rows (several chunks a tile)
    and wider (empty tiles), deletes, a tree over the bits and orbits."""
    rng = np.random.default_rng(seed)
    widths = tuple(int(x) for x in rng.integers(1, wmax + 1, T))
    nd = 1000
    ids, w = merge_world(seed, B, widths, nd, hot=hot, nan_p=nan_p,
                         neg0_p=neg0_p, empty=(1,) if B > 1 else ())
    bits = torch.from_numpy(
        (1 << rng.integers(0, 3, (B, T))).astype(np.int32))
    deleted = torch.from_numpy(rng.random(nd + 1) < 0.1) if deletes \
        else None
    prog = kernels.tree_program(("AND", ("G", 0), ("OR", ("G", 1),
                                                   ("G", 2)))) \
        if tree else None
    check_merge(ids, w, widths, bits, deleted, prog, True, nd + 1, tile,
                32, rpt)


@pytest.mark.parametrize("case", ["T1", "T128", "all_sentinel",
                                  "tile_edges", "n_docs_too_small",
                                  "nan_owner_row", "one_tile"])
def test_merge_docs_traps(case):
    """The traps by name: T = 1; geo's T = 128 with widths in the
    hundreds; every query all SENTINEL; docids at the tiles' first and last
    slots; n_docs below the real docids (the last tile's probes) and a
    negative-free first tile; a NaN on the owner row of a shared doc; a
    single tile."""
    nd, tile = 1000, 64
    if case == "T1":
        ids, w = merge_world(1, 3, (300,), nd, fill=0.9)
        check_merge(ids, w, (300,), n_docs=nd + 1, tile=tile)
    elif case == "T128":
        widths = (16,) * 128
        ids, w = merge_world(2, 2, widths, nd, fill=1.0, hot=40)
        check_merge(ids, w, widths, n_docs=nd + 1, tile=tile, rpt=4)
    elif case == "all_sentinel":
        ids, w = merge_world(3, 3, (8, 16), nd, empty=(0, 1, 2))
        got = check_merge(ids, w, (8, 16), n_docs=nd + 1, tile=tile)
        assert int(got[2].sum()) == 0
    elif case == "tile_edges":
        widths = (8, 8, 8)
        ids = torch.full((1, 24), SENTINEL, dtype=torch.int32)
        edge = [0, 63, 64, 127, 128, 999]
        for t in range(3):
            ids[0, 8 * t:8 * t + 6] = torch.tensor(edge, dtype=torch.int32)
        w = (torch.arange(24, dtype=torch.float32) / 7)[None, :]
        check_merge(ids, w, widths, n_docs=nd + 1, tile=tile)
    elif case == "n_docs_too_small":
        ids, w = merge_world(4, 2, (64, 32, 128), nd, fill=0.9)
        check_merge(ids, w, (64, 32, 128), n_docs=100, tile=tile)
    elif case == "nan_owner_row":
        ids = torch.tensor([[5, 9, SENTINEL, 5, 9, 11]], dtype=torch.int32)
        w = torch.tensor([[float("nan"), -0.0, 0.0, 1.0, -0.0, 2.0]])
        got = check_merge(ids, w, (3, 3), n_docs=nd + 1, tile=tile)
        assert got[0][0, 0].isnan() and got[0][0, 3].isnan()
        # -0.0 + -0.0 from +0.0 is +0.0, as the plain version sums it
        assert got[0][0, 1].item() == 0.0 and \
            not torch.signbit(got[0][0, 1])
    else:
        ids, w = merge_world(5, 2, (50, 70), 40, fill=0.5)
        check_merge(ids, w, (50, 70), n_docs=41, tile=tile)


# --------------------------------------------------------------------------
# merge_plan: the tiles or the probes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("widths,n_docs,tiles", [
    # relevance exact B256 R896 and B128 R2688, its exact re-run B64
    # R148608: a few hundred to 150k rows over a million docs - the probes
    ((256, 256, 256, 128), 1_000_001, False),
    ((1024, 1024, 512, 128), 1_000_001, False),
    ((131072, 16384, 1024, 128), 1_000_001, False),
    # K21 chunked: 7040 rows a chunk; faceted B (T = 2), the faceted
    # AND_NOT family at R98432 and R393344; positional (100k docs); the
    # REST mesh's shards (~3,200 docs: one tile a query)
    ((4096, 2048, 896), 1_000_001, False),
    ((32768, 32768), 1_000_001, False),
    ((65536, 65536), 1_000_001, False),
    ((32768, 32768, 32768, 128), 1_000_001, False),
    ((131072, 131072, 131072, 128), 1_000_001, False),
    ((32768, 32768), 100_001, False),
    ((4096, 4096, 4096, 128), 3_201, False),
    # geo P (T = 128, ~1.4k rows a term) and its aggregation run (~200)
    ((1441,) * 128, 1_000_001, True),
    ((201,) * 128, 1_000_001, True),
    # faceted A and D, browse B16, browse C, the mesh (a shard's docs)
    ((262144, 1048576), 1_000_001, True),
    ((524288, 1048576, 262144, 128), 1_000_001, True),
    ((1048576,) * 4, 1_000_001, True),
    ((1048576, 1048576, 8192, 128), 1_000_001, True),
    ((1048576, 1048576, 1048576, 524288), 1_250_005, True),
])
def test_merge_plan_at_the_paths_shapes(widths, n_docs, tiles):
    n = kernels.merge_plan(widths, n_docs)
    assert (n > 0) == tiles
    if tiles:
        assert n == -(-n_docs // kernels.MERGE_TILE)
    # a segment of fewer tiles than fill the card: the probes
    small = kernels.MERGE_TILE * (kernels.MERGE_MIN_TILES - 1)
    assert kernels.merge_plan(widths, small) == 0


@settings(max_examples=200, deadline=None)
@given(T=st.integers(1, 200), w=st.integers(1, 2**20),
       n_docs=st.integers(1, 2**24))
def test_merge_plan_invariants(T, w, n_docs):
    """The tiles' shared memory fits and they are enough to fill the
    card; more rows never turn tiles into probes."""
    n = kernels.merge_plan((w,) * T, n_docs)
    if n:
        assert 16 * T + 10 * kernels.MERGE_TILE <= 200 * 1024
        assert n >= kernels.MERGE_MIN_TILES
        assert kernels.merge_plan((2 * w,) * T, n_docs) == n


# --------------------------------------------------------------------------
# through JAX: both emulations on a small segment's launch groups
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "prefix"])
def test_emulations_on_jax_rows(mode):
    """The executor tests' zipf corpus (4,000 docs): every launch group's
    rows through the row-tile emulation equal the plain version's (held
    against JAX's slices by tests/test_torch_executor.py), and through the
    doc-tile emulation (tiles of 256 docids) give JAX's docid sort and
    _merge_runs: the counts, each doc's owner, its sum (rtol 1e-5: JAX
    sums in docid-sort order)."""
    from test_torch_executor import RTOL, Case, _jax_merge

    case = Case("zipf", mode)
    n_docs = case.seg.doc_count + 1
    for cfg, _fn, _batch, pb, _chunk in case.groups():
        post, args, widths, prefix, ids, w, tail = case.slices(cfg, pb)
        imp = tuple(case.pseg[k] for k in ("imp.docids", "imp.wdf",
                                           "imp.doclen")) \
            if any(prefix) else None
        got = emulate_score_slices(post, imp, *args, widths,
                                   tuple(map(bool, prefix)), case.params,
                                   threads=64, rpt=2)
        for g, x in zip(got[:3], (ids, w, tail)):
            assert same_bits(g, x)
        sums, owner, count, _o = check_merge(ids, w, widths, n_docs=n_docs,
                                             tile=256, threads=64, rpt=2)
        d, jsums, first, jcount = (np.asarray(x) for x in
                                   _jax_merge(ids, w, cfg.T))
        np.testing.assert_array_equal(count.numpy(), jcount)
        for b in range(ids.shape[0]):
            o = owner[b].numpy()
            mine = dict(zip(ids[b].numpy()[o].tolist(),
                            sums[b].numpy()[o].tolist()))
            theirs = dict(zip(d[b][first[b]].tolist(),
                              jsums[b][first[b]].tolist()))
            assert sorted(mine) == sorted(theirs)
            np.testing.assert_allclose([mine[x] for x in sorted(mine)],
                                       [theirs[x] for x in sorted(mine)],
                                       rtol=RTOL)
