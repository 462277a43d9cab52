"""The decompositions the tiled kernels of topk_rows (K4) and dense_rows
(K12) rely on, held on the CPU against their plain versions.

  topk_rows    csrc/topk_rows.cu cuts each query's rows into tiles
               (kernels.topk_plan, the kernel's tk_plan), keeps each tile's
               k best keys and selects the k best of their union. An
               emulation of that tiling over _topk_rows_plain - each tile
               through the plain version, then the tiles' lists through it
               again - gives the plain version's answer over the whole
               rows, bit for bit, for both key types, on hypothesis-drawn
               shapes with NaN and infinite scores, ties and short owner
               counts, at the kernel's tile size and at small ones (many
               tiles a query, the tile borders inside short rows).
  stage 2      the tiles' lists read rank by rank stop at the first rank
               row with no key above the threshold: the union's k best.
  topk_plan    its invariants: every row in a tile, no tile past the
               rows, one tile up to TOPK_TILE_MIN rows, B x tiles near
               TOPK_BLOCKS, the scratch's size; the main paths' shapes.
  dense_rows   csrc/dense_rows.cu walks runs of doc tiles, each term's
               cursor found once a run by binary search in the slice
               _execute_dense reads and carried from tile to tile (a
               tile's postings: the 256-wide chunks from the cursor whose
               docids fall in it), adding each term's weights into the
               tile's scores in term order. An emulation of that gives
               _dense_rows_plain's bits under every scheme family, at the
               kernel's tile and run length and at small ones, with docs
               at the tile borders, a term block clamped at the end of the
               postings, lens above the class width and T past the 256
               threads that find the cursors.

The generators (topk_rows_case, dense_world) also feed the kernels' own
tests on the card (tests/test_torch_cuda.py). No JAX here: the plain
versions are the reference, held against JAX by the modules' own tests.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xapiand_tpu_torch.models.weights import CollectionStats
from xapiand_tpu_torch.models.weights import scheme_sumpart
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.utils import synth_schemes as ss

SENTINEL = kernels.SENTINEL
TOPK_CASES = ("uniform", "ascending", "equal", "special", "few")


def topk_rows_case(case: str, B: int, R: int, seed: int, tie: str = "none"):
    """(scores f32[B,R], ids i32[B,R], owner bool[B,R], tie i32[B,R] or
    None): owner docids unique a query. case: uniform scores; ascending
    in row order (every row beats the threshold, the most inserts); all
    equal; NaN, -inf and +inf rows among few distinct scores; few owners
    (fewer than most k). tie: none, small ranks (collapse_rows' ties, many
    equal) or the row index (the join's tie window)."""
    g = np.random.Generator(np.random.PCG64(seed))
    ids = np.stack([g.permutation(2 * R + 7)[:R] for _ in range(B)])
    own = g.random((B, R)) < 0.6
    if case == "uniform":
        s = g.random((B, R))
    elif case == "ascending":
        s = np.tile(np.arange(R, dtype=np.float64), (B, 1)) / max(R, 1)
    elif case == "equal":
        s = np.full((B, R), 1.5)
    elif case == "special":
        s = g.integers(0, 12, (B, R)) / 4
        s[g.random((B, R)) < 0.05] = np.nan
        s[g.random((B, R)) < 0.05] = -np.inf
        s[g.random((B, R)) < 0.02] = np.inf
    else:
        s = g.random((B, R))
        own = g.random((B, R)) < 3.0 / max(R, 1)
    t = None
    if tie == "ranks":
        t = torch.from_numpy(g.integers(0, 4, (B, R)).astype(np.int32))
    elif tie == "row":
        t = torch.arange(R, dtype=torch.int32).expand(B, R).contiguous()
    return (torch.from_numpy(s.astype(np.float32)),
            torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(own), t)


def _tile_rows(b: int, R: int, tiles: int, gper: int):
    """The row ranges (query-relative) of each tile of query b, as
    topk_tiles_kernel reads them: groups of 4 rows from the query's first
    row whose global index b R + r is a multiple of 4; the up to 3 rows
    before it and after the last whole group go to tile 0."""
    first, last = b * R, b * R + R
    a0 = min((first + 3) & ~3, last)
    a1 = max(last & ~3, a0)
    ng = (a1 - a0) // 4
    out = []
    for t in range(tiles):
        g0, g1 = t * gper, min(t * gper + gper, ng)
        rows = list(range(a0 + 4 * g0, a0 + 4 * g1)) if g1 > g0 else []
        if t == 0:
            rows = list(range(first, a0)) + list(range(a1, last)) + rows
        out.append([r - first for r in rows])
    return out


def tiled_topk(scores, ids, owner, k, tie=None):
    """topk_rows as the kernel decomposes it, over _topk_rows_plain: each
    tile's k best, then the k best of their union (stage 2). A tile's
    list carries its keys: the docid, the score and, with a tie, the
    row's tie (found again by the docid, unique among owners); a non-finite
    winner comes back with SENTINEL, which is what the final answer
    reports for it whatever its docid, and -inf is the fill."""
    B, R = scores.shape
    tiles, gper = kernels.topk_plan(B, R)
    out_d, out_s = [], []
    for b in range(B):
        parts = []
        for rows in _tile_rows(b, R, tiles, gper):
            idx = torch.tensor(rows, dtype=torch.long)
            sub = [x[b:b + 1, idx] if x is not None else None
                   for x in (scores, ids, owner, tie)]
            d, s = kernels._topk_rows_plain(*sub[:3], k, sub[3])
            parts.append((d[0], s[0]))
        d2 = torch.cat([p[0] for p in parts])[None]
        s2 = torch.cat([p[1] for p in parts])[None]
        own2 = s2 != float("-inf")
        t2 = None
        if tie is not None:
            by_doc = {int(d): int(t) for d, t, o in
                      zip(ids[b], tie[b], owner[b]) if o}
            t2 = torch.tensor([[by_doc.get(int(d), 0) for d in d2[0]]],
                              dtype=torch.int32)
        d, s = kernels._topk_rows_plain(s2, d2, own2, k, t2)
        out_d.append(d)
        out_s.append(s)
    return torch.cat(out_d), torch.cat(out_s)


def _same(got, want):
    assert torch.equal(got[0], want[0])
    assert got[1].numpy().tobytes() == want[1].numpy().tobytes()


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(B=st.integers(1, 3), R=st.integers(1, 3000),
       k=st.sampled_from([1, 2, 10, 33, 65, 80, 256]),
       case=st.sampled_from(TOPK_CASES),
       tie=st.sampled_from(["none", "ranks", "row"]),
       tile_min=st.sampled_from([8, 100, 1000]), seed=st.integers(0, 99))
def test_topk_union_of_tiles_equals_plain(B, R, k, case, tie, tile_min,
                                          seed):
    """Small tiles: many a query, their borders anywhere in the rows."""
    args = topk_rows_case(case, B, R, seed, tie)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "TOPK_TILE_MIN", tile_min)
        got = tiled_topk(*args[:3], k, args[3])
    _same(got, kernels._topk_rows_plain(*args[:3], k, args[3]))


@pytest.mark.parametrize("tie", ["none", "ranks", "row"])
@pytest.mark.parametrize("R", [kernels.TOPK_TILE_MIN - 1,
                               kernels.TOPK_TILE_MIN,
                               kernels.TOPK_TILE_MIN + 1, 40001])
def test_topk_union_of_kernel_tiles_equals_plain(R, tie):
    """The kernel's own tile size: one tile up to TOPK_TILE_MIN rows, two
    past it, several at R 40001 (odd: the row bases of queries 1 and 2 are
    not 16-byte aligned); k 10 and 80, every case."""
    for i, case in enumerate(TOPK_CASES):
        args = topk_rows_case(case, 2, R, 31 + i, tie)
        for k in (10, 80):
            got = tiled_topk(*args[:3], k, args[3])
            _same(got, kernels._topk_rows_plain(*args[:3], k, args[3]))


def rank_order_merge(lists, k):
    """Stage 2 as topk_merge_kernel reads it: the tiles' lists (each best
    first, keys as (score, -docid) tuples, None its fill) rank by rank,
    a threshold the k-th best key kept so far, and a stop at the first
    whole rank row none of whose keys beats it. -> the k best, and the
    number of rank rows read."""
    kept, rows = [], 0
    for rank in range(k):
        row = [x[rank] for x in lists if x[rank] is not None]
        rows += 1
        thr = sorted(kept, reverse=True)[k - 1] if len(kept) >= k else None
        passed = [key for key in row if thr is None or key > thr]
        if not passed:
            break
        kept += passed
    return sorted(kept, reverse=True)[:k], rows


@settings(max_examples=60, deadline=None)
@given(tiles=st.integers(1, 40), k=st.integers(1, 40),
       fill=st.floats(0.0, 1.0), seed=st.integers(0, 999))
def test_topk_merge_stops_at_a_failed_rank_row(tiles, k, fill, seed):
    """The rank-order merge with its early stop gives the k best of the
    union of the tiles' lists: every key past a rank row that failed is
    below its list's key in that row."""
    g = np.random.Generator(np.random.PCG64(seed))
    docs = g.permutation(tiles * k * 4)
    lists, union, i = [], [], 0
    for _t in range(tiles):
        n = int(g.integers(0, k + 1)) if g.random() < fill else k
        keys = sorted(((float(g.integers(0, 6)), -int(docs[i + j]))
                       for j in range(n)), reverse=True)
        i += n
        union += keys
        lists.append(keys + [None] * (k - n))
    got, rows = rank_order_merge(lists, k)
    assert got == sorted(union, reverse=True)[:k]
    assert rows <= k


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 4096), R=st.integers(0, 2**26))
def test_topk_plan_invariants(B, R):
    """kernels.topk_plan: every group of 4 rows (R // 4 + 1 bounds a
    query's, whatever its alignment) lies in a tile, the last tile starts
    inside them, R up to TOPK_TILE_MIN is one tile (one launch, no merge),
    at most ceil(R / TOPK_TILE_MIN) tiles (each more than half that many
    rows), B x tiles at most TOPK_BLOCKS (or B, one tile a query), so the
    merge's scratch of B x tiles x k keys stays under 4.4 MB at k 256
    (TieKey, 16 bytes)."""
    tiles, gper = kernels.topk_plan(B, R)
    ng = R // 4 + 1
    assert tiles >= 1 and gper >= 1
    assert tiles * gper >= ng
    assert (tiles - 1) * gper < ng
    if R <= kernels.TOPK_TILE_MIN:
        assert tiles == 1
    assert tiles <= max(1, -(-R // kernels.TOPK_TILE_MIN))
    assert B * tiles <= max(kernels.TOPK_BLOCKS, B)
    if tiles > 1:
        assert 4 * gper > kernels.TOPK_TILE_MIN // 2 - 4
        assert B * tiles * kernels.MAX_TOPK * 16 <= 4.4e6


def test_topk_plan_at_the_main_paths_shapes():
    """The tiling at the shapes the paths launch (PERF.md section 6):
    relevance B256 R896 and the chunked B1024 R7040 in one launch; the
    browse, mesh and tie-ranks shapes split, at least 128 blocks (one an
    SM of the H100's 132, near enough)."""
    assert kernels.topk_plan(256, 896)[0] == 1
    assert kernels.topk_plan(1024, 7040)[0] == 1
    for B, R in ((16, 4194304), (32, 2097152), (36, 3670144),
                 (64, 148608), (1, 2101376), (64, 1048576)):
        tiles, _gper = kernels.topk_plan(B, R)
        assert tiles > 1
        assert B * tiles >= 128


# ---------------------------------------------------------------------------
# dense_rows
# ---------------------------------------------------------------------------

DENSE_WIDE_T = 300
DENSE_SCHEMES = ("bm25", "tfidf", "pl2", "dicecoeff", "lm-absolute_discount",
                 "bb2")


def dense_world(variant: str, label: str, seed: int = 3, tile=None):
    """Inputs of dense_rows (CPU tensors) over a synthetic posting array,
    laid out as models/builder.py lays it: each term's docids sorted and
    unique, then a guard of pad docs as long as the widest class:
    (post, offsets, lens, tconst, scoring, bits, classes, deleted, spec,
    uniq). tile (default kernels.DENSE_TILE) puts docs d0 - 1, d0 and d0 +
    tile - 1 of every tile border into term 0, and sizes the longest term
    (tile docs, the one before last). variant: "borders" (3 queries, 5
    terms), "clamp" (the last term, 5 docs, takes a class of twice the
    guard in its slot: its slice starts clamped, tile rows back, inside
    the longest term, whose docids its 5 rows read), "over" (lens above
    the class width in every other slot: the block's first classes[t]
    rows count), "wide" (T = DENSE_WIDE_T slots, past the 256 threads
    that find the cursors)."""
    tile = tile or kernels.DENSE_TILE
    g = np.random.Generator(np.random.PCG64(seed))
    nd1 = 3 * tile + 11
    T = DENSE_WIDE_T if variant == "wide" else 5
    n_terms = T + 1
    borders = [d for t0 in range(tile, nd1 - 1, tile)
               for d in (t0 - 1, t0, t0 + tile - 1) if d < nd1 - 1]
    blocks = []
    for t in range(n_terms):
        n = int(g.integers(1, tile - len(borders) - 2))
        if t == n_terms - 2:
            n = tile
        elif t == n_terms - 1:
            n = 5
        docs = set(g.choice(nd1 - 1, n, replace=False).tolist())
        if t == 0:
            docs |= set(borders) | {0, nd1 - 2}
        blocks.append(np.array(sorted(docs), dtype=np.int32))
    offs = np.cumsum([0] + [len(x) for x in blocks])
    B = 3
    term_of = np.array([[(b + t) % (n_terms - 1) for t in range(T)]
                        for b in range(B)])
    if variant == "clamp":
        term_of[:, T - 1] = n_terms - 1
    lens = np.array([[len(blocks[x]) for x in row] for row in term_of])
    offsets = np.array([[offs[x] for x in row] for row in term_of])
    classes = [1 << int(max(int(lens[:, t].max()), 1) - 1).bit_length()
               for t in range(T)]
    guard = max(classes)
    if variant == "clamp":
        guard = max(classes[:T - 1])
        classes[T - 1] = 2 * guard
    if variant == "over":
        classes = [c // 2 if t % 2 and c > 1 else c
                   for t, c in enumerate(classes)]
    pd = np.concatenate(blocks + [np.full(guard, nd1 - 1, np.int32)])
    P = len(pd)
    if variant == "clamp":
        assert all(offsets[b, T - 1] + classes[T - 1] > P for b in range(B))
    wdf = g.integers(1, 6, P).astype(np.float32)
    dl = g.integers(5, 60, P).astype(np.float32)
    wdf[P - guard:] = 0.0
    st_ = CollectionStats(doc_count=nd1 - 1, avg_doclen=30.0,
                          doclen_lower=5.0, doclen_upper=59.0,
                          total_len=float(30 * (nd1 - 1)))
    scheme = ss.make(dict((c[0], c) for c in ss.SCHEME_CONFIGS)[label])
    spec = scheme.kernel_spec(st_)
    C = scheme.n_constants
    tc = g.random((B, T, C)).astype(np.float32) * 3 + 0.5
    if C == 2:
        tc[..., 1] = g.integers(50, 5000, (B, T))
    tconst = torch.from_numpy(tc[..., 0].copy() if C == 1 else tc)
    scoring = torch.from_numpy((g.random((B, T)) < 0.85).astype(np.float32))
    bits = torch.from_numpy(
        (1 << (np.arange(T) % 3))[None, :].repeat(B, 0).astype(np.int32))
    deleted = torch.from_numpy(g.random(nd1) < 0.05)
    deleted[nd1 - 1] = False
    uniq = torch.from_numpy(g.integers(1, 40, nd1).astype(np.float32)) \
        if spec.needs_uniq else None
    post = (torch.from_numpy(pd), torch.from_numpy(wdf), torch.from_numpy(dl))
    return (post, torch.from_numpy(offsets.astype(np.int32)),
            torch.from_numpy(lens.astype(np.int32)), tconst, scoring, bits,
            tuple(classes), deleted, spec, uniq)


def tiled_dense(post, offsets, lens, tconst, scoring, bits, classes, deleted,
                spec, uniq=None, tile=None, per=None):
    """dense_rows as the kernel computes it: per query, runs of `per` doc
    tiles (kernels.dense_per by default); a run finds each term's cursor
    by binary search (its first posting at or past the run's first doc)
    in the term's slice (classes[t] rows from the clamped start, the first
    min(lens, classes[t]) counting); per tile, each term's postings from
    the cursor 256 at a time while the whole chunk falls in the tile, their
    weights added into the tile's scores as s = s + w and the term's bit
    ORed into its orbits, term by term."""
    tile = tile or kernels.DENSE_TILE
    B, T = offsets.shape
    nd1 = deleted.shape[0]
    n = post[0].shape[0]
    n_tiles = -(-nd1 // tile)
    per = per or kernels.dense_per(B, nd1, classes)
    scores = torch.zeros((B, nd1), dtype=torch.float32)
    orbits = torch.zeros((B, nd1), dtype=torch.int32)
    for b in range(B):
        slices = []
        for t in range(T):
            W = classes[t]
            ln = max(min(int(lens[b, t]), W), 0)
            start = max(min(int(offsets[b, t]), n - W), 0)
            slices.append((start, post[0][start:start + ln]))
        for j0 in range(0, n_tiles, per):
            first = j0 * tile
            cur = [int(torch.searchsorted(blk, torch.tensor(
                first, dtype=torch.int32))) for _s, blk in slices]
            for d0 in range(first, min(first + per * tile, nd1), tile):
                d1 = min(d0 + tile, nd1)
                s_t = torch.zeros(tile, dtype=torch.float32)
                o_t = torch.zeros(tile, dtype=torch.int32)
                for t, (start, blk) in enumerate(slices):
                    c = cur[t]
                    while c < len(blk):
                        chunk = blk[c:c + 256]
                        n_in = int((chunk < d1).sum())
                        q = torch.arange(start + c, start + c + n_in)
                        d = post[0][q].long()
                        tc = tuple(x[b:b + 1, 0]
                                   for x in kernels._tc(tconst, t))
                        w = kernels._scored(scheme_sumpart(
                            spec, post[1][q], post[2][q], tc,
                            uniq[d] if uniq is not None else None),
                            scoring[b, t:t + 1])
                        s_t[d - d0] = s_t[d - d0] + w
                        o_t[d - d0] |= int(bits[b, t])
                        c += n_in
                        if n_in < 256:
                            break
                    cur[t] = c
                scores[b, d0:d1] = s_t[:d1 - d0]
                orbits[b, d0:d1] = o_t[:d1 - d0]
    scores[:, nd1 - 1] = 0.0
    orbits[:, nd1 - 1] = 0
    live = ~deleted
    live[nd1 - 1] = False
    ids = torch.arange(nd1, dtype=torch.int32)
    return (ids.expand(B, nd1).contiguous(), scores, orbits,
            live.expand(B, nd1).contiguous())


@pytest.mark.parametrize("tile,per", [(64, 1), (64, 3), (None, None)])
@pytest.mark.parametrize("label", DENSE_SCHEMES)
def test_dense_tiles_accumulate_to_plain_bits(label, tile, per):
    """Every variant of dense_world, the emulated runs of tiles against
    _dense_rows_plain: ids, orbits and live equal, scores bit for bit;
    small tiles one and three a run, and the kernel's tile and run."""
    for variant in ("borders", "clamp", "over", "wide"):
        args = dense_world(variant, label, tile=tile)
        got = tiled_dense(*args, tile=tile, per=per)
        want = kernels._dense_rows_plain(*args)
        for name, g_, w in zip(("ids", "scores", "orbits", "live"), got,
                               want):
            assert g_.numpy().tobytes() == w.numpy().tobytes(), \
                (variant, name)
        assert bool((got[2] != 0).any())


@pytest.mark.parametrize("classes", [(), (128,), (kernels.DENSE_SHORT,),
                                     (128, kernels.DENSE_SHORT * 2),
                                     (131072, 131072)])
def test_dense_per_invariants(classes):
    """kernels.dense_per, the run length the wrapper passes the kernel: at
    least one tile a run, every tile in a run; one tile a block where
    every slice is short (browse M's 128 rows); else B x runs within
    DENSE_BLOCKS whenever B is."""
    short = max(classes, default=0) <= kernels.DENSE_SHORT
    for B in (1, 3, 16, 32, 64, 256, 791, 792, 4096):
        for nd1 in (1, 4096, 4097, 100_001, 1_000_001):
            per = kernels.dense_per(B, nd1, classes)
            tiles = -(-nd1 // kernels.DENSE_TILE)
            runs = -(-tiles // per)
            assert per >= 1 and runs * per >= tiles
            if short:
                assert per == 1
            else:
                assert B * runs <= max(kernels.DENSE_BLOCKS, B)
