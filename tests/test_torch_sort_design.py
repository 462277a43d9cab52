"""The decomposition the tiled kernel of sort_topk (K8) relies on, held on
the CPU against its plain version.

  tiling       csrc/sort_topk.cu cuts each query's rows into tiles
               (kernels.sort_plan, the kernel's sk_plan), keeps each tile's
               k best keys and selects the k best of their union. Each tile
               through the plain version, then the tiles' rows through it
               again, gives the plain version's answer over the whole rows
               bit for bit, emitted key words included, for every key kind
               of SORT_TEST_SPECS and key lengths of 3 to 8 words, on
               hypothesis-drawn shapes at the kernel's tile size and at
               small ones (the tile borders inside short rows, row bases
               not 4-aligned).
  the kernel   an emulation of both stages as the kernel runs them: rounds
               of 4 rows a thread, an ineligible row's key made of constant
               words and its row index, an eligible row's key compared with
               the threshold word by word (a tie goes on to the next word),
               at most k ineligible rows a warp a round, the flushes that
               keep k and set the threshold, the tiles' lists merged rank
               by rank with the early stop. Its answer is the plain
               version's.
  the traps    each by name: an eligible row whose float key is NaN sorts
               after every ineligible row (so ineligible rows are never
               skipped); fewer than k eligible rows (the rest ineligible
               rows in row order, their masked words emitted) and C < k
               (all ones past C); the tile borders inside short rows; first
               words that tie the threshold (a strict first-word compare
               gives another answer); a strmetric key with the mesh's code
               remap.
  sort_plan    its invariants and the main paths' shapes.
  semijoin     csrc/semijoin_rows.cu (K21c, the second kernel of this
               slice) searches a block of drive rows' docids only inside
               the bracket [L0, L1] of the block's least and greatest
               docid, staged when it is short; an emulation of that gives
               JAX's rounds' hits and postings (executor.py:1216-1226)
               wherever the kernel takes it (a block of ascending postings
               inside the array, searched long enough), and JAX's rounds
               themselves elsewhere: a length past the class, an empty
               block, a block past the array, a clamped drive window whose
               docids are not ascending.

No JAX here: the plain version is the reference, held against JAX by the
modules' own tests (tests/test_torch_predicate.py, the mesh tests).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_torch_topk_design import _tile_rows
from xapiand_tpu_torch.ops import kernels
from xapiand_tpu_torch.utils import synth_faceted as sf

SENTINEL = kernels.SENTINEL
SLOT, PRICE = sf.SORT_TEST_SLOT, sf.PRICE_SLOT
# SORT_TEST_SPECS (3 to 5 key words) and keys of 6, 7 and 8 words
SPECS = sf.SORT_TEST_SPECS + (
    (("value", SLOT, True), ("value", PRICE, False)),
    (("value", SLOT, False), ("score", None, True), ("value", PRICE, True)),
    (("value", SLOT, False), ("score", None, True), ("value", PRICE, True),
     ("dist", SLOT, False)),
    (("score", None, False),),
)
CASES = ("uniform", "nan", "few", "ties", "ineligible", "sorted", "reversed")


def n_words(specs) -> int:
    return sum(2 if s[0] == "value" else 1 for s in specs) + 2


def sort_world(specs, B: int, C: int, seed: int, case: str,
               remap: bool = False):
    """The inputs of one sort_topk call, made with numpy from the seed:
    (ids, sums, eligible, values, targets, strtabs, remaps). case: uniform;
    nan (a quarter of the scores NaN, some -0.0, half the rows eligible);
    few (fewer eligible rows than most k); ties (every column of a few
    values: first words tie); ineligible (no row eligible); sorted / reversed
    (docids ascending / descending along the rows: the docid key's best
    rows first, or every row better than the last)."""
    g = np.random.Generator(np.random.PCG64(seed))
    nd = 2 * C + 7
    ids = np.stack([g.permutation(nd)[:C] for _ in range(B)])
    if case == "sorted":
        ids = np.sort(ids, 1)
    elif case == "reversed":
        ids = -np.sort(-ids, 1)
    elig = g.random((B, C)) < 0.6
    sums = (g.random((B, C)) * 10).astype(np.float32)
    col, _tg, tab = sf.sort_test_inputs(nd, B, seed)
    price = sf.sort_test_inputs(nd, B, seed + 1)[0]
    if case == "nan":
        sums[g.random((B, C)) < 0.25] = np.nan
        sums[g.random((B, C)) < 0.1] = -0.0
        sums[g.random((B, C)) < 0.1] = 0.0
        elig = g.random((B, C)) < 0.5
    elif case == "few":
        elig = g.random((B, C)) < 3.0 / max(C, 1)
    elif case == "ties":
        for c in (col, price):
            c["hi"] = g.integers(0, 2, nd + 1).astype(np.int32)
            c["lo"] = g.integers(-1, 2, nd + 1).astype(np.int32)
            c["fval"] = g.integers(0, 3, nd + 1).astype(np.float32)
            c["fval2"] = np.zeros(nd + 1, np.float32)
            c["cats"] = g.integers(-1, 3, nd + 1).astype(np.int32)
        sums = (g.integers(0, 3, (B, C)) / 2).astype(np.float32)
        tab = np.round(tab * 2) / 2
    elif case == "ineligible":
        elig = np.zeros((B, C), bool)
    S = len(specs)
    targets = np.stack([g.random((B, S)) * 180 - 90,
                        g.random((B, S)) * 360 - 180], 2).astype(np.float32)
    if case == "ties":
        targets[..., 0] = 1.0
        targets[..., 1] = 0.0
    values = {SLOT: {c: torch.from_numpy(v) for c, v in col.items()},
              PRICE: {c: torch.from_numpy(v) for c, v in price.items()}}
    strtabs = {i: torch.from_numpy(tab.astype(np.float32))
               for i, s in enumerate(specs) if s[0] == "strmetric"}
    remaps = {}
    if remap:   # the mesh's local codes -> the global table, some unknown
        rm = g.integers(-1, 64, 41).astype(np.int32)
        remaps = {i: torch.from_numpy(rm) for i in strtabs}
    return (torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(sums),
            torch.from_numpy(elig), values, torch.from_numpy(targets),
            strtabs, remaps)


def _cols(specs, values):
    return [values.get(s[1]) if s[0] not in ("score", "docid") else None
            for s in specs]


def _query(world, b, idx=None):
    """Query b of a world (its rows idx), as a batch of one."""
    ids, sums, elig, values, targets, strtabs, remaps = world
    sel = (slice(b, b + 1), idx if idx is not None else slice(None))
    return (ids[sel], sums[sel], elig[sel], values, targets[b:b + 1],
            {i: t[b:b + 1] for i, t in strtabs.items()}, remaps)


def plain(specs, world, k):
    ids, sums, elig, values, targets, strtabs, remaps = world
    return kernels._sort_topk_plain(specs, _cols(specs, values), ids, sums,
                                    elig, k, targets, strtabs, remaps,
                                    emit=True)


def _same(got, want, what=None):
    assert torch.equal(got[0], want[0]), what
    assert got[1].numpy().tobytes() == want[1].numpy().tobytes(), what
    assert torch.equal(got[2], want[2]), what


def _concat(parts):
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def tiled_sort(specs, world, k):
    """sort_topk as the kernel decomposes it, over the plain version: each
    tile's k best rows (the plain version's order of the tile's rows), then
    the plain version over the union of those rows, in row order (the row
    index is the kernel's last key word)."""
    ids = world[0]
    B, C = ids.shape
    tiles, gper = kernels.sort_plan(B, C)
    parts = []
    for b in range(B):
        kept = []
        for rows in _tile_rows(b, C, tiles, gper):
            idx = torch.tensor(sorted(rows), dtype=torch.long)
            q = _query(world, b, idx)
            words = kernels.sort_words(specs, _cols(specs, q[3]), q[0], q[1],
                                       q[2], q[4], q[5], q[6])
            kept += idx[kernels._lex_order(words)[0, :k]].tolist()
        parts.append(plain(specs, _query(world, b, torch.tensor(
            sorted(kept), dtype=torch.long)), k))
    return _concat(parts)


# -- an emulation of the kernel's two stages ---------------------------------

def _const_words(specs):
    """An ineligible row's words but its row index (spec_const)."""
    out = []
    for s in specs:
        out += [0xFFFFFFFF] * 2 if s[0] == "value" else \
            [0xFFFFFFFF if s[0] == "docid" else 0xFF800000]
    return tuple(out) + (0xFFFFFFFF,)


def _flush(buf, k):
    buf.sort()
    del buf[k:]
    return buf[k - 1] if len(buf) >= k else None


def _round_end(buf, k, thr, cap, nxt, flush_min):
    n = len(buf)
    if n > cap - nxt or (n >= flush_min and n >= 2 * k):
        return _flush(buf, k) or thr
    return thr


def kernel_sort(specs, world, k, threads=256, flush_min=128,
                strict_first=False, skip_ineligible=False):
    """Both stages of csrc/sort_topk.cu on the host, row by row in the
    kernel's order. strict_first / skip_ineligible: two wrong designs (a
    first word that ties the threshold rejected; ineligible rows never
    candidates), which the trap tests show to give other answers."""
    ids, sums, elig, values, targets, strtabs, remaps = world
    B, C = ids.shape
    words = kernels.sort_words(specs, _cols(specs, values), ids, sums, elig,
                               targets, strtabs, remaps)
    W = torch.stack(words, 2).numpy()
    ids, sums, elig = ids.numpy(), sums.numpy(), elig.numpy()
    const = _const_words(specs)
    rnd, cap = 4 * threads, 8 * threads
    tiles, gper = kernels.sort_plan(B, C)
    nk = len(const) + 1

    def below(key, thr):
        if thr is None:
            return True
        if strict_first and key[0] == thr[0]:
            return False
        return key < thr

    def warp(rows, buf, thr):
        """One warp's rows, in row order (None: a lane without a row)."""
        n_in = 0
        for r in rows:
            if r is None:
                continue
            if elig[b, r]:
                key = tuple(W[b, r].tolist()) + (r,)
                if below(key, thr):
                    buf.append(key)
            elif not skip_ineligible:
                assert tuple(W[b, r].tolist()) == const
                key = const + (r,)
                if below(key, thr):
                    n_in += 1
                    if n_in <= k:   # the warp's first k ineligible rows
                        buf.append(key)

    parts = []
    for b in range(B):
        first, last = b * C, b * C + C
        a0 = min((first + 3) & ~3, last)
        a1 = max(last & ~3, a0)
        ng = (a1 - a0) // 4
        lists = []
        for t in range(tiles):
            buf, thr = [], None
            if t == 0:   # warp 0's lanes: the rows before a0, after a1
                lanes = [first + i if i < a0 - first else None
                         for i in range(4)]
                lanes += [a1 + i if i < last - a1 else None
                          for i in range(28)]
                warp([None if x is None else x - first for x in lanes], buf,
                     thr)
            g0, g1 = t * gper, min(t * gper + gper, ng)
            for gb in range(g0, g1, threads):
                thr_r = thr
                for w0 in range(gb, gb + threads, 32):
                    rows = [a0 + 4 * g + i - first if g < g1 else None
                            for g in range(w0, w0 + 32) for i in range(4)]
                    warp(rows, buf, thr_r)
                thr = _round_end(buf, k, thr, cap, rnd, flush_min)
            _flush(buf, k)
            lists.append(buf + [None] * (k - len(buf)))
        if tiles == 1:
            keys = lists[0]
        else:   # stage 2: rank by rank, the early stop
            buf, thr, win, n = [], None, 0, tiles * k
            for base in range(0, n, threads):
                passed = False
                for f in range(base, min(base + threads, n)):
                    rank, lst = divmod(f, tiles)
                    key = lists[lst][rank]
                    if key is not None and (thr is None or key < thr):
                        buf.append(key)
                        passed = True
                if passed:
                    win = base + threads
                elif (-(-win // tiles) + 1) * tiles <= base + threads:
                    break
                thr = _round_end(buf, k, thr, cap, threads, flush_min)
            _flush(buf, k)
            keys = buf + [None] * (k - len(buf))
        d, s, e = [], [], []
        for key in keys:
            if key is None:
                d.append(SENTINEL)
                s.append(float("-inf"))
                e.append([0xFFFFFFFF] * (nk - 2))
                continue
            r = key[-1]
            el = bool(elig[b, r])
            d.append(int(ids[b, r]) if el else SENTINEL)
            s.append(float(sums[b, r]) if el else float("-inf"))
            e.append(list(key[:nk - 2]))
        ee = np.array(e, dtype=np.uint32).reshape(1, k, nk - 2)
        parts.append((torch.tensor([d], dtype=torch.int32),
                      torch.tensor([s], dtype=torch.float32),
                      torch.from_numpy(ee.view(np.int32).copy())))
    return _concat(parts)


# -- the tiling and the kernel's stages against the plain version ------------

@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(spec_i=st.integers(0, len(SPECS) - 1), B=st.integers(1, 3),
       C=st.integers(1, 3000), k=st.sampled_from([1, 2, 10, 33, 64]),
       case=st.sampled_from(CASES), tile_min=st.sampled_from([8, 100, 1000]),
       remap=st.booleans(), seed=st.integers(0, 99))
def test_sort_union_of_tiles_equals_plain(spec_i, B, C, k, case, tile_min,
                                          remap, seed):
    """Small tiles: many a query, their borders anywhere in the rows; every
    key kind, 3 to 8 key words, every case."""
    specs = SPECS[spec_i]
    world = sort_world(specs, B, C, seed, case, remap)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "SORT_TILE_MIN", tile_min)
        got = tiled_sort(specs, world, k)
    _same(got, plain(specs, world, k), (specs, case))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(spec_i=st.integers(0, len(SPECS) - 1), B=st.integers(1, 3),
       C=st.integers(1, 1500), k=st.sampled_from([1, 2, 10, 33, 64]),
       case=st.sampled_from(CASES), tile_min=st.sampled_from([8, 300]),
       threads=st.sampled_from([32, 64]), remap=st.booleans(),
       seed=st.integers(0, 99))
def test_sort_kernel_stages_equal_plain(spec_i, B, C, k, case, tile_min,
                                        threads, remap, seed):
    """The kernel's stages emulated with blocks of 32 or 64 threads (many
    rounds and flushes a tile) and small tiles (many lists to merge)."""
    specs = SPECS[spec_i]
    world = sort_world(specs, B, C, seed, case, remap)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "SORT_TILE_MIN", tile_min)
        got = kernel_sort(specs, world, k, threads=threads)
    _same(got, plain(specs, world, k), (specs, case))


@pytest.mark.parametrize("C", [kernels.SORT_TILE_MIN - 1,
                               kernels.SORT_TILE_MIN,
                               kernels.SORT_TILE_MIN + 1, 40001])
def test_sort_kernel_tiles_equal_plain(C):
    """The kernel's own tile size and block: one tile up to SORT_TILE_MIN
    rows, two past it, several at C 40001 (odd: the row bases of query 1
    not 4-aligned); k 10 and 64; a value key and the docid key."""
    for i, (specs, case) in enumerate(((SPECS[1], "uniform"),
                                       (SPECS[9], "sorted"),
                                       (SPECS[0], "ties"))):
        world = sort_world(specs, 2, C, 31 + i, case)
        for k in (10, 64):
            want = plain(specs, world, k)
            _same(tiled_sort(specs, world, k), want, (C, specs, k))
        _same(kernel_sort(specs, world, 10), plain(specs, world, 10),
              (C, specs))


# -- the traps, by name --------------------------------------------------------

def test_nan_float_key_sorts_after_ineligible_rows():
    """A score key ascending with every eligible score NaN: fkey(NaN)
    0xffc00000 is above an ineligible row's fkey(+inf) 0xff800000, so the
    ineligible rows (SENTINEL, -inf) come first. A design that skipped
    ineligible rows would answer with the NaN-scored docs."""
    specs = (("score", None, False),)
    world = list(sort_world(specs, 2, 700, 3, "uniform"))
    world[1] = torch.full_like(world[1], float("nan"))
    world[2] = torch.rand(world[2].shape,
                          generator=torch.Generator().manual_seed(1)) < 0.97
    want = plain(specs, world, 10)
    assert int((want[0] == SENTINEL).sum()) > 0
    assert torch.equal(want[0][:, 0], torch.full((2,), SENTINEL,
                                                 dtype=torch.int32))
    _same(kernel_sort(specs, world, 10), want)
    _same(tiled_sort(specs, world, 10), want)
    wrong = kernel_sort(specs, world, 10, skip_ineligible=True)
    assert not torch.equal(wrong[0], want[0])


@pytest.mark.parametrize("specs", [SPECS[1], SPECS[3], SPECS[9]])
def test_fewer_than_k_eligible_pads_with_ineligible_rows(specs):
    """Three eligible rows of 50 at k 10: the three first, then ineligible
    rows in row order (SENTINEL, -inf), their emitted words the masked
    constants (0xff800000 for a float word), not all ones."""
    world = list(sort_world(specs, 1, 50, 5, "uniform"))
    el = torch.zeros(1, 50, dtype=torch.bool)
    el[0, [7, 21, 40]] = True
    world[2] = el
    want = plain(specs, world, 10)
    assert int((want[0] != SENTINEL).sum()) == 3
    assert torch.equal(want[0][0, 3:], torch.full((7,), SENTINEL,
                                                  dtype=torch.int32))
    const = np.array(_const_words(specs)[:-1], dtype=np.uint32).view(np.int32)
    assert torch.equal(want[2][0, 3:], torch.from_numpy(const).expand(7, -1))
    _same(kernel_sort(specs, world, 10), want)
    _same(tiled_sort(specs, world, 10), want)


@pytest.mark.parametrize("C", [1, 3, 9])
def test_rows_fewer_than_k_pad_with_all_ones(C):
    """C < k: SENTINEL, -inf and emitted words of all ones past C."""
    specs = SPECS[4]
    world = sort_world(specs, 3, C, 8, "uniform")
    want = plain(specs, world, 10)
    assert bool((want[2][:, C:] == -1).all())
    assert bool((want[0][:, C:] == SENTINEL).all())
    _same(kernel_sort(specs, world, 10), want)
    _same(tiled_sort(specs, world, 10), want)


@pytest.mark.parametrize("C", [5, 13, 37, 63])
def test_tile_borders_inside_short_rows(C):
    """Tiles of 8 rows over odd C at B 3: the row bases of queries 1 and 2
    are not 4-aligned, so tile 0 also takes the rows before the first
    aligned one and after the last; every case, k 1 and 10."""
    for i, case in enumerate(CASES):
        specs = SPECS[i % len(SPECS)]
        world = sort_world(specs, 3, C, 40 + i, case)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "SORT_TILE_MIN", 8)
            assert kernels.sort_plan(3, C)[0] >= (2 if C > 8 else 1)
            for k in (1, 10):
                want = plain(specs, world, k)
                _same(tiled_sort(specs, world, k), want, (C, case, k))
                _same(kernel_sort(specs, world, k, threads=32), want,
                      (C, case, k))


def test_first_word_tie_goes_on_to_the_next_word():
    """A value key ascending whose hi word is 0 on every row and whose lo
    word falls along the rows: once the threshold is set, every later row
    ties it on the first word and is below it on the second. The kernel's
    compare goes on to the next word on a tie; one that rejected a tied
    first word (a strict first-word compare) would keep the first round's
    rows."""
    specs = (("value", SLOT, False),)
    C = 3000
    world = list(sort_world(specs, 1, C, 2, "uniform"))
    ids = torch.arange(C, dtype=torch.int32)[None]
    col = dict(world[3][SLOT])
    col["hi"] = torch.zeros(C + 8, dtype=torch.int32)
    col["lo"] = torch.arange(C + 8, 0, -1, dtype=torch.int32)
    col["present"] = torch.ones(C + 8, dtype=torch.bool)
    world[0], world[2] = ids, torch.ones(1, C, dtype=torch.bool)
    world[3] = {SLOT: col, PRICE: world[3][PRICE]}
    want = plain(specs, world, 10)
    assert torch.equal(want[0][0], torch.arange(C - 1, C - 11, -1,
                                                dtype=torch.int32))
    _same(kernel_sort(specs, world, 10), want)
    wrong = kernel_sort(specs, world, 10, strict_first=True)
    assert not torch.equal(wrong[0], want[0])


@pytest.mark.parametrize("desc", [False, True])
def test_strmetric_with_a_remap(desc):
    """The mesh's strmetric key: each doc's code mapped through the shard's
    remap row before the table (codes past the remap clamp, -1 stays
    unknown, +inf), ascending and descending, ties in the table."""
    specs = (("strmetric", SLOT, desc, 64), ("score", None, True))
    for case in ("uniform", "ties"):
        world = sort_world(specs, 2, 2500, 11, case, remap=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "SORT_TILE_MIN", 300)
            for k in (10, 64):
                want = plain(specs, world, k)
                _same(tiled_sort(specs, world, k), want, (case, k))
                _same(kernel_sort(specs, world, k, threads=64), want,
                      (case, k))
        if case == "uniform":   # the remap changes the answer
            no_remap = plain(specs, world[:6] + ({},), 10)
            assert not torch.equal(no_remap[2], plain(specs, world, 10)[2])


def test_ineligible_words_are_the_constants():
    """sort_words of an ineligible row are spec_const's words and the
    masked docid INT32_MAX, for every key kind: the kernel never reads an
    ineligible row's docid or columns."""
    for specs in SPECS:
        world = sort_world(specs, 2, 300, 6, "uniform")
        ids, sums, elig, values, targets, strtabs, remaps = world
        words = kernels.sort_words(specs, _cols(specs, values), ids, sums,
                                   elig, targets, strtabs, remaps)
        W = torch.stack(words, 2)[~elig]
        assert torch.equal(W, torch.tensor(_const_words(specs)).expand_as(W))


# -- sort_plan -----------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 4096), C=st.integers(0, 2**26))
def test_sort_plan_invariants(B, C):
    """kernels.sort_plan: every group of 4 rows in a tile, the last tile
    starts inside them, C up to SORT_TILE_MIN one tile, at most
    ceil(C / SORT_TILE_MIN) tiles, B x tiles at most SORT_BLOCKS (or B),
    so the merge's scratch of B x tiles x k keys of 8 words stays under
    1.1 MB at k 64."""
    tiles, gper = kernels.sort_plan(B, C)
    ng = C // 4 + 1
    assert tiles >= 1 and gper >= 1
    assert tiles * gper >= ng
    assert (tiles - 1) * gper < ng
    if C <= kernels.SORT_TILE_MIN:
        assert tiles == 1
    assert tiles <= max(1, -(-C // kernels.SORT_TILE_MIN))
    assert B * tiles <= max(kernels.SORT_BLOCKS, B)
    if tiles > 1:
        assert 4 * gper > kernels.SORT_TILE_MIN // 2 - 4
        assert B * tiles * kernels.MAX_SORT_TOPK * 4 * \
            kernels.MAX_SORT_WORDS <= 1.1e6


def test_sort_plan_at_the_main_paths_shapes():
    """The tiling at the shapes the paths launch (PERF.md section 6): the
    faceted cap B at 131072 and the geo, browse N, browse C and browse M
    launches split; the geo aggregations' B64 R25728 in four tiles a
    query; a browse C query over 1M rows in 123 tiles (near one block an
    SM of the H100's 132); 8192 rows or fewer in one launch."""
    assert kernels.sort_plan(1, 1000001) == (123, 2033)
    assert kernels.sort_plan(64, 25728)[0] == 4
    assert kernels.sort_plan(128, 8192)[0] == 1
    for B, C in ((8, 184448), (8, 312960), (32, 1000001), (64, 1000001),
                 (256, 1000001), (64, 262144), (64, 131072)):
        tiles, _gper = kernels.sort_plan(B, C)
        assert tiles > 1
        assert B * tiles >= 96


# -- semijoin_rows' bracketed search -------------------------------------------

def jax_probe(post, base, n, rounds, d):
    """executor.py:1214-1227 for one drive docid: JAX's rounds, its probes
    clamped into the array as a gather clamps them. -> (hit, the posting
    it lands on)."""
    P = len(post)
    nm1 = max(n - 1, 0)
    lo, hi = 0, n
    for _ in range(rounds):
        mid = (lo + hi) // 2
        right = post[min(max(base + min(mid, nm1), 0), P - 1)] < d
        lo, hi = (mid + 1, hi) if right else (lo, mid)
    p = min(max(base + min(lo, nm1), 0), P - 1)
    return d != SENTINEL and lo < n and post[p] == d, p


def bracket_probe(post, base, n, rounds, ds, stage):
    """csrc/semijoin_rows.cu's search for one block of drive docids ds
    (SENTINEL: not real): the bracket of its real docids' least and
    greatest, staged up to `stage` postings, JAX's rounds where the block
    is not one the bracket serves. -> [(hit, posting)] a row."""
    real = [d != SENTINEL for d in ds]
    exact = n > 0 and base >= 0 and base + n <= len(post) and \
        (rounds >= 31 or n < 2 ** rounds)
    if not exact or not any(real):
        return [jax_probe(post, base, n, rounds, d) if r else (False, None)
                for d, r in zip(ds, real)]
    blk = post[base:base + n]
    lo_d = min(d for d, r in zip(ds, real) if r)
    hi_d = max(d for d, r in zip(ds, real) if r)
    L0 = int(np.searchsorted(blk, lo_d, "left"))
    L1 = min(int(np.searchsorted(blk, hi_d, "left")), n - 1)
    cnt = L1 - L0 + 1
    out = []
    for d, r in zip(ds, real):
        if not r:
            out.append((False, None))
            continue
        if cnt <= stage:
            sub = blk[L0:L0 + max(cnt, 0)]
            y = int(np.searchsorted(sub, d, "left")) if cnt > 0 else 0
            hit, x = y < cnt and sub[y] == d, L0 + y
        else:
            x = L0 + int(np.searchsorted(blk[L0:L1 + 1], d, "left"))
            hit = x < n and blk[x] == d
        out.append((bool(hit), base + x if hit else None))
    return out


@settings(max_examples=300, deadline=None)
@given(seed=st.integers(0, 10**6), n=st.integers(0, 400),
       cls=st.sampled_from([1, 2, 8, 64, 128, 512, 4096]),
       where=st.sampled_from(["inside", "end", "past"]),
       drive=st.sampled_from(["sorted", "clamped", "tail", "none"]),
       stage=st.sampled_from([0, 4, 2048]))
def test_semijoin_bracket_equals_jax_rounds(seed, n, cls, where, drive,
                                            stage):
    """The bracketed search against JAX's rounds over the global postings,
    hit for hit and posting for posting: classes below the length (JAX's
    search stops short: the kernel runs it as it is), blocks at the array's
    end or past it, drive docids ascending, two ascending runs (a clamped
    window), real rows then SENTINEL, none real; brackets staged, searched
    in place, empty. (A term's postings ascend: the bracket's premise.)"""
    g = np.random.Generator(np.random.PCG64(seed))
    pre = np.sort(g.integers(0, 3000, 50))
    blk = np.sort(g.choice(3000, size=n, replace=False)) if n else \
        np.zeros(0, np.int64)
    # the term's block: amid the postings, at their end, or running 10
    # entries past it (its lens past the array: probes clamped)
    post = np.concatenate([pre, blk] + ([] if where != "inside" else
                                        [np.sort(g.integers(0, 3000, 30))]))
    base = len(pre) + (10 if where == "past" else 0)
    m = 64
    if drive == "clamped":
        ds = np.concatenate([np.sort(g.integers(1500, 3000, m // 2)),
                             np.sort(g.integers(0, 3000, m // 2))])
    else:
        ds = np.sort(np.concatenate([g.choice(blk, min(n, m // 2)) if n
                                     else np.zeros(0, np.int64),
                                     g.integers(0, 3000, m)]))[:m]
    if drive == "tail":
        ds[m // 2:] = SENTINEL
    elif drive == "none":
        ds[:] = SENTINEL
    rounds = max(cls.bit_length() - 1, 1) + 1
    got = bracket_probe(post, base, n, rounds, list(ds), stage)
    for d, (hit, p) in zip(ds, got):
        want_hit, want_p = jax_probe(post, base, n, rounds, d)
        assert hit == want_hit, (d, n, cls)
        if hit:
            assert p == want_p
