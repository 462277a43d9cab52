"""The decompositions the redesigned merge_special (K13) and kmeans (K20)
kernels rely on, held on the CPU against their plain versions and JAX.
JAX is imported inside the tests that run it: tests/test_torch_cuda.py
takes its worlds (special_world) from here on a machine without JAX.

  merge_special  csrc/merge_special.cu's doc tiles: a block a (query,
                 docid range) brackets each term block's rows in its range
                 (merge_docs' brackets), gives each doc P = 1 + branches +
                 synonym groups slots (the base, each branch of each max
                 spec, each synonym group), adds each term's rows in term
                 order - a row's weight into every weight channel its term
                 feeds, its posting's wdf into every synonym channel - one
                 barrier a term, then writes each row's sum from its doc's
                 slots, the first and last tiles' rows outside every range
                 by the probes, and its share of the SENTINEL rows 0. An
                 emulation of that (chunks of rows, a barrier a term) gives
                 _merge_special_plain's sums bit for bit: the browse S and
                 X groups, random plans of several max specs and synonym
                 groups (overlapping masks, a term in no channel), BM25 and
                 the generic schemes (two constants a term, uniqterms), NaN
                 weights, n_docs too small, all-SENTINEL queries; and JAX's
                 execute scores (rtol 1e-5) on the S and X plans of a
                 synthetic segment.
  special_plan   the rule between the doc tiles and the probes at the
                 paths' shapes, and its tile halving as P grows.
  kmeans         csrc/kmeans.cu's cluster arithmetic: each block's partial
                 dot products over its column slice (FMAs; a few rows split
                 a tile's columns over parts, added in part order), added
                 in block order; the first maximum; each chunk's rows of a
                 label summed in row order, the chunk sums added in chunk
                 order; each block's squared norms added in block order. An
                 emulation of that, at the plans kernels.kmeans_plan makes,
                 is held to kmeans_loop_plain and to float64 by the margin
                 rule (ops/cluster.py near_ties) at every step.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_slices_design import merge_world

from xapiand_tpu_torch.models.segment import device_segment_from_numpy
from xapiand_tpu_torch.models.weights import (BM25, CollectionStats,
                                              get_scheme,
                                              scheme_sumpart)
from xapiand_tpu_torch.ops import cluster as pcl
from xapiand_tpu_torch.ops import kernels

SENTINEL = kernels.SENTINEL
M32 = 0xFFFFFFFF
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def same_bits(a, b):
    """Equal float32 bits, every NaN equal to every NaN."""
    a, b = a.numpy(), b.numpy()
    if a.shape != b.shape:
        return False
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all() and
                (a[~nan].view(np.int32) == b[~nan].view(np.int32)).all())


# --------------------------------------------------------------------------
# merge_special: doc tiles with a slot a (doc, channel)
# --------------------------------------------------------------------------

def term_channels(max_specs, syn_groups, qbits):
    """csrc/merge_special.cu's channels: P, and per term the weight
    channels it feeds (the base where its bits miss every branch mask,
    each branch whose mask it meets) and its wdf channels (each synonym
    group whose mask it meets)."""
    excl = 0
    for br in max_specs:
        for m in br:
            excl |= m & M32
    cw, cy = [], []
    for qb in qbits:
        qb = int(qb) & M32
        mw, my, ch = [], [], 1
        for br in max_specs:
            for m in br:
                if qb & m & M32:
                    mw.append(ch)
                ch += 1
        if not qb & excl:
            mw.insert(0, 0)
        for m in syn_groups:
            if qb & m & M32:
                my.append(ch)
            ch += 1
        cw.append(mw)
        cy.append(my)
    return ch, cw, cy


def combine(chan, ids, widths, offsets, post_doclen, max_specs, syn_groups,
            syn_tconst, spec, uniq):
    """Each real row's sum from its doc's channel values chan [P, B, R], in
    the kernel's order: the base, each max spec's best branch (the first,
    then a NaN-propagating maximum), each synonym group's sumpart where
    its wdf sum is > 0 (dl at the row's own posting); SENTINEL rows 0."""
    n = post_doclen.shape[0]
    real = ids != SENTINEL
    c = torch.from_numpy(chan)
    s = c[0]
    ch = 1
    for br in max_specs:
        best = None
        for _m in br:
            best = c[ch] if best is None else torch.maximum(best, c[ch])
            ch += 1
        if best is not None:
            s = s + best
    if syn_groups:
        dl = torch.cat([post_doclen[
            offsets[:, u].long().clamp(max=n - W).clamp(min=0)[:, None] +
            torch.arange(W)] for u, W in enumerate(widths)], 1)
        dl = torch.where(dl > 0, dl, 1.0)
        un = uniq[ids.clamp(max=uniq.shape[0] - 1)] if uniq is not None \
            else None
        for i in range(len(syn_groups)):
            ssum = c[ch]
            sw = scheme_sumpart(spec, ssum, dl, kernels._tc(syn_tconst, i),
                                un)
            s = torch.where(ssum > 0, s + sw, s)
            ch += 1
    return torch.where(real, s, 0.0)


def emulate_merge_special(ids, w, widths, bits, offsets, post_wdf,
                          post_doclen, max_specs, syn_groups, syn_tconst,
                          spec, uniq=None, n_docs=None, tile=4096,
                          threads=256, rpt=8):
    """csrc/merge_special.cu's doc tiles as they run, block by block: each
    term's bracket in the block's docid range (from row 0 in the first
    tile, to the first SENTINEL in the last), the bracketed rows in chunks
    of threads * rpt, each chunk's terms in order with a barrier between
    them (every channel the term feeds gets its rows' weight or wdf at the
    doc's slot), then each row's channel values (the probes' for a docid
    outside the tiles), the block's share of the SENTINEL rows. -> (sums
    as merge_special returns them, the times each row was written)."""
    ids_n, w_n = ids.numpy(), w.numpy()
    wdf_n = post_wdf.numpy()
    B, R = ids_n.shape
    T = len(widths)
    ro = kernels.row_offsets(widths)
    n_post = wdf_n.shape[0]
    nt = max(1, -(-int(n_docs) // tile))
    P = kernels.special_channels(max_specs, syn_groups)
    chan = np.zeros((P, B, R), np.float32)
    wrote = np.zeros((B, R), np.int32)
    for b in range(B):
        Pb, cw, cy = term_channels(max_specs, syn_groups, bits[b].tolist())
        assert Pb == P
        pst = [max(min(int(offsets[b, u]), n_post - W), 0)
               for u, W in enumerate(widths)]

        def probe(r, d, t):
            c = np.zeros(P, np.float32)
            for u, W in enumerate(widths):
                if u == t:
                    p = r - ro[t]
                else:
                    blk = ids_n[b, ro[u]:ro[u] + W]
                    p = int(np.searchsorted(blk, d, "left"))
                    if not (p < W and blk[p] == d):
                        continue
                for ch in cw[u]:
                    c[ch] = np.float32(c[ch] + w_n[b, ro[u] + p])
                for ch in cy[u]:
                    c[ch] = np.float32(c[ch] + wdf_n[pst[u] + p])
            return c

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
            pr = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
            ps = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
            N = int(pr[-1])
            k = np.arange(N)
            term = np.searchsorted(pr[:T], k, "right") - 1
            pos = np.asarray(a0, np.int64)[term] + (k - pr[term])
            rows = np.asarray(ro[:T], np.int64)[term] + pos
            d = ids_n[b, rows].astype(np.int64)
            slot = d - lo
            inside = (slot >= 0) & (slot < tile)
            acc = np.zeros((P, tile), np.float32)
            CH = (32 if N <= 32 * rpt else threads) * rpt
            for c0 in range(0, N, CH):
                c1 = min(N, c0 + CH)
                u0 = int(np.searchsorted(pr[:T + 1], c0, "right") - 1)
                u1 = int(np.searchsorted(pr[:T + 1], c1 - 1, "right") - 1)
                for u in range(u0, u1 + 1):    # a barrier after each
                    sel = np.arange(c0, c1)
                    sel = sel[(term[sel] == u) & inside[sel]]
                    s = slot[sel]
                    assert len(np.unique(s)) == len(s)   # one row a slot
                    for ch in cw[u]:
                        acc[ch, s] = acc[ch, s] + w_n[b, rows[sel]]
                    for ch in cy[u]:
                        acc[ch, s] = acc[ch, s] + wdf_n[pst[u] + pos[sel]]
            for kk in range(N):
                r = int(rows[kk])
                chan[:, b, r] = acc[:, slot[kk]] if inside[kk] else \
                    probe(r, int(d[kk]), int(term[kk]))
                wrote[b, r] += 1
            S = int(ps[-1])
            for e in range(S * j // nt, S * (j + 1) // nt):
                u = int(np.searchsorted(ps[:T], e, "right") - 1)
                wrote[b, ro[u] + z0[u] + (e - int(ps[u]))] += 1
    sums = combine(chan, ids, widths, offsets, post_doclen, max_specs,
                   syn_groups, syn_tconst, spec, uniq)
    return sums, wrote


def special_world(seed, B, widths, nd, max_specs, syn_groups, fill=0.7,
                  hot=0, nan_p=0.0, n_post=None, empty=(), scheme="bm25",
                  NS=None):
    """One merge_special call's inputs, made with numpy (CPU tensors): the
    rows of merge_world (each term block's sorted docids, SENTINEL-padded;
    weights in [0, 4)), each (query, term) one or two group bits, the
    postings' wdf and doclen (n_post of them; offsets anywhere in them,
    clamped as lax.dynamic_slice clamps), syn_tconst f32[B, NS(, C)] and
    the scheme's spec and uniqterms. -> merge_special's positional
    arguments."""
    rng = np.random.default_rng(seed)
    T = len(widths)
    ids, w = merge_world(seed, B, widths, nd, fill=fill, hot=hot,
                         nan_p=nan_p, empty=empty)
    bits = np.zeros((B, T), np.int64)
    for b in range(B):
        for u in range(T):
            bits[b, u] = 1 << int(rng.integers(0, 6))
            if rng.random() < 0.3:
                bits[b, u] |= 1 << int(rng.integers(0, 6))
    n_post = n_post or 3 * max(widths) + 100
    post_wdf = torch.from_numpy(rng.integers(1, 6, n_post).astype(
        np.float32))
    post_doclen = torch.from_numpy(rng.integers(0, 90, n_post).astype(
        np.float32))
    offsets = torch.from_numpy(rng.integers(-5, n_post, (B, T)).astype(
        np.int32))
    sc = get_scheme(scheme)
    stats = CollectionStats(doc_count=nd, avg_doclen=40.0, doclen_lower=1.0,
                            doclen_upper=90.0, total_len=40.0 * nd,
                            query_length=float(T))
    spec = sc.kernel_spec(stats)
    C = sc.n_constants
    NS = NS or max(len(syn_groups), 1)
    shape = (B, NS) if C == 1 else (B, NS, C)
    syn_tconst = torch.from_numpy((rng.random(shape) * 3 + 0.5).astype(
        np.float32)) if syn_groups else None
    uniq = torch.from_numpy(rng.integers(1, 30, nd + 1).astype(np.float32)) \
        if spec.needs_uniq else None
    return (ids, w, widths, torch.from_numpy(bits.astype(np.int64).astype(
        np.uint32).view(np.int32)), offsets, post_wdf, post_doclen,
        max_specs, syn_groups, syn_tconst, spec, uniq)


def check_special(args, n_docs, tile=256, threads=32, rpt=2):
    want = kernels._merge_special_plain(*args)
    got, wrote = emulate_merge_special(*args, n_docs=n_docs, tile=tile,
                                       threads=threads, rpt=rpt)
    assert (wrote == 1).all(), "every row written once"
    assert same_bits(got, want)
    return want


# masks over the six group bits special_world draws
PLANS = [
    ((), (0b1,)),                                   # S: one synonym group
    (((0b1, 0b10, 0b100),), ()),                    # X: three branches
    (((0b1, 0b10), (0b1000, 0b110000)), (0b100,)),  # two specs and a group
    (((0b11, 0b110),), (0b1000, 0b11000)),          # overlapping masks
    (((0b1,),), (0b10, 0b100, 0b1000, 0b10000)),    # many groups
]


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 10**6), B=st.integers(1, 3),
       T=st.sampled_from([1, 2, 4, 7]), wmax=st.integers(1, 200),
       hot=st.sampled_from([0, 60, 400]), tile=st.sampled_from([16, 64,
                                                                256]),
       rpt=st.sampled_from([1, 2, 8]), plan=st.sampled_from(range(len(PLANS))),
       scheme=st.sampled_from(["bm25", "tfidf", "pl2", "dicecoeff"]))
def test_merge_special_doc_tiles_equal_plain(seed, B, T, wmax, hot, tile,
                                             rpt, plan, scheme):
    """Doc tiles bracketed per term, every channel summed in term order, on
    hypothesis-drawn blocks and plans: shared docs (hot), tiles narrower
    than the rows (several chunks a tile) and wider (empty tiles), one to
    six channels, BM25 and the generic schemes."""
    rng = np.random.default_rng(seed)
    widths = tuple(int(x) for x in rng.integers(1, wmax + 1, T))
    max_specs, syn_groups = PLANS[plan]
    nd = 1000
    args = special_world(seed, B, widths, nd, max_specs, syn_groups, hot=hot,
                         scheme=scheme, empty=(1,) if B > 1 else ())
    check_special(args, nd + 1, tile, 32, rpt)


@pytest.mark.parametrize("case", ["T1", "nan", "all_sentinel", "tile_edges",
                                  "n_docs_too_small", "no_channel",
                                  "wide_NS", "one_tile"])
def test_merge_special_traps(case):
    """The traps by name: T = 1; NaN weights (a non-scoring term's, kept in
    the base as JAX keeps it); every query all SENTINEL; docids at the
    tiles' first and last slots; n_docs below the real docids (the last
    tile's probes); a term whose bits meet no channel; syn_tconst wider
    than the groups; a single tile."""
    nd, tile = 1000, 64
    syn = ((), (0b1,))
    if case == "T1":
        args = special_world(1, 3, (300,), nd, *syn, fill=0.9)
    elif case == "nan":
        args = special_world(2, 3, (64, 32, 128), nd, *PLANS[2], hot=100,
                             nan_p=0.1)
    elif case == "all_sentinel":
        args = special_world(3, 3, (8, 16), nd, *PLANS[1], empty=(0, 1, 2))
    elif case == "tile_edges":
        args = list(special_world(4, 1, (8, 8, 8), nd, *PLANS[2]))
        ids = torch.full((1, 24), SENTINEL, dtype=torch.int32)
        for t in range(3):
            ids[0, 8 * t:8 * t + 6] = torch.tensor([0, 63, 64, 127, 128,
                                                    999], dtype=torch.int32)
        args[0] = ids
        args = tuple(args)
    elif case == "n_docs_too_small":
        args = special_world(5, 2, (64, 32, 128), nd, *PLANS[3], fill=0.9)
        check_special(args, 100, tile)
        return
    elif case == "no_channel":
        args = list(special_world(6, 2, (40, 40, 40), nd, *PLANS[1],
                                  hot=80))
        bits = args[3].clone()
        bits[:, 1] = 1 << 30          # in no mask: neither base nor branch
        args[3] = bits
        args = tuple(args)
    elif case == "wide_NS":
        args = special_world(7, 2, (50, 70), nd, *PLANS[4], NS=9,
                             scheme="pl2")
    else:
        args = special_world(8, 2, (50, 70), 40, *PLANS[2], fill=0.5)
        check_special(args, 41, tile)
        return
    check_special(args, nd + 1, tile)


@pytest.fixture(scope="module")
def browse_sx():
    """The browse S and X launch groups (utils/synth_browse.py) over a
    20,000-doc faceted corpus: score_slices' rows and merge_special's other
    arguments, per group."""
    from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
    from xapiand_tpu_torch.utils import synth_browse as sb
    from xapiand_tpu_torch.utils import synth_faceted as sf

    corpus = sf.build_faceted_corpus(20_000, seed=7)
    searcher = SegmentSearcher(corpus.seg, device=torch.device("cpu"))
    qs = sb.browse_queries(0, 0, 12, 12, 0, seed=11)
    seg = searcher.device_segment.arrays_pytree()
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    spec = searcher.scheme.kernel_spec(searcher.segment)
    out = []
    for cfg, _fn, batch, _chunk in BatchSearcher(
            searcher, k=10, min_batch=8).plan([q for _f, q, _p in qs]):
        widths = cfg.term_classes()
        ids, w, _ = kernels.score_slices(
            post, None, batch["offsets"], batch["lens"], batch["tconst"],
            batch["scoring"], widths, (0,) * cfg.T, spec)
        out.append(((ids, w, widths, batch["group_bits"], batch["offsets"],
                     seg["post_wdf"], seg["post_doclen"], cfg.max_specs,
                     cfg.syn_groups, batch.get("syn_tconst"), spec),
                    seg["deleted"].shape[0]))
    return out


def test_merge_special_doc_tiles_on_browse_rows(browse_sx):
    """The browse S (synonym) and X (max) groups' rows through the
    emulation, by tiles of 1024 docids, equal the plain version bit for
    bit."""
    seen = set()
    for args, n_docs in browse_sx:
        check_special(args, n_docs, tile=1024, threads=64, rpt=2)
        seen.add("syn" if args[8] else "max")
    assert seen == {"syn", "max"}


def _tree_to_numpy(tree):
    return {k: (_tree_to_numpy(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _jax_world():
    from xapiand_tpu.query.ir import Q as JQ
    from xapiand_tpu.utils.synth import build_synthetic_segment

    seg = build_synthetic_segment(3000, 300, seed=17)
    words = sorted(seg.terms, key=lambda t: -seg.terms[t].length)
    a, b, c, d, e = words[3], words[5], words[9], words[2], words[14]
    irs = [JQ.or_(JQ.synonym([a, b, c]), JQ.term(d)),
           JQ.max_(JQ.term(a), JQ.term(b), JQ.and_(JQ.term(c), JQ.term(d))),
           JQ.or_(JQ.synonym([b, e]), JQ.term(a), JQ.term(c)),
           JQ.max_(JQ.term(e), JQ.or_(JQ.term(b), JQ.term(d)))]
    return seg, irs


def test_merge_special_doc_tiles_match_jax_execute():
    """JAX's BatchSearcher over a synthetic segment's synonym and OP_MAX
    plans: every launch group's rows (the port's score_slices on JAX's
    batch) through the emulation; each of JAX's top-k docs carries JAX's
    score (rtol 1e-5: JAX adds in its segmented scan's order)."""
    import jax.numpy as jnp

    from xapiand_tpu.models.weights import BM25 as JBM25
    from xapiand_tpu.search import BatchSearcher as JBatch
    from xapiand_tpu.search import SegmentSearcher as JSearcher

    seg, irs = _jax_world()
    js = JSearcher(seg, JBM25())
    jarr = js.device_segment.arrays_pytree()
    pseg = device_segment_from_numpy(_tree_to_numpy(jarr),
                                     torch.device("cpu"))
    jstats = {"N": jnp.float32(seg.doc_count),
              "avg_doclen": jnp.float32(seg.avg_doclen),
              "doclen_lower": jnp.float32(1.0)}
    spec = BM25().kernel_spec(CollectionStats(seg.doc_count,
                                              seg.avg_doclen))
    post = tuple(pseg[k] for k in ("post_docids", "post_wdf",
                                   "post_doclen"))
    n_docs = pseg["deleted"].shape[0]
    checked = 0
    for cfg, fn, batch, _chunk in JBatch(js, k=10).plan(irs * 3):
        assert cfg.syn_groups or cfg.max_specs
        pb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()
              if k in ("offsets", "lens", "tconst", "scoring", "group_bits",
                       "syn_tconst")}
        widths = cfg.term_classes()
        ids, w, _ = kernels.score_slices(
            post, None, pb["offsets"], pb["lens"], pb["tconst"],
            pb["scoring"], widths, (0,) * cfg.T, spec)
        args = (ids, w, widths, pb["group_bits"], pb["offsets"], post[1],
                post[2], cfg.max_specs, cfg.syn_groups, pb.get("syn_tconst"),
                spec)
        sums = check_special(args, n_docs, tile=512, threads=64, rpt=2)
        want = fn(jarr, batch, jstats)
        for b in range(ids.shape[0]):
            mine = dict(zip(ids[b].tolist(), sums[b].tolist()))
            for dd, sc in zip(np.asarray(want["docids"][b]).tolist(),
                              np.asarray(want["scores"][b]).tolist()):
                if dd == SENTINEL:
                    continue
                assert abs(mine[dd] - sc) <= RTOL * abs(sc), (b, dd)
                checked += 1
    assert checked > 50


# --------------------------------------------------------------------------
# special_plan: the tiles or the probes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("widths,n_docs,P,tiles", [
    # browse S and X at B16 and B32 (the schemes' S / X groups are the same
    # shapes): the tiles
    ((1048576,) * 4, 1_000_001, 2, True),
    ((1048576,) * 4, 1_000_001, 4, True),
    ((524288, 524288, 524288, 524288), 1_000_001, 2, True),
    ((1048576, 524288, 262144, 131072), 1_000_001, 4, True),
    # relevance-sized sparse blocks over a million docs: the probes
    ((256, 256, 256, 128), 1_000_001, 2, False),
    ((1024, 1024, 512, 128), 1_000_001, 4, False),
    ((4096, 2048, 896), 1_000_001, 3, False),
    # a small segment (fewer tiles than MERGE_MIN_TILES): the probes
    ((32768,) * 4, 20_001, 2, False),
    # channels past the tiles' channel word: the probes
    ((1048576,) * 4, 1_000_001, 33, False),
])
def test_special_plan_at_the_paths_shapes(widths, n_docs, P, tiles):
    n, tile = kernels.special_plan(widths, n_docs, P)
    assert (n > 0) == tiles
    if tiles:
        assert n == -(-n_docs // tile)
        assert 4 * P * tile + 32 * len(widths) + 8 <= 200 * 1024


def test_special_plan_halves_the_tile_as_channels_grow():
    """4096 docids up to 12 channels, 2048 up to 24, 1024 up to 32."""
    W = (1048576,) * 4
    tiles = {P: kernels.special_plan(W, 1_000_001, P)[1]
             for P in range(1, 34)}
    assert all(tiles[P] == 4096 for P in range(1, 13))
    assert all(tiles[P] == 2048 for P in range(13, 25))
    assert all(tiles[P] == 1024 for P in range(25, 33))
    assert tiles[33] == 0


@settings(max_examples=200, deadline=None)
@given(T=st.integers(1, 64), w=st.integers(1, 2**20),
       n_docs=st.integers(1, 2**24), P=st.integers(1, 40))
def test_special_plan_invariants(T, w, n_docs, P):
    """The slots fit, the tiles are enough to fill the card, and more rows
    never turn tiles into probes."""
    n, tile = kernels.special_plan((w,) * T, n_docs, P)
    if n:
        assert P <= kernels.SPECIAL_CHANNELS
        assert 4 * P * tile + 32 * T + 8 <= 200 * 1024
        assert tile >= kernels.SPECIAL_MIN_TILE
        assert n >= kernels.MERGE_MIN_TILES
        assert kernels.special_plan((2 * w,) * T, n_docs, P) == (n, tile)


# --------------------------------------------------------------------------
# kmeans: one cluster a call, the columns split over its blocks
# --------------------------------------------------------------------------

def _fma32(x, c, acc):
    """float32 fmaf, up to a double rounding: the product is exact in
    float64."""
    return (x.astype(np.float64) * c + acc).astype(np.float32)


def emulate_kmeans_loop(X, C0, iters, assign_last, S, RC, threads=256,
                        parts=64, G=1):
    """csrc/kmeans.cu's arithmetic at cluster size S, RC rows a chunk and
    G clusters (cluster g the rows [g n / G, (g + 1) n / G)): per chunk
    each block's partial products over its columns (the columns of a tile
    over CP parts where the tiles are few, added in part order), added in
    block order, the first maximum; per chunk and label the rows summed in
    row order, then added onto the cluster's sum of the label; the
    clusters' sums added in cluster order; each block's squared norms
    added in block order. -> (labels, C, (labels i32[iters, n], C
    f32[iters, k, V]))."""
    X = np.asarray(X, np.float32)
    C = np.array(C0, np.float32)
    n, V = X.shape
    k = C.shape[0]
    kp = -(-k // 4) * 4
    cols = [(b * V // S, (b + 1) * V // S) for b in range(S)]
    hl, hc = [], []
    labels = np.zeros(n, np.int32)
    for t in range(iters + (1 if assign_last else 0)):
        upd = t < iters
        if upd:
            hc.append(C.copy())
        sums = np.zeros((G, k, V), np.float32)
        chunks = [(g, r0, min(RC, (g + 1) * n // G - r0)) for g in range(G)
                  for r0 in range(g * n // G, (g + 1) * n // G, RC)]
        for g, r0, rc in chunks:
            rc4 = -(-rc // 4) * 4
            tiles = rc4 // 4 * (kp // 4)
            CP = 1
            while CP < parts and tiles * CP * 2 <= threads:
                CP *= 2
            xs = X[r0:r0 + rc]
            tot = np.zeros((rc, k), np.float32)
            for c0, c1 in cols:          # block order
                blk = None
                for q in range(CP):       # part order, inside the block
                    acc = np.zeros((rc, k), np.float32)
                    for j in range(c0 + q, c1, CP):
                        acc = _fma32(xs[:, j:j + 1], C[None, :, j], acc)
                    blk = acc if blk is None else (blk + acc).astype(
                        np.float32)
                tot = (tot + blk).astype(np.float32)
            lab = np.zeros(rc, np.int32)
            for i in range(rc):          # the first maximum
                best = -np.inf
                for c in range(k):
                    if tot[i, c] > best:
                        best, lab[i] = tot[i, c], c
            labels[r0:r0 + rc] = lab
            if upd:
                for c in range(k):
                    part = np.zeros(V, np.float32)
                    for i in np.flatnonzero(lab == c):     # row order
                        part = (part + xs[i]).astype(np.float32)
                    sums[g, c] = (sums[g, c] + part).astype(np.float32)
        if upd:
            tot = sums[0]
            for g in range(1, G):        # cluster order
                tot = (tot + sums[g]).astype(np.float32)
            sums = tot
            hl.append(labels.copy())
            sq = np.zeros(k, np.float32)
            for c0, c1 in cols:          # block order
                blk = (sums[:, c0:c1] * sums[:, c0:c1]).astype(np.float32)
                sq = (sq + blk.sum(axis=1, dtype=np.float32)).astype(
                    np.float32)
            norm = np.sqrt(sq).astype(np.float32)
            keep = ~(norm > 1e-6)
            C = np.where(keep[:, None], C,
                         (sums / np.maximum(norm, 1e-6)[:, None]).astype(
                             np.float32))
    return labels, C, (np.array(hl, np.int32).reshape(iters, n),
                       np.array(hc, np.float32).reshape(iters, k, V))


def _unit_rows(n, v, k, seed, blocks=True):
    rng = np.random.Generator(np.random.PCG64(seed))
    if blocks:
        centres = rng.random((k, v)) ** 4
        rows = centres[rng.integers(0, k, n)] + 0.05 * rng.random((n, v))
    else:
        rows = rng.random((n, v)) ** 3
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)


def _update64(X64, labels, C, k):
    S = np.zeros((k, X64.shape[1]))
    np.add.at(S, labels, X64)
    norms = np.linalg.norm(S, axis=1, keepdims=True)
    return np.where(norms > 1e-6, S / np.maximum(norms, 1e-6), C)


def hold_trajectory(X, got, want):
    """The emulation's steps against kmeans_loop_plain's and float64's by
    the margin rule: at each step the labels under the emulation's own
    centroids equal float64's outside the margin, its next centroids are
    within rtol 1e-5 of the float64 update of its own labels, and while
    every label agrees with the plain trajectory the centroids agree with
    it within rtol 1e-5. -> rows inside the margin."""
    X64 = X.astype(np.float64)
    (gl, gc, (ghl, ghc)), (wl, wc, (whl, whc)) = got, want
    iters, k = ghc.shape[0], gc.shape[0]
    nexts = list(ghc[1:]) + [gc]
    inside = 0
    agree = True
    for t in range(iters):
        C = ghc[t].astype(np.float64)
        near = pcl.near_ties(X64, C)
        inside += int(near.sum())
        lab64 = (X64 @ C.T).argmax(axis=1)
        assert not ((ghl[t] != lab64) & ~near).any(), t
        np.testing.assert_allclose(nexts[t], _update64(X64, ghl[t], C, k),
                                   rtol=RTOL, atol=0)
        if agree:
            np.testing.assert_allclose(ghc[t], whc[t], rtol=RTOL, atol=0)
            agree = bool((ghl[t] == whl[t]).all())
    C = gc.astype(np.float64)
    near = pcl.near_ties(X64, C)
    assert not ((gl != (X64 @ C.T).argmax(axis=1)) & ~near).any()
    if agree:
        np.testing.assert_array_equal(gl[~near], wl[~near])
    return inside


@pytest.mark.parametrize("n,v,k,blocks", [(64, 48, 5, True),
                                          (90, 40, 3, False),
                                          (37, 17, 20, True),
                                          (10, 36, 3, True),
                                          (1, 5, 1, True)])
@pytest.mark.parametrize("S", [1, 3, 16])
def test_kmeans_cluster_arithmetic_by_the_margin_rule(n, v, k, blocks, S):
    """The cluster's column split at 1, 3 and 16 blocks (16 past V's
    columns: blocks of no column), and chunks of the kernel's RC and of 8
    rows (several chunks a step), in one cluster and, at 8 rows a chunk,
    in 3 clusters that split the rows (at most n), held to
    kmeans_loop_plain and float64 at every step of 6 and the last
    assignment."""
    X = _unit_rows(n, v, k, seed=n + v + k, blocks=blocks)
    C0 = X[np.arange(k) * (n // k)]
    want = kernels.kmeans_loop_plain(torch.from_numpy(X),
                                     torch.from_numpy(C0), 6, history=True)
    want = (want[0].numpy(), want[1].numpy(),
            (want[2][0].numpy(), want[2][1].numpy()))
    _S, RC, _g, _G = kernels.kmeans_plan(n, v, k)
    for rc, G in ((RC, 1), (8, 1), (8, min(3, n))):
        got = emulate_kmeans_loop(X, C0, 6, True, S, rc, G=G)
        hold_trajectory(X, got, want)


@pytest.mark.parametrize("n,v,k,S,RC,G", [(10, 1360, 3, 1, 12, 1),
                                          (256, 2048, 8, 16, 256, 1),
                                          (4096, 2048, 16, 16, 256, 8),
                                          (207, 2048, 8, 13, 208, 1),
                                          (37, 17, 20, 1, 40, 1),
                                          (600, 2048, 8, 16, 256, 3)])
def test_kmeans_plan_at_the_paths_shapes(n, v, k, S, RC, G):
    """One block at the REST path's n10 k3 (V 1,024-1,360), 16 at n256 and
    n4096 (V 2048), each block's buffers within the H100's shared memory;
    a chunk of 4 * floor(256 / ceil(k / 4)) rows at most; one cluster
    where it holds the rows in one chunk, else a cluster a chunk, no more
    than the card's SMs hold (8 of 16 blocks at n4096)."""
    assert kernels.kmeans_plan(n, v, k) == (S, RC, False, G)
    assert 4 * kernels._km_words(v, k, S, RC) <= kernels.KMEANS_SMEM


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 10_000), v=st.integers(0, 4096),
       k=st.integers(1, 400))
def test_kmeans_plan_invariants(n, v, k):
    """A cluster of 1 to 16 blocks of at least 32 columns each (or one);
    a chunk a multiple of 4 rows, at most n rounded up to 4; the buffers in
    shared memory, or one block with a device workspace."""
    k = min(k, n)
    S, RC, glob, G = kernels.kmeans_plan(n, v, k)
    assert 1 <= S <= kernels.KMEANS_CLUSTER
    assert 1 <= G <= min(kernels.KMEANS_GRID, n, -(-n // RC))
    assert G * S <= max(kernels.KMEANS_SMS, S)
    assert G == 1 or not glob
    assert S == 1 or v // S >= 32
    assert RC >= 4 and RC % 4 == 0 and RC <= max(4, -(-n // 4) * 4)
    if glob:
        assert S == 1
    else:
        assert 4 * kernels._km_words(v, k, S, RC) <= kernels.KMEANS_SMEM


def test_kmeans_loop_plain_is_repeated_steps():
    """kmeans_loop_plain's history is kmeans_step_plain's trajectory, and
    kmeans (one step, or the assignment alone) its one-step call."""
    X = torch.from_numpy(_unit_rows(50, 20, 4, seed=3))
    C0 = X[:4].clone()
    labels, C, (hl, hc) = kernels.kmeans_loop_plain(X, C0, 3, history=True)
    c = C0
    for t in range(3):
        assert torch.equal(hc[t], c)
        lt, c = kernels.kmeans_step_plain(X, c)
        assert torch.equal(hl[t], lt)
    assert torch.equal(C, c)
    assert torch.equal(labels, kernels.kmeans_step_plain(X, c, False)[0])
    l1, c1 = kernels.kmeans(X, C0)
    assert torch.equal(l1, hl[0]) and torch.equal(c1, hc[1])
    l0, none = kernels.kmeans(X, C0, update=False)
    assert none is None and torch.equal(l0, hl[0])
    with pytest.raises(ValueError):
        kernels.kmeans_loop(X, C0, 0, assign_last=False)
    with pytest.raises(ValueError):
        kernels.kmeans_loop(X[:3], C0, 2)
