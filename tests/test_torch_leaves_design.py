"""The decompositions the redesigned phrase_leaves (K14) and geo_leaves
(K16) kernels rely on, held on the CPU against their plain versions and
JAX. JAX is imported inside the tests that run it, so
tests/test_torch_cuda.py takes the worlds and cases from here.

  phrase_leaves  csrc/phrase_leaves.cu: candidacy from the orbits merge_docs
                 writes on every row of a doc and the deleted flags, read
                 at the rows of the phrase term with the fewest postings
                 (no search); a count pass over tiles of those rows, a
                 compact pass that numbers a tile's candidates after the
                 counts of the tiles before it and exits where that prefix
                 reaches cand_cap, a verify pass of one candidate a thread
                 whose owner search skips the terms whose group bit the doc
                 lacks. An emulation of the three passes equals
                 _phrase_leaves_plain bit for bit, ncand included: the cap
                 inside the first tile, mid-tile and never, no candidate, a
                 repeated word, NEAR at windows 1 and 5, a phrase term with
                 no postings, 18 terms, deleted docs, an OR group beside the
                 phrase (its bits in orbits do not make candidates); at
                 tiles of 64 rows and at the kernel's 1,024. The planner
                 facts it rests on (a group a phrase term, terms numbered
                 in group order, orbits equal on every row of a doc) are
                 pinned, and its verdicts equal JAX's phrase_leaves per doc
                 on tests/test_torch_phrase.py's worlds.
  geo_leaves     csrc/geo_leaves.cu: one search a range, k = #(qe < rs),
                 hit iff k < QR and qs[k] <= re, in the bracket of a bucket
                 table over the cover; equal to the two counts #(qs <= re)
                 > #(qe < rs) of _geo_leaves_plain and of JAX's
                 _gather_geo_leaves on sorted, disjoint covers (hypothesis):
                 QR 1 and 1024, INT32_MAX pads, ranges touching a cover
                 range's ends, re = INT32_MAX, docs past RMAX ranges, base
                 None. The int2 pairs it reads (models/segment.py
                 geo_arrays) are built wherever a geo column is uploaded.
"""

import bisect

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xapiand_tpu_torch.models.segment import GeoColumn, geo_arrays
from xapiand_tpu_torch.ops import kernels, phrase
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.query.plan import compile_ir
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils import synth_positional as sp

I32MAX = kernels.I32MAX
SENTINEL = kernels.SENTINEL
PH_TILE = phrase.PHRASE_TILE     # csrc/phrase_leaves.cu PH_TILE
GL_NB = 512                      # csrc/geo_leaves.cu GL_NB


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setenv("XT_HOST_PATH", "0")


# --------------------------------------------------------------------------
# phrase_leaves: a world without JAX, its cases, the three passes emulated
# --------------------------------------------------------------------------

def positional_world(device, n_docs=2000):
    """Config 2's generator at n_docs with every 53rd doc deleted; its
    searcher on ``device``; the case queries: a common phrase (w0 w1, for
    the cap cases), two words that share no doc, a repeated word, NEAR at
    windows 1 and 5, a phrase with a word that has no postings, 18 words
    of doc 0, an OR group beside a phrase."""
    corpus = sp.build_corpus2(n_docs, seed=7)
    seg = corpus.seg
    seg.deleted[5:n_docs:53] = True
    searcher = SegmentSearcher(seg, device=device)
    long = tuple(sp.word(t) for t in corpus.tokens[0][:18])

    def docs(w):
        ti = seg.terms[w]
        return set(seg.post_docids[ti.offset:ti.offset + ti.length].tolist())

    # two words that have postings and share no doc: no candidate
    apart = next((a, b) for a in ("w300", "w301", "w302") for b in
                 (f"w{i}" for i in range(400, 600))
                 if b in seg.terms and not docs(a) & docs(b))
    irs = {"common": Q.phrase(("w0", "w1")),
           "apart": Q.phrase(apart),
           "repeated": Q.phrase(("w0", "w1", "w0")),
           "near1": Q.near(("w0", "w2"), window=1),
           "near5": Q.near(("w3", "w1"), window=5),
           "zero": Q.phrase(("w0", "nosuchword")),
           "long": Q.phrase(long),
           "or_group": Q.or_(Q.phrase(("w2", "w4")), Q.term("w7"))}
    return corpus, searcher, irs


def phrase_args(searcher, ir):
    """The wrapper's arguments of the query's phrase launch group, as
    execute_batch forms them: (args, kw, cfg)."""
    (cfg, _fn, batch, _ch), = [g for g in BatchSearcher(
        searcher, k=10).plan([ir]) if g[0].phrases]
    seg = searcher.device_segment.arrays_pytree()
    widths = cfg.term_classes()
    post = (seg["post_docids"], seg["post_wdf"], seg["post_doclen"])
    ids, w, _t = kernels.score_slices(
        post, None, batch["offsets"], batch["lens"], batch["tconst"],
        batch["scoring"], widths, (0,) * cfg.T,
        searcher.scheme.kernel_spec(searcher.segment))
    deleted = seg["deleted"] if cfg.has_deletes else None
    bits = batch["group_bits"]
    _s, first, _c, orbits = kernels.merge_docs(
        ids, w, widths, bits, deleted, None, True,
        n_docs=seg["deleted"].shape[0])
    args = (ids, widths, batch["offsets"], batch["lens"], orbits, first,
            seg["post_posoff"], seg["post_poslen"], seg["positions"],
            cfg.phrases, cfg.cand_cap, cfg.pmax)
    return args, {"deleted": deleted, "bits": bits}, cfg


def with_cap(args, cap):
    return args[:10] + (int(cap),) + args[11:]


def emulate_phrase_leaves(args, kw, tile=PH_TILE, verify=True):
    """csrc/phrase_leaves.cu's three passes, row by row (verify False:
    the first two). -> phbits, ncand, {(b, p): (the tiles the compact
    pass numbered, the walked rows of every candidate)}."""
    ids, widths, offsets, lens, orbits, _first, posoff, poslen, positions, \
        phrases, cand_cap, pmax = args
    deleted, bits = kw["deleted"], kw["bits"]
    ids, orbits = ids.cpu().numpy(), orbits.cpu().numpy()
    offsets, lens = offsets.cpu().tolist(), lens.cpu().numpy()
    posoff, poslen = posoff.cpu().numpy(), poslen.cpu().numpy()
    positions = positions.cpu().numpy()
    deleted = None if deleted is None else deleted.cpu().numpy()
    bits = bits.cpu().tolist()
    widths = tuple(int(x) for x in widths)
    B, R = ids.shape
    T = len(widths)
    ro = kernels.row_offsets(widths)
    table, cols = phrase.phrase_table(phrases)
    phbits = np.zeros((B, R), np.int32)
    ncand = np.zeros((B, len(phrases)), np.int32)
    numbered = {}
    for p in range(len(phrases)):
        row = table[p * cols:(p + 1) * cols]
        n, exact, window, allbits = row[:4]
        terms = list(row[4:4 + n])
        for b in range(B):
            rows = [min(int(lens[b, t]), widths[t]) for t in range(T)]
            tw, nw = terms[0], rows[terms[0]]
            for t in terms[1:]:
                if rows[t] < nw:
                    tw, nw = t, rows[t]
            blk = ids[b, ro[tw]:ro[tw] + nw]
            cand = (orbits[b, ro[tw]:ro[tw] + nw] & allbits) == allbits
            if deleted is not None:
                cand &= ~deleted[np.minimum(blk, deleted.shape[0] - 1)]
            # count: a tile's candidates
            used = -(-nw // tile)
            counts = [int(cand[x * tile:(x + 1) * tile].sum())
                      for x in range(used)]
            ncand[b, p] = min(sum(counts), cand_cap)
            # compact: the tiles whose prefix is below the cap
            lst, numbered[(b, p)] = {}, ([], np.flatnonzero(cand))
            for x in range(used):
                idx = sum(counts[:x])
                if idx >= cand_cap:
                    continue
                numbered[(b, p)][0].append(x)
                for j in np.flatnonzero(cand[x * tile:(x + 1) * tile]):
                    if idx < cand_cap:
                        lst[idx] = ro[tw] + x * tile + int(j)
                    idx += 1
            assert sorted(lst) == list(range(ncand[b, p]))
            if not verify:
                continue
            # verify: one candidate a thread
            blocks = [ids[b, ro[t]:ro[t] + rows[t]].tolist()
                      for t in range(T)]
            id_b, ob_b = ids[b].tolist(), orbits[b].tolist()
            for i in range(ncand[b, p]):
                r0 = lst[i]
                d, ob = id_b[r0], ob_b[r0]

                def pos_of(t):
                    if t == tw:
                        return r0 - ro[t]
                    q = bisect.bisect_left(blocks[t], d)
                    return q if q < rows[t] and blocks[t][q] == d else -1

                pos = [pos_of(t) for t in terms]
                assert min(pos) >= 0
                owner = r0
                for u in range(T):
                    if not ob & bits[b][u]:
                        continue
                    q = pos[terms.index(u)] if u in terms else pos_of(u)
                    if q >= 0:
                        owner = ro[u] + q
                        break
                lists = []
                for t, q in zip(terms, pos):
                    slot = offsets[b][t] + q
                    po = int(posoff[slot])
                    lists.append(positions[po:po + min(int(poslen[slot]),
                                                       pmax)].tolist())
                ok = False
                for p0 in lists[0]:
                    ok = True
                    for k, li in enumerate(lists[1:], start=1):
                        if exact:
                            ok = p0 + k in li
                        else:
                            j = bisect.bisect_left(li, p0 - window + 1)
                            ok = j < len(li) and li[j] < p0 + window
                        if not ok:
                            break
                    if ok:
                        break
                if ok:
                    phbits[b, owner] |= 1 << p
    return torch.from_numpy(phbits), torch.from_numpy(ncand), numbered


@pytest.fixture(scope="module")
def world():
    corpus, searcher, irs = positional_world(torch.device("cpu"))
    return corpus, searcher, {k: phrase_args(searcher, ir)
                              for k, ir in irs.items()}


def _same(got, want):
    assert torch.equal(got[0], want[0].cpu())
    assert torch.equal(got[1], want[1].cpu())


def test_planner_gives_each_phrase_term_its_own_group():
    """The fact candidacy rests on: every phrase term is the only term of
    its group (so a group bit in orbits is the term's), and terms are
    numbered in group order."""
    irs = [Q.phrase(("a", "b", "a")), Q.near(("a", "c"), window=3),
           Q.or_(Q.phrase(("a", "b")), Q.or_terms(["a", "d", "e"])),
           Q.and_(Q.term("z"), Q.phrase(tuple(f"s{i}" for i in range(18))),
                  Q.near(("b", "z"), window=5))]
    for ir in irs:
        cq = compile_ir(ir)
        groups = [t.group for t in cq.terms]
        assert groups == sorted(groups)
        for term_idxs, group_idxs, _w, _e in cq.phrases:
            assert len(set(group_idxs)) == len(group_idxs)
            for t, g in zip(term_idxs, group_idxs):
                assert cq.terms[t].group == g
                assert groups.count(g) == 1


def test_orbits_equal_on_every_row_of_a_doc(world):
    """merge_docs writes the doc's OR of group bits on each of its rows,
    not only at the owner: the walked rows read it there."""
    _corpus, _searcher, cases = world
    for name in ("repeated", "or_group"):
        args, _kw, _cfg = cases[name]
        ids, orbits, first = args[0], args[4], args[5]
        for b in range(ids.shape[0]):
            real = ids[b] != SENTINEL
            d, ob = ids[b][real], orbits[b][real]
            own = {int(x): int(o) for x, o, f in zip(
                ids[b].tolist(), orbits[b].tolist(), first[b].tolist()) if f}
            for x, o in zip(d.tolist(), ob.tolist()):
                assert own.get(x, o) == o


@pytest.mark.parametrize("tile", [64, PH_TILE])
@pytest.mark.parametrize("case", ["cap_first_tile", "cap_mid_tile",
                                  "cap_never", "no_candidate", "repeated",
                                  "near1", "near5", "zero", "long",
                                  "or_group"])
def test_phrase_tiles_match_plain_version(world, case, tile):
    _corpus, _searcher, cases = world
    name = {"cap_first_tile": "common", "cap_mid_tile": "common",
            "cap_never": "common", "no_candidate": "apart"}.get(case, case)
    args, kw, cfg = cases[name]
    assert kw["deleted"] is not None      # every 53rd doc is deleted
    if case.startswith("cap"):
        # the walked rows of the query with the most candidates, uncapped
        _pb, total, info = emulate_phrase_leaves(with_cap(args, 1 << 30),
                                                 kw, tile, verify=False)
        b = int(total[:, 0].argmax())
        tiles, at = info[(b, 0)]
        n_tiles = len(tiles)
        assert n_tiles >= 2 and len(at) > 2
        if case == "cap_first_tile":
            cap = max(1, int((at < tile).sum()) // 2)
        elif case == "cap_mid_tile":
            # the cap falls in the middle of the last tile walked
            last = int(at[-1]) // tile
            inside = at[at >= last * tile]
            cap = int((at < last * tile).sum()) + max(1, len(inside) // 2)
        else:
            cap = len(at) + 5
        args = with_cap(args, cap)
        got = emulate_phrase_leaves(args, kw, tile)
        cap_tile = int(at[min(cap, len(at)) - 1]) // tile
        want_tiles = {"cap_first_tile": [0], "cap_never": tiles}.get(
            case, list(range(cap_tile + 1)))
        assert got[2][(b, 0)][0] == want_tiles
        if case == "cap_mid_tile":
            assert cap_tile > 0 and cap < len(at)
    else:
        got = emulate_phrase_leaves(args, kw, tile)
    want = phrase._phrase_leaves_plain(*args)
    _same(got, want)
    # the wrapper on CPU tensors is the plain version
    _same(phrase.phrase_leaves(*args, **kw), want)
    n = int(got[1].sum())
    if case in ("no_candidate", "zero"):
        assert n == 0
    else:
        assert n > 0 and (case == "near1" or bool(got[0].any()))


def test_phrase_leaves_takes_deleted_and_bits_by_name(world):
    """The wrapper has no default for what merge_docs applied: a call that
    leaves out ``deleted`` (None only when given) or ``bits``, or passes
    them by position, is refused."""
    _corpus, _searcher, cases = world
    args, kw, _cfg = cases["common"]
    for k in kw:
        with pytest.raises(TypeError):
            phrase.phrase_leaves(*args, **{n: v for n, v in kw.items()
                                           if n != k})
    with pytest.raises(TypeError):
        phrase.phrase_leaves(*args, kw["deleted"], kw["bits"])


def test_other_groups_bits_do_not_make_candidates(world):
    """The OR group beside the phrase sets its bit in the orbits of the
    docs holding w7: a doc with that bit and not both phrase bits is no
    candidate, a doc with both is, whatever its other bits."""
    _corpus, _searcher, cases = world
    args, kw, cfg = cases["or_group"]
    ids, orbits, first = args[0], args[4], args[5]
    (tidx, groups, _w, _e), = cfg.phrases
    allbits = sum(1 << g for g in groups)
    other = 0
    for t, bt in enumerate(kw["bits"][0].tolist()):
        if t not in tidx:
            other |= bt
    assert other > 0 and not other & allbits
    has_other = (orbits & other) != 0
    full = (orbits & allbits) == allbits
    assert bool((has_other & ~full & first).any())
    assert bool((has_other & full & first).any())
    phb, ncand, _n = emulate_phrase_leaves(args, kw, 64)
    n_cand = int((full & first).sum(1).clamp(max=args[10]).sum())
    assert int(ncand.sum()) == n_cand
    assert not bool((phb.bool() & ~full).any())


@pytest.mark.parametrize("fam", ["P2", "P3", "N", "CAP"])
def test_phrase_tiles_match_jax(fam):
    """The emulation's verdicts are JAX's phrase_leaves' per doc, on the
    worlds of tests/test_torch_phrase.py (JAX Database commits, deleted
    docs; the Zipf world past the cap)."""
    import test_torch_phrase as tph
    import test_torch_predicate as tp
    from xapiand_tpu_torch.ops.executor import ExecConfig

    key = "z" if fam == "CAP" else "u"
    if key not in tph._WORLDS:
        tph._WORLDS[key] = tph._zipf_world() if key == "z" \
            else tph._uniform_world()
    w = tph._WORLDS[key]
    n_true = 0
    for jcfg, _fn, batch, _chunk in w.jax_groups(fam):
        cfg = tp._fields(jcfg, ExecConfig)
        pb = w.port_batch(batch)
        ids, wts, widths, _s, first, orbits = tph._port_rows(w, cfg, pb)
        args = (ids, widths, pb["offsets"], pb["lens"], orbits, first,
                w.parr["post_posoff"], w.parr["post_poslen"],
                w.parr["positions"], cfg.phrases, cfg.cand_cap, cfg.pmax)
        kw = {"deleted": w.parr["deleted"] if cfg.has_deletes else None,
              "bits": pb["group_bits"]}
        phb, ncand, _n = emulate_phrase_leaves(args, kw, 64)
        _same((phb, ncand), phrase._phrase_leaves_plain(*args))
        want = tph._jax_phrase_verdicts(w, jcfg, pb, ids, wts, widths)
        for p, wp in enumerate(want):
            got = tph._pairs(ids.numpy(), ((phb.numpy() >> p) & 1) == 1)
            assert got == wp, (fam, p)
            n_true += len(got)
        if fam == "CAP":
            assert (ncand.numpy() == cfg.cand_cap).any()
    assert n_true > 0


# --------------------------------------------------------------------------
# geo_leaves: one search a range in a bucket table's bracket
# --------------------------------------------------------------------------

def geo_case(seed, B=3, C=300, QR=64, n_real=None, RMAX=8, nd=400,
             base=True, max_ranges=12):
    """A geo column of nd docs (0..max_ranges ranges each, some touching a
    cover range's ends, some with re = INT32_MAX; its int2 pairs as the
    segment uploads them), B covers of QR rows (n_real sorted disjoint
    ranges, INT32_MAX pads), C rows a query (SENTINEL rows among them) and
    base flags, or None. -> the wrapper's (cols, specs, queries, docids,
    base), numpy-made, on the CPU."""
    rng = np.random.default_rng(seed)
    span = 1 << 20
    covers = []
    ends = []
    for _b in range(B):
        k = int(rng.integers(1, QR + 1)) if n_real is None else n_real
        cuts = np.sort(rng.choice(span, size=2 * k, replace=False))
        cuts = cuts.reshape(k, 2).astype(np.int64) + (1 << 29)
        q = np.full((QR, 2), I32MAX, np.int64)
        q[:k] = cuts
        covers.append(q)
        ends += cuts.reshape(-1).tolist()
    doc_len = rng.integers(0, max_ranges + 1, size=nd + 1)
    doc_len[nd] = 0                        # the pad doc
    starts, stops = [], []
    for n in doc_len:
        pts = np.sort(rng.choice(span + 2, size=2 * n, replace=False))
        pts = pts.reshape(-1, 2) + (1 << 29) - 1
        for j in range(n):
            if rng.random() < 0.2 and ends:   # touch a cover range's end
                e = int(rng.choice(ends))
                pts[j] = (e, e) if rng.random() < 0.5 else (e - 3, e)
            if rng.random() < 0.03:
                pts[j, 1] = I32MAX
        starts += pts[:, 0].tolist()
        stops += pts[:, 1].tolist()
    doc_off = np.concatenate([[0], np.cumsum(doc_len)[:-1]])
    if not starts:
        starts, stops = [0], [0]
    col = geo_arrays(GeoColumn(
        flat_start=np.asarray(starts), flat_end=np.asarray(stops),
        doc_off=doc_off, doc_len=doc_len, max_doc_ranges=max_ranges))
    col = {k: torch.from_numpy(v) for k, v in col.items()}
    docids = torch.tensor(rng.integers(0, nd + 3, size=(B, C)),
                          dtype=torch.int32)
    docids[torch.from_numpy(rng.random((B, C)) < 0.1)] = SENTINEL
    flags = torch.from_numpy(rng.random((B, C)) < 0.8) & (docids != SENTINEL)
    queries = [torch.tensor(np.stack(covers), dtype=torch.int32)]
    return [col], ((101, QR, RMAX),), queries, docids, \
        (flags if base else None)


def emulate_geo_leaves(cols, specs, queries, docids, base, nb=GL_NB):
    """csrc/geo_leaves.cu per row: per leaf the cover's bucket table (lo =
    qe[0], the least shift that puts the last real end in nb buckets,
    tab[h] = #(qe < lo + (h << s)), tab[nb] = QR), each of a live row's
    first min(doc_len, RMAX) ranges searched in its bucket's bracket: hit
    iff k < QR and qs[k] <= re."""
    d_all = docids.numpy()
    live = base.numpy() if base is not None else d_all != SENTINEL
    B, C = d_all.shape
    out = np.zeros((B, C), np.int64)
    for g, (col, (_s, QR, RMAX), q) in enumerate(zip(cols, specs, queries)):
        c = {k: v.numpy().astype(np.int64) for k, v in col.items()}
        nd1, GR = len(c["doc_off"]), len(c["flat_start"])
        for b in range(B):
            qs, qe = q[b, :, 0].numpy(), q[b, :, 1].numpy()
            lo = int(qe[0])
            real = np.flatnonzero(qe != I32MAX)
            span = int(qe[real[-1]]) - lo if len(real) else 0
            s = 0
            while span >> s >= nb:
                s += 1
            tab = [int(np.searchsorted(qe, lo + (h << s), side="left"))
                   if lo + (h << s) <= I32MAX else QR for h in range(nb)]
            tab.append(QR)
            for r in range(C):
                if not live[b, r]:
                    continue
                dd = min(int(d_all[b, r]), nd1 - 1)
                off, n = c["doc_off"][dd], min(c["doc_len"][dd], RMAX)
                for j in range(n):
                    ri = min(off + j, GR - 1)
                    rs, re = c["flat_start"][ri], c["flat_end"][ri]
                    h = 0 if rs < lo else min((rs - lo) >> s, nb - 1)
                    a, e = tab[h], tab[h + 1]
                    k = a + bisect.bisect_left(qe[a:e].tolist(), rs)
                    # the bracket holds the lower bound itself
                    assert k == np.searchsorted(qe, rs, side="left")
                    if k < QR and qs[k] <= re:
                        out[b, r] |= 1 << g
                        break
    return torch.from_numpy(out.astype(np.int32))


def _two_count_vs_one_search(q, rs, re):
    """#(qs <= re) > #(qe < rs) against k < QR and qs[k] <= re."""
    qs, qe = q[:, 0], q[:, 1]
    k = np.searchsorted(qe, rs, side="left")
    one = (k < len(qe)) & (qs[np.minimum(k, len(qe) - 1)] <= re)
    two = np.searchsorted(qs, re, side="right") > k
    return one, two


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1),
       QR=st.sampled_from([1, 2, 16, 64, 1024]),
       pad=st.integers(0, 8), touch=st.booleans())
def test_one_search_equals_two_counts(seed, QR, pad, touch):
    """On sorted, disjoint covers padded with INT32_MAX rows, ranges
    anywhere (touching a cover range's ends, re = INT32_MAX): the one
    search gives the two counts' verdict."""
    rng = np.random.default_rng(seed)
    k = max(1, QR - pad) if QR > 1 else 1
    cuts = np.sort(rng.choice(1 << 24, size=2 * k, replace=False))
    q = np.full((QR, 2), I32MAX, np.int64)
    q[:k] = cuts.reshape(k, 2)
    n = 500
    rs = rng.integers(0, (1 << 24) + 10, size=n)
    re = rs + rng.integers(0, 1 << 12, size=n)
    if touch:
        e = q[:k].reshape(-1)
        pick = rng.integers(0, len(e), size=n // 2)
        rs[:n // 2] = e[pick]
        re[:n // 2] = e[pick] + rng.integers(0, 2, size=n // 2)
    re[rng.random(n) < 0.05] = I32MAX
    rs[rng.random(n) < 0.02] = I32MAX
    re = np.maximum(re, rs)
    one, two = _two_count_vs_one_search(q, rs, re)
    np.testing.assert_array_equal(one, two)


@pytest.mark.parametrize("case", ["random", "qr1", "qr1024", "all_real",
                                  "past_rmax", "no_base", "wide"])
def test_geo_tiles_match_plain_version(case):
    kw = {"qr1": {"QR": 1, "n_real": 1}, "qr1024": {"QR": 1024},
          "all_real": {"QR": 64, "n_real": 64},
          "past_rmax": {"RMAX": 4, "max_ranges": 12},
          "no_base": {"base": False},
          "wide": {"B": 2, "C": 3000, "QR": 256, "nd": 2000}}.get(case, {})
    a = geo_case(17 + len(case), **kw)
    want = kernels._geo_leaves_plain(*a)
    got = emulate_geo_leaves(*a)
    assert torch.equal(got, want)
    assert torch.equal(kernels.geo_leaves(*a), want)
    assert 0 < int((want != 0).sum()) < int((a[3] != SENTINEL).sum())


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1),
       QR=st.sampled_from([1, 16, 64, 1024]),
       RMAX=st.sampled_from([1, 4, 16]), base=st.booleans())
def test_geo_bucket_search_equals_plain_version(seed, QR, RMAX, base):
    a = geo_case(seed, B=2, C=120, QR=QR, RMAX=RMAX, nd=150, base=base)
    assert torch.equal(emulate_geo_leaves(*a), kernels._geo_leaves_plain(*a))


def test_geo_pairs_are_built_where_the_column_is_uploaded():
    """The int2 pairs the kernel gathers (span: doc_off, doc_len; flat:
    flat_start, flat_end) are part of the geo column wherever it reaches
    the device: a DeviceSegment's upload and the mesh's stacked shards."""
    from xapiand_tpu_torch.database import Database
    from xapiand_tpu_torch.models.segment import DeviceSegment
    from xapiand_tpu_torch.parallel.mesh import make_mesh
    from xapiand_tpu_torch.parallel.sharded import (pad_uniform,
                                                    shard_view,
                                                    stack_segments)

    segs = []
    for n in (20, 33):
        db = Database(device="cpu")
        for i in range(n):
            db.index_document({"loc": {"_point": {
                "_latitude": 10 + i * 0.1, "_longitude": 20.0 - i * 0.05}}},
                doc_id=f"d{i}")
        db.commit()
        segs.append(db._searchers[0].segment)
    trees = [DeviceSegment(s, torch.device("cpu")).arrays for s in segs]
    stacked = stack_segments(pad_uniform(segs), make_mesh(2, devices="cpu"))
    trees += [shard_view(stacked, k) for k in range(2)]
    for tree in trees:
        assert tree["geo"]
        for col in tree["geo"].values():
            assert torch.equal(col["span"], torch.stack(
                (col["doc_off"], col["doc_len"]), 1))
            assert torch.equal(col["flat"], torch.stack(
                (col["flat_start"], col["flat_end"]), 1))
            assert col["span"].is_contiguous()
            assert col["flat"].is_contiguous()


def test_geo_leaves_plain_version_reads_the_four_channels():
    """On CPU tensors the wrapper's plain version reads the four channels
    (the JAX package's layout), with the pairs or without; the card's
    refusal of a column without them is in tests/test_torch_cuda.py."""
    cols, specs, queries, docids, base = geo_case(4)
    bare = [{k: v for k, v in cols[0].items() if k not in ("span", "flat")}]
    want = kernels._geo_leaves_plain(cols, specs, queries, docids, base)
    assert torch.equal(kernels.geo_leaves(bare, specs, queries, docids,
                                          base), want)


@pytest.mark.parametrize("case", ["qr1", "qr1024", "past_rmax", "no_base"])
def test_geo_tiles_match_jax(case):
    """The emulation's verdicts are JAX's _gather_geo_leaves' per row."""
    import types

    import jax.numpy as jnp

    import xapiand_tpu.ops.executor as jex

    kw = {"qr1": {"QR": 1, "n_real": 1}, "qr1024": {"QR": 1024},
          "past_rmax": {"RMAX": 4, "max_ranges": 12},
          "no_base": {"base": False}}[case]
    cols, specs, queries, docids, base = geo_case(5 + len(case), **kw)
    got = emulate_geo_leaves(cols, specs, queries, docids, base)
    live = base if base is not None else docids != SENTINEL
    seg = {"geo": {101: {k: jnp.asarray(v.numpy())
                         for k, v in cols[0].items()}}}
    cfg = types.SimpleNamespace(geo_specs=specs)
    for b in range(docids.shape[0]):
        want = jex._gather_geo_leaves(seg, cfg, [jnp.asarray(
            queries[0][b].numpy())], jnp.asarray(docids[b].numpy()))[0]
        want = np.asarray(want) & live[b].numpy()
        np.testing.assert_array_equal(got[b].numpy() == 1, want)
