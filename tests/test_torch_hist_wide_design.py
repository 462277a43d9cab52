"""The decompositions the redesigned agg_hist (K17c-3) and wide_topk (K4+K8
wide) kernels rely on, held on the CPU against their plain versions and
JAX. JAX is imported inside the tests that run it, so
tests/test_torch_cuda.py takes the cases and emulations from here.

  agg_hist   csrc/agg_hist.cu, one launch a call: G blocks a query of
             kernels.row_plan (at HIST_FILL, or HIST2_FILL for hist2) walk
             the query's rows by common.cuh warp_row_queue (the emulation
             takes tests/test_torch_metrics_ranges_design.py's queues);
             every eligible row is drained once, its bin
             clip(floor((v - lo) * scale), 0, nbins - 1) in float32 (a NaN
             in bin 0). The top level counts into a block's histogram;
             one block writes the output, else each block adds its nonzero
             bins into a zero-kept scratch and the last block (whichever
             that is) writes the output from it and leaves it zero. hist2
             (codes, member) adds into the zero-kept scratch, then every
             block converts its share after a grid barrier, or by float
             atomics into a zeroed output. The emulation's counts equal
             _agg_hist_plain's and JAX's _value_hist and hist2 einsum
             (ops/aggs.py 52-59, 141-153) exactly, NaN, +-inf and
             out-of-range values, codes out of range and no eligible row
             included, and the scratch is zero after every call.
  wide_topk  csrc/wide_topk.cu: T tiles a query (kernels.wide_plan); each
             tile's candidates (topk_rows: owner rows whose score is not
             NaN; sort_topk: every row) read once into a list with their
             first key word; radix passes over the rows still tied - the
             highest 8-bit digit position the tied rows do not all share,
             the digit where the running count reaches the number still
             wanted, the rows below it in, above it out, on it tied with
             their next digits (or next word, computed once) - until the
             tied rows are exactly the number wanted; the in-rows sorted;
             the tiles' sorted lists merged by ranks (binary searches in
             the others; keys are unique). The emulation's answers equal
             _topk_rows_plain's and _sort_topk_plain's bit for bit, and
             JAX's lax.sort of the same keys: deep ties (every key word
             shared by many rows), keys of more than 32 words, k at or past
             the candidates, NaN scores, several tiles a query.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_torch_metrics_ranges_design import warp_queues
from xapiand_tpu_torch.ops import kernels

SENTINEL = kernels.SENTINEL
I32MAX = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# agg_hist
# --------------------------------------------------------------------------

def hist_case(seed, B, R, nbins=2048, mode="one", nb=1, nd=None,
              p_elig=0.5):
    """One agg_hist call's inputs, made with numpy from the seed: ids past
    the column (clamped), a value column with NaN, +-inf, values far below
    lo and past the last bin, absent docs; params (lo, scale) a query (a
    power-of-two scale); codes with -1 and codes past nb (mode "codes"),
    or a member matrix (mode "member"). -> (args, kw) of kernels.agg_hist."""
    g = np.random.Generator(np.random.PCG64(seed))
    nd = nd or 2 * R + 5
    ids = g.integers(0, nd + 3, (B, R)).astype(np.int32)
    elig = g.random((B, R)) < p_elig
    fval = (g.random(nd) * 120 - 10).astype(np.float32)
    special = g.random(nd)
    fval[special < 0.02] = np.nan
    fval[(special >= 0.02) & (special < 0.03)] = np.inf
    fval[(special >= 0.03) & (special < 0.04)] = -np.inf
    fval[(special >= 0.04) & (special < 0.06)] = 3e9
    fval[(special >= 0.06) & (special < 0.08)] = -3e9
    present = g.random(nd) < 0.9
    lo = g.uniform(-5, 5, B)
    scale = 2.0 ** g.integers(-1, 6, B)
    params = np.stack([lo, scale], 1).astype(np.float32)
    kw = {}
    if mode == "codes":
        kw["codes"] = torch.from_numpy(
            g.integers(-2, nb + 2, (B, R)).astype(np.int32))
        kw["nb"] = nb
    elif mode == "member":
        kw["member"] = torch.from_numpy(g.random((B, R, nb)) < 0.3)
        kw["nb"] = nb
    args = (torch.from_numpy(ids), torch.from_numpy(elig),
            torch.from_numpy(fval), torch.from_numpy(present),
            torch.from_numpy(params), nbins)
    return args, kw


def value_bin(v, lo, scale, nbins):
    """csrc/agg_hist.cu value_bin in float32: NaN in bin 0."""
    f = np.floor((v - np.float32(lo)) * np.float32(scale))
    f = np.where(np.isnan(f), 0, f)
    return np.clip(f, 0, nbins - 1).astype(np.int64)


def emulate_agg_hist(ids, elig, fval, present, params, nbins, codes=None,
                     member=None, nb=1, order_seed=0):
    """csrc/agg_hist.cu's walk: -> (f32[B,nb,nbins], the scratch after the
    call, every (query, row) drained). The blocks of a query end in an
    order drawn from order_seed: the last to end converts (the top
    level)."""
    B, R = ids.shape
    if member is not None:
        nb = member.shape[2]
    mode = 0 if codes is None and member is None else \
        (1 if codes is not None else 2)
    G, gpw = kernels.row_plan(
        B, R, fill=kernels.HIST_FILL if mode == 0 else kernels.HIST2_FILL)
    flout = mode > 0 and kernels.HIST2_FLOAT and R < 2**24
    ids_n, elig_n = ids.numpy(), elig.numpy()
    fv, pr, pa = fval.numpy(), present.numpy(), params.numpy()
    n = fv.shape[0]
    scr = np.zeros(B * nb * nbins, np.int64)
    out = np.zeros((B, nb, nbins), np.float32)
    drained = []
    rng = np.random.Generator(np.random.PCG64(order_seed))
    for b in range(B):
        lo, scale = pa[b]
        adds = []   # each block's nonzero bins (the top level)
        for warps in warp_queues(elig_n[b], b, R, G, gpw):
            h = np.zeros(nbins, np.int64)
            for q in warps:   # a warp's queue, drained in order
                drained += [(b, int(r)) for r in q]
                d = np.minimum(ids_n[b, q], n - 1)
                ok = pr[d]
                rows, d = q[ok], d[ok]
                bins = value_bin(fv[d], lo, scale, nbins)
                if mode == 0:
                    np.add.at(h, bins, 1)
                    continue
                if mode == 1:
                    c = codes.numpy()[b, rows]
                    keep = (c >= 0) & (c < nb)
                    j, bb = c[keep], bins[keep]
                else:
                    m = member.numpy()[b, rows]
                    rr, j = np.nonzero(m)
                    bb = bins[rr]
                flat = (b * nb + j) * nbins + bb
                if flout:
                    np.add.at(out.reshape(-1), flat, np.float32(1))
                else:
                    np.add.at(scr, flat, 1)
            adds.append(h)
        if mode == 0:
            if G == 1:
                out[b, 0] = adds[0]
                continue
            sq = scr[b * nbins:(b + 1) * nbins]
            for g in rng.permutation(G):   # the blocks' atomics, any order
                sq += adds[g]
            out[b, 0] = sq          # the last block's conversion
            sq[:] = 0
    if mode > 0 and not flout:
        # the grid barrier, then each block's share converted and zeroed
        for lo_i in range(0, B * nb * nbins, G * B * 256):
            sl = slice(lo_i, lo_i + G * B * 256)
            out.reshape(-1)[sl] = scr[sl]
            scr[sl] = 0
    return torch.from_numpy(out), scr, drained


def jax_hist(ids, elig, fval, present, params, nbins, codes=None,
             member=None, nb=1):
    """JAX: _value_hist (ops/aggs.py 52-59) a query, or the hist2 einsum of
    _sub_stats_bucketed (141-153) of the bucket membership (masked by
    presence, as bf is) by the value's one-hot bin."""
    import jax.numpy as jnp

    from xapiand_tpu.ops.aggs import _value_hist

    B, R = ids.shape
    n = fval.shape[0]
    out = []
    for b in range(B):
        d = np.minimum(ids[b].numpy(), n - 1)
        v = jnp.asarray(fval.numpy()[d])
        m = jnp.asarray(elig[b].numpy() & present.numpy()[d])
        lo, scale = (jnp.float32(x) for x in params[b].numpy())
        if codes is None and member is None:
            out.append(np.asarray(_value_hist(v, m, lo, scale, nbins))[None])
            continue
        if member is not None:
            bf = jnp.asarray(member[b].numpy()) & m[:, None]
        else:
            c = jnp.asarray(codes[b].numpy())
            bf = (c[:, None] == jnp.arange(nb)[None, :]) & m[:, None]
        bf = bf.astype(jnp.float32)
        vb = jnp.clip(jnp.floor((v - lo) * scale).astype(jnp.int32), 0,
                      nbins - 1)
        voh = (vb[:, None] == jnp.arange(nbins)[None, :]).astype(jnp.float32)
        out.append(np.asarray(jnp.einsum("rb,rk->bk", bf, voh,
                                         preferred_element_type=jnp.float32)))
    return np.stack(out)


HIST_CASES = {
    # mode, B, R, nb, nbins, p_elig
    "one_b1": ("one", 1, 20011, 1, 2048, 0.5),
    "one_many_blocks": ("one", 3, 70000, 1, 2048, 0.3),
    "one_small_bins": ("one", 4, 5000, 1, 17, 0.6),
    "one_none": ("one", 2, 3000, 1, 2048, 0.0),
    "codes": ("codes", 1, 30011, 9, 2048, 0.5),
    "codes_b3": ("codes", 3, 9000, 5, 64, 0.7),
    "member": ("member", 1, 12000, 6, 2048, 0.4),
    "member_b2": ("member", 2, 7001, 3, 33, 0.5),
    "codes_none": ("codes", 2, 4000, 4, 2048, 0.0),
}


@pytest.mark.parametrize("case", sorted(HIST_CASES))
@pytest.mark.parametrize("flout", [True, False])
def test_agg_hist_walk_equals_plain(case, flout, monkeypatch):
    """The one launch's walk (every eligible row drained once, the blocks'
    atomics and the last block's or the barrier's conversion, hist2 by
    the zero-kept scratch or by float atomics) equals _agg_hist_plain
    exactly, and leaves the scratch zero."""
    monkeypatch.setattr(kernels, "HIST2_FLOAT", flout)
    mode, B, R, nb, nbins, p = HIST_CASES[case]
    args, kw = hist_case(sorted(HIST_CASES).index(case), B, R, nbins, mode, nb,
                         p_elig=p)
    got, scr, drained = emulate_agg_hist(*args, **kw)
    want = kernels._agg_hist_plain(*args, **kw)
    assert torch.equal(got, want)
    assert not scr.any()
    elig = args[1].numpy()
    assert sorted(drained) == [tuple(x) for x in np.argwhere(elig)]
    if p:
        assert want.sum() > 0


@pytest.mark.parametrize("case", ["one_b1", "one_small_bins", "codes_b3",
                                  "member_b2", "codes_none"])
def test_agg_hist_equals_jax(case):
    """The plain version and the emulation against JAX's _value_hist and
    hist2 einsum, exactly (NaN values in bin 0 as JAX's int32 conversion
    gives them)."""
    mode, B, R, nb, nbins, p = HIST_CASES[case]
    args, kw = hist_case(sorted(HIST_CASES).index(case) + 50, B, R, nbins, mode, nb,
                         p_elig=p)
    want = jax_hist(*args, **kw)
    got = kernels.agg_hist(*args, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(emulate_agg_hist(*args, **kw)[0].numpy(),
                                  want)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(B=st.integers(1, 5), R=st.integers(1, 9000),
       fill=st.sampled_from([1, 33, 66, 132, 528]),
       seed=st.integers(0, 10**6))
def test_agg_hist_blocks_any_fill(B, R, fill, seed):
    """Whatever row_plan's fill gives (one block, many, blocks of 16 rows),
    the top level's blocks and their last block's conversion count every
    eligible row once."""
    args, kw = hist_case(seed, B, R, 64, "one")
    saved = kernels.HIST_FILL
    kernels.HIST_FILL = fill
    try:
        got, scr, _ = emulate_agg_hist(*args, **kw, order_seed=seed)
    finally:
        kernels.HIST_FILL = saved
    assert torch.equal(got, kernels._agg_hist_plain(*args, **kw))
    assert not scr.any()


def test_value_bins_nan_and_out_of_range():
    """value_bins: NaN in bin 0, -inf and far below lo in 0, +inf and past
    the last bin in nbins - 1 (JAX's floor, int32 conversion, clip)."""
    v = torch.tensor([[float("nan"), 1e30, -1e30, float("inf"),
                       float("-inf"), 3.7, 2047.5, 2048.0]])
    got = kernels.value_bins(v, torch.tensor([[0.0, 1.0]]), 2048)
    assert got.tolist() == [[0, 2047, 0, 2047, 0, 3, 2047, 2047]]


def test_hist_plans_at_the_database_shapes():
    """row_plan at the Database path's widest captured launches: the top
    level B1 R82048 and hist2 B1 R65664 fill the card's SMs at least
    halfway, every block at least one 16-row group a warp."""
    for R, fill in ((82048, kernels.HIST_FILL), (65664, kernels.HIST2_FILL)):
        G, gpw = kernels.row_plan(1, R, fill=fill)
        assert G >= min(fill, 66) and 1 <= gpw <= 32
        assert G * kernels.AGG_WARPS * gpw * 16 >= R


# --------------------------------------------------------------------------
# wide_topk
# --------------------------------------------------------------------------

def rows_words(scores, ids, owner, tie=None):
    """topk_rows' keys (csrc/wide_topk.cu RowSrc): -> (candidates bool
    [B,R], words uint32 [B,R,nw]): ~monotone(score), [tie,] docid."""
    s = scores.numpy()
    u = s.view(np.uint32)
    mono = np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000))
    ws = [~mono]
    if tie is not None:
        ws.append(tie.numpy().view(np.uint32))
    ws.append(ids.numpy().view(np.uint32))
    return owner.numpy() & ~np.isnan(s), np.stack(ws, 2).astype(np.uint32)


def sort_words(specs, ids, sums, elig, values, targets=None, strtabs=None,
               remaps=None):
    """sort_topk's keys (row_key's words): every row a candidate; the
    specs' words, the masked docid, the row index."""
    cols = [values.get(s[1]) if s[0] not in ("score", "docid") else None
            for s in specs]
    keys = kernels.sort_words(specs, cols, ids, sums, elig, targets,
                              strtabs or {}, remaps)
    B, C = ids.shape
    w = np.stack([k.numpy() for k in keys] +
                 [np.broadcast_to(np.arange(C), (B, C))], 2)
    return np.ones((B, C), bool), w.astype(np.uint32)


def emulate_tile(words, k):
    """One tile's radix passes (csrc/wide_topk.cu wide_tile) over its
    candidates' key words uint32 [n, nw]: -> (the in-rows, indices into
    words, sorted by key; the passes taken)."""
    n, nw = words.shape
    tied = np.arange(n)
    x = words[:, 0].copy()       # each row's current word
    ins, want, w, top, passes = [], k, 0, 3, 0
    while True:
        passes += 1
        ns = tied.size
        if ns <= want:
            ins.append(tied)
            break
        xt = x[tied]
        q = next((qq for qq in range(top, -1, -1)
                  if np.bincount((xt >> (8 * qq)) & 255,
                                 minlength=256).max() < ns), None)
        if q is None:            # the tied rows share word w
            w += 1
            top = 3
            x[tied] = words[tied, w]
            continue
        dig = (xt >> (8 * q)) & 255
        h = np.bincount(dig, minlength=256)
        cum = np.cumsum(h)
        d = int(np.argmax(cum >= want))
        want -= int(cum[d] - h[d])
        ins.append(tied[dig < d])
        on = tied[dig == d]
        if h[d] == want:         # the digit's rows all in
            ins.append(on)
            break
        tied = on
        if q == 0:
            w += 1
            top = 3
            x[tied] = words[tied, w]
        else:
            top = q - 1
    sel = np.concatenate(ins)
    order = sorted(sel.tolist(), key=lambda i: tuple(words[i]))
    return np.array(order, dtype=np.int64), passes


def emulate_wide(cand, words, k, plan=None):
    """wide_topk over every query: the tiles of kernels.wide_plan (or
    plan), each tile's sorted in-rows, the merge by ranks. -> ([B][<= k]
    row indices in answer order, the most passes of a tile)."""
    B, R, nw = words.shape
    T, TR, kk, _f, _p = plan or kernels.wide_plan(B, R, k, nw)
    out, most = [], 0
    for b in range(B):
        lists = []
        for t in range(T):
            rows = np.arange(t * TR, min(R, t * TR + TR))
            rows = rows[cand[b, rows]]
            sel, passes = emulate_tile(words[b, rows], k)
            most = max(most, passes)
            assert sel.size == min(k, rows.size) <= kk
            lists.append([tuple(words[b, r]) for r in rows[sel]])
        ans = [None] * min(k, sum(len(x) for x in lists))
        for t, lst in enumerate(lists):
            for i, key in enumerate(lst):
                rank = i + sum(_count_lt(o, key)
                               for t2, o in enumerate(lists) if t2 != t)
                if rank < k:
                    assert ans[rank] is None
                    ans[rank] = key
        out.append(ans)
    return out, most


def _count_lt(lst, key):
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) // 2
        if lst[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def decode_rows(keys, k):
    """topk_rows' answer from the keys in order: docids (SENTINEL past the
    owners and where the score is not finite) and scores (-inf past)."""
    d = np.full(k, SENTINEL, np.int32)
    s = np.full(k, -np.inf, np.float32)
    for j, key in enumerate(keys):
        mono = np.uint32(~np.uint32(key[0]))
        bits = np.uint32(mono & 0x7fffffff) if mono & 0x80000000 \
            else np.uint32(~mono)
        s[j] = np.array([bits], np.uint32).view(np.float32)[0]
        d[j] = np.uint32(key[-1]).view(np.int32) if np.isfinite(s[j]) \
            else SENTINEL
    return d, s


def decode_sort(keys, k, ids, sums, elig, nu):
    """sort_topk's answer (docids, scores, emitted words) from the keys in
    order (the last word the row index)."""
    d = np.full(k, SENTINEL, np.int32)
    s = np.full(k, -np.inf, np.float32)
    kw = np.full((k, nu), 0xFFFFFFFF, np.uint32)
    for j, key in enumerate(keys):
        r = int(key[-1])
        if elig[r]:
            d[j], s[j] = ids[r], sums[r]
        kw[j] = key[:nu]
    return d, s, kw.view(np.int32)


def wide_rows_case(case, B, R, seed, tie=False):
    """topk_rows inputs for the wide mode: uniform scores, deep ties (few
    distinct scores, equal ties), NaN / +-inf rows, few owners."""
    g = np.random.Generator(np.random.PCG64(seed))
    ids = np.stack([g.permutation(2 * R + 7)[:R] for _ in range(B)])
    own = g.random((B, R)) < 0.6
    if case == "uniform":
        s = g.random((B, R))
    elif case == "deep":
        s = g.integers(0, 3, (B, R)) / 2
    elif case == "special":
        s = g.integers(0, 12, (B, R)) / 4
        s[g.random((B, R)) < 0.05] = np.nan
        s[g.random((B, R)) < 0.05] = -np.inf
        s[g.random((B, R)) < 0.02] = np.inf
    else:   # few owners
        s = g.random((B, R))
        own = g.random((B, R)) < 20.0 / max(R, 1)
    t = torch.from_numpy(g.integers(0, 3, (B, R)).astype(np.int32)) \
        if tie else None
    return (torch.from_numpy(s.astype(np.float32)),
            torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(own), t)


def wide_rows_answer(scores, ids, owner, k, tie=None, plan=None):
    cand, words = rows_words(scores, ids, owner, tie)
    keys, _ = emulate_wide(cand, words, k, plan)
    dd, ss = zip(*(decode_rows(kq, k) for kq in keys))
    return torch.from_numpy(np.stack(dd)), torch.from_numpy(np.stack(ss))


def _same(got, want):
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def small_tiles(monkeypatch, tile=512, merge=1 << 20):
    """wide_plan at tiles of a few hundred rows (several a query at the
    tests' sizes)."""
    monkeypatch.setattr(kernels, "WIDE_TILE_MIN", tile)
    monkeypatch.setattr(kernels, "WIDE_MERGE", merge)


@pytest.mark.parametrize("case", ["uniform", "deep", "special", "few"])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k", [300, 700, 5000])
def test_wide_rows_tiles_equal_plain(case, tie, k, monkeypatch):
    """topk_rows' wide mode emulated over several tiles a query, and over
    one: the answer equals _topk_rows_plain bit for bit (k past the
    candidates at 5000: every candidate, then SENTINEL and -inf)."""
    args = wide_rows_case(case, 3, 4000, k + len(case), tie)
    want = kernels._topk_rows_plain(*args[:3], k, args[3])
    _same(wide_rows_answer(*args[:3], k, args[3]), want)
    small_tiles(monkeypatch)
    plan = kernels.wide_plan(3, 4000, k, 3 if tie else 2)
    assert plan[0] > 1
    _same(wide_rows_answer(*args[:3], k, args[3]), want)


def jax_rows(scores, ids, owner, k, tie=None):
    """JAX: lax.sort of (-score, tie, docid) over the owner rows whose
    score is not NaN (the rest -inf, SENTINEL), the first k, a docid
    SENTINEL where its score is not finite (executor.py _rank_and_topk's
    order)."""
    import jax.numpy as jnp
    from jax import lax

    s, d, o = (jnp.asarray(x.numpy()) for x in (scores, ids, owner))
    o = o & ~jnp.isnan(s)
    ms = jnp.where(o, s, -jnp.inf)
    md = jnp.where(o, d, SENTINEL)
    mt = jnp.where(o, jnp.asarray(tie.numpy()), I32MAX) if tie is not None \
        else jnp.zeros_like(md)
    ns, _t, dd, vv = lax.sort((-ms, mt, md, ms), num_keys=3)
    kk = min(k, s.shape[1])
    dd, vv = np.asarray(dd[:, :kk]), np.asarray(vv[:, :kk])
    dd = np.where(np.isfinite(vv), dd, SENTINEL)
    pad = ((0, 0), (0, k - kk))
    return (np.pad(dd, pad, constant_values=SENTINEL),
            np.pad(vv, pad, constant_values=-np.inf))


@pytest.mark.parametrize("case,tie", [("uniform", False), ("deep", True),
                                      ("special", False)])
def test_wide_rows_equal_jax(case, tie, monkeypatch):
    """The emulation over several tiles against JAX's lax.sort of the same
    rows, k 300 and k past the candidates."""
    small_tiles(monkeypatch, tile=256)
    args = wide_rows_case(case, 2, 1500, 9, tie)
    for k in (300, 2000):
        got = wide_rows_answer(*args[:3], k, args[3])
        want = jax_rows(*args[:3], k, args[3])
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        assert got[1].numpy().tobytes() == \
            want[1].astype(np.float32).tobytes()


def table_world(B, R, n_keys, seed, p_elig=0.7):
    """wide_table_phase's world at a small size: 8 value columns of 2-7
    distinct values (ties run deep), n_keys value keys over them."""
    g = np.random.Generator(np.random.PCG64(seed))
    nd = 2 * R
    ids = np.stack([g.permutation(nd)[:R] for _ in range(B)])
    sums = (g.integers(0, 40, (B, R)) / 8).astype(np.float32)
    elig = g.random((B, R)) < p_elig
    values = {}
    for c in range(8):
        v = g.integers(0, 2 + c % 6, nd + 1).astype(np.int32)
        values[c] = {"hi": torch.from_numpy(v),
                     "lo": torch.from_numpy(v * 3 - 1),
                     "present": torch.from_numpy(g.random(nd + 1) < 0.95)}
    specs = tuple(("value", i % 8, bool(i % 3)) for i in range(n_keys))
    return specs, (torch.from_numpy(ids.astype(np.int32)),
                   torch.from_numpy(sums), torch.from_numpy(elig)), values


def wide_sort_answer(specs, ids, sums, elig, k, values, targets=None,
                     strtabs=None, remaps=None):
    cand, words = sort_words(specs, ids, sums, elig, values, targets,
                             strtabs, remaps)
    keys, most = emulate_wide(cand, words, k)
    nu = words.shape[2] - 2
    out = [decode_sort(kq, k, ids[b].numpy(), sums[b].numpy(),
                       elig[b].numpy(), nu) for b, kq in enumerate(keys)]
    return tuple(torch.from_numpy(np.stack(x)) for x in zip(*out)), most


@pytest.mark.parametrize("n_keys,k", [(1, 80), (20, 10), (40, 10), (3, 700)])
@pytest.mark.parametrize("tiles", [False, True])
def test_wide_sort_equals_plain(n_keys, k, tiles, monkeypatch):
    """sort_topk's wide mode emulated (more than 32 key words at 20 and 40
    keys: 42 and 82 words, ties deep through every repeated column; k past
    the eligible rows at 700) equals _sort_topk_plain bit for bit, emitted
    key words included, over one tile a query and over several."""
    if tiles:
        small_tiles(monkeypatch, tile=300)
    specs, (ids, sums, elig), values = table_world(2, 1200, n_keys, n_keys)
    got, _ = wide_sort_answer(specs, ids, sums, elig, k, values)
    cols = [values[s[1]] for s in specs]
    want = kernels._sort_topk_plain(specs, cols, ids, sums, elig, k, None,
                                    {}, None, True)
    _same(got, want)


def test_wide_sort_deep_ties_skip_shared_words():
    """A tile whose tied rows share word after word (the repeated columns)
    takes a pass a shared word, not four: the passes stay below 2 a key
    word plus the words of the columns that tell the rows apart."""
    specs, (ids, sums, elig), values = table_world(1, 3000, 40, 5)
    _got, most = wide_sort_answer(specs, ids, sums, elig, 10, values)
    assert most < 2 * (2 * 40 + 2)


@pytest.mark.parametrize("case", ["keys5", "strmetric", "nan", "ties"])
def test_wide_sort_kinds_equal_plain(case, monkeypatch):
    """Every key kind through the wide mode (k 80 past sort_topk's lists):
    value, score, dist, geodist, strmetric with the mesh's remap, NaN
    scores, first words that tie."""
    from test_torch_sort_design import SPECS, sort_world

    small_tiles(monkeypatch, tile=128)
    specs = {"keys5": SPECS[6], "strmetric": SPECS[4], "nan": SPECS[5],
             "ties": SPECS[3]}[case]
    world = sort_world(specs, 3, 700, 11, "nan" if case == "nan" else
                       "ties" if case == "ties" else "uniform",
                       remap=case == "strmetric")
    ids, sums, elig, values, targets, strtabs, remaps = world
    got, _ = wide_sort_answer(specs, ids, sums, elig, 80, values, targets,
                              strtabs, remaps)
    cols = [values.get(s[1]) if s[0] not in ("score", "docid") else None
            for s in specs]
    want = kernels._sort_topk_plain(specs, cols, ids, sums, elig, 80,
                                    targets, strtabs, remaps, True)
    _same(got, want)


def test_wide_sort_equals_jax():
    """The emulation of a 20-key sort (42 words) against JAX's lax.sort of
    the same key words and the row index."""
    import jax.numpy as jnp
    from jax import lax

    specs, (ids, sums, elig), values = table_world(2, 600, 20, 3)
    got, _ = wide_sort_answer(specs, ids, sums, elig, 10, values)
    _cand, words = sort_words(specs, ids, sums, elig, values)
    ops = tuple(jnp.asarray(words[:, :, i]) for i in range(words.shape[2]))
    srt = lax.sort(ops, num_keys=len(ops))
    row = np.asarray(srt[-1][:, :10])
    want_d = np.where(np.take_along_axis(elig.numpy(), row, 1),
                      np.take_along_axis(ids.numpy(), row, 1), SENTINEL)
    np.testing.assert_array_equal(got[0].numpy(), want_d)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(B=st.integers(1, 300), R=st.integers(1, 3_000_000),
       k=st.integers(1, 20000), nw=st.integers(2, 90))
def test_wide_plan_invariants(B, R, k, nw):
    """wide_plan: the tiles cover the rows, B x T within WIDE_BLOCKS where
    a query has several, the merge's lists within its shared memory, each
    buffer in shared memory only where it fits."""
    T, TR, kk, flags, per_block = kernels.wide_plan(B, R, k, nw)
    assert T >= 1 and T * TR >= R and (T - 1) * TR < R
    assert kk == min(k, TR)
    if T > 1:
        assert B * T <= kernels.WIDE_BLOCKS
        assert T * k <= kernels.WIDE_MERGE
        assert T * kk * nw * 4 <= kernels.WIDE_SMEM
    glists, gin, gsort = flags & 1, flags & 2, flags & 4
    P = 1 << (kk - 1).bit_length()
    smem = (0 if glists else 16 * TR) + (0 if gin else 4 * kk)
    assert smem <= kernels.WIDE_SMEM
    assert gsort or (not glists and P * nw * 4 <= 16 * TR)
    assert per_block % 2 == 0


def test_wide_plan_at_the_main_paths_shapes():
    """The REST mesh's page of 300 (B1 R32896) and sorted collapse of k 80,
    and the key-word table's sort (B4 R262144, 82 words): several tiles a
    query, every buffer in shared memory."""
    for B, R, k, nw in ((1, 32896, 300, 2), (1, 57472, 80, 4),
                        (4, 262144, 10, 82)):
        T, TR, kk, flags, per_block = kernels.wide_plan(B, R, k, nw)
        assert T > 1 and flags == 0 and per_block == 0, (B, R, k, nw)
