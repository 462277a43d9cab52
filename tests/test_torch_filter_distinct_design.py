"""The decompositions the redesigned filter_leaves (K7) and agg_distinct
(K17b) kernels rely on, held on the CPU against their plain versions and
JAX. JAX is imported inside the tests that run it, so
tests/test_torch_cuda.py takes the cases from here.

  value_arrays   models/segment.py: each value column's packed keys
                 (keys i32[n, 4]: hi, lo, max_hi, max_lo) and dense codes
                 (codes i32[n], the rank of a present doc's (hi, lo) key
                 among the column's K distinct keys, -1 where absent;
                 code_hll i32[K]: each code's _hash32 register index << 5 |
                 rho, | 1 << 15 for the key (INT32_MAX, INT32_MAX)) equal
                 the channels they come from and JAX's _hash32: multi-value
                 docs (their smallest key), absent docs, the pad doc, that
                 key; built wherever a value column is uploaded (a
                 DeviceSegment, the mesh's stacked shards, whose code
                 tables pad to the widest shard's K).
  filter_leaves  csrc/filter_leaves.cu: row tiles, flags first - groups
                 of 16 rows on the flat [B, C] index (a query's rows need
                 not start on 16), a group's flags one load of base; a
                 warp's 32 groups a window whose lane l works rows 32 k +
                 l (flags by shuffle, or the docids of packed rows), the
                 tree once a lane over its 16 rows as 16-bit masks (a
                 stack of FL_STACK masks; an F leaf one gather of a row's
                 four key words; a deeper program row by row). The
                 emulation equals _filter_leaves_plain bit for bit
                 (hypothesis over shapes, leaves and trees: F 0-34,
                 multi-value columns at vmax 1-4, a slot the segment
                 lacks, PH and GEO words, base None, B 1; a 512-leaf
                 tree) and JAX's _gather_filter_leaves + _eval_tree.
  agg_distinct   csrc/agg_distinct.cu: a query's exact count is the
                 population of a K-bit set of the eligible rows' codes, its
                 HyperLogLog registers the maximum of each set code's rho
                 at its index, read from the set; the emulation (the set in
                 shared memory a block, OR'd into the query's words, or in
                 the query's words) equals _agg_distinct_plain and JAX's
                 compute_aggs cardinality: K 1, no eligible row, ids past
                 n - 1, absent docs, the left-out key, multi-value docs.
Counts, flags and registers are compared exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from xapiand_tpu_torch.models.segment import (device_segment_from_numpy,
                                              value_arrays)
from xapiand_tpu_torch.ops import kernels

I32MAX = kernels.I32MAX
I32MIN = -2**31
SENTINEL = kernels.SENTINEL
FL_STACK = 8                 # csrc/filter_leaves.cu FL_STACK
AD_SMEM_WORDS = 2048         # csrc/agg_distinct.cu AD_SMEM_WORDS
AD_SKIP = 1 << 15            # csrc/agg_distinct.cu AD_SKIP
MISSING_SLOT = 77            # a slot the columns lack


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# columns
# --------------------------------------------------------------------------

def value_case(seed, nd=300, mv=True, hi_range=12, lo_range=4):
    """A value column as models/builder.py packs one (numpy): nd docs and
    the pad doc (absent), 0-3 values a doc (0-1 without mv), a doc's smallest key
    in (hi, lo), its largest in (max_hi, max_lo), absent docs (hi, lo)
    INT32_MAX and (max_hi, max_lo) INT32_MIN; docs with >= 2 values keep
    every key in mv_*; doc 1 holds the key (INT32_MAX, INT32_MAX), doc 2
    the extremes."""
    rng = np.random.Generator(np.random.PCG64(seed))
    n = nd + 1
    nv = rng.choice(4 if mv else 2, n,
                    p=[0.15, 0.55, 0.2, 0.1] if mv else [0.15, 0.85])
    nv[-1] = 0
    if nd > 2:
        nv[1], nv[2] = 1, 2 if mv else 1
    ch = {"hi": np.full(n, I32MAX, np.int32), "lo": np.full(n, I32MAX,
                                                            np.int32),
          "max_hi": np.full(n, I32MIN, np.int32),
          "max_lo": np.full(n, I32MIN, np.int32),
          "present": nv > 0, "mv_off": np.zeros(n, np.int32),
          "mv_len": np.zeros(n, np.int32)}
    mvh, mvl = [], []
    for d in range(n):
        if not nv[d]:
            continue
        keys = [(int(rng.integers(-hi_range, hi_range)),
                 int(rng.integers(-lo_range, lo_range)))
                for _ in range(nv[d])]
        if d == 1 and nd > 1:
            keys = [(I32MAX, I32MAX)]
        if d == 2 and nd > 2:
            keys = [(I32MIN, I32MIN), (I32MAX, I32MAX - 1)][:nv[d]]
        keys = sorted(keys)     # (hi, lo) of signed ints: lex order
        ch["hi"][d], ch["lo"][d] = keys[0]
        ch["max_hi"][d], ch["max_lo"][d] = keys[-1]
        if len(keys) > 1:
            ch["mv_off"][d], ch["mv_len"][d] = len(mvh), len(keys)
            for h, lo in keys:
                mvh.append(h)
                mvl.append(lo)
    ch["present"] = nv > 0
    if mvh:
        ch["mv_hi"] = np.asarray(mvh, np.int32)
        ch["mv_lo"] = np.asarray(mvl, np.int32)
    else:
        del ch["mv_off"], ch["mv_len"]
    return ch


def torch_col(ch, packed=True):
    """The column's tensors on the CPU, with value_arrays (packed) or as a
    JAX tree carries it (without)."""
    arr = dict(ch)
    if packed:
        arr.update(value_arrays(ch))
    return device_segment_from_numpy(arr, torch.device("cpu"))


def hash32_int(hi, lo):
    """ops/aggs.py _hash32 of one key, in Python integers."""
    M = 0xFFFFFFFF
    h = (int(hi) & M) ^ (((int(lo) & M) * 0x9E3779B9) & M)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    return h ^ (h >> 16)


# --------------------------------------------------------------------------
# value_arrays
# --------------------------------------------------------------------------

def check_value_arrays(ch, va):
    """keys, codes and code_hll of one column against its channels."""
    hi, lo, present = ch["hi"], ch["lo"], ch["present"]
    want = np.stack((hi, lo, ch["max_hi"], ch["max_lo"]), 1)
    want[~present] = (I32MAX, I32MAX, I32MIN, I32MIN)   # an empty interval
    np.testing.assert_array_equal(va["keys"], want)
    assert va["keys"].dtype == np.int32 and va["keys"].flags.c_contiguous
    codes, hll = va["codes"], va["code_hll"]
    assert codes.dtype == np.int32 and hll.dtype == np.int32
    np.testing.assert_array_equal(codes >= 0, present)
    keys = {(int(h), int(x)) for h, x, p in zip(hi, lo, present) if p}
    assert hll.shape == (len(keys),)
    # a code a distinct key: equal codes iff equal keys, every code used
    by_code: dict = {}
    for h, x, c in zip(hi[present], lo[present], codes[present]):
        assert by_code.setdefault(int(c), (int(h), int(x))) == (int(h),
                                                                  int(x))
    # every code used, ranked in the kernels' (signed lexicographic) order
    assert [by_code[c] for c in range(len(keys))] == sorted(keys)
    for c, (h, x) in by_code.items():
        hh = hash32_int(h, x)
        rest = (hh << 10) & 0xFFFFFFFF
        rho = 23 if rest == 0 else 32 - rest.bit_length() + 1
        want = (hh >> 22) << 5 | rho | \
            (AD_SKIP if (h, x) == (I32MAX, I32MAX) else 0)
        assert int(hll[c]) == want, (c, h, x)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mv", [False, True])
def test_value_arrays_equal_channels(seed, mv):
    ch = value_case(seed, nd=200, mv=mv)
    assert ch["present"][1] and (ch["hi"][1], ch["lo"][1]) == (I32MAX,
                                                                I32MAX)
    check_value_arrays(ch, value_arrays(ch))


def test_value_arrays_refuse_a_present_doc_past_its_max():
    """A present doc's packed keys hold min <= max, so that an absent doc's
    empty interval tells it apart: a column that breaks it is refused."""
    ch = value_case(1, nd=20)
    d = int(np.flatnonzero(ch["present"])[3])
    ch["max_hi"][d] = ch["hi"][d] - 1
    with pytest.raises(ValueError, match="smallest key passes"):
        value_arrays(ch)


def test_value_arrays_of_an_empty_column():
    ch = value_case(0, nd=5)
    ch["present"][:] = False
    va = value_arrays(ch)
    assert va["code_hll"].shape == (0,) and (va["codes"] == -1).all()


def test_code_hll_equals_jax_hash32():
    """code_hll's register index and rho are JAX's _hash32 and lax.clz's of
    each distinct key (ops/aggs.py 40-49, 454-458)."""
    import jax.numpy as jnp
    from jax import lax

    from xapiand_tpu.ops.aggs import _hash32

    ch = value_case(9, nd=400, hi_range=2**20, lo_range=2**30)
    va = value_arrays(ch)
    p = ch["present"]
    hh = _hash32(jnp.asarray(ch["hi"][p]), jnp.asarray(ch["lo"][p]))
    idx = np.asarray(hh >> jnp.uint32(22)).astype(np.int64)
    rest = hh << jnp.uint32(10)
    rho = np.asarray(jnp.where(rest == 0, 23,
                               lax.clz(rest).astype(jnp.int32) + 1))
    h = va["code_hll"][va["codes"][p]]
    np.testing.assert_array_equal((h >> 5) & 1023, idx)
    np.testing.assert_array_equal(h & 31, rho)


def test_value_arrays_are_built_where_the_column_is_uploaded():
    """keys, codes and code_hll are part of every value column wherever it
    reaches the device: a DeviceSegment's upload (the Database's, with
    multi-value, absent and later-field docs) and the mesh's stacked
    shards (each shard's own codes; the code tables padded with 0 to the
    widest shard's K)."""
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
            doc = {"price": float(i % 7), "tags": [i % 5, i % 3 + 10]}
            if i % 4 == 0:
                del doc["price"]
            db.index_document(doc, doc_id=f"d{i}")
        db.commit()
        segs.append(db._searchers[0].segment)
    cpu = torch.device("cpu")
    trees = [DeviceSegment(s, cpu).arrays for s in segs]
    stacked = stack_segments(pad_uniform(segs), make_mesh(2, devices="cpu"))
    views = [shard_view(stacked, k) for k in range(2)]
    for k, tree in enumerate(trees + views):
        assert tree["values"]
        for col in tree["values"].values():
            ch = {c: col[c].numpy() for c in
                  ("hi", "lo", "max_hi", "max_lo", "present")}
            va = {c: col[c].numpy() for c in ("keys", "codes", "code_hll")}
            if k >= len(trees):
                # the pad past this shard's K is never a code
                K = int(va["codes"].max()) + 1
                assert not va["code_hll"][K:].any()
                va["code_hll"] = va["code_hll"][:K]
            check_value_arrays(ch, va)
            assert col["keys"].is_contiguous()


# --------------------------------------------------------------------------
# filter_leaves: the flags-first tile walk
# --------------------------------------------------------------------------

def run_program(prog, orbits, fleaf, ph, geo):
    """common.cuh eval_program on one row: the postfix program over a bit
    stack."""
    st_ = []
    for ins in prog:
        op, arg = ins & 0xff, ins >> 8
        if op == kernels.OP_G:
            st_.append((orbits >> arg) & 1)
        elif op == kernels.OP_F:
            st_.append(int(fleaf(arg)))
        elif op == kernels.OP_PH:
            st_.append((ph >> arg) & 1)
        elif op == kernels.OP_GEO:
            st_.append((geo >> arg) & 1)
        elif op in (kernels.OP_ALL, kernels.OP_NONE):
            st_.append(int(op == kernels.OP_ALL))
        else:
            b = st_.pop()
            a = st_.pop()
            st_.append(a & b if op == kernels.OP_AND else a | b
                       if op == kernels.OP_OR else a ^ b
                       if op == kernels.OP_XOR else a & (b ^ 1)
                       if op == kernels.OP_ANDNOT else b & (a ^ 1))
    return st_[-1]


def _lex_ge(ah, al, bh, bl):
    return ah > bh or (ah == bh and al >= bl)


def _lex_le(ah, al, bh, bl):
    return ah < bh or (ah == bh and al <= bl)


def _leaf(col, vm, p, dd, k):
    """fl_keys: the packed keys' test (present iff min <= max), then the
    multi-value scan (csrc/filter_leaves.cu fl_mv)."""
    if not (_lex_le(k[0], k[1], k[2], k[3]) and
            _lex_ge(k[2], k[3], p[0], p[1]) and
            _lex_le(k[0], k[1], p[2], p[3])):
        return False
    if vm <= 1 or "mv_hi" not in col:
        return True
    cnt = int(col["mv_len"][dd])
    if cnt <= 0:
        return True
    off, mvn = int(col["mv_off"][dd]), col["mv_hi"].shape[0]
    for j in range(min(vm, cnt)):
        vi = min(off + j, mvn - 1)
        vh, vl = int(col["mv_hi"][vi]), int(col["mv_lo"][vi])
        if _lex_ge(vh, vl, p[0], p[1]) and _lex_le(vh, vl, p[2], p[3]):
            return True
    return False


def run_masks(prog, word, fmask):
    """csrc/filter_leaves.cu's tree over a lane's 16 rows: every leaf a
    16-bit mask (word(op, arg) of a G, PH or GEO leaf, fmask(arg) of an F
    leaf), a stack of FL_STACK masks in two 64-bit words, top lowest."""
    s0 = s1 = 0
    M64 = 2**64 - 1
    for ins in prog:
        op, arg = ins & 0xff, ins >> 8
        if op == kernels.OP_F:
            x = fmask(arg)
        elif op in (kernels.OP_G, kernels.OP_PH, kernels.OP_GEO):
            x = word(op, arg)
        elif op in (kernels.OP_ALL, kernels.OP_NONE):
            x = 0xffff if op == kernels.OP_ALL else 0
        else:
            bb, a = s0 & 0xffff, (s0 >> 16) & 0xffff
            x = (a & bb if op == kernels.OP_AND else a | bb
                 if op == kernels.OP_OR else a ^ bb
                 if op == kernels.OP_XOR else a & ~bb & 0xffff
                 if op == kernels.OP_ANDNOT else bb & ~a & 0xffff)
            s0 = ((s0 >> 32) | (s1 << 32)) & M64
            s1 >>= 32
        s1 = ((s1 << 16) | (s0 >> 48)) & M64
        s0 = ((s0 << 16) | x) & M64
    return s0 & 0xffff


def emulate_filter_leaves(values, slots, vmax, fparams, docids, base,
                          orbits, prog, phbits=None, geobits=None):
    """csrc/filter_leaves.cu lane by lane: each group of 16 flat rows' flags
    first; a warp's 32 groups a window of 512 rows, lane l's rows 32 k + l
    (k = 0..15), their flags from the groups' masks (or their docids), the
    tree once over the lane's 16 rows as 16-bit masks (an F leaf the packed
    keys' test of each first row; a program deeper than FL_STACK row by
    row), the verdicts back to their rows, the count."""
    B, C = docids.shape
    F = len(slots)
    cols = [values.get(s) for s in slots]
    vmax = tuple(int(vmax[i]) if i < len(vmax) else 1 for i in range(F))
    flat = docids.reshape(-1).tolist()
    fb_ = base.reshape(-1).tolist() if base is not None else None
    words = {kernels.OP_G: orbits, kernels.OP_PH: phbits,
             kernels.OP_GEO: geobits}
    words = {op: w.reshape(-1).tolist() for op, w in words.items()
             if w is not None}
    keys = [c["keys"].tolist() if c is not None else None for c in cols]
    fp = fparams.tolist()
    need = kernels.tree_need(prog)
    elig = [0] * (B * C)
    count = [0] * B

    def leaf(b, f, row):
        c = cols[f]
        if c is None:
            return 0
        dd = min(flat[row], c["hi"].shape[0] - 1)
        return int(_leaf(c, vmax[f], fp[b][f], dd, keys[f][dd]))

    for b in range(B):
        lo, hi = b * C, b * C + C
        for gw in range(lo >> 4, (hi + 15) >> 4, 32):
            masks = []
            for g in range(gw, gw + 32):
                m = 0
                for j in range(16):
                    r = g * 16 + j
                    if base is not None and lo <= r < hi and fb_[r]:
                        m |= 1 << j
                masks.append(m)
            row0 = gw * 16
            for lane in range(32):
                rows = [row0 + 32 * k + lane for k in range(16)]
                lm = 0
                for k, r in enumerate(rows):
                    w = 32 * k + lane
                    first = (masks[w >> 4] >> (w & 15)) & 1 \
                        if base is not None else \
                        lo <= r < hi and flat[r] != SENTINEL
                    lm |= int(first) << k
                if not lm:
                    continue
                if need <= FL_STACK:
                    def word(op, arg, rows=rows, lm=lm):
                        return sum(((words[op][r] >> arg) & 1) << k
                                   for k, r in enumerate(rows)
                                   if (lm >> k) & 1)

                    def fmask(f, rows=rows, lm=lm):
                        return sum(leaf(b, f, r) << k
                                   for k, r in enumerate(rows)
                                   if (lm >> k) & 1)

                    res = run_masks(prog, word, fmask) & lm
                else:
                    res = 0
                    for k, r in enumerate(rows):
                        if (lm >> k) & 1:
                            w = {op: v[r] for op, v in words.items()}
                            res |= run_program(
                                prog, w.get(kernels.OP_G, 0),
                                lambda f, r=r: leaf(b, f, r),
                                w.get(kernels.OP_PH, 0),
                                w.get(kernels.OP_GEO, 0)) << k
                for k, r in enumerate(rows):
                    if (res >> k) & 1:
                        elig[r] = 1
                        count[b] += 1
    return (torch.tensor(elig, dtype=torch.bool).reshape(B, C),
            torch.tensor(count, dtype=torch.int32))


def deep_tree(F, depth=9):
    """A complete binary tree of 2**depth leaves (G 0-3 and F 0..F-1 in
    turn, every operator): its program needs depth + 1 stack entries,
    past FL_STACK from depth 8."""
    ops = ("XOR", "OR", "AND", "AND_NOT")
    leaves = [("G", i % 4) for i in range(4)] + [("F", i) for i in range(F)]
    n = [0]

    def node(d):
        if d == 0:
            n[0] += 1
            return leaves[n[0] % len(leaves)]
        return (ops[d % 4], node(d - 1), node(d - 1))

    return node(depth)


def random_tree(rng, F, n_g, n_ph, n_geo, depth=3):
    """A random tree over G, F, PH and GEO leaves and every operator."""
    leaves = [("G", i) for i in range(n_g)] + [("F", i) for i in range(F)] \
        + [("PH", i) for i in range(n_ph)] + [("GEO", i)
                                              for i in range(n_geo)]

    def node(d):
        if d == 0 or rng.random() < 0.3:
            return leaves[int(rng.integers(len(leaves)))]
        op = ("AND", "OR", "AND_NOT", "XOR", "AND_MAYBE", "FILTER")[
            int(rng.integers(6))]
        if op in ("AND", "OR"):
            return (op,) + tuple(node(d - 1)
                                 for _ in range(int(rng.integers(2, 4))))
        return (op, node(d - 1), node(d - 1))

    tree = node(depth)
    # every F leaf somewhere, so a leaf past the prefetch is read
    for i in range(F):
        tree = ("OR", tree, ("AND", ("F", i), ("G", 0)))
    return tree


def filter_case(seed, B=3, C=150, F=3, base=True, ph=False, geo=False,
                nd=300, deep=False):
    """Columns (one multi-value, one single-value, a slot they lack), the
    rows and parameters of a filter_leaves launch from a seed: docids with
    SENTINEL rows and ids past the pad doc, base flags, orbits, verdict
    words, random ranges with open ends, a random tree."""
    rng = np.random.Generator(np.random.PCG64(seed))
    values = {5: torch_col(value_case(seed, nd, mv=True)),
              6: torch_col(value_case(seed + 1, nd, mv=False))}
    slots = tuple(int(rng.choice([5, 6, 5, MISSING_SLOT]))
                  for _ in range(F))
    vmax = tuple(int(rng.integers(1, 5)) for _ in range(F))
    fp = np.zeros((B, F, 4), np.int32)
    for b in range(B):
        for f in range(F):
            a = (int(rng.integers(-13, 13)), int(rng.integers(-5, 5)))
            z = (a[0] + int(rng.integers(0, 6)), int(rng.integers(-5, 5)))
            if rng.random() < 0.15:
                a = (I32MIN, I32MIN)
            if rng.random() < 0.15:
                z = (I32MAX, I32MAX)
            fp[b, f] = a + z
    docids = rng.integers(0, nd + 4, (B, C)).astype(np.int32)
    docids[rng.random((B, C)) < 0.2] = SENTINEL
    base_t = torch.from_numpy(rng.random((B, C)) < 0.7) if base else None
    orbits = rng.integers(0, 16, (B, C)).astype(np.int32)
    phb = torch.from_numpy(rng.integers(0, 4, (B, C)).astype(np.int32)) \
        if ph else None
    geob = torch.from_numpy(rng.integers(0, 4, (B, C)).astype(np.int32)) \
        if geo else None
    tree = deep_tree(F) if deep else \
        random_tree(rng, F, 3, 2 if ph else 0, 2 if geo else 0)
    return (values, slots, vmax, torch.from_numpy(fp),
            torch.from_numpy(docids), base_t, torch.from_numpy(orbits),
            kernels.tree_program(tree), phb, geob), tree


def _plain(args):
    values, slots, vmax = args[:3]
    cols = [values.get(s) for s in slots]
    vm = tuple(int(vmax[i]) if i < len(vmax) else 1
               for i in range(len(slots)))
    return kernels._filter_leaves_plain(cols, vm, *args[3:])


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 4),
       C=st.integers(1, 90), F=st.integers(0, 5), base=st.booleans(),
       ph=st.booleans(), geo=st.booleans())
@example(seed=3, B=1, C=1, F=1, base=True, ph=False, geo=False)
@example(seed=4, B=3, C=17, F=34, base=False, ph=True, geo=True)
@example(seed=5, B=2, C=64, F=0, base=True, ph=True, geo=False)
def test_filter_tiles_match_plain_version(seed, B, C, F, base, ph, geo):
    args, _tree = filter_case(seed, B, C, F, base, ph, geo)
    got = emulate_filter_leaves(*args)
    want = _plain(args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the wrapper on CPU tensors is the plain version
    w2 = kernels.filter_leaves(*args)
    assert torch.equal(w2[0], want[0]) and torch.equal(w2[1], want[1])


@pytest.mark.parametrize("base", [True, False])
def test_filter_deep_tree_runs_row_by_row(base):
    """A program past FL_STACK masks (a complete tree of 512 leaves needs 10)
    runs row by row, equal to the plain version."""
    args, tree = filter_case(31, B=2, C=70, F=3, base=base, deep=True)
    assert kernels.tree_need(args[7]) == 10
    got = emulate_filter_leaves(*args)
    want = _plain(args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("case", ["base", "packed", "wide_f", "verdicts"])
def test_filter_tiles_match_jax(case):
    """The emulation's eligible flags are JAX's _gather_filter_leaves +
    _eval_tree's (and the row's first flag) per row."""
    import jax.numpy as jnp

    import xapiand_tpu.ops.executor as jex

    kw = {"base": {}, "packed": {"base": False}, "wide_f": {"F": 34},
          "verdicts": {"ph": True, "geo": True, "C": 77}}[case]
    args, tree = filter_case(11 + len(case), **kw)
    values, slots, vmax, fp, docids, base, orbits, _prog, phb, geob = args
    got, count = emulate_filter_leaves(*args)
    jvals = {s: {c: jnp.asarray(v.numpy()) for c, v in col.items()
                 if c not in ("keys", "codes", "code_hll")}
             for s, col in values.items()}
    cfg = jex.ExecConfig(T=1, L=128, k=10, tree=tree, n_filters=len(slots),
                         filter_slots=slots, filter_vmax=vmax)
    first = base if base is not None else docids != SENTINEL
    for b in range(docids.shape[0]):
        d = jnp.asarray(docids[b].numpy())
        fres = jex._gather_filter_leaves({"values": jvals}, cfg,
                                         jnp.asarray(fp[b].numpy()), d)
        ob = jnp.asarray(orbits[b].numpy())
        ph = jnp.asarray(phb[b].numpy()) if phb is not None else None
        ge = jnp.asarray(geob[b].numpy()) if geob is not None else None
        want = jex._eval_tree(tree, {
            "G": lambda i: (ob & (1 << i)) != 0,
            "F": lambda i: fres[i],
            "PH": lambda i: (ph & (1 << i)) != 0,
            "GEO": lambda i: (ge & (1 << i)) != 0,
            "ALL": lambda: jnp.ones(d.shape, bool)})
        want = np.asarray(want) & first[b].numpy()
        np.testing.assert_array_equal(got[b].numpy(), want, str(b))
        assert int(count[b]) == int(want.sum())
    assert got.any() and not got.all()


def test_jax_tree_feeds_the_plain_versions():
    """A JAX tree (device_segment_from_numpy of its channels, no packed keys
    or codes) feeds both wrappers on the CPU, as the tree with them."""
    (values, *rest), _tree = filter_case(21, F=3)
    bare = {s: {c: v for c, v in col.items()
                if c not in ("keys", "codes", "code_hll")}
            for s, col in values.items()}
    for a, b in zip(kernels.filter_leaves(bare, *rest),
                    kernels.filter_leaves(values, *rest)):
        assert torch.equal(a, b)
    ids, elig = rest[3], rest[4] if rest[4] is not None else \
        rest[3] != SENTINEL
    for a, b in zip(kernels.agg_distinct(ids, elig, bare[5]),
                    kernels.agg_distinct(ids, elig, values[5])):
        assert torch.equal(a, b)


def test_wrappers_refuse_columns_without_the_new_arrays(monkeypatch):
    """Where the wrappers would launch (a CUDA tensor: _on_cuda true), a
    column without its packed keys or codes is refused by name before any
    launch, not read as another layout (the card's own case is in
    tests/test_torch_cuda.py)."""
    (values, slots, *rest), _tree = filter_case(22, F=2)
    slots = (5, 6)
    bare = {s: {c: v for c, v in col.items() if c != "keys"}
            for s, col in values.items()}
    monkeypatch.setattr(kernels, "_on_cuda", lambda name, *t: True)
    with pytest.raises(ValueError, match="slot 5 has no packed keys"):
        kernels.filter_leaves(bare, slots, *rest)
    ids = rest[2]
    for ch in ("codes", "code_hll"):
        col = {c: v for c, v in values[5].items() if c != ch}
        with pytest.raises(ValueError, match="without its codes"):
            kernels.agg_distinct(ids, ids != SENTINEL, col)


# --------------------------------------------------------------------------
# agg_distinct: the K-bit set and the registers read from it
# --------------------------------------------------------------------------

def emulate_agg_distinct(ids, elig, col, G=3, local=True):
    """csrc/agg_distinct.cu: G blocks a query set the bits of their rows'
    codes (the flags 16 rows at a time on the flat index, a set bit's docid
    and code; a shared set a block OR'd into the query's words where
    ``local``, else the query's words directly), then the fold reads each
    word's codes: the count of those without AD_SKIP, each register the
    maximum rho at its index."""
    B, R = ids.shape
    n = col["hi"].shape[0]
    codes, hll = col["codes"], col["code_hll"]
    W = kernels.distinct_words(hll.shape[0])
    words = torch.zeros((B, W), dtype=torch.int64)
    fi, fe = ids.reshape(-1), elig.reshape(-1)
    for b in range(B):
        lo, hi = b * R, b * R + R
        ga, ng = lo >> 4, ((hi + 15) >> 4) - (lo >> 4)
        for g in range(G):
            sset = torch.zeros(W, dtype=torch.int64) if local else words[b]
            for gi in range(ga + ng * g // G, ga + ng * (g + 1) // G):
                r = torch.arange(gi * 16, gi * 16 + 16)
                r = r[(r >= lo) & (r < hi)]
                r = r[fe[r]]
                c = codes[fi[r].long().clamp(max=n - 1)].long()
                c = c[c >= 0]
                for x in c.tolist():
                    sset[x >> 5] |= 1 << (x & 31)
            if local:
                words[b] |= sset
    count = torch.zeros(B, dtype=torch.int32)
    regs = torch.zeros((B, kernels.HLL_REGS), dtype=torch.int32)
    for b in range(B):
        for i in range(W):
            x = int(words[b, i])
            for j in range(32):
                if (x >> j) & 1:
                    h = int(hll[i * 32 + j])
                    count[b] += 0 if h & AD_SKIP else 1
                    idx, rho = (h >> 5) & 1023, h & 31
                    regs[b, idx] = max(int(regs[b, idx]), rho)
    return count, regs, words


def distinct_case(seed, B=3, R=120, nd=300, p_elig=0.5, mv=True,
                  hi_range=12):
    rng = np.random.Generator(np.random.PCG64(seed))
    col = torch_col(value_case(seed, nd, mv=mv, hi_range=hi_range))
    ids = torch.from_numpy(rng.integers(0, nd + 6, (B, R)).astype(np.int32))
    elig = torch.from_numpy(rng.random((B, R)) < p_elig)
    return ids, elig, col


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 4),
       R=st.integers(1, 100), p=st.sampled_from([0.0, 0.3, 1.0]),
       G=st.integers(1, 4), local=st.booleans())
@example(seed=1, B=2, R=33, p=0.0, G=2, local=True)
@example(seed=2, B=1, R=1, p=1.0, G=1, local=False)
def test_distinct_set_matches_plain_version(seed, B, R, p, G, local):
    ids, elig, col = distinct_case(seed, B, R, p_elig=p)
    n, regs, _w = emulate_agg_distinct(ids, elig, col, G, local)
    pn, pregs = kernels._agg_distinct_plain(ids, elig, col)
    assert torch.equal(n, pn) and torch.equal(regs, pregs)
    if p == 0.0:
        assert not n.any() and not regs.any()


DISTINCT_EDGES = ("k1", "skip_key", "past_n", "absent", "wide_k", "none")


def distinct_edge(case, B=2, R=96):
    """K = 1 (one distinct key); rows of the left-out key alone (registers
    set, count 0); ids past n - 1 (they read row n - 1, the absent pad
    doc); a query of absent docs only; K past the shared-memory set
    (AD_SMEM_WORDS words), whose codes set the query's words directly; no
    eligible row. -> ids, elig, col (CPU tensors)."""
    nd = 90000 if case == "wide_k" else 200
    ch = value_case(7, nd=nd, mv=False,
                    hi_range=2**20 if case == "wide_k" else 12)
    rng = np.random.Generator(np.random.PCG64(8))
    ids = rng.integers(0, nd, (B, R)).astype(np.int32)
    elig = np.full((B, R), case != "none")
    if case == "k1":
        for c, v in (("hi", 3), ("lo", -1), ("max_hi", 3), ("max_lo", -1)):
            ch[c][ch["present"]] = v
    elif case == "skip_key":
        ids[:] = 1                      # the doc of (INT32_MAX, INT32_MAX)
    elif case == "past_n":
        ids[0] = nd + 1 + rng.integers(0, 99, R)
        ids[0, ::3] = SENTINEL
    elif case == "absent":
        gone = np.flatnonzero(~ch["present"][:nd])
        ids[0] = gone[rng.integers(0, len(gone), R)]
    return torch.from_numpy(ids), torch.from_numpy(elig), torch_col(ch)


@pytest.mark.parametrize("case", DISTINCT_EDGES)
def test_distinct_edge_cases(case):
    ids, elig, col = distinct_edge(case)
    W = kernels.distinct_words(col["code_hll"].shape[0])
    assert (W > AD_SMEM_WORDS) == (case == "wide_k")
    n, regs, words = emulate_agg_distinct(ids, elig, col, 2,
                                          local=W <= AD_SMEM_WORDS)
    pn, pregs = kernels._agg_distinct_plain(ids, elig, col)
    assert torch.equal(n, pn) and torch.equal(regs, pregs)
    if case == "k1":
        assert col["code_hll"].shape[0] in (1, 2)   # (and the left-out key)
        assert int(n.max()) == 1
    if case == "skip_key":
        assert not n.any() and bool(regs.any())
    if case in ("past_n", "absent"):
        assert int(n[0]) == 0 and not bool(regs[0].any())
        assert not words[0].any()
    if case == "none":
        assert not n.any() and not regs.any()


@pytest.mark.parametrize("seed", range(3))
def test_distinct_set_matches_jax(seed):
    """The emulation's n, maxn and registers are JAX's compute_aggs
    cardinality on the same rows (multi-value docs count their smallest
    key)."""
    import jax
    import jax.numpy as jnp

    from xapiand_tpu.ops import aggs as jaggs

    ids, elig, col = distinct_case(30 + seed, B=4, R=200, p_elig=0.6,
                                   hi_range=40)
    nd1 = col["hi"].shape[0]
    jcol = {c: jnp.asarray(v.numpy()) for c, v in col.items()
            if c not in ("keys", "codes", "code_hll")}
    want = jax.jit(jax.vmap(lambda d, m: jaggs.compute_aggs(
        {"values": {5: jcol}}, (("cardinality", 5),),
        jnp.minimum(d, nd1 - 1), m, jnp.zeros(d.shape, jnp.float32))))(
        jnp.asarray(ids.numpy()), jnp.asarray(elig.numpy()))[0]
    n, regs, _w = emulate_agg_distinct(ids, elig, col)
    np.testing.assert_array_equal(n.numpy(), np.asarray(want["n"]))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want["maxn"]))
    np.testing.assert_array_equal(regs.numpy(), np.asarray(want["hll"]))
    assert n.min() > 0


def test_distinct_scratch_is_sized_by_the_codes():
    """The kernel's scratch is B x ceil(K / 32) words (at least one),
    whatever the rows; G blocks a query set the bits, G2 fold the words."""
    assert [kernels.distinct_words(k) for k in (0, 1, 32, 33, 65536)] == \
        [1, 1, 1, 2, 2048]
    assert kernels.distinct_plan(256, 1000001, 1) == (9, 1)
    assert kernels.distinct_plan(1, 100, 5000) == (1, 20)
    G, G2 = kernels.distinct_plan(64, 25728, 100000)
    assert G == 7 and G2 == kernels.DISTINCT_FOLD
