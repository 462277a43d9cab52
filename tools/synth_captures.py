#!/usr/bin/env python3
"""Write launches made from a seed, in ``chip_smoke.py --capture``'s
format, for ``tools/sort_pairs.py`` to replay where no path makes them.

    python tools/synth_captures.py _archive/synth
    python tools/sort_pairs.py --parent DIR --captures _archive/synth \\
        --kernels kmeans,merge_special

- ``kmeans``: one kmeans_cosine call (X, C0, 20 steps) at each of the REST
  path's shapes, n10 V1036 k3, n256 V2048 k8 and n4096 V2048 k16: rows in
  k blocks plus noise, L2-normalised, and ops/cluster.py's farthest-first
  seeding. The calls' times do not depend on the values beyond the labels'
  spread.
- ``collapse_rows``: one query's rows over 1,000,001 docids, sorted and
  distinct where eligible (40% of them), scores in [0, 1), on a column of
  40 categories drawn zipf-like, 3% without a value (browse C's collapse
  on the category): at R 2,359,424 with collapse_max 3 and R 1,000,001
  with 8.
- ``agg_buckets``: terms over 64 categories, count only, at faceted A's
  B64 R1310720 with 0.5% of the rows eligible, all of them in a tenth of
  the queries, each in one stretch of its rows (a query whose matches
  crowd its first term's rows), and at D's B32 R1835136 with 11% eligible
  everywhere.
- ``merge_special``: the browse S plan (one synonym group over the first
  three terms) and the X plan (a max spec of three branches, the last the
  third and fourth terms) under BM25, B16, T4 over 1,000,001 docids, at
  term blocks of 1024 to 262,144 rows, 70% of them real: the sparse side
  of ``kernels.special_plan``'s border, which no path reaches (its
  launches are the browse S and X ones, 1,048,576 rows a term).

Made on the card (the captures keep their tensors there), with numpy from
``--seed``.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SENTINEL = 2**31 - 1
KMEANS_SHAPES = ((10, 1036, 3), (256, 2048, 8), (4096, 2048, 16))
SPECIAL_WIDTHS = (1024, 8192, 65536, 262144)
N_DOCS = 1_000_001


def unit_rows(rng, n, v, k):
    import numpy as np

    centres = rng.random((k, v)) ** 4
    rows = centres[rng.integers(0, k, n)] + 0.05 * rng.random((n, v))
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)


def seeding(X, k):
    """ops/cluster.py kmeans_cosine's farthest-first seeding."""
    import numpy as np

    chosen = [0]
    sims = X @ X[0]
    for _ in range(k - 1):
        nxt = int(np.argmin(sims))
        chosen.append(nxt)
        sims = np.maximum(sims, X @ X[nxt])
    return np.ascontiguousarray(X[chosen])


def special_args(rng, B, W, plan, dev):
    """One merge_special call: T = 4 term blocks of W rows each (up to 70%
    real, sorted distinct docids, SENTINEL-padded), BM25 weights in
    [0, 4), the postings' wdf and doclen, each block's offset into them."""
    import numpy as np
    import torch

    from xapiand_tpu_torch.models.weights import BM25, CollectionStats
    from xapiand_tpu_torch.ops import kernels as kn

    T = 4
    widths = (W,) * T
    R = W * T
    ids = np.full((B, R), SENTINEL, np.int32)
    w = np.zeros((B, R), np.float32)
    for b in range(B):
        for u in range(T):
            n = int(0.7 * W)
            d = np.sort(rng.choice(N_DOCS, n, replace=False))
            ids[b, u * W:u * W + n] = d
            w[b, u * W:u * W + n] = rng.random(n) * 4
    n_post = 8 * W
    if plan == "syn":
        max_specs, syn_groups, bits = (), (0b1,), (0b1, 0b1, 0b1, 0b10)
    else:
        max_specs, syn_groups = ((0b1, 0b10, 0b100),), ()
        bits = (0b1, 0b10, 0b100, 0b100)
    stats = CollectionStats(doc_count=N_DOCS, avg_doclen=40.0,
                            doclen_lower=1.0, doclen_upper=90.0,
                            total_len=40.0 * N_DOCS, query_length=float(T))
    spec = BM25().kernel_spec(stats)

    def t(x):
        return torch.from_numpy(x).to(dev)

    args = (t(ids), t(w), widths,
            t(np.tile(np.array(bits, np.int32), (B, 1))),
            t(rng.integers(0, n_post - W, (B, T)).astype(np.int32)),
            t(rng.integers(1, 6, n_post).astype(np.float32)),
            t(rng.integers(0, 90, n_post).astype(np.float32)),
            max_specs, syn_groups,
            t((rng.random((B, 1)) * 3 + 0.5).astype(np.float32))
            if syn_groups else None, spec, None)
    assert kn.special_channels(max_specs, syn_groups) == \
        (2 if plan == "syn" else 4)
    return args


def collapse_args(rng, R, cmax, dev):
    """One browse-C-like collapse_rows call (see the module docstring)."""
    import numpy as np
    import torch

    cat = np.minimum(rng.zipf(1.3, N_DOCS) - 1, 39).astype(np.int32)
    col = {"hi": torch.zeros(N_DOCS, dtype=torch.int32, device=dev),
           "lo": torch.from_numpy(cat).to(dev),
           "present": torch.from_numpy(rng.random(N_DOCS) < 0.97).to(dev)}
    ids = np.sort(rng.integers(0, N_DOCS, R)).astype(np.int32)
    elig = rng.random(R) < 0.4
    elig[1:] &= ids[1:] != ids[:-1]
    return (torch.from_numpy(ids).to(dev)[None],
            torch.from_numpy(rng.random(R).astype(np.float32)).to(dev)[None],
            torch.from_numpy(elig).to(dev)[None], col, cmax)


def bucket_args(rng, B, R, share, crowded, dev):
    """One terms agg_buckets call, count only (see the module docstring)."""
    import numpy as np
    import torch

    ids = np.sort(rng.integers(0, N_DOCS, (B, R)), 1).astype(np.int32)
    elig = np.zeros((B, R), bool)
    if crowded:
        dense = max(1, B // 10)
        span = int(share * B * R / dense)
        for b in range(dense):
            elig[b, :span] = True
    else:
        elig = rng.random((B, R)) < share
    cats = rng.integers(-1, 64, N_DOCS).astype(np.int32)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(elig).to(dev),
            "terms", torch.from_numpy(cats).to(dev), 64)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--seed", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("synth_captures: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.dir, exist_ok=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def save(name, a, kw):
        key = cs.HELD[name](a, **kw)[2]
        torch.save({"name": name, "key": key, "args": a, "kw": kw},
                   os.path.join(args.dir, f"{name} {key}.pt"))
        print(f"[synth] {name} {key}", flush=True)

    for n, v, k in KMEANS_SHAPES:
        X = unit_rows(rng, n, v, k)
        save("kmeans", (torch.from_numpy(X).to(dev),
                        torch.from_numpy(seeding(X, k)).to(dev), 20), {})
    for W in SPECIAL_WIDTHS:
        for plan in ("syn", "max"):
            save("merge_special", special_args(rng, 16, W, plan, dev),
                 {"n_docs": N_DOCS})
    for R, cmax in ((2359424, 3), (1000001, 8)):
        save("collapse_rows", collapse_args(rng, R, cmax, dev), {})
    save("agg_buckets", bucket_args(rng, 64, 1310720, 0.005, True, dev), {})
    save("agg_buckets", bucket_args(rng, 32, 1835136, 0.11, False, dev), {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
