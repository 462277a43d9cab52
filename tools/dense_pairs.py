#!/usr/bin/env python3
"""Time two versions of csrc/dense_rows.cu against each other on one card.

    python tools/dense_pairs.py --parent DIR [--rounds 3]

DIR is a checkout of the version to compare with (for example a
``git archive`` of the parent commit unpacked under ``_archive/``). Both
versions' ``dense_rows.cu`` are compiled alone (``sort_pairs.build_many``:
the flags of ``ops/kernels.py``, each with its own ``common.cuh``) into
``_archive/dense_pairs/``, loaded side by side and launched through the
port's wrapper (``sort_pairs.using``) on the same inputs, in the order
parent, change, change, parent, ``--rounds`` times: the browse N shapes
and their wider classes (BM25 terms of 100k-900k of 1M docs, after the
guard of pad docs a segment's postings end with), M (no posting) and one
query. Both versions must return the plain version's bits, which is
checked. Prints one line per shape with every time, each version's
median (``utils/cudatime.event_ms``, mean of 10 launches a time) and the
13-byte floor (B x (ND + 1) x 13 bytes at 3.35 TB/s), then the card's
name and power limit. Both versions must take xt_dense_rows' run length
argument (the tiled design's C interface).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from sort_pairs import ROOT, build_many, smi, using

# (B, term blocks, class width): browse N, its wider classes, the schemes'
# D group's width, M (no posting), one query
SHAPES = ((64, (0, 1), 131_072), (64, (2, 3), 524_288),
          (32, (4, 3), 1_048_576), (256, (), 1), (1, (0, 1), 131_072))
TERMS = (100_000, 120_000, 400_000, 450_000, 900_000)
ND1 = 1_000_001


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_pairs: no CUDA device", file=sys.stderr)
        return 2
    from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.utils.cudatime import event_ms

    out = os.path.join(ROOT, "_archive", "dense_pairs")
    libs = dict(zip(("parent", "change"), build_many([
        (os.path.join(out, f"{v}.so"), os.path.join(d, "xapiand_tpu_torch",
                                                     "csrc"),
         ("dense_rows.cu",), ()) for v, d in (("parent", args.parent),
                                              ("change", ROOT))])))
    gen = torch.Generator().manual_seed(5)
    blocks = [torch.sort(torch.randperm(ND1 - 1, generator=gen)[:n])[0]
              .to(torch.int32) for n in TERMS]
    pd = torch.cat(blocks + [torch.full((1 << 20,), ND1 - 1,
                                        dtype=torch.int32)])
    offs = [0]
    for b in blocks:
        offs.append(offs[-1] + len(b))
    post = (pd.cuda(), (torch.rand(len(pd), generator=gen) * 4 + 1).cuda(),
            (torch.rand(len(pd), generator=gen) * 50 + 5).cuda())
    deleted = (torch.rand(ND1, generator=gen) < 0.01).cuda()
    spec = get_scheme("bm25").kernel_spec(CollectionStats(
        doc_count=ND1 - 1, avg_doclen=30.0, doclen_lower=5.0))
    for B, terms, W in SHAPES:
        T = max(len(terms), 1)
        offsets = torch.tensor([[offs[t] for t in terms] or [0]] * B,
                               dtype=torch.int32, device="cuda")
        lens = torch.tensor([[len(blocks[t]) for t in terms] or [0]] * B,
                            dtype=torch.int32, device="cuda")
        dargs = (post, offsets, lens,
                 torch.rand((B, T), device="cuda") + 0.5,
                 torch.ones((B, T), device="cuda"),
                 torch.ones((B, T), dtype=torch.int32, device="cuda"),
                 (W,) * T, deleted, spec)
        want = kn._dense_rows_plain(*dargs)
        times = {v: [] for v in libs}
        for _ in range(args.rounds):
            for v in ("parent", "change", "change", "parent"):
                with using(libs[v]):
                    got = kn.dense_rows(*dargs)
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, want)):
                        raise AssertionError(f"B={B} W={W}: {v} and the "
                                             "plain version disagree")
                    times[v].append(event_ms(
                        lambda: kn.dense_rows(*dargs), 10))
        print(json.dumps({
            "shape": f"B={B} T={len(terms)} classes={W}",
            "ms": times, "median": {v: statistics.median(t)
                                    for v, t in times.items()},
            "floor_13_bytes_ms": B * ND1 * 13 / 3.35e9}), flush=True)
        del want
        torch.cuda.empty_cache()
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
