#!/usr/bin/env python3
"""Time two versions of csrc/dense_rows.cu against each other on one card.

    python tools/dense_pairs.py --parent DIR [--rounds 3]

DIR is a checkout of the version to compare with (for example a
``git archive`` of the parent commit unpacked under ``_archive/``). Both
versions' ``dense_rows.cu`` are compiled alone with nvcc (the flags of
``ops/kernels.py``, each with its own ``common.cuh``) into
``_archive/dense_pairs/``, loaded side by side and launched through the
port's wrapper (its library swapped in) on the same inputs, in the order
parent, change, change, parent, ``--rounds`` times: the browse N shapes
and their wider classes (BM25 terms of 100k-900k of 1M docs, after the
guard of pad docs a segment's postings end with), M (no posting) and one
query. Both versions must return the plain version's bits, which is
checked. Prints one line per shape with every time, each version's
median (CUDA events, mean of 10 launches a time) and the 13-byte floor
(B x (ND + 1) x 13 bytes at 3.35 TB/s), then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, term blocks, class width): browse N, its wider classes, the schemes'
# D group's width, M (no posting), one query
SHAPES = ((64, (0, 1), 131_072), (64, (2, 3), 524_288),
          (32, (4, 3), 1_048_576), (256, (), 1), (1, (0, 1), 131_072))
TERMS = (100_000, 120_000, 400_000, 450_000, 900_000)
ND1 = 1_000_001
# xt_dense_rows' run length argument (after uniq), which versions before
# it do not take: the wrapper's argument is dropped for them
PER_ARG = 18


class _NoPer:
    """An xt_dense_rows of the first C interface behind the current one."""

    def __init__(self, fn):
        self.fn = fn

    def xt_dense_rows(self, *a):
        return self.fn(*a[:PER_ARG], *a[PER_ARG + 1:])


def build(csrc: str, out: str):
    sys.path.insert(0, ROOT)
    from xapiand_tpu_torch.ops import kernels as kn

    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = os.path.join(csrc, "dense_rows.cu")
    subprocess.run([kn.find_nvcc(), *kn.NVCC_FLAGS, "-shared", "-o", out,
                    src], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    sig = kn._SIGNATURES["xt_dense_rows"]
    lib.xt_dense_rows.restype = ctypes.c_int
    with open(src) as f:
        if "int per," in f.read():
            lib.xt_dense_rows.argtypes = sig
            return lib
    lib.xt_dense_rows.argtypes = sig[:PER_ARG] + sig[PER_ARG + 1:]
    return _NoPer(lib.xt_dense_rows)


def ms(fn, reps=10):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_pairs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from xapiand_tpu_torch.models.weights import CollectionStats, get_scheme
    from xapiand_tpu_torch.ops import kernels as kn

    out = os.path.join(ROOT, "_archive", "dense_pairs")
    libs = {"parent": build(os.path.join(args.parent, "xapiand_tpu_torch",
                                         "csrc"),
                            os.path.join(out, "parent.so")),
            "change": build(os.path.join(ROOT, "xapiand_tpu_torch", "csrc"),
                            os.path.join(out, "change.so"))}
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
                kn._lib = libs[v]
                got = kn.dense_rows(*dargs)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"B={B} W={W}: {v} and the plain "
                                         "version disagree")
                times[v].append(ms(lambda: kn.dense_rows(*dargs)))
        print(json.dumps({
            "shape": f"B={B} T={len(terms)} classes={W}",
            "ms": times, "median": {v: statistics.median(t)
                                    for v, t in times.items()},
            "floor_13_bytes_ms": B * ND1 * 13 / 3.35e9}), flush=True)
        del want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
