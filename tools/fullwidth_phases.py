#!/usr/bin/env python3
"""Where fullwidth_topk's part kernel spends its time, on the card:
csrc/fullwidth_topk.cu built with -DFW_PHASES (the blocks of the query
with the most eligible rows add up their warps' cycles in the walk, their batches of 32 drained rows,
their buffer selections and the cycles of those and of the batches' keys,
and the block's end), run on
launches made from a seed at faceted A's widest shape (B 64, R 1,310,720:
the eligible rows 2.6% of the first 262,144 rows, as the AND's owner rows
fall; 0.53% of every row; none) and on captured launches.

    python tools/fullwidth_phases.py [--captures DIR]

One JSON line a launch: its time by CUDA events and device-only (by
kernel), then for each block g of that query the sums over its 8 warps;
then the card's name, power limit and SM clock.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

NAMES = ("walk", "batches", "selections", "selection cycles", "key cycles",
         "end")


def made(case, dev, seed=7, B=64, R=1_310_720, n_docs=1_000_000):
    """fullwidth_topk's arguments at faceted A's widest shape."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n = n_docs + 1
    col = {"hi": torch.randint(-2**20, 2**20, (n,), generator=g,
                               dtype=torch.int32),
           "lo": torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                               dtype=torch.int32),
           "present": torch.rand(n, generator=g) >= 0.1}
    ids = torch.randint(0, n_docs, (B, R), generator=g, dtype=torch.int32)
    sums = torch.rand((B, R), generator=g)
    if case == "owners":
        elig = torch.zeros((B, R), dtype=torch.bool)
        elig[:, :262144] = torch.rand((B, 262144), generator=g) < 0.026
    elif case == "uniform":
        elig = torch.rand((B, R), generator=g) < 0.0053
    else:
        elig = torch.zeros((B, R), dtype=torch.bool)
    spec = ("value", 90, True)
    return ((spec, ids.to(dev), sums.to(dev), elig.to(dev), 10,
             {90: {c: x.to(dev) for c, x in col.items()}}, None, None), {})


def main() -> int:
    import torch

    import chip_smoke as cs
    from sort_pairs import build_many, using
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.utils.cudatime import device_ms, event_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--captures", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fullwidth_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = os.path.join(ROOT, "_archive", "fullwidth_phases", "phases.so")
    lib, = build_many([(out, os.path.join(ROOT, "xapiand_tpu_torch", "csrc"),
                        ("fullwidth_topk.cu",), ("-DFW_PHASES",))])
    lib.xt_fullwidth_phases.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
    lib.xt_fullwidth_phases.restype = ctypes.c_int
    runs = [(c, made(c, dev)) for c in ("owners", "uniform", "none")]
    if args.captures:
        for f in sorted(os.listdir(args.captures)):
            if f.startswith("fullwidth_topk") and f.endswith(".pt"):
                cap = torch.load(os.path.join(args.captures, f),
                                 weights_only=False)
                runs.append((f[:-3], (cap["args"], cap["kw"])))
    buf = (ctypes.c_ulonglong * (64 * 6))()
    for name, (a, kw) in runs:
        # the query with the most eligible rows
        q = int(a[3].sum(1).argmax())
        with using(lib):
            ms = event_ms(lambda: kn.fullwidth_topk(*a, **kw), 5)
            by: dict = {}
            dev_ms = device_ms(lambda: kn.fullwidth_topk(*a, **kw), 5,
                               by=by)
            if lib.xt_fullwidth_phases(None, 1, q):
                raise RuntimeError("xt_fullwidth_phases failed")
            kn.fullwidth_topk(*a, **kw)
            torch.cuda.synchronize()
            if lib.xt_fullwidth_phases(ctypes.cast(buf, ctypes.c_void_p),
                                       0, q):
                raise RuntimeError("xt_fullwidth_phases failed")
        B, R = a[1].shape
        G, gpw = kn.fullwidth_plan(B, R)
        v = list(buf)
        print(json.dumps({
            "launch": name, "B": B, "R": R, "G": G, "gpw": gpw,
            "event_ms": ms, "device_ms": dev_ms, "by_kernel": by,
            "query": q, "eligible": int(a[3][q].sum()),
            "eligible_all": int(a[3].sum()),
            "blocks": [{NAMES[i]: v[g * 6 + i] for i in range(6)}
                       for g in range(min(G, 64))]}), flush=True)
    print(cs.__name__, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
