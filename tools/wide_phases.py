#!/usr/bin/env python3
"""Where a wide_topk tile's time goes, on the card: csrc/wide_topk.cu built
with -DWT_PHASES (block (0, 0) of wide_tile records clock64() at its
phases), each captured wide call of chip_smoke.py --capture replayed once
through it, the phases printed in SM cycles.

    python3 chip_smoke.py --capture DIR --only rest_mesh
    python tools/wide_phases.py --captures DIR [--flags="-DNAME=VALUE ..."]

The phases: the first read of the tile's rows (the list, the first word's
digit histograms), the radix passes (and their count), the in-rows' key
words, their sorted runs of 32 and ranks, and the list or answer written
(the path of up to WT_RANK in-rows). One JSON line a capture, then the
card's name, power limit and SM clock.
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


def main() -> int:
    import torch

    import chip_smoke as cs
    from sort_pairs import build_many, using

    ap = argparse.ArgumentParser()
    ap.add_argument("--captures", required=True)
    ap.add_argument("--flags", default="",
                    help="more nvcc flags of the build, one string")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_phases: no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "_archive", "wide_phases", "phases.so")
    lib, = build_many([(out, os.path.join(ROOT, "xapiand_tpu_torch", "csrc"),
                        ("wide_topk.cu",),
                        ("-DWT_PHASES", *args.flags.split()))])
    lib.xt_wide_phases.argtypes = [ctypes.c_void_p]
    lib.xt_wide_phases.restype = ctypes.c_int
    clocks = (ctypes.c_longlong * 8)()
    for f in sorted(os.listdir(args.captures)):
        if not f.startswith("wide_topk") or not f.endswith(".pt"):
            continue
        cap = torch.load(os.path.join(args.captures, f), weights_only=False)
        home, attr = cs.wrapper_home(cap["name"])
        with using(lib):
            for _ in range(3):
                getattr(home, attr)(*cap["args"], **cap["kw"])
            torch.cuda.synchronize()
        if lib.xt_wide_phases(ctypes.cast(clocks, ctypes.c_void_p)):
            raise RuntimeError("xt_wide_phases failed")
        c = list(clocks)
        print(json.dumps({
            "key": cap["name"] + " " + cs.HELD[cap["name"]](
                cap["args"], **cap["kw"])[2][:80],
            "flags": args.flags, "passes": c[6],
            "cycles": {"first read": c[1] - c[0], "passes": c[2] - c[1],
                       "key words": c[3] - c[2], "runs and ranks":
                       c[7] - c[3], "written": c[4] - c[7],
                       "tile": c[4] - c[0]}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
