#!/usr/bin/env python3
"""Time two versions of csrc/topk_rows.cu against each other on one card.

    python tools/topk_pairs.py --parent DIR [--rounds 3]

DIR is a checkout of the version to compare with (for example a
``git archive`` of the parent commit unpacked under ``_archive/``). Both
versions' ``topk_rows.cu`` are compiled alone with nvcc (the flags of
``ops/kernels.py``, each with its own ``common.cuh``) into
``_archive/topk_pairs/``, loaded side by side and launched on the same
inputs, in the order parent, change, change, parent, ``--rounds`` times:
the browse path's widest shapes (B32 R2097152 and B16 R4194304 with k 10,
the collapse's tie ranks at B1 R2101376; half the rows owners, scores
uniform, no NaN, so both versions must return the same answer, which is
checked). Prints one line per shape with every time and each version's
median (CUDA events, mean of 20 launches a time), then the card's name and
power limit.
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
SHAPES = ((32, 2_097_152, False), (16, 4_194_304, False), (1, 2_101_376, True))
K = 10


def build(csrc: str, out: str) -> ctypes.CDLL:
    sys.path.insert(0, ROOT)
    from xapiand_tpu_torch.ops import kernels as kn

    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([kn.find_nvcc(), *kn.NVCC_FLAGS, "-shared", "-o", out,
                    os.path.join(csrc, "topk_rows.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.xt_topk_rows.argtypes = [P, P, P, I, I, I, P, P, P]
    lib.xt_topk_rows_tie.argtypes = [P, P, P, P, I, I, I, P, P, P]
    return lib


def launcher(lib, scores, ids, owner, tie, out_d, out_s):
    import torch

    B, R = scores.shape
    st = torch.cuda.current_stream().cuda_stream

    def run():
        if tie is None:
            rc = lib.xt_topk_rows(scores.data_ptr(), ids.data_ptr(),
                                  owner.data_ptr(), B, R, K, out_d.data_ptr(),
                                  out_s.data_ptr(), st)
        else:
            rc = lib.xt_topk_rows_tie(scores.data_ptr(), ids.data_ptr(),
                                      owner.data_ptr(), tie.data_ptr(), B, R,
                                      K, out_d.data_ptr(), out_s.data_ptr(),
                                      st)
        if rc:
            raise RuntimeError(f"topk_rows launch failed: {rc}")
    return run


def ms(fn, reps=20):
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
        print("topk_pairs: no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "_archive", "topk_pairs")
    libs = {"parent": build(os.path.join(args.parent, "xapiand_tpu_torch",
                                         "csrc"),
                            os.path.join(out, "parent.so")),
            "change": build(os.path.join(ROOT, "xapiand_tpu_torch", "csrc"),
                            os.path.join(out, "change.so"))}
    g = torch.Generator(device="cuda").manual_seed(7)
    for B, R, with_tie in SHAPES:
        scores = torch.rand((B, R), generator=g, device="cuda") * 20.0
        ids = torch.randint(0, 2**30, (B, R), generator=g, device="cuda",
                            dtype=torch.int32)
        owner = (torch.rand((B, R), generator=g, device="cuda") < 0.5) \
            .to(torch.uint8)
        tie = torch.randint(0, 4, (B, R), generator=g, device="cuda",
                            dtype=torch.int32) if with_tie else None
        outs = {v: (torch.empty((B, K), dtype=torch.int32, device="cuda"),
                    torch.empty((B, K), dtype=torch.float32, device="cuda"))
                for v in libs}
        runs = {v: launcher(libs[v], scores, ids, owner, tie, *outs[v])
                for v in libs}
        times = {v: [] for v in libs}
        for _ in range(args.rounds):
            for v in ("parent", "change", "change", "parent"):
                times[v].append(ms(runs[v]))
        if not (torch.equal(outs["parent"][0], outs["change"][0]) and
                torch.equal(outs["parent"][1], outs["change"][1])):
            raise AssertionError(f"B={B} R={R}: the versions disagree")
        print(json.dumps({
            "shape": f"{'tie ' if with_tie else ''}B={B} R={R} k={K}",
            "ms": times, "median": {v: statistics.median(t)
                                    for v, t in times.items()}}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
