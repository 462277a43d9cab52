#!/usr/bin/env python3
"""Time two versions of csrc/sort_topk.cu, agg_filter.cu and
semijoin_rows.cu, and variants of this tree's sort_topk.cu, against each
other on one card, on the launches the paths make.

    python3 chip_smoke.py --capture _archive/captures
    python tools/sort_pairs.py --parent DIR --captures _archive/captures \\
        [--rounds 2]

``chip_smoke.py --capture`` saves the arguments of the launches its paths
make at the shapes of its ``CAPTURE`` table (sort_topk at geo, browse N, C
and M, faceted A and B, a REST mesh shape; the widest agg_filter and
semijoin_rows). DIR is a checkout of the version to compare with (for
example a ``git archive`` of the parent commit unpacked under
``_archive/``). The versions, each built with the flags of
``ops/kernels.py`` into ``_archive/sort_pairs/`` (one nvcc a source, all at
once): ``parent`` (DIR's sources), ``change`` (this tree's) and, for
sort_topk alone, ``VARIANTS`` (this tree's sort_topk.cu with other
constants). Each captured launch is replayed through this tree's wrapper
(``kernels._lib`` swapped), each version's answer held to the plain
version's (``chip_smoke.HELD``), then timed in the order parent, change,
the variants, the variants reversed, change, parent, ``--rounds`` times.
One JSON line a launch: its key, the eligible rows' share, every time and
each version's median, device-only (``utils/cudatime.device_ms``: CUDA
activity alone, the mean a call over 20 calls) and by CUDA events around
the same 20 wrapper calls (``event_ms``), the change's time by kernel, the
library call's (HELD's yardstick: ``torch.topk(largest=False)`` of the
masked docids for the docid key, ``torch.searchsorted`` for agg_filter and
semijoin_rows) and the bound (HELD's work over ``chip_smoke.py``'s rates).
Then the card's name and power limit.

``build_many`` and ``using`` are also the harness of ``tools/topk_pairs.py``
and ``tools/dense_pairs.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCES = ("sort_topk.cu", "agg_filter.cu", "semijoin_rows.cu")
# this tree's sort_topk.cu with other constants: tiles of 16384 rows, 8
# blocks an SM, each eligible docid read alone
VARIANTS = {"tile16384": ("-DSK_TILE_MIN=16384",),
            "blocks1056": ("-DSK_BLOCKS=1056",),
            "scalar_ids": ("-DSK_IDS_VEC=0",)}
REPS = 20


def build_many(jobs) -> list:
    """jobs: (library path, csrc directory, sources, extra nvcc flags).
    Every nvcc is started at once, then each job's objects are linked into
    its library, which is loaded with ops/kernels.py's C signatures."""
    from xapiand_tpu_torch.ops import kernels as kn

    procs = []
    for out, csrc, sources, flags in jobs:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        for n in sources:
            obj = f"{out[:-3]}.{n[:-3]}.o"
            procs.append((n, obj, subprocess.Popen(
                [kn.find_nvcc(), *kn.NVCC_FLAGS, *flags, "-c", "-o", obj,
                 os.path.join(csrc, n)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for n, _obj, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc {n} failed:\n{log}")
    libs = []
    for out, _csrc, sources, _flags in jobs:
        subprocess.run([kn.find_nvcc(), "-shared", "-o", out,
                        *(f"{out[:-3]}.{n[:-3]}.o" for n in sources)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(out)
        for fn, argtypes in kn._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs.append(lib)
    return libs


@contextlib.contextmanager
def using(lib):
    """The port's wrappers launch from lib inside the block."""
    from xapiand_tpu_torch.ops import kernels as kn

    saved, kn._lib = kn._lib, lib
    try:
        yield
    finally:
        kn._lib = saved


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def replay(path, libs, rounds):
    """One captured launch: every version held to the plain version, then
    timed; its JSON line."""
    import torch

    import chip_smoke as cs
    from xapiand_tpu_torch.ops import kernels as kn
    from xapiand_tpu_torch.utils.cudatime import device_ms, event_ms

    cap = torch.load(path, weights_only=False)
    name, args, kw = cap["name"], cap["args"], cap["kw"]
    plain, check, key, work, _library, *yard = cs.HELD[name](args, **kw)
    wrapper = getattr(kn, name)
    names = [v for v in libs if name == "sort_topk" or v not in VARIANTS]
    want = plain()
    run = {}
    for v in names:
        with using(libs[v]):
            check(wrapper(*args, **kw), want)
        run[v] = (lambda lib=libs[v]: call(lib, wrapper, args, kw))
    torch.cuda.synchronize()
    dev = {v: [] for v in names}
    ev = {v: [] for v in names}
    var = [v for v in names if v in VARIANTS]
    for _ in range(rounds):
        for v in ("parent", "change", *var, *var[::-1], "change", "parent"):
            dev[v].append(device_ms(run[v], REPS))
            ev[v].append(event_ms(run[v], REPS))
    by: dict = {}
    device_ms(run["change"], REPS, by=by)
    b, ops = work()
    elig = args[3] if name == "sort_topk" else \
        args[1] if name == "agg_filter" else None
    return {
        "kernel": name, "key": key,
        "eligible_share": float(elig.float().mean()) if elig is not None
        else None,
        "device_ms": dev, "event_ms": ev,
        "median_device_ms": {v: statistics.median(t) for v, t in dev.items()
                             if None not in t},
        "median_event_ms": {v: statistics.median(t) for v, t in ev.items()},
        "change_by_kernel_ms": by,
        "library_device_ms": device_ms(yard[0], REPS) if yard else None,
        "library_event_ms": event_ms(yard[0], REPS) if yard else None,
        "bound_ms": max(1e3 * b / cs.HBM_BYTES_PER_S,
                        1e3 * ops / cs.PEAK_OPS_PER_S)}


def call(lib, wrapper, args, kw):
    with using(lib):
        return wrapper(*args, **kw)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--captures", required=True,
                    help="chip_smoke.py --capture's directory")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sort_pairs: no CUDA device", file=sys.stderr)
        return 2
    files = sorted(f for f in os.listdir(args.captures) if f.endswith(".pt"))
    if not files:
        print(f"sort_pairs: no capture in {args.captures}", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "_archive", "sort_pairs")
    here = os.path.join(ROOT, "xapiand_tpu_torch", "csrc")
    jobs = {"parent": (os.path.join(out, "parent.so"),
                       os.path.join(args.parent, "xapiand_tpu_torch", "csrc"),
                       SOURCES, ()),
            "change": (os.path.join(out, "change.so"), here, SOURCES, ())}
    for v, flags in VARIANTS.items():
        jobs[v] = (os.path.join(out, f"{v}.so"), here, ("sort_topk.cu",),
                   flags)
    libs = dict(zip(jobs, build_many(list(jobs.values()))))
    for f in files:
        print(json.dumps(replay(os.path.join(args.captures, f), libs,
                                args.rounds)), flush=True)
        torch.cuda.empty_cache()
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
