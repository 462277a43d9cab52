"""Device timers for the port's measurements on the card (``chip_smoke.py``
and the version pairs of ``tools/``).

``event_ms`` puts two CUDA events around a loop of calls, so it reads the
host work between launches wherever the card waits on it; ``device_ms``
reads ``torch.profiler``'s CUDA activity alone (kernels, copies, memsets,
their durations summed), so it reads the card's time and none of the
host's. Both warm the call first. torch is imported inside them: the module
imports on a machine without a card.
"""

from __future__ import annotations


def event_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of fn() over reps calls, between two CUDA events."""
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


def device_ms(fn, reps: int = 20, by: dict | None = None, tries: int = 3):
    """The device time of one fn(): the durations of the CUDA activity that
    torch.profiler traces over reps calls, summed, over reps. by, a dict,
    gets each device event name's (cut to 48 characters) mean a call.

    Every call of fn must launch the same device work. A trace whose
    device events are not a whole number a call is taken again, up to
    tries traces, and None returned after. Late in a long process
    (chip_smoke.py, after several paths) a trace has held none of a 4 µs
    kernel's launches, or only some of a longer kernel's, while the next
    trace, of a PyTorch call, held all of its own, and the same launches
    read whole in a process of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if ev and len(ev) % reps == 0:
            break
    else:
        return None
    us = 0.0
    for e in ev:
        t = e.time_range.end - e.time_range.start
        us += t
        if by is not None:
            name = e.name[:48]
            by[name] = by.get(name, 0.0) + t / 1e3 / reps
    return us / 1e3 / reps
