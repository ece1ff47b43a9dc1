"""Device time of a call on the card: the one definition that
``chip_smoke.py`` and the ``scripts/torch_*.py`` tools report their
kernel times with, and the split of a call's time by launch. It stands alone (only ``torch``), so the A/B script can
hand its source to a process that imports another checkout."""

from __future__ import annotations

import torch


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    ``warmup`` calls, between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(fns, calls: int = 10) -> list:
    """Device time of each kernel the calls ``fns`` launch, in the order the
    profiler first records them: ``[(kernel name, ms a round), ...]``, the time of
    all of a name's launches over ``calls`` rounds divided by ``calls``
    (torch.profiler's kernel records; memory copies and sets left out).
    Summed by name, so a record the profiler drops or a launch made in only
    some rounds cannot shift another kernel's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(('Memcpy', 'Memset'))),
                     key=lambda e: e.time_range.start)
    total: dict = {}
    for e in kernels:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
    return [(name, us / calls / 1e3) for name, us in total.items()]
