"""Device time of a call on the card: the one definition that
``chip_smoke.py`` and the ``scripts/torch_*.py`` tools report their
kernel times with. It stands alone (only ``torch``), so the A/B script can
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
