"""Compares the logged loss streams of two training runs (counterpart of
``scripts/compare_loss_streams.py``, for the port's log lines).

Reads ``step N: loss=X ...`` lines (``train/loop.MetricLogger``; the
eval lines, ``step N: eval_loss=...``, do not match) from two logs and
reports, over the steps both logged (from ``--from-step`` on), how many
are bit-equal and the largest |loss_a - loss_b|. Exit code 0 when that is
below 5e-3, 2 when not, 1 when the logs share no step. The logger prints
5 significant digits, so "bit-equal" is equal as printed.

    python -m sav_tpu_torch.compare_loss_streams A.log B.log [--from-step N]

A resumed run's stream after its restore must equal the uninterrupted
twin's at the same steps; the port's card run against its ``--device cpu``
run, or against the JAX package's ``train.py`` log (whose lines carry an
``INFO:absl:`` prefix, also read here), is the loss-stream comparison
ROADMAP.md's Queue 3 asks for.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Tuple

PAT = re.compile(rb'step (\d+): (?:\S+ )*?loss=([0-9.eE+-]+|nan|inf)')
TOLERANCE = 5e-3


def parse(path: str) -> Dict[int, float]:
    """Step -> logged loss; a later line of the same step wins."""
    out = {}
    with open(path, 'rb') as f:
        for line in f:
            m = PAT.search(line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


def compare(a: Dict[int, float], b: Dict[int, float],
            from_step: int = 0) -> Tuple[str, int]:
    """(the report line, the exit code) of two parsed streams."""
    steps = sorted(s for s in a.keys() & b.keys() if s >= from_step)
    if not steps:
        return 'no overlapping steps', 1
    diffs = [(abs(a[s] - b[s]), s) for s in steps]
    worst, worst_step = max(diffs)
    exact = sum(1 for d, _ in diffs if d == 0.0)
    report = (f'{len(steps)} overlapping steps in [{steps[0]}, {steps[-1]}]; '
              f'{exact} bit-equal; max |dloss| = {worst:.3e} at step '
              f'{worst_step}')
    return report, 0 if worst < TOLERANCE else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('log_a')
    ap.add_argument('log_b')
    ap.add_argument('--from-step', type=int, default=0)
    args = ap.parse_args(argv)
    report, code = compare(parse(args.log_a), parse(args.log_b),
                           args.from_step)
    print(report)
    return code


if __name__ == '__main__':
    raise SystemExit(main())
