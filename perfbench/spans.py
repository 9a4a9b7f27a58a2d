"""Arithmetic of the readers of the program's spans and counters
(QuantResult.timing, and the "srt.<name>" profiler records its stage
spans open; sketch_rna_tpu_torch/utils/timing.py).

Counters and span sums are read from the window's untraced samples, as
readers.stage_ms_per_mreads reads the stage times.  Each function returns
None where a key or a record is absent, as it is from a program that has
no such span or counter.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

# The program's profiler record of span <name> is named PREFIX + <name>.
PREFIX = "srt."


def _with(run, *keys) -> list:
    return [s for s in run.untraced() if all(k in s.timing for k in keys)]


def mean_per_sample(run, key: str, scale: float = 1.0) -> Optional[float]:
    """The mean of timing[key] over the untraced samples that report it,
    times scale."""
    samples = _with(run, key)
    if not samples:
        return None
    return scale * sum(s.timing[key] for s in samples) / len(samples)


def ratio(run, num: str, den: str) -> Optional[float]:
    """The sum of timing[num] over the sum of timing[den], over the
    untraced samples that report both (None if the denominator is 0)."""
    samples = _with(run, num, den)
    total = sum(s.timing[den] for s in samples)
    return sum(s.timing[num] for s in samples) / total if total else None


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The intervals merged where they overlap or nest, in order."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """The length both of two merged, ordered lists of intervals cover."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_idle_share(run, span: str) -> Optional[float]:
    """The share of the host time covered by the traced samples' records
    of span `span` ("srt.<span>") in which no device record ran, in %.
    None without such records or without any device record (off a card)."""
    windows = union((e.start, e.end) for e in run.events if not e.device and e.name == PREFIX + span)
    device = union((e.start, e.end) for e in run.events if e.device)
    total = sum(b - a for a, b in windows)
    if total <= 0 or not device:
        return None
    return 100.0 * (1.0 - overlap(device, windows) / total)
