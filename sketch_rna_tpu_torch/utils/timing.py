"""Phase timing + throughput counters.

The reference's only instrumentation is one wall clock around the index
build and its phase banners.  A PhaseTimer gives a pipeline phase a
named duration with a derived rate, queryable as a dict
(sketch_rna_tpu/utils/timing.py's counterpart).  A phase that ran device
work names its device: the timer synchronizes it before it reads the
clock, since CUDA calls return before the card has finished.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import torch

log = logging.getLogger("sketch_rna_tpu_torch.timing")


class PhaseTimer:
    """Accumulates named phase durations and item counts."""

    def __init__(self) -> None:
        self.durations: Dict[str, float] = {}
        self.items: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, items: Optional[int] = None, device: Optional[torch.device] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            if items is not None:
                self.items[name] = self.items.get(name, 0) + items
            rate = f" ({items / dt:,.0f}/s)" if items else ""
            log.info("phase %-18s %8.3fs%s", name, dt, rate)

    def report(self) -> Dict[str, float]:
        out = dict(self.durations)
        for name, n in self.items.items():
            if self.durations.get(name):
                out[f"{name}_per_s"] = n / self.durations[name]
        return out
