"""Phase timing, spans and counters of one quant call.

The reference's only instrumentation is one wall clock around the index
build and its phase banners.  A PhaseTimer gives a pipeline phase a
named duration with a derived rate, queryable as a dict
(sketch_rna_tpu/utils/timing.py's counterpart).  A phase that ran device
work names its device: the timer synchronizes it before it reads the
clock, since CUDA calls return before the card has finished.

Each quant call (pipeline.quantify, stream.quantify_streamed,
pipeline.quantify_sharded: the outermost of them, through quant_call)
opens one PhaseTimer, and the code beneath reaches it through a context
variable, with no parameter passed down:

  phase(name, ...)  a span: its host seconds add to durations[name];
                    while a torch.profiler records, it also opens a
                    FUNCTION-scope profiler record "srt.<name>" on the
                    profiler's clock (never a USER_SCOPE one, which the
                    profiler would also put on the device's timeline),
                    so the profiler's records hold the spans' nesting;
  declare(name)     report span `name` as 0 s where it did not run;
  count(name, n)    a counter;
  host_read(x)      x.tolist(), a blocking device-to-host read of the
                    match stage, counted as match.host_reads;
  restart()         empty the timer before a quant call's retry, so the
                    report is the retry's alone.

With no timer open each is a no-op (host_read still reads).  The call's
report (span seconds, rates, counters) lands in QuantResult.timing.  A
tool that calls an engine's inner functions (pipeline.match_scan) opens
a timer itself: `with PhaseTimer().opened() as timer: ...`; a quant call
made under an open timer reports into it.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import logging
import time
from typing import Callable, Dict, Optional

import torch

log = logging.getLogger("sketch_rna_tpu_torch.timing")

# The profiler's record of a span is named PREFIX + the span's name.
PREFIX = "srt."
HOST_READS = "match.host_reads"

_OPEN: contextvars.ContextVar[Optional["PhaseTimer"]] = contextvars.ContextVar("sketch_rna_tpu_torch_timer",
                                                                               default=None)


class PhaseTimer:
    """Accumulates named phase durations, item counts and counters."""

    def __init__(self) -> None:
        self.durations: Dict[str, float] = {}
        self.items: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def opened(self):
        """Make this the open timer of the code beneath (phase, count)."""
        token = _OPEN.set(self)
        try:
            yield self
        finally:
            _OPEN.reset(token)

    @contextlib.contextmanager
    def phase(self, name: str, items: Optional[int] = None, device: Optional[torch.device] = None, *,
              inner: bool = False, record: bool = True):
        """A span.  inner: no log line (the stage spans log theirs).
        record: open the "srt.<name>" profiler record while a profiler
        records (a whole-call span opens none)."""
        rec = None
        if record and torch.autograd.profiler._is_profiler_enabled:
            rec = torch._C._profiler._RecordFunctionFast(PREFIX + name)
            rec.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            if rec is not None:
                rec.__exit__(None, None, None)
            dt = t1 - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            if items is not None:
                self.items[name] = self.items.get(name, 0) + items
            if not inner:
                rate = f" ({items / dt:,.0f}/s)" if items else ""
                log.info("phase %-18s %8.3fs%s", name, dt, rate)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def report(self) -> Dict[str, float]:
        out = dict(self.durations)
        for name, n in self.items.items():
            if self.durations.get(name):
                out[f"{name}_per_s"] = n / self.durations[name]
        out.update(self.counts)
        return out


def phase(name: str, items: Optional[int] = None, device: Optional[torch.device] = None, *, inner: bool = False,
          record: bool = True):
    """The open timer's span (PhaseTimer.phase), or a no-op."""
    timer = _OPEN.get()
    if timer is None:
        return contextlib.nullcontext()
    return timer.phase(name, items, device, inner=inner, record=record)


def declare(name: str) -> None:
    """Report span `name` as 0 s on the open timer where it has not run."""
    timer = _OPEN.get()
    if timer is not None:
        timer.durations.setdefault(name, 0.0)


def count(name: str, n: int = 1) -> None:
    """Add n to the open timer's counter, if a timer is open."""
    timer = _OPEN.get()
    if timer is not None:
        timer.count(name, n)


def restart() -> None:
    """Empty the open timer, if any: a quant call that retries calls this
    first, so its report covers the retry alone."""
    timer = _OPEN.get()
    if timer is not None:
        timer.durations.clear()
        timer.items.clear()
        timer.counts.clear()


def host_read(x: torch.Tensor) -> list:
    """x.tolist(), counted as one match.host_reads."""
    count(HOST_READS)
    return x.tolist()


def quant_call(fn: Callable) -> Callable:
    """Decorate a quant entry point: a call with no timer open opens one
    PhaseTimer and adds its report to the returned QuantResult's timing;
    a call under an open timer (quantify streaming through
    quantify_streamed, a retry, a tool's timer) reports into that one."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _OPEN.get() is not None:
            return fn(*args, **kwargs)
        with PhaseTimer().opened() as timer:
            result = fn(*args, **kwargs)
        result.timing.update(timer.report())
        return result

    return call
