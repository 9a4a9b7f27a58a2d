"""What a --trace 1 run reads from torch.profiler, and the arithmetic every
per-layer metric shares.

busy_share, op_name, device_ms_by_name and host_ops are frozen copies of
the port's sketch_rna_tpu_torch/utils/profiling.py functions of those
names, working on Ev records: a trace is turned into Ev records once, so
the metric readers and their tests need no profiler.  A busy share from
a trace is a floor: a trace on the card can lose a few device records.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

# The harness's span around each sample's quant (a CPU record; its device
# annotation is no operation and is left out of the device records).
SAMPLE_SPAN = "perfbench.sample"
_RUNTIME_CALLS = {
    "launch": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
               "cuGraphLaunch"),
    "memcpy": ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset"),
    "sync": ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"),
    "alloc": ("cudaMalloc", "cudaFree", "cudaMallocAsync", "cudaFreeAsync", "cudaHostAlloc", "cudaMallocHost",
              "cudaFreeHost", "cudaHostRegister", "cudaHostUnregister"),
}


@dataclasses.dataclass(frozen=True)
class Ev:
    """One trace record: its name, start and end (microseconds, the
    profiler's clock), whether it ran on the device, and, for a host
    record, whether it is a torch operation that no other torch operation
    called (a top-level aten:: record)."""

    name: str
    start: float
    end: float
    device: bool
    top_op: bool = False


def from_profiler(events) -> List[Ev]:
    """Ev records of torch.profiler's prof.events()."""
    import torch

    out = []
    for e in events:
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if on_device and e.name.startswith("perfbench."):
            continue
        top = False
        if not on_device and e.name.startswith("aten::"):
            top, parent = True, e.cpu_parent
            while parent is not None:
                if parent.name.startswith("aten::"):
                    top = False
                    break
                parent = parent.cpu_parent
        out.append(Ev(e.name, float(e.time_range.start), float(e.time_range.end), on_device, top))
    return out


def busy_share(events: Iterable[Ev], wall_s: float) -> Tuple[float, float]:
    """(busy seconds, busy share of wall_s): the union of the device
    records' intervals, so overlapping ones count once."""
    busy, end = 0.0, None
    for a, b in sorted((e.start, e.end) for e in events if e.device):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_s = busy / 1e6
    return busy_s, (busy_s / wall_s if wall_s > 0 else 0.0)


def op_name(name: str) -> str:
    """A device record's name without its return type, template and
    argument lists ("void at::native::(anonymous namespace)::f<...>(...)"
    -> "at::native::f")."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    return re.split(r"[<(]", s, maxsplit=1)[0].strip() or name


def device_ms_by_name(events: Iterable[Ev], top: int = 10) -> List[Tuple[str, float, int]]:
    """(name, device ms, records) of the device records summed by op_name,
    the `top` largest first."""
    ms, count = defaultdict(float), defaultdict(int)
    for e in events:
        if e.device:
            name = op_name(e.name)
            ms[name] += (e.end - e.start) / 1e3
            count[name] += 1
    return sorted(((name, ms[name], count[name]) for name in ms), key=lambda r: -r[1])[:top]


def host_ops(events: Iterable[Ev]) -> Dict[str, int]:
    """The host's CUDA runtime calls by kind (launch, memcpy, sync, alloc)
    and torch_ops, the top-level torch operations, among the records."""
    kind_of = {name: kind for kind, names in _RUNTIME_CALLS.items() for name in names}
    counts = dict.fromkeys((*_RUNTIME_CALLS, "torch_ops"), 0)
    for e in events:
        if e.device:
            continue
        kind = kind_of.get(e.name)
        if kind is not None:
            counts[kind] += 1
        elif e.top_op:
            counts["torch_ops"] += 1
    return counts


def idle_gaps(events: List[Ev], t0: float, t1: float, top: int = 10) -> List[Tuple[str, float]]:
    """The `top` longest stretches of [t0, t1] (microseconds) in which no
    device record ran, each named by the host record that overlaps it
    most ("host: <name>"), or "no host record"; (name, seconds)."""
    gaps, end = [], t0
    for a, b in sorted((e.start, e.end) for e in events if e.device):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
    if end < t1:
        gaps.append((end, t1))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    host = [e for e in events if not e.device and not e.name.startswith("perfbench.")]
    out = []
    for a, b in gaps:
        best, name = 0.0, "no host record"
        for e in host:
            overlap = min(b, e.end) - max(a, e.start)
            if overlap > best:
                best, name = overlap, f"host: {e.name}"
        out.append((name, (b - a) / 1e6))
    return out
