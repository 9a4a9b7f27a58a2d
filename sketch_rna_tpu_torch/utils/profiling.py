"""torch.profiler integration (the reference's gprof workflow, and the
JAX package's jax.profiler hook, on the GPU), and the timing helpers
that chip_smoke.py and the profile scripts (scripts/profile_*_torch.py)
share.

Set SKETCH_TPU_PROFILE=/some/dir to capture a trace of the quant engines:
maybe_trace(tag) writes a Chrome trace (CPU activities, and CUDA ones on
a card) to /some/dir/<tag>/trace_<pid>.json, one file per process, to
view in chrome://tracing or Perfetto.  Without the variable it does
nothing.

The timing helpers work on an explicit device:

  wall_ms          host clock, best of `repeats` means over n calls,
                   each ended by a synchronize (any device);
  device_ms        torch.profiler's device time of one call, or of one
                   kernel's launches (a card only);
  launch_split_ms  device ms per launch of each kernel whose name holds a
                   prefix (a card only);
  busy_share       the union of a trace's device intervals over a wall time;
  device_ms_by_name  a trace's device time summed by operation name;
  host_ops         per traced call, the host's CUDA runtime calls
                   (launches, copies, syncs, allocator calls) and the
                   torch operations it dispatched (any device);
  counters / reset_launches / read_launches
                   each hand-written kernel's launch count, kept by its
                   wrapper;
  measure          wall ms, device ms, launches and host operations of
                   one call, together (what the profile scripts report).

A profiler trace on the card can lose device records, so device_ms and
launch_split_ms take a trace again until one holds nearly every launch
(see device_ms); a measurement they cannot make raises TraceError.
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

log = logging.getLogger("sketch_rna_tpu_torch.profiling")

PROFILE_ENV = "SKETCH_TPU_PROFILE"
REPS = 50  # calls per device-time measurement
MARK = "spin_kernel"  # torch.cuda._sleep's kernel, which marks where a call starts

# The host's CUDA API calls that host_ops counts, by kind.
_HOST_CALLS = {
    "launch": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"),
    "memcpy": ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset"),
    "sync": ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"),
    "alloc": ("cudaMalloc", "cudaFree", "cudaMallocAsync", "cudaFreeAsync", "cudaHostAlloc", "cudaMallocHost",
              "cudaFreeHost", "cudaHostRegister", "cudaHostUnregister"),
}


class TraceError(RuntimeError):
    """A profiler trace that cannot give the time asked for: too few of
    the calls' device records, or none with device time."""


@contextlib.contextmanager
def maybe_trace(tag: str):
    """Trace the enclosed block if SKETCH_TPU_PROFILE is set."""
    out_dir = os.environ.get(PROFILE_ENV)
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out_dir, tag)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log.info("capturing a torch.profiler trace -> %s", path)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, f"trace_{os.getpid()}.json"))


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn: Callable[[], object], device, n: int = 20, repeats: int = 3) -> float:
    """Host milliseconds of one call of fn(): one call to warm up, then
    the best of `repeats` means over n calls, each run of n ended by a
    synchronize of `device`, so the device's work is inside the time."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync(device)
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


def cuda_events(prof) -> list:
    """The device records of a torch.profiler trace."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def whole_calls(events):
    """The device operations of each call that a trace holds whole: the
    runs between consecutive marks whose length is the most common one.
    A lost record shortens its call's run and a lost mark merges two
    runs; either way that run is left out."""
    runs, cur = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if MARK in e.name:
            if cur is not None:
                runs.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e)
    if not runs:
        return []
    lengths = [len(r) for r in runs]
    n = max(set(lengths), key=lengths.count)
    return [r for r in runs if len(r) == n]


def _warm_up(fn, arg_sets):
    """One call on each argument set and one more: the outputs a timed
    loop holds (one a set, see device_ms), with the caching allocator
    holding the spare block the loop's next output takes, so no trace
    allocates device memory."""
    held = [None] * len(arg_sets)
    for r in range(len(arg_sets) + 1):
        held[r % len(arg_sets)] = fn(*arg_sets[r % len(arg_sets)])
    torch.cuda.synchronize()
    return held


def retake(take: Callable[[], object], size: Callable[[object], int], done: Callable[[object], bool],
           tries: int = 8):
    """The fullest of up to `tries` takes of a trace: take() again until
    done(the fullest so far), keeping the first take of the largest
    size().  Returns (the fullest, each take's size)."""
    best, counts = None, []
    for _ in range(tries):
        got = take()
        counts.append(size(got))
        if best is None or counts[-1] > size(best):
            best = got
        if done(best):
            break
    return best, counts


def device_ms(fn, arg_sets: Sequence[tuple], kernel=None, reps=None) -> float:
    """Mean device time of one call of fn(*args), in ms: torch.profiler
    over `reps` calls after a warm-up, cycling through arg_sets.  With
    `kernel` (a substring of a kernel's name) the mean time of that
    kernel's traced launches; else the mean, over the calls the trace
    holds whole (whole_calls), of the sum of each call's device
    operations.  The host's share of a call is left out.

    Each call's output is held until its input comes round again, so
    the outputs too cycle through as many buffers as arg_sets: a call
    writes to memory the L2 no longer holds, and its write-back falls
    inside the timed calls, as on the main path.

    A trace on the card can lose some of its device records (1 to 3 of
    50 in most traces, all of them in some).  So a trace is taken again
    until one holds nine tenths of the launches or whole calls, at most
    eight times, keeping the fullest, which must hold half of them."""
    from torch.profiler import ProfilerActivity, profile

    if reps is None:
        reps = REPS
    held = _warm_up(fn, arg_sets)

    def take():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for r in range(reps):
                if kernel is None:
                    torch.cuda._sleep(0)
                held[r % len(arg_sets)] = fn(*arg_sets[r % len(arg_sets)])
            if kernel is None:
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        events = cuda_events(prof)
        return [e for e in events if kernel in e.name] if kernel is not None else whole_calls(events)

    best, counts = retake(take, len, lambda got: len(got) >= reps - reps // 10)
    del held
    if len(set(counts)) > 1:
        print(f"[trace] traces of {kernel or 'a call'} held {counts} {'launches' if kernel else 'whole calls'} "
              f"of {reps}; the fullest is used")
    if not (reps + 1) // 2 <= len(best) <= reps:
        raise TraceError(f"{len(best)} {'launches of ' + kernel if kernel else 'whole calls'} traced in {reps} calls")
    if kernel is not None:
        ms = sum(e.time_range.elapsed_us() for e in best) / len(best) / 1e3
    else:
        ms = sum(e.time_range.elapsed_us() for run in best for e in run) / len(best) / 1e3
    if ms <= 0:
        raise TraceError(f"no device time traced for {kernel or 'a call'}")
    return ms


def launch_split_ms(fn, arg_sets: Sequence[tuple], prefix: str, reps=None) -> Dict[str, Tuple[float, int]]:
    """Mean device ms per launch of each kernel whose name holds `prefix`
    in calls of fn(*args) (torch.profiler, as device_ms; a kernel is
    named by the identifier before its template or argument list), and
    how many launches of each the trace held.  Outputs are held as in
    device_ms.  A trace that lost records is taken again as in device_ms:
    until each kernel traced holds nine tenths of the calls' launches,
    at most eight times, keeping the trace with the most launches."""
    from torch.profiler import ProfilerActivity, profile

    reps = reps or REPS
    held = _warm_up(fn, arg_sets)

    def take():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for r in range(reps):
                held[r % len(arg_sets)] = fn(*arg_sets[r % len(arg_sets)])
            torch.cuda.synchronize()
        times = defaultdict(list)
        for e in cuda_events(prof):
            if prefix in e.name:
                times[re.search(rf"{prefix}\w*", e.name).group(0)].append(e.time_range.elapsed_us())
        return times

    best, counts = retake(take, lambda t: sum(map(len, t.values())),
                          lambda t: bool(t) and all(len(us) >= reps - reps // 10 for us in t.values()))
    del held
    if len(set(counts)) > 1:
        print(f"[trace] traces of {prefix} kernels held {counts} launches in {reps} calls; the fullest is used")
    if not best:
        raise TraceError(f"no {prefix} kernel traced")
    split = {name: (sum(us) / len(us) / 1e3, len(us)) for name, us in best.items()}
    if not all(ms > 0 for ms, _ in split.values()):
        raise TraceError(f"a {prefix} kernel traced no device time: {split}")
    return split


def busy_share(events: Iterable, wall_s: float) -> Tuple[float, float]:
    """(busy seconds, busy share of wall_s): the union of the events'
    time ranges (microseconds, as torch.profiler gives them), so
    overlapping and nested intervals count once."""
    busy, end = 0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
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


def device_ms_by_name(events: Iterable, top: int = 15) -> List[Tuple[str, float, int]]:
    """(name, device ms, records) of a trace's device records summed by
    op_name, the `top` largest first."""
    ms, count = defaultdict(float), defaultdict(int)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = op_name(e.name)
            ms[name] += e.time_range.elapsed_us() / 1e3
            count[name] += 1
    return sorted(((name, ms[name], count[name]) for name in ms), key=lambda r: -r[1])[:top]


def host_ops(events: Iterable, calls: int = 1) -> Dict[str, float]:
    """The host's work per traced call, from a trace's CPU records: its
    CUDA runtime calls by kind (launch, memcpy: copies and memsets,
    sync: stream / device / event synchronizes, alloc: the allocator's
    cudaMalloc / cudaFree and host-memory calls) and torch_ops, the
    torch operations it dispatched (top-level aten:: records).  Each
    count is divided by `calls`, the calls the trace held."""
    kind_of = {name: kind for kind, names in _HOST_CALLS.items() for name in names}
    counts = dict.fromkeys((*_HOST_CALLS, "torch_ops"), 0)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        kind = kind_of.get(e.name)
        if kind is not None:
            counts[kind] += 1
        elif e.name.startswith("aten::") and e.cpu_parent is None:
            counts["torch_ops"] += 1
    return {kind: n / max(calls, 1) for kind, n in counts.items()}


def counters() -> Dict[str, Tuple[object, str]]:
    """Each kernel wrapper's launch count (name -> (object, attribute))."""
    from sketch_rna_tpu_torch.em.segsum import segsum_apply
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
    from sketch_rna_tpu_torch.match import row_sort
    from sketch_rna_tpu_torch.match.bucket_lookup import bucket_lookup

    return {"K1": (fused_sketch, "launches"), "K2": (fused_sketch_multik, "launches"),
            "K3": (nthash_sketch, "launches"), "K4": (row_sort.row_sort, "launches"),
            "K4-int64": (row_sort.row_sort, "launches_i64"), "merge": (row_sort.merge_pairs, "launches"),
            "merge-partition": (row_sort.merge_partition, "launches"),
            "P": (bucket_lookup, "launches"), "S": (segsum_apply, "launches")}


def reset_launches() -> None:
    for obj, attr in counters().values():
        setattr(obj, attr, 0)


def read_launches() -> Dict[str, int]:
    return {name: getattr(obj, attr) for name, (obj, attr) in counters().items()}


def launches_of(fn: Callable[[], object], device) -> Dict[str, int]:
    """The kernel launches of one call of fn(), by name (0s omitted):
    every count set to 0 just before the call and read just after."""
    reset_launches()
    fn()
    sync(device)
    return {name: n for name, n in read_launches().items() if n}


def traced(fn: Callable[[], object], device, calls: int = 1) -> Tuple[List, float]:
    """Run fn() `calls` times under torch.profiler (CPU records, and CUDA
    ones on a card; no shapes recorded, to keep the tracer's own cost
    down).  Returns (the trace's records, the traced wall seconds, read
    after a synchronize and before the profiler's teardown)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync(device)
        wall = time.perf_counter() - t0
    return list(prof.events()), wall


def measure(fn: Callable[[], object], device, calls: int = 20) -> dict:
    """wall ms (best of 3 means over `calls` calls), device ms (over
    2.5 x `calls` calls; None off the card: not measured), launches by
    kernel and host operations per call (over calls / 2) of fn()."""
    device = torch.device(device)
    trace_calls = max(calls // 2, 1)
    out = {"wall_ms": wall_ms(fn, device, n=calls),
           "device_ms": device_ms(fn, [()], reps=calls * 5 // 2) if device.type == "cuda" else None,
           "launches": launches_of(fn, device)}
    events, _ = traced(fn, device, trace_calls)
    out["host_ops"] = host_ops(events, trace_calls)
    return out
