"""CUDA graphs of the match stage's batch steps (pipeline.match_scan),
kept with their index.

A batch step whose shapes are static (the sketch and probe of a
fused-kernel length group; the expansion and grouping at known event
widths) is captured once into a torch.cuda.CUDAGraph and replayed for
every later batch of the same key, so a batch costs the host a few
copies and one graph launch instead of ~90 kernel launches.

The graphs live in a GraphStore, which hangs on its DeviceIndex
(DeviceIndex.graphs) and goes with it: a key captured by one match call
replays in every later call on that index, so a process that quantifies
sample after sample against one index captures each step shape once.
The store holds the graphs, their static inputs, their outputs and their
launch counts, and nothing that refers back to the index (no step
function): `del index` drops them at once, with no garbage-collector
cycle.  Its graphs share one memory pool (torch.cuda.graph_pool_handle(),
made at its first capture).  The warm-ups run on one side stream a
device, which the process keeps, so they reuse the memory the earlier
ones left cached.  The store keeps at most MAX_GRAPHS graphs and drops
the least recently used past that, so a stream of samples with ever new
length groups or batch widths cannot grow it without end.  At
batch_size 8192 and 150-base reads a graph reserves ~40 MiB of the pool
at k = 31 and ~75 MiB at ks (21, 31) (on an H100: 118 MiB for a k = 31
quant's three, ~340 MiB for ~4.5 at (21, 31)), so a full store holds
~0.6-1.2 GiB; a grouping graph's share grows with its event widths.

A key holds everything a captured step reads that can change between
calls on one index: its shapes and the QuantConfig fields the steps read
(pipeline.match_scan's keys).  A replay runs the kernels as captured, so
two calls that would compute a step differently never share a key.

StepGraphs is one match call's front of the store, entered for the
call (`with StepGraphs(device, store) as graphs:`).  Entering it takes
the store's lock, so two threads' match calls on one index run in turn:
a graph's static inputs and outputs are shared.  Calls on one index run
on one stream, or each ends before the next starts (a quant call does:
it reads its result to the host).  graphs.run(key, fn, *inputs) returns
fn(*inputs):

  - on the CPU it calls fn (the same code the graphs capture, so the CPU
    tests run it);
  - on a card, the first call of a key runs fn eagerly on a side stream
    (the warm-up: its result is this call's, and the kernel library is
    built and loaded by then), then captures fn into a graph whose static
    inputs are copies of these inputs; each later call of the key, in
    this match call or a later one, copies its inputs into them and
    replays.  A replay's outputs are the graph's own tensors: the graphs
    share one pool, so another key's replay may overwrite them, and the
    caller copies them out before the next run call.

A capture that fails raises; nothing falls back to running eagerly.

Each capture (its warm-up, capture and instantiate) is the span
graphs.capture of the quant call's timer (utils/timing.py), and counts
graphs.captures and graphs.reserved_bytes: torch.cuda.memory_reserved()
after it less before it, an allocator statistic read on the host, no
device sync.  Each replay counts graphs.replays, and each graph the
bound drops graphs.evictions.  A StepGraphs declares the span and the
four counters, so they read 0 where nothing is captured (the CPU) or
every key was captured by an earlier call.

The kernel wrappers count launches on the host (utils/profiling.py
counters), so a replay would not advance them: each graph keeps the
counts its capture added (and takes them back, since a capture launches
nothing), and each replay adds them again.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from sketch_rna_tpu_torch.utils.timing import count, declare, phase

# The graphs a store keeps (see the module docstring for the memory this
# bounds).  A GENCODE quant of 2^20 150-base reads uses 3 (k = 31) to ~8
# (ks (21, 31), by the batches' event widths).
MAX_GRAPHS = 16


@dataclasses.dataclass
class _Graph:
    graph: object  # torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    outputs: object  # what fn returned while captured
    launches: Dict[str, int]  # kernel launches one replay makes, by counter name


class GraphStore:
    """The captured step graphs of one DeviceIndex, least recently used
    first (see the module docstring)."""

    def __init__(self):
        self.entries: "collections.OrderedDict[Hashable, _Graph]" = collections.OrderedDict()
        self.pool = None  # torch.cuda.graph_pool_handle(), made at the first capture
        self.lock = threading.Lock()  # held by one match call at a time

    def get(self, key: Hashable) -> Optional[_Graph]:
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key: Hashable, entry: _Graph) -> int:
        """Keep entry under key; returns the graphs dropped for it (0 or 1)."""
        self.entries[key] = entry
        if len(self.entries) <= MAX_GRAPHS:
            return 0
        self.entries.popitem(last=False)
        return 1


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


_STREAMS: Dict[int, torch.cuda.Stream] = {}  # device index -> the warm-ups' side stream


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class StepGraphs:
    """One match call's front of a GraphStore on one device (see the
    module docstring)."""

    def __init__(self, device, store: GraphStore):
        self.device = torch.device(device)
        self.store = store
        self.graphed = self.device.type == "cuda"
        declare("graphs.capture")
        for name in ("graphs.captures", "graphs.replays", "graphs.evictions", "graphs.reserved_bytes"):
            count(name, 0)
        if self.graphed:
            from sketch_rna_tpu_torch.utils.profiling import counters

            self.counters = counters()
            self.stream = _side_stream(self.device)

    def __enter__(self) -> "StepGraphs":
        self.store.lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.store.lock.release()

    def run(self, key: Hashable, fn: Callable, *inputs: torch.Tensor):
        if not self.graphed:
            return fn(*inputs)
        entry = self.store.get(key)
        if entry is None:
            reserved = torch.cuda.memory_reserved(self.device)
            with phase("graphs.capture", inner=True):
                out, entry = self._capture(fn, inputs)
            count("graphs.captures")
            count("graphs.reserved_bytes", torch.cuda.memory_reserved(self.device) - reserved)
            count("graphs.evictions", self.store.put(key, entry))
            return out
        count("graphs.replays")
        for buf, x in zip(entry.inputs, inputs):
            buf.copy_(x)
        entry.graph.replay()
        self._add(entry.launches)
        return entry.outputs

    def _read(self) -> Dict[str, int]:
        return {name: getattr(obj, attr) for name, (obj, attr) in self.counters.items()}

    def _add(self, launches: Dict[str, int]) -> None:
        for name, n in launches.items():
            obj, attr = self.counters[name]
            setattr(obj, attr, getattr(obj, attr) + n)

    def _capture(self, fn: Callable, inputs: Tuple[torch.Tensor, ...]):
        """(fn(*inputs) run eagerly, the graph of fn captured on copies of
        the inputs)."""
        if self.store.pool is None:
            self.store.pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        static = [x.clone() for x in inputs]  # on the caller's stream, which copies into them
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*inputs)  # the warm-up, eager: this call's result
            before = self._read()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.store.pool, capture_error_mode="thread_local")
            try:
                outputs = fn(*static)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was already invalid: the first error is the one to raise
                raise
            graph.capture_end()
            after = self._read()
        current.wait_stream(self.stream)
        for t in _tensors(out):  # made on the side stream, read on the caller's
            t.record_stream(current)
        launches = {name: after[name] - before[name] for name in after if after[name] != before[name]}
        self._add({name: -n for name, n in launches.items()})  # the capture launched nothing
        return out, _Graph(graph, static, outputs, launches)
