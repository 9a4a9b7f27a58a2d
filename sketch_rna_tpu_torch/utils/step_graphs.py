"""CUDA graphs of one match call's batch steps (pipeline.match_scan).

A batch step whose shapes are static (the sketch and probe of a
fused-kernel length group; the expansion and grouping at known event
widths) is captured once into a torch.cuda.CUDAGraph and replayed for
every later batch of the same shapes, so a batch costs the host a few
copies and one graph launch instead of ~90 kernel launches.  The graphs
live as long as their StepGraphs, which pipeline.match_scan makes for
one call; they share one memory pool (torch.cuda.graph_pool_handle()).
The warm-ups run on one side stream a device, which the process keeps,
so a call's warm-ups reuse the memory the previous call's left cached.

run(key, fn, *inputs) returns fn(*inputs):

  - on the CPU it calls fn (the same code the graphs capture, so the CPU
    tests run it);
  - on a card, the first call of a key runs fn eagerly on a side stream
    (the warm-up: its result is this call's, and the kernel library is
    built and loaded by then), then captures fn into a graph whose static
    inputs are copies of these inputs; each later call of the key copies
    its inputs into them and replays.  A replay's outputs are the
    graph's own tensors: the graphs share one pool, so another key's
    replay may overwrite them, and the caller copies them out before the
    next run call.

A capture that fails raises; nothing falls back to running eagerly.

Each capture (its warm-up, capture and instantiate) is the span
graphs.capture of the quant call's timer (utils/timing.py), and counts
graphs.captures and graphs.reserved_bytes: torch.cuda.memory_reserved()
after it less before it, an allocator statistic read on the host, no
device sync.  A StepGraphs declares the span and both counters, so they
read 0 where nothing is captured (the CPU).

The kernel wrappers count launches on the host (utils/profiling.py
counters), so a replay would not advance them: each graph keeps the
counts its capture added (and takes them back, since a capture launches
nothing), and each replay adds them again.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, List, Tuple

import torch

from sketch_rna_tpu_torch.utils.timing import count, declare, phase


@dataclasses.dataclass
class _Graph:
    graph: object  # torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    outputs: object  # what fn returned while captured
    launches: Dict[str, int]  # kernel launches one replay makes, by counter name


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
    """The graphs of one match call on one device, keyed by their step's
    static shapes (see the module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: Dict[Hashable, _Graph] = {}
        declare("graphs.capture")
        count("graphs.captures", 0)
        count("graphs.reserved_bytes", 0)
        if self.device.type == "cuda":
            from sketch_rna_tpu_torch.utils.profiling import counters

            self.counters = counters()
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = _side_stream(self.device)

    def run(self, key: Hashable, fn: Callable, *inputs: torch.Tensor):
        if self.device.type != "cuda":
            return fn(*inputs)
        entry = self.graphs.get(key)
        if entry is None:
            reserved = torch.cuda.memory_reserved(self.device)
            with phase("graphs.capture", inner=True):
                out = self._capture(key, fn, inputs)
            count("graphs.captures")
            count("graphs.reserved_bytes", torch.cuda.memory_reserved(self.device) - reserved)
            return out
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

    def _capture(self, key: Hashable, fn: Callable, inputs: Tuple[torch.Tensor, ...]):
        current = torch.cuda.current_stream(self.device)
        static = [x.clone() for x in inputs]  # on the caller's stream, which copies into them
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*inputs)  # the warm-up, eager: this call's result
            before = self._read()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
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
        self.graphs[key] = _Graph(graph, static, outputs, launches)
        return out
