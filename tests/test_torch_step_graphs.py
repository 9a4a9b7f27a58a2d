"""The match stage's graph store (utils/step_graphs.py) on the CPU, with a
stand-in for torch.cuda's capture: a "graph" that, at each replay, runs
the step it was captured from, under the config it was captured with, on
its static inputs and into its outputs.  So a key that left out a config
field a step reads would hand a later call the earlier config's tables.

  - configs that differ in any of the fields the captured steps read
    (sketch_fraction, chain_fraction, candidate_capacity,
    match_per_k_tables) never share a graph, and the same config and
    shapes replay;
  - match_scan calls on one index with configs A, B, A equal a fresh
    index's results, bit for bit;
  - the store goes with its index;
  - at MAX_GRAPHS the least recently used graph goes, counted as
    graphs.evictions;
  - graphs.replays and graphs.captures add up to the lookups;
  - a step that raises while captured leaves the store unlocked and
    without the key.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from sketch_rna_tpu_torch import pipeline
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.pipeline import match_scan
from sketch_rna_tpu_torch.utils import step_graphs
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome
from sketch_rna_tpu_torch.utils.timing import PhaseTimer

B = 32
KS = (21, 31)
# sketch_capacity: every length group's caps at the floor, at either
# sketch_fraction, so the caps in a key cannot tell the fractions apart.
BASE = dict(kmer_lengths=KS, batch_size=B, sketch_capacity=64, sketch_fraction=0.05, chain_fraction=0.9,
            candidate_capacity=2, match_per_k_tables=True)
# Each field the captured steps read, at a value that changes the tables.
OTHER = {"sketch_fraction": 0.02, "chain_fraction": 0.5, "candidate_capacity": 3, "match_per_k_tables": False}


class _Replayed:
    """A stand-in for a captured CUDA graph (see the module docstring)."""

    def __init__(self, fn, static):
        self.fn, self.static = fn, static
        self.outputs = fn(*static)

    def replay(self):
        for out, new in zip(step_graphs._tensors(self.outputs), step_graphs._tensors(self.fn(*self.static))):
            out.copy_(new)


class StandIn(step_graphs.StepGraphs):
    """StepGraphs as on a card, with _Replayed for torch.cuda's graphs;
    LOOKUPS holds the key of every run call."""

    LOOKUPS = []

    def __init__(self, device, store):
        super().__init__(device, store)
        self.graphed, self.counters = True, {}

    def run(self, key, fn, *inputs):
        self.LOOKUPS.append(key)
        return super().run(key, fn, *inputs)

    def _capture(self, fn, inputs):
        static = [x.clone() for x in inputs]
        graph = _Replayed(fn, static)
        return fn(*inputs), step_graphs._Graph(graph, static, graph.outputs, {})


@pytest.fixture(scope="module")
def problem():
    """A 120-transcript artifact at ks (21, 31), and 150 reads in two
    length groups: 100 of 120 bases and 50 of 300."""
    seqs = synth_transcriptome(np.random.default_rng(19), 120, 350, 900)
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    artifact = build_index(FastaRecords([f"T{i}" for i in range(len(seqs))], text, 0),
                           QuantConfig(kmer_lengths=KS), device="cpu")
    c1, l1 = sample_reads(seqs, 100, 120, 512, seed=6)
    c2, l2 = sample_reads(seqs, 50, 300, 512, seed=7)
    return artifact, torch.from_numpy(np.concatenate([c1, c2])), np.concatenate([l1, l2])


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(pipeline, "StepGraphs", StandIn)
    monkeypatch.setattr(StandIn, "LOOKUPS", [])
    return monkeypatch


def _scan(index, problem, cfg):
    """match_scan's tables, padded count and stats as host values, and
    its graph counters."""
    _, codes, lengths = problem
    with PhaseTimer().opened() as timer:
        tid, score, n_padded, stats = match_scan(index, codes, lengths, cfg)
    out = (tid.numpy(), score.numpy(), n_padded, {k: int(v) for k, v in stats.items()})
    return out, {k: v for k, v in timer.counts.items() if k.startswith("graphs.")}


def _eager(monkeypatch, problem, cfg):
    """match_scan on a fresh index with the real StepGraphs (on the CPU:
    every step eager)."""
    with monkeypatch.context() as m:
        m.setattr(pipeline, "StepGraphs", step_graphs.StepGraphs)
        return _scan(to_device(problem[0], "cpu"), problem, cfg)[0]


def _equal(a, b):
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2] and a[3] == b[3])


@pytest.mark.parametrize("field", sorted(OTHER))
def test_configs_never_share_a_graph(problem, stand_in, field):
    base, other = QuantConfig(**BASE), QuantConfig(**dict(BASE, **{field: OTHER[field]}))
    fresh = _eager(stand_in, problem, other)
    index = to_device(problem[0], "cpu")
    first, counts = _scan(index, problem, base)
    assert counts["graphs.captures"] > 0 and counts["graphs.replays"] > 0
    keys = set(index.graphs.entries)
    got, counts = _scan(index, problem, other)
    assert _equal(got, fresh) and not _equal(got, first)
    assert counts["graphs.captures"] == len(set(index.graphs.entries) - keys) > 0
    assert not keys & set(StandIn.LOOKUPS[-(counts["graphs.captures"] + counts["graphs.replays"]):])
    again, counts = _scan(index, problem, base)  # the same config and shapes: every step replays
    assert _equal(again, first) and counts["graphs.captures"] == 0 and counts["graphs.replays"] > 0


def test_configs_a_b_a_equal_a_fresh_index(problem, stand_in):
    a, b = QuantConfig(**BASE), QuantConfig(**dict(BASE, **OTHER))
    index = to_device(problem[0], "cpu")
    want = {cfg: _eager(stand_in, problem, cfg) for cfg in (a, b)}
    assert not _equal(want[a], want[b])
    for cfg in (a, b, a, b):
        got, counts = _scan(index, problem, cfg)
        assert _equal(got, want[cfg]) and counts["graphs.replays"] > 0


@pytest.mark.parametrize("collect", [True, False])
def test_store_goes_with_its_index(problem, stand_in, collect):
    """Without a collection too, once the entries hold what a CUDA graph
    holds: the stand-in's step function, which refers to the index, goes."""
    index = to_device(problem[0], "cpu")
    _scan(index, problem, QuantConfig(**BASE))
    assert index.graphs.entries
    dead = [weakref.ref(index), weakref.ref(index.graphs)]
    gc.disable()
    try:
        if not collect:
            for entry in index.graphs.entries.values():
                entry.graph = object()
        del index
        if collect:
            gc.collect()
        assert [ref() for ref in dead] == [None, None]
    finally:
        gc.enable()


def test_captures_and_replays_add_up_to_the_lookups(problem, stand_in):
    index = to_device(problem[0], "cpu")
    for call in range(3):
        before = len(StandIn.LOOKUPS)
        _, counts = _scan(index, problem, QuantConfig(**BASE))
        lookups = len(StandIn.LOOKUPS) - before
        assert counts["graphs.captures"] + counts["graphs.replays"] == lookups > 0
        assert counts["graphs.captures"] == (len(set(StandIn.LOOKUPS[before:])) if call == 0 else 0)
        assert counts["graphs.evictions"] == 0


def _double(x):
    return x * 2


def test_least_recently_used_graph_goes_at_the_bound():
    store = step_graphs.GraphStore()
    x = torch.arange(4)
    with PhaseTimer().opened() as timer, StandIn("cpu", store) as graphs:
        for key in range(step_graphs.MAX_GRAPHS):
            assert torch.equal(graphs.run(key, _double, x + key), 2 * (x + key))
        assert timer.counts["graphs.evictions"] == 0
        assert torch.equal(graphs.run(0, _double, x + 7), 2 * (x + 7))  # a replay: key 0 is the newest
        graphs.run(step_graphs.MAX_GRAPHS, _double, x)
        assert 1 not in store.entries and 0 in store.entries and len(store.entries) == step_graphs.MAX_GRAPHS
        assert timer.counts["graphs.evictions"] == 1
        graphs.run(1, _double, x)  # captured again; key 2 goes
        assert 2 not in store.entries
    assert timer.counts["graphs.captures"] == step_graphs.MAX_GRAPHS + 2
    assert timer.counts["graphs.replays"] == 1
    assert timer.counts["graphs.evictions"] == 2


def test_failed_capture_raises_and_unlocks_the_store():
    store = step_graphs.GraphStore()

    def broken(x):
        raise ValueError("no")

    with pytest.raises(ValueError), StandIn("cpu", store) as graphs:
        graphs.run("k", broken, torch.zeros(2))
    assert not store.lock.locked() and "k" not in store.entries
    with StandIn("cpu", store) as graphs:
        assert torch.equal(graphs.run("k", _double, torch.ones(2)), torch.full((2,), 2))
