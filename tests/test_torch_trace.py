"""The port's spans and counters (utils/timing.py) on the CPU:

  - PhaseTimer: spans add to durations and rates as before, nest in the
    profiler's records, counters accumulate, and with no timer open the
    module's phase / count are no-ops;
  - each quant entry point reports its stage spans in QuantResult.timing
    under the keys it always had, plus the counters;
  - under torch.profiler the stage spans are FUNCTION-scope "srt.<name>"
    records (never user annotations), the whole call opens none, and the
    torch operations beneath stay top-level by the benchmark's rule; with
    no profiler no record is opened;
  - match.groups, match.host_reads, em.iterations and em.segsum_sums
    count what the engines do, and a retried quant reports the retry
    alone.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from perfbench import tracing
from sketch_rna_tpu_torch import pipeline, stream
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.pipeline import length_groups, quantify, quantify_sharded
from sketch_rna_tpu_torch.stream import quantify_streamed
from sketch_rna_tpu_torch.utils import timing
from sketch_rna_tpu_torch.utils.profiling import host_ops
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome
from sketch_rna_tpu_torch.utils.timing import PhaseTimer

STAGES = {"fused": {"match", "classes", "em_assign", "quant_fused", "quant_fused_per_s", "index_upload"},
          "streamed": {"stream_match", "classes", "em_assign", "index_upload"},
          "sharded": {"stream_match", "classes", "em_assign"}}
COUNTERS = {"graphs.capture", "graphs.captures", "graphs.replays", "graphs.evictions", "graphs.reserved_bytes",
            "match.groups", "match.host_reads", "match.eager_batches", "match.eager_sketch",
            "match.group_kernel_batches", "em.iterations", "em.segsum_sums"}
GRAPHS = {"graphs.capture", "graphs.captures", "graphs.replays", "graphs.evictions", "graphs.reserved_bytes"}
# What match_scan declares (the fused and streamed engines' match), beside its graphs.
SCAN = GRAPHS | {"match.eager_batches", "match.eager_sketch", "match.group_kernel_batches"}


@pytest.fixture(scope="module")
def problem():
    """A 40-transcript index at ks (31,) and (21, 31), and 500 reads: 100
    bases, or a mix of 100 and 300 (two length groups)."""
    seqs = synth_transcriptome(np.random.default_rng(11), 40, 300, 700)
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    records = FastaRecords([f"T{i}" for i in range(len(seqs))], text, 0)
    out = {}
    for ks in ((31,), (21, 31)):
        cfg = QuantConfig(kmer_lengths=ks, batch_size=128, stream_chunk_reads=256)
        artifact = build_index(records, cfg, device="cpu")
        out[ks] = (artifact, to_device(artifact, "cpu"), cfg)
    short = sample_reads(seqs, 500, 100, 512, seed=3)
    long = sample_reads(seqs, 500, 300, 512, seed=4)
    out["reads"] = {"one": PackedReads(short[0][:, :128], short[1], []),
                    "two": PackedReads(np.concatenate([short[0][:250], long[0][:250]]),
                                       np.concatenate([short[1][:250], long[1][:250]]), [])}
    return out


def _quant(problem, engine, ks=(31,), reads="one"):
    artifact, index, cfg = problem[ks]
    packed = problem["reads"][reads]
    if engine == "fused":
        return quantify(index, packed, cfg)
    if engine == "streamed":
        return quantify_streamed(index, packed, cfg)
    return quantify_sharded(artifact, packed, cfg, device="cpu")


def test_spans_add_durations_and_rates():
    timer = PhaseTimer()
    for items in (10, 30):
        with timer.phase("a", items=items):
            pass
    with timer.phase("a"):
        pass
    report = timer.report()
    assert timer.items == {"a": 40} and report["a_per_s"] == pytest.approx(40 / report["a"])
    assert set(report) == {"a", "a_per_s"} and report["a"] > 0


def test_nesting_records_the_parent():
    """Under a profiler each span's record nests in its parent's."""
    from torch.profiler import ProfilerActivity, profile

    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("outer"):
            with timer.phase("inner", inner=True):
                with timer.phase("innermost", inner=True):
                    pass
            with timer.phase("second", inner=True):
                pass
    records = {e.name: e for e in _srt(prof.events())}
    assert {name: e.cpu_parent.name if e.cpu_parent is not None else None for name, e in records.items()} == {
        "srt.outer": None, "srt.inner": "srt.outer", "srt.innermost": "srt.inner", "srt.second": "srt.outer"}
    ranges = {name: e.time_range for name, e in records.items()}
    assert ranges["srt.outer"].start <= ranges["srt.inner"].start <= ranges["srt.inner"].end \
        <= ranges["srt.second"].start
    assert set(timer.durations) == {"outer", "inner", "innermost", "second"}


def test_declare_reports_a_span_that_did_not_run():
    timer = PhaseTimer()
    with timer.opened():
        timing.declare("a")
        with timing.phase("b", inner=True):
            pass
        timing.declare("b")
    assert timer.report()["a"] == 0.0 and timer.report()["b"] > 0


def test_count_accumulates_into_the_report():
    timer = PhaseTimer()
    with timer.opened():
        timing.count("c")
        timing.count("c", 3)
        timing.count("z", 0)
        assert timing.host_read(torch.tensor([4, 5])) == [4, 5]
    assert timer.counts == {"c": 4, "z": 0, "match.host_reads": 1}
    assert timer.report() == {"c": 4, "z": 0, "match.host_reads": 1}


def test_with_no_timer_open_phase_and_count_do_nothing():
    timer = PhaseTimer()
    assert timing._OPEN.get() is None
    with timing.phase("x", items=3):
        timing.count("c")
        assert timing.host_read(torch.tensor([7])) == [7]
    assert timer.report() == {}
    with timer.opened():
        pass
    with timing.phase("x"):
        timing.count("c")
    assert timer.report() == {} and timing._OPEN.get() is None


def test_inner_spans_do_not_log(caplog):
    timer = PhaseTimer()
    with caplog.at_level(logging.INFO, logger="sketch_rna_tpu_torch.timing"):
        with timer.phase("stage"):
            with timer.phase("graphs.capture", inner=True):
                pass
    assert [r.getMessage().split()[1] for r in caplog.records] == ["stage"]


@pytest.mark.parametrize("engine", ["fused", "streamed", "sharded"])
def test_each_engine_reports_its_stage_keys_and_counters(problem, engine):
    res = _quant(problem, engine)
    # The sharded engine's batch step runs eagerly: it makes no graphs and no match_scan.
    assert set(res.timing) == STAGES[engine] | (COUNTERS - SCAN if engine == "sharded" else COUNTERS)
    assert all(res.timing[key] > 0 for key in STAGES[engine] - {"index_upload"})
    assert all(res.timing[key] == 0 for key in SCAN & set(res.timing))  # no card, no capture, no K3
    assert res.timing["em.iterations"] == res.em_iterations > 0


def test_quantify_streaming_reports_once(problem, monkeypatch):
    """quantify streams through quantify_streamed: one timer, one report."""
    monkeypatch.setattr(pipeline, "FUSED_MAX_PADDED_READS", 0)
    res = _quant(problem, "fused")
    assert set(res.timing) == STAGES["streamed"] | COUNTERS
    assert res.timing["em.iterations"] == res.em_iterations


def test_an_enclosing_call_timer_takes_the_spans(problem):
    with PhaseTimer().opened() as timer:
        res = _quant(problem, "fused")
    assert res.timing == {"index_upload": problem[(31,)][1].upload_s}
    assert set(timer.report()) == STAGES["fused"] - {"index_upload"} | COUNTERS
    assert timer.counts["em.iterations"] == res.em_iterations


def _srt(events):
    return [e for e in events if e.name.startswith(timing.PREFIX)]


def test_profiler_sees_function_scope_stage_records(problem):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _quant(problem, "fused")
    events = prof.events()
    srt = _srt(events)
    assert {e.name for e in srt} == {"srt.match", "srt.classes", "srt.em_assign"}
    assert not any(e.is_user_annotation for e in srt)
    under = [e for e in events if e.name.startswith("aten::") and e.cpu_parent is not None
             and e.cpu_parent.name.startswith(timing.PREFIX)]
    assert {e.cpu_parent.name for e in under} == {"srt.match", "srt.classes", "srt.em_assign"}
    # The benchmark's rule (perfbench/tracing.py) and host_ops: still top-level torch operations.
    evs = tracing.from_profiler(events)
    tops = {(e.name, e.start) for e in evs if e.top_op}
    assert all((e.name, float(e.time_range.start)) in tops for e in under)
    assert host_ops(events)["torch_ops"] == tracing.host_ops(evs)["torch_ops"] >= len(under) > 0


def test_no_profiler_opens_no_record(problem, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(*args, **kwargs):
        made.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    _quant(problem, "fused")
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert _srt(prof.events()) == []
    with profile(activities=[ProfilerActivity.CPU]):
        _quant(problem, "fused")
    assert sorted(set(made)) == ["srt.classes", "srt.em_assign", "srt.match"]


@pytest.mark.parametrize("ks,reads,host_reads_per_group", [((31,), "one", 2), ((31,), "two", 1.5),
                                                            ((21, 31), "one", 3), ((21, 31), "two", 2)])
def test_fused_counts_groups_reads_and_iterations(problem, ks, reads, host_reads_per_group):
    """A length group's sizes read, then one stats read a call, and at two
    ks one per-k spill read a call."""
    res = _quant(problem, "fused", ks, reads)
    packed = problem["reads"][reads]
    groups = len(length_groups(packed.lengths, packed.codes.shape[1]))
    assert res.timing["match.groups"] == groups == (1 if reads == "one" else 2)
    assert res.timing["match.host_reads"] == host_reads_per_group * groups
    assert res.timing["em.iterations"] == res.em_iterations


@pytest.mark.parametrize("engine", ["fused", "streamed", "sharded", "checkpointed"])
@pytest.mark.parametrize("segsum", ["on", "off"])
def test_segsum_sums_count_the_sums_s_takes(problem, tmp_path, engine, segsum):
    """em.segsum_sums: one a segmented sum, an EM iteration's and the
    assignment's two (segsum_plain on the CPU), over every checkpoint
    segment; 0 on the scatter route, which em_assign declares."""
    artifact, index, cfg = problem[(31,)]
    cfg = dataclasses.replace(cfg, em_segsum=segsum)
    packed = problem["reads"]["one"]
    if engine == "checkpointed":
        cfg = dataclasses.replace(cfg, em_checkpoint=str(tmp_path / "em.npz"), em_checkpoint_every=3)
        res = quantify(index, packed, cfg)
    elif engine == "fused":
        res = quantify(index, packed, cfg)
    elif engine == "streamed":
        res = quantify_streamed(index, packed, cfg)
    else:
        res = quantify_sharded(artifact, packed, cfg, device="cpu")
    assert res.em_iterations > 3
    assert res.timing["em.segsum_sums"] == (res.em_iterations + 2 if segsum == "on" else 0)


def _streamed_host_reads(res, config, groups: int, chunks: int) -> int:
    """The streamed chunk loop's reads: its groups' sizes, and a chunk's
    n_cand_max and torch.unique, and the six boolean-mask indexes of a
    split into narrow and wide classes; a compaction's torch.unique, a
    drain's three copies."""
    split = 0 < config.stream_narrow_width < config.candidate_capacity
    return (groups + chunks * (2 + 6 * split) + res.stats["stream_compactions"]
            + 3 * res.stats["stream_drains"])


@pytest.mark.parametrize("reads", ["one", "two"])
def test_streamed_counts_groups_over_its_chunks(problem, reads):
    """Each chunk's length groups, and per chunk its groups' sizes reads,
    its n_cand_max read and its class dedup's reads."""
    _, index, cfg = problem[(31,)]
    packed = problem["reads"][reads]
    res = _quant(problem, "streamed", reads=reads)
    _, _, chunk = stream._feed_plan(packed, cfg, None)
    starts = range(0, packed.num_reads, chunk)
    groups = sum(len(length_groups(packed.lengths[r0 : r0 + chunk], packed.codes.shape[1])) for r0 in starts)
    assert len(starts) > 1 and res.timing["match.groups"] == groups
    assert res.timing["match.host_reads"] == _streamed_host_reads(res, cfg, groups, len(starts))
    assert res.timing["em.iterations"] == res.em_iterations


@pytest.mark.parametrize("engine", ["streamed", "sharded"])
def test_a_retry_reports_the_retry_alone(problem, monkeypatch, engine):
    """A wide class block that spills reruns the chunk loop at full width:
    the timer starts empty for the rerun, so stream_match, match.groups
    and match.host_reads are the rerun's alone, as a fresh timing dict
    made them before the spans."""
    artifact, index, cfg = problem[(31,)]
    cfg = dataclasses.replace(cfg, stream_narrow_width=2)
    packed = problem["reads"]["one"]
    monkeypatch.setattr(stream, "WIDE_BLOCK_ROWS", 1)
    seen = []
    real = stream.stream_classes

    def stream_classes(*args, **kwargs):
        timer = timing._OPEN.get()
        before = dict(timer.report())
        classes = real(*args, **kwargs)
        seen.append((before, classes.stats["wide_spilled"], dict(timer.report())))
        return classes

    monkeypatch.setattr(stream, "stream_classes", stream_classes)
    def quant(config):
        if engine == "streamed":
            return quantify_streamed(index, packed, config)
        return quantify_sharded(artifact, packed, config, device="cpu")

    res = quant(cfg)
    assert [spilled > 0 for _, spilled, _ in seen] == [True, False]
    (_, _, first), (before, _, after) = seen
    assert first["match.groups"] > 0 and before == {}
    for key in ("stream_match", "match.groups", "match.host_reads"):
        assert res.timing[key] == after[key]
    _, _, chunk = stream._feed_plan(packed, cfg, None)
    chunks = -(-packed.num_reads // chunk)
    assert res.timing["match.groups"] == first["match.groups"] == chunks
    alone = quant(dataclasses.replace(cfg, stream_narrow_width=0))
    assert all(res.timing[key] == alone.timing[key] for key in ("match.groups", "match.host_reads", "em.iterations"))
    assert res.timing["em.iterations"] == res.em_iterations
