"""Faults of the port that were repaired, each with the check that failed
before, and the port's phase timer and profiler hook:

  - a default quant (no --em-dtype) runs the EM in float64 and writes
    examples/sample.expected.csv byte for byte;
  - LazyScanFeed: iter(feed) without a step leaves the scan to close(),
    which closes it;
  - quantify reports timing["quant_fused"] and a reads/s rate, as the
    JAX package's quantify does; PhaseTimer accumulates like the JAX
    one;
  - maybe_trace writes a trace under SKETCH_TPU_PROFILE and does nothing
    without it.
"""

import os

import numpy as np
import pytest

from sketch_rna_tpu.utils.timing import PhaseTimer as JaxPhaseTimer
from sketch_rna_tpu_torch.cli import build_parser
from sketch_rna_tpu_torch.cli import main as port_cli
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io import native
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.pipeline import quantify
from sketch_rna_tpu_torch.utils.profiling import maybe_trace
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome
from sketch_rna_tpu_torch.utils.timing import PhaseTimer

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def test_default_em_is_float64_and_byte_identical(tmp_path):
    assert QuantConfig().em_dtype == "float64"
    assert build_parser().parse_args([]).em_dtype == "float64"
    idx, out = str(tmp_path / "s.npz"), str(tmp_path / "out.csv")
    assert port_cli(["-o", "index", "--device", "cpu", os.path.join(EXAMPLES, "sample.fa"), idx]) == 0
    assert port_cli(["-o", "quant", "--device", "cpu", idx, os.path.join(EXAMPLES, "sample.fq"), out]) == 0
    with open(out, "rb") as got, open(os.path.join(EXAMPLES, "sample.expected.csv"), "rb") as want:
        assert got.read() == want.read()
    out32 = str(tmp_path / "out32.csv")
    assert port_cli(["-o", "quant", "--device", "cpu", "--em-dtype", "float32", idx,
                     os.path.join(EXAMPLES, "sample.fq"), out32]) == 0
    assert os.path.getsize(out32) > 0


@pytest.mark.parametrize("stepped", [False, True])
def test_lazy_scan_feed_close_after_iter(stepped):
    if not native.native_available():
        pytest.skip(f"native fastio library did not build ({native.so_path()})")
    feed = native.LazyScanFeed(os.path.join(EXAMPLES, "sample.fq"), 31, 64)
    it = iter(feed)
    if stepped:
        first = next(it)
        assert first.num_reads > 0
        it.close()  # the generator's finally closes the scan it took over
    feed.close()
    assert feed._scan is not None and feed._scan._h is None  # the mmap and record table are released
    feed.close()  # idempotent


@pytest.fixture(scope="module")
def small_problem():
    seqs = synth_transcriptome(np.random.default_rng(11), 40, 300, 700)
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    cfg = QuantConfig(batch_size=128)
    idx = build_index(FastaRecords([f"T{i}" for i in range(len(seqs))], text, 0), cfg, device="cpu")
    codes, lengths = sample_reads(seqs, 500, 100, 128, seed=3)
    return to_device(idx, "cpu"), PackedReads(codes, lengths, []), cfg


def test_quantify_reports_quant_fused(small_problem):
    index, packed, cfg = small_problem
    res = quantify(index, packed, cfg)
    t = res.timing
    assert {"match", "classes", "em_assign", "quant_fused", "quant_fused_per_s"} <= set(t)
    assert t["quant_fused"] >= t["match"] + t["classes"] + t["em_assign"] > 0
    assert t["quant_fused_per_s"] == pytest.approx(packed.num_reads / t["quant_fused"])


def test_phase_timer_reports_like_the_jax_one():
    reports = []
    for timer in (PhaseTimer(), JaxPhaseTimer()):
        for items in (10, 30):
            with timer.phase("a", items=items):
                pass
        with timer.phase("b"):
            pass
        reports.append(timer.report())
        assert timer.items == {"a": 40}
    assert reports[0].keys() == reports[1].keys() == {"a", "b", "a_per_s"}
    assert all(v > 0 for v in reports[0].values())


def test_maybe_trace_writes_under_the_profile_dir(small_problem, tmp_path, monkeypatch):
    index, packed, cfg = small_problem
    monkeypatch.delenv("SKETCH_TPU_PROFILE", raising=False)
    with maybe_trace("nothing"):
        pass
    quantify(index, packed, cfg)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("SKETCH_TPU_PROFILE", str(tmp_path))
    quantify(index, packed, cfg)
    traces = list((tmp_path / "quant_fused").iterdir())
    assert len(traces) == 1 and traces[0].name == f"trace_{os.getpid()}.json" and traces[0].stat().st_size > 1000
