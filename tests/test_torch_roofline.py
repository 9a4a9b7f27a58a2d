"""utils/roofline.py and the counts a fused quant leaves for it.

  - bound and the `*_work` rules reproduce the bounds of PERF.md §6's
    kernel table (pinning the move of the yardstick out of chip_smoke.py);
  - roofline's arithmetic on a hand-made sizes and timing;
  - the fused CPU quant fills all seven QuantResult.sizes keys, and the
    keys that mean the same quantity as the JAX package's equal them
    (reads_padded and hash_windows where batch_size divides the reads;
    em_lanes and em_width_max on the per-read table);
  - csv_rows equals the JAX package's on the sample at float64: the same
    names in the same order, values within 5e-9 relative (the float64
    fuzz bar of PARITY.md deviation 6) and equal as the CSV prints them.
"""

import os

import numpy as np
import pytest

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import quantify as jax_quantify
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch import pipeline
from sketch_rna_tpu_torch.io.fasta import FastaRecords, load_fasta
from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
from sketch_rna_tpu_torch.io.packing import PackedReads, pack_reads
from sketch_rna_tpu_torch.pipeline import format_cpp_double, quantify
from sketch_rna_tpu_torch.utils import roofline as rf
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
SIZE_KEYS = {"reads_padded", "hash_windows", "hash_ops", "probe_bytes", "group_lanes", "em_lanes", "em_width_max"}


@pytest.mark.parametrize(
    "work,bound_us,by",
    [
        (rf.sort_work(8192, 256, 4), 5.008, "bytes"),  # K4
        (rf.sort_work(8192, 256, 8), 10.016, "bytes"),  # K4-int64
        (rf.merge_work(8192, 32768, 8), 1282.08, "bytes"),  # the merge's wide round
        (rf.sketch_work(8192, 104, (31,), (32,)), 0.978, "bytes"),  # K1
        (rf.sketch_work(8192, 104, (21, 31), (32, 32)), 1.692, "bytes"),  # K2
        (rf.kept_work(8192, 2000, 31, 140), 15.554, "operations"),  # K3
    ],
    ids=["K4", "K4-int64", "merge", "K1", "K2", "K3"],
)
def test_bounds_of_the_kernel_table(work, bound_us, by):
    ms, got_by = rf.bound(*work)
    assert got_by == by
    assert round(ms * 1e3, 3) == pytest.approx(bound_us, abs=1e-9)


def test_roofline_arithmetic():
    sizes = {"reads_padded": 1000, "hash_windows": 70_000, "hash_ops": 10**10, "probe_bytes": 335 * 10**6,
             "group_lanes": 10**7, "em_lanes": 4 * 10**6, "em_width_max": 4}
    timing = {"match": 0.5, "em_assign": 0.25}
    out = rf.roofline(sizes, timing, elapsed_s=1.0, em_iterations=9, em_dtype_bytes=8)
    assert out["sketch"]["frac_ops_peak"] == pytest.approx(1e10 / 0.5 / rf.INT32_OPS_PER_S)
    assert out["probe"]["gb_per_s"] == pytest.approx(0.67)
    assert out["probe"]["frac_hbm_peak"] == pytest.approx(2e-4)
    assert out["group"]["bytes"] == 8 * 10**7 and out["group"]["share"] == pytest.approx(1.6e8 / 3.35e12)
    em = out["em"]
    assert em["bytes"] == 10 * (8 * 4 * 10**6 + 8 * 10**6) and em["ops"] == 10 * 4 * 4 * 10**6
    assert em["frac_hbm_peak"] == pytest.approx(4e8 / 0.25 / 3.35e12)
    assert em["frac_ops_peak"] == pytest.approx(1.6e8 / 0.25 / rf.FLOAT64_OPS_PER_S)
    assert em["share"] == em["frac_hbm_peak"]
    summary = out["summary"]
    assert summary["dominant_bound"] == "sketch"
    assert summary["frac_of_peak"] == out["sketch"]["share"]
    parts = sum(out[s]["share"] * t for s, t in (("sketch", 0.5), ("probe", 0.5), ("group", 0.5), ("em", 0.25)))
    assert summary["bound_s"] == pytest.approx(parts) and summary["frac_of_elapsed"] == pytest.approx(parts)
    assert "H100" in summary["note"]
    f32 = rf.roofline(sizes, timing, 1.0, 9, em_dtype_bytes=4)["em"]
    assert f32["frac_ops_peak"] == pytest.approx(1.6e8 / 0.25 / rf.FLOAT32_OPS_PER_S)
    assert rf.roofline({}, {}, 1.0, 0)["summary"]["dominant_bound"] is None


@pytest.fixture(scope="module")
def problem():
    seqs = synth_transcriptome(np.random.default_rng(5), 150, 300, 900)
    names = [f"T{i}" for i in range(len(seqs))]
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    return seqs, names, text


@pytest.mark.parametrize(
    "ks,n_reads,batch",
    [((31,), 2048, 1024), ((31,), 512, 256), ((21, 31), 512, 256)],
    ids=["k31-classes", "k31-per-read", "k21_31-per-read"],
)
def test_fused_quant_sizes(problem, ks, n_reads, batch):
    seqs, names, text = problem
    idx = jax_build_index(JaxRecords(names, text, 0), JaxConfig(kmer_lengths=ks))
    codes, lengths = sample_reads(seqs, n_reads, 100, 256, seed=6)
    ids = [f"r{i}" for i in range(n_reads)]
    ref = jax_quantify(idx, JaxPacked(codes, lengths, ids),
                       JaxConfig(kmer_lengths=ks, em_dtype="float64", batch_size=batch))
    got = quantify(to_device(idx, "cpu"), PackedReads(codes, lengths, ids),
                   QuantConfig(kmer_lengths=ks, em_dtype="float64", batch_size=batch))
    assert set(got.sizes) == SIZE_KEYS and all(v > 0 for v in got.sizes.values()), got.sizes
    same = ["reads_padded", "hash_windows"] + (["em_lanes", "em_width_max"] if n_reads < 1024 else [])
    assert {k: got.sizes[k] for k in same} == {k: ref.sizes[k] for k in same}
    L = 104  # the reads' width: 100 bases rounded up to 8
    assert got.sizes["hash_windows"] == sum(n_reads * (L - k + 1) for k in ks)
    assert got.sizes["hash_ops"] == 8 * n_reads * L + 8 * got.sizes["hash_windows"]
    out = rf.roofline(got.sizes, got.timing, got.timing["quant_fused"], got.em_iterations)
    assert {"sketch", "probe", "group", "em", "summary"} <= set(out)


def test_long_read_sizes_count_k3():
    """Reads past 1024 windows sketch through K3, which reads the codes
    once a k (kept_work's rule), where K1 / K2 read them once a launch."""
    seqs = synth_transcriptome(np.random.default_rng(9), 20, 1200, 2000)
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    cfg = QuantConfig(kmer_lengths=(21, 31), batch_size=16)
    index = to_device(build_index(FastaRecords([f"T{i}" for i in range(20)], text, 0), cfg, device="cpu"), "cpu")
    codes, lengths = sample_reads([s for s in seqs if s.size >= 1100], 32, 1100, 1104, seed=3)
    got = quantify(index, PackedReads(codes, lengths, []), cfg)
    L = 1104
    assert got.sizes["reads_padded"] == 32
    assert got.sizes["hash_windows"] == sum(32 * (L - k + 1) for k in (21, 31))
    assert got.sizes["hash_ops"] == sum(8 * 32 * L + 8 * 32 * (L - k + 1) for k in (21, 31))


def test_streamed_quant_leaves_sizes_empty(problem, monkeypatch):
    """As in the JAX package, only the fused engine counts sizes."""
    seqs, names, text = problem
    monkeypatch.setattr(pipeline, "FUSED_MAX_PADDED_READS", 0)
    index = to_device(build_index(FastaRecords(names, text, 0), QuantConfig(), device="cpu"), "cpu")
    codes, lengths = sample_reads(seqs, 300, 100, 256, seed=6)
    res = quantify(index, PackedReads(codes, lengths, []), QuantConfig(batch_size=128, stream_chunk_reads=256))
    assert res.sizes == {} and res.has_entry.sum() > 0


def test_csv_rows_equal_jax_on_the_sample():
    recs = load_fasta(os.path.join(EXAMPLES, "sample.fa"))
    reads = load_fastq_dict(os.path.join(EXAMPLES, "sample.fq"))
    idx = jax_build_index(JaxRecords(recs.names, recs.seqs, 0), JaxConfig())
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=31, pad_len=256)
    ref = jax_quantify(idx, JaxPacked(packed.codes, packed.lengths, packed.ids), JaxConfig(em_dtype="float64"))
    got = quantify(to_device(idx, "cpu"), packed, QuantConfig(em_dtype="float64"))
    rows, want = got.csv_rows(), ref.csv_rows()
    assert len(rows) == 30 and [r[0] for r in rows] == [w[0] for w in want]
    np.testing.assert_allclose(np.array([r[1:] for r in rows]), np.array([w[1:] for w in want]), rtol=5e-9, atol=0)
    assert [format_cpp_double(v) for r in rows for v in r[1:]] == [format_cpp_double(v) for w in want for v in w[1:]]
