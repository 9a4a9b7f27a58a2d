"""The port's streaming engine against the JAX package's, and against the
port's fused engine.

Both packages stream the same reads (quantify_streamed called directly,
or quantify with FUSED_MAX_PADDED_READS patched to 0).  Tolerances:
port vs JAX float64 within 1e-9 relative (summation order differs;
PARITY.md deviation 6 allows 5e-9), port streamed vs port fused within
1e-12.  The CSV row set, the iteration count and the loss stats must be
equal.  Cases: default knobs, constant compaction, drains, the narrow /
wide dual buffer fed whole and as 2-bit chunks, and multi-k.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import sketch_rna_tpu_torch.pipeline as port_pipeline
from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.stream import quantify_streamed as jax_streamed
from sketch_rna_tpu_torch.cli import main as port_cli
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.io.packing import Packed2Reads, PackedReads, unpack_codes2
from sketch_rna_tpu_torch.stream import _ClassBuffer, quantify_streamed, stream_retry_config

from util import decode, make_transcriptome, sample_reads

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
LOSS = ("sketch_overflow", "expand_dropped", "candidate_spilled", "class_overflow", "wide_spilled")


def _pack(reads, pad=128):
    codes = np.zeros((len(reads), pad), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    return codes, lens


def _dual_transcriptome(rng):
    """Heavily overlapping transcripts: many wide candidate profiles."""
    base = rng.integers(0, 4, size=400).astype(np.uint8)
    seqs = []
    for _ in range(24):
        a = int(rng.integers(0, 40))
        mut = base.copy()
        pos = rng.integers(0, base.size, size=3)
        mut[pos] = (mut[pos] + 1) % 4
        seqs.append(np.concatenate([mut[a : a + 300], rng.integers(0, 4, size=50).astype(np.uint8)]))
    return seqs


# case -> (seed, transcripts, tx lengths, reads, read len, error rate, config knobs)
CASES = {
    "default": (321, 15, (60, 500), 150, 100, 0.005, dict(kmer_lengths=(31,), batch_size=64)),
    "compaction": (99, 10, (80, 400), 600, 90, 0.005,
                   dict(kmer_lengths=(31,), batch_size=64, stream_class_capacity=128, stream_chunk_reads=192)),
    "drain": (910009, 20, (60, 700), 500, 70, 0.02,
              dict(kmer_lengths=(21,), batch_size=32, stream_class_capacity=64, stream_chunk_reads=32)),
    "dual": (77, None, None, 400, 80, 0.01,
             dict(kmer_lengths=(21,), batch_size=32, candidate_capacity=32, stream_narrow_width=2,
                  stream_chunk_reads=64)),
    "multik": (2024, 18, (80, 600), 700, 100, 0.01,
               dict(kmer_lengths=(21, 31), batch_size=64, stream_class_capacity=256, stream_chunk_reads=128)),
}


def _problem(case):
    seed, n_tx, len_range, n_reads, read_len, err, knobs = CASES[case]
    rng = np.random.default_rng(seed)
    seqs = _dual_transcriptome(rng) if case == "dual" else make_transcriptome(rng, n=n_tx, len_range=len_range)
    recs = JaxRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    jcfg = JaxConfig(max_read_len=128, em_dtype="float64", **knobs)
    idx = jax_build_index(recs, jcfg)
    reads = [r for r in sample_reads(rng, seqs, n_reads=n_reads, read_len=read_len, error_rate=err)
             if r.size >= max(knobs["kmer_lengths"])]
    codes, lens = _pack(reads)
    return idx, codes, lens, jcfg, QuantConfig(em_dtype="float64", **knobs)


@pytest.fixture(scope="module", params=list(CASES))
def problem(request):
    return (request.param, *_problem(request.param))


def _assert_equal(got, ref, rtol):
    assert got.em_iterations == ref.em_iterations
    np.testing.assert_array_equal(got.has_entry, ref.has_entry)
    assert got.has_entry.sum() >= 5
    np.testing.assert_allclose(got.pi, ref.pi, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.weighted_counts, ref.weighted_counts, rtol=rtol, atol=0)
    for key in LOSS:
        assert got.stats.get(key, 0) == int(np.asarray(ref.stats.get(key, 0)).sum()), key


def _chunks2(codes, lens, rows):
    return [PackedReads(codes[s : s + rows], lens[s : s + rows], []).bit_packed() for s in range(0, len(lens), rows)]


def test_port_streamed_equals_jax_streamed(problem):
    case, idx, codes, lens, jcfg, cfg = problem
    ref = jax_streamed(idx, JaxPacked(codes, lens, []), jcfg)
    dev = to_device(idx, "cpu")
    feeds = {"packed": PackedReads(codes, lens, [])}
    if case == "dual":  # also as an iterator of 2-bit chunks
        feeds["packed2"] = iter(_chunks2(codes, lens, 64))
    for feed, reads in feeds.items():
        got = quantify_streamed(dev, reads, cfg, num_reads_hint=len(lens))
        _assert_equal(got, ref, 1e-9)
        assert got.stats["class_overflow"] == 0, feed
        if case == "drain":
            assert got.stats["stream_drains"] > 0
        if case == "compaction":
            assert got.stats["stream_compactions"] > 0


def test_port_streamed_equals_port_fused(problem):
    case, idx, codes, lens, _, cfg = problem
    dev = to_device(idx, "cpu")
    packed = PackedReads(codes, lens, [])
    fused = port_pipeline.quantify(dev, packed, cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pipeline, "FUSED_MAX_PADDED_READS", 0)
        streamed = port_pipeline.quantify(dev, packed, cfg)
    assert streamed.stats["stream_classes"] > 0
    _assert_equal(streamed, fused, 1e-12)
    assert streamed.num_mapped == fused.num_mapped
    assert streamed.num_reads == fused.num_reads == len(lens)


def test_drain_off_counts_class_overflow():
    """The drain case's classes exceed the buffer: without draining the
    engine drops classes and counts their reads (as the JAX engine does)."""
    idx, codes, lens, jcfg, cfg = _problem("drain")
    off = dataclasses.replace(cfg, stream_drain=False)
    got = quantify_streamed(to_device(idx, "cpu"), PackedReads(codes, lens, []), off)
    ref = jax_streamed(idx, JaxPacked(codes, lens, []), dataclasses.replace(jcfg, stream_drain=False))
    assert got.stats["class_overflow"] > 0
    assert int(ref.stats["class_overflow"]) > 0
    assert got.stats["stream_drains"] == 0


def test_wide_spill_reruns_full_width(monkeypatch):
    """A wide side block past its rows spills reads: a replayable feed
    reruns with one full-width buffer and equals the fused run; an
    iterator feed reports the spill and stream_retry_config names the
    rerun."""
    import sketch_rna_tpu_torch.stream as stream_mod

    idx, codes, lens, _, cfg = _problem("dual")
    dev = to_device(idx, "cpu")
    packed = PackedReads(codes, lens, [])
    fused = port_pipeline.quantify(dev, packed, cfg)
    monkeypatch.setattr(stream_mod, "WIDE_BLOCK_ROWS", 1)
    spilled = quantify_streamed(dev, iter([packed]), cfg, num_reads_hint=len(lens))
    assert spilled.stats["wide_spilled"] > 0
    retry, reason = stream_retry_config(cfg, spilled.stats)
    assert retry.stream_narrow_width == 0 and "wide" in reason
    rerun = quantify_streamed(dev, packed, cfg)
    assert rerun.stats["wide_spilled"] == 0
    _assert_equal(rerun, fused, 1e-12)


def test_class_buffer_compact_drain_merge():
    """Unit test of the buffer: appends past capacity compact, then drain;
    the merged classes carry every appended weight exactly."""
    buf = _ClassBuffer(4, 3, drain=True, device=torch.device("cpu"))
    blocks = [
        (torch.tensor([[1, 2], [3, 0]], dtype=torch.int32), torch.tensor([[2, 1], [1, 0]], dtype=torch.int32)),
        (torch.tensor([[1, 2], [5, 0], [6, 0]], dtype=torch.int32), torch.tensor([[2, 1], [1, 0], [1, 0]], dtype=torch.int32)),
        (torch.tensor([[7, 0], [8, 0], [3, 0]], dtype=torch.int32), torch.tensor([[1, 0], [3, 0], [1, 0]], dtype=torch.int32)),
    ]
    want = {}
    for i, (tid, score) in enumerate(blocks):
        weight = torch.arange(1, tid.shape[0] + 1, dtype=torch.int64) * (i + 1)
        assert buf.append((tid, score, weight)) == 0
        for t, s, w in zip(tid.tolist(), score.tolist(), weight.tolist()):
            key = (tuple(t) + (0,), tuple(s) + (0,))
            want[key] = want.get(key, 0) + w
    assert buf.compactions >= 1 and len(buf.drained) >= 1
    tid, score, weight = buf.merged(3)
    got = {(tuple(t), tuple(s)): w for t, s, w in zip(tid.tolist(), score.tolist(), weight.tolist())}
    assert got == want


def test_sample_csv_through_streaming_route(tmp_path, monkeypatch):
    """examples/sample.fq forced through the streamed route: the float64
    CSV is byte-identical to sample.expected.csv."""
    monkeypatch.setattr(port_pipeline, "FUSED_MAX_PADDED_READS", 0)
    idx, out = str(tmp_path / "s.npz"), str(tmp_path / "s.csv")
    fa, fq = os.path.join(EXAMPLES, "sample.fa"), os.path.join(EXAMPLES, "sample.fq")
    assert port_cli(["-o", "index", "--device", "cpu", "-k", "31", fa, idx]) == 0
    assert port_cli(["-o", "quant", "--device", "cpu", "--no-native", "--em-dtype", "float64", idx, fq, out]) == 0
    with open(out, "rb") as a, open(os.path.join(EXAMPLES, "sample.expected.csv"), "rb") as b:
        assert a.read() == b.read()


def test_packed2_feed_roundtrip():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(7, 103)).astype(np.uint8)
    lens = np.full(7, 103, np.int32)
    p2 = PackedReads(codes, lens, []).bit_packed()
    assert isinstance(p2, Packed2Reads) and p2.codes2.shape == (7, 26) and p2.padded_len == 103
    np.testing.assert_array_equal(unpack_codes2(p2.codes2, 103), codes)
    np.testing.assert_array_equal(unpack_codes2(torch.from_numpy(p2.codes2), 103).numpy(), codes)
    from sketch_rna_tpu.io.packing import PackedReads as JP

    np.testing.assert_array_equal(p2.codes2, JP(codes, lens, []).bit_packed().codes2)
