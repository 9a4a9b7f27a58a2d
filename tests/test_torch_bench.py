"""bench_torch.py and the port's scale scripts against the JAX package.

- the port's index build on the 25,000-transcript cut of the GENCODE-scale
  transcriptome is bit-equal to the JAX package's, and the digests that
  chip_smoke's gencode phase holds the card's 250,000-transcript builds
  to are the JAX package's build;
- each bench_torch problem (c2, c3, c4, c5) gives bench.py's
  transcriptome and index, and its quant equals the JAX package's on the
  same reads within 1e-9 (float64);
- the standard bench's JSON line, and the guard that keeps every mode
  off the CPU unless asked;
- make_fastq_torch's records read back to the same codes through the
  Python parser and the native one.
All on the CPU, at small read counts.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch
from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import quantify as jax_quantify
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import KIndex, save_index
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io import native
from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
from sketch_rna_tpu_torch.pipeline import quantify, quantify_samples
from sketch_rna_tpu_torch.utils import synth
from sketch_rna_tpu_torch.utils.synth import fasta_records, sample_reads, synth_transcriptome

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPTS = os.path.join(_REPO, "scripts")
sys.path.insert(0, _SCRIPTS)

import make_fastq_torch  # noqa: E402


def _digest(kidx) -> str:
    return KIndex(kidx.keys, kidx.row_ptr, kidx.postings).sha256()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))) if a.size else 0.0


def test_index_build_bit_equal_to_jax_at_25k():
    """The GENCODE-scale transcriptome's generator and seed at 25,000
    transcripts: the port's CPU build equals the JAX package's build."""
    seqs = synth_transcriptome(np.random.default_rng(synth.GENCODE_SEED), 25000)
    recs = fasta_records(seqs)
    mine = build_index(recs, QuantConfig(kmer_lengths=(31,)), device="cpu").per_k[31]
    ref = jax_build_index(JaxRecords(recs.names, recs.seqs, 0), JaxConfig(kmer_lengths=(31,))).per_k[31]
    assert (mine.num_keys, mine.postings.size) == (ref.keys.size, ref.postings.size) == (823245, 1454310)
    assert mine.sha256() == _digest(ref)
    assert mine.sha256().startswith("357db61712d0fe27")


def test_gencode_digests_are_the_jax_build():
    """chip_smoke's gencode phase and bench_torch's GENCODE-scale entries
    hold the 250,000-transcript indexes to GENCODE_INDEX: those are the
    JAX package's build of the same transcriptome at ks (21, 31) (~30 s,
    ~3 GB here)."""
    assert (synth.GENCODE_SEED, synth.GENCODE_TRANSCRIPTS) == (2026, 250000)
    seqs = synth_transcriptome(np.random.default_rng(synth.GENCODE_SEED), synth.GENCODE_TRANSCRIPTS)
    recs = fasta_records(seqs)
    ref = jax_build_index(JaxRecords(recs.names, recs.seqs, 0), JaxConfig(kmer_lengths=(21, 31)))
    got = {k: (int(ki.keys.size), int(ki.postings.size), _digest(ki)) for k, ki in ref.per_k.items()}
    assert got == synth.GENCODE_INDEX


def test_gencode_cache_is_held_to_the_jax_digests(tmp_path, monkeypatch):
    """A cached index that is not the JAX package's GENCODE-scale build
    (here a 40-transcript one under the 250k cache name) is reported as
    skipped, never timed; one whose digests match is used."""
    artifact = build_index(fasta_records(synth.gencode_transcriptome(40)), QuantConfig(kmer_lengths=(31,)),
                           device="cpu")
    path = tmp_path / "T250000_k31.npz"
    assert bench_torch.load_gencode_index(path, (31,))[1].startswith("missing ")
    save_index(str(path), artifact)
    got, why = bench_torch.load_gencode_index(path, (31,))
    assert got is None and "is not the GENCODE-scale index" in why
    fastq = tmp_path / "reads.fq"
    fastq.write_text("@r0\nACGT\n+\nIIII\n")
    entry = bench_torch.stream32m_entry(torch.device("cpu"), tmp_path, fastq)
    assert set(entry) == {"skipped"}
    if native.native_available():
        assert entry["skipped"] == why
    ki = artifact.per_k[31]
    monkeypatch.setitem(synth.GENCODE_INDEX, 31, (ki.num_keys, int(ki.postings.size), ki.sha256()))
    got, why = bench_torch.load_gencode_index(path, (31,))
    assert why is None and got.per_k[31].sha256() == ki.sha256()


# (bench.py config, transcripts, read length, ks, seed), the --configs matrix's sizes.
_CONFIGS = {
    "c2": (6000, 100, (31,), 21),
    "c3": (20000, 100, (21, 31), 22),
    "c4": (50000, 150, (31,), 23),
    "c5": (6000, 100, (31,), 24),
}
_READS = 2048


@pytest.fixture
def jax_bench_tmp(tmp_path, monkeypatch):
    """bench.py's index cache in a fresh directory, always rebuilt."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("SKETCH_TPU_BENCH_NOCACHE", "1")


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_problem_matches_jax_bench(name, jax_bench_tmp):
    n_tx, read_len, ks, seed = _CONFIGS[name]
    p = bench_torch.synth_problem(n_tx, _READS, read_len, ks, seed, "cpu")
    jcfg, jidx, _ = bench._synth_problem(n_tx, _READS, read_len, ks, seed)
    # The same transcriptome and the same index, bit for bit.
    assert p.artifact.names == list(jidx.names)
    np.testing.assert_array_equal(p.artifact.lengths, jidx.lengths)
    assert p.config.max_read_len == jcfg.max_read_len and p.config.batch_size == jcfg.batch_size
    assert tuple(p.config.kmer_lengths) == tuple(jcfg.kmer_lengths) and p.config.em_dtype == jcfg.em_dtype
    for k in ks:
        assert p.artifact.per_k[k].sha256() == _digest(jidx.per_k[k]), k
    assert p.packed.codes.shape == (_READS, jcfg.max_read_len)

    cfg = dataclasses.replace(p.config, em_dtype="float64")
    jcfg = dataclasses.replace(jcfg, em_dtype="float64")
    if name == "c5":
        samples = bench_torch.c5_samples(p, _READS // 4)
        got = quantify_samples(p.index, samples, cfg)
        pairs = [(got[s], jax_quantify(jidx, JaxPacked(r.codes, r.lengths, []), jcfg)) for s, r in samples.items()]
        assert len(pairs) == 4
    elif name == "c4":
        # bench_torch's c4 runs the streamed engine in chunks of 2^20.
        cfg = dataclasses.replace(cfg, stream_chunk_reads=1 << 20)
        with bench_torch.forced_streaming():
            got = quantify(p.index, p.packed, cfg)
        assert "stream_classes" in got.stats
        pairs = [(got, jax_quantify(jidx, JaxPacked(p.packed.codes, p.packed.lengths, []), jcfg))]
    else:
        pairs = [(quantify(p.index, p.packed, cfg), jax_quantify(jidx, JaxPacked(p.packed.codes, p.packed.lengths, []),
                                                                 jcfg))]
    for got, ref in pairs:
        np.testing.assert_array_equal(got.has_entry, ref.has_entry)
        assert got.em_iterations == ref.em_iterations
        assert got.num_reads == ref.num_reads
        assert _rel(got.pi, ref.pi) <= 1e-9
        assert _rel(got.weighted_counts[ref.has_entry], ref.weighted_counts[ref.has_entry]) <= 1e-9


def test_standard_line(capsys):
    """The standard bench's one JSON line: its keys, no vs_baseline, the
    device it ran on, and a roofline of the stages."""
    line = bench_torch.run_standard(device="cpu", n_transcripts=40, n_reads=1024, repeats=1)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == [line]
    assert set(line) == {"metric", "value", "unit", "roofline", "device"}
    assert line["metric"] == "quant_reads_per_s" and line["unit"] == "reads/s" and line["value"] > 0
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert {"sketch", "probe", "group", "em", "summary"} <= set(line["roofline"])


def test_spread_entry():
    entry = bench_torch.spread_entry([3.0, None, 1.0, 2.0], 4, {"name": "cpu", "power_limit": None})
    assert (entry["n"], entry["n_requested"]) == (3, 4)
    assert (entry["median_reads_per_s"], entry["min_reads_per_s"], entry["max_reads_per_s"]) == (2.0, 1.0, 3.0)


def test_no_card_raises(monkeypatch, tmp_path):
    """Asked for the card (the default) where there is none, every mode
    raises before it does any work; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "matrix.json"
    for run in (lambda: bench_torch.run_standard(),
                lambda: bench_torch.run_configs(out=out),
                lambda: bench_torch.run_stream32m_only(out=out),
                lambda: bench_torch.run_standard_spread(1, out=out)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert not out.exists()


@pytest.mark.parametrize("argv", [["bench_torch.py"], ["bench_torch.py", "--configs"],
                                  ["scripts/scale_check_torch.py"]], ids=["standard", "configs", "scale-check"])
def test_scripts_without_a_card_exit_nonzero(argv):
    env = dict(os.environ, PYTHONPATH=_REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, *argv], env=env, capture_output=True, text=True, timeout=300, cwd=_REPO)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no CUDA device" in out.stderr and "metric" not in out.stdout


@pytest.mark.parametrize("parser", ["python", "native"])
def test_make_fastq_reads_back(parser, tmp_path):
    """make_fastq_torch's records, chunk by chunk from their seeds, read
    back through the port's parsers to the codes sample_reads drew,
    reads shorter than --read-len at their own length."""
    if parser == "native" and not native.native_available():
        pytest.skip("the native FASTQ parser did not build")
    path = str(tmp_path / "reads.fq")
    n, chunk, n_tx = 3000, 1100, 300
    assert make_fastq_torch.main([path, "--transcripts", str(n_tx), "--reads", str(n), "--chunk", str(chunk)]) == 0
    seqs = synth_transcriptome(np.random.default_rng(synth.GENCODE_SEED), n_tx)
    codes, lengths = [], []
    for r0 in range(0, n, chunk):
        c, length = sample_reads(seqs, min(chunk, n - r0), 150, 150, seed=1000 + r0 % 997)
        codes.append(c)
        lengths.append(length)
    codes, lengths = np.concatenate(codes), np.concatenate(lengths)
    assert (lengths < 150).any()  # the short-read framing is exercised
    if parser == "python":
        reads = load_fastq_dict(path)
        assert list(reads) == [f"r{i:010d}" for i in range(n)]
        want = ["".join("ACGT"[b] for b in codes[i, : lengths[i]]) for i in range(n)]
        assert list(reads.values()) == want
    else:
        packed, stats = native.pack_fastq_native(path, min_len=1)
        assert packed.num_reads == n and stats["max_len"] == 150
        np.testing.assert_array_equal(packed.lengths, lengths)
        np.testing.assert_array_equal(packed.codes[:, :150], codes)
