"""End-to-end quant of the PyTorch port against the JAX package, on the CPU.

Same index, same reads.  Tolerances: float64 within 1e-9 relative
(summation order differs; PARITY.md deviation 6 allows 5e-9), float32
within 1e-5 relative (float32 accumulation over <= 20 iterations).  The
CSV row set, the iteration count and the overflow stats must be equal.
Cases cover the equivalence-class path (>= 1024 padded rows), reads of
two lengths (two padded-length groups), and the per-read table path
(fewer than 1024 padded rows, several batches).
"""

import os

import numpy as np
import pytest

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import quantify as jax_quantify
from sketch_rna_tpu_torch.cli import main as port_cli
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.pipeline import quantify, write_csv
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.fixture(scope="module")
def problem():
    seqs = synth_transcriptome(np.random.default_rng(5), 150, 300, 900)
    names = [f"T{i}" for i in range(len(seqs))]
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    idx = jax_build_index(JaxRecords(names, text, 0), JaxConfig(kmer_lengths=(31,)))
    return seqs, idx


def _reads(seqs, case):
    if case == "mixed":  # 100 bp and 300 bp reads: padded-length groups 256 and 512
        c1, n1 = sample_reads(seqs, 2000, 100, 512, seed=7)
        c2, n2 = sample_reads(seqs, 1000, 300, 512, seed=8)
        return np.concatenate([c1, c2]), np.concatenate([n1, n2])
    n_reads = 600 if case == "per-read" else 3000
    return sample_reads(seqs, n_reads, 100, 256, seed=6)


@pytest.mark.parametrize(
    "case,dtype,batch,rtol",
    [
        ("classes", "float64", 8192, 1e-9),
        ("classes", "float32", 8192, 1e-5),
        ("mixed", "float64", 8192, 1e-9),
        ("per-read", "float64", 256, 1e-9),
    ],
)
def test_quantify_equals_jax(problem, case, dtype, batch, rtol):
    seqs, idx = problem
    codes, lengths = _reads(seqs, case)
    ids = [f"r{i}" for i in range(codes.shape[0])]
    ref = jax_quantify(
        idx,
        JaxPacked(codes, lengths, ids),
        JaxConfig(kmer_lengths=(31,), em_dtype=dtype, batch_size=batch),
    )
    got = quantify(
        to_device(idx, "cpu"),
        PackedReads(codes, lengths, ids),
        QuantConfig(em_dtype=dtype, batch_size=batch),
    )
    assert got.em_iterations == ref.em_iterations
    np.testing.assert_array_equal(got.has_entry, ref.has_entry)
    assert got.has_entry.sum() > 100
    np.testing.assert_allclose(got.pi, ref.pi, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.weighted_counts, ref.weighted_counts, rtol=rtol, atol=0)
    for key in ("sketch_overflow", "candidate_spilled"):
        assert got.stats[key] == ref.stats.get(key, 0)
    assert got.stats["expand_dropped"] == 0
    assert abs(got.weighted_counts.sum() - got.num_mapped) <= 1e-6 * got.num_mapped


def test_no_reads_writes_header_only_csv(problem, tmp_path):
    _, idx = problem
    empty = PackedReads(np.zeros((0, 256), np.uint8), np.zeros(0, np.int32), [])
    result = quantify(to_device(idx, "cpu"), empty)
    assert result.num_reads == 0 and not result.has_entry.any()
    out = tmp_path / "empty.csv"
    write_csv(str(out), result)
    assert out.read_text() == "Name,NumReads,EM_Abundance\n"


def test_cli_sample_csv_is_byte_identical(tmp_path):
    idx = str(tmp_path / "sample.npz")
    out = str(tmp_path / "sample.csv")
    assert port_cli(["-o", "index", "--device", "cpu", "-k", "31", os.path.join(EXAMPLES, "sample.fa"), idx]) == 0
    assert port_cli(["-o", "quant", "--device", "cpu", "--em-dtype", "float64", idx,
                     os.path.join(EXAMPLES, "sample.fq"), out]) == 0
    with open(out) as a, open(os.path.join(EXAMPLES, "sample.expected.csv")) as b:
        assert a.read() == b.read()
