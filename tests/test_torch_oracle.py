"""The port's reference oracle (oracle/reference_oracle.py) and its scalar
hashing against the JAX package's, and the port's pipeline against it.

  - nthash_forward_scalar (rolling) equals the JAX one and the direct
    windowed XOR, for k in {15, 21, 31} on seeded random codes;
  - sketch_scalar equals the JAX one;
  - every oracle function equals the JAX oracle's output exactly (the
    same float64 operations in the same order), on the sample and on
    two seeded synthetic problems, for ks (31,) and (21, 31);
  - the port's CPU quantify is within 5e-9 relative of the port's
    oracle_quant (PARITY.md deviation 6), with the same CSV rows;
  - collect_pairs gives oracle_sparse_chain's candidates of every read,
    with nothing dropped, spilled or overflowed (as
    tests/test_match_em.py holds the JAX package).
"""

import os

import numpy as np
import pytest

from sketch_rna_tpu.hash import nthash as jax_nthash
from sketch_rna_tpu.oracle import reference_oracle as jax_oracle
from sketch_rna_tpu.sketch.fracminhash import sketch_scalar as jax_sketch_scalar
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.hash.nthash import nthash_forward_scalar, nthash_forward_scalar_direct
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords, load_fasta
from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
from sketch_rna_tpu_torch.io.packing import PackedReads, encode_sequence
from sketch_rna_tpu_torch.oracle import reference_oracle as oracle
from sketch_rna_tpu_torch.pipeline import collect_pairs, quantify
from sketch_rna_tpu_torch.sketch.fracminhash import sketch_scalar

from util import decode, make_transcriptome, sample_reads

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
KS = [(31,), (21, 31)]


@pytest.mark.parametrize("k", [15, 21, 31])
def test_nthash_scalar_forms_equal_jax(k):
    codes = np.random.default_rng(k).integers(0, 4, size=257).tolist()
    rolling = nthash_forward_scalar(codes, k)
    assert len(rolling) == 257 - k + 1
    assert rolling == nthash_forward_scalar_direct(codes, k)
    assert rolling == jax_nthash.nthash_forward_scalar(codes, k)
    assert nthash_forward_scalar(codes[: k - 1], k) == []


@pytest.mark.parametrize("k,fraction", [(21, 0.05), (31, 0.05), (31, 0.5)])
def test_sketch_scalar_equals_jax(k, fraction):
    codes = np.random.default_rng(7).integers(0, 4, size=600).astype(np.uint8)
    got = sketch_scalar(codes, k, fraction)
    assert got == jax_sketch_scalar(codes, k, fraction)
    assert 0 < len(got) < 600 - k + 1


def _problem(name):
    """(transcript codes, {read id: codes}) of a named problem."""
    if name == "sample":
        recs = load_fasta(os.path.join(EXAMPLES, "sample.fa"))
        reads = load_fastq_dict(os.path.join(EXAMPLES, "sample.fq"))
        seqs = [encode_sequence(s) for s in recs.seqs]
        read_codes = {rid: encode_sequence(s) for rid, s in reads.items()}
        return seqs, {rid: c for rid, c in read_codes.items() if c is not None}
    rng = np.random.default_rng({"synth-a": 7, "synth-b": 11}[name])
    seqs = make_transcriptome(rng, n=18, len_range=(60, 700))
    reads = sample_reads(rng, seqs, n_reads=250, read_len=100)
    return seqs, {f"read{i}": r for i, r in enumerate(reads)}


@pytest.mark.parametrize("ks", KS, ids=["k31", "k21_31"])
@pytest.mark.parametrize("name", ["sample", "synth-a", "synth-b"])
def test_oracle_equals_jax_oracle(name, ks):
    seqs, read_codes = _problem(name)
    read_codes = {rid: c for rid, c in read_codes.items() if c.size >= max(ks)}
    index = oracle.oracle_build_index(seqs, ks, 0.05)
    assert index == jax_oracle.oracle_build_index(seqs, ks, 0.05)
    sketches = {rid: {k: sketch_scalar(c, k, 0.05) for k in ks} for rid, c in read_codes.items()}
    segments = oracle.oracle_sparse_chain(sketches, index, ks, 0.9)
    assert segments == jax_oracle.oracle_sparse_chain(sketches, index, ks, 0.9)
    assert sum(map(len, segments.values())) > len(segments) // 2
    pi = oracle.oracle_em(segments, len(seqs))
    np.testing.assert_array_equal(pi, jax_oracle.oracle_em(segments, len(seqs)))
    np.testing.assert_array_equal(oracle.oracle_assign(segments, pi), jax_oracle.oracle_assign(segments, pi))
    got = oracle.oracle_quant(seqs, read_codes, ks)
    want = jax_oracle.oracle_quant(seqs, read_codes, ks)
    assert got[0] == want[0] == segments and got[3] == want[3]
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g, w)


def _port_problem(seed, ks, mixed=False):
    """A synthetic problem packed for the port, its index built on the CPU.
    mixed: every third read 300 bases long, so that the reads fall in two
    padded-length groups whose rows interleave."""
    rng = np.random.default_rng(seed)
    seqs = make_transcriptome(rng, n=18, len_range=(60, 700))
    recs = FastaRecords([f"T{i:03d}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    cfg = QuantConfig(kmer_lengths=ks, batch_size=64, max_read_len=128, em_dtype="float64")
    index = to_device(build_index(recs, cfg, device="cpu"), "cpu")
    reads = [r for r in sample_reads(rng, seqs, n_reads=250, read_len=100) if r.size >= max(ks)]
    if mixed:
        long_reads = sample_reads(rng, [s for s in seqs if s.size >= 300], n_reads=len(reads), read_len=300)
        reads[::3] = long_reads[::3]
    codes = np.zeros((len(reads), 512 if mixed else 128), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lengths[i] = r.size
    packed = PackedReads(codes, lengths, [f"read{i}" for i in range(len(reads))])
    return seqs, {f"read{i}": r for i, r in enumerate(reads)}, cfg, index, packed


@pytest.mark.parametrize("ks", KS, ids=["k31", "k21_31"])
def test_quantify_within_oracle(ks):
    seqs, read_codes, cfg, index, packed = _port_problem(11, ks)
    segments, pi, weighted, csv_tids = oracle.oracle_quant(seqs, read_codes, ks, cfg.sketch_fraction,
                                                           cfg.chain_fraction)
    result = quantify(index, packed, cfg)
    assert result.num_reads == len(segments)
    assert [t for t in range(len(seqs)) if result.has_entry[t]] == csv_tids
    np.testing.assert_allclose(result.pi, pi, rtol=5e-9, atol=0)
    np.testing.assert_allclose(result.weighted_counts, weighted, rtol=5e-9, atol=0)


@pytest.mark.parametrize("ks,mixed", [((31,), False), ((21, 31), False), ((31,), True)],
                         ids=["k31", "k21_31", "k31-two-lengths"])
def test_collect_pairs_equals_oracle(ks, mixed):
    seqs, read_codes, cfg, index, packed = _port_problem(7, ks, mixed)
    reads, tids, scores, stats = collect_pairs(index, packed, cfg)
    assert stats == {"sketch_overflow": 0, "expand_dropped": 0, "candidate_spilled": 0}
    assert reads.dtype == tids.dtype == scores.dtype == np.int32
    oracle_index = oracle.oracle_build_index(seqs, ks, cfg.sketch_fraction)
    sketches = {rid: {k: sketch_scalar(c, k, cfg.sketch_fraction) for k in ks} for rid, c in read_codes.items()}
    segments = oracle.oracle_sparse_chain(sketches, oracle_index, ks, cfg.chain_fraction)
    got = {}
    for r, t, s in zip(reads.tolist(), tids.tolist(), scores.tolist()):
        got.setdefault(r, []).append((t, s))
    for i in range(packed.num_reads):
        assert got.get(i, []) == segments[f"read{i}"], i  # in (score desc, tid asc) order
    assert len(reads) > packed.num_reads // 2
