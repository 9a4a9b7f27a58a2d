"""Multi-k index build and quant of the PyTorch port against the JAX package.

Same FASTA, same reads, ks (21, 31).  The index must be bit-equal.
Quant tolerances as in test_torch_quant.py: float64 within 1e-9
relative, float32 within 1e-5; the CSV row set, the iteration count and
the summed overflow stats must be equal.  Cases: the equivalence-class
path, the per-read path, a per-k candidate spill (which the port
regroups merged, batch by batch), reads past the fused kernels' 1024
windows, reads past K4's 16384 windows (20 kb), and the CLI.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import torch
import pytest

from sketch_rna_tpu.cli import main as jax_cli
from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import _device_index, quantify as jax_quantify, sketch_match_step as jax_step
from sketch_rna_tpu_torch import cli as port_cli_module
from sketch_rna_tpu_torch.cli import main as port_cli
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.pipeline import match_rows, quantify
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

KS = (21, 31)
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _text(seqs):
    return [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]


@pytest.fixture(scope="module")
def problem():
    """150 isoform-family transcripts, one of 25 bases (sketchable at
    k = 21 alone, so in neither index) and one of 10."""
    seqs = synth_transcriptome(np.random.default_rng(15), 150, 600, 2600)
    rng = np.random.default_rng(16)
    seqs += [rng.integers(0, 4, size=25).astype(np.uint8), rng.integers(0, 4, size=10).astype(np.uint8)]
    names = [f"T{i}" for i in range(len(seqs))]
    idx = jax_build_index(JaxRecords(names, _text(seqs), 0), JaxConfig(kmer_lengths=KS))
    return seqs, names, idx


def test_build_index_multik_equals_jax(problem):
    seqs, names, ref = problem
    port = build_index(FastaRecords(names, _text(seqs), 0), QuantConfig(kmer_lengths=(31, 21)), device="cpu")
    assert port.kmer_lengths == ref.kmer_lengths == KS
    np.testing.assert_array_equal(port.lengths, ref.lengths)
    for k in KS:
        a, b = port.per_k[k], ref.per_k[k]
        assert a.num_keys > 0
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
        np.testing.assert_array_equal(a.postings, b.postings)
        assert not np.isin(a.postings, [len(names) - 2, len(names) - 1]).any()


@pytest.fixture(scope="module")
def long_problem():
    """12 transcripts of 20-24 kb, so error-free 20,000 bp reads exist."""
    seqs = synth_transcriptome(np.random.default_rng(25), 12, 20000, 24000)
    names = [f"L{i}" for i in range(len(seqs))]
    return seqs, jax_build_index(JaxRecords(names, _text(seqs), 0), JaxConfig(kmer_lengths=KS))


def _reads(seqs, case):
    if case == "very-long":  # 20,000 bp reads (nk_pad 32768 at k = 21 and 31) among 100 bp reads
        c1, n1 = sample_reads(seqs, 6, 20000, 20480, seed=33)
        c2, n2 = sample_reads(seqs, 200, 100, 20480, seed=34)
        codes, lengths = np.concatenate([c1, c2]), np.concatenate([n1, n2])
        order = np.random.default_rng(35).permutation(lengths.size)  # long reads among short ones
        return codes[order], lengths[order]
    if case == "long":  # 1,200 bp reads (nk_pad 2048: K3 + K4 dedup) among 100 bp reads
        c1, n1 = sample_reads(seqs, 300, 1200, 1280, seed=31)
        c2, n2 = sample_reads(seqs, 500, 100, 1280, seed=32)
        return np.concatenate([c1, c2]), np.concatenate([n1, n2])
    n_reads = 600 if case == "per-read" else 3000
    return sample_reads(seqs, n_reads, 100, 256, seed=6)


def _assert_quant_equal(got, ref, rtol, min_rows=50):
    assert got.em_iterations == ref.em_iterations
    np.testing.assert_array_equal(got.has_entry, ref.has_entry)
    assert got.has_entry.sum() > min(min_rows, got.has_entry.size // 2)
    np.testing.assert_allclose(got.pi, ref.pi, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.weighted_counts, ref.weighted_counts, rtol=rtol, atol=0)
    for key in ("sketch_overflow", "expand_dropped", "candidate_spilled"):
        assert got.stats[key] == int(np.asarray(ref.stats.get(key, 0)).sum()), key
    assert abs(got.weighted_counts.sum() - got.num_mapped) <= 1e-6 * got.num_mapped


@pytest.mark.parametrize(
    "case,dtype,batch,rtol",
    [
        ("classes", "float64", 8192, 1e-9),
        ("classes", "float32", 8192, 1e-5),
        ("per-read", "float64", 256, 1e-9),
        ("long", "float64", 256, 1e-9),
        ("very-long", "float64", 32, 1e-9),
    ],
)
def test_quantify_multik_equals_jax(request, problem, case, dtype, batch, rtol):
    seqs, _, idx = problem
    if case == "very-long":
        seqs, idx = request.getfixturevalue("long_problem")
    if case == "long":
        seqs = [s for s in seqs if s.size >= 1200]
    codes, lengths = _reads(seqs, case)
    ids = [f"r{i}" for i in range(codes.shape[0])]
    # A 20 kb read expands ~2,000 events per k: starting the JAX engine at
    # that budget skips its doubling reruns (same result, fewer compiles).
    budget = {"expand_per_read": 4096} if case == "very-long" else {}
    ref = jax_quantify(idx, JaxPacked(codes, lengths, ids),
                       JaxConfig(kmer_lengths=KS, em_dtype=dtype, batch_size=batch, **budget))
    got = quantify(to_device(idx, "cpu"), PackedReads(codes, lengths, ids),
                   QuantConfig(kmer_lengths=KS, em_dtype=dtype, batch_size=batch))
    _assert_quant_equal(got, ref, rtol)
    assert got.stats["sketch_overflow"] == got.stats["expand_dropped"] == 0


def test_per_k_spill_regroups_merged():
    """300 transcripts share an 80-base core, so a core read's k = 15
    passing set (300 tids) overflows the per-k table (2C = 16 at C = 8).
    The port regroups that batch as merged K-wide rows: its tables equal
    the JAX package's merged grouping, its quant the JAX package's forced
    merged run, and candidate_spilled the JAX result's."""
    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, 80).astype(np.uint8)
    seqs = [np.concatenate([core, rng.integers(0, 4, 60).astype(np.uint8)]) for _ in range(300)]
    names = [f"T{i:04d}" for i in range(300)]
    ks = (15, 31)
    jcfg = JaxConfig(kmer_lengths=ks, candidate_capacity=8, batch_size=64, max_read_len=128, em_dtype="float64")
    idx = jax_build_index(JaxRecords(names, _text(seqs), 0), jcfg)
    codes = np.zeros((48, 128), np.uint8)
    lengths = np.full(48, 70, np.int32)
    codes[:32, :70] = core[:70]
    for i in range(32, 48):  # reads off the core: no per-k spill in their batch
        s = seqs[i]
        codes[i, :70] = s[70:140]

    merged = dataclasses.replace(jcfg, match_per_k_tables=False)
    r_per_k = jax_quantify(idx, JaxPacked(codes, lengths, []), jcfg)
    r_merged = jax_quantify(idx, JaxPacked(codes, lengths, []), merged)
    cfg = QuantConfig(kmer_lengths=ks, candidate_capacity=8, batch_size=32, em_dtype="float64")
    dev = to_device(idx, "cpu")
    got = quantify(dev, PackedReads(codes, lengths, []), cfg)
    _assert_quant_equal(got, r_merged, 1e-9, min_rows=10)
    assert got.stats["candidate_spilled"] == int(np.asarray(r_per_k.stats["candidate_spilled"]).sum()) > 0
    assert got.stats["candidate_spilled_per_k"] > 0

    tid, score, _, _ = match_rows(dev, torch.from_numpy(codes), lengths, cfg)
    bp, post, meta = _device_index(idx, ks)
    jt, js, jm, _ = jax_step(
        jnp.asarray(codes[:, :72]), jnp.asarray(lengths), bp, post,
        kmer_lengths=ks, sketch_fraction=cfg.sketch_fraction,
        sketch_caps=tuple(cfg.sketch_capacity_for(k, 72) for k in ks),
        chain_fraction=cfg.chain_fraction, expand_per_read=4096, candidate_capacity=8,
        bucket_meta=meta, num_transcripts=300, match_tiers=False, match_per_k_tables=False,
    )
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tid.numpy(), np.where(jm, np.asarray(jt), 0))
    np.testing.assert_array_equal(score.numpy(), np.where(jm, np.asarray(js), 0))


def test_cli_multik_equals_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    fa, fq = os.path.join(EXAMPLES, "sample.fa"), os.path.join(EXAMPLES, "sample.fq")
    outs = {}
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        idx, out = str(tmp_path / f"{name}.npz"), str(tmp_path / f"{name}.csv")
        assert cli(["-o", "index", *extra, "-k", "21,31", fa, idx]) == 0
        assert cli(["-o", "quant", *extra, "--em-dtype", "float64", idx, fq, out]) == 0
        outs[name] = open(out).read()
    assert outs["port"].count("\n") > 10
    assert outs["port"] == outs["jax"]


def test_cli_refuses_without_cuda(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port_cli_module.torch.cuda, "is_available", lambda: False)
    fa = os.path.join(EXAMPLES, "sample.fa")
    assert port_cli(["-o", "index", "-k", "21,31", fa, str(tmp_path / "i.npz")]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "i.npz").exists()
