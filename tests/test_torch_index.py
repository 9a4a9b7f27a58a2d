"""Index build and artifact of the PyTorch port against the JAX package.

keys, row_ptr and postings must be bit-equal, and an `.npz` written by
either package must load in the other.
"""

import os

import numpy as np
import pytest
import torch

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.artifact import load_index as jax_load_index
from sketch_rna_tpu.index.artifact import save_index as jax_save_index
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.fasta import load_fasta as jax_load_fasta
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import load_index, save_index, to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords, load_fasta
from sketch_rna_tpu_torch.utils.synth import synth_transcriptome

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _assert_same_index(port, ref, k):
    assert port.names == list(ref.names)
    np.testing.assert_array_equal(port.lengths, ref.lengths)
    assert tuple(port.kmer_lengths) == tuple(ref.kmer_lengths)
    a, b = port.per_k[k], ref.per_k[k]
    assert a.keys.dtype == np.uint32 and a.row_ptr.dtype == np.int32 and a.postings.dtype == np.int32
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.postings, b.postings)


@pytest.fixture(scope="module")
def synth_records():
    """300 isoform-family transcripts plus two shorter than every k tested."""
    seqs = synth_transcriptome(np.random.default_rng(11), 300, 150, 600)
    seqs += [np.arange(20, dtype=np.uint8) % 4, np.zeros(5, np.uint8)]
    names = [f"T{i}" for i in range(len(seqs))]
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    return names, text


def test_build_index_defaults_to_the_card(monkeypatch):
    """With no device given, build_index builds on CUDA: without a CUDA
    device it raises rather than running on the CPU."""
    import inspect

    assert inspect.signature(build_index).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    records = load_fasta(os.path.join(EXAMPLES, "sample.fa"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index(records, QuantConfig(kmer_lengths=(31,)))


def test_build_sample_equals_jax():
    fa = os.path.join(EXAMPLES, "sample.fa")
    port = build_index(load_fasta(fa), QuantConfig(kmer_lengths=(31,)), device="cpu")
    ref = jax_build_index(jax_load_fasta(fa), JaxConfig(kmer_lengths=(31,)))
    _assert_same_index(port, ref, 31)


@pytest.mark.parametrize("k", [21, 31])
def test_build_synthetic_equals_jax(synth_records, k):
    names, text = synth_records
    port = build_index(FastaRecords(names, text, 0), QuantConfig(kmer_lengths=(k,)), device="cpu")
    ref = jax_build_index(JaxRecords(names, text, 0), JaxConfig(kmer_lengths=(k,)))
    _assert_same_index(port, ref, k)
    assert port.per_k[k].num_keys > 0
    # The short transcripts are stored but own no posting.
    short = [len(names) - 2, len(names) - 1]
    assert not np.isin(port.per_k[k].postings, short).any()


def test_npz_round_trips_between_packages(synth_records, tmp_path):
    names, text = synth_records
    ref = jax_build_index(JaxRecords(names, text, 0), JaxConfig(kmer_lengths=(31,)))
    jax_path = str(tmp_path / "jax.npz")
    jax_save_index(jax_path, ref)
    dev = to_device(load_index(jax_path), "cpu")
    assert dev.names == list(ref.names) and dev.kmer_lengths == (31,)
    kd, kr = dev.per_k[31], ref.per_k[31]
    assert kd.keys.dtype == torch.int64 and kd.postings.dtype == torch.int32
    np.testing.assert_array_equal(kd.keys.numpy(), kr.keys.astype(np.int64))
    np.testing.assert_array_equal(kd.row_ptr.numpy(), kr.row_ptr)
    np.testing.assert_array_equal(kd.postings.numpy(), kr.postings)

    port_path = str(tmp_path / "port.npz")
    port = build_index(FastaRecords(names, text, 0), QuantConfig(kmer_lengths=(31,)), device="cpu")
    save_index(port_path, port)
    _assert_same_index(load_index(port_path), jax_load_index(port_path), 31)
    _assert_same_index(load_index(port_path), ref, 31)
