"""Index build and artifact of the PyTorch port against the JAX package.

keys, row_ptr and postings must be bit-equal, and an `.npz` written by
either package must load in the other.  The GENCODE-scale transcriptome
(utils/synth.py) gives the JAX package's index at 25,000 transcripts,
its digests at 250,000 are the JAX package's build, and the scripts'
index cache (scripts/common_torch.py) uses a 250,000-transcript index
only if it has those digests.
"""

import os
import sys

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
from sketch_rna_tpu_torch.index.artifact import KIndex, load_index, save_index, to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords, load_fasta
from sketch_rna_tpu_torch.utils import synth
from sketch_rna_tpu_torch.utils.synth import fasta_records, synth_transcriptome

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(_REPO, "examples")
sys.path.insert(0, os.path.join(_REPO, "scripts"))

import common_torch  # noqa: E402


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


def _digest(kidx) -> str:
    return KIndex(kidx.keys, kidx.row_ptr, kidx.postings).sha256()


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
    """chip_smoke's gencode phase and the scripts' index cache hold the
    250,000-transcript indexes to GENCODE_INDEX: those are the JAX
    package's build of the same transcriptome at ks (21, 31) (~30 s,
    ~3 GB here)."""
    assert (synth.GENCODE_SEED, synth.GENCODE_TRANSCRIPTS) == (2026, 250000)
    seqs = synth_transcriptome(np.random.default_rng(synth.GENCODE_SEED), synth.GENCODE_TRANSCRIPTS)
    recs = fasta_records(seqs)
    ref = jax_build_index(JaxRecords(recs.names, recs.seqs, 0), JaxConfig(kmer_lengths=(21, 31)))
    got = {k: (int(ki.keys.size), int(ki.postings.size), _digest(ki)) for k, ki in ref.per_k.items()}
    assert got == synth.GENCODE_INDEX


def test_gencode_cache_is_held_to_the_jax_digests(tmp_path, monkeypatch, capsys):
    """A cached index that is not the JAX package's GENCODE-scale build
    (here a 40-transcript one under the 250k cache name) is refused, and
    cached_index builds the index again; one whose digests match is
    loaded.  (The GENCODE scale is set to 40 transcripts here, so that
    cached_index's rebuild stays small.)"""
    artifact = build_index(fasta_records(synth.gencode_transcriptome(40)), QuantConfig(kmer_lengths=(31,)),
                           device="cpu")
    path = tmp_path / "T250000_k31.npz"
    assert common_torch.load_gencode_index(path, (31,))[1].startswith("missing ")
    save_index(str(path), artifact)
    got, why = common_torch.load_gencode_index(path, (31,))
    assert got is None and "is not the GENCODE-scale index" in why

    monkeypatch.setattr(synth, "GENCODE_TRANSCRIPTS", 40)
    save_index(str(tmp_path / "T40_k31.npz"), artifact)
    _, seqs, where = common_torch.cached_index(40, (31,), "cpu", tmp_path)
    assert where.startswith("index built on cpu") and len(seqs) == 40
    assert "not using the cache" in capsys.readouterr().err

    ki = artifact.per_k[31]
    monkeypatch.setitem(synth.GENCODE_INDEX, 31, (ki.num_keys, int(ki.postings.size), ki.sha256()))
    got, why = common_torch.load_gencode_index(path, (31,))
    assert why is None and got.per_k[31].sha256() == ki.sha256()
    got, _, where = common_torch.cached_index(40, (31,), "cpu", tmp_path)
    assert where.startswith("index loaded from cache") and got.per_k[31].sha256() == ki.sha256()
