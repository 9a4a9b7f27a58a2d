"""Whole-run Nanopore cDNA samples through the streamed engine on the CPU.

The benchmark's flow-cell mix (perfbench/traffic/ont_flowcell_4m.json:
the long-read mix as 2-bit codes at the native feed's pad), cut to 600
reads, is drawn by the benchmark's generator (perfbench/gen.py) from a
300-transcript synthetic transcriptome.  pipeline.quantify streams it
(the fused bound patched to 0, as the benchmark's CPU tests patch it) in
chunks of 200 reads, each chunk several length groups, those past 1,024
windows sketched by K3's plain version with phase 1 run eagerly.  Held to
the benchmark's plain reference (perfbench/reference/quant.py: the same
CSV rows and mapped reads, pi within 1e-9) and to the fused engine on the
same reads; the chunk loop's counter stream.chunks and span
stream.upload, and match.groups summed over the chunks.

A length group of fewer reads than a batch is one batch of their count
rounded up to a power of two (pipeline.match_scan), so two counts within
a power of two take one batch shape and the same graph keys; its tables
equal the per-batch route's (sketch_match_step) at 1, 3 and 47 reads.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import gen
from perfbench.reference import quant as ref
from sketch_rna_tpu_torch import pipeline
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.packing import Packed2Reads, PackedReads
from sketch_rna_tpu_torch.pipeline import length_groups, match_rows, match_scan, quantify, sketch_match_step
from sketch_rna_tpu_torch.utils import step_graphs
from sketch_rna_tpu_torch.utils.synth import fasta_records

MIX = Path(__file__).resolve().parent.parent / "perfbench" / "traffic" / "ont_flowcell_4m.json"
READS = 600
CHUNK = 200
TRANSCRIPTS = 300


@pytest.fixture(scope="module")
def sample():
    """(flat codes, transcript lengths, transcripts, the mix's sample of
    READS reads as the Packed2Reads the mix hands the engine)."""
    seqs = gen.synth_transcriptome(np.random.default_rng(2**31 + 25), TRANSCRIPTS)
    flat = torch.from_numpy(np.concatenate(seqs))
    lengths = torch.from_numpy(np.array([s.size for s in seqs], dtype=np.int32))
    mix = dict(json.loads(MIX.read_text()), reads=READS)
    gen.check_mix(mix)
    g = torch.Generator()
    g.manual_seed(2**33 + 25)
    packed = gen.draw_sample(g, flat, lengths, mix)
    assert isinstance(packed, Packed2Reads) and packed.pad_len == gen.pad_width(mix) == 2560
    return flat, lengths, seqs, packed


@pytest.fixture(scope="module")
def indexes(sample):
    _, _, seqs, _ = sample
    return {ks: to_device(build_index(fasta_records(seqs), QuantConfig(kmer_lengths=ks), device="cpu"), "cpu")
            for ks in ((31,), (21, 31))}


@pytest.mark.parametrize("batch", [64, 8192])
@pytest.mark.parametrize("ks", [(31,), (21, 31)])
def test_streamed_long_reads_match_the_reference_and_the_fused_engine(sample, indexes, monkeypatch, ks, batch):
    flat, lengths, _, packed = sample
    codes, lens = gen.sample_codes(packed)
    config = QuantConfig(kmer_lengths=ks, batch_size=batch, stream_chunk_reads=CHUNK)
    index = indexes[ks]
    fused = quantify(index, PackedReads(codes, lens, []), config)
    assert "match" in fused.timing
    monkeypatch.setattr(pipeline, "FUSED_MAX_PADDED_READS", 0)
    res = quantify(index, packed, config)

    q = {"kmer_lengths": ks, "sketch_fraction": config.sketch_fraction, "chain_fraction": config.chain_fraction,
         "em_max_iterations": config.em_max_iterations, "em_convergence": config.em_convergence}
    want = ref.quant(codes, lens, ref.build_index(flat, lengths, ks, config.sketch_fraction), TRANSCRIPTS, q, "cpu")
    assert np.array_equal(res.has_entry, want["has_entry"]) and want["has_entry"].sum() > 0
    assert res.num_mapped == want["num_mapped"] > 0
    assert np.max(np.abs(res.pi - want["pi"]) / want["pi"]) <= 1e-9
    assert np.array_equal(res.has_entry, fused.has_entry) and res.num_mapped == fused.num_mapped
    assert np.max(np.abs(res.pi - fused.pi) / fused.pi) <= 1e-9
    assert np.max(np.abs(res.weighted_counts - fused.weighted_counts) / np.maximum(fused.weighted_counts, 1)) <= 1e-9

    # The chunk loop: a count a chunk, the upload's span, every chunk's length groups.
    per_chunk = [len(length_groups(lens[r0 : r0 + CHUNK], codes.shape[1])) for r0 in range(0, READS, CHUNK)]
    assert len(per_chunk) == 3 and min(per_chunk) >= 3
    assert res.timing["stream.chunks"] == len(per_chunk)
    assert res.timing["match.groups"] == sum(per_chunk)
    assert res.timing["stream.upload"] > 0 and "match" not in res.timing
    assert res.timing["match.eager_batches"] > 0  # K3's groups, phase 1 eager


def _keys(monkeypatch):
    """The keys match_scan asks the graph store for, in order."""
    keys = []
    real = step_graphs.StepGraphs.run

    def run(self, key, fn, *inputs):
        keys.append(key)
        return real(self, key, fn, *inputs)

    monkeypatch.setattr(step_graphs.StepGraphs, "run", run)
    return keys


@pytest.mark.parametrize("pad", [1024, 2048])
def test_small_group_takes_a_power_of_two_batch(sample, indexes, monkeypatch, pad):
    """Reads of one length group (pad 1024: the fused sketch's graph; 2048:
    K3, phase 1 eager), three distinct ones repeated to each count."""
    _, _, _, packed = sample
    codes, lens = gen.sample_codes(packed)
    rows = dict(length_groups(lens, codes.shape[1]))[pad][:3]
    assert rows.size == 3
    index = indexes[(31,)]
    config = QuantConfig(kmer_lengths=(31,))
    keys = _keys(monkeypatch)
    shapes = {}
    for n in (1, 3, 33, 47):
        pick = np.resize(rows, n)
        c, n_lens = torch.from_numpy(codes[pick]), lens[pick]
        del keys[:]
        tid, score, n_padded, stats = match_scan(index, c, n_lens, config)
        shapes[n] = list(keys)
        want = match_rows(index, c, n_lens, config, step=sketch_match_step)
        assert torch.equal(tid, want[0]) and torch.equal(score, want[1]) and n_padded == want[2] == config.batch_size
        assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in want[3].items()}
        assert tid.shape[0] == n and int((score > 0).sum()) > 0
    assert all(key[1] == pipeline.pow2ceil(n) for n, ks in shapes.items() for key in ks)
    assert shapes[33] == shapes[47] and shapes[1] != shapes[3]
    assert {key[0] for key in shapes[47]} == ({"sketch", "group"} if pad == 1024 else {"group"})
