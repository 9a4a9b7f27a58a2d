"""Nanopore-like cDNA reads through the port's normal path on the CPU.

The benchmark's long-read mix (perfbench/traffic/ont_cdna_512k.json), cut
to 512 reads, is drawn by the benchmark's generator (perfbench/gen.py)
from a 300-transcript synthetic transcriptome and quantified by
pipeline.quantify (the fused engine, match_scan).  The reads of 500-2,549
bases fall into several length groups, and those past 1,024 windows are
sketched by K3's plain version (hash_kept) and a sort dedup, with phase 1
run eagerly.  Held to the benchmark's plain reference
(perfbench/reference/quant.py): the same CSV rows and mapped reads, pi
within 1e-9.  The timer's counters: match.eager_batches is the K3
groups' batches, and match.host_reads holds one kept-width read a batch
and k that K3 sketches beside the groups' size reads and the stats read.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import gen
from perfbench.reference import quant as ref
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.hash.sketch_kernel import MAX_WINDOWS, window_pad
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.pipeline import length_groups, quantify
from sketch_rna_tpu_torch.utils.synth import fasta_records

MIX = Path(__file__).resolve().parent.parent / "perfbench" / "traffic" / "ont_cdna_512k.json"
READS = 512
TRANSCRIPTS = 300


@pytest.fixture(scope="module")
def sample():
    """(flat codes, transcript lengths, transcripts, the mix's sample of
    READS reads as a PackedReads)."""
    seqs = gen.synth_transcriptome(np.random.default_rng(2**31 + 21), TRANSCRIPTS)
    flat = torch.from_numpy(np.concatenate(seqs))
    lengths = torch.from_numpy(np.array([s.size for s in seqs], dtype=np.int32))
    mix = dict(json.loads(MIX.read_text()), reads=READS)
    gen.check_mix(mix)
    g = torch.Generator()
    g.manual_seed(2**33 + 21)
    return flat, lengths, seqs, gen.draw_sample(g, flat, lengths, mix)


def _groups(packed, ks, batch):
    """(rows, batches, K3 ks) of each length group as match_scan forms it."""
    lens = np.asarray(packed.lengths)
    out = []
    for pad, rows in length_groups(lens, packed.codes.shape[1]):
        n = int(lens[rows].size)
        l_eff = min(pad, packed.codes.shape[1], -(-max(int(lens[rows].max()), max(ks)) // 8) * 8)
        bg = min(batch, n)
        out.append((n, -(-n // bg), sum(window_pad(l_eff, k) > MAX_WINDOWS for k in ks)))
    return out


@pytest.mark.parametrize("batch", [48, 8192])
@pytest.mark.parametrize("ks", [(31,), (21, 31)])
def test_long_reads_match_the_reference(sample, ks, batch):
    flat, lengths, seqs, packed = sample
    config = QuantConfig(kmer_lengths=ks, batch_size=batch)
    res = quantify(to_device(build_index(fasta_records(seqs), config, device="cpu"), "cpu"), packed, config)

    index = ref.build_index(flat, lengths, ks, config.sketch_fraction)
    q = {"kmer_lengths": ks, "sketch_fraction": config.sketch_fraction, "chain_fraction": config.chain_fraction,
         "em_max_iterations": config.em_max_iterations, "em_convergence": config.em_convergence}
    want = ref.quant(packed.codes, packed.lengths, index, TRANSCRIPTS, q, "cpu")
    assert np.array_equal(res.has_entry, want["has_entry"]) and want["has_entry"].sum() > 0
    assert res.num_mapped == want["num_mapped"] > 0
    assert np.max(np.abs(res.pi - want["pi"]) / want["pi"]) <= 1e-9

    groups = _groups(packed, ks, batch)
    assert len(groups) >= 3 and sum(n for n, _, _ in groups) == READS
    if batch < READS:  # some group's last batch is padded with empty reads
        assert any(n % min(batch, n) for n, _, _ in groups)
    eager = sum(b for _, b, k3 in groups if k3)
    assert res.timing["match.eager_batches"] == eager > 0
    assert res.timing["match.eager_sketch"] > 0
    # A size read a group, one kept-width read a batch and K3 k, the stats
    # read, and at two ks the per-k spill read (no batch spilled here, so
    # no regroup sketches again).
    assert res.stats["candidate_spilled_per_k"] == 0
    k3_reads = sum(b * k3 for _, b, k3 in groups)
    assert res.timing["match.host_reads"] == len(groups) + k3_reads + 1 + (len(ks) > 1)
