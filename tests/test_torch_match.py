"""Per-read candidate tables of the PyTorch port against the JAX package.

Same index, same reads: the port's sketch_match_step must give the same
(tid, score) table as JAX's flat-window sketch_match_step, whose window
is made wide enough to drop no event.  The reads include candidate-less
reads and reads from a 300-way shared core whose events overflow the
default 256-lane window (and whose candidates overflow C = 64).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.pipeline import _device_index, sketch_match_step as jax_step
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.match.probe import probe
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, row_sort_plain
from sketch_rna_tpu_torch.match.rowmatch import row_expand_from_runs, row_slices
from sketch_rna_tpu_torch.oracle import oracle_quant
from sketch_rna_tpu_torch.pipeline import sketch_match_step
from sketch_rna_tpu_torch.sketch.fracminhash import sketch_batch
from sketch_rna_tpu_torch.utils.synth import synth_transcriptome

K = 31
B, L = 64, 128
JAX_WINDOW = 4096  # >= every read's event total below: JAX drops nothing


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    seqs = synth_transcriptome(rng, 120, 200, 500)
    core = rng.integers(0, 4, size=120).astype(np.uint8)
    for _ in range(300):  # 300 transcripts sharing one 120-base core
        flank = rng.integers(0, 4, size=(2, 40)).astype(np.uint8)
        seqs.append(np.concatenate([flank[0], core, flank[1]]))
    names = [f"T{i}" for i in range(len(seqs))]
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    idx = jax_build_index(JaxRecords(names, text, 0), JaxConfig(kmer_lengths=(K,)))

    codes = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i in range(B):
        if i < 4:  # the shared core: hundreds of events per read
            sub = core[i * 5 : i * 5 + 100]
        elif i < 8:  # random sequence: no candidates
            sub = rng.integers(0, 4, size=100).astype(np.uint8)
        else:
            s = seqs[rng.integers(120)]
            ln = int(rng.integers(60, 121))
            st = int(rng.integers(0, max(len(s) - ln, 1)))
            sub = s[st : st + ln]
        codes[i, : len(sub)] = sub
        lengths[i] = len(sub)
    return idx, codes, lengths


def test_candidate_tables_equal_jax(problem):
    idx, codes, lengths = problem
    cfg = QuantConfig()
    cap = cfg.sketch_capacity_for(K, L)
    bp, post, meta = _device_index(idx, (K,))
    jt, js, jm, jst = jax_step(
        jnp.asarray(codes),
        jnp.asarray(lengths),
        bp,
        post,
        kmer_lengths=(K,),
        sketch_fraction=cfg.sketch_fraction,
        sketch_caps=(cap,),
        chain_fraction=cfg.chain_fraction,
        expand_per_read=JAX_WINDOW,
        candidate_capacity=cfg.candidate_capacity,
        bucket_meta=meta,
        num_transcripts=idx.num_transcripts,
        match_tiers=False,
    )
    jt, js, jm = np.asarray(jt), np.asarray(js), np.asarray(jm)
    assert int(np.asarray(jst["expand_dropped"]).sum()) == 0

    dev = to_device(idx, "cpu")
    res = sketch_match_step(torch.from_numpy(codes), torch.from_numpy(lengths), dev, cfg, (cap,))
    np.testing.assert_array_equal(res.mask.numpy(), jm)
    np.testing.assert_array_equal(res.tid.numpy(), np.where(jm, jt, 0))
    np.testing.assert_array_equal(res.score.numpy(), np.where(jm, js, 0))
    assert int(res.stats["expand_dropped"]) == 0
    assert int(res.stats["sketch_overflow"]) == int(np.asarray(jst["sketch_overflow"]).sum())
    assert int(res.stats["candidate_spilled"]) == int(jst["candidate_spilled"]) > 0

    # The cases the fixture promises: no-hit reads, and reads past 256 events.
    assert not jm[4:8].any()
    h, m, _ = sketch_batch(torch.from_numpy(codes), torch.from_numpy(lengths), K, cfg.sketch_fraction, cap)
    _, length = probe(h, m, dev.per_k[K].keys, dev.per_k[K].row_ptr)
    assert int(length[:4].sum(dim=1).min()) > 256


def test_expansion_counts_events_past_the_cap():
    start = torch.tensor([[0, 2, 0], [1, 0, 0]])
    length = torch.tensor([[2, 3, 0], [1, 0, 0]])
    postings = torch.arange(10, dtype=torch.int32) * 10
    key = row_expand_from_runs(start, length, postings)
    assert key.tolist() == [[0, 10, 20, 30, 40, 2**31 - 1, 2**31 - 1, 2**31 - 1],
                            [10] + [2**31 - 1] * 7]


@pytest.mark.parametrize("batch_size,want", [(4, [[0, 2, 4], [1], [5], [3]]), (16, [[0, 2, 4], [1, 5], [3]]),
                                             (64, [[0, 2, 4], [1, 5, 3]])])
def test_row_slices_bound_wide_rows(batch_size, want):
    """Rows past MAX_WIDTH events go, narrowest first, into slices of at
    most batch_size x MAX_WIDTH lanes (one row at least)."""
    most = [10, 20000, 5, 70000, 16384, 40000]
    assert row_slices(most, batch_size) == want
    assert row_slices([3, 16384], 4) == [[0, 1]]
    assert row_slices([70000], 1) == [[0]]


def test_heavy_reads_group_in_slices():
    """Reads from a 300-way shared core at sketch fraction 0.9 collect
    ~24,000 events each, past K4's widest row: the batch groups them in
    row slices (2 + 2 + 1 at a budget of 4 x 16384 lanes), so no event row
    holds more lanes than that, and every read's candidates equal the
    oracle's sparse chain (its top C; the core's 300 spill past C), with
    no event dropped."""
    rng = np.random.default_rng(300)
    seqs = synth_transcriptome(rng, 20, 200, 500)
    core = rng.integers(0, 4, size=150).astype(np.uint8)
    seqs += [np.concatenate([f[0], core, f[1]]) for f in rng.integers(0, 4, size=(300, 2, 30)).astype(np.uint8)]
    reads = [core[i : i + 120] for i in range(0, 25, 5)]
    for _ in range(11):
        s = seqs[int(rng.integers(20))]
        st = int(rng.integers(0, len(s) - 100))
        reads.append(s[st : st + 100])
    cfg = QuantConfig(kmer_lengths=(K,), sketch_fraction=0.9, batch_size=4)
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    index = to_device(build_index(FastaRecords([f"T{i}" for i in range(len(seqs))], text, 0), cfg, device="cpu"),
                      "cpu")
    codes = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
    lengths = np.array([r.size for r in reads], np.int32)
    widest = []

    def sort(x):
        if x.shape[1] > MAX_WIDTH:
            widest.append(tuple(x.shape))
        return row_sort_plain(x)

    res = sketch_match_step(torch.from_numpy(codes), torch.from_numpy(lengths), index, cfg,
                            (cfg.sketch_capacity_for(K, L),), sort=sort)
    assert sorted(widest) == [(1, 32768), (2, 32768), (2, 32768)]
    segments = oracle_quant(seqs, {i: r for i, r in enumerate(reads)}, (K,), sketch_fraction=0.9)[0]
    assert int(res.stats["expand_dropped"]) == 0
    spilled = sum(max(len(s) - cfg.candidate_capacity, 0) for s in segments.values())
    assert int(res.stats["candidate_spilled"]) == spilled
    for i in range(len(reads)):
        got = [(t, s) for t, s, m in zip(res.tid[i].tolist(), res.score[i].tolist(), res.mask[i].tolist()) if m]
        assert got == segments[i][: cfg.candidate_capacity], i
    assert min(sum(s for _, s in segments[i]) for i in range(5)) > MAX_WIDTH  # every core read is past the row
