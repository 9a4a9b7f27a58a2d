"""The vectorised reference (reference/quant.py) against the frozen scalar
oracle (reference/oracle.py) on small transcriptomes, with error-bearing
and off-target reads drawn by the benchmark's own generator."""

import numpy as np
import pytest
import torch

from perfbench import gen
from perfbench.reference import oracle
from perfbench.reference import quant as ref

Q = {"kmer_lengths": [31], "sketch_fraction": 0.05, "chain_fraction": 0.9, "em_max_iterations": 20,
     "em_convergence": 0.01}


def _tx(n, seed):
    seqs = gen.synth_transcriptome(np.random.default_rng(seed), n, 120, 400)
    return seqs, np.concatenate(seqs), np.array([s.size for s in seqs], np.int32)


def _mix(**kw):
    mix = {"reads": 600, "read_len": 100, "abundance_sigma": 1.5, "substitution_rate": 0.01, "off_target": 0.1,
           "packing": "codes", "pool": 1, "warmup_samples": 1, "trace_samples": 1, "check_samples": 1}
    mix.update(kw)
    return mix


def test_window_hashes_equal_the_rolling_scalar_hash():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(3, 90)).astype(np.uint8)
    for k in (1, 21, 31, 63):
        h = ref.window_hashes(torch.from_numpy(codes), k).numpy()
        for r in range(3):
            want = [x & 0xFFFFFFFF for x in oracle.nthash_forward_scalar(list(codes[r]), k)]
            assert h[r].tolist() == want


@pytest.mark.parametrize("ks", [(31,), (21, 31)])
def test_index_equals_the_oracle_index(ks):
    seqs, flat, lengths = _tx(40, 3)
    seqs.append(np.zeros(25, np.uint8))  # shorter than every k: stored, not sketched
    flat, lengths = np.concatenate([flat, seqs[-1]]), np.append(lengths, 25).astype(np.int32)
    idx = ref.build_index(torch.from_numpy(flat), torch.from_numpy(lengths), ks, 0.05)
    want = oracle.oracle_build_index(seqs, ks, 0.05)
    for k in ks:
        keys, row_ptr, postings = (x.numpy() for x in idx[k])
        assert keys.tolist() == sorted(want[k])
        got = {int(h): postings[row_ptr[i] : row_ptr[i + 1]].tolist() for i, h in enumerate(keys)}
        assert got == want[k]


@pytest.mark.parametrize("ks,sub,off", [((31,), 0.0, 0.0), ((31,), 0.01, 0.1), ((21, 31), 0.01, 0.1),
                                        ((21, 31), 0.03, 0.3)])
def test_quant_equals_the_oracle(ks, sub, off):
    seqs, flat, lengths = _tx(60, 11)
    gen_ = torch.Generator().manual_seed(2**31 + 17)
    sample = gen.draw_sample(gen_, torch.from_numpy(flat), torch.from_numpy(lengths),
                             _mix(substitution_rate=sub, off_target=off))
    codes, lens = gen.sample_codes(sample)
    q = dict(Q, kmer_lengths=list(ks))
    idx = ref.build_index(torch.from_numpy(flat), torch.from_numpy(lengths), ks, 0.05)
    got = ref.quant(codes, lens, idx, len(seqs), q, "cpu")
    reads = {f"r{i}": codes[i, : lens[i]] for i in range(len(lens))}
    segments, pi, weighted, rows = oracle.oracle_quant(seqs, reads, ks)
    np.testing.assert_allclose(got["pi"], pi, rtol=1e-12)
    np.testing.assert_allclose(got["weighted_counts"], weighted, rtol=1e-12, atol=1e-12)
    assert np.flatnonzero(got["has_entry"]).tolist() == rows
    assert got["num_mapped"] == sum(1 for c in segments.values() if c)
    assert 0 < got["num_mapped"] < len(lens)
