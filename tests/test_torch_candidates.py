"""The port's global-sort matcher (match/candidates.py) against the JAX
package's, and against the port's row matcher.

Same index (the JAX build_index), same sketches (the JAX sketch_batch,
as numpy): the candidate tables, the per-k drop counts and the spill
count must be equal, under a budget that drops nothing, one that drops
events and a capacity that spills, for one k and two.  When nothing
drops, the global-sort tables must equal the row matcher's
(pipeline.sketch_match_step).  expand_postings' edges: an empty index,
no hits, a budget of 0.  Sizes as tests/test_rowmatch.py's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.match.candidates import match_batch as jax_match_batch
from sketch_rna_tpu.match.lookup import expand_postings as jax_expand_postings
from sketch_rna_tpu.pipeline import _padded_index_arrays
from sketch_rna_tpu.sketch.fracminhash import sketch_batch as jax_sketch_batch
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.match.candidates import expand_postings, match_batch
from sketch_rna_tpu_torch.pipeline import sketch_match_step
from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k

from util import decode, make_transcriptome, sample_reads

L = 128


def _problem(ks):
    rng = np.random.default_rng(5)
    seqs = make_transcriptome(rng, n=20, len_range=(60, 600))
    recs = JaxRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    idx = jax_build_index(recs, JaxConfig(kmer_lengths=ks))
    reads = [r for r in sample_reads(rng, seqs, n_reads=200, read_len=100) if r.size >= max(ks)]
    codes = np.zeros((len(reads), L), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lengths[i] = r.size
    return idx, codes, lengths


@pytest.fixture(scope="module", params=[(31,), (21, 31)], ids=["k31", "k21_31"])
def problem(request):
    ks = request.param
    idx, codes, lengths = _problem(ks)
    cfg = JaxConfig(kmer_lengths=ks)
    hashes, masks = [], []
    for k in ks:
        h, m, _ = jax_sketch_batch(jnp.asarray(codes), jnp.asarray(lengths), k, cfg.sketch_fraction,
                                   cfg.sketch_capacity_for(k))
        hashes.append(np.asarray(h))
        masks.append(np.asarray(m))
    return ks, idx, codes, lengths, hashes, masks


def _port_match(problem, epr, C):
    ks, idx, _, _, hashes, masks = problem
    dev = to_device(idx, "cpu")
    return match_batch(
        [torch.from_numpy(h.astype(np.int64)) for h in hashes],
        [torch.from_numpy(m.copy()) for m in masks],
        [dev.per_k[k].keys for k in ks],
        [dev.per_k[k].row_ptr for k in ks],
        [dev.per_k[k].postings for k in ks],
        chain_fraction=0.9,
        expand_per_read=epr,
        candidate_capacity=C,
    )


@pytest.mark.parametrize("epr,C,what", [(64, 64, "exact"), (2, 64, "drops"), (64, 2, "spills")])
def test_match_batch_equals_jax(problem, epr, C, what):
    ks, idx, _, _, hashes, masks = problem
    keys, row_ptr, postings = _padded_index_arrays(idx, ks)
    want = jax_match_batch(
        [jnp.asarray(h) for h in hashes],
        [jnp.asarray(m) for m in masks],
        [jnp.asarray(a) for a in keys],
        [jnp.asarray(a) for a in row_ptr],
        [jnp.asarray(a) for a in postings],
        chain_fraction=0.9,
        expand_per_read=epr,
        candidate_capacity=C,
    )
    got = _port_match(problem, epr, C)
    for field in ("tid", "score", "mask"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    drops = got.stats["expand_dropped"].numpy()
    np.testing.assert_array_equal(drops, np.asarray(want.stats["expand_dropped"]))
    spilled = int(got.stats["candidate_spilled"])
    assert spilled == int(want.stats["candidate_spilled"])
    assert (drops.sum() > 0) == (what == "drops") and (spilled > 0) == (what == "spills")
    assert int(got.mask.sum()) > 100


def test_match_batch_equals_row_matcher(problem):
    """Nothing dropped: the two formulations give the same tables."""
    ks, idx, codes, lengths, _, _ = problem
    cfg = QuantConfig(kmer_lengths=ks)
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)
    dev = to_device(idx, "cpu")
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    row = sketch_match_step(c, n, dev, cfg, caps)
    assert int(row.stats["candidate_spilled_per_k"]) == 0
    sketches = sketch_all_k(c, n, ks, cfg.sketch_fraction, caps)
    glob = match_batch(
        [h for h, _, _ in sketches],
        [m for _, m, _ in sketches],
        [dev.per_k[k].keys for k in ks],
        [dev.per_k[k].row_ptr for k in ks],
        [dev.per_k[k].postings for k in ks],
        chain_fraction=cfg.chain_fraction,
        expand_per_read=1024,
        candidate_capacity=cfg.candidate_capacity,
    )
    assert int(glob.stats["expand_dropped"].sum()) == 0
    for field in ("tid", "score", "mask"):
        assert torch.equal(getattr(glob, field), getattr(row, field)), field
    assert int(glob.stats["candidate_spilled"]) == int(row.stats["candidate_spilled"])
    assert int(row.mask.sum()) > 100


def _runs(case):
    """(start, length, postings, budget) of an expand_postings edge case."""
    rng = np.random.default_rng(3)
    B, S = 6, 5
    if case == "empty-index":
        return np.zeros((B, S), np.int32), np.zeros((B, S), np.int32), np.zeros(0, np.int32), 16
    postings = rng.integers(0, 50, size=40).astype(np.int32)
    start = rng.integers(0, 30, size=(B, S)).astype(np.int32)
    length = rng.integers(0, 4, size=(B, S)).astype(np.int32)
    if case == "no-hits":
        return start * 0, length * 0, postings, 16
    return start, length, postings, 0  # budget 0: every event dropped


@pytest.mark.parametrize("case", ["empty-index", "no-hits", "budget-0"])
def test_expand_postings_edges(case):
    start, length, postings, budget = _runs(case)
    read, tid, valid, dropped = expand_postings(
        torch.from_numpy(start), torch.from_numpy(length), torch.from_numpy(postings), budget
    )
    B = start.shape[0]
    assert read.shape == tid.shape == valid.shape == (budget,)
    assert not bool(valid.any()) and bool((read == B).all()) and bool((tid == 0).all())
    assert int(dropped) == int(length.sum())
    if postings.size:  # the JAX expansion needs a posting to gather
        want = jax_expand_postings(jnp.asarray(start), jnp.asarray(length), jnp.asarray(postings), budget)
        for g, w in zip((read, tid, valid, dropped), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "budget-0":
        assert int(dropped) > 0
