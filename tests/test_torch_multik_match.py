"""Multi-k grouping of the PyTorch port against the JAX package's functions.

The same per-k event rows (pure tids, INT32_MAX past a read's events) go
through both packages' group_parts_per_k, merged-mode grouping and
combine_k_tables; candidate tables must be bit-equal.  The port's sorts
run as the K4 wrapper, which takes its plain version on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sketch_rna_tpu.match import rowmatch as jrm
from sketch_rna_tpu_torch.match import rowmatch as prm
from sketch_rna_tpu_torch.match.row_sort import row_sort

I32_MAX = 2**31 - 1
CHAIN = 0.9


def _parts(seed, widths, B=48, T=40):
    """Per-k event rows: each read draws a few tids with per-k counts,
    sharing most of them across ks; some reads are empty at one k or at
    every k.  Lanes are shuffled (the grouping sorts them)."""
    rng = np.random.default_rng(seed)
    base = [rng.choice(T, size=rng.integers(1, 9), replace=False) for _ in range(B)]
    parts = []
    for ki, W in enumerate(widths):
        x = np.full((B, W), I32_MAX, np.int32)
        for b in range(B):
            if b % 7 == ki or b % 11 == 0:
                continue  # no events at this k (or at any k)
            tids = base[b] if rng.random() < 0.8 else rng.choice(T, size=3, replace=False)
            # Mostly equal counts, so many tids pass the chain fraction.
            counts = rng.integers(1, 5) - (rng.random(tids.size) < 0.2)
            ev = np.repeat(tids, np.maximum(counts, 1))[:W]
            x[b, : ev.size] = rng.permutation(ev)
        parts.append(x)
    return parts


def _tables(res):
    m = np.asarray(res.mask)
    return m, np.where(m, np.asarray(res.tid), 0), np.where(m, np.asarray(res.score), 0)


def _assert_same(port, jax_res):
    for a, b in zip(_tables(port), _tables(jax_res)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "widths,C", [((64, 32), 64), ((64, 32), 2), ((16, 16, 32), 4), ((32, 32, 32, 32), 3)]
)
def test_group_parts_per_k_equals_jax(widths, C):
    parts = _parts(sum(widths) + C, widths)
    kw = dict(chain_fraction=CHAIN, candidate_capacity=C, num_transcripts=40)
    want = jrm.group_parts_per_k([jnp.asarray(p) for p in parts], **kw)
    got = prm.group_parts_per_k([torch.from_numpy(p) for p in parts], sort=row_sort, **kw)
    _assert_same(got, want)
    total = int(got.stats["candidate_spilled"]) + int(got.stats["candidate_spilled_per_k"])
    assert total == int(want.stats["candidate_spilled"])
    if C <= 3:
        assert int(got.stats["candidate_spilled_per_k"]) > 0  # the small C spills per k


@pytest.mark.parametrize("widths,C", [((64, 32), 64), ((64, 32), 2), ((16, 16, 32), 4)])
def test_merged_grouping_equals_jax(widths, C):
    parts = _parts(sum(widths) + 2 * C, widths)
    kw = dict(chain_fraction=CHAIN, candidate_capacity=C, num_transcripts=40)
    want = jrm._group_tier_parts([jnp.asarray(p) for p in parts], num_k=len(widths), per_k_tables=False, **kw)
    got = prm.group_event_parts([torch.from_numpy(p) for p in parts], per_k_tables=False, **kw)
    _assert_same(got, want)
    assert int(got.stats["candidate_spilled"]) == int(want.stats["candidate_spilled"])
    assert int(got.stats["candidate_spilled_per_k"]) == 0


def test_merged_and_per_k_modes_agree_without_spill():
    parts = [torch.from_numpy(p) for p in _parts(5, (64, 32, 32))]
    kw = dict(chain_fraction=CHAIN, candidate_capacity=64, num_transcripts=40)
    per_k = prm.group_event_parts(parts, per_k_tables=True, **kw)
    merged = prm.group_event_parts(parts, per_k_tables=False, **kw)
    assert int(per_k.stats["candidate_spilled_per_k"]) == 0
    assert int(per_k.mask.sum()) > 20
    for f in ("tid", "score", "mask"):
        assert torch.equal(getattr(per_k, f), getattr(merged, f))


def test_combine_k_tables_equals_jax():
    parts = _parts(9, (64, 32))
    kw = dict(chain_fraction=CHAIN, num_transcripts=40)
    tables = [prm.row_events_to_candidates(torch.from_numpy(p), candidate_capacity=c, **kw)
              for p, c in zip(parts, (16, 8))]  # capacities differ: the combine pads them
    got = prm.combine_k_tables([t.tid for t in tables], [t.score for t in tables], [t.mask for t in tables],
                               candidate_capacity=6, score_bound=96, num_transcripts=40)
    want = jrm.combine_k_tables(
        [jnp.asarray(t.tid.numpy()) for t in tables],
        [jnp.asarray(t.score.numpy()) for t in tables],
        [jnp.asarray(t.mask.numpy()) for t in tables],
        candidate_capacity=6,
        score_bound=96,
        num_transcripts=40,
    )
    _assert_same(got, want)
    assert int(got.stats["candidate_spilled"]) == int(want.stats["candidate_spilled"]) > 0


@pytest.mark.parametrize("widths", [(64, 64), (64, 16), (8, 32, 16)])
def test_sort_event_parts_sorts_the_concatenation(widths):
    parts = [torch.from_numpy(p) for p in _parts(3, widths)]
    got = prm.sort_event_parts(parts)
    cat = torch.sort(torch.cat(parts, dim=1), dim=1).values
    assert got.shape[1] >= cat.shape[1] and (got[:, cat.shape[1]:] == I32_MAX).all()
    assert torch.equal(got[:, : cat.shape[1]], cat)
    if len(set(widths)) == 1:
        want = jrm.sort_event_parts([jnp.asarray(p.numpy()) for p in parts])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T,W,B", [(1 << 20, 4096, 32), (50, 1 << 15, 3)])
def test_top_c_select_equals_jax_three_operand_sort(T, W, B):
    """Past the int32 packing bound (T = 2^20 beside rank 4098) the port
    sorts int64 (rank << 32) | tid keys; a 32768-lane row (a merged
    multi-k row) is wider than K4 and selects chunk by chunk."""
    rng = np.random.default_rng(T + W)
    meets = rng.random((B, W)) < 0.3
    tid = rng.integers(0, T, size=(B, W)).astype(np.int32)
    score = rng.integers(1, 40, size=(B, W)).astype(np.int32)
    tid[:, : W // 2] = tid[:, :1]  # ties on score break by tid, repeated tids too
    kw = dict(score_bound=W, candidate_capacity=64, num_transcripts=T)
    want = jrm._top_c_select(jnp.asarray(meets), jnp.asarray(tid), jnp.asarray(score), **kw)
    got = prm._top_c_select(torch.from_numpy(meets), torch.from_numpy(tid), torch.from_numpy(score),
                            sort=row_sort, **kw)
    _assert_same(got, want)
    assert got.tid.dtype == got.score.dtype == torch.int32
    assert int(got.stats["candidate_spilled"]) == int(want.stats["candidate_spilled"]) > 0
