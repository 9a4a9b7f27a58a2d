"""The port's width-tiered EM tables (em/classes.py, pipeline.em_tables)
against the JAX package's, on the CPU.

  - the tier tables of [N, W] candidate rows drawn from numpy seeds equal
    the JAX package's group_candidate_rows_meta -> plan_class_tables ->
    build_class_tables bit for bit: each tier's width, the multiset of its
    live rows as (tid row, score row, weight), static_base and static_has;
    in seven cases (every tier with singletons, fold off, row weights, no
    wide class, W = 8, W = 4, N < 1024);
  - the per-read split (em_equivalence_classes off) equals the JAX
    package's _em_tables the same way;
  - the JAX package's tier quants (tests/test_equivalence_classes.py's
    width partition, singleton fold with the mid tier, pair tier): the
    port's fold, no-fold and per-read runs agree with each other and with
    the JAX package's quantify within rtol 1e-12, atol 1e-13, in the same
    EM iterations;
  - the EM over the tiers equals the EM over the old single [M, W] table
    within 1e-12 on both routes, and segsum gives the same bits twice;
  - QuantResult.sizes: em_lanes the tiers' lanes, no more than the JAX
    package's padded count, em_width_max the JAX package's.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rna_tpu import pipeline as jax_pipeline
from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.em import classes as jax_classes
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu_torch import pipeline
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.em.classes import build_class_tables
from sketch_rna_tpu_torch.em.em import assign_reads_tables, run_em_tables
from sketch_rna_tpu_torch.em.segsum import plan_from_tables
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.io.packing import PackedReads

from util import decode, make_transcriptome, sample_reads

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

from profile_em_scatter_torch import single_layout  # noqa: E402

WIDTHS = dict(narrow_width=4, mid_width=8)  # the JAX engine's _EM_NARROW_WIDTH, _EM_MID_WIDTH
T = 400


def _candidate_rows(seed, N, W, max_cand, weighted=False):
    """[N, W] int32 rank-ordered candidate rows (score desc, tid asc,
    zero-padded), drawn from a pool of N // 6 profiles so rows repeat;
    each profile's candidate count uniform in 0 .. max_cand.  With
    `weighted`, [N] row weights in 0 .. 3 (zeros make dead rows)."""
    rng = np.random.default_rng(seed)
    P = N // 6
    prof_t = np.zeros((P, W), np.int32)
    prof_s = np.zeros((P, W), np.int32)
    for p in range(P):
        c = int(rng.integers(0, max_cand + 1))
        t = rng.choice(T, c, replace=False)
        s = rng.integers(1, 6, c)
        order = np.lexsort((t, -s))
        prof_t[p, :c], prof_s[p, :c] = t[order], s[order]
    pick = rng.integers(0, P, N)
    weight = rng.integers(0, 4, N).astype(np.int32) if weighted else None
    return prof_t[pick], prof_s[pick], weight


def _live_rows(table):
    """A table's live rows as a sorted list of (tid row, score row, weight)."""
    tid, score = (np.asarray(x) for x in table[:2])
    weight = np.ones(tid.shape[0], np.int64) if table[2] is None else np.asarray(table[2]).astype(np.int64)
    return sorted((tuple(t), tuple(s), int(w)) for t, s, w in zip(tid.tolist(), score.tolist(), weight) if w > 0)


def _tiers(tables):
    """(width, live rows) of each table that holds a live row, in order."""
    out = [(int(np.asarray(t[0]).shape[1]), _live_rows(t)) for t in tables]
    return [(w, rows) for w, rows in out if rows]


# name: (seed, N, W, max candidates, fold, weighted, the port's tier widths)
CASES = {
    "every-tier": (1, 4096, 16, 16, True, False, [16, 8, 4, 2]),
    "fold-off": (2, 4096, 16, 16, False, False, [16, 8, 4, 2]),
    "row-weight": (3, 4096, 16, 16, True, True, [16, 8, 4, 2]),
    "no-wide": (4, 4096, 16, 4, True, False, [4, 2]),
    "w8-no-mid": (5, 4096, 8, 8, True, False, [8, 4, 2]),
    "w4": (6, 4096, 4, 4, True, False, [4, 2]),
    "n-below-1024": (7, 700, 16, 16, True, False, [16]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tier_tables_equal_jax(case):
    seed, N, W, max_cand, fold, weighted, port_widths = CASES[case]
    tid, score, weight = _candidate_rows(seed, N, W, max_cand, weighted)
    jw = None if weight is None else jnp.asarray(weight)
    rep, jweight, scalars = jax_classes.group_candidate_rows_meta(jnp.asarray(tid), jnp.asarray(score),
                                                                  row_weight=jw, **WIDTHS)
    plan = jax_classes.plan_class_tables(np.asarray(scalars), width=W, n_pad=N, fold_singletons=fold, pair_width=2,
                                         **WIDTHS)
    j_tables, j_base, j_has = jax_classes.build_class_tables(jnp.asarray(tid), jnp.asarray(score), rep, jweight,
                                                             num_transcripts=T, **plan)
    tables, base, has = build_class_tables(
        torch.from_numpy(tid), torch.from_numpy(score), num_transcripts=T, fold=fold, n_rows=N, pair_width=2,
        row_weight=None if weight is None else torch.from_numpy(weight), **WIDTHS)
    got, want = _tiers(tables), _tiers(j_tables)
    assert [w for w, _ in got] == [w for w, _ in want] == port_widths
    for (_, g), (_, j) in zip(got, want):
        assert g == j
    assert all(t[0].shape[0] == len(rows) for t, (_, rows) in zip(tables, got))  # exact rows: none dead
    if j_base is None:
        assert base is None and has is None
    else:
        np.testing.assert_array_equal(base.numpy(), np.asarray(j_base))
        np.testing.assert_array_equal(has.numpy(), np.asarray(j_has))
        assert base.sum() > 0


@pytest.mark.parametrize("case", ["wide", "no-wide", "weighted", "n-below-1024"])
def test_per_read_split_equals_jax(case):
    N = 700 if case == "n-below-1024" else 2048
    tid, score, weight = _candidate_rows(11, N, 16, 4 if case == "no-wide" else 16, case == "weighted")
    jcfg = JaxConfig(em_equivalence_classes=False)
    j_tables, j_base, _ = jax_pipeline._em_tables(jnp.asarray(tid), jnp.asarray(score), jcfg,
                                                  row_weight=None if weight is None else jnp.asarray(weight),
                                                  num_transcripts=T)
    tables, base, _ = pipeline.em_tables(torch.from_numpy(tid), torch.from_numpy(score),
                                         QuantConfig(em_equivalence_classes=False), num_transcripts=T, n_rows=N,
                                         row_weight=None if weight is None else torch.from_numpy(weight))
    assert base is None and j_base is None
    got, want = _tiers(tables), _tiers(j_tables)
    assert [w for w, _ in got] == [w for w, _ in want]
    assert [rows for _, rows in got] == [rows for _, rows in want]
    assert sum(t[0].shape[0] for t in tables) == N


def _packed(reads, width=128):
    codes = np.zeros((len(reads), width), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    return codes, lens


def _quants(seqs, reads, cfg_kw, monkeypatch, variants):
    """The JAX package's quantify (its defaults: classes, fold, tiers) and
    the port's under each variant (name -> (config changes, pair width)),
    float64, on the same reads; and each port run's EM tables: their
    widths ("fold" last when singletons fold) and lanes."""
    recs = JaxRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    jcfg = JaxConfig(kmer_lengths=(31,), batch_size=512, max_read_len=128, em_dtype="float64", **cfg_kw)
    idx = jax_build_index(recs, jcfg)
    codes, lens = _packed(reads)
    ids = [str(i) for i in range(len(reads))]
    ref = jax_pipeline.quantify(idx, JaxPacked(codes, lens, ids), jcfg)
    index = to_device(idx, "cpu")
    cfg = QuantConfig(kmer_lengths=(31,), batch_size=512, max_read_len=128, em_dtype="float64", **cfg_kw)
    seen = []
    real = pipeline.em_tables

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(([int(t[0].shape[1]) for t in out[0]] + (["fold"] if out[1] is not None else []),
                     sum(t[0].numel() for t in out[0])))
        return out

    monkeypatch.setattr(pipeline, "em_tables", spy)
    runs, layouts, lanes = {}, {}, {}
    for name, (changes, pair) in variants.items():
        monkeypatch.setattr(pipeline, "_EM_PAIR_WIDTH", pair)
        runs[name] = pipeline.quantify(index, PackedReads(codes, lens, ids), dataclasses.replace(cfg, **changes))
        layouts[name], lanes[name] = seen.pop()
    return ref, runs, layouts, lanes


def _assert_same(a, b):
    assert a.em_iterations == b.em_iterations
    np.testing.assert_allclose(a.pi, b.pi, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(a.weighted_counts, b.weighted_counts, rtol=1e-12, atol=1e-13)
    np.testing.assert_array_equal(a.has_entry, b.has_entry)


FOLD_VARIANTS = {"fold": ({}, 2), "no-fold": ({"em_fold_singletons": False}, 2),
                 "per-read": ({"em_equivalence_classes": False}, 2)}


def test_width_partitioned_em_equals_per_read(monkeypatch):
    """A 16-isoform family forces wide candidate rows (the JAX test's
    transcriptome, seed 888)."""
    rng = np.random.default_rng(888)
    base = rng.integers(0, 4, size=500).astype(np.uint8)
    seqs = [base]
    for _ in range(15):
        a = int(rng.integers(0, 150))
        b = int(rng.integers(a, 450))
        seqs.append(np.concatenate([base[:a], base[b:], rng.integers(0, 4, size=40).astype(np.uint8)]))
    seqs += [rng.integers(0, 4, size=300).astype(np.uint8) for _ in range(4)]
    reads = [r for r in sample_reads(rng, seqs, n_reads=400, read_len=100, error_rate=0.0) if r.size >= 31] * 4
    ref, runs, layouts, _ = _quants(seqs, reads[:1500], {"candidate_capacity": 32}, monkeypatch, FOLD_VARIANTS)
    assert layouts["fold"][0] > 8 and "fold" in layouts["fold"] and "fold" not in layouts["no-fold"]
    assert layouts["per-read"] == [4, layouts["fold"][0]]  # the narrow / wide split
    for run in runs.values():
        _assert_same(run, ref)
    _assert_same(runs["fold"], runs["no-fold"])
    _assert_same(runs["fold"], runs["per-read"])


def test_singleton_fold_and_mid_tier_exact(monkeypatch):
    """Families of 1, ~6 and ~16 isoforms (the JAX test's, seed 999), so
    the wide, mid, narrow and pair tiers and the fold all engage."""
    rng = np.random.default_rng(999)
    base6 = rng.integers(0, 4, size=400).astype(np.uint8)
    base16 = rng.integers(0, 4, size=500).astype(np.uint8)
    seqs = [rng.integers(0, 4, size=300).astype(np.uint8) for _ in range(8)]
    for _ in range(6):
        a = int(rng.integers(0, 100))
        seqs.append(np.concatenate([base6[:a], base6[a + 20:], rng.integers(0, 4, size=30).astype(np.uint8)]))
    for _ in range(16):
        a = int(rng.integers(0, 150))
        b = int(rng.integers(a, 450))
        seqs.append(np.concatenate([base16[:a], base16[b:], rng.integers(0, 4, size=40).astype(np.uint8)]))
    reads = [r for r in sample_reads(rng, seqs, n_reads=500, read_len=100, error_rate=0.0) if r.size >= 31] * 4
    ref, runs, layouts, _ = _quants(seqs, reads[:1900], {"candidate_capacity": 32}, monkeypatch, FOLD_VARIANTS)
    assert layouts["fold"] == [16, 8, 4, 2, "fold"] and layouts["no-fold"] == [16, 8, 4, 2], layouts
    for run in runs.values():
        _assert_same(run, ref)
    _assert_same(runs["fold"], runs["no-fold"])
    _assert_same(runs["fold"], runs["per-read"])


def test_pair_tier_exact(monkeypatch):
    """The pair tier is a layout change only: on (the default) and off
    (pair width 0) agree, and with the JAX package's quantify."""
    rng = np.random.default_rng(0xC0FFEE)
    seqs = make_transcriptome(rng, n=30, len_range=(100, 500))
    reads = [r for r in sample_reads(rng, seqs, n_reads=600, read_len=90) if r.size >= 31] * 2
    ref, runs, layouts, _ = _quants(seqs, reads, {"candidate_capacity": 32}, monkeypatch,
                                 {"on": ({}, 2), "off": ({}, 0)})
    assert 2 in layouts["on"] and 2 not in layouts["off"], layouts
    _assert_same(runs["on"], ref)
    _assert_same(runs["off"], ref)
    _assert_same(runs["on"], runs["off"])


@pytest.mark.parametrize("segsum", [False, True], ids=["scatter", "segsum"])
def test_em_over_tiers_equals_single_table(segsum):
    tid, score, _ = _candidate_rows(1, 4096, 16, 16)
    tables, base, has = build_class_tables(torch.from_numpy(tid), torch.from_numpy(score), num_transcripts=T,
                                           fold=True, n_rows=4096, pair_width=2, **WIDTHS)
    assert len(tables) == 4
    single = [single_layout(tables)]
    kw = dict(num_transcripts=T, dtype="float64", static_base=base, use_segsum=segsum)
    outs = []
    for tabs in (tables, single, tables):
        plan = plan_from_tables(tabs, T) if segsum else None
        pi, iters, _ = run_em_tables(tabs, 4096, max_iterations=20, segsum_plan=plan, **kw)
        counts, entry = assign_reads_tables(tabs, pi, static_has=has, segsum_plan=plan, **kw)
        outs.append((pi, iters, counts, entry))
    (pi, iters, counts, entry), (pi1, iters1, counts1, entry1), again = outs
    assert iters == iters1 and torch.equal(entry, entry1) and iters > 1
    for a, b in ((pi, pi1), (counts, counts1)):
        assert float(((a - b).abs() / b.abs().clamp_min(1e-300)).max()) <= 1e-12
    if segsum:
        assert all(torch.equal(x, y) for x, y in zip((pi, counts, entry), (again[0], again[2], again[3])))


def test_sizes_count_the_tiers(monkeypatch):
    rng = np.random.default_rng(5)
    seqs = make_transcriptome(rng, n=40, len_range=(150, 600), family_size=6)
    reads = [r for r in sample_reads(rng, seqs, n_reads=2000, read_len=100) if r.size >= 31]
    ref, runs, layouts, lanes = _quants(seqs, reads, {}, monkeypatch, {"default": ({}, 2)})
    got = runs["default"]
    widths = [w for w in layouts["default"] if w != "fold"]
    assert len(widths) > 1, layouts
    assert got.sizes["em_lanes"] == lanes["default"] and got.sizes["em_width_max"] == max(widths)
    assert got.sizes["em_width_max"] == ref.sizes["em_width_max"]
    assert 0 < got.sizes["em_lanes"] <= ref.sizes["em_lanes"]
    _assert_same(got, ref)
