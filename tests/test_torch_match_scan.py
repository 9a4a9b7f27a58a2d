"""pipeline.match_scan (one host read a length group; CUDA graphs on a
card) against the JAX package's match_scan and the port's per-batch
route, and the posting-expansion kernel's plain version.

- match_scan's tables equal the JAX package's pipeline.match_scan on the
  CPU (match_tiers off, expand_per_read past every read's events), over
  two length groups with a ragged last batch each, at k = 31 and
  (21, 31): integer outputs bit-equal;
- match_scan equals match_rows' per-batch route (sketch_match_step),
  tables, padded count and every stat,
  including a batch whose reads pass MAX_WIDTH events (row slices) and
  batches whose per-k tables spill (regrouped merged);
- through the read hook, one size read a length group, plus the one
  spill read at K > 1, whatever the batch count;
- row_expand_plain equals the expansion it replaced (repeat_interleave)
  and the JAX package's row_expand_from_runs at k_index 0, num_k 1, on
  runs drawn from a seed, with empty rows, all-empty batches and
  W = MIN_WIDTH;
- the chain-fraction test gives the same meets on its exact integer path
  and its float32 path;
- the steps match_scan captures on a card read nothing to the host
  (no .item(), .tolist(), bool() or int() of a tensor), here where they
  run eagerly;
- which batches the grouping kernel G takes (match/group.py
  group_kernel_takes), what group_event_parts hands it, and the counter
  match.group_kernel_batches, one a batch G groups whole (G itself runs
  on a card only: chip_smoke.py's group phase holds it to the plain chain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.match import rowmatch as jrm
from sketch_rna_tpu.pipeline import _device_index, match_scan as jax_match_scan
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch import pipeline
from sketch_rna_tpu_torch.match import group, rowmatch
from sketch_rna_tpu_torch.match.expand import row_expand, row_expand_plain
from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, MIN_WIDTH, row_sort_plain
from sketch_rna_tpu_torch.pipeline import match_rows, match_scan, sketch_match_step
from sketch_rna_tpu_torch.utils import step_graphs
from sketch_rna_tpu_torch.utils.timing import PhaseTimer
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

from util import decode

I32_MAX = 2**31 - 1
B = 16


@pytest.fixture(scope="module")
def problem():
    """180 isoform-family transcripts, both packages' indexes at k = 31 and
    (21, 31), and 61 reads in two length groups, shuffled together: 40 of
    120 bp and 21 of up to 300 bp (fewer from a shorter transcript), those
    past 256 bp in the pad-512 group and the rest in the pad-256 one."""
    rng = np.random.default_rng(16)
    seqs = synth_transcriptome(rng, 180, 350, 900)
    names = [f"T{i}" for i in range(len(seqs))]
    text = [decode(s) for s in seqs]
    indexes = {}
    for ks in ((31,), (21, 31)):
        jidx = jax_build_index(JaxRecords(names, text, 0), JaxConfig(kmer_lengths=ks))
        indexes[ks] = (jidx, to_device(jidx, "cpu"))
    c1, l1 = sample_reads(seqs, 40, 120, 512, seed=3)
    c2, l2 = sample_reads(seqs, 21, 300, 512, seed=4)
    perm = np.random.default_rng(5).permutation(61)
    lengths = np.concatenate([l1, l2])[perm]
    assert 10 < int((lengths > 256).sum()) <= 21
    return indexes, np.concatenate([c1, c2])[perm], lengths, seqs


def _group_sizes(lengths):
    """Reads a length group, as the JAX engine groups them (pads 256, 512)."""
    return [int((lengths <= 256).sum()), int((lengths > 256).sum())]


def _round_up(n, m):
    return -(-n // m) * m


def jax_scan_tables(jidx, codes, lengths, cfg):
    """The JAX package's match_scan over the reads, grouped and padded as
    its _match_tables does (no tiers, an expansion window past every
    read's events): (tid, score, stats) of the reads, rows in group order."""
    ks = tuple(cfg.kmer_lengths)
    bp, post, meta = _device_index(jidx, ks)
    bp, post = tuple(jnp.asarray(a) for a in bp), tuple(jnp.asarray(a) for a in post)
    pad_of = np.maximum(256, 1 << np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64))
    pads = np.minimum(pad_of, max(codes.shape[1], 256))
    tids, scores, stats = [], [], []
    for pad in sorted(set(pads.tolist())):
        rows = np.flatnonzero(pads == pad)
        n = rows.size
        L = min(min(pad, codes.shape[1]), _round_up(max(int(lengths[rows].max()), max(ks)), 8))
        nb = -(-n // cfg.batch_size)
        c = np.zeros((nb * cfg.batch_size, L), np.uint8)
        c[:n] = codes[rows, :L]
        ln = np.zeros(nb * cfg.batch_size, np.int32)
        ln[:n] = lengths[rows]
        t, s, _, st = jax_match_scan(
            jnp.asarray(c.reshape(nb, cfg.batch_size, L)), jnp.asarray(ln.reshape(nb, cfg.batch_size)), bp, post,
            kmer_lengths=ks, sketch_fraction=cfg.sketch_fraction,
            sketch_caps=tuple(cfg.sketch_capacity_for(k, L) for k in ks), chain_fraction=cfg.chain_fraction,
            expand_per_read=cfg.expand_per_read, candidate_capacity=cfg.candidate_capacity, bucket_meta=meta,
            num_transcripts=jidx.num_transcripts, match_tiers=False, match_per_k_tables=cfg.match_per_k_tables)
        tids.append(np.asarray(t)[:n])
        scores.append(np.asarray(s)[:n])
        stats.append({key: int(np.asarray(v).sum()) for key, v in st.items()})
    return np.concatenate(tids), np.concatenate(scores), {key: sum(s[key] for s in stats) for key in stats[0]}


@pytest.mark.parametrize("ks,C", [((31,), 64), ((31,), 2), ((21, 31), 64)], ids=["k31", "k31_C2", "k21_31"])
def test_match_scan_equals_jax_match_scan(problem, ks, C):
    indexes, codes, lengths, _ = problem
    jidx, index = indexes[ks]
    cfg = QuantConfig(kmer_lengths=ks, batch_size=B, candidate_capacity=C)
    tid, score, n_padded, stats = match_scan(index, torch.from_numpy(codes), lengths, cfg)
    assert int(stats["candidate_spilled_per_k"]) == 0  # the JAX scan then spills exactly as the port
    j_tid, j_score, j_stats = jax_scan_tables(jidx, codes, lengths, JaxConfig(
        kmer_lengths=ks, batch_size=B, candidate_capacity=C, expand_per_read=1 << 12))
    np.testing.assert_array_equal(score.numpy(), j_score)
    np.testing.assert_array_equal(tid.numpy(), np.where(j_score > 0, j_tid, 0))
    assert n_padded == sum(_round_up(n, B) for n in _group_sizes(lengths))
    assert j_stats["expand_dropped"] == 0 == int(stats["expand_dropped"])
    assert int(stats["sketch_overflow"]) == j_stats["sketch_overflow"]
    assert int(stats["candidate_spilled"]) == j_stats["candidate_spilled"]
    assert (score.numpy() > 0).any(axis=1).mean() > 0.9
    if C == 2:
        assert int(stats["candidate_spilled"]) > 0


def _same_as_per_batch(index, codes, lengths, cfg, read=rowmatch._read_local):
    """match_scan against match_rows' per-batch route: equal tables,
    padded count and stats; returns match_scan's stats."""
    got = match_scan(index, torch.from_numpy(codes), lengths, cfg, read=read)
    want = match_rows(index, torch.from_numpy(codes), lengths, cfg, step=sketch_match_step)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    assert {k: int(v) for k, v in got[3].items()} == {k: int(v) for k, v in want[3].items()}
    # match_rows' default route is match_scan.
    dflt = match_rows(index, torch.from_numpy(codes), lengths, cfg)
    assert torch.equal(dflt[0], got[0]) and torch.equal(dflt[1], got[1])
    return got[3]


@pytest.mark.parametrize("ks,C,per_k", [((31,), 64, True), ((31,), 3, True), ((21, 31), 64, True),
                                        ((21, 31), 2, True), ((21, 31), 4, False)],
                         ids=["k31", "k31_C3", "k21_31", "k21_31_spill", "k21_31_merged"])
def test_match_scan_equals_per_batch_route(problem, ks, C, per_k):
    indexes, codes, lengths, _ = problem
    cfg = QuantConfig(kmer_lengths=ks, batch_size=B, candidate_capacity=C, match_per_k_tables=per_k)
    stats = _same_as_per_batch(indexes[ks][1], codes, lengths, cfg)
    if (ks, C) == ((21, 31), 2):
        assert int(stats["candidate_spilled_per_k"]) > 0  # some batches regroup merged


def test_match_scan_slices_heavy_batch():
    """Reads from a 300-way shared core at sketch fraction 0.9 pass K4's
    widest row: their batch groups in row slices, eagerly, and equals the
    per-batch route; the other batch replays the ordinary step."""
    rng = np.random.default_rng(300)
    seqs = synth_transcriptome(rng, 20, 200, 500)
    core = rng.integers(0, 4, size=150).astype(np.uint8)
    seqs += [np.concatenate([f[0], core, f[1]]) for f in rng.integers(0, 4, size=(300, 2, 30)).astype(np.uint8)]
    reads = [core[i : i + 120] for i in range(0, 15, 5)]
    for _ in range(6):
        s = seqs[int(rng.integers(20))]
        st = int(rng.integers(0, len(s) - 100))
        reads.append(s[st : st + 100])
    cfg = QuantConfig(kmer_lengths=(31,), sketch_fraction=0.9, batch_size=4)
    text = [decode(s) for s in seqs]
    index = to_device(build_index(FastaRecords([f"T{i}" for i in range(len(seqs))], text, 0), cfg, device="cpu"),
                      "cpu")
    codes = np.zeros((len(reads), 128), np.uint8)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
    lengths = np.array([r.size for r in reads], np.int32)
    reads_seen = []

    def read(x, n):
        reads_seen.append(x.numel())
        return x.tolist()

    stats = _same_as_per_batch(index, codes, lengths, cfg, read)
    assert int(stats["expand_dropped"]) == 0 and int(stats["candidate_spilled"]) > 0
    # The group's one read (3 batches x 1 k), then the heavy batch's own
    # reads of its rows' totals and each slice's sizes.
    assert reads_seen[0] == 3 and len(reads_seen) > 1


@pytest.mark.parametrize("ks,per_k,nb", [((31,), True, 1), ((31,), True, 6), ((21, 31), True, 4),
                                         ((21, 31), False, 4)],
                         ids=["k31_1", "k31_6", "k21_31_per_k", "k21_31_merged"])
def test_one_size_read_a_length_group(problem, ks, per_k, nb):
    """Two length groups: two size reads, whatever the batch count, and at
    K > 1 with per-k tables one more for the spills."""
    indexes, codes, lengths, _ = problem
    calls = []

    def read(x, n):
        calls.append(n)
        return x.tolist()

    sizes = _group_sizes(lengths)
    batch = -(-sizes[0] // nb)  # the larger group in nb batches
    cfg = QuantConfig(kmer_lengths=ks, batch_size=batch, match_per_k_tables=per_k)
    match_scan(indexes[ks][1], torch.from_numpy(codes), lengths, cfg, read=read)
    groups = [-(-n // batch) for n in sizes]
    want = [nb_g * len(ks) for nb_g in groups] + ([sum(groups)] if len(ks) > 1 and per_k else [])
    assert calls == want


def _repeat_interleave_expand(start, length, postings, W):
    """The port's expansion before the kernel E: one flat event vector by
    repeat_interleave, scattered into the rows."""
    B, S = start.shape
    key = torch.full((B, W), I32_MAX, dtype=torch.int32)
    n_ev = int(length.sum())
    if n_ev:
        lens = length.reshape(-1)
        run = torch.repeat_interleave(torch.arange(B * S), lens, output_size=n_ev)
        first_event = torch.cumsum(lens, 0) - lens
        within = torch.arange(n_ev) - first_event[run]
        col = (torch.cumsum(length, dim=1) - length).reshape(-1)[run] + within
        key[run // S, col] = postings[start.reshape(-1)[run] + within]
    return key


def _runs(seed, B, S, P):
    """Posting runs from a seed: lengths 0-6 with a quarter of the lanes
    masked out, some rows empty, starts inside postings [P]."""
    rng = np.random.default_rng(seed)
    length = rng.integers(0, 7, size=(B, S)) * (rng.random((B, S)) < 0.75)
    length[rng.random(B) < 0.2] = 0
    start = rng.integers(0, P - 6, size=(B, S)) * (length > 0)
    return start.astype(np.int64), length.astype(np.int64)


@pytest.mark.parametrize("seed,B,S", [(0, 33, 8), (1, 7, 1), (2, 64, 32), (3, 5, 3000), (4, 12, 5)])
def test_row_expand_plain_equals_old_expansion_and_jax(seed, B, S):
    P = 500
    postings = np.random.default_rng(seed + 100).integers(0, 10**6, size=P).astype(np.int32)
    start, length = _runs(seed, B, S, P)
    most = int(length.sum(axis=1).max())
    for W in sorted({max(1 << max(most - 1, 0).bit_length(), MIN_WIDTH), MIN_WIDTH << 7}):
        if W < most:
            continue
        s, ln, post = torch.from_numpy(start), torch.from_numpy(length), torch.from_numpy(postings)
        got = row_expand_plain(s, ln, post, W)
        assert got.dtype == torch.int32 and tuple(got.shape) == (B, W)
        assert torch.equal(got, _repeat_interleave_expand(s, ln, post, W))
        assert torch.equal(row_expand(s, ln, post, W), got)  # the wrapper's CPU route
        key, dropped = jrm.row_expand_from_runs(jnp.asarray(start.astype(np.int32)), jnp.asarray(length.astype(
            np.int32)), jnp.asarray(postings), events_per_read=W, k_index=0, num_k=1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(key))
        assert int(dropped) == 0


@pytest.mark.parametrize("B,S,W", [(4, 6, MIN_WIDTH), (3, 1, MIN_WIDTH), (0, 4, 8), (5, 0, 4)],
                         ids=["min_width", "one_lane", "no_rows", "no_lanes"])
def test_row_expand_plain_all_empty_batches(B, S, W):
    postings = torch.arange(9, dtype=torch.int32)
    z = torch.zeros((B, S), dtype=torch.int64)
    assert torch.equal(row_expand_plain(z, z, postings, W), torch.full((B, W), I32_MAX, dtype=torch.int32))
    if B and S:  # one event a row fills the first lane of W = MIN_WIDTH
        ln = z.clone()
        ln[:, -1] = 1
        st = z + 3
        got = row_expand_plain(st, ln, postings, W)
        assert got[:, 0].tolist() == [3] * B and (got[:, 1:] == I32_MAX).all()
        assert torch.equal(got, _repeat_interleave_expand(st, ln, postings, W))


def test_row_expand_checks_its_inputs():
    s = torch.zeros((2, 3), dtype=torch.int64)
    post = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        row_expand(s, s, post, 6)  # not a power of two
    with pytest.raises(ValueError):
        row_expand(s, s, post, 1)  # below MIN_WIDTH
    with pytest.raises(TypeError):
        row_expand(s.int(), s.int(), post, 4)
    with pytest.raises(TypeError):
        row_expand(s, s, post.long(), 4)


@pytest.mark.parametrize("fraction", [0.9, 0.5, 0.75, 0.8, 0.25, 1 / 3])
def test_chain_fraction_paths_agree(fraction, monkeypatch):
    """chain_passes' exact rational path (taken at these fractions) and its
    float32 path (forced by a fraction without a small rational) give the
    same meets over counts and bests up to 3,000."""
    p, q = rowmatch._fraction_compare_params(fraction)
    assert q > 0
    best = torch.arange(3001, dtype=torch.int64)[:, None]
    count = torch.arange(3001, dtype=torch.int64)[None, :]
    exact = rowmatch.chain_passes(count, best, fraction)
    monkeypatch.setattr(rowmatch, "_fraction_compare_params", lambda fraction: (0, 0))
    assert torch.equal(exact, rowmatch.chain_passes(count, best, fraction))
    assert exact.any() and not exact.all()


class _HostRead(AssertionError):
    pass


@pytest.fixture
def no_host_reads(monkeypatch):
    """While a step that match_scan captures on a card runs, a tensor's
    .item(), .tolist(), bool(), int(), float() or .numpy() raises."""
    real = step_graphs.StepGraphs.run

    def guarded(self, key, fn, *inputs):
        def refuse(*_, **__):
            raise _HostRead(f"a host read inside the {key[0]} step")

        with monkeypatch.context() as m:
            for name in ("item", "tolist", "__bool__", "__int__", "__float__", "numpy"):
                m.setattr(torch.Tensor, name, refuse)
            return real(self, key, fn, *inputs)

    monkeypatch.setattr(step_graphs.StepGraphs, "run", guarded)


@pytest.mark.parametrize("ks,C", [((31,), 3), ((21, 31), 2), ((21, 31), 64)])
def test_captured_steps_read_nothing_to_the_host(problem, no_host_reads, ks, C):
    indexes, codes, lengths, _ = problem
    for per_k in (True, False):
        cfg = QuantConfig(kmer_lengths=ks, batch_size=B, candidate_capacity=C, match_per_k_tables=per_k)
        tid, _, _, _ = match_scan(indexes[ks][1], torch.from_numpy(codes), lengths, cfg)
        assert tid.shape == (61, C)


def test_expand_launches_are_counted():
    """E's wrapper count is one of the counters a graph replay advances."""
    from sketch_rna_tpu_torch.utils import profiling

    assert profiling.counters()["E"] == (row_expand, "launches")
    assert profiling.read_launches()["E"] == row_expand.launches


def test_expand_width_keeps_every_event():
    assert [rowmatch.expand_width(m) for m in (0, 1, 2, 3, 200, MAX_WIDTH, MAX_WIDTH + 1)] == [
        MIN_WIDTH, MIN_WIDTH, 2, 4, 256, MAX_WIDTH, 2 * MAX_WIDTH]


@pytest.mark.parametrize("lengths,W,want", [
    ([[0, 0, 0, 0, 0, 3, 0, 0]], 4, 8 * 8 + 32 + 4 * 4 + 4 * 3),  # one run: one sector of starts
    ([[1, 0, 0, 0, 1, 0, 0, 0]], 4, 8 * 8 + 2 * 32 + 4 * 4 + 4 * 2),  # two runs in two sectors
    ([[1, 1, 1, 1, 0, 0, 0, 0]], 4, 8 * 8 + 32 + 4 * 4 + 4 * 4),  # four runs in one sector
    ([[4, 2, 0, 0, 0, 0, 0, 0]], 4, 8 * 8 + 32 + 4 * 4 + 4 * 4),  # the run past W needs no start
    ([[0] * 8, [0] * 8], 2, 8 * 16 + 4 * 4),  # no event: the lengths and the written rows
])
def test_expand_bound_counts_the_starts_it_needs(lengths, W, want):
    """E's bound (roofline.expand_work) reads every run's length, a run's
    start only in the 32-byte sectors of runs that hold an output lane,
    and each valid lane's posting once."""
    from sketch_rna_tpu_torch.utils.roofline import expand_work

    length = torch.tensor(lengths, dtype=torch.int64)
    B, S = length.shape
    assert expand_work(length, W) == (want, B * S + B * W)


@pytest.mark.parametrize("widths,per_k,device,want", [
    ((128,), True, "cuda", True),
    ((256, 128), True, "cuda", True),
    ((1024,), False, "cuda", True),  # one k: the K > 1 mode does not matter
    ((2, 1024, 4), True, "cuda:0", True),
    ((2048,), True, "cuda", False),  # past the widest row a warp sorts
    ((256, 2048), True, "cuda", False),
    ((256, 256), False, "cuda", False),  # the merged K-wide rows
    ((128,), True, "cpu", False),  # the plain chain is the CPU's
    ((64,) * 16, True, "cuda", True),
    ((64,) * 17, True, "cuda", False),  # past the kernel's ks
], ids=["k31", "k21_31", "one_k_merged", "three_ks", "wide", "one_wide_k", "merged", "cpu", "16_ks", "17_ks"])
def test_group_kernel_engagement_rule(widths, per_k, device, want):
    """Which batches G groups: a pure function of the rows' widths, the
    number of ks, the K > 1 mode and the device."""
    assert group.group_kernel_takes(widths, per_k, torch.device(device)) is want
    assert group.group_kernel_takes(list(widths), per_k, device) is want


@pytest.mark.parametrize("K,per_k", [(1, True), (2, True), (3, True), (2, False)],
                         ids=["one_k", "two_ks", "three_ks", "merged"])
def test_group_event_parts_hands_the_kernel_its_tables(monkeypatch, K, per_k):
    """With the rule taken as on a card, group_event_parts hands G the rows,
    each k's table size (C at one k, min(2C, W_k) at several) and the chain
    test (p, q, fraction), and returns its tables and stats as the plain
    chain's; merged rows and another sort take the plain chain."""
    rng = np.random.default_rng(K)
    parts = [torch.from_numpy(np.where(rng.random((6, W)) < 0.8, rng.integers(0, 40, (6, W)), I32_MAX).astype(
        np.int32)) for W in (8, 64, 256)[:K]]
    kw = dict(chain_fraction=0.9, candidate_capacity=16, num_transcripts=40)
    handed = []

    def kernel(rows, caps, C, chain):
        handed.append(([r.shape[1] for r in rows], list(caps), C, chain))
        res = rowmatch.group_event_parts_plain(list(rows), chain_fraction=chain[2], candidate_capacity=C,
                                               num_transcripts=40)
        return res.tid, res.score, res.mask, torch.stack([res.stats["candidate_spilled"],
                                                          res.stats["candidate_spilled_per_k"]])

    real = group.group_kernel_takes
    monkeypatch.setattr(rowmatch, "group_kernel_takes", lambda widths, per_k, device: real(widths, per_k, "cuda"))
    monkeypatch.setattr(rowmatch, "group_rows", kernel)
    got = rowmatch.group_event_parts(parts, per_k_tables=per_k, **kw)
    want = rowmatch.group_event_parts_plain(parts, per_k_tables=per_k, **kw)
    assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask"))
    assert {k: int(v) for k, v in got.stats.items()} == {k: int(v) for k, v in want.stats.items()}
    widths = [p.shape[1] for p in parts]
    caps = [16] if K == 1 else [min(32, W) for W in widths]
    assert handed == ([(widths, caps, 16, (9, 10, 0.9))] if per_k or K == 1 else [])
    rowmatch.group_event_parts(parts, per_k_tables=per_k, sort=row_sort_plain, **kw)
    assert len(handed) == (1 if per_k or K == 1 else 0)


@pytest.mark.parametrize("ks,per_k", [((31,), True), ((21, 31), True), ((21, 31), False)],
                         ids=["k31", "k21_31", "k21_31_merged"])
def test_group_kernel_batches_are_counted_a_batch(problem, monkeypatch, ks, per_k):
    """match.group_kernel_batches reads 0 in a CPU quant (declared); with
    the rule taken as on a card, it counts every batch G would group whole,
    once, in match_scan and in the per-batch route alike, and none at the
    merged K-wide rows."""
    indexes, codes, lengths, _ = problem
    index = indexes[ks][1]
    cfg = QuantConfig(kmer_lengths=ks, batch_size=B, match_per_k_tables=per_k)
    with PhaseTimer().opened() as timer:
        match_scan(index, torch.from_numpy(codes), lengths, cfg)
    assert timer.counts["match.group_kernel_batches"] == 0
    real = group.group_kernel_takes
    monkeypatch.setattr(pipeline, "group_kernel_takes", lambda widths, per_k, device: real(widths, per_k, "cuda"))
    batches = sum(-(-n // B) for n in _group_sizes(lengths))
    want = batches if per_k or len(ks) == 1 else 0
    for step in (None, sketch_match_step):
        with PhaseTimer().opened() as timer:
            match_rows(index, torch.from_numpy(codes), lengths, cfg, step=step)
        assert timer.counts.get("match.group_kernel_batches", 0) == want
