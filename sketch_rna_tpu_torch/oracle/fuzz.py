"""Randomized oracle fuzz of the PyTorch port: random problem shapes and
engine knobs against the reference math in NumPy (reference_oracle.py,
the C++ tool's math line by line).

Each trial draws, from its seed, a transcriptome of isoform families, a
k set, reads with sequencing errors and the knobs that the JAX package's
scripts/fuzz_oracle.py draws (sketch and chain fraction, EM iterations,
batch, pad length, class buffer and chunk size; its tier switch is drawn
and unused, since the port's event widths are exact), with the same
generators in the same order, then the port's own: the engine (fused;
streamed, whose buffers may be tiny enough to compact in the scan;
sharded at mesh (1, 1) in this process) and the EM route (--em-segsum).
A regime fixes a few knobs so that a schedule of trials reaches every
kernel on the card; every other knob comes from the seed:

  fused-1k    fused, one k                   K1, K4, P
  fused-mk    fused, 2 or 3 ks               K2, K4-int64
  streamed    a 16-row class buffer, 64-read chunks
  sharded     mesh (1, 1), 2 or 3 ks         the merge
  long        1,100-2,048 bp reads           K3, the K4-int64 dedup
  segsum      --em-segsum on                 S
  nine-ks     nine ks                        K2 for eight, K1 for one
  very-long   2-4 reads of ~20,000 bp at sketch fraction 0.9: more than
              16,384 kept hashes a row      row_sort_wide's merge round
                                             (the partition launch)

A trial holds the port to the oracle: collect_pairs' candidates of every
read equal oracle_sparse_chain's (its top C by score desc, tid asc),
exactly; pi and NumReads within 5e-9 relative / 1e-12 absolute (the JAX
script's bar: float64 sums in another order); the CSV row set, exactly.
A trial whose sketch_overflow or candidate_spilled is above 0 (a bounded
capacity the oracle does not have) is reported with its stats and not
compared; expand_dropped above 0 fails it, since the port's event widths
are exact.

scripts/fuzz_oracle_torch.py runs a schedule of trials (trial i in
regime i mod 8) and chip_smoke.py's fuzz phase runs one on the card;
one_trial(seed, device) alone takes regime seed mod 8, the same for the
default base 777000, a multiple of 8.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.dist.mesh import make_mesh
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.oracle.reference_oracle import oracle_quant
from sketch_rna_tpu_torch.pipeline import collect_pairs, quantify, quantify_sharded
from sketch_rna_tpu_torch.stream import quantify_streamed

K_SETS = [(31,), (21,), (21, 31), (15, 25, 33), (17,)]
SINGLE_KS = [(31,), (21,), (17,)]
MULTI_KS = [(21, 31), (15, 25, 33)]
NINE_KS = (11, 13, 15, 17, 19, 21, 23, 25, 27)
REGIMES = ("fused-1k", "fused-mk", "streamed", "sharded", "long", "segsum", "nine-ks", "very-long")
LOSS = ("sketch_overflow", "expand_dropped", "candidate_spilled")
PI_RTOL, ATOL = 5e-9, 1e-12


def make_transcriptome(rng: np.random.Generator, n: int, len_range: Tuple[int, int],
                       family_size: int = 3) -> List[np.ndarray]:
    """Families of isoforms sharing long exact stretches (the generator of
    the JAX package's tests, same numbers for the same Generator state)."""
    out: List[np.ndarray] = []
    while len(out) < n:
        base_len = int(rng.integers(*len_range))
        base = rng.integers(0, 4, size=base_len).astype(np.uint8)
        fam = min(family_size, n - len(out))
        out.append(base.copy())
        for _ in range(fam - 1):
            a = int(rng.integers(0, max(base_len // 3, 1)))
            b = int(rng.integers(a, base_len))
            iso = np.concatenate([base[:a], base[b:], rng.integers(0, 4, size=30).astype(np.uint8)])
            if iso.size >= len_range[0] // 2:
                out.append(iso.astype(np.uint8))
    return out[:n]


def sample_reads(rng: np.random.Generator, transcripts: List[np.ndarray], n_reads: int, read_len: int,
                 error_rate: float = 0.005) -> List[np.ndarray]:
    """Reads from uniform transcripts and starts, with substitutions (the
    generator of the JAX package's tests)."""
    reads = []
    for _ in range(n_reads):
        t = transcripts[int(rng.integers(0, len(transcripts)))]
        if t.size <= read_len:
            seq = t.copy()
        else:
            start = int(rng.integers(0, t.size - read_len + 1))
            seq = t[start : start + read_len].copy()
        errs = rng.random(seq.size) < error_rate
        seq[errs] = (seq[errs] + rng.integers(1, 4, size=int(errs.sum()))) % 4
        reads.append(seq.astype(np.uint8))
    return reads


def draw(seed: int, regime: Optional[str] = None) -> dict:
    """A trial's problem and knobs.  The JAX script's draws come first, in
    its order; a regime overrides some of them (and fixes the shapes of
    the long-read regimes), then the port's own draws follow."""
    rng = np.random.default_rng(seed)
    if regime is None:
        regime = REGIMES[seed % len(REGIMES)]
    j = int(rng.integers(0, len(K_SETS)))
    ks = {"fused-1k": SINGLE_KS[j % len(SINGLE_KS)], "fused-mk": MULTI_KS[j % len(MULTI_KS)],
          "sharded": MULTI_KS[j % len(MULTI_KS)], "nine-ks": NINE_KS}.get(regime, K_SETS[j])
    n_t = int(rng.integers(4, 28))
    if regime == "long":
        seqs = make_transcriptome(rng, n=4 + n_t % 9, len_range=(2400, 4000))
    elif regime == "very-long":
        seqs = make_transcriptome(rng, n=3 + n_t % 4, len_range=(20000, 25000))
    else:
        seqs = make_transcriptome(rng, n=n_t, len_range=(40, 800))
    knobs = dict(
        kmer_lengths=ks,
        sketch_fraction=float(rng.choice([0.05, 0.05, 0.05, 0.1, 0.3, 0.02])),
        chain_fraction=float(rng.choice([0.9, 0.9, 0.75, 0.5, 0.833, 1.0])),
        em_max_iterations=int(rng.choice([20, 20, 5, 1, 40])),
        batch_size=int(rng.choice([32, 64, 128])),
        max_read_len=int(rng.choice([128, 256])),
        em_dtype="float64",
    )
    rng.random()  # the JAX script's match_tiers: the port has no tiers
    knobs["stream_class_capacity"] = int(rng.choice([16, 64, 1024]))
    knobs["stream_chunk_reads"] = int(rng.choice([64, 256, 1 << 20]))
    n_reads = int(rng.integers(16, 400))
    pool = seqs
    if regime == "long":
        knobs["max_read_len"] = {128: 1280, 256: 2048}[knobs["max_read_len"]]
        n_reads = 8 + n_reads // 8
        read_len = int(rng.integers(1100, knobs["max_read_len"] + 1))
    elif regime == "very-long":
        knobs["max_read_len"] = 20480
        knobs["sketch_fraction"] = 0.9
        n_reads = 2 + n_reads % 3
        read_len = int(rng.integers(19500, 20481))
        pool = [s for s in seqs if s.size >= 20000]
    else:
        read_len = int(rng.integers(max(ks), min(knobs["max_read_len"], 140)))
    reads = [r for r in sample_reads(rng, pool, n_reads=n_reads, read_len=read_len) if r.size >= max(ks)]
    force_stream = bool(rng.random() < 0.4)
    engine_draw, segsum_draw = rng.random(), rng.random()
    engine = "streamed" if force_stream else ("sharded" if engine_draw < 0.25 else "fused")
    engine = {"fused-1k": "fused", "fused-mk": "fused", "nine-ks": "fused", "streamed": "streamed",
              "sharded": "sharded"}.get(regime, engine)
    if regime == "streamed":
        knobs.update(stream_class_capacity=16, stream_chunk_reads=64)
    knobs["em_segsum"] = "on" if regime == "segsum" or segsum_draw < 0.3 else "off"
    return dict(seed=seed, regime=regime, engine=engine, seqs=seqs, reads=reads, knobs=knobs)


def describe(d: dict) -> dict:
    """The draw without its sequences: what a mismatch prints."""
    return dict(seed=d["seed"], regime=d["regime"], engine=d["engine"], transcripts=len(d["seqs"]),
                reads=len(d["reads"]), read_lengths=sorted({int(r.size) for r in d["reads"]})[-3:], **d["knobs"])


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))) if want.size else 0.0


def one_trial(seed: int, device: str, regime: Optional[str] = None) -> dict:
    """One seeded trial on `device` ("cuda" or "cpu") in `regime` (one of
    REGIMES; by default REGIMES[seed mod 8]): returns its summary
    ({"skipped": stats} when a capacity stat is above 0); raises
    AssertionError on a mismatch."""
    t0 = time.perf_counter()
    d = draw(seed, regime)
    info = describe(d)
    seqs, reads, cfg = d["seqs"], d["reads"], QuantConfig(**d["knobs"])
    if not reads:
        return dict(info, skipped={"no read": 1})
    pad = cfg.max_read_len
    codes = np.zeros((len(reads), pad), np.uint8)
    lengths = np.array([r.size for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
    packed = PackedReads(codes, lengths, [])
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    artifact = build_index(FastaRecords([f"T{i}" for i in range(len(seqs))], text, 0), cfg, device=device)
    index = to_device(artifact, device)
    pairs_read, pairs_tid, pairs_score, pair_stats = collect_pairs(index, packed, cfg)
    if d["engine"] == "fused":
        result = quantify(index, packed, cfg)
    elif d["engine"] == "streamed":
        result = quantify_streamed(index, packed, cfg)
    else:
        # mesh (1, 1) in this process, no process group
        result = quantify_sharded(artifact, packed, cfg, make_mesh(1, 1, device=device), device=device)
    stats = {k: max(int(result.stats.get(k, 0)), pair_stats[k]) for k in LOSS}
    assert stats["expand_dropped"] == 0, f"expand_dropped {stats}: the port's event widths are exact"
    if stats["sketch_overflow"] or stats["candidate_spilled"]:
        return dict(info, skipped=stats)
    card_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    segments, pi, weighted, csv_tids = oracle_quant(
        seqs, {i: r for i, r in enumerate(reads)}, cfg.kmer_lengths, sketch_fraction=cfg.sketch_fraction,
        chain_fraction=cfg.chain_fraction, em_max_iterations=cfg.em_max_iterations)
    oracle_s = time.perf_counter() - t0
    got: Dict[int, list] = {i: [] for i in range(len(reads))}
    for r, t, s in zip(pairs_read.tolist(), pairs_tid.tolist(), pairs_score.tolist()):
        got[r].append((t, s))
    C = cfg.candidate_capacity
    bad = [i for i in range(len(reads)) if got[i] != segments[i][:C]]
    assert not bad, (f"{len(bad)} reads' candidates differ from oracle_sparse_chain's; read {bad[0]}: "
                     f"{got[bad[0]]} against {segments[bad[0]]}")
    rows = [t for t in range(len(seqs)) if result.has_entry[t]]
    assert rows == csv_tids, f"CSV rows {rows} against the oracle's {csv_tids}"
    np.testing.assert_allclose(result.pi, pi, rtol=PI_RTOL, atol=ATOL)
    np.testing.assert_allclose(result.weighted_counts, weighted, rtol=PI_RTOL, atol=ATOL)
    return dict(info, pairs=int(pairs_read.size), pi_rel=_rel_err(result.pi, pi),
                numreads_rel=_rel_err(result.weighted_counts[rows], weighted[rows]),
                port_s=round(card_s, 3), oracle_s=round(oracle_s, 3))
