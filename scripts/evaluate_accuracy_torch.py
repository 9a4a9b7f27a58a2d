"""Accuracy of the PyTorch port against simulated ground truth.

The port's counterpart of scripts/evaluate_accuracy.py, with the same
arguments, draws and output line: a synthetic transcriptome
(utils/synth.py), per-transcript read counts from a length-weighted
log-normal expression draw, error-free reads of --read-len bases sampled
from them, one quant (float32 EM, as there), and the Spearman and
Pearson correlation of NumReads against the true counts, the median
relative error and the share of reads assigned.  The metrics describe
the reference algorithm (count-weighted EM without length
normalization), which the port reproduces, not the port's arithmetic.

Usage: python3 scripts/evaluate_accuracy_torch.py [--transcripts N] [--reads N] [--read-len N] [--k 31]
                                                  [--seed 11] [--device cuda|cpu]

Runs on the card by default and exits nonzero without one; --device cpu
runs every kernel's plain PyTorch version.  Imports no JAX.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return pearson(ra, rb)


def pearson(a, b):
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / d) if d > 0 else float("nan")


def simulated_reads(rng, seqs, n_reads, read_len, pad_len):
    """(codes [R, pad_len] uint8, lengths [R] int32, true counts [T]): the
    JAX script's draws in its order, its on-device gather done in numpy."""
    T = len(seqs)
    lens = np.array([s.size for s in seqs], dtype=np.float64)
    expr = rng.lognormal(0, 1.5, size=T) * lens
    truth_counts = rng.multinomial(n_reads, expr / expr.sum()).astype(np.float64)
    tid_of_read = np.repeat(np.arange(T), truth_counts.astype(np.int64))
    rng.shuffle(tid_of_read)
    big = np.concatenate(seqs)
    lens_i = np.array([s.size for s in seqs], dtype=np.int32)
    offs = np.zeros(T, dtype=np.int32)
    np.cumsum(lens_i[:-1], out=offs[1:])
    tl = lens_i[tid_of_read]
    span = np.maximum(tl - read_len, 0)
    start = (rng.random(tid_of_read.size) * (span + 1)).astype(np.int32)
    eff = np.minimum(tl, read_len).astype(np.int32)
    pos = np.arange(read_len, dtype=np.int32)[None, :]
    codes = big[np.minimum((offs[tid_of_read] + start)[:, None] + pos, (offs[tid_of_read] + tl - 1)[:, None])]
    codes = np.where(pos < eff[:, None], codes, 0).astype(np.uint8)
    return np.pad(codes, ((0, 0), (0, pad_len - read_len))), eff, truth_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcripts", type=int, default=2000)
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--k", default="31")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("evaluate_accuracy_torch: no CUDA device (pass --device cpu to run the plain versions)",
              file=sys.stderr)
        return 2

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.fasta import FastaRecords
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.pipeline import quantify
    from sketch_rna_tpu_torch.utils.synth import synth_transcriptome

    ks = tuple(int(x) for x in args.k.split(","))
    rng = np.random.default_rng(args.seed)
    seqs = synth_transcriptome(rng, args.transcripts)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs = FastaRecords([f"T{i:06d}" for i in range(len(seqs))], [bases[s].tobytes().decode() for s in seqs], 0)
    cfg = QuantConfig(kmer_lengths=ks, max_read_len=((args.read_len + 127) // 128) * 128, em_dtype="float32")
    index = to_device(build_index(recs, cfg, device=args.device), args.device)
    codes, lengths, truth_counts = simulated_reads(rng, seqs, args.reads, args.read_len, cfg.max_read_len)
    packed = PackedReads(codes, lengths, [])

    result = quantify(index, packed, cfg)
    est = result.weighted_counts.astype(np.float64)

    keep = truth_counts + est > 0
    hit = truth_counts > 0
    print(
        f"transcripts={len(seqs)} reads={packed.num_reads} "
        f"spearman={spearman(truth_counts[keep], est[keep]):.4f} "
        f"pearson={pearson(truth_counts[keep], est[keep]):.4f} "
        f"median_rel_err={np.median(np.abs(est[hit] - truth_counts[hit]) / truth_counts[hit]):.4f} "
        f"assigned={est.sum():.0f}/{args.reads}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
