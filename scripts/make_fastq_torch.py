"""Write a large FASTQ from the scale-check transcriptome (the PyTorch
port's counterpart of scripts/make_fastq.py; imports no JAX).

A streamed file-to-CSV run (scripts/profile_stream_torch.py) needs a
real multi-gigabyte file, not reads held in memory.  Reads are drawn with
numpy (sketch_rna_tpu_torch/utils/synth.py sample_reads) a chunk at a
time, each chunk from seed 1000 + (reads written) % 997 as the JAX
script seeds its chunks, and framed into FASTQ records with vectorised
numpy (utils/synth.py fastq_records): "@r" + a 10-digit id, the read,
"+", a quality line of "I".  The draws are numpy's, not the JAX
script's jax.random ones, so the two scripts write other reads from the
same transcriptome; a read shorter than --read-len (from a transcript
that short) is written at its own length.

    python3 scripts/make_fastq_torch.py build/bench_torch/big32m.fq
    python3 scripts/make_fastq_torch.py out.fq --transcripts 250000 --reads 32000000 \\
        --read-len 150 --chunk 2000000

The transcriptome is scripts/scale_check_torch.py's (utils/synth.py
gencode_transcriptome: seed 2026), so the indexes that script caches
match these reads.  Runs on the CPU alone.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--transcripts", type=int, default=250000)
    ap.add_argument("--reads", type=int, default=32_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--chunk", type=int, default=2_000_000)
    args = ap.parse_args(argv)

    from sketch_rna_tpu_torch.utils.synth import gencode_transcriptome, sample_reads, write_fastq

    t0 = time.perf_counter()
    seqs = gencode_transcriptome(args.transcripts)
    print(f"transcriptome: {len(seqs)} seqs ({time.perf_counter() - t0:.1f}s)", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    written = size = 0
    t0 = time.perf_counter()
    while written < args.reads:
        n = min(args.chunk, args.reads - written)
        codes, lengths = sample_reads(seqs, n, args.read_len, args.read_len, seed=1000 + written % 997)
        size += write_fastq(args.out, codes, lengths, start_id=written, append=written > 0)
        written += n
        el = time.perf_counter() - t0
        print(f"  {written}/{args.reads} reads, {written / el / 1e6:.2f} M reads/s", flush=True)
    print(f"wrote {args.out}: {size / 1e9:.2f} GB in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
