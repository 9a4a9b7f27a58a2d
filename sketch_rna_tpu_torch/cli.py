"""Command-line interface: the reference binary's index / quant modes
(src/main.cpp:212-276), on one CUDA device, or on the CPU when asked.

  -o/--mode {index,quant}   default quant
  -k/--kmer-length LIST     comma-separated ks, default 31 (src/main.cpp:215)
  --device {cuda,cpu}       default cuda; without a CUDA device the CLI
                            exits nonzero unless given --device cpu
  index mode:  <reference.fasta> <index_output>
  quant mode:  <index_file> <reads.fastq> <output.csv>

As in the reference (quirk Q1), quant uses the ks stored in the index.
The index file is the JAX package's `.npz` format; either package's
index works with either package's quant.  Phase lines mirror
src/main.cpp:176-196.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional, Tuple

import torch

from sketch_rna_tpu_torch.config import QuantConfig


def _kmer_list(s: str) -> Tuple[int, ...]:
    ks = tuple(int(tok) for tok in s.split(",") if tok.strip())
    if not ks:
        raise argparse.ArgumentTypeError("empty k-mer list")
    return ks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sketch-rna-tpu-torch",
        description="Alignment-free RNA-seq isoform quantification on one GPU "
        "(index/quant modes mirror the reference tool).",
        epilog="Examples:\n"
        "  sketch-rna-tpu-torch -o index -k 21,31 ref.fasta ref.skidx.npz\n"
        "  sketch-rna-tpu-torch -o quant ref.skidx.npz reads.fastq out.csv\n"
        "  sketch-rna-tpu-torch -o quant --device cpu ref.skidx.npz reads.fastq out.csv",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-o", "--mode", choices=["index", "quant"], default="quant")
    p.add_argument("-k", "--kmer-length", type=_kmer_list, default=(31,), metavar="K[,K...]")
    p.add_argument(
        "positional",
        nargs="*",
        help="index: <ref.fasta> <index_out> | quant: <index> <reads.fastq> <out.csv>",
    )
    p.add_argument("--batch-size", type=int, default=QuantConfig.batch_size)
    p.add_argument(
        "--em-dtype",
        choices=["float32", "float64"],
        default=None,
        help="EM accumulation type (default: float64 on the CPU, float32 on a GPU)",
    )
    p.add_argument(
        "--merged-k-grouping",
        action="store_true",
        help="multi-k: group every batch as one merged K-wide event row instead of "
        "intersecting per-k tables (quant falls back to it per batch on a per-k spill)",
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where to run (default cuda; the CPU runs every kernel's plain version)",
    )
    return p


def run_index(ref_fasta: str, index_out: str, config: QuantConfig, device) -> None:
    from sketch_rna_tpu_torch.index.artifact import save_index
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.fasta import load_fasta

    t0 = time.perf_counter()
    idx = build_index(load_fasta(ref_fasta), config, device)
    print(f"Index built in {time.perf_counter() - t0} seconds.")
    save_index(index_out, idx)
    print(f"Index saved to {index_out}")


def _load_reads(reads_path: str, k: int, config: QuantConfig):
    """Parse + validate + pack one FASTQ; the pad width grows to the
    longest kept read (rounded to 128), so no valid read is dropped."""
    from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
    from sketch_rna_tpu_torch.io.packing import pack_reads

    reads = load_fastq_dict(reads_path, min_len=k)
    longest = max((len(s) for s in reads.values()), default=0)
    pad_len = max(config.max_read_len, ((longest + 127) // 128) * 128)
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=k, pad_len=pad_len)
    return packed


def run_quant(index_path: str, reads_path: str, output_path: str, config: QuantConfig, device) -> None:
    from sketch_rna_tpu_torch.index.artifact import load_index, to_device
    from sketch_rna_tpu_torch.pipeline import quantify, write_csv

    idx = to_device(load_index(index_path), device)
    print("Loading index completed")
    config = dataclasses.replace(config, kmer_lengths=tuple(idx.kmer_lengths))
    packed = _load_reads(reads_path, max(idx.kmer_lengths), config)
    print("Loading read completed")
    result = quantify(idx, packed, config)
    print("Sparse chaining completed")
    print("EM estimation completed")
    print("Read assignment completed")
    write_csv(output_path, result)
    print(f"Output written to {output_path}")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sketch-rna-tpu-torch: no CUDA device found; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    config = QuantConfig(
        kmer_lengths=args.kmer_length,
        batch_size=args.batch_size,
        em_dtype=args.em_dtype or ("float64" if device.type == "cpu" else "float32"),
        match_per_k_tables=not args.merged_k_grouping,
    )
    if args.mode == "index":
        if len(args.positional) < 2:
            print("Usage: sketch-rna-tpu-torch -o index <reference.fasta> <index_output>", file=sys.stderr)
            return 1
        run_index(args.positional[0], args.positional[1], config, device)
    else:
        if len(args.positional) < 3:
            print("Usage: sketch-rna-tpu-torch -o quant <index_file> <reads.fastq> <output.csv>", file=sys.stderr)
            return 1
        run_quant(args.positional[0], args.positional[1], args.positional[2], config, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
