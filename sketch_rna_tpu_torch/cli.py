"""Command-line interface: the reference binary's index / quant modes
(src/main.cpp:212-276), on one CUDA device when there is one, else the CPU.

  -o/--mode {index,quant}   default quant
  -k/--kmer-length K        one k, default 31 (multi-k: ROADMAP)
  index mode:  <reference.fasta> <index_output>
  quant mode:  <index_file> <reads.fastq> <output.csv>

As in the reference (quirk Q1), quant uses the k stored in the index.
The index file is the JAX package's `.npz` format; either package's
index works with either package's quant.  Phase lines mirror
src/main.cpp:176-196.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import torch

from sketch_rna_tpu_torch.config import QuantConfig


def _one_k(s: str) -> int:
    ks = [tok.strip() for tok in s.split(",") if tok.strip()]
    if len(ks) != 1:
        raise argparse.ArgumentTypeError("the PyTorch port takes one k (multi-k: ROADMAP Queue 1 item 8)")
    return int(ks[0])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sketch-rna-tpu-torch",
        description="Alignment-free RNA-seq isoform quantification on one GPU "
        "(index/quant modes mirror the reference tool).",
        epilog="Examples:\n"
        "  sketch-rna-tpu-torch -o index -k 31 ref.fasta ref.skidx.npz\n"
        "  sketch-rna-tpu-torch -o quant ref.skidx.npz reads.fastq out.csv",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-o", "--mode", choices=["index", "quant"], default="quant")
    p.add_argument("-k", "--kmer-length", type=_one_k, default=31, metavar="K")
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
    return p


def _device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
    device = _device()
    config = QuantConfig(
        kmer_lengths=(args.kmer_length,),
        batch_size=args.batch_size,
        em_dtype=args.em_dtype or ("float64" if device.type == "cpu" else "float32"),
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
