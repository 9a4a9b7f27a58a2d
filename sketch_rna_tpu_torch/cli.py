"""Command-line interface: the reference binary's index / quant modes
(src/main.cpp:212-276), on one CUDA device, on several (one rank process
each), or on the CPU when asked.

  -o/--mode {index,quant}   default quant
  -k/--kmer-length LIST     comma-separated ks, default 31 (src/main.cpp:215)
  --device {cuda,cpu}       default cuda; without a CUDA device the CLI
                            exits nonzero unless given --device cpu
  index mode:  <reference.fasta> <index_output>   (--index-format npz|refbin)
  quant mode:  <index_file> <reads.fastq>[,<reads2.fastq>...] <output.csv>

As in the reference (quirk Q1), quant uses the ks stored in the index.
Quant reads either package's `.npz` index or the reference binary's own
layout.  The reference constants are flags with the reference defaults.

Quant routes, as the JAX CLI takes them (the route and the read feed are
printed on stderr):
  - a comma list of FASTQs: one CSV per sample, <stem>.<sample>.csv;
  - with the native parser (native/fastio.cpp, built on first use) and a
    file of at least SKETCH_TPU_STREAM_MIN_BYTES (default 2 GiB): the
    streamed engine over a scan that runs in the background
    (feed native-lazy);
  - with the native parser: one scan; past FUSED_MAX_PADDED_READS reads
    the streamed engine over 2-bit chunks packed one ahead of the device
    (feed native-scan), else one whole-file pack;
  - without it (--no-native, or a failed build): the Python parser packs
    the whole file (feed python).
  A whole-file pack runs the fused engine, or the streamed one past
  FUSED_MAX_PADDED_READS padded reads.  A streamed run over an iterator
  feed whose wide class block spilled is re-scanned and rerun with the
  recovery config (stream.stream_retry_config).
  - --sharded, or several rank processes: the sharded engine over a
    (data, index) mesh (pipeline.quantify_sharded), for one sample or a
    comma list.  One process alone runs it at mesh (1, 1) over the whole
    file.  N rank processes start with --coordinator HOST:PORT
    --num-processes N --process-id R each (or under torchrun, from RANK /
    WORLD_SIZE / MASTER_ADDR / MASTER_PORT); each parses its data shard's
    byte range of the uncompressed FASTQ with the Python parser (feed
    byte-range), rank 0 alone prints the phase lines and writes the CSV.
    The route line names the mesh and the backend, e.g.
    `quant route: sharded (dp=2, ip=2, nccl), feed: byte-range`.
Phase lines mirror src/main.cpp:176-196.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from sketch_rna_tpu_torch import __version__
from sketch_rna_tpu_torch.config import QuantConfig

log = logging.getLogger(__name__)

# Files at least this big stream from a background scan (the JAX CLI's
# variable, with its meaning and default).
STREAM_MIN_BYTES_ENV = "SKETCH_TPU_STREAM_MIN_BYTES"


# JAX-CLI flags that select TPU machinery the port leaves out (flag -> why).
_IGNORED_FLAGS = {
    "--expand-per-read": "event rows are sized exactly per batch, there is no expansion budget",
}


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
        "  sketch-rna-tpu-torch -o quant --tpm idx s1.fq.gz,s2.fq.gz out.csv   (multi-sample)\n"
        "  sketch-rna-tpu-torch -o quant --device cpu ref.skidx.npz reads.fastq out.csv",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    d = QuantConfig
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument("-o", "--mode", choices=["index", "quant"], default="quant")
    p.add_argument("-k", "--kmer-length", type=_kmer_list, default=(31,), metavar="K[,K...]")
    p.add_argument(
        "positional",
        nargs="*",
        help="index: <ref.fasta> <index_out> | quant: <index> <reads.fastq>[,<reads2.fastq>...] <out.csv>",
    )
    # Reference constants as flags (reference defaults).
    p.add_argument("--sketch-fraction", type=float, default=d.sketch_fraction)
    p.add_argument("--chain-fraction", type=float, default=d.chain_fraction)
    p.add_argument("--em-max-iterations", type=int, default=d.em_max_iterations)
    p.add_argument("--em-convergence", type=float, default=d.em_convergence)
    p.add_argument("--pseudocount", type=float, default=d.pseudocount)
    # Capacity knobs.
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--max-read-len", type=int, default=d.max_read_len,
                   help="minimum padded read length (the pad grows to the longest read)")
    p.add_argument("--candidate-capacity", type=int, default=d.candidate_capacity)
    p.add_argument(
        "--em-dtype",
        choices=["float32", "float64"],
        default="float64",
        help="EM accumulation type (default float64, the reference's C++ double: the sample CSV comes out "
        "byte-identical; float32 lands within ~1e-5 relative)",
    )
    p.add_argument(
        "--merged-k-grouping",
        action="store_true",
        help="multi-k: group every batch as one merged K-wide event row instead of "
        "intersecting per-k tables (quant falls back to it per batch on a per-k spill)",
    )
    p.add_argument("--em-mxu", choices=["auto", "on", "off"], default=d.em_mxu,
                   help="the JAX package's one-hot E-step, which the port does not have: 'on' takes the scatter "
                   "route (said on stderr) and, as in the JAX package, turns --em-segsum off")
    p.add_argument("--em-segsum", choices=["auto", "on", "off"], default=d.em_segsum,
                   help="sum the EM's posteriors by a segmented sum over transcript-sorted lanes (kernel S), "
                   "bit-identical run to run, instead of index_add_ (auto: S on a card, index_add_ on the CPU)")
    p.add_argument("--no-native", action="store_true", help="disable the native (C++) FASTQ parser")
    p.add_argument("--tpm", action="store_true",
                   help="append a TPM column (length-normalized; the reference promises TPM but never "
                   "computes it)")
    p.add_argument("--index-format", choices=["npz", "refbin"], default="npz",
                   help="index mode output format: npz artifact (default) or the reference binary layout "
                   "(interoperable with the C++ tool)")
    p.add_argument("--em-checkpoint", default=None, metavar="PATH",
                   help="checkpoint the EM state to PATH periodically and resume from it if present")
    p.add_argument("--stream-chunk-reads", type=int, default=None,
                   help=f"reads per super-chunk of the streamed engine (default {d.stream_chunk_reads}); the "
                   "host packs the next chunk while the GPU matches this one")
    p.add_argument("--stream-class-capacity", type=int, default=None,
                   help=f"rows of the streamed engine's class buffer (default {d.stream_class_capacity}); it "
                   "bounds the DISTINCT candidate profiles held on the GPU at once")
    p.add_argument("--no-stream-drain", action="store_true",
                   help="do not drain a full class buffer to the host: classes past it are then dropped, "
                   "counted in the class_overflow stat, never silent")
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where to run (default cuda; the CPU runs every kernel's plain version)",
    )
    p.add_argument("--sharded", action="store_true",
                   help="run quant through the sharded engine: reads split over the data axis of a mesh of rank "
                   "processes, the index hash-range sharded over its index axis (implied by several processes)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address of a multi-process run: rank 0 listens there, the others connect")
    p.add_argument("--num-processes", type=int, default=None, help="rank processes of a multi-process run")
    p.add_argument("--process-id", type=int, default=None, help="this process's rank, 0 .. num-processes - 1")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="collectives backend (default: nccl when every rank has a GPU of its own, else gloo)")
    # Flags of the JAX CLI whose machinery the port does not need: accepted, so
    # that one command line serves both, and ignored with a note on stderr.
    for flag, why in _IGNORED_FLAGS.items():
        p.add_argument(flag, default=None, help=f"accepted and ignored: {why}")
    return p


def _config_from_args(args) -> QuantConfig:
    knobs = {}
    if args.stream_chunk_reads:
        knobs["stream_chunk_reads"] = args.stream_chunk_reads
    if args.stream_class_capacity:
        knobs["stream_class_capacity"] = args.stream_class_capacity
    return QuantConfig(
        kmer_lengths=args.kmer_length,
        sketch_fraction=args.sketch_fraction,
        chain_fraction=args.chain_fraction,
        em_max_iterations=args.em_max_iterations,
        em_convergence=args.em_convergence,
        pseudocount=args.pseudocount,
        batch_size=args.batch_size,
        max_read_len=args.max_read_len,
        candidate_capacity=args.candidate_capacity,
        em_dtype=args.em_dtype,
        em_mxu=args.em_mxu,
        em_segsum=args.em_segsum,
        match_per_k_tables=not args.merged_k_grouping,
        stream_drain=not args.no_stream_drain,
        em_checkpoint=args.em_checkpoint,
        **knobs,
    )


def run_index(ref_fasta: str, index_out: str, config: QuantConfig, device, index_format: str = "npz") -> None:
    from sketch_rna_tpu_torch.index.artifact import save_index
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.fasta import load_fasta

    t0 = time.perf_counter()
    records = load_fasta(ref_fasta)
    idx = build_index(records, config, device)
    print(f"Index built in {time.perf_counter() - t0} seconds.")
    if index_format == "refbin":
        from sketch_rna_tpu_torch.index.refbin import write_refbin_index

        write_refbin_index(index_out, idx, records.seqs)
    else:
        save_index(index_out, idx)
    print(f"Index saved to {index_out}")


def _pad_len(longest: int, config: QuantConfig) -> int:
    """Whole-file pad width: the longest kept read rounded to 128, so no
    valid read is dropped."""
    return max(config.max_read_len, ((longest + 127) // 128) * 128)


def _load_reads(reads_path: str, k: int, config: QuantConfig, use_native: bool):
    """Parse + validate + pack one whole FASTQ (the native parser when it
    builds); returns (packed, feed name)."""
    from sketch_rna_tpu_torch.io import native

    if use_native and native.native_available():
        packed, stats = native.pack_fastq_native(reads_path, min_len=k)
        pad_len = _pad_len(stats["max_len"], config)
        if packed.padded_len < pad_len:
            grown = np.zeros((packed.num_reads, pad_len), np.uint8)
            grown[:, : packed.padded_len] = packed.codes
            packed.codes = grown
        return packed, "native-scan"
    from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
    from sketch_rna_tpu_torch.io.packing import pack_reads

    reads = load_fastq_dict(reads_path, min_len=k)
    pad_len = _pad_len(max((len(s) for s in reads.values()), default=0), config)
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=k, pad_len=pad_len)
    return packed, "python"


def _load_reads_slice(reads_path: str, k: int, config: QuantConfig, mesh):
    """Parse + pack this rank's part of one FASTQ: the byte range of its
    data shard (dist/multihost.py), with the Python parser."""
    from sketch_rna_tpu_torch.dist.multihost import data_shard_range
    from sketch_rna_tpu_torch.io.fastq import load_fastq_dict_range
    from sketch_rna_tpu_torch.io.packing import pack_reads

    if reads_path.endswith(".gz"):
        raise ValueError(f"{reads_path}: a multi-process run splits the FASTQ by byte ranges and needs it "
                         "uncompressed")
    reads = load_fastq_dict_range(reads_path, *data_shard_range(reads_path, mesh), min_len=k)
    pad_len = _pad_len(max((len(s) for s in reads.values()), default=0), config)
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=k, pad_len=pad_len)
    return packed


def _report_route(route: str, feed: str, config: QuantConfig, device) -> None:
    """The route line on stderr; its EM route is em_route's for tables on
    `device` (segsum on a card unless --em-segsum off or --em-mxu on)."""
    from sketch_rna_tpu_torch.em.em import em_route_name

    if config.em_mxu == "on":
        print("--em-mxu on: the port has no one-hot E-step; the EM takes the scatter route", file=sys.stderr)
    em = em_route_name(config.em_mxu, config.em_segsum, torch.device(device).type)
    print(f"quant route: {route}, feed: {feed}, em: {em}", file=sys.stderr)


def _quant_one(artifact, device, reads_path: str, config: QuantConfig, use_native: bool):
    """One FASTQ through the routes the module docstring lists; returns
    the QuantResult.  A background scan starts before the index upload,
    so the two overlap."""
    from sketch_rna_tpu_torch import pipeline
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.stream import quantify_streamed, stream_retry_config

    max_k = max(artifact.kmer_lengths)
    native_ok = use_native and native.native_available()
    lazy = native_ok and os.path.getsize(reads_path) >= int(os.environ.get(STREAM_MIN_BYTES_ENV, 2 << 30))
    if lazy:
        scan = feed = native.LazyScanFeed(reads_path, max_k, config.stream_chunk_reads,
                                          row_multiple=config.batch_size)
    index = to_device(artifact, device)
    print("Loading index completed")
    if lazy:
        feed_name = "native-lazy"
    elif native_ok:
        scan, feed, feed_name = native.NativeFastqScan(reads_path, max_k), None, "native-scan"
        if scan.num_reads > pipeline.FUSED_MAX_PADDED_READS:
            # Streamed chunks pad to the longest read rounded to 8 and
            # ship 2-bit codes: a quarter of the upload bytes.
            pad_len = max(((scan.max_len + 7) // 8) * 8, max_k)
            feed = native.chunks_from_scan2(scan, config.stream_chunk_reads, pad_len,
                                            row_multiple=config.batch_size)
        else:
            with scan:
                packed = scan.pack_range(0, scan.num_reads, _pad_len(scan.max_len, config))
    else:
        feed = None
        packed, feed_name = _load_reads(reads_path, max_k, config, False)
    print("Loading read completed")
    if feed is None:
        _report_route("streamed" if pipeline.streams(packed.num_reads, config) else "fused", feed_name, config,
                      device)
        return pipeline.quantify(index, packed, config)

    _report_route("streamed", feed_name, config, device)
    try:
        # A lazy feed's read count would join its scan here; the engine
        # reads it from the feed once the first chunk is due.
        result = quantify_streamed(index, feed, config, num_reads_hint=None if lazy else scan.num_reads)
    finally:
        # Idempotent.  The feed's generator closes the scan once it has
        # run; this covers an error before its first step (a lazy feed
        # hands its scan over only then, io/native.LazyScanFeed).
        scan.close()
    # An iterator feed cannot replay inside quantify_streamed: re-scan and
    # rerun with the recovery config until the loss stats clear (each
    # recovery moves the config toward a bound, so the loop ends).
    while True:
        retry_cfg, reason = stream_retry_config(config, result.stats)
        if retry_cfg is None:
            return result
        log.warning("streaming %s; re-scanning and rerunning", reason)
        config = retry_cfg
        with native.NativeFastqScan(reads_path, max_k) as rescan:
            pad_len = max(((rescan.max_len + 7) // 8) * 8, max_k)
            chunks = native.chunks_from_scan2(rescan, config.stream_chunk_reads, pad_len,
                                              row_multiple=config.batch_size, close=False)
            result = quantify_streamed(index, chunks, config, num_reads_hint=rescan.num_reads)


def _write_outputs(results, output_path: str, with_tpm: bool, one_sample: bool) -> None:
    """The CSV of one sample at output_path with the reference's phase
    lines, or <stem>.<sample>.csv for each of several."""
    from sketch_rna_tpu_torch.pipeline import write_csv

    if one_sample:
        (result,) = results.values()
        print("Sparse chaining completed")
        print("EM estimation completed")
        print("Read assignment completed")
        write_csv(output_path, result, with_tpm=with_tpm)
        print(f"Output written to {output_path}")
        return
    stem, ext = os.path.splitext(output_path)
    for name, result in results.items():
        out = f"{stem}.{name}{ext or '.csv'}"
        write_csv(out, result, with_tpm=with_tpm)
        print(f"Output written to {out}")


def run_quant_sharded(
    index_path: str,
    reads_path: str,
    output_path: str,
    config: QuantConfig,
    device: torch.device,
    use_native: bool = True,
    with_tpm: bool = False,
) -> None:
    """Quant through the sharded engine, by every rank of the process
    group together (or one process alone, at mesh (1, 1))."""
    from sketch_rna_tpu_torch.dist.mesh import index_device_bytes, make_mesh, mesh_factor, world
    from sketch_rna_tpu_torch.index.refbin import load_any_index
    from sketch_rna_tpu_torch.index.shard import shard_to_device
    from sketch_rna_tpu_torch.pipeline import quantify_samples

    artifact = load_any_index(index_path)
    config = dataclasses.replace(config, kmer_lengths=tuple(artifact.kmer_lengths))
    max_k = max(artifact.kmer_lengths)
    mesh = make_mesh(*mesh_factor(world()[1], index_bytes=index_device_bytes(artifact)), device=device)
    primary, multi = mesh.rank == 0, mesh.world_size > 1

    def say(line: str) -> None:
        if primary:
            print(line)

    shard = shard_to_device(artifact, mesh.ip, mesh.i, device)
    say("Loading index completed")
    fqs = reads_path.split(",")
    for fq in fqs:
        if not os.path.exists(fq):
            raise FileNotFoundError(f"Could not open FASTQ file: {fq}")

    def load(fq):
        if multi:
            packed, feed = _load_reads_slice(fq, max_k, config, mesh), "byte-range"
        else:
            packed, feed = _load_reads(fq, max_k, config, use_native)
        if primary:
            _report_route(f"sharded ({mesh.describe()})", feed, config, mesh.device)
        return packed

    # Each sample is parsed and packed only at its turn.
    samples = {os.path.splitext(os.path.basename(fq))[0]: (lambda fq=fq: load(fq)) for fq in fqs}
    say("Loading read completed")
    results = quantify_samples(shard, samples, config, sharded=True, mesh=mesh, local_slice=multi)
    if primary:
        _write_outputs(results, output_path, with_tpm, one_sample=len(fqs) == 1)


def run_quant(
    index_path: str,
    reads_path: str,
    output_path: str,
    config: QuantConfig,
    device,
    use_native: bool = True,
    with_tpm: bool = False,
) -> None:
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.refbin import load_any_index
    from sketch_rna_tpu_torch.pipeline import quantify_samples, streams

    artifact = load_any_index(index_path)
    config = dataclasses.replace(config, kmer_lengths=tuple(artifact.kmer_lengths))
    if "," not in reads_path:
        result = _quant_one(artifact, device, reads_path, config, use_native)
        _write_outputs({"": result}, output_path, with_tpm, one_sample=True)
        return

    # Several samples: each is parsed and packed only at its turn, so host
    # memory holds one sample's reads at a time.
    idx = to_device(artifact, device)
    print("Loading index completed")
    samples = {}
    for fq in reads_path.split(","):
        if not os.path.exists(fq):
            raise FileNotFoundError(f"Could not open FASTQ file: {fq}")

        def load(fq=fq):
            packed, feed = _load_reads(fq, max(idx.kmer_lengths), config, use_native)
            _report_route("streamed" if streams(packed.num_reads, config) else "fused", feed, config, device)
            return packed

        samples[os.path.splitext(os.path.basename(fq))[0]] = load
    print("Loading read completed")
    _write_outputs(quantify_samples(idx, samples, config), output_path, with_tpm, one_sample=False)


def main(argv: Optional[List[str]] = None) -> int:
    from sketch_rna_tpu_torch.dist.init import init_distributed, rank_device, shutdown

    args = build_parser().parse_args(argv)
    for flag in _IGNORED_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            print(f"sketch-rna-tpu-torch: {flag} is accepted and ignored: {_IGNORED_FLAGS[flag]}", file=sys.stderr)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sketch-rna-tpu-torch: no CUDA device found; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    config = _config_from_args(args)
    if args.mode == "index":
        if len(args.positional) < 2:
            print("Usage: sketch-rna-tpu-torch -o index <reference.fasta> <index_output>", file=sys.stderr)
            return 1
        run_index(args.positional[0], args.positional[1], config, torch.device(args.device), args.index_format)
        return 0
    if len(args.positional) < 3:
        print("Usage: sketch-rna-tpu-torch -o quant <index_file> <reads.fastq> <output.csv>", file=sys.stderr)
        return 1
    multi = args.coordinator is not None or int(os.environ.get("WORLD_SIZE", 1)) > 1
    if args.em_checkpoint and (args.sharded or multi):
        print("sketch-rna-tpu-torch: --em-checkpoint is not supported with --sharded or several processes "
              "(the ranks would race for one file); run the EM checkpoint on one device", file=sys.stderr)
        return 2
    # A failed rendezvous raises: a rank must not carry on alone.
    joined = init_distributed(args.coordinator, args.num_processes, args.process_id, device_type=args.device,
                              backend=args.dist_backend)
    try:
        if args.sharded or joined:
            run_quant_sharded(args.positional[0], args.positional[1], args.positional[2], config,
                              rank_device(args.device), use_native=not args.no_native, with_tpm=args.tpm)
        else:
            run_quant(args.positional[0], args.positional[1], args.positional[2], config, torch.device(args.device),
                      use_native=not args.no_native, with_tpm=args.tpm)
    finally:
        if joined:
            shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
