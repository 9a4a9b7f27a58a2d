"""The PyTorch port's streamed route from a FASTQ file to the result, with
its phases split (the counterpart of scripts/profile_stream.py and, with
--resident, scripts/profile_stream_compute.py; imports no JAX).

    python3 scripts/profile_stream_torch.py INDEX READS.fq [--csv OUT]
        [--chunk-reads N] [--class-capacity N] [--resident] [--device cuda|cpu]

It drives the CLI's big-file route: the FASTQ's record scan on a
background thread (io/native.LazyScanFeed) while the index uploads, then
stream.quantify_streamed over its 2-bit chunks, with the CLI's defaults
(the index's ks, float64 EM).  Besides the engine's phase seconds
(QuantResult.timing) it splits stream_match, chunk by chunk: the host
seconds of each chunk's upload (stream._upload: a pageable copy and the
2-bit unpack on the card, its clock read after a synchronize), of its
matching into classes
(stream.chunk_match_classes, which ends in a host read), and the rest
(waiting on the feed's scan and pack, class-buffer appends), with each
chunk's reads/s.

--resident also runs the same chunks already on the card: the feed is
packed (native.chunks_from_scan2, the CLI feed's width and row multiple)
and uploaded before the clock starts, and the engine unpacks them in
place, so neither the file nor the upload appears in stream_match.  The
two runs' rows must be equal and their pi and NumReads equal within
1e-12 relative, or the script exits 1 (with --csv the resident CSV is
written beside OUT as OUT.resident.csv).

Runs on the card unless --device cpu is passed, and exits 2 without one.
The last line is one JSON object, {"metric": "stream_file_to_result",
...}, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


@contextlib.contextmanager
def chunk_clock(chunks: list, resident: bool = False):
    """While in use, each chunk's upload and match seconds (and reads) go
    into `chunks`; with `resident` the engine's upload takes chunks whose
    2-bit codes already lie on the device and only unpacks them."""
    import numpy as np

    from sketch_rna_tpu_torch import stream
    from sketch_rna_tpu_torch.io.packing import unpack_codes2
    from sketch_rna_tpu_torch.utils.profiling import sync

    upload, match = stream._upload, stream.chunk_match_classes

    def timed_upload(chunk, device):
        t0 = time.perf_counter()
        if resident:
            n = chunk.num_reads
            out = unpack_codes2(chunk.codes2[:n], int(chunk.pad_len)), np.asarray(chunk.lengths[:n], np.int32)
        else:
            out = upload(chunk, device)
        sync(device)
        chunks.append({"reads": chunk.num_reads, "upload_s": time.perf_counter() - t0})
        return out

    def timed_match(*args, **kw):
        t0 = time.perf_counter()
        out = match(*args, **kw)
        chunks[-1]["match_s"] = time.perf_counter() - t0
        chunks[-1]["match_reads_per_s"] = chunks[-1]["reads"] / chunks[-1]["match_s"]
        return out

    stream._upload, stream.chunk_match_classes = timed_upload, timed_match
    try:
        yield
    finally:
        stream._upload, stream.chunk_match_classes = upload, match


def _summary(result, chunks: list, seconds: float) -> dict:
    stream_match = result.timing["stream_match"]
    upload = sum(c["upload_s"] for c in chunks)
    match = sum(c["match_s"] for c in chunks)
    return {"reads": result.num_reads, "seconds": seconds, "reads_per_s": result.num_reads / seconds,
            "timing": result.timing, "stats": {k: int(v) for k, v in result.stats.items()},
            "em_iterations": result.em_iterations,
            "stream_match_split": {"stream_match_s": stream_match, "upload_s": upload, "match_s": match,
                                   "other_s": stream_match - upload - match},
            "chunks": chunks}


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))) if a.size else 0.0


def run_file(index_path: str, fastq: str, config_kw: dict, device):
    """File -> result as the CLI's big-file route runs it, timed from the
    scan's start to the result on the host: (result, summary, config)."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.refbin import load_any_index
    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.stream import quantify_streamed
    from sketch_rna_tpu_torch.utils.profiling import sync

    artifact = load_any_index(index_path)
    config = QuantConfig(kmer_lengths=tuple(artifact.kmer_lengths), **config_kw)
    chunks = []
    t0 = time.perf_counter()
    feed = native.LazyScanFeed(fastq, max(config.kmer_lengths), config.stream_chunk_reads,
                               row_multiple=config.batch_size)
    try:
        index = to_device(artifact, device)
        with chunk_clock(chunks):
            result = quantify_streamed(index, feed, config)
    finally:
        feed.close()
    sync(device)
    return result, _summary(result, chunks, time.perf_counter() - t0), config, index


def run_resident(index, fastq: str, config, device):
    """The same chunks, packed and uploaded before the clock starts."""
    import torch

    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.io.packing import Packed2Reads
    from sketch_rna_tpu_torch.stream import quantify_streamed
    from sketch_rna_tpu_torch.utils.profiling import sync

    feed = native.LazyScanFeed(fastq, max(config.kmer_lengths), config.stream_chunk_reads,
                               row_multiple=config.batch_size)
    n = feed.num_reads
    on_card = [Packed2Reads(torch.from_numpy(p.codes2).to(device), p.lengths, p.pad_len, p.n_real) for p in feed]
    sync(device)
    chunks = []
    t0 = time.perf_counter()
    with chunk_clock(chunks, resident=True):
        result = quantify_streamed(index, iter(on_card), config, num_reads_hint=n)
    sync(device)
    return result, _summary(result, chunks, time.perf_counter() - t0)


def main(argv=None) -> int:
    from common_torch import card, resolve_device
    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.pipeline import write_csv

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("index")
    ap.add_argument("fastq")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--chunk-reads", type=int, default=None)
    ap.add_argument("--class-capacity", type=int, default=None)
    ap.add_argument("--resident", action="store_true", help="also run the same chunks already on the card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    if not native.native_available():
        print("profile_stream_torch: the native FASTQ parser did not build", file=sys.stderr)
        return 1
    kw = {}
    if args.chunk_reads:
        kw["stream_chunk_reads"] = args.chunk_reads
    if args.class_capacity:
        kw["stream_class_capacity"] = args.class_capacity
    result, line, config, index = run_file(args.index, args.fastq, kw, device)
    if args.csv:
        write_csv(args.csv, result)
    if args.resident:
        res, line["resident"] = run_resident(index, args.fastq, config, device)
        rel = max(_rel(res.pi, result.pi), _rel(res.weighted_counts, result.weighted_counts))
        line["resident"]["max_rel_diff"] = rel
        if args.csv:
            write_csv(f"{args.csv}.resident.csv", res)
        if not (list(res.has_entry) == list(result.has_entry) and rel <= 1e-12):
            print(f"profile_stream_torch: FAILED: the resident run differs from the file run by {rel} relative",
                  file=sys.stderr)
            return 1
    print(json.dumps({"metric": "stream_file_to_result", **line, "card": card(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
