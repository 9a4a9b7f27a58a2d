"""Host feed of the PyTorch port's streamed route: scan, pack and upload
rates at the stream's chunk size (the counterpart of
scripts/profile_feed.py; imports no JAX).

    python3 scripts/profile_feed_torch.py READS.fq [--chunk 1048576]
        [--min-len 31] [--batch 8192] [--skip-upload] [--device cuda|cpu]

Stages, each timed on the host's clock:

  scan      io/native.NativeFastqScan: mmap, parallel byte-range parse,
            validation and deduplication of every record;
  pack      NativeFastqScan.pack_range (8-bit codes) and pack_range2 (2-bit,
            4 bases a byte: what the streamed route ships), one chunk of
            --chunk reads at a time, sequentially;
  upload    the 2-bit chunks to the card: from pinned host memory
            (copied in, then a non-blocking copy), and as the stream
            uploads them (stream._upload: a pageable copy, then the 2-bit
            unpack on the card), each ended by a synchronize;
  pipeline  native.chunks_from_scan2 (a background thread packs chunk
            c + 1 while chunk c uploads) into stream._upload, at the
            width and row multiple the CLI's feed (native.LazyScanFeed)
            gives it: what the CLI's streamed route runs before matching.

Each reports reads/s and GB/s (of the FASTQ's bytes for scan and the
pipeline, of the packed bytes for pack and upload); every stage must see
every read of the scan, or the script exits 1.  The upload stages need
the card: with --device cpu or --skip-upload they are null (not
measured) and the pipeline runs without an upload.  Runs on the card
unless --device cpu is passed, and exits 2 without one.  The last line
is one JSON object, {"metric": "host_feed", ...}, with the card's name
and power limit and the host's core count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def _rates(n_reads: int, nbytes: int, seconds: float) -> dict:
    return {"s": seconds, "reads_per_s": n_reads / seconds, "gb_per_s": nbytes / seconds / 1e9}


def profile_feed(fastq: str, chunk: int, min_len: int, batch: int, device, upload: bool) -> dict:
    """The four stages on one FASTQ (see the module docstring); raises
    AssertionError when a stage does not see every read."""
    import torch

    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.stream import _upload

    if not native.native_available():
        raise AssertionError("the native FASTQ parser did not build")
    size = os.path.getsize(fastq)
    t0 = time.perf_counter()
    scan = native.NativeFastqScan(fastq, min_len)
    t_scan = time.perf_counter() - t0
    n = scan.num_reads
    # The CLI feed's width: the longest read rounded up to 8 (LazyScanFeed.pad_len).
    pad_len = max(-(-scan.max_len // 8) * 8, min_len)
    out = {"metric": "host_feed", "fastq_bytes": size, "reads": n, "chunk": chunk, "pad_len": pad_len,
           "scan": _rates(n, size, t_scan)}
    starts = range(0, n, chunk)
    for name, pack in (("pack8", scan.pack_range), ("pack2", scan.pack_range2)):
        t0, packed_n, nbytes = time.perf_counter(), 0, 0
        for s in starts:
            p = pack(s, min(chunk, n - s), pad_len)
            packed_n += p.num_reads
            nbytes += (p.codes.nbytes if name == "pack8" else p.codes2.nbytes) + p.lengths.nbytes
        out[name] = _rates(packed_n, nbytes, time.perf_counter() - t0)
        if packed_n != n:
            raise AssertionError(f"{name} packed {packed_n} of {n} reads")
    out["pack8"]["note"] = "8-bit codes"
    out["pack2"]["note"] = "2-bit codes, what the stream ships"

    out["upload_pinned"] = out["upload_stream"] = None
    if upload:
        chunks = [scan.pack_range2(s, min(chunk, n - s), pad_len, out_rows=-(-min(chunk, n - s) // batch) * batch)
                  for s in starts]
        pinned = torch.empty(chunks[0].codes2.shape, dtype=torch.uint8).pin_memory()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for p in chunks:
            host = pinned[: p.codes2.shape[0]]
            host.copy_(torch.from_numpy(p.codes2))
            host.to(device, non_blocking=True)
            torch.cuda.synchronize(device)
        nbytes = sum(p.codes2.nbytes for p in chunks)
        out["upload_pinned"] = _rates(n, nbytes, time.perf_counter() - t0)
        _upload(chunks[0], device)  # warm the pageable path and the unpack
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for p in chunks:
            _upload(p, device)
            torch.cuda.synchronize(device)
        out["upload_stream"] = _rates(n, nbytes + sum(p.lengths.nbytes for p in chunks), time.perf_counter() - t0)
        del chunks, pinned
    scan.close()

    scan = native.NativeFastqScan(fastq, min_len)
    t0, seen = time.perf_counter(), 0
    for p in native.chunks_from_scan2(scan, chunk, pad_len, row_multiple=batch):
        if upload:
            codes, _ = _upload(p, device)
            torch.cuda.synchronize(device)
            del codes
        seen += p.num_reads
    out["pipeline"] = _rates(seen, size, time.perf_counter() - t0)
    out["pipeline"]["note"] = "pack || upload" if upload else "pack only (no upload measured)"
    if seen != n:
        raise AssertionError(f"the pipeline fed {seen} of {n} reads")
    seq = t_scan + out["pack2"]["s"] + (out["upload_stream"]["s"] if upload else 0.0)
    out["feed_seq"] = {"s": seq, "reads_per_s": n / seq}
    out["cores"] = os.cpu_count()
    return out


def main(argv=None) -> int:
    from common_torch import card, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fastq")
    ap.add_argument("--chunk", type=int, default=1 << 20)
    ap.add_argument("--min-len", type=int, default=31)
    ap.add_argument("--batch", type=int, default=8192, help="row multiple of a chunk (the batch size)")
    ap.add_argument("--skip-upload", action="store_true", help="host stages only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    try:
        line = profile_feed(args.fastq, args.chunk, args.min_len, args.batch, device,
                            upload=device.type == "cuda" and not args.skip_upload)
    except AssertionError as exc:
        print(f"profile_feed_torch: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({**line, "card": card(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
