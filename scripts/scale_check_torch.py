"""Scale harness for the PyTorch port (the counterpart of
scripts/scale_check.py; imports no JAX): a larger transcriptome and read
count on one GPU.  Builds the index on the device, or loads it from the
cache (keyed by transcripts and ks), then times one quant after a
warm-up and reports reads/s, the loss stats and stage seconds.  At
250,000 transcripts a cached index is used only if it equals the JAX
package's build (common_torch.load_gencode_index); else it is built
again.

    python3 scripts/scale_check_torch.py [--transcripts N] [--reads N]
        [--k 31[,21]] [--read-len L] [--batch-size B] [--streaming]
        [--cache-dir DIR] [--device cuda|cpu]

The transcriptome is synth_transcriptome(default_rng(2026), N), as in
the JAX script; reads come from utils/synth.py sample_reads (numpy,
seed 7), not the JAX script's jax.random draws.  The cache
(build/bench_torch/scale_cache by default) holds T<N>_k<ks>.npz, which
the profile_*_torch.py scripts read too.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main(argv=None) -> int:
    from common_torch import SCALE_CACHE, forced_streaming, resolve_device, sync

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--transcripts", type=int, default=50000)
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--k", default="31")
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--streaming", action="store_true", help="force the streamed engine")
    ap.add_argument("--cache-dir", default=str(SCALE_CACHE),
                    help="reuse the built index across runs (keyed by transcripts and ks)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2

    from common_torch import cached_index
    from sketch_rna_tpu_torch import pipeline as pl
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.utils.synth import sample_reads

    ks = tuple(int(x) for x in args.k.split(","))
    cfg = QuantConfig(kmer_lengths=ks, batch_size=args.batch_size,
                      max_read_len=((args.read_len + 127) // 128) * 128, em_dtype="float32")
    t0 = time.perf_counter()
    artifact, seqs, where = cached_index(args.transcripts, ks, device, args.cache_dir)
    print(f"transcriptome: {len(seqs)} seqs, {sum(s.size for s in seqs) / 1e6:.1f} Mb; {where}", flush=True)
    index = to_device(artifact, device)
    t_index = time.perf_counter() - t0
    print(f"index: {t_index:.1f}s, keys={ {k: artifact.per_k[k].num_keys for k in ks} } "
          f"postings={ {k: int(artifact.per_k[k].postings.size) for k in ks} }", flush=True)

    t0 = time.perf_counter()
    codes, lengths = sample_reads(seqs, args.reads, args.read_len, cfg.max_read_len, 7)
    packed = PackedReads(codes, lengths, [])
    print(f"reads: {args.reads} in {time.perf_counter() - t0:.1f}s (host)", flush=True)

    with forced_streaming() if args.streaming else contextlib.nullcontext():
        pl.quantify(index, packed, cfg)  # warm-up
        sync(device)
        t0 = time.perf_counter()
        result = pl.quantify(index, packed, cfg)
        sync(device)
        dt = time.perf_counter() - t0
    print(f"quant: {dt:.2f}s -> {args.reads / dt:,.0f} reads/s | em_iters={result.em_iterations} "
          f"rows={int(result.has_entry.sum())} stats={result.stats} "
          f"timing={ {k: round(v, 3) for k, v in result.timing.items()} }", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
