"""Sketch-stage routes of the PyTorch port at the main path's shapes (the
counterpart of scripts/profile_sketch.py; imports no JAX).

    python3 scripts/profile_sketch_torch.py [B] [L[,L...]] [k[,k...]] [--device cuda|cpu]

For each read width L (default 104,152,256,512,1024: the c3 reads, the
GENCODE reads as the fused engine cuts them, and wider up to the fused
kernels' 1,024 windows) it sketches B (default 8192) random reads that
fill their rows (numpy, seed 0) at the ks (default 31) three ways:

  plain    sketch/fracminhash.sketch_all_k, every step a torch operation;
  unfused  K3 (hash/hash_kernel.nthash_sketch: each read's kept windows)
           + the K4-int64 sort dedup, one k at a time: what
           sketch/dispatch._sketch_long does past 1,024 windows;
  fused    K1 (one k) or K2 (several ks in one launch): what
           dispatch.sketch_reads does up to 1,024 windows.

Each route reports wall ms, device ms (on the card), launches and host
operations per call (utils/profiling.measure).  The three must agree
bit for bit (hashes, mask and overflow count of every k), or the script
exits 1.  It reports the widths where the fused route is the faster of
the two kernel routes on the card (by device ms; by wall ms off the
card) and the first width where it stops winning (null: it wins at every
width it can take).  Runs on the card unless --device cpu is passed, and
exits 2 without one.  The last line is one JSON object with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

ROUTES = ("plain", "unfused", "fused")
SEED = 0  # the reads' numpy seed


def routes(ks, fraction: float, caps, L: int):
    """route -> fn(codes, lengths) -> [(hashes, mask, n_overflow)] per k."""
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik, window_pad
    from sketch_rna_tpu_torch.sketch.dispatch import _sketch_long
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k

    def plain(c, n):
        return sketch_all_k(c, n, ks, fraction, caps)

    def unfused(c, n):
        return [_sketch_long(c, n, k, fraction, cap, window_pad(L, k)) for k, cap in zip(ks, caps)]

    def fused(c, n):
        if len(ks) == 1:
            return [fused_sketch(c, n, ks[0], fraction, caps[0])]
        return fused_sketch_multik(c, n, ks, fraction, caps)

    return dict(zip(ROUTES, (plain, unfused, fused)))


def profile_width(B: int, L: int, ks, device) -> dict:
    """The three routes at [B, L]: measured and held bit-equal."""
    import numpy as np
    import torch

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.utils.profiling import measure

    rng = np.random.default_rng(SEED)
    c = torch.from_numpy(rng.integers(0, 4, size=(B, L), dtype=np.uint8)).to(device)
    n = torch.full((B,), L, dtype=torch.int32, device=device)
    cfg = QuantConfig(kmer_lengths=tuple(ks))
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)
    fns = routes(tuple(ks), cfg.sketch_fraction, caps, L)
    want = fns["plain"](c, n)
    for name in ROUTES[1:]:
        got = fns[name](c, n)
        for k, g, w in zip(ks, got, want):
            if not all(torch.equal(a, b) for a, b in zip(g, w)):
                raise AssertionError(f"{name} differs from the plain sketch at [{B}, {L}] k={k}")
    return {"shape": [B, L], "caps": list(caps), "equal": True,
            **{name: measure(lambda fn=fn: fn(c, n), device) for name, fn in fns.items()}}


def main(argv=None) -> int:
    from common_torch import card, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=8192)
    ap.add_argument("L", nargs="?", default="104,152,256,512,1024", help="comma list of read widths")
    ap.add_argument("ks", nargs="?", default="31", help="comma list of ks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    ks = tuple(int(x) for x in args.ks.split(","))
    metric = "device_ms" if device.type == "cuda" else "wall_ms"
    widths, wins, stops = [], [], None
    for L in (int(x) for x in args.L.split(",")):
        try:
            line = profile_width(args.B, L, ks, device)
        except AssertionError as exc:
            print(f"profile_sketch_torch: FAILED: {exc}", file=sys.stderr)
            return 1
        widths.append(line)
        print(json.dumps(line), flush=True)
        if line["fused"][metric] < line["unfused"][metric]:
            wins.append(L)
        elif stops is None:
            stops = L
    print(json.dumps({"metric": "sketch_routes", "ks": list(ks), "by": metric, "fused_wins_at": wins,
                      "fused_stops_winning_at": stops, "widths": widths, "card": card(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
