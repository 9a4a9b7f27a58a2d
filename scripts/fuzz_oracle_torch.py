"""Randomized oracle fuzz of the PyTorch port on the card: a schedule of
sketch_rna_tpu_torch.oracle.fuzz's seeded trials (random problem shapes
and engine knobs against the reference math in NumPy), trial i in regime
i mod 8, so that the schedule reaches every kernel.

Usage:  python3 scripts/fuzz_oracle_torch.py [n_trials] [base_seed] [--device cuda|cpu]

It runs on the card by default and exits nonzero without one;
--device cpu runs every kernel's plain PyTorch version.  On the first
mismatch it prints the draw and exits nonzero.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from sketch_rna_tpu_torch.oracle.fuzz import REGIMES, describe, draw, one_trial  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_trials", nargs="?", type=int, default=50)
    parser.add_argument("base_seed", nargs="?", type=int, default=777000)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("fuzz_oracle_torch: no CUDA device (pass --device cpu to run the plain versions)", file=sys.stderr)
        return 2
    t0 = time.time()
    compared = skipped = 0
    for i in range(args.n_trials):
        seed = args.base_seed + i
        regime = REGIMES[i % len(REGIMES)]
        try:
            info = one_trial(seed, args.device, regime)
        except Exception:
            print(f"FUZZ FAILURE at seed={seed}: {describe(draw(seed, regime))}", flush=True)
            raise
        skipped += "skipped" in info
        compared += "skipped" not in info
        print(f"[{i + 1}/{args.n_trials}] seed={seed} {'skipped' if 'skipped' in info else 'ok'} {info} "
              f"({time.time() - t0:.0f}s)", flush=True)
    print(f"fuzz_oracle_torch: {compared} trials compared, {skipped} skipped, on {args.device} in "
          f"{time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
