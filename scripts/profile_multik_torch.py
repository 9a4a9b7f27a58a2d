"""Multi-k cost decomposition of the PyTorch port's quant step (the
counterpart of scripts/profile_multik.py, profile_multik_stages.py and
profile_multik_merge.py; imports no JAX): is the cost of ks (21, 31)
each k's own work, or what coupling the ks adds?

    python3 scripts/profile_multik_torch.py [--transcripts 250000]
        [--reads N] [--batch B] [--cache-dir DIR] [--device cuda|cpu]

It loads (or builds) the (21, 31) index of
synth_transcriptome(default_rng(2026), N) as profile_step_torch.py does,
takes the same first batch of 150 bp reads (seed 7), and

  - times every stage of sketch_match_step (profile_step_torch's stages:
    sketch, probe, expand, group, step) at k = 21 alone, at k = 31 alone
    -- each against its own slice of the (21, 31) index -- and at
    (21, 31), and reports t(21) + t(31) against t(21, 31) for each stage
    (device ms on the card, wall ms everywhere), the question of
    profile_multik_stages.py;
  - times the merged grouping's sort both ways on that batch's packed
    (tid * K + k) event rows, int32 and widened to int64: per-k row sorts
    plus the merge kernel (rowmatch.sort_event_parts: K4 + csrc/merge.cu)
    against one row sort of the parts laid side by side
    (row_sort.row_sort_wide); the two must be bit-equal, or the script
    exits 1 (profile_multik_merge.py's A/B).

The stage chains must equal sketch_match_step bit for bit at every k set
(exit 1 otherwise).  Runs on the card unless --device cpu is passed, and
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

KS = (21, 31)


def sort_both_ways(parts, device) -> dict:
    """The merged grouping's sort of these [B, w_k] parts, per-k sorts +
    merge against one row sort of the parts side by side (padded as
    sort_event_parts pads them): measured, and held bit-equal."""
    import torch

    from sketch_rna_tpu_torch.match.row_sort import row_sort_wide
    from sketch_rna_tpu_torch.match.rowmatch import I32_MAX, pow2ceil, sort_event_parts
    from sketch_rna_tpu_torch.utils.profiling import measure

    B = parts[0].shape[0]
    w = pow2ceil(max(p.shape[1] for p in parts))
    side = torch.full((B, pow2ceil(len(parts)) * w), I32_MAX, dtype=parts[0].dtype, device=parts[0].device)
    for i, p in enumerate(parts):
        side[:, i * w : i * w + p.shape[1]] = p

    def per_k_merge():
        return sort_event_parts(parts)

    def one_sort():
        return row_sort_wide(side)

    if not torch.equal(per_k_merge(), one_sort()):
        raise AssertionError(f"per-k sorts + merge differ from one row sort at {list(side.shape)} {side.dtype}")
    return {"shape": list(side.shape), "dtype": str(side.dtype)[6:], "equal": True,
            "per_k_merge": measure(per_k_merge, device), "one_sort": measure(one_sort, device)}


def packed_parts(index, config, c, n, caps):
    """The (21, 31) batch's event rows as the merged grouping packs them
    (tid * K + k; sentinels kept)."""
    import torch

    from profile_step_torch import stage_calls
    from sketch_rna_tpu_torch.match.rowmatch import I32_MAX

    calls, _ = stage_calls(index, config, c, n, caps)
    parts = calls["expand"]()
    K = len(parts)
    return [torch.where(p != I32_MAX, p * K + ki, I32_MAX) for ki, p in enumerate(parts)]


def profile_multik(index, codes, lengths, batch: int, device) -> dict:
    """The stages at k = 21, k = 31 and (21, 31) on one index's slices,
    the sums against the pair, and the grouping sort both ways."""
    from profile_step_torch import first_batch, one_k, profile_stages
    from sketch_rna_tpu_torch.config import QuantConfig

    runs = {}
    for ks in ((KS[0],), (KS[1],), KS):
        sub = index if len(ks) > 1 else one_k(index, ks[0])
        c, n, caps = first_batch(sub, codes, lengths, batch)
        runs[",".join(map(str, ks))] = profile_stages(sub, QuantConfig(kmer_lengths=ks, batch_size=batch), c, n,
                                                      caps)
    a, b, both = (runs[key] for key in ("21", "31", "21,31"))
    sums = {}
    for stage in both:
        sums[stage] = {}
        for metric in ("wall_ms", "device_ms"):
            if both[stage][metric] is None:
                continue
            single = a[stage][metric] + b[stage][metric]
            sums[stage][metric] = {"t21": a[stage][metric], "t31": b[stage][metric], "sum": single,
                                   "t21_31": both[stage][metric], "ratio": both[stage][metric] / single}
    c, n, caps = first_batch(index, codes, lengths, batch)
    parts = packed_parts(index, QuantConfig(kmer_lengths=KS, batch_size=batch), c, n, caps)
    sorts = {"int32": sort_both_ways(parts, device), "int64": sort_both_ways([p.long() for p in parts], device)}
    return {"metric": "multik_stages", "transcripts": index.num_transcripts, "batch": list(c.shape),
            "stages": runs, "sum_vs_both": sums, "grouping_sort": sorts}


def main(argv=None) -> int:
    from common_torch import SCALE_CACHE, card, resolve_device
    from profile_step_torch import PAD_LEN, READ_LEN, SEED, index_on_device
    from sketch_rna_tpu_torch.utils.synth import sample_reads

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--transcripts", type=int, default=250000)
    ap.add_argument("--reads", type=int, default=1 << 20, help="reads drawn; the first batch is profiled")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--cache-dir", default=str(SCALE_CACHE))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    index, seqs = index_on_device(args.transcripts, KS, device, args.cache_dir)
    codes, lengths = sample_reads(seqs, args.reads, READ_LEN, PAD_LEN, SEED)
    try:
        line = profile_multik(index, codes, lengths, args.batch, device)
    except AssertionError as exc:
        print(f"profile_multik_torch: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({**line, "card": card(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
