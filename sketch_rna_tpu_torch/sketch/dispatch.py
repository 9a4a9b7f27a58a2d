"""Sketch-stage dispatch: which kernel sketches each k of a read batch.

  - a k whose windows fit the fused kernels (nk_pad <= 1024, reads up to
    ~1 kb): K1 when it is the batch's only such k, else one K2 launch for
    all of them;
  - a longer k (nk_pad <= 16384): the hash plane of K3, then dedup_select's
    two row sorts on K4 over the int64 plane padded to nk_pad;
  - past 16384 windows: ValueError.

Every route returns exactly sketch_batch's (hashes, mask, n_overflow) for
its k; the plain version of the whole stage is sketch_all_k.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
from sketch_rna_tpu_torch.hash.sketch_kernel import MAX_WINDOWS, fused_sketch, fused_sketch_multik, window_pad
from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, row_sort
from sketch_rna_tpu_torch.sketch.fracminhash import SENTINEL, dedup_select


def sketch_reads(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    ks: Sequence[int],
    fraction: float,
    caps: Sequence[int],
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """[(hashes, mask, n_overflow)] per k of a padded [B, L] read batch."""
    L = codes.shape[1]
    pads = [window_pad(L, k) for k in ks]
    too_long = [k for k, p in zip(ks, pads) if p > MAX_WIDTH]
    if too_long:
        raise ValueError(
            f"reads of {L} bases have more than {MAX_WIDTH} windows at k={too_long[0]}, the widest "
            "row the K4 dedup sorts; longer reads are ROADMAP Queue 3's open limit"
        )
    out = [None] * len(ks)
    fused = [i for i, p in enumerate(pads) if p <= MAX_WINDOWS]
    if len(fused) == 1:
        (i,) = fused
        out[i] = fused_sketch(codes, lengths, ks[i], fraction, caps[i])
    elif fused:
        for i, res in zip(fused, fused_sketch_multik(codes, lengths, [ks[i] for i in fused], fraction,
                                                     [caps[i] for i in fused])):
            out[i] = res
    for i, p in enumerate(pads):
        if p > MAX_WINDOWS:
            plane = nthash_sketch(codes, lengths, ks[i], fraction)
            plane = torch.nn.functional.pad(plane, (0, p - plane.shape[1]), value=SENTINEL)
            out[i] = dedup_select(plane, caps[i], sort=row_sort)
    return out
