"""Sketch-stage dispatch: which kernel sketches each k of a read batch.

  - a k whose windows fit the fused kernels (nk_pad <= 1024, reads up to
    ~1 kb): K1 when it is the batch's only such k, else one K2 launch for
    all of them;
  - a longer k, of any length: the hash plane of K3, then dedup_select's
    two row sorts over the int64 plane padded to nk_pad — K4 up to 16384
    windows, row_sort_wide (K4 chunks + merges in torch) past that — a
    slice of the batch's rows at a time.

Every route returns exactly sketch_batch's (hashes, mask, n_overflow) for
its k; the plain version of the whole stage is sketch_all_k.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
from sketch_rna_tpu_torch.hash.sketch_kernel import MAX_WINDOWS, fused_sketch, fused_sketch_multik, window_pad
from sketch_rna_tpu_torch.match.row_sort import row_sort_wide
from sketch_rna_tpu_torch.sketch.fracminhash import SENTINEL, dedup_select

# Bytes of one slice's int64 hash plane.  The dedup holds the plane, its
# sorted copy and, past K4's widest row, the merge rounds' few copies, so
# a slice takes a small multiple of this; at nk_pad 32768 (20 kb reads)
# it is 1024 rows, where a whole 8192-read batch would be 2 GiB a copy.
PLANE_BYTES = 1 << 28

Sketch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _sketch_long(codes: torch.Tensor, lengths: torch.Tensor, k: int, fraction: float, cap: int,
                 nk_pad: int) -> Sketch:
    """K3 plane + sort-based dedup, PLANE_BYTES of plane at a time."""
    rows = max(1, PLANE_BYTES // (8 * nk_pad))
    parts = []
    for r0 in range(0, max(codes.shape[0], 1), rows):
        plane = nthash_sketch(codes[r0 : r0 + rows], lengths[r0 : r0 + rows], k, fraction)
        plane = torch.nn.functional.pad(plane, (0, nk_pad - plane.shape[1]), value=SENTINEL)
        parts.append(dedup_select(plane, cap, sort=row_sort_wide))
    if len(parts) == 1:
        return parts[0]
    hashes, masks, overflow = zip(*parts)
    return torch.cat(hashes), torch.cat(masks), sum(overflow)


def sketch_reads(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    ks: Sequence[int],
    fraction: float,
    caps: Sequence[int],
) -> List[Sketch]:
    """[(hashes, mask, n_overflow)] per k of a padded [B, L] read batch."""
    L = codes.shape[1]
    pads = [window_pad(L, k) for k in ks]
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
            out[i] = _sketch_long(codes, lengths, ks[i], fraction, caps[i], p)
    return out
