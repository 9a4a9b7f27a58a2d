"""Sketch-stage dispatch: which kernel sketches each k of a read batch.

  - a k whose windows fit the fused kernels (nk_pad <= 1024, reads up to
    ~1 kb): K1 when it is the batch's only such k, else one K2 launch for
    all of them;
  - a longer k, of any length: K3 compacts each read's kept windows
    (~5% of them), and dedup_select's two row sorts run over those alone,
    padded to m_pad = max(2, pow2ceil(the slice's most kept hashes)): K4
    up to 16384 kept hashes, row_sort_wide (K4 chunks + merge kernel)
    past that — a slice of the batch's rows at a time.

Every route returns exactly sketch_batch's (hashes, mask, n_overflow) for
its k; the plain version of the whole stage is sketch_all_k.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
from sketch_rna_tpu_torch.hash.sketch_kernel import MAX_WINDOWS, fused_sketch, fused_sketch_multik, window_pad
from sketch_rna_tpu_torch.match.row_sort import row_sort_wide
from sketch_rna_tpu_torch.sketch.fracminhash import dedup_select
from sketch_rna_tpu_torch.utils.roofline import kept_work, sketch_work

# Bytes of one slice's worst-case kept hashes (every window kept, as at
# fraction 0.9999): the dedup holds them, their sorted copy and, past
# K4's widest row, the merge rounds' copies, so a slice takes a small
# multiple of this.  At nk_pad 32768 (20 kb reads) a slice is 1024 rows.
PLANE_BYTES = 1 << 28

Sketch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _sketch_long(codes: torch.Tensor, lengths: torch.Tensor, k: int, fraction: float, cap: int,
                 nk_pad: int) -> Sketch:
    """K3's kept hashes + sort-based dedup, a slice of rows at a time."""
    rows = max(1, PLANE_BYTES // (8 * nk_pad))
    parts = []
    for r0 in range(0, max(codes.shape[0], 1), rows):
        kept, _, _ = nthash_sketch(codes[r0 : r0 + rows], lengths[r0 : r0 + rows], k, fraction, pow2=True)
        parts.append(dedup_select(kept, cap, sort=row_sort_wide))
    if len(parts) == 1:
        return parts[0]
    hashes, masks, overflow = zip(*parts)
    return torch.cat(hashes), torch.cat(masks), sum(overflow)


def sketch_ops(B: int, L: int, ks: Sequence[int]) -> int:
    """Integer operations of sketch_reads on [B, L] reads at ks, by the
    rules of utils/roofline.py: one fused launch reads the codes once for
    all its ks (sketch_work), K3 once a k (kept_work)."""
    fused = [k for k in ks if window_pad(L, k) <= MAX_WINDOWS]
    ops = sketch_work(B, L, fused, [0] * len(fused))[1] if fused else 0
    return ops + sum(kept_work(B, L, k, 0)[1] for k in ks if k not in fused)


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
