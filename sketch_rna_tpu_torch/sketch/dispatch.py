"""Sketch-stage dispatch: which kernel sketches each k of a read batch.

  - a k whose windows fit the fused kernels (nk_pad <= 1024, reads up to
    ~1 kb): K1 when it is the batch's only such k, else one K2 launch for
    all of them; past MAX_KS such ks (the kernel's kMaxKs), one launch a
    group of MAX_KS ks in the caller's k order, a last group of one k
    taking K1 (nine ks: K2 for eight, K1 for the ninth);
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
from sketch_rna_tpu_torch.hash.sketch_kernel import MAX_KS, MAX_WINDOWS, fused_sketch, fused_sketch_multik, window_pad
from sketch_rna_tpu_torch.match.row_sort import row_sort_wide
from sketch_rna_tpu_torch.sketch.fracminhash import dedup_select

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


def fused_groups(L: int, ks: Sequence[int]) -> List[List[int]]:
    """Positions in ks of the ks that fit the fused kernels at width L,
    one list a launch: groups of MAX_KS in the caller's k order, the
    last one the rest."""
    fused = [i for i, k in enumerate(ks) if window_pad(L, k) <= MAX_WINDOWS]
    return [fused[i : i + MAX_KS] for i in range(0, len(fused), MAX_KS)]


def sketch_reads(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    ks: Sequence[int],
    fraction: float,
    caps: Sequence[int],
) -> List[Sketch]:
    """[(hashes, mask, n_overflow)] per k of a padded [B, L] read batch."""
    L = codes.shape[1]
    out = [None] * len(ks)
    groups = fused_groups(L, ks)
    for group in groups:
        if len(group) == 1:
            (i,) = group
            out[i] = fused_sketch(codes, lengths, ks[i], fraction, caps[i])
            continue
        for i, res in zip(group, fused_sketch_multik(codes, lengths, [ks[i] for i in group], fraction,
                                                     [caps[i] for i in group])):
            out[i] = res
    fused = {i for g in groups for i in g}
    for i, k in enumerate(ks):
        if i not in fused:
            out[i] = _sketch_long(codes, lengths, k, fraction, caps[i], window_pad(L, k))
    return out
