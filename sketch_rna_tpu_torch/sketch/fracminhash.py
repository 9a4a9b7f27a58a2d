"""FracMinHash sketching: threshold filter + set-dedup — the plain
PyTorch versions of the sketch kernels: `sketch_batch` of K1,
`sketch_all_k` of K2 (hash/sketch_kernel.py) and `hash_kept` of K3
(hash/hash_kernel.py).

Reference semantics (createSketch_FracMinhash_direct, src/sketch.cpp:24-39):
  threshold = (uint32_t)(UINT32_MAX * fraction)      [C cast truncates]
  keep a k-mer iff its (low-32-bit) forward ntHash <= threshold
  the sketch is a SET: duplicates collapse, multiplicity is discarded.

Per read the output is a fixed-capacity, ascending row of distinct kept
hashes with a validity mask.  Hashes are int64 tensors holding uint32
values; discarded lanes hold the sentinel 0xFFFFFFFF, which no kept hash
can equal for any fraction < 1.  More distinct kept hashes than the row
holds keeps the numerically smallest and counts the rest, never silent.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from sketch_rna_tpu_torch.hash.nthash import nthash_batch_u32, nthash_forward_scalar
from sketch_rna_tpu_torch.match.row_sort import row_sort_plain

SENTINEL = 0xFFFFFFFF


def fracminhash_threshold(fraction: float) -> int:
    """uint32 keep-threshold with the reference's C-cast truncation
    (src/sketch.cpp:25-26): static_cast<uint32_t>(UINT32_MAX * fraction).

    The reference stores the fraction in a `float` (global sketch_size =
    0.05f, src/main.cpp:43) that widens to the `double` parameter, so
    the product uses double(float(fraction)) — e.g. 0.05 yields
    214748367, not 214748364.  Promote through float32 to match the
    binary bit-for-bit."""
    if not (0.0 <= fraction < 1.0):
        raise ValueError("fraction must be in [0, 1) — 1.0 would collide with the pad sentinel")
    f = np.float64(np.float32(fraction))  # float -> double, like the C++ call
    return int(float(np.float64(0xFFFFFFFF) * f))  # truncates


def hash_plane(codes: torch.Tensor, lengths: torch.Tensor, k: int, fraction: float) -> torch.Tensor:
    """[B, L-k+1] int64: the hash of every window that lies inside its
    read and passes the threshold, SENTINEL elsewhere."""
    h = nthash_batch_u32(codes, k)  # [B, nk]
    pos = torch.arange(h.shape[1], dtype=torch.int64, device=h.device)
    pos_ok = pos[None, :] < (lengths.long()[:, None] - (k - 1))
    keep = pos_ok & (h <= fracminhash_threshold(fraction))
    return torch.where(keep, h, SENTINEL)


def kept_width(max_count: int, pow2: bool) -> int:
    """Lanes of a kept-window row: the batch's largest count, or with pow2
    max(2, its next power of two) — a width K4 sorts."""
    if not pow2:
        return max_count
    return max(2, 1 << (max_count - 1).bit_length())


def hash_kept(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, fraction: float, pow2: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hash_plane compacted per row to its kept windows: (hashes [B, m]
    int64, windows [B, m] int32, counts [B] int32), the kept hashes and
    their window indices in window order, then SENTINEL and -1; m as
    kept_width gives it for the batch's largest count."""
    plane = hash_plane(codes, lengths, k, fraction)
    B, nk = plane.shape
    keep = plane != SENTINEL
    counts = keep.sum(dim=1, dtype=torch.int32)
    m = kept_width(int(counts.max()) if B else 0, pow2)
    # A stable sort of the drop flags puts each row's kept windows first, in order.
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, : min(m, nk)]
    hashes = torch.full((B, m), SENTINEL, dtype=torch.int64, device=plane.device)
    windows = torch.full((B, m), -1, dtype=torch.int32, device=plane.device)
    valid = torch.arange(order.shape[1], device=plane.device)[None, :] < counts[:, None]
    hashes[:, : order.shape[1]] = torch.where(valid, plane.gather(1, order), SENTINEL)
    windows[:, : order.shape[1]] = torch.where(valid, order, -1).to(torch.int32)
    return hashes, windows, counts


def sketch_batch(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    fraction: float,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sketch a padded read batch for one k.

    codes: [B, L] uint8 base codes (zero-padded); lengths: [B] int32.
    Returns (hashes [B, capacity] int64 ascending sentinel-padded,
    mask [B, capacity] bool, n_overflow [] int64 — distinct kept hashes
    dropped for exceeding capacity across the batch).
    """
    return dedup_select(hash_plane(codes, lengths, k, fraction), capacity)


def sketch_all_k(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    ks: Sequence[int],
    fraction: float,
    caps: Sequence[int],
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """sketch_batch for every k: [(hashes, mask, n_overflow)] per k."""
    return [sketch_batch(codes, lengths, k, fraction, cap) for k, cap in zip(ks, caps)]


def dedup_select(
    hs: torch.Tensor,
    capacity: int,
    sort: Callable[[torch.Tensor], torch.Tensor] = row_sort_plain,
):
    """Sort each row, drop duplicates, compact with a second sort, and
    take the first `capacity` distinct values.

    hs: [B, nk] int64 with the sentinel on discarded lanes.  sort: the
    row sort (the long-read path passes kernel K4 with nk a power of
    two).  Returns (hashes, mask, n_overflow) exactly as sketch_batch
    documents.
    """
    B, nk = hs.shape
    hs = sort(hs)
    dup = torch.zeros_like(hs, dtype=torch.bool)
    dup[:, 1:] = hs[:, 1:] == hs[:, :-1]
    hs = sort(torch.where(dup & (hs != SENTINEL), SENTINEL, hs))
    n_unique = (hs != SENTINEL).sum(dim=1)
    if nk < capacity:
        pad = torch.full((B, capacity - nk), SENTINEL, dtype=hs.dtype, device=hs.device)
        hs = torch.cat([hs, pad], dim=1)
    else:
        hs = hs[:, :capacity].contiguous()
    mask = hs != SENTINEL
    n_overflow = torch.clamp(n_unique - capacity, min=0).sum()
    return hs, mask, n_overflow


def sketch_scalar(codes, k: int, fraction: float) -> set:
    """The reference's sketch of one sequence as a Python set of the kept
    low-32-bit hashes, one k-mer at a time: the reference oracle's
    (oracle/reference_oracle.py), independent of every batched path."""
    thr = fracminhash_threshold(fraction)
    out = set()
    for h in nthash_forward_scalar(list(codes), k):
        h32 = h & 0xFFFFFFFF
        if h32 <= thr:
            out.add(h32)
    return out
