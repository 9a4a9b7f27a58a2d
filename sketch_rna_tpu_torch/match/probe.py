"""Index probe: sketch hashes -> posting runs (start, length).

The JAX package probes a bucketed direct-address table because gathers
are slow on a TPU (match/bucket_lookup.py).  That premise is untested on
Hopper, so the port binary-searches the sorted keys with
torch.searchsorted; the (start, length) it returns are identical: the
run of `postings` holding the transcripts of that hash, and (0, 0) for a
masked lane or a hash the index does not hold.
"""

from __future__ import annotations

from typing import Tuple

import torch


def probe(
    hashes: torch.Tensor,
    mask: torch.Tensor,
    keys: torch.Tensor,
    row_ptr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] int64 hashes + validity mask -> (start, length) [B, S] int64.

    keys: [U] int64 ascending distinct; row_ptr: [U+1] int64 CSR offsets.
    """
    if keys.numel() == 0:
        zero = torch.zeros_like(hashes)
        return zero, zero
    pos = torch.searchsorted(keys, hashes, side="left")
    slot = torch.clamp(pos, max=keys.numel() - 1)
    found = mask & (keys[slot] == hashes)
    start = torch.where(found, row_ptr[slot], 0)
    length = torch.where(found, row_ptr[slot + 1] - row_ptr[slot], 0)
    return start, length
