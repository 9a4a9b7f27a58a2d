"""Index probe by binary search: sketch hashes -> posting runs (start,
length), through torch.searchsorted over a k's sorted keys.

The sharded route probes its hash-range shard with it, as the JAX
shard_map route probes with lookup_postings: a shard carries no bucket
table.  The fused and streamed engines probe each k's bucket table
instead (match/bucket_lookup.py, kernel P), as the JAX package's engines
do; the two give identical runs: the run of `postings` holding the
transcripts of that hash, and (0, 0) for a masked lane or a hash the
index does not hold.  Which is faster on the H100 is in PERF.md's
kernel table (P's library_ms is this function's time).
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
