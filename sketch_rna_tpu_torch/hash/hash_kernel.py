"""Wrapper of the compacting hash kernel K3 (csrc/hash.cu).

`nthash_sketch` hashes every window of one k and returns, per row, only
the kept ones: the hashes and window indices of the windows inside the
read whose hash passes the FracMinHash threshold, in window order.  It
feeds the sort-based dedup of reads too long for the fused kernels and
the index build.  On a CUDA tensor it launches the hand-written kernel
(two passes: count per tile, then write at the tiles' offsets) or
raises; on a CPU tensor it runs the plain version,
sketch/fracminhash.hash_kept.  Either reads the batch's largest kept
count to the host, counted as one match.host_reads on the open timer
(utils/timing.py; none is open in the index build).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sketch_rna_tpu_torch import kernels
from sketch_rna_tpu_torch.hash.sketch_kernel import check_batch
from sketch_rna_tpu_torch.sketch.fracminhash import fracminhash_threshold, hash_kept, kept_width
from sketch_rna_tpu_torch.utils.timing import HOST_READS, count


def nthash_sketch(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, fraction: float, pow2: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hashes [B, m] int64 holding uint32, windows [B, m] int32,
    counts [B] int32): row b's counts[b] kept windows — inside the read
    (window < length - (k-1)) with hash <= threshold — in window order,
    then the sentinel 0xFFFFFFFF and -1.  m is the batch's largest count,
    or with pow2 max(2, its next power of two).

    codes: [B, L] uint8, lengths: [B] int32, on one device.  Reads the
    largest count to the host (one sync).
    """
    check_batch(codes, lengths)
    B, L = codes.shape
    nk = L - k + 1
    if k < 1 or nk < 1:
        raise ValueError(f"need 1 <= k <= L (L={L}, k={k})")
    if B:
        count(HOST_READS)  # the largest kept count, read below or in hash_kept
    if codes.device.type == "cpu":
        return hash_kept(codes, lengths, k, fraction, pow2)
    device = codes.device
    lib = kernels.library()
    threshold = fracminhash_threshold(fraction)
    stream = torch.cuda.current_stream(device).cuda_stream
    T = lib.nthash_kept_tiles(L, k)
    tile_counts = torch.empty((T, B), dtype=torch.int32, device=device)
    if B:
        err = lib.nthash_count_launch(
            codes.data_ptr(), lengths.data_ptr(), tile_counts.data_ptr(), B, L, k, threshold, stream
        )
        kernels.check(err, "nthash_count")
        nthash_sketch.launches += 1
    # Each row's tile offsets: a scan along the outer dim (torch's innermost
    # scan is slow for many short rows), or a flat scan of one long row.
    incl = torch.cumsum(tile_counts.view(-1) if B == 1 else tile_counts, dim=0, dtype=torch.int32).view(T, B)
    counts = incl[-1]
    m = kept_width(int(counts.max()) if B else 0, pow2)
    hashes = torch.empty((B, m), dtype=torch.int64, device=device)
    windows = torch.empty((B, m), dtype=torch.int32, device=device)
    if B and m:
        err = lib.nthash_kept_launch(
            codes.data_ptr(), lengths.data_ptr(), incl.data_ptr(), hashes.data_ptr(), windows.data_ptr(),
            B, L, k, threshold, m, stream,
        )
        kernels.check(err, "nthash_kept")
    return hashes, windows, counts


nthash_sketch.launches = 0  # calls that launched the kernel (both passes) since the last reset
