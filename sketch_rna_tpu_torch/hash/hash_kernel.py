"""Wrapper of the hash-plane kernel K3 (csrc/hash.cu).

`nthash_sketch` computes, for one k, every window's kept hash or the
sentinel: the input of a sort-based dedup for reads too long for the
fused kernels, and the index build's hash.  On a CUDA tensor it launches
the hand-written kernel (or raises); on a CPU tensor it runs the plain
version, sketch/fracminhash.hash_plane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sketch_rna_tpu_torch import kernels
from sketch_rna_tpu_torch.hash.nthash import window_tables_u32
from sketch_rna_tpu_torch.hash.sketch_kernel import check_batch
from sketch_rna_tpu_torch.sketch.fracminhash import fracminhash_threshold, hash_plane


@functools.lru_cache(maxsize=None)
def device_tables(k: int, device: torch.device) -> torch.Tensor:
    """[k, 4] rotated-seed table as int32 bits (the kernel reads uint32)."""
    return torch.from_numpy(window_tables_u32(k).view(np.int32).copy()).to(device)


def nthash_sketch(codes: torch.Tensor, lengths: torch.Tensor, k: int, fraction: float) -> torch.Tensor:
    """[B, L-k+1] int64 holding uint32 values: the hash of every window
    that lies inside its read (position < length - (k-1)) and passes the
    threshold, 0xFFFFFFFF elsewhere.

    codes: [B, L] uint8, lengths: [B] int32, on one device.
    """
    check_batch(codes, lengths)
    B, L = codes.shape
    nk = L - k + 1
    if k < 1 or nk < 1:
        raise ValueError(f"need 1 <= k <= L (L={L}, k={k})")
    if codes.device.type == "cpu":
        return hash_plane(codes, lengths, k, fraction)
    out = torch.empty((B, nk), dtype=torch.int64, device=codes.device)
    if B:
        err = kernels.library().nthash_sketch_launch(
            codes.data_ptr(),
            lengths.data_ptr(),
            device_tables(k, codes.device).data_ptr(),
            out.data_ptr(),
            B,
            L,
            k,
            fracminhash_threshold(fraction),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
        kernels.check(err, "nthash_sketch")
        nthash_sketch.launches += 1
    return out


nthash_sketch.launches = 0  # kernel launches since the last reset
