"""Wrapper of the fused sketch kernel K1 (csrc/sketch.cu).

`fused_sketch` is the sketch stage of the quant path.  On a CUDA tensor
it launches the hand-written kernel (or raises); on a CPU tensor it runs
the kernel's plain PyTorch version, sketch/fracminhash.sketch_batch.
Both return exactly the same hashes, mask and overflow count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sketch_rna_tpu_torch import kernels
from sketch_rna_tpu_torch.hash.nthash import window_tables_u32
from sketch_rna_tpu_torch.sketch.fracminhash import fracminhash_threshold, sketch_batch

# One sorted lane per thread of a block; reads past ~1 kb need the
# hash-only kernel K3 (ROADMAP Queue 2).
MAX_WINDOWS = 1024


@functools.lru_cache(maxsize=None)
def _device_tables(k: int, device: torch.device) -> torch.Tensor:
    """[k, 4] rotated-seed table as int32 bits (the kernel reads uint32)."""
    return torch.from_numpy(window_tables_u32(k).view(np.int32).copy()).to(device)


def fused_sketch(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    fraction: float,
    capacity: int,
):
    """Sketch a padded read batch for one k (see sketch_batch).

    codes: [B, L] uint8, lengths: [B] int32, on one device.
    Returns (hashes [B, capacity] int64 holding uint32 values, mask
    [B, capacity] bool, n_overflow [] int64).
    """
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be a [B, L] uint8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    B, L = codes.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise TypeError(f"lengths must be a [{B}] int32 tensor, got {lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != codes.device:
        raise ValueError("codes and lengths must be on one device")
    nk = L - k + 1
    if nk < 1 or capacity < 1:
        raise ValueError(f"need L >= k and capacity >= 1 (L={L}, k={k}, capacity={capacity})")
    nk_pad = 1 << (nk - 1).bit_length()
    if nk_pad > MAX_WINDOWS:
        raise ValueError(
            f"{nk} windows per read exceed the fused sketch kernel's {MAX_WINDOWS}; "
            "reads this long need the hash-only kernel K3 (ROADMAP Queue 2)"
        )
    if codes.device.type == "cpu":
        return sketch_batch(codes, lengths, k, fraction, capacity)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if not (codes.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")

    hashes = torch.empty((B, capacity), dtype=torch.int64, device=codes.device)
    mask = torch.empty((B, capacity), dtype=torch.bool, device=codes.device)
    overflow = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B:
        err = kernels.library().fused_sketch_launch(
            codes.data_ptr(),
            lengths.data_ptr(),
            _device_tables(k, codes.device).data_ptr(),
            hashes.data_ptr(),
            mask.data_ptr(),
            overflow.data_ptr(),
            B,
            L,
            k,
            fracminhash_threshold(fraction),
            capacity,
            nk_pad,
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
        kernels.check(err, "fused_sketch")
        fused_sketch.launches += 1
    return hashes, mask, overflow.sum(dtype=torch.int64)


fused_sketch.launches = 0  # kernel launches since the last reset
