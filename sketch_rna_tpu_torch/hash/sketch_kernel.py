"""Wrappers of the fused sketch kernels K1 and K2 (csrc/sketch.cu).

`fused_sketch` sketches one k (K1), `fused_sketch_multik` every k of a
list over one load of the codes (K2).  On a CUDA tensor each launches its
hand-written kernel (or raises); on a CPU tensor each runs its plain
PyTorch version, sketch/fracminhash.sketch_batch and sketch_all_k.  Both
return exactly the same hashes, masks and overflow counts.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from sketch_rna_tpu_torch import kernels
from sketch_rna_tpu_torch.sketch.fracminhash import fracminhash_threshold, sketch_all_k, sketch_batch

# Windows per read (padded to a power of two) that a warp's shared buffer
# holds; longer reads take the hash-plane kernel K3 and a K4 dedup
# (sketch/dispatch.py).
MAX_WINDOWS = 1024
MAX_KS = 8  # ks per K2 launch (csrc/sketch.cu kMaxKs)


def check_batch(codes: torch.Tensor, lengths: torch.Tensor) -> None:
    """Raise unless codes [B, L] uint8 and lengths [B] int32 are one
    device's tensors that a kernel (or its plain version) takes."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be a [B, L] uint8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    B = codes.shape[0]
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise TypeError(f"lengths must be a [{B}] int32 tensor, got {lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != codes.device:
        raise ValueError("codes and lengths must be on one device")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    if codes.device.type == "cuda" and not (codes.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")


def window_pad(L: int, k: int) -> int:
    """Windows per read rounded up to a power of two (the sort width)."""
    nk = L - k + 1
    if nk < 1:
        raise ValueError(f"need L >= k (L={L}, k={k})")
    return 1 << (nk - 1).bit_length()


def _check_windows(L: int, k: int) -> None:
    if window_pad(L, k) > MAX_WINDOWS:
        raise ValueError(
            f"{L - k + 1} windows per read exceed the fused sketch kernels' {MAX_WINDOWS}; "
            "longer reads take the hash-plane kernel K3 and a K4 dedup (sketch.dispatch.sketch_reads)"
        )


def _outputs(B: int, capacity: int, device: torch.device):
    return (
        torch.empty((B, capacity), dtype=torch.int64, device=device),
        torch.empty((B, capacity), dtype=torch.bool, device=device),
        torch.empty(B, dtype=torch.int32, device=device),
    )


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
    check_batch(codes, lengths)
    B, L = codes.shape
    _check_windows(L, k)
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if codes.device.type == "cpu":
        return sketch_batch(codes, lengths, k, fraction, capacity)
    hashes, mask, overflow = _outputs(B, capacity, codes.device)
    if B:
        err = kernels.library().fused_sketch_launch(
            codes.data_ptr(),
            lengths.data_ptr(),
            hashes.data_ptr(),
            mask.data_ptr(),
            overflow.data_ptr(),
            B,
            L,
            k,
            fracminhash_threshold(fraction),
            capacity,
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
        kernels.check(err, "fused_sketch")
        fused_sketch.launches += 1
    return hashes, mask, overflow.sum(dtype=torch.int64)


fused_sketch.launches = 0  # kernel launches since the last reset


def fused_sketch_multik(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    ks: Sequence[int],
    fraction: float,
    caps: Sequence[int],
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Sketch a padded read batch for every k in ks, one capacity each:
    [(hashes, mask, n_overflow)] per k, each exactly sketch_batch's."""
    check_batch(codes, lengths)
    B, L = codes.shape
    ks, caps = tuple(ks), tuple(caps)
    if not 1 <= len(ks) <= MAX_KS or len(caps) != len(ks):
        raise ValueError(f"need 1 to {MAX_KS} ks and one capacity per k, got ks={ks} caps={caps}")
    for k in ks:
        _check_windows(L, k)
    if min(caps) < 1:
        raise ValueError(f"capacities must be >= 1, got {caps}")
    if codes.device.type == "cpu":
        return sketch_all_k(codes, lengths, ks, fraction, caps)
    outs = [_outputs(B, cap, codes.device) for cap in caps]
    if B:
        n = len(ks)
        ints = ctypes.c_int * n
        ptrs = ctypes.c_void_p * n
        err = kernels.library().fused_sketch_multik_launch(
            codes.data_ptr(),
            lengths.data_ptr(),
            n,
            ints(*ks),
            ints(*caps),
            ptrs(*(h.data_ptr() for h, _, _ in outs)),
            ptrs(*(m.data_ptr() for _, m, _ in outs)),
            ptrs(*(o.data_ptr() for _, _, o in outs)),
            B,
            L,
            fracminhash_threshold(fraction),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
        kernels.check(err, "fused_sketch_multik")
        fused_sketch_multik.launches += 1
    return [(h, m, o.sum(dtype=torch.int64)) for h, m, o in outs]


fused_sketch_multik.launches = 0  # kernel launches since the last reset
