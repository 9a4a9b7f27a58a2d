"""Wrapper of the row sort kernel K4 (csrc/row_sort.cu).

`row_sort` sorts every row of a [B, W] int32 tensor ascending, W a power
of two from 2 to 16384.  On a CUDA tensor it launches the hand-written
bitonic kernel (or raises); on a CPU tensor it runs the plain version,
`row_sort_plain`.
"""

from __future__ import annotations

import torch

from sketch_rna_tpu_torch import kernels

MIN_WIDTH = 2
MAX_WIDTH = 1 << 14  # 64 KB of shared memory per row


def row_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4."""
    return torch.sort(x, dim=-1).values


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of every row of x ([B, W] int32, W a power of two)."""
    if x.dtype != torch.int32:
        raise TypeError(f"row_sort takes int32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"row_sort takes [B, W], got {tuple(x.shape)}")
    B, W = x.shape
    if W & (W - 1) or not MIN_WIDTH <= W <= MAX_WIDTH:
        raise ValueError(f"row width {W} is not a power of two in [{MIN_WIDTH}, {MAX_WIDTH}]")
    if B >= (1 << 31) - 4096:
        raise ValueError(f"{B} rows exceed the kernel's int32 row count")
    if not x.is_contiguous():
        raise ValueError("row_sort takes a contiguous tensor")
    if x.device.type == "cpu":
        return row_sort_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    if B:
        err = kernels.library().row_sort_launch(
            x.data_ptr(),
            out.data_ptr(),
            B,
            W,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        kernels.check(err, "row_sort")
        row_sort.launches += 1
    return out


row_sort.launches = 0  # kernel launches since the last reset
