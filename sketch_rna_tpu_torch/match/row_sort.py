"""Wrapper of the row sort kernel K4 (csrc/row_sort.cu).

`row_sort` sorts every row of a [B, W] int32 or int64 tensor ascending,
W a power of two from 2 to 16384.  On a CUDA tensor it launches the
hand-written bitonic kernel for that key type (or raises); on a CPU
tensor it runs the plain version, `row_sort_plain`.  The int64 instance
is the key+payload sort: a (key << 32) | payload row sorts exactly as
(key, payload) when both halves fit in 32 bits.

`merge_pairs` merges the two ascending halves of every row of a [N, 2w]
tensor: on a CUDA tensor the hand-written merge kernel (csrc/merge.cu:
a bitonic merge in registers for rows up to REGISTER_MERGE_MAX_WIDTH
lanes; past that `merge_staged`: `merge_partition`'s launch, which finds
every tile's split of the two runs, then a staged merge path over the
tiles), on a CPU tensor its plain version, `bitonic_merge_pair`.  `merge_sorted_runs`
merges a row's sorted w-lane runs by rounds of it, and `row_sort_wide`
sorts rows of any power-of-two width: one K4 launch over the 16384-lane
chunks, then one merge per doubling.
"""

from __future__ import annotations

import torch

from sketch_rna_tpu_torch import kernels

MIN_WIDTH = 2
MAX_WIDTH = 1 << 14  # 64 KB of shared memory per int32 row, 128 KB per int64 row

_LAUNCH = {torch.int32: "row_sort_launch", torch.int64: "row_sort_i64_launch"}
_MERGE_REGISTER = {torch.int32: "merge_register_launch", torch.int64: "merge_register_i64_launch"}
_MERGE_PARTITION = {torch.int32: "merge_partition_launch", torch.int64: "merge_partition_i64_launch"}
_MERGE_TILES = {torch.int32: "merge_tiles_launch", torch.int64: "merge_tiles_i64_launch"}
# Rows up to this many lanes merge in registers (csrc/merge.cu's
# kRegisterMaxWidth, the widest row that kernel takes); wider rows take
# merge_staged.
REGISTER_MERGE_MAX_WIDTH = 1024


def row_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4."""
    return torch.sort(x, dim=-1).values


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of every row of x ([B, W] int32 or int64, W a power of two)."""
    if x.dtype not in _LAUNCH:
        raise TypeError(f"row_sort takes int32 or int64, got {x.dtype}")
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
        name = _LAUNCH[x.dtype]
        err = getattr(kernels.library(), name)(
            x.data_ptr(),
            out.data_ptr(),
            B,
            W,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        kernels.check(err, name)
        if x.dtype == torch.int32:
            row_sort.launches += 1
        else:
            row_sort.launches_i64 += 1
    return out


def bitonic_merge_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two row-wise ascending [B, w] rows (w a power of two) into
    one sorted [B, 2w] row: reverse b, making each row bitonic, then run
    the log2(2w) compare-exchange stages of a bitonic merge."""
    B, w = a.shape
    x = torch.cat([a, b.flip(1)], dim=1)
    n = 2 * w
    d = w
    while d >= 1:
        y = x.view(B, n // (2 * d), 2, d)
        lo = torch.minimum(y[:, :, 0], y[:, :, 1])
        hi = torch.maximum(y[:, :, 0], y[:, :, 1])
        x = torch.stack((lo, hi), dim=2).reshape(B, n)
        d //= 2
    return x


def _check_merge_input(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _MERGE_REGISTER:
        raise TypeError(f"{name} takes int32 or int64, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes [N, 2w], got {tuple(x.shape)}")
    N, W = x.shape
    if W < 2 or W & (W - 1):
        raise ValueError(f"row width {W} is not a power of two >= 2")
    if N * W >= 1 << 40 or N >= 1 << 31:
        raise ValueError(f"[{N}, {W}] exceeds the kernel's index range")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def merge_tile(dtype: torch.dtype) -> int:
    """Outputs one block of the staged merge path merges at a time."""
    return kernels.library().merge_tile_outputs(torch.empty((), dtype=dtype).element_size())


def merge_partition_plain(x: torch.Tensor, tile: int) -> torch.Tensor:
    """The plain version of the partition launch: for every row of x
    ([N, 2w], two ascending runs a and b) and every tile boundary
    d = min(k * tile, 2w), k = 0 .. ceil(2w / tile), the number of a-keys
    among the first d outputs of the row's merge, ties from a.
    [N, ceil(2w / tile) + 1] int32."""
    N, W = x.shape
    w = W // 2
    a, b = x[:, :w].contiguous(), x[:, w:].contiguous()
    # a[i]'s output position: i plus the b-keys strictly below it.
    pos = torch.arange(w, device=x.device) + torch.searchsorted(b, a, side="left")
    d = (torch.arange(-(-W // tile) + 1, device=x.device) * tile).clamp(max=W)
    return torch.searchsorted(pos, d.expand(N, -1).contiguous(), side="left").to(torch.int32)


def merge_partition(x: torch.Tensor, tile: int) -> torch.Tensor:
    """merge_partition_plain's splits of x ([N, 2w] int32 or int64, two
    ascending runs a row): on a CUDA tensor one kernel launch, a thread
    a boundary; on a CPU tensor the plain version."""
    _check_merge_input(x, "merge_partition")
    if not 1 <= tile < 1 << 31:
        raise ValueError(f"tile {tile} is not in [1, 2^31)")
    if x.device.type == "cpu":
        return merge_partition_plain(x, tile)
    N, W = x.shape
    splits = torch.empty((N, -(-W // tile) + 1), dtype=torch.int32, device=x.device)
    if N:
        name = _MERGE_PARTITION[x.dtype]
        err = getattr(kernels.library(), name)(
            x.data_ptr(), splits.data_ptr(), N, W, tile, torch.cuda.current_stream(x.device).cuda_stream
        )
        kernels.check(err, name)
        merge_partition.launches += 1
    return splits


def merge_staged(x: torch.Tensor) -> torch.Tensor:
    """merge_pairs' route for rows wider than REGISTER_MERGE_MAX_WIDTH,
    at any width: on a CUDA tensor the partition launch, then the staged
    merge path over its tiles; on a CPU tensor bitonic_merge_pair."""
    _check_merge_input(x, "merge_staged")
    N, W = x.shape
    if x.device.type == "cpu":
        return bitonic_merge_pair(x[:, : W // 2], x[:, W // 2 :])
    out = torch.empty_like(x)
    if N:
        splits = merge_partition(x, merge_tile(x.dtype))
        name = _MERGE_TILES[x.dtype]
        err = getattr(kernels.library(), name)(
            x.data_ptr(), out.data_ptr(), splits.data_ptr(), N, W, torch.cuda.current_stream(x.device).cuda_stream
        )
        kernels.check(err, name)
    return out


def merge_pairs(x: torch.Tensor) -> torch.Tensor:
    """Merge the two ascending halves of every row of x ([N, 2w] int32 or
    int64, 2w a power of two >= 2) into one ascending row."""
    _check_merge_input(x, "merge_pairs")
    N, W = x.shape
    if x.device.type == "cpu":
        return bitonic_merge_pair(x[:, : W // 2], x[:, W // 2 :])
    if W > REGISTER_MERGE_MAX_WIDTH:
        out = merge_staged(x)
    else:
        out = torch.empty_like(x)
        if N:
            name = _MERGE_REGISTER[x.dtype]
            err = getattr(kernels.library(), name)(
                x.data_ptr(), out.data_ptr(), N, W, torch.cuda.current_stream(x.device).cuda_stream
            )
            kernels.check(err, name)
    if N:
        merge_pairs.launches += 1
    return out


def merge_sorted_runs(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sort every row of x ([B, W], W / w a power of two) whose aligned
    w-lane runs are each ascending: log2(W / w) rounds of merge_pairs."""
    B, W = x.shape
    y = x.contiguous()
    while w < W:
        y = merge_pairs(y.view(-1, 2 * w))
        w *= 2
    return y.view(B, W)


def row_sort_wide(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of every row of x ([B, W] int32 or int64, W any
    power of two >= 2): `row_sort` up to MAX_WIDTH lanes; past that, one
    K4 launch over the [B * W / MAX_WIDTH, MAX_WIDTH] chunks, then
    merge_sorted_runs."""
    if x.dim() != 2:
        raise ValueError(f"row_sort_wide takes [B, W], got {tuple(x.shape)}")
    B, W = x.shape
    if W <= MAX_WIDTH:
        return row_sort(x)
    if W & (W - 1):
        raise ValueError(f"row width {W} is not a power of two")
    return merge_sorted_runs(row_sort(x.contiguous().view(-1, MAX_WIDTH)).view(B, W), MAX_WIDTH)


# Kernel launches since the last reset, per kernel and key type.
row_sort.launches = 0
row_sort.launches_i64 = 0
merge_pairs.launches = 0  # calls that launched the merge (one or two launches each)
merge_partition.launches = 0
