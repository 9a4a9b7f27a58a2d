"""Wrapper of the posting-expansion kernel E (csrc/expand.cu).

`row_expand` turns one k's posting runs, (start, length) [B, S] int64 as
the probe leaves them, into one row of event keys per read: key [B, W]
int32, the tids of the read's events in probe order, then INT32_MAX.  W
is the caller's (a power of two of at least MIN_WIDTH); the engines size
it to the batch's largest per-read event total, so no event falls past
it.  The shapes are static: nothing is read to the host and nothing
sized by the data is allocated, so a step that expands can be captured
in a CUDA graph.

On a CUDA tensor it launches the hand-written kernel (or raises); on a
CPU tensor it runs the plain version, `row_expand_plain`: the same
function in static torch ops (a cumsum, a batched searchsorted of each
lane into its row's run ends, a gather), the counterpart of
sketch_rna_tpu/match/rowmatch.py row_expand_from_runs at k_index 0 and
num_k 1.
"""

from __future__ import annotations

import torch

from sketch_rna_tpu_torch import kernels
from sketch_rna_tpu_torch.match.row_sort import MIN_WIDTH

I32_MAX = 2**31 - 1


def row_expand_plain(start: torch.Tensor, length: torch.Tensor, postings: torch.Tensor, W: int) -> torch.Tensor:
    """The plain PyTorch version of E: lane j of row b holds
    postings[start[b, s] + j - begin[b, s]], s the first run whose
    inclusive end passes j, for j below the row's event total (and W);
    INT32_MAX past it."""
    B, S = start.shape
    if B * S == 0 or postings.numel() == 0:  # no run, or runs that are all empty
        return torch.full((B, W), I32_MAX, dtype=torch.int32, device=start.device)
    ends = torch.cumsum(length, dim=1)
    j = torch.arange(W, dtype=torch.int64, device=start.device).expand(B, W).contiguous()
    slot = torch.searchsorted(ends, j, right=True).clamp_(max=S - 1)
    valid = j < ends[:, -1:]
    begin = ends.gather(1, slot) - length.gather(1, slot)
    pos = torch.where(valid, start.gather(1, slot) + (j - begin), 0)
    return torch.where(valid, postings[pos].to(torch.int32), I32_MAX)


def row_expand(start: torch.Tensor, length: torch.Tensor, postings: torch.Tensor, W: int) -> torch.Tensor:
    """[B, W] int32 event keys of posting runs (start, length) [B, S]
    int64 into postings [P] int32 (see row_expand_plain)."""
    if start.dtype != torch.int64 or length.dtype != torch.int64 or start.dim() != 2 or start.shape != length.shape:
        raise TypeError(f"row_expand takes int64 [B, S] start and length of one shape, got {start.dtype} "
                        f"{tuple(start.shape)} and {length.dtype} {tuple(length.shape)}")
    if postings.dtype != torch.int32 or postings.dim() != 1:
        raise TypeError(f"postings must be a [P] int32 tensor, got {postings.dtype} {tuple(postings.shape)}")
    if W < MIN_WIDTH or W & (W - 1):
        raise ValueError(f"row width {W} is not a power of two >= {MIN_WIDTH}")
    if not (start.device == length.device == postings.device):
        raise ValueError("start, length and postings must be on one device")
    if start.device.type == "cpu":
        return row_expand_plain(start, length, postings, W)
    if start.device.type != "cuda":
        raise ValueError(f"unsupported device {start.device}")
    B, S = start.shape
    if B >= 1 << 31 or W >= 1 << 31:
        raise ValueError(f"[{B}, {W}] exceeds the kernel's int32 row count and width")
    st, ln, post = start.contiguous(), length.contiguous(), postings.contiguous()
    key = torch.empty((B, W), dtype=torch.int32, device=start.device)
    if B:
        err = kernels.library().row_expand_launch(
            st.data_ptr(), ln.data_ptr(), post.data_ptr(), key.data_ptr(), B, S, W,
            torch.cuda.current_stream(start.device).cuda_stream,
        )
        kernels.check(err, "row_expand_launch")
        row_expand.launches += 1
    return key


row_expand.launches = 0  # kernel launches since the last reset
