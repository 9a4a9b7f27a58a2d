"""Wrapper of the grouping kernel G (csrc/group.cu).

`group_rows` groups a batch's per-k event rows ([B, W_k] int32 tids,
INT32_MAX past a read's events, as kernel E leaves them) into top-C
candidate tables in one launch: tid and score [B, C] int32, mask [B, C]
bool, and a [2] int64 tensor of (candidate_spilled,
candidate_spilled_per_k).  Its tables and stats are exactly those of
rowmatch.group_event_parts_plain, the chain of K4 sorts and PyTorch
operations it replaces, at one k and at several ks with per-k tables.
The shapes are static and nothing is read to the host, so a step that
groups can be captured in a CUDA graph.

`group_kernel_takes` is the rule for which batches G groups, from what
the caller already knows on the host: the rows' widths, how many ks,
the K > 1 mode and the device.  rowmatch.group_event_parts follows it;
every other batch (wider rows, the merged K-wide regroup, CPU tensors)
takes the plain chain.  G has no CPU version: on a CPU tensor the plain
chain is the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from sketch_rna_tpu_torch import kernels

MAX_KS = 16  # csrc/group.cu kMaxKs
MAX_GROUP_WIDTH = 1024  # the widest row a warp sorts in registers (32 lanes x 32 keys)


def group_kernel_takes(widths: Sequence[int], per_k_tables: bool, device) -> bool:
    """Whether G groups a batch whose per-k event rows have these widths:
    on a card, 1 to MAX_KS ks, every row at most MAX_GROUP_WIDTH lanes,
    one k or several grouped per k (per_k_tables)."""
    return (torch.device(device).type == "cuda" and 1 <= len(widths) <= MAX_KS
            and max(widths) <= MAX_GROUP_WIDTH and (len(widths) == 1 or per_k_tables))


def group_rows(
    parts: Sequence[torch.Tensor],
    caps: Sequence[int],
    candidate_capacity: int,
    chain: Tuple[int, int, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch G over per-k [B, W_k] int32 event rows on one card.

    caps: each k's table size C_k before the intersection (read at K > 1).
    chain: (p, q, fraction): q > 0 tests count * q >= best * p in int32,
    else count >= fraction * best in float32 (rowmatch.chain_passes).
    Returns (tid, score, mask, stats), stats [2] int64 =
    (candidate_spilled, candidate_spilled_per_k)."""
    if not 1 <= len(parts) <= MAX_KS or len(caps) != len(parts):
        raise ValueError(f"need 1 to {MAX_KS} parts and a cap each, got {len(parts)} and {len(caps)}")
    B = parts[0].shape[0]
    device = parts[0].device
    for p in parts:
        if p.dtype != torch.int32 or p.dim() != 2 or p.shape[0] != B or p.device != device:
            raise TypeError(f"parts must be [B, W] int32 on one device, got {p.dtype} {tuple(p.shape)} on {p.device}")
        W = p.shape[1]
        if W < 2 or W > MAX_GROUP_WIDTH or W & (W - 1):
            raise ValueError(f"row width {W} is not a power of two in [2, {MAX_GROUP_WIDTH}]")
    if device.type != "cuda":
        raise ValueError(f"G runs on a CUDA device, not {device}")
    p_, q_, fraction = chain
    if not (-(2**31) <= p_ < 2**31 and 0 <= q_ < 2**31) or candidate_capacity < 1 or min(caps) < 1:
        raise ValueError(f"chain {chain}, capacity {candidate_capacity} or caps {tuple(caps)} out of range")
    C = candidate_capacity
    tid = torch.empty((B, C), dtype=torch.int32, device=device)
    score = torch.empty((B, C), dtype=torch.int32, device=device)
    mask = torch.empty((B, C), dtype=torch.bool, device=device)
    stats = torch.zeros(2, dtype=torch.int64, device=device)
    if B:
        rows = [p.contiguous() for p in parts]
        K = len(rows)
        ints = ctypes.c_int * K
        err = kernels.library().group_launch(
            (ctypes.c_void_p * K)(*(r.data_ptr() for r in rows)),
            ints(*(r.shape[1] for r in rows)),
            ints(*caps),
            K, B, C, p_, q_, fraction,
            tid.data_ptr(), score.data_ptr(), mask.data_ptr(), stats.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
        kernels.check(err, "group_launch")
        group_rows.launches += 1
    return tid, score, mask, stats


group_rows.launches = 0  # kernel launches since the last reset
