"""The collectives the sharded engine calls, over one group of a mesh.

  gather_lanes     every rank's [B, w] rows side by side, [B, n * w]
  all_reduce_sum   elementwise SUM over the group
  all_reduce_max   elementwise MAX over the group
  read_max         a small tensor read on the host, its leading entries
                   MAX-reduced: the one device sync of a match batch,
                   counted as match.host_reads (utils/timing.py)

A group of None is a group of one: the identity, no process group needed.
With NCCL the calls run torch.distributed on the CUDA tensors.  With gloo
and CUDA tensors they stage through pinned host memory, since gloo does
not all-gather CUDA tensors; this is the route of rank processes that
share one card.  Results come back on the input's device.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from sketch_rna_tpu_torch.utils.timing import HOST_READS, count, host_read


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    import torch.distributed as dist

    if group is None:
        return x
    if x.device.type == "cuda" and dist.get_backend(group) != "nccl":
        host = _to_host(x)
        dist.all_reduce(host, op=op, group=group)
        return host.to(x.device)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    return _all_reduce(x, group, dist.ReduceOp.MAX)


def gather_lanes(x: torch.Tensor, group) -> torch.Tensor:
    """[B, w] on every rank of the group -> [B, n * w]: the ranks' rows
    side by side in group-rank order (jax.lax.all_gather(axis=1,
    tiled=True)).  Every rank passes the same shape."""
    import torch.distributed as dist

    if group is None:
        return x
    n = dist.get_world_size(group)
    B, w = x.shape
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n, B, w), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    else:
        staged = x.device.type == "cuda"
        out = torch.empty((n, B, w), dtype=x.dtype, pin_memory=staged)
        dist.all_gather(list(out.unbind(0)), _to_host(x) if staged else x.contiguous(), group=group)
        out = out.to(x.device)
    return out.permute(1, 0, 2).reshape(B, n * w)


def read_max(x: torch.Tensor, n: int, group: Optional[object]) -> List[int]:
    """x (1-d, integer) as a host list, its first n entries all-reduced
    MAX over the group, in one device sync: NCCL reduces on the device
    before the read, gloo on the host after it."""
    import torch.distributed as dist

    if group is None:
        return host_read(x)
    if dist.get_backend(group) == "nccl":
        out = x.clone()
        dist.all_reduce(out[:n], op=dist.ReduceOp.MAX, group=group)
        return host_read(out)
    count(HOST_READS)
    host = x.to("cpu", copy=True)
    dist.all_reduce(host[:n], op=dist.ReduceOp.MAX, group=group)
    return host.tolist()
