"""The (data, index) mesh of rank processes.

The two parallel axes of sketch_rna_tpu/dist/mesh.py:
  "data"  — reads are embarrassingly parallel; each data shard matches
            its own reads, and the EM all-reduces its per-transcript sums;
  "index" — the hash-range-sharded index (index/shard.py); the ranks of
            one index group hold the same reads and one index shard each,
            and gather their match events before grouping.

A JAX process drives many devices; PyTorch runs one process per GPU.  So
a mesh here is a layout of torch.distributed ranks: rank r sits at
(d, i) = (r // ip, r % ip), as np.array(devices).reshape(n_data, n_index)
lays the JAX devices out, and holds two sub-groups: its index group (the
ranks with its d) and its data group (the ranks with its i).  A group of
one is None: the collectives (dist/collectives.py) are then the
identity, so mesh (1, 1) needs no process group at all.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch

# Device memory one full index replica may take before the mesh chooser
# widens the index axis.  Default: a quarter of an H100's 80 GB; the rest
# stays free for read chunks, event rows and the class buffer.  Override
# with SKETCH_TPU_INDEX_HBM_BUDGET (bytes), the JAX package's variable.
DEFAULT_INDEX_HBM_BUDGET = 20 << 30


def index_device_bytes(index) -> int:
    """Bytes of one full replica of an IndexArtifact as to_device lays it
    out: per k, keys and row_ptr as int64 and postings as int32 (the port
    has no bucket tables).  Shape-only: nothing is allocated."""
    total = 0
    for k in index.kmer_lengths:
        ki = index.per_k[k]
        total += 8 * ki.num_keys + 8 * (ki.num_keys + 1) + 4 * int(ki.postings.shape[0])
    return total


def mesh_factor(
    n_devices: int,
    max_index_shards: int = 2,
    index_bytes: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
) -> Tuple[int, int]:
    """Split n devices into (data, index) axis sizes, exactly as the JAX
    package's mesh_factor does.

    Data parallelism dominates: the index axis doubles only while it
    stays <= max_index_shards, divides the device count, and leaves the
    data axis at least as large.  index_bytes (index_device_bytes) widens
    the cap: when a full replica exceeds the per-device budget, the index
    axis grows to the smallest divisor whose share fits — a fit
    requirement, so it overrides the preference for a large data axis."""
    index = 1
    if index_bytes is not None and n_devices > 1:
        budget = hbm_budget_bytes or int(os.environ.get("SKETCH_TPU_INDEX_HBM_BUDGET", DEFAULT_INDEX_HBM_BUDGET))
        for d in range(1, n_devices + 1):
            if n_devices % d == 0:
                index = d
                if index_bytes / d <= budget:
                    break
        max_index_shards = max(max_index_shards, index)
    while (
        index * 2 <= max_index_shards
        and n_devices % (index * 2) == 0
        and n_devices // (index * 2) >= index * 2
    ):
        index *= 2
    return n_devices // index, index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, ip) mesh, its device and its groups."""

    dp: int
    ip: int
    rank: int
    device: torch.device
    index_group: Optional[Any] = None  # ranks with this d; None when ip == 1
    data_group: Optional[Any] = None  # ranks with this i; None when dp == 1
    world_group: Optional[Any] = None  # every rank; None when dp * ip == 1
    backend: str = "none"

    @property
    def d(self) -> int:
        return self.rank // self.ip

    @property
    def i(self) -> int:
        return self.rank % self.ip

    @property
    def world_size(self) -> int:
        return self.dp * self.ip

    def describe(self) -> str:
        return f"dp={self.dp}, ip={self.ip}, {self.backend}"


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_data: int, n_index: int = 1, device=None) -> Mesh:
    """The mesh of every rank of the process group, n_data x n_index of
    them.  A collective call: every rank makes the same mesh, since
    torch.distributed.new_group must run on all ranks in one order.
    device: this rank's compute device (default: init.rank_device())."""
    import torch.distributed as dist

    from sketch_rna_tpu_torch.dist.init import rank_device

    rank, size = world()
    if n_data * n_index != size:
        raise ValueError(f"a {n_data} x {n_index} mesh needs {n_data * n_index} ranks, the process group has {size}")
    device = torch.device(device) if device is not None else rank_device()
    if size == 1:
        return Mesh(1, 1, 0, device)
    d, i = rank // n_index, rank % n_index
    index_group = data_group = None
    if n_index > 1:
        for row in range(n_data):
            group = dist.new_group([row * n_index + col for col in range(n_index)])
            if row == d:
                index_group = group
    if n_data > 1:
        for col in range(n_index):
            group = dist.new_group([row * n_index + col for row in range(n_data)])
            if col == i:
                data_group = group
    return Mesh(n_data, n_index, rank, device, index_group, data_group, dist.group.WORLD, dist.get_backend())
