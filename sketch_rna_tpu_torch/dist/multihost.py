"""Sharded quant where each rank process supplies its own read slice.

The counterpart of sketch_rna_tpu/dist/multihost.py.  Each rank parses
only a byte range of the FASTQ (io/fastq.byte_range_for_process) and
packs it locally.  The ranks of one index group must hold the same
reads, so rank (d, i) reads byte range d of dp, not range r of the world
(data_shard_range); each of the ip ranks of the group parses that range
itself, and nothing is broadcast: parsing a range twice costs less than
shipping packed reads between processes that may share no memory.

One small control-plane exchange gives the global read count: each
rank's local count, MAX over its index group (which also checks that the
peers agree) and SUM over its data group.  The JAX function also takes a
common pad width and chunk count from it, because its SPMD program needs
equal shapes on every device; here no collective of the chunk loop
crosses data shards (dist/quant_stream.py), so each data shard keeps its
own widths and runs its own number of batches.

Duplicate read IDs: the reference's rule (the last valid occurrence
wins, src/main.cpp:150) applies within each rank's slice; a duplicate ID
whose records fall into different slices is kept twice.  Real FASTQ read
IDs are unique, so this deviation is theoretical (docs/PARITY.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.dist.collectives import all_reduce_max, all_reduce_sum
from sketch_rna_tpu_torch.dist.mesh import Mesh
from sketch_rna_tpu_torch.index.artifact import DeviceIndex
from sketch_rna_tpu_torch.io.packing import PackedReads


def data_shard_range(path: str, mesh: Mesh) -> Tuple[int, int]:
    """The byte range of `path` that this rank parses: part d of dp."""
    from sketch_rna_tpu_torch.io.fastq import byte_range_for_process

    return byte_range_for_process(path, mesh.d, mesh.dp)


def global_num_reads(local_reads: int, mesh: Mesh) -> int:
    """The mesh's read count from each rank's local one (collective).
    Raises, on every rank of the group, when index-group peers disagree."""
    counts = torch.tensor([local_reads, -local_reads], dtype=torch.int64, device=mesh.device)
    hi, neg_lo = all_reduce_max(counts, mesh.index_group).tolist()
    if hi != -neg_lo:
        raise ValueError(f"ranks of index group {mesh.d} hold between {-neg_lo} and {hi} reads; they must hold "
                         "the same reads (byte range d of dp)")
    return int(all_reduce_sum(counts[:1], mesh.data_group)[0])


def quantify_sharded_multihost(
    index: DeviceIndex,
    local_packed: PackedReads,
    config: Optional[QuantConfig],
    mesh: Mesh,
):
    """Sharded streaming quant over this rank's own read slice.

    index: the rank's index shard (index/shard.shard_to_device).  Every
    rank of the mesh calls this collectively, with the same config.
    Returns the replicated QuantResult on every rank; a global read count
    of 0 gives the empty result everywhere.
    """
    from sketch_rna_tpu_torch.dist.quant_stream import quantify_rank
    from sketch_rna_tpu_torch.pipeline import _empty_result

    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    num_reads = global_num_reads(local_packed.num_reads, mesh)
    if num_reads == 0:
        return _empty_result(index)
    return quantify_rank(index, local_packed, config, mesh, num_reads)
