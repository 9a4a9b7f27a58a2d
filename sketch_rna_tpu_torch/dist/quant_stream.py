"""The sharded quant engine: what one rank (d, i) of a (data, index) mesh runs.

The counterpart of sketch_rna_tpu/dist/quant_stream.py, built on the
port's streamed engine (stream.py):

  match   per batch of the rank's reads (match_batch_sharded): sketch
          (K1 / K2; K3 past 1024 windows), probe the LOCAL index shard
          (match/probe.py's binary search, as the JAX shard_map route
          probes with lookup_postings: a shard carries no bucket table),
          expand, gather the event lanes across the index group, group
          merged into top-C candidates;
  classes each chunk's rows pre-dedup into weighted classes and append to
          the rank's own class buffer (stream.stream_classes), which
          compacts and drains to its own host with no collective;
  counts  one all-reduce MAX (the widest candidate set) and one
          all-reduce SUM (read counts and loss stats) over the mesh;
  EM      over the rank's classes, which the rank splits into width tiers
          itself (stream.classes_em), the per-transcript sums all-reduced
          over the data group each iteration (em/em.py).

What keeps the ranks in step:

  - Ranks of one index group hold the same reads, so pipeline.match_rows
    gives them the same batches in the same order, and each batch runs
    two collectives over the index group: an all-reduce MAX of the
    batch's largest per-read event total per k, folded into the host read
    the batch already has (every rank then expands to the same widths,
    which a gather needs), and the gather of the event lanes.
  - A read's events for one (tid, k) are spread over the shards, so per-k
    tables cannot pre-group: the gathered ip x K parts of packed
    tid * K + k keys always group merged (one K4 launch over the parts,
    then rounds of the merge kernel), which truncates only the final
    candidate set.  The per-k spill regroup has nothing to do here and
    candidate_spilled_per_k stays 0.
  - Nothing in the chunk loop is a collective over the data group: data
    shards may run different numbers of batches.
  - Index-group peers gather identical event rows, so their class buffers
    are identical; every column i of the mesh runs the same EM over its
    own data group, with no collective between columns, so a column
    cannot wait on another.  Within a data group every rank reads the
    same all-reduced pi and stops on the same iteration.  On a card the
    index_add_ atomics of two columns may differ in the last place (the
    scatter route, --em-segsum off; segsum, a card's default, sums in a
    fixed order), so the result of column 0 is handed to its index-group
    peers at the end (an all-reduce SUM with zeros from the others):
    every rank returns the same QuantResult.

Each rank tiers its own classes as the fused engine does
(em/classes.py tier_partition), the pair tier included: the JAX sharded
plan has none, and the result is exact either way, since a tier only
drops lanes that are zero.  The tiers' row counts differ between ranks,
which only the JAX package's static shapes had to share.  Not ported,
because the port's exact event widths and draining class buffer make
them unnecessary: the matcher's tier calibration and
shared_tier_widths, the tier key psum and the pretail /
expansion-doubling / full-bound reruns.  The EM honours config.em_segsum
(pipeline.em_assign), each rank planning over its own tiers.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, Sequence

import numpy as np
import torch

from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.dist.collectives import all_reduce_max, all_reduce_sum, gather_lanes, read_max
from sketch_rna_tpu_torch.dist.mesh import Mesh
from sketch_rna_tpu_torch.index.artifact import DeviceIndex
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.match.probe import probe
from sketch_rna_tpu_torch.match.row_sort import row_sort_wide
from sketch_rna_tpu_torch.match.rowmatch import (
    I32_MAX,
    MatchResult,
    match_runs,
    row_events_to_candidates,
    row_expand_from_runs,
)
from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads
from sketch_rna_tpu_torch.utils.timing import restart

log = logging.getLogger(__name__)

# Counts that index-group peers hold identically (they match the same
# reads): one peer contributes them to the mesh-wide sum.  expand_dropped
# (always 0) sums over both axes.
_REPLICATED = ("sketch_overflow", "candidate_spilled", "candidate_spilled_per_k", "wide_spilled", "class_overflow",
               "num_mapped")


def match_batch_sharded(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    index: DeviceIndex,
    config: QuantConfig,
    sketch_caps: Sequence[int],
    *,
    index_group=None,
    sketch=sketch_reads,
    sort=row_sort_wide,
) -> MatchResult:
    """One batch on one rank: pipeline.sketch_match_step against the
    rank's index shard, with the cross-shard event merge.

    Every rank of index_group calls this with the same reads.  The event
    rows hold packed tid * K + k keys; a k's row has the same width on
    every rank (the group's largest per-read event total, pow2), so the
    gathered row splits back into ip x K parts that sort_event_parts
    sorts and merges.  The group's per-read totals, all-reduced MAX, cut
    the same row slices on every rank (match_runs).
    """
    ks = tuple(index.kmer_lengths)
    K = len(ks)
    sketches = sketch(codes, lengths, ks, config.sketch_fraction, sketch_caps)
    runs = [probe(h, m, index.per_k[k].keys, index.per_k[k].row_ptr) for (h, m, _), k in zip(sketches, ks)]

    def group(runs, sizes):
        parts = []
        for ki, ((start, length), k, size) in enumerate(zip(runs, ks, sizes)):
            key = row_expand_from_runs(start, length, index.per_k[k].postings, sizes=size)
            parts.append(torch.where(key != I32_MAX, key * K + ki, I32_MAX) if K > 1 else key)
        widths = [p.shape[1] for p in parts]
        row = gather_lanes(torch.cat(parts, dim=1) if K > 1 else parts[0], index_group)
        parts = list(torch.split(row, widths * (row.shape[1] // sum(widths)), dim=1))
        res = row_events_to_candidates(
            parts if len(parts) > 1 else parts[0],
            num_k=K,
            chain_fraction=config.chain_fraction,
            candidate_capacity=config.candidate_capacity,
            num_transcripts=index.num_transcripts,
            sort=sort,
        )
        res.stats["candidate_spilled_per_k"] = torch.zeros((), dtype=torch.int64, device=res.tid.device)
        return res

    # One host read a batch (more only when it is cut into slices).
    res = match_runs(runs, config.batch_size, group, lambda x, n: read_max(x, n, index_group))
    res.stats["sketch_overflow"] = sum(ov for _, _, ov in sketches)
    res.stats["expand_dropped"] = torch.zeros((), dtype=torch.int64, device=codes.device)
    return res


def mesh_counts(mesh: Mesh, n_cand_max: int, counts: Dict[str, int]) -> tuple:
    """(n_cand_max, counts) over the whole mesh, in two small all-reduces:
    MAX of n_cand_max, SUM of the counts.  A count named in _REPLICATED
    is taken from index rank 0 alone (its peers hold the same number), so
    it comes out as max over index, sum over data; the others sum over
    both axes."""
    if mesh.world_group is None:
        return n_cand_max, dict(counts)
    keys = sorted(counts)
    mine = [counts[k] if (mesh.i == 0 or k not in _REPLICATED) else 0 for k in keys]
    ncm = all_reduce_max(torch.tensor([n_cand_max], dtype=torch.int64, device=mesh.device), mesh.world_group)
    total = all_reduce_sum(torch.tensor(mine, dtype=torch.int64, device=mesh.device), mesh.world_group)
    return int(ncm[0]), dict(zip(keys, total.tolist()))


def _replicate_from_column0(result, mesh: Mesh) -> None:
    """Hand index rank 0's result to its index-group peers, in place."""
    if mesh.index_group is None:
        return
    T = result.pi.shape[0]
    flat = np.concatenate([result.pi, result.weighted_counts, result.has_entry.astype(result.pi.dtype),
                           [result.em_iterations]]).astype(np.float64)
    if mesh.i != 0:
        flat[:] = 0.0
    flat = all_reduce_sum(torch.from_numpy(flat).to(mesh.device), mesh.index_group).cpu().numpy()
    result.pi = flat[:T].astype(result.pi.dtype)
    result.weighted_counts = flat[T : 2 * T].astype(result.weighted_counts.dtype)
    result.has_entry = flat[2 * T : 3 * T] > 0
    result.em_iterations = int(flat[3 * T])


def quantify_rank(index: DeviceIndex, reads: PackedReads, config: QuantConfig, mesh: Mesh, num_reads: int):
    """Run this rank's share of a sharded quant (collective: every rank of
    the mesh calls it).

    index: the rank's index shard, on mesh.device (index/shard.py).
    reads: the reads of the rank's data shard d, the same on every rank
    of its index group.  num_reads: the global read count, > 0.  Returns
    the replicated QuantResult; timing holds this rank's stages,
    stream_drains / stream_compactions / stream_classes this rank's
    buffers.  config.em_checkpoint is refused on more than one rank.
    """
    from sketch_rna_tpu_torch.pipeline import match_rows
    from sketch_rna_tpu_torch.stream import classes_em, stream_classes, stream_retry_config

    if config.em_checkpoint and mesh.world_group is not None:
        raise ValueError("EM checkpoints are not supported across rank processes: every rank would race for one file")
    # Always grouped merged (module docstring); match_rows then regroups nothing.
    config = dataclasses.replace(config, match_per_k_tables=False)
    step = functools.partial(match_batch_sharded, index_group=mesh.index_group)
    classes = stream_classes(index, reads, config, None, match=functools.partial(match_rows, step=step))
    n_cand_max, counts = mesh_counts(mesh, classes.n_cand_max, dict(classes.stats, num_mapped=classes.num_mapped))
    num_mapped = counts.pop("num_mapped")
    # The reduced stats are the same on every rank, so all take this
    # branch together.
    retry_cfg, reason = stream_retry_config(config, counts)
    if retry_cfg is not None:
        log.warning("sharded streaming match %s; rerunning", reason)
        restart()
        return quantify_rank(index, reads, retry_cfg, mesh, num_reads)
    classes = dataclasses.replace(classes, num_reads=num_reads, num_mapped=num_mapped, n_cand_max=n_cand_max,
                                  stats=counts)
    result = classes_em(classes, index, config, group=mesh.data_group)
    _replicate_from_column0(result, mesh)
    return result
