"""The whole-batch sharded quant step: sketch -> match -> EM -> assignment
over a (data, index) mesh, with no chunks and no class buffer.

The counterpart of sketch_rna_tpu/dist/quant_sharded.py, kept as it is
there as the simplest complete statement of the collectives; a test holds
it to the single-device path, and the CLI runs the streamed engine
(dist/quant_stream.py).  Per rank (d, i):

  1. sketch the rank's reads (local compute);
  2. probe and expand against the LOCAL index shard: a hash another
     shard owns does not match here;
  3. gather the event lanes across the index group, so every rank holds
     all events of its reads;
  4. group into per-read candidate tables (local compute);
  5. EM: the per-transcript posterior sums all-reduce over the data
     group each iteration, pi replicated;
  6. soft assignment with the final pi, again summed over the data group.

Not ported from the JAX step: the static expand_per_read width (the
port sizes each row exactly from one host read, all-reduced MAX over the
index group) and the MXU switch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.dist.collectives import all_reduce_sum
from sketch_rna_tpu_torch.dist.mesh import Mesh
from sketch_rna_tpu_torch.dist.quant_stream import match_batch_sharded
from sketch_rna_tpu_torch.em.em import assign_reads_tables, run_em_tables
from sketch_rna_tpu_torch.index.artifact import DeviceIndex


def quant_step_sharded(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    index: DeviceIndex,
    num_reads: int,
    config: QuantConfig,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, Dict[str, int]]:
    """One rank's part of the step (collective over the mesh).

    codes [Bl, L] uint8 / lengths [Bl] int32: the rows of data shard d,
    the same on every rank of its index group, on mesh.device (rows of
    length 0 are padding); index: the rank's index shard; num_reads: the
    global read count.  Returns (pi [T], weighted counts [T], has_entry
    [T], iterations, stats): replicated within a data group.  stats:
    expand_dropped summed over both axes, sketch_overflow and
    candidate_spilled over the data axis (index peers hold the same).
    """
    caps = tuple(config.sketch_capacity_for(k, codes.shape[1]) for k in index.kmer_lengths)
    res = match_batch_sharded(codes, lengths, index, config, caps, index_group=mesh.index_group)
    table = [(res.tid, res.score, None)]
    T = index.num_transcripts
    pi, iterations, _ = run_em_tables(
        table,
        num_reads,
        num_transcripts=T,
        max_iterations=config.em_max_iterations,
        convergence_threshold=config.em_convergence,
        pseudocount=config.pseudocount,
        epsilon=config.em_epsilon,
        dtype=config.em_dtype,
        group=mesh.data_group,
    )
    weighted, has_entry = assign_reads_tables(table, pi, num_transcripts=T, dtype=config.em_dtype,
                                              group=mesh.data_group)
    local = torch.stack([torch.as_tensor(res.stats[key], device=mesh.device).long()
                         for key in ("expand_dropped", "sketch_overflow", "candidate_spilled")])
    local[:1] = all_reduce_sum(local[:1], mesh.index_group)
    total = all_reduce_sum(local, mesh.data_group).tolist()
    stats = dict(zip(("expand_dropped", "sketch_overflow", "candidate_spilled"), total))
    return pi, weighted, has_entry, iterations, stats
