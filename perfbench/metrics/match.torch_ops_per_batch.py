"""Torch operations the host dispatches a batch in the fused engine's
match stage: the top-level aten:: records of each traced sample from its
start to the end of its match stage (QuantResult.timing["match"] after
the span's start), over the sample's batches of batch_size reads a length
group."""

from perfbench.readers import length_groups
from perfbench.tracing import host_ops


def read(run):
    traced = run.traced()
    if not traced or len(run.spans) != len(traced):
        return None
    ks, B = run.config["quant"]["kmer_lengths"], run.config["quant"]["batch_size"]
    ops = batches = 0
    for s, (start, _) in zip(traced, run.spans):
        if "match" not in s.timing:
            return None
        end = start + s.timing["match"] * 1e6
        ops += host_ops(e for e in run.events if start <= e.start <= end)["torch_ops"]
        batches += sum(-(-rows // B) for rows, _ in length_groups(run.pool_lengths[s.pool], run.row_width, ks))
    return ops / batches if batches else None
