"""Host milliseconds of the fused engine's eager phase 1 (the span
match.eager_sketch of QuantResult.timing: the sketch and probe of the
length groups that K3 sketches, which run uncaptured because K3 reads
its kept width to the host each batch; 0 where no group takes K3) per
10^6 reads, over the window's untraced samples."""

from perfbench.readers import stage_ms_per_mreads


def read(run):
    return stage_ms_per_mreads(run, "match.eager_sketch")
