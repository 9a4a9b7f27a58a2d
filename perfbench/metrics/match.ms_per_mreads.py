"""The fused engine's match stage (pipeline.match_scan: sketch, probe, expand, group): QuantResult.timing["match"] in ms per 10^6 reads, over the
window's untraced samples."""

from perfbench.readers import stage_ms_per_mreads


def read(run):
    return stage_ms_per_mreads(run, "match")
