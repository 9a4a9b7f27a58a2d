"""Host milliseconds in CUDA-graph captures (the span graphs.capture of
QuantResult.timing: each capture's eager warm-up, capture and
instantiate; 0 where a call captured nothing) per 10^6 reads, over the
window's untraced samples."""

from perfbench.readers import stage_ms_per_mreads


def read(run):
    return stage_ms_per_mreads(run, "graphs.capture")
