"""The streamed engine's chunk loop (stream.stream_classes: upload, match_rows, class buffer): QuantResult.timing["stream_match"] in ms per 10^6 reads, over the
window's untraced samples."""

from perfbench.readers import stage_ms_per_mreads


def read(run):
    return stage_ms_per_mreads(run, "stream_match")
