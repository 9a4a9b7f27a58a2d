"""CUDA graphs captured per streamed chunk: the counters graphs.captures
over stream.chunks of QuantResult.timing, summed over the window's
untraced samples.  The graphs live with the index (utils/step_graphs.py),
so a chunk captures only a key no earlier chunk or sample had, or one the
store's bound dropped.  None from a program without the chunk counter,
and from a cell that does not stream."""

from perfbench.spans import ratio


def read(run):
    return ratio(run, "graphs.captures", "stream.chunks")
