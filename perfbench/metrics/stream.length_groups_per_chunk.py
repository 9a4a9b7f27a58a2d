"""Length groups matched per streamed chunk: the counters match.groups
over stream.chunks of QuantResult.timing, summed over the window's
untraced samples.  Each group of a chunk is its own size read and its own
graph keys.  None from a program without the chunk counter, and from a
cell that does not stream."""

from perfbench.spans import ratio


def read(run):
    return ratio(run, "match.groups", "stream.chunks")
