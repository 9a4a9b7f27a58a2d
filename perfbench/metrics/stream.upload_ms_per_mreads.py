"""The streamed engine's chunk uploads (stream.stream_classes: the span
stream.upload around each chunk's host-to-device copy and, for 2-bit
codes, its unpack on the device, ended by a device sync): ms per 10^6
reads, over the window's untraced samples.  None from a program without
the span."""

from perfbench.readers import stage_ms_per_mreads


def read(run):
    return stage_ms_per_mreads(run, "stream.upload")
