"""The share of the host time of the streamed engine's chunk loop
(stream.stream_classes) in which no operation ran on the device, in %: the
traced samples' "srt.stream_match" profiler records (the program's span
stream_match) against the device records (perfbench/spans.py).  A floor of
the busy share's complement, as device.idle_share: a trace can lose device
records."""

from perfbench.spans import device_idle_share


def read(run):
    return device_idle_share(run, "stream_match")
