"""The share of the host time of the EM and the assignment (pipeline.em_assign)
in which no operation ran on the device, in %: the traced samples'
"srt.em_assign" profiler records (the program's span em_assign) against the
device records (perfbench/spans.py).  A floor of the busy share's
complement, as device.idle_share: a trace can lose device records."""

from perfbench.spans import device_idle_share


def read(run):
    return device_idle_share(run, "em_assign")
