"""Reads of every sample the window completed over the seconds from the
window's start to the last sample's end (each sample ends with its
QuantResult's pi and counts on the host)."""


def read(run):
    seconds = run.window_end - run.window_start
    return sum(s.reads for s in run.samples) / seconds if seconds > 0 else None
