"""The share of the traced samples' host time in which no operation ran on
the device, in % (a floor of the busy share's complement: a trace can
lose device records)."""

from perfbench.tracing import busy_share


def read(run):
    if not run.events or run.traced_s <= 0:
        return None
    busy_s, share = busy_share(run.events, run.traced_s)
    return 100.0 * (1.0 - share) if busy_s > 0 else None
