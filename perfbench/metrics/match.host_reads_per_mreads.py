"""Blocking device-to-host reads of the match stage per 10^6 reads: the
counter match.host_reads of QuantResult.timing (each length group's
sizes read, the stats read, and K3's kept-width read, one a batch and k
that K3 sketches), summed over the window's untraced samples, over
their reads."""


def read(run):
    samples = [s for s in run.untraced() if "match.host_reads" in s.timing]
    reads = sum(s.reads for s in samples)
    if not reads:
        return None
    return sum(s.timing["match.host_reads"] for s in samples) / (reads / 1e6)
