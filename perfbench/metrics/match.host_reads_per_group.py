"""Blocking device-to-host reads of the match stage per length group
matched: the counters match.host_reads over match.groups of
QuantResult.timing, summed over the window's untraced samples.  A read
counts once where the program asks for it: a sizes, spill, stats or
n_cand_max read, and in the streamed chunk loop each torch.unique and
each boolean-mask index of the class dedup and the class buffer (CUDA's
torch.unique synchronizes several times inside that one call).  The
chunks' host-to-device uploads are not reads and are not counted."""

from perfbench.spans import ratio


def read(run):
    return ratio(run, "match.host_reads", "match.groups")
