"""Batches a quant call groups through the grouping kernel G (the
counter match.group_kernel_batches of QuantResult.timing: one a batch
that G groups whole), the mean over the window's untraced samples.  A
program without the counter reports nothing here."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "match.group_kernel_batches")
