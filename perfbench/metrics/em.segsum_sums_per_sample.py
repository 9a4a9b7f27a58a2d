"""Posterior sums a quant call takes through the kernel S (the counter
em.segsum_sums of QuantResult.timing: one a segmented sum, each EM
iteration's and the assignment's two; 0 on the scatter route), the mean
over the window's untraced samples.  A program without the counter
reports nothing here."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "em.segsum_sums")
