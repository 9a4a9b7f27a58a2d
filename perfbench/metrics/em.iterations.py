"""EM iterations a quant call (the counter em.iterations of
QuantResult.timing), the mean over the window's untraced samples; each
iteration reads its convergence test to the host."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "em.iterations")
