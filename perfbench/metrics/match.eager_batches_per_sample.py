"""Batches a quant call sketches eagerly, outside the CUDA graphs,
because their length group takes K3 (the counter match.eager_batches of
QuantResult.timing), the mean over the window's untraced samples."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "match.eager_batches")
