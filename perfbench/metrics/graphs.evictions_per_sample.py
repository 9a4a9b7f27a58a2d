"""CUDA graphs a quant call drops from its index's graph store, the least
recently used past the store's bound (utils/step_graphs.py: the counter
graphs.evictions of QuantResult.timing), the mean over the window's
untraced samples.  Each one dropped is captured again when its key
returns."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "graphs.evictions")
