"""CUDA graphs captured a quant call (utils/step_graphs.py: the counter
graphs.captures of QuantResult.timing), the mean over the window's
untraced samples.  The graphs are made anew every call, so each capture
costs every sample its warm-up, capture and instantiate."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "graphs.captures")
