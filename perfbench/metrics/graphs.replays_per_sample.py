"""CUDA-graph replays a quant call (utils/step_graphs.py: the counter
graphs.replays of QuantResult.timing), the mean over the window's
untraced samples.  The graphs live with their index, so a batch step
whose key an earlier call captured replays; beside
graphs.captures_per_sample it gives the share of steps that hit."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "graphs.replays")
