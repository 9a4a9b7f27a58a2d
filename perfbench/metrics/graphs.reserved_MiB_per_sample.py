"""Reserved device memory the CUDA-graph captures add a quant call:
torch.cuda.memory_reserved() after each capture less before it, summed
(the counter graphs.reserved_bytes of QuantResult.timing), in MiB, the
mean over the window's untraced samples.  Beside
device.reserved_MiB_per_sample it says how much of the reserved memory a
sample keeps is the graphs' pools; 0 off a card."""

from perfbench.spans import mean_per_sample


def read(run):
    return mean_per_sample(run, "graphs.reserved_bytes", 2.0**-20)
