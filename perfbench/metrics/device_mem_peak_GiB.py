"""torch.cuda.max_memory_allocated() over the run from the index's upload
to the window's close (the index, its bucket tables and every quant), in
GiB; None off a card."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
