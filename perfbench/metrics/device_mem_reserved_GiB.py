"""torch.cuda.max_memory_reserved() from the index's upload to the
window's close, in GiB: the card memory the process held at its peak,
the caching allocator's segments and the CUDA graphs' private pools
included, which device_mem_peak_GiB (allocated bytes) does not see.
None off a card."""


def read(run):
    return run.memory_reserved_bytes / 2**30 if run.memory_reserved_bytes else None
