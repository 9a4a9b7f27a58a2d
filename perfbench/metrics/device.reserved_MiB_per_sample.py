"""How much the card memory the process holds grows a sample:
torch.cuda.memory_reserved() at the window's close less at its start,
over the window's samples, in MiB.  Memory a quant call keeps and never
gives back shows here; at this rate a process of the card's 80 GB runs
out after about (80 GB - reserved at the start) / rate samples.  None off
a card."""


def read(run):
    if not run.memory_reserved_bytes or not run.samples:
        return None
    return run.reserved_growth_bytes / 2**20 / len(run.samples)
