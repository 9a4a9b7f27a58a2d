"""Multi-GPU quantification: one process per GPU over torch.distributed."""
