"""Seconds from the process's start to the window's: imports, the cache
(or, on a checkout's first run, the transcriptome, the index and the
kernels' build), the pool of samples, the index upload and the warm-up
quants."""


def read(run):
    return run.setup_s
