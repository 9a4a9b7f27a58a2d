"""The EM and the soft assignment (em/em.py via pipeline.em_assign): QuantResult.timing["em_assign"] in ms per 10^6 reads, over the
window's untraced samples."""

from perfbench.readers import stage_ms_per_mreads


def read(run):
    return stage_ms_per_mreads(run, "em_assign")
