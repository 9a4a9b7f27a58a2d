"""The class tables (em/classes.py via pipeline.em_tables): QuantResult.timing["classes"] in ms per 10^6 reads, over the
window's untraced samples."""

from perfbench.readers import stage_ms_per_mreads


def read(run):
    return stage_ms_per_mreads(run, "classes")
