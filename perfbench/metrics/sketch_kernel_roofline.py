"""The sketch kernels' share of their roofline (K1 / K2, csrc/sketch.cu's
sketch_kernel): the least bytes the traced samples' sketches move
(readers.sketch_bytes: each sample's bases and lengths read once, and
per k its reads' distinct kept 32-bit hashes, counted by the reference's
own sketch, and a count a read written once) over the H100's 3.35 TB/s,
divided by the traced device time of the records named sketch_kernel, in
%.  Operations are left out: how many a window takes depends on the
implementation."""

from perfbench import gen
from perfbench.readers import HBM_BYTES_PER_S, sketch_bytes
from perfbench.tracing import op_name


def read(run):
    seconds = sum(e.end - e.start for e in run.events if e.device and op_name(e.name) == "sketch_kernel") / 1e6
    if seconds <= 0:
        return None
    q = run.config["quant"]
    by_pool = {}
    for s in run.traced():
        if s.pool not in by_pool:
            codes, lengths = gen.sample_codes(run.pool[s.pool])
            by_pool[s.pool] = sketch_bytes(codes, lengths, q["kmer_lengths"], q["sketch_fraction"],
                                           run.mix["packing"], run.device)
    nbytes = sum(by_pool[s.pool] for s in run.traced())
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
