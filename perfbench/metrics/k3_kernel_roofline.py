"""K3's share of its roofline (csrc/hash.cu's hash_kept_kernel, both
passes: its template instances <false>, the count, and <true>, the
write): the least bytes of the traced samples' reads that K3 sketches
(readers.sketch_bytes over those reads: their bases and lengths read
once, and per k that K3 takes each read's distinct kept 32-bit hashes,
counted by the reference's own sketch, and a count a read written once)
over the H100's 3.35 TB/s, divided by the traced device time of the
records named hash_kept_kernel, in %.

Which reads K3 sketches is decided here, not read from the program: a
length group (readers.length_groups' grouping and widths) takes K3 at k
where its width gives more than MAX_WINDOWS windows rounded up to a
power of two, a frozen copy of the port's rule (sketch/dispatch.py
fused_groups with hash/sketch_kernel.py window_pad and MAX_WINDOWS).  So
any implementation is held to the same work.  Operations are left out:
how many a window takes depends on the implementation."""

from typing import List, Sequence, Tuple

import numpy as np

from perfbench import gen
from perfbench.readers import HBM_BYTES_PER_S, length_groups, sketch_bytes
from perfbench.tracing import op_name

KERNEL = "hash_kept_kernel"
# The fused sketch kernels' widest window count (a power of two).
MAX_WINDOWS = 1024


def window_pad(width: int, k: int) -> int:
    """Windows of a row of `width` bases at k, rounded up to a power of two."""
    return 1 << (width - k).bit_length()


def k3_ks(width: int, ks: Sequence[int]) -> List[int]:
    """The ks that K3 sketches in a group of this width."""
    return [k for k in ks if window_pad(width, k) > MAX_WINDOWS]


def k3_groups(lengths: np.ndarray, row_width: int, ks: Sequence[int]) -> List[Tuple[np.ndarray, List[int]]]:
    """(read rows, ks) of each length group that K3 sketches at some k.
    A group's pad grows with the read length, so the groups, in ascending
    pad, hold the reads in ascending length."""
    order = np.argsort(np.asarray(lengths), kind="stable")
    out, r0 = [], 0
    for rows, width in length_groups(lengths, row_width, ks):
        if k3_ks(width, ks):
            out.append((np.sort(order[r0 : r0 + rows]), k3_ks(width, ks)))
        r0 += rows
    return out


def k3_bytes(codes: np.ndarray, lengths: np.ndarray, row_width: int, ks: Sequence[int], fraction: float,
             packing: str, device) -> int:
    """The least bytes of a sample's reads that K3 sketches."""
    lengths = np.asarray(lengths)
    return sum(sketch_bytes(codes[rows], lengths[rows], k3, fraction, packing, device)
               for rows, k3 in k3_groups(lengths, row_width, ks))


def read(run):
    seconds = sum(e.end - e.start for e in run.events if e.device and op_name(e.name) == KERNEL) / 1e6
    if seconds <= 0:
        return None
    q = run.config["quant"]
    by_pool = {}
    for s in run.traced():
        if s.pool not in by_pool:
            codes, lengths = gen.sample_codes(run.pool[s.pool])
            by_pool[s.pool] = k3_bytes(codes, lengths, run.row_width, q["kmer_lengths"], q["sketch_fraction"],
                                       run.mix["packing"], run.device)
    nbytes = sum(by_pool[s.pool] for s in run.traced())
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
