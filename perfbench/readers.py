"""Arithmetic that several metric readers (metrics/<name>.py) share."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# The H100 SXM's published memory rate (NVIDIA's data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12


def stage_ms_per_mreads(run, key: str) -> Optional[float]:
    """Milliseconds of the program's stage `key` (QuantResult.timing) per
    10^6 reads, over the window's untraced samples that report it."""
    samples = [s for s in run.untraced() if key in s.timing]
    reads = sum(s.reads for s in samples)
    if not reads:
        return None
    return 1e3 * sum(s.timing[key] for s in samples) / (reads / 1e6)


def length_groups(lengths: np.ndarray, row_width: int, ks: Sequence[int]) -> List[tuple]:
    """(rows, width) of each padded-length group of a sample, as the port
    groups reads (pads powers of two from 256, cut to the row width; a
    group's codes cut to its longest read rounded up to 8, at least the
    largest k): a frozen copy of pipeline.length_groups and _groups'
    widths."""
    lengths = np.asarray(lengths)
    pad = np.minimum(np.maximum(256, 1 << np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64)),
                     max(row_width, 256))
    out = []
    for p in np.unique(pad):
        sel = lengths[pad == p]
        width = min(int(p), row_width)
        out.append((int(sel.size), min(width, -(-max(int(sel.max()), max(ks)) // 8) * 8)))
    return out


def kept_hashes(codes: np.ndarray, lengths: np.ndarray, k: int, fraction: float, device) -> int:
    """The distinct kept hashes of every read of a sample at k, summed:
    the reference's own sketch (reference/quant.py read_sketches) of
    [N, L] codes, in blocks of the reference's READ_BLOCK reads."""
    import torch

    from perfbench.reference import quant as ref

    total = 0
    for r0 in range(0, int(lengths.shape[0]), ref.READ_BLOCK):
        n = torch.as_tensor(lengths[r0 : r0 + ref.READ_BLOCK]).to(device)
        width = min(codes.shape[1], max(int(n.max()), k))
        c = torch.as_tensor(codes[r0 : r0 + ref.READ_BLOCK, :width]).to(device)
        total += int(ref.read_sketches(c, n, k, fraction)[0].numel())
    return total


def sketch_bytes(codes: np.ndarray, lengths: np.ndarray, ks: Sequence[int], fraction: float, packing: str,
                 device) -> int:
    """The least bytes a sketch of a sample moves, counted from the
    sample itself: its bases read once as the cell hands them over (a byte
    a base as "codes", two bits as "2bit"), its lengths (4 bytes a read),
    and per k each read's distinct kept hashes written once (32 bits
    each) and a count a read (4 bytes)."""
    lengths = np.asarray(lengths, np.int64)
    n = int(lengths.size)
    bases = int(lengths.sum()) if packing == "codes" else int(((lengths + 3) // 4).sum())
    return bases + 4 * n + sum(4 * kept_hashes(codes, lengths, k, fraction, device) + 4 * n for k in ks)
