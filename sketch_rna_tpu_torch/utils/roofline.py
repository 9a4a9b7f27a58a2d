"""Speed-of-light accounting on one NVIDIA H100: the least time a piece
of work could take (sketch_rna_tpu/utils/roofline.py's counterpart,
with the H100's peaks).

chip_smoke.py's kernel table bounds each kernel with `bound` and the
`*_work` rules below, as PERF.md's kernel table does.  The benchmark's
own shares of a bound (sketch_kernel_roofline, k3_kernel_roofline) are
perfbench's readers' (perfbench/metrics/, perfbench/readers.py), read
from a traced run.

The model counts the bytes a function must move (each input read once,
each output written once) and the least operations it must do, never
what a particular kernel happens to do; where that needs the data (the
rows a probe touches), the per-call `*_work` functions read it.

Peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet; a card
set to a lower power limit runs below them).
"""

from __future__ import annotations

import math

# The H100 SXM's published memory rate; its CUDA cores' 32-bit integer
# rate (132 SMs x 64 lanes x 1.98 GHz boost), which the published table of
# peaks leaves out.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: int, ops: int):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the integer operations over the integer rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def sort_work(B: int, W: int, itemsize: int):
    """(bytes, integer operations) of sorting [B, W] keys: each row read
    and written once; the ceil(log2 W!) comparisons a comparison sort of
    a row needs at least, one operation each on 32-bit words (two on
    int64), whatever network a kernel runs."""
    need = math.ceil(math.lgamma(W + 1) / math.log(2))
    return 2 * B * W * itemsize, B * need * (itemsize // 4)


def group_work(B: int, widths, C: int):
    """(bytes, integer operations) of grouping per-k [B, W_k] int32 event
    rows into [B, C] candidate tables (kernel G): each row read once, the
    int32 tid and score and the bool mask of every table slot written once,
    and the ceil(log2 W_k!) comparisons each row's sort needs at least."""
    need = sum(math.ceil(math.lgamma(W + 1) / math.log(2)) for W in widths)
    return 4 * B * sum(widths) + 9 * B * C, B * need


def sketch_work(B: int, L: int, ks, caps):
    """(bytes, integer operations) of sketching [B, L] reads at ks: codes
    and lengths in, per k a [B, cap] int64 row + bool mask + int32
    overflow out; ~8 operations per position (the prefix XOR) and per
    window (its hash and threshold)."""
    nbytes = B * L + 4 * B + sum(B * cap * 9 + 4 * B for cap in caps)
    return nbytes, 8 * B * L + sum(8 * B * (L - k + 1) for k in ks)


def kept_work(B: int, L: int, k: int, m: int):
    """(bytes, integer operations) of K3 over [B, L] reads at k with an
    output width of m: codes and lengths in, [B, m] int64 hashes, [B, m]
    int32 windows and [B] int32 counts out; ~8 operations per position
    (the prefix XOR) and per window (its hash, threshold and ballot)."""
    return B * L + 4 * B + 12 * B * m + 4 * B, 8 * B * L + 8 * B * (L - k + 1)


def merge_work(N: int, W: int, itemsize: int):
    """(bytes, integer operations) of merging the halves of [N, W] rows:
    each key read and written once; one comparison per output, one
    operation on 32-bit words (two on int64)."""
    return 2 * N * W * itemsize, N * W * (itemsize // 4)


def _sectors8(needed) -> int:
    """32-byte sectors of a flat array of 8-byte items (from an aligned
    start) that hold at least one needed item: `needed` a flat bool
    tensor, one flag an item."""
    n = needed.numel()
    padded = needed.new_zeros(n + (-n % 4))
    padded[:n] = needed
    return int(padded.view(-1, 4).any(dim=1).sum())


def probe_work(hashes, mask, length, table):
    """(bytes, integer operations) of probing [B, S] lanes through a
    bucket table: each lane's bool mask in and its two int64 outputs out;
    the int64 hashes in the 32-byte sectors that hold a masked-in lane;
    the key part (4 * mb bytes) of each bucket row a masked-in lane needs,
    each row once, and the 8-byte run of each hit's slot, each slot once
    (this run's data, counted on the card); mb compares a masked-in
    lane."""
    flat = mask.reshape(-1)
    n, on = flat.numel(), int(flat.sum())
    sectors = _sectors8(flat)
    h = hashes.reshape(-1) & 0xFFFFFFFF
    rows = (h[flat] >> table.shift).clamp(max=table.packed.shape[0] - 1).unique().numel()
    runs = h[((length > 0) & mask).reshape(-1)].unique().numel()
    return 17 * n + 32 * sectors + rows * 4 * table.mb + 8 * runs, on * table.mb


def expand_work(length, W: int):
    """(bytes, integer operations) of expanding [B, S] posting runs into
    [B, W] int32 event rows (kernel E), from this run's run lengths
    (counted on the card): every run's int64 length read once (8 bytes a
    lane); the int64 start of each run that holds an output lane, in the
    32-byte sectors those runs touch (an empty run, or one past W, needs
    no start); each output lane written once (4); one 4-byte posting
    gathered a valid lane.  One addition a run (the ends' prefix sum) and
    one operation an output lane."""
    B, S = length.shape
    ends = length.cumsum(dim=1)
    holds = (length > 0) & (ends - length < W)
    events = int(ends[:, -1].clamp(max=W).sum()) if S else 0
    return 8 * B * S + 32 * _sectors8(holds.reshape(-1)) + 4 * B * W + 4 * events, B * S + B * W


def segsum_work(plan, itemsize: int):
    """(bytes, integer operations) of one segmented sum: each value
    (itemsize), perm entry (4) and is_start flag (1) read once; seg_end
    (4) and seg_live (1) read and the sum written once a transcript; one
    addition a lane, whatever tree adds them."""
    n_pad, T = plan.perm.numel(), plan.seg_end.numel()
    return n_pad * (itemsize + 5) + T * (5 + itemsize), n_pad
