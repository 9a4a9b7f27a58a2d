"""Speed-of-light accounting on one NVIDIA H100: the least time a piece
of work could take, and how near a measured time comes to it
(sketch_rna_tpu/utils/roofline.py's counterpart, with the H100's peaks).

One yardstick for every reader: chip_smoke.py's kernel table bounds
each kernel with `bound` and the `*_work` rules below, and `roofline`
places a whole quant's stages by the same rules, from the counts a fused
quant leaves in QuantResult.sizes (pipeline.py) and its stage times.

The model counts the bytes a function must move (each input read once,
each output written once) and the least operations it must do, never
what a particular kernel happens to do; where that needs the data (the
rows a probe touches), the per-call `*_work` functions read it, and the
quant's sizes, counted from shapes alone, give the most those shapes
allow (see `roofline`).

Peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet; a card
set to a lower power limit runs below them).
"""

from __future__ import annotations

import math
from typing import Dict

# The H100 SXM's published memory rate; its CUDA cores' 32-bit integer
# rate (132 SMs x 64 lanes x 1.98 GHz boost), which the published table of
# peaks leaves out.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Published float rates outside the tensor cores (the EM's arithmetic).
FLOAT32_OPS_PER_S = 67e12
FLOAT64_OPS_PER_S = 34e12
PEAK_NOTE = ("shares of one H100 SXM's peaks (3.35 TB/s HBM, 132 x 64 x 1.98 GHz int32 op/s, "
             "67 / 34 TFLOP/s float32 / float64), against the card's 700 W limit")


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


def probe_shape_bytes(lanes: int, mb: int) -> int:
    """The most bytes probe_work can count for `lanes` lanes through a
    table of row width mb, from the shape alone: every lane masked in,
    its hash (8) read, its mask (1) read, its run (16) written, and its
    own bucket row's key part (4 * mb) read, no row shared, no run hit."""
    return lanes * (25 + 4 * mb)


def segsum_work(plan, itemsize: int):
    """(bytes, integer operations) of one segmented sum: each value
    (itemsize), perm entry (4) and is_start flag (1) read once; seg_end
    (4) and seg_live (1) read and the sum written once a transcript; one
    addition a lane, whatever tree adds them."""
    n_pad, T = plan.perm.numel(), plan.seg_end.numel()
    return n_pad * (itemsize + 5) + T * (5 + itemsize), n_pad


def _placed(seconds: float, nbytes: int = 0, ops: int = 0, ops_per_s: float = INT32_OPS_PER_S) -> dict:
    """Achieved rates and shares of peak of `nbytes` and `ops` done in
    `seconds`; `share` is the larger share, the stage's bound time over
    its measured time."""
    out = {"s": seconds}
    if nbytes:
        out.update(bytes=nbytes, gb_per_s=nbytes / seconds / 1e9, frac_hbm_peak=nbytes / seconds / HBM_BYTES_PER_S)
    if ops:
        out.update(ops=ops, gops_per_s=ops / seconds / 1e9, frac_ops_peak=ops / seconds / ops_per_s)
    out["share"] = max(out.get("frac_hbm_peak", 0.0), out.get("frac_ops_peak", 0.0))
    out["bound_s"] = out["share"] * seconds
    return out


def roofline(
    sizes: Dict[str, int],
    timing: Dict[str, float],
    elapsed_s: float,
    em_iterations: int,
    em_dtype_bytes: int = 8,
) -> Dict[str, dict]:
    """Each stage's achieved rate and share of one H100's peak.

    sizes / timing: a fused quant's QuantResult.sizes and .timing; the
    sketch, probe and group stages all run inside timing["match"], the EM
    in timing["em_assign"] (elapsed_s where a time is missing).
    elapsed_s: the quant's wall time.  Stages, by the rules of the
    `*_work` functions:

      sketch  hash_ops integer operations (sketch_work's and kept_work's
              rule) over the integer rate;
      probe   probe_bytes (probe_shape_bytes, the most these shapes
              allow) over the memory rate;
      group   every event lane read and written once as an int32 key
              (sort_work's bytes, 8 a lane) over the memory rate; the
              lanes' row widths are not kept, so no comparisons count;
      em      each of em_iterations E-steps and the assignment reads
              every table lane's tid and count (8 bytes) and each row's
              weight (8 bytes, em_width_max lanes a row at most), and does
              4 float operations a lane (a product, a sum, a scaling and
              an accumulation) at the float rate of em_dtype_bytes.
              With width tiers, em_lanes / em_width_max is a lower bound
              on the rows, so the bytes stay the least work and a share
              stays at most what the card could reach.

    A share counts the least work, so it reads at most 1.0 on any card; a
    larger one is a miscount.  summary: the stage with the largest share,
    and the stages' bound times summed over elapsed_s: the share of the
    quant the device's work must take at the least.
    """
    out: Dict[str, dict] = {}
    t_match = timing.get("match") or elapsed_s
    t_em = timing.get("em_assign") or elapsed_s
    if sizes.get("hash_ops"):
        out["sketch"] = _placed(t_match, ops=sizes["hash_ops"])
    if sizes.get("probe_bytes"):
        out["probe"] = _placed(t_match, nbytes=sizes["probe_bytes"])
    if sizes.get("group_lanes"):
        out["group"] = dict(lanes=sizes["group_lanes"], **_placed(t_match, nbytes=8 * sizes["group_lanes"]))
    lanes = sizes.get("em_lanes", 0)
    if lanes and em_iterations:
        passes = em_iterations + 1
        rows = -(-lanes // max(sizes.get("em_width_max", 1), 1))
        peak = FLOAT64_OPS_PER_S if em_dtype_bytes == 8 else FLOAT32_OPS_PER_S
        out["em"] = dict(lanes=lanes, iterations=em_iterations,
                         **_placed(t_em, nbytes=passes * (8 * lanes + 8 * rows), ops=passes * 4 * lanes,
                                   ops_per_s=peak))
    lead = max(out, key=lambda name: out[name]["share"], default=None)
    bound_s = sum(stage["bound_s"] for stage in out.values())
    out["summary"] = {
        "dominant_bound": lead,
        "frac_of_peak": out[lead]["share"] if lead else 0.0,
        "bound_s": bound_s,
        "elapsed_s": elapsed_s,
        "frac_of_elapsed": bound_s / elapsed_s if elapsed_s else 0.0,
        "note": PEAK_NOTE,
    }
    return out
