"""The global-sort matcher: candidate extraction as one flat expansion
and one lexicographic sort (sketch_rna_tpu/match/lookup.py and
match/candidates.py's counterpart).

A second formulation of the reference's sparse_chain
(src/sparse_chaining.cpp:29-115), independent of the row matcher
(match/rowmatch.py) past the probe:

  1. per k: probe each sketch hash (match/probe.py) and expand every
     posting of the batch into a flat budget of B * expand_per_read
     lanes; events past the budget are counted (a saturating count per
     k), never silent;
  2. one lexicographic sort of (read, tid) makes each pair's events one
     run (empty lanes carry read B and collapse into a tail run); the run
     counts per k are the match_counts vectors (:48-73);
  3. per-read per-k maxima over the runs (:76-82);
  4. the forall-k fractional threshold and the summed score (:83-105),
     exact in integers when the fraction is a small rational
     (rowmatch._fraction_compare_params, shared with the row matcher);
  5. per-read top-C tables by (score desc, tid asc) (:108-109), with the
     candidates past C counted in candidate_spilled.

Plain PyTorch (sort, searchsorted, index_add_, scatter_reduce) on the
tensors' device, calling none of the port's kernels: the JAX package
computes it in XLA too.  It returns rowmatch's MatchResult, so its
tables compare with the row matcher's directly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from sketch_rna_tpu_torch.match.probe import probe
from sketch_rna_tpu_torch.match.rowmatch import MatchResult, _fraction_compare_params

# Saturation of a k's running event count, as the JAX package's int32
# saturating scan: the drop count stays comparable past 2^30 events.
_CUM_CAP = 1 << 30


def expand_postings(
    start: torch.Tensor,
    length: torch.Tensor,
    postings: torch.Tensor,
    budget: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten every (read, posting) event of a batch into `budget` lanes.

    start, length: [B, S] posting runs (match/probe.py's probe);
    postings: [P] int32 transcript indices.  Returns (read_e [E] int32,
    the owning read row, B on an empty lane; tid_e [E] int32, 0 on an
    empty lane; valid_e [E] bool; n_dropped [] int64, the events past
    the budget, from a running count saturated at 2^30).
    """
    B, S = start.shape
    dev = start.device
    flat_len = length.reshape(-1).long()
    cum = torch.clamp(torch.cumsum(flat_len, 0), max=_CUM_CAP)  # inclusive
    total = cum[-1] if cum.numel() else torch.zeros((), dtype=torch.int64, device=dev)
    n_dropped = torch.clamp(total - budget, min=0)
    e = torch.arange(budget, dtype=torch.int64, device=dev)
    valid_e = e < total
    if B * S == 0 or postings.numel() == 0:  # no lane or no posting: no event
        return (torch.full((budget,), B, dtype=torch.int32, device=dev),
                torch.zeros(budget, dtype=torch.int32, device=dev), valid_e, n_dropped)
    # A lane's run: the first whose inclusive count exceeds the lane.
    src = torch.clamp(torch.searchsorted(cum, e, right=True), max=B * S - 1)
    offset = e - (cum[src] - flat_len[src])
    p_idx = torch.clamp(start.reshape(-1).long()[src] + offset, 0, postings.numel() - 1)
    tid_e = torch.where(valid_e, postings[p_idx].to(torch.int32), 0)
    read_e = torch.where(valid_e, src // S, B).to(torch.int32)
    return read_e, tid_e, valid_e, n_dropped


def expand_events(
    sketch_hashes: Sequence[torch.Tensor],
    sketch_masks: Sequence[torch.Tensor],
    index_keys: Sequence[torch.Tensor],
    index_row_ptr: Sequence[torch.Tensor],
    index_postings: Sequence[torch.Tensor],
    *,
    expand_per_read: int,
):
    """Step 1 of match_batch: each k's probe and expansion into flat
    (read, tid, k) events.  Returns (read_e, tid_e, valid_e, kid_e), each
    [K * E] with E = B * expand_per_read, and the per-k drop counts."""
    K = len(sketch_hashes)
    if not K == len(index_keys) == len(index_row_ptr) == len(index_postings):
        raise ValueError("one sketch and one index per k")
    E = sketch_hashes[0].shape[0] * expand_per_read
    parts: List[Tuple[torch.Tensor, ...]] = []
    drops = []
    for ki in range(K):
        start, length = probe(sketch_hashes[ki], sketch_masks[ki], index_keys[ki], index_row_ptr[ki])
        r, t, v, d = expand_postings(start, length, index_postings[ki], E)
        parts.append((r, t, v, torch.full((E,), ki, dtype=torch.int32, device=r.device)))
        drops.append(d)
    read_e, tid_e, valid_e, kid_e = (torch.cat(p) for p in zip(*parts))
    return read_e, tid_e, valid_e, kid_e, drops


def events_to_candidates(
    read_e: torch.Tensor,
    tid_e: torch.Tensor,
    valid_e: torch.Tensor,
    kid_e: torch.Tensor,
    *,
    num_reads: int,
    num_k: int,
    chain_fraction: float,
    candidate_capacity: int,
) -> MatchResult:
    """Steps 2-5 of match_batch: group the flat events by (read, tid),
    count them per k, threshold, and build the per-read top-C tables."""
    B, K, C = num_reads, num_k, candidate_capacity
    F = read_e.shape[0]
    if F >= 1 << 31:
        raise OverflowError(f"{F} event lanes: a score could overflow the packed top-C key")
    dev = read_e.device
    # ---- group events by (read, tid): one sort of a packed key --------
    order = torch.sort((read_e.long() << 32) | tid_e.long(), stable=True)
    s_key = order.values
    s_kid = kid_e[order.indices]
    s_valid = valid_e[order.indices]
    new_run = torch.ones(F, dtype=torch.bool, device=dev)
    new_run[1:] = s_key[1:] != s_key[:-1]
    run_id = torch.cumsum(new_run.long(), 0) - 1  # [F] non-decreasing

    # Per-run per-k match counts (the match_counts vectors).
    counts = []
    for ki in range(K):
        c = torch.zeros(F, dtype=torch.int64, device=dev)
        counts.append(c.index_add_(0, run_id, ((s_kid == ki) & s_valid).long()))
    # Run representatives: every event of a run carries its key.
    run_key = torch.full((F,), B << 32, dtype=torch.int64, device=dev).scatter_(0, run_id, s_key)
    run_read, run_tid = run_key >> 32, run_key & 0xFFFFFFFF
    run_valid = run_read < B

    # ---- per-read per-k maxima ---------------------------------------
    seg_read = torch.clamp(run_read, max=B)  # empty runs -> segment B
    max_k = [torch.zeros(B + 1, dtype=torch.int64, device=dev).scatter_reduce_(0, seg_read, c, "amax")[:B]
             for c in counts]

    # ---- forall-k fractional threshold + score -----------------------
    p, q = _fraction_compare_params(chain_fraction)
    f32 = torch.tensor(chain_fraction, dtype=torch.float32, device=dev)
    meets = run_valid
    score = torch.zeros(F, dtype=torch.int64, device=dev)
    read_clip = torch.clamp(run_read, 0, max(B - 1, 0))
    for ki in range(K):
        mx_run = max_k[ki][read_clip] if B else torch.zeros_like(score)
        if q > 0:
            ok = counts[ki] * q >= mx_run * p
        else:
            ok = counts[ki].float() >= f32 * mx_run.float()
        meets = meets & ok
        score = score + counts[ki]

    # ---- per-read top-C candidate tables -----------------------------
    # Runs lie in (read, tid) order, so a stable sort by (read, score
    # desc) leaves tid ascending among equal scores.
    cand_read = torch.where(meets, run_read, B)
    top = torch.sort((cand_read << 32) | ((1 << 31) - score), stable=True)
    c_read = top.values >> 32
    c_score = score[top.indices]
    c_tid = run_tid[top.indices]
    rank = torch.arange(F, dtype=torch.int64, device=dev) - torch.searchsorted(c_read, c_read, side="left")
    is_cand = c_read < B
    ok = is_cand & (rank < C)
    rows = torch.where(ok, c_read, B)
    cols = torch.where(ok, rank, 0)
    tbl_tid = torch.zeros((B + 1, C), dtype=torch.int32, device=dev)
    tbl_score = torch.zeros((B + 1, C), dtype=torch.int32, device=dev)
    tbl_mask = torch.zeros((B + 1, C), dtype=torch.bool, device=dev)
    tbl_tid[rows, cols] = c_tid.to(torch.int32)
    tbl_score[rows, cols] = c_score.to(torch.int32)
    tbl_mask[rows, cols] = ok
    stats = {"candidate_spilled": (is_cand & (rank >= C)).sum()}
    return MatchResult(tid=tbl_tid[:B], score=tbl_score[:B], mask=tbl_mask[:B], stats=stats)


def match_batch(
    sketch_hashes: Sequence[torch.Tensor],
    sketch_masks: Sequence[torch.Tensor],
    index_keys: Sequence[torch.Tensor],
    index_row_ptr: Sequence[torch.Tensor],
    index_postings: Sequence[torch.Tensor],
    *,
    chain_fraction: float,
    expand_per_read: int,
    candidate_capacity: int,
) -> MatchResult:
    """Match one read batch against a whole index.

    sketch_hashes / sketch_masks: per-k [B, S_k] sketches (int64 holding
    uint32, bool); index_*: per-k keys [U] int64, row_ptr [U+1], postings
    [P] int32 (a DeviceKIndex's).  stats: candidate_spilled, and
    expand_dropped [K] int64, each k's events past its budget.
    """
    read_e, tid_e, valid_e, kid_e, drops = expand_events(
        sketch_hashes, sketch_masks, index_keys, index_row_ptr, index_postings, expand_per_read=expand_per_read
    )
    result = events_to_candidates(
        read_e,
        tid_e,
        valid_e,
        kid_e,
        num_reads=sketch_hashes[0].shape[0],
        num_k=len(sketch_hashes),
        chain_fraction=chain_fraction,
        candidate_capacity=candidate_capacity,
    )
    result.stats["expand_dropped"] = torch.stack(drops)
    return result
