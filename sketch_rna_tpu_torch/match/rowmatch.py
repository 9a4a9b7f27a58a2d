"""Row-parallel single-k candidate matching.

Semantics of the reference's sparse_chain (src/sparse_chaining.cpp:29-115)
for one k, as in sketch_rna_tpu/match/rowmatch.py:

  - every posting of every probed sketch hash is one event (read, tid),
  - per read, a transcript's count is its number of events; it is a
    candidate iff count >= chain_fraction * (the read's best count),
  - the read keeps its top-C candidates by (count desc, tid asc).

Shape on the GPU: the posting runs expand into one [B, W] row of tid
keys per read, W the batch's largest per-read event total rounded up to
a power of two, so nothing is dropped below EXPAND_RETRY_MAX.  A row
sort (kernel K4) makes each tid's events adjacent; run counting is
shifts and a cummax along the row; the top-C selection is one more K4
sort of packed (rank, tid) keys.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable, Dict, Tuple

import torch

from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, MIN_WIDTH, row_sort

I32_MAX = 2**31 - 1  # sentinel event key; sorts after every tid
# Widest per-read event row (the JAX engines' expansion retry bound, and
# K4's widest row); events past it are counted as expand_dropped.
EXPAND_RETRY_MAX = MAX_WIDTH


@dataclasses.dataclass
class MatchResult:
    """Per-batch candidate tables, rows by (score desc, tid asc).

    tid:   [B, C] int32 candidate transcript index (0 on empty lanes).
    score: [B, C] int32 event count (0 on empty lanes).
    mask:  [B, C] bool validity.
    stats: overflow counters as 0-d int64 tensors.
    """

    tid: torch.Tensor
    score: torch.Tensor
    mask: torch.Tensor
    stats: Dict[str, torch.Tensor]


def pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _fraction_compare_params(fraction: float) -> Tuple[int, int]:
    """(p, q) with fraction ~= p/q for exact integer thresholding, or
    (0, 0) if no small rational matches closely enough."""
    fr = Fraction(fraction).limit_denominator(10000)
    if abs(float(fr) - fraction) < 1e-12:
        return fr.numerator, fr.denominator
    return 0, 0


def row_expand_from_runs(
    start: torch.Tensor,
    length: torch.Tensor,
    postings: torch.Tensor,
    *,
    max_width: int = EXPAND_RETRY_MAX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand posting runs [B, S] into one row of event keys per read.

    Returns (key [B, W] int32: the tids of the read's events in probe
    order, INT32_MAX past them; n_dropped [] int64: events past
    max_width).  W = pow2ceil(largest per-read total), at least 2 and at
    most max_width.  One host sync reads the batch's largest total and
    event count.
    """
    B, S = start.shape
    total = length.sum(dim=1)
    if B:
        max_ev, n_ev = (int(v) for v in torch.stack([total.max(), total.sum()]).tolist())
    else:
        max_ev = n_ev = 0
    W = min(max(pow2ceil(max_ev), MIN_WIDTH), max_width)
    key = torch.full((B, W), I32_MAX, dtype=torch.int32, device=start.device)
    n_dropped = torch.clamp(total - W, min=0).sum()
    if n_ev:
        lens = length.reshape(-1)
        runs = torch.arange(B * S, device=start.device)
        run = torch.repeat_interleave(runs, lens, output_size=n_ev)
        # Event e of run r sits `within` events into the run and `col`
        # events into its read's row (runs keep their probe order).
        first_event = torch.cumsum(lens, 0) - lens
        within = torch.arange(n_ev, device=start.device) - first_event[run]
        col = (torch.cumsum(length, dim=1) - length).reshape(-1)[run] + within
        tid = postings[start.reshape(-1)[run] + within]
        row = run // S
        if max_ev > W:
            keep = col < W
            row, col, tid = row[keep], col[keep], tid[keep]
        key[row, col] = tid
    return key, n_dropped


def _top_c_select(
    meets: torch.Tensor,
    tid: torch.Tensor,
    score: torch.Tensor,
    *,
    score_bound: int,
    candidate_capacity: int,
    num_transcripts: int,
    sort: Callable[[torch.Tensor], torch.Tensor],
) -> MatchResult:
    """The top-C lanes by (score desc, tid asc), as one ascending sort of
    packed (rank, tid) int32 keys.  score_bound bounds every score."""
    B, W = tid.shape
    C = candidate_capacity
    big = score_bound + 2
    tid_bits = 31 - big.bit_length()
    if not 0 < num_transcripts <= (1 << tid_bits):
        raise NotImplementedError(
            f"{num_transcripts} transcripts do not pack beside event rank {big} in an "
            "int32 key; this needs the key+payload row sort (ROADMAP Queue 2, K4 variant)"
        )
    prim = torch.where(meets, (score_bound + 1) - score, big)
    packed = (prim << tid_bits) | torch.where(meets, tid, 0)
    s = sort(packed)[:, :C]
    s_prim = s >> tid_bits
    mask = s_prim < big
    tbl_tid = torch.where(mask, s & ((1 << tid_bits) - 1), 0)
    tbl_score = torch.where(mask, (score_bound + 1) - s_prim, 0)
    if s.shape[1] < C:
        pad = C - s.shape[1]
        tbl_tid = torch.nn.functional.pad(tbl_tid, (0, pad))
        tbl_score = torch.nn.functional.pad(tbl_score, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    n_cand = meets.sum(dim=1)
    stats = {"candidate_spilled": torch.clamp(n_cand - C, min=0).sum()}
    return MatchResult(tid=tbl_tid, score=tbl_score, mask=mask, stats=stats)


def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=fill)


def _shift_left(x: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.nn.functional.pad(x[:, 1:], (0, 1), value=fill)


def row_events_to_candidates(
    keym: torch.Tensor,
    *,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int,
    sort: Callable[[torch.Tensor], torch.Tensor] = row_sort,
) -> MatchResult:
    """Group [B, W] tid event keys (INT32_MAX = empty, any lane order)
    into per-read top-C candidates — the K=1 branch of the JAX function.

    sort: the row sort; K4 by default, its plain version to check it.
    """
    if num_transcripts >= I32_MAX:
        raise OverflowError(f"{num_transcripts} transcripts collide with the INT32_MAX event sentinel")
    keym = sort(keym)
    B, W = keym.shape
    i_idx = torch.arange(W, dtype=torch.int32, device=keym.device).expand(B, W)
    valid = keym != I32_MAX
    is_start = valid & (keym != _shift_right(keym, -1))
    is_end = valid & (keym != _shift_left(keym, I32_MAX - 1))
    # Count of each tid's run, live at the run's END lane.
    start_pos = torch.cummax(torch.where(is_start, i_idx, -1), dim=1).values
    ck = torch.where(is_end, i_idx - start_pos + 1, 0)
    maxc = ck.max(dim=1, keepdim=True).values
    p, q = _fraction_compare_params(chain_fraction)
    if q > 0:
        ok = ck * q >= maxc * p
    else:
        f = torch.tensor(chain_fraction, dtype=torch.float32, device=keym.device)
        ok = ck.float() >= f * maxc.float()
    return _top_c_select(
        is_end & ok,
        keym,
        ck,
        score_bound=W,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
        sort=sort,
    )
