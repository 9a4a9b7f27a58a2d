"""Row-parallel candidate matching, one k or several.

Semantics of the reference's sparse_chain (src/sparse_chaining.cpp:29-115),
as in sketch_rna_tpu/match/rowmatch.py:

  - every posting of every probed sketch hash is one event (read, tid, k),
  - per read and k, a transcript's count is its number of events at that
    k; it passes k iff count >= chain_fraction * (the read's best count
    at k), and a k where the read has no event passes vacuously,
  - a transcript is a candidate iff it passes every k; its score is the
    sum of its counts; the read keeps its top-C candidates by
    (score desc, tid asc).

Shape on the GPU: each k's posting runs expand (kernel E,
match/expand.py) into one [B, W_k] row of tid keys per read, W_k the
batch's largest per-read event total at k rounded up to a power of two
(expand_width), so no event is dropped; a batch that
holds a read past 16384 events at some k groups in row slices
(match_runs), so its rows hold no more lanes than a full batch at K4's
widest.  A row sort (row_sort_wide: kernel K4, and past its 16384 lanes
K4 over 16384-lane chunks and the merge kernel's rounds) makes each
tid's events adjacent; run counting is shifts and a cummax along the
row; the top-C selection is one more K4 sort of packed (rank, tid) keys,
int32 where they fit and int64 past that.  Several ks group per k into top-2C
tables that intersect (group_parts_per_k, the default), or as one merged
K-wide row (the exact fallback when a per-k table spills).

group_event_parts groups a batch on a card with the hand-written kernel
G (match/group.py, csrc/group.cu) where group_kernel_takes allows it: one
launch in place of that chain, equal to it bit for bit.  The chain is
its plain version (group_event_parts_plain): the CPU's, and the card's
for rows past G's widest and for the merged K-wide rows.

Once the widths are known, grouping reads nothing to the host and every
shape in it is static, so pipeline.match_scan replays it from CUDA
graphs (utils/step_graphs.py); event_size_tensor gives the widths'
inputs on the device, and event_sizes reads them.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from sketch_rna_tpu_torch.match.expand import row_expand
from sketch_rna_tpu_torch.match.group import group_kernel_takes, group_rows
from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, MIN_WIDTH, merge_sorted_runs, row_sort_wide
from sketch_rna_tpu_torch.utils.timing import host_read

I32_MAX = 2**31 - 1  # sentinel event key; sorts after every tid
# Sentinel of a (tid << 32) | score table lane: sorts after every real lane.
_TABLE_SENTINEL = I32_MAX << 32

Sort = Callable[[torch.Tensor], torch.Tensor]
Read = Callable[[torch.Tensor, int], List[int]]


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


def _read_local(x: torch.Tensor, n: int) -> List[int]:
    return host_read(x)


def event_size_tensor(lengths: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each k's largest per-read event total of [B, S] posting-run
    lengths, on their device with no host read: [K] int64 (B >= 1)."""
    return torch.stack([length.sum(dim=1).max() for length in lengths])


def event_sizes(lengths: Sequence[torch.Tensor], read: Read = _read_local) -> List[int]:
    """event_size_tensor read to the host, in one host sync for every k:
    each k's largest per-read event total.  read(x, n): x on the host,
    its first n entries all-reduced MAX over an index group
    (dist.collectives.read_max); by default x as it is."""
    if not lengths or lengths[0].shape[0] == 0:
        return [0] * len(lengths)
    return [int(m) for m in read(event_size_tensor(lengths), len(lengths))]


def expand_width(max_events: int) -> int:
    """A k's event row width for a batch whose largest per-read total is
    max_events: the next power of two, at least MIN_WIDTH."""
    return max(pow2ceil(max_events), MIN_WIDTH)


def row_expand_from_runs(
    start: torch.Tensor,
    length: torch.Tensor,
    postings: torch.Tensor,
    *,
    sizes: Optional[int] = None,
) -> torch.Tensor:
    """Expand posting runs [B, S] into one row of event keys per read:
    key [B, W] int32, the tids of the read's events in probe order,
    INT32_MAX past them.  W = expand_width(largest per-read total), so no
    event is dropped (the JAX engines stop at 16384 and count the rest as
    expand_dropped; match_runs bounds the port's rows).  The kernel E on
    a CUDA tensor, its plain version on the CPU (match/expand.py).
    sizes: this k's event_sizes entry (its largest per-read total);
    without it one host sync reads it.
    """
    max_ev = sizes if sizes is not None else event_sizes([length])[0]
    return row_expand(start, length, postings, expand_width(max_ev))


def row_slices(most: Sequence[int], batch_size: int) -> List[List[int]]:
    """A batch's rows in slices whose event rows hold no more lanes a k
    than a full batch at K4's widest row (batch_size x MAX_WIDTH): the
    rows whose events fit MAX_WIDTH lanes as one slice, then the wider
    ones, narrowest first, as many a slice as that holds (at least one).
    most: each row's largest per-k event total."""
    narrow = [i for i, m in enumerate(most) if m <= MAX_WIDTH]
    wide = sorted((i for i, m in enumerate(most) if m > MAX_WIDTH), key=lambda i: most[i])
    slices = [narrow] if narrow else []
    while wide:
        n = 1  # the slice's width is its last (widest) row's
        while n < len(wide) and (n + 1) * pow2ceil(most[wide[n]]) <= batch_size * MAX_WIDTH:
            n += 1
        slices.append(wide[:n])
        wide = wide[n:]
    return slices


def match_runs(
    runs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    batch_size: int,
    group: Callable[[Sequence[Tuple[torch.Tensor, torch.Tensor]], List[int]], MatchResult],
    read: Read = _read_local,
    sizes: Optional[List[int]] = None,
) -> MatchResult:
    """Group one batch's posting runs ((start, length) [B, S] per k) by
    group(runs, sizes), sizes each k's event_sizes entry (read here
    unless given).  When a read's
    events pass MAX_WIDTH lanes at some k, the batch groups in
    row_slices, so its event rows stay as narrow as a full batch's at
    K4's widest row without dropping an event; the slices' tables and
    stats come back as one batch's.  read: as in event_sizes (every rank
    of an index group then cuts the same slices)."""
    if sizes is None:
        sizes = event_sizes([length for _, length in runs], read)
    if max(sizes) <= MAX_WIDTH:
        return group(runs, sizes)
    B = runs[0][0].shape[0]
    most = read(torch.stack([length.sum(dim=1) for _, length in runs]).amax(dim=0), B)
    slices, results = row_slices(most, batch_size), []
    for rows in slices:
        idx = torch.tensor(rows, device=runs[0][0].device)
        part = [(start[idx], length[idx]) for start, length in runs]
        results.append(group(part, event_sizes([length for _, length in part], read)))
    first = results[0]
    out = MatchResult(*(torch.zeros((B,) + r.shape[1:], dtype=r.dtype, device=r.device)
                        for r in (first.tid, first.score, first.mask)),
                      stats={key: sum(r.stats[key] for r in results) for key in first.stats})
    for rows, r in zip(slices, results):
        idx = torch.tensor(rows, device=r.tid.device)
        out.tid[idx], out.score[idx], out.mask[idx] = r.tid, r.score, r.mask
    return out


def _smallest(keys: torch.Tensor, C: int, sort: Sort) -> torch.Tensor:
    """The C smallest keys of every row, ascending (every key of a row
    narrower than C).  Rows wider than K4's widest keep each
    MAX_WIDTH-lane chunk's smallest pow2ceil(C) first: the row's C
    smallest are among them."""
    B, W = keys.shape
    keep = pow2ceil(C)
    while W > MAX_WIDTH:
        keys = sort(keys.reshape(-1, MAX_WIDTH))[:, :keep].reshape(B, -1)
        W = keys.shape[1]
    return sort(keys)[:, :C]


def chain_passes(count: torch.Tensor, best: torch.Tensor, chain_fraction: float) -> torch.Tensor:
    """count >= chain_fraction * best, lane by lane: in integers, count * q
    >= best * p, where a small rational p / q equals the fraction, else in
    float32 as the reference compares.  The float path's factor is filled
    on the device (no host copy)."""
    p, q = _fraction_compare_params(chain_fraction)
    if q > 0:
        return count * q >= best * p
    f32 = torch.full((), chain_fraction, dtype=torch.float32, device=count.device)
    return count.float() >= f32 * best.float()


def _top_c_select(
    meets: torch.Tensor,
    tid: torch.Tensor,
    score: torch.Tensor,
    *,
    score_bound: int,
    candidate_capacity: int,
    num_transcripts: int,
    sort: Sort,
) -> MatchResult:
    """The top-C lanes by (score desc, tid asc), as one ascending sort of
    (rank, tid) keys: packed into int32 when the transcript count leaves
    room beside the rank, else int64 (rank << 32) | tid, the order of
    the JAX package's 3-operand sort.  score_bound bounds every score."""
    C = candidate_capacity
    big = score_bound + 2
    tid_bits = 31 - big.bit_length()
    prim = torch.where(meets, (score_bound + 1) - score, big)
    tid_c = torch.where(meets, tid, 0)
    if 0 < num_transcripts <= (1 << tid_bits):
        s = _smallest(((prim << tid_bits) | tid_c).to(torch.int32), C, sort)
        s_prim, s_tid = s >> tid_bits, s & ((1 << tid_bits) - 1)
    else:
        s = _smallest((prim.long() << 32) | tid_c.long(), C, sort)
        s_prim, s_tid = s >> 32, s & 0xFFFFFFFF
    mask = s_prim < big
    tbl_tid = torch.where(mask, s_tid, 0).to(torch.int32)
    tbl_score = torch.where(mask, (score_bound + 1) - s_prim, 0).to(torch.int32)
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


def sort_event_parts(parts: Sequence[torch.Tensor], sort: Sort = row_sort_wide) -> torch.Tensor:
    """Sort per-k [B, w_k] event-key parts into one ascending row.

    The parts pad with sentinels to a common power-of-two width and a
    power-of-two count and lie side by side in each row; one sort of
    every part, then rounds of the merge kernel (as the JAX package
    merges outside any kernel) combine neighbouring parts, so the merged
    row may exceed K4's widest.  The row holds the parts' keys plus
    sentinels, fully sorted.  With the plain sort the parts sort plainly
    and the merge rounds still run the merge kernel on a CUDA tensor
    (chip_smoke checks that kernel alone)."""
    if len(parts) == 1:
        return sort(parts[0])
    B = parts[0].shape[0]
    w = pow2ceil(max(p.shape[1] for p in parts))
    padded = [torch.nn.functional.pad(p, (0, w - p.shape[1]), value=I32_MAX) for p in parts]
    padded += [torch.full_like(padded[0], I32_MAX)] * (pow2ceil(len(parts)) - len(parts))
    runs = sort(torch.stack(padded, dim=1).view(-1, w))
    return merge_sorted_runs(runs.view(B, len(padded) * w), w)


def row_events_to_candidates(
    keym,
    *,
    num_k: int = 1,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int,
    sort: Sort = row_sort_wide,
) -> MatchResult:
    """Group event keys row-wise into per-read top-C candidates.

    keym: [B, W] int32 keys (INT32_MAX = empty, any lane order), tids
    when num_k == 1 and packed tid*K + k otherwise — or a list of per-k
    [B, w] parts, which sort_event_parts sorts and merges.
    sort: the row sort of any power-of-two width; row_sort_wide by
    default, its plain version (row_sort_plain) to check it.
    """
    K = num_k
    if num_transcripts * K >= I32_MAX:
        raise OverflowError(f"{num_transcripts} transcripts x {K} ks collide with the INT32_MAX event sentinel")
    keym = sort_event_parts(keym, sort) if isinstance(keym, (list, tuple)) else sort(keym)
    B, W = keym.shape
    i_idx = torch.arange(W, dtype=torch.int32, device=keym.device).expand(B, W)
    valid = keym != I32_MAX
    is_start = valid & (keym != _shift_right(keym, -1))
    is_end = valid & (keym != _shift_left(keym, I32_MAX - 1))
    # Count of each (tid, k) run, live at the run's END lane.
    start_pos = torch.cummax(torch.where(is_start, i_idx, -1), dim=1).values
    cnt_end = i_idx - start_pos + 1

    if K == 1:
        tid = keym
        score = torch.where(is_end, cnt_end, 0)
        meets = is_end & chain_passes(score, score.max(dim=1, keepdim=True).values, chain_fraction)
    else:
        # A tid's <= K runs are adjacent after the sort.  A run passes at
        # its END lane against its k's best count; a tid group meets iff
        # every run in it passes and it has a run for every k whose best
        # count is nonzero (a k without events passes vacuously).  Three
        # cumsums (runs, passing runs, counts) and cummax-propagated group
        # bases give the group sums with no scatter.
        tid = keym // K
        kid = keym - tid * K
        maxk = [torch.where(is_end & (kid == ki), cnt_end, 0).max(dim=1).values for ki in range(K)]
        mk = maxk[0][:, None].expand(B, W)
        for ki in range(1, K):
            mk = torch.where(kid == ki, maxk[ki][:, None], mk)
        ok_run = is_end & chain_passes(cnt_end, mk, chain_fraction)
        k_required = sum((m > 0).long() for m in maxk)
        is_tstart = valid & (tid != _shift_right(tid, -1))
        is_tend = valid & (tid != _shift_left(tid, I32_MAX))

        def group_sum(x):
            c = torch.cumsum(x.long(), dim=1)
            base = torch.cummax(torch.where(is_tstart, _shift_right(c, 0), 0), dim=1).values
            return c - base

        n_runs = group_sum(is_end)
        score = group_sum(torch.where(is_end, cnt_end, 0))
        meets = is_tend & (group_sum(ok_run) == n_runs) & (n_runs == k_required[:, None])
    # Scores count row lanes, so W bounds them.
    return _top_c_select(
        meets,
        tid,
        score,
        score_bound=W,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
        sort=sort,
    )


def combine_k_tables(
    tid_parts: Sequence[torch.Tensor],
    score_parts: Sequence[torch.Tensor],
    mask_parts: Sequence[torch.Tensor],
    *,
    candidate_capacity: int,
    score_bound: int,
    num_transcripts: int,
    sort: Sort = row_sort_wide,
) -> MatchResult:
    """Intersect K per-k top tables into the all-k candidates.

    Each per-k table already applied its k's threshold (a k without
    events gives an empty table), so a tid meets iff it appears in every
    non-empty table, and its score is the sum of its per-k scores.  The
    tables' (tid, score) lanes sort as one K4 int64 row of
    (tid << 32) | score; run lengths and cumsum-based run sums follow, and
    top-C selection as in row_events_to_candidates.
    """
    K = len(tid_parts)
    B = tid_parts[0].shape[0]
    Ck = pow2ceil(max(t.shape[1] for t in tid_parts))
    rows = []
    for t, s, m in zip(tid_parts, score_parts, mask_parts):
        key = (torch.where(m, t, I32_MAX).long() << 32) | torch.where(m, s, 0).long()
        rows.append(key)
        if key.shape[1] < Ck:
            rows.append(torch.full((B, Ck - key.shape[1]), _TABLE_SENTINEL, dtype=torch.int64, device=key.device))
    width = pow2ceil(K) * Ck
    filled = sum(r.shape[1] for r in rows)
    if filled < width:
        rows.append(torch.full((B, width - filled), _TABLE_SENTINEL, dtype=torch.int64, device=rows[0].device))
    s = sort(torch.cat(rows, dim=1))
    key, sc = s >> 32, s & 0xFFFFFFFF
    W = key.shape[1]
    valid = key != I32_MAX
    i_idx = torch.arange(W, dtype=torch.int64, device=key.device).expand(B, W)
    is_start = valid & (key != _shift_right(key, -1))
    is_end = valid & (key != _shift_left(key, I32_MAX - 1))
    start_pos = torch.cummax(torch.where(is_start, i_idx, -1), dim=1).values
    run_len = i_idx - start_pos + 1
    # Scores are >= 0, so the cumsum is nondecreasing and a cummax
    # propagates each run's base.
    c_sc = torch.cumsum(sc, dim=1)
    run_score = c_sc - torch.cummax(torch.where(is_start, _shift_right(c_sc, 0), 0), dim=1).values
    k_req = sum(m.any(dim=1).long() for m in mask_parts)
    return _top_c_select(
        is_end & (run_len == k_req[:, None]),
        torch.where(valid, key, 0),
        run_score,
        score_bound=score_bound,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
        sort=sort,
    )


def group_parts_per_k(
    parts: Sequence[torch.Tensor],
    *,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int,
    sort: Sort = row_sort_wide,
) -> MatchResult:
    """Group K > 1 per-k [B, W_k] tid event rows: each k groups alone
    into a top-Ck table, Ck = min(2C, W_k) (W_k lanes hold at most W_k
    tids), and the tables intersect (combine_k_tables).

    stats: candidate_spilled counts the final truncation at C;
    candidate_spilled_per_k the passing tids each k's table could not
    hold — any of those makes the intersection inexact, and the caller
    regroups in merged mode."""
    C = candidate_capacity
    res_ks = [
        row_events_to_candidates(
            p,
            chain_fraction=chain_fraction,
            candidate_capacity=min(2 * C, p.shape[1]),
            num_transcripts=num_transcripts,
            sort=sort,
        )
        for p in parts
    ]
    res = combine_k_tables(
        [r.tid for r in res_ks],
        [r.score for r in res_ks],
        [r.mask for r in res_ks],
        candidate_capacity=C,
        score_bound=sum(p.shape[1] for p in parts),
        num_transcripts=num_transcripts,
        sort=sort,
    )
    res.stats["candidate_spilled_per_k"] = sum(r.stats["candidate_spilled"] for r in res_ks)
    return res


def group_event_parts(
    parts: Sequence[torch.Tensor],
    *,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int,
    per_k_tables: bool = True,
    sort: Sort = row_sort_wide,
) -> MatchResult:
    """Group per-k [B, W_k] tid event rows into top-C candidates (the JAX
    package's _group_tier_parts): one k groups directly; several ks per k
    and intersect (per_k_tables), or as one merged row of packed
    tid*K + k keys, which truncates only the final candidate set.
    stats always carry candidate_spilled_per_k (0 unless per k).

    With the default sort, a batch that group_kernel_takes (on a card, rows
    of at most 1,024 lanes, one k or per-k tables) groups in one launch of
    G; any other batch, or another sort (the plain one, to check the
    kernels), takes group_event_parts_plain.  The two give equal tables
    and stats."""
    if sort is row_sort_wide and group_kernel_takes([x.shape[1] for x in parts], per_k_tables, parts[0].device):
        if num_transcripts >= I32_MAX:
            raise OverflowError(f"{num_transcripts} transcripts collide with the INT32_MAX event sentinel")
        C = candidate_capacity
        caps = [C] if len(parts) == 1 else [min(2 * C, x.shape[1]) for x in parts]
        p, q = _fraction_compare_params(chain_fraction)
        tid, score, mask, stats = group_rows(parts, caps, C, (p, q, chain_fraction))
        return MatchResult(tid=tid, score=score, mask=mask,
                           stats={"candidate_spilled": stats[0], "candidate_spilled_per_k": stats[1]})
    return group_event_parts_plain(parts, chain_fraction=chain_fraction, candidate_capacity=candidate_capacity,
                                   num_transcripts=num_transcripts, per_k_tables=per_k_tables, sort=sort)


def group_event_parts_plain(
    parts: Sequence[torch.Tensor],
    *,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int,
    per_k_tables: bool = True,
    sort: Sort = row_sort_wide,
) -> MatchResult:
    """group_event_parts by the chain of row sorts and PyTorch operations
    (row_events_to_candidates, group_parts_per_k): G's plain version."""
    K = len(parts)
    kw = dict(
        chain_fraction=chain_fraction,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
        sort=sort,
    )
    if K > 1 and per_k_tables:
        return group_parts_per_k(parts, **kw)
    if K == 1:
        res = row_events_to_candidates(parts[0], **kw)
    else:
        packed = [torch.where(p != I32_MAX, p * K + ki, I32_MAX) for ki, p in enumerate(parts)]
        res = row_events_to_candidates(packed, num_k=K, **kw)
    res.stats["candidate_spilled_per_k"] = torch.zeros((), dtype=torch.int64, device=res.tid.device)
    return res
