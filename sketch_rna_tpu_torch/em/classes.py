"""Equivalence-class reduction and the width-tiered EM tables.

Reads with identical candidate profiles (same transcripts, same match
counts) receive identical E-step posteriors, so the EM iterates over
DISTINCT profiles weighted by multiplicity.  Summing m identical
posterior vectors equals m times one of them, so the per-read math of
the reference is unchanged.

`torch.unique(dim=0)` over the (tid, score) rows merges exactly the
identical rows (the JAX package merges rows whose 128-bit hashes agree,
which equals this barring a hash collision).  Rows that already carry a
weight (the streaming engine's classes of earlier chunks) merge the same
way, their weights summed: grouping composes with weights.

The table width W is set by the most ambiguous read, while most classes
have a handful of candidates.  So the classes split by candidate count
into width tiers (the JAX package's em/classes.py plan_class_tables and
tier_partition): pair [*, 2] (exactly two), narrow [*, 4], mid [*, 8]
and wide [*, W].  Each iteration's posterior sum then runs over lanes
close to the true candidate count, not over the zero padding of a
single [M, W] table.  Exact: every class sits in exactly one tier, and a
tier cuts a row only where all its remaining lanes are zero (class rows
are rank-ordered).  Unlike the JAX package, whose static shapes round
each tier's rows up, every tier here holds its classes and no others.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

Table = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]

# tier_partition's tier ids, in the order the tables come out (the JAX
# package's); FOLDED marks the rows that leave the loop.
WIDE, MID, NARROW, PAIR, FOLDED = range(5)


class TierPlan(NamedTuple):
    """plan_class_tables' decisions (the JAX plan's flags and widths)."""

    split: bool  # a wide (and maybe a mid) tier apart from the narrow one
    fold: bool  # singletons leave the loop (static_base / static_has)
    mid_active: bool
    pair_active: bool
    out_width: int  # the wide tier's width; the narrow tier's when not split
    narrow_width: int
    mid_width: int


def group_rows(
    tid: torch.Tensor,
    score: torch.Tensor,
    weight: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge identical (tid, score) rows of [N, W] tables, summing their
    [N] int64 weights.  Exact (no hash); the distinct rows come back in
    ascending lexicographic order with their summed weights."""
    W = tid.shape[1]
    rows, inverse = torch.unique(torch.cat([tid, score], dim=1), dim=0, return_inverse=True)
    summed = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    summed.index_add_(0, inverse, weight.to(torch.int64))
    return rows[:, :W], rows[:, W:], summed


def plan_class_tables(
    n_cand_counts: Sequence[int],
    *,
    width: int,
    n_rows: int,
    narrow_width: int,
    mid_width: int,
    pair_width: int,
    fold_singletons: bool,
) -> TierPlan:
    """The tiers to build (sketch_rna_tpu/em/classes.py plan_class_tables'
    decisions, without its padded sizes).

    n_cand_counts[c]: the live classes (weight > 0) with exactly c
    candidates, c = 0 .. width.  n_rows: the row count of the tables the
    classes came from, as the engine counts them; as in the JAX plan, no
    tier splits off and nothing folds below 1024.  A mid tier needs
    width > mid_width, a pair tier pair_width == 2 < narrow_width; with
    no class wider than narrow_width every row fits narrow_width lanes.
    """
    big = n_rows >= 1024
    n_wide = sum(n_cand_counts[narrow_width + 1 :])
    n_mid = sum(n_cand_counts[narrow_width + 1 : mid_width + 1]) if mid_width > narrow_width else 0
    n_tail1 = sum(n_cand_counts[:2])
    n_pair = n_cand_counts[2] if len(n_cand_counts) > 2 else 0
    split = width > narrow_width and n_wide > 0 and big
    return TierPlan(
        split=split,
        fold=bool(fold_singletons) and n_tail1 > 0 and big,
        mid_active=split and mid_width > narrow_width and width > mid_width and n_mid > 0,
        pair_active=pair_width == 2 and narrow_width > 2 and n_pair > 0 and big,
        out_width=narrow_width if (width > narrow_width and n_wide == 0) else width,
        narrow_width=narrow_width,
        mid_width=mid_width,
    )


def tier_partition(
    tid: torch.Tensor,
    score: torch.Tensor,
    weight: torch.Tensor,
    plan: TierPlan,
    *,
    num_transcripts: int,
) -> Tuple[List[Table], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Split class tables ([M, W] rank-ordered rows, [M] weights, 0 = a
    dead row) into the plan's tiers (sketch_rna_tpu/em/classes.py
    tier_partition): the tables wide [*, out_width], mid [*, mid_width],
    narrow [*, narrow_width, or out_width when not split] and pair
    [*, 2], in that order, each at its exact row count.  An empty tier is
    left out, but at least one table comes back (with no rows when every
    class folds), on the classes' device.

    With plan.fold, classes with exactly one candidate leave the loop:
    their E-step posterior is identically 1 (the reference computes x/x,
    src/isoform_assignment.cpp:38-47), so they add the constant
    static_base [T] (their multiplicities) to every posterior sum and to
    the final counts, and static_has [T] marks their CSV rows.
    Candidate-less classes leave with them: they contribute nothing.
    Returns (tables, static_base, static_has); the static pair is
    (None, None) unless plan.fold.
    """
    n_cand = (score > 0).sum(dim=1)
    live = weight > 0
    static_base = static_has = None
    if plan.fold:
        single = (n_cand == 1) & live
        tid0 = tid[single, 0].long()
        static_base = torch.zeros(num_transcripts, dtype=torch.int64, device=tid.device)
        static_base.index_add_(0, tid0, weight[single].to(torch.int64))
        static_has = torch.zeros(num_transcripts, dtype=torch.bool, device=tid.device)
        static_has[tid0] = True

    tier = torch.full_like(n_cand, NARROW)
    if plan.split:
        tier = torch.where(n_cand > plan.narrow_width, WIDE, tier)
        if plan.mid_active:
            tier = torch.where((n_cand > plan.narrow_width) & (n_cand <= plan.mid_width), MID, tier)
    if plan.pair_active:
        tier = torch.where(n_cand == 2, PAIR, tier)
    if plan.fold:
        tier = torch.where(n_cand <= 1, FOLDED, tier)
    tier = torch.where(live, tier, FOLDED)
    counts = torch.bincount(tier, minlength=FOLDED + 1).tolist()
    order = torch.argsort(tier, stable=True)

    narrow_w = plan.narrow_width if plan.split else plan.out_width
    widths = {WIDE: plan.out_width, MID: plan.mid_width, NARROW: narrow_w, PAIR: min(2, narrow_w)}
    tables: List[Table] = []
    start = 0
    for t in (WIDE, MID, NARROW, PAIR):
        rows = order[start : start + counts[t]]
        start += counts[t]
        if counts[t]:
            w = widths[t]
            tables.append((tid[:, :w][rows], score[:, :w][rows], weight[rows]))
    if not tables:
        tables.append((tid[:0, :narrow_w], score[:0, :narrow_w], weight[:0]))
    return tables, static_base, static_has


def build_class_tables(
    tbl_tid: torch.Tensor,
    tbl_score: torch.Tensor,
    *,
    num_transcripts: int,
    fold: bool,
    n_rows: int,
    narrow_width: int,
    mid_width: int,
    pair_width: int,
    row_weight: Optional[torch.Tensor] = None,
) -> Tuple[List[Table], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Collapse [N, W] candidate tables (rank-ordered, zero-padded) into
    weighted classes and split them into width tiers: the counterpart of
    the JAX package's group_candidate_rows_meta -> plan_class_tables ->
    build_class_tables.

    fold: whether singletons may fold (pipeline._fold_ok); n_rows and the
    widths: plan_class_tables'.  row_weight: [N] multiplicity of each row
    (1 for every row when None).  Returns tier_partition's (tables,
    static_base, static_has).
    """
    W = tbl_tid.shape[1]
    if row_weight is None:
        rows, counts = torch.unique(torch.cat([tbl_tid, tbl_score], dim=1), dim=0, return_counts=True)
        tid, score, weight = rows[:, :W], rows[:, W:], counts
    else:
        tid, score, weight = group_rows(tbl_tid, tbl_score, row_weight)
    n_cand = (score > 0).sum(dim=1)
    # Live classes by candidate count (dead ones counted past W, dropped).
    hist = torch.bincount(torch.where(weight > 0, n_cand, W + 1), minlength=W + 2).tolist()[: W + 1]
    plan = plan_class_tables(hist, width=W, n_rows=n_rows, narrow_width=narrow_width, mid_width=mid_width,
                             pair_width=pair_width, fold_singletons=fold)
    return tier_partition(tid, score, weight, plan, num_transcripts=num_transcripts)
