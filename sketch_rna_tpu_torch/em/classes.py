"""Equivalence-class reduction for the EM.

Reads with identical candidate profiles (same transcripts, same match
counts) receive identical E-step posteriors, so the EM iterates over
DISTINCT profiles weighted by multiplicity.  Summing m identical
posterior vectors equals m times one of them, so the per-read math of
the reference is unchanged.

`torch.unique(dim=0)` over the (tid, score) rows merges exactly the
identical rows (the JAX package merges rows whose 128-bit hashes agree,
which equals this barring a hash collision).  Rows that already carry a
weight (the streaming engine's classes of earlier chunks) merge the same
way, their weights summed: grouping composes with weights.  The JAX
package's narrow/mid/pair width tiers save TPU scatter lanes; here one
weighted table suffices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Table = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


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


def build_class_tables(
    tbl_tid: torch.Tensor,
    tbl_score: torch.Tensor,
    *,
    num_transcripts: int,
    fold: bool,
    row_weight: Optional[torch.Tensor] = None,
) -> Tuple[Table, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Collapse [N, W] candidate tables (rank-ordered, zero-padded) into
    weighted class tables.

    With fold=True, classes with exactly one candidate leave the loop
    table: their E-step posterior is identically 1 (the reference
    computes x/x, src/isoform_assignment.cpp:38-47), so they add the
    constant static_base [T] (their multiplicities) to every posterior
    sum and to the final counts, and static_has [T] marks their CSV rows.
    Candidate-less classes are dropped too: they contribute nothing.

    row_weight: [N] multiplicity of each row (1 for every row when None).

    Returns ((tid, score, weight), static_base, static_has); the static
    pair is (None, None) unless fold.
    """
    if row_weight is None:
        W = tbl_tid.shape[1]
        rows, counts = torch.unique(torch.cat([tbl_tid, tbl_score], dim=1), dim=0, return_counts=True)
        tid, score, weight = rows[:, :W], rows[:, W:], counts
    else:
        tid, score, weight = group_rows(tbl_tid, tbl_score, row_weight)
    if not fold:
        return (tid, score, weight), None, None
    n_cand = (score > 0).sum(dim=1)
    single = n_cand == 1
    tid0 = tid[single, 0].long()
    static_base = torch.zeros(num_transcripts, dtype=torch.int64, device=tid.device)
    static_base.index_add_(0, tid0, weight[single])
    static_has = torch.zeros(num_transcripts, dtype=torch.bool, device=tid.device)
    static_has[tid0] = True
    loop = n_cand > 1
    return (tid[loop], score[loop], weight[loop]), static_base, static_has
