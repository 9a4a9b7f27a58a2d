"""EM abundance estimation + soft read assignment over candidate tables.

The loop math follows the reference (src/isoform_assignment.cpp:9-97)
exactly as sketch_rna_tpu/em/em.py does:

  E-step   w[r, j]  = pi[tid[r, j]] * score[r, j]
           post     = w / sum_j w   (0 when the sum is <= epsilon)
  M-step   pi'      = (sum of posteriors per transcript + pc/R) + pc,
           with the float32 `pseudocount / R` term and the C++
           left-to-right addition order,
  stop     when sum |pi' - pi| < convergence threshold, or at
           max_iterations.

The loop runs over one or several tables (the streaming engine's narrow
and wide class buffers); their posterior sums add into one [T] vector
per iteration.  Rows may carry a multiplicity `weight` (equivalence
classes, em/classes.py); `static_base` adds folded single-candidate
classes.  Convergence is tested on the host once per iteration; each
iteration counts em.iterations on the quant call's timer (utils/timing.py).
`init_pi` and `start_iteration` resume from a checkpoint
(em/checkpoint.py).

Two routes for the per-transcript sums (em_route):

  scatter  (the default) `index_add_`; on CUDA its atomics add in a
           varying order, so float64 results may move in the last ulp
           between runs;
  segsum   (use_segsum) the lanes sorted by transcript once (a plan,
           em/segsum.py, shared by the loop and the assignment), each sum
           a segmented sum in a fixed order: bit-identical run to run.

The JAX package has a third, the one-hot E-step (em_mxu), which it takes
by itself only on a TPU.  The port has none: em_mxu "on" takes the
scatter route, which is faster on a GPU.

With a `group` (a mesh's data group, dist/mesh.py) the tables are this
rank's share of the reads: each iteration all-reduces the posterior sums
over the group once (the JAX package's axis_name="data" psum), and the
assignment its counts and entry marks.  A rank's static_base folds in
before the all-reduce, so every rank's is totalled exactly once;
num_reads is the global read count.  Every rank of the group reads the
same all-reduced pi, so all stop on the same iteration.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from sketch_rna_tpu_torch.dist.collectives import all_reduce_sum
from sketch_rna_tpu_torch.em.classes import Table
from sketch_rna_tpu_torch.em.segsum import SegsumPlan, plan_from_tables, segsum_apply
from sketch_rna_tpu_torch.utils.timing import count

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def em_route_name(em_mxu: str, em_segsum: str) -> str:
    """"scatter" or "segsum": the route of config.em_mxu / em_segsum ("auto"
    | "on" | "off").  As in the JAX package off a TPU, segsum only when
    asked for and never beside the one-hot step; that step itself is the
    scatter here."""
    return "segsum" if em_segsum == "on" and em_mxu != "on" else "scatter"


def em_route(tables: Sequence[Table], num_transcripts: int, config) -> dict:
    """run_em_tables' and assign_reads_tables' route keywords for these
    tables and a QuantConfig: use_segsum and, with it, the plan built once
    for the loop, every checkpoint segment and the assignment."""
    use_segsum = em_route_name(config.em_mxu, config.em_segsum) == "segsum"
    plan = plan_from_tables(tables, num_transcripts) if use_segsum else None
    return dict(use_segsum=use_segsum, segsum_plan=plan)


def _unpack(table: Table, dt: torch.dtype):
    tid, score, weight = table
    wgt = None if weight is None else weight.to(dt)[:, None]
    return tid.long(), score.to(dt), wgt


def _plan(tables, T: int, use_segsum: bool, plan: Optional[SegsumPlan]) -> Optional[SegsumPlan]:
    if not use_segsum:
        return None
    return plan if plan is not None else plan_from_tables(tables, T)


def run_em_tables(
    tables: Sequence[Table],
    num_reads: int,
    *,
    num_transcripts: int,
    max_iterations: int = 20,
    convergence_threshold: float = 0.01,
    pseudocount: float = 0.01,
    epsilon: float = 1e-10,
    dtype: str = "float32",
    static_base: Optional[torch.Tensor] = None,
    init_pi: Optional[torch.Tensor] = None,
    start_iteration: int = 0,
    group=None,
    use_segsum: bool = False,
    segsum_plan: Optional[SegsumPlan] = None,
) -> Tuple[torch.Tensor, int, bool]:
    """Run the EM loop from iteration start_iteration (pi init_pi, or
    uniform) up to max_iterations.  use_segsum picks the segsum route
    (module docstring); segsum_plan: a plan of these tables built
    earlier (else one is built here).

    Returns (pi [T], iterations done, converged): converged tells an
    early stop from reaching max_iterations, so a run split into
    segments stops exactly where an uninterrupted one would.
    """
    T = num_transcripts
    dt = _DTYPES[dtype]
    prepped = [_unpack(table, dt) for table in tables]
    dev = prepped[0][0].device
    base = None if static_base is None else static_base.to(dt)
    plan = _plan(tables, T, use_segsum, segsum_plan)
    if init_pi is None:
        pi = torch.full((T,), 1.0 / T, dtype=dt, device=dev)
    else:
        pi = init_pi.to(dev, dt)
    # C++: float pseudocount = 0.01; 'pseudocount / R' divides in float32
    # (size_t -> float), and each addition then promotes.
    pcf = torch.tensor(pseudocount, dtype=torch.float32)
    term_div = (pcf / torch.tensor(float(num_reads), dtype=torch.float32)).to(dev, dt)
    term_pc = pcf.to(dev, dt)
    eps = torch.tensor(epsilon, dtype=dt, device=dev)
    threshold = torch.tensor(convergence_threshold, dtype=dt, device=dev)
    iterations = start_iteration
    converged = False
    while iterations < max_iterations and not converged:
        ps = torch.zeros(T, dtype=dt, device=dev) if base is None else base.clone()
        flats = []
        for tid, sc, wgt in prepped:
            w = pi[tid] * sc
            denom = w.sum(dim=1, keepdim=True)
            post = w * torch.where(denom > eps, 1.0 / denom, 0.0)
            if wgt is not None:
                post = post * wgt
            if plan is not None:
                flats.append(post.reshape(-1))
            else:
                ps.index_add_(0, tid.reshape(-1), post.reshape(-1))
        if plan is not None:
            ps = ps + segsum_apply(plan, torch.cat(flats))
        ps = all_reduce_sum(ps, group)
        new_pi = (ps + term_div) + term_pc
        change = (new_pi - pi).abs().sum()
        pi = new_pi
        iterations += 1
        count("em.iterations")
        converged = bool(change < threshold)
    return pi, iterations, converged


def assign_reads_tables(
    tables: Sequence[Table],
    pi: torch.Tensor,
    *,
    num_transcripts: int,
    dtype: str = "float32",
    static_base: Optional[torch.Tensor] = None,
    static_has: Optional[torch.Tensor] = None,
    group=None,
    use_segsum: bool = False,
    segsum_plan: Optional[SegsumPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft assignment with the final pi, by the route run_em_tables
    takes for the same flags (the segsum route sums the weighted counts
    and the entry counts through the plan: two segmented sums).

    Returns (weighted_counts [T], has_entry [T] bool); has_entry marks the
    transcripts that are a candidate of >= 1 read with total probability
    > 0 — the reference's CSV row filter (src/data_io.cpp:143-147).
    """
    T = num_transcripts
    dt = _DTYPES[dtype]
    dev = pi.device
    plan = _plan(tables, T, use_segsum, segsum_plan)
    # The scatter route adds into the folded base; segsum adds it after
    # its sums, as the JAX package does.
    weighted = torch.zeros(T, dtype=dt, device=dev)
    has = torch.zeros(T, dtype=torch.int64, device=dev)
    if plan is None and static_base is not None:
        weighted = static_base.to(dt, copy=True)
    if plan is None and static_has is not None:
        has = static_has.to(torch.int64, copy=True)
    prob_flats, contrib_flats = [], []
    for table in tables:
        tid, sc, wgt = _unpack(table, dt)
        w = pi[tid] * sc
        denom = w.sum(dim=1, keepdim=True)
        ok = denom > 0
        prob = w * torch.where(ok, 1.0 / torch.where(ok, denom, 1.0), 0.0)
        contributes = (sc > 0) & ok
        if wgt is not None:
            prob = prob * wgt
            contributes = contributes & (wgt > 0)
        flat_tid = tid.reshape(-1)
        if plan is not None:
            prob_flats.append(prob.reshape(-1))
            contrib_flats.append(contributes.reshape(-1).to(torch.int32))
        else:
            weighted.index_add_(0, flat_tid, prob.reshape(-1))
            has.index_add_(0, flat_tid, contributes.reshape(-1).long())
    if plan is not None:
        weighted = segsum_apply(plan, torch.cat(prob_flats))
        has = segsum_apply(plan, torch.cat(contrib_flats)).long()
        if static_base is not None:
            weighted = weighted + static_base.to(dt)
        if static_has is not None:
            has = has + static_has.to(torch.int64)
    return all_reduce_sum(weighted, group), all_reduce_sum(has, group) > 0
