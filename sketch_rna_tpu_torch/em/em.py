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
classes.  Sums use `index_add_`; on CUDA its atomics add in a varying
order, so float64 results may move in the last ulp between runs.
Convergence is tested on the host once per iteration.  `init_pi` and
`start_iteration` resume from a checkpoint (em/checkpoint.py).

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

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _unpack(table: Table, dt: torch.dtype):
    tid, score, weight = table
    wgt = None if weight is None else weight.to(dt)[:, None]
    return tid.long(), score.to(dt), wgt


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
) -> Tuple[torch.Tensor, int, bool]:
    """Run the EM loop from iteration start_iteration (pi init_pi, or
    uniform) up to max_iterations.

    Returns (pi [T], iterations done, converged): converged tells an
    early stop from reaching max_iterations, so a run split into
    segments stops exactly where an uninterrupted one would.
    """
    T = num_transcripts
    dt = _DTYPES[dtype]
    prepped = [_unpack(table, dt) for table in tables]
    dev = prepped[0][0].device
    base = None if static_base is None else static_base.to(dt)
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
        for tid, sc, wgt in prepped:
            w = pi[tid] * sc
            denom = w.sum(dim=1, keepdim=True)
            post = w * torch.where(denom > eps, 1.0 / denom, 0.0)
            if wgt is not None:
                post = post * wgt
            ps.index_add_(0, tid.reshape(-1), post.reshape(-1))
        ps = all_reduce_sum(ps, group)
        new_pi = (ps + term_div) + term_pc
        change = (new_pi - pi).abs().sum()
        pi = new_pi
        iterations += 1
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft assignment with the final pi.

    Returns (weighted_counts [T], has_entry [T] bool); has_entry marks the
    transcripts that are a candidate of >= 1 read with total probability
    > 0 — the reference's CSV row filter (src/data_io.cpp:143-147).
    """
    T = num_transcripts
    dt = _DTYPES[dtype]
    dev = pi.device
    weighted = torch.zeros(T, dtype=dt, device=dev) if static_base is None else static_base.to(dt, copy=True)
    has = torch.zeros(T, dtype=torch.int64, device=dev) if static_has is None else static_has.to(torch.int64, copy=True)
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
        weighted.index_add_(0, flat_tid, prob.reshape(-1))
        has.index_add_(0, flat_tid, contributes.reshape(-1).long())
    return all_reduce_sum(weighted, group), all_reduce_sum(has, group) > 0
