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

  scatter  `index_add_`; on CUDA its atomics add in a varying order, so
           float64 results may move in the last ulp between runs;
  segsum   (use_segsum) the lanes sorted by transcript once (a plan,
           em/segsum.py, shared by the loop and the assignment), each sum
           a segmented sum in a fixed order: bit-identical run to run.
           Each sum counts em.segsum_sums on the quant call's timer.

Both routes compute the posteriors on the tables' lanes in one flat
order (table by table, row-major; _lanes), a few whole-lane operations
an iteration whatever the number of tables: the loop is bound by the
host's dispatch on a card.

em_segsum "auto" decides by the tables' device: segsum on CUDA, where
the kernel S sums GENCODE-width tiers ~37x faster than index_add_ on an
H100 (index_add_'s atomics queue on transcript 0, which every padding
lane of the tiers carries), and the scatter on the CPU, where segsum is
the slow plain version and the JAX package's choice off a TPU stays
mirrored.  The JAX package has a third route, the one-hot E-step
(em_mxu), which it takes by itself only on a TPU.  The port has none:
em_mxu "on" takes the scatter route, with segsum off, as the JAX package
turns it off.

With a `group` (a mesh's data group, dist/mesh.py) the tables are this
rank's share of the reads: each iteration all-reduces the posterior sums
over the group once (the JAX package's axis_name="data" psum), and the
assignment its counts and entry marks.  A rank's static_base folds in
before the all-reduce, so every rank's is totalled exactly once;
num_reads is the global read count.  Every rank of the group reads the
same all-reduced pi, so all stop on the same iteration.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from sketch_rna_tpu_torch.dist.collectives import all_reduce_sum
from sketch_rna_tpu_torch.em.classes import Table
from sketch_rna_tpu_torch.em.segsum import SegsumPlan, plan_from_tables, segsum_apply
from sketch_rna_tpu_torch.utils.timing import count

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def em_route_name(em_mxu: str, em_segsum: str, device_type: str = "cpu") -> str:
    """"scatter" or "segsum": the route of config.em_mxu / em_segsum ("auto"
    | "on" | "off") for tables on a device of device_type.  Never segsum
    beside the one-hot step, which is the scatter here; "auto" is segsum
    on CUDA alone (module docstring), so on the CPU the route is the JAX
    package's off a TPU: segsum only when asked for."""
    if em_mxu == "on" or em_segsum == "off":
        return "scatter"
    return "segsum" if em_segsum == "on" or device_type == "cuda" else "scatter"


def em_route(tables: Sequence[Table], num_transcripts: int, config) -> dict:
    """run_em_tables' and assign_reads_tables' route keywords for these
    tables and a QuantConfig: use_segsum and, with it, the plan built once
    for the loop, every checkpoint segment and the assignment."""
    device_type = tables[0][0].device.type
    use_segsum = em_route_name(config.em_mxu, config.em_segsum, device_type) == "segsum"
    plan = plan_from_tables(tables, num_transcripts) if use_segsum else None
    return dict(use_segsum=use_segsum, segsum_plan=plan)


class _Lanes(NamedTuple):
    """The tables' lanes in one flat order (table by table, row-major):
    the order both routes sum in, and the plan's."""

    tid: torch.Tensor  # [n] int64
    score: torch.Tensor  # [n] of the EM's dtype
    weight: Optional[torch.Tensor]  # [n] the lane's row multiplicity (1 in a table without); None: no table has one
    row: torch.Tensor  # [n] int64: the lane's row among all tables' rows
    shapes: Tuple[Tuple[int, int], ...]  # each table's (rows, width)


def _lanes(tables: Sequence[Table], dt: torch.dtype) -> _Lanes:
    """The tables' lanes, once a call: the loop's iterations share them."""
    dev = tables[0][0].device
    shapes = tuple((int(t[0].shape[0]), int(t[0].shape[1])) for t in tables)
    starts = itertools.accumulate((n for n, _ in shapes), initial=0)
    row = torch.cat([torch.arange(n * k, device=dev) // max(k, 1) + r0 for (n, k), r0 in zip(shapes, starts)])
    weight = None
    if any(t[2] is not None for t in tables):
        weight = torch.cat([(torch.ones(n, dtype=dt, device=dev) if t[2] is None else t[2].to(dt))[:, None]
                            .expand(n, k).reshape(-1) for t, (n, k) in zip(tables, shapes)])
    return _Lanes(torch.cat([t[0].reshape(-1) for t in tables]).long(),
                  torch.cat([t[1].reshape(-1) for t in tables]).to(dt), weight, row, shapes)


def _row_sums(lanes: _Lanes, w: torch.Tensor) -> torch.Tensor:
    """[rows] sum of each row's lanes of w [n]: each table's [rows, width]
    view summed along its rows, as the table itself would be."""
    out = w.new_empty(sum(n for n, _ in lanes.shapes))
    lane = row = 0
    for n, k in lanes.shapes:
        torch.sum(w[lane : lane + n * k].view(n, k), dim=1, out=out[row : row + n])
        lane, row = lane + n * k, row + n
    return out


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
    lanes = _lanes(tables, dt)
    dev = lanes.tid.device
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
        w = pi[lanes.tid] * lanes.score
        denom = _row_sums(lanes, w)
        post = w * torch.where(denom > eps, 1.0 / denom, 0.0)[lanes.row]
        if lanes.weight is not None:
            post = post * lanes.weight
        if plan is not None:
            ps = ps + segsum_apply(plan, post)
            count("em.segsum_sums")
        else:
            ps.index_add_(0, lanes.tid, post)
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
    lanes = _lanes(tables, dt)
    w = pi[lanes.tid] * lanes.score
    denom = _row_sums(lanes, w)
    ok = denom > 0
    prob = w * torch.where(ok, 1.0 / torch.where(ok, denom, 1.0), 0.0)[lanes.row]
    contributes = (lanes.score > 0) & ok[lanes.row]
    if lanes.weight is not None:
        prob = prob * lanes.weight
        contributes = contributes & (lanes.weight > 0)
    if plan is None:
        # The scatter adds into the folded base; segsum adds it after its
        # sums, as the JAX package does.
        weighted = torch.zeros(T, dtype=dt, device=dev) if static_base is None else static_base.to(dt, copy=True)
        has = torch.zeros(T, dtype=torch.int64, device=dev)
        if static_has is not None:
            has = static_has.to(torch.int64, copy=True)
        weighted.index_add_(0, lanes.tid, prob)
        has.index_add_(0, lanes.tid, contributes.long())
    else:
        weighted = segsum_apply(plan, prob)
        has = segsum_apply(plan, contributes.to(torch.int32)).long()
        count("em.segsum_sums", 2)
        if static_base is not None:
            weighted = weighted + static_base.to(dt)
        if static_has is not None:
            has = has + static_has.to(torch.int64)
    return all_reduce_sum(weighted, group), all_reduce_sum(has, group) > 0
