"""Scatter-free, deterministic posterior sums for the EM
(sketch_rna_tpu/em/segsum.py's counterpart).

The EM's hot sum is ps[t] = sum of the lanes' values whose transcript is
t.  The lane -> transcript keys are the same in every iteration and in
the assignment, so the lanes are sorted by transcript ONCE
(build_segsum_plan) and each sum reduces contiguous runs (segsum_apply):

  1. gather the values into the sorted order, in blocks of BLOCK lanes;
  2. a segmented inclusive scan over each block: every run's partial sum
     lands on its last lane of the block;
  3. ps[t] = the partial at t's last lane, plus, for a run that spans
     block boundaries, the partials at the last lanes of the earlier
     blocks it covers, summed pairwise in a fixed tree.

Every addition combines lanes of one run, so float error stays relative
to each transcript's own sum, as with a scatter.  Unlike the scatter's
atomics (index_add_ on CUDA), the order of every addition is fixed: the
scan is a Hillis-Steele tree, step d combining lane i with lane i - d for
d = 1, 2, .., 256, and the carries a fixed pairwise tree.  So a sum is
bit-identical from run to run, and the plain version below follows the
same tree, so kernel and plain agree bit for bit.

The plan equals the JAX package's field for field (its six arrays, its
block width and its stable sort); the sum agrees with the JAX
associative_scan, whose tree differs, within float rounding.

segsum_apply is the wrapper: on a CUDA tensor the kernel S
(csrc/segsum.cu), on a CPU tensor the plain version segsum_plain.  It
takes float64, float32 and int32 values (the assignment sums its entry
counts through it too).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from sketch_rna_tpu_torch import kernels

BLOCK = 512

_LAUNCH = {torch.float64: "segsum_f64_launch", torch.float32: "segsum_f32_launch",
           torch.int32: "segsum_i32_launch"}


class SegsumPlan(NamedTuple):
    perm: torch.Tensor  # [n_pad] int32: sorted lane -> flat lane it comes from
    is_start: torch.Tensor  # [nblk, BLOCK] bool: a run starts at this lane of its block
    seg_end: torch.Tensor  # [T] int32: t's last sorted lane (clamped)
    seg_live: torch.Tensor  # [T] bool: t has a lane
    carry_tid: torch.Tensor  # [nblk] int32: tid of the block's last lane (0 unless carry_on)
    carry_on: torch.Tensor  # [nblk] bool: that run continues into the next block

    @property
    def num_transcripts(self) -> int:
        return int(self.seg_end.shape[0])


def build_segsum_plan(flat_tid: torch.Tensor, num_transcripts: int) -> SegsumPlan:
    """The plan over [n] lane transcripts in flat order.  Lanes pad to
    whole blocks with the sentinel T, which sorts past every transcript;
    the sort is stable, so equal transcripts keep their flat order."""
    T = num_transcripts
    dev = flat_tid.device
    tid = flat_tid.reshape(-1).to(torch.int32)
    n = int(tid.shape[0])
    nblk = max(-(-n // BLOCK), 1)
    n_pad = nblk * BLOCK
    if n_pad > n:
        tid = torch.cat([tid, torch.full((n_pad - n,), T, dtype=torch.int32, device=dev)])
    sorted_tid, perm = torch.sort(tid, stable=True)
    pos = torch.searchsorted(sorted_tid, torch.arange(T + 1, dtype=torch.int32, device=dev)).to(torch.int32)
    seg_len = pos[1:] - pos[:-1]
    seg_end = torch.clamp(pos[1:] - 1, 0, n_pad - 1)
    st2 = sorted_tid.view(nblk, BLOCK)
    is_start = torch.cat([torch.ones((nblk, 1), dtype=torch.bool, device=dev), st2[:, 1:] != st2[:, :-1]], dim=1)
    carry_tid = st2[:, -1]
    cont = torch.zeros(nblk, dtype=torch.bool, device=dev)
    cont[:-1] = st2[1:, 0] == st2[:-1, -1]
    carry_on = cont & (carry_tid < T)
    return SegsumPlan(
        perm=perm.to(torch.int32),
        is_start=is_start,
        seg_end=seg_end,
        seg_live=seg_len > 0,
        carry_tid=torch.where(carry_on, carry_tid, torch.zeros_like(carry_tid)),
        carry_on=carry_on,
    )


def plan_from_tables(tables: Sequence, num_transcripts: int) -> SegsumPlan:
    """The plan over (tid, score, weight) tables' concatenated flat tid
    lanes: the order the EM flattens its values in."""
    return build_segsum_plan(torch.cat([t[0].reshape(-1) for t in tables]), num_transcripts)


def _check(plan: SegsumPlan, flat_vals: torch.Tensor) -> None:
    if flat_vals.dtype not in _LAUNCH:
        raise TypeError(f"segsum_apply takes float64, float32 or int32 values, got {flat_vals.dtype}")
    if flat_vals.dim() != 1 or flat_vals.shape[0] > plan.perm.shape[0]:
        raise ValueError(f"segsum_apply takes [n <= {plan.perm.shape[0]}] values, got {tuple(flat_vals.shape)}")
    if flat_vals.device != plan.perm.device:
        raise ValueError("values and plan must be on one device")


def segsum_plain(plan: SegsumPlan, flat_vals: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of S: the kernel's own addition tree."""
    _check(plan, flat_vals)
    n_pad = plan.perm.shape[0]
    nblk = n_pad // BLOCK
    n = flat_vals.shape[0]
    v = torch.cat([flat_vals, flat_vals.new_zeros(n_pad - n + 1)])  # the last slot: a zero for pad lanes
    perm = plan.perm.long()
    q = v[torch.where(perm < n, perm, n)].view(nblk, BLOCK)
    f = plan.is_start.clone()
    for d in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        left, left_f = q[:, :-d], f[:, :-d]
        q = torch.cat([q[:, :d], torch.where(f[:, d:], q[:, d:], left + q[:, d:])], dim=1)
        f = torch.cat([f[:, :d], f[:, d:] | left_f], dim=1)
    qf = q.reshape(-1)
    ps = torch.where(plan.seg_live, qf[plan.seg_end.long()], torch.zeros((), dtype=q.dtype, device=q.device))
    # Runs across block boundaries: the last partials of the blocks a run
    # carries out of (a chain, first block first) sum pairwise, as a tree
    # over their positions padded with zeros to a power of two, and add to
    # the run's own partial.
    on = plan.carry_on
    first = on.clone()
    first[1:] &= ~(on[:-1] & (plan.carry_tid[:-1] == plan.carry_tid[1:]))
    n_chains = int(first.sum())
    if n_chains:
        blocks = torch.nonzero(on).flatten()
        chain = torch.cumsum(first.long(), 0)[blocks] - 1
        pos = blocks - torch.nonzero(first).flatten()[chain]
        width = 1 << int(pos.max()).bit_length()  # the longest chain, to a power of two
        m = torch.zeros((n_chains, width), dtype=q.dtype, device=q.device)
        m[chain, pos] = q[blocks, -1]
        while m.shape[1] > 1:
            m = m[:, 0::2] + m[:, 1::2]
        tids = plan.carry_tid[first].long()
        ps[tids] = ps[tids] + m[:, 0]
    return ps


def segsum_apply(plan: SegsumPlan, flat_vals: torch.Tensor) -> torch.Tensor:
    """ps[t] = sum of flat_vals[lane] over the lanes of transcript t, in
    the flat order the plan was built from ([n] float64, float32 or
    int32 -> [T] of that type).  On a CUDA tensor the kernel S (or an
    exception), on a CPU tensor segsum_plain."""
    _check(plan, flat_vals)
    if flat_vals.device.type == "cpu":
        return segsum_plain(plan, flat_vals)
    if flat_vals.device.type != "cuda":
        raise ValueError(f"unsupported device {flat_vals.device}")
    n_pad = plan.perm.shape[0]
    if n_pad >= 1 << 31:
        raise ValueError("segsum_apply: more lanes than the kernel's int32 index")
    vals = flat_vals.contiguous()
    T = plan.num_transcripts
    ps = torch.empty(T, dtype=vals.dtype, device=vals.device)
    scratch = torch.empty(n_pad, dtype=vals.dtype, device=vals.device)
    name = _LAUNCH[vals.dtype]
    err = getattr(kernels.library(), name)(
        vals.data_ptr(), vals.shape[0], plan.perm.data_ptr(), plan.is_start.data_ptr(), plan.seg_end.data_ptr(),
        plan.seg_live.data_ptr(), plan.carry_tid.data_ptr(), plan.carry_on.data_ptr(), scratch.data_ptr(),
        ps.data_ptr(), n_pad // BLOCK, T, torch.cuda.current_stream(vals.device).cuda_stream,
    )
    kernels.check(err, name)
    segsum_apply.launches += 1
    return ps


# Kernel launches since the last reset.
segsum_apply.launches = 0
