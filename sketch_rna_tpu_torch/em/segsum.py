"""Scatter-free, deterministic posterior sums for the EM
(sketch_rna_tpu/em/segsum.py's counterpart).

The EM's hot sum is ps[t] = sum of the lanes' values whose transcript is
t.  The lane -> transcript keys are the same in every iteration and in
the assignment, so the lanes are sorted by transcript ONCE
(build_segsum_plan) and each sum reduces contiguous runs (segsum_apply):

  1. gather the values into the sorted order, in blocks of BLOCK lanes;
  2. a segmented inclusive scan over each block: every run's partial sum
     lands on its last lane of the block;
  3. the blocks' last partials, for the runs that carry on into the next
     block, are a segmented sequence of their own: scanned the same way,
     BLOCK to a carry block, and the carry blocks' totals once more in one
     block (4 a thread up to BLOCK of them, else 8: at most 8,192);
  4. ps[t] = the partial at t's last lane, plus, when t's run carries into
     its last block, the carry total at the block before: its carry
     block's scan, plus the top scan at the carry block before when the
     run reaches back past its own.

Every addition combines lanes of one run, so float error stays relative
to each transcript's own sum, as with a scatter.  Unlike the scatter's
atomics (index_add_ on CUDA), the order of every addition is fixed: each
scan is _block_scan's tree (a serial sum over each thread's elements, a
Hillis-Steele scan of the thread totals within each warp of 32, the warp
totals folded left to right, then a fix-up), the same on every call.  So
a sum is bit-identical from run to run, and the plain version below
follows the same tree, so kernel and plain agree bit for bit.

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


def _block_scan(x: torch.Tensor, starts: torch.Tensor, per: int):
    """The kernel's block scan (csrc/segsum.cu block_scan) over each row
    of x [nb, m] with its start flags, per elements a thread, m / per
    threads a block (a multiple of 32): each element's inclusive
    segmented partial from its run's start (or the row's first element),
    and whether its run reaches back to the row's first element."""
    nb, m = x.shape
    threads = m // per
    warps = threads // 32
    x = x.view(nb, threads, per)
    s = starts.view(nb, threads, per)
    cols = [x[..., 0]]  # each thread's serial sum
    for r in range(1, per):
        cols.append(torch.where(s[..., r], x[..., r], cols[-1] + x[..., r]))
    a = cols[-1].view(nb, warps, 32)
    f = s.any(dim=-1).view(nb, warps, 32)
    for d in (1, 2, 4, 8, 16):  # a warp's shuffle scan of its thread totals
        a = torch.cat([a[..., :d], torch.where(f[..., d:], a[..., d:], a[..., :-d] + a[..., d:])], dim=-1)
        f = torch.cat([f[..., :d], f[..., d:] | f[..., :-d]], dim=-1)
    wa, wf = a[..., 31], f[..., 31]  # warp totals, folded left to right into each warp's carry
    ca, cf = [torch.zeros_like(wa[:, 0]), wa[:, 0]], [torch.zeros_like(wf[:, 0]), wf[:, 0]]
    for u in range(1, warps - 1):
        ca.append(torch.where(wf[:, u], wa[:, u], ca[-1] + wa[:, u]))
        cf.append(cf[-1] | wf[:, u])
    ca, cf = torch.stack(ca[:warps], 1)[..., None], torch.stack(cf[:warps], 1)[..., None]
    later = (torch.arange(warps, device=x.device) > 0)[:, None]
    ea, ef = a[..., :-1], f[..., :-1]  # the warp's threads before each one
    carry = torch.cat([ca, torch.where(~ef & later, ca + ea, ea)], dim=-1).reshape(nb, threads, 1)
    before = torch.cat([cf, ef | cf], dim=-1).reshape(nb, threads, 1)
    has = torch.ones((warps, 32), dtype=torch.bool, device=x.device)
    has[0, 0] = False
    free = torch.cumsum(s, dim=-1) == 0  # no start in the thread at or before the element
    y = torch.where(free & has.view(1, threads, 1), carry + torch.stack(cols, dim=-1), torch.stack(cols, dim=-1))
    return y.reshape(nb, m), (free & ~before).reshape(nb, m)


def _scan_flat(x: torch.Tensor, starts: torch.Tensor, per: int, width: int):
    """_block_scan over x [L] cut into blocks of width, the last padded
    with zeros that start runs (they change no earlier element)."""
    L = x.shape[0]
    pad = -L % width
    x = torch.cat([x, x.new_zeros(pad)])
    starts = torch.cat([starts, starts.new_ones(pad)])
    y, reach = _block_scan(x.view(-1, width), starts.view(-1, width), per)
    return y.reshape(-1)[:L], reach.reshape(-1)[:L]


def segsum_plain(plan: SegsumPlan, flat_vals: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of S: the kernel's own addition tree, a
    whole-tensor step for each of its steps."""
    _check(plan, flat_vals)
    n_pad = plan.perm.shape[0]
    nblk = n_pad // BLOCK
    n = flat_vals.shape[0]
    v = torch.cat([flat_vals, flat_vals.new_zeros(1)])  # the last slot: a zero for pad lanes
    perm = plan.perm.long()
    q, _ = _block_scan(v[torch.where(perm < n, perm, n)].view(nblk, BLOCK), plan.is_start, 4)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    # The carries: each block's last partial where its run carries on (a
    # zero elsewhere); a run of them starts at a block unless the block
    # before carries the same transcript into it.
    on, ctid = plan.carry_on, plan.carry_tid
    cont = on.clone()
    cont[0] = False
    cont[1:] &= on[:-1] & (ctid[:-1] == ctid[1:])
    s1, reach1 = _scan_flat(torch.where(on, q[:, -1], zero), ~cont, 4, BLOCK)
    nblk1 = -(-nblk // BLOCK)
    if nblk1 > 1:  # the carry blocks' totals in one block: 4 a thread up to BLOCK of them, else 8
        last = torch.clamp(torch.arange(nblk1, device=q.device) * BLOCK + BLOCK - 1, max=nblk - 1)
        per = 4 if nblk1 <= BLOCK else 8
        s2, _ = _scan_flat(s1[last], ~reach1[last], per, -(-nblk1 // (32 * per)) * 32 * per)
    end = plan.seg_end.long()
    ps = q.reshape(-1)[end]
    b = end // BLOCK - 1
    bc = torch.clamp(b, min=0)
    carried = (b >= 0) & on[bc] & (ctid[bc] == torch.arange(ps.shape[0], device=q.device))
    total = s1[bc]
    if nblk1 > 1:
        c = bc // BLOCK
        total = torch.where(reach1[bc] & (c > 0), s2[torch.clamp(c - 1, min=0)] + total, total)
    ps = torch.where(carried, ps + total, ps)
    return torch.where(plan.seg_live, ps, zero)


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
    perm, is_start = plan.perm, plan.is_start
    if perm.data_ptr() % 16 or is_start.data_ptr() % 4 or not (perm.is_contiguous() and is_start.is_contiguous()):
        raise ValueError("segsum_apply: the plan's perm must be contiguous and 16-byte aligned, is_start 4-byte")
    T = plan.num_transcripts
    nblk = n_pad // BLOCK
    ps = torch.empty(T, dtype=vals.dtype, device=vals.device)
    scratch = torch.empty(n_pad + nblk + -(-nblk // BLOCK), dtype=vals.dtype, device=vals.device)
    flags = torch.empty(nblk, dtype=torch.uint8, device=vals.device)
    name = _LAUNCH[vals.dtype]
    err = getattr(kernels.library(), name)(
        vals.data_ptr(), vals.shape[0], perm.data_ptr(), is_start.data_ptr(), plan.seg_end.data_ptr(),
        plan.seg_live.data_ptr(), plan.carry_tid.data_ptr(), plan.carry_on.data_ptr(), scratch.data_ptr(),
        flags.data_ptr(), ps.data_ptr(), nblk, T, torch.cuda.current_stream(vals.device).cuda_stream,
    )
    kernels.check(err, name)
    segsum_apply.launches += 1
    return ps


# Kernel launches since the last reset.
segsum_apply.launches = 0
