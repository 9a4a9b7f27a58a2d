"""The port's segmented sum (em/segsum.py) and its EM route against the JAX
package, on the CPU (the kernel S's plain version).

  - the plan's six fields equal the JAX build_segsum_plan's exactly;
  - segsum_apply is within 1e-12 relative of the JAX segsum_apply and of
    np.bincount at float64, and exact at int32; pad lanes are inert;
  - run_em_tables / assign_reads_tables with use_segsum are within 1e-9
    of the JAX run_em_assign_partitioned(use_segsum=True) at float64,
    with weights, a static base and two tables, and the checkpointed
    engine route shares one plan.

The JAX sum is jitted (eager associative_scan compiles each of its
operations per shape).  Its scan tree differs from the port's, so the
two float sums agree within rounding, not bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rna_tpu.em.em import run_em_assign_partitioned
from sketch_rna_tpu.em.segsum import build_segsum_plan as jax_plan
from sketch_rna_tpu.em.segsum import segsum_apply as jax_segsum
from sketch_rna_tpu_torch import pipeline
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.em import em as port_em
from sketch_rna_tpu_torch.em.em import assign_reads_tables, run_em_tables
from sketch_rna_tpu_torch.em.segsum import (BLOCK, _block_scan, build_segsum_plan, plan_from_tables, segsum_apply,
                                            segsum_plain)

_jax_segsum = jax.jit(jax_segsum)


def _tids(case, rng):
    """(flat tids, T) of one plan case."""
    if case.startswith("n="):
        return rng.integers(0, 300, int(case[2:])).astype(np.int32), 300
    if case == "transcripts with no lane":  # only even tids, and T past the largest
        return (2 * rng.integers(0, 200, 3000)).astype(np.int32), 450
    # one transcript over more than `blocks - 1` blocks, shuffled among others
    blocks = int(case.split()[3])
    tid = np.concatenate([np.full(blocks * BLOCK + 37, 7, np.int32), rng.integers(0, 40, 900).astype(np.int32)])
    return rng.permutation(tid), 40


# 1100 blocks: the carries span three carry blocks of 512, so the top scan runs.
PLAN_CASES = ["n=1", "n=511", "n=512", "n=513", "n=5000", "transcripts with no lane", "one transcript over 4 blocks",
              "one transcript over 1100 blocks"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_equals_jax(case):
    tid, T = _tids(case, np.random.default_rng(len(case)))
    want = jax_plan(jnp.asarray(tid), T)
    got = build_segsum_plan(torch.from_numpy(tid), T)
    for field in want._fields:
        a, b = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    if case.startswith("one"):
        assert int(got.carry_on.sum()) >= 4


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("dtype", ["float64", "int32"])
def test_segsum_equals_jax_and_bincount(case, dtype):
    rng = np.random.default_rng(len(case) + 1)
    tid, T = _tids(case, rng)
    vals = (rng.random(tid.size) * rng.integers(1, 1000, tid.size)) if dtype == "float64" else \
        rng.integers(0, 4, tid.size).astype(np.int32)
    plan = build_segsum_plan(torch.from_numpy(tid), T)
    got = segsum_apply(plan, torch.from_numpy(vals)).numpy()
    assert got.dtype == vals.dtype and got.shape == (T,)
    want = np.asarray(_jax_segsum(jax_plan(jnp.asarray(tid), T), jnp.asarray(vals)))
    count = np.bincount(tid, weights=vals.astype(np.float64), minlength=T)
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, count.astype(np.int64))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got, count, rtol=1e-12, atol=0)
    assert not got[np.bincount(tid, minlength=T) == 0].any()


def test_segsum_pad_lanes_are_inert():
    """Table pad lanes (tid 0, value 0) and the plan's block padding add
    nothing, as the scatter adds 0 there (they shift other lanes' block
    positions, so float sums move only by rounding; int sums not at all)."""
    rng = np.random.default_rng(9)
    T = 50
    tid = rng.integers(0, T, 700).astype(np.int32)
    vals = rng.random(700)
    base = segsum_apply(build_segsum_plan(torch.from_numpy(tid), T), torch.from_numpy(vals))
    padded_tid = np.concatenate([tid, np.zeros(300, np.int32)])
    padded = segsum_apply(build_segsum_plan(torch.from_numpy(padded_tid), T),
                          torch.from_numpy(np.concatenate([vals, np.zeros(300)])))
    np.testing.assert_allclose(padded.numpy(), base.numpy(), rtol=1e-15, atol=0)
    counts = torch.from_numpy(rng.integers(0, 4, 700).astype(np.int32))
    a = segsum_apply(build_segsum_plan(torch.from_numpy(tid), T), counts)
    b = segsum_apply(build_segsum_plan(torch.from_numpy(padded_tid), T),
                     torch.cat([counts, torch.zeros(300, dtype=torch.int32)]))
    assert torch.equal(a, b)


def test_segsum_plain_is_deterministic_and_checks_input():
    rng = np.random.default_rng(4)
    tid = torch.from_numpy(rng.integers(0, 30, 3000).astype(np.int32))
    plan = build_segsum_plan(tid, 30)
    v = torch.from_numpy(rng.random(3000))
    assert torch.equal(segsum_plain(plan, v), segsum_plain(plan, v.clone()))
    with pytest.raises(TypeError):
        segsum_apply(plan, v.to(torch.int64))
    with pytest.raises(ValueError):
        segsum_apply(plan, torch.zeros(plan.perm.numel() + 1, dtype=torch.float64))


def _block_scan_emulated(x, starts, per):
    """csrc/segsum.cu's block_scan in numpy, a block a row of x [nb, m]:
    the kernel's registers as arrays over the block's m / per threads, a
    shuffle up by d as a shift within each warp of 32, the warp totals
    folded one warp at a time as each thread folds them.  Returns each
    element's partial and whether its run reaches the block's start."""
    nb, m = x.shape
    threads = m // per
    x = x.reshape(nb, threads, per).copy()
    s = starts.reshape(nb, threads, per)
    for r in range(1, per):  # each thread's serial sum
        x[:, :, r] = np.where(s[:, :, r], x[:, :, r], x[:, :, r - 1] + x[:, :, r])
    a, f = x[:, :, -1].copy(), s.any(axis=-1)
    lane, warp = np.arange(threads) % 32, np.arange(threads) // 32
    for d in (1, 2, 4, 8, 16):  # __shfl_up_sync(a, d): lanes below d keep their own
        al, fl = np.roll(a, d, axis=1), np.roll(f, d, axis=1)
        a = np.where((lane >= d) & ~f, al + a, a)
        f = np.where(lane >= d, f | fl, f)
    ea, ef = np.roll(a, 1, axis=1), np.roll(f, 1, axis=1)
    ca, cf = np.zeros_like(a), np.zeros_like(f)
    for w in range(1, threads // 32):  # thread by thread: the totals of warps 0 .. w - 1
        c, g = a[:, 31], f[:, 31]
        for u in range(1, w):
            c, g = np.where(f[:, 32 * u + 31], a[:, 32 * u + 31], c + a[:, 32 * u + 31]), g | f[:, 32 * u + 31]
        ca[:, warp == w], cf[:, warp == w] = c[:, None], g[:, None]
    carry = np.where(lane > 0, np.where(~ef & (warp > 0), ca + ea, ea), ca)
    before = np.where(lane > 0, ef | cf, cf)
    has = (lane > 0) | (warp > 0)
    free = np.cumsum(s, axis=-1) == 0
    x = np.where(free & has[None, :, None], carry[:, :, None] + x, x)
    return x.reshape(nb, m), (free & ~before[:, :, None]).reshape(nb, m)


def _kernel_emulated(plan, vals):
    """The kernel's four launches in numpy: the lane scan (128 threads x 4
    a plan block), the carry scan (512 carries a block), the top scan (one
    block: 128 x 4 up to 512 carry blocks, else 1024 x 8) and the
    per-transcript final pass."""
    n, T = vals.size, plan.num_transcripts
    perm, on, ctid = plan.perm.numpy(), plan.carry_on.numpy(), plan.carry_tid.numpy()
    nblk = perm.size // BLOCK
    x = np.where(perm < n, vals[np.minimum(perm, n - 1)], 0).astype(vals.dtype).reshape(nblk, BLOCK)
    q, _ = _block_scan_emulated(x, plan.is_start.numpy(), 4)
    nblk1 = -(-nblk // BLOCK)
    b = np.minimum(np.arange(nblk1 * BLOCK), nblk - 1)
    live = (np.arange(nblk1 * BLOCK) < nblk) & on[b]
    prev = np.maximum(b - 1, 0)
    cont = live & (np.arange(nblk1 * BLOCK) > 0) & on[prev] & (ctid[prev] == ctid[b])
    s1, reach1 = _block_scan_emulated(np.where(live, q[b, -1], 0).astype(vals.dtype).reshape(nblk1, BLOCK),
                                      ~cont.reshape(nblk1, BLOCK), 4)
    s1, reach1 = s1.reshape(-1), reach1.reshape(-1)
    if nblk1 > 1:
        width, per = (BLOCK, 4) if nblk1 <= BLOCK else (8192, 8)
        c = np.arange(width)
        last = np.minimum(c * BLOCK + BLOCK - 1, nblk - 1)
        s2, _ = _block_scan_emulated(np.where(c < nblk1, s1[last], 0).astype(vals.dtype)[None],
                                     ((c >= nblk1) | ~reach1[last])[None], per)
        s2 = s2[0]
    out = np.zeros(T, vals.dtype)
    for t in range(T):
        if not plan.seg_live[t]:
            continue
        e = int(plan.seg_end[t])
        acc, blk = q.reshape(-1)[e], e // BLOCK - 1
        if blk >= 0 and on[blk] and ctid[blk] == t:
            total = s1[blk]
            if blk // BLOCK > 0 and reach1[blk]:
                total = s2[blk // BLOCK - 1] + total
            acc = acc + total
        out[t] = acc
    return out


@pytest.mark.parametrize("per, width", [(4, BLOCK), (8, 8192)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_block_scan_follows_the_kernels_tree(per, width, dtype):
    """segsum_plain's _block_scan at both block shapes the kernel launches
    (128 x 4: plan blocks, carry blocks and a top scan of up to 512 carry
    blocks; 1024 x 8: a top scan past 512, which needs n_pad > 2^27 lanes)
    equals the numpy emulation bit for bit, with runs that cross threads
    and warps and runs that reach back to the block's start."""
    rng = np.random.default_rng(per)
    x = (rng.random((3, width)) * 10.0 ** rng.integers(-6, 7, (3, width))).astype(np.float32) \
        if dtype == "float32" else rng.integers(-1000, 1000, (3, width)).astype(np.int32)
    starts = rng.random((3, width)) < np.array([[0.002], [0.05], [0.5]])
    starts[0, : 40 * per] = False  # row 0's first run reaches back to its start across a warp
    starts[1:, 0] = True
    got, reach = _block_scan(torch.from_numpy(x), torch.from_numpy(starts), per)
    want, want_reach = _block_scan_emulated(x, starts, per)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(reach.numpy(), want_reach)
    assert want_reach[0].sum() >= 40 * per and not want_reach[1:].any()


@pytest.mark.parametrize("span", [2, 3, 7, 16, 37, 75, 1100])
def test_segsum_plain_follows_the_kernels_tree(span):
    """float32 values of wildly different sizes, one transcript over span
    blocks (1100: over three carry blocks, so the top scan runs):
    segsum_plain equals, bit for bit, the kernel's four launches emulated
    in numpy float32."""
    rng = np.random.default_rng(span)
    n = span * BLOCK - 100
    tid = rng.permutation(np.concatenate([np.zeros(50, np.int32), np.full(n - 100, 3, np.int32),
                                          rng.integers(4, 9, 50).astype(np.int32)]))
    vals = (rng.random(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
    plan = build_segsum_plan(torch.from_numpy(tid), 9)
    got = segsum_plain(plan, torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, _kernel_emulated(plan, vals))
    on, ctid = plan.carry_on.numpy(), plan.carry_tid.numpy()
    assert sum(1 for b in range(on.size) if on[b] and ctid[b] == 3) >= span - 2


def _tables(rng, T):
    t1 = (rng.integers(0, T, (257, 8)), rng.integers(0, 5, (257, 8)), rng.integers(1, 7, 257))
    t2 = (rng.integers(0, T, (64, 16)), rng.integers(0, 5, (64, 16)), rng.integers(1, 7, 64))
    t2[1][rng.random(64) < 0.3] = 0  # rows with a zero denominator
    return [tuple(a.astype(np.int32) for a in t) for t in (t1, t2)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_base", [False, True])
def test_em_segsum_equals_jax(weighted, with_base):
    rng = np.random.default_rng(11)
    T, R = 300, 400
    tables = _tables(rng, T)
    if not weighted:
        tables = [(t, s, None) for t, s, _ in tables]
    base = rng.integers(0, 3, T).astype(np.int32) if with_base else None
    has = (base > 0) if with_base else None
    jt = tuple((jnp.asarray(t), jnp.asarray(s), None if w is None else jnp.asarray(w)) for t, s, w in tables)
    j_pi, j_it, j_w, j_h = run_em_assign_partitioned(
        jt, jnp.asarray(R, jnp.int32), num_transcripts=T, dtype="float64", use_segsum=True,
        static_base=None if base is None else jnp.asarray(base), static_has=None if has is None else jnp.asarray(has))
    pt = [(torch.from_numpy(t), torch.from_numpy(s), None if w is None else torch.from_numpy(w)) for t, s, w in tables]
    pb = None if base is None else torch.from_numpy(base)
    plan = plan_from_tables(pt, T)
    pi, it, _ = run_em_tables(pt, R, num_transcripts=T, dtype="float64", static_base=pb, use_segsum=True,
                              segsum_plan=plan)
    w, h = assign_reads_tables(pt, pi, num_transcripts=T, dtype="float64", static_base=pb,
                               static_has=None if has is None else torch.from_numpy(has), use_segsum=True,
                               segsum_plan=plan)
    assert it == int(j_it)
    np.testing.assert_allclose(pi.numpy(), np.asarray(j_pi), rtol=1e-9, atol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(h.numpy(), np.asarray(j_h))
    # the scatter route of the port lands within the same tolerance
    pi_s, _, _ = run_em_tables(pt, R, num_transcripts=T, dtype="float64", static_base=pb)
    np.testing.assert_allclose(pi.numpy(), pi_s.numpy(), rtol=1e-12, atol=0)


def _per_table(tables, pi, T, dt, plan):
    """One EM iteration's posterior sums and the assignment, table by table
    (each table's [rows, width] posteriors, then the tables' lanes summed
    in flat order): what run_em_tables and assign_reads_tables compute
    over the tables' flat lanes."""
    posts, probs, contribs = [], [], []
    for tid, sc, wgt in tables:
        w = pi[tid.long()] * sc.to(dt)
        denom = w.sum(dim=1, keepdim=True)
        post = w * torch.where(denom > 1e-10, 1.0 / denom, 0.0)
        ok = denom > 0
        prob = w * torch.where(ok, 1.0 / torch.where(ok, denom, 1.0), 0.0)
        contributes = (sc > 0) & ok
        if wgt is not None:
            post, prob = post * wgt.to(dt)[:, None], prob * wgt.to(dt)[:, None]
            contributes = contributes & (wgt.to(dt)[:, None] > 0)
        posts.append(post.reshape(-1))
        probs.append(prob.reshape(-1))
        contribs.append(contributes.reshape(-1))
    flat = torch.cat([t[0].reshape(-1) for t in tables]).long()
    post, prob, contributes = torch.cat(posts), torch.cat(probs), torch.cat(contribs)
    if plan is None:
        return tuple(torch.zeros(T, dtype=v.dtype).index_add_(0, flat, v)
                     for v in (post, prob, contributes.long()))
    return segsum_apply(plan, post), segsum_apply(plan, prob), segsum_apply(plan, contributes.to(torch.int32)).long()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("use_segsum", [False, True])
def test_flat_lanes_keep_the_per_table_sums(dtype, use_segsum):
    """Both routes compute the tables' posteriors on their flat lanes; the
    bits equal the table-by-table arithmetic, over weighted and unweighted
    tables, a table of no rows and one of width 1."""
    rng = np.random.default_rng(13)
    T = 300
    tables = [tuple(torch.from_numpy(a) for a in t) for t in _tables(rng, T)]
    tables[1] = (tables[1][0], tables[1][1], None)
    tables += [(torch.zeros((0, 4), dtype=torch.int32), torch.zeros((0, 4), dtype=torch.int32),
                torch.zeros(0, dtype=torch.int32)),
               (torch.from_numpy(rng.integers(0, T, (33, 1)).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 3, (33, 1)).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 4, 33).astype(np.int32)))]
    dt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    plan = plan_from_tables(tables, T) if use_segsum else None
    pi0 = torch.from_numpy(rng.random(T)).to(dt)
    # pseudocount 0: one iteration's pi is the posterior sum itself
    pi, _, _ = run_em_tables(tables, 500, num_transcripts=T, dtype=dtype, pseudocount=0.0, init_pi=pi0,
                             max_iterations=1, use_segsum=use_segsum, segsum_plan=plan)
    weighted, has = assign_reads_tables(tables, pi0, num_transcripts=T, dtype=dtype, use_segsum=use_segsum,
                                        segsum_plan=plan)
    want_pi, want_w, want_has = _per_table(tables, pi0, T, dt, plan)
    assert torch.equal(pi, want_pi) and torch.equal(weighted, want_w) and torch.equal(has, want_has > 0)


def test_checkpointed_em_builds_one_plan(monkeypatch, tmp_path):
    """The segsum route's plan is built once per quant and shared by every
    checkpoint segment and the assignment; segments resume exactly."""
    rng = np.random.default_rng(12)
    T = 300
    tables = [(torch.from_numpy(t), torch.from_numpy(s), torch.from_numpy(w)) for t, s, w in _tables(rng, T)]
    built = []
    real = port_em.plan_from_tables

    def counting(tabs, n):
        built.append(n)
        return real(tabs, n)

    monkeypatch.setattr(port_em, "plan_from_tables", counting)
    cfg = QuantConfig(em_segsum="on", em_dtype="float64", em_max_iterations=20, em_convergence=0.0)
    index = dataclasses.make_dataclass("Index", ["names", "lengths"])([f"T{i}" for i in range(T)], np.ones(T))
    one = pipeline.em_assign(tables, None, None, index, cfg, num_reads=400, num_mapped=1, stats={})
    seg = pipeline.em_assign(tables, None, None, index,
                             dataclasses.replace(cfg, em_checkpoint=str(tmp_path / "em.npz"), em_checkpoint_every=3),
                             num_reads=400, num_mapped=1, stats={})
    assert built == [T, T]  # one plan a quant, for 1 segment and for 7
    np.testing.assert_array_equal(seg.pi, one.pi)
    np.testing.assert_array_equal(seg.weighted_counts, one.weighted_counts)
    assert seg.em_iterations == one.em_iterations == 20
