"""Posterior-sum strategies for the EM's inner loop on the PyTorch port
(the counterpart of scripts/profile_em_scatter.py; imports no JAX).

    python3 scripts/profile_em_scatter_torch.py [N] [W] [T] [--chained]
        [--from-index [--transcripts 250000] [--reads 1048576] [--cache-dir DIR]]
        [--device cuda|cpu]

The sum is ps[t] = the sum of the lanes' values whose transcript is t,
at float64 (the port's EM default).  Lanes: by default the JAX script's
shape, N x W lanes (204,800 x 16) over T = 50,000 transcripts with skewed
tids floor(u * u * T) and uniform values, drawn with numpy (seed 0);
with --from-index the EM tables that a fused quant of --reads 150 bp
reads (seed 7) at k = 31 builds (pipeline.em_tables: the class tables'
width tiers, joined in table order) against the index of
synth_transcriptome(default_rng(2026), --transcripts) (profile_step_torch's
cache), its values the first E-step's posteriors times the class weights.
single_layout pads such tiers back into the one [M, W] table the port
used before it had tiers, for a comparison in one run (chip_smoke.py's
stages phase).

Strategies, each one call of one posterior sum:

  index_add          index_add_ in read layout, the port's default route
                     (em/em.py);
  sorted_index_add   the values permuted to tid order, then index_add_
                     on the sorted indices;
  segsum             kernel S over its plan (em/segsum.py segsum_apply),
                     held bit-equal to segsum_plain and to itself;
                     the plan's build (build_segsum_plan) is timed apart,
                     and S is also given amortised over the 22 sums of a
                     20-iteration quant (20 iterations + 2 in the
                     assignment) with one build;
  segment_reduce     torch.segment_reduce on the sorted lanes: a library
                     yardstick only, never on the port's path;
  index_add_live     index_add_ over the lanes whose value is nonzero
                     alone (chosen once): a diagnostic of what the zero
                     lanes -- the tables' padding, all on transcript
                     0 -- cost the default route's atomics;
  cumsum_diff        cumsums over the sorted lanes, differenced at each
                     transcript's segment ends (profile_em_scatter.py:
                     79-88).  A float64 cumsum over millions of lanes
                     rounds at the size of the running total (~1e-10),
                     more than 1e-12 of a small transcript's sum, so each
                     value splits into a fixed-point high part (multiples
                     of 2^-24, summed exactly in int64) and a residual
                     below 2^-25, whose float64 cumsum stays tiny.

Every strategy must equal index_add_ within 1e-12 relative, transcript by
transcript (index_add_'s atomics vary its own order: PARITY.md deviation
6), and S must equal segsum_plain bit for bit and give the same bits
twice; otherwise the script exits 1.
--chained also times each strategy inside a 20-iteration chained E-step
(pi gathered, rows normalised, the posterior sum fed back as the next pi:
profile_em_scatter.py:173-214), per iteration, its final pi held to
index_add_'s within 1e-12 the same way.  Each strategy's tensors are freed
before the next.  Runs on the card unless --device cpu is passed, and
exits 2 without one.  The last line is one JSON object with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

STRATEGIES = ("index_add", "sorted_index_add", "segsum", "segment_reduce", "index_add_live", "cumsum_diff")
SUMS_PER_QUANT = 22  # 20 EM iterations + the assignment's two sums
CHAIN_ITERS = 20
FIXED_POINT = float(1 << 24)  # cumsum_diff's high part: multiples of 2^-24
TOLERANCE = 1e-12
SEED = 0  # the synthetic lanes' numpy seed


def synthetic(N: int, W: int, T: int, device):
    """The JAX script's lanes, drawn with numpy: tid [N, W] floor(u*u*T)
    (skewed), values [N, W] uniform float64."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    u = rng.random((N, W))
    tid = torch.from_numpy((u * u * T).astype(np.int64)).to(device)
    return tid, torch.from_numpy(rng.random((N, W))).to(device), None


def rel_err(got, want) -> float:
    """max over transcripts of |got - want| / |want| (0 where both are 0)."""
    import torch

    diff, scale = (got - want).abs(), want.abs()
    ratio = torch.where(scale > 0, diff / scale.clamp_min(1e-300), torch.where(diff > 0, torch.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


def strategies(flat_tid, T: int, live=None):
    """(name -> fn(values [n] float64) -> [T] for each of STRATEGIES, with
    what each precomputes once from the lanes' tids; build_plan, the
    plan's build, timed apart; the plan segsum uses).  live: [n] bool, the
    lanes index_add_live sums (every lane when None)."""
    import torch

    from sketch_rna_tpu_torch.em.segsum import build_segsum_plan, segsum_apply

    dev = flat_tid.device
    tid_sorted, perm = torch.sort(flat_tid, stable=True)
    seg_len = torch.bincount(flat_tid, minlength=T)
    bounds = torch.cat([seg_len.new_zeros(1), torch.cumsum(seg_len, 0)])
    start, end = bounds[:-1], bounds[1:]
    plan = build_segsum_plan(flat_tid, T)

    def index_add(v):
        return torch.zeros(T, dtype=v.dtype, device=dev).index_add_(0, flat_tid, v)

    def sorted_index_add(v):
        return torch.zeros(T, dtype=v.dtype, device=dev).index_add_(0, tid_sorted, v[perm])

    def segsum(v):
        return segsum_apply(plan, v)

    def segment_reduce(v):
        return torch.segment_reduce(v[perm], "sum", lengths=seg_len, unsafe=True)

    live_lanes = torch.arange(flat_tid.numel(), device=dev) if live is None else torch.nonzero(live).reshape(-1)
    live_tid = flat_tid[live_lanes]

    def index_add_live(v):
        return torch.zeros(T, dtype=v.dtype, device=dev).index_add_(0, live_tid, v[live_lanes])

    def cumsum_diff(v):
        vs = v[perm]
        hi = torch.round(vs * FIXED_POINT)
        lo = vs - hi / FIXED_POINT
        ch = torch.cat([hi.new_zeros(1, dtype=torch.int64), torch.cumsum(hi.long(), 0)])
        cl = torch.cat([lo.new_zeros(1), torch.cumsum(lo, 0)])
        return (ch[end] - ch[start]).to(v.dtype) / FIXED_POINT + (cl[end] - cl[start])

    def build_plan():
        return build_segsum_plan(flat_tid, T)

    fns = dict(zip(STRATEGIES, (index_add, sorted_index_add, segsum, segment_reduce, index_add_live, cumsum_diff)))
    return fns, build_plan, plan


def single_layout(tables):
    """The (tid, score, weight) tiers padded with zero lanes to the widest
    one's width and stacked: one [M, W] table of the same classes."""
    import torch

    W = max(t[0].shape[1] for t in tables)
    tid, score = ([torch.nn.functional.pad(t[i], (0, W - t[i].shape[1])) for t in tables] for i in (0, 1))
    weight = None if tables[0][2] is None else torch.cat([t[2] for t in tables])
    return torch.cat(tid), torch.cat(score), weight


def profile_scatter(tables, T: int, device, chained: bool) -> dict:
    """Every strategy timed (utils/profiling.measure) on one posterior
    sum over these (tid, score, weight) tables' lanes, joined in table
    order, held to index_add_ (S also to segsum_plain and to itself, bit
    for bit); with `chained` also in a 20-iteration chained E-step.
    Raises AssertionError on a check."""
    import torch

    from profile_step_torch import flat_posteriors
    from sketch_rna_tpu_torch.em.segsum import segsum_plain
    from sketch_rna_tpu_torch.utils.profiling import measure

    flat_tid = torch.cat([t[0].long().reshape(-1) for t in tables])
    live = torch.cat([(t[1] > 0).reshape(-1) for t in tables])
    fns, build_plan, plan = strategies(flat_tid, T, live)
    values = flat_posteriors(tables, torch.full((T,), 1.0 / T, dtype=torch.float64, device=device)).contiguous()
    want = fns["index_add"](values)
    out = {"lanes": int(flat_tid.numel()), "zero_lanes": int((~live).sum()),
           "zero_lanes_on_transcript_0": int(((~live) & (flat_tid == 0)).sum()), "transcripts": T,
           "tables": [[int(t[0].shape[0]), int(t[0].shape[1])] for t in tables], "dtype": "float64",
           "strategies": {}}
    for name, fn in fns.items():
        got = fn(values)
        err = rel_err(got, want)
        if not err <= TOLERANCE:
            raise AssertionError(f"{name} differs from index_add_ by {err} relative")
        if name == "segsum" and not torch.equal(got, segsum_plain(plan, values)):
            raise AssertionError("segsum differs from segsum_plain")
        if name == "segsum" and not torch.equal(got, fn(values)):
            raise AssertionError("segsum gave other bits on a second run")
        del got
        out["strategies"][name] = {**measure(lambda fn=fn: fn(values), device), "max_rel_err": err}
    out["segsum_equals_plain"] = out["segsum_bit_stable"] = True
    build = measure(build_plan, device, calls=4)
    out["plan_build"] = build
    seg = out["strategies"]["segsum"]
    out["segsum_amortised"] = {
        metric: (build[metric] + SUMS_PER_QUANT * seg[metric]) / SUMS_PER_QUANT
        for metric in ("wall_ms", "device_ms") if seg[metric] is not None}
    if chained:
        out["chained"] = chained_e_step(tables, T, fns, device)
    return out


def chained_e_step(tables, T: int, fns, device) -> dict:
    """Per strategy: ms per iteration of CHAIN_ITERS chained E-steps (pi
    gathered, rows normalised, summed, + 0.01 fed back), and its final
    pi's relative error against index_add_'s."""
    import torch

    from profile_step_torch import flat_posteriors
    from sketch_rna_tpu_torch.utils.profiling import measure

    pi0 = torch.full((T,), 1.0 / T, dtype=torch.float64, device=device)

    def chain(acc):
        pi = pi0
        for _ in range(CHAIN_ITERS):
            pi = acc(flat_posteriors(tables, pi)) + 0.01
        return pi

    want = chain(fns["index_add"])
    out = {"iterations": CHAIN_ITERS}
    for name, fn in fns.items():
        err = rel_err(chain(fn), want)
        if not err <= TOLERANCE:
            raise AssertionError(f"chained {name} differs from index_add_ by {err} relative")
        m = measure(lambda fn=fn: chain(fn), device, calls=2)
        out[name] = {"wall_ms_per_iteration": m["wall_ms"] / CHAIN_ITERS,
                     "device_ms_per_iteration": None if m["device_ms"] is None else m["device_ms"] / CHAIN_ITERS,
                     "max_rel_err": err}
    return out


def main(argv=None) -> int:
    from common_torch import SCALE_CACHE, card, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("N", nargs="?", type=int, default=204800)
    ap.add_argument("W", nargs="?", type=int, default=16)
    ap.add_argument("T", nargs="?", type=int, default=50000)
    ap.add_argument("--chained", action="store_true", help="also time a 20-iteration chained E-step")
    ap.add_argument("--from-index", action="store_true",
                    help="the class table of a fused quant at --transcripts (N, W, T are then ignored)")
    ap.add_argument("--transcripts", type=int, default=250000)
    ap.add_argument("--reads", type=int, default=1 << 20)
    ap.add_argument("--cache-dir", default=str(SCALE_CACHE))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    if args.from_index:
        from profile_step_torch import PAD_LEN, READ_LEN, class_tables, index_on_device
        from profile_step_torch import SEED as READS_SEED
        from sketch_rna_tpu_torch.config import QuantConfig
        from sketch_rna_tpu_torch.utils.synth import sample_reads

        index, seqs = index_on_device(args.transcripts, (31,), device, args.cache_dir)
        codes, lengths = sample_reads(seqs, args.reads, READ_LEN, PAD_LEN, READS_SEED)
        tables, _, _ = class_tables(index, QuantConfig(), codes, lengths)
        T = index.num_transcripts
        source = f"the EM tables of {args.reads} reads at {T} transcripts, k = 31"
        del index
    else:
        tables = [synthetic(args.N, args.W, args.T, device)]
        T = args.T
        source = f"synthetic: N {args.N} x W {args.W}, T {T}, tids floor(u * u * T), seed {SEED}"
    try:
        line = profile_scatter(tables, T, device, args.chained)
    except AssertionError as exc:
        print(f"profile_em_scatter_torch: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"metric": "em_scatter", "source": source, **line, "card": card(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
