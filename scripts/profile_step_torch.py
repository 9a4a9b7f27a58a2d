"""Per-stage profile of the PyTorch port's quant step at several index
sizes (the counterpart of scripts/profile_step.py, profile_bigindex.py,
profile_gencode_step.py and profile_match_ablate.py; imports no JAX).

    python3 scripts/profile_step_torch.py [--transcripts 6000,50000,250000]
        [--ks 31 | --ks 21,31] [--reads N] [--batch B] [--cache-dir DIR]
        [--device cuda|cpu]

At each index size (synth_transcriptome(default_rng(2026), N), the
GENCODE-scale generator; the index read from scripts/scale_check_torch.py's
cache, or built on the device and saved there) it takes the first
[B, 256] batch of --reads reads of 150 bp (utils/synth.sample_reads,
seed 7, as chip_smoke's gencode phase), cut to the width the fused
engine gives it (the longest read rounded up to 8: 152), and times each
stage of pipeline.sketch_match_step as a call of its own, in the step's
order:

  sketch  sketch/dispatch.sketch_reads (K1 for one k, K2 for several);
  probe   match/bucket_lookup.probe_index (P), one call a k;
  expand  match/rowmatch.row_expand_from_runs, one call a k, given the
          event sizes (the one host sync that reads them is left out);
  group   rowmatch.group_event_parts (the kernel G where it takes the
          batch: one launch; else K4 sorts, run counting, top-C);
  step    the whole sketch_match_step, its host syncs included;
  scan    pipeline.match_scan over all --reads reads, already on the
          device (the fused and streamed engines' match stage: one host
          read a length group, the batch steps replayed from CUDA graphs
          on a card, kept with the index), reported per batch: wall and
          device ms, launches and host operations, with the graphs its
          first call captured (0 where an earlier call on the index
          captured them) and the host calls that synchronized, by the torch
          operation that made them; and one call split by the host
          clock (the fastest of three), with the codes on the device and
          on the host (the fused engine's case): until the size read,
          the read's wait, from it to the call's return, and the
          device's drain after it.

Each stage reports (utils/profiling.measure) wall ms (wall_ms: best of
3 means over 20 calls, synchronized), device ms (torch.profiler, the sum
of one call's device operations over 50 calls; on the card only), the
hand-written kernels' launches by name and the host's operations per
call (host_ops: CUDA runtime calls and torch operations).  The stages' outputs chained must
equal sketch_match_step's tid, score and mask bit for bit, or the script
exits 1.

Then it matches all --reads reads (pipeline.match_rows),
builds the fused engine's EM tables (pipeline.em_tables, as
_quantify_fused calls it: equivalence classes in width tiers, singletons
folded) and times, at those tables' shapes, one EM
iteration (em/em.run_em_tables with max_iterations=1: E-step, the
index_add_ M-step and the host's read of the convergence test), the
E-step and the M-step alone (em.py's own lines; chained they must equal
the iteration's pi within 1e-12 relative) and the assignment
(assign_reads_tables) -- profile_bigindex.py's EM line at the real
shape.  The EM runs at the port's default float64.

The JAX scripts' tiered-vs-flat matcher rows (profile_gencode_step.py:
139-167) have no counterpart: the port's event widths are exact, so its
matcher has no tiers (ROADMAP.md "Do not port"); the EM's class tiers
are the engine's own, timed above.  Runs on the card unless --device cpu
is passed, and exits 2 without one.  Prints one JSON line per index
size and, last, one line with them all and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("sketch", "probe", "expand", "group", "step")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
READ_LEN = 150
PAD_LEN = 256
SEED = 7


def index_on_device(n_transcripts: int, ks, device, cache_dir):
    """(the index of gencode_transcriptome(n_transcripts) at ks on
    `device`, that transcriptome): bench_torch.cached_index's artifact,
    from scale_check_torch.py's cache or built and saved there."""
    from bench_torch import cached_index as cached_artifact
    from sketch_rna_tpu_torch.index.artifact import to_device

    artifact, seqs, where = cached_artifact(n_transcripts, ks, device, cache_dir)
    print(f"{n_transcripts} transcripts, ks {tuple(ks)}: {where}", file=sys.stderr)
    return to_device(artifact, device), seqs


def one_k(index, k: int):
    """The index cut to its k alone (the same device arrays)."""
    import dataclasses

    return dataclasses.replace(index, kmer_lengths=(k,), per_k={k: index.per_k[k]})


def first_batch(index, codes, lengths, batch: int):
    """The first `batch` reads on the index's device, cut as match_rows
    cuts a one-group run (its longest read, at least the largest k,
    rounded up to 8), and each k's sketch capacity there."""
    import numpy as np
    import torch

    from sketch_rna_tpu_torch.config import QuantConfig

    ks = tuple(index.kmer_lengths)
    n = lengths[:batch]
    L = min(codes.shape[1], -(-max(int(n.max()), max(ks)) // 8) * 8)
    cfg = QuantConfig(kmer_lengths=ks)
    c = torch.from_numpy(np.ascontiguousarray(codes[:batch, :L])).to(index.device)
    return c, torch.from_numpy(np.asarray(n, np.int32)).to(index.device), tuple(
        cfg.sketch_capacity_for(k, L) for k in ks)


def stage_calls(index, config, c, n, caps):
    """sketch_match_step's stages on one batch as separate calls: (name ->
    fn() for each of STAGES, each stage reading the outputs the stage
    before it left, and the chained stages' MatchResult)."""
    from sketch_rna_tpu_torch.match.bucket_lookup import probe_index
    from sketch_rna_tpu_torch.match.rowmatch import event_sizes, group_event_parts, row_expand_from_runs
    from sketch_rna_tpu_torch.pipeline import sketch_match_step
    from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads

    ks = tuple(index.kmer_lengths)

    def sketch():
        return sketch_reads(c, n, ks, config.sketch_fraction, caps)

    sketches = sketch()

    def probe():
        return [probe_index(h, m, index.per_k[k]) for (h, m, _), k in zip(sketches, ks)]

    runs = probe()
    sizes = event_sizes([length for _, length in runs])

    def expand():
        return [row_expand_from_runs(start, length, index.per_k[k].postings, sizes=size)
                for (start, length), k, size in zip(runs, ks, sizes)]

    parts = expand()

    def group():
        return group_event_parts(parts, chain_fraction=config.chain_fraction,
                                 candidate_capacity=config.candidate_capacity,
                                 num_transcripts=index.num_transcripts, per_k_tables=config.match_per_k_tables)

    def step():
        return sketch_match_step(c, n, index, config, caps)

    return dict(zip(STAGES, (sketch, probe, expand, group, step))), group()


def profile_stages(index, config, c, n, caps) -> dict:
    """Every stage measured (measure); raises AssertionError unless the
    chained stages' tables equal sketch_match_step's bit for bit."""
    import torch

    from sketch_rna_tpu_torch.utils.profiling import measure

    calls, chained = stage_calls(index, config, c, n, caps)
    whole = calls["step"]()
    for field in ("tid", "score", "mask"):
        if not torch.equal(getattr(chained, field), getattr(whole, field)):
            raise AssertionError(f"the chained stages' {field} differs from sketch_match_step's")
    return {name: measure(fn, c.device) for name, fn in calls.items()}


def profile_scan(index, config, codes, lengths) -> dict:
    """match_scan over every read (codes on the index's device, as the
    streamed engine hands them over), measured per batch: wall ms, device
    ms, launches and host operations (utils/profiling.measure), the graphs
    its first call captures (they stay with the index: later calls
    replay them), and the synchronizing host calls of one traced call
    by the torch operation they sit under."""
    import collections

    import numpy as np
    import torch

    from sketch_rna_tpu_torch.pipeline import match_scan
    from sketch_rna_tpu_torch.utils.profiling import measure, traced
    from sketch_rna_tpu_torch.utils.timing import PhaseTimer

    host = torch.from_numpy(np.ascontiguousarray(codes))
    c = host.to(index.device)

    def scan():
        return match_scan(index, c, lengths, config)

    nb = -(-len(lengths) // config.batch_size)
    with PhaseTimer().opened() as timer:
        scan()
    captures = timer.counts["graphs.captures"]
    got = measure(scan, index.device, calls=4)
    events, _ = traced(scan, index.device)
    syncs = collections.Counter(e.cpu_parent.name if e.cpu_parent is not None else "(none)" for e in events
                                if e.name in SYNC_CALLS)
    return {"batches": nb, "wall_ms": got["wall_ms"] / nb,
            "device_ms": None if got["device_ms"] is None else got["device_ms"] / nb,
            "launches": {k: v / nb for k, v in got["launches"].items()},
            "host_ops": {k: v / nb for k, v in got["host_ops"].items()},
            "graphs_a_call": captures,
            "syncs_a_call": dict(syncs),
            "split_ms": {"device_codes": scan_split(index, config, c, lengths),
                         "host_codes": scan_split(index, config, host, lengths)}}


def scan_split(index, config, codes, lengths, reps: int = 3) -> dict:
    """One match_scan call split by the host clock, the fastest of `reps`
    by total: to_read (from the call to its first size read: the groups'
    cut and upload, then every batch's sketch and probe enqueued), read
    (that read's wait), after_read (from it to the call's return: the
    expansion and grouping enqueued) and drain (the device's work left
    at the return, to a synchronize)."""
    import time

    from sketch_rna_tpu_torch.pipeline import match_scan
    from sketch_rna_tpu_torch.utils.profiling import sync

    marks = {}

    def read(x, n):
        marks.setdefault("read", time.perf_counter())
        out = x.tolist()
        marks.setdefault("back", time.perf_counter())
        return out

    best = None
    for _ in range(reps):
        marks.clear()
        sync(index.device)
        t0 = time.perf_counter()
        match_scan(index, codes, lengths, config, read=read)
        t1 = time.perf_counter()
        sync(index.device)
        t2 = time.perf_counter()
        got = {"to_read": marks["read"] - t0, "read": marks["back"] - marks["read"], "after_read": t1 - marks["back"],
               "drain": t2 - t1, "total": t2 - t0}
        if best is None or got["total"] < best["total"]:
            best = got
    return {k: v * 1e3 for k, v in best.items()}


def class_tables(index, config, codes, lengths):
    """The fused engine's EM tables over all reads: match_rows, then
    pipeline.em_tables as _quantify_fused calls it.  Returns (tables,
    static_base, static_has)."""
    import torch

    from sketch_rna_tpu_torch.match.rowmatch import pow2ceil
    from sketch_rna_tpu_torch.pipeline import em_tables, match_rows

    tid, score, n_padded, _ = match_rows(index, torch.from_numpy(codes), lengths, config)
    W = min(pow2ceil(max(int((score > 0).sum(dim=1).max()), 1)), config.candidate_capacity)
    return em_tables(tid[:, :W], score[:, :W], config, num_transcripts=index.num_transcripts, n_rows=n_padded)


def posteriors(tid, score, weight, pi, eps: float = 1e-10):
    """One E-step's posteriors [M, W] (em/em.py's lines; weight [M] or None)."""
    import torch

    w = pi[tid] * score
    denom = w.sum(dim=1, keepdim=True)
    post = w * torch.where(denom > eps, 1.0 / denom, 0.0)
    return post if weight is None else post * weight.to(post.dtype)[:, None]


def flat_posteriors(tables, pi, eps: float = 1e-10):
    """posteriors of every (tid, score, weight) table, flattened and joined
    in table order: the lane order of the EM's posterior sum."""
    import torch

    return torch.cat([posteriors(t[0].long(), t[1].to(pi.dtype), t[2], pi, eps).reshape(-1) for t in tables])


def profile_em(tables, static_base, static_has, num_reads: int, T: int, config) -> dict:
    """One EM iteration, its E-step and M-step alone, and the assignment
    over these tables (measure each); the E-step and M-step chained
    must give the iteration's pi within 1e-12 relative."""
    import torch

    from sketch_rna_tpu_torch.em.em import assign_reads_tables, run_em_tables
    from sketch_rna_tpu_torch.utils.profiling import measure

    device = tables[0][0].device
    dt = torch.float64 if config.em_dtype == "float64" else torch.float32
    kw = dict(num_transcripts=T, convergence_threshold=config.em_convergence, pseudocount=config.pseudocount,
              epsilon=config.em_epsilon, dtype=config.em_dtype, static_base=static_base)

    def iteration():
        return run_em_tables(tables, num_reads, max_iterations=1, **kw)[0]

    # em/em.py's loop body, one step at a time (run_em_tables' lines).
    flat = torch.cat([t[0].long().reshape(-1) for t in tables])
    pi0 = torch.full((T,), 1.0 / T, dtype=dt, device=device)
    pcf = torch.tensor(config.pseudocount, dtype=torch.float32)
    term_div = (pcf / torch.tensor(float(num_reads), dtype=torch.float32)).to(device, dt)
    term_pc = pcf.to(device, dt)
    base = static_base.to(dt) if static_base is not None else torch.zeros(T, dtype=dt, device=device)

    def e_step():
        return flat_posteriors(tables, pi0, config.em_epsilon)

    post = e_step()

    def m_step():
        return (base.clone().index_add_(0, flat, post) + term_div) + term_pc

    got, want = m_step(), iteration()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())
    if rel > 1e-12:
        raise AssertionError(f"E-step + M-step differ from one run_em_tables iteration by {rel} relative")
    pi = want

    def assign():
        return assign_reads_tables(tables, pi, num_transcripts=T, dtype=config.em_dtype, static_base=static_base,
                                   static_has=static_has)

    return {"lanes": int(flat.numel()), "rows": sum(int(t[0].shape[0]) for t in tables),
            "width": max(int(t[0].shape[1]) for t in tables),
            "tiers": [[int(t[0].shape[0]), int(t[0].shape[1])] for t in tables],
            "steps_vs_iteration_rel": rel,
            **{name: measure(fn, device, calls=4)
               for name, fn in (("iteration", iteration), ("e_step", e_step), ("m_step", m_step),
                                ("assign", assign))}}


def profile_size(n_transcripts: int, ks, args, device, card_info) -> dict:
    """One index size's line: the stages on the first batch and the EM
    at the class tables of all args.reads reads."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.utils.synth import sample_reads

    index, seqs = index_on_device(n_transcripts, ks, device, args.cache_dir)
    codes, lengths = sample_reads(seqs, args.reads, READ_LEN, PAD_LEN, SEED)
    config = QuantConfig(kmer_lengths=tuple(ks), batch_size=args.batch)
    c, n, caps = first_batch(index, codes, lengths, args.batch)
    line = {"metric": "step_stages", "transcripts": n_transcripts, "ks": list(ks),
            "batch": list(c.shape), "caps": list(caps),
            "stages": profile_stages(index, config, c, n, caps), "chain_equals_step": True,
            "scan": profile_scan(index, config, codes, lengths)}
    tables, base, has = class_tables(index, config, codes, lengths)
    line["em"] = profile_em(tables, base, has, args.reads, index.num_transcripts, config)
    line["card"] = card_info
    return line


def main(argv=None) -> int:
    from bench_torch import SCALE_CACHE, card, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--transcripts", default="6000,50000,250000", help="comma list of index sizes")
    ap.add_argument("--ks", default="31", help="31, or a comma list such as 21,31")
    ap.add_argument("--reads", type=int, default=1 << 20, help="reads drawn; the first batch is profiled")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--cache-dir", default=str(SCALE_CACHE))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    ks = tuple(int(x) for x in args.ks.split(","))
    card_info = card(device)
    runs = []
    for n in (int(x) for x in args.transcripts.split(",")):
        try:
            runs.append(profile_size(n, ks, args, device, card_info))
        except AssertionError as exc:
            print(f"profile_step_torch: FAILED at {n} transcripts: {exc}", file=sys.stderr)
            return 1
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"metric": "profile_step", "ks": list(ks), "runs": runs, "card": card_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
