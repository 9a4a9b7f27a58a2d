"""One run of one cell: set-up, the measured window, the check, the result
line.  run.py is the command; tests call main() with a device and a root
of their own.

The flow of a run (README.md has the whole contract):

  1. BENCHMARK.json names the cell's configuration, traffic mix and
     metrics; each is a file under perfbench/ found by that name.
  2. Set-up: the transcriptome and the program's index from the cache
     (cache.py; built and written on a checkout's first run), the pool of
     samples drawn on the device from --seed (gen.py), the index uploaded
     (the port's to_device), `warmup_samples` quants.  setup_s runs from
     the process's start to the window's.
  3. The window: samples quantified back to back through the port's
     pipeline.quantify, cycling through the pool, until --seconds have
     passed; the sample under way then finishes.  With --trace 1 the first
     `trace_samples` run under torch.profiler.
  4. The device's memory is read, the metric readers run, the program's
     state is freed, and the reference quantifies the checked samples
     (check.py decides `correct`).
  5. The process is searched for JAX and the JAX package, after
     everything else it loads; then the last line of standard output is
     the result, and the numbers compared are the last lines of standard
     error.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from perfbench import cache, check, gen, tracing

# Loss counters of QuantResult.stats: a sample with any of them above 0
# lost work, and counts as failed.
LOSS_KEYS = ("sketch_overflow", "expand_dropped", "candidate_spilled", "class_overflow", "wide_spilled")
# Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "sketch_rna_tpu")


@dataclasses.dataclass
class Sample:
    """One quant of the window: which pool sample, its reads, its host
    seconds, the program's stage times (QuantResult.timing), whether it
    was traced, and its result's loss."""

    pool: int
    reads: int
    start: float
    seconds: float
    timing: Dict[str, float]
    traced: bool
    lost: bool


@dataclasses.dataclass
class Run:
    """What the metric readers (metrics/<name>.py) read.

    samples: the window's quants in order; window_start / window_end:
    host clock of the window's start and of its last sample's end;
    setup_s; memory_peak_bytes: the card's allocated peak from the index's
    upload to the window's close; pool_lengths: each pool sample's read
    lengths; row_width: the samples' padded row width; events: the trace's
    records (tracing.Ev) and spans: each traced sample's (start, end) in
    the trace's clock (microseconds); traced_s: host seconds of the traced
    samples; memory_reserved_bytes: the card's reserved peak over the same
    time as memory_peak_bytes; reserved_growth_bytes: reserved memory at
    the window's close less at its start; pool: the drawn samples (gen.py),
    and device: where the run's tensors live."""

    workload: str
    config: Dict
    mix: Dict
    samples: List[Sample]
    window_start: float
    window_end: float
    setup_s: float
    memory_peak_bytes: int
    pool_lengths: List[np.ndarray]
    row_width: int
    events: List[tracing.Ev] = dataclasses.field(default_factory=list)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    traced_s: float = 0.0
    memory_reserved_bytes: int = 0
    reserved_growth_bytes: int = 0
    pool: list = dataclasses.field(default_factory=list)
    device: str = "cpu"

    def untraced(self) -> List[Sample]:
        return [s for s in self.samples if not s.traced]

    def traced(self) -> List[Sample]:
        return [s for s in self.samples if s.traced]


def _fail(msg: str, code: int = 1) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def load_bench(root: Path) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_named(root: Path, folder: str, name: str) -> Dict:
    """perfbench/<folder>/<name>.json as a dict, with its name."""
    with open(Path(root) / "perfbench" / folder / f"{name}.json") as fh:
        return dict(json.load(fh), name=name)


def load_mix(root: Path, name: str) -> Dict:
    """perfbench/traffic/<name>.json, checked, with its data tables read."""
    mix = load_named(root, "traffic", name)
    gen.check_mix(mix)
    return gen.load_tables(mix, Path(root) / "perfbench" / "traffic")


def cell_metrics(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    trace its per-layer ones.  A metric with a workloads list belongs to
    those cells; a per-layer one without it, to every cell that reports
    the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(root: Path, name: str):
    """The read(run) function of perfbench/metrics/<name>.py."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(root: Path, metrics: Sequence[Dict], run: Run) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read (a reader that finds nothing returns None)."""
    out = {}
    for m in metrics:
        value = reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared as whole names."""
    return sorted({name for name in list(sys.modules) if name.split(".", 1)[0] in FORBIDDEN})


def quant_config(cfg: Dict):
    """The port's QuantConfig of a configuration's quant settings."""
    from sketch_rna_tpu_torch.config import QuantConfig

    q = dict(cfg["quant"])
    q["kmer_lengths"] = tuple(q["kmer_lengths"])
    return QuantConfig(**q)


def answer(res) -> Dict:
    """What the check compares of a QuantResult."""
    return {"pi": res.pi, "weighted_counts": res.weighted_counts, "has_entry": res.has_entry,
            "num_mapped": res.num_mapped}


def _lost(res) -> bool:
    return any(int(res.stats.get(key, 0)) > 0 for key in LOSS_KEYS)


def reference_index(cfg: Dict, flat: np.ndarray, lengths: np.ndarray, device):
    """The reference's own index of the transcriptome (reference/quant.py
    build_index, on `device`), or None, said on standard error, where it
    is not the index whose digests the configuration freezes."""
    import torch

    from perfbench.reference import quant as ref

    q = cfg["quant"]
    flat_d = torch.from_numpy(flat).to(device)
    index = ref.build_index(flat_d, torch.from_numpy(lengths), q["kmer_lengths"], q["sketch_fraction"])
    del flat_d
    for k in q["kmer_lengths"]:
        keys, row_ptr, postings = index[k]
        if [keys.numel(), postings.numel(), ref.index_digest(keys, row_ptr, postings)] != list(
                cfg["index_digests"][str(k)]):
            print(f"perfbench: the reference's index at k={k} is not the configuration's", file=sys.stderr)
            return None
    return index


def checked_samples(seed: int, ran: Sequence[int], n: int) -> List[int]:
    """The pool samples whose results a run with this seed checks: n of
    those that ran, drawn from the seed."""
    ran = sorted(ran)
    return np.random.default_rng(seed).choice(ran, size=min(int(n), len(ran)), replace=False).tolist()


def reference_check(index, cfg: Dict, lengths: np.ndarray, pool: list, kept: Dict[int, List[Dict]],
                    device) -> Dict[str, float]:
    """The worst readings of the kept results (answer() of each) against
    the reference's quant of their pool samples, with the reference's own
    index (reference_index; None reads inf everywhere)."""
    from perfbench.reference import quant as ref

    if index is None:
        return {name: float("inf") for name in check.NUMBERS}
    readings = []
    for p, results in sorted(kept.items()):
        codes, lens = gen.sample_codes(pool[p])
        want = ref.quant(codes, lens, index, lengths.size, cfg["quant"], device)
        readings += [check.compare(r, want) for r in results]
    return check.worst(readings)


def main(argv: Optional[Sequence[str]] = None, *, root: Optional[Path] = None, device: Optional[str] = None,
         t_process: Optional[float] = None) -> int:
    """Run one cell once; returns the exit code.  device None: the card,
    as the benchmark runs (no card: exit 2, no result); tests pass "cpu"."""
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root if root is not None else Path(__file__).resolve().parent.parent)

    bench = load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return _fail(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    cfg = load_named(root, "configs", cell["config"])
    mix = load_mix(root, cell["traffic"])
    with open(root / "perfbench" / "limits" / f"{args.workload}.json") as fh:
        limits = json.load(fh)
    metrics = cell_metrics(bench, args.workload, bool(args.trace))

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            return _fail(f"needs {cell['chips']} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.pipeline import quantify

    config = quant_config(cfg)
    phases = {"imports": time.perf_counter() - t_process}
    t = time.perf_counter()
    flat, lengths, tx_cached = cache.transcriptome(root, cfg)
    phases["transcriptome"] = time.perf_counter() - t
    t = time.perf_counter()
    artifact, idx_cached = cache.program_index(root, cfg, flat, lengths, device)
    phases["index_load"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = gen.draw_pool(args.seed, torch.from_numpy(flat).to(dev), torch.from_numpy(lengths), mix)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phases["pool"] = time.perf_counter() - t
    t = time.perf_counter()
    index = to_device(artifact, dev)
    del artifact
    phases["to_device"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(int(mix["warmup_samples"])):
        quantify(index, pool[i % len(pool)], config)
    if on_card:
        torch.cuda.synchronize()
    phases["warmup"] = time.perf_counter() - t

    # The window.
    samples: List[Sample] = []
    kept: Dict[int, List[Dict]] = {}
    n_trace = int(mix["trace_samples"]) if args.trace else 0
    prof = None
    if n_trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
        prof.__enter__()
    reserved_w0 = int(torch.cuda.memory_reserved(dev)) if on_card else 0
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_process
    traced_end = t_w0
    while not samples or time.perf_counter() - t_w0 < args.seconds:
        p = len(samples) % len(pool)
        traced = len(samples) < n_trace
        t0 = time.perf_counter()
        if traced:
            with torch.profiler.record_function(tracing.SAMPLE_SPAN):
                res = quantify(index, pool[p], config)
        else:
            res = quantify(index, pool[p], config)
        t1 = time.perf_counter()
        samples.append(Sample(p, pool[p].num_reads, t0, t1 - t0, dict(res.timing), traced, _lost(res)))
        runs = kept.setdefault(p, [])  # the pool sample's first and last window results
        runs[min(len(runs), 1):] = [answer(res)]
        del res
        if prof is not None and len(samples) == n_trace:
            traced_end = t1
            prof.__exit__(None, None, None)
    t_w1 = samples[-1].start + samples[-1].seconds
    if prof is not None and len(samples) < n_trace:  # the window closed first
        traced_end = t_w1
        prof.__exit__(None, None, None)

    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    reserved_peak = int(torch.cuda.max_memory_reserved(dev)) if on_card else 0
    reserved_growth = int(torch.cuda.memory_reserved(dev)) - reserved_w0 if on_card else 0

    run = Run(args.workload, cfg, mix, samples, t_w0, t_w1, setup_s, memory_peak,
              [gen.sample_codes(s)[1] for s in pool], gen.pad_width(mix), memory_reserved_bytes=reserved_peak,
              reserved_growth_bytes=reserved_growth, pool=pool, device=str(dev))
    if prof is not None:
        run.events = tracing.from_profiler(prof.events())
        run.spans = sorted((e.start, e.end) for e in run.events if e.name == tracing.SAMPLE_SPAN and not e.device)
        run.traced_s = traced_end - t_w0
    values = read_metrics(root, metrics, run)

    # The check, after the program's state is freed.
    del index
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    chosen = checked_samples(args.seed, kept, mix["check_samples"])
    t_ref = time.perf_counter()
    readings = reference_check(reference_index(cfg, flat, lengths, dev), cfg, lengths, pool,
                               {p: kept[p] for p in chosen}, dev)
    ref_s = time.perf_counter() - t_ref
    correct = check.verdict(readings, limits)
    checks = check.lines(readings, limits)

    out = {"correct": correct, "attempted": len(samples), "failed": sum(s.lost for s in samples),
           "metrics": values,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                      "count": int(cell["chips"]), "memory_peak_bytes": reserved_peak}}
    if run.events:
        busy_s, _ = tracing.busy_share(run.events, run.traced_s)
        out["device"].update(busy_s=busy_s, window_s=run.traced_s)
        t0, t1 = (run.spans[0][0], run.spans[-1][1]) if run.spans else (0.0, 0.0)
        out["breakdown"] = {
            "device_ops": [[name, ms / 1e3] for name, ms, _ in tracing.device_ms_by_name(run.events, 10)],
            "idle_gaps": [list(g) for g in tracing.idle_gaps(run.events, t0, t1, 10)]}
    out["checks"] = checks
    print(f"perfbench: {args.workload} seed {args.seed}: {len(samples)} samples in {t_w1 - t_w0:.3f} s, "
          f"set-up {setup_s:.3f} s (transcriptome {'cached' if tx_cached else 'built'}, index "
          f"{'cached' if idx_cached else 'built'}), checked pool samples {chosen} in {ref_s:.3f} s",
          file=sys.stderr)
    print("perfbench: set-up seconds " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    secs = np.array([s.seconds for s in samples])
    by_pool = [float(np.median([s.seconds for s in samples if s.pool == p] or [0.0])) for p in range(len(pool))]
    print(f"perfbench: sample seconds min {secs.min():.5f} quartiles {np.percentile(secs, [25, 50, 75]).tolist()} "
          f"p95 {np.percentile(secs, 95):.5f} max {secs.max():.5f}; median by pool sample {by_pool}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        return _fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", 4)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
